"""Why one data shard's moments must be the stacked step's own functions.

``python3 relu6_edge_study.py`` (CPU, about 6 s): ``chip_smoke.py``'s
TRAIN_SMALL MobileNetV1 (width 0.25, 32x32, 16 rows, f32) at its seeded
weights.  Each batch-norm layer's moments are taken four ways: ``mean``
and ``var`` (what the stacked step and ``parallel/syncbn.py`` take),
``torch.var_mean`` (one pass, rounding otherwise), ``mean``/``var`` on
the rows in another order (the same function), and the whole model in
float64.  It prints each gradient's largest relative gap to float64, the
ReLU6 pre-activation nearest 0 under two row orders, and the stacked
step's three sgd losses (lr 1e-4) in both orders: a pre-activation that
rounds to either side of 0 passes its gradient or not, so the step's
losses move far more than one rounding.
"""

import copy
import functools

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
from nnstreamer_tpu_torch.models import mobilenet
from nnstreamer_tpu_torch.models.convert import (mobilenet_v1_tree_apply,
                                                 tree_module_of)
from nnstreamer_tpu_torch.parallel import mesh, sharded
from nnstreamer_tpu_torch.trainers.torch_optim import _make_optimizer


def mean_var(y, dims):
    return y.mean(dim=dims), y.var(dim=dims, unbiased=False)


def one_pass(y, dims):
    v, m = torch.var_mean(y, dim=dims, correction=0)
    return m, v


def forward64(self, x, dtype=torch.float64, train=False):
    """``ConvBN.forward`` in float64 throughout."""
    h = x.permute(0, 3, 1, 2)
    ph = mobilenet.same_padding(h.shape[2], self.k, self.stride)
    pw = mobilenet.same_padding(h.shape[3], self.k, self.stride)
    if any(ph + pw):
        h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(h, self.weight.double(), stride=self.stride,
                 groups=self.groups).permute(0, 2, 3, 1)
    mean, var = mean_var(y, (0, 1, 2))
    r = torch.rsqrt(var + mobilenet._BN_EPS)
    scale, bias = self.scale.double(), self.bias.double()
    y = y * (scale * r) + (bias - mean * scale * r)
    return torch.clamp(y, 0.0, 6.0) if self.relu6 else y


def grads(build, tree, x, y, moments, f64=False):
    """Every leaf's gradient of one batch, and each ReLU6 input."""
    edges = []
    real_fwd, real_clamp = mobilenet.ConvBN.forward, torch.clamp
    mobilenet._syncbn.batch_moments = moments
    mobilenet.ConvBN.forward = forward64 if f64 else real_fwd
    torch.clamp = lambda t, lo, hi: (edges.append(t.detach().clone())
                                     or real_clamp(t, lo, hi))
    try:
        model = copy.deepcopy(build(tree))
        model = model.double() if f64 else model
        xt = torch.from_numpy(x).double() if f64 else torch.from_numpy(x)
        logits = mobilenet.mobilenet_v1_apply(
            model, xt, torch.float64 if f64 else torch.float32, True)
        sharded.softmax_xent(logits, y).backward()
    finally:
        mobilenet.ConvBN.forward, torch.clamp = real_fwd, real_clamp
        mobilenet._syncbn.batch_moments = mean_var
    return [p.grad.double() for p in model.parameters()], edges


def stacked_losses(xs, ys, tree):
    step, p, o = sharded.train_step(
        mesh.make_mesh("data:1", mesh.local_devices("cpu")[:1]),
        functools.partial(mobilenet_v1_tree_apply, dtype=torch.float32),
        tree, optimizer=_make_optimizer({"optimizer": "sgd", "lr": 1e-4}))
    out = []
    for x, y in zip(xs, ys):
        p, o, loss = step(p, o, x, y)
        out.append(float(loss))
    return out


def main() -> None:
    torch.set_num_threads(2)
    xs, ys, tree = chip_smoke._small_batches()
    build, _ = tree_module_of(mobilenet_v1_tree_apply)
    perm = np.random.default_rng(5).permutation(xs.shape[1])
    ref, _ = grads(build, tree, xs[0], ys[0], mean_var, f64=True)
    runs = {"mean/var": grads(build, tree, xs[0], ys[0], mean_var),
            "var_mean": grads(build, tree, xs[0], ys[0], one_pass),
            "mean/var, rows permuted": grads(build, tree, xs[0][perm],
                                             ys[0][perm], mean_var)}
    for name, (g, _) in runs.items():
        gaps = [float((a - b).norm() / b.norm()) for a, b in zip(g, ref)]
        print(f"{name}: gradients against float64, largest relative norm "
              f"gap {max(gaps):.3e}, median {np.median(gaps):.3e}")
    nat, per = runs["mean/var"][1], runs["mean/var, rows permuted"][1]
    back = torch.from_numpy(np.argsort(perm))
    layer, i = min(((k, int(b[back].reshape(-1).abs().argmin()))
                    for k, b in enumerate(per)),
                   key=lambda ki: float(per[ki[0]][back].reshape(-1)[ki[1]]
                                        .abs()))
    print(f"ReLU6 input nearest 0 (layer {layer}, element {i}): "
          f"{float(nat[layer].reshape(-1)[i]):.9e} in row order, "
          f"{float(per[layer][back].reshape(-1)[i]):.9e} permuted")
    a = stacked_losses(xs, ys, tree)
    b = stacked_losses(xs[:, perm], ys[:, perm], tree)
    gaps = ", ".join(f"{abs(u - v) / v:.3e}" for u, v in zip(b, a))
    print(f"stacked step, sgd lr 1e-4: losses {a} in row order, {b} "
          f"permuted; relative gaps {gaps}")


if __name__ == "__main__":
    main()
