"""Public names of ported modules that no path of either package calls,
held against the JAX package's on the CPU.

- ``models/ssd.py`` ``nms_single``: the greedy one-class NMS, on seeded
  boxes (distinct scores, so the top-k order is defined), with the
  output padded when ``max_out`` exceeds the candidates; boxes and
  scores equal to the JAX package's within 1e-6.
- ``utils/conf.py`` ``Conf.get_bool`` and ``element_restriction``: the
  same values from a config file and from the environment (each
  package's own key prefix) in both packages.
- ``utils/stats.py`` ``DispatchStats``: the same counts, totals,
  snapshots and reset.
- ``parallel/multihost.py`` ``_mesh_by_process``, a held copy of the
  JAX package's: it takes the first ``nici`` devices of each process
  (lowest ids) and drops the rest without a word, as the JAX one does.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import ssd as jssd
from nnstreamer_tpu.parallel import multihost as jmultihost
from nnstreamer_tpu.utils import conf as jconf
from nnstreamer_tpu.utils import stats as jstats
from nnstreamer_tpu_torch.models import ssd as tssd
from nnstreamer_tpu_torch.parallel import multihost as tmultihost
from nnstreamer_tpu_torch.utils import conf as tconf
from nnstreamer_tpu_torch.utils import stats as tstats


def _boxes(rng, n):
    yx = rng.uniform(0, 0.8, (n, 2)).astype(np.float32)
    hw = rng.uniform(0.05, 0.3, (n, 2)).astype(np.float32)
    return np.concatenate([yx, yx + hw], axis=1)


@pytest.mark.parametrize("n,max_out,pre_topk", [(64, 10, 256), (300, 20, 40),
                                                (12, 30, 256)])
def test_nms_single_matches_jax(n, max_out, pre_topk):
    rng = np.random.default_rng(n)
    boxes = _boxes(rng, n)
    # clusters of overlapping boxes, so suppression happens
    boxes[n // 2:] = boxes[:n - n // 2] + 0.01
    scores = rng.permutation(n).astype(np.float32) / n
    jb, js = jssd.nms_single(jnp.asarray(boxes), jnp.asarray(scores),
                             max_out=max_out, pre_topk=pre_topk)
    tb, ts = tssd.nms_single(torch.from_numpy(boxes),
                             torch.from_numpy(scores), max_out=max_out,
                             pre_topk=pre_topk)
    assert tuple(tb.shape) == (max_out, 4) and tuple(ts.shape) == (max_out,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-6)
    assert int((ts > 0).sum()) > 0


@pytest.mark.parametrize("value", ["true", "0", "yes", "off", "", "maybe"])
def test_conf_get_bool_and_restriction_match_jax(value, tmp_path,
                                                 monkeypatch):
    ini = tmp_path / "nns.ini"
    ini.write_text(f"[element]\nrestriction = tensor_filter::tensor_sink:\n"
                   f"[custom]\nflag = {value}\n")
    j, t = jconf.Conf(str(ini)), tconf.Conf(str(ini))
    for default in (False, True):
        assert t.get_bool("custom", "flag", default) == \
            j.get_bool("custom", "flag", default)
        assert t.get_bool("custom", "absent", default) == \
            j.get_bool("custom", "absent", default) == default
    assert t.element_restriction == j.element_restriction == \
        ["tensor_filter", "tensor_sink"]
    monkeypatch.setenv("NNS_TPU_ELEMENT_RESTRICTION", value)
    monkeypatch.setenv("NNS_TPU_TORCH_ELEMENT_RESTRICTION", value)
    assert t.element_restriction == j.element_restriction
    empty = tmp_path / "empty.ini"
    empty.write_text("")
    monkeypatch.delenv("NNS_TPU_ELEMENT_RESTRICTION")
    monkeypatch.delenv("NNS_TPU_TORCH_ELEMENT_RESTRICTION")
    assert tconf.Conf(str(empty)).element_restriction is None is \
        jconf.Conf(str(empty)).element_restriction


def test_dispatch_stats_match_jax():
    j, t = jstats.DispatchStats(), tstats.DispatchStats()
    for site, n in (("filter", 1), ("transform", 3), ("filter", 2),
                    ("decoder", 1), ("decoder_pack", 0)):
        j.count(site, n)
        t.count(site, n)
    assert t.snapshot() == j.snapshot() == {
        "filter": 3, "transform": 3, "decoder": 1, "decoder_pack": 0}
    assert t.total == j.total == 7
    j.reset()
    t.reset()
    assert t.snapshot() == j.snapshot() == {} and t.total == j.total == 0


def test_mesh_by_process_drops_extra_devices_as_jax_does():
    devs = [types.SimpleNamespace(process_index=p, id=p * 10 + i)
            for p in (1, 0) for i in (2, 0, 1)]
    want = jmultihost._mesh_by_process(jax, devs, (2,), (2,))
    got = tmultihost._mesh_by_process(devs, (2,), (2,))
    assert got.shape == want.shape == (2, 2)
    assert [d.id for d in got.flat] == [d.id for d in want.flat] == \
        [0, 1, 10, 11]      # ids 2 and 12 dropped, no error
    for args in (((3,), (2,)), ((2,), (4,))):
        with pytest.raises(ValueError, match="hybrid_mesh"):
            tmultihost._mesh_by_process(devs, *args)
        with pytest.raises(ValueError, match="hybrid_mesh"):
            jmultihost._mesh_by_process(jax, devs, *args)
