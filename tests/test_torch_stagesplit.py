"""The pipeline split on the port: ``tests/test_stagesplit.py`` replayed
over 8 virtual host devices (``parallel.mesh.set_virtual_devices``) — the
cascade (device_src → detector on devices 0-3 → tensor_crop → tensor_if
offload=then → classifier on devices 4-7) equal to the single-stage run
frame for frame, crossings at exactly 0.0 across the stage boundary with
a byte-exact ``d2d``/``handoff`` ledger row, tensor_if FIFO/pts under two
streams, and the start/stop race on a staged pool.  The port's ledger
seams run on the CPU with ``obs.transfer.CARD_TYPES`` widened to
``("cuda", "cpu")`` (a fake card tag).  Then the port's own case: the
handoff leaves residency on the device and equals the JAX package's
cascade values.
"""

import pytest
from torch_replay import replay

from nnstreamer_tpu_torch.obs import transfer as _xfer
from nnstreamer_tpu_torch.parallel import mesh as _mesh


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    _mesh.set_virtual_devices(8, "cpu")
    yield
    _mesh.clear_virtual_devices()


@pytest.fixture(autouse=True)
def _fake_card(monkeypatch):
    monkeypatch.setattr(_xfer, "CARD_TYPES", ("cuda", "cpu"))


replay("test_stagesplit.py", globals(), subs=(
    ("from nnstreamer_tpu.filters.jax_xla import (\n    JaxXlaFilter,\n"
     "    register_model,\n    unregister_model,\n)\n",
     "from nnstreamer_tpu.filters import register_model, unregister_model\n"
     "from nnstreamer_tpu.filters.api import SHARED_MODELS\n"),
    ("from nnstreamer_tpu.runtime import MODEL_POOL, Pipeline\n",
     "from nnstreamer_tpu.runtime import Pipeline\n"
     "from nnstreamer_tpu.runtime.serving import MODEL_POOL\n"),
    ('jax = pytest.importorskip("jax")\n\npytestmark = pytest.mark.skipif(\n'
     "    jax.device_count() < 8,\n"
     '    reason="stage split needs the 8-chip (virtual) inventory")\n', ""),
    ("(x * 2.0 + 1.0).sum(axis=(0, 1))", "(x * 2.0 + 1.0).sum(dim=(0, 1))"),
    # the port records host reads the JAX package does not (tensor_if's
    # one scalar a frame, the source staging its pool, and the pools'
    # fold checks, whose count varies with how the windows fill): the
    # boundary's crossings are the split run's own pipeline rows beyond
    # the single-stage run's, and those must be 0
    ('    p, info, sink_off, sink_keep, pname = _cascade("xzero", True, '
     'frames_n)\n',
     '    fp, finfo, _, _, fname = _cascade("xzero_fused", False, '
     'frames_n)\n'
     '    f0 = LEDGER.totals(pipeline=fname, reason="input")[0] \\\n'
     '        + LEDGER.totals(pipeline=fname, reason="drain")[0]\n'
     '    try:\n'
     '        _feed(fp, finfo, frames_n)\n'
     '        fused = LEDGER.totals(pipeline=fname, reason="input")[0] '
     '\\\n'
     '            + LEDGER.totals(pipeline=fname, reason="drain")[0] - f0\n'
     '    finally:\n'
     '        fp.stop()\n'
     '    p, info, sink_off, sink_keep, pname = _cascade("xzero", True, '
     'frames_n)\n'),
    ('    x0 = LEDGER.totals(reason="input")[0] \\\n'
     '        + LEDGER.totals(reason="drain")[0]\n',
     '    x0 = LEDGER.totals(pipeline=pname, reason="input")[0] \\\n'
     '        + LEDGER.totals(pipeline=pname, reason="drain")[0]\n'),
    ('        x1 = LEDGER.totals(reason="input")[0] \\\n'
     '            + LEDGER.totals(reason="drain")[0]\n',
     '        x1 = LEDGER.totals(pipeline=pname, reason="input")[0] \\\n'
     '            + LEDGER.totals(pipeline=pname, reason="drain")[0]\n'),
    ('        assert x1 - x0 == 0, "stage handoff leaked a host crossing"',
     '        assert x1 - x0 - fused == 0, "stage handoff leaked a host '
     'crossing"'),
    ("    with JaxXlaFilter._shared_lock:\n"
     "        JaxXlaFilter._shared_instances.clear()\n",
     "    SHARED_MODELS.clear()\n"),
))


def test_handoff_keeps_residency_and_tags_the_stage():
    """A frame handed off between stages stays on the device (the
    handoff is a copy, never a drain) and lands on the receiving stage's
    first device record; the source frame is untouched."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.edge import devicechannel as devch

    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    _mesh.set_home(x, 1)
    buf = Buffer.of(x)
    target = _mesh.local_devices("cpu")[5]
    h0 = _xfer.LEDGER.totals(direction="d2d", reason="handoff")
    out = devch.stage_handoff(buf, target, chan=("stage", "t"))
    h1 = _xfer.LEDGER.totals(direction="d2d", reason="handoff")
    assert out is not buf and out.residency == "device"
    y = out.tensors[0].torch()
    assert _mesh.device_ids_of(y) == (5,) and y.data_ptr() != x.data_ptr()
    assert _mesh.device_ids_of(x) == (1,)
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    assert (h1[0] - h0[0], h1[1] - h0[1]) == (1, 48)
    # a host frame is not handed off: its upload is the h2d path
    host = Buffer.of(np.zeros((2, 2), np.float32))
    assert devch.stage_handoff(host, target) is host
