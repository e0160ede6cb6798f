"""The static analyzer's tests (``tests/test_analyze.py``) replayed on the
port's ``nnstreamer_tpu_torch.analyze``, its JSON golden byte-equal.

Every catalog code runs, NNS509/NNS512/NNS516 (mesh placement and the
pipeline split) included: their descriptions lint with the port's
``mesh=``/``devices=`` over 8 virtual host devices
(``parallel.mesh.set_virtual_devices``), the inventory NNS516 reads.
"""

import pytest
from torch_replay import replay


@pytest.fixture(autouse=True)
def _virtual_devices():
    from nnstreamer_tpu_torch.parallel import mesh

    mesh.set_virtual_devices(8, "cpu")
    yield
    mesh.clear_virtual_devices()


replay("test_analyze.py", globals(), subs=(
    # the inventory NNS516 reads: the port's virtual devices
    ("    import jax\n\n    n_devs = len(jax.devices())  # conftest pins 8 "
     "virtual chips\n",
     "    from nnstreamer_tpu.parallel.mesh import local_device_count\n\n"
     "    n_devs = local_device_count()\n"),
    # the port's corpus: chip_smoke.py's literals and the port's docs
    ('default_corpus(os.path.join(REPO, "examples"))',
     'default_corpus(os.path.join(REPO, "chip_smoke.py"))'),
    # the tests that start or parse a pipeline themselves do so on the CPU
    ("    parse_launch,\n    register_element,\n)\n",
     "    register_element,\n)\n"
     "from functools import partial as _partial\n"
     "from nnstreamer_tpu.runtime import parse_launch as _parse_launch\n"
     "parse_launch = _partial(_parse_launch, device='cpu')\n"),
    ("from nnstreamer_tpu.filters.jax_xla import register_model, \\\n"
     "        unregister_model",
     "from nnstreamer_tpu.filters import register_model, unregister_model"),
    # a torch model: torch tensors have no astype
    ('lambda x: x.astype("float32") + 1', "lambda x: x.float() + 1"),
    # ``Message`` names its sender ``source``: reading ``m.src`` raised
    # AttributeError whenever a delivery begun before the removal (which
    # the test allows) landed in ``late_calls``
    ('any(m.src == "after-remove"', 'any(m.source == "after-remove"'),
))
