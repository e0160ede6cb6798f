"""The placement layer (``nnstreamer_tpu_torch/parallel/placement.py``) and
mesh-native shared serving: ``tests/test_placement.py`` replayed on the
port over 8 virtual host devices (``parallel.mesh.set_virtual_devices``, the
counterpart of the JAX tests' ``--xla_force_host_platform_device_count``),
then the port's own cases: accelerator spellings, the subset/overlap
registry keyed by device-record id, the key cache that keeps only
successful resolutions, the window feed and the dcn-axis rule.
"""

import numpy as np
import pytest
import torch
from torch_replay import replay

from nnstreamer_tpu_torch.parallel import mesh as _mesh


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    _mesh.set_virtual_devices(8, "cpu")
    yield
    _mesh.clear_virtual_devices()


replay("test_placement.py", globals(), subs=(
    ("import numpy as np\nimport pytest\n",
     "import numpy as np\nimport pytest\nimport torch\n"),
    ("from nnstreamer_tpu.filters.jax_xla import (\n    JaxXlaFilter,\n"
     "    register_model,\n    unregister_model,\n)\n",
     "from nnstreamer_tpu.filters import register_model, unregister_model\n"
     "from nnstreamer_tpu.filters.api import SHARED_MODELS\n"),
    ("from nnstreamer_tpu.runtime import MODEL_POOL, Pipeline\n",
     "from nnstreamer_tpu.runtime import Pipeline\n"
     "from nnstreamer_tpu.runtime.serving import MODEL_POOL\n"),
    ("lambda x: x @ W + 1.0", "lambda x: x @ torch.from_numpy(W) + 1.0"),
    ("    with JaxXlaFilter._shared_lock:\n"
     "        JaxXlaFilter._shared_instances.clear()\n",
     "    SHARED_MODELS.clear()\n"),
    ("        import jax\n\n        n = len(jax.devices(\"cpu\"))\n",
     "        n = _mesh.local_device_count(\"cpu\")\n"),
    ("sp = JaxXlaFilter()", "sp = TorchCudaFilter()"),
    # the port's outputs carry their home device record, not a sharding
    ("devs = {d for o in outs for d in o[0].sharding.device_set}",
     "devs = {o[0]._nns_home for o in outs}"),
))

from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter  # noqa: E402,E501
from nnstreamer_tpu_torch.parallel import placement as _pl  # noqa: E402


class TestPortPlacement:
    def test_accelerator_spellings_one_key(self):
        assert Placement(accelerator="gpu").key() == \
            Placement(accelerator="true:cuda").key() == ("device", "cuda")
        assert Placement(mesh="data:-1", accelerator="cpu").key() == \
            Placement(mesh="data:8", accelerator="true:cpu").key()

    def test_key_matches_jax_layout(self):
        """The canonical key has the JAX package's layout: ("mesh",
        platform, resolved axes, device ids in mesh order, rules)."""
        k = Placement(mesh="data:2,model:2", sharding="tp",
                      accelerator="cpu").key()
        assert k == ("mesh", "cpu", (("data", 2), ("model", 2)),
                     (0, 1, 2, 3), "mobilenet")

    def test_key_cache_keeps_only_successes(self):
        """A spec that cannot resolve now keys raw, and resolves once the
        inventory can hold it (the cache never pins a failure)."""
        spec = Placement(mesh="data:16", accelerator="cpu")
        assert spec.key()[0] == "raw"
        _mesh.set_virtual_devices(16, "cpu")
        try:
            assert spec.key()[0] == "mesh"
        finally:
            _mesh.set_virtual_devices(8, "cpu")
        assert spec.key()[0] == "raw"

    def test_mesh_larger_than_inventory_raises(self):
        with pytest.raises(ValueError):
            Placement(mesh="data:9", accelerator="cpu").resolve()
        with pytest.raises(ValueError):
            Placement(mesh="data:4", devices="6-9",
                      accelerator="cpu").resolve()

    def test_dcn_axis_must_be_a_data_axis(self):
        with pytest.raises(ValueError, match="data-parallel"):
            Placement(mesh="dcn.model:1,data:4",
                      accelerator="cpu").resolve()

    def test_overlap_registry_keys_by_record_id(self, monkeypatch):
        """Virtual records over one torch.device are told apart by id:
        0-3 and 4-7 are disjoint, 2-5 overlaps both; strict mode turns
        the overlap into an error."""
        _pl.reset_subsets()
        try:
            Placement(mesh="data:4", devices="0-3",
                      accelerator="cpu").resolve()
            Placement(mesh="data:4", devices="4-7",
                      accelerator="cpu").resolve()
            assert _pl.overlap_snapshot() == []
            Placement(mesh="data:4", devices="2-5",
                      accelerator="cpu").resolve()
            rows = _pl.overlap_snapshot()
            assert {(r["a"], r["b"], r["shared"]) for r in rows} == {
                ("0-3", "2-5", "2-3"), ("2-5", "4-7", "4-5")}
            monkeypatch.setenv("NNS_TPU_TORCH_STRICT_PLACEMENT", "1")
            with pytest.raises(ValueError, match="overlap"):
                Placement(mesh="data:2", devices="3,4",
                          accelerator="cpu").resolve()
        finally:
            _pl.reset_subsets()

    def test_subset_label_matches_jax(self):
        from nnstreamer_tpu.parallel.placement import subset_label as jlabel

        for ids in ([0, 1, 2, 3], [4, 5, 6, 7], [0, 2, 5], [3], [1, 2, 7]):
            assert _pl.subset_label(ids) == jlabel(ids)

    def test_feed_window_places_rows_per_shard(self):
        rp = Placement(mesh="data:4", accelerator="cpu").resolve()
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        parts = rp.feed_window([x])[0]
        assert len(parts) == 4
        np.testing.assert_array_equal(
            torch.cat(parts).numpy(), x)
        # a window that does not split stays whole, on the lead device
        assert len(rp.feed_window([x[:3]])[0]) == 1
        assert rp.local_rows(x) is x

    def test_groups_follow_meshstat_shard_order(self):
        """Data shard k's devices are the ones obs/meshstat labels shard
        k with, on a model-major mesh too."""
        from nnstreamer_tpu_torch.obs.meshstat import shard_device_label
        from nnstreamer_tpu_torch.parallel.mesh import mesh_topology

        rp = Placement(mesh="model:2,data:4", sharding="tp",
                       accelerator="cpu").resolve()
        row = {**mesh_topology(rp.mesh), "data_axis": "data"}
        for k, g in enumerate(rp.groups):
            assert shard_device_label(row, k) == f"{g[0]}+1"
