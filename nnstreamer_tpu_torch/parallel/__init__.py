"""The parallel layer: placement, mesh, sharded invoke, multi-process and
collectives — what a ``tensor_filter mesh=… sharding=… devices=…`` runs
on.

Counterpart of the JAX package's ``parallel/``, on eager PyTorch:

- :mod:`.placement` — THE placement layer: the ``mesh=``/``sharding=``/
  ``devices=`` spec, its resolution to a mesh of device records (DCN axes
  included), and the canonical key equivalent spellings share;
- :mod:`.mesh` — the device inventory (with the virtual-device seam,
  :func:`.mesh.set_virtual_devices`) and mesh construction;
- :mod:`.sharded` — the sharding rules and the sharded invoke (the split,
  the weight replicas and ``model`` slices, the gathers XLA would insert);
- :mod:`.multihost` — the ``torch.distributed`` process group and hybrid
  meshes;
- :mod:`.collectives` — merge, reduce, ring shift, regroup and ring
  attention across devices.

Not here yet: ``train_step`` (the sharded training step comes with the
trainer, ROADMAP item 7).
"""

from .mesh import (  # noqa: F401
    MeshSpec,
    local_device_count,
    make_mesh,
    parse_device_indices,
)
from .multihost import hybrid_mesh, initialize, process_info  # noqa: F401
from .placement import (  # noqa: F401
    Placement,
    ResolvedPlacement,
    parse_accel_kind,
)
from .sharded import (  # noqa: F401
    PARAM_RULES,
    ShardedModel,
    batch_sharding,
    get_param_rules,
    mobilenet_param_rules,
    register_param_rules,
    replicated,
    replicated_param_rules,
    shard_params,
)
