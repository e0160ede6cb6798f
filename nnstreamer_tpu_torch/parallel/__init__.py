"""The parallel layer: placement, mesh, sharded invoke, multi-process and
collectives — what a ``tensor_filter mesh=… sharding=… devices=…`` runs
on.

Counterpart of the JAX package's ``parallel/``, on eager PyTorch:

- :mod:`.placement` — THE placement layer: the ``mesh=``/``sharding=``/
  ``devices=`` spec, its resolution to a mesh of device records (DCN axes
  included), and the canonical key equivalent spellings share;
- :mod:`.mesh` — the device inventory (with the virtual-device seam,
  :func:`.mesh.set_virtual_devices`) and mesh construction;
- :mod:`.sharded` — the sharding rules, the sharded invoke (the split,
  the weight replicas and ``model`` slices, the gathers XLA would insert)
  and the training step;
- :mod:`.multihost` — the ``torch.distributed`` process group, its
  subgroups (:class:`~.multihost.Subgroup`) and hybrid meshes;
- :mod:`.collectives` — merge, reduce, ring shift, regroup and ring
  attention across devices;
- :mod:`.syncbn` — the batch statistics of a split training step,
  combined over its data shards.

The sharded training step (:func:`train_step`, :func:`softmax_xent`) is
what the ``torch-optim`` trainer runs; over more than one data shard it
splits the batch, and :mod:`.syncbn` combines each batch-norm layer's
moments over the shards (:func:`batch_moments`, :class:`ShardGroup`),
across processes too (:class:`~.syncbn.RankShards`).  A ``model`` group
may span processes: its split layers gather over the group's ranks
(:class:`ModelGroup`), and the moments and gradients reduce over the
data peers, each data shard counted once.
"""

from .mesh import (  # noqa: F401
    MeshSpec,
    local_device_count,
    make_mesh,
    parse_device_indices,
)
from .multihost import (  # noqa: F401
    Subgroup,
    hybrid_mesh,
    initialize,
    process_info,
    subgroups,
)
from .placement import (  # noqa: F401
    Placement,
    ResolvedPlacement,
    parse_accel_kind,
)
from .sharded import (  # noqa: F401
    PARAM_RULES,
    ModelGroup,
    ShardedLeaf,
    ShardedModel,
    batch_sharding,
    get_param_rules,
    mobilenet_param_rules,
    register_param_rules,
    replicated,
    replicated_param_rules,
    shard_params,
    TrainStep,
    data_shard_groups,
    softmax_xent,
    train_step,
    trained_tree,
)
from .syncbn import (  # noqa: F401
    RankShards,
    ShardGroup,
    ShardGroupError,
    batch_moments,
)
