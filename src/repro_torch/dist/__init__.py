# Distribution layer: sharding rules onto a DeviceMesh (DTensor placements)
# + compressed data-parallel gradients.
from .compress import make_compressed_dp_grad_fn, zeros_like_error
from .sharding import (
    NamedSharding,
    PartitionSpec,
    TrainShardings,
    abstract_put,
    batch_sharding,
    blockwise,
    cache_shardings,
    constrain,
    default_rules,
    device_put,
    mesh_ops,
    on_mesh,
    opt_state_shardings,
    spec_for_axes,
    spec_for_axes_shaped,
    to_global,
    train_shardings,
    tree_shardings,
    tree_shardings_shaped,
    write_at_,
)
