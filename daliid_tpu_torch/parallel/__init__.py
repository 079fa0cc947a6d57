from daliid_tpu_torch.parallel.distributed import (
    add_multihost_flags,
    initialize_multihost,
    maybe_initialize_from_args,
    shutdown_multihost,
)
from daliid_tpu_torch.parallel.mesh import (
    active,
    all_reduce_,
    all_reduce_sum,
    barrier,
    gather_rows,
    local_rows,
    pad_to_multiple,
    rank,
    row_range,
    world,
)

__all__ = [
    "active",
    "add_multihost_flags",
    "all_reduce_",
    "all_reduce_sum",
    "barrier",
    "gather_rows",
    "initialize_multihost",
    "local_rows",
    "maybe_initialize_from_args",
    "pad_to_multiple",
    "rank",
    "row_range",
    "shutdown_multihost",
    "world",
]
