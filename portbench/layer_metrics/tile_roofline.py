"""The kernel tile's share of its roofline, in %: each launch's bound
(``portbench/work/kernel_tile.py``) summed over the profiled steps,
over the device time of the ``kernel_tile`` events in the trace."""

from portbench.layer_metrics._launches import share
from portbench.work import kernel_tile

DEVICE_EVENTS_ONLY = True


def read(ctx):
    return share(ctx, "tile_roofline", ["kernel_tile<"], [],
                 ["self", "cross", "self_unaligned", "cross_unaligned"],
                 "tiles", kernel_tile.bound_s)
