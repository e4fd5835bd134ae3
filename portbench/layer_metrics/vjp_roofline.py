"""The gradient tile's share of its roofline, in %: each launch's bound
(``portbench/work/kernel_vjp.py``) summed over the profiled steps, over
the device time of the ``kernel_vjp`` events and their
``reduce_partials`` reductions in the trace."""

from portbench.layer_metrics._launches import share
from portbench.work import kernel_vjp

DEVICE_EVENTS_ONLY = True


def read(ctx):
    return share(ctx, "vjp_roofline", ["kernel_vjp<"], ["reduce_partials"],
                 ["vjp", "vjp_unaligned"], "vjps", kernel_vjp.bound_s)
