"""The multi-device tier: the mesh with the batch-, test-point- and
row-sharded paths (``mesh``), and the distributed exact GP, whose kernel
matrix is built, factored and served row-sharded (``dist_exact``).

Port of ``gpyreg_tpu/parallel/``; one process drives every shard (see
``mesh``'s docstring)."""

from . import dist_exact
from . import mesh

__all__ = ["dist_exact", "mesh"]
