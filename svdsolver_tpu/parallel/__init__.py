"""Multi-device execution: device meshes, sharded batch SVD, distributed Stage I.

The reference's parallelism is single-node (OpenMP threads + one GPU).
This package is the *scale-out* layer the reference lacks:
``jax.sharding.Mesh`` + ``pjit`` shardings so batches of problems run
data-parallel across devices and the trailing-matrix GEMMs of Stage I shard
across the device interconnect.
"""

from svdsolver_tpu.parallel.mesh import make_mesh
from svdsolver_tpu.parallel.distributed import (
    svdvals_batch_sharded,
    svdvals_batch_sharded_gspmd,
    svdvals_sharded,
    svd_sharded,
    dense_to_band_sharded,
    dense_to_band_shardmap,
    dryrun,
)
from svdsolver_tpu.parallel.jacobi import svd_jacobi_sharded

__all__ = [
    "svd_jacobi_sharded",
    "make_mesh",
    "svdvals_batch_sharded",
    "svdvals_batch_sharded_gspmd",
    "svdvals_sharded",
    "svd_sharded",
    "dense_to_band_sharded",
    "dense_to_band_shardmap",
    "dryrun",
]
