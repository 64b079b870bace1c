"""svdsolver_tpu — a dense singular-value-decomposition framework in JAX.

Built from scratch in JAX/XLA/Pallas with the full capability ladder of the
reference CPU/CUDA solver (scrose/SVDSolver):

* Golub-Kahan bidiagonalization          (reference: svd_serial.h:233 `brd`)
* blocked one-stage panel reduction      (reference: svd_serial.h:442 `block_brd`)
* two-stage dense->band + bulge chase    (reference: svd_parallel.h:411/:640,
                                          svd_cuda_1.cu:750, svd_cuda_2.cu:1117)
* implicit zero-shift QR diagonalization (reference: svd_serial.h:314/:368)

Everything is a pure function over `jax.Array`s with static shapes so that the
whole pipeline compiles to a single XLA executable; the hot FLOPs (trailing
matrix updates) land in large GEMMs, and the sequential per-lane recurrences
(bisection, the inverse-iteration solve) run as Pallas Triton kernels on the
GPU (ops/dispatch.py chooses them; the XLA references run elsewhere).
"""

from svdsolver_tpu.ops.householder import (
    householder_vector,
    apply_left,
    apply_right,
)
from svdsolver_tpu.ops.givens import givens
from svdsolver_tpu.models.golub_kahan import bidiagonalize_gk
from svdsolver_tpu.models.blocked import bidiagonalize_blocked
from svdsolver_tpu.models.two_stage import (
    dense_to_band,
    band_to_bidiagonal,
    bidiagonalize_two_stage,
)
from svdsolver_tpu.models.diagonalize import (
    zero_shift_sweep,
    shifted_sweep,
    diag_reduce_fixed_iter,
    bidiagonal_svdvals,
    bisect_svdvals,
    dqds_svdvals,
    convergence_threshold,
)
from svdsolver_tpu.models.svd import svdvals, svdvals_batch, Bidiagonal
from svdsolver_tpu.models.vectors import svd, svds, svd_batch, bidiagonal_svd
from svdsolver_tpu.models.jacobi import (
    svd_jacobi,
    svd_jacobi_batch,
    svd_jacobi_pre,
)
from svdsolver_tpu.models.complex_svd import svd_c, svdvals_c
from svdsolver_tpu.linalg import (
    pinv,
    lstsq,
    matrix_rank,
    cond,
    norm2,
    lowrank,
    rsvd,
    polar,
    eigh,
    orth,
    null_space,
)

__version__ = "0.1.0"

__all__ = [
    "householder_vector",
    "apply_left",
    "apply_right",
    "givens",
    "bidiagonalize_gk",
    "bidiagonalize_blocked",
    "dense_to_band",
    "band_to_bidiagonal",
    "bidiagonalize_two_stage",
    "zero_shift_sweep",
    "shifted_sweep",
    "diag_reduce_fixed_iter",
    "bidiagonal_svdvals",
    "bisect_svdvals",
    "dqds_svdvals",
    "convergence_threshold",
    "svdvals",
    "svdvals_batch",
    "svd",
    "svd_jacobi",
    "svd_c",
    "svdvals_c",
    "svd_jacobi_batch",
    "svd_jacobi_pre",
    "svds",
    "svd_batch",
    "bidiagonal_svd",
    "Bidiagonal",
    "pinv",
    "lstsq",
    "matrix_rank",
    "cond",
    "norm2",
    "lowrank",
    "rsvd",
    "polar",
    "eigh",
    "orth",
    "null_space",
]
