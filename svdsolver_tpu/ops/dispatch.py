"""The one place that chooses between a GPU kernel and its plain reference.

Each entry point stages out both implementations with
``lax.platform_dependent``; the choice is made when the computation is
lowered, for the platform it is lowered for (not the process's default
backend, which can differ from a mesh's devices).  CUDA gets the Pallas
Triton kernel; every other platform gets the XLA reference, which is also
the kernels' test oracle.
"""

from jax import lax

from svdsolver_tpu.models.diagonalize import bisect_svdvals as _bisect_xla
from svdsolver_tpu.ops.pallas.bisect_triton import bisect_svdvals_triton
from svdsolver_tpu.ops.pallas.tgk_solve_triton import tgk_solve_triton


def bisect_svdvals(d, e):
    """Singular values of the bidiagonal {d, e}, descending, by bisection."""
    return lax.platform_dependent(
        d, e, cuda=bisect_svdvals_triton, default=_bisect_xla
    )


def tgk_solve(z, lam, rhs, pivmin, big):
    """Per-lane shifted TGK solve of inverse iteration (see tgk_solve_xla)."""
    from svdsolver_tpu.models.vectors import tgk_solve_xla

    return lax.platform_dependent(
        z, lam, rhs, pivmin, big, cuda=tgk_solve_triton, default=tgk_solve_xla
    )
