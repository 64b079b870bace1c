"""Matmul precision control.

A float32 contraction at XLA's default precision may run in TF32 on the
GPU's tensor cores (about three decimal digits) — unacceptable for
orthogonal reductions, whose error must stay near machine epsilon.  All
contractions in the solver go through :func:`pdot`, which asks for
``Precision.HIGHEST`` (true float32 or float64 arithmetic).
"""

import jax.numpy as jnp
from jax import lax

_PRECISION = lax.Precision.HIGHEST


def get_lax_precision():
    """The contraction precision as a ``lax.Precision`` (for einsum etc.)."""
    return _PRECISION


def pdot(a, b):
    """Precision-controlled matmul/vecdot used for every contraction."""
    return jnp.matmul(a, b, precision=_PRECISION)
