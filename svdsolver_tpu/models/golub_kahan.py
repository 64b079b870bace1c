"""Golub-Kahan bidiagonal reduction — the "base" model.

Capability parity with the reference's naive ``serial::brd``
(svd_serial.h:232-267) in JAX: one ``lax.fori_loop`` over columns,
each step a pair of masked rank-1 updates on the full (static-shape) matrix.
The reference materializes a dense ``H`` per column and runs a naive GEMM
against the trailing matrix (O(n^4) total); here each step is two GEMV-sized
rank-1 updates (O(n^3) total) that XLA fuses.
"""

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.householder import householder_vector
from svdsolver_tpu.ops.precision import pdot


def bidiagonalize_gk(A):
    """Reduce ``A`` (m x n, m >= n) to upper-bidiagonal form.

    Returns ``(d, e)``: the diagonal (length n) and superdiagonal
    (length n-1) of ``B = U^T A V``.  Signs are reflector-dependent
    (as in the reference); singular values are ``|.|``-invariant.
    """
    m, n = A.shape
    if m < n:
        raise ValueError("bidiagonalize_gk requires m >= n; pass A.T instead")
    dtype = A.dtype
    d0 = jnp.zeros((n,), dtype)
    e0 = jnp.zeros((n,), dtype)  # slot n-1 is scratch, sliced off on return

    def body(j, carry):
        A, d, e = carry
        # Column reflector: eliminate below the diagonal in column j.
        v, tau, beta = householder_vector(A[:, j], j)
        A = A - tau * jnp.outer(v, pdot(v, A))
        d = d.at[j].set(beta)
        # Row reflector: eliminate right of the superdiagonal in row j.
        u, tau_r, beta_r = householder_vector(A[j, :], j + 1)
        A = A - tau_r * jnp.outer(pdot(A, u), u)
        e = e.at[jnp.minimum(j, n - 1)].set(beta_r)
        return A, d, e

    A, d, e = lax.fori_loop(0, n, body, (A, d0, e0))
    return d, e[: n - 1]


bidiagonalize_gk_jit = jax.jit(bidiagonalize_gk)
