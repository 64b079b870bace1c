"""Blocked one-stage bidiagonalization — the "singlecore" model.

Capability parity with the reference's ``serial::block_brd``
(svd_serial.h:441-536): panel-wise compact-WY bidiagonal reduction where each
panel accumulates ``V, Y, X, U`` such that the trailing matrix is updated once
per panel as ``A <- A - V Y^T - X U^T`` (two large GEMMs).

Differences from the reference:

* the reference re-materializes ``A - VY' - XU'`` for the *entire* trailing
  matrix before every panel column (svd_serial.h:566-571) — an O(m n b) cost
  per column.  Here the current column/row are formed lazily from the low-rank
  correction (LAPACK ``labrd``-style), so the panel loop is GEMV-sized;
* static shapes: all reflectors are full-length masked vectors, the panel loop
  is a ``lax.fori_loop`` over global column indices, and ragged trailing
  widths never appear (inactive regions are zero and therefore no-ops).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.householder import householder_vector
from svdsolver_tpu.ops.precision import pdot


@functools.partial(jax.jit, static_argnames=("panel",))
def bidiagonalize_blocked(A, panel=32):
    """Reduce ``A`` (m x n, m >= n) to upper-bidiagonal form; returns ``(d, e)``.

    ``panel`` is the block width (the reference's ``b_size``; its CPU-mirror
    hardcodes 8 at svd_cpu.h:444).  Any ``n`` works — out-of-range panel
    columns degenerate to identity reflectors.
    """
    m, n = A.shape
    if m < n:
        raise ValueError("bidiagonalize_blocked requires m >= n")
    dtype = A.dtype
    b = int(panel)
    n_panels = -(-n // b)
    d0 = jnp.zeros((n,), dtype)
    e0 = jnp.zeros((n,), dtype)  # slot n-1 is scratch

    def panel_body(k, carry):
        A, d, e = carry
        c = k * b
        V = jnp.zeros((m, b), dtype)
        Y = jnp.zeros((n, b), dtype)
        X = jnp.zeros((m, b), dtype)
        U = jnp.zeros((n, b), dtype)

        def col_body(j, pcarry):
            V, Y, X, U, d, e = pcarry
            g = c + j
            g_ok = g < n
            gc = jnp.minimum(g, n - 1)
            # Current column of A_hat = A - V Y^T - X U^T, formed lazily.
            col = A[:, gc] - pdot(V, Y[gc, :]) - pdot(X, U[gc, :])
            v, tau, beta = householder_vector(col, g)
            tau = jnp.where(g_ok, tau, jnp.zeros((), dtype))
            d = d.at[gc].set(jnp.where(g_ok, beta, d[gc]))
            # y = tau * A_hat^T v  (left-update row for the trailing matrix)
            y = tau * (pdot(A.T, v) - pdot(Y, pdot(V.T, v)) - pdot(U, pdot(X.T, v)))
            V = V.at[:, j].set(jnp.where(g_ok, v, jnp.zeros((m,), dtype)))
            Y = Y.at[:, j].set(y)
            # Current row g of A_hat (now including the column reflector).
            row = A[gc, :] - pdot(Y, V[gc, :]) - pdot(U, X[gc, :])
            u, tau_r, beta_r = householder_vector(row, g + 1)
            tau_r = jnp.where(g_ok, tau_r, jnp.zeros((), dtype))
            e = e.at[gc].set(jnp.where(g_ok, beta_r, e[gc]))
            # x = tau_r * A_hat u  (right-update column)
            x = tau_r * (pdot(A, u) - pdot(V, pdot(Y.T, u)) - pdot(X, pdot(U.T, u)))
            X = X.at[:, j].set(x)
            U = U.at[:, j].set(jnp.where(g_ok, u, jnp.zeros((n,), dtype)))
            return V, Y, X, U, d, e

        V, Y, X, U, d, e = lax.fori_loop(0, b, col_body, (V, Y, X, U, d, e))
        # Deferred trailing update: two big GEMMs (reference: svd_serial.h:525).
        A = A - pdot(V, Y.T) - pdot(X, U.T)
        return A, d, e

    A, d, e = lax.fori_loop(0, n_panels, panel_body, (A, d0, e0))
    return d, e[: n - 1]
