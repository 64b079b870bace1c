"""Householder reflector primitives.

Design notes
------------
The reference builds a *materialized* (m-j)x(m-j) matrix ``H = I - tau w w'``
for every column and multiplies it into the trailing matrix
(reference: svd_serial.h:189-216, the `transform` member) — an O(n^4) total.
Here a reflector is only ever the pair ``(v, tau)`` and is applied as a rank-1
update ``A - tau * v (v'A)``; blocked algorithms aggregate reflectors with
compact-WY (see ops/wy.py) so the FLOPs land in large GEMMs.

Because XLA requires static shapes, reflectors are computed over *full-length*
vectors with an index mask selecting the active part: ``v`` is zero at indices
``< p``, one at the pivot ``p``, and the tail holds the scaled input.  Applying
such a reflector to the full matrix is mathematically a no-op on the inactive
rows/columns, so no dynamic slicing is needed anywhere in the hot loops.
"""

import jax.numpy as jnp

from svdsolver_tpu.ops.precision import pdot


def householder_vector(x, p):
    """Compute a Householder reflector for the tail ``x[p:]`` of a vector.

    Returns ``(v, tau, beta)`` with ``v`` the same length as ``x`` such that
    ``H = I - tau * v v^T`` satisfies ``(H x')[p] = beta`` and ``(H x')[i] = 0``
    for ``i > p``, where ``x'`` is ``x`` with indices ``< p`` ignored.
    ``v[p] == 1`` and ``v[i] == 0`` for ``i < p`` so that applying ``H`` to a
    full matrix leaves rows ``< p`` untouched.

    Mirrors the role of the reference's ``householder()``
    (svd_serial.h:189, svd_cpu.h:153, svd_cuda_2.cu:797) with LAPACK
    ``larfg``-style scaling: ``beta = -sign(x[p]) * ||x[p:]||``,
    ``tau = (beta - x[p]) / beta``, ``v = x / (x[p] - beta)``.

    ``p`` may be a traced index; out-of-range pivots degenerate to the
    identity reflector (``tau == 0``).
    """
    L = x.shape[0]
    dtype = x.dtype
    idx = jnp.arange(L)
    tail = idx > p
    xt = jnp.where(tail, x, jnp.zeros((), dtype))
    pivot = jnp.where(p < L, x[jnp.minimum(p, L - 1)], jnp.zeros((), dtype))
    sigma2 = jnp.sum(xt * xt)
    norm = jnp.sqrt(pivot * pivot + sigma2)
    sign = jnp.where(pivot >= 0, jnp.ones((), dtype), -jnp.ones((), dtype))
    beta = -sign * norm
    # Degenerate: tail is all zero (includes p >= L-1) -> identity reflector.
    trivial = sigma2 == 0
    denom = jnp.where(trivial, jnp.ones((), dtype), pivot - beta)
    v = jnp.where(tail, xt / denom, jnp.zeros((), dtype))
    v = v.at[jnp.minimum(p, L - 1)].set(
        jnp.where(p < L, jnp.ones((), dtype), v[jnp.minimum(p, L - 1)])
    )
    safe_beta = jnp.where(beta == 0, jnp.ones((), dtype), beta)
    tau = jnp.where(trivial, jnp.zeros((), dtype), (beta - pivot) / safe_beta)
    beta_out = jnp.where(trivial, pivot, beta)
    return v, tau, beta_out


def apply_left(A, v, tau):
    """``A <- (I - tau v v^T) A`` as a rank-1 update (rows with v==0 untouched)."""
    w = pdot(v, A)
    return A - tau * jnp.outer(v, w)


def apply_right(A, v, tau):
    """``A <- A (I - tau v v^T)`` as a rank-1 update (cols with v==0 untouched)."""
    w = pdot(A, v)
    return A - tau * jnp.outer(w, v)
