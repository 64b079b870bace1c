"""Tiled Stage-I dense->band reduction — the reference's "multicore" tile
algorithm (brd_p1, svd_parallel.h:410-533) rebuilt in JAX.

The reference factors the diagonal tile (``factor_1tile``), TS-factors each
sub-diagonal tile against the diagonal R (``factor_2tile``,
triangle-on-top-of-square), and fans the updates across the tile row with
OpenMP (``apply_1tile``/``apply_2tile``, omp at svd_parallel.h:477).

Here each tile factorization operates on a full-width row slab so the
"apply across the row" is fused into the factorization's rank-1 updates
(the omp-for-j fan-out becomes column vectorization — XLA's native axis):

* diagonal step: Householder columns of the (t, n) slab at rows [c, c+t);
* TS step: the (2t, n) stack of the diagonal slab and tile-row i's slab —
  the R part is already upper-triangular, so plain contiguous-tail
  reflectors on the stack reproduce the TS structure exactly (the
  triangle's zeros make the reflector skip those rows).

The LQ mirror runs on the transpose.  Produces the same band *class* as the
panel-sweep ``dense_to_band`` (different reflector order -> elementwise
different band, identical singular values).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.precision import pdot


def _slab_factor_step(S, col, piv_row):
    """One Householder step on slab ``S``: reflector from column ``col``
    (dynamic) with contiguous tail below local ``piv_row`` (dynamic), applied
    full-width.  Returns the updated slab."""
    dtype = S.dtype
    rows = S.shape[0]
    ridx = jnp.arange(rows)
    x = S[:, col]
    tail = ridx > piv_row
    xt = jnp.where(tail, x, jnp.zeros((), dtype))
    pivot = x[jnp.minimum(piv_row, rows - 1)]
    sigma2 = jnp.sum(xt * xt)
    norm = jnp.sqrt(pivot * pivot + sigma2)
    sign = jnp.where(pivot >= 0, jnp.ones((), dtype), -jnp.ones((), dtype))
    beta = -sign * norm
    trivial = sigma2 == 0
    denom = jnp.where(trivial, jnp.ones((), dtype), pivot - beta)
    v = jnp.where(tail, xt / denom, jnp.zeros((), dtype))
    v = v.at[jnp.minimum(piv_row, rows - 1)].set(
        jnp.where(piv_row < rows, jnp.ones((), dtype), v[jnp.minimum(piv_row, rows - 1)])
    )
    safe_beta = jnp.where(beta == 0, jnp.ones((), dtype), beta)
    tau = jnp.where(trivial, jnp.zeros((), dtype), (beta - pivot) / safe_beta)
    return S - tau * jnp.outer(v, pdot(v, S))


def _factor_1slab(A, c, t):
    """factor_1tile + apply_1tile (svd_parallel.h:295/:346): QR of the
    diagonal tile with the row-k application fused (full-width slab)."""
    n = A.shape[1]
    S = lax.dynamic_slice(A, (c, 0), (t, n))

    def step(j, S):
        return _slab_factor_step(S, c + j, j)

    S = lax.fori_loop(0, t, step, S)
    return lax.dynamic_update_slice(A, S, (c, 0))


def _factor_2slab(A, c, ri, t):
    """factor_2tile + apply_2tile (svd_parallel.h:316/:372): TS-factor tile
    (i, k) against the diagonal R, updates fused across both tile rows."""
    n = A.shape[1]
    top = lax.dynamic_slice(A, (c, 0), (t, n))
    bot = lax.dynamic_slice(A, (ri, 0), (t, n))
    S = jnp.concatenate([top, bot], axis=0)  # (2t, n)

    def step(j, S):
        # pivot: R diagonal (local row j); tail: rows of tile i (the zeros of
        # R below its diagonal make the contiguous tail exactly TS-shaped)
        return _slab_factor_step(S, c + j, j)

    S = lax.fori_loop(0, t, step, S)
    A = lax.dynamic_update_slice(A, S[:t], (c, 0))
    return lax.dynamic_update_slice(A, S[t:], (ri, 0))


@functools.partial(jax.jit, static_argnames=("band",))
def dense_to_band_tiled(A, band=32):
    """Tiled Stage I (reference brd_p1): reduce square ``A`` to upper-band
    form with ``band`` superdiagonals via tile QR/LQ sweeps."""
    n = A.shape[0]
    t = int(band)
    if A.shape[0] != A.shape[1]:
        raise ValueError("dense_to_band_tiled expects a square matrix")
    if n % t != 0:
        raise ValueError(f"n={n} must be divisible by band={t}")
    nbt = n // t

    def qr_tile_col(k, A):
        c = k * t
        A = _factor_1slab(A, c, t)

        def ts(i, A):
            return _factor_2slab(A, c, i * t, t)

        return lax.fori_loop(k + 1, nbt, ts, A)

    def lq_tile_row(k, At):
        # rows [c, c+t) of A = columns of At; pivots at band offset c+t.
        c = k * t
        St = lax.dynamic_slice(At, (c + t, 0), (t, n))

        def step(j, St):
            return _slab_factor_step(St, c + j, j)

        St = lax.fori_loop(0, t, step, St)
        At = lax.dynamic_update_slice(At, St, (c + t, 0))

        def ts(i, At):
            top = lax.dynamic_slice(At, (c + t, 0), (t, n))
            bot = lax.dynamic_slice(At, (i * t, 0), (t, n))
            S = jnp.concatenate([top, bot], axis=0)

            def step2(j, S):
                return _slab_factor_step(S, c + j, j)

            S = lax.fori_loop(0, t, step2, S)
            At = lax.dynamic_update_slice(At, S[:t], (c + t, 0))
            return lax.dynamic_update_slice(At, S[t:], (i * t, 0))

        return lax.fori_loop(k + 2, nbt, ts, At)

    def tile_sweep(k, A):
        A = qr_tile_col(k, A)
        # last tile column has no beyond-band rows to eliminate (and the
        # slab slice would clamp into genuine data)
        return lax.cond(
            k < nbt - 1, lambda A: lq_tile_row(k, A.T).T, lambda A: A, A
        )

    return lax.fori_loop(0, nbt, tile_sweep, A)
