"""Pallas kernel (Triton route): the shifted TGK solve of inverse iteration.

Solves ``(TGK - diag-per-lane(lam)) x = rhs`` for every shift lane at once:
the computation of :func:`svdsolver_tpu.models.vectors.tgk_solve_xla`
(tridiagonal LU with partial pivoting and a band-2 upper factor, followed
by back substitution), laid out for a GPU:

* **Grid over lanes.**  A program owns ``block`` lanes (columns of
  ``rhs``), one per thread; lanes are independent problems, so nothing is
  carried between programs.
* **Rows inside the program.**  The elimination and the back substitution
  are loops over the 2n rows inside one launch; the XLA reference runs
  them as two ``lax.scan``s with a launch per step.  The factor rows
  (pivot, two upper entries, transformed rhs) go to global memory on the
  way down and are read back on the way up.
* **Scalar reads.**  The per-row off-diagonals ``z[k]`` and ``z[k+1]`` are
  scalar loads shared by every lane of the program.
* The generic elimination's third upper-diagonal carry is identically zero
  for a tridiagonal, so only ``p2 = swap ? z[k+1] : 0`` is kept.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

BLOCK = 32  # lanes per program: one warp, one lane per thread


def _tgk_kernel(
    za_ref, zc_ref, lam_ref, rhs_ref, scal_ref,
    sol_ref, u0_ref, u1_ref, u2_ref, r_ref, *, N,
):
    pivmin = scal_ref[0]
    big = scal_ref[1]
    lam = lam_ref[...]
    zero = jnp.zeros_like(lam)
    bi = -lam

    def clamp(p):
        return jnp.where(
            jnp.abs(p) < pivmin, jnp.where(p < 0, -pivmin, pivmin), p
        )

    def fwd(k, carry):
        b, cc, y = carry
        ai = za_ref[k]
        ci = zc_ref[k]
        yi = rhs_ref[k + 1]
        swap = jnp.abs(ai) > jnp.abs(b)
        p0 = jnp.where(swap, ai, b)
        p1 = jnp.where(swap, bi, cc)
        p2 = jnp.where(swap, ci, zero)
        py = jnp.where(swap, yi, y)
        q0 = jnp.where(swap, b, ai)
        q1 = jnp.where(swap, cc, bi)
        q2 = jnp.where(swap, zero, ci)
        qy = jnp.where(swap, y, yi)
        safe = clamp(p0)
        mlt = q0 / safe
        u0_ref[k] = safe
        u1_ref[k] = p1
        u2_ref[k] = p2
        r_ref[k] = py
        return q1 - mlt * p1, q2 - mlt * p2, qy - mlt * py

    init = (bi, jnp.full(lam.shape, za_ref[0], lam.dtype), rhs_ref[0])
    b, _, y = lax.fori_loop(jnp.int32(0), jnp.int32(N - 1), fwd, init)
    # last row: pivot clamp(b), no upper entries
    v = jnp.clip(y / clamp(b), -big, big)
    sol_ref[N - 1] = v

    def bwd(j, carry):
        s1, s2 = carry
        k = N - 2 - j
        v = (r_ref[k] - u1_ref[k] * s1 - u2_ref[k] * s2) / u0_ref[k]
        v = jnp.clip(v, -big, big)  # bound growth; see pivmin in the caller
        sol_ref[k] = v
        return v, s1

    lax.fori_loop(jnp.int32(0), jnp.int32(N - 1), bwd, (v, zero))


@functools.partial(jax.jit, static_argnames=("interpret",))
def tgk_solve_triton(z, lam, rhs, pivmin, big, interpret=False):
    """Drop-in for :func:`svdsolver_tpu.models.vectors.tgk_solve_xla`.

    ``z``: (N-1,) TGK off-diagonals, ``lam``: (n,) per-lane shifts,
    ``rhs``: (N, n).  Lanes are padded to a whole number of blocks with
    shift 1 and zero rhs (an independent, harmless problem each) and
    sliced away on return.
    """
    N, n = rhs.shape
    dtype = rhs.dtype
    npad = pl.cdiv(n, BLOCK) * BLOCK
    lam_p = jnp.pad(lam, (0, npad - n), constant_values=1.0)
    rhs_p = jnp.pad(rhs, ((0, 0), (0, npad - n)))
    zc = jnp.concatenate([z[1:], jnp.zeros((1,), dtype)])
    scal = jnp.stack([pivmin, big]).astype(dtype)

    rows = lambda m: pl.BlockSpec((m, BLOCK), lambda i: (0, i))
    full = lambda m: pl.BlockSpec((m,), lambda i: (0,))
    factor = jax.ShapeDtypeStruct((N - 1, npad), dtype)
    sol, *_ = pl.pallas_call(
        functools.partial(_tgk_kernel, N=N),
        grid=(npad // BLOCK,),
        in_specs=[
            full(N - 1),
            full(N - 1),
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            rows(N),
            full(2),
        ],
        out_specs=[rows(N)] + [rows(N - 1)] * 4,
        out_shape=[jax.ShapeDtypeStruct((N, npad), dtype)] + [factor] * 4,
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=2),
        interpret=interpret,
        backend="triton",
        name="tgk_solve",
    )(z, zc, lam_p, rhs_p, scal)
    return sol[:, :n]
