"""Pallas kernel (Triton route): bidiagonal singular values by bisection.

Same algorithm as :func:`svdsolver_tpu.models.diagonalize.bisect_svdvals`
(Sturm counts on the Golub-Kahan tridiagonal ``TGK``, all n values
bracketed at once), laid out for a GPU:

* **Grid over lanes.**  Lane ``k`` brackets the k-th smallest value; a
  program owns ``block`` lanes, one lane per thread, and nothing is
  carried between programs.  ``block = 32`` keeps the grid at 120 programs
  for n = 3840 and 240 for n = 7680, so every SM gets work.
* **One launch.**  The XLA reference runs ``iters x (2n - 1)`` dependent
  loop steps, each an n-lane launch.  Here both loops run inside the
  kernel and every lane keeps its pivot chain in registers.
* **Twisted count.**  Forward pivots ``p_i = -lam - z_{i-1}^2 / p_{i-1}``
  from the top and backward pivots ``q_i = -lam - z_i^2 / q_{i+1}`` from
  the bottom advance in the same loop step (independent chains) and meet
  at the twist index ``m = n + 1``, where Sylvester's inertia gives
  ``#neg = #neg(p_1..p_n) + #neg(q_{n+2}..q_{2n}) + (gamma < 0)`` with
  ``gamma = p_{n+1} + q_{n+1} + lam``.  The dependent depth is n steps per
  count, not 2n.
* **Scalar reads.**  Each step reads one ``z^2`` per chain as a scalar
  load shared by every lane of the program.

The recurrence is dtype-generic: float32 and float64 both run natively.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from svdsolver_tpu.models.diagonalize import bisect_iters, tgk_bisect_inputs

BLOCK = 32  # lanes per program: one warp, one lane per thread


def _bisect_kernel(target_ref, z2f_ref, z2r_ref, bound_ref, out_ref, *, n,
                   iters, block):
    dtype = out_ref.dtype
    target = target_ref[...]  # lane k brackets the k-th smallest value
    one = jnp.ones((block,), jnp.int32)
    nil = jnp.zeros((block,), jnp.int32)

    def count_below(lam):
        """#(sigma < lam) per lane, from the twisted TGK factorization."""
        p = -lam  # p_1
        q = -lam  # q_{2n}
        cnt = jnp.where(p < 0, one, nil) * 2

        def step(j, carry):
            p, q, cnt = carry
            p = -lam - z2f_ref[j] / p  # p_{j+2}
            q = -lam - z2r_ref[j] / q  # q_{2n-1-j}
            cnt = cnt + jnp.where(p < 0, one, nil) + jnp.where(q < 0, one, nil)
            return p, q, cnt

        p, q, cnt = lax.fori_loop(jnp.int32(0), jnp.int32(n - 1), step, (p, q, cnt))
        p = -lam - z2f_ref[n - 1] / p  # p_{n+1}
        gamma = p + q + lam
        # q_{n+1} was counted in the loop but belongs to the twist
        cnt = cnt - jnp.where(q < 0, one, nil) + jnp.where(gamma < 0, one, nil)
        return cnt - n  # TGK eigenvalues below lam, minus the n negative ones

    def biter(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        above = count_below(mid) > target
        return jnp.where(above, lo, mid), jnp.where(above, mid, hi)

    lo = jnp.zeros((block,), dtype)
    hi = jnp.full((block,), bound_ref[0], dtype)
    lo, hi = lax.fori_loop(jnp.int32(0), jnp.int32(iters), biter, (lo, hi))
    out_ref[...] = 0.5 * (lo + hi)


@functools.partial(jax.jit, static_argnames=("iters", "interpret"))
def bisect_svdvals_triton(d, e, iters=None, interpret=False):
    """Singular values of the bidiagonal {d, e}, descending.

    Drop-in for :func:`svdsolver_tpu.models.diagonalize.bisect_svdvals`;
    ``interpret=True`` runs the kernel through the Pallas interpreter
    (any backend), which is how it is tested without a GPU.
    """
    n = d.shape[0]
    dtype = d.dtype
    if n == 1:
        return jnp.abs(d)
    if iters is None:
        iters = bisect_iters(dtype)
    z2, bound = tgk_bisect_inputs(d, e)
    z2f = z2[:n]  # forward chain reads z_1^2 .. z_n^2
    z2r = z2[n:][::-1]  # backward chain reads z_{2n-1}^2 .. z_{n+1}^2
    npad = pl.cdiv(n, BLOCK) * BLOCK
    out = pl.pallas_call(
        functools.partial(_bisect_kernel, n=n, iters=int(iters), block=BLOCK),
        grid=(npad // BLOCK,),
        in_specs=[
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            pl.BlockSpec((n,), lambda i: (0,)),
            pl.BlockSpec((n - 1,), lambda i: (0,)),
            pl.BlockSpec((1,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((BLOCK,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((npad,), dtype),
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        backend="triton",
        name="bisect_svdvals",
    )(jnp.arange(npad, dtype=jnp.int32), z2f, z2r, jnp.reshape(bound, (1,)))
    return out[:n][::-1]
