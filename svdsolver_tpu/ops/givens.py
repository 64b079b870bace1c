"""Stable Givens rotation parameters, branchless.

Mirrors the reference's three-branch ``rotate()`` (svd_serial.h:277-297) but
computed with ``jnp.where`` selects instead of data-dependent branches so it
vectorizes/vmaps cleanly inside ``lax`` loops.
"""

import jax.numpy as jnp


def givens(f, g):
    """Return ``(c, s, r)`` with ``[c s; -s c]^T [f; g] = [r; 0]``.

    Branches (matching svd_serial.h:277):
      * ``f == 0``          -> (0, 1, g)
      * ``|f| > |g|``       -> t = g/f, tt = sqrt(1+t^2); (1/tt, t/tt, f*tt)
      * otherwise           -> t = f/g, tt = sqrt(1+t^2); (t/tt, 1/tt, g*tt)
    """
    dtype = jnp.result_type(f, g)
    f = jnp.asarray(f, dtype)
    g = jnp.asarray(g, dtype)
    one = jnp.ones((), dtype)
    af, ag = jnp.abs(f), jnp.abs(g)
    f_dom = af > ag

    safe_f = jnp.where(f == 0, one, f)
    safe_g = jnp.where(g == 0, one, g)

    # |f| > |g| branch
    t1 = g / safe_f
    tt1 = jnp.sqrt(1 + t1 * t1)
    c1, s1, r1 = 1 / tt1, t1 / tt1, f * tt1

    # |g| >= |f| branch
    t2 = f / safe_g
    tt2 = jnp.sqrt(1 + t2 * t2)
    c2, s2, r2 = t2 / tt2, 1 / tt2, g * tt2

    c = jnp.where(f_dom, c1, c2)
    s = jnp.where(f_dom, s1, s2)
    r = jnp.where(f_dom, r1, r2)

    # f == 0 branch (covers g == 0 too: -> (0, 1, 0))
    zero = jnp.zeros((), dtype)
    c = jnp.where(f == 0, zero, c)
    s = jnp.where(f == 0, one, s)
    r = jnp.where(f == 0, g, r)
    return c, s, r
