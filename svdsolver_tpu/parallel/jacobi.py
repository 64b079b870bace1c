"""Multi-device one-sided block-Jacobi SVD: a systolic tournament.

The single-chip block Jacobi (models/jacobi.py) pairs ``nb`` column blocks
round-robin; every round's work is embarrassingly parallel across pairs.
This module distributes the pairs over the mesh's ``tp`` axis the classic
Brent-Luk way: each device owns TWO column blocks (its current pair), each
round does one local pair step — a (2b, 2b) Gram, an accumulated-rotation
local solve, and two (n, 2b) x (2b, 2b) GEMMs — and then the tournament
re-pairing becomes a **neighbor-only block exchange** (one ``ppermute`` up,
one down).  Per round each
device moves 2 blocks of n*b floats to neighbors; convergence is a ``pmax``
of the per-pair relative coupling.

Contrast with the two-stage pipeline's sharding (distributed.py): Stage I
shards a *sequential* panel sweep (psum-broadcast panels, O(n/band)
dependent steps), while the Jacobi tournament has NO sequential panel chain
— all devices factor concurrently every round, so compute scales ~1/P with
only neighbor traffic.  The reference has no distributed layer at all
(single process + one GPU — SURVEY.md section 2.8); both designs are
capabilities added on top of parity.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from svdsolver_tpu.ops.precision import pdot, get_lax_precision
from svdsolver_tpu.models.jacobi import (
    _eps_eff,
    _finalize,
    _local_rotations,
    _schedule_cols,
)

__all__ = ["svd_jacobi_sharded"]


def _round_robin_exchange(parts, axis, n_dev):
    """One circle-method rotation of each device's (top, bottom) blocks.

    Global arrangement: device i holds ring slots (a_i, b_i); a_0 is pinned
    and all other tokens rotate one step along
    ``a_1 -> a_2 -> ... -> a_{P-1} -> b_{P-1} -> ... -> b_0 -> a_1``:

    * new a_i = old a_{i-1} (i >= 2), new a_1 = old b_0, a_0 pinned;
    * new b_i = old b_{i+1} (i <= P-2), new b_{P-1} = old a_{P-1}.

    Both moves are nearest-neighbor: one ppermute shifting up (device 0
    contributes its BOTTOM block, everyone else their top) and one shifting
    down (bottom blocks), with the two ring ends resolved locally.

    ``parts``: list of (top, bottom) array pairs sharing the schedule (W and
    V blocks travel together).  Returns the re-paired list.
    """
    i_dev = lax.axis_index(axis)
    up = [(i, i + 1) for i in range(n_dev - 1)]
    down = [(i, i - 1) for i in range(1, n_dev)]
    out = []
    for top, bot in parts:
        msg_up = jnp.where(i_dev == 0, bot, top)
        recv_up = lax.ppermute(msg_up, axis, up)
        recv_dn = lax.ppermute(bot, axis, down)
        new_top = jnp.where(i_dev == 0, top, recv_up)
        new_bot = jnp.where(i_dev == n_dev - 1, top, recv_dn)
        out.append((new_top, new_bot))
    return out


def svd_jacobi_sharded(A, mesh, max_sweeps=30, tol=None):
    """Full SVD of one square matrix by multi-chip block Jacobi.

    Returns ``(U, s, Vh)`` with ``A ~= U @ diag(s) @ Vh`` (same accuracy
    class as :func:`~svdsolver_tpu.models.jacobi.svd_jacobi` — ~eps RELATIVE
    sigma error on graded spectra).  The iteration is fully distributed
    (each of the mesh's ``tp`` devices owns two column blocks of W and V);
    only the O(n^2) finalization (norms, sort, normalize) runs replicated.

    The dgejsv row/column-grading transpose heuristic runs on the host
    before sharding (two norm reductions), exactly as in the single-chip
    path.
    """
    m, n = A.shape
    if m != n:
        raise ValueError(f"square input required, got {A.shape}")
    n_dev = mesh.shape["tp"]
    if n_dev < 2:
        raise ValueError("need tp >= 2; use models.jacobi.svd_jacobi on one device")
    dtype = A.dtype
    eps_eff = _eps_eff(dtype)
    if tol is None:
        tol = float(np.sqrt(n)) * eps_eff

    # grading flip (host-side: one tiny reduction per axis)
    tiny = float(jnp.finfo(dtype).tiny)
    rn = jnp.linalg.norm(A, axis=1)
    cn = jnp.linalg.norm(A, axis=0)
    spread = lambda v: float(jnp.max(v)) / max(float(jnp.min(v)), tiny)
    flip = spread(rn) > spread(cn)
    if flip:
        A = A.T

    # gesvj-style input scaling (see models/jacobi.py): Gram products of
    # squared column norms overflow f32 for entries ~1e10 without it
    scale = jnp.max(jnp.abs(A))
    scale = jnp.where(
        jnp.logical_or(scale == 0, ~jnp.isfinite(scale)),
        jnp.ones((), dtype),
        scale,
    )
    A = A / scale

    b = -(-n // (2 * n_dev))  # block width: device pair width is 2b
    n_pad = 2 * n_dev * b
    Ap = jnp.pad(A, ((0, n_pad - n), (0, n_pad - n)))
    in_perms, in_iperms = _schedule_cols(2 * b, 1)
    prec = get_lax_precision()

    def body(W_loc, V_loc):  # (n_pad, 2b) column blocks per device
        nrounds = 2 * n_dev - 1

        def round_body(r, carry):
            W, V, off = carry
            G = pdot(W.T, W)  # (2b, 2b) pair Gram
            dg = jnp.maximum(jnp.diagonal(G), 0.0)
            gmax = lax.pmax(jnp.max(dg), "tp")
            floor = (eps_eff * eps_eff) * n_pad * gmax
            cross = jnp.abs(G[:b, b:])
            denom = jnp.sqrt(dg[:b, None] * dg[None, b:])
            alive = jnp.minimum(dg[:b, None], dg[None, b:]) > floor
            rel = jnp.where(alive, cross / jnp.maximum(denom, 1e-30), 0.0)
            off = jnp.maximum(off, lax.pmax(jnp.max(rel), "tp"))
            J = _local_rotations(G[None], in_perms, in_iperms, prec)[0]
            W = pdot(W, J)
            V = pdot(V, J)
            (Wt, Wb), (Vt, Vb) = _round_robin_exchange(
                [(W[:, :b], W[:, b:]), (V[:, :b], V[:, b:])], "tp", n_dev
            )
            return (
                jnp.concatenate([Wt, Wb], axis=1),
                jnp.concatenate([Vt, Vb], axis=1),
                off,
            )

        def sweep_body(state):
            W, V, off_prev, stall, it = state
            W, V, off = lax.fori_loop(
                0, nrounds, round_body, (W, V, jnp.zeros((), dtype))
            )
            # two-consecutive-bounce floor rule, as in the single-chip solver
            bounced = jnp.logical_and(off < 1e-2, off >= off_prev)
            stall = jnp.where(bounced, stall + 1, 0)
            return W, V, off, stall, it + 1

        def sweep_cond(state):
            _, _, off, stall, it = state
            return jnp.logical_and(
                it < max_sweeps, jnp.logical_and(off > tol, stall < 2)
            )

        big = jnp.full((), jnp.inf, dtype)
        init = (
            W_loc, V_loc, big,
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
        )
        W_loc, V_loc, *_ = lax.while_loop(sweep_cond, sweep_body, init)
        return W_loc, V_loc

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(None, "tp"), P(None, "tp")),
            out_specs=(P(None, "tp"), P(None, "tp")),
            check_vma=False,
        )
    )
    Wsh = jax.device_put(Ap, NamedSharding(mesh, P(None, "tp")))
    Vsh = jax.device_put(
        jnp.eye(n_pad, dtype=dtype), NamedSharding(mesh, P(None, "tp"))
    )
    W, V = fn(Wsh, Vsh)

    # finalization is O(n^2) data movement: replicate and reuse the
    # single-chip tail (sort / normalize / dead-column zeroing / flip swap)
    W = jax.device_put(W, NamedSharding(mesh, P()))
    V = jax.device_put(V, NamedSharding(mesh, P()))
    fin = functools.partial(_finalize, n=n, flip=jnp.asarray(flip), eps_eff=eps_eff)
    U, s, Vh = jax.jit(fin)(W, V)
    return U, s * scale, Vh
