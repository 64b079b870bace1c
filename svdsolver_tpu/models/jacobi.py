"""One-sided block-Jacobi SVD — an all-GEMM algorithm family.

No reference counterpart (the reference implements bidiagonalization-based
methods only: svd_serial.h:233 ``brd``, svd_parallel.h:411 ``brd_p1``).
Added because block Jacobi is the natural *second* SVD algorithm for
matrix units, with a compute shape completely different from the
two-stage pipeline's:

* Every sweep is a round-robin tournament over column blocks.  Each round
  pairs all blocks into disjoint couples, so every pair's work — a batched
  ``(2b, 2b)`` Gram contraction, a batched rotation solve, and a batched
  ``(n, 2b) @ (2b, 2b)`` column update — runs as ONE big batched GEMM with
  no sequential dependence inside the round.  There is no panel bottleneck
  and no bulge chase: the whole algorithm is GEMM-dense.
* One-sided Jacobi never forms the full Gram matrix A'A; each rotation is
  computed from a (2b, 2b) Gram of two column blocks and applied to the
  columns directly, which preserves small singular values far better than
  normal-equation methods: on graded matrices the computed sigma carry
  ~eps RELATIVE error across 12 decades (see tests/test_jacobi.py), an
  accuracy class bidiagonalization-based methods cannot reach.
* The column blocks shard naturally over a device mesh (block pairs per
  chip, rotations exchanged by collective permute), which the
  bidiagonalization pipeline's Stage II cannot do.

Algorithm (Hestenes one-sided Jacobi, blocked):

    W <- A (or A' when rows are more graded than columns); V <- I
    repeat (sweep):
      for each tournament round (nb-1 rounds pairing all nb blocks):
        for each pair (p, q) in parallel:
          G = [Wp Wq]' [Wp Wq]                    (2b x 2b Gram)
          J = accumulated scalar Jacobi rotations on G
          [Wp Wq] <- [Wp Wq] J ; [Vp Vq] <- [Vp Vq] J
    until max relative cross-block coupling < tol
    sigma_i = ||W[:, i]|| ; U = W / sigma ; Vh = V'

The local solver matters: an eigendecomposition of G also orthogonalizes
the pair, but its eigenvector matrix is an arbitrary orthogonal matrix —
far from identity even when G is nearly diagonal — which violates the
Forsythe–Henrici closeness-to-identity condition and makes the outer
iteration stagnate (measured: random 256^2 stalls at coupling ~0.9).  The
convergent choice is a J that is itself a product of scalar Jacobi
rotations: each rotation angle -> 0 as the off-diagonal -> 0, so J -> I
near convergence and the classic quadratic tail appears (random fp32
matrices converge in ~8-12 sweeps).  One inner parallel-ordered sweep over
G per visit suffices (measured equal to 2 inner sweeps in outer-sweep
count on random/graded/Hilbert test matrices).

Row-graded inputs (A = D*B with D graded) converge slowly in this column
metric — the decoupling front grinds down the spectrum roughly one decade
per two sweeps (measured: 41 sweeps for 12 decades vs 8 via the
transpose).  Since the SVD of A' is the SVD of A with U and V swapped, the
solver runs on whichever of A / A' has the smaller row-norm spread
(LAPACK's dgejsv applies the same heuristic) — chosen with elementwise
``where`` so the whole solve stays jittable.

Use Jacobi when the ACCURACY CLASS matters (graded / ill-scaled spectra
need relative sigma error) or for the multi-device tournament
(parallel/jacobi.py); its speed against the two-stage pipeline on the GPU
is not measured yet.

Rank-deficiency note: singular vectors attached to sigma ~= 0 are returned
as zero columns (W's null columns carry no direction information); the
reconstruction ``U @ diag(s) @ Vh ~= A`` always holds, but U/V are only
column-orthonormal on the numerical range.  Use ``svd(A, method="tpu2")``
when a fully orthonormal null-space basis is required.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.precision import pdot, get_lax_precision

__all__ = ["svd_jacobi", "svd_jacobi_batch"]


def _tournament(nb):
    """Round-robin schedule: (nb-1, nb) block orderings, pairs adjacent.

    Circle method: block 0 is pinned, blocks 1..nb-1 rotate.  Round r pairs
    (0, rot[0]) and (rot[i], rot[nb-1-i]); the returned row lists the 2*i
    and 2*i+1 slots of pair i consecutively, so reshaping columns grouped by
    the row order yields (npairs, 2b) pair groups directly.
    """
    assert nb % 2 == 0 and nb >= 2
    rounds = np.empty((nb - 1, nb), dtype=np.int32)
    others = list(range(1, nb))
    for r in range(nb - 1):
        rot = others[r:] + others[:r]
        row = [0, rot[0]]
        for i in range(1, nb // 2):
            row += [rot[i], rot[nb - 1 - i]]
        rounds[r] = row
    return rounds


def _schedule_cols(n_pad, b):
    """Column permutations (nb-1, n_pad) + inverses for the tournament."""
    nb = n_pad // b
    rounds = _tournament(nb)
    base = np.arange(n_pad, dtype=np.int32).reshape(nb, b)
    perms = base[rounds].reshape(nb - 1, n_pad)
    iperms = np.argsort(perms, axis=1).astype(np.int32)
    return jnp.asarray(perms), jnp.asarray(iperms)


def _rotation_params(app, aqq, apq, eps):
    """Stable scalar Jacobi (c, s) zeroing G[p,q]; identity when negligible.

    Standard Rutishauser formulas: tau = (aqq-app)/(2 apq),
    t = sign(tau)/(|tau| + sqrt(1+tau^2)), c = 1/sqrt(1+t^2), s = t*c.
    The rotation is skipped (c=1, s=0) when |apq| is negligible relative to
    sqrt(app*aqq) — both for speed of convergence bookkeeping and so fully
    converged pairs are bitwise fixed points.
    """
    small = jnp.abs(apq) <= eps * jnp.sqrt(jnp.maximum(app * aqq, 0.0))
    denom = jnp.where(apq == 0, 1.0, 2.0 * apq)
    tau = (aqq - app) / denom
    sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(app.dtype)
    # sqrt(1 + tau^2) without forming tau^2: near convergence tau ~ 1/apq
    # blows past the f32 RANGE, so square only a ratio <= 1 and rescale.
    # |tau| >= 1: sqrt(1+tau^2) = |tau| * sqrt(1 + tau^-2); inf stays inf
    # -> t = 0, the correct limit.
    at = jnp.abs(tau)
    big = at >= 1.0
    r = jnp.where(big, 1.0 / jnp.maximum(at, 1.0), at)  # <= 1, safe to square
    root = jnp.sqrt(1.0 + r * r)
    t = sgn / (at + jnp.where(big, at * root, root))
    t = jnp.where(small, 0.0, t)
    c = lax.rsqrt(1.0 + t * t)
    return c, t * c


def _local_rotations(G, perms, iperms, prec):
    """Accumulated-rotation local solver for a batch of pair Grams.

    G: (P, w, w) symmetric.  Runs ONE parallel-ordered scalar-Jacobi sweep
    (w-1 rounds of w/2 disjoint rotations, batched over P and over the
    rotations of a round) and returns the accumulated orthogonal J with
    G_new = J' G J nearly diagonal.  Unlike an eigendecomposition, J is a
    product of rotations and -> I as offdiag(G) -> 0, which is what makes
    the OUTER block iteration converge (see module docstring).  ``prec``
    must be fp32-accurate (HIGHEST, never TF32): J is a product of O(w)
    rotation applications, and reduced-precision contractions destroy its
    orthogonality (and with it the factorization) within a few sweeps.
    """
    P, w, _ = G.shape
    h = w // 2
    dtype = G.dtype
    eps = jnp.finfo(dtype).eps
    J0 = jnp.broadcast_to(jnp.eye(w, dtype=dtype), G.shape)
    nrounds = perms.shape[0]

    def round_body(r, carry):
        G, J = carry
        perm, iperm = perms[r], iperms[r]
        # permute rows+cols so this round's pairs are adjacent
        Gp = jnp.take(jnp.take(G, perm, axis=1), perm, axis=2)
        blk = jnp.einsum(
            "pkakb->pkab", Gp.reshape(P, h, 2, h, 2)
        )  # (P, h, 2, 2) diagonal 2x2 blocks
        c, s = _rotation_params(
            blk[:, :, 0, 0], blk[:, :, 1, 1], blk[:, :, 0, 1], eps
        )
        # R[k] = [[c, s], [-s, c]] applied as G' = R' G R per pair
        R = jnp.stack(
            [jnp.stack([c, s], axis=-1), jnp.stack([-s, c], axis=-1)],
            axis=-2,
        )  # (P, h, 2, 2)
        Gc = jnp.einsum(
            "pmki,pkia->pmka", Gp.reshape(P, w, h, 2), R, precision=prec
        )
        Gr = jnp.einsum(
            "pkim,pkia->pkam", Gc.reshape(P, h, 2, w), R, precision=prec
        ).reshape(P, w, w)
        G = jnp.take(jnp.take(Gr, iperm, axis=1), iperm, axis=2)
        Jp = jnp.take(J, perm, axis=2)
        Jc = jnp.einsum(
            "pmki,pkia->pmka", Jp.reshape(P, w, h, 2), R, precision=prec
        )
        J = jnp.take(Jc.reshape(P, w, w), iperm, axis=2)
        return G, J

    _, J = lax.fori_loop(0, nrounds, round_body, (G, J0))
    return J


def _jacobi_round(W, V, perm, iperm, in_perms, in_iperms, b, eps_eff):
    """Apply one tournament round of disjoint pair rotations to (W, V).

    Returns the updated (W, V) and the maximum relative cross-block
    coupling measured BEFORE this round's rotations (the sweep converges
    when every pair it visited was already decoupled), masked to live
    columns: pairs where either column's norm is below the dead-column
    floor eps_eff*sqrt(n)*max_colnorm carry no signal (they represent
    sigma that round to zero at working precision) and are excluded so
    rank-deficient inputs terminate.
    """
    m = W.shape[0]
    n_pad = W.shape[1]
    npairs = n_pad // (2 * b)
    prec = get_lax_precision()
    eps = eps_eff

    def group(M):
        # columns -> (npairs, rows, 2b), pairs adjacent under `perm`
        return (
            jnp.take(M, perm, axis=1)
            .reshape(M.shape[0], npairs, 2 * b)
            .transpose(1, 0, 2)
        )

    def ungroup(Mp, rows):
        M = Mp.transpose(1, 0, 2).reshape(rows, n_pad)
        return jnp.take(M, iperm, axis=1)

    Wp = group(W)
    Vp = group(V)
    G = jnp.einsum("pmi,pmj->pij", Wp, Wp, precision=prec)
    J = _local_rotations(G, in_perms, in_iperms, prec)
    Wp = jnp.einsum("pmi,pij->pmj", Wp, J, precision=prec)
    Vp = jnp.einsum("pmi,pij->pmj", Vp, J, precision=prec)

    dg = jnp.maximum(jnp.einsum("pii->pi", G), 0.0)
    floor = (eps * eps) * n_pad * jnp.max(dg)  # squared dead-column floor
    denom = jnp.sqrt(dg[:, :b, None] * dg[:, None, b:])
    alive = jnp.minimum(dg[:, :b, None], dg[:, None, b:]) > floor
    cross = jnp.abs(G[:, :b, b:])
    rel = jnp.where(alive, cross / jnp.maximum(denom, 1e-30), 0.0)
    return ungroup(Wp, m), ungroup(Vp, V.shape[0]), jnp.max(rel)


def _eps_eff(dtype):
    """Machine epsilon of the compute path: native float32 and float64."""
    return float(jnp.finfo(dtype).eps)


@functools.partial(
    jax.jit, static_argnames=("b", "max_sweeps", "tol", "eps_eff")
)
def _svd_jacobi_square(A, b, max_sweeps, tol, eps_eff):
    n = A.shape[0]
    # Grading flip: the column metric converges fast when COLUMN norms are
    # graded and slowly when ROW norms are (module docstring); solve the
    # transpose when rows are spread wider, swap U/V at the end.
    tiny = jnp.finfo(A.dtype).tiny
    rn = jnp.linalg.norm(A, axis=1)
    cn = jnp.linalg.norm(A, axis=0)
    spread = lambda v: jnp.max(v) / jnp.maximum(jnp.min(v), tiny)
    flip = spread(rn) > spread(cn)
    A = jnp.where(flip, A.T, A)
    # gesvj-style input scaling: Gram entries and the skip/coupling tests
    # form PRODUCTS of squared column norms — unscaled, entries ~1e10
    # overflow those products to inf in f32, silently skipping every
    # rotation.  Scale to
    # max|A| ~ 1 (column norms <= sqrt(n), products <= n^2), unscale sigma.
    scale = jnp.max(jnp.abs(A))
    scale = jnp.where(
        jnp.logical_or(scale == 0, ~jnp.isfinite(scale)),
        jnp.ones((), A.dtype),
        scale,
    )
    A = A / scale

    n_pad = -(-n // (2 * b)) * (2 * b)
    W = jnp.pad(A, ((0, 0), (0, n_pad - n)))
    V = jnp.eye(n_pad, dtype=A.dtype)
    perms, iperms = _schedule_cols(n_pad, b)
    in_perms, in_iperms = _schedule_cols(2 * b, 1)
    nrounds = perms.shape[0]

    def sweep_body(state):
        W, V, off_prev, stall, it = state

        def round_body(r, carry):
            W, V, off = carry
            W, V, rel = _jacobi_round(
                W, V, perms[r], iperms[r], in_perms, in_iperms, b, eps_eff
            )
            return W, V, jnp.maximum(off, rel)

        W, V, off = lax.fori_loop(
            0, nrounds, round_body, (W, V, jnp.zeros((), A.dtype))
        )
        # Noise-floor bookkeeping: a collapsed (< 1e-2) coupling that did
        # not improve this sweep is a candidate floor, but the max
        # off-diagonal of cyclic Jacobi is NOT monotone — a single bounce
        # mid-convergence is normal.  Count consecutive non-improving
        # sweeps and only the second in a row stops the iteration.
        bounced = jnp.logical_and(off < 1e-2, off >= off_prev)
        stall = jnp.where(bounced, stall + 1, 0)
        return W, V, off, stall, it + 1

    def sweep_cond(state):
        _, _, off, stall, it = state
        # Stop on: tolerance reached, OR two consecutive sweeps at the
        # noise floor of the compute path (which for columns near the dead
        # floor sits far above any eps-scale tolerance on graded
        # spectra).  Further sweeps past the floor only churn
        # noise into the smallest columns.
        return jnp.logical_and(
            it < max_sweeps, jnp.logical_and(off > tol, stall < 2)
        )

    big = jnp.full((), jnp.inf, A.dtype)
    init = (W, V, big, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    W, V, off, _, sweeps = lax.while_loop(sweep_cond, sweep_body, init)

    U, s, Vh = _finalize(W, V, n, flip, eps_eff)
    return U, s * scale, Vh, sweeps


def _finalize(W, V, n, flip, eps_eff):
    """Sort by descending column norm, normalize, zero dead vectors, and
    undo the grading flip: (W, V) with W ~= A_pad V -> (U, s, Vh)."""
    s_all = jnp.linalg.norm(W, axis=0)
    order = jnp.argsort(-s_all)[:n]
    s = s_all[order]
    L = jnp.take(W, order, axis=1)[:n] / jnp.maximum(
        s, jnp.finfo(W.dtype).tiny
    )
    R = jnp.take(V[:n], order, axis=1)
    # zero out vectors of numerically-zero sigma instead of returning noise
    # (threshold sqrt(n)*eps_eff: above measured zero-sigma noise, below
    # any sigma the compute path can actually resolve)
    dead = s <= (eps_eff * jnp.maximum(s[0], 0) * np.sqrt(n))
    L = jnp.where(dead[None, :], 0.0, L)
    R = jnp.where(dead[None, :], 0.0, R)
    U = jnp.where(flip, R, L)
    Vc = jnp.where(flip, L, R)
    return U, s, Vc.T


def svd_jacobi(A, block=64, max_sweeps=30, tol=None):
    """Full SVD by one-sided block Jacobi: ``A ~= U @ diag(s) @ Vh``.

    All-GEMM alternative to the two-stage pipeline (see module docstring):
    all FLOPs are batched GEMMs, there is no sequential panel or chase,
    and sigma on graded/ill-scaled matrices carry ~eps RELATIVE accuracy —
    better than any bidiagonalization-based method.  ``block`` is the
    column-block width (pair width ``2*block``);
    ``tol`` is the maximum relative cross-block coupling at which a sweep
    declares convergence (default ``sqrt(n) * eps``).
    """
    m, n = A.shape
    if m < n:
        U, s, Vh = svd_jacobi(A.T, block=block, max_sweeps=max_sweeps, tol=tol)
        return Vh.T, s, U.T
    if m > n:
        Q, R = jnp.linalg.qr(A, mode="reduced")
        Ur, s, Vh = svd_jacobi(R, block=block, max_sweeps=max_sweeps, tol=tol)
        return pdot(Q, Ur), s, Vh
    b = int(max(2, min(block, -(-n // 2))))
    eps_eff = _eps_eff(A.dtype)
    if tol is None:
        tol = float(np.sqrt(n)) * eps_eff
    U, s, Vh, _ = _svd_jacobi_square(A, b=b, max_sweeps=int(max_sweeps),
                                     tol=float(tol), eps_eff=eps_eff)
    return U, s, Vh


def svd_jacobi_batch(As, block=16, max_sweeps=30, tol=None):
    """Batched full SVD by one-sided block Jacobi: (B, n, n) -> U, s, Vh.

    vmaps the square Jacobi solve — every round's Gram/rotation/update
    batches across both the tournament pairs and the input batch, which
    keeps the matrix units full even for small per-matrix sizes.  All lanes
    run the same sweep count (the convergence test reduces over the batch).
    """
    if As.ndim != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"expected (B, n, n), got {As.shape}")
    n = As.shape[1]
    b = int(max(2, min(block, -(-n // 2))))
    eps_eff = _eps_eff(As.dtype)
    if tol is None:
        tol = float(np.sqrt(n)) * eps_eff

    fn = jax.vmap(
        lambda A: _svd_jacobi_square(
            A, b=b, max_sweeps=int(max_sweeps), tol=float(tol),
            eps_eff=eps_eff,
        )[:3]
    )
    return fn(As)


@functools.partial(
    jax.jit, static_argnames=("b", "max_sweeps", "tol", "eps_eff")
)
def _svd_jacobi_pre_square(A, b, max_sweeps, tol, eps_eff):
    # poor-man's column pivoting: one exact permutation by descending norm
    cn = jnp.linalg.norm(A, axis=0)
    order = jnp.argsort(-cn)
    iorder = jnp.argsort(order)
    Ap = jnp.take(A, order, axis=1)
    Q1, R1 = jnp.linalg.qr(Ap, mode="reduced")
    Q2, R2 = jnp.linalg.qr(R1.T, mode="reduced")
    Ux, s, Vhx, sweeps = _svd_jacobi_square(
        R2.T, b=b, max_sweeps=max_sweeps, tol=tol, eps_eff=eps_eff
    )
    U = pdot(Q1, Ux)
    Vh = pdot(Vhx, Q2.T)
    return U, s, jnp.take(Vh, iorder, axis=1), sweeps


def svd_jacobi_pre(A, block=16, max_sweeps=30, tol=None):
    """Preconditioned one-sided Jacobi (LAPACK dgejsv class): ``A ~= U @
    diag(s) @ Vh`` with Jacobi's RELATIVE sigma accuracy at a fraction of
    the standalone sweep count.

    Drmac's preconditioning: sort columns by norm (the exact-permutation
    core of column pivoting), QR factor, QR factor the transposed
    triangular factor again, and run one-sided Jacobi on the doubly
    condensed ``R2^T``.  Each QR acts like half a QR-algorithm iteration
    on the Gram, concentrating mass onto the diagonal, so the Jacobi
    tournament starts close to its quadratic-convergence regime.
    Householder QR perturbs every column by ~eps * (that column's norm),
    so column-graded relative accuracy survives the preconditioning
    (Drmac & Veselic, LAWN 169/170 — the dgejsv design).

    Assembly: ``A P = Q1 R1``, ``R1^T = Q2 R2``, Jacobi on ``X = R2^T``
    gives ``X = Ux diag(s) Vhx``; then ``U = Q1 Ux`` and
    ``Vh = (Q2 Vhx^T)^T P^T`` (a column un-permutation).

    The standalone :func:`svd_jacobi` (same accuracy class) remains the
    path with no QR in front, for rank-revealing edge cases.  The whole
    path (permutation + QRs + Jacobi + assembly) runs as ONE jitted
    program.  ``block`` defaults to 16 (not standalone's 64): the condensed
    input needs less cross-block mixing, so cheaper local solves suffice.
    """
    m, n = A.shape
    if m < n:
        U, s, Vh = svd_jacobi_pre(
            A.T, block=block, max_sweeps=max_sweeps, tol=tol
        )
        return Vh.T, s, U.T
    b = int(max(2, min(block, -(-n // 2))))
    eps_eff = _eps_eff(A.dtype)
    if tol is None:
        tol = float(np.sqrt(n)) * eps_eff
    U, s, Vh, _ = _svd_jacobi_pre_square(
        A, b=b, max_sweeps=int(max_sweeps), tol=float(tol), eps_eff=eps_eff
    )
    return U, s, Vh
