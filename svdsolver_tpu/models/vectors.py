"""Singular vectors — full SVD (beyond the reference, which computes only
singular values).

Two pieces:

* :func:`bidiagonal_svd` — vectors of the bidiagonal {d, e}: singular values
  from parallel bisection, then eigenvectors of the Golub-Kahan tridiagonal
  ``TGK`` by inverse iteration.  The tridiagonal solve (LU with partial
  pivoting, band-2 upper factor) runs *vectorized across all n shift lanes*,
  the same layout as the bisection: sequential depth is O(2n) per
  iteration with (n,)-vector arithmetic.
* :func:`bidiagonalize_blocked_uv` — the one-stage blocked reduction with
  orthogonal-factor accumulation: per panel, ``U <- U (I - V T V^T)`` with
  the compact-WY ``T`` recovered in closed form
  (``T^{-1} = striu(V^T V) + diag(1/tau)``), so accumulation is all GEMMs.

Clustered or exactly-multiple singular values: inverse iteration alone would
return nearly-parallel columns there, so :func:`tgk_vectors` re-orthogonalizes
within detected tight clusters in TGK space after every iteration — a
cluster-blocked shifted CholeskyQR (width-unlimited, all GEMM/blocked ops;
with the iteration this is inverse *subspace* iteration per cluster) —
and finishes with a per-part Newton-Schulz polar polish that removes the
~eps*smax/gap cross-talk of the dense bulk AND the -sigma twin
contamination of close-but-unclustered lanes (whose u/v defects cancel in
TGK x-space; see the polish comment).  LAPACK's dstein handles clusters
with O(n^2)-depth sequential MGS groups, a shape wide devices hate.

:func:`svd_two_stage` runs the flagship two-stage pipeline with full
back-transformation of the Stage-I compact-WY factors and the recorded
Stage-II chase reflectors (the reference's brd_p2 doc block advertises U1/V1
outputs it never produces — svd_parallel.h:400-407).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.householder import householder_vector
from svdsolver_tpu.ops.precision import pdot
from svdsolver_tpu.ops.chase_schedule import nc_of_static, s_max_of
from svdsolver_tpu.ops import dispatch


def _larft_closed_form(V, taus):
    """Forward compact-WY T from reflectors: T^{-1} = striu(V^T V) + diag(1/tau).

    Columns with tau == 0 must already be zeroed in ``V`` (their identity
    reflectors then contribute nothing regardless of the 1/tau guard)."""
    b = taus.shape[0]
    dtype = V.dtype
    safe = jnp.where(taus == 0, jnp.ones((), dtype), taus)
    Tinv = jnp.triu(pdot(V.T, V), 1) + jnp.diag(1.0 / safe)
    return jax.scipy.linalg.solve_triangular(
        Tinv, jnp.eye(b, dtype=dtype), lower=False
    )


@functools.partial(jax.jit, static_argnames=("panel",))
def bidiagonalize_blocked_uv(A, panel=32):
    """Blocked one-stage bidiagonalization with U/V accumulation.

    Returns ``(d, e, U, V)`` with ``A = U @ bidiag(d, e) @ V.T`` (square A).
    Same panel math as models/blocked.py plus per-panel GEMM updates of the
    orthogonal factors.
    """
    m, n = A.shape
    if m != n:
        raise ValueError("bidiagonalize_blocked_uv expects a square matrix")
    dtype = A.dtype
    b = int(panel)
    n_panels = -(-n // b)
    d0 = jnp.zeros((n,), dtype)
    e0 = jnp.zeros((n,), dtype)
    U0 = jnp.eye(n, dtype=dtype)
    Vc0 = jnp.eye(n, dtype=dtype)

    def panel_body(k, carry):
        A, d, e, Uacc, Vacc = carry
        c = k * b
        V = jnp.zeros((m, b), dtype)
        Y = jnp.zeros((n, b), dtype)
        X = jnp.zeros((m, b), dtype)
        U = jnp.zeros((n, b), dtype)
        tl0 = jnp.zeros((b,), dtype)
        tr0 = jnp.zeros((b,), dtype)

        def col_body(j, pcarry):
            V, Y, X, U, d, e, tl, tr = pcarry
            g = c + j
            g_ok = g < n
            gc = jnp.minimum(g, n - 1)
            col = A[:, gc] - pdot(V, Y[gc, :]) - pdot(X, U[gc, :])
            v, tau, beta = householder_vector(col, g)
            tau = jnp.where(g_ok, tau, jnp.zeros((), dtype))
            d = d.at[gc].set(jnp.where(g_ok, beta, d[gc]))
            y = tau * (pdot(A.T, v) - pdot(Y, pdot(V.T, v)) - pdot(U, pdot(X.T, v)))
            vz = jnp.where(jnp.logical_and(g_ok, tau != 0), v, jnp.zeros((m,), dtype))
            V = V.at[:, j].set(vz)
            Y = Y.at[:, j].set(y)
            tl = tl.at[j].set(tau)
            row = A[gc, :] - pdot(Y, V[gc, :]) - pdot(U, X[gc, :])
            u, tau_r, beta_r = householder_vector(row, g + 1)
            tau_r = jnp.where(g_ok, tau_r, jnp.zeros((), dtype))
            e = e.at[gc].set(jnp.where(g_ok, beta_r, e[gc]))
            x = tau_r * (pdot(A, u) - pdot(V, pdot(Y.T, u)) - pdot(X, pdot(U.T, u)))
            X = X.at[:, j].set(x)
            uz = jnp.where(tau_r != 0, u, jnp.zeros((n,), dtype))
            U = U.at[:, j].set(uz)
            tr = tr.at[j].set(tau_r)
            return V, Y, X, U, d, e, tl, tr

        V, Y, X, U, d, e, tl, tr = lax.fori_loop(
            0, b, col_body, (V, Y, X, U, d, e, tl0, tr0)
        )
        A = A - pdot(V, Y.T) - pdot(X, U.T)
        # accumulate the orthogonal factors (forward products, compact-WY)
        TL = _larft_closed_form(V, tl)
        Uacc = Uacc - pdot(pdot(pdot(Uacc, V), TL), V.T)
        TR = _larft_closed_form(U, tr)
        Vacc = Vacc - pdot(pdot(pdot(Vacc, U), TR), U.T)
        return A, d, e, Uacc, Vacc

    A, d, e, Uacc, Vacc = lax.fori_loop(
        0, n_panels, panel_body, (A, d0, e0, U0, Vc0)
    )
    return d, e[: n - 1], Uacc, Vacc


def _cluster_bounds(sig, ctol):
    """Per-column cluster id + inclusive [start, end] column bounds of the
    contiguous close-sigma clusters (sig sorted)."""
    n = sig.shape[0]
    smax = jnp.max(jnp.abs(sig))
    linked = jnp.abs(sig[1:] - sig[:-1]) <= ctol * smax  # (n-1,)
    is_start = jnp.concatenate([jnp.ones((1,), bool), ~linked])
    rid = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    idx = jnp.arange(n)
    start = lax.cummax(jnp.where(is_start, idx, 0))
    is_end = jnp.concatenate([~linked, jnp.ones((1,), bool)])
    end = lax.cummin(jnp.where(is_end, idx, n - 1), reverse=True)
    return rid, start, end


def _cluster_orthogonalize(x, sig, ctol, passes=2):
    """Cluster-blocked CholeskyQR, tiled: orthonormalize within clusters of
    close singular values in TGK space.

    The dense formulation (:func:`_cluster_orthogonalize_dense`) pays a
    full (n, n) Gram + DENSE cholesky + DENSE triangular solve per pass,
    while the masked Gram is block-diagonal with NARROW blocks (close-
    sigma clusters).  Here the columns are tiled at width 128 under TWO
    covers (offsets 0 and 64): any cluster of width <= 64 lies wholly
    inside some tile of at least one cover (a span of < 64 columns cannot
    contain both a multiple of 128 and one of 128m - 64), so each pass is
    a BATCHED (ntiles, 128, 128) masked Gram + cholesky + triangular
    solve — GEMM-shaped small-batch ops in place of sequential dense
    factorizations.  The two covers correct DISJOINT column sets, so both
    corrections derive from the same input x and commute.  Clusters wider
    than 64 columns fall back to the dense path (lax.cond — compiled
    once, executed only when such a cluster exists)."""
    n = x.shape[1]
    dtype = x.dtype
    rid, start, end = _cluster_bounds(sig, ctol)
    in_cluster = start != end
    wide = jnp.any(jnp.logical_and(in_cluster, end - start > 64))

    TW = 128
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    shift = jnp.asarray(4 * n, dtype) * jnp.asarray(
        jnp.finfo(dtype).eps, dtype
    )

    def tiled(x):
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=0), tiny))
        x = x / nrm[None, :]
        full_A = start // TW == end // TW
        full_B = (start + 64) // TW == (end + 64) // TW
        corr = {
            0: jnp.logical_and(in_cluster, full_A),
            64: jnp.logical_and(
                in_cluster, jnp.logical_and(full_B, ~full_A)
            ),
        }

        def cover(x, off):
            npad = -(-(n + off) // TW) * TW
            nt = npad // TW
            xp = jnp.pad(x, ((0, 0), (off, npad - n - off)))
            # padded columns get unique negative cluster ids -> singletons
            rid_p = jnp.pad(rid + 1, (off, npad - n - off))  # pads are 0
            pidx = jnp.arange(npad)
            rid_p = jnp.where(
                jnp.logical_or(pidx < off, pidx >= off + n),
                -(pidx + 1),
                rid_p,
            )
            ok_p = jnp.pad(corr[off], (off, npad - n - off))
            rid_t = rid_p.reshape(nt, TW)
            ok_t = ok_p.reshape(nt, TW)
            x3 = xp.reshape(x.shape[0], nt, TW)
            mask = rid_t[:, :, None] == rid_t[:, None, :]
            mask = jnp.logical_and(
                mask, jnp.logical_and(ok_t[:, :, None], ok_t[:, None, :])
            )
            eye = jnp.eye(TW, dtype=dtype)[None]
            y3 = x3
            for p in range(int(passes)):
                s_p = shift if p == 0 else jnp.zeros((), dtype)
                G = jnp.einsum(
                    "kti,ktj->tij",
                    y3,
                    y3,
                    precision=lax.Precision.HIGHEST,
                )
                Gc = jnp.where(mask, G, jnp.zeros((), dtype)) + (
                    (1 + s_p) * eye - jnp.where(mask, eye, 0.0)
                )
                L = jnp.linalg.cholesky(Gc)
                yt = jax.scipy.linalg.solve_triangular(
                    L, jnp.swapaxes(y3, 0, 1).swapaxes(1, 2), lower=True
                )  # (nt, TW, N)
                ynew = jnp.swapaxes(yt, 1, 2).swapaxes(0, 1)
                bad = ~jnp.isfinite(jnp.sum(ynew * ynew, axis=0))
                y3 = jnp.where(bad[None], y3, ynew)
            yp = y3.reshape(x.shape[0], npad)[:, off : off + n]
            return jnp.where(corr[off][None, :], yp, x)

        x = cover(x, 0)
        x = cover(x, 64)
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=0), tiny))
        return x / nrm[None, :]

    return lax.cond(
        wide,
        lambda x: _cluster_orthogonalize_dense(x, sig, ctol, passes),
        tiled,
        x,
    )


def _cluster_orthogonalize_dense(x, sig, ctol, passes=2):
    """Orthonormalize within clusters of close singular values, in TGK space,
    by cluster-blocked CholeskyQR — width-unlimited and GEMM-shaped.

    ``x``: (2n, n) TGK eigenvector columns for the shifts ``sig`` (sorted,
    so clusters are contiguous).  Orthogonality of TGK eigenvectors implies
    BOTH u- and v-orthogonality of the extracted singular vectors (for
    eigenvectors of the same/close sigma, u'^T u = v'^T v = x'^T x up to the
    eigen-residual), so orthogonalizing here preserves the U/V coupling —
    orthogonalizing U and V independently would not.

    Method: the cluster-masked Gram ``Gc = I + M o (X^T X - I)`` (M the
    block mask ``rid_i == rid_j``) is block-diagonal SPD, so ``X L^{-T}``
    with ``L = chol(Gc)`` orthonormalizes every cluster at once while
    leaving singleton columns untouched — three blocked ops (GEMM,
    cholesky, triangular solve) regardless of cluster width, where
    positional MGS would need one pass per member.  Two passes
    (CholeskyQR2) reach machine orthogonality for block condition numbers
    up to ~1/sqrt(eps); columns of a failed (non-PD, NaN-producing) block
    fall back to their input values rather than poisoning the lanes.
    """
    n = x.shape[1]
    dtype = x.dtype
    smax = jnp.max(jnp.abs(sig))
    linked = jnp.abs(sig[1:] - sig[:-1]) <= ctol * smax  # (n-1,)
    rid = jnp.cumsum(
        jnp.concatenate([jnp.zeros((1,), jnp.int32),
                         1 - linked.astype(jnp.int32)])
    )  # cluster id per column
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=0), tiny))
    x = x / nrm[None, :]
    mask = rid[:, None] == rid[None, :]
    eye = jnp.eye(n, dtype=dtype)
    # shifted CholeskyQR: a Gram matrix is PSD up to ~n*eps roundoff, so
    # this diagonal shift keeps chol PD even for rank-deficient blocks
    # (whose NaNs would otherwise propagate through the 0*NaN off-blocks);
    # the bias it adds is removed by the later passes / polar polish.
    shift = jnp.asarray(4 * n, dtype) * jnp.asarray(
        jnp.finfo(dtype).eps, dtype
    )
    for p in range(int(passes)):
        # shift only the first pass (shifted CholeskyQR3 schedule): once a
        # pass has run, the Gram is near-identity and chol is safely PD —
        # an unshifted final pass removes the first pass's O(shift) bias.
        s_p = shift if p == 0 else jnp.zeros((), dtype)
        G = pdot(x.T, x)
        Gc = jnp.where(mask, G, jnp.zeros((), dtype)) + (
            (1 + s_p) * eye - jnp.where(mask, eye, jnp.zeros((), dtype))
        )
        L = jnp.linalg.cholesky(Gc)
        y = jax.scipy.linalg.solve_triangular(L, x.T, lower=True).T
        # rank-deficient blocks: chol emits NaN columns — keep the input
        # there (the polar polish and the next solve re-separate them)
        bad = ~jnp.isfinite(jnp.sum(y * y, axis=0))
        x = jnp.where(bad[None, :], x, y)
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=0), tiny))
    return x / nrm[None, :]


def tgk_solve_xla(z, lam, rhs, pivmin, big):
    """(TGK - diag-per-lane(lam)) x = rhs; tridiagonal LU with partial
    pivoting, band-2 upper factor; lanes vectorized — XLA scan formulation.

    ``z``: (N-1,) TGK off-diagonals, ``lam``: (n,) per-lane shifts,
    ``rhs``: (N, n).  Both substitution passes are ``lax.scan``s emitting
    factor/solution rows as scan outputs — scatter-updating (N, n) carries
    per step is slower.  The forward carry's third slot (``dd``) of the
    generic band-2 elimination is identically zero for a tridiagonal (only
    ``p2 = swap ? c_i : 0`` survives), but is kept for clarity; the GPU
    kernel (ops/pallas/tgk_solve_triton.py) drops it.  This is what
    ``ops.dispatch.tgk_solve`` runs off CUDA, and the kernel's oracle.
    """
    n = lam.shape[0]
    dtype = rhs.dtype
    zero_row = jnp.zeros((n,), dtype)
    c_xs = jnp.concatenate([z[1:], jnp.zeros((1,), dtype)])

    def fwd(carry, x):
        b, cc, dd, y = carry
        ai, ci_s, yi = x
        bi = -lam
        ci = jnp.broadcast_to(ci_s, (n,)).astype(dtype)
        swap = jnp.abs(ai) > jnp.abs(b)
        p0 = jnp.where(swap, ai, b)
        p1 = jnp.where(swap, bi, cc)
        p2 = jnp.where(swap, ci, dd)
        py = jnp.where(swap, yi, y)
        q0 = jnp.where(swap, b, ai)
        q1 = jnp.where(swap, cc, bi)
        q2 = jnp.where(swap, dd, ci)
        qy = jnp.where(swap, y, yi)
        psign = jnp.where(p0 < 0, -jnp.ones((), dtype), jnp.ones((), dtype))
        safe = jnp.where(jnp.abs(p0) < pivmin, psign * pivmin, p0)
        mlt = q0 / safe
        carry = (q1 - mlt * p1, q2 - mlt * p2, zero_row, qy - mlt * py)
        return carry, (safe, p1, p2, py)

    init = (-lam, jnp.broadcast_to(z[0], (n,)).astype(dtype), zero_row, rhs[0])
    (b, _, _, y), (U0, U1, U2, R) = lax.scan(
        fwd, init, (z, c_xs, rhs[1:]), unroll=4
    )
    bsign = jnp.where(b < 0, -jnp.ones((), dtype), jnp.ones((), dtype))
    last = jnp.where(jnp.abs(b) < pivmin, bsign * pivmin, b)
    U0 = jnp.concatenate([U0, last[None]], axis=0)
    U1 = jnp.concatenate([U1, zero_row[None]], axis=0)
    U2 = jnp.concatenate([U2, zero_row[None]], axis=0)
    R = jnp.concatenate([R, y[None]], axis=0)

    def bwd(carry, x):
        s1, s2 = carry
        u0, u1, u2, r = x
        v = (r - u1 * s1 - u2 * s2) / u0
        v = jnp.clip(v, -big, big)  # bound growth; see pivmin note in caller
        return (v, s1), v

    _, sol = lax.scan(
        bwd, (zero_row, zero_row), (U0, U1, U2, R), reverse=True, unroll=4
    )
    return sol


@functools.partial(jax.jit, static_argnames=("iters", "polish"))
def tgk_vectors(d, e, sig, iters=None, polish=None):
    """Singular vectors of the bidiagonal {d, e} for the values ``sig`` via
    inverse iteration on the Golub-Kahan tridiagonal, all lanes at once.

    Returns ``(U_b, V_b)`` with ``bidiag(d, e) @ V_b ~= U_b * sig``.

    ``iters`` (inverse-iteration steps) and ``polish`` (Newton-Schulz polar
    passes) default per dtype: fp32 converges to its roundoff floor with
    (2, 2) — measured identical orthogonality to (3, 4) at n=2048,
    faster — while f64's ~1e-15 floor needs the extra pass of each.

    Columns whose singular values are clustered (|sig_i - sig_j| <=
    max(64, 2n)*eps*sig_max — including exactly-multiple values) are
    re-coupled every iteration: v-parts orthogonalized within the cluster and
    u rebuilt as B v / sigma (see ``couple_clusters`` for why that beats
    x-space orthogonalization).  Cluster orthogonalization is the tiled
    double-cover CholeskyQR (:func:`_cluster_orthogonalize`): batched
    (128, 128) blocks for clusters up to 64 columns wide, with a dense
    CholeskyQR fallback (lax.cond) for wider ones.

    ``sig`` may be any contiguous SUBSET of the spectrum (sorted descending)
    — e.g. the top-k values for a partial SVD: the lane count everywhere is
    ``sig.shape[0]``, independent of the matrix dimension.
    """
    n = d.shape[0]
    N = 2 * n
    k = sig.shape[0]
    dtype = d.dtype
    if iters is None:
        iters = 2 if dtype == jnp.float32 else 3
    if polish is None:
        # Newton-Schulz is quadratic: from the ~1e-3 per-lane cross-talk
        # floor, two passes reach the fp32 roundoff floor (measured
        # identical orthogonality to three at n=2048, gauss + clustered)
        polish = 2 if dtype == jnp.float32 else 4
    z = jnp.zeros((N - 1,), dtype).at[0::2].set(d).at[1::2].set(e)
    smax = jnp.max(jnp.abs(sig))
    # LAPACK-dstein-style pivot floor: partial pivoting bounds the forward
    # multipliers by 1, but the BACK substitution divides by the stored
    # pivots — two consecutive near-zero pivots overflow fp32 to inf and the
    # next fused multiply-add turns inf - inf into NaN (observed at n >= 1024
    # on dense random spectra).  Clamp pivot magnitude from below, and clip
    # the solution growth: inverse iteration only needs the dominant
    # direction, and later iterations + the final polar polish absorb the
    # (rare, per-entry) clip distortion.
    eps_ = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    pivmin = jnp.maximum(
        smax * eps_ * eps_, jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    )
    big = jnp.asarray(float(jnp.finfo(dtype).max) ** 0.5 / 16.0, dtype)
    lam = sig

    def solve(rhs):
        """(TGK - diag-per-lane(lam)) x = rhs; lanes vectorized.

        ``lam`` is read at call time (after the multiplet perturbation)."""
        return dispatch.tgk_solve(z, lam, rhs, pivmin, big)

    x = jax.random.normal(jax.random.PRNGKey(0), (N, k), dtype)

    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    # Tight-cluster net: gaps below ~64 ulp of sig_max are where per-lane
    # inverse iteration COLLAPSES lanes onto the same vector (shift accuracy
    # is ~eps*smax, so the amplification ratio gap/eps/smax is too small to
    # separate them) — those need the v-MGS + u-rebuild coupling below.
    # Wider but still small gaps (the dense bulk of a random spectrum sits at
    # ~1e2..1e3 eps) resolve per-lane and the final polar polish removes
    # their residual ~eps*smax/gap cross-talk.  A wide net here (earlier:
    # max(64, 2n)*eps) is actively harmful at scale: it declares the whole
    # bulk one giant cluster that width-8 MGS cannot orthogonalize.
    ctol = 64 * eps
    linked = jnp.abs(sig[1:] - sig[:-1]) <= ctol * smax
    has_cluster = jnp.any(linked)
    in_cluster = jnp.zeros((k,), bool).at[1:].set(linked)
    in_cluster = in_cluster.at[:-1].max(linked)
    # dstein-style shift perturbation: spread duplicate shifts by a few ulps
    # so lanes of a multiplet are amplified toward different split eigvecs.
    is_start = jnp.concatenate([jnp.ones((1,), bool), ~linked])
    idx = jnp.arange(k)
    pic = idx - jnp.maximum.accumulate(jnp.where(is_start, idx, 0))
    lam = lam * (1 + 4 * eps * pic.astype(dtype))

    def couple_clusters(x):
        """Within clusters, orthogonalize the v-parts and REBUILD u = Bv/sig.

        Cluster lanes can be contaminated by the -sigma TGK twin, which
        shares the SAME v with opposite u — x-space orthogonality can then
        leave u-parts parallel.  The twins' shared v means v-parts always
        stay in the right singular subspace, so v-MGS + u-reconstruction
        enforces the U/V coupling exactly and makes the u's orthogonal via
        B^T B v ~= sigma^2 v."""
        v = x[0::2]
        u = x[1::2]
        Vc = _cluster_orthogonalize(v, sig, ctol)
        # column 0 is never visited by the MGS loop — normalize everything
        Vc = Vc / jnp.maximum(
            jnp.linalg.norm(Vc, axis=0, keepdims=True), tiny
        )
        Bv = d[:, None] * Vc
        Bv = Bv.at[:-1, :].add(e[:, None] * Vc[1:, :])
        Uc = Bv / jnp.maximum(sig, smax * eps + tiny)[None, :]
        Uc = Uc / jnp.maximum(
            jnp.linalg.norm(Uc, axis=0, keepdims=True), tiny
        )
        usable = jnp.logical_and(in_cluster, sig > 1e-3 * smax)
        # near-zero-sigma clusters: u = Bv/sigma is ill-conditioned and the
        # +/-sigma TGK twins degenerate, leaving inverse-iteration u-parts
        # parallel.  There the u/v coupling is vacuous (B^T u = sigma v ~ 0),
        # so orthogonalize the u-parts directly within the cluster — but
        # LAZILY: on generic spectra no cluster is near-zero, and the u-side
        # CholeskyQR2 (dense Gram + chol + triangular solve) would cost a
        # dense factorization whose result is discarded.
        need_un = jnp.any(jnp.logical_and(in_cluster, ~usable))

        def _un(u):
            Un = _cluster_orthogonalize(u, sig, ctol)
            return Un / jnp.maximum(
                jnp.linalg.norm(Un, axis=0, keepdims=True), tiny
            )

        Un = lax.cond(need_un, _un, lambda u: u, u)
        v = jnp.where(in_cluster[None, :], Vc, v)
        u = jnp.where(
            usable[None, :], Uc, jnp.where(in_cluster[None, :], Un, u)
        )
        # interleave back (row 2i = v[i], 2i+1 = u[i]) via stack+reshape:
        # the strided x.at[0::2].set scatter fused into a >16 MB scoped-vmem
        # allocation at n >= ~6656 and failed to compile
        x = jnp.stack([v, u], axis=1).reshape(x.shape)
        return x / jnp.maximum(
            jnp.linalg.norm(x, axis=0, keepdims=True), tiny
        )

    def it(_, x):
        x = solve(x)
        # near-singular solves reach ~1/sqrt(tiny); scale by the max first
        # so the norm's squares cannot overflow fp32
        mx = jnp.maximum(
            jnp.max(jnp.abs(x), axis=0, keepdims=True), tiny
        )
        x = x / mx
        x = x / jnp.linalg.norm(x, axis=0, keepdims=True)
        # re-couple clusters EVERY iteration so the next solve amplifies the
        # still-missing subspace component instead of re-collapsing lanes.
        return lax.cond(has_cluster, couple_clusters, lambda x: x, x)

    x = lax.fori_loop(0, int(iters), it, x)

    # Final polar polish: Newton-Schulz X <- X(3I - X^T X)/2 converges to the
    # nearest orthonormal basis (quadratically for ||X^T X - I|| < 1, which
    # per-lane inverse iteration + the cluster coupling guarantee).  Dense
    # random spectra leave ~eps*smax/gap ~ 1e-3..1e-2 pairwise cross-talk in
    # fp32 that no per-lane method can avoid; a few GEMM pairs
    # restore ~1e-6 orthogonality while perturbing each column only by its
    # existing cross-talk (so eigen-residuals are preserved to first order).
    # The u- and v-parts are polished SEPARATELY: close-but-not-clustered
    # lanes carry -sigma TGK twin contamination, whose u/v cross-talks
    # CANCEL in x-space (v_i.v_j = -u_i.u_j) — an x-space polish reaches
    # x-orthogonality while both parts stay ~eps*smax/gap off (measured
    # 3.3e-5 stall at n=2048).  Per-part polish removes it directly; the
    # mixing error it introduces couples only nearby-sigma lanes, so the
    # factorization error is O(defect * gap) — below the fp32 floor.
    eye = jnp.eye(k, dtype=dtype)
    u = x[1::2]
    v = x[0::2]
    # exact TGK eigenvectors split norm equally (1/sqrt(2) each); renormalize
    # the parts before polishing so NS starts near its fixed point
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=0, keepdims=True), tiny)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=0, keepdims=True), tiny)

    # the u and v passes are independent: run them STACKED so each pass is
    # one batched GEMM pair instead of two sequential ones (halves the
    # sequential GEMM chain of the polish tail)
    uv = jnp.stack([u, v])  # (2, n, k)

    def _polish_pass(j, M):
        G = pdot(jnp.swapaxes(M, -1, -2), M)
        return pdot(M, 1.5 * eye - 0.5 * G)

    uv = lax.fori_loop(0, int(polish), _polish_pass, uv)
    return uv[0], uv[1]  # (U_b, V_b)


def bidiagonal_svd(d, e, k=None):
    """SVD of the bidiagonal {d, e}: returns (U_b, sig, V_b).

    ``k``: if given, vectors (and the returned sig) cover only the top-``k``
    singular values; bisection still resolves the full spectrum (its cost is
    independent of how many vectors are wanted)."""
    sig = dispatch.bisect_svdvals(d, e)
    if k is not None:
        sig = sig[: min(int(k), sig.shape[0])]
    U_b, V_b = tgk_vectors(d, e, sig)
    return U_b, sig, V_b


@functools.partial(jax.jit, static_argnames=("band", "reverse"))
def _apply_chase_reflectors(V, T, M, band, reverse):
    """Apply a chase reflector product (from band_to_bidiagonal_accum) to the
    rows of ``M``.

    ``V``: (n_sweeps, s_max, b) reflectors, ``T``: (n_sweeps, s_max) taus;
    reflector (i, s) acts on rows ``[i+1+s*b, i+1+(s+1)*b)``.  Within a sweep
    the supports are disjoint, so one sweep applies as a single batched
    (s_max, b, ncols) segment update; sweeps run sequentially in creation
    order (``reverse=False``, computing ``R @ M``) or reverse creation order
    (``reverse=True``, computing ``L @ M``).
    """
    n_sweeps, s_max, b = V.shape
    ncols = M.shape[1]
    P = s_max * b
    dtype = M.dtype
    # supports reach i+1+P <= n_sweeps + P; pad rows so segments are in-bounds
    Mp = jnp.pad(M, ((0, n_sweeps + P + 1 - M.shape[0]), (0, 0)))

    def sweep_apply(i, Mp):
        seg = lax.dynamic_slice(Mp, (i + 1, 0), (P, ncols))
        seg3 = seg.reshape(s_max, b, ncols)
        v = V[i]  # (s_max, b); tau==0 slots are exact no-ops
        tv = T[i][:, None] * v
        coef = jnp.einsum(
            "sb,sbn->sn",
            tv,
            seg3,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=dtype,
        )
        seg3 = seg3 - v[:, :, None] * coef[:, None, :]
        return lax.dynamic_update_slice(Mp, seg3.reshape(P, ncols), (i + 1, 0))

    if reverse:
        Mp = lax.fori_loop(
            0, n_sweeps, lambda k, Mp: sweep_apply(n_sweeps - 1 - k, Mp), Mp
        )
    else:
        Mp = lax.fori_loop(0, n_sweeps, sweep_apply, Mp)
    return Mp[: M.shape[0]]


@functools.partial(jax.jit, static_argnames=("band",))
def _apply_chase_reflectors_wy(V, T, M, band):
    """Grouped compact-WY form of :func:`_apply_chase_reflectors`
    (reverse=True, i.e. the creation-order product ``L @ M``), with the
    per-reflector rank-1 updates aggregated into GEMMs.

    Validity of the regrouping: reflector (i, s) supports rows
    ``[i+1+s*b, i+1+(s+1)*b)``, so two reflectors overlap iff
    ``|(i-i') + (s-s')*b| < b``; for sweeps within one group of G <= b
    consecutive sweeps, every overlapping pair with i < i' has s' in
    {s, s-1} — the later sweep sits at the same or LOWER slot.  Hence the
    (slot desc, sweep asc) order preserves the relative order of every
    non-commuting pair, and the creation-order product equals
    ``prod_{g asc} prod_{s desc} S(g, s)`` with ``S(g, s)`` the forward
    compact-WY product of the group's G reflectors at slot s.

    Applying to M therefore walks groups in descending g and slots in
    ascending s, each step two (G+b, G)x(G+b, ncols) GEMMs instead of G
    rank-1 updates — (n/G * s_max) sequential GEMM steps in place of
    n sweeps of batched rank-1s.
    """
    n_sweeps, s_max, b = V.shape
    ncols = M.shape[1]
    G = b  # group size; the reordering proof needs G <= b
    n_groups = -(-n_sweeps // G)
    pad_s = n_groups * G - n_sweeps
    dtype = M.dtype
    Vp = jnp.pad(V, ((0, pad_s), (0, 0), (0, 0)))
    Tp = jnp.pad(T, ((0, pad_s), (0, 0)))
    # (n_groups, s_max, G, b) with tau==0 columns zeroed (identity
    # reflectors must vanish from V for the closed-form T)
    Vg = Vp.reshape(n_groups, G, s_max, b).transpose(0, 2, 1, 3)
    Tg = Tp.reshape(n_groups, G, s_max).transpose(0, 2, 1)
    Vg = jnp.where(Tg[..., None] == 0, jnp.zeros((), dtype), Vg)

    rows_i = jnp.arange(G)[:, None]
    cols_i = jnp.arange(b)[None, :] + rows_i

    def build(vg, tg):
        # vg (G, b) -> staggered (G+b, G): column j at local rows [j, j+b)
        F = jnp.zeros((G, G + b), dtype).at[rows_i, cols_i].set(vg)
        Vb = F.T
        return Vb, _larft_closed_form(Vb, tg)

    Vb, Tb = jax.vmap(jax.vmap(build))(Vg, Tg)  # (ng, s_max, G+b, G) etc.

    P = n_groups * G + s_max * b + 1
    Mp = jnp.pad(M, ((0, P + G + b - M.shape[0]), (0, 0)))

    def slot_apply(s, Mp, g):
        r0 = g * G + 1 + s * b
        seg = lax.dynamic_slice(Mp, (r0, 0), (G + b, ncols))
        Vs = Vb[g, s]
        coef = pdot(Tb[g, s], pdot(Vs.T, seg))
        seg = seg - pdot(Vs, coef)
        return lax.dynamic_update_slice(Mp, seg, (r0, 0))

    def group_apply(k, Mp):
        g = n_groups - 1 - k
        return lax.fori_loop(
            0, s_max, lambda s, Mp: slot_apply(s, Mp, g), Mp
        )

    Mp = lax.fori_loop(0, n_groups, group_apply, Mp)
    return Mp[: M.shape[0]]


@functools.partial(jax.jit, static_argnames=("band",))
def _apply_chase_reflectors_wy_carry(V, T, M, band):
    """Overlap-carry form of :func:`_apply_chase_reflectors_wy`: the same
    (group g desc, slot s asc) compact-WY walk, with two cost reductions
    (the walk is a mix of memory traffic and small-GEMM passes):

    * **Overlap carry.**  Slot s's segment rows ``[r(s), r(s)+2b)`` and
      slot s+1's ``[r(s)+b, r(s)+3b)`` share b rows, so the within-group
      slot walk carries the updated tail block: each step loads only the
      b fresh rows and stores only the b retiring rows — half the HBM
      traffic of re-slicing the full 2b segment per step.
    * **T-fold.**  ``seg - V (T (V^T seg))`` becomes ``seg - (V T)(V^T seg)``
      with ``VT`` precomputed batched over all (g, s): two GEMMs per step
      instead of three.  (Association change: output matches the sequential
      walk to roundoff, not bitwise.)

    Plus a work trim: sweep i records only slots 0..nc(i) (the chase hop
    budget), so each group's scan stops at its own static slot count —
    ~540 of the 930 (g, s) steps at n=3840/b=128 carry any content.  The
    group loop unrolls in Python (static g: static V/VT slices, static row
    bases); per-step V/VT blocks stream in as ``lax.scan`` xs (no per-step
    dynamic gathers from the (ng, s_max, ...) block arrays).
    """
    n_sweeps, s_max, b = V.shape
    ncols = M.shape[1]
    G = b
    n_groups = -(-n_sweeps // G)
    pad_s = n_groups * G - n_sweeps
    dtype = M.dtype
    Vp = jnp.pad(V, ((0, pad_s), (0, 0), (0, 0)))
    Tp = jnp.pad(T, ((0, pad_s), (0, 0)))
    Vg = Vp.reshape(n_groups, G, s_max, b).transpose(0, 2, 1, 3)
    Tg = Tp.reshape(n_groups, G, s_max).transpose(0, 2, 1)
    Vg = jnp.where(Tg[..., None] == 0, jnp.zeros((), dtype), Vg)

    rows_i = jnp.arange(G)[:, None]
    cols_i = jnp.arange(b)[None, :] + rows_i

    def build(vg, tg):
        F = jnp.zeros((G, G + b), dtype).at[rows_i, cols_i].set(vg)
        Vb = F.T
        Tb = _larft_closed_form(Vb, tg)
        return Vb, pdot(Vb, Tb)

    Vb, VTb = jax.vmap(jax.vmap(build))(Vg, Tg)  # (ng, s_max, G+b, G) x2

    P = n_groups * G + s_max * b + 1
    Mp = jnp.pad(M, ((0, P + G + b - M.shape[0]), (0, 0)))

    # Per-group slot budget: sweep i records slots 0..nc(i) only (nc = hop
    # count of the chase schedule, decreasing in i), so group g's slots
    # beyond nc(gG)+1 are identically tau=0 — skip them (at n=3840/b=128
    # this trims the walk from ng*s_max = 930 steps to ~540).  The group
    # loop unrolls in Python: g is static, so the V/VT blocks are static
    # slices and each group's scan has its own static slot count.
    n_prob = n_sweeps + 1  # band matrix dimension the records came from

    for g in range(n_groups - 1, -1, -1):
        s_g = min(s_max, nc_of_static(g * G, n_prob, b) + 1)
        r0 = g * G + 1
        head = lax.slice_in_dim(Mp, r0, r0 + b, axis=0)

        def slot(carry, xs, r0=r0):
            Mp, head, s = carry
            Vs, VTs = xs
            rs = r0 + s * b
            z = jnp.zeros((), rs.dtype)
            fresh = lax.dynamic_slice(Mp, (rs + b, z), (b, ncols))
            seg = jnp.concatenate([head, fresh])
            coef = pdot(Vs.T, seg)
            seg = seg - pdot(VTs, coef)
            Mp = lax.dynamic_update_slice(Mp, seg[:b], (rs, z))
            return (Mp, seg[b:], s + 1), None

        (Mp, tail, _), _ = lax.scan(
            slot,
            (Mp, head, jnp.int32(0)),
            (Vb[g, :s_g], VTb[g, :s_g]),
        )
        Mp = lax.dynamic_update_slice(Mp, tail, (r0 + s_g * b, 0))

    return Mp[: M.shape[0]]


def _apply_chase_reflectors_wy_pair(VL, TL, VR, TR, ML, MR, band):
    """Both chase back-transforms (``L @ Ub`` and ``R @ Vb``) in ONE
    vmapped walk: the left and right record sets have identical shape and
    slot schedule, so stacking them turns every two-GEMM step of
    :func:`_apply_chase_reflectors_wy_carry` into one BATCHED two-GEMM
    step — half the sequential GEMM chain of the back-transform tail."""
    V2 = jnp.stack([VL, VR])
    T2 = jnp.stack([TL, TR])
    M2 = jnp.stack([ML, MR])
    out = jax.vmap(
        _apply_chase_reflectors_wy_carry, in_axes=(0, 0, 0, None)
    )(V2, T2, M2, band)
    return out[0], out[1]


def _apply_stage1_reflectors_pair(Vq, Tq, Vl, Tl, MU, MV):
    """Back-transform both Stage-I factor products in ONE batched walk:
    ``U1 @ MU`` and ``V1 @ MV`` where ``U1 = Q_0 Q_1 ... Q_{p-1}`` and
    ``V1 = P_0 P_1 ... P_{p-1}`` are the products of the recorded panel
    block reflectors (``dense_to_band_rec`` contract: ``Vq[k] = V_k^T``,
    ``Tq[k] = T_k^T``; ``Q_k = I - V_k T_k V_k^T``).

    Applying the records backward to the (n, k) matrices the caller
    actually needs costs the same GEMM FLOPs as the eager U1/V1
    accumulation — but it leaves Stage I's sequential critical path, the
    QR and LQ sides batch into single 2-wide GEMM steps (identical shapes
    and schedule), and the two final ``U1 @ LU`` / ``V1 @ RV`` n^3 GEMMs
    disappear entirely.
    """
    V2 = jnp.stack([Vq, Vl], axis=1)  # (p, 2, b, n)
    T2 = jnp.stack([Tq, Tl], axis=1)  # (p, 2, b, b)
    M2 = jnp.stack([MU, MV])          # (2, n, k)

    def step(M2, rec):
        Vt, Tt = rec                  # (2, b, n), (2, b, b)
        W = pdot(Vt, M2)              # (2, b, k)
        M2 = M2 - pdot(
            jnp.transpose(Vt, (0, 2, 1)), pdot(jnp.transpose(Tt, (0, 2, 1)), W)
        )
        return M2, None

    M2, _ = lax.scan(step, M2, (V2, T2), reverse=True)
    return M2[0], M2[1]


def svd_two_stage(A, band=None, k=None):
    """Full SVD through the flagship two-stage pipeline (square ``A``).

    ``A = U diag(s) V^T`` via: Stage I with compact-WY reflector recording
    (``A = U1 Ab V1^T`` with U1/V1 left as panel records), reflector-recording
    chase (``Ab = L B R^T``),
    TGK bisection + inverse iteration for the bidiagonal vectors
    (``B = Ub diag(s) Vb^T``), then back-transformation
    ``U = U1 (L Ub)``, ``V = V1 (R Vb)``.

    ``k``: if given, compute only the top-``k`` singular triplets (partial
    SVD) — the reduction and bisection are unchanged (they produce the full
    spectrum for the cost of the band reduction), but inverse iteration and
    every back-transform GEMM run on ``k`` lanes instead of ``n``.

    The reference's two-stage *documents* U1/V1 outputs it never produces
    (svd_parallel.h:400-407); this delivers them.
    """
    from svdsolver_tpu.models.svd import _auto_block
    from svdsolver_tpu.models.two_stage import (
        dense_to_band_rec,
        band_to_bidiagonal_accum,
    )

    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("svd_two_stage expects a square matrix; use svd()")
    b = int(band) if band else _auto_block(n)
    while b >= n and b > 2:  # tiny inputs: the chase needs band < n
        b //= 2
    pad = (-n) % b
    if pad:
        A = jnp.pad(A, ((0, pad), (0, pad)))
    Ab, Vq, Tq, Vl, Tl = dense_to_band_rec(A, band=b)
    d, e, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
    # trim record slots the schedule never fills
    np_ = Ab.shape[0]
    s_used = s_max_of(np_, b)
    if s_used < VL.shape[1]:
        VL, TL = VL[:, :s_used], TL[:, :s_used]
        VR, TR = VR[:, :s_used], TR[:, :s_used]
    U_b, s, V_b = bidiagonal_svd(d, e, k=k)
    kout = n if k is None else min(int(k), n)
    LU, RV = _apply_chase_reflectors_wy_pair(
        VL, TL, VR, TR, U_b, V_b, b
    )  # L @ Ub, R @ Vb — one batched walk
    U, V = _apply_stage1_reflectors_pair(
        Vq, Tq, Vl, Tl, LU, RV
    )  # U1 @ LU, V1 @ RV — one batched backward walk over the records
    return U[:n, :kout], s[:kout], V[:n, :kout].T


def svd(A, panel=32, method="tpu2", band=None):
    """Full (thin) singular value decomposition of ``A``.

    Returns ``(U, s, Vh)`` with ``A ~= U @ diag(s) @ Vh``, s descending;
    for m x n input, U is (m, k) and Vh (k, n) with k = min(m, n).
    No reference counterpart (the reference computes singular values only).
    Rectangular inputs reduce to the square triangular factor by a one-sided
    QR first.

    ``method``: "tpu2"/"multicore"/"tpu1" run the two-stage pipeline with
    chase-reflector back-transformation (:func:`svd_two_stage` — the fast
    path at scale); "singlecore" runs the one-stage blocked reduction with
    accumulated factors; "jacobi" runs one-sided block Jacobi
    (:func:`~svdsolver_tpu.models.jacobi.svd_jacobi` — high RELATIVE
    accuracy on graded matrices, all-GEMM compute shape).
    """
    import numpy as _np

    if _np.iscomplexobj(A):  # host numpy complex: split (re, im) pipeline
        if method != "tpu2":
            raise ValueError(
                f"complex input supports only the default pipeline "
                f"(got method={method!r}); call "
                f"svdsolver_tpu.models.complex_svd.svd_c directly"
            )
        from svdsolver_tpu.models.complex_svd import svd_c

        return svd_c(A)
    m, n = A.shape
    if method == "jacobi":
        from svdsolver_tpu.models.jacobi import svd_jacobi

        return svd_jacobi(A)
    if m != n:
        if m < n:
            U, s, Vh = svd(A.T, panel=panel, method=method, band=band)
            return Vh.T, s, U.T
        Q, R = jnp.linalg.qr(A, mode="reduced")  # (m, n), (n, n)
        Ur, s, Vh = svd(R, panel=panel, method=method, band=band)
        return pdot(Q, Ur), s, Vh
    if method in ("tpu2", "tpu1", "multicore"):
        return svd_two_stage(A, band=band)
    d, e, Ug, Vg = bidiagonalize_blocked_uv(A, panel=panel)
    U_b, s, V_b = bidiagonal_svd(d, e)
    U = pdot(Ug, U_b)
    V = pdot(Vg, V_b)
    return U, s, V.T


def svds(A, k, band=None):
    """Top-``k`` partial SVD: the ``k`` largest singular triplets of ``A``.

    Returns ``(U, s, Vh)`` with U (m, k), s (k,) descending, Vh (k, n) and
    ``A @ Vh.T ~= U * s``.  No reference counterpart (the reference computes
    the full set of singular values only).

    Runs the flagship two-stage reduction + full-spectrum bisection (those
    cost the same regardless of ``k`` — the reduction is where the FLOPs
    are), but inverse iteration, the polar polish, the chase back-transform,
    and the final Stage-I GEMMs all run on ``k`` lanes, so the
    vectors-dominated tail of the pipeline shrinks by ~n/k.
    """
    m, n = A.shape
    k = int(k)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"k={k} out of range for shape {A.shape}")
    if m != n:
        if m < n:
            U, s, Vh = svds(A.T, k, band=band)
            return Vh.T, s, U.T
        Q, R = jnp.linalg.qr(A, mode="reduced")  # (m, n), (n, n)
        Ur, s, Vh = svds(R, k, band=band)
        return pdot(Q, Ur), s, Vh
    return svd_two_stage(A, band=band, k=k)


def svd_batch(As, block=None):
    """Full SVD of a batch of square matrices:
    (B, n, n) -> (U (B, n, n), s (B, n) descending, Vh (B, n, n)).

    Single-device batched execution of the two-stage pipeline under
    ``jax.vmap``, whose per-op dispatch cost is amortized across the batch
    (the Triton kernels batch as an extra grid axis).  Batched
    counterpart of :func:`svdsolver_tpu.models.svd.svdvals_batch`; for
    multi-chip sharded batches see ``parallel.distributed``.
    """
    from svdsolver_tpu.models.svd import _auto_block, _pad_to_multiple
    from svdsolver_tpu.models.two_stage import (
        dense_to_band_uv,
        band_to_bidiagonal_accum,
    )

    if As.ndim != 3 or As.shape[-1] != As.shape[-2]:
        raise ValueError(f"svd_batch expects (B, n, n), got {As.shape}")
    n = As.shape[-1]
    b = int(block) if block else _auto_block(n)
    while b >= n and b > 2:
        b //= 2

    def one(A):
        Ap, _ = _pad_to_multiple(A, b)
        Ab, U1, V1 = dense_to_band_uv(Ap, band=b)
        d, e, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
        np_ = Ab.shape[0]
        s_used = s_max_of(np_, b)
        if s_used < VL.shape[1]:
            VL, TL = VL[:, :s_used], TL[:, :s_used]
            VR, TR = VR[:, :s_used], TR[:, :s_used]
        sig = dispatch.bisect_svdvals(d, e)
        U_b, V_b = tgk_vectors(d, e, sig)
        LU = _apply_chase_reflectors_wy(VL, TL, U_b, b)
        RV = _apply_chase_reflectors_wy(VR, TR, V_b, b)
        U = pdot(U1, LU)
        V = pdot(V1, RV)
        return U[:n, :n], sig[:n], V[:n, :n].T

    return jax.vmap(one)(As)
