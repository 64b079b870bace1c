"""Two-stage bidiagonalization — the "multicore"/"CUDA" model in JAX.

Stage I  (dense -> band):  panel QR/LQ with compact-WY block reflectors and
GEMM trailing updates (capability parity with the reference's ``brd_p1``
family: svd_parallel.h:410, svd_cpu.h:370, svd_cuda_1.cu:750,
svd_cuda_2.cu:1117).  The reference's tiled/OpenMP and CUDA kernel-launch
structure is replaced by one jitted ``lax.fori_loop`` over panels whose
trailing updates are full-width GEMMs — XLA hands them to the GEMM
library, which takes the place of both the OpenMP tile fan-out and the
``mm_kernel`` launches.

Stage II (band -> bidiagonal): Householder bulge chasing
(reference: ``brd_p2`` + ``band_rd_top/right/left``, svd_parallel.h:568-695)
over fixed-size windows.  The reference clamps every window with ``min()`` at
the matrix edges; here the matrix is zero-padded once so all windows are
static-shape and edge reflectors degenerate to no-ops — no masking, no
dynamic shapes.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.householder import householder_vector
from svdsolver_tpu.ops.precision import pdot
from svdsolver_tpu.ops.chase_schedule import nc_of, nc_of_static, s_max_of


def _panel_qr_step(A, c0, r_off, b):
    """Factor panel columns ``[c0, c0+b)`` with pivot row ``r_off + j`` for
    panel column ``j``; apply the aggregated block reflector to the trailing
    matrix.  ``r_off == c0`` gives a QR panel (dense->band column step);
    calling on ``A.T`` with ``r_off == c0 + b`` gives the LQ row step.

    Returns the updated ``A``.  Compact-WY: ``Q = I - V T V^T`` accumulated
    via the larft forward recurrence (the reference's ``hholder_compact`` /
    ``wy_compact_cuda``: svd_parallel.h:96, svd_cuda_2.cu:838).
    """
    m, n = A.shape
    dtype = A.dtype
    P0 = lax.dynamic_slice(A, (0, c0), (m, b))
    V0 = jnp.zeros((m, b), dtype)
    T0 = jnp.zeros((b, b), dtype)
    ridx = jnp.arange(m)

    def col_body(j, carry):
        P, V, T = carry
        p = r_off + j
        v, tau, beta = householder_vector(P[:, j], p)
        P = P - tau * jnp.outer(v, pdot(v, P))
        # Exact column j: zeros strictly below the pivot, beta at the pivot.
        colj = jnp.where(ridx > p, jnp.zeros((), dtype), P[:, j])
        pc = jnp.minimum(p, m - 1)
        colj = colj.at[pc].set(jnp.where(p < m, beta, colj[pc]))
        P = P.at[:, j].set(colj)
        # larft update: T[:, j] = -tau * T @ (V^T v);  T[j, j] = tau.
        w = pdot(V.T, v)  # zero at indices >= j (those V columns are still zero)
        T = T.at[:, j].set(-tau * pdot(T, w))
        T = T.at[j, j].set(tau)
        V = V.at[:, j].set(v)
        return P, V, T

    P, V, T = lax.fori_loop(0, b, col_body, (P0, V0, T0), unroll=4)
    # Trailing update A <- (I - V T V^T)^T A; columns left of the panel are
    # zero under V's row support (already reduced), the panel itself is
    # overwritten with its factored form below.
    W = pdot(V.T, A)
    A = A - pdot(V, pdot(T.T, W))
    A = lax.dynamic_update_slice(A, P, (0, c0))
    return A


def segment_bounds(nb, segments):
    """Panel-index boundaries splitting ``nb`` panels into ``segments``
    roughly equal runs (for static trailing-matrix shrinking)."""
    segments = max(1, min(int(segments), nb))
    return [nb * s // segments for s in range(segments + 1)]


@functools.partial(jax.jit, static_argnames=("band", "segments"))
def dense_to_band(A, band=32, segments=1):
    """Stage I: reduce square ``A`` to upper-band form (``band`` superdiagonals).

    Requires ``n % band == 0`` (as the reference does — README.md:45); callers
    pad otherwise (zero padding only appends zero singular values).

    ``segments``: the trailing updates run on the static sub-block
    ``A[s0:, s0:]`` per segment of panels (the static-shape form of the
    reference's shrinking trailing matrix, svd_cuda_2.cu:1172-1175
    ``reduce``) — full-width
    GEMMs all the way down would cost 3x the FLOPs of the true trailing
    updates.  Exact: a panel at column c >= s0 only reads/writes rows and
    columns >= s0 (reflector support starts at the pivot), and everything
    it reads outside the band there is still dense.  Default 1: the path
    runs 2n dependent column steps, so it is bound by their count rather
    than by the GEMMs (the GPU default is not tuned yet; ROADMAP 1.4).
    """
    n = A.shape[0]
    b = int(band)
    if A.shape[0] != A.shape[1]:
        raise ValueError("dense_to_band expects a square matrix")
    if n % b != 0:
        raise ValueError(f"n={n} must be divisible by band={b}")

    def step(k, S):
        c = k * b
        S = _panel_qr_step(S, c, c, b)           # QR on panel columns
        S = _panel_qr_step(S.T, c, c + b, b).T   # LQ on panel rows
        return S

    bounds = segment_bounds(n // b, segments)
    for s in range(len(bounds) - 1):
        k0, k1 = bounds[s], bounds[s + 1]
        if k0 == k1:
            continue
        s0 = k0 * b
        sub = lax.dynamic_slice(A, (s0, s0), (n - s0, n - s0))
        sub = lax.fori_loop(0, k1 - k0, step, sub)
        A = lax.dynamic_update_slice(A, sub, (s0, s0))
    return A


@functools.partial(jax.jit, static_argnames=("band",))
def dense_to_band_uv(A, band=32):
    """Stage I with orthogonal-factor accumulation: returns ``(Ab, U1, V1)``
    with ``A = U1 @ Ab @ V1^T`` (Ab upper-band).

    Per QR panel ``U1 <- U1 (I - V T V^T)`` and per LQ panel
    ``V1 <- V1 (I - V2 T2 V2^T)`` — all compact-WY GEMMs.
    """
    n = A.shape[0]
    b = int(band)
    if A.shape[0] != A.shape[1]:
        raise ValueError("dense_to_band_uv expects a square matrix")
    if n % b != 0:
        raise ValueError(f"n={n} must be divisible by band={b}")
    dtype = A.dtype

    def panel_qr_collect(A, c0, r_off):
        """As _panel_qr_step but returning (A, V, T)."""
        m = A.shape[0]
        P0 = lax.dynamic_slice(A, (0, c0), (m, b))
        V0 = jnp.zeros((m, b), dtype)
        T0 = jnp.zeros((b, b), dtype)
        ridx = jnp.arange(m)

        def col_body(j, carry):
            P, V, T = carry
            p = r_off + j
            v, tau, beta = householder_vector(P[:, j], p)
            P = P - tau * jnp.outer(v, pdot(v, P))
            colj = jnp.where(ridx > p, jnp.zeros((), dtype), P[:, j])
            pc = jnp.minimum(p, m - 1)
            colj = colj.at[pc].set(jnp.where(p < m, beta, colj[pc]))
            P = P.at[:, j].set(colj)
            w = pdot(V.T, v)
            T = T.at[:, j].set(-tau * pdot(T, w))
            T = T.at[j, j].set(tau)
            V = V.at[:, j].set(jnp.where(tau != 0, v, jnp.zeros((m,), dtype)))
            return P, V, T

        P, V, T = lax.fori_loop(0, b, col_body, (P0, V0, T0), unroll=4)
        W = pdot(V.T, A)
        A = A - pdot(V, pdot(T.T, W))
        A = lax.dynamic_update_slice(A, P, (0, c0))
        return A, V, T

    U0 = jnp.eye(n, dtype=dtype)
    Vc0 = jnp.eye(n, dtype=dtype)

    def step(k, carry):
        A, U1, V1 = carry
        c = k * b
        A, V, T = panel_qr_collect(A, c, c)
        U1 = U1 - pdot(pdot(pdot(U1, V), T), V.T)  # U1 (I - V T V^T)
        At, V2, T2 = panel_qr_collect(A.T, c, c + b)
        A = At.T
        V1 = V1 - pdot(pdot(pdot(V1, V2), T2), V2.T)  # V1 (I - V2 T2 V2^T)
        return A, U1, V1

    return lax.fori_loop(0, n // b, step, (A, U0, Vc0))


@functools.partial(jax.jit, static_argnames=("band",))
def dense_to_band_rec(A, band=32):
    """Stage I with reflector *recording* instead of eager U1/V1 accumulation.

    Returns ``(Ab, Vq, Tq, Vl, Tl)`` where ``Vq/Tq`` (shape ``(p, b, n)`` /
    ``(p, b, b)``, ``p = n // band``) record the QR-panel block reflectors in
    transposed layout (``Vq[k] = V_k^T``, ``Tq[k] = T_k^T``) and ``Vl/Tl``
    the LQ-panel ones, such that

        ``A = Q_0 Q_1 ... Q_{p-1} @ Ab @ (P_0 P_1 ... P_{p-1})^T``

    with ``Q_k = I - Vq[k]^T Tq[k]^T Vq[k]`` and ``P_k`` likewise from
    ``Vl/Tl``.  Same mathematics as :func:`dense_to_band_uv` — but the
    ~4n^3-FLOP factor updates leave the sequential Stage-I critical path;
    the caller back-transforms whatever (thin) matrices it actually needs
    (see ``vectors._apply_stage1_reflectors_pair``), which also subsumes
    the two final ``U1 @ LU`` GEMMs.  Reference analog: the U1/V1 factors
    svd_parallel.h:400-407 documents but never produces.
    """
    n = A.shape[0]
    b = int(band)
    if A.shape[0] != A.shape[1]:
        raise ValueError("dense_to_band_rec expects a square matrix")
    if n % b != 0:
        raise ValueError(f"n={n} must be divisible by band={b}")
    dtype = A.dtype

    def panel_qr_collect(A, c0, r_off):
        m = A.shape[0]
        P0 = lax.dynamic_slice(A, (0, c0), (m, b))
        V0 = jnp.zeros((m, b), dtype)
        T0 = jnp.zeros((b, b), dtype)
        ridx = jnp.arange(m)

        def col_body(j, carry):
            P, V, T = carry
            p = r_off + j
            v, tau, beta = householder_vector(P[:, j], p)
            P = P - tau * jnp.outer(v, pdot(v, P))
            colj = jnp.where(ridx > p, jnp.zeros((), dtype), P[:, j])
            pc = jnp.minimum(p, m - 1)
            colj = colj.at[pc].set(jnp.where(p < m, beta, colj[pc]))
            P = P.at[:, j].set(colj)
            w = pdot(V.T, v)
            T = T.at[:, j].set(-tau * pdot(T, w))
            T = T.at[j, j].set(tau)
            V = V.at[:, j].set(jnp.where(tau != 0, v, jnp.zeros((m,), dtype)))
            return P, V, T

        P, V, T = lax.fori_loop(0, b, col_body, (P0, V0, T0), unroll=4)
        W = pdot(V.T, A)
        A = A - pdot(V, pdot(T.T, W))
        A = lax.dynamic_update_slice(A, P, (0, c0))
        return A, V, T

    def step(A, k):
        c = k * b
        A, V, T = panel_qr_collect(A, c, c)
        At, V2, T2 = panel_qr_collect(A.T, c, c + b)
        return At.T, (V.T, T.T, V2.T, T2.T)

    Ab, (Vq, Tq, Vl, Tl) = lax.scan(step, A, jnp.arange(n // b))
    return Ab, Vq, Tq, Vl, Tl


def make_window_pairs(w, record=False):
    """Build the two Stage-II window kernels for window parameter ``w``
    (= band + 1): ``top_pair`` opens a sweep (right-elim row 0 over cols
    [0, w-1), then left-elim rows [1, w)), ``chase_pair`` advances the bulge
    (right-elim row 0 over cols [0, w-1), then left-elim rows [w-1, 2w-2)).

    Shared by every consumer of the sequential chase schedule — the local
    chase, the recording chase, the wavefront schedule, and the multi-chip
    pipelined chase (parallel/distributed.py) — so the "same reflectors as
    the sequential chase" invariant those schedules rely on is enforced by
    construction, not by keeping copies in sync.

    With ``record=True`` each kernel also returns its reflectors:
    ``(W, v_right, tau_right, v_left, tau_left)``.
    """

    def _pair(W, left_r0):
        v, tau, _ = householder_vector(W[0, : w - 1], 0)
        Wr = W[:, : w - 1]
        W = W.at[:, : w - 1].set(Wr - tau * jnp.outer(pdot(Wr, v), v))
        v2, tau2, _ = householder_vector(W[left_r0:, 0], 0)
        Ws = W[left_r0:, :]
        W = W.at[left_r0:, :].set(Ws - tau2 * jnp.outer(v2, pdot(v2, Ws)))
        if record:
            return W, v, tau, v2, tau2
        return W

    def top_pair(W):
        return _pair(W, 1)

    def chase_pair(W):
        return _pair(W, w - 1)

    return top_pair, chase_pair


def _left_elim(A, r0, c0, wr, wc):
    """Householder on window column 0 (pivot = window row 0), applied from the
    left to the whole window (reference: band_rd_left, svd_parallel.h:619)."""
    W = lax.dynamic_slice(A, (r0, c0), (wr, wc))
    v, tau, _ = householder_vector(W[:, 0], 0)
    W = W - tau * jnp.outer(v, pdot(v, W))
    return lax.dynamic_update_slice(A, W, (r0, c0))


def _right_elim(A, r0, c0, wr, wc):
    """Householder on window row 0 (pivot = window col 0), applied from the
    right to the whole window (reference: band_rd_right, svd_parallel.h:601)."""
    W = lax.dynamic_slice(A, (r0, c0), (wr, wc))
    v, tau, _ = householder_vector(W[0, :], 0)
    W = W - tau * jnp.outer(pdot(W, v), v)
    return lax.dynamic_update_slice(A, W, (r0, c0))


@functools.partial(jax.jit, static_argnames=("band",))
def band_to_bidiagonal(A, band=32):
    """Stage II: bulge-chase an upper-band matrix (``band`` superdiagonals)
    down to bidiagonal.  Returns ``(d, e)``.

    Mirrors the reference's sweep structure (brd_p2, svd_parallel.h:639): for
    each column ``i`` a row elimination + column elimination open the sweep,
    then ``right``/``left`` window pairs chase the bulge off the band, each
    advancing ``w - 1`` rows/cols (``w = band + 1``, the reference's
    ``b_size += 1`` at svd_parallel.h:649).
    """
    n = A.shape[0]
    dtype = A.dtype
    w = int(band) + 1
    if n < 2:
        return jnp.abs(jnp.diag(A)), jnp.zeros((0,), dtype)
    # Zero-pad so every window is in-bounds: reflectors over the pad are
    # identity (zero tails) and pad writes are discarded on return.
    pad = 2 * w + 2
    Ap = jnp.pad(A, ((0, pad), (0, pad)))
    step = w - 1

    # Each right/left elimination pair touches two *static* subviews of one
    # combined window, so a pair costs a single dynamic slice + update —
    # halving the sequential HBM round-trips vs slicing per elimination.
    top_pair, chase_pair = make_window_pairs(w)

    def sweep(i, Ap):
        # Task 1 (band_rd_top): eliminate row i right of the superdiagonal,
        # then column i+1 below the diagonal.
        W = lax.dynamic_slice(Ap, (i, i + 1), (w, 2 * w - 2))
        Ap = lax.dynamic_update_slice(Ap, top_pair(W), (i, i + 1))
        # Chase: window corners advance w-1 per iteration.
        n_chase = nc_of(i, n, w - 1)

        def chase(k, Ap):
            r = i + 1 + k * step
            c = i + 1 + (k + 1) * step
            W = lax.dynamic_slice(Ap, (r, c), (2 * w - 2, 2 * w - 2))
            return lax.dynamic_update_slice(Ap, chase_pair(W), (r, c))

        return lax.fori_loop(0, n_chase, chase, Ap)

    Ap = lax.fori_loop(0, n - 1, sweep, Ap)
    B = Ap[:n, :n]
    return jnp.diag(B), jnp.diag(B, 1)


@functools.partial(jax.jit, static_argnames=("band",))
def band_to_bidiagonal_accum(A, band=32):
    """Stage II chase that also RECORDS every Householder reflector, for
    singular-vector back-transformation.

    Returns ``(d, e, VL, TL, VR, TR)``: reflector (i, s) of sweep ``i`` at
    slot ``s`` (s=0: the top pair, s>=1: chase pair s-1) has length ``band``
    and support ``[i+1+s*band, i+1+(s+1)*band)`` — rows for the left
    reflectors ``VL`` (with taus ``TL``), columns for the right ``VR``/``TR``.
    Within one sweep the slots' supports are disjoint (they tile the band),
    which is what makes the back-transform batchable per sweep
    (models/vectors.py:apply_chase_*).

    The band matrix factors as ``A = L @ bidiag(d, e) @ R^T`` where
    ``L = H(1) H(2) ...`` (left reflectors, creation order) and
    ``R^T = G(1) G(2) ...`` (right reflectors, creation order).

    Same schedule and arithmetic as :func:`band_to_bidiagonal` (the
    reference's brd_p2, svd_parallel.h:639) — differential-tested.

    Implementation note: records are emitted as ``lax.scan`` outputs with only
    small per-sweep buffers in the inner-loop carry.  An earlier version
    scatter-updated the full ``(n-1, s_max, b)`` arrays inside the nested
    dynamic-trip loops; that shape has miscompiled on an accelerator
    backend (records came back with impossible values — reflector entries
    must satisfy ``|v| <= 1`` under larfg scaling — while the same program
    is exact on CPU), so keep the giant arrays out of loop carries.
    """
    n = A.shape[0]
    dtype = A.dtype
    w = int(band) + 1
    b = w - 1
    if n < 2:
        raise ValueError("band_to_bidiagonal_accum needs n >= 2")
    pad = 2 * w + 2
    Ap = jnp.pad(A, ((0, pad), (0, pad)))
    step = w - 1
    s_max = s_max_of(n, w - 1)  # top + max chase slots

    top_pair, chase_pair = make_window_pairs(w, record=True)

    def sweep(Ap, i):
        i = jnp.int32(i)
        W = lax.dynamic_slice(Ap, (i, i + 1), (w, 2 * w - 2))
        W, vr, tr, vl, tl = top_pair(W)
        Ap = lax.dynamic_update_slice(Ap, W, (i, i + 1))
        zero = jnp.int32(0)
        vR = jnp.zeros((s_max, b), dtype).at[0].set(vr)
        tR = jnp.zeros((s_max,), dtype).at[0].set(tr)
        vL = jnp.zeros((s_max, b), dtype).at[0].set(vl[: w - 1])
        tL = jnp.zeros((s_max,), dtype).at[0].set(tl)
        n_chase = nc_of(i, n, w - 1)

        def chase(k, carry):
            Ap, vR, tR, vL, tL = carry
            r = i + 1 + k * step
            c = i + 1 + (k + 1) * step
            W = lax.dynamic_slice(Ap, (r, c), (2 * w - 2, 2 * w - 2))
            W, vr, tr, vl, tl = chase_pair(W)
            Ap = lax.dynamic_update_slice(Ap, W, (r, c))
            k1 = jnp.int32(k) + 1
            vR = lax.dynamic_update_slice(vR, vr[None, :], (k1, zero))
            tR = tR.at[k1].set(tr)
            vL = lax.dynamic_update_slice(vL, vl[: w - 1][None, :], (k1, zero))
            tL = tL.at[k1].set(tl)
            return Ap, vR, tR, vL, tL

        Ap, vR, tR, vL, tL = lax.fori_loop(
            0, n_chase, chase, (Ap, vR, tR, vL, tL)
        )
        return Ap, (vL, tL, vR, tR)

    Ap, (VL, TL, VR, TR) = lax.scan(sweep, Ap, jnp.arange(n - 1))
    B = Ap[:n, :n]
    return jnp.diag(B), jnp.diag(B, 1), VL, TL, VR, TR


@functools.partial(jax.jit, static_argnames=("band",))
def band_to_bidiagonal_wavefront(A, band=32):
    """Stage II with pipelined sweeps — an answer to the reference's
    OpenMP task-DAG intent (its ``Tracker`` scheduler stub, svd_parallel.h:56,
    was never wired in; here the wavefront actually runs).

    Bulge-chase sweeps are pipelined with a spacing of 3 chase-slots: sweep
    ``i`` executes slot ``s`` (s=0: top pair, s>=1: chase pair) at tick
    ``t = 3*i + s``.  With window corners advancing ``w-1`` rows per slot,
    spacing 3 makes concurrent windows provably disjoint (row separation
    ``3(w-1)-1 >= 2(w-1)`` for w >= 2), so each tick gathers the ~S/3 active
    windows as one batched slice, eliminates them with a vmapped pair kernel,
    and writes them back — reducing sequential depth from ``n^2/b`` window
    pairs to ``~3n`` ticks.

    Inactive/overshot lanes are redirected to an all-zero dummy corner of the
    padding (identity eliminations), which keeps every shape static.
    """
    n = A.shape[0]
    dtype = A.dtype
    w = int(band) + 1
    if n < 2:
        return jnp.abs(jnp.diag(A)), jnp.zeros((0,), dtype)
    step = w - 1
    ww = 2 * w - 2  # chase window edge
    # Longest sweep (i=0) chase-slot count; every sweep gets S_max slots —
    # overshoot windows land in zero padding and degenerate to no-ops.
    s_max = nc_of_static(0, n, w - 1)
    pad = 6 * w  # genuine windows stay below n + 3w; dummy corner above n + 4w
    Ap = jnp.pad(A, ((0, pad), (0, pad)))
    Np = n + pad
    dummy = Np - ww
    G = (s_max + 2) // 3 + 1  # max concurrent chase lanes
    lanes = jnp.arange(G, dtype=jnp.int32)

    top_pair, chase_pair = make_window_pairs(w)

    def tick(t, Ap):
        # Top pair for the sweep starting this tick (at most one: t % 3 == 0).
        i0 = t // 3
        top_ok = jnp.logical_and(t % 3 == 0, i0 <= n - 2)
        tr = jnp.where(top_ok, i0, dummy)
        tc = jnp.where(top_ok, i0 + 1, dummy)
        Wt = lax.dynamic_slice(Ap, (tr, tc), (w, ww))
        Ap = lax.dynamic_update_slice(Ap, top_pair(Wt), (tr, tc))
        # Batched chase pairs for all active sweeps.
        q = (t - 1) // 3  # newest sweep that could be chasing
        iv = q - lanes
        sv = t - 3 * iv
        ok = (iv >= 0) & (iv <= n - 2) & (sv >= 1) & (sv <= s_max)
        rv = jnp.where(ok, iv + 1 + (sv - 1) * step, dummy)
        cv = jnp.where(ok, rv + step, dummy)
        Wb = jax.vmap(
            lambda r, c: lax.dynamic_slice(Ap, (r, c), (ww, ww))
        )(rv, cv)
        Wb = jax.vmap(chase_pair)(Wb)
        for j in range(G):
            Ap = lax.dynamic_update_slice(Ap, Wb[j], (rv[j], cv[j]))
        return Ap

    T = 3 * (n - 2) + s_max + 1
    Ap = lax.fori_loop(0, T, tick, Ap)
    B = Ap[:n, :n]
    return jnp.diag(B), jnp.diag(B, 1)


@functools.partial(jax.jit, static_argnames=("band", "wavefront"))
def bidiagonalize_two_stage(A, band=32, wavefront=False):
    """Full two-stage reduction: dense -> band -> bidiagonal; returns (d, e).

    ``wavefront=True`` selects the pipelined Stage-II schedule — numerically
    exact (bitwise-equal in f64) but slower on the H100 than the sequential
    schedule (PERF.md): XLA's batched gather/scatter of the scattered
    windows costs more than the shorter dependent chain saves.
    """
    A = dense_to_band(A, band=band)
    if wavefront:
        return band_to_bidiagonal_wavefront(A, band=band)
    return band_to_bidiagonal(A, band=band)
