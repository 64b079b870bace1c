"""Complex SVD in split (re, im) representation: unitary bidiagonalization
to a REAL bidiagonal + the real pipeline.

No reference counterpart (the reference is float/double only — matrix.h:79);
this is the zgebrd/zbdsqr capability a complete framework needs.  Two
choices shape the design:

* Complex arrays are carried as ``(re, im)`` pairs of real arrays and
  every complex operation is expanded into real arithmetic — a complex
  contraction is 4 real matmuls.  (Native complex dtypes are a planned
  replacement; the split form runs unchanged on any backend.)  The
  functional core is pure and jittable over the split pairs; thin wrappers
  convert host numpy complex arrays at the API boundary.
* Complex Householder reflectors use LAPACK zlarfg scaling, which produces
  a REAL beta at every pivot — so the bidiagonal {d, e} of a complex matrix
  is real *by construction* (no phase-normalization pass) and the entire
  real diagonalization stack (bisection, dqds, TGK inverse iteration
  with cluster coupling) applies unchanged.  Only the reduction and the
  final back-transform GEMMs are complex.

Reflector conventions (differential-tested vs numpy in tests/test_complex):

* column elimination: ``(v, tau, beta) = householder_vector_c(x, p)`` gives
  unitary ``H = I - tau v v^H`` with ``H^H x = beta e_p`` (beta REAL);
  apply ``A <- H^H A = A - conj(tau) v (v^H A)`` and accumulate
  ``U <- U H = U - tau (U v) v^H``.  Unlike the real case a reflector is
  needed even for a zero tail when the pivot has a nonzero imaginary part
  (it rotates the pivot onto the real axis).
* row elimination at row r: run zlarfg on ``y = conj(A[r, :])``; then
  ``A <- A (I - tau u u^H)`` zeroes ``A[r, p+1:]`` with ``A[r, p]`` real,
  and the right factor accumulates as ``Vh <- (I - conj(tau) u u^H) Vh``
  (the module keeps ``Vh = V^H`` directly, so ``A_orig = U A_cur Vh`` is
  loop-invariant).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.precision import pdot

__all__ = ["bidiagonalize_gk_c", "svdvals_c", "svd_c", "householder_vector_c"]


# ---------------------------------------------------------------------------
# split-complex helpers: a "complex" array/scalar is a (re, im) pair
# ---------------------------------------------------------------------------

def _cmatmul(a, b):
    """(ar, ai) @ (br, bi) -> 4 real contractions."""
    ar, ai = a
    br, bi = b
    return (pdot(ar, br) - pdot(ai, bi), pdot(ar, bi) + pdot(ai, br))


def _cvecmat_h(v, A):
    """``v^H A`` for column pair v and matrix pair A -> row-vector pair."""
    vr, vi = v
    Ar, Ai = A
    return (pdot(vr, Ar) + pdot(vi, Ai), pdot(vr, Ai) - pdot(vi, Ar))


def _cmatvec(A, v):
    Ar, Ai = A
    vr, vi = v
    return (pdot(Ar, vr) - pdot(Ai, vi), pdot(Ar, vi) + pdot(Ai, vr))


def _couter(u, w):
    ur, ui = u
    wr, wi = w
    return (
        jnp.outer(ur, wr) - jnp.outer(ui, wi),
        jnp.outer(ur, wi) + jnp.outer(ui, wr),
    )


def _cscale(t, x):
    """scalar pair t * array pair x."""
    tr, ti = t
    xr, xi = x
    return (tr * xr - ti * xi, tr * xi + ti * xr)


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _cconj(a):
    return (a[0], -a[1])


def _cdiv(x, d):
    """array pair x / scalar pair d (guarded by caller)."""
    dr, di = d
    n2 = dr * dr + di * di
    xr, xi = x
    return ((xr * dr + xi * di) / n2, (xi * dr - xr * di) / n2)


def householder_vector_c(x, p):
    """Complex Householder reflector over a split pair (zlarfg semantics).

    ``x`` is a (re, im) pair of length-L vectors.  Returns ``(v, tau, beta)``
    with ``v`` a masked full-length pair (zero below the pivot,
    ``v[p] == 1``), ``tau`` a scalar pair, and ``beta`` a REAL scalar such
    that ``(I - tau v v^H)^H x' = beta e_p`` (``x'`` = x with indices < p
    ignored).
    """
    xr, xi = x
    L = xr.shape[0]
    dtype = xr.dtype
    idx = jnp.arange(L)
    tail = idx > p
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    xtr = jnp.where(tail, xr, zero)
    xti = jnp.where(tail, xi, zero)
    pc = jnp.minimum(p, L - 1)
    in_range = p < L
    pr = jnp.where(in_range, xr[pc], zero)
    pi = jnp.where(in_range, xi[pc], zero)
    sigma2 = jnp.sum(xtr * xtr + xti * xti)
    norm = jnp.sqrt(pr * pr + pi * pi + sigma2)
    sign = jnp.where(pr >= 0, one, -one)
    beta = -sign * norm  # REAL
    trivial = jnp.logical_and(sigma2 == 0, pi == 0)
    denom = (jnp.where(trivial, one, pr - beta), jnp.where(trivial, zero, pi))
    vr, vi = _cdiv((xtr, xti), denom)
    vr = vr.at[pc].set(jnp.where(in_range, one, vr[pc]))
    vi = vi.at[pc].set(jnp.where(in_range, zero, vi[pc]))
    safe_beta = jnp.where(beta == 0, one, beta)
    tau = (
        jnp.where(trivial, zero, (beta - pr) / safe_beta),
        jnp.where(trivial, zero, -pi / safe_beta),
    )
    beta_out = jnp.where(trivial, pr, beta)
    return (vr, vi), tau, beta_out


@functools.partial(jax.jit, static_argnames=("uv",))
def _bidiagonalize_gk_c(Ar, Ai, uv=False):
    """Split-complex Golub-Kahan: (d, e) real [+ (U, Vh) pairs if ``uv``].

    ``A = U @ B @ Vh`` with B the real upper bidiagonal {d, e}; U (m, m)
    and Vh (n, n) unitary.  Rank-1 masked-reflector form of the reference's
    ``brd`` (svd_serial.h:233), generalized to the complex field.
    """
    m, n = Ar.shape
    dtype = Ar.dtype
    if m < n:
        raise ValueError("internal: callers must pass m >= n")
    ridx = jnp.arange(m)
    cidx = jnp.arange(n)
    zero = jnp.zeros((), dtype)

    d0 = jnp.zeros((n,), dtype)
    e0 = jnp.zeros((max(n - 1, 1),), dtype)
    eye_m = jnp.eye(m, dtype=dtype) if uv else jnp.zeros((1, 1), dtype)
    eye_n = jnp.eye(n, dtype=dtype) if uv else jnp.zeros((1, 1), dtype)
    zU = jnp.zeros_like(eye_m)
    zV = jnp.zeros_like(eye_n)

    def step(j, carry):
        A, d, e, U, Vh = carry
        # --- column reflector: zero A[j+1:, j], A[j, j] -> real beta ---
        keep = ridx >= j
        col = (
            jnp.where(keep, A[0][:, j], zero),
            jnp.where(keep, A[1][:, j], zero),
        )
        v, tau, beta = householder_vector_c(col, j)
        w = _cvecmat_h(v, A)  # v^H A
        A = _csub(A, _cscale(_cconj(tau), _couter(v, w)))
        d = d.at[j].set(beta)
        if uv:
            Uv = _cmatvec(U, v)
            U = _csub(U, _cscale(tau, _couter(Uv, _cconj(v))))
        # --- row reflector on conj(A[j, :]): zero A[j, j+2:], e_j real ---
        keep_r = cidx >= j + 1
        y = (
            jnp.where(keep_r, A[0][j, :], zero),
            jnp.where(keep_r, -A[1][j, :], zero),
        )
        u, tau_r, beta_r = householder_vector_c(y, j + 1)
        Au = _cmatvec(A, u)
        A = _csub(A, _cscale(tau_r, _couter(Au, _cconj(u))))
        e = lax.cond(
            j < n - 1,
            lambda e: e.at[jnp.minimum(j, n - 2)].set(beta_r),
            lambda e: e,
            e,
        )
        if uv:
            uhV = _cvecmat_h(u, Vh)
            Vh = _csub(Vh, _cscale(_cconj(tau_r), _couter(u, uhV)))
        return A, d, e, U, Vh

    init = ((Ar, Ai), d0, e0, (eye_m, zU), (eye_n, zV))
    A, d, e, U, Vh = lax.fori_loop(0, n, step, init)
    if uv:
        return d, e, U, Vh
    return d, e


def bidiagonalize_gk_c(Ar, Ai):
    """Real bidiagonal {d, e} of a split-complex matrix (m >= n)."""
    return _bidiagonalize_gk_c(Ar, Ai, uv=False)


def _cmatvec_h(A, v):
    """``A^H v`` for matrix pair A and column pair v."""
    Ar, Ai = A
    vr, vi = v
    return (pdot(Ar.T, vr) + pdot(Ai.T, vi), pdot(Ar.T, vi) - pdot(Ai.T, vr))


def _cset_col(M, j, v):
    return (M[0].at[:, j].set(v[0]), M[1].at[:, j].set(v[1]))


def _clarft(V, taus, b):
    """Forward compact-WY T (split pair, (b, b) upper triangular) for the
    reflector product ``H_1 ... H_b = I - V T V^H`` (LAPACK zlarft).

    ``V``: (m, b) pair of panel reflectors; ``taus``: (b,) pair.  Recurrence
    per column j: ``T[:j, j] = -tau_j T[:j, :j] (V^H v_j)[:j]``,
    ``T[j, j] = tau_j``.
    """
    dtype = V[0].dtype
    zero = jnp.zeros((), dtype)
    T0 = (jnp.zeros((b, b), dtype), jnp.zeros((b, b), dtype))
    jidx = jnp.arange(b)

    def body(j, T):
        vj = (V[0][:, j], V[1][:, j])
        w = _cmatvec_h(V, vj)  # (b,) = V^H v_j
        w = (
            jnp.where(jidx < j, w[0], zero),
            jnp.where(jidx < j, w[1], zero),
        )
        tj = (taus[0][j], taus[1][j])
        col = _cscale((-tj[0], -tj[1]), _cmatvec(T, w))
        col = (col[0].at[j].set(tj[0]), col[1].at[j].set(tj[1]))
        return _cset_col(T, j, col)

    return lax.fori_loop(0, b, body, T0)


def bidiagonalize_blocked_c(Ar, Ai, panel=32):
    """Blocked split-complex bidiagonalization: (d, e) real (see below)."""
    return _bidiagonalize_blocked_c(Ar, Ai, panel=panel, uv=False)


@functools.partial(jax.jit, static_argnames=("panel", "uv"))
def _bidiagonalize_blocked_c(Ar, Ai, panel=32, uv=False):
    """Blocked split-complex bidiagonalization (zlabrd class): (d, e) real.

    Complex port of :func:`~svdsolver_tpu.models.blocked.bidiagonalize_blocked`
    — lazy labrd panels over ``A_hat = A - V Y^H - X U^H`` with the deferred
    trailing update as two complex GEMMs (8 real passes) per panel, so
    the O(n^3) FLOPs land in GEMMs instead of the GK ladder's 2n rank-1
    loop iterations.  Row eliminations run zlarfg on the CONJUGATED current
    row (y = conj(A_hat[g, :])), which makes every e entry real; column
    pivots are real by zlarfg directly.
    """
    m, n = Ar.shape
    if m < n:
        raise ValueError("bidiagonalize_blocked_c requires m >= n")
    dtype = Ar.dtype
    b = int(panel)
    n_panels = -(-n // b)
    zero = jnp.zeros((), dtype)
    d0 = jnp.zeros((n,), dtype)
    e0 = jnp.zeros((n,), dtype)  # slot n-1 is scratch
    if uv:
        Uacc0 = (jnp.eye(m, dtype=dtype), jnp.zeros((m, m), dtype))
        Vh0 = (jnp.eye(n, dtype=dtype), jnp.zeros((n, n), dtype))
    else:
        Uacc0 = (jnp.zeros((1, 1), dtype),) * 2
        Vh0 = (jnp.zeros((1, 1), dtype),) * 2

    def panel_body(k, carry):
        A, d, e, Uacc, Vh = carry
        c = k * b
        V = (jnp.zeros((m, b), dtype), jnp.zeros((m, b), dtype))
        Y = (jnp.zeros((n, b), dtype), jnp.zeros((n, b), dtype))
        X = (jnp.zeros((m, b), dtype), jnp.zeros((m, b), dtype))
        U = (jnp.zeros((n, b), dtype), jnp.zeros((n, b), dtype))
        tl0 = (jnp.zeros((b,), dtype), jnp.zeros((b,), dtype))
        tr0 = (jnp.zeros((b,), dtype), jnp.zeros((b,), dtype))

        def col_body(j, pcarry):
            V, Y, X, U, d, e, tl, tr = pcarry
            g = c + j
            g_ok = g < n
            gc = jnp.minimum(g, n - 1)
            # Current column of A_hat = A - V Y^H - X U^H, formed lazily:
            # (V Y^H)[:, g] = V @ conj(Y[g, :]).
            Yg = _cconj((Y[0][gc, :], Y[1][gc, :]))
            Ug = _cconj((U[0][gc, :], U[1][gc, :]))
            col = _csub(
                _csub((A[0][:, gc], A[1][:, gc]), _cmatvec(V, Yg)),
                _cmatvec(X, Ug),
            )
            v, tau, beta = householder_vector_c(col, g)
            tau = (
                jnp.where(g_ok, tau[0], zero),
                jnp.where(g_ok, tau[1], zero),
            )
            v = (
                jnp.where(g_ok, v[0], zero),
                jnp.where(g_ok, v[1], zero),
            )
            d = d.at[gc].set(jnp.where(g_ok, beta, d[gc]))
            # y = tau * A_hat^H v  (so the left update is A_hat -= v y^H)
            Ahv = _csub(
                _csub(_cmatvec_h(A, v), _cmatvec(Y, _cmatvec_h(V, v))),
                _cmatvec(U, _cmatvec_h(X, v)),
            )
            y = _cscale(tau, Ahv)
            V = _cset_col(V, j, v)
            Y = _cset_col(Y, j, y)
            # Conjugated current row g of A_hat (now incl. the column
            # reflector): conj(A_hat[g, :]) = conj(A[g, :]) - Y conj(V[g, :])
            # - U conj(X[g, :]).
            Vg = _cconj((V[0][gc, :], V[1][gc, :]))
            Xg = _cconj((X[0][gc, :], X[1][gc, :]))
            yrow = _csub(
                _csub(
                    (A[0][gc, :], -A[1][gc, :]), _cmatvec(Y, Vg)
                ),
                _cmatvec(U, Xg),
            )
            u, tau_r, beta_r = householder_vector_c(yrow, g + 1)
            tau_r = (
                jnp.where(g_ok, tau_r[0], zero),
                jnp.where(g_ok, tau_r[1], zero),
            )
            u = (
                jnp.where(g_ok, u[0], zero),
                jnp.where(g_ok, u[1], zero),
            )
            e = e.at[gc].set(jnp.where(g_ok, beta_r, e[gc]))
            # x = tau_r * A_hat u  (right update is A_hat -= x u^H)
            Au = _csub(
                _csub(_cmatvec(A, u), _cmatvec(V, _cmatvec_h(Y, u))),
                _cmatvec(X, _cmatvec_h(U, u)),
            )
            x = _cscale(tau_r, Au)
            X = _cset_col(X, j, x)
            U = _cset_col(U, j, u)
            tl = (tl[0].at[j].set(tau[0]), tl[1].at[j].set(tau[1]))
            tr = (tr[0].at[j].set(tau_r[0]), tr[1].at[j].set(tau_r[1]))
            return V, Y, X, U, d, e, tl, tr

        V, Y, X, U, d, e, tl, tr = lax.fori_loop(
            0, b, col_body, (V, Y, X, U, d, e, tl0, tr0)
        )
        # Deferred trailing update: A -= V Y^H + X U^H (complex GEMMs).
        A = _csub(A, _cmatmul(V, (Y[0].T, -Y[1].T)))
        A = _csub(A, _cmatmul(X, (U[0].T, -U[1].T)))
        if uv:
            # U <- U (H_1...H_b) = U (I - V TL V^H);  per-column convention
            # matches the GK uv path (A <- H^H A, U <- U H).
            TL = _clarft(V, tl, b)
            UV = _cmatmul(Uacc, V)
            Uacc = _csub(
                Uacc, _cmatmul(_cmatmul(UV, TL), (V[0].T, -V[1].T))
            )
            # Vh <- (G_1...G_b)^H Vh = Vh - U TR^H (U^H Vh)
            TR = _clarft(U, tr, b)
            W = _cmatmul((U[0].T, -U[1].T), Vh)  # U^H Vh (b, n)
            Vh = _csub(
                Vh, _cmatmul(_cmatmul(U, (TR[0].T, -TR[1].T)), W)
            )
        return A, d, e, Uacc, Vh

    A, d, e, Uacc, Vh = lax.fori_loop(
        0, n_panels, panel_body, ((Ar, Ai), d0, e0, Uacc0, Vh0)
    )
    if uv:
        return d, e[: n - 1], Uacc, Vh
    return d, e[: n - 1]


def _split(A):
    """Host numpy complex (or real) -> (re, im) float32/float64 jax pair.

    One stacked host->device transfer instead of two.
    """
    import numpy as np

    A = np.asarray(A)
    rdt = np.float64 if A.dtype == np.complex128 else np.float32
    X = jnp.asarray(np.stack([A.real, A.imag]).astype(rdt, copy=False))
    return (X[0], X[1])


def _join(pair):
    """(re, im) jax pair -> host numpy complex array (ONE stacked D2H)."""
    import numpy as np

    X = np.asarray(jnp.stack(pair))
    return X[0] + 1j * X[1]


def svdvals_c(A):
    """Singular values of a complex matrix, descending (host numpy in/out).

    ``A`` may be a numpy complex array or a ``(re, im)`` pair of jax arrays.
    Split-complex Golub-Kahan to a REAL bidiagonal, then the real
    diagonalization (bisection, through ops.dispatch).
    """
    from svdsolver_tpu.ops import dispatch

    pair = A if isinstance(A, tuple) else _split(A)
    m, n = pair[0].shape
    if m < n:  # sigma(A^H) = sigma(A)
        pair = (pair[0].T, -pair[1].T)
        m, n = n, m
    if n >= 1536:  # the blocked GEMM panels win at scale
        d, e = bidiagonalize_blocked_c(*pair)
    else:
        d, e = bidiagonalize_gk_c(*pair)
    return dispatch.bisect_svdvals(d, e)[:n]


def svd_c(A):
    """Full thin SVD of a complex matrix: ``A ~= U @ diag(s) @ Vh``.

    ``A``: numpy complex (returns numpy complex U/Vh, jax real s) or a
    ``(re, im)`` jax pair (returns U/Vh as pairs).  U (m, k), s (k,)
    descending, Vh (k, n), k = min(m, n).  Split-complex reduction with
    factor accumulation + real bidiagonal SVD (TGK inverse iteration with
    cluster coupling) + split-complex back-transform GEMMs.
    """
    pairs_in = isinstance(A, tuple)
    pair = A if pairs_in else _split(A)
    m, n = pair[0].shape
    if m < n:  # A^H = U2 s Vh2  =>  A = Vh2^H s U2^H
        U2, s, Vh2 = svd_c((pair[0].T, -pair[1].T))
        U = (Vh2[0].T, -Vh2[1].T)
        Vh = (U2[0].T, -U2[1].T)
        if pairs_in:
            return U, s, Vh
        return _join(U), s, _join(Vh)
    # one jitted core: no per-op dispatch between the stages
    Us, s, Vs = _svd_c_core(*pair)
    if pairs_in:
        return (Us[0], Us[1]), s, (Vs[0], Vs[1])
    # the core's outputs are already (2, ...)-stacked: one D2H each
    import numpy as np

    Un = np.asarray(Us)
    Vn = np.asarray(Vs)
    return Un[0] + 1j * Un[1], s, Vn[0] + 1j * Vn[1]


@jax.jit
def _svd_c_core(pr, pi):
    from svdsolver_tpu.models.vectors import bidiagonal_svd

    n = pr.shape[1]
    if n >= 1536:  # blocked panels win at scale with factor accumulation
        d, e, U1, Vh1 = _bidiagonalize_blocked_c(pr, pi, uv=True)
    else:
        d, e, U1, Vh1 = _bidiagonalize_gk_c(pr, pi, uv=True)
    U_b, s, V_b = bidiagonal_svd(d, e)  # real factors of the bidiagonal
    zb = jnp.zeros_like(U_b)
    U = _cmatmul((U1[0][:, :n], U1[1][:, :n]), (U_b, zb))
    Vh = _cmatmul((V_b.T, jnp.zeros_like(V_b.T)), Vh1)
    # stacked outputs: one D2H per factor instead of two
    return jnp.stack(U), s, jnp.stack(Vh)
