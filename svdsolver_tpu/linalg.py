"""SVD applications: pseudo-inverse, least squares, rank, condition number,
spectral norm, best low-rank approximation.

No reference counterpart (the reference stops at singular values —
svd_serial.h:368 ``qrd`` is its last pipeline stage); these are the standard
consumers of an SVD that make the solver usable as a framework.  Everything
routes through the flagship two-stage pipeline (:func:`svdsolver_tpu.svd` /
:func:`svdsolver_tpu.svdvals`), so the hot FLOPs land in its GEMMs.
"""

import jax.numpy as jnp

from svdsolver_tpu.models.svd import svdvals
from svdsolver_tpu.models.vectors import svd, svds
from svdsolver_tpu.ops.precision import pdot


def _default_rtol(A, s0=None):
    """LAPACK-gelsd-style default relative cutoff: max(m, n) * eps."""
    return max(A.shape) * float(jnp.finfo(A.dtype).eps)


def pinv(A, rtol=None, method="tpu2"):
    """Moore-Penrose pseudo-inverse via the two-stage SVD.

    Singular values below ``rtol * sigma_max`` (default ``max(m,n)*eps``)
    are treated as zero, exactly as ``numpy.linalg.pinv``.
    """
    if rtol is None:
        rtol = _default_rtol(A)
    U, s, Vh = svd(A, method=method)
    cutoff = rtol * s[0]
    sinv = jnp.where(s > cutoff, 1.0 / jnp.where(s > cutoff, s, 1.0), 0.0)
    return pdot(Vh.T * sinv[None, :], U.T)


def lstsq(A, b, rtol=None, method="tpu2"):
    """Minimum-norm least-squares solution of ``A x ~= b`` via the SVD.

    ``b`` may be a vector (m,) or a block of right-hand sides (m, nrhs).
    Returns ``(x, resid_norm, rank)`` — the solution, the Euclidean residual
    norm per right-hand side, and the numerical rank used.
    """
    if rtol is None:
        rtol = _default_rtol(A)
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    U, s, Vh = svd(A, method=method)
    cutoff = rtol * s[0]
    keep = s > cutoff
    sinv = jnp.where(keep, 1.0 / jnp.where(keep, s, 1.0), 0.0)
    x = pdot(Vh.T, sinv[:, None] * pdot(U.T, B))
    r = pdot(A, x) - B
    resid = jnp.sqrt(jnp.sum(r * r, axis=0))
    rank = jnp.sum(keep)
    if vec:
        return x[:, 0], resid[0], rank
    return x, resid, rank


def matrix_rank(A, rtol=None):
    """Numerical rank: number of singular values above ``rtol * sigma_max``."""
    if rtol is None:
        rtol = _default_rtol(A)
    if A.ndim != 2:
        raise ValueError("matrix_rank expects a 2-D array")
    m, n = A.shape
    if m != n:  # svdvals expects square; reduce via the Gram-free fold
        if m < n:
            return matrix_rank(A.T, rtol=rtol)
        A = jnp.linalg.qr(A, mode="r")
    s = svdvals(A)
    return jnp.sum(s > rtol * s[0])


def cond(A):
    """Spectral condition number sigma_max / sigma_min."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("cond expects a square matrix")
    s = svdvals(A)
    return s[0] / s[-1]


def norm2(A):
    """Spectral norm (largest singular value)."""
    if A.ndim != 2:
        raise ValueError("norm2 expects a 2-D array")
    m, n = A.shape
    if m != n:
        if m < n:
            return norm2(A.T)
        A = jnp.linalg.qr(A, mode="r")
    return svdvals(A)[0]


def lowrank(A, k, band=None):
    """Best rank-``k`` approximation factors (Eckart-Young).

    Returns ``(L, R)`` with ``A ~= L @ R``, L (m, k), R (k, n) — the
    truncated SVD with the singular values folded into ``L``.
    """
    U, s, Vh = svds(A, k, band=band)
    return U * s[None, :], Vh


def rsvd(A, k, oversample=8, power_iters=2, key=None):
    """Randomized truncated SVD (Halko-Martinsson-Tropp): rank-``k`` factors
    of ``A`` at O(m n (k+p)) cost — all GEMMs plus one tiny exact SVD.

    Returns ``(U, s, Vh)`` with U (m, k), s (k,) descending, Vh (k, n).
    ``power_iters`` subspace-iteration passes (with QR re-orthonormalization)
    sharpen the range capture for slowly decaying spectra; accuracy is the
    usual ``sigma_{k+1}``-dominated randomized bound, so use :func:`svds`
    when exact top-k triplets are required.  Everything except the final
    (k+p)-sized exact SVD is a GEMM, so this is the fastest path for
    k << n on one device and the natural sketch for very large inputs.
    """
    import jax

    m, n = A.shape
    k = int(k)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"k={k} out of range for shape {A.shape}")
    p = int(min(oversample + k, min(m, n)))
    if key is None:
        key = jax.random.PRNGKey(0)
    Om = jax.random.normal(key, (n, p), A.dtype)
    Y = pdot(A, Om)
    Q, _ = jnp.linalg.qr(Y)
    for _ in range(int(power_iters)):
        Z, _ = jnp.linalg.qr(pdot(A.T, Q))
        Q, _ = jnp.linalg.qr(pdot(A, Z))
    B = pdot(Q.T, A)  # (p, n) sketch
    Ub, s, Vh = svd(B.T)  # tall (n, p): exact small SVD via the pipeline
    U = pdot(Q, Vh.T)
    return U[:, :k], s[:k], Ub.T[:k, :]


def polar(A, side="right", method="tpu2"):
    """Polar decomposition via the SVD (scipy.linalg.polar convention).

    ``side="right"``: ``A = W @ P`` with W orthonormal (m, n) and P (n, n)
    symmetric positive semi-definite; ``side="left"``: ``A = P @ W`` with
    P (m, m).  W is the nearest orthogonal matrix to A in Frobenius norm
    (the orthogonal Procrustes solution).
    """
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    U, s, Vh = svd(A, method=method)
    W = pdot(U, Vh)
    if side == "right":
        P = pdot(Vh.T * s[None, :], Vh)
    else:
        P = pdot(U * s[None, :], U.T)
    return W, P


def eigh(A, method="tpu2"):
    """Eigendecomposition of a symmetric matrix via the SVD.

    Returns ``(w, V)`` with eigenvalues ``w`` ascending and ``A @ V ~=
    V @ diag(w)`` (numpy.linalg.eigh convention).  Method: shift to
    positive definite (``B = A + c I`` with ``c > ||A||_2``, so B's SVD *is*
    its eigendecomposition and no sign recovery is needed even for paired
    ``+/-lambda`` spectra), run the two-stage SVD, shift back.  Absolute
    accuracy ~eps * c with ``c <= 1.25 * ||A||_inf`` — the same class as a
    direct symmetric solver up to the row-sum bound's slack.
    """
    import numpy as np

    m, n = A.shape
    if m != n:
        raise ValueError(f"eigh expects a square symmetric matrix, got {A.shape}")
    if np.iscomplexobj(A):
        # Hermitian: same shift trick via the complex SVD.  Note: the complex
        # branch returns NUMPY arrays (the split-complex pipeline's host
        # interface) and ignores ``method`` (svd_c has one pipeline).
        from svdsolver_tpu.models.complex_svd import svd_c

        A = np.asarray(A)
        A = 0.5 * (A + np.conj(A.T))
        c = 1.25 * float(np.abs(A).sum(axis=1).max()) + float(
            np.finfo(A.real.dtype).tiny
        )
        U, s, _ = svd_c(A + c * np.eye(n, dtype=A.dtype))
        return (s - c)[::-1], U[:, ::-1]
    A = 0.5 * (A + A.T)  # enforce exact symmetry of the compute input
    # cheap O(n^2) spectral bound (symmetric: ||A||_2 <= ||A||_inf = max
    # row abs-sum) — an exact norm2 here would run a second full solve
    c = 1.25 * jnp.max(jnp.sum(jnp.abs(A), axis=1)) + jnp.finfo(A.dtype).tiny
    B = A + c * jnp.eye(n, dtype=A.dtype)
    U, s, _ = svd(B, method=method)
    w = (s - c)[::-1]
    return w, U[:, ::-1]


def orth(A, rtol=None):
    """Orthonormal basis of the range of ``A``: (m, rank) columns.

    The numerical rank is pulled to the host (the result shape depends on
    it), so this is an eager convenience like ``scipy.linalg.orth`` — not
    jittable.
    """
    if rtol is None:
        rtol = _default_rtol(A)
    U, s, _ = svd(A)
    r = int(jnp.sum(s > rtol * s[0]))
    return U[:, :r]


def null_space(A, rtol=None):
    """Orthonormal basis of the null space of ``A``: (n, n - rank) columns.

    Eager like :func:`orth` (the result shape depends on the numerical
    rank).
    """
    if rtol is None:
        rtol = _default_rtol(A)
    m, n = A.shape
    if m < n:
        # thin Vh of a wide matrix only spans the row space; zero rows do
        # not change the null space but make Vh a full (n, n) basis
        A = jnp.concatenate([A, jnp.zeros((n - m, n), A.dtype)], axis=0)
    _, s, Vh = svd(A)
    r = int(jnp.sum(s > rtol * s[0]))
    N = Vh[r:].T
    if r == 0 or N.shape[1] == 0:
        return N
    # Wide zero-sigma clusters come back full-rank but ill-conditioned from
    # the TGK solver (inverse iteration cannot separate a degenerate
    # multiplet; see models/vectors.py cluster notes).  The leading r rows
    # of Vh ARE accurate (their sigma are above the cutoff), so project the
    # row space out explicitly — two passes, classic twice-is-enough — and
    # re-orthonormalize what remains.
    Vr = Vh[:r].T
    for _ in range(2):
        N = N - pdot(Vr, pdot(Vr.T, N))
    Q, _ = jnp.linalg.qr(N)
    return Q
