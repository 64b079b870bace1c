"""Full-SVD (singular vector) tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from svdsolver_tpu.models.vectors import (
    svd,
    bidiagonal_svd,
    bidiagonalize_blocked_uv,
)


def test_blocked_uv_reconstructs(rng):
    n = 48
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    d, e, U, V = bidiagonalize_blocked_uv(A, panel=16)
    B = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
    rec = np.asarray(U) @ B @ np.asarray(V).T
    np.testing.assert_allclose(rec, np.asarray(A), atol=2e-5)
    # factors orthogonal
    Un = np.asarray(U)
    np.testing.assert_allclose(Un.T @ Un, np.eye(n), atol=2e-5)


def test_bidiagonal_svd_residuals(rng):
    n = 64
    d = jnp.asarray(rng.normal(size=n).astype(np.float32))
    e = jnp.asarray(rng.normal(size=n - 1).astype(np.float32))
    U_b, s, V_b = bidiagonal_svd(d, e)
    B = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
    res = np.linalg.norm(
        B @ np.asarray(V_b) - np.asarray(U_b) * np.asarray(s)[None, :], axis=0
    )
    assert res.max() / np.asarray(s)[0] < 1e-5


@pytest.mark.parametrize("shape", [(48, 20), (20, 48)])
def test_full_svd_rectangular(rng, shape):
    A = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    U, s, Vh = svd(A, panel=8)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    k = min(shape)
    assert U.shape == (shape[0], k) and Vh.shape == (k, shape[1])
    want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(
        U @ np.diag(s) @ Vh, np.asarray(A), atol=3e-5 * want[0]
    )


@pytest.mark.parametrize("n,b", [(32, 8), (96, 16)])
def test_full_svd(rng, n, b):
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = svd(A, panel=b)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(
        U @ np.diag(s) @ Vh, np.asarray(A), atol=3e-5 * want[0]
    )
    np.testing.assert_allclose(U.T @ U, np.eye(n), atol=5e-5)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(n), atol=5e-5)


def test_full_svd_one_stage(rng):
    n = 48
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = svd(A, panel=16, method="singlecore")
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(
        U @ np.diag(s) @ Vh, np.asarray(A), atol=3e-5 * want[0]
    )


def test_two_stage_svd_repeated_sigma(rng):
    # VERDICT round-1 gate: clustered/exactly-multiple singular values must
    # give orthogonal factors and a valid reconstruction through the
    # flagship two-stage pipeline.
    n = 96
    Q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    Q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    svals = np.concatenate(
        [np.full(5, 3.0), np.full(4, 1.0), rng.uniform(0.1, 2.5, n - 9)]
    )
    svals = np.sort(svals)[::-1]
    A = jnp.asarray(((Q1 * svals) @ Q2.T).astype(np.float32))
    U, s, Vh = svd(A, method="tpu2", band=16)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    np.testing.assert_allclose(s, svals, rtol=0, atol=1e-5 * svals[0])
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - np.asarray(A)).max() < 1e-4 * svals[0]


def test_two_stage_svd_wide_cluster(rng):
    # A cluster far wider than any fixed MGS window (n/3 values within 1e-6):
    # the cluster-blocked CholeskyQR coupling + separate u/v polar polish
    # must deliver orthogonal factors (the width-8 positional MGS this
    # replaced left an 8e-2 defect here).  Low-rank-plus-noise matrices make
    # this spectrum shape common in practice.
    n = 384
    Q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    Q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = rng.uniform(0.1, 2.5, n)
    sv[: n // 3] = 3.0 + rng.normal(size=n // 3) * 1e-6
    A = jnp.asarray(((Q1 * np.sort(sv)[::-1]) @ Q2.T).astype(np.float32))
    U, s, Vh = svd(A, method="tpu2", band=32)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    assert np.abs(U.T @ U - np.eye(n)).max() < 2e-5
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 2e-5
    assert np.abs(U @ np.diag(s) @ Vh - np.asarray(A)).max() < 1e-4 * sv.max()


def test_two_stage_svd_large_dense_spectrum(rng):
    # Regression for two scale-only failures: (a) chase-record corruption
    # when the accumulating chase carried the full record arrays through
    # nested loops (garbage reflectors at n >= 512), and (b) inverse-iteration
    # NaN from fp32 back-substitution overflow on dense random spectra.
    # A random Gaussian matrix has ~1e2..1e3*eps relative gaps throughout its
    # bulk — the hard case for per-lane inverse iteration.
    n = 512
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = svd(A, method="tpu2")
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    assert np.isfinite(U).all() and np.isfinite(Vh).all()
    want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=0, atol=1e-5 * want[0])
    assert np.abs(U @ np.diag(s) @ Vh - np.asarray(A)).max() < 1e-4 * want[0]
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4


def test_full_svd_at_scale(rng):
    # svd() at a size where earlier failures appeared only at scale (an
    # on-chip memory budget crossed near n ~ 3900 while every smaller-n test
    # passed).  Checks reconstruction and orthogonality, not just
    # completion.
    n = 4096
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = svd(A)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    assert np.isfinite(U).all() and np.isfinite(Vh).all()
    nrm = float(s[0])
    assert np.abs(U @ np.diag(s) @ Vh - np.asarray(A)).max() < 1e-4 * nrm
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4


def test_two_stage_svd_f64_repeated(rng):
    n = 96
    Q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    Q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    svals = np.sort(
        np.concatenate([np.full(5, 3.0), rng.uniform(0.1, 2.5, n - 5)])
    )[::-1]
    A = jnp.asarray((Q1 * svals) @ Q2.T)
    U, s, Vh = svd(A, method="tpu2", band=16)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-9
    assert np.abs(U @ np.diag(s) @ Vh - np.asarray(A)).max() < 1e-9 * svals[0]


def test_dense_to_band_uv_reconstructs(rng):
    from svdsolver_tpu.models.two_stage import dense_to_band_uv

    n, b = 64, 16
    A = jnp.asarray(rng.normal(size=(n, n)))
    Ab, U1, V1 = dense_to_band_uv(A, band=b)
    Ab, U1, V1 = map(np.asarray, (Ab, U1, V1))
    np.testing.assert_allclose(U1 @ Ab @ V1.T, np.asarray(A), atol=1e-12)
    np.testing.assert_allclose(U1.T @ U1, np.eye(n), atol=1e-12)
    np.testing.assert_allclose(V1.T @ V1, np.eye(n), atol=1e-12)


def test_dense_to_band_rec_matches_uv(rng):
    """The recording Stage I is the same factorization as the eager one:
    identical band output (bitwise) and the backward-applied records
    rebuild the same U1/V1."""
    from svdsolver_tpu.models.two_stage import dense_to_band_uv, dense_to_band_rec
    from svdsolver_tpu.models.vectors import _apply_stage1_reflectors_pair

    n, b = 64, 16
    A = jnp.asarray(rng.normal(size=(n, n)))
    Ab_u, U1, V1 = dense_to_band_uv(A, band=b)
    Ab_r, Vq, Tq, Vl, Tl = dense_to_band_rec(A, band=b)
    # Same factorization, but fori_loop vs scan: XLA is not obligated to
    # compile the two loop forms to identical arithmetic, so compare at
    # tight f64 tolerance rather than bitwise (ADVICE r3).
    np.testing.assert_allclose(
        np.asarray(Ab_u), np.asarray(Ab_r), rtol=0, atol=1e-12
    )
    eye = jnp.eye(n, dtype=A.dtype)
    U1r, V1r = _apply_stage1_reflectors_pair(Vq, Tq, Vl, Tl, eye, eye)
    np.testing.assert_allclose(np.asarray(U1r), np.asarray(U1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(V1r), np.asarray(V1), atol=1e-12)


def test_chase_accum_factorization(rng):
    from svdsolver_tpu.models.two_stage import (
        dense_to_band,
        band_to_bidiagonal_accum,
    )
    from svdsolver_tpu.models.vectors import _apply_chase_reflectors

    n, b = 48, 8
    A = jnp.asarray(rng.normal(size=(n, n)))
    Ab = dense_to_band(A, band=b)
    d, e, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
    B = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
    I = jnp.eye(n, dtype=A.dtype)
    L = np.asarray(_apply_chase_reflectors(VL, TL, I, b, reverse=True))
    R = np.asarray(_apply_chase_reflectors(VR, TR, I, b, reverse=True))
    np.testing.assert_allclose(L.T @ L, np.eye(n), atol=1e-12)
    np.testing.assert_allclose(L @ B @ R.T, np.asarray(Ab), atol=1e-11)


@pytest.mark.parametrize("n,b", [(48, 8), (96, 16), (72, 8)])
def test_chase_apply_wy_matches_rank1(rng, n, b):
    # grouped compact-WY back-transform must realize the SAME operator as
    # the per-sweep rank-1 application (f64 so the reordering's rounding
    # differences stay ~1e-13); n=96/b=16 has a ragged last group,
    # n=72/b=8 multiple full groups.
    from svdsolver_tpu.models.two_stage import (
        dense_to_band,
        band_to_bidiagonal_accum,
    )
    from svdsolver_tpu.models.vectors import (
        _apply_chase_reflectors,
        _apply_chase_reflectors_wy,
    )

    A = jnp.asarray(rng.normal(size=(n, n)))
    Ab = dense_to_band(A, band=b)
    _, _, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
    M = jnp.asarray(rng.normal(size=(n, n)))
    for V, T in ((VL, TL), (VR, TR)):
        want = np.asarray(_apply_chase_reflectors(V, T, M, b, reverse=True))
        got = np.asarray(_apply_chase_reflectors_wy(V, T, M, b))
        np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n,b", [(48, 8), (96, 16), (72, 8)])
def test_chase_apply_wy_carry_matches_wy(rng, n, b):
    # the production back-transform (_apply_chase_reflectors_wy_carry:
    # overlap-carry + per-group slot trim) must realize the same operator
    # as the plain grouped WY walk on REAL recorder output — including
    # slot-padded records (s_pad > s_used, as the Pallas recorders emit:
    # extra all-zero tau slots must be exact no-ops, and the slot trim
    # must not skip any live slot of the shared schedule) (ADVICE r4 #1).
    from svdsolver_tpu.models.two_stage import (
        dense_to_band,
        band_to_bidiagonal_accum,
    )
    from svdsolver_tpu.models.vectors import (
        _apply_chase_reflectors_wy,
        _apply_chase_reflectors_wy_carry,
    )

    A = jnp.asarray(rng.normal(size=(n, n)))
    Ab = dense_to_band(A, band=b)
    _, _, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
    M = jnp.asarray(rng.normal(size=(n, n)))
    for V, T in ((VL, TL), (VR, TR)):
        want = np.asarray(_apply_chase_reflectors_wy(V, T, M, b))
        got = np.asarray(_apply_chase_reflectors_wy_carry(V, T, M, b))
        np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
        # slot-padded records (Pallas recorders pad s_max to a multiple
        # of 8): identical result, no live slot skipped by the trim
        s_pad = -(-V.shape[1] // 8) * 8 + 8
        Vp = jnp.pad(V, ((0, 0), (0, s_pad - V.shape[1]), (0, 0)))
        Tp = jnp.pad(T, ((0, 0), (0, s_pad - T.shape[1])))
        got_p = np.asarray(_apply_chase_reflectors_wy_carry(Vp, Tp, M, b))
        np.testing.assert_allclose(
            got_p, want, atol=1e-12 * np.abs(want).max()
        )


@pytest.mark.parametrize("n,k", [(96, 8), (128, 1)])
def test_svds_topk(rng, n, k):
    from svdsolver_tpu.models.vectors import svds

    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = svds(A, k)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    assert U.shape == (n, k) and s.shape == (k,) and Vh.shape == (k, n)
    want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want[:k], rtol=2e-5, atol=1e-5 * want[0])
    # triplet residual + factor orthogonality
    res = np.abs(np.asarray(A) @ Vh.T - U * s[None, :]).max()
    assert res / want[0] < 3e-5
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=2e-5)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(k), atol=2e-5)


def test_svds_rectangular(rng):
    from svdsolver_tpu.models.vectors import svds

    k = 6
    for shape in [(120, 72), (72, 120)]:
        A = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        U, s, Vh = svds(A, k)
        U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
        assert U.shape == (shape[0], k) and Vh.shape == (k, shape[1])
        want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
        np.testing.assert_allclose(s, want[:k], rtol=2e-5, atol=1e-5 * want[0])
        res = np.abs(np.asarray(A) @ Vh.T - U * s[None, :]).max()
        assert res / want[0] < 3e-5


def test_svds_clustered_top(rng):
    """Top-k whose boundary lands inside a cluster of equal sigma."""
    from svdsolver_tpu.models.vectors import svds

    n = 64
    Q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    Q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sig = np.linspace(3.0, 1.0, n)
    sig[4:10] = 2.0  # 6-fold multiplet straddling the k=7 boundary
    sig.sort()
    sig = sig[::-1]
    A = jnp.asarray((Q1 * sig[None, :]) @ Q2.T, dtype=jnp.float32)
    U, s, Vh = svds(A, 7)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    np.testing.assert_allclose(s, sig[:7], rtol=2e-5, atol=1e-5 * sig[0])
    # inside a multiplet individual vectors are not unique, but each triplet
    # must still satisfy A v = s u with orthonormal selected columns
    res = np.abs(np.asarray(A) @ Vh.T - U * s[None, :]).max()
    assert res / sig[0] < 5e-5
    np.testing.assert_allclose(U.T @ U, np.eye(7), atol=5e-5)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(7), atol=5e-5)


def test_svd_batch(rng):
    from svdsolver_tpu.models.vectors import svd_batch

    B, n = 3, 64
    As = jnp.asarray(rng.normal(size=(B, n, n)).astype(np.float32))
    U, s, Vh = svd_batch(As)
    assert U.shape == (B, n, n) and s.shape == (B, n) and Vh.shape == (B, n, n)
    for i in range(B):
        An = np.asarray(As[i])
        want = np.linalg.svd(np.asarray(An, np.float64), compute_uv=False)
        np.testing.assert_allclose(
            np.asarray(s[i]), want, rtol=2e-5, atol=1e-5 * want[0]
        )
        rec = np.asarray(U[i]) @ np.diag(np.asarray(s[i])) @ np.asarray(Vh[i])
        np.testing.assert_allclose(rec, An, atol=3e-5 * want[0])


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_cluster_orthogonalize_tiled_matches_dense(rng, kind):
    # the tiled double-cover CholeskyQR must realize the dense masked
    # CholeskyQR's operator on narrow clusters, and route wide (> 64
    # column) clusters to the dense fallback.  Regression for the
    # cluster-id cumsum bug (0.079 off-diagonal on repeated sigma).
    from svdsolver_tpu.models.vectors import (
        _cluster_orthogonalize,
        _cluster_orthogonalize_dense,
    )

    n = 160
    if kind == "narrow":
        sig = np.sort(
            np.concatenate(
                [np.full(5, 3.0), np.full(4, 1.0), rng.uniform(0.1, 2.5, n - 9)]
            )
        )[::-1].copy()
    else:  # one cluster wider than the 64-column tiled cover
        sig = np.sort(
            np.concatenate(
                [3.0 + rng.normal(size=80) * 1e-14, rng.uniform(0.1, 2.5, n - 80)]
            )
        )[::-1].copy()
    x = rng.normal(size=(2 * n, n))
    ctol = jnp.asarray(64 * np.finfo(np.float64).eps)
    a = np.asarray(
        _cluster_orthogonalize_dense(jnp.asarray(x), jnp.asarray(sig), ctol)
    )
    b = np.asarray(
        _cluster_orthogonalize(jnp.asarray(x), jnp.asarray(sig), ctol)
    )
    np.testing.assert_allclose(b, a, atol=1e-10)
    # intra-cluster orthogonality achieved
    G = b.T @ b
    smax = np.abs(sig).max()
    linked = np.abs(sig[1:] - sig[:-1]) <= 64 * np.finfo(np.float64).eps * smax
    for i in np.where(linked)[0][:20]:
        assert abs(G[i, i + 1]) < 1e-10
