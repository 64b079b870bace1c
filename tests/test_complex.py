"""Complex SVD (split re/im representation)."""

import numpy as np
import jax.numpy as jnp

from svdsolver_tpu.models.complex_svd import (
    householder_vector_c,
    bidiagonalize_gk_c,
    svdvals_c,
    svd_c,
    _split,
)


def test_householder_c_zlarfg(rng):
    # H^H x = beta e_p with beta REAL; H unitary; pivot-only rotation case
    x = (rng.normal(size=12) + 1j * rng.normal(size=12)).astype(np.complex64)
    for p in (0, 5, 11):
        v, tau, beta = householder_vector_c(_split(x), p)
        vn = np.asarray(v[0]) + 1j * np.asarray(v[1])
        taun = complex(float(tau[0]), float(tau[1]))
        xm = np.where(np.arange(12) >= p, x, 0)
        Hh = np.eye(12, dtype=np.complex64) - np.conj(taun) * np.outer(vn, np.conj(vn))
        y = Hh @ xm
        tgt = np.zeros(12, np.complex64)
        tgt[p] = float(beta)
        assert np.abs(y - tgt).max() < 1e-5
        H = np.eye(12, dtype=np.complex64) - taun * np.outer(vn, np.conj(vn))
        assert np.abs(np.conj(H.T) @ H - np.eye(12)).max() < 1e-5


def test_bidiagonalize_c_real_output(rng):
    n = 32
    A = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(
        np.complex64
    )
    d, e = bidiagonalize_gk_c(*_split(A))
    # d, e are REAL arrays (zgebrd class) and sigma-preserving
    assert not np.iscomplexobj(np.asarray(d))
    B = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
    ref = np.linalg.svd(A.astype(np.complex128), compute_uv=False)
    got = np.linalg.svd(B.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(got - ref)) / ref[0] < 1e-5


def test_svdvals_c(rng):
    n = 48
    A = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(
        np.complex64
    )
    ref = np.linalg.svd(A.astype(np.complex128), compute_uv=False)
    s = np.asarray(svdvals_c(A))
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-5
    # transparent routing through the public svdvals
    from svdsolver_tpu import svdvals

    s2 = np.asarray(svdvals(A))
    assert np.max(np.abs(s2 - ref)) / ref[0] < 1e-5


def test_svd_c_square_and_rect(rng):
    from svdsolver_tpu import svd

    n = 48
    A = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(
        np.complex64
    )
    U, s, Vh = svd(A)  # routes to svd_c
    s = np.asarray(s)
    assert np.abs(U @ np.diag(s) @ Vh - A).max() / np.abs(A).max() < 1e-4
    assert np.abs(np.conj(U.T) @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ np.conj(Vh.T) - np.eye(n)).max() < 1e-4
    # wide rectangular (exercises the conjugate-transpose branch)
    B = (rng.normal(size=(24, 40)) + 1j * rng.normal(size=(24, 40))).astype(
        np.complex64
    )
    Ub, sb, Vhb = svd_c(B)
    sb = np.asarray(sb)
    refb = np.linalg.svd(B.astype(np.complex128), compute_uv=False)
    assert np.max(np.abs(sb - refb)) / refb[0] < 1e-4
    assert np.abs(Ub @ np.diag(sb) @ Vhb - B).max() / np.abs(B).max() < 1e-4
    assert Ub.shape == (24, 24) and Vhb.shape == (24, 40)


def test_svd_c_hermitian_and_real_input(rng):
    # Hermitian input: sigma = |eigenvalues|
    n = 32
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = ((M + np.conj(M.T)) / 2).astype(np.complex64)
    s = np.asarray(svdvals_c(A))
    ref = np.sort(np.abs(np.linalg.eigvalsh(A.astype(np.complex128))))[::-1]
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-5
    # complex array with zero imaginary part matches the real pipeline
    R = rng.normal(size=(n, n)).astype(np.float32)
    s1 = np.asarray(svdvals_c(R.astype(np.complex64)))
    ref2 = np.linalg.svd(R.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(s1 - ref2)) / ref2[0] < 1e-5


def test_bidiagonalize_blocked_c(rng):
    # blocked (zlabrd-class) reduction matches the GK ladder's sigma;
    # odd n exercises the ragged last panel
    from svdsolver_tpu.models.complex_svd import bidiagonalize_blocked_c

    for m, n in ((63, 63), (80, 48)):
        A = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))).astype(
            np.complex64
        )
        d, e = bidiagonalize_blocked_c(*_split(A), panel=16)
        B = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
        ref = np.linalg.svd(A.astype(np.complex128), compute_uv=False)
        got = np.linalg.svd(B.astype(np.float64), compute_uv=False)
        assert np.max(np.abs(got - ref)) / ref[0] < 1e-5, (m, n)


def test_eigh_hermitian_complex(rng):
    from svdsolver_tpu.linalg import eigh

    n = 32
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = ((M + np.conj(M.T)) / 2).astype(np.complex64)
    w, V = eigh(A)
    w = np.asarray(w)
    ref = np.linalg.eigvalsh(A.astype(np.complex128))
    assert np.all(np.diff(w) >= -1e-3)
    assert np.max(np.abs(np.sort(w) - ref)) / np.abs(ref).max() < 1e-4
    assert (
        np.abs(A @ V - V * w[None, :]).max() / np.abs(ref).max() < 1e-3
    )
    assert np.abs(np.conj(V.T) @ V - np.eye(n)).max() < 1e-3


def test_bidiagonalize_blocked_c_uv(rng):
    # factor-accumulating blocked variant: A = U B Vh with unitary factors
    from svdsolver_tpu.models.complex_svd import _bidiagonalize_blocked_c

    n = 48
    A = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(
        np.complex64
    )
    d, e, U, Vh = _bidiagonalize_blocked_c(*_split(A), panel=16, uv=True)
    Un = np.asarray(U[0]) + 1j * np.asarray(U[1])
    Vhn = np.asarray(Vh[0]) + 1j * np.asarray(Vh[1])
    B = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1)
    assert np.abs(Un @ B @ Vhn - A).max() / np.abs(A).max() < 1e-5
    assert np.abs(np.conj(Un.T) @ Un - np.eye(n)).max() < 1e-5
    assert np.abs(Vhn @ np.conj(Vhn.T) - np.eye(n)).max() < 1e-5
