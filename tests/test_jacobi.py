"""One-sided block-Jacobi SVD tests (models/jacobi.py).

No reference counterpart (the reference is bidiagonalization-only:
svd_serial.h:233, svd_parallel.h:411); oracle is numpy LAPACK.  Accuracy
bars are in units of the compute path's epsilon (``_eps_eff``, the
dtype's machine epsilon).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from svdsolver_tpu.models.jacobi import (
    svd_jacobi,
    svd_jacobi_batch,
    _svd_jacobi_square,
    _eps_eff,
    _tournament,
)


def _full_check(A, U, s, Vh, tol_rec, tol_orth):
    """Reconstruction + orthogonality on the numerical range + descending."""
    A, U, s, Vh = map(np.asarray, (A, U, s, Vh))
    k = min(A.shape)
    assert U.shape == (A.shape[0], k) and Vh.shape == (k, A.shape[1])
    assert s.shape == (k,)
    assert np.all(np.diff(s) <= 1e-12 * max(s[0], 1e-300))
    rec = np.linalg.norm(U * s @ Vh - A) / max(np.linalg.norm(A), 1e-300)
    assert rec < tol_rec, f"reconstruction {rec:.2e}"
    alive = s > np.sqrt(k) * _eps_eff(A.dtype) * max(s[0], 0)
    ix = np.ix_(alive, alive)
    na = int(alive.sum())
    assert np.abs((U.T @ U)[ix] - np.eye(na)).max() < tol_orth
    assert np.abs((Vh @ Vh.T)[ix] - np.eye(na)).max() < tol_orth


def test_tournament_covers_all_pairs():
    for nb in (2, 4, 8, 16):
        seen = set()
        for row in _tournament(nb):
            pairs = {tuple(sorted((row[2 * i], row[2 * i + 1])))
                     for i in range(nb // 2)}
            assert len(pairs) == nb // 2  # disjoint within a round
            seen |= pairs
        assert len(seen) == nb * (nb - 1) // 2  # every pair exactly once


def test_random_square_f64(rng):
    A = jnp.asarray(rng.uniform(0.0, 5.0, size=(192, 192)))
    U, s, Vh = svd_jacobi(A, block=16)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    sref = np.linalg.svd(np.asarray(A), compute_uv=False)
    assert np.abs(np.asarray(s) - sref).max() / sref[0] < 1e-10


def test_random_square_f32(rng):
    A = jnp.asarray(rng.uniform(0.0, 5.0, size=(192, 192)).astype(np.float32))
    U, s, Vh = svd_jacobi(A, block=16)
    assert s.dtype == jnp.float32
    _full_check(A, U, s, Vh, 5e-5, 5e-4)
    sref = np.linalg.svd(np.asarray(A, dtype=np.float64), compute_uv=False)
    assert np.abs(np.asarray(s) - sref).max() / sref[0] < 5e-5


def test_colgraded_high_relative_accuracy(rng):
    """Jacobi's selling point: ~eps_eff RELATIVE sigma accuracy under
    column grading spanning 10 decades — bidiagonalization methods only
    deliver ABSOLUTE accuracy ~eps*sigma_max here."""
    n = 192
    A = jnp.asarray(
        rng.standard_normal((n, n)) * np.logspace(0, -10, n)[None, :]
    )
    U, s, Vh = svd_jacobi(A, block=16)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    sref = np.linalg.svd(np.asarray(A), compute_uv=False)
    alive = sref > np.sqrt(n) * _eps_eff(np.float64) * sref[0]
    rel = (np.abs(np.asarray(s) - sref) / sref)[alive].max()
    assert rel < 1e-8, f"relative sigma error {rel:.2e}"


def test_rowgraded_transpose_flip(rng):
    """Row grading triggers the transpose flip (slow direct convergence —
    module docstring); results must be identical quality."""
    n = 192
    A = jnp.asarray(
        np.logspace(0, -10, n)[:, None] * rng.standard_normal((n, n))
    )
    U, s, Vh = svd_jacobi(A, block=16)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    sref = np.linalg.svd(np.asarray(A), compute_uv=False)
    alive = sref > np.sqrt(n) * _eps_eff(np.float64) * sref[0]
    rel = (np.abs(np.asarray(s) - sref) / sref)[alive].max()
    assert rel < 1e-8, f"relative sigma error {rel:.2e}"


def test_tall_and_wide(rng):
    A = jnp.asarray(rng.standard_normal((200, 96)))
    U, s, Vh = svd_jacobi(A, block=8)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    W = jnp.asarray(rng.standard_normal((96, 200)))
    U, s, Vh = svd_jacobi(W, block=8)
    _full_check(W, U, s, Vh, 1e-10, 1e-10)
    sref = np.linalg.svd(np.asarray(W), compute_uv=False)
    assert np.abs(np.asarray(s) - sref).max() / sref[0] < 1e-10


def test_rank_deficient_zero_tail(rng):
    """Numerically-zero sigma come back as ~0 with ZERO vector columns
    (documented contract) and the reconstruction still holds."""
    n, r = 160, 7
    B = rng.standard_normal((n, r)) @ rng.standard_normal((r, n))
    U, s, Vh = svd_jacobi(jnp.asarray(B), block=16)
    U, s, Vh = map(np.asarray, (U, s, Vh))
    rec = np.linalg.norm(U * s @ Vh - B) / np.linalg.norm(B)
    assert rec < 1e-10
    assert s[r:].max() < 1e-9 * s[0]
    assert np.abs(U[:, r:]).max() == 0.0  # zeroed, not noise
    sref = np.linalg.svd(B, compute_uv=False)
    assert np.abs(s[:r] - sref[:r]).max() / sref[0] < 1e-10


def test_nonsquare_block_edge(rng):
    """Odd sizes exercise padding: n not a multiple of 2*block."""
    A = jnp.asarray(rng.standard_normal((100, 100)))
    U, s, Vh = svd_jacobi(A, block=16)  # pad 100 -> 128
    _full_check(A, U, s, Vh, 1e-10, 1e-10)


def test_batch_matches_single(rng):
    As = jnp.asarray(rng.standard_normal((4, 64, 64)))
    U, s, Vh = svd_jacobi_batch(As, block=8)
    assert U.shape == (4, 64, 64) and s.shape == (4, 64)
    srefs = np.linalg.svd(np.asarray(As), compute_uv=False)
    assert np.abs(np.asarray(s) - srefs).max() / srefs.max() < 1e-10
    for i in range(4):
        _full_check(As[i], U[i], s[i], Vh[i], 1e-10, 1e-10)


def test_batch_shape_validation():
    with pytest.raises(ValueError):
        svd_jacobi_batch(jnp.zeros((4, 8, 9)))
    with pytest.raises(ValueError):
        svd_jacobi_batch(jnp.zeros((8, 8)))


def test_sweep_count_terminates(rng):
    """Convergence (not max_sweeps exhaustion) on a clean random matrix."""
    n = 128
    A = jnp.asarray(rng.uniform(0.0, 5.0, size=(n, n)))
    eps = _eps_eff(np.float64)
    _, _, _, sweeps = _svd_jacobi_square(
        A, b=16, max_sweeps=30, tol=float(np.sqrt(n)) * eps, eps_eff=eps
    )
    assert 3 <= int(sweeps) <= 20


def test_jacobi_large_scale_entries(rng):
    # regression: the rotation-skip and coupling tests form products of
    # squared column norms; without gesvj-style input scaling, entries
    # ~1e10 overflow those products to inf in f32 and every rotation is
    # silently skipped (sigma came back with ~0.4 relative error)
    from svdsolver_tpu import svd_jacobi

    n = 64
    A = jnp.asarray((rng.normal(size=(n, n)) * 1e10).astype(np.float32))
    U, s, Vh = (np.asarray(x) for x in svd_jacobi(A))
    ref = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    An = np.asarray(A)
    assert np.abs(U @ np.diag(s) @ Vh - An).max() / np.abs(An).max() < 1e-4
    # and tiny entries (underflow side of the same scaling)
    B = jnp.asarray((rng.normal(size=(n, n)) * 1e-30).astype(np.float32))
    _, s2, _ = (np.asarray(x) for x in svd_jacobi(B))
    ref2 = np.linalg.svd(np.asarray(B, np.float64), compute_uv=False)
    assert np.max(np.abs(s2 - ref2)) / ref2[0] < 1e-4


def test_preconditioned_colgraded_relative_accuracy(rng):
    """dgejsv-style preconditioned Jacobi keeps the RELATIVE accuracy
    class through the two QR condensations (Drmac-Veselic)."""
    from svdsolver_tpu.models.jacobi import svd_jacobi_pre

    n = 192
    A = jnp.asarray(
        rng.standard_normal((n, n)) * np.logspace(0, -10, n)[None, :]
    )
    U, s, Vh = svd_jacobi_pre(A, block=16)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    sref = np.linalg.svd(np.asarray(A), compute_uv=False)
    alive = sref > np.sqrt(n) * _eps_eff(np.float64) * sref[0]
    rel = (np.abs(np.asarray(s) - sref) / sref)[alive].max()
    assert rel < 1e-8, f"relative sigma error {rel:.2e}"


def test_preconditioned_fp32_and_shapes(rng):
    from svdsolver_tpu.models.jacobi import svd_jacobi_pre

    A = jnp.asarray(
        rng.uniform(0.0, 5.0, size=(192, 192)).astype(np.float32)
    )
    U, s, Vh = svd_jacobi_pre(A, block=16)
    assert s.dtype == jnp.float32
    _full_check(A, U, s, Vh, 5e-5, 5e-4)
    sref = np.linalg.svd(np.asarray(A, dtype=np.float64), compute_uv=False)
    assert np.abs(np.asarray(s) - sref).max() / sref[0] < 5e-5
    # wide input routes through the transpose
    B = jnp.asarray(rng.standard_normal((96, 160)))
    U, s, Vh = svd_jacobi_pre(B, block=16)
    _full_check(B, U, s, Vh, 1e-10, 1e-10)


def test_preconditioned_converges_faster(rng):
    """The point of the preconditioner: strictly fewer tournament sweeps
    than standalone Jacobi on a graded input."""
    from svdsolver_tpu.models.jacobi import (
        _eps_eff as ee,
        svd_jacobi_pre,
    )
    from svdsolver_tpu.models.jacobi import _svd_jacobi_square

    n = 192
    A = jnp.asarray(
        rng.standard_normal((n, n)) * np.logspace(0, -6, n)[None, :]
    )
    eps_eff = ee(A.dtype)
    tol = float(np.sqrt(n)) * eps_eff
    _, _, _, sweeps_std = _svd_jacobi_square(
        A, b=16, max_sweeps=30, tol=tol, eps_eff=eps_eff
    )
    cn = jnp.linalg.norm(A, axis=0)
    Ap = jnp.take(A, jnp.argsort(-cn), axis=1)
    Q1, R1 = jnp.linalg.qr(Ap, mode="reduced")
    Q2, R2 = jnp.linalg.qr(R1.T, mode="reduced")
    _, _, _, sweeps_pre = _svd_jacobi_square(
        R2.T, b=16, max_sweeps=30, tol=tol, eps_eff=eps_eff
    )
    assert int(sweeps_pre) < int(sweeps_std), (
        int(sweeps_pre),
        int(sweeps_std),
    )
