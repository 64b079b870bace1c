"""Differential tests: native host runtime vs the JAX device models.

The reference's correctness architecture is "CPU implementation as oracle for
device kernels" (cuda_unit_tests.cu:90, svd_cuda_2.cu:1152); here the native
C++ library and the JAX models must agree with each other and with LAPACK.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from svdsolver_tpu.utils import native


@pytest.fixture(autouse=True, scope="module")
def _native_lib():
    """Build (or load) the native library; skip where no toolchain exists."""
    try:
        native.get_lib()
    except Exception as exc:  # toolchain unavailable
        pytest.skip(f"native toolchain unavailable: {exc}")


def test_native_gk_matches_jax(rng):
    from svdsolver_tpu.models.golub_kahan import bidiagonalize_gk_jit

    A = rng.normal(size=(48, 48))
    d_n, e_n = native.gk_brd(A)
    d_j, e_j = bidiagonalize_gk_jit(jnp.asarray(A))
    np.testing.assert_allclose(np.abs(d_n), np.abs(np.asarray(d_j)), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.abs(e_n), np.abs(np.asarray(e_j)), rtol=1e-9, atol=1e-11)


def test_native_dense_to_band_matches_jax(rng):
    from svdsolver_tpu.models.two_stage import dense_to_band

    A = rng.normal(size=(48, 48))
    got = native.dense_to_band(A, 8)
    want = np.asarray(dense_to_band(jnp.asarray(A), band=8))
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-8, atol=1e-9)


def test_native_band_to_bidiag_sigma(rng):
    A = rng.normal(size=(64, 64))
    Ab = native.dense_to_band(A, 8)
    d, e = native.band_to_bidiag(Ab, 8)
    B = np.diag(d) + np.diag(e, 1)
    want = np.linalg.svd(A, compute_uv=False)
    got = np.linalg.svd(B, compute_uv=False)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * want[0])


def test_native_qrd_vs_lapack(rng):
    d = rng.normal(size=64)
    e = rng.normal(size=63)
    B = np.diag(d) + np.diag(e, 1)
    want = np.linalg.svd(B, compute_uv=False)
    got = native.qrd(d, e)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * want[0])


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-4)])
def test_native_full_pipeline(rng, dtype, rtol):
    A = rng.normal(size=(64, 64)).astype(dtype)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    got = native.svdvals(A, band=8)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * want[0] * rtol)


def test_native_fixture_band_mse():
    from svdsolver_tpu.utils import fixtures as fx

    A = fx.load_fixture("test", 64)
    band_ref = fx.load_fixture("band", 64)
    Ab = native.dense_to_band(A, 4)
    assert fx.band_mse(Ab, band_ref, 4) < 1e-6
