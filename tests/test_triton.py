"""The Pallas Triton kernels and the dispatch point that chooses them.

Here the kernels run through the Pallas interpreter against their XLA
references; their lowering to Triton IR for CUDA is checked at real widths
(lowering needs no GPU).  The ``gpu`` tests run the compiled kernels and
skip where there is no card.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svdsolver_tpu.models.diagonalize import bisect_svdvals
from svdsolver_tpu.models.vectors import tgk_solve_xla
from svdsolver_tpu.ops import dispatch
from svdsolver_tpu.ops.pallas.bisect_triton import bisect_svdvals_triton
from svdsolver_tpu.ops.pallas.tgk_solve_triton import tgk_solve_triton

TRITON_CALL = "__gpu$xla.gpu.triton"
SIZES = [1, 2, 45, 256]  # 45: not a multiple of the 32-lane block
DTYPES = [np.float32, np.float64]
# twisted vs one-ended Sturm recurrences: an eps-level bracket difference
BISECT_TOL = {np.float32: 1e-6, np.float64: 1e-13}


def _bidiagonal(rng, n, dtype):
    d = jnp.asarray(rng.uniform(0, 5, n).astype(dtype))
    e = jnp.asarray(rng.uniform(0, 5, n - 1).astype(dtype))
    return d, e


def _tgk_problem(rng, n, dtype):
    """A TGK solve as inverse iteration poses it: shifts at the spectrum."""
    d, e = _bidiagonal(rng, n, dtype)
    N = 2 * n
    z = jnp.zeros((N - 1,), dtype).at[0::2].set(d).at[1::2].set(e)
    lam = bisect_svdvals(d, e)
    rhs = jnp.asarray(rng.normal(size=(N, n)).astype(dtype))
    eps = np.finfo(dtype).eps
    pivmin = jnp.asarray(max(float(lam[0]) * eps * eps, np.finfo(dtype).tiny), dtype)
    big = jnp.asarray(np.finfo(dtype).max ** 0.5 / 16, dtype)
    return z, lam, rhs, pivmin, big


def _unit_columns(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_bisect_triton_interpret_matches_xla(rng, n, dtype):
    d, e = _bidiagonal(rng, n, dtype)
    got = np.asarray(bisect_svdvals_triton(d, e, interpret=True))
    want = np.asarray(bisect_svdvals(d, e))
    assert got.shape == (n,) and got.dtype == dtype
    assert np.all(np.diff(got) <= 0), "not descending"
    assert np.abs(got - want).max() <= BISECT_TOL[dtype] * want[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_tgk_solve_triton_interpret_matches_xla(rng, n, dtype):
    args = _tgk_problem(rng, n, dtype)
    got = tgk_solve_triton(*args, interpret=True)
    want = tgk_solve_xla(*args)
    assert got.shape == (2 * n, n) and got.dtype == dtype
    np.testing.assert_allclose(
        _unit_columns(got), _unit_columns(want), rtol=0, atol=1e-4
    )


def _batched(rng, kernel, n, batch=3):
    """(kernel, reference, args) for a batch of independent problems."""
    if kernel == "bisect":
        probs = [_bidiagonal(rng, n, np.float32) for _ in range(batch)]
        fns = bisect_svdvals_triton, bisect_svdvals
    else:
        probs = [_tgk_problem(rng, n, np.float32) for _ in range(batch)]
        fns = tgk_solve_triton, tgk_solve_xla
    args = [jnp.stack(a) for a in zip(*probs)]
    return fns[0], fns[1], args


def _assert_batch_close(kernel, got, want):
    for g, w in zip(np.asarray(got), np.asarray(want)):
        if kernel == "bisect":
            assert np.abs(g - w).max() <= BISECT_TOL[np.float32] * w[0]
        else:
            np.testing.assert_allclose(
                _unit_columns(g), _unit_columns(w), rtol=0, atol=1e-4
            )


@pytest.mark.parametrize("kernel", ["bisect", "tgk_solve"])
def test_kernel_batches_under_vmap(rng, kernel):
    fn, ref, args = _batched(rng, kernel, 45)
    got = jax.vmap(functools.partial(fn, interpret=True))(*args)
    _assert_batch_close(kernel, got, jax.vmap(ref)(*args))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("kernel", ["bisect", "tgk_solve"])
def test_kernel_lowers_to_triton_at_real_width(kernel, dtype):
    n = 3840
    N = 2 * n
    sd = jax.ShapeDtypeStruct
    if kernel == "bisect":
        fn, args = bisect_svdvals_triton, (sd((n,), dtype), sd((n - 1,), dtype))
    else:
        fn = tgk_solve_triton
        args = (sd((N - 1,), dtype), sd((n,), dtype), sd((N, n), dtype),
                sd((), dtype), sd((), dtype))
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert TRITON_CALL in text


def _dispatch_case(name, rng):
    if name == "bisect":
        d, e = _bidiagonal(rng, 64, np.float32)
        return dispatch.bisect_svdvals, bisect_svdvals, (d, e)
    return dispatch.tgk_solve, tgk_solve_xla, _tgk_problem(rng, 64, np.float32)


@pytest.mark.parametrize("name", ["bisect", "tgk_solve"])
def test_dispatch_runs_reference_on_cpu(rng, name):
    fn, ref, args = _dispatch_case(name, rng)
    lowered = jax.jit(fn).lower(*args)
    assert TRITON_CALL not in lowered.as_text()
    np.testing.assert_array_equal(
        np.asarray(jax.jit(fn)(*args)), np.asarray(ref(*args))
    )


@pytest.mark.parametrize("name", ["bisect", "tgk_solve"])
def test_dispatch_lowers_kernel_for_cuda(rng, name):
    fn, _, args = _dispatch_case(name, rng)
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert TRITON_CALL in text


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_bisect_triton_on_gpu(rng, dtype):
    d, e = _bidiagonal(rng, 3840, dtype)
    got = np.asarray(bisect_svdvals_triton(d, e))
    want = np.asarray(bisect_svdvals(d, e))
    assert np.abs(got - want).max() <= BISECT_TOL[dtype] * want[0]


@pytest.mark.gpu
def test_tgk_solve_triton_on_gpu(rng):
    args = _tgk_problem(rng, 3840, np.float32)
    np.testing.assert_allclose(
        _unit_columns(tgk_solve_triton(*args)),
        _unit_columns(tgk_solve_xla(*args)),
        rtol=0,
        atol=1e-4,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["bisect", "tgk_solve"])
def test_kernel_batches_under_vmap_on_gpu(rng, kernel):
    fn, ref, args = _batched(rng, kernel, 512)
    _assert_batch_close(kernel, jax.vmap(fn)(*args), jax.vmap(ref)(*args))
