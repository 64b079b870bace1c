"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svdsolver_tpu.parallel.mesh import make_mesh
from svdsolver_tpu.parallel.distributed import svdvals_batch_sharded


@pytest.fixture(scope="module")
def cpu_mesh():
    cpu = jax.devices("cpu")
    if len(cpu) < 8:
        pytest.skip("needs 8 virtual CPU devices (xla_force_host_platform)")
    return make_mesh(8, dp=2, platform="cpu")


def test_mesh_shape(cpu_mesh):
    assert dict(cpu_mesh.shape) == {"dp": 2, "tp": 4}


def test_batch_sharded_svdvals(cpu_mesh, rng):
    batch, n, band = 4, 32, 8
    As = jnp.asarray(rng.uniform(0, 5, (batch, n, n)).astype(np.float32))
    sig = np.asarray(svdvals_batch_sharded(As, cpu_mesh, band=band))
    ref = np.linalg.svd(np.asarray(As, np.float64), compute_uv=False)
    err = np.max(np.abs(sig - ref) / ref[:, :1])
    assert err < 1e-4, err


def test_shardmap_stage1_matches_single_device(rng):
    from svdsolver_tpu.parallel.distributed import dense_to_band_shardmap
    from svdsolver_tpu.models.two_stage import dense_to_band

    mesh = make_mesh(4, dp=1, platform="cpu")
    n, b = 64, 16
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    Ab_ref = np.asarray(dense_to_band(A, band=b))
    Ab = np.asarray(dense_to_band_shardmap(A, mesh, band=b))
    np.testing.assert_allclose(Ab, Ab_ref, atol=5e-4)
    want = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    got = np.linalg.svd(Ab.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])


def test_dryrun_entrypoint():
    # dryrun_multichip pins the WHOLE process to the virtual CPU platform
    # (clear_backends + jax_platforms=cpu), which would leak into every
    # later test in this process.  Run it in its own process.
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__ as g; g.dryrun_multichip(8)",
        ],
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_svdvals_sharded_single_matrix(cpu_mesh, rng):
    # one large matrix: Stage I sharded over tp, band gathered, local tail
    from svdsolver_tpu.parallel.distributed import svdvals_sharded

    n, band = 256, 32
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    sig = np.asarray(svdvals_sharded(A, cpu_mesh, band=band))
    ref = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    assert np.max(np.abs(sig - ref)) / ref[0] < 1e-4


def test_svd_sharded_full(cpu_mesh, rng):
    # multi-chip FULL SVD: Stage I + factor accumulation sharded over tp,
    # back-transforms on column blocks, final contractions by psum_scatter
    from svdsolver_tpu.parallel.distributed import svd_sharded

    n, band = 64, 8
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = (np.asarray(x) for x in svd_sharded(A, cpu_mesh, band=band))
    An = np.asarray(A)
    ref = np.linalg.svd(An.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - An).max() / np.abs(An).max() < 1e-4


def test_batch_gspmd_matches(cpu_mesh, rng):
    from svdsolver_tpu.parallel.distributed import svdvals_batch_sharded_gspmd

    batch, n, band = 4, 32, 8
    As = jnp.asarray(rng.uniform(0, 5, (batch, n, n)).astype(np.float32))
    sig = np.asarray(svdvals_batch_sharded_gspmd(As, cpu_mesh, band=band))
    ref = np.linalg.svd(np.asarray(As, np.float64), compute_uv=False)
    assert np.max(np.abs(sig - ref) / ref[:, :1]) < 1e-4


def test_batch_sharded_never_replicates_A(cpu_mesh):
    """The default batch path uses explicit shard_map collectives; assert on
    the compiled HLO that the ONLY full-matrix all-gather is the band gather
    after Stage I — this test fails if anyone reintroduces a path where the
    partitioner replicates A (the GSPMD variant measurably does)."""
    import functools
    import re
    from svdsolver_tpu.parallel.distributed import svdvals_batch_sharded

    batch, n, band = 4, 32, 8
    As = np.zeros((batch, n, n), np.float32)
    fn = jax.jit(
        functools.partial(svdvals_batch_sharded, mesh=cpu_mesh, band=band)
    )
    txt = fn.lower(As).compile().as_text()
    full_gathers = [
        m
        for m in re.findall(r"= \w+\[([^\]]*)\][^\n]*all-gather", txt)
        if m.split(",")[-2:] == [str(n), str(n)]
    ]
    assert len(full_gathers) == 1, full_gathers  # exactly the band gather
    assert "all-reduce" in txt  # the hand-placed psums survived compilation


def test_svd_jacobi_sharded(cpu_mesh, rng):
    # multi-chip block Jacobi: two column blocks per tp device, neighbor
    # ppermute tournament exchange, pmax convergence coupling
    from svdsolver_tpu.parallel.jacobi import svd_jacobi_sharded

    n = 64
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = (np.asarray(x) for x in svd_jacobi_sharded(A, cpu_mesh))
    An = np.asarray(A)
    ref = np.linalg.svd(An.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - An).max() / np.abs(An).max() < 1e-4


def test_svd_jacobi_sharded_graded_relative(cpu_mesh, rng):
    # the Jacobi accuracy class survives distribution: RELATIVE sigma error
    # stays ~fp32-eps across 6 decades of column grading
    from svdsolver_tpu.parallel.jacobi import svd_jacobi_sharded

    n = 64
    B = jnp.asarray(
        (rng.normal(size=(n, n)) @ np.diag(np.logspace(0, -6, n))).astype(
            np.float32
        )
    )
    U, s, Vh = (np.asarray(x) for x in svd_jacobi_sharded(B, cpu_mesh))
    ref = np.linalg.svd(np.asarray(B, np.float64), compute_uv=False)
    assert np.max(np.abs(s - ref) / ref) < 1e-3  # relative, every decade
    Bn = np.asarray(B)
    assert np.abs(U @ np.diag(s) @ Vh - Bn).max() / np.abs(Bn).max() < 1e-4


def test_svd_jacobi_sharded_nonsquare_pad(cpu_mesh, rng):
    # n not divisible by 2*tp: zero-pad columns are dead and masked out
    from svdsolver_tpu.parallel.jacobi import svd_jacobi_sharded

    n = 52  # 2*tp = 8 does not divide 52 -> pads to 56
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    U, s, Vh = (np.asarray(x) for x in svd_jacobi_sharded(A, cpu_mesh))
    An = np.asarray(A)
    ref = np.linalg.svd(An.astype(np.float64), compute_uv=False)
    assert s.shape == (n,) and U.shape == (n, n) and Vh.shape == (n, n)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - An).max() / np.abs(An).max() < 1e-4


def test_pipelined_chase_matches_sequential(cpu_mesh, rng):
    # multi-chip Stage II: the pipelined bulge chase over row-sharded
    # devices computes the same bidiagonal SPECTRUM as the sequential chase
    # (d/e entries differ by reordering roundoff, which the chase amplifies;
    # the singular values are the invariant)
    from svdsolver_tpu.parallel.distributed import band_to_bidiagonal_pipelined
    from svdsolver_tpu.models.two_stage import dense_to_band, band_to_bidiagonal

    for n, band in [(96, 8), (64, 4)]:
        A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
        Ab = dense_to_band(A, band=band)
        d0, e0 = (np.asarray(x, np.float64) for x in band_to_bidiagonal(Ab, band=band))
        d1, e1 = (
            np.asarray(x, np.float64)
            for x in band_to_bidiagonal_pipelined(Ab, cpu_mesh, band=band)
        )
        assert d1.shape == (n,) and e1.shape == (n - 1,)
        s0 = np.linalg.svd(np.diag(d0) + np.diag(e0, 1), compute_uv=False)
        s1 = np.linalg.svd(np.diag(d1) + np.diag(e1, 1), compute_uv=False)
        ref = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
        assert np.max(np.abs(s1 - ref)) / ref[0] < 1e-5, (n, band)
        assert np.max(np.abs(s1 - s0)) / ref[0] < 1e-5, (n, band)


def test_pipelined_chase_spectrum_f64(cpu_mesh, rng):
    # the docstring/PARITY contract, gated: in f64 the pipelined chase's
    # bidiagonal spectrum matches the sequential chase's to ~1e-13 relative
    # (reordering roundoff only — on the real f64 of the CPU mesh)
    from svdsolver_tpu.parallel.distributed import band_to_bidiagonal_pipelined
    from svdsolver_tpu.models.two_stage import dense_to_band, band_to_bidiagonal

    n, band = 64, 8
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float64))
    Ab = dense_to_band(A, band=band)
    d0, e0 = (np.asarray(x) for x in band_to_bidiagonal(Ab, band=band))
    d1, e1 = (
        np.asarray(x)
        for x in band_to_bidiagonal_pipelined(Ab, cpu_mesh, band=band)
    )
    assert d1.dtype == np.float64
    s0 = np.linalg.svd(np.diag(d0) + np.diag(e0, 1), compute_uv=False)
    s1 = np.linalg.svd(np.diag(d1) + np.diag(e1, 1), compute_uv=False)
    assert np.max(np.abs(s1 - s0)) / s0[0] < 1e-13


def test_pipelined_chase_group_sizes(cpu_mesh, rng):
    # explicit sweeps_per_group settings (1 = no intra-group stagger) all
    # reproduce the spectrum
    from svdsolver_tpu.parallel.distributed import band_to_bidiagonal_pipelined
    from svdsolver_tpu.models.two_stage import dense_to_band

    n, band = 64, 8
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    Ab = dense_to_band(A, band=band)
    ref = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    for lg in (1, 2):
        d, e = (
            np.asarray(x, np.float64)
            for x in band_to_bidiagonal_pipelined(
                Ab, cpu_mesh, band=band, sweeps_per_group=lg
            )
        )
        s = np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)
        assert np.max(np.abs(s - ref)) / ref[0] < 1e-5, lg


def test_svdvals_sharded_pipelined_stage2(cpu_mesh, rng):
    # the fully-distributed single-matrix pipeline: sharded Stage I +
    # pipelined multi-chip chase + bisection
    from svdsolver_tpu.parallel.distributed import svdvals_sharded

    n, band = 128, 16
    A = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))
    sig = np.asarray(svdvals_sharded(A, cpu_mesh, band=band, stage2="pipelined"))
    ref = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    assert np.max(np.abs(sig - ref)) / ref[0] < 1e-4
