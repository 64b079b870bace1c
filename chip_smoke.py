"""Smoke run of the main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One card:

1. device check: JAX must see a GPU (no fallback); prints the device kind,
   count, and the card's name and power limit from ``nvidia-smi``;
2. ``svdvals`` fp32 at n=7680 against fp64 cuSOLVER on the card;
3. ``svd`` fp32 at n=3840: reconstruction, orthogonality, and sigma
   against host LAPACK in fp64;
4. ``svdvals`` fp64 at n=2048 against host LAPACK;
5. each Pallas Triton kernel against its XLA reference at n=3840 and 7680.

Four cards (``--four-cards``): ``svdvals_sharded`` and ``svd_sharded`` on a
``make_mesh(4, dp=1)`` mesh at n=7680 fp32, beside the single-card
``svdvals``/``svd`` of the same matrix on device 0, with the same gates.

Every phase raises on failure; nothing is caught.  The last line of
standard output is one JSON object naming the device, printed only when
every gate held.  Everything runs in this one process.
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

# accuracy gates (the repo's own: cli.py check, tests/test_vectors.py)
SIG_F32 = 1e-5  # max|sigma - ref| / sigma_max
SIG_F64 = 1e-10
SVD_RECON = 1e-4  # max|U S Vh - A| / sigma_max
SVD_ORTH = 1e-4  # max|U^T U - I|, max|Vh Vh^T - I|
KERNEL_BISECT = {jnp.float32: 1e-6, jnp.float64: 1e-13}  # vs XLA bisection
KERNEL_TGK = 1e-4  # per-lane normalized solutions, fp32


def log(*args):
    print(*args, flush=True)


def timed(fn, *args, reps=2):
    """(compile seconds, steady seconds per call, result) of jit(fn)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        steady.append(time.perf_counter() - t0)
    return t_compile, min(steady), out, compiled


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def check(name, value, limit):
    log(f"  {name}: {value:.3e} (limit {limit:.0e})")
    if not value <= limit:
        raise AssertionError(f"{name} = {value:.3e} exceeds {limit:.0e}")


def device_phase():
    from svdsolver_tpu.utils.device import describe, nvidia_smi

    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {dev['platform']!r})"
        )
    smi = nvidia_smi()
    if not smi or "," not in smi.splitlines()[0]:
        raise SystemExit(f"chip_smoke: nvidia-smi gave no power limit: {smi!r}")
    log(f"[1] device: {dev['kind']} x{dev['count']}; nvidia-smi name, "
        "power.limit:")
    log(smi)
    return dev


def sigma_ref_gpu(A):
    """fp64 singular values on the card (cuSOLVER via jnp.linalg.svd)."""
    with jax.enable_x64(True):
        s = jnp.linalg.svd(A.astype(jnp.float64), compute_uv=False)
        return np.asarray(jax.block_until_ready(s))


def normal(key, n, dtype):
    return jax.random.normal(jax.random.PRNGKey(key), (n, n), dtype)


def svdvals_phase(n=7680):
    from svdsolver_tpu import svdvals

    A = normal(0, n, jnp.float32)
    tc, ts, sig, compiled = timed(svdvals, A)
    log(f"[2] svdvals fp32 n={n}: compile {tc:.3f} s, steady {ts:.3f} s")
    log(f"    memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    ref = sigma_ref_gpu(A)
    log(f"    cuSOLVER fp64 reference: {time.perf_counter() - t0:.3f} s")
    sig = np.asarray(sig)
    require(sig.shape == (n,) and np.isfinite(sig).all(), "svdvals output")
    check("max|sigma - ref|/sigma_max", np.abs(sig - ref).max() / ref[0], SIG_F32)


def svd_phase(n=3840):
    from svdsolver_tpu import svd

    A = normal(1, n, jnp.float32)
    tc, ts, (U, s, Vh), compiled = timed(svd, A)
    log(f"[3] svd fp32 n={n}: compile {tc:.3f} s, steady {ts:.3f} s")
    log(f"    memory_analysis: {compiled.memory_analysis()}")
    require(U.shape == (n, n) and s.shape == (n,) and Vh.shape == (n, n),
            "svd output shapes")
    t0 = time.perf_counter()
    ref = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    log(f"    host LAPACK fp64 reference: {time.perf_counter() - t0:.3f} s")
    gate_svd(A, U, s, Vh, ref)


def gate_svd(A, U, s, Vh, ref):
    """Sigma against ``ref`` plus reconstruction and orthogonality, in fp64
    on the card."""
    with jax.enable_x64(True):
        hi = jax.lax.Precision.HIGHEST
        U, Vh, A = (x.astype(jnp.float64) for x in (U, Vh, A))
        eye = jnp.eye(U.shape[1], dtype=jnp.float64)
        US = U * s.astype(jnp.float64)
        recon = jnp.abs(jnp.matmul(US, Vh, precision=hi) - A).max()
        ou = jnp.abs(jnp.matmul(U.T, U, precision=hi) - eye).max()
        ov = jnp.abs(jnp.matmul(Vh, Vh.T, precision=hi) - eye).max()
        recon, ou, ov = (float(x) for x in (recon, ou, ov))
    s = np.asarray(s)
    require(np.isfinite(s).all(), "finite sigma")
    check("max|sigma - ref|/sigma_max", np.abs(s - ref).max() / ref[0], SIG_F32)
    check("max|U S Vh - A|/sigma_max", recon / ref[0], SVD_RECON)
    check("max|U^T U - I|", ou, SVD_ORTH)
    check("max|Vh Vh^T - I|", ov, SVD_ORTH)


def svdvals_f64_phase(n=2048):
    from svdsolver_tpu import svdvals

    with jax.enable_x64(True):
        A = normal(2, n, jnp.float64)
        tc, ts, sig, _ = timed(svdvals, A)
        sig = np.asarray(sig)
    log(f"[4] svdvals fp64 n={n}: compile {tc:.3f} s, steady {ts:.3f} s")
    ref = np.linalg.svd(np.asarray(A), compute_uv=False)
    require(np.isfinite(sig).all(), "finite sigma")
    check("max|sigma - ref|/sigma_max", np.abs(sig - ref).max() / ref[0], SIG_F64)


def bidiagonal(key, n, dtype):
    """Random uniform [0, 5] bidiagonal: the reference's diagonal benchmark."""
    kd, ke = jax.random.split(jax.random.PRNGKey(key))
    d = jax.random.uniform(kd, (n,), dtype, 0.0, 5.0)
    e = jax.random.uniform(ke, (n - 1,), dtype, 0.0, 5.0)
    return d, e


def kernel_phase(sizes=(3840, 7680)):
    from svdsolver_tpu.models.diagonalize import bisect_svdvals
    from svdsolver_tpu.models.vectors import tgk_solve_xla
    from svdsolver_tpu.ops.pallas.bisect_triton import bisect_svdvals_triton
    from svdsolver_tpu.ops.pallas.tgk_solve_triton import tgk_solve_triton

    for n in sizes:
        for dtype in (jnp.float32, jnp.float64):
            with jax.enable_x64(dtype == jnp.float64):
                d, e = bidiagonal(n, n, dtype)
                tk = timed(bisect_svdvals_triton, d, e)
                tr = timed(bisect_svdvals, d, e)
                sk, sr = np.asarray(tk[2]), np.asarray(tr[2])
            name = jnp.dtype(dtype).name
            log(f"[5] bisection n={n} {name}: triton compile {tk[0]:.3f} s "
                f"steady {tk[1]:.4f} s | xla compile {tr[0]:.3f} s "
                f"steady {tr[1]:.4f} s")
            check("max|triton - xla|/sigma_max", np.abs(sk - sr).max() / sr[0],
                  KERNEL_BISECT[dtype])
        d, e = bidiagonal(n, n, jnp.float32)
        N = 2 * n
        z = jnp.zeros((N - 1,), jnp.float32).at[0::2].set(d).at[1::2].set(e)
        lam = bisect_svdvals_triton(d, e)
        rhs = jax.random.normal(jax.random.PRNGKey(n + 1), (N, n), jnp.float32)
        eps = float(jnp.finfo(jnp.float32).eps)
        pivmin = jnp.float32(max(float(lam[0]) * eps * eps, 1e-37))
        big = jnp.float32(np.finfo(np.float32).max ** 0.5 / 16)
        args = (z, lam, rhs, pivmin, big)
        tk = timed(tgk_solve_triton, *args)
        tr = timed(tgk_solve_xla, *args)
        xk = tk[2] / jnp.linalg.norm(tk[2], axis=0)
        xr = tr[2] / jnp.linalg.norm(tr[2], axis=0)
        log(f"[5] tgk solve n={n} float32: triton compile {tk[0]:.3f} s "
            f"steady {tk[1]:.4f} s | xla compile {tr[0]:.3f} s "
            f"steady {tr[1]:.4f} s")
        check("max|triton - xla| per-lane normalized",
              float(jnp.abs(xk - xr).max()), KERNEL_TGK)


def four_card_phase(n=7680):
    from svdsolver_tpu import svd, svdvals
    from svdsolver_tpu.models.svd import _auto_block
    from svdsolver_tpu.parallel.distributed import (
        dense_to_band_shardmap,
        svd_sharded,
        svdvals_sharded,
    )
    from svdsolver_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    if len(devs) != 4:
        raise SystemExit(f"chip_smoke --four-cards: found {len(devs)} devices")
    mesh = make_mesh(4, dp=1)
    band = _auto_block(n)
    A = normal(3, n, jnp.float32)  # on device 0
    ref = sigma_ref_gpu(A)

    # Stage I must spread over all four devices, a column block on each
    t0 = time.perf_counter()
    Ab = jax.block_until_ready(dense_to_band_shardmap(A, mesh, band=band))
    shards = {s.device.id: s.data.shape for s in Ab.addressable_shards}
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    log(f"[4c] sharded Stage I: {time.perf_counter() - t0:.3f} s (incl. "
        f"compile); shards {shards}; peak bytes per device {peaks}")
    require(len(shards) == 4 and all(
        shape == (n, n // 4) for shape in shards.values()
    ), f"Stage I shards {shards}")
    if None not in peaks:  # the CPU backend keeps no memory stats
        require(min(peaks) >= A.nbytes // 4, f"peak bytes {peaks}")

    t0 = time.perf_counter()
    s4 = np.asarray(jax.block_until_ready(svdvals_sharded(A, mesh, band=band)))
    log(f"[4c] svdvals_sharded n={n}: {time.perf_counter() - t0:.3f} s "
        "(incl. compile)")
    check("sharded max|sigma - ref|/sigma_max", np.abs(s4 - ref).max() / ref[0],
          SIG_F32)
    t0 = time.perf_counter()
    s1 = np.asarray(jax.block_until_ready(svdvals(A)))
    log(f"[4c] svdvals one card n={n}: {time.perf_counter() - t0:.3f} s "
        "(incl. compile)")
    check("one-card max|sigma - ref|/sigma_max", np.abs(s1 - ref).max() / ref[0],
          SIG_F32)

    t0 = time.perf_counter()
    U, s, Vh = jax.block_until_ready(svd_sharded(A, mesh, band=band))
    log(f"[4c] svd_sharded n={n}: {time.perf_counter() - t0:.3f} s "
        "(incl. compile)")
    gate_svd(A, jax.device_put(U, devs[0]), jax.device_put(s, devs[0]),
             jax.device_put(Vh, devs[0]), ref)
    t0 = time.perf_counter()
    U, s, Vh = jax.block_until_ready(svd(A))
    log(f"[4c] svd one card n={n}: {time.perf_counter() - t0:.3f} s "
        "(incl. compile)")
    gate_svd(A, U, s, Vh, ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    from svdsolver_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t_all = time.perf_counter()
    dev = device_phase()
    if args.four_cards:
        four_card_phase()
    else:
        svdvals_phase()
        svd_phase()
        svdvals_f64_phase()
        kernel_phase()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
