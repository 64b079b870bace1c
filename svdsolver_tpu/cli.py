"""Command-line driver with the reference's benchmark/check surface.

Benchmark mode (reference: svd_cpu.cpp:114-297, svd_cuda_2.cu:1357-1431):

    python -m svdsolver_tpu bench MODEL step n_steps n_instances [block]

with MODEL in {base, singlecore, multicore, diagonal, tpu1, tpu2, jacobi}
(jacobi: full-SVD one-sided block Jacobi — no reference counterpart).  Sweeps
matrix sizes N = k*step for k = 1..n_steps-1 over ``n_instances`` random
uniform [0, 5] matrices per size (reference generators: svd_cpu.cpp:50-90),
prints mean seconds per instance, and writes ``data/<model>_benchmark.csv``
in the reference's schema.

Check mode (reference: svd_cuda_2.cu:1296-1347):

    python -m svdsolver_tpu check {64|512|1024} [--band 4] [--dtype float|double]

reads the shipped fixture, runs the two-stage Stage-I reduction with band=4,
reports band-limited MSE vs the ``band_*`` fixture, then fully bidiagonalizes
and reports MSE vs the ``bidiagonal_*`` fixture.  Size 1024 (which the
reference README advertises but ships no fixture for) is generated once by
the native C++ oracle and cached — a true cross-implementation check.
"""

import argparse
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def _make_matrices(n, count, rng, dtype, min_val=0.0, max_val=5.0):
    return [
        jnp.asarray(rng.uniform(min_val, max_val, size=(n, n)).astype(dtype))
        for _ in range(count)
    ]


def _make_bidiagonals(n, count, rng, dtype, min_val=0.0, max_val=5.0):
    return [
        (
            jnp.asarray(rng.uniform(min_val, max_val, size=n).astype(dtype)),
            jnp.asarray(rng.uniform(min_val, max_val, size=n - 1).astype(dtype)),
        )
        for _ in range(count)
    ]


def _ensure_x64(args):
    # without x64, f64 inputs silently downcast to f32
    if args.dtype == "double":
        jax.config.update("jax_enable_x64", True)


def cmd_bench(args):
    _ensure_x64(args)
    from svdsolver_tpu.models.golub_kahan import bidiagonalize_gk_jit
    from svdsolver_tpu.models.blocked import bidiagonalize_blocked
    from svdsolver_tpu.models.two_stage import dense_to_band, band_to_bidiagonal
    from svdsolver_tpu.models.diagonalize import (
        bidiagonal_svdvals,
        dqds_svdvals,
    )
    from svdsolver_tpu.ops import dispatch
    from svdsolver_tpu.utils.timing import benchmark
    from svdsolver_tpu.utils.csvout import write_benchmark_csv

    model = args.model
    dtype = np.float64 if args.dtype == "double" else np.float32
    rng = np.random.default_rng(args.seed)
    sizes, y, z = [], [], []
    print(f"Model: {model}  step={args.step} steps={args.n_steps} "
          f"instances={args.n_instances} block={args.block} dtype={args.dtype}")
    print(f"devices: {jax.devices()}")

    for k in range(1, args.n_steps):
        n = k * args.step
        t2 = None
        if model == "diagonal":
            data = _make_bidiagonals(n, args.n_instances, rng, dtype)
            if args.diag == "qr":
                solver = bidiagonal_svdvals
            elif args.diag == "dqds":
                solver = dqds_svdvals
            else:
                solver = dispatch.bisect_svdvals
            t1 = benchmark(lambda de: solver(de[0], de[1]), data)
            print(f"\tN = {n} : {t1:g} sec (bidiagonal -> diagonal, {args.diag})")
        else:
            data = _make_matrices(n, args.n_instances, rng, dtype)
            if model == "base":
                t1 = benchmark(bidiagonalize_gk_jit, data)
                print(f"\tN = {n} : {t1:g} sec (dense -> bidiagonal)")
            elif model == "singlecore":
                t1 = benchmark(lambda A: bidiagonalize_blocked(A, panel=args.block), data)
                print(f"\tN = {n} : {t1:g} sec (dense -> bidiagonal)")
            elif model == "jacobi":
                from svdsolver_tpu.models.jacobi import svd_jacobi

                t1 = benchmark(
                    lambda A: svd_jacobi(A, block=args.block)[1], data
                )
                print(f"\tN = {n} : {t1:g} sec (full SVD, block Jacobi)")
            elif model in ("multicore", "tpu1", "tpu2"):
                pad = (-n) % args.block
                if pad:  # reference requires divisibility (README.md:45); pad instead
                    data = [jnp.pad(A, ((0, pad), (0, pad))) for A in data]
                stage1 = dense_to_band
                stage2 = band_to_bidiagonal
                if model == "multicore":
                    from svdsolver_tpu.models.tiled import dense_to_band_tiled

                    stage1 = dense_to_band_tiled
                t1 = benchmark(lambda A: stage1(A, band=args.block), data)
                banded = [stage1(A, band=args.block) for A in data]
                t2 = benchmark(lambda A: stage2(A, band=args.block), banded)
                print(
                    f"\tN = {n} : {t1:g} sec (dense -> band) | "
                    f"{t2:g} sec (band -> bidiagonal) | {t1 + t2:g} sec (total)"
                )
            else:
                raise SystemExit(f"unknown model {model}")
        sizes.append(n)
        y.append(t1)
        if t2 is not None:
            z.append(t2)

    path = args.output or f"data/{model}_benchmark.csv"
    write_benchmark_csv(path, sizes, y, z if z else None)
    print(f"\nWrote results to {path}")


def cmd_check(args):
    _ensure_x64(args)
    from svdsolver_tpu.models.two_stage import dense_to_band, bidiagonalize_two_stage
    from svdsolver_tpu.utils import fixtures as fx

    n = args.size
    dtype = np.float64 if args.dtype == "double" else np.float32
    if n == 1024:
        # not shipped by the reference (its README advertises check 1024
        # with no fixture); generated once by the native C++ oracle
        fx.ensure_generated_fixtures(n, dtype, band=args.band)
    A0 = fx.load_fixture("test", n, dtype)
    sig_ref = np.linalg.svd(A0.astype(np.float64), compute_uv=False)
    tol = 1e-5 if dtype == np.float32 else 1e-10

    if args.model == "tpu2":
        # Flagship path: svdvals (Stage I + chase + bisection) on whatever
        # backend is present, gated on sigma vs LAPACK (the band=4 fixtures
        # are keyed to the reference's band-4 reduction — svd_cuda_2.cu:1300
        # — so at the flagship band only the sigma oracle applies).
        from svdsolver_tpu.models.svd import svdvals

        band = None if args.band == 4 else args.band
        t0 = time.perf_counter()
        sig = np.asarray(svdvals(jnp.asarray(A0), block=band))
        t_all = time.perf_counter() - t0
        rel = float(np.max(np.abs(sig - sig_ref)) / sig_ref[0])
        print(f"svdvals N={n} on {jax.devices()[0].platform}: {t_all:.3f}s "
              f"(incl. compile)  max |sigma - sigma_lapack| / ||A||_2 = "
              f"{rel:.3e}")
        ok = rel < tol
        print("CHECK PASSED" if ok else "CHECK FAILED")
        return 0 if ok else 1

    band = args.band
    pad = (-n) % band
    A = jnp.asarray(np.pad(A0, ((0, pad), (0, pad))))

    t0 = time.perf_counter()
    Ab = np.asarray(dense_to_band(A, band=band))[:n, :n]
    jax.block_until_ready(Ab)
    t_band = time.perf_counter() - t0

    band_ref = fx.load_fixture("band", n, dtype)
    mse_band = fx.band_mse(Ab, band_ref, band)
    print(f"band reduction    N={n} band={band}: {t_band:.3f}s  "
          f"MSE vs fixture = {mse_band:.3e}")

    d, e = bidiagonalize_two_stage(A, band=band)
    d, e = np.asarray(d)[:n], np.asarray(e)[: n - 1]
    bidiag_ref = fx.load_fixture("bidiagonal", n, dtype)
    B = np.diag(d) + np.diag(e, 1)
    mse_bidiag = fx.band_mse(B, bidiag_ref, 1)
    print(f"bidiagonalization N={n}: MSE vs fixture = {mse_bidiag:.3e}")

    # External oracle: singular values must match LAPACK to ~eps * ||A||.
    sig = np.linalg.svd(B.astype(np.float64), compute_uv=False)
    rel = float(np.max(np.abs(sig - sig_ref)) / sig_ref[0])
    print(f"max |sigma - sigma_lapack| / ||A||_2 = {rel:.3e}")
    ok = rel < tol
    print("CHECK PASSED" if ok else "CHECK FAILED")
    return 0 if ok else 1


def cmd_svdvals(args):
    _ensure_x64(args)
    from svdsolver_tpu.models.svd import svdvals
    from svdsolver_tpu.utils.fixtures import read_matrix

    dtype = np.float64 if args.dtype == "double" else np.float32
    A = read_matrix(args.path, args.n, args.n, dtype)
    s = np.asarray(svdvals(jnp.asarray(A), method=args.model))
    out = args.output
    if out:
        np.asarray(s).tofile(out)
        print(f"wrote {len(s)} singular values to {out}")
    else:
        np.set_printoptions(precision=6, suppress=False, threshold=50)
        print(s)
    return 0


def cmd_svd(args):
    _ensure_x64(args)
    from svdsolver_tpu.models.vectors import svd, svds
    from svdsolver_tpu.utils.fixtures import read_matrix

    dtype = np.float64 if args.dtype == "double" else np.float32
    A = read_matrix(args.path, args.n, args.n, dtype)
    Aj = jnp.asarray(A)
    if args.k:
        U, s, Vh = svds(Aj, args.k)
    else:
        U, s, Vh = svd(Aj)
    U, s, Vh = np.asarray(U), np.asarray(s), np.asarray(Vh)
    # residual report: ||A V - U S|| holds for full AND top-k outputs
    res = float(
        np.max(np.abs(A @ Vh.T - U * s[None, :])) / max(float(s[0]), 1e-30)
    )
    k = s.shape[0]
    print(f"computed {k} singular triplet(s); max residual "
          f"|A v - s u| / sigma_0 = {res:.3e}")
    if args.output_prefix:
        U.tofile(args.output_prefix + "_U.bin")
        s.tofile(args.output_prefix + "_s.bin")
        Vh.tofile(args.output_prefix + "_Vh.bin")
        print(f"wrote {args.output_prefix}_{{U,s,Vh}}.bin "
              f"(shapes {U.shape}, {s.shape}, {Vh.shape})")
    else:
        np.set_printoptions(precision=6, suppress=False, threshold=50)
        print(s)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="svdsolver_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("bench", help="benchmark sweep (reference CLI parity)")
    pb.add_argument("model", choices=[
        "base", "singlecore", "multicore", "diagonal", "tpu1", "tpu2",
        "jacobi"])
    pb.add_argument("step", type=int)
    pb.add_argument("n_steps", type=int)
    pb.add_argument("n_instances", type=int)
    pb.add_argument("block", type=int, nargs="?", default=32)
    pb.add_argument("--dtype", choices=["float", "double"], default="float")
    pb.add_argument("--diag", choices=["bisect", "qr", "dqds"], default="bisect",
                    help="diagonalization algorithm for the 'diagonal' model")
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--output", default=None)
    pb.set_defaults(fn=cmd_bench)

    pc = sub.add_parser("check", help="fixture correctness check")
    pc.add_argument("size", type=int, choices=[64, 512, 1024])
    pc.add_argument("--band", type=int, default=4)
    pc.add_argument("--dtype", choices=["float", "double"], default="float")
    pc.add_argument(
        "--model", choices=["xla", "tpu2"], default="xla",
        help="xla: reference-parity band-4 fixture MSE; tpu2: the flagship "
             "svdvals pipeline (Stage I + chase + bisection) gated on "
             "sigma vs LAPACK",
    )
    pc.set_defaults(fn=cmd_check)

    ps = sub.add_parser(
        "svdvals", help="singular values of a raw binary matrix file"
    )
    ps.add_argument("path", help="row-major binary matrix (reference format)")
    ps.add_argument("n", type=int, help="matrix dimension (n x n)")
    ps.add_argument("--model", default="tpu2", choices=[
        "base", "singlecore", "multicore", "tpu1", "tpu2"])
    ps.add_argument("--dtype", choices=["float", "double"], default="float")
    ps.add_argument("--output", default=None,
                    help="write sigma as raw binary instead of printing")
    ps.set_defaults(fn=cmd_svdvals)

    pv = sub.add_parser(
        "svd", help="full (or top-k) SVD of a raw binary matrix file"
    )
    pv.add_argument("path", help="row-major binary matrix (reference format)")
    pv.add_argument("n", type=int, help="matrix dimension (n x n)")
    pv.add_argument("-k", type=int, default=None,
                    help="compute only the top-k singular triplets")
    pv.add_argument("--dtype", choices=["float", "double"], default="float")
    pv.add_argument("--output-prefix", default=None,
                    help="write <prefix>_{U,s,Vh}.bin instead of printing s")
    pv.set_defaults(fn=cmd_svd)

    args = p.parse_args(argv)
    from svdsolver_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
