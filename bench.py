"""Headline benchmark: one JSON line to stdout, diagnostics to stderr.

Primary metric (round-comparable): two-stage Stage-I dense->band reduction,
N=3200 band=32 fp32 — the reference's canonical CUDA sweep config.  Baseline:
the reference's published V100 CUDA-1 band-reduction wall-clock at N=3200,
band=32 — 22.0778 s (reference README.md:203; see BASELINE.md).
``vs_baseline`` is the speedup factor (baseline_seconds / our_seconds).

The same JSON line also carries full singular values at 3840x3840 fp32
(flagship path) — wall-clock and max relative error vs LAPACK — and the
other cells below.  The device, its kind and count, and the card's name and
power limit go to stderr; the exit code is non-zero if any section failed.
"""

import json
import sys
import time

import numpy as np

N = 3200
BAND = 32
BASELINE_S = 22.0778  # V100 CUDA-1, README.md:203
NS_N = 3840  # full-sigma size


def main():
    import jax

    from svdsolver_tpu.utils.cache import enable_compile_cache
    from svdsolver_tpu.utils.device import describe, nvidia_smi

    enable_compile_cache()
    import jax.numpy as jnp
    from svdsolver_tpu.models.svd import svdvals
    from svdsolver_tpu.models.two_stage import dense_to_band

    dev = describe()
    print(f"platform {dev['platform']}  device_kind {dev['kind']}  "
          f"devices {dev['count']}", file=sys.stderr)
    try:
        print(f"nvidia-smi: {nvidia_smi()}", file=sys.stderr)
    except Exception as exc:
        print(f"nvidia-smi: unavailable ({exc})", file=sys.stderr)
    failed = []
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.uniform(0.0, 5.0, size=(N, N)).astype(np.float32))
    stage1 = dense_to_band

    def run(x):
        return jax.block_until_ready(stage1(x, band=BAND))

    t0 = time.perf_counter()
    run(A)
    print(f"stage1 compile+first run: {time.perf_counter() - t0:.2f}s",
          file=sys.stderr)

    # Loop-timed (5 back-to-back calls, one final fence); the MEDIAN of 5
    # loop measurements.
    reps = 5
    loop = 5
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(loop):
            out = stage1(A, band=BAND)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / loop)
    t = _median(times)
    flops = 8 / 3 * N**3  # two-sided blocked reduction FLOP count
    gflops = flops / t / 1e9
    print(f"stage1 times: {times}  gflops: {gflops:.1f}", file=sys.stderr)

    # ---- full sigma at 3840^2 fp32, accuracy vs LAPACK --------------------
    ns_s = ns_err = None
    try:
        Ans = jnp.asarray(
            rng.uniform(0.0, 5.0, size=(NS_N, NS_N)).astype(np.float32)
        )

        def run_ns(x):
            return np.asarray(svdvals(x, method="tpu2"))

        t0 = time.perf_counter()
        run_ns(Ans)  # compile
        print(f"northstar compile+first run: {time.perf_counter() - t0:.2f}s",
              file=sys.stderr)
        ns_times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sig = run_ns(Ans)
            ns_times.append(time.perf_counter() - t0)
        ns_s = _median(ns_times)
        ref = np.linalg.svd(np.asarray(Ans, np.float64), compute_uv=False)
        ns_err = float(np.max(np.abs(sig - ref)) / ref[0])
        print(
            f"north star: svdvals {NS_N}^2 fp32 times {ns_times} "
            f"rel_err {ns_err:.2e}",
            file=sys.stderr,
        )
    except Exception as exc:  # the line is still printed; the exit code fails
        print(f"north-star bench failed: {exc}", file=sys.stderr)
        failed.append("northstar")

    # ---- scale point: full sigma at 7680^2 fp32 -----------------------------
    sc_s = None
    try:
        SCN = 7680
        Asc = jnp.asarray(rng.normal(size=(SCN, SCN)).astype(np.float32))

        def run_sc(x):
            return jax.block_until_ready(svdvals(x, method="tpu2"))

        t0 = time.perf_counter()
        run_sc(Asc)  # compile
        print(f"scale compile+first run: {time.perf_counter() - t0:.2f}s",
              file=sys.stderr)
        sc_times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run_sc(Asc)
            sc_times.append(time.perf_counter() - t0)
        sc_s = _median(sc_times)
        print(f"scale: svdvals {SCN}^2 fp32 times {sc_times}", file=sys.stderr)
        del Asc
    except Exception as exc:
        print(f"scale bench failed: {exc}", file=sys.stderr)
        failed.append("scale")

    # full-pipeline breakdown (flagship path, auto band): the three stage
    # timings go into the JSON line.
    pipe_metrics = {}
    try:
        from svdsolver_tpu.utils.profiling import stage_timings

        t0 = time.perf_counter()
        st = stage_timings(A)
        print(
            f"full pipeline (tpu2, band={st['band']}, incl compile "
            f"{time.perf_counter() - t0:.1f}s): {st}",
            file=sys.stderr,
        )
        pipe_metrics = {
            "pipeline_N3200_stage1_s": round(st["stage1_dense_to_band_s"], 4),
            "pipeline_N3200_stage2_s": round(
                st["stage2_band_to_bidiagonal_s"], 4
            ),
            "pipeline_N3200_diag_s": round(st["diagonalization_s"], 4),
        }
    except Exception as exc:
        print(f"stage_timings failed: {exc}", file=sys.stderr)
        failed.append("stage_timings")

    # ---- full SVD with singular vectors (beyond the reference) ----------
    svd_metrics = {}
    try:
        from svdsolver_tpu import svd

        fsvd = jax.jit(svd)  # the public svd() is jit-compatible

        for SN, sv_loop in ((2048, 3), (3840, 2)):
            Asv = jnp.asarray(rng.normal(size=(SN, SN)).astype(np.float32))

            def run_svd(x, k):
                out = None
                for _ in range(k):
                    out = fsvd(x)
                jax.block_until_ready(out)
                return out

            t0 = time.perf_counter()
            run_svd(Asv, 1)  # compile
            print(
                f"svd {SN} compile+first run: "
                f"{time.perf_counter() - t0:.2f}s",
                file=sys.stderr,
            )
            sv_times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = run_svd(Asv, sv_loop)
                sv_times.append((time.perf_counter() - t0) / sv_loop)
            svd_s = _median(sv_times)
            U, s, Vh = (np.asarray(o) for o in out)
            An = np.asarray(Asv)
            svd_err = float(
                np.abs(U @ np.diag(s) @ Vh - An).max() / np.abs(An).max()
            )
            svd_metrics[f"full_svd_N{SN}_fp32_s"] = round(svd_s, 4)
            svd_metrics[f"full_svd_N{SN}_max_recon_rel_err"] = float(
                f"{svd_err:.3e}"
            )
            print(
                f"full svd {SN}^2 fp32 times {sv_times} recon {svd_err:.2e}",
                file=sys.stderr,
            )
            del Asv, out, U, s, Vh, An
    except Exception as exc:
        print(f"full-svd bench failed: {exc}", file=sys.stderr)
        failed.append("full_svd")

    # ---- Jacobi relative accuracy on a graded spectrum (fp32: 6 decades) --
    # Headline: the preconditioned (dgejsv-class) flagship; standalone
    # svd_jacobi kept as the secondary (rank-revealing, no QR in front).
    jac_metrics = {}
    try:
        from svdsolver_tpu import svd_jacobi, svd_jacobi_pre

        JN = 512
        # 6 decades: the fp32 limit (12-decade relative accuracy needs
        # f64 — demonstrated in tests/test_jacobi.py)
        g = rng.normal(size=(JN, JN)) @ np.diag(np.logspace(0, -6, JN))
        Aj = jnp.asarray(g.astype(np.float32))
        refj = np.linalg.svd(np.asarray(Aj, np.float64), compute_uv=False)
        for name, fn in (("jacobi_pre", svd_jacobi_pre), ("jacobi", svd_jacobi)):
            out = fn(Aj)
            jax.block_until_ready(out)
            jac_s = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                for _ in range(2):
                    out = fn(Aj)
                jax.block_until_ready(out)
                jac_s = min(jac_s, (time.perf_counter() - t0) / 2)
            jac_err = float(np.max(np.abs(np.asarray(out[1]) - refj) / refj))
            jac_metrics[f"{name}_graded6dec_N{JN}_s"] = round(jac_s, 4)
            jac_metrics[f"{name}_graded6dec_max_RELATIVE_err"] = float(
                f"{jac_err:.3e}"
            )
            print(
                f"{name} graded {JN}^2: {jac_s:.3f}s max RELATIVE err "
                f"{jac_err:.2e}",
                file=sys.stderr,
            )
    except Exception as exc:
        print(f"jacobi bench failed: {exc}", file=sys.stderr)
        failed.append("jacobi")

    # ---- complex SVD (split re/im pairs) ----------------------------------
    # Loop-timed on device-resident (re, im) pairs: host numpy complex
    # in/out would add two big transfers per call.
    cx_s = cx_err = None
    try:
        from svdsolver_tpu.models.complex_svd import svd_c

        CN = 512
        Ac = (
            rng.normal(size=(CN, CN)) + 1j * rng.normal(size=(CN, CN))
        ).astype(np.complex64)
        pair = (
            jnp.asarray(Ac.real.astype(np.float32)),
            jnp.asarray(Ac.imag.astype(np.float32)),
        )
        Uc, sc, Vhc = svd_c(pair)  # compile
        jax.block_until_ready(sc)
        cx_s = float("inf")
        cx_loop = 3
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(cx_loop):
                Uc, sc, Vhc = svd_c(pair)
            jax.block_until_ready(sc)
            cx_s = min(cx_s, (time.perf_counter() - t0) / cx_loop)
        Un = np.asarray(Uc[0]) + 1j * np.asarray(Uc[1])
        Vn = np.asarray(Vhc[0]) + 1j * np.asarray(Vhc[1])
        cx_err = float(
            np.abs(Un @ np.diag(np.asarray(sc)) @ Vn - Ac).max()
            / np.abs(Ac).max()
        )
        print(
            f"complex svd {CN}^2 (device pairs, loop-timed): {cx_s:.3f}s "
            f"recon {cx_err:.2e}",
            file=sys.stderr,
        )
    except Exception as exc:
        print(f"complex bench failed: {exc}", file=sys.stderr)
        failed.append("complex")

    line = {
        "metric": f"stage1_dense_to_band_N{N}_band{BAND}_fp32_wallclock",
        "value": round(t, 4),
        "unit": "seconds",
        "vs_baseline": round(BASELINE_S / t, 2),
        "stage1_tflops": round(gflops / 1e3, 2),
    }
    if ns_s is not None:
        line["northstar_svdvals_N3840_fp32_s"] = round(ns_s, 4)
        line["northstar_max_rel_err_vs_lapack"] = float(f"{ns_err:.3e}")
    if sc_s is not None:
        line["svdvals_N7680_fp32_s"] = round(sc_s, 4)
    line.update(pipe_metrics)
    line.update(svd_metrics)
    line.update(jac_metrics)
    if cx_s is not None:
        line["complex_svd_N512_s"] = round(cx_s, 4)
        line["complex_svd_N512_recon_rel_err"] = float(f"{cx_err:.3e}")
    print(json.dumps(line))
    if failed:
        print(f"failed sections: {failed}", file=sys.stderr)
        sys.exit(1)


def _median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


if __name__ == "__main__":
    main()
