"""Tracing/profiling utilities.

The reference has no profiling subsystem beyond chrono timers (SURVEY §5;
its ``-lprofiler`` flag is commented out at CMakeLists.txt:15).  Here:

* :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable device trace;
* :func:`stage_timings` — per-stage wall-clock breakdown of the values-only
  pipeline, each stage fenced with ``jax.block_until_ready``.
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir):
    """Capture a device profiler trace: ``with trace('/tmp/t'): run()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def stage_timings(A, band=None, diag="bisect", warmup=True, reps=5):
    """Per-stage seconds for the two-stage pipeline on ``A``; returns a dict.

    Stages: dense->band, band->bidiagonal, diagonalization — the same calls
    :func:`svdsolver_tpu.svdvals` makes.  The first call per shape compiles;
    ``warmup=True`` excludes compilation.  Each stage is timed as a
    ``reps``-call back-to-back loop with one final fence, reporting seconds
    per call.
    """
    import jax.numpy as jnp

    from svdsolver_tpu.models.svd import _auto_block
    from svdsolver_tpu.models.two_stage import dense_to_band, band_to_bidiagonal
    from svdsolver_tpu.models.diagonalize import bidiagonal_svdvals
    from svdsolver_tpu.ops import dispatch

    n = A.shape[0]
    band = band or _auto_block(n)
    pad = (-n) % band
    if pad:
        A = jnp.pad(A, ((0, pad), (0, pad)))

    stage1 = dense_to_band
    stage2 = band_to_bidiagonal
    solver = bidiagonal_svdvals if diag == "qr" else dispatch.bisect_svdvals

    out = {}
    if warmup:
        Ab = jax.block_until_ready(stage1(A, band=band))
        jax.block_until_ready(solver(*stage2(Ab, band=band)))
    reps = max(1, int(reps))

    def loop_time(fn):
        t0 = time.perf_counter()
        r = None
        for _ in range(reps):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / reps

    Ab = jax.block_until_ready(stage1(A, band=band))
    out["stage1_dense_to_band_s"] = loop_time(
        lambda: stage1(A, band=band)
    )
    d, e = jax.block_until_ready(stage2(Ab, band=band))
    out["stage2_band_to_bidiagonal_s"] = loop_time(
        lambda: stage2(Ab, band=band)
    )
    out["diagonalization_s"] = loop_time(lambda: solver(d, e))
    out["total_s"] = sum(out.values())
    out["band"] = band
    return out
