"""Benchmark timing harness (reference: timing.h:23-91).

The reference times a ``for_each`` over pre-generated instances with
``std::chrono::steady_clock`` and reports the mean microseconds per instance.
Here the same protocol, adapted to an async device runtime: every result is
fenced with ``jax.block_until_ready`` so device execution is fully counted,
and the first (compile) call can be excluded — XLA compiles once per shape,
which has no CUDA analogue and would otherwise dominate small sweeps.
"""

import time

import jax


def benchmark(fn, instances, *args, warmup=True):
    """Mean seconds per call of ``fn(instance, *args)`` over ``instances``.

    ``warmup=True`` runs the first instance once beforehand (uncounted) so
    compilation is excluded, mirroring steady-state per-instance cost.
    """
    if warmup and len(instances) > 0:
        jax.block_until_ready(fn(instances[0], *args))
    t0 = time.perf_counter()
    for inst in instances:
        jax.block_until_ready(fn(inst, *args))
    return (time.perf_counter() - t0) / max(len(instances), 1)


def benchmark_each(fn, instances, *args, warmup=True):
    """Per-instance timing variant (reference: timing.h:55-91 overload);
    returns (mean_seconds, list_of_seconds)."""
    if warmup and len(instances) > 0:
        jax.block_until_ready(fn(instances[0], *args))
    times = []
    for inst in instances:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(inst, *args))
        times.append(time.perf_counter() - t0)
    mean = sum(times) / max(len(times), 1)
    return mean, times
