"""Top-level singular-value driver: model dispatch over the capability ladder.

The reference exposes its four implementations through CLI model names
(svd_cpu.cpp:143-162: base | singlecore | multicore | diagonal, plus the CUDA
drivers).  Here the same ladder is a single ``svdvals`` entry point with a
``method`` switch; every path is jit-compiled end-to-end.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from svdsolver_tpu.models.golub_kahan import bidiagonalize_gk
from svdsolver_tpu.models.blocked import bidiagonalize_blocked
from svdsolver_tpu.models.two_stage import dense_to_band, band_to_bidiagonal
from svdsolver_tpu.models.tiled import dense_to_band_tiled
from svdsolver_tpu.models.diagonalize import bidiagonal_svdvals, dqds_svdvals
from svdsolver_tpu.ops import dispatch

METHODS = ("base", "singlecore", "multicore", "tpu1", "tpu2")


class Bidiagonal(NamedTuple):
    """Bidiagonal factor {d, e} (reference: svd_serial.h:79-125)."""

    d: jnp.ndarray
    e: jnp.ndarray


def _pad_to_multiple(A, b):
    n = A.shape[0]
    r = (-n) % b
    if r == 0:
        return A, n
    return jnp.pad(A, ((0, r), (0, r))), n


def _auto_block(n):
    """Band/panel width: wider bands shrink the sequential bulge-chase step
    count (n^2/b steps) and fatten the Stage-I GEMMs, at the price of more
    work per chase window and longer compiles."""
    if n >= 1024:
        return 128
    if n >= 256:
        return 64
    return 32


def bidiagonalize(A, method="tpu2", block=None):
    """Reduce ``A`` to bidiagonal form with the chosen model; returns Bidiagonal.

    base       : Golub-Kahan, unblocked           (reference `brd`)
    singlecore : blocked one-stage compact-WY     (reference `block_brd`)
    multicore / tpu1 / tpu2 : two-stage band reduction + bulge chase
                 (reference `brd_p1`+`brd_p2` / `cuda_brd_p1`).  multicore
                 runs the reference's tiled Stage-I schedule; tpu1 and tpu2
                 are two names for the same panel-sweep path.

    ``block=None`` auto-selects the band/panel width by problem size.
    """
    if block is None:
        block = _auto_block(A.shape[0])
    if method == "base":
        d, e = bidiagonalize_gk(A)
    elif method == "singlecore":
        d, e = bidiagonalize_blocked(A, panel=block)
    elif method in ("multicore", "tpu1", "tpu2"):
        Ap, n = _pad_to_multiple(A, block)
        if method == "multicore":
            # the reference's tiled TS-QR schedule (brd_p1, svd_parallel.h)
            Ab = dense_to_band_tiled(Ap, band=block)
        else:
            # the panel-sweep schedule of its CUDA drivers (cuda_brd_p1)
            Ab = dense_to_band(Ap, band=block)
        d, e = band_to_bidiagonal(Ab, band=block)
        d, e = d[:n], e[: n - 1]
    else:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    return Bidiagonal(d, e)


def svdvals(A, method="tpu2", block=None, diag="bisect"):
    """Singular values of ``A`` (any shape), sorted descending.

    End-to-end: bidiagonalize with the chosen model, then diagonalize.
    ``diag``: 'bisect' (default — all values bisected in parallel), 'qr'
    (the reference's implicit-shift QR with deflation, svd_serial.h:368),
    or 'dqds' (Fernando-Parlett differential qd — high relative accuracy
    on graded spectra, with bisection fallback).

    Rectangular inputs are first reduced to a square triangular factor by a
    one-sided QR/LQ (sigma-preserving), then run through the square pipeline
    — the standard tall-matrix preprocessing the reference lacks (its
    two-stage models require square inputs).
    """
    import numpy as _np

    if _np.iscomplexobj(A):  # host numpy complex: split (re, im) pipeline
        if method != "tpu2" or diag != "bisect":
            raise ValueError(
                "complex input supports only method='tpu2', diag='bisect' "
                f"(got method={method!r}, diag={diag!r}); call "
                "svdsolver_tpu.models.complex_svd.svdvals_c directly"
            )
        from svdsolver_tpu.models.complex_svd import svdvals_c

        return svdvals_c(A)
    m, n = A.shape
    if m != n:
        if m < n:
            A = A.T
            m, n = n, m
        A = jnp.linalg.qr(A, mode="r")[:n, :n]
    B = bidiagonalize(A, method=method, block=block)
    if diag == "bisect":
        return dispatch.bisect_svdvals(B.d, B.e)[:n]
    elif diag == "qr":
        return bidiagonal_svdvals(B.d, B.e)[:n]
    elif diag == "dqds":
        return dqds_svdvals(B.d, B.e)[:n]
    raise ValueError(f"unknown diag {diag!r}; 'bisect', 'qr' or 'dqds'")


def svdvals_batch(As, block=None):
    """Singular values of a batch of square matrices: (B, n, n) -> (B, n).

    Single-device batched execution (vmapped two-stage + bisection); for
    multi-chip sharded batches use parallel.distributed.svdvals_batch_sharded.
    """
    n = As.shape[-1]
    if block is None:
        block = _auto_block(n)

    def one(A):
        Ap, _ = _pad_to_multiple(A, block)
        Ab = dense_to_band(Ap, band=block)
        d, e = band_to_bidiagonal(Ab, band=block)
        return dispatch.bisect_svdvals(d, e)[:n]

    return jax.vmap(one)(As)
