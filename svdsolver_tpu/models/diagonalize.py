"""Bidiagonal -> singular values: implicit zero-shift QR (Demmel-Kahan 1990).

Capability parity with the reference's ``impl_zero_shift`` (svd_serial.h:314),
``diag_reduce_fixed_iter`` (svd_serial.h:348), ``qrd`` (svd_serial.h:368) and
``Criteria`` (svd_serial.h:137), rebuilt for XLA's static-shape world:

* the Givens chain of one sweep is a ``lax.fori_loop`` with scalar carries
  (traced dynamic ``lo``/``hi`` bounds restrict it to the active block);
* the reference's dynamic sub-block slicing (svd_serial.h:408) becomes a
  vectorized deflation-window computation over the full ``e`` vector;
* convergence uses the Demmel-Kahan lower-bound recurrences via ``lax.scan``
  with dtype-correct ``eps`` (the reference hardcodes 1e-8 and has the
  ``500*n^2``-is-XOR bug at svd_serial.h:164 — not replicated).
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from svdsolver_tpu.ops.givens import givens


def zero_shift_sweep(d, e, lo=None, hi=None):
    """One Demmel-Kahan implicit zero-shift QR sweep over ``d[lo:hi+1]``.

    ``d``: diagonal (length n); ``e``: superdiagonal (length n-1).
    ``lo``/``hi`` (inclusive d-indices, default full range) bound the
    unreduced block; they may be traced values.

    Recurrence as in the reference (svd_serial.h:318-333):
        rot  = givens(c * d[k], e[k]);     e[k-1] = r * s_   (k > lo)
        rot_ = givens(c_ * r, d[k+1] * s); d[k]   = r_
    finalized with  h = c*d[hi];  e[hi-1] = h*s_;  d[hi] = h*c_.
    """
    n = d.shape[0]
    dtype = d.dtype
    if lo is None:
        lo = 0
    if hi is None:
        hi = n - 1
    lo = jnp.asarray(lo, jnp.int32)
    hi = jnp.asarray(hi, jnp.int32)
    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)

    def body(k, carry):
        d, e, c, s, c_, s_ = carry
        c1, s1, r1 = givens(c * d[k], e[k])
        km1 = jnp.maximum(k - 1, 0)
        e = e.at[km1].set(jnp.where(k > lo, r1 * s_, e[km1]))
        c2, s2, r2 = givens(c_ * r1, d[k + 1] * s1)
        d = d.at[k].set(r2)
        return d, e, c1, s1, c2, s2

    d, e, c, s, c_, s_ = lax.fori_loop(lo, hi, body, (d, e, one, zero, one, zero))
    h = c * d[hi]
    him1 = jnp.maximum(hi - 1, 0)
    valid = hi > lo
    e = e.at[him1].set(jnp.where(valid, h * s_, e[him1]))
    d = d.at[hi].set(jnp.where(valid, h * c_, d[hi]))
    return d, e


def diag_reduce_fixed_iter(d, e, n_iter=200):
    """``n_iter`` unconditional full sweeps (reference: svd_serial.h:348-353).

    Benchmark-only variant; use :func:`bidiagonal_svdvals` for convergence.
    """

    def body(_, de):
        return zero_shift_sweep(*de)

    return lax.fori_loop(0, n_iter, body, (d, e))


def convergence_threshold(d, e, tol_factor=100.0):
    """Demmel-Kahan deflation threshold (reference: Criteria, svd_serial.h:137).

    Computes the lambda/mu singular-value lower-bound recurrences (DK 1990,
    p.20) with ``lax.scan`` and returns ``max(tol * lbound, tiny)`` where
    ``tol = tol_factor * eps(dtype)``.
    """
    dtype = d.dtype
    ad = jnp.abs(d)
    ae = jnp.abs(e)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def mu_step(mu, de):
        adj, aej = de
        mu_next = adj * (mu / (mu + aej))
        return mu_next, mu_next

    # mu[0] = |d[0]|; mu[j+1] = |d[j+1]| * mu[j] / (mu[j] + |e[j]|)
    _, mus = lax.scan(mu_step, ad[0], (ad[1:], ae))
    # lambda[n-1] = |d[n-1]|; lambda[j] = |d[j]| * lam[j+1] / (lam[j+1] + |e[j]|)
    _, lams = lax.scan(mu_step, ad[-1], (ad[:-1][::-1], ae[::-1]))
    lbound = jnp.minimum(
        jnp.minimum(jnp.min(mus), ad[0]), jnp.minimum(jnp.min(lams), ad[-1])
    )
    tol = jnp.asarray(tol_factor, dtype) * eps
    # Absolute floor: sigma_min of a random bidiagonal is EXPONENTIALLY
    # small in n, so tol*lbound underflows past any value the fp32/f64
    # sweeps can resolve (measured 1.7e-20 at n=1280 fp32) and deflation
    # then relies on literal underflow — the bottom block can stall for
    # thousands of sweeps.  The sweeps' own roundoff bounds attainable
    # accuracy at ~eps*||B||, so deflating at half that loses nothing
    # real (Weyl: total perturbation <= ||sum of zeroed entries||_2
    # ~ sqrt(n)*eps*||B||); the reference's Criteria carries an absolute
    # floor too (the max_iter*umin term, svd_serial.h:164 — with its XOR
    # bug it lands near 1e-4).
    smax_b = jnp.max(ad) + jnp.max(jnp.concatenate([ae, ae[:1] * 0]))
    floor = 0.5 * eps * smax_b
    return jnp.maximum(jnp.maximum(tol * lbound, floor), tiny)


def _sigma_min_2x2(f, g, h):
    """Smaller singular value of ``[[f, g], [0, h]]`` (LAPACK ``dlas2``-style,
    branchless).  Used for the Wilkinson-style shift of the implicit QR step."""
    dtype = jnp.result_type(f, g, h)
    fa, ga, ha = jnp.abs(f), jnp.abs(g), jnp.abs(h)
    fhmn = jnp.minimum(fa, ha)
    fhmx = jnp.maximum(fa, ha)
    one = jnp.ones((), dtype)
    safe_fhmx = jnp.where(fhmx == 0, one, fhmx)
    safe_ga = jnp.where(ga == 0, one, ga)
    # branch ga <= fhmx
    as_ = 1 + fhmn / safe_fhmx
    at = (fhmx - fhmn) / safe_fhmx
    au1 = (ga / safe_fhmx) ** 2
    c1 = 2 / (jnp.sqrt(as_ * as_ + au1) + jnp.sqrt(at * at + au1))
    ss1 = fhmn * c1
    # branch ga > fhmx
    au2 = fhmx / safe_ga
    c2 = 1 / (jnp.sqrt(1 + (as_ * au2) ** 2) + jnp.sqrt(1 + (at * au2) ** 2))
    ss2 = jnp.where(au2 == 0, fhmn * fhmx / safe_ga, (fhmn * c2) * au2 * 2)
    ssmin = jnp.where(ga <= fhmx, ss1, ss2)
    return jnp.where(fhmn == 0, jnp.zeros((), dtype), ssmin)


def shifted_sweep(d, e, lo, hi, shift):
    """One implicit-shift QR sweep (Golub-Kahan SVD step) on ``d[lo:hi+1]``.

    The chasing recurrence follows LAPACK ``dbdsqr``'s shifted forward path;
    like :func:`zero_shift_sweep` it runs as a ``lax.fori_loop`` with scalar
    carries and traced block bounds."""
    n = d.shape[0]
    dtype = d.dtype
    lo = jnp.asarray(lo, jnp.int32)
    hi = jnp.asarray(hi, jnp.int32)
    dl = d[lo]
    sgn = jnp.where(dl >= 0, jnp.ones((), dtype), -jnp.ones((), dtype))
    safe_dl = jnp.where(dl == 0, jnp.ones((), dtype), dl)
    f0 = (jnp.abs(dl) - shift) * (sgn + shift / safe_dl)
    g0 = e[lo]

    def body(i, carry):
        d, e, f, g = carry
        cosr, sinr, r = givens(f, g)
        im1 = jnp.maximum(i - 1, 0)
        e = e.at[im1].set(jnp.where(i > lo, r, e[im1]))
        f2 = cosr * d[i] + sinr * e[i]
        e = e.at[i].set(cosr * e[i] - sinr * d[i])
        g2 = sinr * d[i + 1]
        d = d.at[i + 1].set(cosr * d[i + 1])
        cosl, sinl, r2 = givens(f2, g2)
        d = d.at[i].set(r2)
        f3 = cosl * e[i] + sinl * d[i + 1]
        d = d.at[i + 1].set(cosl * d[i + 1] - sinl * e[i])
        ip1 = jnp.minimum(i + 1, n - 2)
        g3 = jnp.where(i < hi - 1, sinl * e[ip1], jnp.zeros((), dtype))
        e = e.at[ip1].set(jnp.where(i < hi - 1, cosl * e[ip1], e[ip1]))
        return d, e, f3, g3

    d, e, f, _ = lax.fori_loop(lo, hi, body, (d, e, f0, g0))
    him1 = jnp.maximum(hi - 1, 0)
    e = e.at[him1].set(jnp.where(hi > lo, f, e[him1]))
    return d, e


@functools.partial(jax.jit, static_argnames=("max_sweeps",))
def _qr_diag_chunk(d, e, thresh, max_sweeps):
    """Up to ``max_sweeps`` QR deflation sweeps on {d, e} (threshold fixed
    by the caller); returns ``(d, e, converged)``.  The resumable inner
    step of :func:`bidiagonal_svdvals`'s chunked driver."""
    n = d.shape[0]
    dtype = d.dtype
    idx = jnp.arange(n - 1, dtype=jnp.int32)

    def cond(carry):
        d, e, it = carry
        return jnp.logical_and(it < max_sweeps, jnp.any(jnp.abs(e) > thresh))

    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    def body(carry):
        d, e, it = carry
        live = jnp.abs(e) > thresh
        e = jnp.where(live, e, jnp.zeros((), dtype))
        # hi: last live superdiagonal index; block spans d[lo .. hi+1].
        hi_e = jnp.max(jnp.where(live, idx, -1))
        dead_below = jnp.logical_and(idx < hi_e, jnp.logical_not(live))
        lo = jnp.max(jnp.where(dead_below, idx + 1, 0))
        hi = hi_e + 1
        # Shift from the bottom 2x2; zeroed when it would spoil relative
        # accuracy (LAPACK dbdsqr's test: (shift/|d[lo]|)^2 < eps).
        shift = _sigma_min_2x2(d[jnp.maximum(hi - 1, 0)], e[hi_e], d[hi])
        sll = jnp.abs(d[lo])
        safe_sll = jnp.where(sll == 0, jnp.ones((), dtype), sll)
        use_zero = jnp.logical_or(sll == 0, (shift / safe_sll) ** 2 < eps)
        d, e = lax.cond(
            use_zero,
            lambda d, e: zero_shift_sweep(d, e, lo, hi),
            lambda d, e: shifted_sweep(d, e, lo, hi, shift),
            d,
            e,
        )
        return d, e, it + 1

    d, e, _ = lax.while_loop(cond, body, (d, e, jnp.int32(0)))
    converged = jnp.logical_not(jnp.any(jnp.abs(e) > thresh))
    return d, e, converged


@jax.jit
def _qr_diag_thresh(d, e):
    return convergence_threshold(d, e)


def bidiagonal_svdvals(d, e, max_sweeps=None, chunk_sweeps=None):
    """Singular values of the bidiagonal matrix {d, e}, sorted descending.

    Convergent QR diagonalization with deflation — the reference's ``qrd``
    (svd_serial.h:367-422) as a ``lax.while_loop``:

    * negligible ``|e[i]| <= threshold`` entries are hard-zeroed (deflation);
    * the bottom-most unreduced block ``[lo, hi]`` is located with vectorized
      index arithmetic instead of the reference's scan-and-slice;
    * one zero-shift sweep runs on that block per iteration.

    The sweeps run in host-driven CHUNKS of ``chunk_sweeps`` (auto-sized
    to a bounded amount of work per chunk): this algorithm is O(n) sweeps
    of O(n) sequential Givens — the honest O(n^2) curve the reference's
    ``diagonal`` benchmark records — and one device program of that length
    cannot be interrupted, while chunks let the host stop as soon as the
    bidiagonal has converged.  Under a jit trace the host loop degenerates
    to one full-length chunk.
    """
    n = d.shape[0]
    if n == 1:
        return jnp.abs(d)
    if max_sweeps is None:
        max_sweeps = 30 * n
    import jax.core as _core

    tracing = isinstance(d, _core.Tracer) or isinstance(e, _core.Tracer)
    if chunk_sweeps is None:
        # bounded work per compiled program: ~1.2e6 / n sweeps of O(n) each
        chunk_sweeps = max(128, min(1024, int(1.2e6) // max(n, 1)))
    thresh = _qr_diag_thresh(d, e)
    if tracing or chunk_sweeps >= max_sweeps:
        d, e, _ = _qr_diag_chunk(d, e, thresh, max_sweeps=int(max_sweeps))
        return jnp.sort(jnp.abs(d))[::-1]
    done = 0
    while done < max_sweeps:
        k = min(int(chunk_sweeps), int(max_sweeps) - done)
        d, e, converged = _qr_diag_chunk(d, e, thresh, max_sweeps=k)
        done += k
        if bool(converged):
            break
    return jnp.sort(jnp.abs(d))[::-1]


@functools.partial(jax.jit, static_argnames=("max_sweeps", "with_info"))
def dqds_svdvals(d, e, max_sweeps=None, with_info=False):
    """Singular values by differential qd with shifts (Fernando-Parlett
    dqds — the LAPACK ``dlasq`` algorithm class), sorted descending.

    The second high-accuracy diagonalizer beside :func:`bisect_svdvals`:
    dqds carries only positive quantities, so it reaches HIGH RELATIVE
    accuracy on graded spectra (validated at condition 1e12: max relative
    error ~4e-13 where the fixed-count bisection's absolute bracket gives
    ~1e-8 on the smallest values).  Like the QR path it is a sequential
    sweep recurrence — kept for accuracy parity, not speed; the default
    remains bisection.

    Works on scaled q = d^2, ee = e^2.  Per iteration: hard-zero negligible
    off-diagonals and SPLIT at the bottom-most zero (dlasq2-style — the
    active window then takes block-local shifts; without splitting, a tiny
    interior E pins dmin far below the bottom eigenvalue and the chase
    crawls at ~47 zero-ish-shift sweeps per eigenvalue, accumulating
    rounding — measured on a random 120-spectrum: 5594 sweeps / rel 5e-6
    before, 1295 sweeps / rel 3e-15 after), run the dlasq3-style deflation
    loop, optionally reverse the window, then one dqds sweep:

    * DEFLATION (dlasq3 labels 20/40): strip the window bottom until
      nothing fires — 1-eigenvalue when ``E[hi-1]`` is negligible against
      ``tol2*(sigma + q[hi])`` or ``tol2*q[hi-1]`` (tol = 100 eps), and
      2-eigenvalue EXACT when ``E[hi-2]`` is negligible or the window has
      exactly two entries: the trailing 2x2's eigenvalues are computed in
      closed form (stable quadratic on qd quantities) and both deflate at
      zero sweep cost.
    * REVERSAL (dlasq2's CBIAS flip): deflation only happens at the
      bottom, so a window ordered with large values there
      (``1.5*q[lo] < q[hi]``) is flipped in place — otherwise an
      interior/top minimum caps every shift and the battery degenerates
      to weak case-6 ``g*dmin`` shifts.
    * SHIFT: the full LAPACK dlasq4 case battery (ttypes -2..-12),
      dispatched on how many eigenvalues deflated since the previous
      sweep (0/1/2 — after deflation, ``dmin1``/``dmin2`` proxy the
      shrunk window) and where the previous sweep attained its minimum
      pivot (``dn``/``dn1``/``dn2``), including the Rayleigh-quotient
      residual norm loops of cases 4/5/7/10 and the case-6 G history.
      Departure, documented: LAPACK reads a few leading norm-estimate
      terms from the ping-pong ALTERNATE (q, e) copy; this implementation
      is single-copy and uses current values — shift quality heuristics
      only, never correctness.
    * A sweep that breaks positivity or overflows is NOT discarded to
      zero-shift immediately: the failed sweep's negative ``dmin`` bounds
      the overshoot, so retry once with ``tau <- max(0, tau + dmin_fail)``
      (LAPACK dlasq3's ``TAU = TAU + DMIN`` failure correction, which keeps
      most of the aggressive shift); only if that also fails fall back to
      ``tau = 0`` (plain dqd).
    * If even the zero-shift sweep fails (interior splits with vanishing
      pivots), the sweep cap is hit, or NO deflation lands for 60
      consecutive sweeps, the routine FALLS BACK to extended-iteration
      bisection — normwise accuracy is therefore always delivered, and the
      fallback measures both faster and more accurate than a stalled dqds.

    ``with_info``: also return the sweep count (convergence diagnostics);
    ``with_info="debug"`` additionally returns the ttype histogram.

    Measured accuracy (f64): max RELATIVE error ~1e-14 across random,
    uniform, graded (cond 1e12), clustered, and explicitly-split spectra —
    LAPACK-grade.  Sweep counts on the recorded stall-class spectrum
    (random n=120, seed 0): 5594 (pre-splitting) -> 1293 (round-2
    battery) -> 1028 (twisted-case split) -> 865 (this battery) — vs
    LAPACK dlasq2's own 877 on the identical spectrum (measured via
    ctypes, scripts/probe_dqds.py; across the 6-spectrum battery: 6165
    here vs 5985 dlasq2, within 3%).  Gated by a regression test at
    LAPACK-parity class (<= 900).
    """
    n = d.shape[0]
    dtype = d.dtype
    if n == 1:
        return jnp.abs(d)
    if max_sweeps is None:
        max_sweeps = 60 * n
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    zero = jnp.zeros((), dtype)
    scale = jnp.maximum(jnp.max(jnp.abs(d)), jnp.max(jnp.abs(e)))
    scale = jnp.where(scale == 0, jnp.ones((), dtype), scale)
    q0 = (d / scale) * (d / scale)
    E0 = jnp.pad((e / scale) * (e / scale), (0, 1))  # E[n-1] unused (kept 0)
    idx = jnp.arange(n, dtype=jnp.int32)

    def sweep(q, E, lo, hi, tau):
        """One dqds sweep over the active WINDOW [lo, hi]; returns
        (q', E', dmin, dn, dmin1, dn1, dmin2, dn2, ok) with ``dn`` the final
        (bottom) pivot, ``dn1``/``dn2`` the second-/third-to-last pivots,
        and ``dmin1``/``dmin2`` the minimum pivots EXCLUDING the last one /
        two positions — the dlasq4/dlasq5 auxiliary quantities the shift
        selection dispatches on."""
        dd0 = q[lo] - tau

        def step(i, carry):
            dd, q, E, dmin, dmin1, dmin2, dn1, dn2, ok = carry
            active = jnp.logical_and(i >= lo, i < hi)
            qq = dd + E[i]
            safe_qq = jnp.where(qq == 0, tiny, qq)
            t = q[i + 1] / safe_qq
            een = E[i] * t
            ddn = dd * t - tau
            q = q.at[i].set(jnp.where(active, qq, q[i]))
            E = E.at[i].set(jnp.where(active, een, E[i]))
            dmin = jnp.where(active, jnp.minimum(dmin, ddn), dmin)
            # pivot at position i+1: exclude the bottom (i+1 == hi) from
            # dmin1, the bottom two from dmin2; record dn1/dn2 at hi-1/hi-2
            interior = jnp.logical_and(active, i < hi - 1)
            dmin1 = jnp.where(interior, jnp.minimum(dmin1, ddn), dmin1)
            interior2 = jnp.logical_and(active, i < hi - 2)
            dmin2 = jnp.where(interior2, jnp.minimum(dmin2, ddn), dmin2)
            dn1 = jnp.where(i == hi - 2, ddn, dn1)
            dn2 = jnp.where(i == hi - 3, ddn, dn2)
            ok = jnp.logical_and(
                ok, jnp.logical_or(~active, qq > 0)
            )
            dd = jnp.where(active, ddn, dd)
            return dd, q, E, dmin, dmin1, dmin2, dn1, dn2, ok

        dd, q, E, dmin, dmin1, dmin2, dn1, dn2, ok = lax.fori_loop(
            0, n - 1, step,
            (dd0, q, E, dd0, dd0, dd0, dd0, dd0, jnp.bool_(True)),
        )
        q = jnp.where(idx == hi, dd, q)  # q[hi] <- final dd (traced index)
        dmin = jnp.minimum(dmin, dd)
        ok = jnp.logical_and(ok, jnp.logical_and(dmin >= 0, jnp.isfinite(dd)))
        return q, E, dmin, dd, dmin1, dn1, dmin2, dn2, ok

    # dlasq4 magic constants (LAPACK dlasq4.f): CNST1 = 9/16 bounds the
    # Rayleigh-residual norm estimate below which the refined shift is
    # trusted; CNST2/CNST3 are its safety inflation factors.
    CNST1 = jnp.asarray(0.5625, dtype)
    CNST2 = jnp.asarray(1.01, dtype)
    CNST3 = jnp.asarray(1.05, dtype)

    def cond(st):
        hi, it, stuck = st[2], st[12], st[15]
        return jnp.logical_and(
            jnp.logical_and(hi >= 0, it < max_sweeps), ~stuck
        )

    def body(st):
        (
            q, E, hi, accv, dmin, dn, dm1, dn1v, dm2, dn2v, tt, g, it,
            since, out, stuck, th,
        ) = st
        hi_in = hi

        # ---- dlasq2-style SPLITTING: the active window's lower edge is one
        # past the bottom-most negligible interior E.  Without it, a tiny
        # interior E pins dmin near the small interior eigenvalue, capping
        # every shift far below the bottom eigenvalue — the bottom entries
        # then converge at zero-shift crawl speed (measured: 47 sweeps per
        # eigenvalue on a random 120-spectrum) while rounding accumulates.
        # Windowed sweeps let each split block take full-size shifts; accv
        # is the per-ENTRY accumulated shift (blocks see different shifts).
        # Splits are PERMANENT: negligible E are hard-zeroed (a relative
        # eps^2 perturbation in sigma^2 space, the same bound the deflation
        # test uses).  A zero E decouples the sweep recurrence exactly
        # (een = 0 and ddn = q[next] - tau at the boundary), so one sweep
        # remains a valid dqds transform of every sub-block; zeroing also
        # keeps the split declared as the window's q values shrink —
        # re-merging blocks whose entries carry different accumulated
        # shifts would corrupt the recurrence.
        # Negligibility is LAPACK dlasq2's: tol2*(sigma + q) with
        # tol = 100*eps, where sigma is the entry's ACCUMULATED shift (accv
        # — all eigenvalues of the window sit above it, so an E below
        # tol2*sigma perturbs every sigma^2 by < tol2 relative).  The
        # eps^2*q term covers the pre-shift phase (accv = 0).
        tol2 = (100 * eps) * (100 * eps)
        qnext = jnp.concatenate([q[1:], q[-1:]])
        eneg = jnp.logical_and(
            E
            <= tol2 * accv + eps * eps * jnp.maximum(q, qnext) + tiny,
            idx < hi,
        )
        E = jnp.where(eneg, zero, E)
        lo = jnp.max(jnp.where(eneg, idx + 1, 0))

        # ---- dlasq3-style deflation loop: keep stripping the bottom of
        # the window until nothing fires.  Two forms (LAPACK dlasq3
        # labels 20/40):
        #   * 1-eigenvalue: hi == lo (decoupled 1x1 — E[lo-1] was zeroed
        #     at the split) or E[hi-1] negligible against tol2*(sigma +
        #     q[hi]) OR tol2*q[hi-1] (both dlasq3 alternatives; sigma is
        #     the entry's accumulated shift, the eps^2 term covers the
        #     pre-shift phase).
        #   * 2-eigenvalue EXACT: a 2-entry window, or E[hi-2] negligible
        #     — the trailing 2x2's eigenvalues are computed in closed form
        #     (stable quadratic on qd quantities) and BOTH deflate at
        #     once, costing zero sweeps.  This is where dlasq2 resolves
        #     every window's last pair and most clusters.
        tol2 = (100 * eps) * (100 * eps)

        def defl_cond(c):
            return c[4]

        def defl_body(c):
            q, E, hi, out, _ = c
            him1 = jnp.maximum(hi - 1, 0)
            him2 = jnp.maximum(hi - 2, 0)
            neg1 = jnp.logical_or(
                E[him1] <= tol2 * (accv[hi] + q[hi]),
                E[him1] <= tol2 * q[him1],
            )
            neg1 = jnp.logical_or(
                neg1,
                E[him1]
                <= eps * eps * jnp.maximum(q[hi], q[him1]) + tiny,
            )
            fire1 = jnp.logical_and(
                hi >= 0, jnp.logical_or(hi == lo, neg1)
            )
            neg2 = jnp.logical_or(
                E[him2] <= tol2 * accv[hi], E[him2] <= tol2 * q[him2]
            )
            neg2 = jnp.logical_or(
                neg2,
                E[him2]
                <= eps * eps * jnp.maximum(q[him1], q[him2]) + tiny,
            )
            fire2 = jnp.logical_and(
                jnp.logical_and(hi - 1 >= lo, ~fire1),
                jnp.logical_or(hi - 1 == lo, neg2),
            )

            def apply1(args):
                q, E, hi, out = args
                out = jnp.where(idx == hi, q + accv, out)
                E = jnp.where(idx == him1, zero, E)
                return q, E, hi - 1, out

            def apply2(args):
                # exact trailing-2x2 deflation (dlasq3 label 40): order the
                # pair (bs <= as_), then the stable quadratic for the
                # smaller root of [[as_+ee, sqrt(as_*ee)],[., bs]].
                q, E, hi, out = args
                q1 = q[him1]
                q2 = q[hi]
                bs = jnp.minimum(q1, q2)
                as_ = jnp.maximum(q1, q2)
                ee = E[him1]
                t = 0.5 * ((as_ - bs) + ee)
                s0 = bs * (ee / jnp.maximum(t, tiny))
                s1 = jnp.where(
                    s0 <= t,
                    bs
                    * (
                        ee
                        / jnp.maximum(
                            t * (1 + jnp.sqrt(1 + s0 / jnp.maximum(t, tiny))),
                            tiny,
                        )
                    ),
                    bs
                    * (
                        ee
                        / jnp.maximum(
                            t + jnp.sqrt(t) * jnp.sqrt(t + s0), tiny
                        )
                    ),
                )
                tbig = as_ + (s1 + ee)
                refine = jnp.logical_and(ee > bs * tol2, t != 0)
                lam_small = jnp.where(
                    refine, bs * (as_ / jnp.maximum(tbig, tiny)), bs
                )
                lam_big = jnp.where(refine, tbig, as_)
                out = jnp.where(idx == hi, lam_small + accv, out)
                out = jnp.where(idx == him1, lam_big + accv, out)
                E = jnp.where(
                    jnp.logical_or(idx == him1, idx == him2), zero, E
                )
                return q, E, hi - 2, out

            q, E, hi, out = lax.cond(
                fire1,
                apply1,
                lambda args: lax.cond(
                    fire2, apply2, lambda a: a, args
                ),
                (q, E, hi, out),
            )
            return q, E, hi, out, jnp.logical_or(fire1, fire2)

        q, E, hi, out, _ = lax.while_loop(
            defl_cond, defl_body, (q, E, hi, out, jnp.bool_(True))
        )
        # progress guard (belt-and-braces beneath the splitting): if no
        # deflation lands for 60 consecutive sweeps, declare the run stuck;
        # the bisection safety net below measures BOTH faster and more
        # accurate than a stalled dqds.
        since = jnp.where(hi < hi_in, jnp.int32(0), since + 1)
        stuck = jnp.logical_or(stuck, since > 60)

        # ---- dlasq2-style qd-array REVERSAL: deflation only happens at
        # the bottom, so when the window is ordered with its large values
        # there (CBIAS*q[lo] < q[hi]), flip it — otherwise the interior/top
        # minimum caps every shift (long case-6 stretches of weak g*dmin
        # shifts; measured 204/826 passes on the stall spectrum before
        # this).  The 1.5 bias makes the flip self-limiting (1.5a < b and
        # 1.5b < a cannot both hold).  accv is uniform within a window, so
        # only q and E reverse; the previous sweep's pivot stats describe
        # the old orientation — reset them (next sweep is a plain dqd,
        # exactly how dlasq2 starts a freshly flipped block).
        do_flip = jnp.logical_and(hi - lo >= 2, 1.5 * q[lo] < q[hi])
        in_q = jnp.logical_and(idx >= lo, idx <= hi)
        in_E = jnp.logical_and(idx >= lo, idx <= hi - 1)
        rev_q = q[jnp.clip(lo + hi - idx, 0, n - 1)]
        rev_E = E[jnp.clip(lo + hi - 1 - idx, 0, n - 1)]
        q = jnp.where(jnp.logical_and(do_flip, in_q), rev_q, q)
        E = jnp.where(jnp.logical_and(do_flip, in_E), rev_E, E)
        dmin = jnp.where(do_flip, zero, dmin)
        dn = jnp.where(do_flip, zero, dn)
        dm1 = jnp.where(do_flip, zero, dm1)
        dn1v = jnp.where(do_flip, zero, dn1v)
        dm2 = jnp.where(do_flip, zero, dm2)
        dn2v = jnp.where(do_flip, zero, dn2v)
        tt = jnp.where(do_flip, jnp.int32(0), tt)

        def do_sweep(args):
            (
                q, E, hi, accv, dmin, dn, dm1, dn1v, dm2, dn2v, tt, g,
                stuck, th,
            ) = args
            # ---- shift selection: the full dlasq4 case battery ----------
            # (LAPACK dlasq4.f cases 2..12, dispatched on how many
            # eigenvalues deflated since the previous sweep and on where
            # the previous sweep attained its minimum pivot.  Departure,
            # documented: LAPACK reads a few leading terms of the norm
            # estimates from the ping-pong ALTERNATE copy of (q, e); this
            # implementation is single-copy and uses the current values —
            # the estimates are heuristic shift quality, never correctness,
            # and the dlasq3-style failure-correction retry backstops.)
            ndefl = jnp.minimum(hi_in - hi, jnp.int32(2))
            him1 = jnp.maximum(hi - 1, 0)
            him2 = jnp.maximum(hi - 2, 0)
            him3 = jnp.maximum(hi - 3, 0)

            def sq(x):
                return jnp.sqrt(jnp.maximum(x, zero))

            # "minimum pivot attained at the k-th-from-bottom position":
            # LAPACK's exact equality tests, under a 4-eps tolerance
            # (dminK <= dnJ holds by construction, so one-sided).
            at_dn = dn <= dmin * (1 + 4 * eps)
            at_dn1 = dn1v <= dmin * (1 + 4 * eps)
            at_dn2 = dn2v <= dmin * (1 + 4 * eps)
            m1_at = dn1v <= dm1 * (1 + 4 * eps)
            m2_at = dn2v <= dm2 * (1 + 4 * eps)

            def norm_tail(start, b0, a0):
                """dlasq4 'approximate contribution to norm squared': walk
                i = start..lo accumulating a += (b *= E[i]/q[i]); abort
                (valid=False -> caller keeps its fallback shift, LAPACK's
                RETURN) on any E[i] > q[i]; stop early once the sum has
                converged (100*max(b', b) < a) or exceeded CNST1."""

                def ncond(c):
                    return ~c[3]

                def nbody(c):
                    i, a, b, done, valid = c
                    j = jnp.maximum(i, 0)
                    qi = jnp.maximum(q[j], tiny)
                    Ei = E[j]
                    live = i >= lo
                    bad = jnp.logical_and(live, Ei > qi)
                    bn = b * (Ei / qi)
                    an = a + bn
                    stop = jnp.logical_or(
                        100.0 * jnp.maximum(bn, b) < an, an > CNST1
                    )
                    upd = jnp.logical_and(live, ~bad)
                    a = jnp.where(upd, an, a)
                    b = jnp.where(upd, bn, b)
                    done = jnp.logical_or(
                        ~live,
                        jnp.logical_or(bad, jnp.logical_or(stop, bn == 0)),
                    )
                    return i - 1, a, b, done, jnp.logical_and(valid, ~bad)

                _, a, _, _, valid = lax.while_loop(
                    ncond,
                    nbody,
                    (start, a0, b0, jnp.bool_(False), jnp.bool_(True)),
                )
                return a, valid

            def shift_nodefl(_):
                # no deflation since the previous sweep (dlasq4 N0IN == N0)
                def case23(_):
                    # cases 2/3: min at the bottom AND dmin1 at dn1 (the
                    # twisted asymptotic).  2x2-perturbation shift with a
                    # gap estimate refined through dmin2.
                    b1 = sq(q[hi]) * sq(E[him1])
                    b2 = sq(q[him1]) * sq(E[him2])
                    a2 = q[him1] + E[him1]
                    gap2 = dm2 - a2 - 0.25 * dm2
                    gap1 = jnp.where(
                        jnp.logical_and(gap2 > 0, gap2 > b2),
                        a2 - dn - (b2 / gap2) * b2,
                        a2 - dn - (b1 + b2),
                    )
                    s2 = jnp.maximum(
                        dn - (b1 / jnp.maximum(gap1, tiny)) * b1, 0.5 * dmin
                    )
                    s3 = jnp.where(dn > b1, dn - b1, zero)
                    s3 = jnp.where(
                        a2 > b1 + b2, jnp.minimum(s3, a2 - (b1 + b2)), s3
                    )
                    s3 = jnp.maximum(s3, dmin / 3)
                    use2 = jnp.logical_and(gap1 > 0, gap1 > b1)
                    return (
                        jnp.where(use2, s2, s3),
                        jnp.where(use2, jnp.int32(-2), jnp.int32(-3)),
                        g,
                    )

                def case4(_):
                    # case 4: min at dn (but dmin1 not at dn1) or at dn1 —
                    # Rayleigh-quotient residual bound via the norm tail.
                    gam = jnp.where(at_dn, dn, dn1v)
                    b2i = jnp.where(
                        at_dn,
                        E[him1] / jnp.maximum(q[him1], tiny),
                        E[him2] / jnp.maximum(q[him2], tiny),
                    )
                    a2i = jnp.where(
                        at_dn, b2i, E[him1] / jnp.maximum(q[hi], tiny) + b2i
                    )
                    start = jnp.where(at_dn, hi - 2, hi - 3)
                    pre_ok = jnp.where(
                        at_dn,
                        E[him1] <= q[him1],
                        jnp.logical_and(
                            E[him1] <= q[hi], E[him2] <= q[him2]
                        ),
                    )
                    a2f, valid = norm_tail(start, b2i, a2i)
                    a2f = CNST3 * a2f
                    ok = jnp.logical_and(
                        jnp.logical_and(pre_ok, valid), a2f < CNST1
                    )
                    s = jnp.where(
                        ok,
                        gam * (1 - jnp.sqrt(a2f)) / (1 + a2f),
                        0.25 * dmin,
                    )
                    return s, jnp.int32(-4), g

                def case5(_):
                    # case 5: min at dn2 — same residual bound, two rows up.
                    pre_ok = jnp.logical_and(
                        E[him2] <= q[him1], E[him1] <= q[hi]
                    )
                    a2i = (E[him1] / jnp.maximum(q[hi], tiny)) * (
                        1 + E[him2] / jnp.maximum(q[him1], tiny)
                    )

                    def tail(_):
                        b2i = E[him3] / jnp.maximum(q[him3], tiny)
                        a2f, valid = norm_tail(hi - 4, b2i, a2i + b2i)
                        return CNST3 * a2f, valid

                    a2f, valid = lax.cond(
                        hi - lo > 2,
                        tail,
                        lambda _: (a2i, jnp.bool_(True)),
                        None,
                    )
                    ok = jnp.logical_and(
                        jnp.logical_and(pre_ok, valid), a2f < CNST1
                    )
                    s = jnp.where(
                        ok,
                        dn2v * (1 - jnp.sqrt(a2f)) / (1 + a2f),
                        0.25 * dmin,
                    )
                    return s, jnp.int32(-5), g

                def case6(_):
                    # case 6: interior minimum, no structure to exploit —
                    # g*dmin with the dlasq4 G history (grows toward 1 on
                    # consecutive case-6 sweeps; resets cautious after a
                    # failure-corrected sweep, ttype -18).
                    gn = jnp.where(
                        tt == -6,
                        g + (1 - g) / 3,
                        jnp.where(
                            tt == -18,
                            jnp.asarray(1.0 / 12.0, dtype),
                            jnp.asarray(0.25, dtype),
                        ),
                    )
                    return gn * dmin, jnp.int32(-6), gn

                twisted = jnp.logical_and(at_dn, m1_at)
                return lax.cond(
                    jnp.logical_or(at_dn, at_dn1),
                    lambda _: lax.cond(twisted, case23, case4, None),
                    lambda _: lax.cond(at_dn2, case5, case6, None),
                    None,
                )

            def shift_one(_):
                # one eigenvalue deflated: dmin1/dn1 proxy the shrunk
                # window's dmin/dn (dlasq4 N0IN == N0 + 1, cases 7/8/9)
                def case78(_):
                    s0 = dm1 / 3
                    pre_ok = E[him1] <= q[him1]
                    b0 = E[him1] / jnp.maximum(q[him1], tiny)
                    a2f, valid = norm_tail(hi - 2, b0, b0)
                    b2s = jnp.sqrt(CNST3 * a2f)
                    a2v = dm1 / (1 + b2s * b2s)
                    gap2 = 0.5 * dm2 - a2v
                    wide = jnp.logical_and(gap2 > 0, gap2 > b2s * a2v)
                    ref = jnp.where(
                        wide,
                        a2v
                        * (
                            1
                            - CNST2
                            * a2v
                            * (b2s / jnp.maximum(gap2, tiny))
                            * b2s
                        ),
                        a2v * (1 - CNST2 * b2s),
                    )
                    s = jnp.where(
                        jnp.logical_and(pre_ok, valid),
                        jnp.maximum(s0, ref),
                        s0,
                    )
                    ttn = jnp.where(wide, jnp.int32(-7), jnp.int32(-8))
                    return s, ttn, g

                def case9(_):
                    return (
                        jnp.where(m1_at, 0.5 * dm1, 0.25 * dm1),
                        jnp.int32(-9),
                        g,
                    )

                return lax.cond(
                    jnp.logical_and(m1_at, m2_at), case78, case9, None
                )

            def shift_two(_):
                # two eigenvalues deflated: dmin2/dn2 are the proxies
                # (dlasq4 N0IN == N0 + 2, cases 10/11)
                def case10(_):
                    s0 = dm2 / 3
                    pre_ok = E[him1] <= q[him1]
                    b0 = E[him1] / jnp.maximum(q[him1], tiny)
                    a2f, valid = norm_tail(hi - 2, b0, b0)
                    b2s = jnp.sqrt(CNST3 * a2f)
                    a2v = dm2 / (1 + b2s * b2s)
                    gap2 = (
                        q[him1] + E[him2] - sq(q[him2]) * sq(E[him2]) - a2v
                    )
                    wide = jnp.logical_and(gap2 > 0, gap2 > b2s * a2v)
                    ref = jnp.where(
                        wide,
                        a2v
                        * (
                            1
                            - CNST2
                            * a2v
                            * (b2s / jnp.maximum(gap2, tiny))
                            * b2s
                        ),
                        a2v * (1 - CNST2 * b2s),
                    )
                    s = jnp.where(
                        jnp.logical_and(pre_ok, valid),
                        jnp.maximum(s0, ref),
                        s0,
                    )
                    return s, jnp.int32(-10), g

                def case11(_):
                    return 0.25 * dm2, jnp.int32(-11), g

                c10 = jnp.logical_and(m2_at, 2 * E[him1] < q[him1])
                return lax.cond(c10, case10, case11, None)

            tau, ttn, gn = lax.switch(
                ndefl, [shift_nodefl, shift_one, shift_two], None
            )
            # (2-entry windows never reach here: the deflation loop above
            # resolves them exactly, dlasq3-style, at zero sweep cost.)
            tau = jnp.maximum(zero, tau)
            q1, E1, dminP, dnP, dm1P, dn1P, dm2P, dn2P, ok = sweep(
                q, E, lo, hi, tau
            )

            def corrected(_):
                # dlasq3 failure correction: the failed sweep's (negative)
                # dmin bounds the overshoot, so tau + dmin is a safe-side
                # estimate that keeps most of the aggressive shift.  A NaN
                # dmin (overflowed sweep) poisons tau2, which simply makes
                # this retry fail too and drops to the dqd below.  ttype
                # -18 records the failure so the next case-6 G is cautious.
                tau2 = jnp.maximum(zero, tau + dminP)
                r2 = sweep(q, E, lo, hi, tau2)

                def dqd(_):
                    r3 = sweep(q, E, lo, hi, zero)
                    return r3 + (zero, jnp.int32(0))

                return lax.cond(
                    r2[-1],
                    lambda _: r2 + (tau2, jnp.int32(-18)),
                    dqd,
                    None,
                )

            (
                q1, E1, dminP, dnP, dm1P, dn1P, dm2P, dn2P, ok, tau, ttn
            ) = lax.cond(
                ok,
                lambda _: (
                    q1, E1, dminP, dnP, dm1P, dn1P, dm2P, dn2P, ok, tau,
                    ttn,
                ),
                corrected,
                None,
            )
            # a failed zero-shift sweep means vanishing interior pivots:
            # keep the pre-sweep state and bail to the bisection fallback
            q1 = jnp.where(ok, q1, q)
            E1 = jnp.where(ok, E1, E)
            dminP = jnp.where(ok, dminP, dmin)
            dnP = jnp.where(ok, dnP, dn)
            dm1P = jnp.where(ok, dm1P, dm1)
            dn1P = jnp.where(ok, dn1P, dn1v)
            dm2P = jnp.where(ok, dm2P, dm2)
            dn2P = jnp.where(ok, dn2P, dn2v)
            tau = jnp.where(ok, tau, zero)
            ttn = jnp.where(ok, ttn, jnp.int32(0))
            in_win = jnp.logical_and(idx >= lo, idx <= hi)
            accv = accv + jnp.where(in_win, tau, zero)
            th = args[-1].at[jnp.minimum(-ttn, 18)].add(1)
            return (
                q1, E1, hi, accv, dminP, dnP, dm1P, dn1P, dm2P, dn2P, ttn,
                gn, jnp.logical_or(stuck, ~ok), th,
            )

        # the shift-carry (dmin..dn2, ttype, g) describes the PREVIOUS
        # window; after a deflation the dlasq4 N0IN cases (7..11) consume
        # dmin1/dmin2 as proxies for the shrunk window — no reset needed.
        # (A NEW split mid-window leaves a stale dmin — that case is
        # covered by the failure-correction retry instead.)
        (
            q, E, hi, accv, dmin, dn, dm1, dn1v, dm2, dn2v, tt, g, stuck,
            th,
        ) = lax.cond(
            hi - lo >= 1,
            do_sweep,
            lambda args: args,
            (
                q, E, hi, accv, dmin, dn, dm1, dn1v, dm2, dn2v, tt, g,
                stuck, th,
            ),
        )
        return (
            q, E, hi, accv, dmin, dn, dm1, dn1v, dm2, dn2v, tt, g, it + 1,
            since, out, stuck, th,
        )

    st = (
        q0, E0, jnp.int32(n - 1), jnp.zeros((n,), dtype), zero, zero, zero,
        zero, zero, zero, jnp.int32(0), jnp.asarray(0.25, dtype),
        jnp.int32(0), jnp.int32(0), jnp.zeros((n,), dtype),
        jnp.bool_(False), jnp.zeros((19,), jnp.int32),
    )
    (
        q, E, hi, accv, dmin, dn, dm1, dn1v, dm2, dn2v, tt, g, it, since,
        out, stuck, th,
    ) = lax.while_loop(cond, body, st)
    out = jnp.where(idx <= hi, q + accv, out)  # flush if capped/stuck
    sig = scale * jnp.sort(jnp.sqrt(jnp.maximum(out, zero)))[::-1]
    # normwise safety net: unconverged (stuck or capped) -> bisection
    sig = lax.cond(
        hi < 0, lambda _: sig, lambda _: bisect_svdvals(d, e), None
    )
    if with_info == "debug":
        # diagnostic: sweep count + histogram of the dlasq4 shift types
        # fired (indexed by -ttype; 18 = failure-corrected retries,
        # 0 = zero-shift dqd fallbacks)
        return sig, it, th
    if with_info:
        return sig, it
    return sig


def bisect_iters(dtype):
    """Halvings from the Gershgorin bracket down to ~eps * ||B||."""
    return int(np.ceil(-np.log2(np.finfo(dtype).eps))) + 12


def tgk_bisect_inputs(d, e):
    """Squared TGK off-diagonals and the Gershgorin bound for bisection.

    TGK's off-diagonals interleave d and e: (d1, e1, d2, e2, ..., d_n).
    Their squares are floored at ``tiny`` (which decouples exact splits
    safely); the bound is padded by a few ulps so every eigenvalue lies
    strictly inside [-bound, bound]."""
    n = d.shape[0]
    dtype = d.dtype
    z = jnp.zeros((2 * n - 1,), dtype).at[0::2].set(d).at[1::2].set(e)
    z2 = jnp.maximum(z * z, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    azp = jnp.pad(jnp.abs(z), (1, 1))
    bound = jnp.max(azp[:-1] + azp[1:]) * (1 + 4 * jnp.finfo(dtype).eps)
    return z2, bound


@functools.partial(jax.jit, static_argnames=("iters",))
def bisect_svdvals(d, e, iters=None):
    """Singular values of the bidiagonal {d, e} by parallel bisection.

    Parallel alternative to QR iteration (no reference counterpart — the
    reference's ``qrd`` is inherently sequential: ~n rotations per sweep and
    O(n) sweeps, hopeless at scale on a wide device).  This is the XLA
    reference; on CUDA ``ops.dispatch.bisect_svdvals`` runs the Triton
    kernel of ops/pallas/bisect_triton.py instead.  Here all ``n``
    values are bisected *simultaneously* on the Golub-Kahan tridiagonal
    ``TGK = P [[0, B^T], [B, 0]] P^T`` (zero diagonal, off-diagonals
    interleaving d and e), whose eigenvalues are +/-sigma.  One bisection
    step evaluates a Sturm pivot count for n shifts at once: the recurrence
    ``p <- -lam - z_i^2 / p`` runs as a single ``fori_loop`` of length 2n
    with (n,)-vector lanes, so sequential depth is O(2n * iters) instead of
    the QR iteration's O(n^2) scalar chain.

    Accuracy: ABSOLUTE, ``~||B|| * 2**-iters`` — a fixed iteration count
    bisected from a Gershgorin bracket; tiny singular values carry no
    relative-accuracy guarantee.  (Bisection on TGK *can* deliver the
    Demmel-Kahan 1990 high relative accuracy, but only with per-value
    relative stopping criteria and a pivmin guard; this implementation
    instead relies on IEEE inf semantics for zero pivots and trades the
    relative guarantee for a fixed, fully-vectorizable iteration count.)
    """
    n = d.shape[0]
    dtype = d.dtype
    if n == 1:
        return jnp.abs(d)
    if iters is None:
        iters = bisect_iters(dtype)
    z2, bound = tgk_bisect_inputs(d, e)

    def count_sigma_less(lam):
        """#(sigma < lam_j) for each lane j, via TGK Sturm pivot signs."""
        p0 = -lam
        cnt0 = (p0 < 0).astype(jnp.int32)

        def step(i, carry):
            p, cnt = carry
            p = -lam - z2[i - 1] / p
            return p, cnt + (p < 0)

        _, cnt = lax.fori_loop(1, 2 * n, step, (p0, cnt0))
        return cnt - n  # TGK eigs below lam minus the n negative ones

    lo = jnp.zeros((n,), dtype)
    hi = jnp.full((n,), bound, dtype)
    ks = jnp.arange(n, dtype=jnp.int32)  # lane j targets the j-th smallest

    def biter(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        above = count_sigma_less(mid) > ks
        return jnp.where(above, lo, mid), jnp.where(above, mid, hi)

    lo, hi = lax.fori_loop(0, int(iters), biter, (lo, hi))
    return (0.5 * (lo + hi))[::-1]
