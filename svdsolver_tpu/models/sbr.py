"""Successive band reduction (SBR): block bulge-chase that narrows an
upper-band matrix from bandwidth ``b1`` to ``b2`` with rank-``nb`` block
reflectors whose applies are GEMMs.

Why this exists: the scalar bulge chase (models/two_stage.band_to_bidiagonal,
reference brd_p2 at svd_parallel.h:639) does O(n^2 * b) strictly VECTOR-bound
work — every elimination is a rank-1 reflector pair, and PERF_NOTES' row-cost
model shows every windowing variant of it is pinned to the same ~2n^2
moved-row invariant.  SBR (Bischof-Lang-Sun's framework, adapted to the
two-sided bidiagonal case) escapes at the algorithm level: ONE block sweep
takes band(b1) -> band(b2) moving each window once per rank-``nb`` update
instead of once per rank-1 update, and the window updates are compact-WY
GEMMs.  The remaining scalar chase then runs on a band ``b2`` matrix — a
fraction of the vector-bound work.

The block pair is the exact rank-``nb`` generalization of the scalar
window pair (two_stage.make_window_pairs is the ``nb = 1, b2 = 1`` case):

* right/LQ block elimination: rows ``[R, R+nb)`` are brought to the
  staircase where row ``t`` ends at window column ``t`` (bandwidth ``b2``
  at the sweep top, bandwidth ``b1`` for chase hops), via a compact-WY LQ
  panel over the ``d + nb``-wide support (``d = b1 - b2``), applied to every
  window row as a GEMM.  This fills a lower-triangular bulge below the
  diagonal in the next ``d + nb`` rows.
* left/QR block elimination: the first ``nb`` bulge columns are eliminated
  back to upper form (column ``t`` keeps window rows ``[0, t]``) by the
  mirrored compact-WY QR panel, spreading fill ``b1`` columns ahead — which
  the next hop's right elimination removes.  Window corners advance ``b1``
  rows/cols per hop, exactly like the scalar chase.

The staircase construction requires ``nb <= b2`` (the elimination columns
must start at-or-right of every panel row's diagonal), the Bischof-Lang
``d + nb <= b1`` constraint in this geometry.

Used by the ``tpu2`` pipeline as Stage IIa: dense -> band(128) [Stage I]
-> band(b2) [this module] -> bidiagonal [narrow scalar chase] -> sigma.
"""

import functools

import jax.numpy as jnp
from jax import lax
import jax

from svdsolver_tpu.models.two_stage import _panel_qr_step, band_to_bidiagonal


def make_sbr_window_pairs(b, c, nb):
    """Block window kernels for one SBR sweep: returns ``(top_pair,
    chase_pair)`` over static-shape windows.

    ``top_pair`` acts on the (b + nb, b + W) window at rows ``[i0, ...)``,
    cols ``[i0 + c, ...)``; ``chase_pair`` on the (b + W, b + W) window at
    rows ``[R, ...)``, cols ``[R + b, ...)``, where ``W = b - c + nb`` is the
    reflector support span.  Scalar sanity: at ``nb = c = 1`` these are
    exactly two_stage.make_window_pairs' (w, 2w-2) and (2w-2, 2w-2) windows.
    """
    W = b - c + nb

    def _right_block(Wn):
        # LQ panel over the first nb rows of the W-wide left strip; row t
        # pivots at column t (staircase).  _panel_qr_step on the transpose
        # factors panel columns with pivot row j and applies the aggregated
        # compact-WY reflector to the whole strip (GEMMs).
        R = Wn[:, :W]
        R = _panel_qr_step(R.T, 0, 0, nb).T
        return Wn.at[:, :W].set(R)

    def _left_block(Wn, r0):
        # QR panel over the first nb columns of the sub-window starting at
        # row r0; column t pivots at sub-window row t.
        L = _panel_qr_step(Wn[r0:, :], 0, 0, nb)
        return Wn.at[r0:, :].set(L)

    def top_pair(Wn):
        return _left_block(_right_block(Wn), c)

    def chase_pair(Wn):
        return _left_block(_right_block(Wn), b)

    return top_pair, chase_pair


@functools.partial(jax.jit, static_argnames=("b1", "b2", "nb"))
def band_reduce_width(A, b1, b2, nb=None):
    """Reduce square upper-band ``A`` (bandwidth ``b1``) to upper-band
    form of bandwidth ``b2`` by one SBR block sweep; returns the (n, n)
    narrowed band matrix (orthogonally equivalent — same singular values).

    ``nb``: block-reflector rank (defaults to ``b2``; must satisfy
    ``1 <= nb <= b2``).  Zero padding makes every window static-shape;
    overshoot eliminations see zero columns and degenerate to exact no-ops
    (tau = 0), the same trick as the scalar chase.
    """
    n = A.shape[0]
    b, c = int(b1), int(b2)
    nb = c if nb is None else int(nb)
    if A.shape[0] != A.shape[1]:
        raise ValueError("band_reduce_width expects a square matrix")
    if not 1 <= c < b:
        raise ValueError(f"need 1 <= b2 < b1, got b1={b}, b2={c}")
    if not 1 <= nb <= c:
        raise ValueError(f"need 1 <= nb <= b2 (staircase), got nb={nb}")
    if n < 2:
        return A
    W = b - c + nb
    pad = 2 * (b + W) + 2
    Ap = jnp.pad(A, ((0, pad), (0, pad)))
    top_pair, chase_pair = make_sbr_window_pairs(b, c, nb)

    def sweep(k, Ap):
        i0 = k * nb
        Wt = lax.dynamic_slice(Ap, (i0, i0 + c), (b + nb, b + W))
        Ap = lax.dynamic_update_slice(Ap, top_pair(Wt), (i0, i0 + c))
        # hop h: right elim of rows [R, R+nb), R = i0 + c + h*b; needed
        # while R + b < n, +1 overshoot hop mirroring the scalar chase.
        n_chase = (
            lax.max(
                jnp.int32(0),
                -(-(jnp.int32(n) - (i0 + c + b)) // b),
            )
            + 1
        )

        def chase(h, Ap):
            R = i0 + c + h * b
            Wc = lax.dynamic_slice(Ap, (R, R + b), (b + W, b + W))
            return lax.dynamic_update_slice(Ap, chase_pair(Wc), (R, R + b))

        return lax.fori_loop(0, n_chase, chase, Ap)

    K = max(1, -(-(n - 1) // nb))
    Ap = lax.fori_loop(0, K, sweep, Ap)
    return Ap[:n, :n]


@functools.partial(jax.jit, static_argnames=("band", "mid", "nb"))
def band_to_bidiagonal_sbr(A, band=128, mid=32, nb=None):
    """Two-step Stage II: band(``band``) -> band(``mid``) by the SBR block
    sweep, then the scalar chase at the narrow bandwidth; returns (d, e).

    Same output class as band_to_bidiagonal; the reflector sequence differs,
    so d/e are spectrum-equivalent, not elementwise-equal.
    """
    Am = band_reduce_width(A, b1=int(band), b2=int(mid), nb=nb)
    return band_to_bidiagonal(Am, band=int(mid))
