"""Correctly-rounded f32 matrix contraction from exact bf16 digit
products (Ozaki-style).

A plain f32 matmul carries ~1e-7 error relative to the *largest*
operand magnitudes, and whole-image DCT chains amplify that: a 512x512
spec round trip floors far above the BASELINE.md 1e-5 target
(reference convention: the intermediate precision is *higher* than
storage precision — include/precision.h:50, default
INTERMEDIATE=long double).

This module recovers f64-class contraction accuracy from exact
arithmetic alone — the classic error-free splitting ("Ozaki scheme"):

1. scale both operands by powers of two so entries lie in (-1, 1];
2. split each into B-bit integer digits: ``a = sum_i m_i 2^{-B(i+1)}``
   with ``|m_i| <= 2^B``; digits are stored as bfloat16 (integers up to
   256 are exact in bf16) and every split step is error-free
   (Sterbenz subtraction);
3. every digit-pair product ``M_i @ X_j`` is then EXACT: bf16 products
   of B-bit integers fit f32, and f32 accumulation is exact because
   ``2B + log2(K) <= 24`` (B is chosen per contraction length K), so
   every partial sum is an integer below 2^24;
4. the exact partial products are combined largest-first with TwoSum
   compensation (error O(eps^2)) and the only rounding in the whole
   pipeline is the final f32 store.

Cost: ~18 bf16 matmuls per contraction at the full f64-class tail,
far fewer with a tolerance budget; everything is jittable jnp.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["digit_width", "budget_bits", "split_matrix_digits", "exact_contract"]


def digit_width(k: int) -> int:
    """Largest digit width B with 2B + ceil(log2 k) <= 24 (exact f32
    accumulation over a K-length contraction), capped at bf16's 8
    mantissa bits."""
    k = max(int(k), 2)
    return max(1, min(8, (24 - math.ceil(math.log2(k))) // 2))


def budget_bits(tol: float | None, k: int) -> int | None:
    """Digit-tail depth (bits below each slice max) needed to keep the
    contraction truncation error comfortably under ``tol`` relative to
    the per-slice operand magnitudes.  Truncation residuals accumulate
    across the K-length contraction (worst case K * 2^-bits), hence the
    ceil(log2 k) term; the +4 margin absorbs chained transforms (a spec
    round trip stacks 4 contractions).  ``None`` keeps the full
    f64-class tail."""
    if tol is None:
        return None
    return max(8, math.ceil(-math.log2(tol)) + math.ceil(math.log2(max(k, 2))) + 4)


def split_matrix_digits(m: np.ndarray, pmax: int | None = None,
                        tol: float | None = None):
    """Split a float64 [M, K] matrix into integer digit slices.

    Returns (digits [D, M, K] bfloat16 with integer values, scale) such
    that ``m ~= scale * sum_i digits[i] * 2**(-B*(i+1))`` with error
    below ``scale * 2**(-B*D)``; B = digit_width(K).  ``tol`` bounds the
    digit count to ``budget_bits(tol)`` total bits (the
    tolerance-budgeted mode; default carries the full f64 mantissa).
    """
    m = np.asarray(m, dtype=np.float64)
    B = digit_width(m.shape[1])
    # power-of-two scale with |m'| <= 1 (frexp: m = mant * 2^e, mant < 1)
    mx = float(np.max(np.abs(m)))
    e = math.frexp(mx)[1] if mx > 0 else 0
    scale = float(2.0**e)
    r = m / scale
    bits = budget_bits(tol, m.shape[1])
    nd = -(-(bits if bits is not None else 53) // B)  # default: full f64 mantissa
    if pmax is not None:
        nd = min(nd, pmax + 1)
    digits = []
    for i in range(nd):
        sc = 2.0 ** (B * (i + 1))
        d = np.round(r * sc)
        r = r - d / sc
        digits.append(d)
    return (
        np.stack(digits).astype(jnp.bfloat16),
        np.float32(scale),
    )


_X_BITS = 36  # digit depth below each slice max (> f32's 24: elements
#               much smaller than their slice max keep relative accuracy
#               through chained transforms)


def _split_operand_digits(x: jnp.ndarray, B: int, axis: int,
                          x_bits: int = _X_BITS):
    """Runtime digit split of an f32 operand.  Scales are per
    contraction *slice* (max along ``axis``, the Ozaki blocking), so
    dynamic range across output elements costs nothing; returns
    (digit list, log2-scale array with ``axis`` kept as size 1).
    The scale/round/subtract core is shared with the int8 path
    (int8mm.split_operand_digits_jnp: exact exponent-field scaling,
    no log2/exp2 approximations)."""
    from dspfun_tpu.ops.int8mm import split_operand_digits_jnp  # noqa: PLC0415

    x = jnp.asarray(x, jnp.float32)
    return split_operand_digits_jnp(x, axis, B, -(-x_bits // B),
                                    jnp.bfloat16)


def exact_contract(
    x: jax.Array,
    digits_a: jax.Array,       # [DA, M, K] from split_matrix_digits
    scale_a,                   # matrix power-of-two scale
    axis: int,
    tol: float | None = None,
) -> jax.Array:
    """Contract the digit-split [M, K] matrix against ``axis`` of ``x``
    with one f32 rounding total.  Returns f32, shaped like ``x`` with
    ``axis`` replaced by M.

    ``tol`` engages the tolerance-budgeted mode: the operand digit count
    and digit-pair cutoff are sized to ``budget_bits(tol)`` instead of
    the full ~60-bit tail — at 1e-5 that is ~5x fewer matmul passes, still
    with exact products and exact f32 accumulation (truncation is the
    only error, bounded per slice).
    """
    axis = axis % x.ndim
    da, m, k = digits_a.shape
    B = digit_width(k)
    bits = budget_bits(tol, k)
    xd, ex = _split_operand_digits(x, B, axis,
                                   x_bits=bits if bits is not None else _X_BITS)
    dx = len(xd)
    # one batched matmul computes every digit-pair product at once —
    # [DA*M, K] @ [K, DX*rest] — ~1.5x the FLOPs of the needed pairs
    # but a far better matmul shape than ~30 small ones
    prod_all = jnp.tensordot(
        digits_a.reshape(da * m, k), jnp.stack(xd),
        axes=[[1], [axis + 1]],
        precision=jax.lax.Precision.DEFAULT,  # bf16 digits: exact products
        preferred_element_type=jnp.float32,
    )  # [DA*M, DX, rest...]
    prod_all = prod_all.reshape((da, m) + prod_all.shape[1:])
    # keep digit pairs down to 2^(-B*(pmax+2)) ~ 2^-tail relative
    tail = bits if bits is not None else 60
    pmax = max(0, -(-tail // B) - 2)
    pairs = sorted(
        ((i, j) for i in range(da) for j in range(dx) if i + j <= pmax),
        key=lambda ij: ij[0] + ij[1],
    )
    s = err = None
    for i, j in pairs:
        t = prod_all[i, :, j] * float(2.0 ** (-B * (i + j + 2)))
        if s is None:
            s, err = t, jnp.zeros_like(t)
        else:
            # TwoSum: z + (s - (z - b)) + (t - b) == s + t exactly
            z = s + t
            b = z - s
            err = err + ((s - (z - b)) + (t - b))
            s = z
    # per-slice power-of-two scales: ex has size 1 at ``axis``; move it
    # to the front to broadcast over the M output axis
    from dspfun_tpu.ops.int8mm import exp2i  # noqa: PLC0415

    y = (s + err) * (jnp.float32(scale_a) * exp2i(jnp.moveaxis(ex, axis, 0)))
    return jnp.moveaxis(y, 0, axis)
