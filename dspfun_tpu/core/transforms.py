"""ND separable spectral transforms as dense matrix contractions.

The reference runs FFTW r2r plans (REDFT10/REDFT01) over whole images
(spec/ispec/zoom/scan) and over 3-D blocks (motion).  Here every
transform is a dense basis-matrix contraction, batched over
channels/blocks/frames; XLA fuses the surrounding elementwise filter
chains into the matmuls.

Precision: the `hilo` intermediate mode implements double-float
compensated contraction — the float64 basis matrix is split into
hi + lo float32 parts and the two matmuls are summed.  For float32
inputs (exactly representable) this bounds the basis representation
error at ~2^-48, recovering the reference's "intermediate precision >
coeff precision" behaviour (reference include/precision.h:26-57).

Also provides the dspfun "uniform range" normalisation grids:
sqrt(2)^(#nonzero indices) per coefficient — reference
include/speclib.c:79-92 (spec_normalization), spec/spec.c:70-74,
motion/motion.c:643-647.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from dspfun_tpu.core import basis as basis_mod
from dspfun_tpu.core.precision import Precision, get_precision

__all__ = [
    "apply_matrix",
    "dct2",
    "dct3",
    "dct2_nd",
    "dct3_nd",
    "uniform_grid",
    "split_hilo",
    "AxisPlan",
    "plan_axis",
    "plan_matrix",
    "apply_plan",
    "apply_plan_nd",
]


def split_hilo(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a float64 matrix into hi + lo float32 parts (double-float)."""
    hi = m.astype(np.float32)
    lo = (m - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


class AxisPlan(NamedTuple):
    """A planned 1-D transform: basis matrix array(s).

    The analogue of an FFTW plan (reference motion/motion.c:518-557
    plans + wisdom): materialised once per (size, kind, precision).
    Held as *host* numpy arrays so a cached plan is safe to use both as
    a jit argument (lives in HBM, not inlined) and inside jit/shard_map
    traces (becomes a compile-time constant).  ``lo`` is the
    double-float compensation term (None outside hilo mode);
    ``digits``/``scale`` are the error-free bf16 digit split (None
    outside exact mode — see core/exact.py); ``rowsum`` is the hi/lo
    pair of per-row matrix sums [2, M] used by the rank-1 ``split``
    contraction (exact for DCT-II: [2N, 0, ...]).
    """

    hi: jax.Array | np.ndarray
    lo: jax.Array | np.ndarray | None
    digits: jax.Array | np.ndarray | None = None
    scale: jax.Array | np.ndarray | None = None
    rowsum: jax.Array | np.ndarray | None = None


def plan_matrix(m: np.ndarray, precision: Precision | None = None) -> AxisPlan:
    """Build an AxisPlan from an arbitrary float64 matrix."""
    p = precision or get_precision()
    m = np.asarray(m, dtype=np.float64)
    rs64 = m.sum(axis=1)
    rs_hi = rs64.astype(np.float32)
    rowsum = np.stack([rs_hi, (rs64 - rs_hi.astype(np.float64)).astype(np.float32)])
    if p.intermediate == "f64":
        return AxisPlan(m, None, rowsum=rs64[None, :])
    if p.intermediate == "exact":
        from dspfun_tpu.core.exact import split_matrix_digits  # noqa: PLC0415

        digits, scale = split_matrix_digits(m, tol=p.tol)
        return AxisPlan(m.astype(np.float32), None, digits, scale, rowsum)
    if p.intermediate == "i8":
        from dspfun_tpu.ops.int8mm import (  # noqa: PLC0415
            I8_DEEP_TOL, i8_feasible, split_matrix_i8,
        )

        # tight (or unset) accuracy budgets carry a 4th digit plane:
        # the deep 10-product form lands ~1e-8-class relative
        # (~2^-28 truncation, exact int32 accumulation) at ~1.7x the
        # 3-digit form's int8 work
        ndig = 4 if p.tol is None or p.tol <= I8_DEEP_TOL else 3
        if i8_feasible(m.shape[1], ndig):
            digits, row_scale = split_matrix_i8(m, ndig)
            return AxisPlan(m.astype(np.float32), None, digits, row_scale,
                            rowsum)
        # contraction too long for the exact-int32 group sums: the
        # bf16-digit exact mode is the same accuracy class without
        # that limit
        from dspfun_tpu.core.exact import split_matrix_digits  # noqa: PLC0415

        digits, scale = split_matrix_digits(m, tol=p.tol)
        return AxisPlan(m.astype(np.float32), None, digits, scale, rowsum)
    if p.intermediate == "hilo":
        hi, lo = split_hilo(m)
        return AxisPlan(hi, lo, rowsum=rowsum)
    return AxisPlan(m.astype(np.float32), None, rowsum=rowsum)


@functools.lru_cache(maxsize=128)
def _plan_axis_cached(n: int, kind: str, intermediate: str,
                      tol: float | None) -> AxisPlan:
    m = basis_mod.dct2_matrix(n) if kind == "dct2" else basis_mod.dct3_matrix(n)
    return plan_matrix(m, Precision(intermediate=intermediate, tol=tol))


def plan_axis(n: int, kind: str, precision: Precision | None = None) -> AxisPlan:
    """Cached plan for an FFTW-convention DCT along an axis of length n."""
    p = precision or get_precision()
    if kind not in ("dct2", "dct3"):
        raise ValueError(kind)
    return _plan_axis_cached(int(n), kind, p.intermediate, p.tol)


def _vec_along(vec: jax.Array, axis: int, ndim: int) -> jax.Array:
    shape = [1] * ndim
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def apply_plan(
    x: jax.Array,
    plan: AxisPlan,
    axis: int,
    precision: Precision | None = None,
    split: str | None = None,
) -> jax.Array:
    """Contract a planned [K, N] matrix against ``axis`` of ``x``.

    ``split`` (advisory; engages only when ``precision.tol`` is set on
    an f32/hilo policy) names the rank-1 component that dominates the
    operand's dynamic range: the bulk contraction then sees only the
    balanced residual while the dominant component is applied
    analytically with one rounding:

    * ``"mean"`` — for forward DCTs: ``M@x == M@(x-mu) + mu*rowsum(M)``
      for any mu; rowsum(DCT-II) is exactly [2N, 0, ...] so the image
      mean (the huge DC ~ N*mean) never passes through bf16 splitting.
    * ``"zero0"`` — for inverse DCTs: ``M@x == M@x_0zeroed + x_0*M[:,0]``
      and DCT-III column 0 is exactly ones, so the DC coefficient is a
      plain broadcast add.

    The split also composes with the int8 digit mode: the balanced
    residual keeps each contraction slice's digit scaling tight around
    the signal instead of the DC.
    """
    p = precision or get_precision()
    axis = axis % x.ndim

    def tdot(mat: jax.Array, operand: jax.Array,
             prec=jax.lax.Precision.HIGHEST) -> jax.Array:
        y = jnp.tensordot(
            mat,
            operand,
            axes=[[1], [axis]],
            precision=prec,
            preferred_element_type=jnp.float32
            if p.intermediate != "f64"
            else jnp.float64,
        )
        return jnp.moveaxis(y, 0, axis)

    def rank1_split(xf):
        """Peel the dominant rank-1 component off the operand: returns
        (residual, pivot, correction hi/lo vectors) — exact algebra for
        any pivot (see the docstring)."""
        if split == "mean":
            piv = jnp.mean(xf, axis=axis, keepdims=True)
            resid = xf - piv
            vec_hi = _vec_along(jnp.asarray(plan.rowsum)[0], axis, x.ndim)
            vec_lo = _vec_along(jnp.asarray(plan.rowsum)[1], axis, x.ndim)
        else:
            piv = jax.lax.index_in_dim(xf, 0, axis, keepdims=True)
            k_idx = _vec_along(jnp.arange(xf.shape[axis]), axis, x.ndim)
            resid = jnp.where(k_idx == 0, jnp.float32(0), xf)
            vec_hi = _vec_along(jnp.asarray(plan.hi)[:, 0], axis, x.ndim)
            vec_lo = (_vec_along(jnp.asarray(plan.lo)[:, 0], axis, x.ndim)
                      if plan.lo is not None else None)
        return resid, piv, vec_hi, vec_lo

    if (plan.digits is not None and jnp.asarray(plan.digits).dtype == jnp.int8
            and x.shape[axis] < 256):
        # tiny contractions (blockwise DCTs, K <= 16) gain nothing from
        # the int8 digit products; HIGHEST on the f32 matrix is both
        # faster and more accurate there
        y = tdot(plan.hi, x.astype(jnp.float32))
    elif plan.digits is not None and jnp.asarray(plan.digits).dtype == jnp.int8:
        from dspfun_tpu.ops.int8mm import i8_contract  # noqa: PLC0415

        xf = x.astype(jnp.float32)
        if split in ("mean", "zero0"):
            # the split composes: balanced residual slices keep the
            # per-slice digit scaling tight around the signal
            resid, piv, vec_hi, vec_lo = rank1_split(xf)
            y = i8_contract(resid, plan.digits, plan.scale, axis)
            y = y + piv * vec_hi
            if vec_lo is not None:
                y = y + piv * vec_lo
        else:
            y = i8_contract(xf, plan.digits, plan.scale, axis)
    elif plan.digits is not None:
        from dspfun_tpu.core.exact import exact_contract  # noqa: PLC0415

        y = exact_contract(x.astype(jnp.float32), plan.digits, plan.scale,
                           axis, tol=p.tol)
    elif p.intermediate == "f64":
        y = tdot(plan.hi, x.astype(jnp.float64))
    elif (split in ("mean", "zero0") and p.tol is not None
          and p.intermediate in ("f32", "hilo")):
        xf = x.astype(jnp.float32)
        resid, piv, vec_hi, vec_lo = rank1_split(xf)
        # HIGHEST even for loose budgets: HIGH runs in TF32 on the GPU
        # and misses a 2e-5 budget through a chained 4K transform pair
        y = tdot(plan.hi, resid)
        if plan.lo is not None:
            y = y + tdot(plan.lo, resid, jax.lax.Precision.DEFAULT)
        y = y + piv * vec_hi
        if vec_lo is not None:
            y = y + piv * vec_lo
    elif p.intermediate == "hilo" and plan.lo is not None:
        xf = x.astype(jnp.float32)
        # the lo compensation term is ~2^-24 of the main term, so one
        # DEFAULT matmul (TF32 on the GPU, ~2^-11 relative) suffices: its
        # error lands near 2^-35 of the result, far below the f32
        # accumulation floor
        y = tdot(plan.hi, xf) + tdot(plan.lo, xf,
                                     prec=jax.lax.Precision.DEFAULT)
    else:
        y = tdot(plan.hi, x.astype(plan.hi.dtype))
    return y.astype(p.coeff_dtype)


def apply_plan_nd(
    x: jax.Array,
    plans: Sequence[AxisPlan],
    axes: Sequence[int],
    precision: Precision | None = None,
    split: str | None = None,
) -> jax.Array:
    for plan, ax in zip(plans, axes):
        x = apply_plan(x, plan, ax, precision, split=split)
    return x


def apply_matrix(
    x: jax.Array,
    m: np.ndarray,
    axis: int,
    precision: Precision | None = None,
) -> jax.Array:
    """Contract float64 matrix ``m`` [K, N] against axis ``axis`` of ``x``.

    Convenience form for small matrices (embeds them as program
    constants); large/production paths should build an AxisPlan and pass
    it as a jit argument instead.
    """
    return apply_plan(x, plan_matrix(m, precision), axis, precision)


def dct2(x: jax.Array, axis: int, precision: Precision | None = None) -> jax.Array:
    """FFTW REDFT10 along one axis (unnormalised)."""
    return apply_matrix(x, basis_mod.dct2_matrix(x.shape[axis]), axis, precision)


def dct3(x: jax.Array, axis: int, precision: Precision | None = None) -> jax.Array:
    """FFTW REDFT01 along one axis (unnormalised)."""
    return apply_matrix(x, basis_mod.dct3_matrix(x.shape[axis]), axis, precision)


def dct2_nd(
    x: jax.Array, axes: Sequence[int], precision: Precision | None = None
) -> jax.Array:
    """Separable FFTW DCT-II over several axes (e.g. 2-D whole-image
    transform, reference spec/spec.c:63; 3-D block transform,
    motion/motion.c:535-538)."""
    for ax in axes:
        x = dct2(x, ax, precision)
    return x


def dct3_nd(
    x: jax.Array, axes: Sequence[int], precision: Precision | None = None
) -> jax.Array:
    """Separable FFTW DCT-III over several axes.  dct3_nd(dct2_nd(x))
    == x * prod(2*N_axis)."""
    for ax in axes:
        x = dct3(x, ax, precision)
    return x


@functools.lru_cache(maxsize=None)
def _uniform_grid_np(shape: tuple[int, ...]) -> np.ndarray:
    """sqrt(2)^(#nonzero indices) over an ND index grid (float64).

    reference include/speclib.h:44-51 / speclib.c:79-92: converts
    unnormalised FFTW DCT coefficients to dspfun's "uniform range"
    convention where every coefficient shares the same maximum
    magnitude.
    """
    g = np.zeros(shape, dtype=np.float64)
    for ax, n in enumerate(shape):
        idx = [None] * len(shape)
        idx[ax] = slice(None)
        g = g + (np.arange(n) != 0)[tuple(idx)]
    out = np.sqrt(2.0) ** g
    out.setflags(write=False)  # cached: in-place edits would corrupt it
    return out


def uniform_grid(shape: Sequence[int]) -> np.ndarray:
    """Uniform-range multiplier grid for the given transform dims."""
    return _uniform_grid_np(tuple(int(s) for s in shape))
