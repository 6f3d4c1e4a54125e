"""int8 Ozaki digit contraction: exact int8 products, int32 sums.

Both operands are split into B=7-bit signed-integer digits (per-row
power-of-two scales for the matrix, per-slice scales along the
contraction axis for the operand).  Every digit product is exact in
int8 x int8 -> int32, and the same-weight digit pairs are summed in
int32 before one f32 weighted combine, so the only error is the
digit-representation truncation: ~2^-21 relative to the slice maxes
with 3 digits (6 products), ~2^-28 with 4 (10 products).  ``_kmax``
bounds the contraction length for which the int32 group sums stay
exact.

The operand split runs as fused XLA elementwise passes.  The products
themselves run as a Pallas kernel through Triton on the GPU
(:func:`_i8_call`): one int32 accumulator per weight group stays in
registers across a loop over K chunks and the block writes one f32
tile.  Elsewhere, and as its reference, the plain form runs: per weight
group one int8 ``dot_general`` over the digit planes concatenated along
K (e.g. ``[A0|A1|A2] @ [X2; X1; X0]`` for the 2^-28 group) and an f32
combine XLA fuses.  On the GPU the plain form returns wrong results
inside the pipelines (PERF.md), so the GPU always takes the kernel.

Kernel layouts avoid host-side transposes:

* ``left``  — ``y[b, m, r] = sum_k A[m, k] x[b, k, r]``;
* ``right`` — ``y[b, r, m] = sum_k x[b, r, k] A[m, k]``.

This replaces the reference's "intermediate = long double" knob
(include/precision.h:50-57).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["B_I8", "I8_DEEP_TOL", "ceil_to", "split_matrix_i8",
           "i8_contract", "i8_contract_rt", "i8_feasible"]


def ceil_to(n: int, m: int) -> int:
    """``n`` rounded up to the next multiple of ``m`` (tile/shard
    padding — shared so the idiom is written once)."""
    return -(-n // m) * m


B_I8 = 7          # digit width: |digit| <= 64 after half-range scaling
_NDIG = 3         # 3 digits cover ~22 bits below each row/slice max
_W = [float(2.0 ** (-B_I8 * (p + 2))) for p in range(4)]

# accuracy budgets at or below this engage the 4-digit deep contraction
# (10 digit-pair products, truncation ~2^-28 -> ~1e-8-class relative
# with exact accumulation); looser budgets keep 3 digits
I8_DEEP_TOL = 2e-6

# Triton kernel tiles: (tm, tr, tk, num_warps, num_stages) per digit
# count, the fastest of a sweep at the 4K bench's pruned contractions on
# an H100.  Powers of two; the digit tiles of all stages fit the 227 KB
# a Hopper block may use (ndig x (tm + tr) x tk bytes per stage).
_TILES = {3: (128, 64, 64, 4, 3), 4: (64, 64, 64, 4, 3)}


def split_matrix_i8(m: np.ndarray, ndig: int = _NDIG):
    """Host split of a float64 [M, K] matrix into int8 digits.

    Returns (digits int8 [D, M, K], row_scale f32 [M, 1]) with
    ``m ~= row_scale * sum_i digits[i] * 2**(-B*(i+1))``; rows are
    scaled into (-1/2, 1/2] so every digit fits +-64 (carry-safe in
    int8).
    """
    m = np.asarray(m, dtype=np.float64)
    mx = np.max(np.abs(m), axis=1, keepdims=True)
    e = np.where(mx > 0, np.ceil(np.log2(np.maximum(mx, 1e-300))) + 1.0, 0.0)
    r = m / 2.0**e
    digs = []
    for i in range(ndig):
        sc = 2.0 ** (B_I8 * (i + 1))
        d = np.round(r * sc)
        r = r - d / sc
        digs.append(d.astype(np.int8))
    return np.stack(digs), (2.0**e).astype(np.float32)


def log2_ceil1(x: jax.Array) -> jax.Array:
    """EXACT per-element e with 2^(e-2) <= |x| < 2^(e-1) (i.e. the
    scaling exponent that puts x * 2^-e strictly inside (-1/2, 1/2)),
    read from the f32 exponent field.  Replaces ceil(log2(x)) + 1: an
    approximate log2 can shift the exponent by 1 near power-of-two
    boundaries, overflowing the 64-bound digit proof."""
    bits = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32),
                                        jnp.int32)
    return (((bits >> 23) & 0xFF) - 125).astype(jnp.float32)


def exp2i(e: jax.Array) -> jax.Array:
    """EXACT 2^e for integer-valued f32 ``e`` in [-126, 127], built by
    bit-casting the biased exponent.  An approximate ``exp2`` would
    make scale/unscale pairs non-reciprocal, a multiplicative error on
    every element.  ``e > 127`` (operand slice maxes >= 2^126, outside
    the digit-split domain) yields +inf so the corruption is loudly
    non-finite instead of silently wrong; ``e < -126`` (subnormal
    scales) clamps — use :func:`scale_down` to apply a 2^-e factor,
    which stays exact to e = 253."""
    bits = (jnp.clip(e, -126.0, 127.0).astype(jnp.int32) + 127) << 23
    v = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return jnp.where(e > 127.0, jnp.inf, v)


def scale_down(x: jax.Array, e: jax.Array) -> jax.Array:
    """``x * 2^-e`` via two exact power-of-two factors: covers the full
    ``log2_ceil1`` range (e up to 129 for slice maxes near f32 max)
    without the single-factor form's 2^-127-and-below subnormal scales
    (not representable by the biased-exponent bit-cast, and flushed to
    zero on devices without subnormals)."""
    h1 = jnp.floor(e * 0.5)
    return (x * exp2i(-h1)) * exp2i(-(e - h1))


def split_operand_digits_jnp(x: jax.Array, axis: int, bwidth: int,
                             ndig: int, dtype):
    """Shared runtime (in-graph) digit split: per-slice exact
    power-of-two scaling along ``axis`` (log2_ceil1/scale_down, so
    every digit provably fits ``+-2^(bwidth-1)``) then the round/
    subtract loop — each step error-free (Sterbenz).  Serves both the
    int8 path (``bwidth=7, int8``) and the exact bf16-digit path
    (core/exact.py) so a scaling fix lands in one place.
    Returns (digit arrays, log2-scale ``e`` with ``axis`` kept)."""
    mx = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    e = jnp.where(mx > 0, log2_ceil1(mx), 0.0)
    r = scale_down(x, e)
    out = []
    for i in range(ndig):
        sc = float(2.0 ** (bwidth * (i + 1)))
        d = jnp.round(r * sc)
        r = r - d * (1.0 / sc)
        out.append(d.astype(dtype))
    return out, e


def _split_operand_xla(x: jax.Array, axis: int, ndig: int = _NDIG):
    """Digit split of an f32 operand with per-slice scaling along
    ``axis`` (fused XLA elementwise passes).  Returns (``ndig`` int8
    digit arrays, exp2-scale with ``axis`` kept)."""
    out, e = split_operand_digits_jnp(x, axis, B_I8, ndig, jnp.int8)
    return out, exp2i(e)


def _combine(group_sums):
    """f32 weighted sum of the exact int32 weight-group sums."""
    acc = group_sums[0].astype(jnp.float32) * _W[0]
    for g in range(1, len(group_sums)):
        acc = acc + group_sums[g].astype(jnp.float32) * _W[g]
    return acc


def _group_dots_xla(a, xd, axis):
    """Plain form: weight group g sums the pairs (i, g-i) as ONE int8
    dot over the digit planes concatenated along K.  ``a`` are [M, K]
    digit planes, ``xd`` operand digits shaped like the operand; the
    result is shaped like the operand with ``axis`` replaced by M."""
    sums = []
    for g in range(len(a)):
        a_cat = jnp.concatenate([a[i] for i in range(g + 1)], axis=1)
        x_cat = jnp.concatenate([xd[g - i] for i in range(g + 1)], axis=axis)
        y = jax.lax.dot_general(
            a_cat, x_cat, (((1,), (axis,)), ((), ())),
            preferred_element_type=jnp.int32)
        sums.append(jnp.moveaxis(y, 0, axis))
    return _combine(sums)


def _kernel(*refs, nd, tk, nk, right):
    """One (tm, tr) output tile: int32 weight-group accumulators carried
    over K in ``tk`` chunks, one f32 store."""
    from jax.experimental import pallas as pl  # noqa: PLC0415

    a_refs, x_refs, o_ref = refs[:nd], refs[nd:2 * nd], refs[2 * nd]
    tm = a_refs[0].shape[0]
    tr = x_refs[0].shape[0] if right else x_refs[0].shape[1]
    oshape = (tr, tm) if right else (tm, tr)

    def body(kk, accs):
        ks = pl.ds(pl.multiple_of(kk * tk, tk), tk)
        av = [r[:, ks] for r in a_refs]
        xv = [r[:, ks] if right else r[ks, :] for r in x_refs]
        out = []
        for g in range(nd):
            s = accs[g]
            for i in range(g + 1):
                if right:
                    s = s + jax.lax.dot_general(
                        xv[g - i], av[i], (((1,), (1,)), ((), ())),
                        preferred_element_type=jnp.int32)
                else:
                    s = s + jnp.dot(av[i], xv[g - i],
                                    preferred_element_type=jnp.int32)
            out.append(s)
        return tuple(out)

    zeros = tuple(jnp.zeros(oshape, jnp.int32) for _ in range(nd))
    accs = jax.lax.fori_loop(0, nk, body, zeros)
    o_ref[...] = _combine(accs)


@functools.partial(jax.jit, static_argnames=("right", "tiles", "interpret"))
def _i8_call(a, x, right=False, tiles=None, interpret=False):
    """Kernel form.  ``a``: tuple of [Mp, Kp] int8 digit planes;
    ``x``: tuple of [B, Kp, Rp] (left) or [B, Rp, Kp] (right) int8
    operand digits, every dim a multiple of its tile.  Returns the
    unscaled digit combination, [B, Mp, Rp] (left) or [B, Rp, Mp]
    (right) f32."""
    from jax.experimental import pallas as pl  # noqa: PLC0415
    from jax.experimental.pallas import triton as plgpu  # noqa: PLC0415

    nd = len(a)
    tm, tr, tk, warps, stages = tiles
    mp_, kp = a[0].shape
    b = x[0].shape[0]
    rp = x[0].shape[1] if right else x[0].shape[2]
    a_spec = pl.BlockSpec((tm, kp), lambda c, i, j: (i, 0))
    if right:
        x_spec = pl.BlockSpec((None, tr, kp), lambda c, i, j: (c, j, 0))
        o_spec = pl.BlockSpec((None, tr, tm), lambda c, i, j: (c, j, i))
        oshape = (b, rp, mp_)
    else:
        x_spec = pl.BlockSpec((None, kp, tr), lambda c, i, j: (c, 0, j))
        o_spec = pl.BlockSpec((None, tm, tr), lambda c, i, j: (c, i, j))
        oshape = (b, mp_, rp)
    return pl.pallas_call(
        functools.partial(_kernel, nd=nd, tk=tk, nk=kp // tk, right=right),
        out_shape=jax.ShapeDtypeStruct(oshape, jnp.float32),
        grid=(b, mp_ // tm, rp // tr),
        in_specs=[a_spec] * nd + [x_spec] * nd,
        out_specs=o_spec,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps,
                                             num_stages=stages),
        interpret=interpret,
        name=f"i8_digits{nd}_{'right' if right else 'left'}",
    )(*a, *x)


def _pad_to(x, axis, mult):
    n = x.shape[axis]
    np_ = ceil_to(n, mult)
    if np_ == n:
        return x
    width = [(0, 0)] * x.ndim
    width[axis] = (0, np_ - n)
    return jnp.pad(x, width)


def _group_dots_kernel(a, xd, axis, interpret=False):
    """Kernel form of :func:`_group_dots_xla` (same contract)."""
    nd = len(a)
    tiles = _TILES[nd]
    tm, tr, tk = tiles[:3]
    m, k = a[0].shape
    shape = xd[0].shape
    ap = tuple(_pad_to(_pad_to(d, 0, tm), 1, tk) for d in a)
    if axis == len(shape) - 1 and len(shape) >= 2:
        pre = shape[:-1]
        xs = tuple(_pad_to(_pad_to(d.reshape(1, -1, k), 1, tr), 2, tk)
                   for d in xd)
        y = _i8_call(ap, xs, right=True, tiles=tiles, interpret=interpret)
        return y[0, :int(np.prod(pre)), :m].reshape(pre + (m,))
    if axis == 0 or (axis == 1 and len(shape) == 3):
        lead = shape[0] if axis == 1 else 1
        rest = shape[axis + 1:]
        xs = tuple(_pad_to(_pad_to(d.reshape(lead, k, -1), 1, tk), 2, tr)
                   for d in xd)
        y = _i8_call(ap, xs, right=False, tiles=tiles, interpret=interpret)
        y = y[:, :m, :int(np.prod(rest))]
        return y.reshape(((lead,) if axis == 1 else ()) + (m,) + rest)
    # general middle axis: one moveaxis to the front
    y = _group_dots_kernel(a, [jnp.moveaxis(d, axis, 0) for d in xd], 0,
                           interpret)
    return jnp.moveaxis(y, 0, axis)


def i8_feasible(k: int, ndig: int = _NDIG) -> bool:
    """Host-side planner probe: does a contraction of length ``k`` keep
    its int32 group sums exact?  Callers fall back to the exact
    bf16-digit mode when not (core/transforms.plan_matrix)."""
    return k <= _kmax(ndig)


def i8_contract(
    x: jax.Array,
    digits_a: jax.Array,     # [D, M, K] int8 from split_matrix_i8
    scale_a,                 # [M, 1] f32 row scales
    axis: int,
    interpret: bool = False,
) -> jax.Array:
    """Contract the int8-digit [M, K] matrix against ``axis`` of ``x``
    (f32).  Shaped like ``x`` with ``axis`` replaced by M.

    3 digit planes run 6 products (~2^-21 truncation, the budgeted fast
    mode); 4 planes run the deep 10 products (~2^-28 truncation,
    ~1e-8-class relative — the accuracy mode, still exact int32
    accumulation; see plan_matrix/I8_DEEP_TOL for the selection
    policy).  ``interpret`` runs the GPU kernel in the Pallas
    interpreter (tests).
    """
    da = digits_a.shape[0]
    if da not in (_NDIG, _NDIG + 1):
        raise ValueError(f"expected {_NDIG} or {_NDIG + 1} digit planes, "
                         f"got {da}")
    return _i8_dispatch(x, [digits_a[i] for i in range(da)],
                        jnp.asarray(scale_a), axis, interpret)


def i8_contract_rt(x: jax.Array, a_f32: jax.Array, axis: int) -> jax.Array:
    """Like :func:`i8_contract` but the [M, K] matrix is a *runtime*
    f32 array — the digit split runs on device (fused XLA elementwise).
    For in-graph-generated bases (zoom's continuous DCT basis is built
    from four traced scalars per frame, models/zoom_pipeline.py)."""
    af = jnp.asarray(a_f32, jnp.float32)
    ad, ea = _split_operand_xla(af, 1)     # per-row slice scaling
    return _i8_dispatch(x, ad, ea, axis)


def _kmax(ndig: int) -> int:
    """Largest K with provably exact int32 group accumulation: digit
    products are bounded by 64*64 = 2^12 and the same-weight digit
    pairs are summed *in int32* before the f32 cast — 3 dots in the
    3-digit form's w2 group, 4 in the deep form's w3 group — so the
    bound is (2^31 - 1) / (group_dots * 2^12), not the single-dot
    2^19."""
    group = 3 if ndig == 3 else 4
    return ((1 << 31) - 1) // (group << 12)


def _use_kernel(interpret: bool) -> bool:
    return interpret or jax.default_backend() == "gpu"


def _i8_dispatch(x, a_digits, scale_a, axis, interpret=False):
    axis = axis % x.ndim
    nd = len(a_digits)
    k = x.shape[axis]
    if k > _kmax(nd):
        raise ValueError(
            f"i8 contraction length {k} exceeds the exact-int32 "
            f"accumulation bound ({_kmax(nd)} for {nd} digit planes); "
            "split the axis or use exact/hilo")
    xd, ex = _split_operand_xla(jnp.asarray(x, jnp.float32), axis, nd)
    if _use_kernel(interpret):
        y = _group_dots_kernel(a_digits, xd, axis, interpret)
    else:
        y = _group_dots_xla(a_digits, xd, axis)
    # per-slice operand scales (size 1 at ``axis``) and per-row matrix
    # scales along the output axis
    sa = jnp.reshape(scale_a[:, 0],
                     [1] * axis + [-1] + [1] * (x.ndim - axis - 1))
    return y * ex * sa
