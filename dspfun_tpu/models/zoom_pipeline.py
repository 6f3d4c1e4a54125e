"""zoom compute: continuous DCT-basis interpolation at arbitrary
scale/offset.

The reference (zoom/zoom.c:361-375) evaluates the inverse DCT of a
whole-image DCT-II spectrum at arbitrary real coordinates, one output
column at a time with scalar loops.  Here the separable
synthesis is exactly two dense matrix contractions

    out[j, i, z] = sum_v Yb[j, v] * sum_u C[v, u, z] * Xb[i, u] / (w*h)

where Xb/Yb are the continuous DCT-III basis matrices for the frame's
scale and offset with an implicit 1/2 weight on the DC column
(zoom.c:364,369).  Per-frame basis matrices are generated host-side in
float64 (O(view * ncomponents) cosines) and shipped to the device as
jit *arguments*; they are padded to the full input length so animated
zooms with varying scale keep a single compiled program (ncomponents
<= input length always, zoom.c:41).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from dspfun_tpu.core import basis as basis_mod
from dspfun_tpu.core.precision import Precision, get_precision
from dspfun_tpu.core.transforms import apply_plan_nd, dct2_nd, plan_matrix
from dspfun_tpu.ops.int8mm import ceil_to

__all__ = [
    "forward_spectrum",
    "padded_zoom_basis",
    "zoom_plan",
    "zoom_frame",
    "zoom_frame_device",
    "clamp_scale",
    "showsamples_coords",
]


def forward_spectrum(image: np.ndarray, precision: Precision | None = None) -> jax.Array:
    """Image [H,W,C] -> unnormalised whole-image DCT-II spectrum
    (reference zoom/zoom.c:263-266)."""
    p = precision or get_precision()
    return dct2_nd(jnp.asarray(image, dtype=p.coeff_dtype), (0, 1), p)


# minimum-logical-size clamp (reference zoom.c:277-284): one shared
# implementation, canonical in core/basis.py next to the basis it gates
clamp_scale = basis_mod.clamp_scale


def padded_zoom_basis(
    scaling_type: str,
    scale_num: float,
    scale_den: float,
    offset: float,
    nvectors: int,
    sampling_len: int,
) -> np.ndarray:
    """[nvectors, sampling_len] synthesis matrix: column 0 is the 1/2 DC
    weight, columns 1..ncomponents-1 the continuous DCT-III basis,
    higher columns zero (truncated when downscaling, zoom.c:41)."""
    basis, ncomp = basis_mod.zoom_scaled_basis(
        scaling_type, scale_num, scale_den, offset, nvectors, sampling_len
    )
    m = np.zeros((nvectors, sampling_len), dtype=np.float64)
    m[:, 0] = 0.5
    if ncomp > 1:
        m[:, 1:ncomp] = basis[:, : ncomp - 1]
    return m


@functools.partial(jax.jit, static_argnames=("precision", "encode_trc"))
def _synthesize(spectrum, plan_y, plan_x, precision=None,
                encode_trc: bool = False):
    """Planned separable synthesis: ``plan_y``/``plan_x`` are AxisPlans
    of the continuous basis matrices (host float64 -> digit split, so
    accuracy is set by the contraction mode alone: the deep 4-digit i8
    contraction carries ~2^-28 truncation — the path that holds
    BASELINE.md's <=1e-5 post-OETF budget on 4K stills).
    ``split="zero0"`` peels the dominant DC row/column analytically:
    basis column 0 is exactly 0.5 in every scaling convention
    (zoom/zoom.c:364,369)."""
    h, w = spectrum.shape[:2]
    p = precision or get_precision()
    if p.intermediate == "i8" and spectrum.ndim == 3:
        # [C, H, W] layout: both i8 contractions run transpose-free
        # (batched-left then right kernel form — ops/int8mm.py)
        z = jnp.moveaxis(spectrum, -1, 0)
        t = apply_plan_nd(z, (plan_y, plan_x), (1, 2), p, split="zero0")
        out = jnp.moveaxis(t, 0, -1)
    else:
        out = apply_plan_nd(spectrum, (plan_y, plan_x), (0, 1), p,
                            split="zero0")
    out = out / (h * w)
    if encode_trc:
        from dspfun_tpu.io.color import srgb_encode  # noqa: PLC0415

        out = srgb_encode(out, jnp)
    return out


@functools.lru_cache(maxsize=4)
def _zoom_plan_host(scaling_type, xnum, xden, ynum, yden, vx, vy,
                    vw, vh, w, h, precision):
    xb = padded_zoom_basis(scaling_type, *clamp_scale(w, xnum, xden),
                           vx, vw, w)
    yb = padded_zoom_basis(scaling_type, *clamp_scale(h, ynum, yden),
                           vy, vh, h)
    return plan_matrix(yb, precision), plan_matrix(xb, precision)


def _tracing() -> bool:
    try:
        from jax._src.core import trace_state_clean  # noqa: PLC0415
    except ImportError:
        # private API moved: report "tracing" — host plans are safe in
        # BOTH contexts (they just re-upload per dispatch), whereas
        # guessing "not tracing" inside a trace caches tracers in
        # _zoom_plan_device's lru_cache (the leak this guard prevents)
        return True
    return not trace_state_clean()


@functools.lru_cache(maxsize=4)
def _zoom_plan_device(key):
    # device-resident once per plan: as host numpy jit args these would
    # re-upload on every dispatch
    return jax.device_put(_zoom_plan_host(*key))


def _zoom_plan_cached(*key):
    if _tracing():
        # inside a jit trace device_put would return (and cache!)
        # tracers; host plans become compile-time constants instead
        return _zoom_plan_host(*key)
    return _zoom_plan_device(key)


def zoom_plan(
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    w: int,
    h: int,
    precision: Precision | None = None,
):
    """(plan_y, plan_x) AxisPlans of the host-float64 continuous basis
    for a fixed (scale, offset, view) — the FFTW-plan analogue for zoom
    stills and constant-parameter animations.  Cached: a still's basis
    is built and digit-split once, then every dispatch is two planned
    contractions (faster than the in-graph basis path *and* exact in
    the basis)."""
    p = precision or get_precision()
    return _zoom_plan_cached(scaling_type, float(xscale[0]), float(xscale[1]),
                             float(yscale[0]), float(yscale[1]),
                             float(vx), float(vy), int(vw), int(vh),
                             int(w), int(h), p)


_SCALING_IDS = {"interpolated": 0, "centered": 1, "native": 2}


def device_basis_accurate(vw, vh, vx, vy, xscale, yscale, w, h,
                          scaling_type: str = "interpolated") -> bool:
    """True when the in-graph f32 basis stays ~1e-6-class accurate:

    1. the cosine argument product (k+0.5)*j stays below ~2^21 on both
       axes (f32 loses whole units in the product at 4K+ sizes —
       measured 1.3e-3 basis error at 4096 px), and
    2. the per-vector index k itself is (near-)exactly representable in
       f32 — the int32 phase fold starts from the f32-rounded k, so an
       inexact k (centered mode's rational factor, fractional scales)
       floors the basis at ~pi*|f32(k)-k| regardless of the fold
       (measured ~4.8e-5 for centered at 1080p; ADVICE r3).

    The check is a direct host-side measurement of max |f32(k)-k| over
    the view's basis vectors (O(vw+vh) numpy).  "native" scaling has
    its own criteria (integer num/den for the in-graph int32 fold, see
    the branch below).  Callers falling outside use the host float64
    basis path (:func:`zoom_frame`)."""
    def kmax(n, off, num, den):
        num, den = clamp_scale(n, num, den)
        return (abs(off) + max(vw, vh)) * (den / num) + 1.0

    if scaling_type == "native":
        # native's period is n*num/den, generally fractional, so the
        # folded-mode product bound below does not apply: the direct
        # f32 phase kk*j/N carries error relative to the FULL phase
        # magnitude (~1e-4 at a 4x zoom of 1k px — 50x the criterion).
        # The device path is accurate only via the integer fold
        # (_device_basis): num/den integers, b*j*den exact in int32,
        # 2*n*num exact in f32, and the scalar offset term (the only
        # f32-rounded piece) within the 3e-6 criterion.
        def ok(n, off, num, den, nvec):
            num, den = clamp_scale(n, num, den)
            if num != round(num) or den != round(den) or num < 1 or den < 1:
                return False
            if nvec * max(n - 1, 1) * den >= 2.0**31:
                return False
            if 2.0 * n * num > 2.0**24:
                return False
            return math.pi * 2.0 * (abs(off) + 1.5) * den / num * 2.0**-24 <= 3e-6

        return ok(w, vx, *xscale, vw) and ok(h, vy, *yscale, vh)

    bx = kmax(w, vx, *xscale) * max(w - 1, 1)
    by = kmax(h, vy, *yscale) * max(h - 1, 1)
    if max(bx, by) > float(1 << 21):
        return False

    def k_err(n, off, num, den, nvec):
        num, den = clamp_scale(n, num, den)
        b = np.arange(nvec, dtype=np.float64)
        if scaling_type == "centered":
            denom = n * num - den
            if denom == 0:
                return np.inf
            k = (b + off) * (n - 1) * den / denom
        else:
            k = (b + off) * (den / num)
        return float(np.max(np.abs(k.astype(np.float32).astype(np.float64) - k)))

    err = max(k_err(w, vx, *xscale, vw), k_err(h, vy, *yscale, vh))
    return math.pi * err <= 3e-6


def _device_basis(scaling_id, num, den, offset, nvectors, sampling_len,
                  dtype, b0=None):
    """Basis matrix computed in-graph from traced scalars — the device
    counterpart of :func:`padded_zoom_basis` (animation runs one
    compiled program; only 4 scalars change per frame).  ``b0`` offsets
    the output-vector indices as exact integers (the sharded path's
    per-shard row start), keeping them out of the f32 offset scalar.
    The accuracy contract is delegated to :func:`device_basis_accurate`
    — outside its bounds (int32 fold overflow, non-representable k)
    the result degrades silently; callers must gate."""
    l = sampling_len
    # clamp_scale (zoom.c:37-40, 277-284)
    too_small = l * num / den < 1.0
    num = jnp.where(too_small, 1.0, num)
    den = jnp.where(too_small, float(l), den)
    # C round() (half away from zero): jnp.round is half-even and kept
    # one fewer frequency at exact-x.5 logical sizes (matches
    # basis.zoom_scaled_basis's floor(x+0.5))
    ncomp = jnp.minimum(float(l), jnp.floor(l * num / den + 0.5))
    b_idx = jnp.arange(nvectors, dtype=jnp.int32)
    if b0 is not None:
        b_idx = b_idx + b0
    b_idx = b_idx[:, None]
    b = b_idx.astype(dtype)
    j_idx = jnp.arange(l, dtype=jnp.int32)[None, :]
    j = j_idx.astype(dtype)
    scale = den / num
    k_interp = (b + offset) * scale
    k_native = b + offset
    k_center = (b + offset) * (l - 1) * den / (l * num - den)
    k = jnp.where(scaling_id == 0, k_interp,
                  jnp.where(scaling_id == 1, k_center, k_native))
    big_n = jnp.where(scaling_id == 2, l * num / den, float(l))
    # cos(pi*(k+0.5)*j/N): the naive f32 phase loses ~1.6e-4 absolute
    # once (k+0.5)*j grows past ~2^13 (f32 ulp of the product times pi).
    # For the integral-period scalings (interpolated/centered: N == l,
    # a static int) fold the integer part of the phase EXACTLY in int32
    # — ki*j mod 2l is exact for ki*j < 2^31 — so only the fractional
    # product (magnitude <= j, which then divides by l) carries f32
    # rounding.  The fold starts from the f32-rounded k, so its benefit
    # is bounded by k's representability: with exact k (dyadic scales,
    # integer offsets) basis error drops ~4e-4 -> ~5e-7 at 1080p, but
    # an inexact k (centered mode's rational factor, fractional scales)
    # floors at ~pi*|f32(k)-k| (~5e-5 measured for centered at 1080p).
    # device_basis_accurate() measures k representability host-side and
    # routes inexact-k frames to the float64 basis (tools/zoom.py).
    kk = k + 0.5
    ki = jnp.floor(kk)
    kf = kk - ki
    mi = jnp.mod(ki.astype(jnp.int32) * j_idx, 2 * l)
    ph_folded = (mi.astype(dtype) + kf * j) / float(l)
    # "native" has a fractional period N = l*num/den, so the static-2l
    # fold above does not apply — but for INTEGER num/den the phase
    # k*j*den/(l*num) folds exactly the same way: b*j*den mod 2*l*num
    # in int32 (b integer, offset rides the f32 term).  The direct form
    # covers fractional scales; its error grows with the phase
    # magnitude, so device_basis_accurate() gates it out.
    numi = jnp.maximum(jnp.round(num), 1.0).astype(jnp.int32)
    deni = jnp.maximum(jnp.round(den), 1.0).astype(jnp.int32)
    is_int = (num == numi.astype(dtype)) & (den == deni.astype(dtype))
    mi_nat = jnp.mod(b_idx * j_idx * deni, 2 * l * numi)
    fo = offset + 0.5
    ph_nat_fold = (mi_nat.astype(dtype) + fo * j * deni.astype(dtype)) \
        / jnp.maximum(float(l) * num, 1.0)
    ph_direct = kk * j / big_n
    ph_native = jnp.where(is_int, ph_nat_fold, ph_direct)
    ph = jnp.where(scaling_id == 2, ph_native, ph_folded)
    m = jnp.cos(jnp.pi * jnp.mod(ph, 2.0))
    m = jnp.where(j == 0, 0.5, m)
    return jnp.where(j < ncomp, m, 0.0)


def _synth(spectrum, yb, xb, encode_trc, precision):
    """Separable synthesis tail shared by the device and sharded paths
    (keep in one place so the two cannot drift).

    When the precision policy is ``i8`` with a tolerance set, the two
    contractions run as int8 digit matmuls with the in-graph basis
    split on device (ops/int8mm.i8_contract_rt — ~2x the HIGHEST rate
    at ~2^-20 relative, far below display precision); HIGHEST otherwise
    (the reference computes zoom in long double).  ``precision`` is a
    *static* (hashable) Precision resolved by the caller at dispatch
    time, so changing the runtime policy retraces instead of silently
    reusing a same-shape compiled program (ADVICE r3)."""
    h, w = spectrum.shape[:2]
    p = precision
    if (p.intermediate == "i8" and p.tol is not None
            and min(h, w) >= 256):
        from dspfun_tpu.ops.int8mm import i8_contract_rt  # noqa: PLC0415

        # zero0-style DC peel (see core/transforms.apply_plan): the DC
        # row/column dominate the spectrum's dynamic range and both
        # basis matrices have an exactly-0.5 column 0, so the dominant
        # terms are plain broadcast adds and the int8 digits only carry
        # the balanced residual
        z = jnp.moveaxis(spectrum, -1, 0)            # [c, h, w]
        row0 = z[:, 0:1, :]
        t = i8_contract_rt(z.at[:, 0, :].set(0.0), yb, 1) + 0.5 * row0
        col0 = t[:, :, 0:1]
        o = i8_contract_rt(t.at[:, :, 0].set(0.0), xb, 2) + 0.5 * col0
        out = jnp.moveaxis(o, 0, -1)
    else:
        out = jnp.einsum("jv,vuc,iu->jic", yb, spectrum, xb, optimize=True,
                         precision=jax.lax.Precision.HIGHEST)
    out = out / (h * w)
    if encode_trc:
        from dspfun_tpu.io.color import srgb_encode  # noqa: PLC0415

        out = srgb_encode(out, jnp)
    return out


@functools.partial(jax.jit,
                   static_argnames=("vw", "vh", "encode_trc", "precision"))
def _zoom_frame_device(spectrum, scaling_id, xnum, xden, ynum, yden,
                       vx, vy, vw: int, vh: int, encode_trc: bool = False,
                       precision: Precision | None = None):
    h, w = spectrum.shape[:2]
    dtype = spectrum.dtype
    xb = _device_basis(scaling_id, xnum, xden, vx, vw, w, dtype)
    yb = _device_basis(scaling_id, ynum, yden, vy, vh, h, dtype)
    return _synth(spectrum, yb, xb, encode_trc, precision)


def zoom_frame_device(
    spectrum: jax.Array,
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    encode_trc: bool = False,
) -> jax.Array:
    """Fully device-side zoom frame: the basis matrices are generated
    in-graph, so an animation re-dispatches one compiled program with
    four scalars per frame (no host basis generation or upload).
    ``encode_trc`` applies the sRGB OETF on device (the -g output
    stage, reference zoom.c:396-399)."""
    return _zoom_frame_device(
        spectrum, jnp.asarray(_SCALING_IDS[scaling_type]),
        jnp.asarray(float(xscale[0])), jnp.asarray(float(xscale[1])),
        jnp.asarray(float(yscale[0])), jnp.asarray(float(yscale[1])),
        jnp.asarray(float(vx)), jnp.asarray(float(vy)), vw, vh, encode_trc,
        get_precision(),
    )


@functools.partial(jax.jit, static_argnames=("vw", "vh", "mesh",
                                             "encode_trc", "precision"))
def _zoom_frame_sharded(spectrum, scaling_id, xnum, xden, ynum, yden,
                        vx, vy, vw: int, vh: int, mesh,
                        encode_trc: bool = False,
                        precision: Precision | None = None):
    from jax import shard_map  # noqa: PLC0415
    from jax.sharding import PartitionSpec as P  # noqa: PLC0415

    h, w = spectrum.shape[:2]
    ns = mesh.shape["space"]
    vhl = vh // ns

    def local(spec):
        si = jax.lax.axis_index("space")
        dtype = spec.dtype
        xb = _device_basis(scaling_id, xnum, xden, vx, vw, w, dtype)
        # this shard's output rows: the row start advances per shard as
        # an exact integer b0 (the basis is affine in b + offset, and
        # integer starts must stay out of the f32 offset scalar for the
        # native fold / k representability)
        yb = _device_basis(scaling_id, ynum, yden, vy, vhl, h, dtype,
                           b0=si * vhl)
        return _synth(spec, yb, xb, encode_trc, precision)

    fn = shard_map(local, mesh=mesh, in_specs=P(),
                   out_specs=P("space", None, None), check_vma=False)
    return fn(spectrum)


def zoom_frame_sharded(
    spectrum: jax.Array,
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    mesh,
    encode_trc: bool = False,
) -> jax.Array:
    """Device-mesh zoom frame: output rows shard over 'space', the
    spectrum replicates, each shard synthesises its own continuous
    basis rows — pure data parallelism, no collectives (the scaling
    analogue of the reference's per-column scalar loop,
    zoom/zoom.c:361-375).  Any ``vh`` works: the continuous basis
    extends past the view, so rows pad up to the space axis and the
    extras are sliced off."""
    ns = mesh.shape["space"]
    vhp = ceil_to(vh, ns)
    out = _zoom_frame_sharded(
        spectrum, jnp.asarray(_SCALING_IDS[scaling_type]),
        jnp.asarray(float(xscale[0])), jnp.asarray(float(xscale[1])),
        jnp.asarray(float(yscale[0])), jnp.asarray(float(yscale[1])),
        jnp.asarray(float(vx)), jnp.asarray(float(vy)), vw, vhp, mesh,
        encode_trc, get_precision(),
    )
    return out[:vh] if vhp != vh else out


@functools.partial(jax.jit, static_argnames=("mesh", "precision",
                                             "encode_trc"))
def _synthesize_sharded(spectrum, plan_y, plan_x, mesh, precision=None,
                        encode_trc: bool = False):
    """Planned synthesis with output rows sharded over the mesh 'space'
    axis: plan_y's rows split per shard (the scan row-sharding pattern,
    models/scan_pipeline.plan_spec), plan_x and the spectrum replicate
    — pure data parallelism, no collectives."""
    from jax import shard_map  # noqa: PLC0415
    from jax.sharding import PartitionSpec as P  # noqa: PLC0415

    from dspfun_tpu.parallel.mesh import plan_row_spec as row_spec  # noqa: PLC0415

    fn = shard_map(
        lambda s, py, px: _synthesize.__wrapped__(s, py, px, precision,
                                                  encode_trc),
        mesh=mesh,
        in_specs=(P(), row_spec(plan_y), jax.tree.map(lambda _: P(), plan_x)),
        out_specs=P("space", None, None),
        check_vma=False,
    )
    return fn(spectrum, plan_y, plan_x)


def zoom_frame(
    spectrum: jax.Array,
    scaling_type: str,
    xscale: tuple[float, float],
    yscale: tuple[float, float],
    vx: float,
    vy: float,
    vw: int,
    vh: int,
    precision: Precision | None = None,
    encode_trc: bool = False,
    mesh=None,
) -> jax.Array:
    """One output frame [vh, vw, C] of the continuous zoom via the
    planned host-float64 basis (the accuracy path: basis exact, error =
    contraction mode only; ~2^-28 digit truncation in deep-i8 mode).
    Plans cache, so repeated frames at fixed (scale, offset, view) —
    stills and constant animations — cost just two contractions per
    dispatch.  With ``mesh``, output rows shard over the 'space' axis
    (any height; rows pad internally through the extended basis)."""
    p = precision or get_precision()
    h, w = spectrum.shape[:2]
    if mesh is None:
        plan_y, plan_x = zoom_plan(scaling_type, xscale, yscale, vx, vy,
                                   vw, vh, w, h, p)
        return _synthesize(spectrum, plan_y, plan_x, p, encode_trc)
    ns = mesh.shape["space"]
    vhp = ceil_to(vh, ns)
    plan_y, plan_x = zoom_plan(scaling_type, xscale, yscale, vx, vy,
                               vw, vhp, w, h, p)
    out = _synthesize_sharded(spectrum, plan_y, plan_x, mesh, p, encode_trc)
    return out[:vh] if vhp != vh else out


def showsamples_coords(start: float, scale: float, limit: int) -> list[int]:
    """Marked sample positions along one axis: the reference's
    ``for(size_t y = scale - (size_t)off % (int)scale; y < vh; y += scale)``
    loop truncates to integer every step (zoom/zoom.c:379-390)."""
    out = []
    y = int(scale) - int(start) % int(scale)
    while y < limit:
        out.append(y)
        y = int(y + scale)
    return out


def overlay_showsamples(
    frame: np.ndarray,
    mode: str,
    xscale: float,
    yscale: float,
    vx: float,
    vy: float,
) -> np.ndarray:
    """Mark integer input-lattice positions in green when upscaling
    (reference zoom.c:377-391; the reference's row indexing uses a
    vh stride — a bug for non-square views — corrected here)."""
    if not (xscale > 1 and yscale > 1) or mode == "none":
        return frame
    vh, vw = frame.shape[:2]
    green = np.array([0.0, 1.0, 0.0])
    ys = showsamples_coords(vy, yscale, vh)
    xs = showsamples_coords(vx, xscale, vw)
    if mode == "point":
        for y in ys:
            frame[y, xs] = green
    elif mode == "grid":
        frame[ys, :] = green
        frame[:, xs] = green
    return frame


def default_view(w: int, h: int, xscale, yscale) -> tuple[int, int]:
    """Default view = full scaled size (reference zoom.c:286-289)."""
    vw = int(w * xscale[0] / xscale[1])
    vh = int(h * yscale[0] / yscale[1])
    return vw, vh


def resolve_position(
    vx: float, vy: float, vw: int, vh: int, w: int, h: int,
    xscale, yscale, centered: bool, input_coords: bool, pct_coords: bool,
) -> tuple[float, float]:
    """-p / -c / -P / -%% position semantics (reference zoom.c:292-303;
    the -%% path uses float division here, where the reference
    truncates, and scales vy by vh rather than vy — both reference
    bugs)."""
    xs = xscale[0] / xscale[1]
    ys = yscale[0] / yscale[1]
    if pct_coords:
        return vx * vw / 100.0, vy * vh / 100.0
    if input_coords:
        return vx * xs, vy * ys
    if centered:
        return (w * xs - vw) / 2.0, (h * ys - vh) / 2.0
    return vx, vy
