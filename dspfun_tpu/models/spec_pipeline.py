"""spec/ispec compute pipelines: invertible whole-image DCT spectrograms.

Jittable re-derivations of the scalar chains in reference spec/spec.c:63-139
and spec/ispec.c:84-167.  The whole chain — 2-D DCT-II, uniform-range
normalisation, gain, range max, log/linear scale, sign encode — is
elementwise around two matmuls, so XLA fuses it into a handful of
kernels.

Conventions (see SURVEY.md section 2.2):
* forward DCT-II is FFTW REDFT10, coefficients in ±4wh (spec.c:64);
* DC = F[0,0]/(4wh) = image mean, exported per channel (spec.c:66-68);
* "uniform range": F * sqrt(2)^(#nonzero idx) / (4wh), putting every
  coefficient in ±1 (spec.c:70-78);
* gain: native = 127.5*sqrt(4wh), reference = 127.5*1024, custom
  (spec.c:81-90);
* range: one = gain, dc = max channel DC*gain, dcs = per-channel
  (spec.c:92-108);
* scale: log = copysign(log1p|f|, f)/log1p(max), linear = f/max
  (spec.c:110-122);
* sign: abs | shift ((f/2+.5)*254/255) | saturate (1 if f>=0, DC texel
  exempt) | retain (spec.c:124-139).
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from dspfun_tpu.core.precision import Precision, get_precision
from dspfun_tpu.core.transforms import apply_plan, plan_axis, uniform_grid

__all__ = ["SpecChainParams", "spec_forward", "spec_inverse", "compute_gain",
           "whole_plans"]


@dataclasses.dataclass(frozen=True)
class SpecChainParams:
    """The -t/-R/-T/-S/-G option tuple (reference spec/spec.h:56-79).

    Templates: abs=(log,abs,native,dc), shift=(log,shift,native,one),
    flat=(linear,shift,custom,one), sign=(linear,saturate,custom,one),
    copy=(linear,retain,custom,one) (spec.h:71-79).
    """

    scaletype: str = "log"      # log | linear
    signtype: str = "abs"       # abs | shift | saturate | retain
    gaintype: str = "native"    # native | reference | custom
    rangetype: str = "dc"       # one | dc | dcs
    gain: float = 1.0           # used when gaintype == custom

    @classmethod
    def template(cls, name: str, gain: float = 1.0) -> "SpecChainParams":
        t = {
            "abs": ("log", "abs", "native", "dc"),
            "shift": ("log", "shift", "native", "one"),
            "flat": ("linear", "shift", "custom", "one"),
            "sign": ("linear", "saturate", "custom", "one"),
            "copy": ("linear", "retain", "custom", "one"),
        }[name]
        return cls(*t, gain=gain)


def _whole_image_precision(precision: Precision | None, shape) -> Precision:
    """Whole-image transforms upgrade hilo -> exact at >=256 px: hilo
    only bounds the *basis* representation error, and per-pass
    accumulation rounding dominates for long contractions.  The exact
    mode's error-free contraction
    (core/exact.py) restores the <=1e-5 BASELINE target at ~3x FLOPs —
    negligible for one whole-image transform per tool run."""
    p = precision or get_precision()
    if p.intermediate == "hilo" and min(int(shape[0]), int(shape[1])) >= 256:
        p = dataclasses.replace(p, intermediate="exact")
    return p


def whole_plans(shape, kind: str, precision: Precision | None = None):
    """(rows, cols) AxisPlans of the whole-image DCT ``kind`` over an
    [H, W, ...] image, under the (auto-upgraded) policy.  Pass them to
    jitted code as arguments (``plans=``): closed over, they become
    program constants — ~350 MB for a 4K exact-mode pair, which takes
    the GPU compiler minutes and is too large for the persistent
    compile cache."""
    p = _whole_image_precision(precision, shape)
    return plan_axis(int(shape[0]), kind, p), plan_axis(int(shape[1]), kind, p)


def _whole_dct(x: jnp.ndarray, kind: str, p: Precision,
               plans=None) -> jnp.ndarray:
    """Whole-image separable DCT over [H, W, C] with the rank-1
    DC-split hints (mean on forward, zero0 on inverse — exact algebra,
    see core/transforms.apply_plan).  The i8 mode runs channel-first so
    both contractions hit the transpose-free int8 kernel forms."""
    h, w = x.shape[:2]
    split = "mean" if kind == "dct2" else "zero0"
    ph, pw = plans if plans is not None else whole_plans(x.shape, kind, p)
    if p.intermediate == "i8" and x.ndim == 3:
        z = jnp.moveaxis(x, -1, 0)
        z = apply_plan(z, ph, 1, p, split=split)
        z = apply_plan(z, pw, 2, p, split=split)
        return jnp.moveaxis(z, 0, -1)
    x = apply_plan(x, ph, 0, p, split=split)
    return apply_plan(x, pw, 1, p, split=split)


def compute_gain(params: SpecChainParams, w: int, h: int) -> float:
    """reference spec/spec.c:81-90."""
    if params.gaintype == "native":
        return 127.5 * math.sqrt(w * h * 4)
    if params.gaintype == "reference":
        return 127.5 * 1024.0
    return float(params.gain)


def _range_max(params: SpecChainParams, gain: float, dc_gained: jnp.ndarray):
    """Per-channel scaling max (reference spec/spec.c:92-108).

    ``dc_gained`` is f[0,0,:] after gain (== DC * gain).
    """
    if params.rangetype == "one":
        return jnp.full_like(dc_gained, gain)
    if params.rangetype == "dc":
        return jnp.full_like(dc_gained, jnp.max(dc_gained))
    return dc_gained  # dcs


def spec_forward(
    x: jnp.ndarray,
    params: SpecChainParams,
    precision: Precision | None = None,
    plans=None,
):
    """Image [H, W, C] in [0,1] -> (spectrogram [H,W,C] in [0,1], DC [C]).

    DC is the per-channel image mean (what spec embeds as the "DC"
    property, reference spec/spec.c:66-68,145-148).  ``plans`` is
    :func:`whole_plans` ``(shape, "dct2")``, built here when omitted.
    """
    p = _whole_image_precision(precision, x.shape)
    h, w, d = x.shape
    gain = compute_gain(params, w, h)

    F = _whole_dct(x, "dct2", p, plans)
    grid = uniform_grid((h, w))[:, :, None]
    # uniform range +-1, then gain (spec.c:70-90); constants folded.
    f = F * jnp.asarray(grid * (gain / (4.0 * w * h)), dtype=F.dtype)

    dc = f[0, 0, :] / gain  # == image mean
    maxv = _range_max(params, gain, f[0, 0, :])

    if params.scaletype == "log":
        f = jnp.sign(f) * jnp.log1p(jnp.abs(f)) / jnp.log1p(maxv)
    else:
        f = f / maxv

    s = params.signtype
    if s == "abs":
        f = jnp.abs(f)
    elif s == "shift":
        f = (f / 2 + 0.5) * 254 / 255
    elif s == "saturate":
        sat = (f >= 0).astype(f.dtype)
        # the DC texel keeps its scaled value (spec.c:136: loop starts at d)
        mask = np.zeros((h, w, 1), dtype=bool)
        mask[0, 0, 0] = True
        f = jnp.where(jnp.asarray(mask), f, sat)
    elif s != "retain":
        raise ValueError(params.signtype)
    return f, dc


def signmap_restore(f, signmap, xp=jnp):
    """Sign restoration for ``abs`` spectrums from a ``spec -t sign``
    map (reference ispec.c:87-98): bytes >= 128 mean positive
    (copysign(f, tmp-128)), the DC texel keeps its own value, and the
    map's first texel carries DC.  Returns (signed f, dc).  ONE
    implementation for both the single-device chain and the --mesh
    host pre-pass (tools/ispec.py) so the convention cannot drift."""
    byte = xp.asarray(signmap) * 255.0
    dc = byte[0, 0, :] / 255.0
    not_dc = np.ones(f.shape[:2] + (1,), dtype=bool)
    not_dc[0, 0, 0] = False
    not_dc = xp.asarray(not_dc)
    f = xp.where(not_dc, xp.where(byte >= 128, xp.abs(f), -xp.abs(f)), f)
    return f, dc


def spec_inverse(
    f: jnp.ndarray,
    params: SpecChainParams,
    dc: jnp.ndarray | None = None,
    signmap: jnp.ndarray | None = None,
    preserve_dc: bool = False,
    precision: Precision | None = None,
    plans=None,
):
    """Spectrogram [H,W,C] -> image [H,W,C]; exact inverse of
    :func:`spec_forward` (reference spec/ispec.c:84-167).  ``plans`` is
    :func:`whole_plans` ``(shape, "dct3")``, built here when omitted.

    ``dc`` is the decoded "DC" property (required for dc/dcs ranges or
    preserve_dc unless a signmap supplies it).  ``signmap`` is the pixel
    array of a ``spec -t sign`` image in [0,1]; its first texel provides
    DC and its sign bit restores coefficient signs (ispec.c:87-98).
    """
    p = _whole_image_precision(precision, f.shape)
    h, w, d = f.shape
    gain = compute_gain(params, w, h)

    s = params.signtype
    not_dc_texel = np.ones((h, w, 1), dtype=bool)
    not_dc_texel[0, 0, 0] = False
    not_dc_texel = jnp.asarray(not_dc_texel)

    if s == "abs":
        if signmap is not None:
            f, dc = signmap_restore(f, signmap, jnp)
    elif s == "shift":
        f = (f * 255 / 254 - 0.5) * 2
    elif s == "saturate":
        f = jnp.where(not_dc_texel, f * 2 - 1, f)
    elif s != "retain":
        raise ValueError(params.signtype)

    if params.rangetype == "one":
        maxv = jnp.full((d,), gain, dtype=f.dtype)
    else:
        if dc is None:
            raise ValueError("DC required for dc/dcs range types")
        dcg = jnp.asarray(dc, dtype=f.dtype) * gain
        maxv = jnp.full((d,), jnp.max(dcg), dtype=f.dtype) if params.rangetype == "dc" else dcg

    if params.scaletype == "log":
        fm = f * jnp.log1p(maxv)
        f = jnp.sign(f) * jnp.expm1(jnp.abs(fm))
    else:
        f = f * maxv

    f = f / gain
    grid = uniform_grid((h, w))[:, :, None]
    f = f / jnp.asarray(grid, dtype=f.dtype)

    if preserve_dc:
        if dc is None:
            raise ValueError("DC required for preserve_dc")
        f = f.at[0, 0, :].set(jnp.asarray(dc, dtype=f.dtype))

    return _whole_dct(f, "dct3", p, plans)
