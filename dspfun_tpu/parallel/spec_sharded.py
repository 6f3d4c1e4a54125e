"""Sharded whole-image spec/ispec: the huge-image scaling path.

The spec tools transform the *entire* image in one 2-D DCT
(reference spec/spec.c:63); a wall-sized image on one chip is bound by
HBM and single-chip FLOPs.  Here the image rows are sharded over the
mesh 'space' axis, the separable transform runs Ulysses-style (DCT the
locally-complete W axis, all_to_all to re-localise H, DCT H), and the
spec scalar chain (reference spec.c:66-139) runs elementwise over
global coefficient coordinates — the DC / range maxima are psum'd.

Single-device parity: the same AxisPlan matmuls apply per shard, and
the chain mirrors models.spec_pipeline exactly.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import numpy as np

from dspfun_tpu.core.precision import Precision
from dspfun_tpu.core.transforms import apply_plan, plan_axis, plan_matrix
from dspfun_tpu.models.spec_pipeline import (
    SpecChainParams, _whole_image_precision, compute_gain,
)

__all__ = ["image_sharding", "spectrum_sharding",
           "spec_forward_sharded", "spec_inverse_sharded"]


def image_sharding(mesh: Mesh) -> NamedSharding:
    """[H, W, C] pel layout: rows over 'space'."""
    return NamedSharding(mesh, P("space", None, None))


def spectrum_sharding(mesh: Mesh) -> NamedSharding:
    """[H, W, C] coefficient layout: columns over 'space' (after the
    forward all_to_all)."""
    return NamedSharding(mesh, P(None, "space", None))


def _swap(x, split_axis, concat_axis):
    return jax.lax.all_to_all(x, "space", split_axis=split_axis,
                              concat_axis=concat_axis, tiled=True)


def _psum(x):
    return jax.lax.psum(x, "space")


def _padded_plan(n0: int, n: int, kind: str, p):
    """Plan for an axis zero-padded from n0 to n: extra basis COLUMNS
    are zero (padded inputs contribute nothing) and extra ROWS are zero
    (padded outputs are zero and sliced off) — identical algebra to the
    unpadded transform, but every shard size divides the mesh."""
    if n == n0:
        return plan_axis(n0, kind, p)
    from dspfun_tpu.core import basis as basis_mod  # noqa: PLC0415

    m = basis_mod.dct2_matrix(n0) if kind == "dct2" else basis_mod.dct3_matrix(n0)
    return plan_matrix(np.pad(m, ((0, n - n0), (0, n - n0))), p)


def _grid_factors(h, xg):
    """uniform-range sqrt(2)^(#nonzero) factors for a [H, W/s] shard
    (the column factors come entirely from the global coords xg)."""
    gy = jnp.where(jnp.arange(h) > 0, math.sqrt(2.0), 1.0)[:, None]
    gx = jnp.where(xg > 0, math.sqrt(2.0), 1.0)[None, :]
    return (gy * gx)[:, :, None]


def spec_forward_sharded(
    x: jax.Array,                    # [H, W, C] image_sharding
    params: SpecChainParams,
    mesh: Mesh,
    precision: Precision | None = None,
    true_shape: tuple[int, int] | None = None,
):
    """Sharded spec_forward.  Returns (spectrum [H, W, C] with
    spectrum_sharding, dc [C] replicated).

    ``x`` may be zero-padded up to the mesh (rows AND columns); pass
    the true image dims via ``true_shape`` — the chain computes
    gain/normalisation from them and the padded region comes back as
    garbage to slice off (its basis rows/columns are zero).
    """
    p = _whole_image_precision(precision, x.shape)
    h, w, c = (int(s) for s in x.shape)
    h0, w0 = true_shape if true_shape is not None else (h, w)
    plans = _device_plans(mesh, p, "dct2", h0, h, w0, w)
    return _forward_fn(params, mesh, p, h, w, c, h0, w0)(x, *plans)


@functools.lru_cache(maxsize=8)
def _device_plans(mesh, p, kind, h0, h, w0, w):
    """(rows, cols) padded plans replicated over the mesh once: jit
    arguments, not program constants (see spec_pipeline.whole_plans)."""
    plans = (_padded_plan(h0, h, kind, p), _padded_plan(w0, w, kind, p))
    return jax.device_put(plans, NamedSharding(mesh, P()))


@functools.lru_cache(maxsize=32)
def _forward_fn(params, mesh, p, h, w, c, h0, w0):
    gain = compute_gain(params, w0, h0)

    def local(shard, plan_h, plan_w):
        F = apply_plan(shard, plan_w, 1, p)      # W local
        F = _swap(F, 1, 0)                       # -> [H, W/s, C]
        F = apply_plan(F, plan_h, 0, p)

        si = jax.lax.axis_index("space")
        lw = F.shape[1]
        xg = si * lw + jnp.arange(lw)
        f = F * (_grid_factors(h, xg) * (gain / (4.0 * w0 * h0))).astype(F.dtype)

        origin = ((jnp.arange(h) == 0)[:, None] & (xg == 0)[None, :])[..., None]
        dc_gained = _psum(jnp.sum(jnp.where(origin, f, 0.0), axis=(0, 1)))
        dc = dc_gained / gain

        if params.rangetype == "one":
            maxv = jnp.full((c,), gain, dtype=f.dtype)
        elif params.rangetype == "dc":
            maxv = jnp.full((c,), jnp.max(dc_gained), dtype=f.dtype)
        else:  # dcs
            maxv = dc_gained

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
            f = jnp.where(origin, f, sat)  # DC texel keeps its value
        elif s != "retain":
            raise ValueError(params.signtype)
        return f, dc

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("space", None, None), P(), P()),
        out_specs=(P(None, "space", None), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def spec_inverse_sharded(
    f: jax.Array,                    # [H, W, C] spectrum_sharding
    params: SpecChainParams,
    mesh: Mesh,
    dc=None,
    preserve_dc: bool = False,
    precision: Precision | None = None,
    true_shape: tuple[int, int] | None = None,
):
    """Sharded spec_inverse (signmap handling stays host-side — it is a
    one-shot elementwise pre-pass the caller applies before sharding).
    Returns the image [H, W, C] with image_sharding."""
    p = _whole_image_precision(precision, f.shape)
    h, w, c = (int(s) for s in f.shape)
    h0, w0 = true_shape if true_shape is not None else (h, w)
    fn = _inverse_fn(params, mesh, p, h, w, c, dc is None, preserve_dc,
                     h0, w0)
    dc_arr = (jnp.zeros((c,), jnp.float32) if dc is None
              else jnp.asarray(dc, jnp.float32))
    return fn(f, dc_arr, *_device_plans(mesh, p, "dct3", h0, h, w0, w))


@functools.lru_cache(maxsize=32)
def _inverse_fn(params, mesh, p, h, w, c, dc_missing, preserve_dc, h0, w0):
    gain = compute_gain(params, w0, h0)

    def local(shard, dc_arr, plan_h, plan_w):
        si = jax.lax.axis_index("space")
        lw = shard.shape[1]
        xg = si * lw + jnp.arange(lw)
        origin = ((jnp.arange(h) == 0)[:, None] & (xg == 0)[None, :])[..., None]

        g = shard
        s = params.signtype
        if s == "shift":
            g = (g * 255 / 254 - 0.5) * 2
        elif s == "saturate":
            g = jnp.where(origin, g, g * 2 - 1)
        elif s not in ("abs", "retain"):
            raise ValueError(params.signtype)

        if params.rangetype == "one":
            maxv = jnp.full((c,), gain, dtype=g.dtype)
        else:
            if dc_missing:
                raise ValueError("DC required for dc/dcs range types")
            dcg = dc_arr.astype(g.dtype) * gain
            maxv = (jnp.full((c,), jnp.max(dcg), dtype=g.dtype)
                    if params.rangetype == "dc" else dcg)

        if params.scaletype == "log":
            gm = g * jnp.log1p(maxv)
            g = jnp.sign(g) * jnp.expm1(jnp.abs(gm))
        else:
            g = g * maxv

        g = g / gain
        g = g / _grid_factors(h, xg).astype(g.dtype)
        if preserve_dc:
            if dc_missing:
                raise ValueError("DC required for preserve_dc")
            g = jnp.where(origin, dc_arr.astype(g.dtype), g)

        y = apply_plan(g, plan_h, 0, p)          # H local
        y = _swap(y, 0, 1)                       # -> [H/s, W, C]
        return apply_plan(y, plan_w, 1, p)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "space", None), P(), P(), P()),
        out_specs=P("space", None, None),
        check_vma=False,
    )
    return jax.jit(fn)
