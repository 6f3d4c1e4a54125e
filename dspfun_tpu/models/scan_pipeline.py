"""Progressive frequency-scan reconstruction (the `scan` tool's compute).

The reference (scan/scan.c:421-527) reconstructs one frame at a time:
gather the next `step` scan indexes' coefficients, zero everything
else, run either a full FFTW IDCT or a pruned scalar synthesis over
just those coefficients, and accumulate into a running sum image.

Device formulation: frames are processed in fixed-size *chunks*.
For each chunk the per-frame coordinate lists (host metadata from
:mod:`dspfun_tpu.ops.scan_methods`) become padded [F, K] index arrays,
and the per-frame delta images are computed either

* **pruned**: gather the K active DCT-III basis columns per axis and
  synthesize with one batched matmul per chunk —
  ``delta[f] = By[:, ys_f] @ (v_f * Bx[:, xs_f])`` — an O(h*K*w)
  contraction replacing the reference's O(K*h*w) scalar loop
  (scan/scan.c:30-41); or
* **full**: scatter the coefficients into dense [F, h, w, c] grids and
  run the batched separable IDCT (two matmuls; scan/scan.c:359).

then ``cumsum`` over the frame axis turns deltas into the running
reconstruction for every frame of the chunk at once.  The DC term is
pre-added to the running sum exactly once (scan/scan.c:381-383) and
zeroed out of the coefficient source (scan/scan.c:444-445).

Parity measurement (scan/scan.c:508-526) runs on-device per frame.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from dspfun_tpu.core import basis as basis_mod
from dspfun_tpu.core.precision import Precision, get_precision
from dspfun_tpu.core.transforms import dct2_nd, plan_matrix, apply_plan_nd
from dspfun_tpu.ops.int8mm import ceil_to
from dspfun_tpu.ops.scan_order import ScanOrder

__all__ = ["ScanPlan", "plan_scan", "ScanChunkResult", "scan_chunks", "forward_coeffs"]


def forward_coeffs(image: np.ndarray, precision: Precision | None = None) -> jax.Array:
    """Image [H,W,C] -> DCT-II coefficients / 4wh
    (reference scan/scan.c:292-298, "non-uniform range -1..1")."""
    p = precision or get_precision()
    h, w = image.shape[:2]
    F = dct2_nd(jnp.asarray(image, dtype=p.coeff_dtype), (0, 1), p)
    return F / (4.0 * w * h)


@dataclasses.dataclass
class ScanPlan:
    """Host-side frame schedule + device basis plans."""

    height: int
    width: int
    channels: int
    nframes: int
    step: int
    offset: int
    limit: int
    # padded per-frame coords [nframes_padded, K]
    ys: np.ndarray
    xs: np.ndarray
    valid: np.ndarray
    # coords filled before the first frame (offset prefill), flat
    fill_ys: np.ndarray
    fill_xs: np.ndarray
    use_pruned: bool
    chunk: int
    plans_inv: tuple  # (AxisPlan_h, AxisPlan_w) for dct3

    @property
    def kmax(self) -> int:
        return self.ys.shape[1]


def _frame_coords(order: ScanOrder, limit: int, step: int, invert: bool,
                  frame_i: int) -> tuple[np.ndarray, np.ndarray]:
    """Coordinates covered by output frame ``frame_i`` (scan indices
    s in [i*step, (i+1)*step) clipped to limit, inverted if requested
    — reference scan/scan.c:422-427), deduplicated (set semantics, as
    in the reference's dense-scatter path)."""
    ys: list[np.ndarray] = []
    xs: list[np.ndarray] = []
    for s in range(frame_i * step, min((frame_i + 1) * step, limit)):
        j = limit - s - 1 if invert else s
        y, x = order.coords(j)
        ys.append(y)
        xs.append(x)
    if not ys:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    y = np.concatenate(ys)
    x = np.concatenate(xs)
    _, idx = np.unique(y.astype(np.int64) * (x.max() + 1 if len(x) else 1) + x,
                       return_index=True)
    idx.sort()
    return y[idx], x[idx]


def plan_scan(
    order: ScanOrder,
    width: int,
    height: int,
    channels: int = 3,
    step: int = 1,
    nframes: int = 0,
    offset: int = 0,
    invert: bool = False,
    use_pruned: bool | None = None,
    chunk: int = 8,
    precision: Precision | None = None,
) -> ScanPlan:
    """Build the frame schedule (reference scan/scan.c:343-350,386-427).

    Reference quirk replicated deliberately: ``offset`` counts *scan
    indices* for the prefill (scan.c:389) but *frames* for the schedule
    (scan.c:421 iterates i in [offset, offset+nframes) with frame i
    covering s in [i*step, (i+1)*step)), so with step > 1 the indices
    [offset, offset*step) are in neither; and the default nframes
    (scan.c:347-348) does not subtract offset, so offset runs end with
    empty (duplicate) frames.  Both match the C tool's output exactly.
    """
    limit = order.limit
    if not nframes or nframes > limit // step:
        nframes = (limit + step - 1) // step
    if offset >= limit:
        offset = limit - 1

    frames = []
    for i in range(offset, offset + nframes):
        frames.append(_frame_coords(order, limit, step, invert, i))
    kmax = max((len(y) for y, _ in frames), default=1) or 1

    npad = ((nframes + chunk - 1) // chunk) * chunk
    ys = np.zeros((npad, kmax), dtype=np.int32)
    xs = np.zeros((npad, kmax), dtype=np.int32)
    valid = np.zeros((npad, kmax), dtype=bool)
    for f, (y, x) in enumerate(frames):
        ys[f, : len(y)] = y
        xs[f, : len(x)] = x
        valid[f, : len(y)] = True

    # prefill coords: scan indices 0..offset-1 (reference scan.c:389-417)
    fy: list[np.ndarray] = []
    fx: list[np.ndarray] = []
    for i in range(offset):
        j = limit - i - 1 if invert else i
        y, x = order.coords(j)
        fy.append(y)
        fx.append(x)
    fill_ys = np.concatenate(fy) if fy else np.empty(0, np.int32)
    fill_xs = np.concatenate(fx) if fx else np.empty(0, np.int32)

    if use_pruned is None:
        # crossover: pruned synthesis is O(h*K*w) FLOPs per frame vs
        # O((h+w)*h*w) dense, but its basis-column gathers cost far
        # more than matmul FLOPs, so pruned only pays off when the
        # dense per-pixel cost (h+w) is very large and K tiny (the
        # crossover is not yet measured on the GPU).  (The reference's log2(w*h) threshold,
        # scan.c:349-350, reflects its scalar CPU loop.)  The pruned
        # gather reads plan.hi only, so exact-mode digit plans stick to
        # the dense path (which honours the error-free contraction).
        use_pruned = (min(height, width) >= 1024
                      and kmax * 32 <= min(height, width)
                      and (precision or get_precision()).intermediate != "exact")

    p = precision or get_precision()
    plans_inv = (
        plan_matrix(basis_mod.dct3_matrix(height), p),
        plan_matrix(basis_mod.dct3_matrix(width), p),
    )
    return ScanPlan(
        height=height, width=width, channels=channels, nframes=nframes,
        step=step, offset=offset, limit=limit, ys=ys, xs=xs, valid=valid,
        fill_ys=fill_ys, fill_xs=fill_xs, use_pruned=bool(use_pruned),
        chunk=chunk, plans_inv=plans_inv,
    )


@dataclasses.dataclass
class ScanChunkResult:
    sums: np.ndarray | None    # [F, H, W, C] running reconstruction
    #                            (None in packed mode)
    deltas: np.ndarray | None  # [F, H, W, C] per-frame contribution
    parity: np.ndarray | None  # [F] bool
    inter: np.ndarray | None = None  # [F, H, W, C] display-ready
    #                                  intermediates pane (device-side
    #                                  normalised/encoded)
    payload: np.ndarray | None = None  # [F, S] packed container bytes
    #                                    (io/device_pack packer output)


def _lround(x):
    """C lround: halfway cases away from zero (jnp.round is to-even)."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


@functools.partial(
    jax.jit,
    static_argnames=("use_pruned", "want_deltas", "measure_parity",
                     "parity_scale", "encode_trc", "inter_mode", "grid_h"),
)
def _scan_chunk(
    carry,          # [H, W, C] running sum (H may be a row shard)
    coeffs_nodc,    # [grid_h, W, C] DCT/4wh with DC zeroed
    ys, xs, valid,  # [F, K]
    plans_inv,      # (AxisPlan_h, AxisPlan_w); plan_h rows match carry
    orig,           # [H, W, C] or scalar 0
    dc,             # [C] DC per channel (intermediates pane offset)
    parity_scale,   # float: (1<<depth)-1, or 0 for float compare
    use_pruned: bool,
    want_deltas: bool,
    measure_parity: bool,
    encode_trc: bool = False,
    inter_mode: str | None = None,   # None | "unit" | "minmax"
    grid_h: int | None = None,       # full coefficient rows (row-sharded
    #                                  callers: H here is local, the
    #                                  scatter grid must be global)
):
    h, w, c = carry.shape
    f = ys.shape[0]
    v = coeffs_nodc[ys, xs, :] * valid[..., None].astype(coeffs_nodc.dtype)  # [F,K,C]

    plan_h, plan_w = plans_inv
    if use_pruned:
        # gather basis columns: By[:, ys] -> [F, H, K]
        by = jnp.moveaxis(jnp.asarray(plan_h.hi)[:, ys], 1, 0)
        bx = jnp.moveaxis(jnp.asarray(plan_w.hi)[:, xs], 1, 0)
        t = v[:, :, None, :] * bx[:, :, :, None].transpose(0, 2, 1, 3)  # [F,K,W,C]
        delta = jax.lax.dot_general(
            by, t.reshape(f, -1, w * c),
            (((2,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).reshape(f, h, w, c)
        if plan_h.lo is not None:
            by_lo = jnp.moveaxis(jnp.asarray(plan_h.lo)[:, ys], 1, 0)
            bx_lo = jnp.moveaxis(jnp.asarray(plan_w.lo)[:, xs], 1, 0)
            t_lo = v[:, :, None, :] * bx_lo[:, :, :, None].transpose(0, 2, 1, 3)
            delta = delta + jax.lax.dot_general(
                by, t_lo.reshape(f, -1, w * c),
                (((2,), (1,)), ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            ).reshape(f, h, w, c)
            delta = delta + jax.lax.dot_general(
                by_lo, t.reshape(f, -1, w * c),
                (((2,), (1,)), ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            ).reshape(f, h, w, c)
        delta = delta.astype(carry.dtype)
    else:
        fidx = jnp.broadcast_to(jnp.arange(f)[:, None], ys.shape)
        grid = jnp.zeros((f, grid_h or h, w, c), dtype=coeffs_nodc.dtype)
        grid = grid.at[fidx, ys, xs, :].set(v, mode="drop")
        delta = apply_plan_nd(grid, plans_inv, (1, 2))

    sums = carry[None] + jnp.cumsum(delta, axis=0)

    parity = None
    if measure_parity:
        if parity_scale > 0:
            eq = _lround(orig[None] * parity_scale) == _lround(sums * parity_scale)
        else:
            eq = orig[None].astype(jnp.float32) == sums.astype(jnp.float32)
        parity = jnp.all(eq.reshape(f, -1), axis=1)

    # display-side work stays on device (the host emission loop only
    # assembles panes and writes bytes — reference scan.c:461-491 does
    # this per pixel on the host)
    def _enc(x):
        if not encode_trc:
            return x
        from dspfun_tpu.io.color import srgb_encode  # noqa: PLC0415

        return srgb_encode(x, jnp)

    inter = None
    if inter_mode is not None:
        base = delta + dc[None, None, None, :]
        if inter_mode == "minmax":
            mn = jnp.min(base.reshape(f, -1, base.shape[-1]), axis=1)
            mx = jnp.max(base.reshape(f, -1, base.shape[-1]), axis=1)
            rng = jnp.where(mx - mn == 0, 1.0, mx - mn)
            inter = (base - mn[:, None, None, :]) / rng[:, None, None, :]
        elif inter_mode == "raw":
            # row-sharded minmax: the caller owns the global extrema
            # reduction + normalisation + encoding
            return sums[-1], _enc(sums), (delta if want_deltas else None), \
                base, parity
        else:  # "unit": fixed 0..1 window
            inter = base
        inter = _enc(inter)

    return sums[-1], _enc(sums), (delta if want_deltas else None), \
        inter, parity


def _shard_chunk_fn(mesh, h, use_pruned, want_deltas, measure_parity,
                    parity_scale, encode_trc, inter_mode, plans_inv):
    """Row-sharded chunk step: output rows shard over the mesh 'space'
    axis; the coefficient image replicates, each shard reconstructs its
    own rows (the pruned gather takes its own basis *rows*, the dense
    IDCT its own plan rows) — no collectives except the parity
    reduction and (round 3) the pmin/pmax pair that gives ``minmax``
    intermediates their global per-frame extrema."""
    from jax import shard_map  # noqa: PLC0415
    from jax.sharding import PartitionSpec as P  # noqa: PLC0415

    row = P("space", None, None)

    def local(carry_l, coeffs_nodc, ys, xs, valid, plan_h_l, plan_w,
              orig_l, dc):
        out = _scan_chunk(
            carry_l, coeffs_nodc, ys, xs, valid, (plan_h_l, plan_w),
            orig_l, dc, parity_scale=parity_scale, use_pruned=use_pruned,
            want_deltas=want_deltas, measure_parity=measure_parity,
            encode_trc=encode_trc, grid_h=h,
            inter_mode="raw" if inter_mode == "minmax" else inter_mode,
        )
        carry_n, disp, deltas, inter, parity = out
        if inter_mode == "minmax":
            # global per-frame extrema: mask this shard's padding rows
            # (odd heights pad to the space axis; their deltas are zero
            # but base = dc would contaminate the minimum), reduce over
            # the mesh, then normalise + encode like the single path
            f = inter.shape[0]
            lh = inter.shape[1]
            si = jax.lax.axis_index("space")
            validr = (si * lh + jnp.arange(lh)) < h
            vm = jnp.broadcast_to(validr[None, :, None, None], inter.shape)
            flat = inter.reshape(f, -1, inter.shape[-1])
            vflat = vm.reshape(f, -1, inter.shape[-1])
            mn = jax.lax.pmin(
                jnp.min(jnp.where(vflat, flat, jnp.inf), axis=1), "space")
            mx = jax.lax.pmax(
                jnp.max(jnp.where(vflat, flat, -jnp.inf), axis=1), "space")
            rng = jnp.where(mx - mn == 0, 1.0, mx - mn)
            inter = (inter - mn[:, None, None, :]) / rng[:, None, None, :]
            if encode_trc:
                from dspfun_tpu.io.color import srgb_encode  # noqa: PLC0415

                inter = srgb_encode(inter, jnp)
        if measure_parity:
            # frame parity = every shard's rows match
            parity = jax.lax.psum(
                1 - parity.astype(jnp.int32), "space") == 0
        return carry_n, disp, deltas, inter, parity

    # shard each plan by OUTPUT rows — the field-aware AxisPlan spec
    # builder shared with zoom's row-sharded synthesis
    from dspfun_tpu.parallel.mesh import plan_row_spec as plan_spec  # noqa: PLC0415

    frames_row = P(None, "space", None, None)  # [F, H/s, W, C]

    # construct the shard_map + jit wrapper ONCE (per scan_chunks
    # generator) so the per-chunk dispatch loop hits the trace cache
    # instead of re-tracing every chunk
    plan_h, plan_w = plans_inv
    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(row, P(), P(), P(), P(), plan_spec(plan_h),
                  jax.tree.map(lambda _: P(), plan_w),
                  row if measure_parity else P(), P()),
        out_specs=(row, frames_row,
                   frames_row if want_deltas else P(),
                   frames_row if inter_mode else P(),
                   P()),
        check_vma=False,
    ))

    def wrapped(carry, coeffs_nodc, ys, xs, valid, plans_inv2, orig, dc):
        ph, pw = plans_inv2
        return fn(carry, coeffs_nodc, ys, xs, valid, ph, pw, orig, dc)

    return wrapped


def _pad_plan_rows(plan, rows: int):
    """Zero-pad an AxisPlan's *output rows* to ``rows`` (row-sharded
    meshes need the output axis divisible by the space axis; zero rows
    synthesise zero output)."""
    from dspfun_tpu.core.transforms import AxisPlan  # noqa: PLC0415

    def pad(a, axis):
        if a is None:
            return None
        a = np.asarray(a)
        if a.ndim == 0 or a.shape[axis] >= rows:
            return a
        shape = list(a.shape)
        shape[axis] = rows - a.shape[axis]
        return np.concatenate([a, np.zeros(shape, dtype=a.dtype)], axis=axis)

    return AxisPlan(
        hi=pad(plan.hi, 0),
        lo=pad(plan.lo, 0),
        digits=pad(plan.digits, 1),
        # i8 plans carry a per-row [M, 1] scale; the zero pad value is
        # irrelevant since padded digit rows are all-zero
        scale=(pad(plan.scale, 0)
               if plan.scale is not None and np.ndim(plan.scale) == 2
               else plan.scale),
        rowsum=pad(plan.rowsum, 1),
    )


def scan_chunks(
    plan: ScanPlan,
    coeffs: jax.Array,
    orig: np.ndarray | None = None,
    parity_depth: int = 8,
    want_deltas: bool = False,
    encode_trc: bool = False,
    inter_mode: str | None = None,
    mesh=None,
    packer=None,
):
    """Generator over chunks of frames.

    Yields ``(frame_start, ScanChunkResult)``.  ``coeffs`` is the
    [H,W,C] output of :func:`forward_coeffs`.  ``encode_trc`` applies
    the sRGB OETF to the emitted panes on device; ``inter_mode``
    ("unit" | "minmax") produces the display-ready intermediates pane
    on device (``ScanChunkResult.inter``).  With ``mesh``, output rows
    shard over the mesh 'space' axis — any height (rows zero-pad
    internally) and any inter_mode (minmax reduces its extrema across
    shards).  ``packer`` (io/device_pack.make_packer)
    packs frames to container payload bytes ON DEVICE and the result
    carries ``payload`` instead of float ``sums`` — 4-12x less
    device->host traffic for integer-format outputs (the emission
    bottleneck, VERDICT r3 item 9).
    """
    h, w, c = plan.height, plan.width, plan.channels
    dc = np.asarray(coeffs[0, 0, :])
    coeffs_nodc = jnp.asarray(coeffs).at[0, 0, :].set(0.0)

    # mesh row-sharding: zero-pad output rows up to the space axis so
    # any height engages the mesh (pattern: parallel/sharded.py internal
    # padding); padded plan rows are all-zero -> padded output rows stay
    # zero and are sliced off on the host side
    hp = h
    plans_inv_src = plan.plans_inv
    if mesh is not None:
        ns = mesh.shape["space"]
        hp = ceil_to(h, ns)
        if hp != h:
            plans_inv_src = (_pad_plan_rows(plans_inv_src[0], hp),
                             plans_inv_src[1])
            if orig is not None:
                orig = np.pad(np.asarray(orig), ((0, hp - h), (0, 0), (0, 0)))
    # keep the inverse plans device-resident across chunks
    plans_inv = jax.device_put(plans_inv_src)

    # running sum starts as the DC everywhere (scan/scan.c:381-383)
    carry = jnp.broadcast_to(jnp.asarray(dc, dtype=coeffs.dtype), (h, w, c))
    if hp != h:
        carry = jnp.concatenate(
            [carry, jnp.zeros((hp - h, w, c), carry.dtype)], axis=0)

    # offset prefill: one dense IDCT over the filled coefficients
    # (reference scan.c:389-417)
    if len(plan.fill_ys):
        grid = jnp.zeros((h, w, c), dtype=coeffs.dtype)
        grid = grid.at[plan.fill_ys, plan.fill_xs, :].set(
            coeffs_nodc[plan.fill_ys, plan.fill_xs, :]
        )
        carry = carry + apply_plan_nd(grid[None], plans_inv, (1, 2))[0]

    measure_parity = orig is not None
    orig_dev = jnp.asarray(orig) if measure_parity else jnp.zeros((), coeffs.dtype)
    scale = float((1 << parity_depth) - 1) if parity_depth < 32 else 0.0

    dc_dev = jnp.asarray(dc, dtype=coeffs.dtype)

    step_fn = None
    if mesh is not None:
        step_fn = _shard_chunk_fn(
            mesh, h, plan.use_pruned, want_deltas, measure_parity,
            scale, encode_trc, inter_mode, plans_inv,
        )

    def dispatch(start):
        end = start + plan.chunk
        nonlocal carry
        args = (
            carry, coeffs_nodc,
            jnp.asarray(plan.ys[start:end]), jnp.asarray(plan.xs[start:end]),
            jnp.asarray(plan.valid[start:end]),
            plans_inv, orig_dev, dc_dev,
        )
        if step_fn is not None:
            carry, disp, deltas, inter, parity = step_fn(*args)
        else:
            carry, disp, deltas, inter, parity = _scan_chunk(
                *args, parity_scale=scale,
                use_pruned=plan.use_pruned, want_deltas=want_deltas,
                measure_parity=measure_parity, encode_trc=encode_trc,
                inter_mode=inter_mode,
            )
        packed = None
        if packer is not None:
            packed = packer(disp[:, :h] if hp != h else disp)
            disp = None
        # start the device->host copies early so the next chunk's
        # compute overlaps this chunk's download (D2H is a large share
        # of the frame-emitting tools' time)
        for arr in (disp, deltas, inter, parity, packed):
            if arr is not None:
                try:
                    arr.copy_to_host_async()
                except AttributeError:
                    pass
        return disp, deltas, inter, parity, packed

    def materialise(start, bufs):
        disp, deltas, inter, parity, packed = bufs
        nvalid = min(plan.chunk, plan.nframes - start)

        def rows(a):  # drop the mesh padding rows
            return np.asarray(a[:nvalid, :h]) if hp != h else np.asarray(a[:nvalid])

        return start, ScanChunkResult(
            sums=rows(disp) if disp is not None else None,
            deltas=rows(deltas) if deltas is not None else None,
            parity=np.asarray(parity[:nvalid]) if parity is not None else None,
            inter=rows(inter) if inter is not None else None,
            payload=np.asarray(packed[:nvalid]) if packed is not None else None,
        )

    pending = None
    for start in range(0, plan.nframes, plan.chunk):
        bufs = dispatch(start)
        if pending is not None:
            yield materialise(*pending)
        pending = (start, bufs)
    if pending is not None:
        yield materialise(*pending)
