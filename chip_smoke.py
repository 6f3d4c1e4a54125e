#!/usr/bin/env python
"""Smoke run of dspfun's tools on one GPU, at the sizes users run.

Every phase drives a tool through its normal entry point
(``tool.main([...])`` in this one process: a JAX process reserves most
of the card's memory) and compares the result with a plain float64
numpy/scipy reference.  Input data is generated from ``--seed``.  Each
phase prints one line: shapes, max abs error and its bound, and the
precision policy that ran.  Any failure ends the run with a non-zero
exit code; the last line of a passing run is one JSON object naming
the device.

    python chip_smoke.py                # one GPU, every phase
    python chip_smoke.py --four-cards   # four GPUs, the mesh phases only
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
        # CPU rehearsal: tiny sizes, the GPU kernel in the Pallas
        # interpreter; the device phase fails and the run exits 1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np

FULL = {"still": (3840, 2160), "video": (1920, 1080, 32),
        "zoom_src": (1920, 1080), "i8_k": (2160, 3840)}
TINY = {"still": (320, 256), "video": (64, 48, 16),
        "zoom_src": (64, 48), "i8_k": (216, 384)}


def say(phase: str, **kv) -> None:
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items}", flush=True)


def check(phase: str, what: str, err: float, bound: float) -> None:
    if not err <= bound:  # also catches NaN
        raise AssertionError(f"{phase}: {what} error {err:.3e} > {bound:.1e}")


def smooth_image(rng, w: int, h: int) -> np.ndarray:
    """[h, w, 3] in [0, 1]: smooth gradients plus noise, a still with
    both a strong DC and fine detail."""
    y, x = np.mgrid[0:h, 0:w] / max(w, h)
    base = np.stack([0.5 + 0.35 * np.sin(9 * x + 2 * y),
                     0.5 + 0.35 * np.cos(7 * y - 3 * x),
                     0.3 + 0.4 * x * y], axis=-1)
    return np.clip(base + 0.1 * rng.standard_normal((h, w, 3)), 0.0, 1.0)


def write_png8(path: str, img: np.ndarray) -> None:
    from dspfun_tpu.io import images

    images.write_image(path, img)


def read_fvid(path: str) -> np.ndarray:
    from dspfun_tpu.io import video

    with video.open_input(path) as r:
        frames = []
        while (f := r.read_frame_rgb()) is not None:
            frames.append(f)
    return np.stack(frames)


def count_frames(path: str) -> int:
    from dspfun_tpu.io import video

    n = 0
    with video.open_input(path) as r:
        while r.read_frame(raw=True) is not None:
            n += 1
    return n


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(args) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    say("device", platform=d.platform, kind=repr(d.device_kind),
        count=len(devs), jax=jax.__version__)
    want = 4 if args.four_cards else 1
    if d.platform != "gpu":
        raise RuntimeError(f"device: platform {d.platform!r}, need 'gpu'")
    if len(devs) < want:
        raise RuntimeError(f"device: {len(devs)} devices, need {want}")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def _spec_flat_roundtrip_f64(img: np.ndarray, gain: float) -> np.ndarray:
    """`spec -t flat -G gain` then `ispec` in float64 scipy, with the
    16-bit PNG quantisation of the spectrum and of the result
    (reference spec/spec.c:63-139, ispec.c:84-167)."""
    import scipy.fft

    h, w, _ = img.shape
    nz_h = (np.arange(h) != 0).astype(int)
    nz_w = (np.arange(w) != 0).astype(int)
    grid = (np.sqrt(2.0) ** (nz_h[:, None] + nz_w[None, :]))[:, :, None]
    f = scipy.fft.dctn(img, type=2, axes=(0, 1)) * grid / (4.0 * w * h)
    stored = np.rint(np.clip((f / 2 + 0.5) * 254 / 255, 0, 1) * 65535)
    f = ((stored / 65535) * 255 / 254 - 0.5) * 2 / grid
    out = scipy.fft.dctn(f, type=3, axes=(0, 1))
    return np.rint(np.clip(out, 0, 1) * 65535) / 65535


def phase_spec(args, sz, td, rng) -> None:
    import jax
    import scipy.fft

    from dspfun_tpu.core.precision import Precision, get_precision
    from dspfun_tpu.io import images
    from dspfun_tpu.models import spec_pipeline as spp
    from dspfun_tpu.tools import ispec, spec

    w, h = sz["still"]
    src, spng, back = (os.path.join(td, n) for n in
                       ("src4k.png", "spec.png", "back.png"))
    write_png8(src, smooth_image(rng, w, h))
    flat = ["-t", "flat", "-G", "1000"]
    t0 = time.perf_counter()
    rc1 = spec.main([*flat, src, spng])
    t1 = time.perf_counter()
    rc2 = ispec.main([*flat, spng, back])
    t2 = time.perf_counter()
    if rc1 or rc2:
        raise RuntimeError(f"spec: rc spec={rc1} ispec={rc2}")
    orig = images.read_image(src).pixels
    got = images.read_image(back)
    if got.pixels.shape != orig.shape:
        raise AssertionError(f"spec: shape {got.pixels.shape} != {orig.shape}")
    # the float64 chain through the same 16-bit spectrum and image
    # files: the flat template's quantisation error grows with the
    # image size, so the device must match that floor, not a fixed one
    want = _spec_flat_roundtrip_f64(orig, 1000.0)
    rmse = float(np.sqrt(np.mean((got.pixels - orig) ** 2)))
    rmse_ref = float(np.sqrt(np.mean((want - orig) ** 2)))
    bound = 1.05 * rmse_ref + 2 / 65535
    policy = spp._whole_image_precision(get_precision(), orig.shape)
    say("spec", cli=f"{w}x{h} RGB flat -G 1000 round trip",
        out_depth=got.depth, rmse=f"{rmse:.4e}",
        f64_chain_rmse=f"{rmse_ref:.4e}", bound=f"{bound:.4e}",
        max_abs_vs_f64_chain=f"{np.max(np.abs(got.pixels - want)):.3e}",
        policy=policy.intermediate, spec_s=f"{t1 - t0:.1f}",
        ispec_s=f"{t2 - t1:.1f}")
    check("spec", "CLI round-trip rmse", rmse, bound)

    # library chain against the float64 scipy chain
    img = rng.random((h, w, 3)).astype(np.float32)
    params = spp.SpecChainParams.template("copy")
    n_h, n_w = h, w
    grid = np.sqrt(2.0) ** ((np.arange(n_h) != 0)[:, None]
                            + (np.arange(n_w) != 0)[None, :])
    F = scipy.fft.dctn(img.astype(np.float64), type=2, axes=(0, 1))
    f2 = (F * (grid * (params.gain / (4.0 * n_w * n_h)))[:, :, None]
          / (grid * params.gain)[:, :, None])
    oracle = scipy.fft.dctn(f2, type=3, axes=(0, 1))
    x = jax.device_put(img)
    for prec in (Precision(), Precision(intermediate="f32"),
                 Precision(intermediate="f32", tol=2e-5)):
        def roundtrip(a, pf, pi, p=prec):
            f, dc = spp.spec_forward(a, params, p, plans=pf)
            return spp.spec_inverse(f, params, dc=dc, precision=p, plans=pi)

        plans = jax.device_put((spp.whole_plans(img.shape, "dct2", prec),
                                spp.whole_plans(img.shape, "dct3", prec)))
        y = np.asarray(jax.jit(roundtrip)(x, *plans), np.float64)
        err = float(np.max(np.abs(y - oracle)))
        name = spp._whole_image_precision(prec, img.shape)
        say("spec", lib=f"{w}x{h}x3 spec_forward/spec_inverse",
            policy=f"{name.intermediate}@{name.tol}",
            max_abs=f"{err:.3e}", bound="1e-05" if prec == Precision()
            else "report")
        if prec == Precision():
            check("spec", "library chain", err, 1e-5)


def phase_fused2d(args, sz, rng) -> None:
    import jax
    import scipy.fft

    from dspfun_tpu.core.precision import Precision
    from dspfun_tpu.models.fused import (
        filter_plans, fused_filter_2d, lowpass_mask,
    )

    w, h = sz["still"]
    x_np = rng.random((h, w, 3)).astype(np.float32)
    mask = lowpass_mask((h, w), cutoff=0.25, boost=1.25,
                        damp=0.0)[:, :, None].astype(np.float32)
    ref = scipy.fft.dctn(x_np.astype(np.float64), type=2, axes=(0, 1))
    ref *= mask
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1)) / (4.0 * w * h)
    x, m = jax.device_put(x_np), jax.device_put(mask)
    for prec, bound in ((Precision(coeff="float32", intermediate="i8",
                                   tol=1e-5), 1e-5),
                        (Precision(intermediate="hilo"), None),
                        (Precision(intermediate="f32", tol=2e-5), None)):
        plans = jax.device_put(filter_plans((h, w), prec, mask=mask))
        fn = jax.jit(lambda a, mm, pl, p=prec: fused_filter_2d(a, mm, pl, p))
        if bound is not None:
            mem = fn.lower(x, m, plans).compile().memory_analysis()
            print(f"[fused2d] memory_analysis: {mem}", flush=True)
        y = np.asarray(fn(x, m, plans), np.float64)
        err = float(np.max(np.abs(y - ref)))
        say("fused2d", shape=f"{h}x{w}x3 pruned lowpass",
            policy=f"{prec.intermediate}@{prec.tol}", max_abs=f"{err:.3e}",
            bound=bound if bound is not None else "report")
        if bound is not None:
            check("fused2d", "4K chain", err, bound)


def make_clip(path: str, rng, w: int, h: int, nframes: int) -> np.ndarray:
    """8-bit 4:2:0 y4m clip; returns the luma planes [T, H, W]."""
    from dspfun_tpu.io import video

    props = video.parse_color_props("pixel_format=yuv420p")
    yy, xx = np.mgrid[0:h, 0:w]
    lumas = []
    with video.open_output(path, w, h, Fraction(25), props) as wr:
        for t in range(nframes):
            y = (128 + 60 * np.sin((xx + 3 * t) / 37.0) * np.cos(yy / 23.0)
                 + 20 * rng.standard_normal((h, w)))
            y = np.clip(np.rint(y), 0, 255).astype(np.uint8)
            c = rng.integers(64, 192, (2, h // 2, w // 2)).astype(np.uint8)
            wr.write_frame([y, c[0], c[1]], raw=True)
            lumas.append(y)
    return np.stack(lumas)


def phase_motion(args, sz, td, rng) -> None:
    import jax
    import jax.numpy as jnp
    import scipy.fft

    from dspfun_tpu.models import motion_pipeline as mp
    from dspfun_tpu.tools import motion

    w, h, d = sz["video"]
    clip = os.path.join(td, "clip.y4m")
    luma = make_clip(clip, rng, w, h, d)
    on_gpu = jax.default_backend() == "gpu"
    for blk, bp, want in (((8, 8, 8), (4, 4, 4), "xla-kron"),
                          ((16, 16, 16), (8, 8, 4),
                           "i8-kron" if on_gpu else "xla-sep")):
        out = os.path.join(td, f"motion{blk[0]}.y4m")
        argv = ["-Q", "-b", "x".join(map(str, blk)),
                "-p", "x".join(map(str, bp)), clip, out]
        t0 = time.perf_counter()
        rc = motion.main(argv)
        dt = time.perf_counter() - t0
        nout = count_frames(out) if rc == 0 else -1
        if rc or nout != d:
            raise RuntimeError(f"motion {argv}: rc={rc} frames={nout}/{d}")

        g = mp.plan_geometry(w, h, d, 3, 1, 1, block=mp.Dims(*blk),
                             bp_begin=mp.Dims(*bp))[0]
        params = mp.MotionParams(boost=1.0, damp=0.0)
        kron = mp.maybe_kron_plans(g, params)
        plans = jax.device_put((*mp.make_plans(g), kron) if kron is not None
                               else mp.make_plans(g))
        blocks = mp.frames_to_blocks(luma[:blk[2]].astype(np.float32), g)
        nb = blocks.shape[0]
        bc = (jnp.zeros(nb, jnp.int32), jnp.zeros(nb, jnp.int32))
        mp.LAST_FAST_PATH = None
        got, _ = mp.filter_blocks(jnp.asarray(blocks), plans, bc,
                                  jnp.asarray(0), geom=g, params=params,
                                  plane_index=0, nplanes=3)
        got = np.asarray(got, np.float64)
        mult = np.zeros((blk[2], blk[1], blk[0]))
        mult[bp[2]:, bp[1]:, bp[0]:] = 1.0
        F = scipy.fft.dctn(blocks.astype(np.float64), type=2,
                           axes=(1, 2, 3)) * mult[None]
        ref = scipy.fft.dctn(F, type=3, axes=(1, 2, 3)) / (8.0 * np.prod(blk))
        err = float(np.max(np.abs(got - ref)))
        bound = 5e-2 if mp.LAST_FAST_PATH == "i8-kron" else 1e-2
        say("motion", cli=" ".join(argv[1:5]), clip=f"{w}x{h}x{d} yuv420p",
            frames=nout, wall_s=f"{dt:.1f}", blocks=f"{nb}x{blk}",
            path=mp.LAST_FAST_PATH, max_abs_pel=f"{err:.3e}", bound=bound)
        if mp.LAST_FAST_PATH != want:
            raise AssertionError(f"motion: path {mp.LAST_FAST_PATH} != {want}")
        check("motion", "filter_blocks luma", err, bound)


def phase_zoom(args, sz, td, rng) -> None:
    import scipy.fft

    from dspfun_tpu.core.precision import get_precision
    from dspfun_tpu.io import images
    from dspfun_tpu.models import zoom_pipeline as zp
    from dspfun_tpu.tools import zoom

    w, h = sz["zoom_src"]
    src, out = os.path.join(td, "zsrc.png"), os.path.join(td, "zoom.fvid")
    write_png8(src, smooth_image(rng, w, h))
    t0 = time.perf_counter()
    rc = zoom.main(["-s", "2", "-n", "4", "-q", src, out])
    dt = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"zoom: rc={rc}")
    policy = get_precision()
    frames = read_fvid(out)
    if frames.shape != (4, 2 * h, 2 * w, 3):
        raise AssertionError(f"zoom: frames {frames.shape}")
    # float64 host-basis route of the same synthesis
    pix = images.read_image(src).pixels
    F = scipy.fft.dctn(pix, type=2, axes=(0, 1))
    xs = zp.clamp_scale(w, 2.0, 1.0)
    ys = zp.clamp_scale(h, 2.0, 1.0)
    vw, vh = zp.default_view(w, h, xs, ys)
    vx, vy = zp.resolve_position(0.0, 0.0, vw, vh, w, h, xs, ys,
                                 False, False, False)
    xb = zp.padded_zoom_basis("interpolated", *xs, vx, vw, w)
    yb = zp.padded_zoom_basis("interpolated", *ys, vy, vh, h)[::8]
    ref = np.einsum("jv,vuc,iu->jic", yb, F, xb, optimize=True) / (h * w)
    err = max(float(np.max(np.abs(f[::8] - ref))) for f in frames)
    say("zoom", cli=f"-s 2 -n 4 {w}x{h} -> {2 * w}x{2 * h}",
        frames=frames.shape[0], policy=f"{policy.intermediate}@{policy.tol}",
        max_abs=f"{err:.3e}", bound="1e-05", rows_compared=ref.shape[0],
        wall_s=f"{dt:.1f}")
    check("zoom", "frames vs float64 host basis", err, 1e-5)


def phase_scan(args, sz, td, rng) -> None:
    import scipy.fft

    from dspfun_tpu.io import images
    from dspfun_tpu.ops import scan_methods as sm
    from dspfun_tpu.tools import scan

    w, h = sz["zoom_src"]
    nframes, step = 4, 64
    src, out = os.path.join(td, "ssrc.png"), os.path.join(td, "scan.fvid")
    write_png8(src, smooth_image(rng, w, h))
    t0 = time.perf_counter()
    rc = scan.main(["-q", "-m", "zig", "-S", str(step), "-n", str(nframes),
                    src, out])
    dt = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"scan: rc={rc}")
    got = read_fvid(out)
    # float64 pruned IDCT: DC plus the first (i+1)*step zigzag steps
    img = images.read_image(src).pixels
    coeffs = scipy.fft.dctn(img, type=2, axes=(0, 1)) / (4.0 * w * h)
    order = sm.get_method("zigzag").build(w, h, coeffs=coeffs, args=None)
    err = 0.0
    for i in range(nframes):
        stop = int(order.starts[min((i + 1) * step, order.limit)])
        rec = np.zeros_like(coeffs)
        ys, xs = order.ys[:stop], order.xs[:stop]
        rec[ys, xs] = coeffs[ys, xs]
        rec[0, 0] = coeffs[0, 0]
        want = scipy.fft.dctn(rec, type=3, axes=(0, 1))
        err = max(err, float(np.max(np.abs(got[i] - want))))
    say("scan", cli=f"-m zig -S {step} -n {nframes} {w}x{h}",
        frames=got.shape[0], max_abs=f"{err:.3e}", bound="2e-03",
        wall_s=f"{dt:.1f}")
    if got.shape[0] != nframes:
        raise AssertionError(f"scan: {got.shape[0]} frames")
    check("scan", "frames vs float64 pruned IDCT", err, 2e-3)


def phase_i8(args, sz, rng) -> None:
    import jax
    import jax.numpy as jnp

    from dspfun_tpu.core import basis
    from dspfun_tpu.ops.int8mm import i8_contract, split_matrix_i8

    for k in sz["i8_k"]:
        m = basis.dct2_matrix(k)[: k // 4]      # the pruned support rows
        r = 3 * k // 2
        for ndig, bound in ((3, 1e-6), (4, 3e-7)):
            digits, scale = split_matrix_i8(m, ndig)
            for axis, shape in ((0, (k, r)), (1, (3, r, k))):
                axis = axis if axis == 0 else 2
                x = (rng.random(shape).astype(np.float32) - 0.3) * 4
                fn = jax.jit(lambda a, d=digits, s=scale, ax=axis:
                             i8_contract(a, jnp.asarray(d), jnp.asarray(s),
                                         ax, interpret=args.rehearse))
                y = np.asarray(fn(x), np.float64)
                ref = np.moveaxis(np.tensordot(
                    m, x.astype(np.float64), axes=[[1], [axis]]), 0, axis)
                rel = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
                say("i8", layout="left" if axis == 0 else "right",
                    digits=ndig, M=m.shape[0], K=k, operand=shape,
                    max_rel=f"{rel:.3e}", bound=bound)
                check("i8", f"K={k} {ndig} digits", rel, bound)


def phase_mesh(args, sz, td, rng) -> None:
    """--four-cards: the mesh paths users reach from the CLIs, each
    against the same run on one device."""
    from dspfun_tpu.io import images
    from dspfun_tpu.tools import ispec, motion, spec

    w, h, d = sz["video"]
    clip = os.path.join(td, "clip.y4m")
    make_clip(clip, rng, w, h, d)

    def planes(path):
        from dspfun_tpu.io import video

        with video.open_input(path) as r:
            out = []
            while (f := r.read_frame(raw=True)) is not None:
                out.append(np.concatenate([p.ravel() for p in f]))
        return np.stack(out).astype(np.int32)

    for tag, extra in (("block", ["-b", "8x8x8", "-p", "4x4x4"]),
                       ("whole-clip", ["-b", "0x0x0", "-p", "8x8x4"])):
        outs = {}
        for mesh in (None, "space=2,time=2"):
            out = os.path.join(td, f"m-{tag}-{mesh is not None}.y4m")
            argv = ["-Q", *extra, *(["--mesh", mesh] if mesh else []),
                    clip, out]
            t0 = time.perf_counter()
            rc = motion.main(argv)
            if rc:
                raise RuntimeError(f"mesh motion {argv}: rc={rc}")
            outs[mesh] = (planes(out), time.perf_counter() - t0)
        a, b = outs[None][0], outs["space=2,time=2"][0]
        diff = np.abs(a - b)
        say("mesh", tool="motion", mode=tag, mesh="space=2,time=2",
            frames=a.shape[0], max_abs_pel=int(diff.max()),
            pels_differing=int(np.count_nonzero(diff)), bound=1,
            wall_s=f"{outs[None][1]:.1f}/{outs['space=2,time=2'][1]:.1f}")
        if a.shape != b.shape or diff.max() > 1:
            raise AssertionError(f"mesh motion {tag}: max diff {diff.max()}")

    ws, hs = sz["still"]
    src = os.path.join(td, "src.png")
    write_png8(src, smooth_image(rng, ws, hs))
    orig = images.read_image(src).pixels
    want = _spec_flat_roundtrip_f64(orig, 1000.0)
    bound = 1.05 * float(np.sqrt(np.mean((want - orig) ** 2))) + 2 / 65535
    runs = {}
    for mesh in (None, "4"):
        spng, back = (os.path.join(td, f"{n}-{mesh}.png")
                      for n in ("spec", "back"))
        extra = ["-M", mesh] if mesh else []
        flat = ["-t", "flat", "-G", "1000"]
        if spec.main([*flat, *extra, src, spng]) or \
                ispec.main([*flat, *extra, spng, back]):
            raise RuntimeError(f"mesh spec -M {mesh} failed")
        runs[mesh] = (images.read_image(spng).pixels,
                      images.read_image(back).pixels)
    # the 16-bit spectra may differ by one quantisation step where f32
    # results straddle a rounding boundary; each image must then sit on
    # the float64 chain's quantisation floor, as in the spec phase
    ds = float(np.max(np.abs(runs[None][0] - runs["4"][0])))
    db = float(np.max(np.abs(runs[None][1] - runs["4"][1])))
    rmse = float(np.sqrt(np.mean((runs["4"][1] - orig) ** 2)))
    say("mesh", tool="spec/ispec", mesh="-M 4", shape=f"{hs}x{ws}x3",
        spectrum_max_abs=f"{ds:.3e}", spectrum_bound=f"{1.5 / 65535:.3e}",
        back_max_abs_vs_one_device=f"{db:.3e}", back_rmse=f"{rmse:.4e}",
        back_rmse_bound=f"{bound:.4e}")
    check("mesh", "spec -M 4 spectrum", ds, 1.5 / 65535)
    check("mesh", "ispec -M 4 image rmse", rmse, bound)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phases, on four GPUs")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes (never passes)")
    args = ap.parse_args(argv)

    from dspfun_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    sz = TINY if args.rehearse else FULL
    rng = np.random.default_rng(args.seed)
    try:
        device = phase_device(args)
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        if not args.rehearse:
            raise
        print(f"[device] FAILED (expected in a rehearsal): {e}", flush=True)
        device = None
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        if args.four_cards:
            phase_mesh(args, sz, td, rng)
        else:
            phase_spec(args, sz, td, rng)
            phase_fused2d(args, sz, rng)
            phase_motion(args, sz, td, rng)
            phase_zoom(args, sz, td, rng)
            phase_scan(args, sz, td, rng)
            phase_i8(args, sz, rng)
    print(f"[done] phases_s={time.perf_counter() - t0:.1f}", flush=True)
    if device is None:
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
