#!/usr/bin/env python
"""Benchmark: fused 2-D DCT + filter + IDCT throughput on a 4K image.

Per BASELINE.md: the reference publishes no numbers, so the baseline is
single-core FFTW measured locally (scipy.fft/pocketfft as the proxy,
workers=1, float64 — the reference spec builds with COEFF_PRECISION=D).
Target: >10x single-core FFTW per GPU at <=1e-5 max abs error vs the
double-precision result.

Runs on a GPU only: on any other platform it fails.  Prints ONE JSON
line:
  {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N,
   "device": {...}, "gpu": "<name>, <power limit>", "path": ..., ...}
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import scipy.fft

    import jax
    from dspfun_tpu.core.precision import Precision
    from dspfun_tpu.models.fused import filter_plans, fused_filter_2d, lowpass_mask
    from dspfun_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    enable_compilation_cache()

    h, w, c = 2160, 3840, 3  # 4K RGB
    rng = np.random.default_rng(0)
    x_np = rng.random((h, w, c)).astype(np.float32)
    mask_np = lowpass_mask((h, w), cutoff=0.25, boost=1.25, damp=0.0)[:, :, None]

    xd = x_np.astype(np.float64)
    base_dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        ref = scipy.fft.dctn(xd, type=2, axes=(0, 1), workers=1)
        ref *= mask_np
        ref = scipy.fft.dctn(ref, type=3, axes=(0, 1), workers=1) / (4.0 * w * h)
        base_dt = min(base_dt, time.perf_counter() - t0)
    base_mps = (h * w) / base_dt / 1e6

    # int8 Ozaki digit contraction (ops/int8mm.py; exact int32
    # accumulation) + rank-1 DC-split (mean/zero0 applied analytically)
    # + mask-support pruning — only the pass-band coefficients are
    # computed (the fused-chain generalisation of scan's pruned IDCT,
    # reference scan/scan.c:20-41; identical algebra)
    precision = Precision(coeff="float32", intermediate="i8", tol=1e-5)
    path = f"fused_filter_2d {precision.intermediate}@{precision.tol} pruned"
    # plans are host numpy; ship them to device memory once (they are
    # the FFTW-plan analogue and must not be re-uploaded per call)
    plans = jax.device_put(filter_plans((h, w), precision, mask=mask_np))
    fn = jax.jit(lambda a, m, pl: fused_filter_2d(a, m, pl, precision))

    x = jax.device_put(x_np)
    m = jax.device_put(mask_np.astype(np.float32))
    y = fn(x, m, plans)
    err = float(np.max(np.abs(np.asarray(jax.device_get(y), np.float64) - ref)))

    # Shared two-point estimator (benchmarks/timing.py): delta-sized
    # fori_loop chains, spike-confirmed stop, median over the positive
    # readings, (min, max) band for the artifact.  *0.5 keeps
    # magnitudes finite over long chains (the mask's 1.25x boost would
    # compound); the multiply fuses into the chain.
    from benchmarks.timing import time_fori

    dt, band = time_fori(lambda v: fn(v, m, plans) * 0.5, x, iters=5)
    if band is None:
        band = (dt, dt)
    spread = [(h * w) / band[1] / 1e6, (h * w) / band[0] / 1e6]
    ours_mps = (h * w) / dt / 1e6

    print(
        json.dumps(
            {
                "metric": "megapixels/sec fused 2D DCT+filter+IDCT (4K RGB)",
                "value": round(ours_mps, 2),
                "unit": "MP/s",
                "vs_baseline": round(ours_mps / base_mps, 2),
                "baseline_MP/s": round(base_mps, 2),
                "max_abs_err_vs_f64": err,
                "spread_MP/s": [round(spread[0], 2), round(spread[1], 2)],
                "timing": "median of 5 two-point measurements",
                "path": path,
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "gpu": gpu,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
