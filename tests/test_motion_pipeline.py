"""motion pipeline unit tests (vs reference motion/motion.c chain)."""

import numpy as np
import scipy.fft

from dspfun_tpu.core.expr import parse_expr
from dspfun_tpu.models import motion_pipeline as mp

Dims = mp.Dims


def run_plane(frames, geom, params, plans=None):
    import jax.numpy as jnp

    plans = plans or mp.make_plans(geom)
    bd = geom.block.d
    outs = []
    coded = 0
    for bz in range(geom.nblocks.d):
        blocks = mp.frames_to_blocks(frames[bz * bd : (bz + 1) * bd], geom)
        nb = blocks.shape[0]
        bx = np.arange(nb, dtype=np.int32) % geom.nblocks.w
        by = np.arange(nb, dtype=np.int32) // geom.nblocks.w
        out, c = mp.filter_blocks(
            jnp.asarray(blocks), plans, (jnp.asarray(bx), jnp.asarray(by)),
            jnp.asarray(bz), geom=geom, params=params, plane_index=0, nplanes=1,
        )
        outs.append(mp.blocks_to_frames(np.asarray(out), geom))
        coded += int(np.asarray(c).sum())
    return np.concatenate(outs), coded


def geometry(w, h, d, block=Dims(0, 0, 1), scaled=Dims(), **kw):
    return mp.plan_geometry(w, h, d, 1, block=block, scaled=scaled, **kw)[0]


def test_geometry_defaults_full_frame():
    g = geometry(32, 16, 8)
    assert g.block == Dims(32, 16, 1)
    assert g.scaled == g.block
    assert g.nblocks == Dims(1, 1, 8)
    assert g.bp_end == g.block


def test_geometry_chroma_propagation():
    planes = mp.plan_geometry(33, 17, 4, 3, log2_chroma_w=1, log2_chroma_h=1,
                              block=Dims(16, 16, 2))
    assert planes[0].block == Dims(16, 16, 2)
    assert planes[1].source == Dims(17, 9, 4)  # ceil(33/2), ceil(17/2)
    assert planes[1].block == Dims(8, 8, 2)
    # bandpass end defaults to the block per plane
    assert planes[1].bp_end == planes[1].block


def test_identity_roundtrip():
    """quant=0, no filters: IDCT(DCT(x)) normalization is exact identity
    (motion.c:746-771 scalefactor*normalization^2 chain)."""
    rng = np.random.default_rng(0)
    frames = rng.random((4, 16, 16)) * 255.0
    g = geometry(16, 16, 4, block=Dims(8, 8, 2))
    out, _ = run_plane(frames, g, mp.MotionParams())
    assert out.shape == (4, 16, 16)
    np.testing.assert_allclose(out, frames, atol=1e-3)


def test_lowpass_bandpass():
    """Bandpass keeping only DC of each 4x4x1 block -> blockwise means."""
    rng = np.random.default_rng(1)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1, block=Dims(4, 4, 1), bp_end=Dims(1, 1, 1))
    out, _ = run_plane(frames, g, mp.MotionParams(boost=1.0, damp=0.0))
    for by in range(2):
        for bx in range(2):
            blk = frames[0, by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4]
            np.testing.assert_allclose(
                out[0, by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4],
                blk.mean(), atol=1e-3,
            )


def test_block_upscale():
    """scaled > block: zero-pad spectrum = smooth DCT interpolation;
    constant input stays constant."""
    frames = np.full((1, 4, 4), 100.0)
    g = geometry(4, 4, 1, block=Dims(4, 4, 1), scaled=Dims(8, 8, 1))
    out, _ = run_plane(frames, g, mp.MotionParams())
    assert out.shape == (1, 8, 8)
    np.testing.assert_allclose(out, 100.0, atol=1e-3)


def test_block_downscale():
    """scaled < block truncates the spectrum (motion.c:566)."""
    rng = np.random.default_rng(2)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1, block=Dims(8, 8, 1), scaled=Dims(4, 4, 1))
    out, _ = run_plane(frames, g, mp.MotionParams())
    assert out.shape == (1, 4, 4)
    # oracle: truncated DCT-III with uniform-renorm resize semantics
    F = scipy.fft.dctn(frames[0], type=2)
    # reference scaling: out = IDCT_4(F[:4,:4]) * scaled_vol/block_vol / (8*scaled_vol) * 8
    rec = scipy.fft.idctn(F[:4, :4] * (16 / 64), type=2, norm=None)
    rec = scipy.fft.dctn(F[:4, :4], type=3) * (16 / 64) / (4 * 4 * 4)
    np.testing.assert_allclose(out[0], rec, atol=1e-2)


def test_quant_zeroes_and_counts():
    rng = np.random.default_rng(3)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1)
    out_hi, coded_hi = run_plane(frames, g, mp.MotionParams(quant=0.001))
    out_lo, coded_lo = run_plane(frames, g, mp.MotionParams(quant=10.0))
    assert coded_lo < coded_hi <= 64
    # heavy quantization loses detail
    assert np.abs(out_lo - frames).max() > np.abs(out_hi - frames).max()


def test_coeff_limit_keeps_top_n():
    rng = np.random.default_rng(4)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1)
    out, _ = run_plane(frames, g, mp.MotionParams(coeff_limit=1, quant=1e-9))
    # only DC survives (largest magnitude after uniform renorm) -> flat
    assert np.abs(out[0] - out[0].mean()).max() < 1.0


def test_threshold():
    frames = np.full((1, 4, 4), 128.0)
    frames[0, 0, 0] = 255.0
    g = geometry(4, 4, 1)
    # absurdly high min threshold zeroes everything incl. DC
    out, _ = run_plane(
        frames, g, mp.MotionParams(threshold_min=1e5, threshold_max=1e6)
    )
    np.testing.assert_allclose(out, 0.0, atol=1e-3)


def test_preserve_dc():
    rng = np.random.default_rng(5)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1, bp_begin=Dims(1, 1, 0), bp_end=Dims(8, 8, 1))
    # dc is inside the stop region (begin > 0) and would be damped
    out_no, _ = run_plane(frames, g, mp.MotionParams(damp=0.0))
    out_dc, _ = run_plane(frames, g, mp.MotionParams(damp=0.0, preserve_dc="dc"))
    assert abs(out_dc[0].mean() - frames[0].mean()) < 1.0
    assert abs(out_no[0].mean()) < abs(out_dc[0].mean())


def test_expr_scales_coefficients():
    rng = np.random.default_rng(6)
    frames = rng.random((2, 8, 8)) * 255.0
    g = geometry(8, 8, 2, block=Dims(8, 8, 2))
    expr = parse_expr("c/2", ("c", "x", "y", "z", "i", "width", "height",
                              "depth", "components", "bx", "by", "bz",
                              "bwidth", "bheight", "bdepth"))
    out, _ = run_plane(frames, g, mp.MotionParams(expr=expr))
    np.testing.assert_allclose(out, frames / 2.0, atol=1e-2)


def test_spectrogram_and_inverse_roundtrip():
    """spec shift -> ispec shift is an (approximate) identity chain
    (motion.c:627-638 vs 755-771)."""
    rng = np.random.default_rng(7)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1)
    spec_out, _ = run_plane(frames, g, mp.MotionParams(spec="shift"))
    assert spec_out.shape == (1, 8, 8)
    back, _ = run_plane(spec_out, g, mp.MotionParams(ispec="shift"))
    np.testing.assert_allclose(back, frames, atol=0.2)


def test_spectrogram_flat_copy_roundtrip():
    rng = np.random.default_rng(8)
    frames = rng.random((1, 8, 8)) * 255.0
    g = geometry(8, 8, 1)
    for mode in ("flat", "copy"):
        spec_out, _ = run_plane(frames, g, mp.MotionParams(spec=mode))
        back, _ = run_plane(spec_out, g, mp.MotionParams(ispec=mode))
        np.testing.assert_allclose(back, frames, atol=0.2, err_msg=mode)


def test_dither_preserves_mean():
    rng = np.random.default_rng(9)
    frames = rng.random((1, 16, 16)) * 255.0
    g = geometry(16, 16, 1)
    p = mp.MotionParams(quant=2.0, dither=True, float_pixels=False)
    out, _ = run_plane(frames, g, p)
    assert out.dtype.kind == "f"
    assert np.all(out >= 0) and np.all(out <= 255)
    assert np.all(out == np.round(out))  # integer pel values
    p2 = mp.MotionParams(quant=2.0, dither=False, float_pixels=False)
    out2, _ = run_plane(frames, g, p2)
    # dithering preserves the local mean better than rounding alone
    assert abs(out.mean() - frames.mean()) <= abs(out2.mean() - frames.mean()) + 0.5


def test_temporal_3d_blocks():
    """3-D blocks with depth 4: temporal lowpass removes flicker."""
    base = np.random.default_rng(10).random((8, 8)) * 200 + 25
    frames = np.stack([base + (12 if t % 2 else -12) for t in range(4)])
    g = geometry(8, 8, 4, block=Dims(8, 8, 4), bp_end=Dims(8, 8, 1))
    out, _ = run_plane(frames, g, mp.MotionParams(damp=0.0))
    # temporal DC only -> all frames identical
    np.testing.assert_allclose(out[0], out[3], atol=1e-3)
    np.testing.assert_allclose(out[0], base, atol=1.0)


def test_i8_kron_fast_path_matches_xla_sep():
    """Round 4 (VERDICT r3 item 3): the support-pruned int8 Kronecker
    fast path is exact algebra over the pass band and must match the
    separable formulation within the int8 digit accuracy."""
    import jax

    rng = np.random.default_rng(11)
    d = 8
    g = mp.plan_geometry(32, 32, d, 1, block=mp.Dims(16, 16, d),
                         bp_end=mp.Dims(8, 8, 4))[0]
    params = mp.MotionParams(boost=1.25, damp=0.0)
    frames = rng.random((d, 32, 32)).astype(np.float32) * 255
    base = mp.make_plans(g)
    kron = mp.maybe_kron_plans(g, params, allow_cpu=True)
    assert kron is not None
    blocks = mp.frames_to_blocks(frames, g)
    nb = blocks.shape[0]
    bc = (np.arange(nb, dtype=np.int32) % g.nblocks.w,
          np.arange(nb, dtype=np.int32) // g.nblocks.w)
    import jax.numpy as jnp

    args = ((jnp.asarray(bc[0]), jnp.asarray(bc[1])), jnp.asarray(0))
    out_k, _ = mp.filter_blocks(jnp.asarray(blocks), (*base, kron),
                                *args, geom=g, params=params,
                                plane_index=0, nplanes=1)
    assert mp.LAST_FAST_PATH == "i8-kron"
    out_s, _ = mp.filter_blocks(jnp.asarray(blocks), base, *args,
                                geom=g, params=params,
                                plane_index=0, nplanes=1)
    # int8 3-digit digit accuracy: ~2^-21 relative -> ~0.02 of the
    # 0..255 pel range through the V=2048 contraction pair (invisible
    # at 8-bit output quantisation; the xla-sep path stays available
    # for float-exact needs)
    np.testing.assert_allclose(np.asarray(out_k), np.asarray(out_s),
                               atol=2e-2)
    # threshold composes identically in both forms
    pt = mp.MotionParams(boost=1.25, damp=0.0, threshold_min=1e-4,
                         threshold_max=0.5)
    kron_t = mp.maybe_kron_plans(g, pt, allow_cpu=True)
    out_kt, _ = mp.filter_blocks(jnp.asarray(blocks), (*base, kron_t),
                                 *args, geom=g, params=pt,
                                 plane_index=0, nplanes=1)
    out_st, _ = mp.filter_blocks(jnp.asarray(blocks), base, *args,
                                 geom=g, params=pt,
                                 plane_index=0, nplanes=1)
    np.testing.assert_allclose(np.asarray(out_kt), np.asarray(out_st),
                               atol=2e-2)


def test_maybe_kron_plans_gates():
    """No kron plans for dense supports, small volumes, or non-fast
    chains."""
    g = mp.plan_geometry(32, 32, 8, 1, block=mp.Dims(16, 16, 8),
                         bp_end=mp.Dims(8, 8, 4))[0]
    ok = mp.MotionParams(boost=1.25, damp=0.0)
    assert mp.maybe_kron_plans(g, ok, allow_cpu=True) is not None
    # damp != 0: full support
    assert mp.maybe_kron_plans(
        g, mp.MotionParams(boost=1.25, damp=0.5), allow_cpu=True) is None
    # quant disables the fused fast path entirely
    assert mp.maybe_kron_plans(
        g, mp.MotionParams(damp=0.0, quant=1.0), allow_cpu=True) is None
    # small volume: the dense xla-kron form owns it
    g2 = mp.plan_geometry(16, 16, 4, 1, block=mp.Dims(8, 8, 4),
                          bp_end=mp.Dims(4, 4, 2))[0]
    assert mp.maybe_kron_plans(g2, ok, allow_cpu=True) is None
    # volume past the host [V, V] Kronecker build bound: must return
    # None (24^3 blocks would need a 1.5 GB float64 matrix) — and the
    # gate must fire BEFORE the host kron build
    g3 = mp.plan_geometry(48, 48, 24, 1, block=mp.Dims(24, 24, 24),
                          bp_end=mp.Dims(6, 6, 6))[0]
    assert mp.maybe_kron_plans(g3, ok, allow_cpu=True) is None
    # ...and filter_blocks still runs the volume on the xla-sep path
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    frames = rng.random((24, 48, 48)).astype(np.float32) * 255
    blocks = mp.frames_to_blocks(frames, g3)
    nb = blocks.shape[0]
    bc = (jnp.zeros(nb, jnp.int32), jnp.zeros(nb, jnp.int32))
    base = mp.make_plans(g3)
    out, _ = mp.filter_blocks(jnp.asarray(blocks),
                              (*base, mp.maybe_kron_plans(g3, ok,
                                                          allow_cpu=True)),
                              bc, jnp.asarray(0), geom=g3, params=ok,
                              plane_index=0, nplanes=1)
    assert mp.LAST_FAST_PATH == "xla-sep"
    assert np.isfinite(np.asarray(out)).all()


def test_stateful_expr_routes_through_host_callback():
    """--eval with a stateful av_expr form (random/while/root/taylor)
    round-trips the coefficient grid through the ordered host callback
    (reference motion/motion.c:670-681 evaluates per coefficient on the
    host); a pure-c expression must come back numerically identical to
    the vectorised device path."""
    rng = np.random.default_rng(11)
    frames = rng.random((2, 8, 8)) * 255.0
    g = geometry(8, 8, 2, block=Dims(8, 8, 2))
    names = ("c", "x", "y", "z", "i", "width", "height", "depth",
             "components", "bx", "by", "bz", "bwidth", "bheight", "bdepth")
    expr = parse_expr("c/2 + random(0)*0", names)
    assert expr.stateful
    out, _ = run_plane(frames, g, mp.MotionParams(expr=expr))
    np.testing.assert_allclose(out, frames / 2.0, atol=1e-2)


def test_stateful_expr_restarts_per_invocation():
    """Two independent invocations with freshly parsed --eval text must
    produce IDENTICAL output: the jit cache reuses the compiled host
    callback (params hash exprs by source), and it must evaluate
    through the current parse, not continue the first run's
    random()/st() state (round-5 review finding — the streams
    diverged)."""
    rng = np.random.default_rng(12)
    frames = rng.random((2, 8, 8)) * 255.0
    g = geometry(8, 8, 2, block=Dims(8, 8, 2))
    names = ("c", "x", "y", "z", "i", "width", "height", "depth",
             "components", "bx", "by", "bz", "bwidth", "bheight", "bdepth")

    def run():
        expr = parse_expr("random(0)*255", names)  # fresh parse per run
        out, _ = run_plane(frames, g, mp.MotionParams(expr=expr))
        return np.asarray(out)

    np.testing.assert_array_equal(run(), run())
