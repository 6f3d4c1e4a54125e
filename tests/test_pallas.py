"""Motion's fused blockwise fast path: the xla-kron form (the whole 3-D
DCT folded into two dense [V, V] matmuls) against a float64 oracle, and
the separable form against the general chain."""

import numpy as np
import pytest
import scipy.fft

import jax.numpy as jnp

from dspfun_tpu.models import motion_pipeline as mp


def _run_kron(blocks, dims, params, bp_end=None):
    """filter_blocks over [NB, bd, bh, bw] blocks of ``dims`` (V <= the
    xla-kron bound), asserting the xla-kron form ran."""
    nb = blocks.shape[0]
    bd, bh, bw = dims
    g = mp.plan_geometry(bw, bh * nb, bd, 1, block=mp.Dims(bw, bh, bd),
                         bp_end=bp_end or mp.Dims())[0]
    assert g.block.volume() <= mp._XLA_KRON_MAX_VOL
    bc = (jnp.zeros(nb, jnp.int32), jnp.zeros(nb, jnp.int32))
    mp.LAST_FAST_PATH = None
    out, _ = mp.filter_blocks(jnp.asarray(blocks), mp.make_plans(g), bc,
                              jnp.asarray(0), geom=g, params=params,
                              plane_index=0, nplanes=1)
    assert mp.LAST_FAST_PATH == "xla-kron", mp.LAST_FAST_PATH
    return np.asarray(out, np.float64)


def _oracle(blocks, mult, tmin=0.0, tmax=0.0):
    """float64 DCT-II -> multiplier -> threshold on the uniform-range
    coefficients (reference motion.c:641-647,721-728) -> DCT-III."""
    axes = (1, 2, 3)
    F = scipy.fft.dctn(blocks.astype(np.float64), axes=axes, type=2) * mult
    if tmax:
        shape = blocks.shape[1:]
        uf = 2.0 * np.sqrt(2.0) * np.ones(shape)
        for ax, n in enumerate(shape):
            idx = [None] * 3
            idx[ax] = slice(None)
            uf = uf / np.where(np.arange(n) > 0, 1.0, np.sqrt(2.0))[tuple(idx)]
        a = np.abs(F * uf)
        F = np.where((a < tmin) | (a > tmax), 0.0, F)
    vol = np.prod(blocks.shape[1:])
    return scipy.fft.dctn(F, axes=axes, type=3) / (8.0 * vol)


def test_kron_identity():
    rng = np.random.default_rng(0)
    x = rng.random((10, 2, 8, 8)).astype(np.float32) * 255
    y = _run_kron(x, (2, 8, 8), mp.MotionParams(damp=0.0))
    np.testing.assert_allclose(y, x, atol=1e-3)


def test_kron_lowpass_matches_oracle():
    rng = np.random.default_rng(1)
    dims = (4, 16, 8)
    x = rng.random((20, *dims)).astype(np.float32) * 255
    y = _run_kron(x, dims, mp.MotionParams(boost=1.5, damp=0.0),
                  bp_end=mp.Dims(4, 4, 2))
    mult = np.zeros(dims)
    mult[:2, :4, :4] = 1.5
    np.testing.assert_allclose(y, _oracle(x, mult), atol=1e-2)


def test_kron_threshold_matches_oracle():
    rng = np.random.default_rng(2)
    dims = (4, 16, 8)
    x = rng.random((9, *dims)).astype(np.float32) * 255
    params = mp.MotionParams(damp=0.0, threshold_min=1e-3,
                             threshold_max=0.5)
    y = _run_kron(x, dims, params)
    norm2 = 1.0 / (np.prod(dims) * 8.0)
    ref = _oracle(x, np.ones(dims), tmin=1e-3 * 255.0 / norm2,
                  tmax=0.5 * 255.0 / norm2)
    np.testing.assert_allclose(y, ref, atol=1e-2)
    # the threshold really zeroed coefficients
    assert np.max(np.abs(ref - x)) > 1.0


def test_kron_block_count_not_a_tile_multiple():
    rng = np.random.default_rng(3)
    x = rng.random((3, 1, 8, 16)).astype(np.float32)
    y = _run_kron(x, (1, 8, 16), mp.MotionParams(damp=0.0))
    assert y.shape == (3, 1, 8, 16)
    np.testing.assert_allclose(y, x, atol=1e-4)


def test_filter_blocks_sep_fast_path_matches_slow():
    """The 16x16x16 BASELINE motion config must produce the same result
    through the fast path gate (xla-sep at V=4096) as through the
    general chain."""
    import dataclasses

    g = mp.plan_geometry(32, 32, 16, 1, block=mp.Dims(16, 16, 16),
                         bp_end=mp.Dims(8, 8, 4))[0]
    fastp = mp.MotionParams(boost=1.25, damp=0.0)
    plans = mp.make_plans(g)
    rng = np.random.default_rng(7)
    frames = (rng.random((16, 32, 32)) * 255).astype(np.float32)
    blocks = jnp.asarray(mp.frames_to_blocks(frames, g))
    nb = blocks.shape[0]
    bc = (jnp.zeros(nb, jnp.int32), jnp.zeros(nb, jnp.int32))
    fast_out, _ = mp.filter_blocks(blocks, plans, bc, jnp.asarray(0),
                                   geom=g, params=fastp,
                                   plane_index=0, nplanes=1)
    assert mp.LAST_FAST_PATH == "xla-sep"
    # an identity expression forces the general chain
    from dspfun_tpu.core.expr import parse_expr

    expr = parse_expr("c", ("c", "x", "y", "z", "i", "width", "height",
                            "depth", "components", "bx", "by", "bz",
                            "bwidth", "bheight", "bdepth"))
    slow_out, _ = mp.filter_blocks(blocks, plans, bc, jnp.asarray(0),
                                   geom=g,
                                   params=dataclasses.replace(fastp, expr=expr),
                                   plane_index=0, nplanes=1)
    np.testing.assert_allclose(np.asarray(fast_out), np.asarray(slow_out),
                               atol=2e-2, rtol=1e-5)


@pytest.mark.gpu
def test_baseline_motion_config_engages_fused_path_on_gpu(gpu):
    """The BASELINE motion config (16x16x16 blocks, V=4096) without
    kron plans runs the separable fused fast path on the card."""
    g = mp.plan_geometry(64, 48, 16, 1, block=mp.Dims(16, 16, 16),
                         bp_end=mp.Dims(8, 8, 4))[0]
    params = mp.MotionParams(boost=1.25, damp=0.0)
    plans = mp.make_plans(g)
    rng = np.random.default_rng(8)
    frames = (rng.random((16, 48, 64)) * 255).astype(np.float32)
    blocks = jnp.asarray(mp.frames_to_blocks(frames, g))
    nb = blocks.shape[0]
    bc = (jnp.zeros(nb, jnp.int32), jnp.zeros(nb, jnp.int32))
    mp.LAST_FAST_PATH = None
    out, _ = mp.filter_blocks(blocks, plans, bc, jnp.asarray(0), geom=g,
                              params=params, plane_index=0, nplanes=1)
    out.block_until_ready()
    assert mp.LAST_FAST_PATH == "xla-sep", mp.LAST_FAST_PATH
