"""ops.int8mm: int8 Ozaki digit contraction — the plain XLA form and
the GPU kernel in the Pallas interpreter, both against float64 numpy.

The digit scheme's only error is the ~2^-22 per-slice representation
truncation, so everything here asserts ~1e-6-class accuracy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dspfun_tpu.core import basis as basis_mod
from dspfun_tpu.core.precision import Precision
from dspfun_tpu.core.transforms import apply_plan, plan_axis
from dspfun_tpu.ops.int8mm import B_I8, i8_contract, split_matrix_i8


def test_split_matrix_digits_reconstruct():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((24, 200)) * 5.0
    digits, scale = split_matrix_i8(m)
    assert digits.dtype == np.int8
    assert digits.shape == (3, 24, 200)        # K unpadded
    assert np.max(np.abs(digits.astype(np.int32))) <= 65
    rec = np.zeros((24, 200))
    for i in range(digits.shape[0]):
        rec += digits[i].astype(np.float64) * 2.0 ** (-B_I8 * (i + 1))
    rec = rec * scale
    # ~20 bits below each row max (the ceil+1 half-range scaling can
    # cost up to 2 bits vs the ideal normalisation)
    err = np.max(np.abs(rec - m) / np.max(np.abs(m), axis=1, keepdims=True))
    assert err <= 2.0**-20


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["xla", "kernel-interpret"])
@pytest.mark.parametrize("axis,shape", [
    (0, (160, 70)),          # left form
    (1, (3, 160, 70)),       # batched left form ([C, H, W] case)
    (2, (3, 50, 160)),       # right form
    (1, (2, 160, 5, 7)),     # general middle axis (moveaxis fallback)
])
def test_i8_contract_forms(axis, shape, interpret):
    """Both product forms — the plain XLA group dots and the GPU kernel
    run by the Pallas interpreter (padding to its tiles included) —
    match float64 in every layout."""
    k = shape[axis]
    rng = np.random.default_rng(1)
    m = basis_mod.dct2_matrix(k)
    x = (rng.random(shape).astype(np.float32) - 0.3) * 4
    digits, scale = split_matrix_i8(m)
    y = np.asarray(jax.jit(
        lambda xx: i8_contract(xx, jnp.asarray(digits), jnp.asarray(scale),
                               axis, interpret=interpret))(x), np.float64)
    ref = np.moveaxis(
        np.tensordot(m, x.astype(np.float64), axes=[[1], [axis]]), 0, axis)
    rel = np.max(np.abs(y - ref)) / np.max(np.abs(ref))
    assert rel <= 1e-6, rel


def test_i8_apply_plan_roundtrip():
    n = 256
    p = Precision(intermediate="i8")
    rng = np.random.default_rng(2)
    x = rng.random((n, n)).astype(np.float32)
    f = apply_plan(jnp.asarray(x), plan_axis(n, "dct2", p), 0, p)
    y = apply_plan(f, plan_axis(n, "dct3", p), 0, p) / (2.0 * n)
    # bare i8 (no DC-split hints): ~2^-20 per slice amplified by the
    # DC-dominated spectrum; the fused chains pass split hints and land
    # ~1e-6 (see test_i8_fused_chain_pruned)
    assert np.max(np.abs(np.asarray(y, np.float64) - x)) <= 1e-4


def test_i8_exactness_and_capacity_guards():
    """K bounds follow the int32 group sums (3 dots in the 3-digit
    form's heaviest group, 4 in the deep form's — NOT the single-dot
    2^19), apply to BOTH entry points, and the planner probe reports
    the same bound."""
    from dspfun_tpu.ops.int8mm import _kmax, i8_contract_rt, i8_feasible

    assert _kmax(3) == ((1 << 31) - 1) // (3 << 12)
    assert _kmax(4) == (1 << 17) - 1
    big = jnp.zeros((4, _kmax(3) + 1), jnp.float32)
    digs, sc = split_matrix_i8(np.ones((8, big.shape[1])))
    with pytest.raises(ValueError, match="exact-int32"):
        i8_contract(big, jnp.asarray(digs), jnp.asarray(sc), 1)
    with pytest.raises(ValueError, match="exact-int32"):
        i8_contract_rt(big, jnp.ones((8, big.shape[1]), jnp.float32), 1)

    # the probe is exactly the accumulation bound, per digit count:
    # 8K image axes fit both forms; past _kmax neither does
    assert i8_feasible(7680, 3) and i8_feasible(7680, 4)
    assert i8_feasible(_kmax(4), 4) and not i8_feasible(_kmax(4) + 1, 4)
    assert i8_feasible(_kmax(3), 3) and not i8_feasible(_kmax(3) + 1, 3)
    assert _kmax(4) < _kmax(3)


def test_i8_plan_falls_back_to_exact_when_infeasible():
    """plan_matrix(i8, deep) on a contraction past the deep form's
    exact-int32 bound silently falls back to the bf16-digit exact mode
    (same accuracy class, no K limit) instead of raising at trace
    time."""
    from dspfun_tpu.core.transforms import plan_matrix
    from dspfun_tpu.ops.int8mm import _kmax

    rng = np.random.default_rng(5)
    k = _kmax(4) + 1
    m = rng.random((8, k)) - 0.5
    plan = plan_matrix(m, Precision(intermediate="i8", tol=1e-6))
    assert np.asarray(plan.digits).dtype == jnp.bfloat16  # exact mode
    x = rng.random((k, 2)).astype(np.float32)
    y = np.asarray(apply_plan(jnp.asarray(x), plan, 0,
                              Precision(intermediate="i8", tol=1e-6)))
    ref = m @ x.astype(np.float64)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-6


def test_scale_down_exact_for_extreme_exponents():
    """scale_down keeps x*2^-e exact past e=126 (single-factor exp2i
    clamps there and silently corrupted slices with maxes >= 2^125);
    beyond the digit domain the unscale is loudly non-finite."""
    from dspfun_tpu.ops.int8mm import exp2i, log2_ceil1, scale_down

    x = jnp.asarray([1.5e38, 2.0**125, -3.0e38, 1.0], jnp.float32)
    e = log2_ceil1(jnp.max(jnp.abs(x)))
    r = np.asarray(scale_down(x, e), np.float64)
    ref = np.asarray(x, np.float64) * 2.0 ** (-float(e))
    # elements whose scaled value stays normal are exact; ones so far
    # below the slice max that 2^-e*x is subnormal may flush to zero —
    # they are below the digit truncation depth either way
    normal = np.abs(ref) >= 2.0**-126
    np.testing.assert_array_equal(r[normal], ref[normal])
    assert np.all(np.abs(r[~normal]) <= 2.0**-126)
    assert float(e) >= 128  # the range the old clamp corrupted
    assert np.isinf(float(exp2i(e)))  # unscale: loud, not silent


def test_i8_fused_chain_pruned():
    import scipy.fft

    from dspfun_tpu.models.fused import filter_plans, fused_filter_2d, lowpass_mask

    h, w = 96, 128
    rng = np.random.default_rng(3)
    x = rng.random((h, w, 3)).astype(np.float32)
    mask = lowpass_mask((h, w), cutoff=0.25, boost=1.25)[:, :, None].astype(np.float32)
    ref = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(0, 1))
    ref *= mask
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1)) / (4.0 * w * h)
    p = Precision(intermediate="i8")
    plans = jax.device_put(filter_plans((h, w), p, mask=mask))
    y = jax.jit(lambda a, m_, pl: fused_filter_2d(a, m_, pl, p))(x, mask, plans)
    assert np.max(np.abs(np.asarray(y, np.float64) - ref)) <= 1e-5


def test_i8_fused_chain_2d_mask_rect():
    """Regression (ADVICE r3): a rank-2 [H, W] mask on a rank-3 input
    must broadcast over channels, not be transposed by the i8 branch's
    channel-first moveaxis.  H != W and an asymmetric mask make a
    silent transpose a measurable error."""
    import scipy.fft

    from dspfun_tpu.models.fused import filter_plans, fused_filter_2d

    h, w = 64, 96
    rng = np.random.default_rng(7)
    x = rng.random((h, w, 3)).astype(np.float32)
    # asymmetric mask: pass-box wider than tall
    mask = np.zeros((h, w), np.float32)
    mask[: h // 4, : w // 2] = 1.0
    ref = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(0, 1))
    ref *= mask[:, :, None]
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1)) / (4.0 * w * h)
    p = Precision(intermediate="i8")
    plans = jax.device_put(filter_plans((h, w), p, mask=mask))
    y = fused_filter_2d(jnp.asarray(x), jnp.asarray(mask), plans, p)
    assert np.max(np.abs(np.asarray(y, np.float64) - ref)) <= 1e-5
    # and an outright rank mismatch raises instead of mis-broadcasting
    import pytest

    with pytest.raises(ValueError, match="mask rank"):
        fused_filter_2d(jnp.asarray(x), jnp.asarray(mask[0]), plans, p)


def test_i8_zero_and_constant_slices():
    """Zero slices (mx=0) and constant slices must not produce NaNs."""
    k = 128
    m = basis_mod.dct2_matrix(k)
    digits, scale = split_matrix_i8(m)
    x = np.zeros((k, 4), np.float32)
    x[:, 1] = 3.0
    y = np.asarray(i8_contract(jnp.asarray(x), jnp.asarray(digits),
                               jnp.asarray(scale), 0), np.float64)
    assert np.all(np.isfinite(y))
    np.testing.assert_allclose(y[:, 0], 0.0)
    ref = m @ x.astype(np.float64)
    assert np.max(np.abs(y - ref)) <= 1e-4


def test_i8_inside_shard_map_volume_path():
    """The i8 contraction runs inside shard_map (per-device local
    shards): the motion whole-volume path under DSPFUN_PRECISION=i8
    matches the default-precision single-device chain to pel noise."""
    from dspfun_tpu.core.precision import set_precision
    from dspfun_tpu.models import motion_pipeline as mp
    from dspfun_tpu.parallel import motion_sharded as msh
    from dspfun_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8, space=2, time=4)
    t, h, w = 8, 256, 256  # K >= 256 so the i8 plans engage
    g = mp.plan_geometry(w, h, t, 1, block=mp.Dims(w, h, t))[0]
    params = mp.MotionParams(boost=1.25, damp=0.1)
    rng = np.random.default_rng(12)
    vol = rng.random((t, h, w)).astype(np.float32) * 255

    set_precision(Precision(intermediate="i8", tol=1e-5))
    try:
        vs = jax.device_put(jnp.asarray(vol), msh.volume_sharding(mesh))
        out, _ = msh.motion_filter_volume_sharded(
            vs, mesh, geom=g, params=params, plane_index=0, nplanes=1)
        out = np.asarray(out)
    finally:
        set_precision(Precision())

    ref, _ = mp.filter_blocks(
        jnp.asarray(mp.frames_to_blocks(vol, g)), mp.make_plans(g),
        (jnp.zeros(1, jnp.int32),) * 2, jnp.asarray(0), geom=g,
        params=params, plane_index=0, nplanes=1)
    ref = mp.blocks_to_frames(np.asarray(ref), g)
    # ~2^-20-class contraction error on 0..255 pels
    assert np.max(np.abs(out - ref)) < 0.1


@pytest.mark.gpu
def test_i8_fused_chain_on_gpu(gpu):
    """The bench configuration's i8 contractions compile and run on the
    card at <=1e-5 vs the float64 chain."""
    import scipy.fft

    from dspfun_tpu.models.fused import filter_plans, fused_filter_2d, lowpass_mask

    h, w = 512, 768
    rng = np.random.default_rng(13)
    x = rng.random((h, w, 3)).astype(np.float32)
    mask = lowpass_mask((h, w), cutoff=0.25, boost=1.25)[:, :, None].astype(np.float32)
    p = Precision(intermediate="i8", tol=1e-5)
    plans = jax.device_put(filter_plans((h, w), p, mask=mask))
    y = np.asarray(jax.jit(
        lambda a, m_, pl: fused_filter_2d(a, m_, pl, p))(x, mask, plans),
        np.float64)
    ref = scipy.fft.dctn(x.astype(np.float64), type=2, axes=(0, 1))
    ref *= mask
    ref = scipy.fft.dctn(ref, type=3, axes=(0, 1)) / (4.0 * w * h)
    assert np.max(np.abs(y - ref)) <= 1e-5


@pytest.mark.gpu
def test_i8_deep_form_on_gpu(gpu):
    """The 4-digit deep contraction compiles on the card and lands
    ~1e-7-class relative."""
    rng = np.random.default_rng(0)
    K, M = 1920, 1024
    m = np.cos(np.pi * (np.arange(M)[:, None] / 4.0 + 0.5)
               * np.arange(K)[None, :] / K)
    x = rng.standard_normal((K, 256)).astype(np.float32) * 50
    digits, rs = split_matrix_i8(m, 4)
    y = np.asarray(i8_contract(jnp.asarray(x), jnp.asarray(digits),
                               jnp.asarray(rs), 0), np.float64)
    ref = m @ x.astype(np.float64)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) <= 3e-7


@pytest.mark.gpu
def test_i8_kron_motion_on_gpu(gpu):
    """The support-pruned i8-kron motion fast path engages on the card
    and matches the separable formulation."""
    from dspfun_tpu.models import motion_pipeline as mp

    rng = np.random.default_rng(4)
    d = 16
    g = mp.plan_geometry(128, 64, d, 1, block=mp.Dims(16, 16, d),
                         bp_end=mp.Dims(8, 8, 4))[0]
    params = mp.MotionParams(boost=1.25, damp=0.0)
    frames = rng.random((d, 64, 128)).astype(np.float32) * 255
    base = jax.device_put(mp.make_plans(g))
    kron = jax.device_put(mp.maybe_kron_plans(g, params))
    assert kron is not None
    blocks = jnp.asarray(mp.frames_to_blocks(frames, g))
    nb = blocks.shape[0]
    bc = (jnp.asarray(np.arange(nb, dtype=np.int32) % g.nblocks.w),
          jnp.asarray(np.arange(nb, dtype=np.int32) // g.nblocks.w))
    out_k, _ = mp.filter_blocks(blocks, (*base, kron), bc, jnp.asarray(0),
                                geom=g, params=params, plane_index=0,
                                nplanes=1)
    assert mp.LAST_FAST_PATH == "i8-kron"
    out_s, _ = mp.filter_blocks(blocks, base, bc, jnp.asarray(0),
                                geom=g, params=params, plane_index=0,
                                nplanes=1)
    np.testing.assert_allclose(np.asarray(out_k), np.asarray(out_s),
                               atol=5e-2)
