"""Kronecker-folded block operator tests."""

import numpy as np
import scipy.fft

from dspfun_tpu.core.precision import Precision
from dspfun_tpu.ops import blockdct as bd

PREC = Precision(coeff="float32", intermediate="hilo")


def test_kron_matrix_equals_separable():
    rng = np.random.default_rng(0)
    x = rng.random((4, 6))
    k = bd.kron_dct_matrix((4, 6), "dct2")
    got = (k @ x.reshape(-1)).reshape(4, 6)
    ref = scipy.fft.dctn(x, type=2)
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_folded_operator_identity():
    dims = (4, 8)
    op = bd.folded_operator(dims, np.ones(dims), PREC)
    rng = np.random.default_rng(1)
    x = rng.random((5, 32)).astype(np.float32)
    y = np.asarray(bd.apply_block_operator(x, op, PREC))
    np.testing.assert_allclose(y, x, atol=1e-6)


def test_folded_operator_lowpass_3d():
    dims = (2, 4, 4)
    filt = np.zeros(dims)
    filt[0, :2, :2] = 1.0
    op = bd.folded_operator(dims, filt, PREC)
    rng = np.random.default_rng(2)
    x = rng.random((3, 32)).astype(np.float32)
    y = np.asarray(bd.apply_block_operator(x, op, PREC))
    # oracle: dense transform chain
    xb = x.reshape(3, *dims).astype(np.float64)
    F = scipy.fft.dctn(xb, axes=(1, 2, 3), type=2) * filt[None]
    ref = scipy.fft.dctn(F, axes=(1, 2, 3), type=3) / (8 * np.prod(dims))
    np.testing.assert_allclose(y.reshape(3, *dims), ref, atol=1e-5)


def test_bdiag_axis_plan_blockwise_dct():
    """I (x) D8 block-diagonal plan == per-block DCT along each planar
    axis (the suite config-1 formulation, ops/blockdct.bdiag_axis_plan)."""
    import jax

    from dspfun_tpu.core import basis as basis_mod
    from dspfun_tpu.core.transforms import apply_plan

    n, size = 8, 32
    rng = np.random.default_rng(4)
    x = rng.random((3, size, size)).astype(np.float32)
    for prec in (PREC, Precision(coeff="float32", intermediate="f32"),
                 Precision(coeff="float32", intermediate="i8")):
        plan = bd.bdiag_axis_plan(size, basis_mod.dct2_matrix(n), prec)
        got = np.asarray(jax.jit(
            lambda v, p=plan, q=prec: apply_plan(apply_plan(v, p, 1, q),
                                                 p, 2, q))(x))
        b = x.reshape(3, size // n, n, size // n, n).astype(np.float64)
        ref = scipy.fft.dctn(b, type=2, axes=(2, 4)).reshape(3, size, size)
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_bdiag_axis_plan_validates():
    import pytest

    with pytest.raises(ValueError):
        bd.bdiag_axis_plan(33, np.eye(8), PREC)
    with pytest.raises(ValueError):
        bd.bdiag_axis_plan(32, np.ones((8, 4)), PREC)


def test_blocks_roundtrip():
    rng = np.random.default_rng(3)
    x = rng.random((8, 12, 3)).astype(np.float32)
    blocks = bd.blocks_from_array(x, (4, 4))
    assert blocks.shape == (2 * 3 * 3, 16)
    back = bd.blocks_to_array(blocks, (4, 4), 8, 12, 3)
    np.testing.assert_allclose(np.asarray(back), x)
