"""Golden round-trip tests: spec -> ispec must reconstruct the image
(reference spec/README.md:62-86 documents these invertible pairs;
SURVEY.md section 4 makes them our automated goldens)."""

import numpy as np
import pytest

from dspfun_tpu.core.precision import Precision
from dspfun_tpu.models.spec_pipeline import (
    SpecChainParams,
    spec_forward,
    spec_inverse,
)

# The reference spec tool defaults to COEFF_PRECISION=D (double storage,
# include/precision.h:50-57); its analogue here is the f64 policy on the
# CPU oracle backend.
P64 = Precision(coeff="float64", intermediate="f64")


@pytest.fixture
def img():
    rng = np.random.default_rng(42)
    return rng.random((48, 64, 3)).astype(np.float64)


def roundtrip(img, params, precision=P64, **kw):
    f, dc = spec_forward(img, params, precision)
    y = spec_inverse(np.asarray(f), params, dc=np.asarray(dc), precision=precision, **kw)
    return np.asarray(y)


def test_flat_template_roundtrip(img):
    """flat = linear/shift/custom/one: exactly invertible at full precision."""
    p = SpecChainParams.template("flat", gain=1.0)
    y = roundtrip(img, p)
    assert np.max(np.abs(y - img)) <= 1e-10


def test_flat_roundtrip_f32_storage(img):
    """With f32 coefficient storage (the accelerator default; the reference's
    COEFF_PRECISION=F build), the IDCT coherently sums per-coefficient
    quantisation noise — bound scales like eps32 * w * h."""
    p = SpecChainParams.template("flat", gain=1.0)
    y = roundtrip(img, p, precision=Precision(intermediate="hilo"))
    assert np.max(np.abs(y - img)) <= 64 * 48 * np.finfo(np.float32).eps


def test_shift_template_roundtrip(img):
    """shift = log/shift/native/one."""
    p = SpecChainParams.template("shift")
    y = roundtrip(img, p)
    assert np.max(np.abs(y - img)) <= 1e-10


def test_copy_template_roundtrip(img):
    p = SpecChainParams.template("copy", gain=4.0)
    y = roundtrip(img, p)
    assert np.max(np.abs(y - img)) <= 1e-10


def test_abs_with_signmap_roundtrip(img):
    """abs spectrum + sign map recovers the image (ispec -m,
    reference ispec.c:87-98)."""
    p_abs = SpecChainParams.template("abs")
    p_sign = SpecChainParams.template("sign", gain=1.0)
    f, dc = spec_forward(img, p_abs, P64)
    sm, _ = spec_forward(img, p_sign, P64)
    y = spec_inverse(np.asarray(f), p_abs, dc=None, signmap=np.asarray(sm), precision=P64)
    assert np.max(np.abs(np.asarray(y) - img)) <= 1e-9


def test_preserve_dc(img):
    p = SpecChainParams.template("flat", gain=1.0)
    f, dc = spec_forward(img, p)
    # zero out the stored DC texel, restore via -p
    f = np.asarray(f).copy()
    f[0, 0, :] = 0.5 * 254 / 255  # encoded zero under shift sign
    y = np.asarray(spec_inverse(f, p, dc=np.asarray(dc), preserve_dc=True))
    assert abs(np.mean(y[..., 0]) - np.mean(img[..., 0])) <= 1e-5


def test_dc_is_mean(img):
    p = SpecChainParams.template("abs")
    _, dc = spec_forward(img, p)
    np.testing.assert_allclose(np.asarray(dc), img.mean(axis=(0, 1)), atol=1e-6)


def test_cli_roundtrip_through_png(tmp_path):
    """End-to-end through the CLIs and real PNG files (8-bit quantised,
    so the bound is the flat template's documented lossiness)."""
    from dspfun_tpu.io import images
    from dspfun_tpu.tools import ispec as ispec_tool
    from dspfun_tpu.tools import spec as spec_tool

    rng = np.random.default_rng(7)
    # smooth low-frequency image to keep 8-bit spectrum loss small
    y, x = np.mgrid[0:32, 0:32] / 32.0
    img = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * x), 0.5 + 0.3 * np.cos(2 * np.pi * y), 0.5 * np.ones_like(x)], axis=-1)
    src = str(tmp_path / "src.png")
    specf = str(tmp_path / "spec.png")
    outf = str(tmp_path / "out.png")
    images.write_image(src, img)

    assert spec_tool.main(["-t", "flat", "-G", "1000", src, specf]) == 0
    assert ispec_tool.main(["-t", "flat", "-G", "1000", specf, outf]) == 0

    back = images.read_image(outf).pixels
    assert np.sqrt(np.mean((back - img) ** 2)) < 0.05
