import numpy as np
import pytest

from dspfun_tpu.io import images
from dspfun_tpu.io.color import srgb_decode, srgb_encode


def test_base16_roundtrip():
    data = bytes(range(256))
    enc = images.base16_encode(data)
    assert images.base16_decode(enc) == data
    # matches the reference codec (spec/spec.h:157-168): nibbles + 'A'
    assert images.base16_encode(b"\x00") == "AA"
    assert images.base16_encode(b"\x01") == "BA"
    assert images.base16_encode(b"\x10") == "AB"


def test_dc_property_roundtrip():
    dc = np.array([0.25, 0.5, 0.125])
    prop = images.encode_dc_property(dc)
    out = images.decode_dc_property(prop, 3)
    np.testing.assert_array_equal(out, dc)


def test_png_roundtrip_with_properties(tmp_path):
    rng = np.random.default_rng(0)
    pix = rng.random((16, 24, 3))
    path = str(tmp_path / "t.png")
    images.write_image(path, pix, properties={"DC": "ABCD"})
    back = images.read_image(path)
    assert back.properties["DC"] == "ABCD"
    assert back.pixels.shape == (16, 24, 3)
    # 8-bit quantisation error only
    assert np.max(np.abs(back.pixels - pix)) <= 0.5 / 255 + 1e-12


def test_channel_specs(tmp_path):
    pix = np.zeros((4, 4, 3))
    pix[..., 0] = 1.0  # red
    path = str(tmp_path / "r.png")
    images.write_image(path, pix)
    gray = images.read_image(path, channels="I")
    assert gray.pixels.shape == (4, 4, 1)
    assert gray.pixels[0, 0, 0] == pytest.approx(0.299, abs=1e-2)
    bgr = images.read_image(path, channels="BGR")
    assert bgr.pixels[0, 0, 2] == pytest.approx(1.0)
    assert bgr.pixels[0, 0, 0] == pytest.approx(0.0)


def test_srgb_roundtrip():
    x = np.linspace(0, 1, 100)
    np.testing.assert_allclose(srgb_encode(srgb_decode(x)), x, atol=1e-12)
    # reference threshold behaviour (applybasis.c:142-144)
    assert srgb_decode(np.float64(0.04)) == pytest.approx(0.04 / 12.92)


def test_srgb_device_f32_accuracy():
    """The jnp transfer functions decompose pow into sqrt/cbrt + Newton
    (io/color.py) so device OETF accuracy is ~2 ulp, not the several
    ulp an approximate device f32 pow can carry.  Pin the f32 error bound against the f64 host path
    over the full domain including thresholds, 0, and >1 overshoot."""
    import jax
    import jax.numpy as jnp

    from dspfun_tpu.io import color

    x = np.concatenate([
        np.array([0.0, color._ENC_THRESH, color._DEC_THRESH, 1.0, 1.5]),
        np.linspace(0.0, 1.2, 4001),
        10.0 ** np.linspace(-8, 0.5, 800),
    ])
    xf = jnp.asarray(x, jnp.float32)
    enc = np.asarray(jax.jit(lambda v: color.srgb_encode(v, jnp))(xf),
                     np.float64)
    dec = np.asarray(jax.jit(lambda v: color.srgb_decode(v, jnp))(xf),
                     np.float64)
    rel_e = np.abs(enc - srgb_encode(x)) / np.maximum(np.abs(srgb_encode(x)), 1e-12)
    rel_d = np.abs(dec - srgb_decode(x)) / np.maximum(np.abs(srgb_decode(x)), 1e-12)
    assert rel_e.max() < 1e-6, rel_e.max()
    assert rel_d.max() < 1e-6, rel_d.max()
    assert not np.isnan(enc).any() and not np.isnan(dec).any()
    # monotone through the piecewise threshold (no banding inversions
    # after 8/16-bit quantisation)
    g = np.asarray(jax.jit(lambda v: color.srgb_encode(v, jnp))(
        jnp.asarray(np.linspace(0.0, 1.0, 200001), jnp.float32)))
    assert (np.diff(g) >= 0).all()


def test_sixel_output(tmp_path, capsysbinary):
    from dspfun_tpu.io.sixel import encode_sixel

    rgb = np.zeros((8, 8, 3), dtype=np.uint8)
    rgb[:4] = [255, 0, 0]
    data = encode_sixel(rgb)
    assert data.startswith(b"\x1bPq")
    assert data.endswith(b"\x1b\\")
