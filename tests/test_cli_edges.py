"""Cross-tool CLI edge-case coverage: signmap inversion, zoom position
flags, genbasis complex plane, image-sequence video input."""

import numpy as np

from dspfun_tpu.io import images, video
from dspfun_tpu.tools import genbasis as gb_tool
from dspfun_tpu.tools import ispec as ispec_tool
from dspfun_tpu.tools import motion as motion_tool
from dspfun_tpu.tools import spec as spec_tool
from dspfun_tpu.tools import zoom as zoom_tool


def smooth_image(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack(
        [0.5 + 0.35 * np.sin(x / 4 + c) * np.cos(y / 5 - c) for c in range(3)],
        axis=-1,
    )
    return np.clip(img, 0, 1)


def test_spec_sign_then_ispec_with_signmap(tmp_path):
    """spec -t abs + spec -t sign -> ispec -m signmap recovers the image
    (reference spec/README.md signmap workflow)."""
    src = str(tmp_path / "in.png")
    images.write_image(src, smooth_image(16, 16))
    absspec = str(tmp_path / "abs.png")
    signmap = str(tmp_path / "sign.png")
    back = str(tmp_path / "back.png")
    assert spec_tool.main(["-t", "abs", src, absspec]) == 0
    assert spec_tool.main(["-t", "sign", src, signmap]) == 0
    assert ispec_tool.main(["-t", "abs", "-m", signmap, absspec, back]) == 0
    a = images.read_image(src).pixels
    b = images.read_image(back).pixels
    # 8-bit log-abs spectrum quantisation limits accuracy
    assert np.sqrt(((a - b) ** 2).mean()) < 0.12


def test_zoom_input_coords_and_percent(tmp_path):
    src = str(tmp_path / "in.png")
    images.write_image(src, smooth_image(8, 8))
    out1 = str(tmp_path / "a.fvid")
    out2 = str(tmp_path / "b.fvid")
    # -P: position in input units; at scale 2, -p 2x2 -P == -p 4x4
    assert zoom_tool.main(["-s", "2", "-v", "8x8", "-p", "2x2", "-P", "-q",
                           src, out1]) == 0
    assert zoom_tool.main(["-s", "2", "-v", "8x8", "-p", "4x4", "-q",
                           src, out2]) == 0
    with video.open_input(out1) as r1, video.open_input(out2) as r2:
        np.testing.assert_allclose(r1.read_frame_rgb(), r2.read_frame_rgb(),
                                   atol=1e-6)
    # -%: percent of view
    out3 = str(tmp_path / "c.fvid")
    out4 = str(tmp_path / "d.fvid")
    assert zoom_tool.main(["-s", "2", "-v", "8x8", "-p", "50x50", "-%", "-q",
                           src, out3]) == 0
    assert zoom_tool.main(["-s", "2", "-v", "8x8", "-p", "4x4", "-q",
                           src, out4]) == 0
    with video.open_input(out3) as r3, video.open_input(out4) as r4:
        np.testing.assert_allclose(r3.read_frame_rgb(), r4.read_frame_rgb(),
                                   atol=1e-6)


def test_genbasis_complex_plane(tmp_path):
    out = str(tmp_path / "c.png")
    assert gb_tool.main(["--size", "4x4", "-f", "dft", "-P", "complex",
                         "-n", out]) == 0
    img = images.read_image(out, channels="RGB").pixels
    # complex plane packs Re->R, Im->B with G=0 inside tiles
    # (genbasis.c:45-49); padding defaults to the dim green mix
    assert img.shape == (4 * 4 + 5, 4 * 4 + 5, 3)
    inner = img[1:5, 1:5]
    assert inner[..., 1].max() < 0.01


def test_motion_image_sequence_input(tmp_path):
    pattern = str(tmp_path / "f%02d.png")
    for i in range(2):
        images.write_image(pattern % i, smooth_image(8, 8))
    out = str(tmp_path / "o.fvid")
    assert motion_tool.main(["-Q", pattern, out]) == 0
    with video.open_input(out) as r:
        assert r.frames == 2
        got = r.read_frame_rgb()
    np.testing.assert_allclose(got, smooth_image(8, 8), atol=0.02)


def test_spec_grayscale_channel(tmp_path):
    src = str(tmp_path / "g.png")
    images.write_image(src, smooth_image(12, 12))
    mid = str(tmp_path / "m.png")
    back = str(tmp_path / "b.png")
    assert spec_tool.main(["-c", "I", "-t", "shift", src, mid]) == 0
    assert ispec_tool.main(["-c", "I", "-t", "shift", mid, back]) == 0
    a = images.read_image(src, channels="I").pixels
    b = images.read_image(back, channels="I").pixels
    assert np.sqrt(((a - b) ** 2).mean()) < 0.03


def test_zoom_fractional_logical_resolution(tmp_path):
    src = str(tmp_path / "in.png")
    images.write_image(src, smooth_image(8, 8))
    out = str(tmp_path / "o.fvid")
    assert zoom_tool.main(["-r", "12.5x10.5", "-q", src, out]) == 0
    with video.open_input(out) as r:
        # default view = floor(scaled size)
        assert (r.width, r.height) == (12, 10)


def test_single_image_video_output_and_input(tmp_path):
    """Plain single-image paths work as one-frame image2 streams (used
    to crash with a %-format TypeError)."""
    from fractions import Fraction

    import numpy as np

    from dspfun_tpu.io import video

    props = video.parse_color_props("pixel_format=gbrpf32le")
    out = str(tmp_path / "frame.png")
    with video.open_output(out, 8, 6, Fraction(25), props) as w:
        w.write_frame_rgb(np.full((6, 8, 3), 0.5))
    r = video.open_input(out)
    assert r.frames == 1
    f = r.read_frame_rgb()
    np.testing.assert_allclose(f, 0.5, atol=2 / 255)
    assert r.read_frame_rgb() is None

    # a second frame into a single-image path is refused
    import pytest as _pytest

    with video.open_output(str(tmp_path / "one.png"), 8, 6, Fraction(25),
                           props) as w:
        w.write_frame_rgb(np.zeros((6, 8, 3)))
        with _pytest.raises(RuntimeError, match="one"):
            w.write_frame_rgb(np.zeros((6, 8, 3)))


def test_image_seq_writer_honours_raw(tmp_path):
    """raw=True pel-unit planes must be dequantised before the RGB
    conversion (used to blow out to white)."""
    from fractions import Fraction

    import numpy as np

    from dspfun_tpu.io import images, video

    props = video.parse_color_props("pixel_format=yuv444p:color_range=jpeg")
    out = str(tmp_path / "f%02d.png")
    with video.open_output(out, 8, 6, Fraction(25), props) as w:
        w.write_frame([np.full((6, 8), 128.0), np.full((6, 8), 128.0),
                       np.full((6, 8), 128.0)], raw=True)
    got = images.read_image(out % 0).pixels
    assert abs(got.mean() - 0.5) < 0.02


def test_motion_spectrogram_to_y4m_converts_output(tmp_path):
    """Float-RGB spectrograms into a y4m container must convert through
    RGB for the negotiated yuv444p format (used to write G,B,R planes
    as Y,Cb,Cr)."""
    from fractions import Fraction

    import numpy as np

    from dspfun_tpu.io import video
    from dspfun_tpu.tools import motion as motion_tool

    rng = np.random.default_rng(0)
    frames = rng.random((2, 8, 16, 3)).astype(np.float32)
    src = str(tmp_path / "in.fvid")
    props = video.parse_color_props("pixel_format=gbrpf32le")
    with video.open_output(src, 16, 8, Fraction(25), props,
                           format="fvid") as w:
        for f in frames:
            w.write_frame_rgb(f)

    ref_out = str(tmp_path / "spec.fvid")
    y4m_out = str(tmp_path / "spec.y4m")
    args = ["-Q", "-b", "8x8x1", "--spectrogram=shift"]
    assert motion_tool.main([*args, src, ref_out]) == 0
    assert motion_tool.main([*args, src, y4m_out]) == 0

    def read(p):
        with video.open_input(p) as r:
            return np.stack([r.read_frame_rgb() for _ in range(2)])

    a, b = read(ref_out), read(y4m_out)
    # 8-bit + chroma matrix round trip budget; was ~0.9 max diff before
    assert np.abs(a - b).max() < 0.05


def test_motion_dither_short_flag(tmp_path):
    from fractions import Fraction

    import numpy as np

    from dspfun_tpu.io import video
    from dspfun_tpu.tools import motion as motion_tool

    rng = np.random.default_rng(1)
    src = str(tmp_path / "in.y4m")
    props = video.parse_color_props("pixel_format=yuv444p")
    with video.open_output(src, 16, 8, Fraction(25), props) as w:
        for _ in range(2):
            w.write_frame_rgb(rng.random((8, 16, 3)))
    assert motion_tool.main(["-Q", "-b", "8x8x1", "-d", src,
                             str(tmp_path / "o.y4m")]) == 0


def test_scan_resume_rejects_changed_method(tmp_path):
    """A resume file recorded with one scan method must not seed a run
    with a different method (the state silently corrupted output)."""
    import json

    import numpy as np
    from PIL import Image

    from dspfun_tpu.tools import scan as scan_tool

    rng = np.random.default_rng(2)
    src = str(tmp_path / "s.png")
    Image.fromarray(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)).save(src)
    state = str(tmp_path / "st.json")
    out = str(tmp_path / "o.fvid")
    assert scan_tool.main(["-q", "-m", "diag", "-S", "16", "-n", "4",
                           "--resume-file", state, src, out]) == 0
    st = json.load(open(state))
    assert st["cfg"][6] == "diagonal"
    # rerun with a different method: the cfg mismatch restarts cleanly
    out2 = str(tmp_path / "o2.fvid")
    assert scan_tool.main(["-q", "-m", "zig", "-S", "16", "-n", "4",
                           "--resume-file", state, src, out2]) == 0
    st2 = json.load(open(state))
    assert st2["cfg"][6] == "zigzag"


def test_spec_cli_i8_precision_env(tmp_path, monkeypatch):
    """DSPFUN_PRECISION=i8@1e-5 reaches the tools via the policy env
    (the runtime replacement for the reference's compile-time
    COEFF/INTERMEDIATE_PRECISION) and round-trips within tolerance."""
    import importlib

    import numpy as np
    from PIL import Image

    from dspfun_tpu.core import precision as prec_mod
    from dspfun_tpu.io import images
    from dspfun_tpu.tools import ispec as ispec_tool
    from dspfun_tpu.tools import spec as spec_tool

    rng = np.random.default_rng(9)
    orig = rng.integers(0, 256, (64, 48, 3)).astype(np.uint8)
    src = str(tmp_path / "s.png")
    Image.fromarray(orig).save(src)
    monkeypatch.setenv("DSPFUN_PRECISION", "i8@1e-5")
    prec_mod.set_precision(prec_mod._from_env())
    try:
        assert prec_mod.get_precision().intermediate == "i8"
        assert prec_mod.get_precision().tol == 1e-5
        spng, back = str(tmp_path / "f.png"), str(tmp_path / "b.png")
        assert spec_tool.main(["-t", "flat", "-G", "1000", src, spng]) == 0
        assert ispec_tool.main(["-t", "flat", "-G", "1000", spng, back]) == 0
        got = images.read_image(back).pixels
        assert np.sqrt(np.mean((got - orig / 255.0) ** 2)) < 2e-3
    finally:
        monkeypatch.delenv("DSPFUN_PRECISION")
        prec_mod.set_precision(prec_mod._from_env())


def test_transcode_16bit_y4m_preserves_depth(tmp_path):
    """A 16-bit y4m survives transcode at full depth (round 3: the
    high-depth C-tags ride the native container both directions)."""
    from fractions import Fraction

    import numpy as np

    from dspfun_tpu.io import video
    from dspfun_tpu.tools import transcode as transcode_tool

    src = str(tmp_path / "in.y4m")
    props = video.parse_color_props(
        "pixel_format=yuv444p16le:color_range=jpeg")
    rng = np.random.default_rng(11)
    frames = rng.random((2, 8, 16)).astype(np.float64)
    with video.open_output(src, 16, 8, Fraction(25), props) as w:
        for f in frames:
            w.write_frame([f, np.full((8, 16), 0.5), np.full((8, 16), 0.5)])
    out = str(tmp_path / "out.y4m")
    assert transcode_tool.main([src, out]) == 0
    with video.open_input(out) as r:
        assert r.pix_fmt.name == "yuv444p16le"
        got = [r.read_frame()[0] for _ in range(2)]
    err = np.max(np.abs(np.stack(got) - frames))
    assert err <= 1.5 / 65535.0, err


def test_per_tool_precision_defaults(monkeypatch):
    """VERDICT r3 item 8: per-tool defaults mirror the reference's
    per-tool Makefile precisions; DSPFUN_PRECISION / set_precision
    always win."""
    from dspfun_tpu.core import precision as pr

    # table: zoom gets the accuracy-class contraction on an accelerator, the
    # hilo default on CPU; motion/scan keep the F/L analogue
    monkeypatch.setattr(pr, "_on_accelerator", lambda: True)
    zp = pr.tool_default("zoom")
    assert zp.intermediate == "i8" and zp.tol is None
    monkeypatch.setattr(pr, "_on_accelerator", lambda: False)
    assert pr.tool_default("zoom").intermediate == "hilo"
    assert pr.tool_default("motion") == pr.Precision()
    assert pr.tool_default("scan").coeff_dtype == pr.Precision().coeff_dtype

    # apply: installs only when nothing explicit was chosen
    monkeypatch.setattr(pr, "_explicit", False)
    monkeypatch.setattr(pr, "_on_accelerator", lambda: True)
    pr.apply_tool_default("zoom")
    assert pr.get_precision().intermediate == "i8"
    pr.apply_tool_default("motion")
    assert pr.get_precision().intermediate == "hilo"

    # explicit choice sticks
    pr.set_precision(pr.Precision(coeff="float32", intermediate="exact"))
    pr.apply_tool_default("zoom")
    assert pr.get_precision().intermediate == "exact"
    pr.set_precision(pr.Precision())  # restore for other tests
