"""Process-level pipe composition — the reference's core UX
(SURVEY.md L4: tools compose via stdin/stdout, e.g.
``spec -tflat img.png - | ... | ispec -tflat``, spec/README.md:62-64).
Real subprocesses + OS pipes, not in-process main() calls."""

import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parent.parent


def _env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _tool(name, *args):
    return [sys.executable, "-m", f"dspfun_tpu.tools.{name}", *args]


def test_spec_ispec_through_os_pipe(tmp_path):
    src = tmp_path / "src.png"
    back = tmp_path / "back.png"
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)
    Image.fromarray(img).save(src)

    p1 = subprocess.Popen(_tool("spec", "-t", "flat", str(src), "-"),
                          stdout=subprocess.PIPE, env=_env())
    p2 = subprocess.Popen(_tool("ispec", "-t", "flat", "-", str(back)),
                          stdin=p1.stdout, env=_env())
    p1.stdout.close()
    assert p2.wait(timeout=300) == 0
    assert p1.wait(timeout=10) == 0

    from dspfun_tpu.io import images

    got = images.read_image(str(back)).pixels
    assert np.max(np.abs(got - img / 255.0)) < 2e-3  # 16-bit flat loss


def test_motion_transcode_through_os_pipe(tmp_path):
    from dspfun_tpu.io import video

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.y4m"
    props = video.parse_color_props("pixel_format=yuv444p")
    rng = np.random.default_rng(1)
    frames = rng.random((4, 16, 16, 3)).astype(np.float32)
    with video.open_output(str(clip), 16, 16, Fraction(25), props) as wr:
        for f in frames:
            wr.write_frame_rgb(f)

    # motion writes y4m to stdout (pipe default, reference
    # ffapi.c:177-178), transcode reads it from stdin
    p1 = subprocess.Popen(
        _tool("motion", "-Q", "-b", "8x8x2", "-D", "0.5", str(clip), "-"),
        stdout=subprocess.PIPE, env=_env())
    p2 = subprocess.Popen(_tool("transcode", "-", str(out)),
                          stdin=p1.stdout, env=_env())
    p1.stdout.close()
    assert p2.wait(timeout=300) == 0
    assert p1.wait(timeout=10) == 0

    with video.open_input(str(out)) as r:
        n = 0
        while r.read_frame_rgb() is not None:
            n += 1
    assert n == 4
