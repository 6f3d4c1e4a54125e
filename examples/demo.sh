#!/bin/sh
# End-to-end demo of all ten tools on a synthetic image.
# Defaults to JAX_PLATFORMS=cpu (small-image runs are instant on the
# host); run `JAX_PLATFORMS=cuda sh examples/demo.sh` on a GPU.
set -e
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
# make the repo importable from the temp working dir (append, don't
# replace an existing PYTHONPATH)
repo_dir="$(CDPATH= cd -- "$(dirname -- "$0")/.." && pwd)"
export PYTHONPATH="${repo_dir}${PYTHONPATH:+:$PYTHONPATH}"
cd "$(mktemp -d)"
echo "working in $PWD"

python - <<'EOF'
import numpy as np
from dspfun_tpu.io import images
y, x = np.mgrid[0:96, 0:128] / 64.0
img = np.clip(np.stack([0.5+0.4*np.sin(6*x), 0.5+0.4*np.cos(4*y),
                        0.3+0.2*np.sin(3*(x+y))], -1), 0, 1)
images.write_image("src.png", img)
images.write_image("small.png", img[:24, :32])
EOF

run() { echo "+ dspfun $*"; python -m dspfun_tpu.tools.main "$@"; }

# spec / ispec round trip (+ signmap steganography workflow)
run spec  -t flat -G 1000 src.png spec.png
run ispec -t flat -G 1000 spec.png back.png
run spec  -t sign src.png signmap.png
run spec  -t abs  src.png absspec.png
run ispec -t abs -m signmap.png absspec.png back2.png

# basis toolset (applybasis is O(N^4) like the reference: small input,
# full-sum dump -> the true spectrum; inverse with the DCT3 family)
run genbasis --size 8x8 -f dct2 dctbasis.png
run applybasis -f dct2 -u 32x24 -d fwd.coeff small.png fwd.png
run applybasis -f dct3 -I -u 32x24 -N shift fwd.coeff inv.png
run draw -b 64x64 -f 3x2:0.4 -f 8x1:0.2 drawn.png

# zoom: 3x upscale animation
run zoom -s 3 -n 4 -S '1+i/2' -q src.png zoom.fvid

# scan: progressive reconstruction with spectrogram pane
run scan -m radial -s -S 32 -q src.png scan.fvid

# motion: temporal lowpass over 2-frame cubes + rotate + transcode
python - <<'EOF'
import numpy as np
from fractions import Fraction
from dspfun_tpu.io import images, video
img = images.read_image("src.png").pixels
with video.open_output("clip.y4m", 128, 96, Fraction(25),
                       video.parse_color_props("pixel_format=yuv444p")) as w:
    for t in range(4):
        w.write_frame_rgb(np.clip(img + 0.05*np.sin(t), 0, 1))
EOF
run motion -Q -b 0x0x2 -p 0x0x0-0x0x1 clip.y4m lowpass.y4m
run rotate -q zyx clip.y4m rotated.y4m
run transcode -q clip.y4m copy.y4m

# the reference's default output container is NUT (motion.c:447); ours
# is native (io/nut.py) — write one and read it back with zero
# external binaries
run motion -Q -b 0x0x2 clip.y4m out.nut
run transcode -q out.nut fromnut.y4m

echo "all tools ran; outputs in $PWD"
ls -la
