"""dspfun_tpu — a spectral image/video framework on JAX.

A ground-up JAX/XLA re-design of the capabilities of 0x09/dspfun (a
C11 suite of FFTW/ImageMagick/FFmpeg command-line tools for spectral
analysis of images and video).

Design principles:

* All transforms (DCT-I..IV, DST-I..IV, DFT, WHT, DHT) are expressed as
  dense basis-matrix contractions on the accelerator's matrix units,
  batched over blocks/channels/frames — not FFT butterflies.
* The per-coefficient filter chains (spec's gain/range/scale/sign chain,
  motion's bandpass/threshold/quant chain) are pure elementwise jax ops
  fused by XLA into the surrounding matmuls.
* Precision is a runtime policy (coeff/intermediate dtypes) instead of
  the reference's compile-time COEFF_PRECISION/INTERMEDIATE_PRECISION
  macros (reference include/precision.h:26-57).
* Multi-device scaling is first-class: `dspfun_tpu.parallel` shards the
  block grid / pixel grid / time axis of frame cubes over a
  `jax.sharding.Mesh` with shard_map collectives. (The reference is
  single-process; its only concurrency is FFTW pthreads.)

Toolsets (mirroring the reference's five; reference README.md:12-18):
  spec/ispec     — invertible whole-image 2-D DCT spectrograms
  motion/rotate/transcode — 3-D (x,y,t) blockwise frequency-space video editing
  applybasis/genbasis/draw — basis-function rendering/application, 12 families
  zoom           — continuous DCT-basis interpolation at arbitrary scale/offset
  scan           — progressive reconstruction by frequency-space scan orders

The backend is JAX's: ``JAX_PLATFORMS=cpu`` runs everything on the host.
"""

__version__ = "0.1.0"

from dspfun_tpu.core.precision import Precision, get_precision, set_precision

__all__ = ["Precision", "get_precision", "set_precision", "__version__"]
