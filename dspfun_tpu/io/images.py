"""Still-image I/O: the MagickWand surface of the reference.

Covers what the reference tools use from MagickWand
(spec/spec.c:46-60,141-155, ispec.c:54-81,170-182, scan.c:247-281,
zoom.c:230-261, applybasis.c:339-362,449-461):

* read/write by path, ``-`` pipes, and ImageMagick-style ``fmt:path``
  specifiers (``png:-``, ``sixel:-``);
* pixel export/import as float arrays in [0, 1] with a channel string
  ("RGB", "RGBA", "I", ...);
* image properties — notably the base16-encoded per-channel "DC"
  property spec smuggles through the file header
  (spec/spec.h:157-168, spec.c:145-148), stored as a PNG tEXt chunk
  (which is also where ImageMagick keeps string properties in PNGs);
* sRGB <-> linear colorspace transform flags;
* original bit depth (scan --measure-parity, scan.c:278,508-526).
"""

from __future__ import annotations

import dataclasses
import io as _io
import struct
import sys

import numpy as np

from dspfun_tpu.io import color as _color
from dspfun_tpu.io import sixel as _sixel

__all__ = [
    "ImageData",
    "read_image",
    "write_image",
    "base16_encode",
    "base16_decode",
    "encode_dc_property",
    "decode_dc_property",
]

# Channel letters understood by the export/import surface.  "I" is
# intensity (grayscale).
_RGBA = "RGBA"


def base16_encode(data: bytes) -> str:
    """spec's base16 codec: low nibble first, each nibble + 'A'
    (reference spec/spec.h:157-163)."""
    out = []
    for b in data:
        out.append(chr((b & 15) + 65))
        out.append(chr((b >> 4) + 65))
    return "".join(out)


def base16_decode(s: str) -> bytes:
    """Inverse of base16_encode (reference spec/spec.h:164-168)."""
    out = bytearray()
    for i in range(0, len(s) - 1, 2):
        out.append((ord(s[i]) - 65) | ((ord(s[i + 1]) - 65) << 4))
    return bytes(out)


def encode_dc_property(dc: np.ndarray) -> str:
    """Per-channel DC as base16 of little-endian float64s
    (reference spec/spec.c:66-68,145-148)."""
    return base16_encode(struct.pack("<%dd" % len(dc), *np.asarray(dc, dtype=np.float64)))


def decode_dc_property(prop: str, channels: int) -> np.ndarray:
    raw = base16_decode(prop)
    return np.array(struct.unpack("<%dd" % channels, raw[: 8 * channels]), dtype=np.float64)


@dataclasses.dataclass
class ImageData:
    """Float pixels in [0,1], shape [H, W, C], plus metadata."""

    pixels: np.ndarray
    channels: str = "RGB"
    properties: dict = dataclasses.field(default_factory=dict)
    depth: int = 8
    # Was the source tagged as linear RGB (ImageMagick "RGB" colorspace)?
    linear: bool = False

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]


def _split_spec(spec: str) -> tuple[str | None, str]:
    """Split an ImageMagick-style ``fmt:path`` specifier."""
    known = ("png", "jpg", "jpeg", "bmp", "ppm", "pgm", "tiff", "webp", "sixel", "gif")
    if ":" in spec:
        fmt, rest = spec.split(":", 1)
        if fmt.lower() in known:
            return fmt.lower(), rest
    return None, spec


def _to_channels(rgba: np.ndarray, channels: str) -> np.ndarray:
    """Map an [H,W,4] float RGBA array onto a channel-letter string."""
    planes = []
    for ch in channels.upper():
        if ch in _RGBA:
            planes.append(rgba[..., _RGBA.index(ch)])
        elif ch == "I":
            # ITU-R 601 luma, matching common grayscale conversion.
            planes.append(
                0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2]
            )
        else:
            raise ValueError(f"unsupported channel {ch!r}")
    return np.stack(planes, axis=-1)


def _from_channels(pix: np.ndarray, channels: str) -> np.ndarray:
    """Expand channel-letter planes back to [H,W,4] RGBA in [0,1]."""
    h, w = pix.shape[:2]
    rgba = np.zeros((h, w, 4), dtype=np.float64)
    rgba[..., 3] = 1.0
    for i, ch in enumerate(channels.upper()):
        if ch in _RGBA:
            rgba[..., _RGBA.index(ch)] = pix[..., i]
        elif ch == "I":
            rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = pix[..., i]
        else:
            raise ValueError(f"unsupported channel {ch!r}")
    return rgba


def read_image(spec: str, channels: str = "RGB", linear: bool = False) -> ImageData:
    """Read an image (path, ``-`` for stdin, or ``fmt:path``).

    ``linear=True`` converts sRGB input to linear light, the ``-g``
    behaviour (MagickTransformImageColorspace(RGBColorspace),
    reference spec/spec.c:57).
    """
    from dspfun_tpu.io import png16 as _png  # noqa: PLC0415

    _, path = _split_spec(spec)
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as f:
            data = f.read()

    if _png.sniff_png(data):
        # 8/16-bit gray/RGB(A) PNG: native (Pillow truncates 16-bit
        # color PNGs to 8 bits, and the main path must not need it)
        arr, properties = _png.read_png(data)
        depth = 8 * arr.dtype.itemsize
        fa = arr.astype(np.float64) / float((1 << depth) - 1)
        h, w, nch = fa.shape
        rgba = np.zeros((h, w, 4), dtype=np.float64)
        rgba[..., 3] = 1.0
        if nch == 1:
            rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = fa[..., 0]
        elif nch == 2:
            rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = fa[..., 0]
            rgba[..., 3] = fa[..., 1]
        else:
            rgba[..., :nch] = fa
    else:
        from PIL import Image  # noqa: PLC0415

        img = Image.open(_io.BytesIO(data))
        properties = dict(getattr(img, "text", {}) or {})
        mode = img.mode
        if mode in ("I;16", "I;16B", "I;16L", "I;16N", "I"):
            # PIL loads 16-bit grayscale PNG/TIFF as I;16* or as mode
            # "I" (16-bit data in a 32-bit container)
            depth = 16
            arr = np.asarray(img.convert("I"), dtype=np.float64) / 65535.0
            rgba = np.stack([arr, arr, arr, np.ones_like(arr)], axis=-1)
        else:
            depth = 16 if mode.startswith("I;16") else 8
            rgba_img = img.convert("RGBA")
            rgba = np.asarray(rgba_img, dtype=np.float64) / 255.0

    was_linear = properties.get("colorspace") == "RGB"
    if linear and not was_linear:
        rgba = np.concatenate(
            [_color.srgb_decode(rgba[..., :3]), rgba[..., 3:]], axis=-1
        )
    pix = _to_channels(rgba, channels)
    return ImageData(
        pixels=pix,
        channels=channels,
        properties=properties,
        depth=depth,
        linear=linear or was_linear,
    )


def write_image(
    spec: str | None,
    pixels: np.ndarray,
    channels: str = "RGB",
    properties: dict | None = None,
    to_srgb: bool = False,
    depth: int = 8,
) -> None:
    """Write float pixels in [0,1] to path / ``-`` stdout / ``fmt:path``.

    ``to_srgb=True`` re-encodes linear-light pixels with the sRGB OETF
    before quantisation (the output half of ``-g``,
    reference ispec.c:173-176).  ``spec=None`` defaults to sixel on a
    tty, matching the reference tools' isatty behaviour
    (spec/spec.c:41-42).
    """
    if spec is None:
        spec = "sixel:-" if sys.stdout.isatty() else "-"
    fmt, path = _split_spec(spec)

    rgba = _from_channels(np.asarray(pixels, dtype=np.float64), channels)
    if to_srgb:
        rgba = np.concatenate(
            [_color.srgb_encode(rgba[..., :3]), rgba[..., 3:]], axis=-1
        )
    scale = (1 << depth) - 1
    quant = np.clip(np.rint(np.clip(rgba, 0.0, 1.0) * scale), 0, scale)

    if fmt == "sixel":
        rgb8 = (quant[..., :3] * (255.0 / scale)).astype(np.uint8)
        stream = sys.stdout.buffer if path == "-" else open(path, "wb")
        try:
            _sixel.write_sixel(rgb8, stream)
        finally:
            if path != "-":
                stream.close()
        return

    fmt_name = (fmt or (path.rsplit(".", 1)[-1] if "." in path else "png")).upper()
    if fmt_name in ("JPG",):
        fmt_name = "JPEG"
    if path == "-":
        fmt_name = fmt_name if fmt else "PNG"
    has_alpha = "A" in channels.upper()

    if fmt_name == "PNG":
        # native writer: no Pillow on the main path, and 16-bit color
        # (reference depth semantics: MagickWand Q16 stores spectra at
        # 16 bits, spec/spec.c:141-155)
        from dspfun_tpu.io import png16 as _png  # noqa: PLC0415

        if depth == 16 and len(channels) == 1:
            arr = quant[..., :1].astype(np.uint16)
        else:
            arr = quant[..., :4 if has_alpha else 3].astype(
                np.uint16 if depth == 16 else np.uint8)
        if path == "-":
            _png.write_png(sys.stdout.buffer, arr, properties)
            sys.stdout.buffer.flush()
        else:
            _png.write_png(path, arr, properties)
        return

    from PIL import Image  # noqa: PLC0415

    if depth == 16:
        if len(channels) != 1:
            raise ValueError(f"16-bit output requires PNG (got {fmt_name.lower()!r})")
        # uint16 infers mode I;16 (explicit mode= is deprecated)
        img = Image.fromarray(quant[..., 0].astype(np.uint16))
    else:
        arr8 = quant.astype(np.uint8)
        if has_alpha:
            img = Image.fromarray(arr8, mode="RGBA")
        else:
            img = Image.fromarray(arr8[..., :3], mode="RGB")
    # non-PNG formats drop string properties, as ImageMagick does for
    # most formats
    if path == "-":
        buf = _io.BytesIO()
        img.save(buf, format=fmt_name)
        sys.stdout.buffer.write(buf.getvalue())
        sys.stdout.buffer.flush()
    else:
        img.save(path, format=fmt_name)
