"""Native PNG codec (zlib + struct) for 8- and 16-bit stills.

The tools' main path reads and writes PNG without Pillow: spec stores
spectra at 16 bits (MagickWand's Q16 depth, reference
spec/spec.c:141-155), which Pillow truncates to 8 bits on read for
color images, and 8-bit stills are the usual input.  This module
implements the PNG subset those need:

* write: bit depth 8 or 16, color type 0 (gray) / 4 (gray+alpha) /
  2 (RGB) / 6 (RGBA), filter 0, tEXt chunks for string properties
  (where spec smuggles the "DC" header);
* read: bit depth 8 or 16, color types 0/2/4/6, all five scanline
  filters, non-interlaced.  Palette, sub-byte and interlaced PNGs are
  left to Pillow (``sniff_png`` is False for them).

Unfiltering runs in the native host library when it is built
(native/dspio.cpp); the Python fallback vectorises None/Sub/Up per row
and loops per pixel on Average/Paeth rows (our own writer emits none).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "read_png", "sniff_png"]

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR = {c: t for t, c in _CHANNELS.items()}


def _chunk(typ: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))


def write_png(path_or_stream, arr: np.ndarray,
              properties: dict | None = None) -> None:
    """Write a [H, W, 1|2|3|4] uint8 or uint16 array as a PNG of that
    bit depth (gray, gray+alpha, RGB or RGBA)."""
    arr = np.asarray(arr)
    if (arr.dtype not in (np.uint8, np.uint16) or arr.ndim != 3
            or arr.shape[2] not in _COLOR):
        raise ValueError("write_png wants [H, W, 1|2|3|4] uint8 or uint16")
    h, w, c = arr.shape
    depth = 8 * arr.dtype.itemsize
    rows = arr.astype(">u2") if depth == 16 else arr
    raw = np.zeros((h, 1 + w * c * arr.dtype.itemsize), np.uint8)
    raw[:, 1:] = rows.reshape(h, -1).view(np.uint8)
    out = [_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                             _COLOR[c], 0, 0, 0))]
    for k, v in (properties or {}).items():
        out.append(_chunk(b"tEXt", str(k).encode("latin-1") + b"\x00"
                          + str(v).encode("latin-1")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    data = b"".join(out)
    if hasattr(path_or_stream, "write"):
        path_or_stream.write(data)
    else:
        with open(path_or_stream, "wb") as f:
            f.write(data)


def sniff_png(data: bytes) -> bool:
    """True when ``data`` is a non-interlaced 8- or 16-bit gray/RGB(A)
    PNG this module decodes."""
    if not data.startswith(_SIG) or len(data) < 33:
        return False
    w, h, depth, color, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", data[16:29]
    )
    return depth in (8, 16) and color in _CHANNELS and interlace == 0


def _unfilter_py(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filtering; raw is [h, 1 + stride] uint8."""
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:].copy()
        if ftype == 0:
            rec = line
        elif ftype == 1:  # Sub: per-byte-lane cumulative sum mod 256
            rec = line
            for k in range(bpp):
                lane = rec[k::bpp].astype(np.uint64)
                rec[k::bpp] = np.cumsum(lane).astype(np.uint8)
        elif ftype == 2:  # Up
            rec = line + prev
        elif ftype in (3, 4):  # Average / Paeth: left-dependent, so
            # loop per PIXEL with all bpp byte-lanes vectorised (the
            # dependency spans exactly one pixel)
            npx = stride // bpp
            r = line.astype(np.int32).reshape(npx, bpp)
            p = prev.astype(np.int32).reshape(npx, bpp)
            left = np.zeros(bpp, dtype=np.int32)
            upleft = np.zeros(bpp, dtype=np.int32)
            if ftype == 3:
                for i in range(npx):
                    left = (r[i] + ((left + p[i]) >> 1)) & 0xFF
                    r[i] = left
            else:
                for i in range(npx):
                    b = p[i]
                    pa = np.abs(b - upleft)
                    pb = np.abs(left - upleft)
                    pc = np.abs(left + b - 2 * upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, b, upleft))
                    left = (r[i] + pred) & 0xFF
                    r[i] = left
                    upleft = b
            rec = r.reshape(stride).astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = rec
        prev = out[y]
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    from dspfun_tpu.io import native  # noqa: PLC0415

    if native.available():
        return native.png_unfilter(raw, h, stride, bpp)
    return _unfilter_py(raw, h, stride, bpp)


def read_png(data: bytes) -> tuple[np.ndarray, dict]:
    """Decode an 8- or 16-bit PNG -> ([H, W, C] uint8 or uint16, text
    properties)."""
    if not data.startswith(_SIG):
        raise ValueError("not a PNG")
    pos = 8
    idat = []
    props: dict[str, str] = {}
    w = h = depth = color = None
    while pos + 8 <= len(data):
        ln, typ = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if typ == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            if depth not in (8, 16) or color not in _CHANNELS or interlace:
                raise ValueError("read_png handles non-interlaced 8/16-bit "
                                 "gray/RGB(A) only")
        elif typ == b"tEXt":
            k, _, v = body.partition(b"\x00")
            props[k.decode("latin-1")] = v.decode("latin-1")
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
    if w is None:
        raise ValueError("missing IHDR")
    nch = _CHANNELS[color]
    nbytes = depth // 8
    stride = w * nch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw.reshape(h, 1 + stride)
    flat = _unfilter(raw, h, stride, bpp=nch * nbytes)
    if depth == 8:
        return flat.reshape(h, w, nch), props
    arr = flat.reshape(h, w, nch, 2)
    out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    return out, props
