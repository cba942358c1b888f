"""PNG reading and writing without an image library.

``read_png_rgb(path)`` decodes an 8-bit, non-interlaced PNG (grey, grey and
alpha, RGB, RGBA or palette) to the (H, W, 3) uint8 array that PIL's
``Image.open(path).convert("RGB")`` gives: grey is repeated in the three
channels, alpha is dropped, a palette index becomes its PLTE entry. The IDAT
stream is inflated by ``zlib``; the row filters are undone by the host
library (``csrc/modest_host.cpp::mh_png_unfilter``: Sub, Average and Paeth
depend on the byte to the left, so the loop runs along each row), or by
``unfilter_rows`` where the library cannot be built. ``write_png`` writes an
(H, W, 3) or (H, W) uint8 array with filter 0 (None) on every row.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels a pixel has in the IDAT stream
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def unfilter_rows(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The host library's un-filter in numpy and Python: Up and Sub by
    whole rows, Average and Paeth byte by byte."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 1:
            # each of the bpp interleaved byte streams is a running sum mod 256
            cur = np.empty(stride, np.int64)
            for k in range(min(bpp, stride)):
                cur[k::bpp] = np.cumsum(line[k::bpp]) & 0xFF
        elif ft in (3, 4):
            cur = np.zeros(stride, np.int64)
            ln, up = line.tolist(), prev.tolist()
            vals = [0] * stride
            for i in range(stride):
                a = vals[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                vals[i] = (ln[i] + pred) & 0xFF
            cur[:] = vals
        else:
            raise ValueError(f"png: row {y} has an unknown filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def read_png_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 pixels of the PNG at ``path``, as PIL's
    ``.convert("RGB")`` gives them."""
    from . import native

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"not a png: {path}")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"png: no IHDR in {path}")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace != 0:
        raise NotImplementedError(f"png: {path} has bit depth {depth}, colour type {colour}, "
                                  f"interlace {interlace}; 8-bit non-interlaced images only")
    ch = CHANNELS[colour]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"png: {path} inflates to {raw.size} bytes, not {h * (stride + 1)}")
    pix = native.png_unfilter(raw, h, stride, ch)
    if pix is None:
        pix = unfilter_rows(raw, h, stride, ch)
    pix = pix.reshape(h, w, ch)
    if colour == 3:
        if palette is None:
            raise ValueError(f"png: palette image {path} has no PLTE")
        return palette[pix[..., 0]]
    if colour in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def chunk(kind: bytes, data: bytes) -> bytes:
    """One PNG chunk: length, type, data, CRC."""
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, pixels: np.ndarray) -> None:
    """Write (H, W, 3) RGB or (H, W) grey uint8 ``pixels`` as an 8-bit PNG,
    every row filter 0."""
    pix = np.ascontiguousarray(pixels, np.uint8)
    if pix.ndim == 2:
        colour, ch = 0, 1
    elif pix.ndim == 3 and pix.shape[2] == 3:
        colour, ch = 2, 3
    else:
        raise ValueError(f"write_png: pixels of shape {pix.shape}; (H, W, 3) or (H, W)")
    h, w = pix.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pix.reshape(h, w * ch)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
