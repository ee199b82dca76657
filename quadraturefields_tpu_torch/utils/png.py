"""A small 8-bit PNG codec on the standard library's zlib: gray [H, W]
and RGB [H, W, 3] uint8 images, the texture maps of the bake.

The writer filters every row with filter 0 (None) and compresses the
image with zlib at `level` in one IDAT chunk. The reader takes
non-interlaced 8-bit gray (color type 0) and RGB (color type 2) files
from any writer: all five row filters are undone, rows with filter 0
without a per-pixel loop (an image whose rows all use it is decoded in
one reshape), Sub and Up rows a row at a time, Average and Paeth rows a
pixel at a time. Ancillary chunks are skipped.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}   # color type -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of a gray [H, W] or RGB [H, W, 3] uint8 image."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {image.dtype}")
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG writer takes [H, W] or [H, W, 3], got "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = np.zeros((h, 1 + w * _CHANNELS[color]), np.uint8)
    rows[:, 1:] = image.reshape(h, -1)      # filter byte 0 on every row
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, level))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of raw [H, 1 + stride] (filter byte first)."""
    kinds = raw[:, 0]
    data = raw[:, 1:]
    if not kinds.any():
        return data.copy()
    out = np.empty_like(data)
    prior = np.zeros(data.shape[1], np.uint8)
    for y in range(data.shape[0]):
        kind, row = int(kinds[y]), data[y]
        if kind == 0:
            cur = row
        elif kind == 1:      # Sub: a running sum over each sample lane
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.int64)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = row + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left
            cur = np.empty_like(row)
            r, up = row.tolist(), prior.tolist()
            vals = [0] * len(r)
            for i, x in enumerate(r):
                left = vals[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp
                                  else 0)
                vals[i] = (x + pred) & 0xFF
            cur[:] = vals
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """A gray [H, W] or RGB [H, W, 3] uint8 image from PNG bytes."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG reader takes 8-bit non-interlaced gray or "
                         f"RGB; got depth {depth}, color type {color}, "
                         f"interlace {interlace}")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw.reshape(h, 1 + w * c), c)
    return pixels.reshape((h, w) if c == 1 else (h, w, c))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
