"""Minimal PNG codec on zlib + numpy: 8-bit gray, RGB and RGBA images.

The encoder's texture inputs are PNG frames (scripts/Encoder.py's
`ImagesPath`). This reader covers what such frames use: bit depth 8,
color types 0 (gray), 2 (RGB) and 6 (RGBA), no interlace, and all five
row filters (None, Sub, Up, Average, Paeth). Anything else raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel


def is_png(data: bytes) -> bool:
    return data[:8] == PNG_SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length  # length, type, body, crc


def _unfilter_slow(kind: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4): each byte depends on the reconstructed
    byte to its left, so they run byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] (gray) or [H, W, 3|4] uint8."""
    if not is_png(data):
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}); supported: 8-bit gray/RGB/RGBA, "
            "non-interlaced"
        )
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(
                line.reshape(w, bpp), axis=0, dtype=np.uint8
            ).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prior = out[y]
    if bpp == 1:
        return out.reshape(h, w)
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """[H, W] or [H, W, 1|3|4] uint8 -> PNG bytes (Up filter on every
    row: one vectorized difference, and it compresses smooth images
    well)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"unsupported image shape {a.shape}")
    h, w = a.shape[:2]
    flat = np.ascontiguousarray(a).reshape(h, -1)
    up = flat.copy()
    up[1:] -= flat[:-1]  # uint8 arithmetic wraps mod 256
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (
        PNG_SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
