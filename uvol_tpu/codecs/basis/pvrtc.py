"""PVRTC1 4bpp codec: the `pvrtc1` transcode target + its decoder.

The reference's KTX2Loader transcodes ETC1S to PVRTC1 on PVRTC-capable
(PowerVR/iOS-class) devices, gated on power-of-two dimensions
(FORMAT_OPTIONS pvrtc rows, /root/reference/src/lib/KTX2Loader.js:591-697).
This module implements that target natively:

  - `transcode_blocks_to_pvrtc1`: (endpoint, selector) index grids →
    64-bit PVRTC1 blocks in Morton order. Block color A carries the
    ETC1S entry's lowest intensity level, color B its highest, and the
    per-texel 2-bit modulation is chosen against the actual bilinearly
    interpolated A/B fields (so the encode accounts for the format's
    cross-block color interpolation instead of assuming flat blocks).
  - `decode_pvrtc1_4bpp`: full decoder — Morton block order, 554/555
    color endpoints, x4 bilinear upscale of both color images with
    wraparound, modulation weights {0, 3/8, 5/8, 1} (and the 4/8
    punch-through row when a block selects the alternate modulation
    mode, which this transcoder never emits).

No independent PVRTC oracle exists in this image (Mesa llvmpipe does not
expose IMG texture formats), so unlike the ETC/S3TC/BPTC/ASTC targets the
pair is validated by self-consistency + reconstruction PSNR against the
full RGBA decode (tests/test_pvrtc.py), with the wire layout following
the published PVRTC1 block description (color word: bit0 modulation
mode, bits1-14 color A + bit15 opaque flag, bits16-30 color B + bit31
opaque flag; modulation word: 2 bits per texel, LSB-first raster order).
"""

from __future__ import annotations

import numpy as np

#: modulation blend weights (opaque mode), in eighths
_MOD_WEIGHTS8 = np.array([0, 3, 5, 8], np.int64)


def _morton_interleave(
    bx: np.ndarray, by: np.ndarray, nbx: int = 0, nby: int = 0
) -> np.ndarray:
    """PVRTC block order (PowerVR TwiddleUV): Morton/Z-order with y in
    the even bit positions. For non-square power-of-two grids the
    smaller dimension's bits interleave and the larger dimension's
    remaining high bits append linearly above them (hardware rule; a
    plain Morton would leave index gaps). Square grids (nbx == nby, or
    the sizes omitted) reduce to standard Morton."""
    out = np.zeros_like(bx)
    if nbx <= 0 or nby <= 0 or nbx == nby:
        for bit in range(16):
            out |= ((by >> bit) & 1) << (2 * bit)
            out |= ((bx >> bit) & 1) << (2 * bit + 1)
        return out
    min_bits = min(nbx, nby).bit_length() - 1
    for bit in range(min_bits):
        out |= ((by >> bit) & 1) << (2 * bit)
        out |= ((bx >> bit) & 1) << (2 * bit + 1)
    longer = bx if nbx > nby else by
    out |= (longer >> min_bits) << (2 * min_bits)
    return out


def _expand_a(col14: np.ndarray) -> np.ndarray:
    """Color A: 14 bits = R5 G5 B4 (opaque form) → RGB8."""
    r = (col14 >> 9) & 31
    g = (col14 >> 4) & 31
    b = col14 & 15
    return np.stack(
        [(r << 3) | (r >> 2), (g << 3) | (g >> 2), (b << 4) | b], axis=-1
    )


def _expand_b(col15: np.ndarray) -> np.ndarray:
    """Color B: 15 bits = R5 G5 B5 → RGB8."""
    r = (col15 >> 10) & 31
    g = (col15 >> 5) & 31
    b = col15 & 31
    return np.stack(
        [(r << 3) | (r >> 2), (g << 3) | (g >> 2), (b << 3) | (b >> 2)],
        axis=-1,
    )


def _quant_a(rgb: np.ndarray) -> np.ndarray:
    """RGB8 → color A 14-bit field (R5 G5 B4), rounding."""
    r = np.clip((rgb[..., 0].astype(np.int64) * 31 + 127) // 255, 0, 31)
    g = np.clip((rgb[..., 1].astype(np.int64) * 31 + 127) // 255, 0, 31)
    b = np.clip((rgb[..., 2].astype(np.int64) * 15 + 127) // 255, 0, 15)
    return (r << 9) | (g << 4) | b


def _quant_b(rgb: np.ndarray) -> np.ndarray:
    """RGB8 → color B 15-bit field (R5 G5 B5), rounding."""
    r = np.clip((rgb[..., 0].astype(np.int64) * 31 + 127) // 255, 0, 31)
    g = np.clip((rgb[..., 1].astype(np.int64) * 31 + 127) // 255, 0, 31)
    b = np.clip((rgb[..., 2].astype(np.int64) * 31 + 127) // 255, 0, 31)
    return (r << 10) | (g << 5) | b


def _upscale_bilinear_wrap(low: np.ndarray) -> np.ndarray:
    """[BY, BX, 3] block-resolution color image → [BY*4, BX*4, 3] float,
    x4 bilinear with wraparound; source texel centers sit at local
    (1.5, 1.5) inside each 4x4 footprint (the PVRTC low-frequency
    filter)."""
    by, bx, _ = low.shape
    h, w = by * 4, bx * 4
    ys = (np.arange(h) - 1.5) / 4.0
    xs = (np.arange(w) - 1.5) / 4.0
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    y0 %= by
    x0 %= bx
    y1 = (y0 + 1) % by
    x1 = (x0 + 1) % bx
    lowf = low.astype(np.float32)
    fy = fy.astype(np.float32)
    fx = fx.astype(np.float32)
    top = lowf[y0][:, x0] * (1 - fx) + lowf[y0][:, x1] * fx
    bot = lowf[y1][:, x0] * (1 - fx) + lowf[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def decode_pvrtc1_4bpp(words: np.ndarray, width: int, height: int) -> np.ndarray:
    """[N, 2] uint32 little-endian block words (modulation, color) in
    Morton order → [H, W, 4] RGBA8. Power-of-two dimensions only."""
    by, bx = height // 4, width // 4
    words = np.asarray(words, np.uint64).reshape(by * bx, 2)
    # de-morton into raster block grids
    gy, gx = np.mgrid[0:by, 0:bx]
    morton = _morton_interleave(gx.ravel(), gy.ravel(), bx, by)
    modw = np.zeros(by * bx, np.uint64)
    colw = np.zeros(by * bx, np.uint64)
    modw[np.arange(by * bx)] = words[morton, 0]
    colw[np.arange(by * bx)] = words[morton, 1]
    modw = modw.reshape(by, bx)
    colw = colw.reshape(by, bx).astype(np.int64)

    a_rgb = _expand_a((colw >> 1) & 0x3FFF)  # [by,bx,3]
    b_rgb = _expand_b((colw >> 16) & 0x7FFF)
    a_up = _upscale_bilinear_wrap(a_rgb)  # [H,W,3] float
    b_up = _upscale_bilinear_wrap(b_rgb)

    # per-texel modulation: 2 bits, LSB-first in raster order inside the
    # block (texel index t = ly*4 + lx)
    t = np.arange(16)
    mod2 = (
        modw[:, :, None].astype(np.int64) >> (2 * t)[None, None, :]
    ) & 3  # [by,bx,16]
    mode = colw & 1  # alternate (punch-through) modulation mode
    w8 = _MOD_WEIGHTS8[mod2]  # [by,bx,16]
    # punch-through mode: codes 1/2 blend at 4/8; code 2 is transparent
    w8_pt = np.array([0, 4, 4, 8], np.int64)[mod2]
    w8 = np.where(mode[:, :, None] == 1, w8_pt, w8)
    alpha = np.where(
        (mode[:, :, None] == 1) & (mod2 == 2), 0, 255
    )  # [by,bx,16]

    h, w = height, width
    wfull = np.zeros((h, w), np.int64)
    afull = np.full((h, w), 255, np.int64)
    ly, lx = t // 4, t % 4
    yy = (np.arange(by) * 4)[:, None, None] + ly[None, None, :]
    xx = (np.arange(bx) * 4)[None, :, None] + lx[None, None, :]
    wfull[yy, xx] = w8
    afull[yy, xx] = alpha
    rgb = a_up + (b_up - a_up) * (wfull[:, :, None] / 8.0)
    out = np.zeros((h, w, 4), np.uint8)
    out[..., :3] = np.clip(np.rint(rgb), 0, 255).astype(np.uint8)
    out[..., 3] = afull.astype(np.uint8)
    return out


def transcode_blocks_to_pvrtc1(
    blocks: np.ndarray, endpoints, selectors: np.ndarray,
    width: int, height: int,
) -> np.ndarray:
    """ETC1S (endpoint, selector) grid [by, bx, 2] → PVRTC1 4bpp block
    words [N, 2] uint32 (modulation word, color word) in Morton order."""
    from uvol_tpu.codecs.basis.transcoder import (
        INTEN_TABLES,
        _endpoint_arrays,
    )

    by, bx = height // 4, width // 4
    color5, inten5 = _endpoint_arrays(endpoints)
    base5 = color5.astype(np.int64)
    base8 = (base5 << 3) | (base5 >> 2)  # [E,3]
    mods = INTEN_TABLES[inten5.astype(np.int64)]  # [E,4]
    lo = np.clip(base8 + mods[:, 0:1], 0, 255)  # [E,3]
    hi = np.clip(base8 + mods[:, 3:4], 0, 255)

    ep = blocks[..., 0].astype(np.int64)  # [by,bx]
    sel = blocks[..., 1].astype(np.int64)
    a_field = _quant_a(lo[ep])  # [by,bx]
    b_field = _quant_b(hi[ep])
    colw = (
        (b_field.astype(np.uint64) << np.uint64(16))
        | np.uint64(1 << 31)  # B opaque
        | (a_field.astype(np.uint64) << np.uint64(1))
        | np.uint64(1 << 15)  # A opaque
    )

    # decoder-visible interpolated A/B fields for modulation selection
    a_up = _upscale_bilinear_wrap(_expand_a(a_field))  # [H,W,3]
    b_up = _upscale_bilinear_wrap(_expand_b(b_field))
    # intended texel values from the ETC1S decode
    t = np.arange(16)
    ly, lx = t // 4, t % 4
    sel_codes = selectors[sel.reshape(-1)][:, ly, lx].astype(np.int64)
    level = np.take_along_axis(
        mods[ep.reshape(-1)], sel_codes, axis=1
    )  # [N,16] modifiers per texel
    want = np.clip(
        base8[ep.reshape(-1)][:, None, :] + level[:, :, None], 0, 255
    )  # [N,16,3]
    yy = (np.repeat(np.arange(by), bx) * 4)[:, None] + ly[None, :]
    xx = (np.tile(np.arange(bx), by) * 4)[:, None] + lx[None, :]
    at = a_up[yy, xx]  # [N,16,3] float32
    diff = b_up[yy, xx] - at
    wantf = want.astype(np.float32)
    # per-weight error without materializing the [N,16,4,3] candidate
    # tensor (the float64 form dominated the transcode at 1024^2)
    err = np.empty(at.shape[:2] + (4,), np.float32)
    for k in range(4):
        v = at + np.float32(_MOD_WEIGHTS8[k] / 8.0) * diff - wantf
        err[:, :, k] = (v * v).sum(-1)
    code = err.argmin(-1).astype(np.uint64)  # [N,16]
    modw = (code << (2 * t)[None, :].astype(np.uint64)).sum(1)  # [N]

    # morton-order the output
    gy, gx = np.mgrid[0:by, 0:bx]
    morton = _morton_interleave(gx.ravel(), gy.ravel(), bx, by)
    out = np.zeros((by * bx, 2), np.uint32)
    out[morton, 0] = modw.astype(np.uint32)
    out[morton, 1] = colw.reshape(-1).astype(np.uint32)
    return out
