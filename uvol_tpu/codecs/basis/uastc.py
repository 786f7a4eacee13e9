"""UASTC LDR 4x4 texture codec: encoder (fixture + production) and
transcoder to RGBA, wired through the KTX2 container (DFD color model
166 + optional Zstd supercompression), mirroring the reference's UASTC
capability (src/lib/KTX2Loader.js:469-580 transcode; `basisu -uastc`
encode invoked by scripts/Encoder.py:33-39).

STATUS (round 4): the wire this encoder EMITS by default is the
spec-structured layout in codecs/basis/uastc_spec.py (variable-length
mode codes, ASTC endpoint ranges + BISE, ASTC-range plain weights; no
profile marker). The layout below — the round-2/3 ``UVTUASTCProfile``
— is retained as a LEGACY wire: files carrying its KTX2 marker still
decode through this module, and `encode_uastc_ktx2(wire="legacy")`
still writes it. transcode_uastc dispatches on the marker.

HONESTY / SCOPE (read before relying on interop):

This environment has zero egress and ships no UASTC spec text, no
basisu binary and no UASTC fixtures, so bit-level interop with real
basisu UASTC output CANNOT be verified here. What this module is:

- The ASTC building blocks implemented to the Khronos spec as known
  offline: the integer-sequence (BISE) trit/quint codec (the 5-trit/8-bit
  and 3-quint/7-bit packings with their interleaved truncation rule),
  LDR endpoint expansion (bit replication), and the 16-bit endpoint
  interpolation `(e0*(64-w) + e1*w + 32) >> 6`.
- A documented block layout (5-bit mode field, then component selector /
  endpoints / BISE weights) covering ALL 19 mode slots (0-18): solid
  color (8), single-subset RGB/RGBA/LA at weight levels 2-16, 2/3-subset
  partitions via the real ASTC hash52 pattern function, alpha-plane
  dual-plane RGBA (modes 11/13/17), and shared-endpoint RGB dual-plane
  (mode 6, the ASTC dual-plane rule). Ids 19-31 raise.
- Deliberate simplifications flagged for later verification: weight
  dequantization uses exact rational rounding to 0..64 (the ASTC spec's
  bit-replication approximation can differ by ±1 at some levels), and
  the mode numbering follows UASTC's semantics but the field packing is
  this module's own documented profile.

Every encode→container→decode path is self-roundtrip golden-tested
(tests/test_uastc.py); files produced here declare KHR_DF_MODEL_UASTC so
the player dispatches them exactly like the reference's KTX2Loader.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

#: KTX2 key/value marker stamped on every file this encoder writes; its
#: absence on read means "foreign UASTC file" (real basisu output) whose
#: bit layout this self-profile decoder does NOT understand.
UASTC_PROFILE_KEY = b"UVTUASTCProfile"
UASTC_PROFILE_VALUE = b"uvol_tpu-v1"

# ---------------------------------------------------------------------------
# BISE — ASTC integer sequence encoding (trits and quints)
# ---------------------------------------------------------------------------


def _decode_trit_block(T: int) -> Tuple[int, int, int, int, int]:
    """Khronos ASTC trit-block decode: 8 bits -> 5 trits."""
    if (T >> 2) & 0x7 == 0x7:
        C = ((T >> 5) & 0x7) << 2 | (T & 0x3)
        t4 = t3 = 2
    else:
        C = T & 0x1F
        if (T >> 5) & 0x3 == 0x3:
            t4 = 2
            t3 = (T >> 7) & 1
        else:
            t4 = (T >> 7) & 1
            t3 = (T >> 5) & 0x3
    if C & 0x3 == 0x3:
        t2 = 2
        t1 = (C >> 4) & 1
        c3 = (C >> 3) & 1
        c2 = (C >> 2) & 1
        t0 = (c3 << 1) | (c2 & ~c3 & 1)
    elif (C >> 2) & 0x3 == 0x3:
        t2 = 2
        t1 = 2
        t0 = C & 0x3
    else:
        t2 = (C >> 4) & 1
        t1 = (C >> 2) & 0x3
        c1 = (C >> 1) & 1
        c0 = C & 1
        t0 = (c1 << 1) | (c0 & ~c1 & 1)
    return t0, t1, t2, t3, t4


def _decode_quint_block(Q: int) -> Tuple[int, int, int]:
    """Khronos ASTC quint-block decode: 7 bits -> 3 quints."""
    if (Q >> 1) & 0x3 == 0x3 and (Q >> 5) & 0x3 == 0:
        q0_ = Q & 1
        q3 = (Q >> 3) & 1
        q4 = (Q >> 4) & 1
        q2 = (q0_ << 2) | ((q4 & ~q0_ & 1) << 1) | (q3 & ~q0_ & 1)
        q1 = 4
        q0 = 4
    else:
        if (Q >> 1) & 0x3 == 0x3:
            q2 = 4
            C = (((Q >> 3) & 0x3) << 3) | ((~(Q >> 5) & 0x3) << 1) | (Q & 1)
        else:
            q2 = (Q >> 5) & 0x3
            C = Q & 0x1F
        if C & 0x7 == 0x5:
            q1 = 4
            q0 = (C >> 3) & 0x3
        else:
            q1 = (C >> 3) & 0x3
            q0 = C & 0x7
    return q0, q1, q2


# trailing-bit budget per value count inside a group (ASTC truncation rule)
_TRIT_CUM_BITS = [2, 4, 5, 7, 8]  # chunks 2,2,1,2,1
_QUINT_CUM_BITS = [3, 5, 7]  # chunks 3,2,2


def _build_encode_luts():
    """trit/quint tuple -> minimal valid block code, plus per-partial-count
    codes whose truncated high bits are zero (so lazily-truncated streams
    decode with the missing bits read as 0)."""
    trit_full = np.full(3**5, -1, np.int64)
    trit_partial = [np.full(3**n, -1, np.int64) for n in range(1, 5)]
    for T in range(256):
        t = _decode_trit_block(T)
        idx = t[0] + 3 * (t[1] + 3 * (t[2] + 3 * (t[3] + 3 * t[4])))
        if trit_full[idx] < 0:
            trit_full[idx] = T
        for n in range(1, 5):
            if T >> _TRIT_CUM_BITS[n - 1]:
                continue  # high bits must be zero for a truncated group
            pidx = 0
            for k in range(n - 1, -1, -1):
                pidx = pidx * 3 + t[k]
            if trit_partial[n - 1][pidx] < 0:
                trit_partial[n - 1][pidx] = T
    quint_full = np.full(5**3, -1, np.int64)
    quint_partial = [np.full(5**n, -1, np.int64) for n in range(1, 3)]
    for Q in range(128):
        q = _decode_quint_block(Q)
        idx = q[0] + 5 * (q[1] + 5 * q[2])
        if quint_full[idx] < 0:
            quint_full[idx] = Q
        for n in range(1, 3):
            if Q >> _QUINT_CUM_BITS[n - 1]:
                continue
            pidx = 0
            for k in range(n - 1, -1, -1):
                pidx = pidx * 5 + q[k]
            if quint_partial[n - 1][pidx] < 0:
                quint_partial[n - 1][pidx] = Q
    trit_dec = np.array([_decode_trit_block(T) for T in range(256)], np.int64)
    quint_dec = np.array([_decode_quint_block(Q) for Q in range(128)], np.int64)
    return trit_full, trit_partial, quint_full, quint_partial, trit_dec, quint_dec


(_TRIT_ENC, _TRIT_ENC_PARTIAL, _QUINT_ENC, _QUINT_ENC_PARTIAL,
 _TRIT_DEC, _QUINT_DEC) = _build_encode_luts()


def bise_bits(n_values: int, base: int) -> int:
    """Stream bits for n values of pure trits (base 3) / quints (base 5) /
    2^b levels (base = levels)."""
    if base == 3:
        return (n_values * 8 + 4) // 5
    if base == 5:
        return (n_values * 7 + 2) // 3
    b = int(base).bit_length() - 1
    return n_values * b


# ---------------------------------------------------------------------------
# Mode table (this module's documented profile; see module docstring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UastcMode:
    cem: int          # 4 = LA direct, 8 = RGB direct, 12 = RGBA direct
    ep_bits: int      # endpoint component bits (bit-replicated to 8)
    weight_levels: int  # 2 / 3 / 4 / 5 / 8 / 16 (3, 5 go through BISE)
    dual_plane: bool = False
    subsets: int = 1  # ASTC partitions; >1 adds a 10-bit seed field
    plane2: int = 3   # dual-plane: channel the 2nd weight plane drives
                      # (3 = alpha with its own endpoint pair for cem 12;
                      # an RGB channel with SHARED endpoints for cem 8,
                      # the ASTC dual-plane rule)


def _ncomp(m: UastcMode) -> int:
    """Endpoint components per subset for a mode's CEM."""
    return {4: 2, 8: 3, 12: 4}[m.cem]


MODE_SOLID = 8
#: Mode table (this profile's numbering follows UASTC's semantics: modes
#: 0-7 RGB, 8 solid, 9-14 RGBA, 15-17 LA, 18 extra RGB — with multi-
#: subset modes using the REAL ASTC partition-pattern function
#: (astc_partition_4x4, Khronos spec hash52) for texel->subset mapping).
MODES: Dict[int, UastcMode] = {
    0: UastcMode(cem=8, ep_bits=8, weight_levels=16),
    1: UastcMode(cem=8, ep_bits=8, weight_levels=2),
    2: UastcMode(cem=8, ep_bits=8, weight_levels=3),
    3: UastcMode(cem=8, ep_bits=5, weight_levels=4, subsets=2),
    4: UastcMode(cem=8, ep_bits=4, weight_levels=3, subsets=3),
    5: UastcMode(cem=8, ep_bits=8, weight_levels=8),
    6: UastcMode(cem=8, ep_bits=7, weight_levels=4, dual_plane=True,
                 plane2=2),  # RGB dual-plane, shared endpoints (ASTC rule)
    7: UastcMode(cem=8, ep_bits=6, weight_levels=3, subsets=2),
    9: UastcMode(cem=12, ep_bits=4, weight_levels=3, subsets=2),
    10: UastcMode(cem=12, ep_bits=8, weight_levels=8),
    11: UastcMode(cem=12, ep_bits=5, weight_levels=4, dual_plane=True),
    12: UastcMode(cem=12, ep_bits=8, weight_levels=5),
    13: UastcMode(cem=12, ep_bits=8, weight_levels=2, dual_plane=True),
    14: UastcMode(cem=12, ep_bits=6, weight_levels=4),
    15: UastcMode(cem=4, ep_bits=8, weight_levels=8),
    16: UastcMode(cem=4, ep_bits=8, weight_levels=4, subsets=2),
    17: UastcMode(cem=12, ep_bits=6, weight_levels=4, dual_plane=True),
    18: UastcMode(cem=8, ep_bits=8, weight_levels=5),
}

#: candidate partition seeds tried by the encoder (the wire field is the
#: full 10-bit ASTC seed, so any conformant seed decodes)
PARTITION_SEEDS = tuple(range(0, 1024, 32))


def _hash52(p: np.ndarray) -> np.ndarray:
    """Khronos ASTC spec hash52 (all arithmetic mod 2^32)."""
    p = p.astype(np.uint64) & 0xFFFFFFFF
    M = np.uint64(0xFFFFFFFF)
    p ^= p >> np.uint64(15); p &= M
    p = (p - ((p << np.uint64(17)) & M)) & M
    p = (p + ((p << np.uint64(7)) & M)) & M
    p = (p + ((p << np.uint64(4)) & M)) & M
    p ^= p >> np.uint64(5); p &= M
    p = (p + ((p << np.uint64(16)) & M)) & M
    p ^= p >> np.uint64(7)
    p ^= p >> np.uint64(3)
    p ^= (p << np.uint64(6)) & M; p &= M
    p ^= p >> np.uint64(17); p &= M
    return p


def astc_partition_4x4(seed, partition_count: int) -> np.ndarray:
    """ASTC spec `select_partition` for a 4x4 block (small-block path:
    coordinates doubled). seed: scalar or [S] array of 10-bit seeds.
    Returns [S, 16] (or [16]) texel->subset indices, texel order y*4+x.
    """
    scalar = np.isscalar(seed)
    seeds = np.atleast_1d(np.asarray(seed, np.int64))  # [S]
    j = np.arange(16)
    x = (j % 4) << 1  # small block: x,y doubled
    y = (j // 4) << 1
    rnum = _hash52(seeds + (partition_count - 1) * 1024)[:, None]  # [S,1]
    sv = [None] * 13
    shifts = [0, 4, 8, 12, 16, 20, 24, 28, 18, 22, 26]
    for i, sh in enumerate(shifts, start=1):
        sv[i] = ((rnum >> np.uint64(sh)) & np.uint64(0xF)).astype(np.int64)
    sv[12] = (
        ((rnum >> np.uint64(30)) | (rnum << np.uint64(2))) & np.uint64(0xF)
    ).astype(np.int64)
    for i in range(1, 13):
        sv[i] = sv[i] * sv[i]
    s = seeds[:, None]
    # spec: sh1/sh2 swap roles by seed parity; the parity-independent one
    # is 6 for 3 partitions, else 5
    sh_pc = 6 if partition_count == 3 else 5
    sh1 = np.where(s & 1, np.where(s & 2, 4, 5), sh_pc)
    sh2 = np.where(s & 1, sh_pc, np.where(s & 2, 4, 5))
    sh3 = np.where(s & 0x10, sh1, sh2)
    sv[1] >>= sh1; sv[2] >>= sh2; sv[3] >>= sh1; sv[4] >>= sh2
    sv[5] >>= sh1; sv[6] >>= sh2; sv[7] >>= sh1; sv[8] >>= sh2
    sv[9] >>= sh3; sv[10] >>= sh3; sv[11] >>= sh3; sv[12] >>= sh3
    rn = rnum.astype(np.int64)
    a = (sv[1] * x + sv[2] * y + (rn >> 14)) & 0x3F
    b = (sv[3] * x + sv[4] * y + (rn >> 10)) & 0x3F
    c = (sv[5] * x + sv[6] * y + (rn >> 6)) & 0x3F
    d = (sv[7] * x + sv[8] * y + (rn >> 2)) & 0x3F
    if partition_count <= 3:
        d = np.zeros_like(d)
    if partition_count <= 2:
        c = np.zeros_like(c)
    out = np.where(
        (a >= b) & (a >= c) & (a >= d),
        0,
        np.where((b >= c) & (b >= d), 1, np.where(c >= d, 2, 3)),
    ).astype(np.int32)
    return out[0] if scalar else out

#: weight dequantization to 0..64 (exact rational rounding — see docstring)
WEIGHT_TABLES: Dict[int, np.ndarray] = {
    L: np.round(np.arange(L) * 64.0 / (L - 1)).astype(np.int64)
    for L in (2, 3, 4, 5, 8, 16)
}


def _expand_endpoint(v: np.ndarray, bits: int) -> np.ndarray:
    """Bit-replicate an n-bit endpoint component to 8 bits (ASTC LDR)."""
    if bits == 8:
        return v.astype(np.int64)
    v = v.astype(np.int64)
    return (v << (8 - bits)) | (v >> (2 * bits - 8))


# ---------------------------------------------------------------------------
# Bit packing helpers ([B, 128] little-endian bit planes)
# ---------------------------------------------------------------------------


def _bits_of(blocks: np.ndarray) -> np.ndarray:
    """[B,16] uint8 -> [B,128] bits, LSB-first within each byte."""
    return np.unpackbits(blocks, axis=1, bitorder="little")


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=1, bitorder="little")


def _put_field(bits: np.ndarray, pos: int, width: int, values: np.ndarray):
    """Write an integer field at a fixed bit offset for every block."""
    v = values.astype(np.int64)
    for k in range(width):
        bits[:, pos + k] = (v >> k) & 1


def _get_field(bits: np.ndarray, pos: int, width: int) -> np.ndarray:
    v = np.zeros(len(bits), np.int64)
    for k in range(width):
        v |= bits[:, pos + k].astype(np.int64) << k
    return v


def _put_bise(bits: np.ndarray, pos: int, values: np.ndarray, base: int) -> int:
    """Pack [B, N] values in {trits, quints, plain bits}; returns end pos."""
    B, N = values.shape
    if base in (3, 5):
        group, enc_full, enc_part, cum = (
            (5, _TRIT_ENC, _TRIT_ENC_PARTIAL, _TRIT_CUM_BITS)
            if base == 3
            else (3, _QUINT_ENC, _QUINT_ENC_PARTIAL, _QUINT_CUM_BITS)
        )
        p = pos
        for g0 in range(0, N, group):
            n = min(group, N - g0)
            idx = np.zeros(B, np.int64)
            for k in range(n - 1, -1, -1):
                idx = idx * base + values[:, g0 + k]
            code = (enc_full if n == group else enc_part[n - 1])[idx]
            if (code < 0).any():
                raise ValueError("unencodable BISE group")
            nbits = cum[n - 1]
            _put_field(bits, p, nbits, code)
            p += nbits
        return p
    b = int(base).bit_length() - 1
    for i in range(N):
        _put_field(bits, pos + i * b, b, values[:, i])
    return pos + N * b


def _get_bise(bits: np.ndarray, pos: int, n_values: int, base: int):
    """Unpack [B, n_values]; returns (values, end_pos)."""
    B = len(bits)
    out = np.zeros((B, n_values), np.int64)
    if base in (3, 5):
        group, dec, cum = (
            (5, _TRIT_DEC, _TRIT_CUM_BITS)
            if base == 3
            else (3, _QUINT_DEC, _QUINT_CUM_BITS)
        )
        p = pos
        for g0 in range(0, n_values, group):
            n = min(group, n_values - g0)
            nbits = cum[n - 1]
            code = _get_field(bits, p, nbits)
            p += nbits
            vals = dec[code]  # [B, group]
            out[:, g0 : g0 + n] = vals[:, :n]
        return out, p
    b = int(base).bit_length() - 1
    for i in range(n_values):
        out[:, i] = _get_field(bits, pos + i * b, b)
    return out, pos + n_values * b


# ---------------------------------------------------------------------------
# Block encode
# ---------------------------------------------------------------------------


def _fit_endpoints_weights(
    px: np.ndarray, levels: int,
    endpoints: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    table: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """px: [B,16,C] float. Min/max-diagonal fit: endpoints e0/e1 [B,C] and
    per-texel weight level indices [B,16]. Pass `endpoints` to project
    onto a FIXED pair (shared-endpoint dual-plane modes); `table`
    overrides WEIGHT_TABLES[levels] (the spec wire's ASTC weight
    unquantization differs from the uniform tables at 4/5 bits)."""
    if endpoints is not None:
        e0, e1 = endpoints
    else:
        e0 = px.min(axis=1)
        e1 = px.max(axis=1)
    d = e1 - e0  # [B,C]
    denom = (d * d).sum(-1)  # [B]
    t = np.where(
        denom[:, None] > 0,
        ((px - e0[:, None, :]) * d[:, None, :]).sum(-1)
        / np.maximum(denom[:, None], 1e-9),
        0.5,
    )  # [B,16] in [0,1]
    tbl = (WEIGHT_TABLES[levels] if table is None else table).astype(
        np.float64
    )  # 0..64
    w64 = np.clip(t, 0.0, 1.0) * 64.0
    idx = np.abs(w64[..., None] - tbl[None, None, :]).argmin(-1)
    return e0, e1, idx


def _interp(e0_8: np.ndarray, e1_8: np.ndarray, w: np.ndarray) -> np.ndarray:
    """ASTC LDR interpolation: 8-bit endpoints -> 16-bit -> weight blend.
    e*_8: [...,C] ints; w: [...] 0..64 (broadcast over C)."""
    c0 = (e0_8 << 8) | e0_8
    c1 = (e1_8 << 8) | e1_8
    c = (c0 * (64 - w[..., None]) + c1 * w[..., None] + 32) >> 6
    return c >> 8


def _pack_mode_blocks(
    mode_id: int,
    q0: np.ndarray,
    q1: np.ndarray,
    wmain: np.ndarray,
    walpha: Optional[np.ndarray],
    seed: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Bit-pack pre-quantized fields into [B,16] uint8 blocks.

    Single-subset modes take q0/q1 [B, C]; multi-subset modes take
    [B, subsets, C] plus the per-block 10-bit partition `seed`."""
    m = MODES[mode_id]
    B = len(q0)
    nc = _ncomp(m)
    bits = np.zeros((B, 128), np.uint8)
    _put_field(bits, 0, 5, np.full(B, mode_id))
    pos = 5
    if m.dual_plane:
        _put_field(bits, pos, 2, np.full(B, m.plane2))
        pos += 2
    if m.subsets > 1:
        _put_field(bits, pos, 10, seed)
        pos += 10
        for p in range(m.subsets):
            for c in range(nc):
                _put_field(bits, pos, m.ep_bits, q0[:, p, c])
                pos += m.ep_bits
                _put_field(bits, pos, m.ep_bits, q1[:, p, c])
                pos += m.ep_bits
    else:
        for c in range(nc):
            _put_field(bits, pos, m.ep_bits, q0[:, c])
            pos += m.ep_bits
            _put_field(bits, pos, m.ep_bits, q1[:, c])
            pos += m.ep_bits
    pos = _put_bise(bits, pos, wmain, m.weight_levels)
    if m.dual_plane:
        pos = _put_bise(bits, pos, walpha, m.weight_levels)
    assert pos <= 128, (mode_id, pos)
    return _pack_bits(bits)


def _mode_pixels(px_f: np.ndarray, m: UastcMode) -> np.ndarray:
    """Per-mode fit target: RGBA/RGB slices, or [gray, alpha] for LA."""
    if m.cem == 4:
        gray = px_f[..., :3].mean(-1, keepdims=True)
        return np.concatenate([gray, px_f[..., 3:4]], -1)
    return px_f[..., : _ncomp(m)]


def _fit_subsets(pxf: np.ndarray, part: np.ndarray, levels: int, subsets: int,
                 table: Optional[np.ndarray] = None):
    """Per-subset diagonal fit. pxf [B,16,C], part [B,16] subset index →
    (e0 [B,P,C], e1 [B,P,C], widx [B,16]). `table` overrides
    WEIGHT_TABLES[levels] (see _fit_endpoints_weights)."""
    big = 1e30
    e0s, e1s = [], []
    for p in range(subsets):
        msk = (part == p)[..., None]
        e0s.append(np.where(msk, pxf, big).min(1))
        e1s.append(np.where(msk, pxf, -big).max(1))
    e0 = np.stack(e0s, 1)
    e1 = np.stack(e1s, 1)
    empty = e0 > big / 2  # subset with no texels
    e0 = np.where(empty, 0.0, e0)
    e1 = np.where(empty, 0.0, e1)
    bidx = np.arange(len(pxf))[:, None]
    e0_t = e0[bidx, part]  # [B,16,C]
    d_t = (e1 - e0)[bidx, part]
    denom = (d_t * d_t).sum(-1)
    t = np.where(
        denom > 0,
        ((pxf - e0_t) * d_t).sum(-1) / np.maximum(denom, 1e-9),
        0.5,
    )
    tbl = (WEIGHT_TABLES[levels] if table is None else table).astype(
        np.float64
    )
    w64 = np.clip(t, 0.0, 1.0) * 64.0
    widx = np.abs(w64[..., None] - tbl[None, None, :]).argmin(-1)
    return e0, e1, widx


def _best_partition_seed(pxf: np.ndarray, m: UastcMode) -> np.ndarray:
    """Pick the candidate ASTC seed minimizing the unquantized fit error
    per block (the encoder's seed search; the wire carries the full
    10-bit seed so decode accepts any seed)."""
    parts = astc_partition_4x4(np.asarray(PARTITION_SEEDS), m.subsets)  # [S,16]
    table = WEIGHT_TABLES[m.weight_levels].astype(np.float64)
    best_err = np.full(len(pxf), np.inf)
    best_seed = np.zeros(len(pxf), np.int64)
    for si, seed in enumerate(PARTITION_SEEDS):
        part = np.broadcast_to(parts[si], pxf.shape[:2])
        e0, e1, widx = _fit_subsets(pxf, part, m.weight_levels, m.subsets)
        bidx = np.arange(len(pxf))[:, None]
        rec = e0[bidx, part] + (table[widx] / 64.0)[..., None] * (e1 - e0)[
            bidx, part
        ]
        err = ((rec - pxf) ** 2).sum((1, 2))
        take = err < best_err
        best_err[take] = err[take]
        best_seed[take] = seed
    return best_seed


def _fit_mode(px: np.ndarray, mode_id: int):
    """Host fit+quantize for one mode: (q0, q1, wmain, walpha, seed)."""
    m = MODES[mode_id]
    pxf = _mode_pixels(px.astype(np.float64), m)
    seed = None
    if m.subsets > 1:
        seed = _best_partition_seed(pxf, m)
        part = astc_partition_4x4(seed, m.subsets)  # [B, 16]
        e0, e1, wmain = _fit_subsets(pxf, part, m.weight_levels, m.subsets)
        walpha = None
    elif m.dual_plane and m.cem == 12:
        # main plane fits RGB; second plane carries alpha (selector = 3)
        e0m, e1m, wmain = _fit_endpoints_weights(pxf[..., :3], m.weight_levels)
        e0a, e1a, walpha = _fit_endpoints_weights(
            pxf[..., 3:4], m.weight_levels
        )
        e0 = np.concatenate([e0m, e0a], -1)
        e1 = np.concatenate([e1m, e1a], -1)
    elif m.dual_plane:
        # cem 8 RGB dual-plane: ONE shared endpoint pair (ASTC rule) —
        # plane 1 weights drive the non-selected channels, plane 2 the
        # selected channel against the SAME endpoints
        sel = m.plane2
        rest = [c for c in range(3) if c != sel]
        e0, e1, _ = _fit_endpoints_weights(pxf, m.weight_levels)
        _, _, wmain = _fit_endpoints_weights(
            pxf[..., rest], m.weight_levels, endpoints=(e0[:, rest],
                                                        e1[:, rest])
        )
        _, _, walpha = _fit_endpoints_weights(
            pxf[..., sel:sel + 1], m.weight_levels,
            endpoints=(e0[:, sel:sel + 1], e1[:, sel:sel + 1]),
        )
    else:
        e0, e1, wmain = _fit_endpoints_weights(pxf, m.weight_levels)
        walpha = None
    scale = (1 << m.ep_bits) - 1
    q0 = np.clip(np.round(e0 * scale / 255.0), 0, scale).astype(np.int64)
    q1 = np.clip(np.round(e1 * scale / 255.0), 0, scale).astype(np.int64)
    return q0, q1, wmain, walpha, seed


def _encode_mode_blocks(
    px: np.ndarray, mode_id: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode all blocks with one mode. px: [B,16,4] int. Returns
    ([B,16] uint8 blocks, [B] float MSE)."""
    m = MODES[mode_id]
    blocks = _pack_mode_blocks(mode_id, *_fit_mode(px, mode_id))
    # measure error through the real decode path (always full RGBA)
    dec = _decode_mode_payload(_bits_of(blocks), mode_id)
    ref = px.astype(np.float64)
    mse = ((dec.astype(np.float64) - ref) ** 2).mean((1, 2))
    return blocks, mse


# ---------------------------------------------------------------------------
# Device (XLA) encode path — the fit, quantization and exact integer
# reconstruction error for every candidate mode run as ONE jitted program
# over the whole block batch (min/max/matvec reductions);
# the host only packs the winning mode's bits. SURVEY §7 step 6's "block
# encoders as device kernels" applied to the UASTC profile.
# ---------------------------------------------------------------------------

_DEVICE_FIT_CACHE: Dict[Tuple[int, ...], object] = {}


def _device_fit_fn(mode_ids: Tuple[int, ...]):
    import jax
    import jax.numpy as jnp

    fn = _DEVICE_FIT_CACHE.get(mode_ids)
    if fn is not None:
        return fn

    def fit_plane(pxf, table_f):
        e0 = pxf.min(1)
        e1 = pxf.max(1)
        d = e1 - e0
        denom = (d * d).sum(-1)
        t = jnp.where(
            denom[:, None] > 0,
            ((pxf - e0[:, None, :]) * d[:, None, :]).sum(-1)
            / jnp.maximum(denom[:, None], 1e-9),
            0.5,
        )
        w64 = jnp.clip(t, 0.0, 1.0) * 64.0
        widx = jnp.argmin(
            jnp.abs(w64[..., None] - table_f[None, None, :]), -1
        ).astype(jnp.int32)
        return e0, e1, widx

    def expand(q, bits):
        if bits == 8:
            return q
        return (q << (8 - bits)) | (q >> (2 * bits - 8))

    def run(px_u8):  # [B,16,4] uint8
        px_i = px_u8.astype(jnp.int32)
        outs = []
        for mode_id in mode_ids:
            m = MODES[mode_id]
            nc = 4 if m.cem == 12 else 3
            table = jnp.asarray(WEIGHT_TABLES[m.weight_levels], jnp.int32)
            table_f = table.astype(jnp.float32)
            pxf = px_i[..., :nc].astype(jnp.float32)
            if m.dual_plane:
                e0m, e1m, wmain = fit_plane(pxf[..., :3], table_f)
                e0a, e1a, walpha = fit_plane(pxf[..., 3:4], table_f)
                e0 = jnp.concatenate([e0m, e0a], -1)
                e1 = jnp.concatenate([e1m, e1a], -1)
            else:
                e0, e1, wmain = fit_plane(pxf, table_f)
                walpha = jnp.zeros_like(wmain)
            scale = (1 << m.ep_bits) - 1
            q0 = jnp.clip(jnp.round(e0 * (scale / 255.0)), 0, scale).astype(
                jnp.int32
            )
            q1 = jnp.clip(jnp.round(e1 * (scale / 255.0)), 0, scale).astype(
                jnp.int32
            )
            # exact integer reconstruction (same math as the decoder)
            e0_8 = expand(q0, m.ep_bits)
            e1_8 = expand(q1, m.ep_bits)
            c0 = (e0_8 << 8) | e0_8
            c1 = (e1_8 << 8) | e1_8
            w = table[wmain]
            rec = (
                (c0[:, None, :] * (64 - w[..., None])
                 + c1[:, None, :] * w[..., None] + 32) >> 6
            ) >> 8
            if m.dual_plane:
                wa = table[walpha]
                rec_a = (
                    (c0[:, None, 3:] * (64 - wa[..., None])
                     + c1[:, None, 3:] * wa[..., None] + 32) >> 6
                ) >> 8
                rec = jnp.concatenate([rec[..., :3], rec_a], -1)
            diff = (rec - px_i[..., :nc]).astype(jnp.float32)
            err = (diff * diff).mean((1, 2))
            if nc == 3:
                a = px_i[..., 3].astype(jnp.float32)
                err = err + ((255.0 - a) ** 2).mean(1)
            outs.append((q0, q1, wmain, walpha, err))
        return outs

    fn = jax.jit(run)
    _DEVICE_FIT_CACHE[mode_ids] = fn
    return fn


def encode_uastc_blocks(
    px: np.ndarray,
    modes: Optional[List[int]] = None,
    *,
    device: object = "auto",
) -> np.ndarray:
    """px: [B, 4, 4, 4] uint8 RGBA -> [B, 16] uint8 UASTC blocks.

    Tries `modes` (default: solid + the auto set for the content) per
    block and keeps the lowest-MSE encoding, like basisu's quality levels
    trade candidate modes for speed. `device`: True runs the candidate
    fits + error model as one jitted XLA program over the batch ("auto":
    when jax is importable and the batch is large); the wire bytes are
    produced by the same host packer either way.

    Determinism caveat (round-1 advisor): the device fit is float32 and
    its round/argmin ties can pick different (equally valid) winning
    modes than the float64 host fit, so "auto" output bytes can differ
    by batch size / backend. Pass device=False where byte-stable wire
    output matters (encode_uastc_ktx2 does)."""
    B = len(px)
    px16 = px.reshape(B, 16, 4).astype(np.int64)
    has_alpha = (px16[..., 3] != 255).any()
    if modes is None:
        modes = [10, 12] if has_alpha else [0, 5]
    # the jitted fit covers single-subset RGB/RGBA modes; multi-subset,
    # LA and shared-endpoint (cem-8 dual-plane) candidates route through
    # the host fit (partition seed search is host-side)
    device_ok = all(
        MODES[mid].subsets == 1 and MODES[mid].cem != 4
        and not (MODES[mid].dual_plane and MODES[mid].cem != 12)
        for mid in modes
    )
    use_device = device_ok and (
        device is True or (device == "auto" and B >= 16384)
    )
    out = np.zeros((B, 16), np.uint8)

    if use_device:
        try:
            fits = _device_fit_fn(tuple(modes))(
                np.ascontiguousarray(px.reshape(B, 16, 4), np.uint8)
            )
            errs = np.stack([np.asarray(f[4]) for f in fits])  # [M, B]
            winner = errs.argmin(0)
            for mi, mode_id in enumerate(modes):
                sel = winner == mi
                if not sel.any():
                    continue
                q0, q1, wmain, walpha, _ = (np.asarray(x) for x in fits[mi])
                m = MODES[mode_id]
                out[sel] = _pack_mode_blocks(
                    mode_id,
                    q0[sel].astype(np.int64),
                    q1[sel].astype(np.int64),
                    wmain[sel].astype(np.int64),
                    walpha[sel].astype(np.int64) if m.dual_plane else None,
                )
        except Exception as e:  # pragma: no cover - environment-specific
            import warnings

            warnings.warn(
                f"UASTC device encode failed ({type(e).__name__}: {e}); "
                "falling back to the host encoder",
                RuntimeWarning,
            )
            use_device = False

    if not use_device:
        best = np.full(B, np.inf)
        for mode_id in modes:
            blocks, mse = _encode_mode_blocks(px16, mode_id)
            take = mse < best
            out[take] = blocks[take]
            best[take] = mse[take]

    # solid blocks: exact and smallest — always preferred when lossless
    uniform = (px16 == px16[:, :1]).all((1, 2))
    if uniform.any():
        sb = np.zeros((uniform.sum(), 128), np.uint8)
        _put_field(sb, 0, 5, np.full(int(uniform.sum()), MODE_SOLID))
        for c in range(4):
            _put_field(sb, 5 + 8 * c, 8, px16[uniform, 0, c])
        out[uniform] = _pack_bits(sb)
    return out


# ---------------------------------------------------------------------------
# Block decode
# ---------------------------------------------------------------------------


def _decode_mode_payload(bits: np.ndarray, mode_id: int) -> np.ndarray:
    """bits: [B,128] of blocks KNOWN to be `mode_id` -> [B,16,4] uint8."""
    m = MODES[mode_id]
    B = len(bits)
    pos = 5
    if m.dual_plane:
        comp = _get_field(bits, pos, 2)
        pos += 2
    nc = _ncomp(m)
    if m.subsets > 1:
        seed = _get_field(bits, pos, 10)
        pos += 10
        q0 = np.zeros((B, m.subsets, nc), np.int64)
        q1 = np.zeros((B, m.subsets, nc), np.int64)
        for p in range(m.subsets):
            for c in range(nc):
                q0[:, p, c] = _get_field(bits, pos, m.ep_bits)
                pos += m.ep_bits
                q1[:, p, c] = _get_field(bits, pos, m.ep_bits)
                pos += m.ep_bits
        widx, pos = _get_bise(bits, pos, 16, m.weight_levels)
        w64 = WEIGHT_TABLES[m.weight_levels][widx]  # [B,16]
        part = astc_partition_4x4(seed, m.subsets)  # [B,16]
        bidx = np.arange(B)[:, None]
        e0 = _expand_endpoint(q0, m.ep_bits)[bidx, part]  # [B,16,nc]
        e1 = _expand_endpoint(q1, m.ep_bits)[bidx, part]
        vals = _interp(e0, e1, w64)
        out = np.full((B, 16, 4), 255, np.int64)
        if m.cem == 4:  # LA: L replicated to RGB, A separate
            out[..., :3] = vals[..., 0:1]
            out[..., 3] = vals[..., 1]
        else:
            out[..., :nc] = vals
        return out.astype(np.uint8)
    q0 = np.zeros((B, nc), np.int64)
    q1 = np.zeros((B, nc), np.int64)
    for c in range(nc):
        q0[:, c] = _get_field(bits, pos, m.ep_bits)
        pos += m.ep_bits
        q1[:, c] = _get_field(bits, pos, m.ep_bits)
        pos += m.ep_bits
    e0 = _expand_endpoint(q0, m.ep_bits)
    e1 = _expand_endpoint(q1, m.ep_bits)
    widx, pos = _get_bise(bits, pos, 16, m.weight_levels)
    w64 = WEIGHT_TABLES[m.weight_levels][widx]  # [B,16]
    out = np.full((B, 16, 4), 255, np.int64)
    if m.dual_plane:
        widx2, pos = _get_bise(bits, pos, 16, m.weight_levels)
        w64b = WEIGHT_TABLES[m.weight_levels][widx2]
        rgb = _interp(e0[:, None, :3], e1[:, None, :3], w64)
        out[..., :3] = rgb
        if nc == 4:
            # cem 12: the 4th endpoint pair feeds plane 2 (alpha in
            # everything our encoder emits; honor the field anyway)
            second = _interp(e0[:, None, 3:], e1[:, None, 3:], w64b)[..., 0]
        else:
            # cem 8: SHARED endpoints (ASTC dual-plane rule) — plane 2
            # re-interpolates the selected channel's own endpoint pair
            bi = np.arange(B)
            comp_c = np.clip(comp, 0, nc - 1)
            second = _interp(
                e0[bi, comp_c][:, None, None],
                e1[bi, comp_c][:, None, None],
                w64b,
            )[..., 0]
        for c in range(4):
            sel = comp == c
            if not sel.any():
                continue
            if c == 3:
                out[sel, :, 3] = second[sel]
            else:
                out[sel, :, c] = second[sel]
    else:
        vals = _interp(e0[:, None, :], e1[:, None, :], w64)
        if m.cem == 4:  # LA: L replicated to RGB, A separate
            out[..., :3] = vals[..., 0:1]
            out[..., 3] = vals[..., 1]
        else:
            out[..., :nc] = vals
    return out.astype(np.uint8)


def decode_uastc_blocks(blocks: np.ndarray) -> np.ndarray:
    """[B,16] uint8 UASTC blocks -> [B,4,4,4] uint8 RGBA."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    bits = _bits_of(blocks)
    mode = _get_field(bits, 0, 5)
    out = np.zeros((len(blocks), 16, 4), np.uint8)
    done = np.zeros(len(blocks), bool)
    solid = mode == MODE_SOLID
    if solid.any():
        for c in range(4):
            out[solid, :, c] = _get_field(bits[solid], 5 + 8 * c, 8)[:, None]
        done |= solid
    for mode_id in MODES:
        sel = mode == mode_id
        if not sel.any():
            continue
        out[sel] = _decode_mode_payload(bits[sel], mode_id)
        done |= sel
    if not done.all():
        bad = sorted(set(mode[~done].tolist()))
        raise NotImplementedError(f"UASTC modes {bad} not implemented")
    return out.reshape(len(blocks), 4, 4, 4)


# ---------------------------------------------------------------------------
# Image / KTX2 integration
# ---------------------------------------------------------------------------


def image_to_blocks_rgba(img: np.ndarray) -> np.ndarray:
    """[H,W,4] -> [ceil(H/4)*ceil(W/4), 4, 4, 4].

    Non-multiple-of-4 dimensions are edge-replicated into the partial
    border blocks (the KTX2/UASTC convention: ceil(dim/4) blocks per row,
    decoders crop back to [H, W])."""
    h, w, _ = img.shape
    hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
    if (hp, wp) != (h, w):
        img = np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    return (
        img.reshape(hp // 4, 4, wp // 4, 4, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(-1, 4, 4, 4)
    )


def blocks_to_image_rgba(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of image_to_blocks_rgba: ceil(dim/4) block rows/cols,
    cropped back to the true [h, w] (round-1 advisor: floor mis-sliced
    non-multiple-of-4 textures)."""
    nby, nbx = -(-h // 4), -(-w // 4)
    return (
        blocks.reshape(nby, nbx, 4, 4, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nby * 4, nbx * 4, 4)[:h, :w]
    )


#: candidate-mode sets per quality level (basisu's quality knob trades
#: candidate modes for speed the same way): level 0 = the fast pair,
#: 1 adds dual-plane slots, 2 adds multi-subset partitions. Only modes
#: that can IMPROVE the fit belong here — selection is pure MSE, so
#: low-rate modes (coarser weights, narrower endpoints) can never win;
#: they exist for decode coverage and explicit `modes=` requests.
UASTC_QUALITY_MODES = {
    0: ([0, 5], [10, 12]),
    1: ([0, 5, 6], [10, 12, 11, 17]),
    2: ([0, 5, 6, 3, 7], [10, 12, 11, 17, 9]),
}


def encode_uastc_ktx2(
    images: np.ndarray,
    *,
    zstd: bool = True,
    zstd_level: int = 6,
    device: object = False,
    quality: int = 0,
    wire: str = "spec",
) -> bytes:
    """[layers, H, W, 3|4] uint8 -> UASTC .ktx2 bytes (array texture),
    Zstd-supercompressed by default like `basisu -uastc -ktx2`.

    `wire="spec"` (default) emits the spec-structured UASTC layout
    (codecs/basis/uastc_spec.py: variable-length mode codes, ASTC
    endpoint ranges + BISE, plain ASTC-range weights) with NO profile
    marker; "legacy" emits the round-2/3 ``UVTUASTCProfile`` layout with
    its marker (kept for old consumers; transcode_uastc reads both).
    `quality` (0-2) widens the candidate-mode set per block
    (UASTC_QUALITY_MODES / SPEC_QUALITY_MODES), like basisu's quality
    levels.
    `device=False` (default) pins the float64 host fit so wire bytes are
    deterministic across environments; pass True/"auto" for the jitted
    device fit (legacy wire only), whose f32 round/argmin ties can pick
    different (equally valid) winning modes (round-1 advisor note)."""
    from uvol_tpu.containers.ktx2 import (
        KHR_DF_MODEL_UASTC,
        KTX2Header,
        KTX2Level,
        SUPERCOMPRESSION_NONE,
        SUPERCOMPRESSION_ZSTD,
        VK_FORMAT_UNDEFINED,
        make_basis_dfd,
        write_ktx2,
    )
    from uvol_tpu.native import zstd as zstdlib

    if images.ndim == 3:
        images = images[None]
    L, H, W = images.shape[:3]
    if images.shape[-1] == 3:
        images = np.concatenate(
            [images, np.full(images.shape[:-1] + (1,), 255, np.uint8)], -1
        )
    if wire not in ("spec", "legacy"):
        raise ValueError(f"unknown UASTC wire {wire!r}")
    if wire == "spec":
        from uvol_tpu.codecs.basis.uastc_spec import (
            SPEC_QUALITY_MODES,
            encode_spec_blocks,
        )

        rgb_set, rgba_set = SPEC_QUALITY_MODES[min(max(int(quality), 0), 2)]
    else:
        rgb_set, rgba_set = UASTC_QUALITY_MODES[min(max(int(quality), 0), 2)]

    def _encode_layer(i: int) -> bytes:
        blocks_px = image_to_blocks_rgba(images[i])
        modes = None  # quality 0 = the encoder's own default pair
        if quality > 0:
            has_a = (blocks_px[..., 3] != 255).any()
            modes = list(rgba_set if has_a else rgb_set)
        if wire == "spec":
            return encode_spec_blocks(blocks_px, modes=modes).tobytes()
        return encode_uastc_blocks(
            blocks_px, modes=modes, device=device
        ).tobytes()

    payload = b"".join(_encode_layer(i) for i in range(L))
    uncompressed = len(payload)
    scheme = SUPERCOMPRESSION_NONE
    if zstd and zstdlib.is_available():
        payload = zstdlib.compress(payload, zstd_level)
        scheme = SUPERCOMPRESSION_ZSTD
    header = KTX2Header(
        vk_format=VK_FORMAT_UNDEFINED,
        type_size=1,
        pixel_width=W,
        pixel_height=H,
        pixel_depth=0,
        layer_count=L if L > 1 else 0,
        face_count=1,
        level_count=1,
        supercompression_scheme=scheme,
    )
    # machine-detectable marker on LEGACY files only: that wire is this
    # module's documented profile, not spec UASTC (round-1 advisor).
    # Spec-wire files intentionally carry no marker — they claim the
    # standard layout (uastc_spec.py documents the reconstruction risk).
    kv = (
        {UASTC_PROFILE_KEY: UASTC_PROFILE_VALUE + b"\x00"}
        if wire == "legacy"
        else None
    )
    return write_ktx2(
        header,
        [KTX2Level(data=payload, uncompressed_byte_length=uncompressed)],
        dfd=make_basis_dfd(color_model=KHR_DF_MODEL_UASTC, has_alpha=True),
        key_value=kv,
    )


def transcode_uastc(ktx2_file, target: str = "rgba") -> np.ndarray:
    """UASTC KTX2 -> frames.

    target="rgba": [layers, H, W, 4] uint8 full decode.
    target="astc": [layers, nblocks, 16] uint8 REAL ASTC-LDR 4x4 blocks
    (codecs/basis/astc.py transcode — the KTX2Loader `astc-4x4` device
    target, /root/reference/src/lib/KTX2Loader.js:591-697; wire validated
    against Mesa's independent ASTC decoder).
    target="bc7": [layers, nblocks, 16] uint8 REAL BC7/BPTC blocks
    (codecs/basis/bc7.py — the KTX2Loader `bc7` desktop target; wire
    validated against Mesa's independent BPTC decoder).
    target="etc1" / "etc2-eac" / "bc1-bc3" / "pvrtc1": decode-and-refit
    (UASTC configurations have no structural mapping onto these formats,
    matching basisu's own transcoder): per-block ETC1 fit
    (etc.encode_etc1_blocks), + EAC alpha fit for etc2-eac
    ([layers, nblocks, 4] uint32), BC1 / BC4+BC1 words
    ([layers, nblocks, 2|4] uint32), Morton-order PVRTC1 words
    ([layers, nblocks, 2] uint32, power-of-two only)."""
    if target not in (
        "rgba", "astc", "bc7", "etc1", "etc2-eac", "bc1-bc3", "pvrtc1"
    ):
        raise NotImplementedError(f"UASTC transcode target {target!r}")
    # wire dispatch: files carrying the legacy UVTUASTCProfile marker
    # decode through this module's round-2/3 profile layout; marker-less
    # files (including foreign ones) go through the spec-structured
    # layout (codecs/basis/uastc_spec.py — reconstruction caveat there)
    marker = ktx2_file.key_value.get(UASTC_PROFILE_KEY)
    is_legacy = (
        marker is not None and marker.rstrip(b"\x00") == UASTC_PROFILE_VALUE
    )
    if is_legacy:
        decode_blocks_fn = decode_uastc_blocks
    else:
        from uvol_tpu.codecs.basis.uastc_spec import decode_spec_blocks

        # the spec layout has 3 documented reconstruction guesses
        # (uastc_spec.py docstring); our own files always carry the
        # standard KTXwriter key write_ktx2 stamps, so a spec-path file
        # WITHOUT it is genuinely foreign (real basisu output) and may
        # decode wrong without this hint (round-4 advisor, medium)
        writer = ktx2_file.key_value.get(b"KTXwriter", b"")
        foreign = not writer.rstrip(b"\x00").startswith(b"uvol_tpu")
        if foreign:
            import warnings

            warnings.warn(
                "marker-less UASTC file without a uvol_tpu KTXwriter key:"
                " decoding through the reconstructed spec layout"
                " (3 unverified layout cells — see codecs/basis/"
                "uastc_spec.py); foreign basisu files may decode"
                " incorrectly until fixtures verify the layout",
                RuntimeWarning,
                stacklevel=2,
            )

            def decode_blocks_fn(blocks, _inner=decode_spec_blocks):
                try:
                    return _inner(blocks)
                except Exception as e:
                    raise type(e)(
                        f"{e} (foreign UASTC file decoded through the"
                        " reconstructed spec layout — the mode-code"
                        " table is a documented guess; see"
                        " codecs/basis/uastc_spec.py)"
                    ) from e
        else:
            decode_blocks_fn = decode_spec_blocks
    h = ktx2_file.header.pixel_height
    w = ktx2_file.header.pixel_width
    layers = max(1, ktx2_file.header.layer_count)
    data = ktx2_file.level_payload(0)
    # ceil(dim/4) blocks per row/column (floor mis-sliced layers of
    # non-multiple-of-4 textures; blocks_to_image_rgba crops to [h, w])
    per = (-(-h // 4)) * (-(-w // 4)) * 16
    frames = []
    file_has_alpha = None
    if target in ("etc2-eac", "bc1-bc3", "pvrtc1"):
        # alpha layout must be uniform across layers (a per-layer
        # decision would produce ragged word shapes): any non-opaque
        # texel anywhere makes the whole file carry alpha blocks
        file_has_alpha = any(
            (
                decode_blocks_fn(
                    np.frombuffer(
                        data[i * per : (i + 1) * per], np.uint8
                    ).reshape(-1, 16)
                )[..., 3]
                != 255
            ).any()
            for i in range(layers)
        )
    for i in range(layers):
        blocks = np.frombuffer(
            data[i * per : (i + 1) * per], np.uint8
        ).reshape(-1, 16)
        if target == "astc":
            if is_legacy:
                from uvol_tpu.codecs.basis.astc import (
                    transcode_uastc_to_astc,
                )

                frames.append(transcode_uastc_to_astc(blocks))
            else:
                from uvol_tpu.codecs.basis.uastc_spec import spec_to_astc

                # verbatim field shuffle — value-exact for EVERY mode
                frames.append(spec_to_astc(blocks))
        elif target == "bc7":
            if is_legacy:
                from uvol_tpu.codecs.basis.bc7 import transcode_uastc_to_bc7

                frames.append(transcode_uastc_to_bc7(blocks))
            else:
                # spec wire: whole-block BC7 mode-6 refit on the decoded
                # texels (real BPTC wire; the structural per-mode carry
                # of the legacy path is not yet ported to spec parsing)
                from uvol_tpu.codecs.basis.bc7 import fit_mode6_blocks

                px = decode_blocks_fn(blocks).reshape(-1, 4, 4, 4)
                frames.append(fit_mode6_blocks(px))
        elif target in ("etc1", "etc2-eac", "bc1-bc3", "pvrtc1"):
            # decode-and-refit rows of the reference's format table
            import jax.numpy as jnp

            from uvol_tpu.codecs.basis import etc as _etc
            from uvol_tpu.codecs.basis.blockfit import (
                fit_bc1_blocks,
                fit_bc4_blocks,
                fit_eac_blocks,
                fit_pvrtc1_from_rgba,
            )

            px = decode_blocks_fn(blocks)  # [B,4,4,4]
            if target == "pvrtc1":
                if file_has_alpha:
                    # PVRTC1 punch-through alpha is not implemented;
                    # refusing beats silently flattening the channel
                    raise NotImplementedError(
                        "pvrtc1 target: file carries alpha"
                    )
                img = blocks_to_image_rgba(px, h, w)
                frames.append(fit_pvrtc1_from_rgba(img))
                continue
            a16 = px[..., 3].reshape(-1, 16)
            has_alpha = file_has_alpha
            if target == "bc1-bc3":
                color = fit_bc1_blocks(px[..., :3].reshape(-1, 16, 3))
                if has_alpha:
                    alpha = fit_bc4_blocks(a16)
                    frames.append(np.concatenate([alpha, color], axis=1))
                else:
                    frames.append(color)
                continue
            color = np.asarray(
                _etc.encode_etc1_blocks(jnp.asarray(px[..., :3]))
            )
            if target == "etc2-eac":
                alpha = (
                    fit_eac_blocks(a16)
                    if has_alpha
                    else np.broadcast_to(
                        np.array(
                            [0xFF1D9249, 0x24924924], np.uint32
                        )[None, :],
                        color.shape,
                    ).copy()
                )
                frames.append(np.concatenate([alpha, color], axis=1))
            else:
                frames.append(color)
        else:
            frames.append(
                blocks_to_image_rgba(decode_blocks_fn(blocks), h, w)
            )
    return np.stack(frames)
