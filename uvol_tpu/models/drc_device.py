"""Device-side stages for REAL `.drc` decode: batched dequantize +
octahedral-normal reconstruction (round-1 verdict item 4).

Split of labor:

  - the wire stages (rANS entropy, Edgebreaker connectivity, prediction
    integration) are depth-N sequential recurrences — each value's
    parallelogram parents are typically the immediately preceding data
    ids, so there is no wide wavefront to map onto the device; a
    `lax.scan` formulation is latency-bound (~µs x 27k steps). These
    stages stay in C
    (native/draco_frame.cpp, GIL-free — they pool across cores on real
    hosts).
  - everything AFTER prediction is pure per-value math: quantized int →
    float dequantize and octahedral ints → unit normals. Those stages
    batch across frames as ONE jitted program here, outputs staying
    device-resident for the renderer/model (the north star's "decode
    back on device to identical vertex buffers").

`decode_drc_batch` = host portable decode (threaded, C) + device batch
conversion. Parity vs the all-host path is exact for integer stages by
construction and ≤1e-5 relative for the float stages (f32 device math vs
the C path's f64 accumulate; tests/test_drc_device.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from uvol_tpu.codecs.draco import constants as K


@dataclasses.dataclass
class DeviceFrameBatch:
    """Batched device tensors for N decoded `.drc` frames (padded)."""

    counts: Dict[int, np.ndarray]  # att_type -> [F] valid value counts
    values: Dict[int, Any]  # att_type -> [F, Nmax, C] device float32
    faces: List[np.ndarray]  # per-frame [M, 3] int32 (host)
    num_points: List[int]
    # 1-element output of the same fused executable as `values`: fetching
    # it (np.asarray) proves the whole dispatch completed with ONE tiny
    # fetch instead of one fetch per attribute.
    token: Any = None


def _dequant_fns():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def dequantize(ints, mins, scale):  # [F,N,C] i16/i32, [F,C], [F]
        return mins[:, None, :] + ints.astype(jnp.float32) * scale[:, None, None]

    @jax.jit
    def oct_to_unit(st, max_value):  # [F,N,2] i32, [F] f32
        u = st[..., 0].astype(jnp.float32) / max_value[:, None] * 2.0 - 1.0
        v = st[..., 1].astype(jnp.float32) / max_value[:, None] * 2.0 - 1.0
        z = 1.0 - jnp.abs(u) - jnp.abs(v)
        neg = z < 0
        su = jnp.where(u >= 0, 1.0, -1.0)
        sv = jnp.where(v >= 0, 1.0, -1.0)
        u2 = jnp.where(neg, (1.0 - jnp.abs(v)) * su, u)
        v2 = jnp.where(neg, (1.0 - jnp.abs(u)) * sv, v)
        nrm = jnp.sqrt(u2 * u2 + v2 * v2 + z * z)
        dn = jnp.maximum(nrm, 1e-30)
        out = jnp.stack([u2 / dn, v2 / dn, z / dn], axis=-1)
        return jnp.where(
            (nrm == 0)[..., None], jnp.asarray([0.0, 0.0, 1.0]), out
        )

    return dequantize, oct_to_unit


_FNS = None


def decode_drc_batch(
    blobs: Sequence[bytes],
    *,
    workers: int = 8,
    as_numpy: bool = False,
) -> DeviceFrameBatch:
    """Real `.drc` frames → device-resident float attribute batches.

    Host phase: portable native decode per frame (thread pool — the C
    loops release the GIL). Device phase: one jitted dequantize /
    oct→unit program per attribute type over the [F, Nmax, C] batch.
    """
    global _FNS
    import jax
    import jax.numpy as jnp

    from uvol_tpu import native

    def host_one(blob):
        res = native.drc_decode_native(blob, portable=True)
        if res is None:
            raise NotImplementedError(
                "stream outside the native fast path; use decode_drc"
            )
        return res

    if len(blobs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(workers, len(blobs))) as pool:
            frames = list(pool.map(host_one, blobs))
    else:
        frames = [host_one(b) for b in blobs]

    if _FNS is None:
        _FNS = _dequant_fns()
    return _build_batch(frames, as_numpy=as_numpy)


_FUSED_CACHE: Dict = {}

#: vertex-count bucket for the fused upload program's padded shapes —
#: every stream window whose nmax lands in the same bucket reuses one
#: compiled program (see the bucketing note in _build_batch). 4096 keeps
#: the whole liam corpus in 2-3 programs; the padding costs < 40 KB of
#: upload per window against one compile per extra shape.
_NMAX_BUCKET = 4096

# upload packing modes: bits -> bytes per GROUP of values. 11/10/8-bit
# quantized values ride at 1.5/1.25/1.0 bytes instead of int16's 2.0
# (~43% fewer upload bytes on the liam corpus).
_MODE_GROUP = {8: (1, 1), 10: (4, 5), 12: (2, 3), 16: (1, 2), 32: (1, 4)}


def _pick_mode(max_bits: int, has_neg: bool) -> int:
    if has_neg:
        return 16 if max_bits <= 15 else 32
    for m in (8, 10, 12):
        if max_bits <= m:
            return m
    # mode 16 is an int16 pack (the device bitcast sign-extends), so a
    # non-negative value needs to fit 15 bits; 16-bit declared streams
    # with values >= 2**15 must ride the int32 wire.
    return 16 if max_bits <= 15 else 32


def _pack_host(vals: np.ndarray, mode: int) -> np.ndarray:
    """Flat non-negative int array -> uint8 wire for the chosen mode."""
    if vals.dtype == np.int32:  # the batch-builder path: one C pass
        from uvol_tpu import native

        out = native.pack_bits_native(
            vals, mode, _packed_nbytes(len(vals), mode)
        )
        if out is not None:
            return out
    v = vals.astype(np.int64)
    if mode == 8:
        return v.astype(np.uint8)
    if mode == 16:
        return np.ascontiguousarray(v.astype(np.int16)).view(np.uint8)
    if mode == 32:
        return np.ascontiguousarray(v.astype(np.int32)).view(np.uint8)
    gv, gb = _MODE_GROUP[mode]
    pad = (-len(v)) % gv
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.int64)])
    g = v.reshape(-1, gv)
    out = np.empty((len(g), gb), np.uint8)
    if mode == 12:  # 2 values -> 3 bytes
        out[:, 0] = g[:, 0] & 0xFF
        out[:, 1] = ((g[:, 0] >> 8) & 0xF) | ((g[:, 1] & 0xF) << 4)
        out[:, 2] = (g[:, 1] >> 4) & 0xFF
    else:  # mode == 10: 4 values -> 5 bytes
        out[:, 0] = g[:, 0] & 0xFF
        out[:, 1] = ((g[:, 0] >> 8) & 0x3) | ((g[:, 1] & 0x3F) << 2)
        out[:, 2] = ((g[:, 1] >> 6) & 0xF) | ((g[:, 2] & 0xF) << 4)
        out[:, 3] = ((g[:, 2] >> 4) & 0x3F) | ((g[:, 3] & 0x3) << 6)
        out[:, 4] = (g[:, 3] >> 2) & 0xFF
    return out.reshape(-1)


def _packed_nbytes(n: int, mode: int) -> int:
    gv, gb = _MODE_GROUP[mode]
    return ((n + gv - 1) // gv) * gb


def _fused_batch_fn(key):
    """One jitted program converting the PACKED uint8 upload buffer into
    every attribute's device tensor: a single host->device transfer + a
    single dispatch per window instead of ~9 small per-attribute
    transfers (ints, mins, scales x 3 attribute types)."""
    import jax
    import jax.numpy as jnp

    # tuple of (att_type, kind, mode, f, nmax, nc, off, mlen, moff)
    # key[1] = (meta_off, meta_len): the float32 metadata rides the SAME
    # uint8 upload buffer (bitcast on device)
    specs = key[0]
    meta_off, meta_len = key[1]

    def unpack(by, mode, n):
        b = by.astype(jnp.int32)
        if mode == 8:
            return b[:n]
        if mode == 16:
            g = b.reshape(-1, 2)
            v = g[:, 0] | (g[:, 1] << 8)
            return (v - ((v & 0x8000) << 1))[:n]  # sign-extend
        if mode == 32:
            g = b.reshape(-1, 4)
            return (
                g[:, 0] | (g[:, 1] << 8) | (g[:, 2] << 16) | (g[:, 3] << 24)
            )[:n]
        if mode == 12:
            g = b.reshape(-1, 3)
            v0 = g[:, 0] | ((g[:, 1] & 0xF) << 8)
            v1 = (g[:, 1] >> 4) | (g[:, 2] << 4)
            return jnp.stack([v0, v1], -1).reshape(-1)[:n]
        g = b.reshape(-1, 5)  # mode == 10
        v0 = g[:, 0] | ((g[:, 1] & 0x3) << 8)
        v1 = (g[:, 1] >> 2) | ((g[:, 2] & 0xF) << 6)
        v2 = (g[:, 2] >> 4) | ((g[:, 3] & 0x3F) << 4)
        v3 = (g[:, 3] >> 6) | (g[:, 4] << 2)
        return jnp.stack([v0, v1, v2, v3], -1).reshape(-1)[:n]

    @jax.jit
    def run(packed):
        meta = jax.lax.bitcast_convert_type(
            packed[meta_off : meta_off + 4 * meta_len].reshape(-1, 4),
            jnp.float32,
        )
        outs = [packed[:1]]  # completion token (see DeviceFrameBatch)
        for _t, kind, mode, f, nmax, nc, off, _ml, moff in specs:
            n = f * nmax * nc
            by = packed[off : off + _packed_nbytes(n, mode)]
            ints = unpack(by, mode, n).reshape(f, nmax, nc)
            if kind == 1:
                mins = meta[moff : moff + f * nc].reshape(f, nc)
                scale = meta[moff + f * nc : moff + f * nc + f]
                outs.append(
                    mins[:, None, :]
                    + ints.astype(jnp.float32) * scale[:, None, None]
                )
            else:  # octahedral normals
                maxv = meta[moff : moff + f]
                u = ints[..., 0].astype(jnp.float32) / maxv[:, None] * 2.0 - 1.0
                v = ints[..., 1].astype(jnp.float32) / maxv[:, None] * 2.0 - 1.0
                z = 1.0 - jnp.abs(u) - jnp.abs(v)
                neg = z < 0
                su = jnp.where(u >= 0, 1.0, -1.0)
                sv = jnp.where(v >= 0, 1.0, -1.0)
                u2 = jnp.where(neg, (1.0 - jnp.abs(v)) * su, u)
                v2 = jnp.where(neg, (1.0 - jnp.abs(u)) * sv, v)
                nrm = jnp.sqrt(u2 * u2 + v2 * v2 + z * z)
                dn = jnp.maximum(nrm, 1e-30)
                out = jnp.stack([u2 / dn, v2 / dn, z / dn], axis=-1)
                outs.append(
                    jnp.where(
                        (nrm == 0)[..., None],
                        jnp.asarray([0.0, 0.0, 1.0]),
                        out,
                    )
                )
        return tuple(outs)

    return run


def _build_batch(
    frames, *, as_numpy: bool = False, sync: bool = True
) -> "DeviceFrameBatch":
    """Native-decoded frame tuples → padded device batches (shared by
    decode_drc_batch and the pipelined decode_drc_stream). All device
    attributes ride ONE packed upload + ONE fused dispatch.

    sync=False leaves the device dispatch in flight (the stream path
    pipelines windows; a per-window block_until_ready would serialize
    the whole pipeline on this transport)."""
    import jax
    import jax.numpy as jnp

    f = len(frames)
    by_type: Dict[int, List] = {}
    faces = []
    num_points = []
    for num_faces, npts, poc, attrs in frames:
        # asarray, not astype: poc is already int32 from the native
        # decoder — astype unconditionally copied ~630 KB per frame
        faces.append(np.asarray(poc, np.int32).reshape(-1, 3))
        num_points.append(int(npts))
        for a in attrs:
            by_type.setdefault(a[0], []).append(a)

    counts: Dict[int, np.ndarray] = {}
    values: Dict[int, Any] = {}
    specs = []  # (att_type, kind, mode, f, nmax, nc, off, mlen, moff)
    jobs = []  # (vals_list, mode, stride, off) parallel to specs
    metas: List[np.ndarray] = []
    off = moff = 0

    # shape bucketing: nmax rounds up to _NMAX_BUCKET and the packing
    # mode derives from the DECLARED quantization bits, not this
    # window's value range — otherwise every stream window with a new
    # vertex count (or a max value crossing a bit boundary) traces a
    # fresh fused program, and a compile on this remote backend costs
    # minutes, not the padded values' ~10 KB of upload
    def _bucket(n: int) -> int:
        return -(-max(n, 1) // _NMAX_BUCKET) * _NMAX_BUCKET

    for att_type, entries in sorted(by_type.items()):
        if len(entries) != f:
            raise ValueError(
                f"attribute type {att_type} appears in {len(entries)} of "
                f"{f} frames; decode_drc_batch needs a uniform attribute "
                "set — decode mixed sequences per-frame with decode_drc"
            )
        kind = entries[0][7][0]
        decl_bits = 0
        if kind == 1:  # quantized → dequantize on device
            nc = entries[0][5].shape[1]
            decl_bits = max(int(e[7][1]) for e in entries)
            mins = np.zeros((f, nc), np.float32)
            scale = np.zeros(f, np.float32)
            for i, e in enumerate(entries):
                _k, bits, _mq, rng, mn = e[7]
                mins[i] = mn[:nc]
                scale[i] = rng / ((1 << bits) - 1)
            meta = np.concatenate([mins.reshape(-1), scale]).astype(
                np.float32
            )
        elif kind == 2:  # octahedral normals
            nc = 2
            maxv = np.zeros(f, np.float32)
            for i, e in enumerate(entries):
                mq = e[7][2]
                q = 0
                while (1 << q) <= mq:
                    q += 1
                maxv[i] = float((1 << q) - 2)
                decl_bits = max(decl_bits, q)
            meta = maxv
        else:  # integer attrs: already final, keep host ints
            counts[att_type] = np.asarray(
                [len(e[5]) for e in entries], np.int64
            )
            values[att_type] = [e[5] for e in entries]
            continue
        vals_list = [np.ascontiguousarray(e[5], np.int32) for e in entries]
        nmax = _bucket(max(v.shape[0] for v in vals_list))
        cnt = np.asarray([v.shape[0] for v in vals_list], np.int64)
        # declared-bits mode (shape-stable across windows); fall back to
        # the data range only when values escape the declared range
        # (hostile or foreign streams — correctness over cache locality)
        mode = _pick_mode(max(decl_bits, 1), False)
        vmax = max(int(v.max(initial=0)) for v in vals_list)
        vmin = min(int(v.min(initial=0)) for v in vals_list)
        if vmin < 0 or vmax >= (1 << max(decl_bits, 1)):
            mode = _pick_mode(max(vmax, 1).bit_length(), vmin < 0)
            if vmin < -(2**15) or vmax >= 2**15:
                mode = 32
        counts[att_type] = cnt
        specs.append(
            (att_type, kind, mode, f, nmax, nc, off, len(meta), moff)
        )
        jobs.append((vals_list, mode, nmax * nc, off))
        metas.append(meta)
        off += _packed_nbytes(f * nmax * nc, mode)
        moff += len(meta)

    if specs:
        from uvol_tpu import native

        meta_all = np.concatenate(metas) if metas else np.zeros(1, np.float32)
        # metadata floats ride the tail of the packed buffer, 4-aligned
        pad = (-off) % 4
        packed = np.empty(off + pad + 4 * len(meta_all), np.uint8)
        for spec, (vals_list, mode, stride, j_off) in zip(specs, jobs):
            # fused C fill+pack straight into the window buffer (no
            # [F, nmax, nc] int32 intermediate to zero, copy and re-read
            # on the uploader thread)
            if not native.pack_frames_native(
                vals_list, mode, stride, packed, j_off
            ):
                # portable fallback: pad to the flat array and pack
                _t, _k, _m, _f, nmax, nc, *_r = spec
                ints = np.zeros((f, nmax, nc), np.int32)
                for i, v in enumerate(vals_list):
                    ints[i, : v.shape[0]] = v.reshape(v.shape[0], nc)
                chunk = _pack_host(ints.reshape(-1), mode)
                packed[j_off : j_off + len(chunk)] = chunk
        if pad:
            packed[off : off + pad] = 0
        packed[off + pad :] = np.ascontiguousarray(meta_all).view(np.uint8)
        key = (tuple(specs), (off + pad, len(meta_all)))
        fn = _FUSED_CACHE.get(key)
        if fn is None:
            fn = _fused_batch_fn(key)
            _FUSED_CACHE[key] = fn
        # device_put issues the transfer asynchronously, so the stream
        # path's next window keeps decoding on the host meanwhile
        tok, *outs = fn(jax.device_put(packed))
        for (att_type, *_rest), out in zip(specs, outs):
            values[att_type] = np.asarray(out) if as_numpy else out
        if sync and not as_numpy:
            np.asarray(tok)  # one tiny fetch == dispatch completed
    else:
        tok = None
    return DeviceFrameBatch(
        counts=counts,
        values=values,
        faces=faces,
        num_points=num_points,
        token=tok,
    )


def decode_drc_stream(
    blobs: Sequence[bytes],
    *,
    window: int = 8,
    workers: Optional[int] = None,
    as_numpy: bool = False,
    lookahead: int = 4,
):
    """Pipelined wire→device decode (VERDICT r2 item 3's streaming form).

    Three pipeline stages, no per-window sync point:

      1. per-frame C wire decode on `workers` threads (GIL-free native
         loops) with up to `lookahead` future windows in flight;
      2. a dedicated uploader thread packs each completed window and
         issues the single fused upload+dispatch (async under jit) —
         window k+1's wire decode keeps running while window k's bytes
         ride the transport;
      3. the generator yields (start_index, DeviceFrameBatch) in order
         WITHOUT blocking on device completion — consumers that need
         host values force the arrays (jax materializes them on read).

    Per-window results are byte-identical to decode_drc_batch on the
    same slice (tests/test_drc_device.py).
    """
    global _FNS
    from concurrent.futures import ThreadPoolExecutor

    from uvol_tpu import native

    if _FNS is None:
        _FNS = _dequant_fns()

    def host_one(blob):
        res = native.drc_decode_native(blob, portable=True)
        if res is None:
            raise NotImplementedError(
                "stream outside the native fast path; use decode_drc"
            )
        return res

    if workers is None:
        # one wire-decode thread per core, capped: extra threads on a
        # small host only add lock contention with the uploader
        import os as _os

        workers = max(1, min(8, _os.cpu_count() or 1))
    starts = list(range(0, len(blobs), window))
    with ThreadPoolExecutor(max(1, workers)) as pool, ThreadPoolExecutor(
        1
    ) as uploader:
        decode_futs: dict = {}
        batch_futs: dict = {}
        next_submit = 0

        def build(idx):
            frames = [fut.result() for fut in decode_futs.pop(idx)]
            return _build_batch(frames, as_numpy=as_numpy, sync=False)

        for i, start in enumerate(starts):
            while next_submit < len(starts) and next_submit <= i + lookahead:
                s = starts[next_submit]
                decode_futs[next_submit] = [
                    pool.submit(host_one, blob)
                    for blob in blobs[s : s + window]
                ]
                # the uploader runs windows strictly in order, so device
                # transfers stay serialized and ordered on the transport
                batch_futs[next_submit] = uploader.submit(build, next_submit)
                next_submit += 1
            yield start, batch_futs.pop(i).result()
