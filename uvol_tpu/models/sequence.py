"""Frame-sequence codec models — the batched device compute path.

Replaces the reference encoder's per-frame subprocess loop
(scripts/Encoder.py:256-298: one draco_encoder/basisu process per frame)
with whole-sequence batched array programs:

  - GeometrySequenceCodec: [F, N, 3/2] attribute batches → quantize →
    predict → zigzag on device (single jit), rANS entropy per frame on
    host (serialization is not math); decode reverses with a `vmap`ed scan.
  - TextureSequenceCodec: [F, H, W, 3] frames → ETC1/ETC2 blocks on device,
    KTX2 container with `sequenceSize` frames as layers (the reference's
    KTX2_BATCH_SIZE batching, scripts/Encoder.py:279-298).

Both shard the frame axis over a `jax.sharding.Mesh` (data parallelism;
SURVEY.md §2.4) — the whole sequence is one XLA program per stage
instead of F processes.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from uvol_tpu.codecs.buffer import DecoderBuffer, EncoderBuffer
from uvol_tpu.codecs.symbol_coding import decode_symbols, encode_symbols
from uvol_tpu.containers.ktx2 import (
    SUPERCOMPRESSION_NONE,
    KTX2File,
    KTX2Header,
    KTX2Level,
    write_ktx2,
)
from uvol_tpu.ops.quantize import zigzag_decode
from uvol_tpu.codecs.basis.etc import (
    blocks_to_image,
    decode_etc1_blocks,
    encode_etc1_blocks,
    image_to_blocks,
    pack_etc1_payload,
    pack_words2,
    unpack_etc1_payload,
    unpack_words2,
)

#: magic for this framework's own geometry frame format ("UVTG")
UVTG_MAGIC = b"UVTG"
VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK = 147


@dataclasses.dataclass
class GeometryFrameSet:
    """Padded batch of frames plus per-frame validity counts."""

    positions: np.ndarray  # [F, N, 3] float32 (padded)
    uvs: Optional[np.ndarray]  # [F, N, 2]
    counts: np.ndarray  # [F] valid vertex count per frame
    faces: List[np.ndarray]  # per-frame [Mf, 3] int32


def _mesh_is_multiprocess(mesh) -> bool:
    from uvol_tpu.parallel.mesh import mesh_is_multiprocess

    return mesh_is_multiprocess(mesh)


class GeometrySequenceCodec:
    """Batched quantize+predict+entropy codec for mesh attribute sequences.

    The device encode is a planar-layout XLA chain ([F, C, N], vertices
    on the minor axis — see `_syms`).
    """

    def _dev_in(self, x):
        """Device-call input boundary. On a multi-process mesh the host
        value (identical on every process, the multi-host data contract)
        is passed as numpy so pjit shards it globally; single-process
        keeps the explicit transfer."""
        if x is None:
            return None
        if self._multiprocess:
            return np.asarray(x)
        return jax.device_put(np.ascontiguousarray(x)) if isinstance(
            x, np.ndarray
        ) else jnp.asarray(x)

    def _dev_out(self, tree):
        """Device-call output boundary: on a multi-process mesh, gather
        shards to fully-replicated arrays so `np.asarray` works on every
        process (each host then writes the same bytes)."""
        if self._multiprocess:
            from uvol_tpu.parallel.mesh import replicate_to_host

            tree = replicate_to_host(self.mesh, tree)
        return tree

    def __init__(
        self,
        position_bits: int = 11,
        uv_bits: int = 10,
        mesh: Optional["jax.sharding.Mesh"] = None,
    ):
        """`mesh`: a `jax.sharding.Mesh` with a `frames` axis — the device
        batch then runs as one `shard_map`ped SPMD program with each
        device owning a frame slice (the production form of SURVEY §2.4's
        frame-parallel mandate; byte-identical to single-device output,
        asserted by tests/test_multichip.py)."""
        self.position_bits = position_bits
        self.uv_bits = uv_bits
        self.mesh = mesh
        self._multiprocess = mesh is not None and _mesh_is_multiprocess(mesh)

        def _syms(xt, bits, mask):
            """Quantize+delta+zigzag in the planar [F, C, N] device
            layout (vertices on the minor axis). Identical symbols to the
            interleaved form (delta along N commutes with the layout;
            min/max reductions are order-independent)."""
            big = jnp.asarray(jnp.finfo(xt.dtype).max, xt.dtype)
            m = mask[:, None, :]
            mn = jnp.min(jnp.where(m, xt, big), axis=-1)  # [F, C]
            mx = jnp.max(jnp.where(m, xt, -big), axis=-1)
            rng = jnp.max(mx - mn, axis=-1)  # [F] Draco-style scalar range
            rng = jnp.where(rng <= 0, jnp.ones_like(rng), rng)
            inv = ((1 << bits) - 1) / rng
            xm = jnp.where(m, xt - mn[..., None], 0.0)
            q = jnp.floor(xm * inv[:, None, None] + 0.5).astype(jnp.int32)
            prev = jnp.pad(q[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
            d = q - prev
            syms = ((d >> 31) ^ (d << 1)).astype(jnp.uint32)
            return syms, mn, rng  # syms [F, C, N]

        def _encode_fn(pos, uv, mask):
            # planar contract: pos [F, 3, N], uv [F, 2, N], mask [F, N]
            pos_syms, pmin, prng = _syms(pos, position_bits, mask)
            out = {
                "pos_syms": pos_syms,
                "pos_min": pmin,
                "pos_range": prng,
            }
            if uv is not None:
                uv_syms, umin, urng = _syms(uv, uv_bits, mask)
                out.update(uv_syms=uv_syms, uv_min=umin, uv_range=urng)
            return out

        def _decode_fn(pos_syms, pos_min, pos_scale, uv_syms, uv_min, uv_scale):
            # per-frame scale = range / ((1<<bits_of_blob) - 1): the blob
            # header's quantization bits rule, NOT this codec instance's
            # defaults (mixed-bits batches dequantize correctly).
            # syms arrive planar [F, C, N]; outputs stay planar.
            qpos = jnp.cumsum(zigzag_decode(pos_syms), axis=-1, dtype=jnp.int32)
            pos = pos_min[..., None] + (
                qpos.astype(jnp.float32) * pos_scale[..., None, None]
            )
            quv = jnp.cumsum(zigzag_decode(uv_syms), axis=-1, dtype=jnp.int32)
            uv = uv_min[..., None] + (
                quv.astype(jnp.float32) * uv_scale[..., None, None]
            )
            return pos, uv

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from uvol_tpu.parallel.mesh import FRAME_AXIS

            spec = P(FRAME_AXIS)
            # every stage is per-frame math — pure dp, no collectives
            _encode_device = jax.jit(
                jax.shard_map(
                    _encode_fn, mesh=mesh,
                    in_specs=(spec, spec, spec), out_specs=spec,
                )
            )
            _decode_device = jax.jit(
                jax.shard_map(
                    _decode_fn, mesh=mesh,
                    in_specs=(spec,) * 6, out_specs=(spec, spec),
                )
            )
        else:
            _encode_device = jax.jit(_encode_fn)
            _decode_device = jax.jit(_decode_fn)

        self._encode_device = _encode_device
        self._decode_device = _decode_device

    def _pad_frames(self, *arrays):
        """Pad each array's frame axis to the mesh multiple via the shared
        parallel.mesh helper (ragged sequences; SURVEY §7 hard part (d))."""
        if self.mesh is None:
            return arrays, arrays[0].shape[0]
        from uvol_tpu.parallel.mesh import pad_frames_to_mesh

        padded = [pad_frames_to_mesh(a, self.mesh)[0] for a in arrays]
        return tuple(padded), arrays[0].shape[0]

    # -- encode --------------------------------------------------------------
    def encode(self, frames: GeometryFrameSet) -> List[bytes]:
        """Returns one `.uvtg` blob per frame (device batch + host entropy)."""
        f, n, _ = frames.positions.shape
        mask = np.arange(n)[None, :] < frames.counts[:, None]
        if frames.uvs is not None:
            (pos_in, uv_in, mask_in), _ = self._pad_frames(
                frames.positions, frames.uvs, mask
            )
        else:
            (pos_in, mask_in), _ = self._pad_frames(frames.positions, mask)
            uv_in = None
        # planar device contract: [F, C, N] (host transposes are cheap
        # strided copies; the device never sees a minor-dim-3 layout)
        dev = self._encode_device(
            self._dev_in(np.ascontiguousarray(pos_in.transpose(0, 2, 1))),
            self._dev_in(np.ascontiguousarray(uv_in.transpose(0, 2, 1)))
            if uv_in is not None
            else None,
            self._dev_in(mask_in),
        )
        # mesh-padded frames are dropped by the [:f] host loop below
        dev = jax.tree.map(np.asarray, self._dev_out(dev))

        def frame_blob(i: int) -> bytes:
            count = int(frames.counts[i])
            out = EncoderBuffer()
            out.raw(UVTG_MAGIC)
            out.u8(1)  # version
            out.u8(self.position_bits)
            out.u8(self.uv_bits if frames.uvs is not None else 0)
            out.varint(count)
            faces = frames.faces[i]
            out.varint(len(faces))
            for c in range(3):
                out.f32(float(dev["pos_min"][i, c]))
            out.f32(float(dev["pos_range"][i]))
            encode_symbols(
                np.ascontiguousarray(dev["pos_syms"][i][:, :count].T).reshape(-1),
                3,
                out,
            )
            if frames.uvs is not None:
                for c in range(2):
                    out.f32(float(dev["uv_min"][i, c]))
                out.f32(float(dev["uv_range"][i]))
                encode_symbols(
                    np.ascontiguousarray(
                        dev["uv_syms"][i][:, :count].T
                    ).reshape(-1),
                    2,
                    out,
                )
            # connectivity: delta+zigzag coded indices (host; Edgebreaker is
            # the C++-native upgrade path, SURVEY.md §7 step 4)
            flat = faces.reshape(-1).astype(np.int64)
            deltas = np.diff(flat, prepend=0)
            syms = np.where(deltas >= 0, deltas * 2, -deltas * 2 - 1).astype(np.uint32)
            encode_symbols(syms, 1, out)
            return out.getvalue()

        # per-frame entropy fans out over host threads (the native rANS
        # loops release the GIL) — the whole-sequence analog of the
        # reference's per-frame subprocess loop
        if f > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(8, f)) as pool:
                return list(pool.map(frame_blob, range(f)))
        return [frame_blob(i) for i in range(f)]

    def encode_bucketed(
        self,
        positions,
        uvs,
        faces,
        *,
        max_waste: float = 0.25,
    ) -> List[bytes]:
        """Ragged-sequence encode: per-frame arrays of differing vertex
        counts are bucketed (`parallel.mesh.bucket_frames_by_count`) so
        each device batch pads to its own max vertex count instead of the
        sequence max — SURVEY §7 hard part (d). Bucket lengths honor the
        codec's mesh so the frame axis still shards evenly.

        positions: sequence of [Ni, 3]; uvs: sequence of [Ni, 2] or None;
        faces: sequence of [Mi, 3]. Returns blobs in input order — each
        frame's quantization is per-frame, so output bytes are identical
        to any other batching of the same frames.
        """
        from uvol_tpu.parallel.mesh import FRAME_AXIS, bucket_frames_by_count

        counts = np.array([len(p) for p in positions], np.int64)
        mesh_size = (
            int(self.mesh.shape[FRAME_AXIS]) if self.mesh is not None else 1
        )
        out: List[Optional[bytes]] = [None] * len(counts)
        for idx in bucket_frames_by_count(counts, mesh_size, max_waste):
            nmax = int(counts[idx].max())
            pos = np.zeros((len(idx), nmax, 3), np.float32)
            uv = (
                np.zeros((len(idx), nmax, 2), np.float32)
                if uvs is not None
                else None
            )
            for j, i in enumerate(idx):
                pos[j, : counts[i]] = positions[i]
                if uv is not None:
                    uv[j, : counts[i]] = uvs[i]
            fs = GeometryFrameSet(
                pos, uv, counts[idx],
                [np.asarray(faces[i], np.int32) for i in idx],
            )
            for j, blob in enumerate(self.encode(fs)):
                out[int(idx[j])] = blob
        return out  # type: ignore[return-value]

    # -- decode --------------------------------------------------------------
    def decode(
        self, blobs: Sequence[bytes], *, as_numpy: bool = True
    ) -> GeometryFrameSet:
        """`as_numpy=False` leaves decoded attributes on device — the
        natural output when the consumer (renderer/model) is also on
        device; host readback is a separate explicit step."""
        f = len(blobs)
        counts = np.zeros(f, np.int64)

        def frame_parse(blob: bytes):
            buf = DecoderBuffer(blob)
            if buf.raw(4) != UVTG_MAGIC:
                raise ValueError("not a UVTG frame")
            _ver = buf.u8()
            pbits = buf.u8()
            ubits = buf.u8()
            count = buf.varint()
            nfaces = buf.varint()
            pmin = [buf.f32() for _ in range(3)]
            prange = buf.f32()
            ps = decode_symbols(count * 3, 3, buf).reshape(count, 3)
            meta = dict(pmin=pmin, prange=prange, pbits=pbits, ubits=ubits)
            us = None
            if ubits:
                umin = [buf.f32() for _ in range(2)]
                urange = buf.f32()
                us = decode_symbols(count * 2, 2, buf).reshape(count, 2)
                meta.update(umin=umin, urange=urange)
            idx_syms = decode_symbols(nfaces * 3, 1, buf)
            signed = np.where(idx_syms % 2 == 0, idx_syms // 2, -((idx_syms + 1) // 2))
            flat = np.cumsum(signed)
            return count, ps, us, meta, flat.reshape(nfaces, 3).astype(np.int32)

        if f > 1:  # host entropy decode fans out over threads (GIL-free C++)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(8, f)) as pool:
                parsed = list(pool.map(frame_parse, blobs))
        else:
            parsed = [frame_parse(b) for b in blobs]
        pos_syms, uv_syms, metas, faces_list = [], [], [], []
        max_n = 0
        for i, (count, ps, us, meta, faces_i) in enumerate(parsed):
            counts[i] = count
            max_n = max(max_n, count)
            pos_syms.append(ps)
            uv_syms.append(us)
            metas.append(meta)
            faces_list.append(faces_i)

        # planar [F, C, N] upload (see _decode_fn's device contract)
        pos_batch = np.zeros((f, 3, max_n), np.uint32)
        uv_batch = np.zeros((f, 2, max_n), np.uint32)
        pmin = np.zeros((f, 3), np.float32)
        pscale = np.zeros(f, np.float32)
        umin = np.zeros((f, 2), np.float32)
        uscale = np.zeros(f, np.float32)
        any_uv = False
        for i in range(f):
            c = int(counts[i])
            pos_batch[i, :, :c] = pos_syms[i].T
            pmin[i] = metas[i]["pmin"]
            pscale[i] = metas[i]["prange"] / ((1 << metas[i]["pbits"]) - 1)
            if uv_syms[i] is not None:
                any_uv = True
                uv_batch[i, :, :c] = uv_syms[i].T
                umin[i] = metas[i]["umin"]
                uscale[i] = metas[i]["urange"] / ((1 << metas[i]["ubits"]) - 1)
        (pos_batch, pmin, pscale, uv_batch, umin, uscale), _ = self._pad_frames(
            pos_batch, pmin, pscale, uv_batch, umin, uscale
        )
        pos, uv = self._decode_device(
            self._dev_in(pos_batch), self._dev_in(pmin), self._dev_in(pscale),
            self._dev_in(uv_batch), self._dev_in(umin), self._dev_in(uscale),
        )
        # multi-process: gather regardless of as_numpy — the [:f] slice
        # below is an eager op that jax rejects on non-fully-addressable
        # arrays, and the replicated result stays device-resident anyway
        pos, uv = self._dev_out((pos, uv))
        pos, uv = pos[:f], uv[:f]  # drop mesh padding
        if not any_uv:
            uv = None  # UV-less streams: honor the Optional contract
        if as_numpy:
            # host boundary converts back to per-vertex [F, N, C] rows
            pos = np.ascontiguousarray(np.asarray(pos).transpose(0, 2, 1))
            uv = (
                np.ascontiguousarray(np.asarray(uv).transpose(0, 2, 1))
                if uv is not None
                else None
            )
        else:
            # device-resident output stays planar [F, C, N]
            jax.block_until_ready(pos if uv is None else (pos, uv))
        return GeometryFrameSet(
            positions=pos,
            uvs=uv,
            counts=counts,
            faces=faces_list,
        )


class TextureSequenceCodec:
    """ETC1S-free device texture path: ETC1/ETC2 block encode + KTX2
    batching.

    `supercompression="zstd"` wraps each level in Zstandard (the raw-KTX2
    scheme the reference decodes at src/lib/KTX2Loader.js:799-823).
    """

    def __init__(
        self,
        sequence_size: int = 5,
        supercompression: str = "none",
        mesh: Optional["jax.sharding.Mesh"] = None,
    ):
        """`mesh`: shard the layer (frame) axis of each segment over the
        mesh's `frames` axis via shard_map — the KTX2_BATCH_SIZE layer
        batch is the natural dp unit (SURVEY §2.4). Byte-identical to the
        single-device encode."""
        self.sequence_size = sequence_size
        self.mesh = mesh
        self._multiprocess = mesh is not None and _mesh_is_multiprocess(mesh)
        if supercompression not in ("none", "zstd"):
            raise ValueError(
                f"unknown supercompression {supercompression!r} "
                "(supported: 'none', 'zstd')"
            )
        self.supercompression = supercompression
        # Device word layout is [2, L*nb] int32 (word planes, blocks
        # frame-major on the minor axis); `encode_segment`/`decode_segment`
        # convert at the host boundary (etc.pack_words2/unpack_words2).
        def _encode_fn(frames_u8):  # [L, H, W, 3] -> [2, L*nb] int32
            blocks = image_to_blocks(frames_u8)
            words = jax.vmap(encode_etc1_blocks)(blocks)  # [L, nb, 2]
            return jnp.transpose(
                jax.lax.bitcast_convert_type(words, jnp.int32), (2, 0, 1)
            ).reshape(2, -1)

        def _decode_fn(words2, h, w):  # [2, L*nb] -> [L, H, W, 3]
            nb = (h // 4) * (w // 4)
            l = words2.shape[1] // nb
            words = jax.lax.bitcast_convert_type(
                jnp.transpose(words2.reshape(2, l, nb), (1, 2, 0)),
                jnp.uint32,
            )
            blocks = jax.vmap(decode_etc1_blocks)(words)
            return jax.vmap(lambda b: blocks_to_image(b, h, w))(blocks)

        from functools import partial

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from uvol_tpu.parallel.mesh import FRAME_AXIS

            spec = P(FRAME_AXIS)
            # word planes are [2, L*nb] with blocks frame-major on the
            # minor axis, so sharding axis 1 IS frame parallelism
            wspec = P(None, FRAME_AXIS)
            _encode = jax.jit(
                jax.shard_map(
                    _encode_fn, mesh=mesh, in_specs=(spec,), out_specs=wspec
                )
            )

            @partial(jax.jit, static_argnums=(1, 2))
            def _decode(words2, h, w):
                return jax.shard_map(
                    lambda ws: _decode_fn(ws, h, w),
                    mesh=mesh, in_specs=(wspec,), out_specs=spec,
                )(words2)

        else:
            _encode = jax.jit(_encode_fn)
            _decode = partial(jax.jit, static_argnums=(1, 2))(_decode_fn)

        self._encode = _encode
        self._decode = _decode

    # shared multi-host host↔device boundary (same contract as geometry)
    _dev_in = GeometrySequenceCodec._dev_in
    _dev_out = GeometrySequenceCodec._dev_out

    def _pad_layers(self, arr: np.ndarray):
        """Pad the layer axis to the mesh multiple (shared helper)."""
        if self.mesh is None:
            return arr, arr.shape[0]
        from uvol_tpu.parallel.mesh import pad_frames_to_mesh

        return pad_frames_to_mesh(arr, self.mesh)

    def encode_segment(self, frames: np.ndarray) -> bytes:
        """[L, H, W, 3] uint8 → one `.ktx2` (layers = frames, ETC2 RGB)."""
        l, h, w, _ = frames.shape
        frames_in, _ = self._pad_layers(np.asarray(frames))
        words = pack_words2(
            self._dev_out(self._encode(self._dev_in(frames_in))),
            frames_in.shape[0],
        )[:l]
        payload = b"".join(pack_etc1_payload(words[i]) for i in range(l))
        raw_len = len(payload)
        scheme = SUPERCOMPRESSION_NONE
        if self.supercompression == "zstd":
            from uvol_tpu.containers.ktx2 import SUPERCOMPRESSION_ZSTD
            from uvol_tpu.native import zstd

            payload = zstd.compress(payload)
            scheme = SUPERCOMPRESSION_ZSTD
        header = KTX2Header(
            vk_format=VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK,
            type_size=1,
            pixel_width=w,
            pixel_height=h,
            pixel_depth=0,
            layer_count=l,
            face_count=1,
            level_count=1,
            supercompression_scheme=scheme,
        )
        return write_ktx2(header, [KTX2Level(payload, raw_len)])

    def decode_segment(self, ktx2: KTX2File, *, as_numpy: bool = True):
        """KTX2 (ETC2 RGB layers, optionally Zstd/zlib) → [L, H, W, 3].

        `as_numpy=False` keeps the decoded frames on device (the natural
        hand-off to a device-side consumer; see GeometrySequenceCodec)."""
        h = ktx2.header.pixel_height
        w = ktx2.header.pixel_width
        l = max(ktx2.header.layer_count, 1)
        per = (h // 4) * (w // 4) * 8
        data = ktx2.level_payload(0)
        words = np.stack(
            [unpack_etc1_payload(data[i * per : (i + 1) * per]) for i in range(l)]
        )
        words_in, _ = self._pad_layers(words)
        out = self._dev_out(self._decode(self._dev_in(unpack_words2(words_in)), h, w))
        if as_numpy:
            return np.asarray(out[:l])
        return jax.block_until_ready(out[:l])
