"""Bring-up smoke of the V2 encode -> play path on one GPU.

Drives the system's main path once through the entry points a user
calls, at the reference liam track's full shape (~26k vertices / ~52k
faces per frame, 1024² textures in 5-frame KTX2 segments, 1024/1024
ETC1S palettes), on a clip generated from a seed:

  env            card name and power limit, JAX versions, compile cache,
                 native libraries built and loaded
  synth          the clip: `--frames` OBJ + PNG frames (uvol_tpu.io.synth)
  encode         `python -m uvol_tpu.encoder_cli` (Draco geometry, ETC1S
                 and ETC1 textures); palette core and ETC1 encode on GPU
  play           the facade Player (V2) on a virtual clock: every frame
                 shown `ok`, geometry == decode_drc, texture == transcoder
  device_decode  decode_drc_stream on GPU vs the host decode_drc
  codecs         GeometrySequenceCodec / TextureSequenceCodec at F=32 on
                 GPU vs the same jitted functions on the CPU
  etc1s          the Triton endpoint-assign kernel vs the XLA formulation
                 at 5x1024², E=1024; encode_ktx2_etc1s GPU vs CPU PSNR
  kernels        hand-written kernel vs XLA's plain version, median of 5,
                 alone and inside the whole ETC1S palette build

Each phase prints one JSON line; a failed check exits non-zero before
the final line, which is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
It runs only on a GPU: with no accelerator it exits non-zero.

    python chip_smoke.py [--frames 30] [--seed 0]

On one H100 80GB HBM3 (power limit 700 W) a run with an empty compile
cache took 177 s; compiling the ETC1S palette program (about 30 s) is
the largest single cost.
"""

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")

#: the shapes the phases run at: the liam track's widths
PLATFORM = "gpu"
TEXTURE = 1024  # texture side
CODEC_FRAMES = 32  # frames per sequence-codec batch
ENDPOINTS = 1024  # ETC1S palette width of the assign check and timing
SMALL_TEXTURE = 256  # side and palette width of the GPU-vs-CPU encode
KMEANS_ITERS = 6  # encode_ktx2_etc1s's default


class SmokeFailure(RuntimeError):
    pass


def _emit(phase, t0, checks, **info):
    ok = all(checks.values())
    print(
        json.dumps(
            {"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
             "ok": ok, "checks": checks, **info}
        ),
        flush=True,
    )
    if not ok:
        bad = [k for k, v in checks.items() if not v]
        raise SmokeFailure(f"phase {phase}: failed checks {bad}")


def _median_time(fn, n=5):
    import jax

    jax.block_until_ready(fn())  # warm-up (compile)
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def _platforms(tree):
    import jax

    return {d.platform for x in jax.tree.leaves(tree) for d in x.devices()}


def _segment_blocks(seed):
    """[5 * nb, 16, 3] uint8 blocks of one 5-frame synthetic segment."""
    from uvol_tpu.io import synth

    t = TEXTURE
    tex = np.stack([synth.texture_frame(i, seed, t) for i in range(5)])
    return np.ascontiguousarray(
        tex.reshape(5, t // 4, 4, t // 4, 4, 3).transpose(0, 1, 3, 2, 4, 5)
        .reshape(-1, 16, 3)
    )


def phase_env():
    t0 = time.perf_counter()
    import jax
    import jaxlib

    from uvol_tpu import native
    from uvol_tpu.utils.compile_cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    cache = enable_compile_cache()
    checks = {
        f"native_{name}": getattr(native, name)() is not None
        for name in ("get_lib", "get_draco_lib", "get_corto_lib", "get_etc1s_lib")
    }
    checks["backend_gpu"] = jax.default_backend() == PLATFORM
    _emit(
        "env", t0, checks, card=smi, jax=jax.__version__,
        jaxlib=jaxlib.__version__, compile_cache=cache,
        devices=[str(d) for d in jax.devices()],
    )
    return smi


def phase_synth(frames, seed):
    t0 = time.perf_counter()
    from uvol_tpu.io import synth
    from uvol_tpu.io.png import read_png

    cfg = synth.write_clip(
        WORK, frames=frames, seed=seed, tex_size=TEXTURE,
        GEOMETRY_CODEC="draco", TEXTURE_CODEC="etc1s,etc", KTX2_BATCH_SIZE=5,
        ETC1S_ENDPOINTS=ENDPOINTS, ETC1S_SELECTORS=ENDPOINTS,
    )
    m = synth.mesh_frame(0, seed)
    img = read_png(os.path.join(WORK, "images", "00000.png")).astype(np.int32)
    dx = np.abs(np.diff(img, axis=1))
    checks = {
        "vertices_26145": m.positions.shape == (26145, 3),
        "faces_52290": m.faces.shape == (52290, 3),
        "texture_size": img.shape == (TEXTURE, TEXTURE, 3),
        "texture_not_flat": float(img.std()) > 10.0,
        "texture_smooth_not_noise": float(np.median(dx)) < 2.0,
        "texture_has_edges": int(dx.max()) > 50,
        "files": len(os.listdir(os.path.join(WORK, "OBJ"))) == frames
        and len(os.listdir(os.path.join(WORK, "images"))) == frames,
    }
    _emit("synth", t0, checks, frames=frames, seed=seed, config=cfg)
    return cfg


def phase_encode(cfg):
    t0 = time.perf_counter()
    import jax

    from uvol_tpu import encoder_cli
    from uvol_tpu.codecs.basis import etc1s_encode
    from uvol_tpu.models import sequence

    times = {"geometry_draco": [], "etc1s_segment": [], "etc_segment": []}
    platforms = {"palette_core": set(), "etc1_encode": set()}

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t)
            return out

        setattr(owner, name, wrapper)
        return fn

    class RecordingCache(dict):
        """Palette-core jit cache that records its outputs' devices."""

        def get(self, key, default=None):
            core = super().get(key, default)
            if core is None:
                return None

            def recorded(*a):
                out = core(*a)
                platforms["palette_core"] |= _platforms(out)
                return out

            return recorded

    def recorded_pack(words2, f):
        platforms["etc1_encode"] |= _platforms(words2)
        return real_pack(words2, f)

    saved = [
        (encoder_cli, "_encode_geometry_draco",
         timed(encoder_cli, "_encode_geometry_draco", "geometry_draco")),
        (etc1s_encode, "encode_ktx2_etc1s",
         timed(etc1s_encode, "encode_ktx2_etc1s", "etc1s_segment")),
        (sequence.TextureSequenceCodec, "encode_segment",
         timed(sequence.TextureSequenceCodec, "encode_segment", "etc_segment")),
        (etc1s_encode, "_PALETTE_JIT_CACHE", etc1s_encode._PALETTE_JIT_CACHE),
        (sequence, "pack_words2", sequence.pack_words2),
    ]
    real_pack = sequence.pack_words2
    etc1s_encode._PALETTE_JIT_CACHE = RecordingCache()
    sequence.pack_words2 = recorded_pack
    try:
        rc = encoder_cli.main([cfg])
        kernel_keys = [k[-1] for k in etc1s_encode._PALETTE_JIT_CACHE]
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)

    def split(ts):
        return {
            "cold_s": round(ts[0], 3) if ts else None,
            "warm_median_s": round(float(np.median(ts[1:])), 3)
            if len(ts) > 1 else None,
            "calls": len(ts),
        }

    out = os.path.join(WORK, "output")
    checks = {
        "exit_0": rc == 0,
        "manifest": os.path.exists(os.path.join(out, "synth.uvol.json")),
        "palette_core_on_gpu": platforms["palette_core"] == {PLATFORM},
        "palette_core_uses_kernel": bool(kernel_keys) and all(kernel_keys),
        "etc1_encode_on_gpu": platforms["etc1_encode"] == {PLATFORM},
    }
    _emit(
        "encode", t0, checks,
        stages={k: split(v) for k, v in times.items()},
        devices={k: sorted(v) for k, v in platforms.items()},
        jax_backend=jax.default_backend(),
    )
    return out


def phase_play(out, frames):
    t0 = time.perf_counter()
    from uvol_tpu.codecs.basis.transcoder import transcode_ktx2_etc1s
    from uvol_tpu.codecs.draco.decoder import decode_drc
    from uvol_tpu.containers.ktx2 import read_ktx2
    from uvol_tpu.interfaces import PlayMode
    from uvol_tpu.player.clock import PlaybackClock, VirtualClock
    from uvol_tpu.player.facade import Player

    vc = VirtualClock()
    ended = []
    p = Player(
        play_mode=PlayMode.single,
        paths=[os.path.join(out, "synth.uvol.json")],
        on_track_end=lambda: ended.append(True),
        v2_player_kwargs={"clock": PlaybackClock(now=vc)},
    )
    p.set_track_path()
    v2 = p.v2_instance
    statuses, geo_equal, tex_equal = [], [], []
    golden = {}
    t_play = time.perf_counter()
    for i in range(frames):
        vc.t = i / 30.0
        r = p.update()
        statuses.append((r.status, r.geometry_frame))
        if r.status != "ok":
            continue
        with open(v2.geometry_url(r.geometry_frame), "rb") as f:
            ref = decode_drc(f.read())
        geo_equal.append(
            np.array_equal(r.geometry.faces, ref.faces)
            and all(
                np.array_equal(a.values, b.values)
                for a, b in zip(r.geometry.attributes, ref.attributes)
            )
        )
        seg = r.texture_segment
        if seg not in golden:
            with open(v2.texture_url(seg), "rb") as f:
                golden[seg] = transcode_ktx2_etc1s(
                    read_ktx2(f.read()), target=r.texture.format
                )
        tex_equal.append(
            np.array_equal(
                np.asarray(r.texture.data[r.texture_layer]),
                golden[seg][r.texture_layer],
            )
        )
    wall = time.perf_counter() - t_play
    p.dispose()
    checks = {
        "every_frame_ok": statuses == [("ok", i) for i in range(frames)],
        "geometry_equals_decode_drc": len(geo_equal) == frames and all(geo_equal),
        "texture_equals_transcoder": len(tex_equal) == frames and all(tex_equal),
    }
    _emit(
        "play", t0, checks, fps=round(frames / wall, 3),
        texture_target=v2.texture_target, texture_format=r.texture.format
        if statuses and statuses[-1][0] == "ok" else None,
    )


def phase_device_decode(out, frames):
    t0 = time.perf_counter()
    from uvol_tpu.codecs.draco import constants as K
    from uvol_tpu.codecs.draco.decoder import decode_drc
    from uvol_tpu.models.drc_device import decode_drc_stream

    blobs = []
    for i in range(frames):
        with open(os.path.join(out, "geometry_draco", f"{i:05d}.drc"), "rb") as f:
            blobs.append(f.read())
    # tolerance of tests/test_drc_device.py: integer stages (faces, generic
    # attributes) exact; the f32 device dequantize and octahedral normals
    # against the C path's f64 within rtol = atol = 2e-5
    tol = 2e-5
    on_gpu, close, exact, seen = [], [], [], 0
    worst = 0.0
    for start, batch in decode_drc_stream(blobs, window=8):
        for att, vals in batch.values.items():
            if isinstance(vals, list):
                continue
            on_gpu.append(_platforms(vals) == {PLATFORM})
        for j, faces in enumerate(batch.faces):
            ref = decode_drc(blobs[start + j])
            exact.append(np.array_equal(faces, ref.faces.astype(np.int32)))
            for att in (K.ATT_POSITION, K.ATT_TEX_COORD, K.ATT_NORMAL):
                a = ref.attribute_by_type(att)
                if a is None:
                    continue
                n = int(batch.counts[att][j])
                got = np.asarray(batch.values[att][j, :n])
                close.append(
                    n == len(a.values)
                    and np.allclose(got, a.values, rtol=tol, atol=tol)
                )
                worst = max(worst, float(np.abs(got - a.values).max()))
            seen += 1
    checks = {
        "all_frames": seen == frames,
        "resident_on_gpu": bool(on_gpu) and all(on_gpu),
        "integer_stages_exact": bool(exact) and all(exact),
        "float_stages_within_tol": bool(close) and all(close),
    }
    _emit("device_decode", t0, checks, rtol=tol, atol=tol,
          max_abs_diff=worst)


def phase_codecs(seed):
    t0 = time.perf_counter()
    import jax

    from uvol_tpu.containers.ktx2 import read_ktx2
    from uvol_tpu.io import synth
    from uvol_tpu.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
    )

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    f_n = CODEC_FRAMES
    meshes = [synth.mesh_frame(i, seed) for i in range(f_n)]
    n = meshes[0].positions.shape[0]
    pos = np.stack([m.positions for m in meshes])
    uv = np.zeros((f_n, n, 2), np.float32)
    for i, m in enumerate(meshes):
        uv[i][m.faces.reshape(-1)] = m.uvs[m.uv_faces.reshape(-1)]
    frames = GeometryFrameSet(
        pos, uv, np.full(f_n, n, np.int64), [m.faces for m in meshes]
    )
    geo = GeometrySequenceCodec(position_bits=11, uv_bits=10)
    blobs = geo.encode(frames)
    dec = geo.decode(blobs)
    step = (pos.max(1) - pos.min(1)).max(1) / 2047.0
    recon = bool(
        np.all(np.abs(dec.positions - pos).max(axis=(1, 2)) <= step * 1.0001)
    )
    planar = (
        np.ascontiguousarray(pos.transpose(0, 2, 1)),
        np.ascontiguousarray(uv.transpose(0, 2, 1)),
        np.ones((f_n, n), bool),
    )
    enc = {
        name: jax.tree.map(
            np.asarray,
            geo._encode_device(*(jax.device_put(a, d) for a in planar)),
        )
        for name, d in (("gpu", gpu), ("cpu", cpu))
    }

    def q_of(syms):  # zigzag deltas -> quantized values
        s = syms.astype(np.int64)
        return np.cumsum((s >> 1) ^ -(s & 1), axis=-1)

    sym_diff, step_ok = 0, True
    for key in ("pos_syms", "uv_syms"):
        a, b = enc["gpu"][key], enc["cpu"][key]
        sym_diff += int(np.count_nonzero(a != b))
        step_ok &= int(np.abs(q_of(a) - q_of(b)).max()) <= 1
    q_diff = sum(
        int(np.count_nonzero(q_of(enc["gpu"][k]) != q_of(enc["cpu"][k])))
        for k in ("pos_syms", "uv_syms")
    )

    tex = np.stack(
        [synth.texture_frame(i, seed, TEXTURE) for i in range(f_n)]
    )
    texc = TextureSequenceCodec(sequence_size=f_n)
    words = {
        name: texc._encode(jax.device_put(tex, d))
        for name, d in (("gpu", gpu), ("cpu", cpu))
    }
    imgs = {
        p: np.asarray(texc._decode(w, TEXTURE, TEXTURE))
        for p, w in words.items()
    }
    words = {p: np.asarray(w) for p, w in words.items()}
    blob = texc.encode_segment(tex)
    seg = texc.decode_segment(read_ktx2(blob))
    checks = {
        "geometry_roundtrip_within_step": recon,
        "uvtg_symbols_within_one_step": step_ok,
        "etc1_words_bit_identical": np.array_equal(words["gpu"], words["cpu"]),
        "etc1_decode_bit_identical": np.array_equal(imgs["gpu"], imgs["cpu"]),
        "ktx2_segment_roundtrip": np.array_equal(seg, imgs["gpu"]),
    }
    _emit(
        "codecs", t0, checks, frames=f_n, vertices=n,
        uvtg_symbols_differing=sym_diff, uvtg_values_differing=q_diff,
    )


def phase_etc1s(seed):
    t0 = time.perf_counter()
    import jax
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis import etc1s_assign as A
    from uvol_tpu.codecs.basis.etc1s_encode import encode_ktx2_etc1s
    from uvol_tpu.codecs.basis.transcoder import (
        INTEN_TABLES,
        transcode_ktx2_etc1s,
    )
    from uvol_tpu.containers.ktx2 import read_ktx2
    from uvol_tpu.io import synth

    # (a) kernel vs XLA at a full liam segment: 5 x 1024², E = 1024
    r = np.random.default_rng(seed)
    blocks = _segment_blocks(seed)
    n, e = blocks.shape[0], ENDPOINTS
    dev = jax.device_put(blocks)
    picks = blocks[r.choice(n, e, replace=False)].mean(axis=1)
    b5 = np.round(picks * 31 / 255).astype(np.int32)
    basef = jnp.asarray((b5 << 3) | (b5 >> 2), jnp.float32)
    mods = jnp.asarray(np.asarray(INTEN_TABLES, np.float32)[r.integers(0, 8, e)])
    me, q = A.effective_modifiers(basef, mods)
    kernel = A.assign_endpoints_triton(
        A.pixel_planes(dev), A.endpoint_const_rows(basef, me, q), n=n
    )
    xla = jax.jit(A.assign_endpoints_xla)(dev.astype(jnp.float32), basef, me, q)
    assign_equal = bool(np.array_equal(np.asarray(kernel), np.asarray(xla)))
    assign_on_gpu = _platforms(kernel) == {PLATFORM}

    # (b) encode_ktx2_etc1s on GPU and CPU: 5 x 256², E = S = 256
    small = np.stack(
        [synth.texture_frame(i, seed, size=SMALL_TEXTURE) for i in range(5)]
    )

    def psnr(blob):
        rgb = transcode_ktx2_etc1s(read_ktx2(blob), "rgba")[..., :3]
        mse = np.mean((rgb.astype(np.float64) - small) ** 2)
        return float(10 * np.log10(255.0**2 / mse))

    kw = dict(num_endpoints=SMALL_TEXTURE, num_selectors=SMALL_TEXTURE)
    p_gpu = psnr(encode_ktx2_etc1s(small, **kw))
    with jax.default_device(jax.devices("cpu")[0]):
        p_cpu = psnr(encode_ktx2_etc1s(small, **kw))
    checks = {
        "assign_kernel_equals_xla": assign_equal,
        "assign_kernel_on_gpu": assign_on_gpu,
        "psnr_gpu_cpu_within_0.25dB": abs(p_gpu - p_cpu) <= 0.25,
    }
    _emit(
        "etc1s", t0, checks, blocks=n, endpoints=e,
        psnr_gpu_db=round(p_gpu, 3), psnr_cpu_db=round(p_cpu, 3),
    )


def phase_kernels(seed):
    t0 = time.perf_counter()
    import jax
    import jax.numpy as jnp

    from uvol_tpu.codecs.basis import etc1s_assign as A
    from uvol_tpu.codecs.basis.etc1s_encode import (
        _palette_core_fn,
        inten_block_errors,
    )
    from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES
    from uvol_tpu.io import synth
    from uvol_tpu.models.codebook import kmeans_update
    from uvol_tpu.models.sequence import TextureSequenceCodec

    r = np.random.default_rng(seed)
    blocks = jax.device_put(_segment_blocks(seed))
    n, e = blocks.shape[0], ENDPOINTS
    bf = blocks.astype(jnp.float32)
    basef = jnp.asarray(r.integers(0, 32, (e, 3)) * 8 + 4, jnp.float32)
    mods = jnp.asarray(np.asarray(INTEN_TABLES, np.float32)[r.integers(0, 8, e)])
    me, q = A.effective_modifiers(basef, mods)
    planes = A.pixel_planes(blocks)
    const = A.endpoint_const_rows(basef, me, q)
    xla_assign = jax.jit(A.assign_endpoints_xla)
    inten = jax.jit(inten_block_errors)
    lloyd = jax.jit(kmeans_update)
    ms = {
        "endpoint_assign_triton": _median_time(
            lambda: A.assign_endpoints_triton(planes, const, n=n)
        ),
        "endpoint_assign_xla": _median_time(
            lambda: xla_assign(bf, basef, me, q)
        ),
    }
    # the stages that run as plain XLA, at the same shapes
    base_b = bf[:, 0, :]
    feats = jnp.concatenate([jnp.mean(bf, 1), jnp.std(bf, (1, 2))[:, None]], 1)
    ms["inten_errors_xla"] = _median_time(lambda: inten(bf, base_b))
    ms["kmeans_step_xla"] = _median_time(lambda: lloyd(feats, feats[:e]))
    frames = jax.device_put(
        np.stack(
            [synth.texture_frame(i, seed, TEXTURE) for i in range(CODEC_FRAMES)]
        )
    )
    texc = TextureSequenceCodec(sequence_size=CODEC_FRAMES)
    words = texc._encode(frames)
    ms["etc1_encode_xla"] = _median_time(lambda: texc._encode(frames))
    ms["etc1_decode_xla"] = _median_time(
        lambda: texc._decode(words, TEXTURE, TEXTURE)
    )
    # end to end: the whole palette build of one segment, whose three
    # exact-assign calls run as the kernel or as XLA
    cores = {
        name: jax.jit(_palette_core_fn(e, e, KMEANS_ITERS, gpu_kernel=flag))
        for name, flag in (("triton", True), ("xla", False))
    }
    outs = {name: core(blocks) for name, core in cores.items()}
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(outs["triton"], outs["xla"])
    )
    for name, core in cores.items():
        ms[f"palette_core_{name}"] = _median_time(functools.partial(core, blocks))
    ms = {k: round(v * 1e3, 3) for k, v in ms.items()}
    checks = {
        "kernel_faster_than_xla":
            ms["endpoint_assign_triton"] < ms["endpoint_assign_xla"],
        "palette_core_paths_identical": same,
        "palette_core_faster_with_kernel":
            ms["palette_core_triton"] < ms["palette_core_xla"],
    }
    _emit("kernels", t0, checks, median_ms=ms, blocks=n, endpoints=e,
          codec_frames=CODEC_FRAMES)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    requested = os.environ.get("JAX_PLATFORMS", "")
    if requested and not {"cuda", "gpu"} & set(requested.split(",")):
        raise SmokeFailure(f"no GPU: JAX_PLATFORMS={requested!r} names none")

    import jax

    # the CPU stays available as the comparison device
    jax.config.update("jax_platforms", "cuda,cpu")
    if jax.default_backend() != PLATFORM:
        raise SmokeFailure(f"no GPU: JAX backend is {jax.default_backend()}")

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        smi = phase_env()
        cfg = phase_synth(args.frames, args.seed)
        out = phase_encode(cfg)
        phase_play(out, args.frames)
        phase_device_decode(out, args.frames)
        phase_codecs(args.seed)
        phase_etc1s(args.seed)
        phase_kernels(args.seed)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    d = jax.devices()[0]
    print(smi)
    print(json.dumps(
        {"ok": True,
         "device": {"platform": d.platform, "kind": d.device_kind,
                    "count": len(jax.devices())}}
    ))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
