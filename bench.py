"""uvol benchmark: end-to-end encode+decode of a volumetric stream.

Full pipeline per frame, not device math alone: liam-scale geometry (26k
verts) runs quantize→delta→zigzag on device, host rANS entropy (native
C++), and `.uvtg` container serialization to bytes; 1024² textures run
the ETC1 block encoder into real KTX2 containers; decode reverses every
stage back to tensors (entropy decode, un-delta, dequantize, ETC1 block
decode). The corpus metrics run only where the reference liam corpus is
present. Prints ONE JSON line; vs_baseline is the real-time multiple
against the reference's 30 fps bar (BASELINE.md), with stage detail
included. Its numbers are not claims until the benchmark is split into
cells.

  python bench.py
"""

import json
import os
import time

import numpy as np


def _bench_repeats() -> int:
    """Every host metric reports the MEDIAN of N repeats (host timings
    swing run to run). UVT_BENCH_REPEATS overrides N."""
    try:
        return max(1, int(os.environ.get("UVT_BENCH_REPEATS", "3")))
    except ValueError:
        return 3


def _median_fps(fn, units: float, n: int) -> float:
    """Median over n runs of units/elapsed(fn)."""
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        samples.append(units / (time.perf_counter() - t0))
    return float(np.median(samples))


def _liam_host_metrics():
    """Host-only corpus metrics (median of N runs each): 8-frame decode
    fps, 4-frame re-encode fps, 4-worker pool decode fps. Returns
    (fps, pool_fps, enc_fps, frames_bin, meshes) or Nones when the
    corpus is absent."""
    liam_dir = "/root/reference/example/public/liam/output/geometry_draco"
    if not os.path.isdir(liam_dir):
        return None, None, None, None, None
    from uvol_tpu.codecs.draco import constants as KD
    from uvol_tpu.codecs.draco.decoder import decode_drc
    from uvol_tpu.codecs.draco.encoder import AttributeToEncode, encode_drc
    from uvol_tpu.runtime.prefetch import PrefetchPool

    reps = _bench_repeats()
    frames_bin = [
        open(os.path.join(liam_dir, f"{i:05d}.drc"), "rb").read()
        for i in range(8)
    ]
    decode_drc(frames_bin[0])  # warm native build
    meshes = [decode_drc(b) for b in frames_bin]
    liam_fps = _median_fps(
        lambda: [decode_drc(b) for b in frames_bin], len(frames_bin), reps
    )

    def reenc(mm):
        atts = []
        for t, bits in ((KD.ATT_POSITION, 11), (KD.ATT_TEX_COORD, 10),
                        (KD.ATT_NORMAL, 8)):
            a = mm.attribute_by_type(t)
            if a is not None:
                atts.append(
                    AttributeToEncode(t, a.values, a.corner_to_value, bits)
                )
        g = mm.attribute_by_type(KD.ATT_GENERIC)
        if g is not None:
            atts.append(
                AttributeToEncode(
                    KD.ATT_GENERIC, g.values, g.corner_to_value, integer=True
                )
            )
        faces_idx = atts[0].corner_to_value.reshape(-1, 3)
        return encode_drc(faces_idx, atts)

    reenc(meshes[0])  # warm
    liam_enc_fps = _median_fps(
        lambda: [reenc(mm) for mm in meshes[:4]], 4, reps
    )

    def pooled():
        pool = PrefetchPool(decode_drc, workers=4)
        for i, b in enumerate(frames_bin * 3):
            pool.request(i, b)
        pool.wait_idle(60)
        pool.close()

    liam_fps_pool = _median_fps(pooled, 3 * len(frames_bin), reps)
    return liam_fps, liam_fps_pool, liam_enc_fps, frames_bin, meshes


def _v1_video_metrics():
    """V1 texture track (compressed H.264, gop P slices) on real liam
    textures: (encode_fps, decode_fps, bpp) or Nones."""
    liam = (
        "/root/reference/example/public/liam/output/"
        "texture_ktx2-fps30-1k_baseColor_default"
    )
    if not os.path.isdir(liam):
        return None, None, None
    from uvol_tpu.codecs.basis.transcoder import transcode_ktx2_etc1s
    from uvol_tpu.containers.ktx2 import read_ktx2
    from uvol_tpu.io.video import Mp4VideoTexture, encode_v1_texture_video

    with open(os.path.join(liam, "00000.ktx2"), "rb") as fh:
        frames = [
            np.ascontiguousarray(f[..., :3])
            for f in np.asarray(
                transcode_ktx2_etc1s(read_ktx2(fh.read()), "rgba")
            )
        ]
    encode_v1_texture_video(frames[:2], codec="h264", qp=28, gop=2)  # warm
    t0 = time.perf_counter()
    blob = encode_v1_texture_video(frames, codec="h264", qp=28,
                                   gop=len(frames))
    enc_fps = len(frames) / (time.perf_counter() - t0)
    tex = Mp4VideoTexture(blob)
    t0 = time.perf_counter()
    for i in range(len(frames)):
        tex.current_time = (i + 0.25) / 30.0
        if tex.read_baked_frame_number() != i:
            raise AssertionError("V1 counter readback broke")
    dec_fps = len(frames) / (time.perf_counter() - t0)
    h, w = frames[0].shape[:2]
    return enc_fps, dec_fps, len(blob) * 8 / (len(frames) * h * w)


def _v1_player_metrics(n_frames: int = 30):
    """FULL V1 player playback fps on real corpus data (VERDICT r4 item
    2): facade Player V1 branch — `.drcs` byte-range fetch → native Corto
    decode → MP4 H.264 motion-P decode → baked-counter readback → mesh
    sync — on a virtual clock. Asset build (corpus `.drc`→`.crt`→`.drcs`
    + ktx2→counter-baked H.264 MP4, the remaster_v1 pipeline) is cached
    in /tmp and excluded from the timed region; playback is media-of-N.
    Matches /root/reference/src/V1/player.ts:251-287 processFrame."""
    liam = "/root/reference/example/public/liam/output"
    if not os.path.isdir(liam):
        return None
    cache = f"/tmp/uvt_bench_v1_assets_v2_{n_frames}"
    man_path = os.path.join(cache, "liam_v1.manifest")
    if not os.path.isfile(man_path):
        import subprocess
        import sys

        # the child stays off the accelerator: one process per card
        r = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "examples", "remaster_v1.py"),
             cache, "--frames", str(n_frames), "--tex-size", "1024"],
            capture_output=True, timeout=900,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
        )
        if r.returncode != 0 or not os.path.isfile(man_path):
            return None
    from uvol_tpu.interfaces import PlayMode
    from uvol_tpu.player.clock import PlaybackClock, VirtualClock
    from uvol_tpu.player.facade import Player as FacadePlayer

    def _play_once() -> float:
        vc = VirtualClock()
        ended = []
        p = FacadePlayer(
            paths=[man_path],
            fetcher=lambda u: open(u, "rb").read(),
            on_track_end=lambda: ended.append(1),
            play_mode=PlayMode.unmanaged,
            v1_player_kwargs={"clock": PlaybackClock(now=vc)},
        )
        p.set_track_path(man_path)
        shown = 0
        t0 = time.perf_counter()
        for _ in range(3 * n_frames + 30):
            r = p.update()
            if r is None or ended:
                break
            if r.status == "ok":
                shown += 1
            vc.advance(1 / 30)
        wall = time.perf_counter() - t0
        if shown < n_frames - 3:
            return 0.0  # degraded run: do not report a rosy fps
        return shown / wall

    _play_once()  # warm (native builds, page cache)
    return float(np.median([_play_once() for _ in range(_bench_repeats())]))


def _streams_realwire_metrics(n_streams: int = 8, n_frames: int = 60):
    """8 concurrent REAL facade-path players (VERDICT r4 item 4): real
    `.drc` + `.ktx2` bytes, wire stages (container parse, rANS/Huffman,
    edgebreaker, BasisLZ) + transcode, independent prefetch windows on
    virtual clocks, stepped round-robin like one serving process
    multiplexing 8 viewers. The device-stage companion metric is
    streams8_device_*; this one includes everything the wire costs.

    Also measures the per-stage core-budget model the VERDICT asked
    for: per-frame stage cost AT 8 concurrent streams (allocator and
    cache pressure included — the r5 malloc-threshold fix came from
    exactly this drive), from which the core counts needed for 1x and
    10x real-time follow. Matches BASELINE configs[4] /
    /root/reference/src/lib/WorkerPool.js:29-91 (the reference spreads
    this cost over 4 workers x N tabs; one thread here serializes it).

    Uses the production serving GC config (bounded gen0 + reduced
    gen2 cadence) the same way _play_once uses the production malloc
    tune: both are process-wide serving knobs, applied and restored.
    """
    liam = "/root/reference/example/public/liam"
    if not os.path.isdir(os.path.join(liam, "output")):
        return None
    import gc

    from uvol_tpu.containers.manifest import manifest_for_directory
    from uvol_tpu.interfaces import PlayMode
    from uvol_tpu.player.clock import PlaybackClock, VirtualClock
    from uvol_tpu.player.facade import Player as FacadePlayer
    import uvol_tpu.native as _native
    from uvol_tpu.codecs.basis import transcoder as _transcoder

    manifest_bytes = json.dumps(
        manifest_for_directory(os.path.join(liam, "output"))
    ).encode()
    stage = {"geo_n": 0, "geo_t": 0.0, "tex_n": 0, "tex_t": 0.0,
             "fetch_t": 0.0, "tex_frames": 0}

    def _fetch(url):
        t0 = time.perf_counter()
        if url == "/liam.uvol.json":
            out = manifest_bytes
        else:
            with open(os.path.join(liam, url.lstrip("/")), "rb") as f:
                out = f.read()
        stage["fetch_t"] += time.perf_counter() - t0
        return out

    real_geo = _native.drc_decode_native
    real_tex = _transcoder.transcode_ktx2_etc1s

    def timed_geo(*a, **k):
        t0 = time.perf_counter()
        out = real_geo(*a, **k)
        stage["geo_n"] += 1
        stage["geo_t"] += time.perf_counter() - t0
        return out

    def timed_tex(*a, **k):
        t0 = time.perf_counter()
        out = real_tex(*a, **k)
        stage["tex_n"] += 1
        stage["tex_t"] += time.perf_counter() - t0
        stage["tex_frames"] += len(out)  # [layers, ...] per segment
        return out

    old_thresh = gc.get_threshold()
    _native.drc_decode_native = timed_geo
    _transcoder.transcode_ktx2_etc1s = timed_tex
    gc.set_threshold(50000, 50, 100)
    try:
        players = []
        for _ in range(n_streams):
            vc = VirtualClock()
            p = FacadePlayer(
                paths=["/liam.uvol.json"],
                fetcher=_fetch,
                play_mode=PlayMode.unmanaged,
                on_track_end=lambda: None,
                v2_player_kwargs={"clock": PlaybackClock(now=vc)},
            )
            players.append({"p": p, "vc": vc, "last": -1, "shown": 0})
        t0 = time.perf_counter()
        for st in players:
            st["p"].set_track_path("/liam.uvol.json")
        live = list(players)
        while live:
            for st in list(live):
                r = st["p"].update()
                if r is None:
                    live.remove(st)
                    continue
                if r.status == "ok" and r.geometry_frame != st["last"]:
                    st["shown"] += 1
                    st["last"] = r.geometry_frame
                st["vc"].advance(1 / 30)
                if st["last"] >= n_frames - 1:
                    live.remove(st)
        wall = time.perf_counter() - t0
    finally:
        _native.drc_decode_native = real_geo
        _transcoder.transcode_ktx2_etc1s = real_tex
        gc.set_threshold(*old_thresh)

    shown = sum(st["shown"] for st in players)
    if not shown or not stage["geo_n"]:
        return None
    geo_ms = 1000.0 * stage["geo_t"] / stage["geo_n"]
    tex_ms = 1000.0 * stage["tex_t"] / max(stage["tex_frames"], 1)
    fetch_ms = 1000.0 * stage["fetch_t"] / stage["geo_n"]
    other_ms = max(
        0.0,
        1000.0 * (wall - stage["geo_t"] - stage["tex_t"] - stage["fetch_t"])
        / stage["geo_n"],
    )
    frame_ms = geo_ms + tex_ms + fetch_ms + other_ms
    return {
        "streams8_realwire_fps_total": round(shown / wall, 1),
        "streams8_realwire_fps_per_stream": round(
            shown / wall / n_streams, 2
        ),
        "streams8_realwire_realtime_multiple": round(
            shown / wall / n_streams / 30.0, 3
        ),
        "streams8_realwire_decodes_per_shown": round(
            stage["geo_n"] / shown, 2
        ),
        # steady-state capacity: frames actually pulled through the
        # wire per second (the window fill decodes ~2x the shown count
        # at this run length, so shown/wall understates throughput)
        "streams8_realwire_decode_fps_total": round(
            stage["geo_n"] / wall, 1
        ),
        "streams8_realwire_stage_ms_per_frame": {
            "geometry_decode": round(geo_ms, 1),
            "texture_transcode": round(tex_ms, 1),
            "fetch_io": round(fetch_ms, 2),
            "player_other": round(other_ms, 2),
            "total": round(frame_ms, 1),
        },
        # cores so that 8 streams x 30 fps x frame_ms fits in budget
        "streams8_realwire_cores_for_realtime": round(
            n_streams * 30.0 * frame_ms / 1000.0, 1
        ),
        "streams8_realwire_cores_for_10x": round(
            n_streams * 300.0 * frame_ms / 1000.0, 1
        ),
        "streams8_realwire_cores_present": os.cpu_count(),
    }


def main() -> None:
    import jax

    from uvol_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from uvol_tpu.containers.ktx2 import read_ktx2
    from uvol_tpu.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
    )

    # ---- full-player playback of the real corpus -----------------------------
    # facade -> V2 interval prefetch -> native Draco decode -> BasisLZ
    # transcode (compressed ETC1 target), all 250 frames on a virtual clock;
    # runs FIRST so the headline is measured on a clean heap
    playback_fps = None
    liam_root = "/root/reference/example/public/liam"
    if os.path.isdir(os.path.join(liam_root, "output")):
        from uvol_tpu.containers.manifest import manifest_for_directory
        from uvol_tpu.player.clock import PlaybackClock, VirtualClock
        from uvol_tpu.player.facade import Player as FacadePlayer
        from uvol_tpu.interfaces import PlayMode

        manifest = manifest_for_directory(os.path.join(liam_root, "output"))
        files = {"/liam.uvol.json": json.dumps(manifest).encode()}

        def _fetch(url):
            if url in files:
                return files[url]
            return open(os.path.join(liam_root, url.lstrip("/")), "rb").read()

        def _play_once() -> float:
            vc = VirtualClock()
            fp = FacadePlayer(
                paths=["/liam.uvol.json"],
                fetcher=_fetch,
                play_mode=PlayMode.unmanaged,
                on_track_end=lambda: None,
                v2_player_kwargs={"clock": PlaybackClock(now=vc)},
            )
            t0 = time.perf_counter()
            fp.set_track_path("/liam.uvol.json")
            shown, last = 0, -1
            while shown < 250:
                rr = fp.update()
                if rr is None:
                    break
                if rr.status == "ok" and rr.geometry_frame != last:
                    shown += 1
                    last = rr.geometry_frame
                vc.advance(1 / 30)
            return shown / (time.perf_counter() - t0)

        _play_once()  # warm (native builds, page cache)
        playback_fps = float(
            np.median([_play_once() for _ in range(_bench_repeats())])
        )

    r = np.random.default_rng(0)
    # 32-frame batches: the device metrics batch >1 s of 30 fps video per
    # dispatch
    F = 32  # frames per batch
    N = 26145  # liam-scale vertex count
    H = W = 1024  # liam texture resolution

    # liam-like content: smooth surface + textured image
    theta = r.uniform(0, np.pi, N)
    phi = r.uniform(0, 2 * np.pi, N)
    base = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1
    )
    positions = np.stack([base * (1 + 0.01 * k) for k in range(F)]).astype(
        np.float32
    )
    uvs = r.uniform(0, 1, (F, N, 2)).astype(np.float32)
    counts = np.full(F, N, np.int64)
    # coherent strip-like connectivity (real meshes have small index deltas;
    # random triangles would benchmark a pathological entropy alphabet)
    k = np.arange(2 * N - 2)
    strip = np.stack([k // 2, k // 2 + 1 + (k % 2), k // 2 + 2 - (k % 2)], 1)
    strip = (strip % N).astype(np.int32)
    faces = [strip for _ in range(F)]
    yy, xx = np.mgrid[0:H, 0:W]
    tex = np.stack([(xx // 4) % 256, (yy // 4) % 256, ((xx + yy) // 8) % 256], -1)
    textures = np.stack([np.roll(tex, k, axis=1) for k in range(F)]).astype(
        np.uint8
    )

    geo = GeometrySequenceCodec(position_bits=11, uv_bits=10)
    texc = TextureSequenceCodec(sequence_size=F)
    frames = GeometryFrameSet(positions, uvs, counts, faces)
    # the e2e loop re-uploads its batch every rep, so it runs an 8-frame
    # slice (the device metrics below use the full 32-frame batch with
    # device-resident tensors)
    F_E2E = 8
    texc_e2e = TextureSequenceCodec(sequence_size=F_E2E)
    frames_e2e = GeometryFrameSet(
        positions[:F_E2E], uvs[:F_E2E], counts[:F_E2E], faces[:F_E2E]
    )
    tex_e2e = textures[:F_E2E]

    # ---- warmup / compile ---------------------------------------------------
    blobs = geo.encode(frames_e2e)
    dec = geo.decode(blobs, as_numpy=False)
    tex_blob = texc_e2e.encode_segment(tex_e2e)
    tex_dec = texc_e2e.decode_segment(read_ktx2(tex_blob), as_numpy=False)

    # ---- timed loop: bytes out → tensors back --------------------------------
    reps = 2
    t_geo_enc = t_geo_dec = t_tex_enc = t_tex_dec = 0.0
    t0 = time.perf_counter()
    for _ in range(reps):
        t = time.perf_counter()
        blobs = geo.encode(frames_e2e)
        t_geo_enc += time.perf_counter() - t
        t = time.perf_counter()
        tex_blob = texc_e2e.encode_segment(tex_e2e)
        t_tex_enc += time.perf_counter() - t
        t = time.perf_counter()
        dec = geo.decode(blobs, as_numpy=False)  # tensors stay on device
        t_geo_dec += time.perf_counter() - t
        t = time.perf_counter()
        tex_dec = texc_e2e.decode_segment(
            read_ktx2(tex_blob), as_numpy=False
        )
        t_tex_dec += time.perf_counter() - t
    dt = time.perf_counter() - t0
    fps = reps * F_E2E / dt

    # ---- correctness gates ----------------------------------------------------
    step = float(
        (positions[0].max(0) - positions[0].min(0)).max()
    ) / 2047
    # device-resident decode output is planar [F, C, N]
    err = float(
        np.abs(np.asarray(dec.positions)[0][:, :N].T - positions[0]).max()
    )
    assert err <= step, (err, step)
    assert tex_dec.shape == tex_e2e.shape
    total_bytes = sum(len(b) for b in blobs) + len(tex_blob)

    nframes = reps * F_E2E
    mverts = nframes * N / (t_geo_enc + t_geo_dec) / 1e6

    # ---- real Draco corpus decode (the reference's own playback format) -----
    liam_device_decode_fps = liam_device_decode_mverts = None
    liam_device_stage_mverts = None
    liam_device_decode_pipelined_fps = None
    (liam_fps, liam_fps_pool, liam_enc_fps,
     frames_bin, meshes) = _liam_host_metrics()
    _e, _d, _b = _v1_video_metrics()
    v1_enc_f = round(_e, 1) if _e else None
    v1_dec_f = round(_d, 1) if _d else None
    v1_bpp_f = round(_b, 2) if _b else None
    _vp = _v1_player_metrics()
    v1_play_f = round(_vp, 1) if _vp else None
    realwire = _streams_realwire_metrics() or {}
    if frames_bin is not None:
        from uvol_tpu.codecs.draco import constants as KD

        # real .drc -> DEVICE-resident tensors: host C wire stages
        # (sequential recurrences) + batched device dequantize/oct->unit
        # (models/drc_device.py; VERDICT r1 item 4)
        from uvol_tpu.models.drc_device import decode_drc_batch

        # warm compile — and wait for it: dispatches are async, so an
        # unforced warm call leaves the compile + execute in flight and
        # the timed region below absorbs them
        jax.block_until_ready([
            v for v in decode_drc_batch(frames_bin).values.values()
            if not isinstance(v, list)
        ])
        t0 = time.perf_counter()
        dbatch = decode_drc_batch(frames_bin)
        jax.block_until_ready(
            [v for v in dbatch.values.values() if not isinstance(v, list)]
        )
        dt_dd = time.perf_counter() - t0
        liam_device_decode_fps = len(frames_bin) / dt_dd
        liam_device_decode_mverts = (
            sum(int(c) for c in dbatch.counts[0]) / dt_dd / 1e6
        )

        # pipelined streaming variant (decode_drc_stream): host wire
        # decode of window k+1 overlaps window k's device upload+compute
        from uvol_tpu.models.drc_device import decode_drc_stream

        # 128 DISTINCT corpus frames (r4 streamed the same 8 frames
        # twice — 16 frames total, so the pipeline's fixed startup +
        # final-window tail dominated the rate; a real player streams
        # the whole 250-frame track), median-of-3 per the r4 verdict
        liam_dir = (
            "/root/reference/example/public/liam/output/geometry_draco"
        )
        big = [
            open(os.path.join(liam_dir, f"{i:05d}.drc"), "rb").read()
            for i in range(128)
        ]
        # warm every window shape (nmax buckets can differ) and force
        # the in-flight dispatches out of the timed region
        for _s, _b in decode_drc_stream(big[:32], window=4):
            jax.block_until_ready([
                v for v in _b.values.values() if not isinstance(v, list)
            ])
        pipe_runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            last = None
            for _s, batch in decode_drc_stream(big, window=4):
                last = batch
            jax.block_until_ready(
                [v for v in last.values.values() if not isinstance(v, list)]
            )
            pipe_runs.append(len(big) / (time.perf_counter() - t0))
        liam_device_decode_pipelined_fps = sorted(pipe_runs)[1]

        # device-stage-only variant: the jitted dequantize over a
        # device-RESIDENT 64-frame batch at the real frames' shape
        # (dequantize is data-independent elementwise math, so zeros
        # time identically). Separates the device stage from the host
        # wire decode and the upload in the end-to-end number above.
        import jax.numpy as _jnp

        from uvol_tpu.models import drc_device as _dd

        if _dd._FNS is not None:
            _dequant, _oct = _dd._FNS
            pos_dev = dbatch.values[KD.ATT_POSITION]  # [8, N, 3]
            ints8 = _jnp.tile(
                _jnp.zeros(pos_dev.shape, _jnp.int16), (8, 1, 1)
            )
            f64 = ints8.shape[0]
            st8 = _jnp.zeros((f64, ints8.shape[1], 2), _jnp.int16)
            mins8 = _jnp.zeros((f64, 3), _jnp.float32)
            scale8 = _jnp.ones(f64, _jnp.float32)
            maxv8 = _jnp.full(f64, 254.0, _jnp.float32)

            def _stage():
                # both device stages of a real frame: position/uv
                # dequantize AND octahedral-normal reconstruction
                return (
                    _dequant(ints8, mins8, scale8),
                    _oct(st8, maxv8),
                )

            jax.block_until_ready(_stage())
            t0 = time.perf_counter()
            for _ in range(3):
                out = _stage()
            jax.block_until_ready(out)
            dt_ds = time.perf_counter() - t0
            # count ACTUAL per-frame vertex counts (not the padded Nmax)
            real_per_frame = sum(
                int(c) for c in dbatch.counts[KD.ATT_POSITION]
            ) / len(frames_bin)
            liam_device_stage_mverts = (
                3 * f64 * real_per_frame / dt_ds / 1e6
            )

    # ---- 8 concurrent streams (BASELINE "8 streams ≥10× real-time") ----------
    # pure data parallelism over the stream×frame axes: one batched program
    # encodes+decodes geometry for all 8 liam-scale streams; host entropy
    # fans out over threads. Reported per stream.
    STREAMS = 8
    ms_frames = GeometryFrameSet(
        np.tile(positions[:4], (STREAMS, 1, 1)),
        np.tile(uvs[:4], (STREAMS, 1, 1)),
        np.full(4 * STREAMS, N, np.int64),
        [strip] * (4 * STREAMS),
    )
    ms_blobs = geo.encode(ms_frames)  # warm shapes (encode AND decode)
    geo.decode(ms_blobs, as_numpy=False)
    t0 = time.perf_counter()
    ms_blobs = geo.encode(ms_frames)
    geo.decode(ms_blobs, as_numpy=False)
    dt8 = time.perf_counter() - t0
    per_stream_fps = 4 * STREAMS / dt8 / STREAMS

    # windowed variant through the device ring buffer (SURVEY §7 step 7):
    # window i+1's host->device upload overlaps window i's device encode
    from uvol_tpu.runtime.device_stream import stream_frames

    enc_dev8 = geo._encode_device
    windows = [
        (
            np.tile(positions[:4].transpose(0, 2, 1), (STREAMS, 1, 1)),
            np.tile(uvs[:4].transpose(0, 2, 1), (STREAMS, 1, 1)),
            np.ones((4 * STREAMS, N), bool),
        )
        for _ in range(3)
    ]
    fn8 = lambda w: enc_dev8(*w)  # noqa: E731
    for _, r in stream_frames(windows[:1], fn8):
        jax.block_until_ready(r)  # warm
    t0 = time.perf_counter()
    last = None
    for _, r in stream_frames(windows, fn8, num_slots=2):
        last = r
    jax.block_until_ready(last)
    streamed_fps = len(windows) * 4 * STREAMS / (time.perf_counter() - t0)

    # ---- device-compute-only sub-metric ---------------------------------------
    # the FULL per-frame codec chain — geometry quantize+delta+zigzag
    # encode AND dequantize+integrate decode, ETC1 block encode AND
    # decode for a 1024² texture — with device-resident tensors
    import jax.numpy as jnp

    # upload the 8-frame slice and tile to the 32-frame batch on device
    rep_n = F // F_E2E
    # planar device contracts: geometry [F, C, N], textures enter the
    # codec as [F, H, W, 3]
    dev_pos = jnp.tile(
        jnp.asarray(positions[:F_E2E].transpose(0, 2, 1)), (rep_n, 1, 1)
    )
    dev_uv = jnp.tile(
        jnp.asarray(uvs[:F_E2E].transpose(0, 2, 1)), (rep_n, 1, 1)
    )
    dev_mask = jnp.ones((F, N), bool)
    dev_tex = jnp.tile(jnp.asarray(tex_e2e), (rep_n, 1, 1, 1))
    enc_dev = geo._encode_device
    tex_enc_dev = texc._encode
    dec_dev = geo._decode_device
    tex_dec_dev = texc._decode

    @jax.jit
    def device_chain():
        out = enc_dev(dev_pos, dev_uv, dev_mask)
        words = tex_enc_dev(dev_tex)
        pos2, uv2 = dec_dev(
            out["pos_syms"],
            out["pos_min"],
            out["pos_range"] / 2047.0,
            out["uv_syms"],
            out["uv_min"],
            out["uv_range"] / 1023.0,
        )
        imgs = tex_dec_dev(words, H, W)
        return out, words, pos2, uv2, imgs

    res = device_chain()
    jax.block_until_ready(res)

    # ---- jax.profiler trace capture (SURVEY §5 tracing) ----------------------
    # One full device-chain dispatch is wrapped in jax.profiler.trace so
    # kernel-level device attribution comes from real XLA traces.
    # UVT_BENCH_TRACE=0 disables; UVT_BENCH_TRACE_DIR overrides the
    # output path (default traces/, gitignored).
    trace_dir = None
    if os.environ.get("UVT_BENCH_TRACE", "1") != "0":
        trace_dir = os.environ.get("UVT_BENCH_TRACE_DIR") or os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "traces",
            time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
        )
        try:
            os.makedirs(trace_dir, exist_ok=True)
            with jax.profiler.trace(trace_dir):
                res = device_chain()
                jax.block_until_ready(res)
        except Exception:
            trace_dir = None  # tracing must never sink the bench run

    # 6 queued dispatches per timed region, and every device metric is
    # the MEDIAN of 3 timed regions
    dev_reps = 6

    def _median_device_fps(fn, units):
        vals = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(dev_reps):
                res = fn()
            jax.block_until_ready(res)
            vals.append(dev_reps * units / (time.perf_counter() - t0))
        return float(np.median(vals))

    device_fps = _median_device_fps(device_chain, F)

    # ---- device-only 8-stream metric (VERDICT r1 item 5) ---------------------
    # 8 concurrent liam-scale streams × 4 frames as ONE device batch
    # through the same full enc+dec chain — pure device residency; the
    # streams×frames axes are exactly what shard_map splits over a real
    # multi-chip mesh (tests/test_multichip.py runs that path on 8
    # virtual devices; one physical chip here).
    s_pos = jnp.tile(
        jnp.asarray(positions[:4].transpose(0, 2, 1)), (STREAMS, 1, 1)
    )
    s_uv = jnp.tile(jnp.asarray(uvs[:4].transpose(0, 2, 1)), (STREAMS, 1, 1))
    s_mask = jnp.ones((4 * STREAMS, N), bool)
    s_tex = jnp.tile(dev_tex[:4], (STREAMS, 1, 1, 1))

    @jax.jit
    def stream_chain():
        out = enc_dev(s_pos, s_uv, s_mask)
        words = tex_enc_dev(s_tex)
        pos2, uv2 = dec_dev(
            out["pos_syms"], out["pos_min"], out["pos_range"] / 2047.0,
            out["uv_syms"], out["uv_min"], out["uv_range"] / 1023.0,
        )
        imgs = tex_dec_dev(words, H, W)
        return out, words, pos2, uv2, imgs

    sres = stream_chain()
    jax.block_until_ready(sres)
    streams8_device_fps_per_stream = _median_device_fps(stream_chain, 4)

    # decode-only variant — the reference's actual 8-stream scenario is
    # 8 concurrent PLAYERS (decode side only; BASELINE.json configs[4],
    # DRACOLoader worker pools)
    s_words = sres[1]
    s_psyms, s_pmin = sres[0]["pos_syms"], sres[0]["pos_min"]
    s_pscale = sres[0]["pos_range"] / 2047.0
    s_usyms, s_umin = sres[0]["uv_syms"], sres[0]["uv_min"]
    s_uscale = sres[0]["uv_range"] / 1023.0

    @jax.jit
    def stream_decode():
        pos2, uv2 = dec_dev(
            s_psyms, s_pmin, s_pscale, s_usyms, s_umin, s_uscale
        )
        imgs = tex_dec_dev(s_words, H, W)
        return pos2, uv2, imgs

    sdres = stream_decode()
    jax.block_until_ready(sdres)
    streams8_decode_fps_per_stream = _median_device_fps(stream_decode, 4)
    # Headline: the reference's own workload — play its real 250-frame
    # corpus (draco_encoder .drc + basisu .ktx2) through the full
    # production path (facade -> V2 prefetch -> native Draco decode ->
    # BasisLZ transcode) against the 30 fps real-time bar. Falls back to
    # the synthetic end-to-end number when the corpus is absent.
    headline = playback_fps if playback_fps else fps
    headline_name = (
        "liam 250-frame full-player playback fps (real reference corpus, "
        "facade->prefetch->decode->transcode)"
        if playback_fps
        else "end-to-end encode+decode frames/s/chip "
        "(26k-vert geom->bytes->tensors + 1024^2 tex->ktx2->tensors)"
    )
    result = (
            {
                "metric": headline_name,
                "value": round(headline, 2),
                "unit": "frames/s",
                "vs_baseline": round(headline / 30.0, 2),
                "detail": {
                    "synthetic_e2e_fps": round(fps, 2),
                    "geometry_encode_fps": round(nframes / t_geo_enc, 1),
                    "geometry_decode_fps": round(nframes / t_geo_dec, 1),
                    "texture_encode_fps": round(nframes / t_tex_enc, 1),
                    "texture_decode_fps": round(nframes / t_tex_dec, 1),
                    "geometry_mverts_per_s": round(mverts, 2),
                    "stream_bytes_per_batch": total_bytes,
                    "host_metric_repeats": _bench_repeats(),
                    "profiler_trace_dir": trace_dir,
                    "device_compute_only_fps": round(device_fps, 1),
                    "streams8_geometry_fps_per_stream": round(per_stream_fps, 1),
                    "streams8_realtime_multiple": round(per_stream_fps / 30.0, 2),
                    "streams8_ringbuffer_total_fps": round(streamed_fps, 1),
                    "streams8_device_fps_per_stream": round(
                        streams8_device_fps_per_stream, 1
                    ),
                    "streams8_device_realtime_multiple": round(
                        streams8_device_fps_per_stream / 30.0, 2
                    ),
                    "streams8_device_decode_fps_per_stream": round(
                        streams8_decode_fps_per_stream, 1
                    ),
                    "streams8_device_decode_realtime_multiple": round(
                        streams8_decode_fps_per_stream / 30.0, 2
                    ),
                    "liam_full_player_playback_fps": (
                        round(playback_fps, 1) if playback_fps else None
                    ),
                    "liam_draco_decode_fps": (
                        round(liam_fps, 1) if liam_fps else None
                    ),
                    "liam_draco_decode_fps_pool4": (
                        round(liam_fps_pool, 1) if liam_fps_pool else None
                    ),
                    "liam_draco_encode_fps": (
                        round(liam_enc_fps, 1) if liam_enc_fps else None
                    ),
                    "v1_full_player_playback_fps": v1_play_f,
                    **realwire,
                    "v1_h264_encode_fps": v1_enc_f,
                    "v1_h264_decode_fps": v1_dec_f,
                    "v1_h264_bpp": v1_bpp_f,
                    "liam_device_decode_fps": (
                        round(liam_device_decode_fps, 1)
                        if liam_device_decode_fps else None
                    ),
                    "liam_device_decode_mverts_per_s": (
                        round(liam_device_decode_mverts, 2)
                        if liam_device_decode_mverts else None
                    ),
                    "liam_device_decode_pipelined_fps": (
                        round(liam_device_decode_pipelined_fps, 1)
                        if liam_device_decode_pipelined_fps else None
                    ),
                    "liam_device_stage_mverts_per_s": (
                        round(liam_device_stage_mverts, 1)
                        if liam_device_stage_mverts else None
                    ),
                    "device": {
                        "platform": jax.devices()[0].platform,
                        "kind": jax.devices()[0].device_kind,
                        "count": len(jax.devices()),
                    },
                },
            }
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
