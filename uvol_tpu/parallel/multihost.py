"""Two-process `jax.distributed` bring-up + byte-parity check.

SURVEY §2.4/§5 call for multi-host scale via
`jax.distributed.initialize` (the reference itself is single-node; its
"distributed" transport is Web Worker postMessage —
/root/reference/src/V1/worker.ts:69). This module actually exercises the
multi-host path in CI: a launcher spawns two coordinator-connected
processes, each holding 4 virtual CPU devices, and runs the PRODUCTION
mesh-sharded codecs (models/sequence.py) over the resulting 8-device
global mesh. Both processes must produce byte-identical artifacts, which
must also match the single-process codec (tests/test_multihost.py closes
that loop).

Run as a worker:  python -m uvol_tpu.parallel.multihost --worker OUT.json
(with JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID set —
the standard launcher contract initialize_distributed consumes).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_check_inputs(n_frames: int, n_verts: int = 96, hw: int = 16):
    """Deterministic inputs shared by workers and the single-process
    reference (same rng stream order on every caller)."""
    import numpy as np

    r = np.random.default_rng(0)
    positions = r.normal(size=(n_frames, n_verts, 3)).astype(np.float32)
    uvs = r.uniform(0, 1, (n_frames, n_verts, 2)).astype(np.float32)
    counts = np.full(n_frames, n_verts, np.int64)
    k = np.arange(32)
    faces = [
        (np.stack([k, k + 1, k + 2], 1).astype(np.int32) % n_verts)
    ] * n_frames
    textures = r.integers(0, 256, (n_frames, hw, hw, 3)).astype(np.uint8)
    return positions, uvs, counts, faces, textures


def run_codecs(mesh, n_frames: int):
    """Encode+decode the production codecs; return artifact hashes."""
    import numpy as np

    from uvol_tpu.containers.ktx2 import read_ktx2
    from uvol_tpu.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
    )

    positions, uvs, counts, faces, textures = make_check_inputs(n_frames)
    geo = GeometrySequenceCodec(mesh=mesh)
    blobs = geo.encode(GeometryFrameSet(positions, uvs, counts, faces))
    dec = geo.decode(blobs)
    # device-resident output mode must also work multi-process (the
    # gather boundary applies regardless of as_numpy — review r3): the
    # replicated result is addressable, so readback must agree
    dev = geo.decode(blobs, as_numpy=False)
    if not np.array_equal(
        np.ascontiguousarray(np.asarray(dev.positions).transpose(0, 2, 1)),
        np.asarray(dec.positions),
    ):
        raise AssertionError("device-resident decode diverged")
    texc = TextureSequenceCodec(sequence_size=n_frames, mesh=mesh)
    tex_blob = texc.encode_segment(textures)
    tdec = texc.decode_segment(read_ktx2(tex_blob))
    return {
        "geo_blobs": hashlib.sha256(b"".join(blobs)).hexdigest(),
        "geo_decoded": hashlib.sha256(
            np.ascontiguousarray(dec.positions).tobytes()
        ).hexdigest(),
        "tex_blob": hashlib.sha256(tex_blob).hexdigest(),
        "tex_decoded": hashlib.sha256(
            np.ascontiguousarray(tdec).tobytes()
        ).hexdigest(),
    }


def worker_main(out_path: str) -> None:
    import jax

    # the check runs on CPU processes whatever the ambient platform
    jax.config.update("jax_platforms", "cpu")

    from uvol_tpu.parallel.mesh import initialize_distributed, make_mesh

    if not initialize_distributed():
        raise RuntimeError("multi-process env vars missing")
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    if n_global <= n_local:
        raise RuntimeError(
            f"expected a multi-process mesh, got {n_global} global / "
            f"{n_local} local devices"
        )
    mesh = make_mesh()
    hashes = run_codecs(mesh, n_frames=n_global * 2)
    hashes.update(
        process_index=jax.process_index(),
        n_global_devices=n_global,
        n_local_devices=n_local,
    )
    with open(out_path, "w") as fh:
        json.dump(hashes, fh)


def run_two_process_check(
    n_local_devices: int = 4, timeout: float = 420.0
) -> dict:
    """Spawn 2 coordinator-connected CPU processes (4 virtual devices
    each), run the production sharded codecs on the 8-device global mesh,
    assert byte-parity between the processes, and return process 0's
    artifact hashes (n_frames = 2x global devices)."""
    import tempfile

    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], []
        for pid in range(2):
            out = os.path.join(tmp, f"p{pid}.json")
            outs.append(out)
            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            env.pop("JAX_PLATFORM_NAME", None)
            flags = [
                f
                for f in env.get("XLA_FLAGS", "").split()
                if "xla_force_host_platform_device_count" not in f
            ]
            flags.append(
                f"--xla_force_host_platform_device_count={n_local_devices}"
            )
            env["XLA_FLAGS"] = " ".join(flags)
            env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            env["JAX_NUM_PROCESSES"] = "2"
            env["JAX_PROCESS_ID"] = str(pid)
            env["_UVOL_DRYRUN_CHILD"] = "0"
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable,
                        "-m",
                        "uvol_tpu.parallel.multihost",
                        "--worker",
                        out,
                    ],
                    env=env,
                    cwd=repo_root,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                )
            )
        logs = []
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            logs.append(stdout.decode(errors="replace"))
        for pid, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"multihost worker {pid} failed (rc={p.returncode}):\n"
                    + logs[pid][-4000:]
                )
        results = []
        for out in outs:
            with open(out) as fh:
                results.append(json.load(fh))
    r0, r1 = results
    for key in ("geo_blobs", "geo_decoded", "tex_blob", "tex_decoded"):
        if r0[key] != r1[key]:
            raise AssertionError(
                f"process parity violated for {key}: {r0[key]} != {r1[key]}"
            )
    if {r0["process_index"], r1["process_index"]} != {0, 1}:
        raise AssertionError("workers did not claim distinct process ids")
    return r0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker_main(sys.argv[2])
    else:
        print(json.dumps(run_two_process_check(), indent=2))
