"""Device mesh + sharding helpers (frame-parallel volumetric pipelines).

The reference's parallelism is worker pools over frames/segments
(SURVEY.md §2.4: DRACOLoader pool ≤4 workers, Basis WorkerPool). The
device equivalent is pure data parallelism over the frame axis of a
`jax.sharding.Mesh`, with collectives only for reductions
(stats/codebooks).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frames"
BLOCK_AXIS = "blocks"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-host bring-up: `jax.distributed.initialize` with env-var
    fallbacks, so `make_mesh()` then spans every host's devices
    (SURVEY §2.4 / §5).

    Args fall back to JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID (the standard launcher contract). Returns True when a
    multi-process runtime was initialized, False for the single-process
    case (nothing to do — the local mesh path is unchanged). Safe to call
    twice; a second call is a no-op.

    This cannot be exercised in the single-chip CI environment (the
    8-device tests use a virtual CPU mesh instead); the call path is the
    standard one production pods use.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if getattr(initialize_distributed, "_done", False):
        return True
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    initialize_distributed._done = True
    return True


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans devices owned by more than one process —
    the multi-host case where per-process `np.asarray` of a sharded array
    would fail (shards live on non-addressable devices)."""
    pid = jax.process_index()
    return any(d.process_index != pid for d in mesh.devices.flat)


def replicate_to_host(mesh: Mesh, tree):
    """Gather a pytree of mesh-sharded arrays to fully-replicated arrays.

    One all-gather per leaf; afterwards every process can
    `np.asarray` the result. This is the multi-host analog of the
    reference's worker→main-thread transferable handoff
    (/root/reference/src/V1/worker.ts:69)."""
    sharding = NamedSharding(mesh, jax.sharding.PartitionSpec())
    return jax.jit(lambda t: t, out_shardings=sharding)(tree)


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis_shapes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (FRAME_AXIS,),
) -> Mesh:
    """1-D frame mesh by default; pass axis_shapes for frames×blocks grids."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if axis_shapes is None:
        axis_shapes = (len(devices),)
    grid = np.asarray(devices).reshape(axis_shapes)
    return Mesh(grid, axis_names=tuple(axis_names))


def frame_sharding(mesh: Mesh, ndim: int, frame_dim: int = 0) -> NamedSharding:
    """Shard `frame_dim` over the frame axis, replicate the rest."""
    spec = [None] * ndim
    spec[frame_dim] = FRAME_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_frames(mesh: Mesh, array: jax.Array, frame_dim: int = 0) -> jax.Array:
    """Place a frame-batched array so each device owns a frame slice."""
    return jax.device_put(array, frame_sharding(mesh, array.ndim, frame_dim))


def pad_frames_to_mesh(array: np.ndarray, mesh: Mesh, frame_dim: int = 0):
    """Pad the frame axis to a multiple of the mesh's frame-axis size.

    Returns (padded, original_count) — ragged sequences are the norm
    (SURVEY.md §7 hard part (d)).
    """
    n = array.shape[frame_dim]
    per = mesh.shape[FRAME_AXIS]
    target = -(-n // per) * per
    if target == n:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[frame_dim] = (0, target - n)
    return np.pad(array, pad), n


def bucket_frames_by_count(
    counts,
    mesh_size: int = 1,
    max_waste: float = 0.25,
):
    """Group frame indices into padding buckets for ragged sequences.

    Frames in one device batch pad to the batch's max vertex count, so a
    single 50k-vert frame in a batch of 5k-vert frames makes every lane
    10x wider than needed. This sorts frames by count and greedily cuts
    buckets so each bucket's padded-compute waste
    (1 - sum(counts)/(len*max)) stays under `max_waste`; bucket lengths
    are then rounded to multiples of `mesh_size` when possible so the
    frame axis shards evenly (the remainder bucket relies on
    `pad_frames_to_mesh`). Returns a list of index arrays covering every
    frame exactly once (ascending count across buckets).
    """
    counts = np.asarray(counts, np.int64)
    order = np.argsort(counts, kind="stable")
    buckets = []
    start = 0
    n = len(order)
    while start < n:
        end = start + 1
        total = int(counts[order[start]])
        while end < n:
            c = int(counts[order[end]])
            new_total = total + c
            # order is count-sorted, so c IS the running max
            waste = 1.0 - new_total / ((end - start + 1) * max(c, 1))
            if waste > max_waste and (end - start) >= mesh_size:
                break
            total = new_total
            end += 1
        if mesh_size > 1 and end < n:
            # round down to a sharding-even length (keep >= mesh_size)
            span = end - start
            even = (span // mesh_size) * mesh_size
            if even >= mesh_size:
                end = start + even
        buckets.append(order[start:end])
        start = end
    return buckets
