"""Texture codebook learning (ETC1S-style global palettes) on device.

The reference's ETC1S path relies on basisu's global endpoint/selector
codebooks (scripts/Encoder.py:286-298 → .ktx2 with BasisLZ global data).
Building such codebooks is a clustering problem (SURVEY.md §7 hard part
(c)); here it is a batched k-means whose assignment step is a single
matmul and whose update step reduces over the frame axis with
`psum` — the canonical dp-over-frames collective pattern for this
framework's training-style workloads.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uvol_tpu.parallel.mesh import FRAME_AXIS

Array = jax.Array


def kmeans_assign(blocks: Array, codebook: Array) -> Array:
    """blocks [B, D], codebook [K, D] → assignments [B] (argmin L2).

    Distance via the matmul identity so the heavy term is one matmul.
    """
    dots = jnp.dot(
        blocks.astype(jnp.bfloat16),
        codebook.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    c2 = jnp.sum(codebook.astype(jnp.float32) ** 2, axis=1)
    return jnp.argmin(c2[None, :] - 2.0 * dots, axis=1)


def kmeans_update(
    blocks: Array, codebook: Array, *, axis_name: str | None = None
) -> Tuple[Array, Array]:
    """One Lloyd iteration; cross-device reduction when `axis_name` given.

    Returns (new_codebook, mean_distortion).
    """
    k, d = codebook.shape
    assign = kmeans_assign(blocks, codebook)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # [B, K]
    sums = jnp.dot(
        onehot.T, blocks.astype(jnp.float32), preferred_element_type=jnp.float32
    )  # [K, D]
    counts = jnp.sum(onehot, axis=0)  # [K]
    chosen = codebook.astype(jnp.float32)[assign]
    distortion = jnp.sum((blocks.astype(jnp.float32) - chosen) ** 2)
    n = jnp.asarray(blocks.shape[0], jnp.float32)
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        counts = jax.lax.psum(counts, axis_name)
        distortion = jax.lax.psum(distortion, axis_name)
        n = jax.lax.psum(n, axis_name)
    new_codebook = jnp.where(
        counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], codebook
    )
    return new_codebook, distortion / jnp.maximum(n, 1.0)


def make_sharded_train_step(mesh: Mesh):
    """jit-compiled training step: frames sharded, codebook replicated.

    This is the full multi-chip "training step" shape of the framework:
    per-device assignment + matmul reduction, `psum` across devices, replicated
    parameter update.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(FRAME_AXIS), P()),
        out_specs=(P(), P()),
    )
    def step(local_blocks, codebook):
        flat = local_blocks.reshape(-1, local_blocks.shape[-1])
        return kmeans_update(flat, codebook, axis_name=FRAME_AXIS)

    return jax.jit(step)
