"""Prediction transforms: delta and (multi-)parallelogram.

Re-expresses the reference's prediction stage as pure array programs:
  - Corto's PARALLEL (parallelogram) / CORRELATED (delta-to-neighbor)
    strategies (deprecated/encoder/dev/src/vertex_attribute.h:33,
    deltaDecode in src/lib/corto.ts:389-410)
  - Draco's difference / parallelogram prediction schemes used by the
    sequential integer attribute decoders.

Encode side is fully parallel: residual[i] = v[i] - (v[a]+v[b]-v[c]) is a
pure gather, `vmap`-able over frames. Decode side is a prefix dependency —
expressed as `lax.scan` over vertices so the whole decode stays on-device
and `vmap`s over the frame axis (SURVEY.md §7 step 2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def parallelogram_encode(
    values: Array, pred_indices: Array, *, first_delta: bool = True
) -> Array:
    """Residuals under parallelogram prediction.

    values:       [..., N, D] int32 quantized attribute values
    pred_indices: [..., N, 3] int32 — for each vertex i, indices (a, b, c)
                  of the already-coded parallelogram corners, with the
                  convention pred = v[a] + v[b] - v[c]. Index -1 in column a
                  means "no predictor": predict from previous vertex
                  (or zero for vertex 0 when `first_delta`).
    """
    a, b, c = pred_indices[..., 0], pred_indices[..., 1], pred_indices[..., 2]
    va = jnp.take_along_axis(values, jnp.maximum(a, 0)[..., None], axis=-2)
    vb = jnp.take_along_axis(values, jnp.maximum(b, 0)[..., None], axis=-2)
    vc = jnp.take_along_axis(values, jnp.maximum(c, 0)[..., None], axis=-2)
    par = va + vb - vc

    n = values.shape[-2]
    idx = jax.lax.broadcasted_iota(jnp.int32, values.shape[:-1], len(values.shape) - 2)
    prev = jnp.roll(values, 1, axis=-2)
    # vertex 0 always predicts from zero — the decoder's scan carry starts
    # at zeros for both first_delta settings, and the rolled row 0 would
    # otherwise wrap around to values[N-1] and break the round-trip
    prev = jnp.where((idx == 0)[..., None], 0, prev)

    pred = jnp.where((a >= 0)[..., None], par, prev)
    return values - pred


def parallelogram_decode(
    residuals: Array, pred_indices: Array, *, first_delta: bool = True
) -> Array:
    """Inverse of `parallelogram_encode` via `lax.scan` over vertices.

    The scan carries the reconstructed prefix; each step gathers its three
    corners from it. O(N) sequential steps on-device, `vmap` over frames for
    throughput (frame-parallelism is the reference's own axis of parallelism,
    SURVEY.md §2.4).
    """
    n, d = residuals.shape[-2], residuals.shape[-1]
    batch_shape = residuals.shape[:-2]

    def one_mesh(res: Array, pidx: Array) -> Array:
        out0 = jnp.zeros((n, d), res.dtype)

        def step(carry, i):
            out, prev = carry
            a, b, c = pidx[i, 0], pidx[i, 1], pidx[i, 2]
            par = out[jnp.maximum(a, 0)] + out[jnp.maximum(b, 0)] - out[jnp.maximum(c, 0)]
            base = jnp.where(i == 0, jnp.zeros((d,), res.dtype) if first_delta else prev, prev)
            pred = jnp.where(a >= 0, par, base)
            v = res[i] + pred
            out = out.at[i].set(v)
            return (out, v), None

        (out, _), _ = jax.lax.scan(
            step, (out0, jnp.zeros((d,), res.dtype)), jnp.arange(n)
        )
        return out

    fn = one_mesh
    for _ in batch_shape:
        fn = jax.vmap(fn)
    return fn(residuals, pred_indices)


def delta_encode(values: Array) -> Array:
    """Plain successive-difference coding (Corto CORRELATED / Draco delta)."""
    prev = jnp.roll(values, 1, axis=-2)
    idx = jax.lax.broadcasted_iota(jnp.int32, values.shape[:-1], len(values.shape) - 2)
    prev = jnp.where((idx == 0)[..., None], 0, prev)
    return values - prev


def delta_decode(residuals: Array) -> Array:
    """Inverse of `delta_encode` — a cumulative sum (fully parallel on device)."""
    return jnp.cumsum(residuals, axis=-2, dtype=residuals.dtype)
