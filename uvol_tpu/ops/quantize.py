"""Attribute quantization kernels (JAX, batched over frames).

Batched re-expression of the reference's per-attribute quantizers:
  - Draco-style uniform range quantization driven by Q_POSITION_ATTR=11,
    Q_TEXTURE_ATTR=10, Q_NORMAL_ATTR=8, Q_GENERIC_ATTR=8
    (reference: scripts/Encoder.py:260-267 flags to draco_encoder)
  - Corto's per-component power-of-two step quantization
    (reference: deprecated/encoder/dev/src/vertex_attribute.h:72-120,
     encoder.cpp:49 quantization-step heuristic)

All functions are shape-polymorphic pure array programs: they accept a
single frame `[N, D]` or a padded batch `[F, N, D]` (quantization bounds are
computed per frame over a validity mask so ragged sequences can be packed
into one padded array — SURVEY.md §7 hard part (d)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


class QuantizedAttr(NamedTuple):
    """Quantized integers plus the transform needed to dequantize."""

    values: Array  # int32, same leading shape as input
    min_value: Array  # [..., D] float32 per-frame minimum
    range_value: Array  # [...] float32 scalar per frame (max component range)


def compute_quantization_transform(
    x: Array, mask: Optional[Array] = None
) -> Tuple[Array, Array]:
    """Per-frame min and max-range over valid rows.

    `x`: [..., N, D]; `mask`: [..., N] bool (True = valid row). Returns
    (min [..., D], range [...]) where range is the largest per-component
    extent — Draco uses one scalar range for all components of an attribute.
    """
    if mask is None:
        mn = jnp.min(x, axis=-2)
        mx = jnp.max(x, axis=-2)
    else:
        big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
        m = mask[..., None]
        mn = jnp.min(jnp.where(m, x, big), axis=-2)
        mx = jnp.max(jnp.where(m, x, -big), axis=-2)
    rng = jnp.max(mx - mn, axis=-1)
    # guard degenerate frames (all points equal): range 0 → 1 to avoid div0
    rng = jnp.where(rng <= 0, jnp.ones_like(rng), rng)
    return mn, rng


def quantize(
    x: Array,
    qbits: int,
    *,
    mask: Optional[Array] = None,
    min_value: Optional[Array] = None,
    range_value: Optional[Array] = None,
) -> QuantizedAttr:
    """Uniform range quantization to `qbits` (Draco semantics).

    q = floor((v - min) / delta + 0.5), delta = range / (2^qbits - 1).
    """
    if min_value is None or range_value is None:
        min_value, range_value = compute_quantization_transform(x, mask)
    max_q = (1 << qbits) - 1
    delta = range_value / max_q
    inv = (1.0 / delta)[..., None, None]
    q = jnp.floor((x - min_value[..., None, :]) * inv + 0.5)
    q = jnp.clip(q, 0, max_q).astype(jnp.int32)
    if mask is not None:
        q = jnp.where(mask[..., None], q, 0)
    return QuantizedAttr(q, min_value, range_value)


def dequantize(q: QuantizedAttr, qbits: int) -> Array:
    max_q = (1 << qbits) - 1
    delta = (q.range_value / max_q)[..., None, None]
    return q.min_value[..., None, :] + q.values.astype(jnp.float32) * delta


def corto_quantization_step(x: Array, nvert: int, level: int = 0) -> Array:
    """Corto's bbox/vertex-count quantization-step heuristic.

    Mirrors the *behavior* of crt::Encoder's default step choice
    (deprecated/encoder/dev/src/encoder.cpp:49): the step is the bbox
    diagonal scaled by pow(2, level) over a vertex-density term, so denser
    meshes quantize finer.
    """
    mn = jnp.min(x, axis=-2)
    mx = jnp.max(x, axis=-2)
    diag = jnp.linalg.norm(mx - mn, axis=-1)
    side = diag / jnp.sqrt(2.0)
    # one quantization unit per expected inter-vertex spacing, coarsened 2^level
    return (side / jnp.cbrt(jnp.asarray(nvert, x.dtype))) * (2.0**level) / 20.0


def quantize_step(x: Array, step: Array) -> Array:
    """Fixed-step integer quantization (Corto semantics): round(v / step)."""
    return jnp.round(x / step[..., None, None]).astype(jnp.int32)


def dequantize_step(q: Array, step: Array) -> Array:
    return q.astype(jnp.float32) * step[..., None, None]


def zigzag_encode(v: Array) -> Array:
    """Signed → unsigned interleave: 0,-1,1,-2,2 → 0,1,2,3,4.

    Both Draco (ConvertSignedIntsToSymbols) and Corto (encodeDiff) store
    prediction residuals this way before entropy coding.
    """
    return jnp.where(v >= 0, v.astype(jnp.uint32) << 1, ((-v).astype(jnp.uint32) << 1) - 1)


def zigzag_decode(u: Array) -> Array:
    u = u.astype(jnp.uint32)
    mag = (u >> 1).astype(jnp.int32)
    return jnp.where((u & 1) == 0, mag, -(mag + 1))
