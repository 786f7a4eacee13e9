"""Octahedral normal codec + normal estimation (JAX, batched).

Re-expresses the reference's two normal pipelines:
  - Corto's NormalAttr octahedral quantization with DIFF/ESTIMATED/BORDER
    prediction, incl. normal estimation from faces
    (deprecated/encoder/dev/src/normal_attribute.cpp:61-303,
     src/lib/corto.ts:470-671)
  - Draco's octahedron transform used by its normal attribute codec
    (math follows the published Draco bitstream semantics: fold the
    lower hemisphere into the octahedron diamond, quantize (u,v)).

Encode/decode are elementwise over vertices → pure elementwise work, `vmap` over
frames for sequence throughput.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def octahedral_encode(n: Array, qbits: int) -> Array:
    """Unit (or unnormalized) normals [..., 3] → quantized (s, t) int32 [..., 2].

    Uses the octahedron parameterization with lower-hemisphere fold:
      scale by 1/(|x|+|y|+|z|); if z < 0: (u,v) = ((1-|y|)·sgn x, (1-|x|)·sgn y)
    then uniform quantization of (u,v) ∈ [-1,1] onto [0, max_value] where
    max_value = 2^qbits - 2 (even, so the center is exact — Draco's choice).
    """
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    abs_sum = jnp.abs(x) + jnp.abs(y) + jnp.abs(z)
    safe = jnp.where(abs_sum > 0, abs_sum, 1.0)
    xs, ys, zs = x / safe, y / safe, z / safe

    sign_x = jnp.where(xs >= 0, 1.0, -1.0)
    sign_y = jnp.where(ys >= 0, 1.0, -1.0)
    u = jnp.where(zs >= 0, xs, (1.0 - jnp.abs(ys)) * sign_x)
    v = jnp.where(zs >= 0, ys, (1.0 - jnp.abs(xs)) * sign_y)

    max_value = (1 << qbits) - 2
    s = jnp.floor((u + 1.0) * 0.5 * max_value + 0.5).astype(jnp.int32)
    t = jnp.floor((v + 1.0) * 0.5 * max_value + 0.5).astype(jnp.int32)
    return jnp.stack([s, t], axis=-1)


def octahedral_decode(st: Array, qbits: int) -> Array:
    """Quantized (s, t) → unit normals [..., 3] (inverse of the fold)."""
    max_value = (1 << qbits) - 2
    u = st[..., 0].astype(jnp.float32) * (2.0 / max_value) - 1.0
    v = st[..., 1].astype(jnp.float32) * (2.0 / max_value) - 1.0
    z = 1.0 - jnp.abs(u) - jnp.abs(v)
    below = z < 0
    sign_u = jnp.where(u >= 0, 1.0, -1.0)
    sign_v = jnp.where(v >= 0, 1.0, -1.0)
    x = jnp.where(below, (1.0 - jnp.abs(v)) * sign_u, u)
    y = jnp.where(below, (1.0 - jnp.abs(u)) * sign_v, v)
    n = jnp.stack([x, y, z], axis=-1)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(norm > 0, norm, 1.0)


def estimate_normals(positions: Array, faces: Array) -> Array:
    """Area-weighted vertex normals from faces (scatter-add, jittable).

    Equivalent of Corto's estimateNormals (normal_attribute.cpp:40): each
    face's cross-product normal is accumulated onto its three corners.
    positions: [N, 3] float32; faces: [F, 3] int32 (may contain padding
    rows of -1, which are dropped via masking).
    """
    valid = (faces[..., 0] >= 0)[..., None]
    f = jnp.maximum(faces, 0)
    p0 = positions[f[..., 0]]
    p1 = positions[f[..., 1]]
    p2 = positions[f[..., 2]]
    fn = jnp.cross(p1 - p0, p2 - p0) * valid
    out = jnp.zeros_like(positions)
    for k in range(3):
        out = out.at[f[..., k]].add(fn)
    norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
    return out / jnp.where(norm > 0, norm, 1.0)
