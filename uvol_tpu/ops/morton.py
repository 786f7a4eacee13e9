"""Morton (Z-order) codes for point-cloud coding (JAX).

Equivalent of Corto's ZPoint sort used by its point-cloud path
(deprecated/unity/Assets/uvol/src/encoder.cpp:238-293, zpoint.h): quantized
(x, y, z) are bit-interleaved and sorted so nearby points become neighbors
in the stream, making successive-difference coding effective.

Bit interleaving is pure elementwise integer work; sorting uses XLA's batched sort.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def _part1by2_10(x: Array) -> Array:
    """Spread the low 10 bits of x so there are 2 zeros between each bit."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(q: Array) -> Array:
    """[..., 3] int coords (≤10 bits each) → uint32 Morton code."""
    return (
        _part1by2_10(q[..., 0])
        | (_part1by2_10(q[..., 1]) << 1)
        | (_part1by2_10(q[..., 2]) << 2)
    )


def morton63(q: Array) -> Tuple[Array, Array, Array]:
    """[..., 3] int coords (≤21 bits each) → (top, mid, lo) uint32 Morton
    key words, compared lexicographically (z > y > x significance like
    morton30: z in the highest interleave position of every triple).

    63 interleaved bits = 3 (coordinate bit 20 of z,y,x) + 30 (bits
    10..19) + 30 (bits 0..9); three words avoid x64 mode.
    """
    lo = morton30(q & 0x3FF)
    mid = morton30((q >> 10) & 0x3FF)
    b20 = (q >> 20) & 1
    top = (b20[..., 2] << 2) | (b20[..., 1] << 1) | b20[..., 0]
    return top.astype(jnp.uint32), mid, lo


def morton_order(q: Array) -> Array:
    """Permutation sorting points by Morton code (supports 21-bit coords).

    q: [..., N, 3] int32 quantized coordinates → [..., N] int32 argsort.
    """
    top, mid, lo = morton63(q)
    idx = jax.lax.broadcasted_iota(jnp.int32, q.shape[:-1], len(q.shape) - 2)
    _, _, _, perm = jax.lax.sort((top, mid, lo, idx), num_keys=3)
    return perm


def invert_permutation(perm: Array) -> Array:
    """inv[perm[i]] = i, batched over leading axes."""
    n = perm.shape[-1]
    idx = jax.lax.broadcasted_iota(jnp.int32, perm.shape, len(perm.shape) - 1)
    inv = jnp.zeros_like(perm)
    return jnp.put_along_axis(inv, perm, idx, axis=-1, inplace=False)
