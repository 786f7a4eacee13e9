"""Point-cloud sequence codec (Morton-ordered delta coding).

Device-side equivalent of the reference's point-cloud path: Corto's
encodePointCloud sorts points by Morton/ZPoint order then delta-codes
(deprecated/unity/Assets/uvol/src/encoder.cpp:238-293, zpoint.h; JS decode
at src/lib/corto.ts:84). Here the Morton sort, quantization, and deltas are
batched device ops over whole frame sequences; the `.crt` point-cloud wire
format is produced by `codecs.corto.encode_crt` so reference decoders can
consume the output.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from uvol_tpu.codecs.corto import decode_crt, encode_crt
from uvol_tpu.ops.morton import morton_order
from uvol_tpu.ops.quantize import quantize


class PointCloudSequenceCodec:
    """Batch: quantize + Morton-sort on device; serialize per frame."""

    def __init__(self, position_bits: int = 11):
        self.position_bits = position_bits

        @jax.jit
        def _device_stage(pos):  # [F, N, 3]
            q = quantize(pos, self.position_bits)
            perm = morton_order(q.values)
            sorted_pos = jnp.take_along_axis(pos, perm[..., None], axis=-2)
            return sorted_pos, perm

        self._device_stage = _device_stage

    def encode(self, positions: np.ndarray, **attrs) -> List[bytes]:
        """positions [F, N, 3] float32 → per-frame `.crt` point clouds."""
        sorted_pos, perm = self._device_stage(jnp.asarray(positions))
        sorted_pos = np.asarray(sorted_pos)
        perm = np.asarray(perm)
        blobs = []
        for i in range(len(sorted_pos)):
            kwargs = {}
            for name, arr in attrs.items():
                kwargs[name] = np.asarray(arr[i])[perm[i]]
            blobs.append(
                encode_crt(
                    sorted_pos[i],
                    np.zeros((0, 3), np.int64),
                    **kwargs,
                )
            )
        return blobs

    def decode(self, blobs: List[bytes]) -> List[np.ndarray]:
        return [decode_crt(b).attributes["position"] for b in blobs]
