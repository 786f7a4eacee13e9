"""Polynomial-trajectory compression for fixed-topology frame groups.

Device-side re-design of the reference's experimental encoder
(deprecated/encoder/dev/encoder.py:30-366): frames with identical vertex
count are grouped and each vertex's (x, y, z) trajectory over the group is
fit with a degree-4 polynomial; the mesh is then stored once plus 15
coefficients per vertex (the reference stores them as xPos/yPos/zPos PLY
attributes consumed by its custom corto fork, main.cpp:189-202).

The reference fits with one `np.polyfit` call per vertex per axis
(encoder.py:112 — O(N) Python loop); here the whole group is ONE batched
least-squares solve on device: the Vandermonde normal equations are shared
across all vertices, so coefficients = solve(VᵀV, Vᵀ·positions) with
positions [frames, N·3] — a single matmul pair.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


@dataclasses.dataclass
class TrajectoryGroup:
    coefficients: np.ndarray  # [degree+1, N, 3]
    frame_count: int
    degree: int

    def sample(self, frame_index) -> np.ndarray:
        """Reconstruct positions at (possibly fractional) frame indices."""
        t = np.asarray(frame_index, np.float32) / max(self.frame_count - 1, 1)
        powers = np.stack([t**k for k in range(self.degree + 1)])
        return np.einsum("k,knc->nc", powers, self.coefficients)


def _vty(positions: Array, degree: int) -> Array:
    """The only big matmul of the fit: Vᵀ·y, [D+1, F] × [F, N·3]."""
    f, n, c = positions.shape
    t = jnp.linspace(0.0, 1.0, f)
    vand = jnp.stack([t**k for k in range(degree + 1)], axis=1)  # [F, D+1]
    y = positions.reshape(f, n * c)
    # HIGHEST precision: a default-precision f32 matmul may run in bf16
    # passes or TF32, which costs ~3 digits — too lossy for the
    # normal-equation RHS
    return jnp.dot(
        vand.T, y,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


_vty_jit = jax.jit(_vty, static_argnums=1)


def fit_trajectories(positions: np.ndarray, degree: int = 4) -> TrajectoryGroup:
    """positions [F, N, 3] (fixed topology) → per-vertex polynomial fit.

    The O(F·N) matmul Vᵀy runs on device; the (D+1)×(D+1) normal-equation
    solve runs on host in float64 — VᵀV is ill-conditioned at degree 4, and
    a float32 solve loses ~3 digits even on exactly-polynomial data.
    """
    f, n, c = positions.shape
    if f <= degree:
        degree = max(f - 1, 0)
    vty = np.asarray(
        _vty_jit(jnp.asarray(positions, jnp.float32), degree), np.float64
    )
    t = np.linspace(0.0, 1.0, f)
    vand = np.stack([t**k for k in range(degree + 1)], axis=1)
    vtv = vand.T @ vand  # tiny, float64
    coef = np.linalg.solve(vtv, vty).astype(np.float32)
    return TrajectoryGroup(
        coefficients=coef.reshape(degree + 1, n, c), frame_count=f, degree=degree
    )


def group_fixed_topology(frame_counts: np.ndarray) -> list:
    """Split a sequence into runs of equal vertex count (the reference
    groups same-vertex-count PLY frames, encoder.py:30-60)."""
    groups = []
    start = 0
    for i in range(1, len(frame_counts) + 1):
        if i == len(frame_counts) or frame_counts[i] != frame_counts[start]:
            groups.append((start, i))
            start = i
    return groups


def reconstruction_error(
    positions: np.ndarray, group: TrajectoryGroup
) -> float:
    recon = np.stack(
        [group.sample(k) for k in range(group.frame_count)]
    )
    return float(np.abs(recon - positions).max())
