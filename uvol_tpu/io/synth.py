"""Deterministic synthetic capture clips at the reference liam track's shape.

The reference sample (`example/public/liam`) is 250 frames at 30 fps of
a ~26k-vertex, ~52k-face textured scan with 1024² baseColor textures,
encoded at qp11/qt10/qn8 in 5-frame KTX2 segments. This module makes a
clip of that shape from a seed, so the encoder, the players and the
device stages can run at full width without the corpus:

- geometry: a torus of `rings` x `segments` vertices (249 x 105 =
  26,145 vertices, 52,290 triangles) whose surface deforms non-rigidly
  over time, with per-corner UVs (a seam where the parameter wraps) and
  per-vertex normals;
- texture: 1024² RGB frames with smooth gradients, hard-edged moving
  shapes and stripes that change every frame.

`write_clip` writes OBJ and PNG files plus an encoder config.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np

#: torus grid at the liam vertex count: 249 * 105 = 26,145 vertices
RINGS = 249
SEGMENTS = 105
TEXTURE_SIZE = 1024


@dataclasses.dataclass
class MeshFrame:
    positions: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32 position indices
    uvs: np.ndarray  # [(R+1)*(S+1), 2] float32
    uv_faces: np.ndarray  # [F, 3] int32 per-corner UV indices
    normals: np.ndarray  # [V, 3] float32 unit normals (normal index = vertex)


def _params(seed: int) -> Dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    return {
        "wave_k": r.integers(2, 7, 3),  # angular wave numbers
        "wave_amp": r.uniform(0.03, 0.08, 3),
        "wave_speed": r.uniform(0.5, 2.0, 3),
        "phase": r.uniform(0, 2 * np.pi, 3),
        "shapes": r.uniform(0, 1, (12, 7)),  # x, y, size, rgb, speed
        "tint": r.uniform(0.2, 1.0, (2, 3)),
    }


def _topology(rings: int, segments: int) -> Tuple[np.ndarray, np.ndarray]:
    """Torus faces over wrapped vertex indices, and the same faces over
    the (rings+1) x (segments+1) UV grid (UVs do not wrap: a seam)."""
    i, j = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    i1, j1 = i + 1, j + 1
    v = lambda a, b: (a % rings) * segments + (b % segments)  # noqa: E731
    t = lambda a, b: a * (segments + 1) + b  # noqa: E731
    faces = np.concatenate(
        [
            np.stack([v(i, j), v(i1, j), v(i1, j1)], -1).reshape(-1, 3),
            np.stack([v(i, j), v(i1, j1), v(i, j1)], -1).reshape(-1, 3),
        ]
    )
    uv_faces = np.concatenate(
        [
            np.stack([t(i, j), t(i1, j), t(i1, j1)], -1).reshape(-1, 3),
            np.stack([t(i, j), t(i1, j1), t(i, j1)], -1).reshape(-1, 3),
        ]
    )
    return faces.astype(np.int32), uv_faces.astype(np.int32)


def mesh_frame(
    frame: int, seed: int = 0, rings: int = RINGS, segments: int = SEGMENTS,
    fps: float = 30.0,
) -> MeshFrame:
    """One deformed torus frame. Deterministic in (frame, seed)."""
    p = _params(seed)
    t = frame / fps
    u = 2 * np.pi * np.arange(rings) / rings
    v = 2 * np.pi * np.arange(segments) / segments
    uu, vv = np.meshgrid(u, v, indexing="ij")
    # non-rigid: travelling waves in the tube radius and the centre line
    tube = 0.35 * (
        1.0
        + p["wave_amp"][0]
        * np.sin(p["wave_k"][0] * uu + p["wave_speed"][0] * t + p["phase"][0])
        + p["wave_amp"][1]
        * np.sin(p["wave_k"][1] * vv - p["wave_speed"][1] * t + p["phase"][1])
    )
    major = 1.0 + p["wave_amp"][2] * np.sin(
        p["wave_k"][2] * uu + p["wave_speed"][2] * t + p["phase"][2]
    )
    twist = 0.3 * np.sin(0.7 * t) * np.cos(uu)
    x = (major + tube * np.cos(vv + twist)) * np.cos(uu)
    y = (major + tube * np.cos(vv + twist)) * np.sin(uu)
    z = tube * np.sin(vv + twist) + 0.1 * np.sin(uu * 2 + t)
    positions = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    faces, uv_faces = _topology(rings, segments)
    gu, gv = np.meshgrid(
        np.linspace(0, 1, rings + 1), np.linspace(0, 1, segments + 1),
        indexing="ij",
    )
    uvs = np.stack([gu, gv], -1).reshape(-1, 2).astype(np.float32)
    # area-weighted vertex normals of the deformed surface
    a, b, c = (positions[faces[:, k]].astype(np.float64) for k in range(3))
    fn = np.cross(b - a, c - a)
    acc = np.zeros((len(positions), 3))
    for k in range(3):
        np.add.at(acc, faces[:, k], fn)
    normals = acc / np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
    return MeshFrame(positions, faces, uvs, uv_faces, normals.astype(np.float32))


def texture_frame(
    frame: int, seed: int = 0, size: int = TEXTURE_SIZE
) -> np.ndarray:
    """[size, size, 3] uint8: gradients, moving hard-edged discs and
    boxes, and stripes. Deterministic in (frame, seed)."""
    p = _params(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    t = frame / 30.0
    g = (xx + 0.5 * yy)[..., None]
    img = (1 - g) * p["tint"][0] + g * p["tint"][1]  # smooth gradient
    stripes = (np.sin(40.0 * (xx + yy) + 3.0 * t) > 0.6)[..., None]
    img = np.where(stripes, img * 0.6, img)
    for k, (sx, sy, sz, r, gc, bc, sp) in enumerate(p["shapes"]):
        cx = (sx + 0.05 * np.sin(t * (1 + sp) + k)) % 1.0
        cy = (sy + 0.05 * np.cos(t * (1 + sp) + k)) % 1.0
        rad = 0.03 + 0.08 * sz
        if k % 2:
            inside = (xx - cx) ** 2 + (yy - cy) ** 2 < rad**2
        else:
            inside = (np.abs(xx - cx) < rad) & (np.abs(yy - cy) < 0.6 * rad)
        img = np.where(inside[..., None], np.float32([r, gc, bc]), img)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_obj(path: str, m: MeshFrame) -> None:
    """OBJ with v/vt/vn per corner (normal index = position index)."""
    lines = ["v %.6f %.6f %.6f" % tuple(r) for r in m.positions.tolist()]
    lines += ["vt %.6f %.6f" % tuple(r) for r in m.uvs.tolist()]
    lines += ["vn %.6f %.6f %.6f" % tuple(r) for r in m.normals.tolist()]
    f = m.faces + 1
    ft = m.uv_faces + 1
    lines += [
        "f %d/%d/%d %d/%d/%d %d/%d/%d"
        % (a, ta, a, b, tb, b, c, tc, c)
        for (a, b, c), (ta, tb, tc) in zip(f.tolist(), ft.tolist())
    ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_clip(
    root: str, frames: int = 30, seed: int = 0,
    tex_size: int = TEXTURE_SIZE, **config
) -> str:
    """Write `frames` OBJ + PNG frames under `root` and an encoder config
    (the `encoder_cli` template plus `config` overrides); returns the
    config path."""
    from uvol_tpu.encoder_cli import TEMPLATE
    from uvol_tpu.io.png import write_png

    os.makedirs(os.path.join(root, "OBJ"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(frames):
        write_obj(os.path.join(root, "OBJ", f"{i:05d}.obj"), mesh_frame(i, seed))
        write_png(
            os.path.join(root, "images", f"{i:05d}.png"),
            texture_frame(i, seed, tex_size),
        )
    cfg = dict(TEMPLATE)
    cfg.update(
        name="synth",
        OBJFilesPath=os.path.join(root, "OBJ", "[#####].obj"),
        ImagesPath=os.path.join(root, "images", "[#####].png"),
        OutputDirectory=os.path.join(root, "output"),
    )
    cfg.update(config)
    path = os.path.join(root, "config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh, indent=2)
    return path
