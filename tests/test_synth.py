"""Synthetic liam-shaped clips: determinism, shape and the files written."""

import json
import os

import numpy as np

from uvol_tpu.io import synth
from uvol_tpu.io.png import read_png


def test_mesh_frames_are_deterministic_liam_shaped_and_deform():
    a, b = synth.mesh_frame(3, seed=1), synth.mesh_frame(3, seed=1)
    for f in ("positions", "faces", "uvs", "uv_faces", "normals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.positions.shape == (26145, 3) and a.faces.shape == (52290, 3)
    assert a.uv_faces.shape == a.faces.shape
    assert a.faces.max() == 26144 and a.uv_faces.max() < len(a.uvs)
    np.testing.assert_allclose(np.linalg.norm(a.normals, axis=1), 1.0, atol=1e-5)
    # non-rigid: the inter-frame motion varies across the surface
    c = synth.mesh_frame(4, seed=1)
    motion = np.linalg.norm(c.positions - a.positions, axis=1)
    assert motion.std() > 0.1 * motion.mean() > 0
    assert not np.array_equal(synth.mesh_frame(3, seed=2).positions, a.positions)


def test_texture_frames_are_deterministic_and_structured():
    t0 = synth.texture_frame(0, seed=0, size=128)
    np.testing.assert_array_equal(t0, synth.texture_frame(0, seed=0, size=128))
    assert t0.shape == (128, 128, 3) and t0.dtype == np.uint8
    assert not np.array_equal(t0, synth.texture_frame(1, seed=0, size=128))
    dx = np.abs(np.diff(t0.astype(np.int32), axis=1))
    assert t0.std() > 10 and np.median(dx) < 2 and dx.max() > 50


def test_write_clip(tmp_path):
    root = str(tmp_path)
    cfg_path = synth.write_clip(
        root, frames=2, seed=0, tex_size=64, KTX2_BATCH_SIZE=5
    )
    with open(cfg_path) as f:
        cfg = json.load(f)
    assert cfg["KTX2_BATCH_SIZE"] == 5 and cfg["name"] == "synth"
    assert sorted(os.listdir(os.path.join(root, "OBJ"))) == ["00000.obj", "00001.obj"]
    img = read_png(os.path.join(root, "images", "00001.png"))
    np.testing.assert_array_equal(img, synth.texture_frame(1, 0, 64))
    from uvol_tpu.encoder_cli import load_obj

    m = synth.mesh_frame(0, 0)
    v, u, faces = load_obj(os.path.join(root, "OBJ", "00000.obj"))
    np.testing.assert_allclose(v, m.positions, atol=1e-6)
    np.testing.assert_array_equal(faces, m.faces)
    assert u.shape == (26145, 2)
