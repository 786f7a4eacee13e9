"""Plot fitted per-vertex polynomial trajectories to a PNG.

Counterpart of the reference's motion visualizer
(deprecated/encoder/dev/Visualize_Motion.py:12-50): fit degree-4
trajectories over a frame window (models/trajectory.py, the device-side
polyfit of deprecated/encoder/dev/encoder.py:112) and draw a 3-D sample
of the vertex paths. Headless (Agg backend).

  python examples/visualize_motion.py [out.png] [--vertices 40]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="/tmp/uvol_motion.png")
    ap.add_argument("--vertices", type=int, default=40)
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from uvol_tpu.models.trajectory import fit_trajectories

    # synthetic breathing-sphere clip (same shape of motion the reference
    # fits: smooth per-vertex paths over a fixed-topology window)
    r = np.random.default_rng(0)
    n = 400
    theta = r.uniform(0, np.pi, n)
    phi = r.uniform(0, 2 * np.pi, n)
    base = np.stack(
        [
            np.sin(theta) * np.cos(phi),
            np.sin(theta) * np.sin(phi),
            np.cos(theta),
        ],
        -1,
    )
    t = np.linspace(0, 1, args.frames)[:, None, None]
    clip = base[None] * (1.0 + 0.15 * np.sin(2 * np.pi * t)) + 0.05 * t * base[
        None
    ] ** 2

    group = fit_trajectories(clip.astype(np.float32))
    dense = np.stack(
        [group.sample(f) for f in np.linspace(0, args.frames - 1, 120)]
    )

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    sel = r.choice(n, size=min(args.vertices, n), replace=False)
    for v in sel:
        ax.plot(dense[:, v, 0], dense[:, v, 1], dense[:, v, 2], lw=0.8)
    ax.scatter(*clip[0, sel].T, s=6, c="k", label="frame 0")
    ax.set_title(
        f"degree-4 vertex trajectories ({len(sel)} of {n} vertices, "
        f"{args.frames} frames)"
    )
    ax.legend(loc="upper left")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    err = float(
        np.abs(
            np.stack([group.sample(f) for f in range(args.frames)]) - clip
        ).max()
    )
    print(f"wrote {args.out}; max reconstruction error {err:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
