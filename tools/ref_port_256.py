"""Head-to-head denominator: run the reference-faithful NumPy port on the
EXACT 256-frame bench corridor (same renderer call as bench.py) and report
its ATE + steady-state fps. This is the apples-to-apples accuracy anchor
the engine's slam_ate_rmse_m must meet or beat (VERDICT r2 item 2).

Run from the checkout root: JAX_PLATFORMS=cpu python -u tools/ref_port_256.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.eval.reference_port import run_reference_slam  # noqa: E402

N_FRAMES = 256


def main():
    drift = 0.03 * 0.5 * N_FRAMES
    frames, traj, _ = render_sequence(
        n_frames=N_FRAMES, n_points=832, noise=0.004,
        x_range=(-1.8, drift + 1.8),
    )
    est, times = run_reference_slam(frames, min_measured=50, verbose=True)
    gt = (np.asarray(traj.t) - np.asarray(traj.t[0])) @ np.asarray(traj.r[0])
    ate = float(np.sqrt(np.mean(np.sum((est - gt[:len(est)]) ** 2, axis=1))))
    warm = times[N_FRAMES // 4:]
    print(json.dumps({
        "metric": "ref_port_256",
        "ate_rmse_m": round(ate, 4),
        "fps_steady": round(1.0 / float(np.mean(warm)), 2),
        "median_ms": round(1e3 * float(np.median(warm)), 1),
        "n_frames": N_FRAMES,
    }))


if __name__ == "__main__":
    main()
