"""Measure the baseline denominator: frames/s of the reference-faithful
NumPy port (pre3_tpu/eval/reference_port.py) on the host CPU.

The reference publishes no frames/s, so the ≥10× speedup
claim needs a measured stand-in: this times the mono_slam.m per-frame loop
port — sequential adaptive RANSAC, per-feature loops, dense EKF — on the
same synthetic sequence family bench.py uses, at the reference operating
point (min 50 measured features, mono_slam.m:91). Steady-state fps
(first-quarter warmup excluded, map at working size) is the number that
replaces the old MATLAB_FPS estimate in bench.py.

Run from the checkout root: python tools/measure_baseline.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.eval.reference_port import run_reference_slam  # noqa: E402

N_FRAMES = 48


def main():
    frames, traj, scene = render_sequence(
        n_frames=N_FRAMES, n_points=400, noise=0.004
    )
    est, times = run_reference_slam(frames, min_measured=50, verbose=True)
    gt = (np.asarray(traj.t) - np.asarray(traj.t[0])) @ np.asarray(traj.r[0])
    ate = float(np.sqrt(np.mean(
        np.sum((est - gt[:len(est)]) ** 2, axis=1)
    )))
    warm = times[N_FRAMES // 4:]
    fps_steady = 1.0 / float(np.mean(warm))
    print(json.dumps({
        "metric": "reference_port_frames_per_s",
        "value": round(fps_steady, 2),
        "unit": "frames/s",
        "extra": {
            "n_frames": N_FRAMES,
            "median_ms": round(1e3 * float(np.median(warm)), 1),
            "p90_ms": round(1e3 * float(np.percentile(warm, 90)), 1),
            "ate_rmse_m": round(ate, 4),
            "host": "single-thread NumPy on this machine",
        },
    }))


if __name__ == "__main__":
    main()
