"""Spare-capacity demonstration (VERDICT r4 #8): batched multi-sequence
SLAM throughput.

One 176×144 SLAM stream is a small program for an accelerator. This tool
vmaps the WHOLE jitted pipeline (SIFT frontend + EKF scan) over B
independent corridor sequences — distinct scenes AND trajectories — and
measures aggregate frames/s at B ∈ {1, 4, 8, 16}: what the spare
capacity buys when the deployment has many concurrent streams (multi-
robot, multi-sensor, offline reprocessing).

Usage: python tools/measure_batch.py [n_frames] [batches...]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.slam import SlamConfig, run_slam
from pre3_tpu.eval.trajectory import ate_rmse
from pre3_tpu.frontend.pipeline import extract_features_sift
from pre3_tpu.geometry.camera import sr4000_camera

N_LANDMARKS = 256
CFG = SlamConfig(min_measured=50, max_update_slots=96)


def main(n_frames=256, batches=(1, 4, 8, 16), n_landmarks=N_LANDMARKS):
    cam = sr4000_camera()
    print("backend:", jax.default_backend(), flush=True)
    drift = 0.03 * 0.5 * n_frames
    b_max = max(batches)
    t0 = time.time()
    seqs = []
    for b in range(b_max):
        frames, traj, _ = render_sequence(
            n_frames=n_frames, n_points=832, noise=0.004,
            x_range=(-1.8, drift + 1.8),
            scene_seed=b, traj_seed=100 + b,
        )
        seqs.append((
            np.stack([f.intensity for f in frames]),
            np.nan_to_num(np.stack([f.xyz for f in frames])),
            np.stack([f.confidence for f in frames]),
            (traj.t - traj.t[0]) @ traj.r[0],
        ))
    print(f"rendered {b_max}x{n_frames} frames in {time.time()-t0:.0f}s",
          flush=True)
    intensity = jnp.asarray(np.stack([s[0] for s in seqs]))
    xyz = jnp.asarray(np.stack([s[1] for s in seqs]))
    conf = jnp.asarray(np.stack([s[2] for s in seqs]))
    gts = [s[3] for s in seqs]

    def pipe_fn(i, x, c, keys):
        # frontend: lax.map over the SEQUENCE axis, each step the
        # full-sequence vmapped extractor (the proven B=1 working set —
        # a flat vmap over B×F frames OOMs at B ≥ 4, and mapping over
        # frames inside vmap(B) hit device faults at B = 8); the EKF
        # scan then vmaps over sequences (per-step work batches across
        # sequences, which is the capacity story being measured)
        fs = jax.lax.map(
            lambda t: jax.vmap(extract_features_sift)(*t), (i, x, c)
        )
        return jax.vmap(
            lambda f, k: run_slam(
                cam, f, k, cfg=CFG, n_landmarks=n_landmarks
            )
        )(fs, keys)

    for b in batches:
        pipe = jax.jit(pipe_fn)
        keys = jax.random.split(jax.random.PRNGKey(0), b)
        args = (intensity[:b], xyz[:b], conf[:b], keys)
        out = pipe(*args)  # compile + warm
        jax.block_until_ready(out.t)
        np.asarray(out.t[0, -1])
        reps = 3
        t0 = time.time()
        for r in range(reps):
            out = pipe(intensity[:b], xyz[:b], conf[:b],
                       jax.random.split(jax.random.PRNGKey(r + 1), b))
            jax.block_until_ready(out.t)
            np.asarray(out.t[0, -1])
        dt = (time.time() - t0) / reps
        ates = [
            float(ate_rmse(np.asarray(out.t[i]), gts[i], align=False))
            for i in range(b)
        ]
        print(
            f"B={b:2d}: aggregate {b * n_frames / dt:8.1f} frames/s "
            f"({n_frames / dt:6.1f} per-seq)  ate mean "
            f"{np.mean(ates):.3f} max {np.max(ates):.3f}", flush=True,
        )


if __name__ == "__main__":
    # usage: measure_batch.py [n_frames] [K] [batches...]
    nf = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    k = int(sys.argv[2]) if len(sys.argv) > 2 else N_LANDMARKS
    bs = tuple(int(x) for x in sys.argv[3:]) or (1, 4, 8, 16)
    main(nf, bs, k)
