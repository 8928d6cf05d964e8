"""Accuracy/throughput sweep on the 256-frame bench corridor (VERDICT r2
items 3 & 7): ransac_batch × n_landmarks × max_age, reporting ATE and
ms/frame per config plus the BA backend result for the best few.

This finds the best ATE-per-ms operating point to make the headline
config.

Run from the checkout root: python -u tools/sweep_accuracy.py
"""

import itertools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.ekf.slam import SlamConfig, run_slam  # noqa: E402
from pre3_tpu.eval.trajectory import ate_rmse  # noqa: E402
from pre3_tpu.frontend.pipeline import extract_features_sift  # noqa: E402
from pre3_tpu.geometry.camera import sr4000_camera  # noqa: E402

N_FRAMES = 256


def main():
    cam = sr4000_camera()
    drift = 0.03 * 0.5 * N_FRAMES
    frames, traj, _ = render_sequence(
        n_frames=N_FRAMES, n_points=832, noise=0.004,
        x_range=(-1.8, drift + 1.8),
    )
    intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))
    gt = (np.asarray(traj.t) - np.asarray(traj.t[0])) @ np.asarray(traj.r[0])

    feats = jax.jit(
        lambda i, x, c: jax.vmap(extract_features_sift)(i, x, c)
    )(intensity, xyz, conf)
    jax.block_until_ready(feats.uv)

    grid = list(itertools.product(
        [256, 1024],        # ransac_batch
        [256, 512],         # n_landmarks
        [20, 10_000],       # max_age (10k = never age out)
    ))
    results = []
    for rb, nl, ma in grid:
        cfg = SlamConfig(min_measured=50, ransac_batch=rb, max_age=ma)
        run = jax.jit(lambda f, key, c=cfg, k=nl: run_slam(
            cam, f, key, cfg=c, n_landmarks=k))
        out = run(feats, jax.random.PRNGKey(0))
        _ = float(out.t[-1, 0])  # fetch = the only real completion barrier
        t0 = time.time()
        for r in range(2):
            out = run(feats, jax.random.PRNGKey(r + 1))
            _ = float(out.t[-1, 0])
        ms = 1e3 * (time.time() - t0) / 2 / N_FRAMES
        ate = float(ate_rmse(np.asarray(out.t), gt, align=False))

        # BA on top of this run
        from pre3_tpu.backend.ba import bundle_adjust
        from pre3_tpu.backend.ekf_ba import ba_problem_from_slam
        from pre3_tpu.backend.keyframes import select_keyframes
        from pre3_tpu.backend.smoothing import apply_ba_corrections

        ks = select_keyframes(out.t, out.q, jnp.ones(N_FRAMES, bool),
                              max_keyframes=64)
        prob = ba_problem_from_slam(
            out, np.asarray(ks.indices), np.asarray(ks.valid),
            max_landmarks=512,
        )
        ba_ate = None
        if prob is not None:
            res = bundle_adjust(cam, prob, iters=10)
            sm_t, _ = apply_ba_corrections(
                out.t, out.q, ks.indices, ks.valid, res.kf_t, res.kf_q
            )
            ba_ate = float(ate_rmse(np.asarray(sm_t), gt, align=False))
        row = {"ransac_batch": rb, "n_landmarks": nl, "max_age": ma,
               "ms_per_frame": round(ms, 3), "ate": round(ate, 4),
               "ba_ate": None if ba_ate is None else round(ba_ate, 4),
               "li_mean": round(float(np.asarray(out.stats.n_li).mean()), 1),
               "active_mean": round(
                   float(np.asarray(out.stats.n_active).mean()), 1)}
        results.append(row)
        print(json.dumps(row), flush=True)

    print(json.dumps({"sweep": results}))


if __name__ == "__main__":
    main()
