"""End-to-end demo: synthetic SR4000 sequence → EKF-SLAM → keyframe BA →
plots + map export.

Run:  python examples/run_synthetic_slam.py [out_dir]

This is the full-engine walkthrough (BASELINE configs #1-#4 in one go):
renders a ground-truth scene, runs the jitted SLAM pipeline, refines
keyframes with Schur-complement BA, and writes trajectory/stat plots and
a PLY map dump.
"""

import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.backend.ba import bundle_adjust
from pre3_tpu.backend.keyframes import select_keyframes
from pre3_tpu.backend.tracks import make_ba_problem_from_tracks
from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.slam import run_slam
from pre3_tpu.eval.trajectory import ate_rmse, rpe_translation
from pre3_tpu.eval.viz import plot_slam_stats, plot_trajectory
from pre3_tpu.frontend.pipeline import extract_features_sift
from pre3_tpu.geometry.camera import sr4000_camera
from pre3_tpu.vo.dead_reckoning import run_sequence


def main(out_dir: str | None = None, n_frames: int = 32):
    out_dir = out_dir or tempfile.mkdtemp(prefix="pre3_demo_")
    cam = sr4000_camera()
    print(f"backend: {jax.default_backend()}")
    t0 = time.time()
    frames, traj, scene = render_sequence(
        n_frames=n_frames, n_points=400, noise=0.004
    )
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    print(f"rendered {n_frames} frames in {time.time() - t0:.1f}s")

    t0 = time.time()
    feats = [
        extract_features_sift(
            jnp.asarray(f.intensity), jnp.asarray(f.xyz),
            jnp.asarray(f.confidence),
        )
        for f in frames
    ]
    feats = jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
    print(f"features in {time.time() - t0:.1f}s")

    # config #1: VO dead reckoning
    t0 = time.time()
    vo = run_sequence(feats, jax.random.PRNGKey(0), batch=1024)
    print(
        f"VO: {time.time() - t0:.1f}s, "
        f"ATE {ate_rmse(np.asarray(vo.t), gt, align=False):.4f} m"
    )

    # configs #2/#3: EKF-SLAM
    t0 = time.time()
    out = run_slam(cam, feats, jax.random.PRNGKey(1), n_landmarks=64)
    slam_ate = ate_rmse(np.asarray(out.t), gt, align=False)
    print(
        f"SLAM: {time.time() - t0:.1f}s, ATE {slam_ate:.4f} m, "
        f"RPE {rpe_translation(np.asarray(out.t), gt):.4f} m"
    )

    # config #4: keyframes + BA on the filter-vetted observation records
    from pre3_tpu.backend.ekf_ba import ba_problem_from_slam

    ks = select_keyframes(out.t, out.q, jnp.ones(n_frames, bool),
                          max_keyframes=10)
    idx = ks.indices
    prob = ba_problem_from_slam(out, np.asarray(idx), np.asarray(ks.valid))
    res = bundle_adjust(cam, prob, iters=10)
    print(
        f"BA: {int(ks.n)} keyframes, cost "
        f"{float(res.cost[0]):.3f} -> {float(res.cost[-1]):.3f}"
    )

    # propagate keyframe corrections to every frame
    from pre3_tpu.backend.smoothing import apply_ba_corrections

    sm_t, sm_q = apply_ba_corrections(
        out.t, out.q, idx, ks.valid, res.kf_t, res.kf_q
    )
    sm_ate = ate_rmse(np.asarray(sm_t), gt, align=False)
    print(f"smoothed full-trajectory ATE: {sm_ate:.4f} m")

    plot_trajectory(f"{out_dir}/trajectory.png", np.asarray(out.t), gt,
                    title=f"EKF-SLAM (ATE {slam_ate:.3f} m)")
    plot_slam_stats(f"{out_dir}/stats.png", out.stats)
    from pre3_tpu.eval.viz import export_ply

    export_ply(f"{out_dir}/ba_map.ply", np.asarray(res.points))
    print(f"wrote {out_dir}/trajectory.png, stats.png, ba_map.ply")


if __name__ == "__main__":
    main(*sys.argv[1:2])
