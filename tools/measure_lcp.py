"""Measure the keyframe-to-keyframe loop-closure pose factors
(BaProblem.lcp_*, VERDICT r4 #3) on the bench loop scene and a new
multi-loop scene (2 out-and-back passes).

For each scene: run the headline SLAM pipeline, build the BA problem
(which now mines lcp factors from filter re-acquisitions), and run BA
with the lcp factors ON vs stripped OFF. Reports SLAM ATE, both post-BA
ATEs, and the mined factor count. Runs on the default backend, one
measurement at a time.

Usage: python tools/measure_lcp.py [n_frames]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.backend.ba import bundle_adjust
from pre3_tpu.backend.ekf_ba import ba_problem_from_slam
from pre3_tpu.backend.keyframes import select_keyframes
from pre3_tpu.backend.smoothing import apply_ba_corrections
from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.slam import SlamConfig, run_slam
from pre3_tpu.eval.trajectory import ate_rmse
from pre3_tpu.frontend.pipeline import extract_features_sift
from pre3_tpu.geometry.camera import sr4000_camera

N_LANDMARKS = 256
CFG = SlamConfig(min_measured=50, max_update_slots=96)


def run_scene(cam, pipe, name, n_frames, loop, n_points, x_range):
    frames, traj, _ = render_sequence(
        n_frames=n_frames, n_points=n_points, noise=0.004,
        x_range=x_range, loop=loop,
    )
    intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))
    gt = (traj.t - traj.t[0]) @ traj.r[0]

    t0 = time.time()
    out = pipe(intensity, xyz, conf, jax.random.PRNGKey(0))
    jax.block_until_ready(out.t)
    slam_ate = ate_rmse(np.asarray(out.t), gt, align=False)
    print(f"[{name}] slam ate {slam_ate:.4f} m  ({time.time()-t0:.1f}s)",
          flush=True)

    ks = select_keyframes(
        out.t, out.q, jnp.ones(n_frames, bool), max_keyframes=64
    )
    prob = ba_problem_from_slam(
        out, np.asarray(ks.indices), np.asarray(ks.valid),
        max_landmarks=512,
    )
    n_lcp = 0 if prob.lcp_i is None else int(prob.lcp_i.shape[0])
    n_lclm = int(np.asarray(prob.lc_lm).sum())
    print(f"[{name}] filter-event lcp factors: {n_lcp}  "
          f"lc landmarks: {n_lclm}", flush=True)

    # keyframe-rematch loop detector (backend/loop_detect.py)
    from pre3_tpu.backend.loop_detect import (
        merge_lcp, mine_keyframe_loop_closures,
    )
    from pre3_tpu.frontend.pipeline import extract_features_sift as _ef

    kf_idx = np.asarray(ks.indices)
    kf_feats = jax.jit(jax.vmap(_ef))(
        intensity[kf_idx], xyz[kf_idx], conf[kf_idx]
    )
    mined = mine_keyframe_loop_closures(
        kf_feats, np.asarray(out.t)[kf_idx], np.asarray(out.q)[kf_idx],
        np.asarray(ks.valid),
    )
    n_mined = 0 if mined is None else len(mined[0])
    print(f"[{name}] keyframe-rematch lcp factors: {n_mined}", flush=True)
    prob_full = merge_lcp(prob, mined)
    for tag, p in (
        ("lcp OFF        ", prob._replace(
            lcp_i=None, lcp_j=None, lcp_t=None, lcp_q=None, lcp_w=None)),
        ("lcp events     ", prob),
        ("lcp ev+rematch ", prob_full),
    ):
        res = bundle_adjust(cam, p, iters=10)
        sm_t, _ = apply_ba_corrections(
            out.t, out.q, ks.indices, ks.valid, res.kf_t, res.kf_q
        )
        ba_ate = ate_rmse(np.asarray(sm_t), gt, align=False)
        print(f"[{name}] {tag} post-BA ate {float(ba_ate):.4f} m "
              f"(cost {float(res.cost[0]):.3f} -> "
              f"{float(res.cost[-1]):.3f})", flush=True)
    if prob_full.lcp_i is not None:
        # report the factor endpoints for the record
        print(f"[{name}] all lcp pairs:",
              list(zip(np.asarray(prob_full.lcp_i).tolist(),
                       np.asarray(prob_full.lcp_j).tolist())), flush=True)


def main(n_frames=256):
    cam = sr4000_camera()
    print("backend:", jax.default_backend(), flush=True)

    @jax.jit
    def pipe(intensity, xyz, conf, key):
        fs = jax.vmap(extract_features_sift)(intensity, xyz, conf)
        return run_slam(cam, fs, key, cfg=CFG, n_landmarks=N_LANDMARKS)

    loop_drift = 0.03 * 0.5 * (n_frames // 2)
    run_scene(cam, pipe, "loop x1", n_frames, True, 600,
              (-1.8, loop_drift + 1.8))
    # multi-loop: 2 out-and-back passes over the quarter corridor
    ml_drift = 0.03 * 0.5 * (n_frames // 4)
    run_scene(cam, pipe, "loop x2", n_frames, 2, 500,
              (-1.8, ml_drift + 1.8))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
