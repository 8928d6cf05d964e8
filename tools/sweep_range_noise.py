"""Range-dependent noise + loop-closure-factor sweep (VERDICT r3 #2/#3).

Measures, on the default device:
  * 256- and 512-frame corridors: SLAM ATE and post-BA ATE for
    (depth_range_quadratic ∈ {off, on}) × (BA depth_range_ref ∈ sweep) —
    the SR4000 σ∝range² noise model pushed through the landmark depth
    prior and the BA depth factors.
  * loop scenario (out-and-back): post-BA ATE for lc_gap ∈ {0 (off), 15}
    — un-Huberized loop-closure landmark factors from filter
    re-acquisitions.

Targets (VERDICT): 512-frame SLAM ATE < 1.4 m (vs r3's 1.69), loop
post-BA ≤ 0.06 m (vs 0.077), no regression at 256.

Run from the checkout root: python -u tools/sweep_range_noise.py
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pre3_tpu.backend.ba import bundle_adjust  # noqa: E402
from pre3_tpu.backend.ekf_ba import ba_problem_from_slam  # noqa: E402
from pre3_tpu.backend.keyframes import select_keyframes  # noqa: E402
from pre3_tpu.backend.smoothing import apply_ba_corrections  # noqa: E402
from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.ekf.slam import SlamConfig, run_slam  # noqa: E402
from pre3_tpu.eval.trajectory import ate_rmse  # noqa: E402
from pre3_tpu.frontend.pipeline import extract_features_sift  # noqa: E402
from pre3_tpu.geometry.camera import sr4000_camera  # noqa: E402

CAM = sr4000_camera()


def make_seq(n_frames, loop=False):
    half = n_frames // 2 if loop else n_frames
    drift = 0.03 * 0.5 * half
    frames, traj, _ = render_sequence(
        n_frames=n_frames, n_points=int(832 * max(1, n_frames // 256)),
        noise=0.004, x_range=(-1.8, drift + 1.8), loop=loop,
    )
    intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))
    gt = (np.asarray(traj.t) - np.asarray(traj.t[0])) @ np.asarray(
        traj.r[0]
    )
    feats = jax.jit(
        lambda i, x, c: jax.vmap(extract_features_sift)(i, x, c)
    )(intensity, xyz, conf)
    jax.block_until_ready(feats.uv)
    return feats, gt


def slam_and_ba(feats, gt, cfg, n_frames, depth_range_ref=0.0, lc_gap=15,
                label=""):
    run = jax.jit(lambda f, key, c=cfg: run_slam(CAM, f, key, cfg=c,
                                                 n_landmarks=256))
    t0 = time.time()
    out = run(feats, jax.random.PRNGKey(0))
    _ = float(out.t[-1, 0])
    dt = time.time() - t0
    ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
    ks = select_keyframes(out.t, out.q, jnp.ones(n_frames, bool),
                          max_keyframes=64)
    prob = ba_problem_from_slam(
        out, np.asarray(ks.indices), np.asarray(ks.valid),
        max_landmarks=512, lc_gap=lc_gap,
    )
    ba_ate = lc_n = None
    if prob is not None:
        lc_n = int(np.asarray(prob.lc_lm).sum())
        res = bundle_adjust(CAM, prob, iters=10,
                            depth_range_ref=depth_range_ref)
        sm_t, _ = apply_ba_corrections(
            out.t, out.q, ks.indices, ks.valid, res.kf_t, res.kf_q
        )
        ba_ate = float(ate_rmse(np.asarray(sm_t), gt, align=False))
    row = {"label": label, "n_frames": n_frames,
           "depth_range_quadratic": cfg.depth_range_quadratic,
           "depth_range_ref": depth_range_ref, "lc_gap": lc_gap,
           "ate": round(ate, 4),
           "ba_ate": None if ba_ate is None else round(ba_ate, 4),
           "lc_landmarks": lc_n, "wall_s": round(dt, 1)}
    print(json.dumps(row), flush=True)
    return row


def main():
    stage = sys.argv[1] if len(sys.argv) > 1 else "256"
    base = SlamConfig(min_measured=50)
    quad = base._replace(depth_range_quadratic=True)

    if stage == "256a":
        feats, gt = make_seq(256)
        slam_and_ba(feats, gt, base, 256, 0.0, 0, "lc-off")
        slam_and_ba(feats, gt, base, 256, 0.0, 15, "lc-15")
    elif stage == "256b":
        feats, gt = make_seq(256)
        slam_and_ba(feats, gt, base, 256, 1.0, 15, "ba-ref1")
        slam_and_ba(feats, gt, base, 256, 2.0, 15, "ba-ref2")
    elif stage == "512a":
        feats, gt = make_seq(512)
        slam_and_ba(feats, gt, base, 512, 0.0, 15, "baseline")
        slam_and_ba(feats, gt, quad, 512, 0.0, 15, "ekf-quad")
    elif stage == "512b":
        feats, gt = make_seq(512)
        slam_and_ba(feats, gt, base, 512, 1.0, 15, "ba-ref1")
        slam_and_ba(feats, gt, base, 512, 2.0, 15, "ba-ref2")
    elif stage == "h256":
        feats, gt = make_seq(256)
        slam_and_ba(feats, gt, quad, 256, 0.0, 15, "hybrid-quad-256")
    elif stage == "h512":
        feats, gt = make_seq(512)
        slam_and_ba(feats, gt, quad, 512, 0.0, 15, "hybrid-quad-512")
    elif stage == "d0_256":
        feats, gt = make_seq(256)
        q15 = quad._replace(depth_range_d0=1.5)
        slam_and_ba(feats, gt, q15, 256, 0.0, 15, "quad-d0-1.5-256")
    elif stage == "d0_512":
        feats, gt = make_seq(512)
        q15 = quad._replace(depth_range_d0=1.5)
        slam_and_ba(feats, gt, q15, 512, 0.0, 15, "quad-d0-1.5-512")
    elif stage == "d0ba":
        # one SLAM run (quad d0=1.5), several BA weightings on top
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 256
        feats, gt = make_seq(n)
        q15 = quad._replace(depth_range_d0=1.5)
        run = jax.jit(lambda f, key: run_slam(CAM, f, key, cfg=q15,
                                              n_landmarks=256))
        out = run(feats, jax.random.PRNGKey(0))
        _ = float(out.t[-1, 0])
        ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
        ks = select_keyframes(out.t, out.q, jnp.ones(n, bool),
                              max_keyframes=64)
        prob = ba_problem_from_slam(
            out, np.asarray(ks.indices), np.asarray(ks.valid),
            max_landmarks=512, lc_gap=15,
        )
        for ref in (0.0, 1.5):
            for dw in (50.0, 10.0):
                res = bundle_adjust(CAM, prob, iters=10,
                                    depth_weight=dw, depth_range_ref=ref)
                sm_t, _ = apply_ba_corrections(
                    out.t, out.q, ks.indices, ks.valid, res.kf_t,
                    res.kf_q,
                )
                print(json.dumps({
                    "label": f"d0ba-n{n}-ref{ref}-dw{dw}",
                    "ate": round(ate, 4),
                    "ba_ate": round(float(ate_rmse(
                        np.asarray(sm_t), gt, align=False)), 4),
                }), flush=True)
    elif stage == "loopa":
        feats, gt = make_seq(256, loop=True)
        slam_and_ba(feats, gt, base, 256, 0.0, 0, "loop-lc-off")
        slam_and_ba(feats, gt, base, 256, 0.0, 15, "loop-lc-15")
    elif stage == "loopb":
        feats, gt = make_seq(256, loop=True)
        mem = base._replace(max_invisible=10_000, max_update_slots=96)
        slam_and_ba(feats, gt, mem, 256, 0.0, 15, "loop-memorymap-lc15")


if __name__ == "__main__":
    main()
