"""Stage-level wall-clock breakdown of the headline SLAM benchmark.

Times each stage of the bench.py pipeline separately on the current
backend: frontend SIFT/FAST, VO-only scan, and the
EKF-SLAM scan at the reference operating point (min_measured=50,
mono_slam.m:91) for both map capacities (K=64, K=256), under SlamConfig
ablations (only_predict / pure_ekf / 1pre, vo covariance on/off, RANSAC
batch sizes). Prints a JSON dict of ms-per-frame so hot spots are
attributable before optimizing.

All timed calls are jitted device programs (run_slam and run_sequence are
jit-decorated with static configs; the frontends are jitted here), so the
stage times are in the same execution mode as bench.py's headline —
per-op eager dispatch never pollutes the attribution (advisor finding,
round 1).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.slam import SlamConfig, run_slam
from pre3_tpu.frontend.pipeline import extract_features, extract_features_sift
from pre3_tpu.geometry.camera import sr4000_camera
from pre3_tpu.vo.dead_reckoning import run_sequence

N_FRAMES = 64
BASE = SlamConfig(min_measured=50)


def timeit(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.time() - t0) / reps


def main():
    cam = sr4000_camera()
    frames, traj, scene = render_sequence(
        n_frames=N_FRAMES, n_points=400, noise=0.004
    )
    intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))

    res = {"backend": jax.default_backend(), "n_frames": N_FRAMES,
           "min_measured": BASE.min_measured}

    # frontend alone
    fe_sift = jax.jit(
        lambda i, x, c: jax.vmap(
            lambda a, b, d: extract_features_sift(a, b, d)
        )(i, x, c)
    )
    feats, dt = timeit(fe_sift, intensity, xyz, conf)
    res["frontend_sift_ms_per_frame"] = 1e3 * dt / N_FRAMES
    print("frontend_sift", res["frontend_sift_ms_per_frame"], flush=True)

    fe_fast = jax.jit(
        lambda i, x, c: jax.vmap(
            lambda a, b, d: extract_features(
                a, b, d, threshold=0.05, max_features=256
            )
        )(i, x, c)
    )
    feats_fast, dt = timeit(fe_fast, intensity, xyz, conf)
    res["frontend_fast_ms_per_frame"] = 1e3 * dt / N_FRAMES
    print("frontend_fast", res["frontend_fast_ms_per_frame"], flush=True)

    # VO scan alone (on precomputed FAST features)
    _, dt = timeit(
        lambda f: run_sequence(f, jax.random.PRNGKey(0), batch=1024),
        feats_fast,
    )
    res["vo_scan_ms_per_frame"] = 1e3 * dt / N_FRAMES
    print("vo_scan", res["vo_scan_ms_per_frame"], flush=True)

    # EKF-SLAM scan on precomputed SIFT features: capacities × ablations
    for name, cfg, k in [
        ("slam_1pre_k64", BASE, 64),
        ("slam_1pre_k256", BASE, 256),
        ("slam_only_predict_k256", BASE._replace(only_predict=True), 256),
        ("slam_pure_ekf_k256", BASE._replace(est_method="pure_ekf"), 256),
        ("slam_no_vocov_k256",
         BASE._replace(vo_noise_from_covariance=False), 256),
        ("slam_rb128_k256", BASE._replace(ransac_batch=128), 256),
    ]:
        try:
            _, dt = timeit(
                lambda f, c=cfg, kk=k: run_slam(
                    cam, f, jax.random.PRNGKey(0), cfg=c, n_landmarks=kk
                ),
                feats,
            )
            res[name + "_ms_per_frame"] = 1e3 * dt / N_FRAMES
            print(name, res[name + "_ms_per_frame"], flush=True)
        except Exception as e:  # noqa: BLE001 — keep profiling other cfgs
            res[name + "_error"] = repr(e)[:200]
            print(name, "ERROR", repr(e)[:200], flush=True)

    for k2, v in res.items():
        if isinstance(v, float):
            res[k2] = round(v, 3)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
