"""Scan-level attribution of the K=512 per-frame step cost (VERDICT r3
#8).

Attribution runs through lax.scan over 64 frames, so per-dispatch
overhead is amortized, with config ablations:

  only_predict     — VO + predict + measurement-prediction + matching +
                     map management (no updates, no RANSAC)
  pure_ekf         — + one full Kalman update on all IC matches
  1pre             — + batched RANSAC + rescue + second update (headline)

and the deltas at K=256 vs K=512 localize the super-linear term.

Run from the checkout root: python -u tools/profile_k512.py
"""

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
from pre3_tpu.frontend.pipeline import extract_features_sift  # noqa: E402
from pre3_tpu.geometry.camera import sr4000_camera  # noqa: E402

CAM = sr4000_camera()
N = 64


def main():
    frames, _, _ = render_sequence(n_frames=N, n_points=700, noise=0.004,
                                   x_range=(-1.8, 3.0))
    intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))
    feats = jax.jit(
        lambda i, x, c: jax.vmap(extract_features_sift)(i, x, c)
    )(intensity, xyz, conf)
    jax.block_until_ready(feats.uv)

    base = SlamConfig(min_measured=50)
    res = {}
    for k in (256, 512):
        for name, cfg in [
            ("only_predict", base._replace(only_predict=True)),
            ("pure_ekf", base._replace(est_method="pure_ekf")),
            ("1pre", base),
        ]:
            run = jax.jit(lambda f, key, c=cfg, kk=k: run_slam(
                CAM, f, key, cfg=c, n_landmarks=kk))
            out = run(feats, jax.random.PRNGKey(0))
            _ = float(out.t[-1, 0])
            t0 = time.time()
            for r in range(3):
                out = run(feats, jax.random.PRNGKey(r))
                _ = float(out.t[-1, 0])
            ms = 1e3 * (time.time() - t0) / 3 / N
            res[f"k{k}_{name}"] = round(ms, 3)
            print(json.dumps({f"k{k}_{name}": res[f"k{k}_{name}"]}),
                  flush=True)

    for k in (256, 512):
        res[f"k{k}_ekf_update_delta"] = round(
            res[f"k{k}_pure_ekf"] - res[f"k{k}_only_predict"], 3)
        res[f"k{k}_ransac_delta"] = round(
            res[f"k{k}_1pre"] - res[f"k{k}_pure_ekf"], 3)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
