"""Offline keyframing walkthrough — the SR4000_key_frame_selection.m
pipeline, end to end with resumable caches:

  render sequence → (cached) feature extraction → (cached) VO against the
  last accepted keyframe → keyframe acceptance (4° / 0.05 m) → renumbered
  KeyFrames/ dataset export → keyframe BA → correction smoothing.

Run:  python examples/run_offline_keyframing.py [work_dir]

Re-running with the same work_dir resumes from the npz caches (the
reference's OVERWRITE/RECALCULATE cache semantics, utils/cache.py).
"""

import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.backend.ba import bundle_adjust
from pre3_tpu.backend.keyframes import (
    export_keyframe_dataset, find_keyframes_vo,
)
from pre3_tpu.backend.smoothing import apply_ba_corrections
from pre3_tpu.backend.tracks import make_ba_problem_from_tracks
from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.eval.trajectory import ate_rmse
from pre3_tpu.frontend.pipeline import extract_features
from pre3_tpu.geometry.camera import sr4000_camera
from pre3_tpu.utils.cache import FeatureCache, VoCache
from pre3_tpu.vo.dead_reckoning import run_sequence


def main(work_dir: str | None = None, n_frames: int = 24):
    work_dir = work_dir or tempfile.mkdtemp(prefix="pre3_keyframing_")
    os.makedirs(work_dir, exist_ok=True)
    cam = sr4000_camera()
    print(f"backend: {jax.default_backend()}")
    frames, traj, scene = render_sequence(
        n_frames=n_frames, n_points=400, noise=0.003, step_t=0.04
    )
    gt = (traj.t - traj.t[0]) @ traj.r[0]

    # cached per-frame features (tier 1)
    t0 = time.time()
    fcache = FeatureCache(work_dir)
    feats = [
        fcache.get(i, lambda f=f: extract_features(
            jnp.asarray(f.intensity), jnp.asarray(np.nan_to_num(f.xyz)),
            jnp.asarray(f.confidence), threshold=0.05, max_features=256,
        ))
        for i, f in enumerate(frames)
    ]
    feats = jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
    print(f"features (cached): {time.time() - t0:.1f}s")

    # offline keyframe pass with cached pair VO (tier 2)
    t0 = time.time()
    kf = find_keyframes_vo(
        feats, jax.random.PRNGKey(0), vo_cache=VoCache(work_dir), batch=512
    )
    print(
        f"keyframes {kf.indices.tolist()} "
        f"({kf.n_vo_calls} VO calls, {time.time() - t0:.1f}s)"
    )

    out = export_keyframe_dataset(
        kf.indices, os.path.join(work_dir, "KeyFrames"), feats=feats,
        deltas=kf,
    )
    print(f"exported keyframe dataset → {out}")

    # full-sequence VO for the non-keyframe poses
    vo = run_sequence(feats, jax.random.PRNGKey(1), batch=1024)
    ate_vo = ate_rmse(np.asarray(vo.t), gt, align=False)

    # keyframe BA on multi-view tracks + smoothing back onto all frames
    kf_idx = jnp.asarray(kf.indices)
    kf_valid = jnp.ones((len(kf.indices),), bool)
    kf_feats = jax.tree.map(lambda x: x[kf_idx], feats)
    prob = make_ba_problem_from_tracks(
        kf_feats, vo.t[kf_idx], vo.q[kf_idx], kf_valid
    )
    res = bundle_adjust(cam, prob, iters=10)
    sm_t, sm_q = apply_ba_corrections(
        vo.t, vo.q, kf_idx, kf_valid, res.kf_t, res.kf_q
    )
    ate_ba = ate_rmse(np.asarray(sm_t), gt, align=False)
    print(
        f"ATE: VO {ate_vo:.4f} m → BA+smoothing {ate_ba:.4f} m "
        f"(cost {float(res.cost[0]):.4f} → {float(res.cost[-1]):.4f})"
    )


if __name__ == "__main__":
    main(*sys.argv[1:2])
