"""End-to-end real-format pipeline: reference-layout `.dat` directory →
native C++ loader → OnlineSlam streaming → keyframes → Schur BA →
trajectory dumps.

This is the reference's whole operating mode (a directory of d1_NNNN.dat
files, read_xyz_sr4000.m:10-12 / takeImage.m:27-30, driven by
mono_slam.m's per-frame loop and SR4000_key_frame_selection.m's offline
pass) as one flow. Since no SR4000 dataset ships with the reference, the
sequence is rendered synthetically and exported into the exact on-disk
format first (pre3_tpu/data/export.py), so every byte still passes
through the real parser path.

Run from the checkout root: python examples/run_dat_pipeline.py [out_dir]
"""

import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pre3_tpu.backend.ba import bundle_adjust
from pre3_tpu.backend.ekf_ba import ba_problem_from_slam
from pre3_tpu.backend.keyframes import select_keyframes
from pre3_tpu.backend.smoothing import apply_ba_corrections
from pre3_tpu.data.export import export_dat_sequence
from pre3_tpu.data.native_loader import native_available, read_sequence_native
from pre3_tpu.data.sr4000 import list_sequence
from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.ekf.slam import SlamConfig, SlamTrajectory
from pre3_tpu.eval.trajectory import ate_rmse
from pre3_tpu.geometry.camera import sr4000_camera
from pre3_tpu.runtime.online import OnlineSlam


def run(data_dir: str, out_dir: str, n_frames: int = 48):
    cam = sr4000_camera()

    # 1. dataset directory (render + export if absent)
    os.makedirs(data_dir, exist_ok=True)
    if not list_sequence(data_dir):
        print(f"rendering {n_frames} frames into {data_dir} ...")
        frames, traj, _ = render_sequence(
            n_frames=n_frames, n_points=400, noise=0.004
        )
        export_dat_sequence(frames, data_dir)
        gt = (traj.t - traj.t[0]) @ traj.r[0]
        np.save(os.path.join(data_dir, "gt_t.npy"), gt)
    paths = list_sequence(data_dir)
    gt_path = os.path.join(data_dir, "gt_t.npy")
    gt = np.load(gt_path) if os.path.exists(gt_path) else None

    # 2. decode through the native (threaded C++) loader
    print(f"decoding {len(paths)} .dat frames "
          f"(native={native_available()}) ...")
    frames = read_sequence_native(paths)

    # 3. stream through OnlineSlam (one fused dispatch per frame)
    slam = OnlineSlam(
        # initial_orientation: plane-fit gravity prior from frame 0 — the
        # reference's default startup (initialize_x_and_p.m:35-37)
        cam, cfg=SlamConfig(match_ratio=1.3, initial_orientation=True),
        n_landmarks=64,
        extractor_kwargs={"threshold": 0.05, "max_features": 128},
        key=jax.random.PRNGKey(0),
    )
    slam.run(frames, prefetch=2)
    ts, qs = slam.trajectory

    # 4. keyframes + BA + smoothing
    ks = select_keyframes(
        jnp.asarray(ts), jnp.asarray(qs), jnp.ones(len(ts), bool),
        max_keyframes=16,
    )
    # online driver discards per-step records; rebuild BA input offline
    # from keyframe features via cross-keyframe tracks
    from pre3_tpu.backend.tracks import make_ba_problem_from_tracks
    from pre3_tpu.frontend.pipeline import extract_features

    kf_idx = np.asarray(ks.indices)
    kf_feats = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[
            extract_features(
                jnp.asarray(frames[i].intensity),
                jnp.asarray(np.nan_to_num(frames[i].xyz)),
                jnp.asarray(frames[i].confidence),
                threshold=0.05, max_features=128,
            )
            for i in kf_idx
        ],
    )
    prob = make_ba_problem_from_tracks(
        kf_feats, jnp.asarray(ts[kf_idx]), jnp.asarray(qs[kf_idx]),
        ks.valid, max_tracks=128,
    )
    res = bundle_adjust(cam, prob, iters=8)
    sm_t, sm_q = apply_ba_corrections(
        jnp.asarray(ts), jnp.asarray(qs), ks.indices, ks.valid,
        res.kf_t, res.kf_q,
    )
    sm_t = np.asarray(sm_t)

    # 5. dumps
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "trajectory.npz"),
             t=ts, q=qs, t_ba=sm_t, kf_indices=kf_idx,
             kf_valid=np.asarray(ks.valid))
    from pre3_tpu.eval.viz import plot_trajectory

    plot_trajectory(os.path.join(out_dir, "trajectory.png"), ts, gt_t=gt)
    plot_trajectory(
        os.path.join(out_dir, "trajectory_ba.png"), sm_t, gt_t=gt,
        title="post-BA trajectory",
    )

    if gt is not None:
        ate = ate_rmse(ts, gt, align=False)
        ate_ba = ate_rmse(sm_t, gt, align=False)
        print(f"online ATE {ate:.4f} m | post-BA ATE {ate_ba:.4f} m "
              f"| {int(ks.n)} keyframes | outputs in {out_dir}")
        return float(ate), float(ate_ba)
    print(f"done; outputs in {out_dir}")
    return None, None


if __name__ == "__main__":
    base = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="pre3_dat_"
    )
    run(os.path.join(base, "data"), os.path.join(base, "out"))
