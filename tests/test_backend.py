"""Keyframe selection + track building + full config-#4 pipeline test:
sequence → VO → keyframes → tracks → Schur BA, against synthetic GT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pre3_tpu.backend.ba import bundle_adjust
from pre3_tpu.backend.keyframes import select_keyframes
from pre3_tpu.backend.tracks import make_ba_problem_from_tracks
from pre3_tpu.data.synthetic import render_sequence
from pre3_tpu.eval.trajectory import ate_rmse
from pre3_tpu.frontend.pipeline import extract_features_sift
from pre3_tpu.geometry.camera import sr4000_camera
from pre3_tpu.vo.dead_reckoning import run_sequence

CAM = sr4000_camera()


class TestKeyframeSelection:
    def test_thresholds(self):
        # motion below both thresholds → only frame 0
        n = 10
        t = jnp.zeros((n, 3)).at[:, 0].set(jnp.arange(n) * 0.001)
        q = jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1))
        ok = jnp.ones(n, bool)
        ks = select_keyframes(t, q, ok, max_keyframes=8)
        assert int(ks.n) == 1

        # 6 cm jumps → every frame qualifies
        t2 = jnp.zeros((n, 3)).at[:, 0].set(jnp.arange(n) * 0.06)
        ks2 = select_keyframes(t2, q, ok, max_keyframes=8)
        assert int(ks2.n) >= 8

    def test_rotation_trigger(self):
        from pre3_tpu.geometry.quaternion import e2q

        n = 6
        t = jnp.zeros((n, 3))
        yaw = jnp.arange(n) * jnp.radians(5.0)  # 5° per frame > 4°
        q = jax.vmap(lambda y: e2q(jnp.array([0.0, 0.0, y])))(yaw)
        ks = select_keyframes(t, q, jnp.ones(n, bool), max_keyframes=8)
        assert int(ks.n) >= 5

    def test_invalid_frames_skipped(self):
        n = 8
        t = jnp.zeros((n, 3)).at[:, 0].set(jnp.arange(n) * 0.06)
        q = jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1))
        ok = jnp.ones(n, bool).at[3].set(False)
        ks = select_keyframes(t, q, ok, max_keyframes=8)
        idx = np.asarray(ks.indices)[np.asarray(ks.valid)]
        assert 3 not in idx


class TestFullBackend:
    def test_vo_keyframes_tracks_ba(self):
        """Config #4 end to end; BA must not degrade the VO trajectory and
        tracks must reconstruct real landmarks."""
        frames, traj, scene = render_sequence(
            n_frames=16, n_points=300, noise=0.004, traj_seed=5
        )
        feats = [
            extract_features_sift(
                jnp.asarray(f.intensity), jnp.asarray(f.xyz),
                jnp.asarray(f.confidence),
            )
            for f in frames
        ]
        feats = jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
        vo = run_sequence(feats, jax.random.PRNGKey(0), batch=512)

        ks = select_keyframes(vo.t, vo.q, vo.ok, max_keyframes=8)
        n_kf = int(ks.n)
        assert n_kf >= 3, f"only {n_kf} keyframes"
        idx = ks.indices
        kf_feats = jax.tree.map(lambda x: x[idx], feats)
        prob = make_ba_problem_from_tracks(
            kf_feats, vo.t[idx], vo.q[idx], ks.valid, max_tracks=256
        )
        n_obs = int(prob.mask.sum())
        assert n_obs > 3 * n_kf, f"too few track observations: {n_obs}"

        res = bundle_adjust(CAM, prob, iters=8)
        assert float(res.cost[-1]) <= float(res.cost[0])

        # compare keyframe positions against GT (frame-0 relative)
        gt = (traj.t - traj.t[0]) @ traj.r[0]
        gt_kf = gt[np.asarray(idx)]
        valid = np.asarray(ks.valid)
        err_vo = np.linalg.norm(
            np.asarray(vo.t[idx])[valid] - gt_kf[valid], axis=-1
        )
        err_ba = np.linalg.norm(
            np.asarray(res.kf_t)[valid] - gt_kf[valid], axis=-1
        )
        # BA should not be worse than VO init (usually better)
        assert err_ba.mean() <= err_vo.mean() * 1.5
        assert err_ba.mean() < 0.05


class TestEkfBaBridge:
    @pytest.mark.slow
    def test_slam_records_to_ba_improves(self):
        """EKF records → BA problem → smoothing must not degrade and
        usually improves the trajectory (the full config-#4 integration)."""
        from pre3_tpu.backend.ekf_ba import ba_problem_from_slam
        from pre3_tpu.backend.smoothing import apply_ba_corrections
        from pre3_tpu.ekf.slam import run_slam

        frames, traj, scene = render_sequence(
            n_frames=12, n_points=300, noise=0.004
        )
        feats = [
            extract_features_sift(
                jnp.asarray(f.intensity), jnp.asarray(f.xyz),
                jnp.asarray(f.confidence), keypoints_per_octave=48,
            )
            for f in frames
        ]
        feats = jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
        out = run_slam(CAM, feats, jax.random.PRNGKey(0), n_landmarks=32)
        gt = (traj.t - traj.t[0]) @ traj.r[0]
        slam_ate = ate_rmse(np.asarray(out.t), gt, align=False)

        from pre3_tpu.backend.keyframes import select_keyframes

        # dense keyframing for the short test sequence (slow synthetic
        # motion yields only ~2 keyframes at the reference thresholds)
        ks = select_keyframes(out.t, out.q, jnp.ones(12, bool),
                              max_keyframes=8, rot_thresh_deg=1.0,
                              trans_thresh_m=0.02)
        prob = ba_problem_from_slam(
            out, np.asarray(ks.indices), np.asarray(ks.valid)
        )
        assert prob is not None
        assert int(prob.mask.sum()) > 10
        res = bundle_adjust(CAM, prob, iters=8)
        assert float(res.cost[-1]) <= float(res.cost[0])
        sm_t, _ = apply_ba_corrections(
            out.t, out.q, ks.indices, ks.valid, res.kf_t, res.kf_q
        )
        sm_ate = ate_rmse(np.asarray(sm_t), gt, align=False)
        # On short, well-tracked sequences the filter estimate is already
        # near-optimal and BA can add slight noise; it must stay sane.
        # (On longer sequences BA improves the trajectory — see the demo.)
        assert sm_ate < max(2.0 * slam_ate, 0.04), (sm_ate, slam_ate)

    @pytest.mark.slow
    def test_rematch_merge_option(self):
        """ba_problem_from_slam(kf_feats=...) merges cross-keyframe track
        re-matches into the record landmarks: observation count must not
        shrink and the problem stays solvable. (Measured off by default:
        the merged matches degrade ATE — the round-3 record.)"""
        from pre3_tpu.backend.ekf_ba import ba_problem_from_slam
        from pre3_tpu.backend.keyframes import select_keyframes
        from pre3_tpu.ekf.slam import run_slam

        frames, traj, _ = render_sequence(
            n_frames=12, n_points=300, noise=0.004
        )
        feats = [
            extract_features_sift(
                jnp.asarray(f.intensity), jnp.asarray(f.xyz),
                jnp.asarray(f.confidence), keypoints_per_octave=48,
            )
            for f in frames
        ]
        feats = jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
        out = run_slam(CAM, feats, jax.random.PRNGKey(0), n_landmarks=32)
        ks = select_keyframes(out.t, out.q, jnp.ones(12, bool),
                              max_keyframes=8, rot_thresh_deg=1.0,
                              trans_thresh_m=0.02)
        kf_idx = np.asarray(ks.indices)
        base = ba_problem_from_slam(out, kf_idx, np.asarray(ks.valid))
        kf_feats = jax.tree.map(lambda a: a[jnp.asarray(kf_idx)], feats)
        merged = ba_problem_from_slam(
            out, kf_idx, np.asarray(ks.valid), kf_feats=kf_feats
        )
        assert merged is not None and base is not None
        assert int(merged.mask.sum()) >= int(base.mask.sum())
        res = bundle_adjust(CAM, merged, iters=5)
        assert float(res.cost[-1]) <= float(res.cost[0]) + 1e-9
