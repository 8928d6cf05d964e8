"""Multi-device tests on the 8-device virtual CPU mesh: sharded RANSAC
and landmark-sharded distributed BA must match their single-device
counterparts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pre3_tpu.backend.ba import bundle_adjust
from pre3_tpu.parallel.ba_sharded import bundle_adjust_sharded
from pre3_tpu.parallel.mesh import make_mesh
from pre3_tpu.parallel.vo_sharded import sharded_ransac_rigid
from pre3_tpu.vo.ransac import ransac_rigid
from tests.test_ba import make_ba_problem, CAM
from tests.test_vo import make_rigid_problem


def test_eight_devices_available():
    assert len(jax.devices()) == 8


class TestShardedRansac:
    def test_matches_unsharded_result_quality(self):
        p1, p2, r, t, _ = make_rigid_problem(
            n=96, noise=0.003, outlier_frac=0.3, seed=11
        )
        mesh = make_mesh(8, axis="hyp")
        with jax.set_mesh(mesh):
            res = jax.jit(
                lambda k: sharded_ransac_rigid(
                    mesh, k, p1, p2, jnp.ones(96, bool), batch=512,
                    support_threshold=0.001,
                )
            )(jax.random.PRNGKey(0))
        assert bool(res.ok)
        np.testing.assert_allclose(np.asarray(res.r), r, atol=0.02)
        np.testing.assert_allclose(np.asarray(res.t), t, atol=0.02)


class TestDistributedBa:
    def test_matches_single_device(self):
        prob, (gt_t, gt_q, gt_p) = make_ba_problem(
            n_kf=5, n_lm=48, seed=21, t_noise=0.03, p_noise=0.03
        )
        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(8, axis="lm")
        dist = bundle_adjust_sharded(mesh, CAM, prob, iters=8)
        # same final accuracy (exact bitwise equality is not expected —
        # psum reorders the f32 reduction)
        assert float(dist.cost[-1]) < 1e-3
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.points), np.asarray(single.points), atol=5e-3
        )

    def test_landmark_padding(self):
        # 41 landmarks does not divide 8 → exercises the pad path
        prob, (gt_t, _, _) = make_ba_problem(
            n_kf=4, n_lm=41, seed=22, t_noise=0.02, p_noise=0.02
        )
        mesh = make_mesh(8, axis="lm")
        dist = bundle_adjust_sharded(mesh, CAM, prob, iters=8)
        assert dist.points.shape[0] == 41
        assert float(dist.cost[-1]) < 1e-3
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=5e-3
        )

    def test_matches_single_device_with_odo_factors(self):
        # VERDICT r3 #1: the distributed path must carry the odometry-
        # chain factors (the difference between BA helping and hurting on
        # loop-free sequences, the round-2 record) — equality vs the
        # single-device backend WITH odo_t/odo_q/odo_w set.
        from pre3_tpu.geometry.quaternion import qconj, qprod, qrotate

        prob, (gt_t, gt_q, _) = make_ba_problem(
            n_kf=5, n_lm=48, seed=24, t_noise=0.03, p_noise=0.03
        )
        odo_t = jnp.stack([
            qrotate(qconj(gt_q[i]), gt_t[i + 1] - gt_t[i])
            for i in range(4)
        ])
        odo_q = jnp.stack(
            [qprod(qconj(gt_q[i]), gt_q[i + 1]) for i in range(4)]
        )
        odo_w = jnp.array([1.0, 1.0, 0.0, 1.0])  # one disabled factor
        prob = prob._replace(odo_t=odo_t, odo_q=odo_q, odo_w=odo_w)

        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(8, axis="lm")
        dist = bundle_adjust_sharded(mesh, CAM, prob, iters=8)
        # identical math → identical LM accept/reject decisions; only
        # psum reduction order differs (atol floors the converged-noise
        # tail, which sits at ~5e-11 pure f32 rounding)
        np.testing.assert_allclose(
            np.asarray(dist.cost), np.asarray(single.cost),
            rtol=1e-4, atol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.points), np.asarray(single.points), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=5e-3
        )

    def test_two_device_submesh(self):
        prob, (gt_t, _, _) = make_ba_problem(
            n_kf=4, n_lm=40, seed=23, t_noise=0.02, p_noise=0.02
        )
        mesh = make_mesh(2, axis="lm")
        dist = bundle_adjust_sharded(mesh, CAM, prob, iters=8)
        assert float(dist.cost[-1]) < 1e-3


class TestPoseShardedBa:
    """Keyframe-block pose partition with separator-pose halo exchange
    (SURVEY §2.4 halo row): agreement with the single-device backend on
    a window-local corridor problem, and zero dropped observations."""

    def _corridor_problem(self, n_kf=16, lm_per_kf=6, span=2, seed=0):
        from pre3_tpu.geometry.camera import project

        rng = np.random.default_rng(seed)
        kf_t = np.zeros((n_kf, 3), np.float32)
        kf_t[:, 0] = 0.12 * np.arange(n_kf)
        kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_kf, 1))
        pts, obs, oxyz, msk = [], [], [], []
        for c in range(n_kf):
            for _ in range(lm_per_kf):
                p = np.array([
                    kf_t[c, 0] + rng.uniform(-0.4, 0.4),
                    rng.uniform(-0.8, 0.8),
                    rng.uniform(2.0, 3.5),
                ], np.float32)
                pts.append(p)
                row_uv = np.zeros((n_kf, 2), np.float32)
                row_xyz = np.zeros((n_kf, 3), np.float32)
                row_m = np.zeros(n_kf, bool)
                for fkf in range(max(0, c - span),
                                 min(n_kf, c + span + 1)):
                    p_cam = p - kf_t[fkf]
                    uv = np.asarray(
                        project(CAM, jnp.asarray(p_cam))
                    )
                    if 2 < uv[0] < 173 and 2 < uv[1] < 141:
                        row_uv[fkf] = uv
                        row_xyz[fkf] = p_cam
                        row_m[fkf] = True
                obs.append(row_uv)
                oxyz.append(row_xyz)
                msk.append(row_m)
        points = np.stack(pts)
        obs_uv = np.stack(obs, axis=1)  # [F, L, 2]
        obs_xyz = np.stack(oxyz, axis=1)
        mask = np.stack(msk, axis=1)
        keep = mask.sum(0) >= 2
        points, obs_uv = points[keep], obs_uv[:, keep]
        obs_xyz, mask = obs_xyz[:, keep], mask[:, keep]
        kf_t_init = kf_t + rng.normal(
            scale=0.02, size=kf_t.shape
        ).astype(np.float32)
        kf_t_init[0] = kf_t[0]
        p_init = points + rng.normal(
            scale=0.02, size=points.shape
        ).astype(np.float32)
        odo_t = (kf_t[1:] - kf_t[:-1]).astype(np.float32)
        odo_q = np.tile(np.array([1.0, 0, 0, 0], np.float32),
                        (n_kf - 1, 1))
        from pre3_tpu.backend.ba import BaProblem

        return BaProblem(
            obs_uv=jnp.asarray(obs_uv), mask=jnp.asarray(mask),
            kf_t=jnp.asarray(kf_t_init), kf_q=jnp.asarray(kf_q),
            points=jnp.asarray(p_init),
            obs_xyz=jnp.asarray(obs_xyz), mask_xyz=jnp.asarray(mask),
            odo_t=jnp.asarray(odo_t), odo_q=jnp.asarray(odo_q),
            odo_w=jnp.ones(n_kf - 1, jnp.float32),
        ), jnp.asarray(kf_t)

    def test_matches_single_device_on_window_local_problem(self):
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem()
        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(4, axis="blk")
        dist, report = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=8, cg_iters=96, sep=3
        )
        # keyframe locality → the block windows cover every observation
        assert report["dropped_obs"] == 0, report
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.points), np.asarray(single.points),
            atol=5e-3,
        )

    def test_eight_blocks(self):
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem(n_kf=24, seed=3)
        mesh = make_mesh(8, axis="blk")
        dist, report = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=8, cg_iters=96, sep=3
        )
        assert report["dropped_obs"] == 0
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=8e-3
        )

    def test_fb_smaller_than_sep(self):
        """The driver's dryrun shape (F = 2·n_dev → fb = 2 < sep = 3)
        crashed in round 4 (VERDICT r4 #1): halo_exchange's x_own[-sep:]
        slices clamp to fb rows and the window math breaks. sep must
        clamp to fb. Pinned against the single-device optimizer."""
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem(n_kf=16, seed=5)
        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(8, axis="blk")
        dist, report = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=8, cg_iters=96, sep=3
        )
        assert report["fb"] == 2
        assert report["window"] == 6  # sep clamped 3 → 2
        assert report["dropped_obs"] == 0, report
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=3e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=8e-3
        )

    def test_uneven_f_with_empty_blocks(self):
        """F = 10 on 8 blocks: fb = 2, fpad = 16 — blocks 5-7 hold only
        padded poses. The padding/own_valid path had zero coverage in
        round 4 (VERDICT r4 weak #2)."""
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem(n_kf=10, seed=7)
        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(8, axis="blk")
        dist, report = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=8, cg_iters=96, sep=3
        )
        assert report["dropped_obs"] == 0, report
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=3e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=8e-3
        )

    def test_uneven_f_partial_last_block(self):
        """F = 25 on 7 blocks: fb = 4, last block owns 1 real + 3 padded
        poses (uneven division without whole empty blocks)."""
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem(n_kf=25, seed=9)
        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(7, axis="blk")
        dist, report = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=8, cg_iters=96, sep=3
        )
        assert report["fb"] == 4
        assert report["dropped_obs"] == 0, report
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=3e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=8e-3
        )

    def test_global_landmarks_exact_on_nonlocal_problem(self):
        """Observation spans of 13 frames >> any block window (fb=2,
        sep→2 ⇒ width 6): round 4 silently DROPPED those observations
        (VERDICT r4 weak #7); now they route to the replicated global
        factor group and the result matches the single-device optimizer
        on a problem window locality does NOT cover."""
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem(n_kf=16, span=6, seed=11)
        single = bundle_adjust(CAM, prob, iters=8)
        mesh = make_mesh(8, axis="blk")
        dist, report = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=8, cg_iters=128, sep=3
        )
        assert report["dropped_obs"] == 0, report
        assert report["global_lm"] > 0, report
        assert report["global_obs"] > 0
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(single.kf_t), atol=3e-3
        )
        np.testing.assert_allclose(
            np.asarray(dist.points), np.asarray(single.points),
            atol=5e-3,
        )
        np.testing.assert_allclose(
            np.asarray(dist.kf_t), np.asarray(gt_t), atol=8e-3
        )

    def test_lcp_pose_factors_all_three_paths_agree(self):
        """Keyframe-pair loop-closure pose factors (BaProblem.lcp_*)
        must be consumed identically by bundle_adjust, the landmark-
        sharded path, and the pose-sharded path (VERDICT r4 #3: 'consume
        it in BOTH backend/ba.py and the sharded paths')."""
        from pre3_tpu.geometry.quaternion import qconj, qprod, qrotate
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, gt_t = self._corridor_problem(n_kf=16, seed=13)
        # fabricate a loop-closure factor between kf 2 and kf 13 with
        # the ground-truth relative pose (identity rotation corridor)
        i, j = 2, 13
        rel_t = qrotate(qconj(prob.kf_q[i]), gt_t[j] - gt_t[i])
        rel_q = qprod(qconj(prob.kf_q[i]), prob.kf_q[j])
        prob = prob._replace(
            lcp_i=jnp.asarray([i], jnp.int32),
            lcp_j=jnp.asarray([j], jnp.int32),
            lcp_t=rel_t[None], lcp_q=rel_q[None],
            lcp_w=jnp.ones(1, jnp.float32),
        )
        single = bundle_adjust(CAM, prob, iters=8)
        mesh_lm = make_mesh(8, axis="lm")
        lm_sharded = bundle_adjust_sharded(mesh_lm, CAM, prob, iters=8)
        mesh_blk = make_mesh(8, axis="blk")
        pose_sharded, report = bundle_adjust_pose_sharded(
            mesh_blk, CAM, prob, iters=8, cg_iters=128, sep=3
        )
        np.testing.assert_allclose(
            np.asarray(lm_sharded.kf_t), np.asarray(single.kf_t),
            atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(pose_sharded.kf_t), np.asarray(single.kf_t),
            atol=3e-3,
        )
        np.testing.assert_allclose(
            float(pose_sharded.cost[0]), float(single.cost[0]),
            rtol=1e-4,
        )
        np.testing.assert_allclose(
            float(lm_sharded.cost[0]), float(single.cost[0]), rtol=1e-4
        )

    def test_cost_history_includes_initial_cost(self):
        """cost[0] must be the PRE-optimization cost in all three BA
        implementations (ADVICE r4): len == iters+1 and cost[0] matches
        bundle_adjust's cost[0] on the same problem."""
        from pre3_tpu.parallel.ba_pose_sharded import (
            bundle_adjust_pose_sharded,
        )

        prob, _ = self._corridor_problem(n_kf=16, seed=5)
        single = bundle_adjust(CAM, prob, iters=4)
        mesh = make_mesh(4, axis="blk")
        dist, _ = bundle_adjust_pose_sharded(
            mesh, CAM, prob, iters=4, cg_iters=64, sep=3
        )
        assert dist.cost.shape[0] == 5
        np.testing.assert_allclose(
            float(dist.cost[0]), float(single.cost[0]), rtol=1e-4
        )
        assert float(dist.cost[-1]) < float(dist.cost[0])
