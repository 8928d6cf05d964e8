"""Frontend tests: FAST detection, depth lift, descriptor matching.

Sequence-level oracle: the synthetic renderer (data/synthetic.py) places
textured landmarks at known world positions, so detected + lifted features
must back-project onto true landmarks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pre3_tpu.data.synthetic import make_scene, make_trajectory, render_frame
from pre3_tpu.frontend.fast import detect, fast_score_map
from pre3_tpu.frontend.depth_lift import lift
from pre3_tpu.ops.matching import match_descriptors


class TestFast:
    def test_synthetic_blob_detected(self):
        img = np.full((64, 64), 0.1, np.float32)
        img[30:33, 30:33] = 1.0  # bright 3×3 blob = strong corner everywhere
        c = detect(jnp.asarray(img), threshold=0.1, max_corners=8)
        assert int(c.valid.sum()) >= 1
        uv = np.asarray(c.uv[np.asarray(c.valid)])
        assert np.any(np.linalg.norm(uv - np.array([31, 31]), axis=-1) < 3)

    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 0.5)
        c = detect(img, threshold=0.05, max_corners=8)
        assert int(c.valid.sum()) == 0

    def test_border_excluded(self):
        score = fast_score_map(
            jnp.asarray(np.random.default_rng(0).uniform(size=(32, 32)).astype(np.float32)),
            threshold=0.01,
        )
        s = np.asarray(score)
        assert s[:3].sum() == 0 and s[-3:].sum() == 0
        assert s[:, :3].sum() == 0 and s[:, -3:].sum() == 0

    def test_rendered_frame_corners_near_landmarks(self):
        scene = make_scene(n_points=80, seed=3)
        traj = make_trajectory(1, seed=4)
        fr = render_frame(scene, traj.t[0], traj.r[0], 0.0, noise=0.003)
        c = detect(jnp.asarray(fr.intensity), threshold=0.08, max_corners=64)
        assert int(c.valid.sum()) > 10

        # project landmarks with ground truth and check detections are close
        from pre3_tpu.geometry import sr4000_camera, project

        cam = sr4000_camera()
        p_cam = (scene.points - traj.t[0]) @ traj.r[0]
        vis = p_cam[:, 2] > 0.3
        uv_gt = np.asarray(project(cam, jnp.asarray(p_cam[vis])))
        uv = np.asarray(c.uv[np.asarray(c.valid)])
        d = np.linalg.norm(uv[:, None] - uv_gt[None], axis=-1).min(axis=1)
        assert np.median(d) < 2.0


class TestDepthLift:
    def test_lift_validity_gates(self):
        xyz = np.zeros((16, 16, 3), np.float32)
        xyz[..., 2] = 2.0  # 2 m everywhere
        xyz[5, 5] = np.nan  # invalid pixel
        xyz[6, 6] = [0, 0, 0.1]  # too close
        conf = np.ones((16, 16), np.float32)
        conf[7, 7] = 0.1  # low confidence
        uv = jnp.asarray([[5, 5], [6, 6], [7, 7], [8, 8]], jnp.float32)
        ok = jnp.ones(4, bool)
        out = lift(uv, ok, jnp.asarray(xyz), jnp.asarray(conf))
        np.testing.assert_array_equal(
            np.asarray(out.valid), [False, False, False, True]
        )
        np.testing.assert_allclose(out.xyz[3], [0, 0, 2.0])


class TestMatching:
    def _descs(self, n=64, d=32, seed=0):
        rng = np.random.default_rng(seed)
        d2 = rng.normal(size=(n, d)).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
        perm = rng.permutation(n)
        noise = rng.normal(scale=0.05, size=(n, d)).astype(np.float32)
        d1 = d2[perm] + noise
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        return jnp.asarray(d1), jnp.asarray(d2), perm

    def test_permutation_recovered(self):
        d1, d2, perm = self._descs()
        m = match_descriptors(d1, d2, ratio=1.2)
        acc = np.asarray(m.accepted)
        assert acc.mean() > 0.9
        np.testing.assert_array_equal(np.asarray(m.index)[acc], perm[acc])

    def test_ratio_test_rejects_ambiguous(self):
        # two identical columns ⇒ best ≈ second ⇒ rejected
        d2 = jnp.asarray(np.eye(4, 8, dtype=np.float32))
        d2 = jnp.concatenate([d2, d2[:1]], axis=0)  # duplicate row 0
        d1 = d2[:1]
        m = match_descriptors(d1, d2, ratio=1.5)
        assert not bool(m.accepted[0])

    def test_valid_masks(self):
        d1, d2, perm = self._descs(seed=1)
        valid2 = jnp.zeros(d2.shape[0], bool)
        m = match_descriptors(d1, d2, valid2=valid2)
        assert not np.any(np.asarray(m.accepted))

    def test_matches_numpy_non_tile_shape(self):
        """100 × 77 × 40: no dimension is a power-of-two tile."""
        d1, _, _ = self._descs(n=100, d=40, seed=2)
        d2 = d1[:77] + 0.03 * jax.random.normal(jax.random.PRNGKey(0),
                                                (77, 40))
        m = match_descriptors(d1, d2, ratio=1.3)
        ref = numpy_match(d1, d2, ratio=1.3)
        np.testing.assert_array_equal(np.asarray(m.index), ref[0])
        np.testing.assert_array_equal(np.asarray(m.accepted), ref[3])
        np.testing.assert_allclose(np.asarray(m.dist2), ref[1], atol=1e-5)
        np.testing.assert_allclose(np.asarray(m.dist2_second), ref[2],
                                   atol=1e-5)


def numpy_match(d1, d2, ratio, pair_mask=None):
    """float64 brute force: (best index, best, second, accepted)."""
    d1, d2 = np.asarray(d1, np.float64), np.asarray(d2, np.float64)
    dist = np.sum((d1[:, None] - d2[None]) ** 2, -1)
    if pair_mask is not None:
        dist = np.where(pair_mask, dist, 1e30)
    idx = np.argmin(dist, -1)
    srt = np.sort(dist, -1)
    acc = (srt[:, 0] * ratio < srt[:, 1]) & (srt[:, 0] < 1e30)
    return idx, srt[:, 0], srt[:, 1], acc


@pytest.mark.parametrize("n1,n2,d,gated", [
    (256, 256, 121, False),  # VO dead reckoning: FAST 11×11 patches
    (256, 288, 128, True),  # EKF search: map × SIFT frame, ellipse gate
    (256, 288, 128, False),  # backend track table × SIFT frame
    (288, 288, 128, False),  # loop detection: keyframe × keyframe
])
def test_match_descriptors_call_site_shapes(n1, n2, d, gated):
    """The matcher at the shapes of its four pipeline call sites
    (vo/dead_reckoning.py, ekf/measurement.py, backend/tracks.py,
    backend/loop_detect.py) against a float64 brute force."""
    rng = np.random.default_rng(n1 + n2 + d)
    d2 = rng.random((n2, d)) ** 3
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    d1 = d2[rng.permutation(n2)[:n1]] + rng.normal(scale=0.02, size=(n1, d))
    d1[rng.uniform(size=n1) < 0.2] = rng.random(d)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    valid1 = rng.uniform(size=n1) < 0.9
    valid2 = rng.uniform(size=n2) < 0.9
    mask = rng.uniform(size=(n1, n2)) < 0.5 if gated else None
    m = jax.jit(match_descriptors, static_argnames=("ratio",))(
        jnp.asarray(d1, jnp.float32), jnp.asarray(d2, jnp.float32),
        valid1=jnp.asarray(valid1), valid2=jnp.asarray(valid2), ratio=1.5,
        pair_mask=None if mask is None else jnp.asarray(mask),
    )
    gate = valid2[None, :] if mask is None else mask & valid2[None, :]
    idx, best, _, acc = numpy_match(d1, d2, 1.5, gate)
    acc &= valid1
    np.testing.assert_array_equal(np.asarray(m.accepted), acc)
    np.testing.assert_array_equal(np.asarray(m.index)[acc], idx[acc])
    np.testing.assert_allclose(np.asarray(m.dist2)[acc], best[acc],
                               atol=1e-5)


def test_match_pair_mask_recovers_in_gate_runner_up():
    """gate-first matching (VERDICT r3 #9): a landmark whose GLOBAL best
    descriptor match lies outside the search gate must still match the
    correct in-gate runner-up once the ellipse mask is applied before
    the ratio test."""
    import jax.numpy as jnp
    import numpy as np

    from pre3_tpu.ops.matching import match_descriptors

    rng = np.random.default_rng(0)
    d_true = rng.normal(size=(128,)).astype(np.float32)
    d_true /= np.linalg.norm(d_true)
    # frame: feature 0 = near-identical distractor (out of gate),
    # feature 1 = the true match (in gate), feature 2 = unrelated
    jitter = rng.normal(scale=0.01, size=(128,)).astype(np.float32)
    d2 = np.stack([
        d_true + 0.9 * jitter,  # distractor: globally closest
        d_true + 1.0 * jitter,
        rng.normal(size=(128,)).astype(np.float32),
    ])
    d1 = d_true[None]
    # global order: best = 0 (distractor), runner-up = 1 (true)
    m_global = match_descriptors(jnp.asarray(d1), jnp.asarray(d2),
                                 ratio=1.5)
    assert int(m_global.index[0]) == 0
    # near-duplicate best/second (0.81 vs 1.0 in squared dist) →
    # the global ratio test kills the match entirely
    assert not bool(m_global.accepted[0])
    # gate excludes the distractor → the true match wins and accepts
    mask = jnp.asarray([[False, True, True]])
    m_gated = match_descriptors(jnp.asarray(d1), jnp.asarray(d2),
                                ratio=1.5, pair_mask=mask)
    assert int(m_gated.index[0]) == 1
    assert bool(m_gated.accepted[0])
