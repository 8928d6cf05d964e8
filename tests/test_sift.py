"""SIFT frontend tests: pyramid properties, detection, descriptor
invariances, and cross-frame matching on rendered scenes.

Mirrors what the reference verifies by hand (test_sift_tracking.m —
descriptor track consistency across frames), plus property tests the
reference lacks.
"""

import jax.numpy as jnp
import numpy as np

from pre3_tpu.data.synthetic import make_scene, make_trajectory, render_frame
from pre3_tpu.frontend.scalespace import build_pyramid, gaussian_blur
from pre3_tpu.frontend.sift import extract_sift
from pre3_tpu.ops.matching import match_descriptors


def blob_image(h=96, w=128, centers=((40, 50, 3.0), (70, 90, 5.0)), amp=1.0):
    """Gaussian blobs — DoG extrema at known positions/scales."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for cy, cx, s in centers:
        img += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return jnp.asarray(img.astype(np.float32))


class TestScaleSpace:
    def test_blur_preserves_mean(self):
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.uniform(size=(64, 64)).astype(np.float32))
        out = gaussian_blur(img, 2.0)
        # interior mean is preserved (edges clamp to zero padding)
        np.testing.assert_allclose(
            float(jnp.mean(out[8:-8, 8:-8])),
            float(jnp.mean(img[8:-8, 8:-8])),
            atol=0.02,
        )

    def test_pyramid_shapes(self):
        img = blob_image()
        octs = build_pyramid(img, n_octaves=3, s_levels=3)
        assert len(octs) == 3
        assert octs[0].gss.shape == (6, 96, 128)
        assert octs[0].dog.shape == (5, 96, 128)
        assert octs[1].gss.shape == (6, 48, 64)
        assert octs[2].gss.shape == (6, 24, 32)

    def test_dog_energy_decreases_with_smoothing(self):
        img = blob_image()
        octs = build_pyramid(img, n_octaves=1)
        # successive gss levels are progressively smoother
        tv = [float(jnp.abs(jnp.diff(octs[0].gss[s], axis=0)).sum())
              for s in range(6)]
        assert all(tv[i] >= tv[i + 1] for i in range(5))


class TestSiftDetect:
    def test_blob_detected_at_location(self):
        img = blob_image(centers=((48, 64, 2.5),))
        f = extract_sift(img, n_octaves=2, keypoints_per_octave=16)
        uv = np.asarray(f.uv[np.asarray(f.valid)])
        assert len(uv) >= 1
        d = np.linalg.norm(uv - np.array([64, 48]), axis=-1)
        assert d.min() < 2.0

    def test_scale_estimate_tracks_blob_size(self):
        small = extract_sift(blob_image(centers=((48, 64, 2.0),)),
                             n_octaves=3, keypoints_per_octave=8)
        large = extract_sift(blob_image(centers=((48, 64, 6.0),)),
                            n_octaves=3, keypoints_per_octave=8)

        def best_scale(f, target):
            uv = np.asarray(f.uv)
            ok = np.asarray(f.valid)
            d = np.linalg.norm(uv - np.array(target), axis=-1)
            d[~ok] = 1e9
            return float(np.asarray(f.scale)[np.argmin(d)])

        s_small = best_scale(small, [64, 48])
        s_large = best_scale(large, [64, 48])
        assert s_large > s_small

    def test_flat_image_no_keypoints(self):
        f = extract_sift(jnp.full((96, 128), 0.5), keypoints_per_octave=8)
        assert int(f.valid.sum()) == 0


class TestSiftDescriptor:
    def test_descriptor_normalized(self):
        scene = make_scene(n_points=60, seed=0)
        traj = make_trajectory(1, seed=1)
        fr = render_frame(scene, traj.t[0], traj.r[0], 0.0, noise=0.003)
        f = extract_sift(jnp.asarray(fr.intensity), keypoints_per_octave=64)
        ok = np.asarray(f.valid)
        norms = np.linalg.norm(np.asarray(f.desc)[ok], axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-3)

    def test_cross_frame_matching(self):
        """Descriptors of the same landmarks in consecutive frames match
        (the test_sift_tracking.m scenario, with ground truth)."""
        scene = make_scene(n_points=150, seed=2)
        traj = make_trajectory(2, seed=3)
        fr0 = render_frame(scene, traj.t[0], traj.r[0], 0.0, noise=0.003)
        fr1 = render_frame(scene, traj.t[1], traj.r[1], 0.1, noise=0.003,
                           seed=7)
        f0 = extract_sift(jnp.asarray(fr0.intensity), keypoints_per_octave=96)
        f1 = extract_sift(jnp.asarray(fr1.intensity), keypoints_per_octave=96)
        m = match_descriptors(f0.desc, f1.desc, valid1=f0.valid,
                              valid2=f1.valid, ratio=1.3)
        acc = np.asarray(m.accepted)
        assert acc.sum() >= 30, f"only {acc.sum()} SIFT matches"
        # matched pixel displacement must be small (small camera motion)
        uv0 = np.asarray(f0.uv)[acc]
        uv1 = np.asarray(f1.uv)[np.asarray(m.index)[acc]]
        disp = np.linalg.norm(uv0 - uv1, axis=-1)
        assert np.median(disp) < 10.0

    def test_rotation_invariance_with_orientation(self):
        """With upright=False, descriptors match across a 90° image
        rotation (the rotation invariance the reference's orientation
        assignment provides)."""
        scene = make_scene(n_points=120, seed=4)
        traj = make_trajectory(1, seed=5)
        fr = render_frame(scene, traj.t[0], traj.r[0], 0.0, noise=0.002)
        img = jnp.asarray(fr.intensity)
        rot = jnp.rot90(img)
        f0 = extract_sift(img, keypoints_per_octave=96, upright=False)
        f1 = extract_sift(rot, keypoints_per_octave=96, upright=False)
        m = match_descriptors(f0.desc, f1.desc, valid1=f0.valid,
                              valid2=f1.valid, ratio=1.3)
        acc = np.asarray(m.accepted)
        assert acc.sum() >= 10, f"only {acc.sum()} rotated matches"
        # verify geometric consistency: rot90 maps (u, v) → (v, W-1-u)
        h, w = img.shape
        uv0 = np.asarray(f0.uv)[acc]
        uv1 = np.asarray(f1.uv)[np.asarray(m.index)[acc]]
        expect = np.stack([uv0[:, 1], w - 1 - uv0[:, 0]], axis=-1)
        d = np.linalg.norm(uv1 - expect, axis=-1)
        assert np.median(d) < 3.0


def _rotate_image(img: jnp.ndarray, deg: float) -> jnp.ndarray:
    """Rotate about the image center (bilinear, zero fill)."""
    from jax.scipy.ndimage import map_coordinates

    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = np.deg2rad(deg)
    yy, xx = jnp.mgrid[0:h, 0:w]
    # source coords = R(-θ) applied to dest offsets
    dy, dx = yy - cy, xx - cx
    sy = cy + np.cos(th) * dy - np.sin(th) * dx
    sx = cx + np.sin(th) * dy + np.cos(th) * dx
    return map_coordinates(img, [sy, sx], order=1, mode="constant")


def _uv_rotated(uv: np.ndarray, shape, deg: float) -> np.ndarray:
    h, w = shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = np.deg2rad(deg)
    du, dv = uv[:, 0] - cx, uv[:, 1] - cy
    return np.stack(
        [cx + np.cos(th) * du - np.sin(th) * dv,
         cy + np.sin(th) * du + np.cos(th) * dv], axis=-1,
    )


class TestMultiOrientation:
    def test_second_peak_emitted(self):
        """upright=False doubles capacity; keypoints with a qualifying
        second histogram peak (≥ 0.8·max, sift_vedal.m:232-317) appear as
        valid duplicates at the same location with a different θ."""
        scene = make_scene(n_points=150, seed=8)
        traj = make_trajectory(1, seed=9)
        fr = render_frame(scene, traj.t[0], traj.r[0], 0.0, noise=0.002)
        f_up = extract_sift(jnp.asarray(fr.intensity),
                            keypoints_per_octave=96)
        f = extract_sift(jnp.asarray(fr.intensity), keypoints_per_octave=96,
                         upright=False)
        assert f.uv.shape[0] == 2 * f_up.uv.shape[0]
        # layout: per octave, [kpo primary | kpo second-peak duplicates]
        kpo = 96
        valid = np.asarray(f.valid)
        uv, th = np.asarray(f.uv), np.asarray(f.orientation)
        n_second = 0
        for o in range(f.uv.shape[0] // (2 * kpo)):
            first = valid[2 * kpo * o: 2 * kpo * o + kpo]
            second = valid[2 * kpo * o + kpo: 2 * kpo * (o + 1)]
            assert (second & ~first).sum() == 0  # copies of valid slots only
            dup = np.where(second)[0] + 2 * kpo * o
            np.testing.assert_allclose(uv[dup + kpo], uv[dup], atol=1e-5)
            # distinct local maxima are ≥ 2 histogram bins apart; parabolic
            # refinement can shift each by up to ±½ bin → floor ≈ 1 bin
            dth = np.abs(np.angle(np.exp(1j * (th[dup + kpo] - th[dup]))))
            assert (dth > 0.15).all(), "second peak should differ in angle"
            n_second += second.sum()
        assert n_second > 0, "no second-orientation keypoints emitted"

    def test_repeatability_vs_rotation_angle(self):
        """Match rate of upright=False descriptors under in-plane rotation
        (the reference's siftormx.c rotation invariance). Match rate =
        accepted matches with correct geometry / min(valid kp counts);
        numbers recorded in PARITY.md §C15."""
        scene = make_scene(n_points=150, seed=10)
        traj = make_trajectory(1, seed=11)
        fr = render_frame(scene, traj.t[0], traj.r[0], 0.0, noise=0.002)
        img = jnp.asarray(fr.intensity)
        f0 = extract_sift(img, keypoints_per_octave=96, upright=False)
        rates = {}
        for deg in (15.0, 45.0, 75.0):
            f1 = extract_sift(_rotate_image(img, deg),
                              keypoints_per_octave=96, upright=False)
            m = match_descriptors(f0.desc, f1.desc, valid1=f0.valid,
                                  valid2=f1.valid, ratio=1.3)
            acc = np.asarray(m.accepted)
            uv1 = np.asarray(f1.uv)[np.asarray(m.index)[acc]]
            expect = _uv_rotated(np.asarray(f0.uv)[acc], img.shape, deg)
            good = np.linalg.norm(uv1 - expect, axis=-1) < 4.0
            n0 = int(np.asarray(f0.valid).sum())
            n1 = int(np.asarray(f1.valid).sum())
            rates[deg] = good.sum() / max(min(n0, n1), 1)
        # rotation must not collapse matching (an upright extractor scores
        # ~0 at 45°); exact rates are recorded in PARITY.md
        assert min(rates.values()) > 0.10, rates


class TestFastMathBranches:
    """The opt-in bf16 matmul branch (PRE3_SIFT_FAST_MATH=1) on CPU,
    against the exact f32 path (=0): the fast path must stay numerically
    close to the exact path — descriptor matches agree and
    keypoint sets overlap strongly."""

    def test_fast_branch_close_to_exact_on_cpu(self, monkeypatch):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from pre3_tpu.data.synthetic import render_sequence
        from pre3_tpu.frontend.pipeline import extract_features_sift

        frames, _, _ = render_sequence(n_frames=1, n_points=300,
                                       noise=0.004)
        f = frames[0]
        args = (jnp.asarray(f.intensity), jnp.asarray(f.xyz),
                jnp.asarray(f.confidence))

        def run():
            # fresh jit wrapper per branch: _fast_math() is read at trace
            # time, so a shared cache would pin the first branch
            return jax.jit(
                lambda i, x, c: extract_features_sift(
                    i, x, c, keypoints_per_octave=48
                )
            )(*args)

        monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "0")
        exact = run()
        monkeypatch.setenv("PRE3_SIFT_FAST_MATH", "1")
        fast = run()

        uv_e = np.asarray(exact.uv)[np.asarray(exact.valid)]
        uv_f = np.asarray(fast.uv)[np.asarray(fast.valid)]
        assert len(uv_f) > 0.8 * len(uv_e)
        # ≥80% of exact keypoints have a fast keypoint within 1 px
        d = np.linalg.norm(uv_e[:, None] - uv_f[None], axis=-1)
        overlap = (d.min(axis=1) < 1.0).mean()
        assert overlap > 0.8, f"keypoint overlap {overlap:.2f}"
        # descriptors at co-located keypoints are close (bf16 tolerance)
        pairs = np.nonzero(d.min(axis=1) < 0.25)[0]
        j = d.argmin(axis=1)[pairs]
        de = np.asarray(exact.desc)[np.asarray(exact.valid)][pairs]
        df = np.asarray(fast.desc)[np.asarray(fast.valid)][j]
        cos = np.sum(de * df, -1) / np.maximum(
            np.linalg.norm(de, axis=-1) * np.linalg.norm(df, axis=-1),
            1e-9,
        )
        assert len(pairs) >= 10
        assert float(np.median(cos)) > 0.99, float(np.median(cos))
