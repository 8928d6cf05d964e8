"""Degraded-input robustness (VERDICT r4 #6): the reference's sensor
gates exist because real SR4000 data is dirty — NaN depth holes
(inittialize_depth_my_version.m:74-88), low-confidence pixels
(code_from_dr_ye/confidence_filtering.m:1-14), saturated intensity
(read_image_sr4000.m:8-23) — and the RANSAC/gating stack must also
survive dynamic outlier objects the rigid-motion model cannot explain.

Each test corrupts the clean synthetic sequence at sensor-realistic
rates, runs the full SLAM pipeline, and pins an ATE degradation bound
(measured values recorded in the round-5 record).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pre3_tpu.data.synthetic import (
    make_scene, make_trajectory, render_frame, render_sequence,
)
from pre3_tpu.ekf.slam import SlamConfig, run_slam
from pre3_tpu.eval.trajectory import ate_rmse
from pre3_tpu.frontend.pipeline import extract_features_sift
from pre3_tpu.geometry.camera import sr4000_camera

N_FRAMES = 48
CFG = SlamConfig(min_measured=50)
CAM = sr4000_camera()


def _run(intensity, xyz, conf, key=0):
    @jax.jit
    def pipe(i, x, c, k):
        fs = jax.vmap(extract_features_sift)(i, x, c)
        return run_slam(CAM, fs, k, cfg=CFG, n_landmarks=128)

    return pipe(
        jnp.asarray(intensity), jnp.asarray(np.nan_to_num(xyz)),
        jnp.asarray(conf), jax.random.PRNGKey(key),
    )


def _stack(frames):
    return (
        np.stack([f.intensity for f in frames]),
        np.stack([f.xyz for f in frames]),
        np.stack([f.confidence for f in frames]),
    )


@pytest.fixture(scope="module")
def clean_seq():
    frames, traj, scene = render_sequence(
        n_frames=N_FRAMES, n_points=300, noise=0.004
    )
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    return frames, traj, scene, gt


@pytest.fixture(scope="module")
def clean_ate(clean_seq):
    frames, _, _, gt = clean_seq
    out = _run(*_stack(frames))
    return float(ate_rmse(np.asarray(out.t), gt, align=False))


def _blocks(rng, img_shape, frac, size):
    """Random block mask covering ≈frac of the image."""
    h, w = img_shape
    m = np.zeros((h, w), bool)
    n_blocks = int(frac * h * w / (size * size))
    for _ in range(n_blocks):
        r = rng.integers(0, h - size)
        c = rng.integers(0, w - size)
        m[r:r + size, c:c + size] = True
    return m


@pytest.mark.slow
def test_nan_depth_holes(clean_seq, clean_ate):
    """≈15% of depth pixels NaN'd in random blobs per frame — the
    background-return dropouts the reference discards keypoints over
    (inittialize_depth_my_version.m:74: NaN depth → feature skipped)."""
    frames, _, _, gt = clean_seq
    rng = np.random.default_rng(7)
    i_, x_, c_ = _stack(frames)
    x_ = x_.copy()
    for f in range(N_FRAMES):
        m = _blocks(rng, x_.shape[1:3], 0.15, 6)
        x_[f][m] = np.nan
    out = _run(i_, x_, c_)
    ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
    print(f"corrupted ate {ate:.4f} vs clean {clean_ate:.4f}")
    assert ate < max(3.0 * clean_ate, 0.08), (ate, clean_ate)


@pytest.mark.slow
def test_confidence_dropout(clean_seq, clean_ate):
    """≈20% of pixels at near-zero confidence per frame — the SR4000
    confidence map the reference gates lifts on
    (confidence_filtering.m:1-14: conf ≤ 0.5·max → discard)."""
    frames, _, _, gt = clean_seq
    rng = np.random.default_rng(11)
    i_, x_, c_ = _stack(frames)
    c_ = c_.copy()
    for f in range(N_FRAMES):
        m = _blocks(rng, c_.shape[1:3], 0.20, 8)
        c_[f][m] = 0.02
    out = _run(i_, x_, c_)
    ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
    print(f"corrupted ate {ate:.4f} vs clean {clean_ate:.4f}")
    assert ate < max(3.0 * clean_ate, 0.08), (ate, clean_ate)


@pytest.mark.slow
def test_saturated_intensity(clean_seq, clean_ate):
    """Blown-highlight patches (intensity clamped to max, ≈8%/frame) —
    the >65000 saturation clamp of read_image_sr4000.m:8-23. Saturated
    regions carry no texture; features there die but the pipeline must
    not."""
    frames, _, _, gt = clean_seq
    rng = np.random.default_rng(13)
    i_, x_, c_ = _stack(frames)
    i_ = i_.copy()
    for f in range(N_FRAMES):
        m = _blocks(rng, i_.shape[1:3], 0.08, 10)
        i_[f][m] = 1.0
    out = _run(i_, x_, c_)
    ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
    print(f"corrupted ate {ate:.4f} vs clean {clean_ate:.4f}")
    assert ate < max(3.0 * clean_ate, 0.08), (ate, clean_ate)


@pytest.mark.slow
def test_moving_outlier_object(clean_ate):
    """A textured 20-point rigid cluster sweeping through the scene with
    its own motion: its features violate the static-world rigid model,
    so VO RANSAC (vo/ransac.py) and the 1-point RANSAC gating
    (one_point_ransac.py) must reject them — the dynamic-outlier case
    the reference's consensus machinery exists for."""
    scene = make_scene(n_points=300, seed=0)
    traj = make_trajectory(N_FRAMES, seed=1)
    n_mov = 20
    rng = np.random.default_rng(17)
    mov_base = np.stack([
        rng.uniform(-1.2, -0.6, n_mov),
        rng.uniform(-0.5, 0.5, n_mov),
        rng.uniform(1.6, 2.4, n_mov),
    ], axis=-1).astype(np.float32)
    vel = np.array([0.06, 0.004, 0.0], np.float32)  # crosses the FOV
    frames = []
    for f in range(N_FRAMES):
        pts = scene.points.copy()
        pts[:n_mov] = mov_base + vel * f
        frames.append(render_frame(
            scene._replace(points=pts), traj.t[f], traj.r[f],
            timestamp=0.1 * f, noise=0.004, seed=1000 + f,
        ))
    gt = (traj.t - traj.t[0]) @ traj.r[0]
    out = _run(*_stack(frames))
    ate = float(ate_rmse(np.asarray(out.t), gt, align=False))
    print(f"corrupted ate {ate:.4f} vs clean {clean_ate:.4f}")
    assert ate < max(3.0 * clean_ate, 0.08), (ate, clean_ate)
