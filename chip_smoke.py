"""Smoke run of the SLAM main path on NVIDIA GPUs.

Run from the root of a checkout, one process per machine:

    python3 chip_smoke.py              # one GPU: every phase below
    python3 chip_smoke.py --devices 4  # four GPUs: the sharded paths only

One-GPU phases, all at the sizes bench.py measures (SR4000 frames at
176×144, the 256-frame corridor, SIFT 3 octaves × 96 keypoints, VO RANSAC
at 512 hypotheses, inverse-depth EKF with 1-point RANSAC at K=256):

  device     the first JAX device must be a GPU; name and power limit
  kernels    RANSAC scoring, descriptor matching, the unrolled 6×6
             Cholesky solve and the closed-form 3×3 SVD at real widths,
             each against a float64 NumPy reference
  headline   vmapped SIFT frontend + run_slam as one program, K=256 and
             K=64: compile time, steady-state time, ATE
  fast_ncc   FAST frontend + NCC patch matcher SLAM: time, ATE
  vo         VO dead reckoning: time, ATE
  backend    keyframes → BA problem → Schur BA → smoothing on the
             headline output: BA ATE
  streaming  OnlineSlam: per-frame process() then two process_chunk(16)

Each ATE bound is a constant below, set from a CPU run of the same phase
with the same seed, SEED (PERF.md). Any failed phase ends the run with a
non-zero exit. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np

# Seed of every PRNG key and every generated input below; the ATE bounds
# hold for this seed only.
SEED = 0

# ATE bounds [m]: max(1.5 × CPU, CPU + 0.1) of the same phase and seeds,
# the CPU value being the worst over PRNG keys SEED+0..3 of a
# JAX_PLATFORMS=cpu run (PERF.md, "ATE bounds"); headline bounds capped
# at 0.2 m. The additive term covers CPU/GPU divergence of the chaotic
# EKF trajectory (FAST+NCC: 0.0579 m CPU vs 0.0954 m H100, same key).
ATE_BOUND = {
    "headline_k256": 0.2,  # CPU 0.1250
    "headline_k64": 0.2,  # CPU 0.1108
    "fast_ncc": 0.1899,  # CPU 0.0899
    "vo": 1.275,  # CPU 0.8500 (dead reckoning drifts without a map)
    "backend": 0.2556,  # CPU 0.1556
    "streaming": 0.1482,  # CPU 0.0482 over 40 frames
}

# Parity tolerances, each against float64 NumPy.
SCORE_ERR_RTOL = 1e-3  # mean inlier error, fp32 elementwise on device
SCORE_BAND_RTOL = 1e-4  # |resid² − gate| below this·gate is a tie
MATCH_MIN_AGREE = 0.99  # best-index / accept agreement, TF32 products
CHOL_RTOL = 5e-4  # ‖y − y_ref‖/‖y_ref‖, cond(S) ≤ 100, fp32
SVD_SIGMA_RTOL = 2e-2  # |σ − σ_ref| ≤ this·σ₁ (svd3's AᵀA f32 floor)
SVD_ORTHO_ATOL = 1e-3  # ‖UᵀU − I‖∞ and ‖VᵀV − I‖∞


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def require_gpus(n: int):
    """The first n JAX devices, which must be GPUs; exits otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(
            f"chip_smoke: needs {n} GPU(s), JAX has {len(devs)} "
            f"{devs[0].platform} device(s)", file=sys.stderr,
        )
        sys.exit(2)
    return devs[:n]


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def check_ate(name: str, ate: float) -> None:
    check(np.isfinite(ate) and ate <= ATE_BOUND[name],
          f"{name}: ATE {ate:.4f} m exceeds bound {ATE_BOUND[name]} m")


# ---------------------------------------------------------------------------
# Kernels at real widths
# ---------------------------------------------------------------------------


def _rot(rng, deg: float, size: int) -> np.ndarray:
    """[size, 3, 3] rotations about random axes by N(0, deg) degrees."""
    axis = rng.normal(size=(size, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.deg2rad(rng.normal(scale=deg, size=(size, 1, 1)))
    k = np.zeros((size, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    k = k - np.swapaxes(k, 1, 2)
    return np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)


def scoring_case(rng, b: int, n: int):
    """RANSAC scoring problem at SR4000 scale: 70% inliers of a ~2°/3 cm
    motion, hypotheses perturbed around it, the ransac_rigid default
    gate 0.001·(nearest range)."""
    p2 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                   rng.uniform(0.8, 4.0, n)], axis=-1)
    r0, t0 = _rot(rng, 2.0, 1)[0], rng.normal(scale=0.03, size=3)
    p1 = p2 @ r0.T + t0 + rng.normal(scale=0.003, size=(n, 3))
    out = rng.uniform(size=n) < 0.3
    p1[out] += rng.normal(scale=0.3, size=(int(out.sum()), 3))
    valid = rng.uniform(size=n) < 0.9
    r = _rot(rng, 1.0, b) @ r0
    t = t0 + rng.normal(scale=0.01, size=(b, 3))
    thr = 0.001 * np.sqrt(np.min(np.sum(p2[valid] ** 2, -1)))
    return r, t, p1, p2, valid, thr


def score_reference(r, t, p1, p2, valid, thr):
    """float64 support, mean inlier error, and tie-band count per row."""
    pred = np.einsum("bij,nj->bni", r, p2) + t[:, None]
    resid2 = np.sum((pred - p1[None]) ** 2, -1)
    inl = (resid2 < thr) & valid[None]
    sup = inl.sum(-1)
    err = np.where(inl, resid2, 0).sum(-1) / np.maximum(sup, 1)
    band = ((np.abs(resid2 - thr) <= SCORE_BAND_RTOL * thr)
            & valid[None]).sum(-1)
    return sup, err, band


def check_scoring(rng, b: int, n: int) -> None:
    import jax
    import jax.numpy as jnp

    from pre3_tpu.ops.ransac_score import score_hypotheses

    case = scoring_case(rng, b, n)
    sup_ref, err_ref, band = score_reference(*case)
    f32 = [jnp.asarray(a, jnp.float32) for a in case[:4]]
    sup, err = jax.jit(score_hypotheses)(
        *f32, jnp.asarray(case[4]), jnp.float32(case[5])
    )
    sup, err = np.asarray(sup), np.asarray(err)
    exact = band == 0
    check(np.array_equal(sup[exact], sup_ref[exact]),
          f"scoring B={b} N={n}: support differs from float64")
    check(np.all(np.abs(sup - sup_ref) <= band),
          f"scoring B={b} N={n}: support off by more than the tie band")
    same = sup == sup_ref
    rel = np.abs(err - err_ref)[same] / np.maximum(err_ref[same], 1e-12)
    check(float(rel.max()) <= SCORE_ERR_RTOL,
          f"scoring B={b} N={n}: mean error rel {rel.max():.2e}")
    say(f"kernels  score_hypotheses B={b} N={n}: support equal on "
        f"{int(same.sum())}/{b} rows ({int((~exact).sum())} rows with a "
        f"tie-band pair), mean-err max rel {rel.max():.2e} "
        f"(tol {SCORE_ERR_RTOL}), mean support {sup.mean():.1f}")


def sift_like(rng, n: int, d: int = 128) -> np.ndarray:
    x = rng.random((n, d)) ** 3
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x = np.minimum(x, 0.2)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def check_matching(rng, n: int, d: int = 128) -> None:
    import jax
    import jax.numpy as jnp

    from pre3_tpu.ops.matching import match_descriptors

    d2 = sift_like(rng, n, d)
    perm = rng.permutation(n)
    d1 = d2[perm] + rng.normal(scale=0.02, size=(n, d))
    fresh = rng.uniform(size=n) < 0.2  # rows with no true partner
    d1[fresh] = sift_like(rng, int(fresh.sum()), d)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)

    dist = np.sum((d1[:, None] - d2[None]) ** 2, -1)
    idx_ref = np.argmin(dist, -1)
    srt = np.sort(dist, -1)
    acc_ref = srt[:, 0] * 1.5 < srt[:, 1]

    m = jax.jit(match_descriptors)(jnp.asarray(d1, jnp.float32),
                                   jnp.asarray(d2, jnp.float32))
    idx_agree = float(np.mean(np.asarray(m.index) == idx_ref))
    acc_agree = float(np.mean(np.asarray(m.accepted) == acc_ref))
    check(idx_agree >= MATCH_MIN_AGREE and acc_agree >= MATCH_MIN_AGREE,
          f"matching {n}x{n}x{d}: index agree {idx_agree:.4f}, "
          f"accept agree {acc_agree:.4f} (min {MATCH_MIN_AGREE})")
    say(f"kernels  match_descriptors {n}x{n}x{d}: best-index agreement "
        f"{idx_agree:.4f}, accept agreement {acc_agree:.4f} "
        f"(min {MATCH_MIN_AGREE}), accepted {int(acc_ref.sum())}/{n}")


def check_chol(rng, b: int = 256, n: int = 6) -> None:
    import jax
    import jax.numpy as jnp

    from pre3_tpu.ops.small_chol import chol_solve_unrolled

    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    lam = 10.0 ** rng.uniform(-2, 0, size=(b, n))
    s = q @ (lam[..., None] * np.swapaxes(q, 1, 2))
    rhs = rng.normal(size=(b, n))
    y_ref = np.linalg.solve(s, rhs[..., None])[..., 0]
    y = np.asarray(jax.jit(chol_solve_unrolled)(
        jnp.asarray(s, jnp.float32), jnp.asarray(rhs, jnp.float32)
    ))
    rel = np.linalg.norm(y - y_ref, axis=-1) / np.linalg.norm(y_ref, axis=-1)
    check(float(rel.max()) <= CHOL_RTOL,
          f"chol_solve_unrolled: rel err {rel.max():.2e}")
    say(f"kernels  chol_solve_unrolled B={b} {n}x{n}: max rel err "
        f"{rel.max():.2e} (tol {CHOL_RTOL})")


def check_svd3(rng, b: int = 4096) -> None:
    import jax
    import jax.numpy as jnp

    from pre3_tpu.ops.svd3 import svd3

    a = rng.normal(size=(b, 3, 3))
    u, s, vt = (np.asarray(x, np.float64)
                for x in jax.jit(svd3)(jnp.asarray(a, jnp.float32)))
    s_ref = np.linalg.svd(a, compute_uv=False)
    s_err = float((np.abs(s - s_ref) / s_ref[:, :1]).max())
    eye = np.eye(3)
    ortho = max(float(np.abs(np.swapaxes(u, 1, 2) @ u - eye).max()),
                float(np.abs(vt @ np.swapaxes(vt, 1, 2) - eye).max()))
    rec = float((np.abs(u @ (s[..., None] * vt) - a).max(axis=(1, 2))
                 / np.abs(a).max(axis=(1, 2))).max())
    check(s_err <= SVD_SIGMA_RTOL and ortho <= SVD_ORTHO_ATOL
          and rec <= SVD_SIGMA_RTOL,
          f"svd3: sigma {s_err:.2e}, ortho {ortho:.2e}, recon {rec:.2e}")
    say(f"kernels  svd3 B={b}: max |σ−σ_ref|/σ₁ {s_err:.2e}, orthogonality "
        f"{ortho:.2e}, reconstruction {rec:.2e}")


def phase_kernels(vo_n: int = 288, big_match: int = 2048) -> None:
    rng = np.random.default_rng(SEED)
    check_scoring(rng, 512, vo_n)  # EKF-scan VO: ≈ 3 × 96 SIFT matches
    check_scoring(rng, 1024, 256)  # dead reckoning: 256 FAST features
    check_matching(rng, vo_n)
    check_matching(rng, big_match)
    check_chol(rng)
    check_svd3(rng)


# ---------------------------------------------------------------------------
# Pipeline phases
# ---------------------------------------------------------------------------


def phase_pipeline(n_frames: int | None = None) -> None:
    import jax

    import bench
    from pre3_tpu.eval.trajectory import ate_rmse
    from pre3_tpu.geometry.camera import sr4000_camera
    from pre3_tpu.runtime.online import OnlineSlam

    cam = sr4000_camera()
    n = n_frames or bench.N_FRAMES
    _, _, (intensity, xyz, conf), gt = bench.render_corridor(n)

    def ate(t) -> float:
        t = np.asarray(t)
        return ate_rmse(t, gt[: len(t)], align=False)

    def run_phase(name, pipe):
        """Time pipe over keys SEED+0..3; every call's ATE must pass."""
        outs, first, times = bench.time_reps_stats(
            lambda r: pipe(intensity, xyz, conf, jax.random.PRNGKey(SEED + r)),
            reps=3)
        steady = float(np.median(times))
        ates = [ate(o.t) for o in outs]
        say(f"{name}: frames {n}, compile+first {first:.2f} s, steady "
            f"{steady * 1e3:.1f} ms ({n / steady:.1f} frames/s), ATE max "
            f"{max(ates):.4f} m over keys SEED+0..{len(ates) - 1} "
            f"[{', '.join(f'{x:.4f}' for x in ates)}] (bound "
            f"{ATE_BOUND[name]})")
        for x in ates:
            check_ate(name, x)
        return outs[0]

    head_out = run_phase(f"headline_k{bench.N_LANDMARKS}", bench.make_pipeline(
        cam, bench.CFG, bench.N_LANDMARKS))
    run_phase("headline_k64", bench.make_pipeline(cam, bench.CFG, 64))
    run_phase("fast_ncc", bench.make_fast_ncc_pipeline(cam))
    run_phase("vo", bench.vo_pipeline)

    ks, prob = bench.ba_problem(head_out, n)
    check(prob is not None, "backend: no BA problem from the headline")
    t0 = time.perf_counter()
    sm_t = bench.ba_smooth(cam, head_out, ks, prob)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench.ba_smooth(cam, head_out, ks, prob)
    a = ate(sm_t)
    say(f"backend: {int(ks.n)} keyframes, BA + smoothing compile+first "
        f"{first:.2f} s, steady {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"BA ATE {a:.4f} m")
    check_ate("backend", a)

    online = OnlineSlam(cam, cfg=bench.CFG, n_landmarks=bench.N_LANDMARKS,
                        extractor="sift", key=jax.random.PRNGKey(SEED))
    n_single, c = 8, 16
    t0 = time.perf_counter()
    for i in range(n_single):
        res = online.process(intensity[i], xyz[i], conf[i])
    jax.block_until_ready(res.t)
    t1 = time.perf_counter()
    for lo in (n_single, n_single + c):
        outs = online.process_chunk(intensity[lo:lo + c], xyz[lo:lo + c],
                                    conf[lo:lo + c])
    jax.block_until_ready(outs[-1].t)
    t_s, _ = online.trajectory
    check(len(t_s) == n_single + 2 * c and np.all(np.isfinite(t_s)),
          f"streaming: {len(t_s)} poses or non-finite")
    a = ate(t_s)
    say(f"streaming: {n_single} process() incl. compile "
        f"{t1 - t0:.2f} s, 2 process_chunk({c}) incl. compile "
        f"{time.perf_counter() - t1:.2f} s, ATE {a:.4f} m over "
        f"{len(t_s)} frames")
    check_ate("streaming", a)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    if peak is not None:
        say(f"device peak memory {peak / 2**30:.2f} GiB")


def _allocs(devs) -> list:
    """Cumulative allocation count per device (None where the backend
    keeps no memory statistics, as the CPU does)."""
    return [(d.memory_stats() or {}).get("num_allocs") for d in devs]


def check_spread(name: str, devs, before: list) -> str:
    """Checks that every device of the mesh allocated new buffers since
    `before`, i.e. that the path put work on all of them. A GPU must keep
    the statistics; only a CPU rehearsal goes without the check."""
    after = _allocs(devs)
    if None in before or None in after:
        check(devs[0].platform != "gpu",
              f"{name}: the GPU reports no allocation statistics")
        return "allocations per device n/a"
    delta = [b - a for a, b in zip(before, after)]
    check(min(delta) > 0, f"{name}: devices without new allocations {delta}")
    return f"new allocations per device {delta}"


def check_collectives(name: str, jitted, *args) -> int:
    """Checks that the compiled program holds at least one cross-device
    collective (the GPU backend emits them as async `-start`/`-done`
    pairs) and returns their number."""
    hlo = jitted.lower(*args).compile().as_text()
    n = len(re.findall(r"\b(?:all-reduce|all-gather|collective-permute"
                       r"|reduce-scatter|all-to-all)(?:-start)?\(", hlo))
    check(n > 0, f"{name}: no collective in the compiled program")
    return n


def phase_multi(n_dev: int, n_frames: int | None = None) -> None:
    """Sharded paths over a flat n-device mesh, each against its
    single-device counterpart: hypothesis-sharded RANSAC vs ransac_rigid,
    landmark- and pose-sharded BA vs bundle_adjust on the headline's own
    64-keyframe BA problem, frame-sharded run_slam_pipelined vs the
    headline run_slam."""
    import jax
    import jax.numpy as jnp

    import bench
    from pre3_tpu.backend.ba import bundle_adjust
    from pre3_tpu.backend.smoothing import apply_ba_corrections
    from pre3_tpu.eval.trajectory import ate_rmse
    from pre3_tpu.geometry.camera import sr4000_camera
    from pre3_tpu.parallel.ba_pose_sharded import bundle_adjust_pose_sharded
    from pre3_tpu.parallel.ba_sharded import bundle_adjust_sharded
    from pre3_tpu.parallel.mesh import make_mesh
    from pre3_tpu.parallel.vo_sharded import sharded_ransac_rigid
    from pre3_tpu.runtime.stage_pipeline import (
        _sharded_extract_fn, run_slam_pipelined,
    )
    from pre3_tpu.vo.ransac import ransac_rigid

    cam = sr4000_camera()
    n = n_frames or bench.N_FRAMES
    devs = jax.devices()[:n_dev]
    rng = np.random.default_rng(SEED)

    # ---- hypothesis-sharded RANSAC ----
    _, _, p1, p2, valid, thr = scoring_case(rng, 1, 288)
    p1, p2 = (jnp.asarray(a, jnp.float32) for a in (p1, p2))
    valid, thr = jnp.asarray(valid), float(thr)
    key = jax.random.PRNGKey(SEED)
    batch = 512 * n_dev
    mesh_h = make_mesh(n_dev, axis="hyp")
    sharded = jax.jit(lambda k, a, b, v: sharded_ransac_rigid(
        mesh_h, k, a, b, v, batch=batch, support_threshold=thr))
    n_coll = check_collectives("sharded RANSAC", sharded, key, p1, p2, valid)
    a0 = _allocs(devs)
    got = jax.block_until_ready(sharded(key, p1, p2, valid))
    spread = check_spread("sharded RANSAC", devs, a0)
    ref = ransac_rigid(key, p1, p2, valid, batch=batch,
                       support_threshold=thr)
    dr = float(jnp.abs(got.r - ref.r).max())
    dt = float(jnp.abs(got.t - ref.t).max())
    check(int(got.n_inliers) == int(ref.n_inliers) and dr <= 1e-4
          and dt <= 1e-4,
          f"sharded RANSAC: inliers {int(got.n_inliers)} vs "
          f"{int(ref.n_inliers)}, |dR| {dr:.2e}, |dt| {dt:.2e}")
    say(f"multi    sharded_ransac_rigid B={batch} N=288 on {n_dev} "
        f"devices: inliers {int(got.n_inliers)} (single "
        f"{int(ref.n_inliers)}), |dR| {dr:.2e}, |dt| {dt:.2e}, "
        f"{n_coll} collectives, {spread}")

    # ---- the headline run on one device: BA input and pipeline ref ----
    _, _, (intensity, xyz, conf), gt = bench.render_corridor(n)
    head = bench.make_pipeline(cam, bench.CFG, bench.N_LANDMARKS)
    slam_key = jax.random.PRNGKey(SEED)
    slam_out = jax.block_until_ready(head(intensity, xyz, conf, slam_key))
    head_ate = ate_rmse(np.asarray(slam_out.t), gt, align=False)
    say(f"multi    headline run_slam K={bench.N_LANDMARKS} on one device: "
        f"ATE {head_ate:.4f} m")

    # ---- landmark- and pose-sharded BA vs bundle_adjust ----
    ks, prob = bench.ba_problem(slam_out, n)
    check(prob is not None, "multi: no BA problem from the headline")

    def ba_ate(res) -> float:
        sm_t, _ = apply_ba_corrections(slam_out.t, slam_out.q, ks.indices,
                                       ks.valid, res.kf_t, res.kf_q)
        return ate_rmse(np.asarray(sm_t), gt, align=False)

    single = bundle_adjust(cam, prob, iters=10)
    single_ate = ba_ate(single)
    a0 = _allocs(devs)
    lm = jax.block_until_ready(bundle_adjust_sharded(
        make_mesh(n_dev, axis="lm"), cam, prob, iters=10))
    lm_allocs = check_spread("landmark-sharded BA", devs, a0)
    a0 = _allocs(devs)
    pose, report = jax.block_until_ready(bundle_adjust_pose_sharded(
        make_mesh(n_dev, axis="blk"), cam, prob, iters=10, cg_iters=96,
        sep=3))
    pose_allocs = check_spread("pose-sharded BA", devs, a0)
    for name, res, tol, allocs in (("landmark", lm, 1e-3, lm_allocs),
                                   ("pose", pose, 5e-3, pose_allocs)):
        d = float(jnp.abs(res.kf_t - single.kf_t).max())
        a = ba_ate(res)
        check(d <= tol and a <= ATE_BOUND["backend"],
              f"{name}-sharded BA: max |dt| {d:.2e} m (tol {tol}), "
              f"ATE {a:.4f} m")
        say(f"multi    {name}-sharded BA F={prob.kf_t.shape[0]} "
            f"L={prob.points.shape[0]} on {n_dev} devices: max |kf_t − "
            f"single| {d:.2e} m (tol {tol}), BA ATE {a:.4f} m (single "
            f"{single_ate:.4f}), {allocs}")
    check(report["dropped_obs"] == 0, f"pose-sharded BA report {report}")

    # ---- frame-sharded stage pipeline vs run_slam ----
    mesh_f = make_mesh(n_dev, axis="frame")
    fe = _sharded_extract_fn(mesh_f, "sift", (), "frame")
    chunk = tuple(a[:8 * n_dev] for a in (intensity, xyz, conf))
    n_coll = check_collectives("sharded_extract", fe, *chunk)
    a0 = _allocs(devs)
    feats = jax.block_until_ready(fe(*chunk))
    spread = check_spread("sharded_extract", devs, a0)
    say(f"multi    sharded_extract {8 * n_dev} frames: {n_coll} "
        f"collectives, {spread}, output {feats.desc.sharding}")
    out = run_slam_pipelined(cam, intensity, xyz, conf, slam_key,
                             mesh=mesh_f, cfg=bench.CFG,
                             n_landmarks=bench.N_LANDMARKS,
                             chunk=8 * n_dev, extractor="sift")
    pipe_ate = ate_rmse(np.asarray(out.t), gt, align=False)
    dmax = float(np.abs(np.asarray(out.t) - np.asarray(slam_out.t)).max())
    check(pipe_ate <= ATE_BOUND["headline_k256"]
          and abs(pipe_ate - head_ate) <= 0.05,
          f"run_slam_pipelined: ATE {pipe_ate:.4f} m vs run_slam "
          f"{head_ate:.4f} m")
    say(f"multi    run_slam_pipelined {n} frames, chunk {8 * n_dev}, "
        f"{n_dev}-way frame-sharded frontend: ATE {pipe_ate:.4f} m "
        f"(run_slam {head_ate:.4f}), max |t − t_run_slam| {dmax:.2e} m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4 runs only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    devs = require_gpus(args.devices)
    import bench  # outside a checkout this fails here

    say(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    say(f"nvidia-smi: {nvidia_smi()}")
    t0 = time.perf_counter()
    if args.devices == 1:
        phase_kernels()
        phase_pipeline()
    else:
        phase_multi(args.devices)
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": bench.device_info()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
