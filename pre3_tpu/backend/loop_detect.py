"""Keyframe-to-keyframe loop-closure detection → relative-pose factors.

The filter's implicit loop closure (landmark re-acquisition through the
uncertainty-widened gate, mono_slam.m:161 + rescue_hi_inliers.m:27-47)
can only witness revisits SHORTER than the invisible-landmark deletion
horizon (delete_features.m:46, max_invisible = 20 frames): a landmark
out of view for longer is deleted before the camera returns, so the
re-acquisition events ekf_ba.py mines never span a real loop. This
module closes that gap in the BACKEND, where the reference has nothing:
candidate keyframe pairs that are far apart in time but near in the
(drifted) estimate are descriptor-rematched (ops/matching — the same
matcher as the frontend) and geometrically verified by the batched
rigid RANSAC (vo/ransac.py — the same consensus machinery as VO); a
pair that passes yields one Kabsch-refit relative SE(3) factor
(BaProblem.lcp_*) whose inlier consensus makes it far more robust than
merging raw re-matched landmark observations (measured WORSE in round
3: 0.077 → 0.131 m ATE — because single wrong associations
survive Huber; a RANSAC-vetted pose factor admits no single wrong
match).

Host-side orchestration over a handful of candidate pairs; the per-pair
match + RANSAC is one jitted program reused across pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.geometry.quaternion import r2q
from pre3_tpu.ops.matching import match_descriptors
from pre3_tpu.vo.covariance import vo_covariance
from pre3_tpu.vo.ransac import ransac_rigid


# conservative noise floor added to every factor covariance so the
# sqrt-information can never claim better than ~5 mm / 0.25°
_COV_FLOOR = np.diag([2.5e-5] * 3 + [2e-5] * 3)

# Empirical variance inflation, CALIBRATED against ground truth (r5):
# on synthetic loop scenes the Kabsch pose errors vs GT were 3-5× the
# IFT model's σ in the narrow-FOV rotation-translation ambiguity
# direction (measured: |t_err| 4-14 cm, rot 0.8-2.5°, while the model
# claimed σ_t ≈ 1 cm — the per-point noise model misses the systematic
# splat/texture localization bias, and the fitted rmse understates the
# noise through overfitting 12-30 points with 6 DOF). 25 = (5σ)²
# makes the factor's claimed confidence match its measured accuracy.
_COV_INFLATION = 25.0


def sqrt_information(cov: np.ndarray) -> np.ndarray:
    """[6, 6] upper-triangular whitening matrix L with ‖L r‖² =
    rᵀ Σ⁻¹ r for Σ = inflation·cov + floor — what
    _pair_residual_jacobians applies to the raw factor residual."""
    sig = _COV_INFLATION * np.asarray(cov, np.float64) + _COV_FLOOR
    info = np.linalg.inv(sig)
    info = 0.5 * (info + info.T)
    return np.linalg.cholesky(info).T.astype(np.float32)  # upper: r↦L r


def mine_keyframe_loop_closures(
    kf_feats,  # Features stacked over the M keyframes
    kf_t: np.ndarray,  # [M, 3] estimated keyframe positions (world)
    kf_q: np.ndarray,  # [M, 4]
    kf_valid: np.ndarray,  # [M]
    key: jax.Array | None = None,
    min_gap: int = 8,  # keyframe-index gap for a candidate pair
    max_dist: float = 1.2,  # m — estimated-proximity gate
    min_path_ratio: float = 2.0,  # loop-likeness gate, see below
    min_inliers: int = 12,
    max_pairs: int = 16,  # strongest-first budget
    ratio: float = 1.3,
    batch: int = 1024,
):
    """Returns (lcp_i, lcp_j, lcp_t, lcp_q, lcp_w) numpy arrays or None.

    Factor convention matches backend.ba._odo_residual:
    lcp_t = R_iᵀ(t_j − t_i), lcp_q = q_i⁻¹ ⊗ q_j — estimated here from
    the matched camera-frame point sets (p_i ≈ R·p_j + t via
    ransac_rigid), with NO dependence on the drifted world poses.

    Candidate gate: a genuine loop pair is one where the camera traveled
    FAR between the two keyframes yet ended up NEAR — path_length(a→b) /
    dist(a, b) ≥ min_path_ratio. Plain proximity alone floods the budget
    with same-leg neighbors whose relative pose the odometry chain
    already pins (measured: those factors add Kabsch noise and slightly
    WORSEN post-BA ATE, r5 first cut)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    kf_t = np.asarray(kf_t)
    kf_valid = np.asarray(kf_valid)
    m = len(kf_t)
    # cumulative path length along the keyframe chain
    seg = np.linalg.norm(np.diff(kf_t, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])

    cands = []
    for a in range(m):
        if not kf_valid[a]:
            continue
        for b in range(a + min_gap, m):
            if not kf_valid[b]:
                continue
            d = float(np.linalg.norm(kf_t[a] - kf_t[b]))
            if d >= max_dist:
                continue
            path = float(cum[b] - cum[a])
            r_loop = path / max(d, 0.05)
            if r_loop >= min_path_ratio:
                cands.append((-r_loop, a, b))  # most loop-like first
    if not cands:
        return None
    cands.sort()

    @jax.jit
    def match_and_fit(fa_desc, fa_xyz, fa_valid, fb_desc, fb_xyz,
                      fb_valid, k):
        mt = match_descriptors(
            fa_desc, fb_desc, valid1=fa_valid, valid2=fb_valid,
            ratio=ratio,
        )
        ok = (
            mt.accepted & fa_valid
            & (jnp.linalg.norm(fa_xyz, axis=-1) > 0.2)
            & (jnp.linalg.norm(fb_xyz[mt.index], axis=-1) > 0.2)
        )
        p_a = fa_xyz
        p_b = fb_xyz[mt.index]
        fit = ransac_rigid(
            k, p_a, p_b, ok, batch=batch, min_inliers=min_inliers,
        )
        cov = vo_covariance(
            fit.r, fit.t, p_a, p_b, fit.inliers.astype(p_a.dtype)
        )
        return fit.r, fit.t, fit.ok, fit.n_inliers, fit.rmse, cov

    out_i, out_j, out_t, out_q, out_w, out_l = [], [], [], [], [], []
    seen = set()
    for _score, a, b in cands:
        if len(out_i) >= max_pairs:
            break
        if (a, b) in seen:
            continue
        # neighbor suppression: one factor per trajectory neighborhood —
        # adjacent keyframes share the same constraint information
        for da in (-2, -1, 0, 1, 2):
            for db in (-2, -1, 0, 1, 2):
                seen.add((a + da, b + db))
        fa = jax.tree.map(lambda x: x[a], kf_feats)
        fb = jax.tree.map(lambda x: x[b], kf_feats)
        key, k = jax.random.split(key)
        r, t, ok, n_inl, rmse, cov = match_and_fit(
            fa.desc, fa.xyz, fa.valid, fb.desc, fb.xyz, fb.valid, k
        )
        if not bool(ok):
            continue
        out_i.append(a)
        out_j.append(b)
        out_t.append(np.asarray(t, np.float32))
        out_q.append(np.asarray(r2q(jnp.asarray(r)), np.float32))
        out_w.append(1.0)
        out_l.append(sqrt_information(np.asarray(cov)))
    if not out_i:
        return None
    return (
        np.asarray(out_i, np.int32), np.asarray(out_j, np.int32),
        np.stack(out_t), np.stack(out_q),
        np.asarray(out_w, np.float32), np.stack(out_l),
    )


def merge_lcp(problem, lcp):
    """Concatenate mined keyframe-rematch factors onto a BaProblem's
    existing (filter-event) lcp factors. lcp = the 6-tuple
    mine_keyframe_loop_closures returns (incl. per-factor
    sqrt-information); None → problem unchanged. Both factor sources
    emit lcp_info, so the merged problem always carries it."""
    if lcp is None:
        return problem
    li, lj, lt, lq, lw, linfo = (jnp.asarray(x) for x in lcp)
    if problem.lcp_i is not None:
        # drop mined pairs that duplicate existing (i, j) factors
        have = {
            (int(a), int(b))
            for a, b in zip(
                np.asarray(problem.lcp_i), np.asarray(problem.lcp_j)
            )
        }
        keep = np.asarray([
            (int(a), int(b)) not in have
            for a, b in zip(np.asarray(li), np.asarray(lj))
        ])
        if not keep.any():
            return problem
        li, lj, lt, lq, lw, linfo = (
            x[jnp.asarray(keep)] for x in (li, lj, lt, lq, lw, linfo)
        )
        g0 = problem.lcp_i.shape[0]
        li = jnp.concatenate([problem.lcp_i, li])
        lj = jnp.concatenate([problem.lcp_j, lj])
        lt = jnp.concatenate([problem.lcp_t, lt])
        lq = jnp.concatenate([problem.lcp_q, lq])
        lw = jnp.concatenate([
            problem.lcp_w if problem.lcp_w is not None
            else jnp.ones(g0, jnp.float32), lw,
        ])
        linfo = jnp.concatenate([
            problem.lcp_info if problem.lcp_info is not None
            else jnp.tile(
                jnp.diag(jnp.asarray([20.0] * 3 + [50.0] * 3,
                                     jnp.float32))[None], (g0, 1, 1)
            ),
            linfo,
        ])
    return problem._replace(
        lcp_i=li, lcp_j=lj, lcp_t=lt, lcp_q=lq, lcp_w=lw,
        lcp_info=linfo,
    )
