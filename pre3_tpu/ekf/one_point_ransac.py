"""1-point / 3-point RANSAC inlier gating inside the EKF.

Re-design of the reference's sequential hypothesis loop
(ransac_hypotheses.m:27-86: up to 1000 adaptive iterations, each doing a
partial Kalman update from random individually-compatible matches and
counting low-innovation support via compute_hypothesis_support_fast.m) and
the high-innovation rescue (rescue_hi_inliers.m:27-47: χ²(2, 0.95)=5.9915
gating against the post-update covariance).

The reference's namesake "3-Point" behavior (select_random_match.m:47-51):
each hypothesis draws THREE distinct IC matches whenever more than three
exist, and one otherwise; the hypothesis update then stacks the drawn
measurements (6-dim innovation, 6×6 S — ransac_hypotheses.m:56-63 builds
the stacked sparse Hi and block-diagonal R).

Accelerator shape: draw ALL B hypotheses at once ([B, 3] Gumbel-top-k samples
without replacement — the randperm analog), compute all B partial state
updates as one batched gain application (ΔX_b = P H_bᵀ S_b⁻¹ ν_b with a
batched 6×6 Cholesky solve), reproject every landmark under every
hypothesis as a [B, K] tensor op, and argmax support. Fixed B replaces
the adaptive iteration count (SURVEY §7.1); B ≥ the reference's adaptive
budget so the statistical behavior is conservative (statistical parity vs
a reference-faithful adaptive loop is pinned by
tests/test_ransac_parity.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pre3_tpu.ekf.measurement import Observations, measure_one
from pre3_tpu.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu.geometry.camera import Camera

CHI2_2_95 = 5.9915


def one_point_ransac(
    key: jax.Array,
    cam_model: Camera,
    state: EkfState,
    obs: Observations,
    batch: int = 256,
    std_z: float = 1.0,
    n_points: int = 3,
    max_slots: int | None = None,
) -> jnp.ndarray:
    """Select low-innovation inliers among IC matches. Returns [K] bool.

    n_points: matches stacked per hypothesis. 3 reproduces the reference's
    3PRE mode — 3-match hypotheses when >3 IC matches exist, 1-match
    otherwise (select_random_match.m:47-51); 1 forces the classic Civera
    1-point variant everywhere.

    Support threshold = std_z (ransac_hypotheses.m:33: "RANSAC threshold
    should have a low value", set to the measurement std).

    max_slots: bound the hypothesis-draw pool to the M IC slots gathered
    first by top_k (ties keep index order) — the P·Hᵀ gain strips then
    read [D, M, 6] of P instead of [D, K, 6] (the full-matrix read that
    dominates at K=512). Support counting and the returned inlier mask
    still cover ALL K slots, so the selected li set is unchanged
    whenever ≤ M matches are individually compatible.
    """
    k = state.n_landmarks
    ic = obs.ic
    num_ic = jnp.sum(ic)

    p = state.p
    pc = p[:, :CAM_DIM]  # [D, 13]
    if max_slots is not None and max_slots < k:
        m_pool = max_slots
        _, pool = jax.lax.top_k(ic.astype(jnp.int32), m_pool)  # [M]
        hc_pool = obs.hc[pool]
        hl_pool = obs.hl[pool]
        nu_pool = (obs.z - obs.h)[pool]
        ic_pool = ic[pool]
        pl_pool = p[:, CAM_DIM:].reshape(-1, k, LM_DIM)[:, pool, :]
    else:
        m_pool = k
        pool = jnp.arange(k)
        hc_pool, hl_pool = obs.hc, obs.hl
        nu_pool = obs.z - obs.h
        ic_pool = ic
        pl_pool = p[:, CAM_DIM:].reshape(-1, k, LM_DIM)

    # Draw [B, S] hypothesis indices INTO THE POOL without replacement
    # within a hypothesis (randperm analog), ∝ IC mask across slots.
    logits = jnp.where(ic_pool, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (batch, m_pool))
    _, idx = jax.lax.top_k(logits[None] + g, n_points)  # [B, S]
    # 3-match hypotheses only when more than S IC matches exist, else
    # 1-match (select_random_match.m:47-51). Surplus draws are masked to
    # exact no-ops (zero H rows / zero innovation with unit R).
    n_use = jnp.where(num_ic > n_points, n_points, 1)
    use = (jnp.arange(n_points)[None, :] < n_use) & ic_pool[idx]  # [B, S]

    # zero non-IC JACOBIAN rows first: inactive slots carry NaN
    # Jacobians, and the ΔX contraction below multiplies EVERY pool row
    # by its (possibly zero) gain — 0·NaN would poison the whole batch.
    # (Zeroing hc/hl [M,2,13] instead of ph [M,D,2] makes the zeroed ph
    # rows fall out of the einsum for free — the post-hoc where was a
    # full copy of ph per step.)
    hc_pool = jnp.where(ic_pool[:, None, None], hc_pool, 0.0)
    hl_pool = jnp.where(ic_pool[:, None, None], hl_pool, 0.0)
    # Per-landmark gain column block P H_iᵀ = P[:, cam] Hc_iᵀ +
    # P[:, lm_i] Hl_iᵀ, precomputed once for the pool: [M, D, 2].
    # (A [M, 2, D] layout meant to skip a transpose pass measured ~40 µs
    # WORSE per step — XLA already picks good layouts here; r5 timing.)
    ph = jnp.einsum("dc,kec->kde", pc, hc_pool) + jnp.einsum(
        "dkl,kel->kde", pl_pool, hl_pool
    )
    nu_all = nu_pool  # [M, 2]
    s_pts = n_points
    ph_cam = ph[:, :CAM_DIM, :]  # [M, 13, 2]

    def gains_for(idx_h, use_h):
        """Per-hypothesis gain vector y = S⁻¹ν [2S] from its stacked
        matches. Only the CAMERA rows and the drawn slots' landmark rows
        of P·Hᵀ enter S — the [S, D, 2] strips are NOT gathered here
        (the full-width ΔX is applied afterwards as one batched
        matmul)."""
        hc = jnp.where(use_h[:, None, None], hc_pool[idx_h], 0.0)
        hl = jnp.where(use_h[:, None, None], hl_pool[idx_h], 0.0)
        nu = jnp.where(use_h[:, None], nu_all[idx_h], 0.0)  # [S, 2]
        phs_cam = jnp.where(
            use_h[:, None, None], ph_cam[idx_h], 0.0
        )  # [S, 13, 2]
        # S[2j:2j+2, 2m:2m+2] = H_j (P H_mᵀ) — H_j has nonzeros only in
        # the camera block and landmark-j block, so only those rows of
        # each column block are touched.
        s_cam = jnp.einsum("jac,mcb->jamb", hc, phs_cam)
        rows = (
            CAM_DIM + pool[idx_h][:, None] * LM_DIM
            + jnp.arange(LM_DIM)[None, :]
        )  # [S(j), 6] global row indices of slot j
        # lm_rows[j, m, l, e] = ph[idx_h[m], rows[j, l], e] — a small
        # fancy-index gather straight from the pool tensor
        lm_rows = ph[idx_h[None, :, None], rows[:, None, :], :]
        lm_rows = jnp.where(use_h[None, :, None, None], lm_rows, 0.0)
        s_lm = jnp.einsum("jal,jmlb->jamb", hl, lm_rows)
        s = (s_cam + s_lm).reshape(2 * s_pts, 2 * s_pts)
        s = s + (std_z**2) * jnp.eye(2 * s_pts)
        # S is PSD + σ²I → unrolled batched Cholesky solve: pure fused
        # elementwise arithmetic instead of a solver-library call. Its
        # cost against cuSOLVER on an H100 is not measured (ROADMAP
        # Design 3).
        from pre3_tpu.ops.small_chol import chol_solve_unrolled

        return chol_solve_unrolled(s, nu.reshape(-1))

    ys = jax.vmap(gains_for)(idx, use)  # [B, 2S]
    # ΔX_b = Σ_s ph[idx[b,s]] · y_b[2s:2s+2] — route the gains into
    # pool space and contract once: [B, M, 2] × [M, D, 2] → [B, D]. One
    # matmul replaces B gathered [D, 2S] @ [2S] products (a [B, S, D, 2]
    # gather moves ~20 MB of device memory per RANSAC call at K=256).
    # The pool-space routing is a one-hot contraction, not a scatter-add;
    # the scatter's cost on an H100 is not measured (ROADMAP Design 3).
    ys_gated = jnp.where(use[..., None], ys.reshape(batch, s_pts, 2), 0.0)
    onehot = (idx[..., None] == jnp.arange(m_pool)).astype(ph.dtype)
    w = jnp.einsum("bsm,bse->bme", onehot, ys_gated)  # [B, M, 2]
    dx = jnp.einsum("bme,mde->bd", w, ph)  # [B, D]
    x_hyp = state.x[None] + dx  # [B, D]

    # Support: reproject all landmarks under each hypothesis state
    # (compute_hypothesis_support_fast.m:35-110, batched twice).
    def project_all(xb):
        camb = xb[:CAM_DIM]
        lms = xb[CAM_DIM:].reshape(k, LM_DIM)
        return jax.vmap(
            lambda l, iid: measure_one(cam_model, camb, l, iid)
        )(lms, state.is_id)  # [K, 2]

    h_all = jax.vmap(project_all)(x_hyp)  # [B, K, 2]
    resid = jnp.linalg.norm(obs.z[None] - h_all, axis=-1)  # [B, K]
    inlier = (resid < std_z) & ic[None]
    support = jnp.sum(inlier, axis=-1)  # [B]
    # Guard: a hypothesis from an invalid draw (no IC at all) has support 0.
    any_ic = jnp.any(ic)
    best = jnp.argmax(support)
    li = inlier[best] & any_ic
    return li


def rescue_hi_inliers(
    cam_model: Camera,
    state: EkfState,  # post low-innovation update
    obs: Observations,
    li: jnp.ndarray,
    std_z: float = 1.0,
) -> tuple[jnp.ndarray, Observations]:
    """χ² gate the remaining IC matches against the post-li state
    (rescue_hi_inliers.m:27-47: h/H recomputed at the updated state, then
    νᵀS⁻¹ν < χ²(2, 0.95)). Returns (hi mask [K], refreshed Observations
    carrying the recomputed h/H/S for the hi update)."""
    from pre3_tpu.ekf.measurement import predict_measurements

    obs2 = predict_measurements(cam_model, state, std_z=std_z)
    obs2 = obs2._replace(z=obs.z, ic=obs.ic)
    nu = obs.z - obs2.h  # [K, 2]
    # closed-form batched 2×2 inverse for the χ² forms
    s00 = obs2.s[:, 0, 0]
    s01 = obs2.s[:, 0, 1]
    s10 = obs2.s[:, 1, 0]
    s11 = obs2.s[:, 1, 1]
    det = s00 * s11 - s01 * s10
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    chi2 = inv_det * (
        s11 * nu[:, 0] ** 2
        - (s01 + s10) * nu[:, 0] * nu[:, 1]
        + s00 * nu[:, 1] ** 2
    )
    hi = obs.ic & (~li) & (chi2 < CHI2_2_95)
    return hi, obs2
