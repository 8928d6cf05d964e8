"""Map management: delete / convert / add landmarks in the masked state.

Re-design of map_management.m:27-80 and friends:
  delete_features.m:32-46 — tracking-ratio, age, and invisibility rules;
    deletion is a mask flip + row/col zeroing (the reference physically
    shrinks x/P per feature, delete_a_feature.m — impossible under static
    shapes and unnecessary: zeroed blocks are exact no-ops downstream)
  inversedepth_2_cartesian.m:29-74 — linearity-index conversion with the
    closed-form reparameterization Jacobian, applied in-place in the
    6-wide slot (extra 3 dims zeroed)
  initialize_features.m / add_features_inverse_depth.m /
    add_a_feature_covariance_inverse_depth.m:27-90 — new landmarks from
    unmatched frame features with the RGB-D depth prior ρ = 1/‖xyz‖,
    σρ = 0.01·ρ² (initialize_a_feature_sift_3.m:116,
    add_features_inverse_depth.m:48), full covariance augmentation via
    autodiff Jacobians of the init function.

Candidate selection (initialize_features.m dispatch): two modes —
  "topk"     detector-score top-k among gated features (deterministic,
             default; the box-occupancy goal of the reference is served
             by the min-distance gate), and
  "weighted" the reference's Gaussian-center-weighted sampling without
             replacement (Weighted_Smpl_wo_replacement.m:1-35: N(center,
             diag((W/6)², (H/6)²)) weights, sequentially re-normalized
             randsample) realized exactly-in-distribution as one Gumbel
             top-k over log-weights (Efraimidis–Spirakis), which is the
             static-shape form of sampling without replacement.
tests/test_map_management.py pins the distributional agreement of the
Gumbel form against a faithful sequential NumPy sampler.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pre3_tpu.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu.frontend.pipeline import Features
from pre3_tpu.geometry.camera import Camera
from pre3_tpu.geometry.inverse_depth import (
    conversion_jacobian, inverse_depth_point, inverse_depth_to_cartesian,
    linearity_index,
)


# ---------------------------------------------------------------------------
# Delete
# ---------------------------------------------------------------------------


def delete_features(
    state: EkfState, step: jnp.ndarray,
    min_predicted: int = 5,
    max_age: int = 20,
    max_invisible: int = 20,
    invisible_rule_min_map: int = 20,
) -> EkfState:
    """Deactivate bad landmarks (delete_features.m:32-46)."""
    bad_ratio = (
        state.times_measured < 0.5 * state.times_predicted
    ) & (state.times_predicted > min_predicted)
    too_old = (step - state.init_frame) > max_age
    n_active = jnp.sum(state.active)
    lost = (n_active > invisible_rule_min_map) & (
        (step - state.last_visible) > max_invisible
    )
    drop = state.active & (bad_ratio | too_old | lost)
    return _deactivate(state, drop)


def _deactivate(state: EkfState, drop: jnp.ndarray) -> EkfState:
    k = state.n_landmarks
    keep_dims = jnp.concatenate(
        [jnp.ones(CAM_DIM, bool), jnp.repeat(~drop, LM_DIM)]
    )

    # The masked multiply is unconditional: a lax.cond(any(drop)) gate
    # splits the scan body into sub-computations and defeats XLA fusion.
    # Which form is faster on an H100 is not measured (ROADMAP Design 3).
    x = jnp.where(keep_dims, state.x, 0.0)
    p = state.p * keep_dims[:, None] * keep_dims[None, :]
    return state._replace(
        x=x, p=p, active=state.active & ~drop,
        is_id=state.is_id & ~drop,
    )


# ---------------------------------------------------------------------------
# Inverse-depth → Cartesian conversion
# ---------------------------------------------------------------------------


def convert_to_cartesian(
    state: EkfState, threshold: float = 0.1, max_conversions: int = 16
) -> EkfState:
    """Reparameterize well-localized inverse-depth landmarks
    (inversedepth_2_cartesian.m:56: convert when 4·σd·cosα/d < 0.1).

    At most max_conversions slots convert per step: conversions are rare
    (typically 0-3/frame), and bounding them lets the P transform gather
    and rewrite ONLY the selected slots' [6, D] strips instead of
    rebuilding the full [D, D] matrix (two concatenates + a symmetrize =
    ~4 full-matrix HBM passes per step at K=512). A slot past the bound
    still satisfies the linearity test next frame and converts then —
    the reparameterization is order-insensitive."""
    k = state.n_landmarks
    lms = state.landmarks
    rho_idx = CAM_DIM + jnp.arange(k) * LM_DIM + 5
    sigma_rho = jnp.sqrt(jnp.maximum(state.p[rho_idx, rho_idx], 0.0))
    li = jax.vmap(lambda y, s: linearity_index(y, s, state.x[0:3]))(
        lms, sigma_rho
    )
    conv = state.active & state.is_id & (li < threshold) & (
        lms[:, 5] > 1e-6
    )

    m = min(max_conversions, k)
    _, sel = jax.lax.top_k(conv.astype(jnp.int32), m)  # converting first
    sel_conv = conv[sel]  # [M]
    # slots selected AND converting this step (surplus waits a frame)
    did = jnp.zeros((k,), bool).at[sel].set(sel_conv)

    # Per-slot 6×6 reparameterization blocks: top 3 rows = ∂p/∂y, rest 0.
    lms_sel = lms[sel]
    j3 = jax.vmap(conversion_jacobian)(lms_sel)  # [M, 3, 6]
    j6 = jnp.concatenate([j3, jnp.zeros((m, 3, LM_DIM))], axis=1)
    eye6 = jnp.broadcast_to(jnp.eye(LM_DIM), (m, LM_DIM, LM_DIM))
    blocks = jnp.where(sel_conv[:, None, None], j6, eye6)  # [M, 6, 6]

    # J = blockdiag(I, …, B_s, …) applied as gathered strip products on
    # the M selected slots only: row strips then column strips gives
    # exactly J P Jᵀ (still O(M·36·D), now with O(M·6·D) memory traffic).
    # (No lax.cond skip on no-conversion steps: conditionals split the
    # scan body and defeat fusion; see _deactivate.)
    d = CAM_DIM + k * LM_DIM
    rows = (CAM_DIM + sel[:, None] * LM_DIM
            + jnp.arange(LM_DIM)[None, :]).reshape(-1)  # [M·6]
    prow = state.p[rows].reshape(m, LM_DIM, d)
    prow = jnp.einsum("kab,kbD->kaD", blocks, prow)
    p = state.p.at[rows].set(prow.reshape(m * LM_DIM, d))
    pcol = p[:, rows].reshape(d, m, LM_DIM)
    pcol = jnp.einsum("kab,Dkb->Dka", blocks, pcol)
    p = p.at[:, rows].set(pcol.reshape(d, m * LM_DIM))

    pts = jax.vmap(inverse_depth_to_cartesian)(lms)  # [K, 3]
    new_lms = jnp.where(
        did[:, None],
        jnp.concatenate([pts, jnp.zeros((k, 3))], axis=-1),
        lms,
    )
    x = state.x.at[CAM_DIM:].set(new_lms.reshape(-1))
    return state._replace(x=x, p=p, is_id=state.is_id & ~did)


# ---------------------------------------------------------------------------
# Add
# ---------------------------------------------------------------------------


def weighted_candidate_choice(
    key: jax.Array,
    uv: jnp.ndarray,  # [Kf, 2]
    mask: jnp.ndarray,  # [Kf] eligible candidates
    max_adds: int,
    n_cols: float,
    n_rows: float,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gaussian-center-weighted sampling without replacement of max_adds
    candidate indices (Weighted_Smpl_wo_replacement.m:1-35: weights =
    N(uv; center, diag((W/6)², (H/6)²)), sequentially re-normalized). One
    Gumbel top-k over log-weights is identical in distribution
    (Efraimidis–Spirakis) and static-shape. Returns (indices, ok-mask)."""
    cx, cy = n_cols / 2.0, n_rows / 2.0
    sx, sy = n_cols / 6.0, n_rows / 6.0
    logw = -0.5 * (
        ((uv[:, 0] - cx) / sx) ** 2 + ((uv[:, 1] - cy) / sy) ** 2
    )
    g = jax.random.gumbel(key, (uv.shape[0],))
    val = jnp.where(mask, logw + g, -jnp.inf)
    top_val, top_idx = jax.lax.top_k(val, max_adds)
    return top_idx, jnp.isfinite(top_val)


def add_features(
    cam_model: Camera,
    state: EkfState,
    frame: Features,
    predicted_h: jnp.ndarray,  # [K, 2] current predicted landmark pixels
    step: jnp.ndarray,
    n_measured: jnp.ndarray,
    max_adds: int = 8,
    min_measured: int = 25,
    min_separation_px: float = 10.0,
    std_pxl: float = 1.0,
    depth_sigma: float = 0.01,
    depth_range_quadratic: bool = False,
    depth_range_d0: float = 2.0,
    image: jnp.ndarray | None = None,
    sampling: str = "topk",
    key: jax.Array | None = None,
) -> EkfState:
    """Initialize up to `max_adds` new inverse-depth landmarks from
    depth-valid, well-separated frame features when tracking support is
    low (map_management.m:58-66 / initialize_features.m).

    sampling: "topk" (detector score) or "weighted" (the reference's
    Gaussian-center weighting, Weighted_Smpl_wo_replacement.m — needs
    `key`; falls back to topk when key is None)."""
    k = state.n_landmarks
    kf = frame.uv.shape[0]
    # More adds than slots can never land (bootstrap passes max_adds·4
    # against small maps): clamp so candidates and free slots pair 1:1.
    max_adds = min(max_adds, k)

    # Candidate gate: valid, has depth, far from every active landmark's
    # predicted position.
    d2map = jnp.linalg.norm(
        frame.uv[:, None, :] - predicted_h[None], axis=-1
    )  # [Kf, K]
    d2map = jnp.where(state.active[None], d2map, jnp.inf)
    far = jnp.min(d2map, axis=-1) > min_separation_px
    has_depth = jnp.linalg.norm(frame.xyz, axis=-1) > 0.2
    cand = frame.valid & has_depth & far
    want = n_measured < min_measured
    if sampling == "weighted" and key is not None:
        top_idx, top_ok = weighted_candidate_choice(
            key, frame.uv, cand & want, max_adds,
            n_cols=cam_model.n_cols, n_rows=cam_model.n_rows,
        )
    else:
        score = jnp.where(cand & want, frame.score, -1.0)
        top_score, top_idx = jax.lax.top_k(score, max_adds)
        top_ok = top_score > 0

    # Free slots: inactive, lowest indices first.
    slot_order = jnp.argsort(state.active.astype(jnp.int32), stable=True)
    free_slots = slot_order[:max_adds]
    slot_free = ~state.active[free_slots]

    # Init-appearance record for the NCC matcher (patch_when_initialized;
    # zero when no image is supplied — descriptor-matching mode).
    if image is not None:
        from pre3_tpu.frontend.patch_warp import extract_raw_patches

        pb = state.init_patch.shape[-1]
        cand_patches = extract_raw_patches(
            image, frame.uv[top_idx], size=pb
        )  # [max_adds, PB, PB]
    else:
        cand_patches = None

    # All max_adds insertions as ONE batched covariance augmentation
    # (add_a_feature_covariance_inverse_depth.m:27-90, vectorized over the
    # adds). The sequential reference adds one landmark at a time, each
    # strip reading the P that already contains the previous adds; here
    # the strips are computed against the pre-add P and the missing
    # new×new cross-covariance Jc_a·Pcc·Jc_bᵀ is written explicitly —
    # algebraically identical (new slots' pre-add rows are zero), and it
    # replaces max_adds full-pytree where-selects (≈ 8 full-[D,D] HBM
    # passes per step — the dominant map-management cost at K=256) with
    # three strip/block scatters.
    a = max_adds
    do = top_ok & slot_free  # [A]
    uv_a = frame.uv[top_idx]  # [A, 2]
    xyz_a = frame.xyz[top_idx]  # [A, 3]
    rho0 = 1.0 / jnp.maximum(
        jnp.linalg.norm(xyz_a, axis=-1), 1e-6
    )  # [A]
    # depth-prior std (initialize_a_feature_sift_3.m:116-117):
    # σρ = σ_d·ρ² with σ_d = depth_sigma (constant 1 cm, reference
    # parity). The SR4000's actual range noise grows ∝ range² beyond
    # a couple of meters (amplitude ∝ 1/d², cov_pose_shift_calc.m
    # noise model); depth_range_quadratic switches to the hybrid
    # σ_d = depth_sigma·max(1, (d/d0)²): the reference prior inside
    # d0, honestly looser beyond — σρ = depth_sigma·max(ρ², 1/d0²).
    # Measured (512-frame corridor, far features at 3.4–5.7 m):
    # SLAM ATE 1.69 → 0.78 with the quadratic tail; the d0 knee
    # protects the short-sequence regime where the tight reference
    # prior is what anchors scale.
    d0 = depth_range_d0
    sig_rho = (
        depth_sigma * jnp.maximum(rho0 * rho0, 1.0 / (d0 * d0))
        if depth_range_quadratic
        else depth_sigma * rho0 * rho0
    )  # [A]

    cam13 = state.x[:CAM_DIM]

    def y_of(c, uv_, rho_):
        return inverse_depth_point(cam_model, uv_, c[0:3], c[3:7], rho_)

    y_a = jax.vmap(lambda u, r: y_of(cam13, u, r))(uv_a, rho0)  # [A, 6]
    jc_a = jax.vmap(
        lambda u, r: jax.jacfwd(lambda c: y_of(c, u, r))(cam13)
    )(uv_a, rho0)  # [A, 6, 13]
    juv_a = jax.vmap(
        lambda u, r: jax.jacfwd(lambda uu: y_of(cam13, uu, r))(u)
    )(uv_a, rho0)  # [A, 6, 2]
    jr_a = jax.vmap(
        lambda u, r: jax.jacfwd(lambda rr: y_of(cam13, u, rr))(r)
    )(uv_a, rho0)  # [A, 6]

    # Gate failed adds to exact no-ops: a non-do slot keeps its zeroed
    # x/P rows (inactive slots are zeroed by _deactivate/init_state).
    y_a = jnp.where(do[:, None], y_a, 0.0)
    jc_eff = jnp.where(do[:, None, None], jc_a, 0.0)

    pcc = state.p[:CAM_DIM, :CAM_DIM]
    strips = jnp.einsum(
        "aij,jD->aiD", jc_eff, state.p[:CAM_DIM, :]
    )  # [A, 6, D]
    cross = jnp.einsum(
        "aij,jk,blk->aibl", jc_eff, pcc, jc_eff
    )  # [A, 6, A, 6]
    noise = (std_pxl**2) * jnp.einsum(
        "ail,ajl->aij", juv_a, juv_a
    ) + (sig_rho**2)[:, None, None] * jnp.einsum(
        "ai,aj->aij", jr_a, jr_a
    )  # [A, 6, 6]
    noise = jnp.where(do[:, None, None], noise, 0.0)
    cross = cross.at[jnp.arange(a), :, jnp.arange(a), :].add(noise)

    rows = (
        CAM_DIM + free_slots[:, None] * LM_DIM
        + jnp.arange(LM_DIM)[None, :]
    ).reshape(-1)  # [A·6] — distinct (free_slots is argsort output)
    # When fewer than max_adds slots are free, free_slots' tail holds
    # ACTIVE slots (do=False there): their rows must stay untouched, so
    # every scatter writes the original values back outside `do`.
    do_rep = jnp.repeat(do, LM_DIM)  # [A·6]
    strips_flat = strips.reshape(a * LM_DIM, -1)
    p = state.p.at[rows, :].set(
        jnp.where(do_rep[:, None], strips_flat, state.p[rows, :])
    )
    p = p.at[:, rows].set(
        jnp.where(do_rep[None, :], strips_flat.T, p[:, rows])
    )
    # new×new cross block only where BOTH endpoints are fresh adds; a
    # (do, ¬do) pair's covariance is already correct from the strip write
    blk = p[rows[:, None], rows[None, :]]
    p = p.at[rows[:, None], rows[None, :]].set(
        jnp.where(
            do_rep[:, None] & do_rep[None, :],
            cross.reshape(a * LM_DIM, a * LM_DIM), blk,
        )
    )
    x = state.x.at[rows].set(
        jnp.where(do_rep, y_a.reshape(-1), state.x[rows])
    )

    state = state._replace(
        x=x, p=p,
        active=state.active.at[free_slots].set(
            state.active[free_slots] | do
        ),
        is_id=state.is_id.at[free_slots].set(
            jnp.where(do, True, state.is_id[free_slots])
        ),
        desc=state.desc.at[free_slots].set(
            jnp.where(do[:, None], frame.desc[top_idx],
                      state.desc[free_slots])
        ),
        times_predicted=state.times_predicted.at[free_slots].set(
            jnp.where(do, 0, state.times_predicted[free_slots])
        ),
        times_measured=state.times_measured.at[free_slots].set(
            jnp.where(do, 0, state.times_measured[free_slots])
        ),
        init_frame=state.init_frame.at[free_slots].set(
            jnp.where(do, step, state.init_frame[free_slots])
        ),
        last_visible=state.last_visible.at[free_slots].set(
            jnp.where(do, step, state.last_visible[free_slots])
        ),
        init_uv=state.init_uv.at[free_slots].set(
            jnp.where(do[:, None], uv_a, state.init_uv[free_slots])
        ),
        init_cam=state.init_cam.at[free_slots].set(
            jnp.where(do[:, None], cam13[0:7][None],
                      state.init_cam[free_slots])
        ),
    )
    if cand_patches is not None:
        state = state._replace(
            init_patch=state.init_patch.at[free_slots].set(
                jnp.where(do[:, None, None], cand_patches,
                          state.init_patch[free_slots])
            )
        )
    return state
