"""Measurement prediction, Jacobians, innovation covariance, and map
matching for the EKF.

Re-design of the reference's measurement stack:
  predict_camera_measurements.m:27-68 (h per landmark, FOV/bounds gates)
  calculate_derivatives.m + calculate_Hi_{inverse_depth,cartesian}_my_
    version.m (~600 lines of hand chain-rule) → jax.jacfwd of the
    measurement function, vmapped over landmarks
  search_IC_matches.m:27-57 + matching_sift_based.m (descriptor matching
    against the frame, gated by the predicted search ellipse 3·√S)

The full H matrix is never materialized globally: H_i has nonzeros only in
the camera block (2×13) and landmark-i block (2×6), so S_i is assembled
from the corresponding P blocks — the same sparsity the reference exploits
(search_IC_matches.m:36), vectorized over all K slots.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.ekf.state import CAM_DIM, LM_DIM, EkfState
from pre3_tpu.frontend.pipeline import Features
from pre3_tpu.geometry.camera import Camera, project_point, distort
from pre3_tpu.geometry.inverse_depth import (
    inverse_depth_camera_ray,
)
from pre3_tpu.geometry.quaternion import qconj, qrotate
from pre3_tpu.ops.matching import match_descriptors


class Observations(NamedTuple):
    """Per-frame transient measurement data (the per-frame fields of
    features_info: h, S, z, individually_compatible, ...)."""

    h: jnp.ndarray  # [K, 2] predicted pixel
    hc: jnp.ndarray  # [K, 2, 13] ∂h/∂cam
    hl: jnp.ndarray  # [K, 2, 6] ∂h/∂landmark
    s: jnp.ndarray  # [K, 2, 2] innovation covariance
    visible: jnp.ndarray  # [K] bool — predicted in image
    z: jnp.ndarray  # [K, 2] matched measurement (0 where unmatched)
    ic: jnp.ndarray  # [K] bool — individually compatible (matched)
    z_xyz: jnp.ndarray  # [K, 3] camera-frame depth of the matched feature
    # (not used by the EKF update — recorded for the BA backend)


def measure_one(
    cam_model: Camera, cam_state: jnp.ndarray, lm: jnp.ndarray,
    is_id: jnp.ndarray,
) -> jnp.ndarray:
    """Distorted-pixel measurement h of one landmark slot.

    Inverse-depth slots project the scale-free ray (hi_inverse_depth.m:41);
    cartesian slots project R_cwᵀ(p − t) (hi_cartesian.m). The branch is a
    jnp.where over both results — both are NaN-safe for any slot content.
    """
    t_wc, q_wc = cam_state[0:3], cam_state[3:7]
    hrl_id = inverse_depth_camera_ray(lm, t_wc, q_wc)
    hrl_xyz = qrotate(qconj(q_wc), lm[:3] - t_wc)
    hrl = jnp.where(is_id, hrl_id, hrl_xyz)
    return distort(cam_model, project_point(cam_model, hrl))


def _visible_gate(
    cam_model: Camera, cam_state: jnp.ndarray, lm: jnp.ndarray,
    is_id: jnp.ndarray, h: jnp.ndarray,
) -> jnp.ndarray:
    t_wc, q_wc = cam_state[0:3], cam_state[3:7]
    hrl_id = inverse_depth_camera_ray(lm, t_wc, q_wc)
    hrl_xyz = qrotate(qconj(q_wc), lm[:3] - t_wc)
    hrl = jnp.where(is_id, hrl_id, hrl_xyz)
    # 60° cone per axis + image bounds (hi_inverse_depth.m:63-85)
    zc = hrl[..., 2]
    okz = zc > 0
    limx = jnp.abs(jnp.degrees(jnp.arctan2(hrl[..., 0], zc))) < 60.0
    limy = jnp.abs(jnp.degrees(jnp.arctan2(hrl[..., 1], zc))) < 60.0
    u, v = h[..., 0], h[..., 1]
    inb = (u > 0) & (u < cam_model.n_cols - 1) & (v > 0) & (
        v < cam_model.n_rows - 1
    )
    return okz & limx & limy & inb


def predict_measurements(
    cam_model: Camera, state: EkfState, std_z: float = 1.0
) -> Observations:
    """h, H blocks, S, and visibility for every landmark slot (vmapped)."""
    cam_state = state.x[:CAM_DIM]
    lms = state.landmarks  # [K, 6]

    def h_fn(c, l, iid):
        return measure_one(cam_model, c, l, iid)

    h = jax.vmap(lambda l, i: h_fn(cam_state, l, i))(lms, state.is_id)
    hc = jax.vmap(
        lambda l, i: jax.jacfwd(lambda c: h_fn(c, l, i))(cam_state)
    )(lms, state.is_id)  # [K, 2, 13]
    hl = jax.vmap(
        lambda l, i: jax.jacfwd(lambda ll: h_fn(cam_state, ll, i))(l)
    )(lms, state.is_id)  # [K, 2, 6]
    # cartesian slots: kill derivative wrt the unused 3 params
    lm_mask = jnp.where(
        state.is_id[:, None], jnp.ones((LM_DIM,)),
        jnp.array([1.0, 1, 1, 0, 0, 0]),
    )
    hl = hl * lm_mask[:, None, :]

    # S_i = Hc Pcc Hcᵀ + Hc Pc,li Hlᵀ + (·)ᵀ + Hl Pli,li Hlᵀ + R
    k = state.n_landmarks
    pcc = state.p[:CAM_DIM, :CAM_DIM]
    pcl = state.p[:CAM_DIM, CAM_DIM:].reshape(CAM_DIM, k, LM_DIM)
    pcl = jnp.swapaxes(pcl, 0, 1)  # [K, 13, 6]
    # Diagonal 6×6 blocks of the landmark-landmark covariance as ONE
    # static gather. (A vmapped dynamic_slice here compiles to a
    # K-iteration XLA loop of tiny slice/update fusions per step, and an
    # einsum-diagonal "kakb->kab" lowers to a strided scalar loop. Which
    # form is fastest on an H100 is not measured: ROADMAP Design 3.)
    rows = CAM_DIM + (
        jnp.arange(k)[:, None] * LM_DIM + jnp.arange(LM_DIM)[None, :]
    )  # [K, 6]
    pll_diag = state.p[rows[:, :, None], rows[:, None, :]]  # [K, 6, 6]
    s = (
        jnp.einsum("kac,cd,kbd->kab", hc, pcc, hc)
        + jnp.einsum("kac,kcd,kbd->kab", hc, pcl, hl)
        + jnp.einsum("kad,kcd,kbc->kab", hl, pcl, hc)
        + jnp.einsum("kac,kcd,kbd->kab", hl, pll_diag, hl)
        + (std_z**2) * jnp.eye(2)[None]
    )

    visible = jax.vmap(
        lambda l, i, hh: _visible_gate(cam_model, cam_state, l, i, hh)
    )(lms, state.is_id, h)
    visible = visible & state.active

    kz = jnp.zeros((k, 2))
    return Observations(
        h=h, hc=hc, hl=hl, s=s, visible=visible, z=kz,
        ic=jnp.zeros((k,), bool), z_xyz=jnp.zeros((k, 3)),
    )


def search_ic_matches(
    obs: Observations,
    state: EkfState,
    frame: Features,
    ratio: float = 1.5,
    gate_sigma: float = 3.0,
    max_gate_px: float = 40.0,
    gate_first: bool = False,
) -> tuple[Observations, EkfState]:
    """Match stored landmark descriptors to the frame's features, gated by
    the predicted search region (search_IC_matches.m:33-44 +
    matching_sift_based.m:118-133). Updates stored descriptors on success
    (the reference refreshes the per-feature descriptor).

    gate_first=False reproduces the reference's order — global best
    descriptor match first (siftmatch over ALL frame features,
    matching_sift_based.m:118), search-region gate second (:129-130) — so
    a landmark whose global best match lands outside its gate gets no
    match even when an in-gate runner-up is correct. gate_first=True
    restricts the candidate set to the ellipse BEFORE the ratio test
    (one [K, N] mask on the distance matrix): recall recovered in
    repetitive texture at identical cost."""
    # search-region gate: 3σ of the innovation, clamped (reference falls
    # back to 40 px when S is degenerate)
    sig = jnp.sqrt(
        jnp.maximum(jnp.maximum(obs.s[:, 0, 0], obs.s[:, 1, 1]), 1e-9)
    )
    gate = jnp.minimum(gate_sigma * sig, max_gate_px)
    pair_mask = None
    if gate_first:
        d_all = jnp.linalg.norm(
            frame.uv[None, :, :] - obs.h[:, None, :], axis=-1
        )  # [K, N]
        pair_mask = d_all <= gate[:, None]
    m = match_descriptors(
        state.desc, frame.desc, valid1=obs.visible, valid2=frame.valid,
        ratio=ratio, pair_mask=pair_mask,
    )
    z = frame.uv[m.index]  # [K, 2]
    dist = jnp.linalg.norm(z - obs.h, axis=-1)
    ic = m.accepted & obs.visible & (dist <= gate)
    new_desc = jnp.where(ic[:, None], frame.desc[m.index], state.desc)
    z_xyz = jnp.where(ic[:, None], frame.xyz[m.index], 0.0)
    return (
        obs._replace(z=jnp.where(ic[:, None], z, 0.0), ic=ic, z_xyz=z_xyz),
        state._replace(desc=new_desc),
    )
