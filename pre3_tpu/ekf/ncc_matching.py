"""Warped-patch NCC map matching — the FAST/NCC measurement path.

Dense-tensor re-design of the reference's correlation matcher
(mex_files/CorePar_Ver1/matching.m:27-180 + corrcoef_partitioned MEX):
for every map feature, scan candidate pixels inside the innovation
ellipse of S, correlate the image patch at each candidate against the
feature's *warped init patch* (pred_patch_fc.m), and accept the best
candidate with NCC ≥ 0.60 (matching.m:31).

The reference walks the ellipse pixels in a data-dependent double loop
and calls a partitioned-corrcoef MEX kernel; here each feature gets a
fixed G×G candidate grid scaled to its own 3σ search box, all K·G²·P²
candidate-patch pixels are produced by two separable one-hot-blend
interpolation matmuls (the grid is an outer product per feature —
matrix products, no gathers), and all K·G² correlations happen as one batched dot
product (zero-mean unit-norm patches make NCC an inner product — see
frontend/patches.py). Static shapes, no native kernel.

Unlike the descriptor path (measurement.py search_ic_matches), the stored
appearance is never refreshed: the reference's NCC path always warps the
patch captured at initialization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pre3_tpu.ekf.measurement import Observations
from pre3_tpu.ekf.state import EkfState
from pre3_tpu.frontend.patches import bilinear_sample
from pre3_tpu.frontend.patch_warp import predict_patches
from pre3_tpu.geometry.camera import Camera
from pre3_tpu.geometry.inverse_depth import inverse_depth_to_cartesian

CHI2_2DOF_95 = 5.9915  # χ²(2, 0.95) — the reference's ellipse gate


def search_ic_matches_ncc(
    cam: Camera,
    obs: Observations,
    state: EkfState,
    image: jnp.ndarray,  # [H, W] current intensity image
    xyz_img: jnp.ndarray | None = None,  # [H, W, 3] camera-frame points
    patch: int = 11,
    grid: int = 13,
    ncc_threshold: float = 0.60,
    max_gate_px: float = 20.0,
    min_gate_px: float = 2.0,
) -> Observations:
    """Match every visible map feature by warped-patch NCC.

    Returns obs with z / ic / z_xyz filled. [K, G²] candidate scan per
    feature, candidates limited to the Mahalanobis ellipse of S
    (matching.m:75-97 half-axis scan).
    """
    k = state.n_landmarks
    lms = state.landmarks
    lms_w = jnp.where(
        state.is_id[:, None],
        jax.vmap(inverse_depth_to_cartesian)(lms),
        lms[:, :3],
    )

    pred_desc = predict_patches(
        cam, state.init_patch, state.init_uv, state.init_cam,
        state.x[0:7], lms_w, obs.h, patch=patch,
    )  # [K, P²]

    # Per-feature candidate grid spanning the 3σ box of S (clamped).
    sig_u = jnp.sqrt(jnp.maximum(obs.s[:, 0, 0], 1e-9))
    sig_v = jnp.sqrt(jnp.maximum(obs.s[:, 1, 1], 1e-9))
    r_u = jnp.clip(3.0 * sig_u, min_gate_px, max_gate_px)
    r_v = jnp.clip(3.0 * sig_v, min_gate_px, max_gate_px)
    lin = jnp.linspace(-1.0, 1.0, grid)
    gu, gv = jnp.meshgrid(lin, lin, indexing="xy")
    unit = jnp.stack([gu, gv], axis=-1).reshape(-1, 2)  # [G², 2] in [-1,1]
    radii = jnp.stack([r_u, r_v], axis=-1)  # [K, 2]
    centers = obs.h[:, None, :] + unit[None] * radii[:, None, :]  # [K,G²,2]

    # Ellipse + image-bounds gate per candidate.
    d = centers - obs.h[:, None, :]  # [K, G², 2]
    s_inv = jnp.linalg.inv(
        obs.s + 1e-9 * jnp.eye(2)[None]
    )  # [K, 2, 2]
    mahal = jnp.einsum("kca,kab,kcb->kc", d, s_inv, d)
    h_img, w_img = image.shape
    inb = (
        (centers[..., 0] > patch)
        & (centers[..., 0] < w_img - patch - 1)
        & (centers[..., 1] > patch)
        & (centers[..., 1] < h_img - patch - 1)
    )
    cand_ok = (mahal <= CHI2_2DOF_95) & inb  # [K, G²]

    # Candidate patches via SEPARABLE bilinear interpolation: for one
    # feature, every candidate-patch pixel sits on the outer product of
    # G·P distinct u-coords × G·P distinct v-coords (candidate centers
    # on a regular per-feature grid + integer patch offsets), so the
    # whole [G², P²] patch stack is two interpolation matmuls
    # W_v · img · W_uᵀ with 2-nonzero one-hot-blend rows — matrix
    # products in place of 4·K·G²·P² ≈ 42M scalar gathers per frame
    # (which form is faster is not measured on the H100; ROADMAP
    # Design 3).
    half = (patch - 1) / 2.0
    offs = jnp.arange(patch) - half
    gp = grid * patch
    # u_coords[k, cu·P + pu], v_coords[k, cv·P + pv]
    u_axis = (lin[:, None, None] * r_u[None, None, :]
              + offs[None, :, None]).reshape(gp, k)  # [G·P, K] (cu, pu)
    v_axis = (lin[:, None, None] * r_v[None, None, :]
              + offs[None, :, None]).reshape(gp, k)
    u_coords = obs.h[:, 0][None, :] + u_axis  # [G·P, K]
    v_coords = obs.h[:, 1][None, :] + v_axis
    u_coords = jnp.clip(u_coords.T, 0.0, w_img - 1.001)  # [K, G·P]
    v_coords = jnp.clip(v_coords.T, 0.0, h_img - 1.001)

    def blend(coords, n):
        c0 = jnp.floor(coords).astype(jnp.int32)
        dc = coords - c0
        return (
            jax.nn.one_hot(c0, n, dtype=image.dtype) * (1.0 - dc)[..., None]
            + jax.nn.one_hot(c0 + 1, n, dtype=image.dtype) * dc[..., None]
        )  # [K, G·P, n]

    wu = blend(u_coords, w_img)  # [K, G·P, W]
    wv = blend(v_coords, h_img)  # [K, G·P, H]
    # throughput matmuls: patch intensities tolerate default precision
    rows = jnp.einsum(
        "kvh,hw->kvw", wv, image,
        precision=jax.lax.Precision.DEFAULT,
    )  # [K, G·P, W]
    g2 = jnp.einsum(
        "kvw,kuw->kvu", rows, wu,
        precision=jax.lax.Precision.DEFAULT,
    )  # [K, G·P(v), G·P(u)]
    g5 = g2.reshape(k, grid, patch, grid, patch)  # [k, cv, pv, cu, pu]
    vals = jnp.transpose(g5, (0, 1, 3, 2, 4)).reshape(
        k, grid * grid, patch * patch
    )  # [K, G², P²] — candidate c = cv·G + cu, pixel p = pv·P + pu
    vals = vals - jnp.mean(vals, axis=-1, keepdims=True)
    vals = vals / jnp.maximum(
        jnp.linalg.norm(vals, axis=-1, keepdims=True), 1e-8
    )

    ncc = jnp.einsum("kp,kcp->kc", pred_desc, vals)  # [K, G²]
    ncc = jnp.where(cand_ok, ncc, -2.0)
    best = jnp.argmax(ncc, axis=-1)  # [K]
    best_ncc = jnp.take_along_axis(ncc, best[:, None], axis=-1)[:, 0]
    z = jnp.take_along_axis(
        centers, best[:, None, None].repeat(2, -1), axis=1
    )[:, 0]  # [K, 2]

    ic = obs.visible & state.active & (best_ncc >= ncc_threshold)
    z = jnp.where(ic[:, None], z, 0.0)

    if xyz_img is not None:
        z_xyz = jax.vmap(
            lambda uv: jax.vmap(
                lambda ch: bilinear_sample(ch, uv)
            )(jnp.moveaxis(xyz_img, -1, 0))
        )(z)  # [K, 3]
        z_xyz = jnp.where(ic[:, None], z_xyz, 0.0)
    else:
        z_xyz = jnp.zeros((k, 3))

    return obs._replace(z=z, ic=ic, z_xyz=z_xyz)
