"""Warped-patch appearance prediction for NCC map matching.

Dense-tensor re-design of the reference's patch-warp stack
(pred_patch_fc.m:27-90, predict_features_appearance.m:26-54,
rotate_with_dist_fc_c1c2.m / _c2c1.m): each map feature stores the raw
intensity patch and camera pose captured at initialization; before NCC
matching, that patch is re-rendered into the current view under the
assumption that the feature lies on a plane whose normal points along the
initial viewing ray.

Instead of composing an explicit pixel homography and special-casing the
radial distortion (the reference's rotate_with_dist_* pair), each target
pixel is traced exactly: undistort → ray → ray/plane intersection in
world → reproject + distort into the init view → bilinear sample. This
is a fixed-size gather per feature, vmap-friendly, and exact under the
2-parameter distortion model.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pre3_tpu.frontend.patches import bilinear_sample
from pre3_tpu.geometry.camera import Camera, project_point, distort, unproject
from pre3_tpu.geometry.quaternion import qconj, qrotate


@partial(jax.jit, static_argnames=("size",))
def extract_raw_patches(
    img: jnp.ndarray, uv: jnp.ndarray, size: int = 21
) -> jnp.ndarray:
    """[K, size, size] raw (unnormalized) intensity patches centered at uv.

    The stored "patch_when_initialized" of the reference feature record
    (add_feature_to_info_vector_my_version_sift.m:45-80 keeps a large
    init patch for later warping)."""
    half = (size - 1) / 2.0
    offs = jnp.arange(size) - half
    gu, gv = jnp.meshgrid(offs, offs, indexing="xy")
    grid = jnp.stack([gu, gv], axis=-1)  # [size, size, 2]
    pts = uv[:, None, None, :] + grid[None]  # [K, size, size, 2]
    return bilinear_sample(img, pts)


def _plane_point(
    o_w: jnp.ndarray,  # [3] ray origin (current camera center, world)
    d_w: jnp.ndarray,  # [..., 3] ray directions (world)
    p_w: jnp.ndarray,  # [3] plane point (landmark, world)
    n_w: jnp.ndarray,  # [3] plane normal (world)
) -> jnp.ndarray:
    """Ray/plane intersection X = o + s·d with s clamped positive."""
    denom = jnp.einsum("...i,i->...", d_w, n_w)
    safe = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    s = jnp.einsum("i,i->", p_w - o_w, n_w) / safe
    s = jnp.clip(s, 1e-3, 1e3)
    return o_w + s[..., None] * d_w


def predict_patch_appearance(
    cam: Camera,
    init_patch: jnp.ndarray,  # [PB, PB] raw patch at initialization
    init_uv: jnp.ndarray,  # [2] pixel of the feature at initialization
    init_cam: jnp.ndarray,  # [7] (t_w, q_wc) pose at initialization
    cur_cam: jnp.ndarray,  # [7] (t_w, q_wc) current pose
    lm_w: jnp.ndarray,  # [3] landmark position, world frame
    h_pred: jnp.ndarray,  # [2] predicted pixel in the current view
    patch: int = 11,
) -> jnp.ndarray:
    """[patch²] zero-mean unit-norm predicted appearance of one feature.

    Mirrors pred_patch_fc.m:52-80: plane through the landmark with normal
    along the initial view ray, warped by the relative camera motion.
    """
    t_i, q_i = init_cam[0:3], init_cam[3:7]
    t_c, q_c = cur_cam[0:3], cur_cam[3:7]
    n_w = lm_w - t_i
    n_w = n_w / jnp.maximum(jnp.linalg.norm(n_w), 1e-9)

    half = (patch - 1) / 2.0
    offs = jnp.arange(patch) - half
    gu, gv = jnp.meshgrid(offs, offs, indexing="xy")
    grid_uv = h_pred + jnp.stack([gu, gv], axis=-1)  # [P, P, 2] distorted px

    d_c = unproject(cam, grid_uv)  # [P, P, 3] rays, current camera frame
    d_w = qrotate(q_c, d_c)
    x_w = _plane_point(t_c, d_w, lm_w, n_w)  # [P, P, 3]

    x_i = qrotate(qconj(q_i), x_w - t_i)  # init camera frame
    uv_i = distort(cam, project_point(cam, x_i))  # [P, P, 2]

    pb = init_patch.shape[-1]
    center = (pb - 1) / 2.0
    sample = (uv_i - init_uv + center).reshape(-1, 2)  # [P², 2]
    # Warped coords are not axis-separable (full homography+distortion
    # trace), so the bilinear read is one one-hot contraction over the
    # flattened init patch instead of 4 scalar gathers (which form is
    # faster is not measured on the H100; ROADMAP Design 3).
    u = jnp.clip(sample[:, 0], 0.0, pb - 1.001)
    v = jnp.clip(sample[:, 1], 0.0, pb - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du, dv = u - u0, v - v0
    idx = v0 * pb + u0  # [P²]
    n2 = pb * pb
    wmat = (
        jax.nn.one_hot(idx, n2, dtype=init_patch.dtype)
        * ((1 - du) * (1 - dv))[:, None]
        + jax.nn.one_hot(idx + 1, n2, dtype=init_patch.dtype)
        * (du * (1 - dv))[:, None]
        + jax.nn.one_hot(idx + pb, n2, dtype=init_patch.dtype)
        * ((1 - du) * dv)[:, None]
        + jax.nn.one_hot(idx + pb + 1, n2, dtype=init_patch.dtype)
        * (du * dv)[:, None]
    )  # [P², PB²]
    vals = wmat @ init_patch.reshape(-1)  # [P²]
    vals = vals - jnp.mean(vals)
    return vals / jnp.maximum(jnp.linalg.norm(vals), 1e-8)


def predict_patches(
    cam: Camera,
    init_patches: jnp.ndarray,  # [K, PB, PB]
    init_uvs: jnp.ndarray,  # [K, 2]
    init_cams: jnp.ndarray,  # [K, 7]
    cur_cam: jnp.ndarray,  # [7]
    lms_w: jnp.ndarray,  # [K, 3]
    h_pred: jnp.ndarray,  # [K, 2]
    patch: int = 11,
) -> jnp.ndarray:
    """[K, patch²] predicted appearance of every map feature (vmapped
    predict_features_appearance.m)."""
    return jax.vmap(
        lambda ip, iu, ic, lm, h: predict_patch_appearance(
            cam, ip, iu, ic, cur_cam, lm, h, patch=patch
        )
    )(init_patches, init_uvs, init_cams, lms_w, h_pred)
