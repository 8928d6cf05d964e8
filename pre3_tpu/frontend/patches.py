"""Patch descriptors: normalized intensity patches around keypoints.

Dense-tensor analog of the reference's NCC patch matching frontend
(mex_files/CorePar_Ver1/matching.m:27-180 + corrcoef_partitioned.m:
warped-patch normalized cross-correlation, threshold 0.60). Key insight:
zero-mean, unit-norm patch vectors turn NCC into a plain dot product, so
patch correlation becomes the same matrix product as descriptor matching
(ops/matching.py) — `1 − NCC = dist²/2` — and the reference's dedicated
partitioned-corrcoef MEX kernel disappears into the matcher.

Extraction is a batched bilinear gather at a fixed K×P×P sample grid
(vmap over keypoints), jit-friendly with static shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def bilinear_sample(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Sample img [H, W] at float pixel positions uv [..., 2] (u=col, v=row)
    with bilinear interpolation and edge clamping."""
    h, w = img.shape
    u = jnp.clip(uv[..., 0], 0.0, w - 1.001)
    v = jnp.clip(uv[..., 1], 0.0, h - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = u - u0
    dv = v - v0
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    return (
        i00 * (1 - du) * (1 - dv)
        + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv
        + i11 * du * dv
    )


def blend_matrix(coords: jnp.ndarray, n: int, dtype) -> jnp.ndarray:
    """[..., n] one-hot-blend interpolation rows: weight (1−frac) at
    floor(c) and frac at floor(c)+1 — one bilinear axis as a matrix so
    sampling becomes a matmul (see extract_patch_descriptors)."""
    c0 = jnp.floor(coords).astype(jnp.int32)
    dc = coords - c0
    return (
        jax.nn.one_hot(c0, n, dtype=dtype) * (1.0 - dc)[..., None]
        + jax.nn.one_hot(c0 + 1, n, dtype=dtype) * dc[..., None]
    )


@partial(jax.jit, static_argnames=("patch", "stride"))
def extract_patch_descriptors(
    img: jnp.ndarray,
    uv: jnp.ndarray,  # [K, 2] keypoint centers
    patch: int = 11,
    stride: float = 1.0,
) -> jnp.ndarray:
    """[K, patch²] zero-mean unit-norm patch descriptors.

    With these, matching via squared L2 distance is exactly NCC matching:
    ‖a − b‖² = 2(1 − NCC(a, b)); the reference's 0.60 correlation gate
    becomes dist² < 0.80.

    The patch grid is an outer product of per-keypoint u-coords ×
    v-coords, so the whole [K, P, P] stack is two separable blend
    matmuls W_v · img · W_uᵀ — identical values to the 4-corner gather
    form, but matrix products instead of 4·K·P² scalar gathers (which
    form is faster is not measured on the H100; ROADMAP Design 3).
    """
    h, w = img.shape
    half = (patch - 1) / 2.0
    offs = (jnp.arange(patch) - half) * stride
    u = jnp.clip(uv[:, 0][:, None] + offs[None, :], 0.0, w - 1.001)
    v = jnp.clip(uv[:, 1][:, None] + offs[None, :], 0.0, h - 1.001)
    wu = blend_matrix(u, w, img.dtype)  # [K, P, W]
    wv = blend_matrix(v, h, img.dtype)  # [K, P, H]
    rows = jnp.einsum(
        "kph,hw->kpw", wv, img, precision=jax.lax.Precision.HIGHEST
    )
    vals = jnp.einsum(
        "kpw,kqw->kpq", rows, wu, precision=jax.lax.Precision.HIGHEST
    ).reshape(uv.shape[0], patch * patch)  # row-major (v, u) = grid order
    vals = vals - jnp.mean(vals, axis=-1, keepdims=True)
    n = jnp.linalg.norm(vals, axis=-1, keepdims=True)
    return vals / jnp.maximum(n, 1e-8)


def ncc_from_dist2(dist2: jnp.ndarray) -> jnp.ndarray:
    """Convert matcher squared distances back to NCC values."""
    return 1.0 - 0.5 * dist2
