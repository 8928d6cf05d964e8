"""SIFT detector + descriptor as dense tensor programs.

Re-design of the reference's vendored Vedaldi SIFT (sift/sift_vedal.m:
1-323 pipeline; C MEX kernels siftlocalmax.c, siftrefinemx.c, siftormx.c,
siftdescriptor.c — ~2.6k lines of C). Per SURVEY §2.3, each MEX kernel maps
to a dense tensor formulation:

  siftlocalmax.c   → 26-neighbor max/min test as rolled-stack comparisons
                     over the whole [S+2, H, W] DoG tensor at once
  siftrefinemx.c   → batched 3×3 quadratic refinement (one closed-form
                     solve per pixel, masked) + Harris-style edge rejection
  siftormx.c       → orientation histograms via one-hot matmul over a
                     fixed per-keypoint sample grid (gathered bilinearly)
  siftdescriptor.c → 4×4×8 trilinear binning as an einsum of hat-function
                     weights — the scatter becomes a dense [samples, bins]
                     contraction (a matrix product)

Fixed-capacity keypoint lists per octave (top-k by |DoG|), masked. With
upright=False each keypoint emits up to 2 orientation peaks (the reference
emits one keypoint per peak within 80% of the max, sift_vedal.m:232-317);
the duplicates occupy a second masked [K] block, so capacity doubles to
2·K per octave in that mode.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.frontend.scalespace import (
    Octave, build_pyramid, gradient_polar,
)

NBP = 4  # descriptor spatial bins
NBO = 8  # descriptor orientation bins
N_ORI_BINS = 36
MAGNIF = 3.0  # descriptor bin width in units of σ (Lowe/Vedaldi magnif)
DESC_SAMPLES = 16  # sample grid is DESC_SAMPLES × DESC_SAMPLES
ORI_RADIUS = 8  # orientation window half-size (octave pixels)


class SiftFeatures(NamedTuple):
    uv: jnp.ndarray  # [K, 2] input-resolution pixel positions
    scale: jnp.ndarray  # [K] σ in input-resolution pixels
    orientation: jnp.ndarray  # [K] radians
    desc: jnp.ndarray  # [K, 128]
    score: jnp.ndarray  # [K] |DoG| response
    valid: jnp.ndarray  # [K] bool


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


def _local_extrema(dog: jnp.ndarray, peak_thresh: float) -> jnp.ndarray:
    """[S+2, H, W] → bool mask of 26-neighborhood extrema (valid only on
    interior levels/pixels; caller masks borders)."""
    neigh_max = jnp.full_like(dog, -jnp.inf)
    neigh_min = jnp.full_like(dog, jnp.inf)
    for dl in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dl == 0 and dr == 0 and dc == 0:
                    continue
                sh = jnp.roll(dog, (-dl, -dr, -dc), axis=(0, 1, 2))
                neigh_max = jnp.maximum(neigh_max, sh)
                neigh_min = jnp.minimum(neigh_min, sh)
    is_max = (dog > neigh_max) & (dog > peak_thresh)
    is_min = (dog < neigh_min) & (dog < -peak_thresh)
    return is_max | is_min


def _refine(dog: jnp.ndarray):
    """Quadratic subpixel refinement over the whole DoG tensor.

    Returns (offset [S+2, H, W, 3] in (level, row, col) order, edge_ok,
    refined_value). Closed-form 3×3 solve via adjugate (no linalg.solve —
    stays elementwise)."""
    d = dog
    # first derivatives (central)
    gl = 0.5 * (jnp.roll(d, -1, 0) - jnp.roll(d, 1, 0))
    gr = 0.5 * (jnp.roll(d, -1, 1) - jnp.roll(d, 1, 1))
    gc = 0.5 * (jnp.roll(d, -1, 2) - jnp.roll(d, 1, 2))
    # second derivatives
    hll = jnp.roll(d, -1, 0) + jnp.roll(d, 1, 0) - 2 * d
    hrr = jnp.roll(d, -1, 1) + jnp.roll(d, 1, 1) - 2 * d
    hcc = jnp.roll(d, -1, 2) + jnp.roll(d, 1, 2) - 2 * d

    def cross(a, b):
        return 0.25 * (
            jnp.roll(d, (-1, -1), (a, b))
            + jnp.roll(d, (1, 1), (a, b))
            - jnp.roll(d, (-1, 1), (a, b))
            - jnp.roll(d, (1, -1), (a, b))
        )

    hlr, hlc, hrc = cross(0, 1), cross(0, 2), cross(1, 2)

    # Solve H x = -g for x via adjugate of the symmetric 3×3 H.
    a, b_, c = hll, hlr, hlc
    e, f = hrr, hrc
    i = hcc
    det = a * (e * i - f * f) - b_ * (b_ * i - f * c) + c * (b_ * f - e * c)
    safe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    # adjugate rows (symmetric)
    a00 = e * i - f * f
    a01 = c * f - b_ * i
    a02 = b_ * f - c * e
    a11 = a * i - c * c
    a12 = b_ * c - a * f
    a22 = a * e - b_ * b_
    xl = -(a00 * gl + a01 * gr + a02 * gc) / safe
    xr = -(a01 * gl + a11 * gr + a12 * gc) / safe
    xc = -(a02 * gl + a12 * gr + a22 * gc) / safe
    offset = jnp.stack([xl, xr, xc], axis=-1)
    refined = d + 0.5 * (gl * xl + gr * xr + gc * xc)
    # Edge rejection on the spatial 2×2 Hessian (siftrefinemx.c, r=10)
    r_edge = 10.0
    tr = hrr + hcc
    det2 = hrr * hcc - hrc * hrc
    edge_ok = (det2 > 0) & (
        tr * tr / jnp.where(det2 == 0, 1e-12, det2)
        < (r_edge + 1) ** 2 / r_edge
    )
    return offset, edge_ok, refined


def _detect_octave(
    oct_: Octave, peak_thresh: float, max_keypoints: int, s_levels: int,
    sigma0: float,
):
    """Top-K keypoints of one octave: (row, col, level, σ_oct, score, ok)."""
    dog = oct_.dog
    n_lev, h, w = dog.shape
    extrema = _local_extrema(dog, peak_thresh)
    offset, edge_ok, refined = _refine(dog)

    levels = jax.lax.broadcasted_iota(jnp.int32, dog.shape, 0)
    rows = jax.lax.broadcasted_iota(jnp.int32, dog.shape, 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, dog.shape, 2)
    border = 5
    interior = (
        (levels >= 1) & (levels <= n_lev - 2)
        & (rows >= border) & (rows < h - border)
        & (cols >= border) & (cols < w - border)
    )
    small_off = jnp.all(jnp.abs(offset) < 1.5, axis=-1)
    ok = extrema & edge_ok & interior & small_off & (
        jnp.abs(refined) > peak_thresh
    )
    score = jnp.where(ok, jnp.abs(refined), 0.0)

    flat = score.reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_keypoints)
    lvl = idx // (h * w)
    rem = idx % (h * w)
    r = rem // w
    c = rem % w
    off = offset.reshape(-1, 3)[idx]
    valid = vals > 0
    # refined continuous position/level
    r_f = r.astype(jnp.float32) + off[:, 1]
    c_f = c.astype(jnp.float32) + off[:, 2]
    s_f = lvl.astype(jnp.float32) + off[:, 0] - 1.0  # back to -1-based s
    k = 2.0 ** (1.0 / s_levels)
    sigma = sigma0 * jnp.power(k, s_f)
    return r_f, c_f, lvl, sigma, vals, valid


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------


def _gather_bilinear_level(
    stack: jnp.ndarray,  # [L, H, W]
    level: jnp.ndarray,  # [K] int32
    uv: jnp.ndarray,  # [K, S, 2] float (u=col, v=row)
) -> jnp.ndarray:
    """Bilinear sample per keypoint from its own pyramid level: [K, S]."""
    l_, h, w = stack.shape
    flat = stack.reshape(-1)
    u = jnp.clip(uv[..., 0], 0.0, w - 1.001)
    v = jnp.clip(uv[..., 1], 0.0, h - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = u - u0
    dv = v - v0
    base = level[:, None] * (h * w)

    def at(vi, ui):
        return flat[base + vi * w + ui]

    return (
        at(v0, u0) * (1 - du) * (1 - dv)
        + at(v0, u0 + 1) * du * (1 - dv)
        + at(v0 + 1, u0) * (1 - du) * dv
        + at(v0 + 1, u0 + 1) * du * dv
    )


# ---------------------------------------------------------------------------
# Orientation
# ---------------------------------------------------------------------------


def _orientations(
    mag: jnp.ndarray, ang: jnp.ndarray, level: jnp.ndarray,
    r_f: jnp.ndarray, c_f: jnp.ndarray, sigma: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top-2 gradient orientations per keypoint (siftormx.c).

    Fixed (2R+1)² sample window; Gaussian weight uses the per-keypoint
    σ_w = 1.5σ. Histogram built by one-hot contraction, smoothed
    circularly, peaks refined by parabolic interpolation.

    Returns (θ₁ [K], θ₂ [K], has2 [K] bool). The reference emits one
    keypoint per histogram peak within 80% of the global maximum
    (sift/sift_vedal.m:232-317, siftormx.c); we cap at 2 peaks — Lowe
    reports ~15% of keypoints carry a second peak, so 2 covers nearly all
    multi-orientation emissions with a static shape."""
    rr = jnp.arange(-ORI_RADIUS, ORI_RADIUS + 1, dtype=jnp.float32)
    gu, gv = jnp.meshgrid(rr, rr, indexing="xy")
    grid = jnp.stack([gu.ravel(), gv.ravel()], axis=-1)  # [S², 2]
    pts = jnp.stack([c_f, r_f], axis=-1)[:, None, :] + grid[None]
    m = _gather_bilinear_level(mag, level, pts)  # [K, S²]
    a = _gather_bilinear_level(ang, level, pts)
    d2 = jnp.sum(grid * grid, axis=-1)[None]  # [1, S²]
    sw = 1.5 * sigma[:, None]
    wgt = jnp.exp(-d2 / (2.0 * sw * sw)) * m
    # one-hot histogram over 36 bins
    bin_f = (a % (2 * jnp.pi)) / (2 * jnp.pi) * N_ORI_BINS
    b0 = jnp.floor(bin_f).astype(jnp.int32) % N_ORI_BINS
    frac = bin_f - jnp.floor(bin_f)
    bins = jnp.arange(N_ORI_BINS)
    oh0 = (b0[..., None] == bins).astype(jnp.float32) * (1 - frac)[..., None]
    oh1 = ((b0[..., None] + 1) % N_ORI_BINS == bins).astype(jnp.float32) * (
        frac[..., None]
    )
    hist = jnp.einsum("ks,ksb->kb", wgt, oh0 + oh1)
    # circular smoothing ×2 (reference smooths the histogram)
    for _ in range(2):
        hist = (
            hist + 0.5 * (jnp.roll(hist, 1, -1) + jnp.roll(hist, -1, -1))
        ) / 2.0
    def refine(peak):
        hm = jnp.take_along_axis(hist, peak[:, None], axis=-1)[:, 0]
        hl = jnp.take_along_axis(
            hist, ((peak - 1) % N_ORI_BINS)[:, None], axis=-1
        )[:, 0]
        hr = jnp.take_along_axis(
            hist, ((peak + 1) % N_ORI_BINS)[:, None], axis=-1
        )[:, 0]
        denom = hl - 2 * hm + hr
        dpk = jnp.where(
            jnp.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, 0.0
        )
        return (peak + dpk) * (2 * jnp.pi / N_ORI_BINS), hm

    peak1 = jnp.argmax(hist, axis=-1)
    theta1, h1 = refine(peak1)
    # second peak: the best circular local maximum other than the global
    # one, admitted at ≥ 80% of the global peak (Lowe's rule, siftormx.c)
    is_max = (hist >= jnp.roll(hist, 1, -1)) & (hist > jnp.roll(hist, -1, -1))
    cand = jnp.where(
        is_max & (bins[None] != peak1[:, None]), hist, -jnp.inf
    )
    peak2 = jnp.argmax(cand, axis=-1)
    theta2, h2 = refine(peak2)
    has2 = jnp.take_along_axis(cand, peak2[:, None], -1)[:, 0] >= 0.8 * h1
    return theta1, theta2, has2


# ---------------------------------------------------------------------------
# Descriptor
# ---------------------------------------------------------------------------


def _fast_math() -> bool:
    """Opt-in bf16 operands for the band/descriptor matmuls:
    PRE3_SIFT_FAST_MATH=1 turns them on; unset or any other value keeps
    exact f32. Read at TRACE time — changing the env after a jitted
    caller compiled does not retrace; tests should wrap a fresh jit
    (tests/test_sift.py::TestFastMathBranches).
    """
    return os.environ.get("PRE3_SIFT_FAST_MATH") == "1"


def _band_matrix(n: int, delta: float) -> np.ndarray:
    """[n, n] banded triangle-filter matrix: B[p, q] = hat((p−q)/Δ).
    Static (trace-time numpy) — one per (level, axis length)."""
    idx = np.arange(n)
    return np.maximum(
        0.0, 1.0 - np.abs(idx[:, None] - idx[None, :]) / delta
    ).astype(np.float32)


def _tri_sepconv(x: jnp.ndarray, delta: float) -> jnp.ndarray:
    """Separable triangle (hat) convolution of [H, W, C]:
    out(p) = Σ_q max(0, 1−|pᵣ−qᵣ|/Δ)·max(0, 1−|p_c−q_c|/Δ)·x(q).

    Implemented as two banded-matrix contractions rather than
    conv_general_dilated, so the ~30-tap spatial kernel becomes an
    [H, H] × [H, W·C] matrix product. Which of the two is faster on an
    H100 is not measured (ROADMAP Design 3). The band matrices are
    static constants (Δ is trace-time)."""
    h, w, _ = x.shape
    br = jnp.asarray(_band_matrix(h, delta))  # [H, H]
    bc = jnp.asarray(_band_matrix(w, delta))  # [W, W]
    # Opt-in bf16 inputs with f32 accumulation: these matmuls feed the
    # descriptor (normalized + clamped downstream), where bf16's ~3
    # decimal digits are ample.
    if _fast_math():
        br, bc, x = (a.astype(jnp.bfloat16) for a in (br, bc, x))
    y = jnp.einsum("hH,Hwc->hwc", br, x,
                   preferred_element_type=jnp.float32)
    if _fast_math():
        y = y.astype(jnp.bfloat16)
    return jnp.einsum("wW,hWc->hwc", bc, y,
                      preferred_element_type=jnp.float32)


def _descriptors_dense(
    mag: jnp.ndarray, ang: jnp.ndarray, level: jnp.ndarray,
    r_f: jnp.ndarray, c_f: jnp.ndarray, sigma: jnp.ndarray,
    s_levels: int, sigma0: float,
) -> jnp.ndarray:
    """Upright 128-D descriptors via dense pre-binning — the dense-tensor
    formulation of siftdescriptor.c (SURVEY §2.3). The sampled form
    (_descriptors) issues ~1k scalar gathers per keypoint; here the
    irregular work collapses to 64 8-vector gathers per keypoint:

      1. orientation binning:  m8[h,w,o] = mag·hat(ang→8 bins)   (dense elementwise)
      2. spatial binning:      B = triangle-conv(m8, Δ_l) per level, with
         the footprint Δ_l = MAGNIF·σ_l quantized to the level's nominal
         scale (vlfeat-dsift-style approximation)        (dense sepconv)
      3. per keypoint: bilinear-sample B at its 4×4 bin centers, weight
         by the Gaussian window evaluated at bin centers (flat-window
         approximation), normalize/clamp/renormalize.

    Upright only (θ=0): rotation would break the shared dense binning;
    extract_sift falls back to _descriptors when upright=False.
    """
    n_lev, h, w = mag.shape
    k_scale = 2.0 ** (1.0 / s_levels)

    # 1. orientation hat binning (dense, all levels at once)
    af = (ang % (2 * jnp.pi)) / (2 * jnp.pi) * NBO  # [L, H, W]
    ob = jnp.arange(NBO, dtype=mag.dtype)
    diff = jnp.abs(af[..., None] - ob)
    circ = jnp.minimum(diff, NBO - diff)
    m8 = mag[..., None] * jnp.maximum(0.0, 1.0 - circ)  # [L, H, W, 8]

    # 2. per-level triangle pre-binning at the level's nominal Δ
    binned = jnp.stack([
        _tri_sepconv(m8[l], MAGNIF * sigma0 * k_scale ** (l - 1.0))
        for l in range(n_lev)
    ])  # [L, H, W, 8]

    # 3. sample each keypoint's 4×4 bin centers. The bilinear gather is
    # reformulated as two one-hot contractions — a [K·16, L·W] × [L·W, H·8]
    # matmul (level+column taps) followed by a row-tap reduce — instead of
    # a [K, 16, 8]-shaped random gather. Whether the gather would be
    # faster on an H100 is not measured (ROADMAP Design 3).
    centers = jnp.arange(NBP, dtype=mag.dtype) - (NBP - 1) / 2.0
    gx, gy = jnp.meshgrid(centers, centers, indexing="xy")
    gxy = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)  # [16, 2] bin units
    delta_k = (MAGNIF * sigma)[:, None]  # [K, 1] px per bin
    u = c_f[:, None] + gxy[None, :, 0] * delta_k  # [K, 16]
    v = r_f[:, None] + gxy[None, :, 1] * delta_k
    u = jnp.clip(u, 0.0, w - 1.001).reshape(-1)  # [K·16]
    v = jnp.clip(v, 0.0, h - 1.001).reshape(-1)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = u - u0
    dv = v - v0
    x = u.shape[0]  # K·16
    lvl_w = jnp.repeat(level, 16) * w  # [K·16] level offset in L·W
    cols = jnp.arange(n_lev * w, dtype=jnp.int32)[None]  # [1, L·W]
    wlc = (
        (cols == (lvl_w + u0)[:, None]) * (1.0 - du)[:, None]
        + (cols == (lvl_w + u0 + 1)[:, None]) * du[:, None]
    )  # [K·16, L·W]
    rows = jnp.arange(h, dtype=jnp.int32)[None]  # [1, H]
    wr = (
        (rows == v0[:, None]) * (1.0 - dv)[:, None]
        + (rows == (v0 + 1)[:, None]) * dv[:, None]
    )  # [K·16, H]
    # binned [L, H, W, 8] → [L·W, H·8]; tmp[x, h, o] = Σ_{l,c} wlc·binned
    src = binned.transpose(0, 2, 1, 3).reshape(n_lev * w, h * NBO)
    if _fast_math():  # bf16 taps, f32 accumulate
        wlc = wlc.astype(jnp.bfloat16)
        src = src.astype(jnp.bfloat16)
        wr = wr.astype(jnp.bfloat16)
    tmp = jax.lax.dot(
        wlc, src, preferred_element_type=jnp.float32
    ).reshape(x, h, NBO)
    samp = jnp.einsum(
        "xh,xho->xo", wr, tmp, preferred_element_type=jnp.float32
    ).reshape(-1, 16, NBO)

    # Gaussian window at bin centers (flat-window approximation)
    win = jnp.exp(
        -jnp.sum(gxy * gxy, axis=-1) / (2.0 * (NBP / 2.0) ** 2)
    )  # [16]
    desc = (samp * win[None, :, None]).reshape(samp.shape[0], -1)  # [K, 128]
    n1 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(n1, 1e-8)
    desc = jnp.minimum(desc, 0.2)
    n2 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    return desc / jnp.maximum(n2, 1e-8)


def _descriptors(
    mag: jnp.ndarray, ang: jnp.ndarray, level: jnp.ndarray,
    r_f: jnp.ndarray, c_f: jnp.ndarray, sigma: jnp.ndarray,
    theta: jnp.ndarray,
) -> jnp.ndarray:
    """128-D descriptors (siftdescriptor.c): 4×4 spatial × 8 orientation
    trilinear binning over a rotated, σ-scaled sample grid."""
    ns = DESC_SAMPLES
    # sample grid in bin units: covers [-NBP/2, NBP/2]
    lin = (jnp.arange(ns) + 0.5) / ns * NBP - NBP / 2.0  # [-2, 2)
    gx, gy = jnp.meshgrid(lin, lin, indexing="xy")
    gxy = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)  # [ns², 2] bin units

    ct, st = jnp.cos(theta), jnp.sin(theta)  # [K]
    # rotate then scale to pixels: offset = R(θ)·(x, y)·MAGNIF·σ
    scale = (MAGNIF * sigma)[:, None]  # [K, 1]
    ox = (ct[:, None] * gxy[None, :, 0] - st[:, None] * gxy[None, :, 1]) * scale
    oy = (st[:, None] * gxy[None, :, 0] + ct[:, None] * gxy[None, :, 1]) * scale
    pts = jnp.stack(
        [c_f[:, None] + ox, r_f[:, None] + oy], axis=-1
    )  # [K, ns², 2]
    m = _gather_bilinear_level(mag, level, pts)
    a = _gather_bilinear_level(ang, level, pts) - theta[:, None]

    # Gaussian window in bin units (σ_win = NBP/2)
    d2 = jnp.sum(gxy * gxy, axis=-1)[None]
    win = jnp.exp(-d2 / (2.0 * (NBP / 2.0) ** 2))
    wm = m * win  # [K, ns²]

    # spatial hat weights to the 4 bins per axis (bin centers at
    # -1.5, -0.5, 0.5, 1.5 in bin units)
    centers = jnp.arange(NBP) - (NBP - 1) / 2.0  # [-1.5 .. 1.5]
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(gxy[:, 0:1] - centers[None]))  # [ns²,4]
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(gxy[:, 1:2] - centers[None]))
    # orientation circular hat weights to 8 bins
    af = (a % (2 * jnp.pi)) / (2 * jnp.pi) * NBO  # [K, ns²]
    ob = jnp.arange(NBO)
    diff = jnp.abs(af[..., None] - ob[None, None])  # [K, ns², 8]
    circ = jnp.minimum(diff, NBO - diff)
    wo = jnp.maximum(0.0, 1.0 - circ)

    # desc[k, ybin, xbin, obin] = Σ_s wm·wy·wx·wo
    desc = jnp.einsum("ks,sy,sx,kso->kyxo", wm, wy, wx, wo)
    desc = desc.reshape(desc.shape[0], -1)  # [K, 128]
    # normalize → clamp 0.2 → renormalize (Lowe illumination handling)
    n1 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(n1, 1e-8)
    desc = jnp.minimum(desc, 0.2)
    n2 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    return desc / jnp.maximum(n2, 1e-8)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "n_octaves", "s_levels", "keypoints_per_octave", "peak_thresh",
        "upright",
    ),
)
def extract_sift(
    img: jnp.ndarray,
    n_octaves: int = 3,
    s_levels: int = 3,
    keypoints_per_octave: int = 128,
    peak_thresh: float = 0.004,
    upright: bool = True,
) -> SiftFeatures:
    """SIFT on [H, W] float image in [0, 1] → fixed-capacity feature set
    (K = n_octaves · keypoints_per_octave, masked).

    upright=True skips orientation assignment (θ=0): for RGB-D SLAM with
    small inter-frame roll, upright descriptors are markedly more
    repeatable on weakly-oriented texture (the reference always assigns
    orientations — documented deviation; set upright=False for full
    rotation invariance)."""
    sigma0 = 1.6 * 2.0 ** (1.0 / s_levels)
    octaves = build_pyramid(
        img, n_octaves=n_octaves, s_levels=s_levels, sigma0=sigma0
    )
    outs = []
    for oct_ in octaves:
        r_f, c_f, lvl, sigma, score, valid = _detect_octave(
            oct_, peak_thresh, keypoints_per_octave, s_levels, sigma0
        )
        mags, angs = [], []
        for s in range(oct_.gss.shape[0]):
            mg, an = gradient_polar(oct_.gss[s])
            mags.append(mg)
            angs.append(an)
        mag = jnp.stack(mags)
        ang = jnp.stack(angs)
        if upright:
            theta = jnp.zeros_like(sigma)
            desc = _descriptors_dense(
                mag, ang, lvl, r_f, c_f, sigma, s_levels, sigma0
            )
        else:
            # Multi-orientation emission (sift_vedal.m:232-317): each
            # second peak ≥ 80% of the max becomes its own keypoint at the
            # same location/scale — duplicate the slot arrays [K] → [2K]
            # and mask the copies without a qualifying second peak.
            theta1, theta2, has2 = _orientations(
                mag, ang, lvl, r_f, c_f, sigma
            )
            theta = jnp.concatenate([theta1, theta2])
            r_f = jnp.concatenate([r_f, r_f])
            c_f = jnp.concatenate([c_f, c_f])
            lvl = jnp.concatenate([lvl, lvl])
            sigma = jnp.concatenate([sigma, sigma])
            score = jnp.concatenate([score, jnp.where(has2, score, 0.0)])
            valid = jnp.concatenate([valid, valid & has2])
            desc = _descriptors(mag, ang, lvl, r_f, c_f, sigma, theta)
        ds = float(oct_.downsample)
        outs.append(
            SiftFeatures(
                uv=jnp.stack([c_f * ds, r_f * ds], axis=-1),
                scale=sigma * ds,
                orientation=theta,
                desc=desc,
                score=score,
                valid=valid,
            )
        )
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
