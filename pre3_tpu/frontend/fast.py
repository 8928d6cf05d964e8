"""FAST-9 corner detection, fully vectorized.

Re-design of the reference's FAST frontend (fast-matlab-src/
fast_corner_detect_9.m + fast_nonmax.m, MEX'd via MATLAB Coder — 7.7k lines
of unrolled per-pixel tests). Here the segment test is expressed as dense
whole-image tensor ops: the 16-pixel Bresenham ring is materialized as a
[16, H, W] stack of shifted images (XLA fuses the shifts), the ≥9-contiguous
test becomes a wrap-around windowed sum, and non-max suppression is a 3×3
reduce_window. Output is a fixed-K top-k corner list (static shapes).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, clockwise from 12 o'clock: (drow, dcol).
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # default: FAST-9 (the variant the reference MEX-compiles)


class Corners(NamedTuple):
    """Fixed-capacity corner list (masked)."""

    uv: jnp.ndarray  # [K, 2] (u=col, v=row) float32
    score: jnp.ndarray  # [K] float32
    valid: jnp.ndarray  # [K] bool


def _ring_stack(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] of ring-shifted copies; borders are handled by the
    validity margin in detect()."""
    shifted = [jnp.roll(img, shift=(-dr, -dc), axis=(0, 1)) for dr, dc in _RING]
    return jnp.stack(shifted, axis=0)


def fast_score_map(
    img: jnp.ndarray, threshold: float = 0.05, arc: int = ARC
) -> jnp.ndarray:
    """Per-pixel FAST-n corner score (0 where not a corner), n = arc ∈ 9..12
    (the reference ships fast_corner_detect_{9,10,11,12}.m; 9 is the one it
    MEX-compiles and uses).

    Score = max over (bright, dark) polarity of the summed threshold excess
    on the contiguous arc — the standard nonmax-suppression score.
    """
    ARC = arc
    ring = _ring_stack(img)  # [16, H, W]
    center = img[None]
    bright = ring - center - threshold  # >0 ⇒ ring pixel much brighter
    dark = center - ring - threshold

    def arc_score(excess: jnp.ndarray) -> jnp.ndarray:
        is_on = (excess > 0).astype(jnp.float32)
        # wrap-around: windows of length ARC over a ring of 16
        on2 = jnp.concatenate([is_on, is_on[: ARC - 1]], axis=0)
        ex2 = jnp.concatenate([jnp.maximum(excess, 0.0),
                               jnp.maximum(excess[: ARC - 1], 0.0)], axis=0)
        cs_on = jnp.cumsum(on2, axis=0)
        cs_ex = jnp.cumsum(ex2, axis=0)
        zeros = jnp.zeros_like(cs_on[:1])
        cs_on = jnp.concatenate([zeros, cs_on], axis=0)
        cs_ex = jnp.concatenate([zeros, cs_ex], axis=0)
        win_on = cs_on[ARC:] - cs_on[:-ARC]  # [16, H, W]
        win_ex = cs_ex[ARC:] - cs_ex[:-ARC]
        full = win_on >= ARC - 0.5
        return jnp.max(jnp.where(full, win_ex, 0.0), axis=0)

    score = jnp.maximum(arc_score(bright), arc_score(dark))
    # Invalidate the 3-pixel border (ring wraps around the image edge).
    h, w = img.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    margin = (rows >= 3) & (rows < h - 3) & (cols >= 3) & (cols < w - 3)
    return jnp.where(margin, score, 0.0)


def nonmax_suppress(score: jnp.ndarray) -> jnp.ndarray:
    """Keep pixels that are the strict max of their 3×3 neighbourhood
    (reference fast_nonmax.m)."""
    local_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= local_max, score, 0.0)


@partial(jax.jit, static_argnames=("max_corners", "arc"))
def detect(
    img: jnp.ndarray, threshold: float = 0.05, max_corners: int = 256,
    arc: int = ARC,
) -> Corners:
    """FAST-n detection → top-K corners with scores (static K)."""
    score = nonmax_suppress(fast_score_map(img, threshold, arc=arc))
    flat = score.reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_corners)
    w = img.shape[1]
    rows = idx // w
    cols = idx % w
    uv = jnp.stack([cols, rows], axis=-1).astype(jnp.float32)
    return Corners(uv=uv, score=vals, valid=vals > 0)
