"""Batch-parallel RANSAC rigid-motion estimation (frame-to-frame VO).

Re-design of the reference's sequential RANSAC VO loops
(mex_files/RANSAC_CALCULATION/RANSAC_CALC_VER2.m:43-206 — 5-point
hypotheses, ≤2000 adaptive iterations; code_from_dr_ye/ransac_dr_ye.m:1-79 —
4-point hypotheses, ≤700 iterations, support threshold 0.001·dist(minZ pt)).

Accelerator shape (SURVEY §7.1): instead of an adaptive sequential loop, draw
ALL B hypotheses at once, solve B Kabsch fits with one batched 3×3 SVD
(vmap), score every hypothesis against every match as one [B, N] tensor op,
and argmax support — trading wasted hypotheses for total parallelism. A
final refit runs weighted Kabsch on the winning inlier set (masked weights,
no compaction), mirroring RANSAC_CALC_VER2.m:186's support-set refit.

Everything is static-shaped: N matches arrive as fixed-capacity masked
arrays straight from the matcher.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.ops.ransac_score import score_hypotheses
from pre3_tpu.vo.rigid import RigidFit, kabsch


class RansacResult(NamedTuple):
    r: jnp.ndarray  # [3, 3] rotation: frame2 → frame1
    t: jnp.ndarray  # [3] translation
    inliers: jnp.ndarray  # [N] bool — support of the refit solution
    n_inliers: jnp.ndarray  # [] int32
    ok: jnp.ndarray  # [] bool — valid solution (enough support, sane fit)
    rmse: jnp.ndarray  # [] float — refit inlier RMS residual
    best_support: jnp.ndarray  # [] int32 — winning hypothesis support


def _sample_hypotheses(key, n, batch, sample_size, valid):
    """[B, S] match indices, drawn ∝ validity. Gumbel-top-k per hypothesis
    gives samples without replacement — replaces ransac_dr_ye.m:29-48's
    rejection loops with a fixed-shape parallel draw."""
    logits = jnp.where(valid, 0.0, -jnp.inf)[None, :]  # [1, N]
    g = jax.random.gumbel(key, (batch, valid.shape[0]))
    scores = logits + g
    _, idx = jax.lax.top_k(scores, sample_size)
    return idx  # [B, S]


@partial(
    jax.jit,
    static_argnames=("batch", "sample_size", "range_weighted_refit"),
)
def ransac_rigid(
    key: jax.Array,
    p1: jnp.ndarray,  # [N, 3] frame-1 points
    p2: jnp.ndarray,  # [N, 3] frame-2 points (matched rows)
    valid: jnp.ndarray,  # [N] bool
    batch: int = 1024,
    sample_size: int = 4,
    support_threshold: jnp.ndarray | float | None = None,
    min_inliers: int = 6,
    range_weighted_refit: bool = False,
) -> RansacResult:
    """Estimate (R, t) with p1 ≈ R·p2 + t from masked matched 3D points.

    support_threshold: squared-distance inlier gate in m². Default mirrors
    the reference's scene-scaled gate (ransac_dr_ye.m:23,72):
    0.001·dist(nearest valid point in frame 2).

    range_weighted_refit: weight the final Kabsch refit by 1/‖p‖² —
    inverse variance under the SR4000's angular-dominated noise (lateral
    σ ∝ range), so distant inliers stop dominating the fit when the map
    is far away. Inlier GATING stays binary (reference semantics).
    """
    n = p1.shape[0]
    if support_threshold is None:
        d2 = jnp.sum(p2 * p2, axis=-1)
        d2 = jnp.where(valid, d2, jnp.inf)
        support_threshold = 0.001 * jnp.sqrt(jnp.min(d2))

    idx = _sample_hypotheses(key, n, batch, sample_size, valid)  # [B, S]
    hp1 = p1[idx]  # [B, S, 3]
    hp2 = p2[idx]
    fits = kabsch(hp1, hp2)  # batched over B

    # Score all hypotheses × all matches as one fused [B, N] reduction
    # (ops/ransac_score.py).
    support, err = score_hypotheses(
        fits.r, fits.t, p1, p2, valid, jnp.asarray(support_threshold)
    )
    # best = max support, ties broken by min error (RANSAC_CALC_VER2.m:
    # best = max support then min error) — encode as lexicographic score.
    score = support.astype(jnp.float32) - err / (err + 1.0)
    score = jnp.where(fits.ok, score, -1.0)
    best = jnp.argmax(score)

    # Recompute the winning hypothesis's inlier set (one [N] row — cheap)
    # and refit on it with masked weights.
    pred_b = p2 @ fits.r[best].T + fits.t[best]
    resid2_b = jnp.sum((pred_b - p1) ** 2, axis=-1)
    w = ((resid2_b < support_threshold) & valid).astype(p1.dtype)
    if range_weighted_refit:
        w = w / jnp.maximum(jnp.sum(p2 * p2, axis=-1), 0.25)
    refit = kabsch(p1, p2, w)
    pred = jnp.einsum("ij,nj->ni", refit.r, p2) + refit.t
    resid2 = jnp.sum((pred - p1) * (pred - p1), axis=-1)
    inl = (resid2 < support_threshold) & valid
    n_inl = jnp.sum(inl)
    ok = refit.ok & (n_inl >= min_inliers)
    return RansacResult(
        r=refit.r, t=refit.t, inliers=inl, n_inliers=n_inl, ok=ok,
        rmse=refit.rmse, best_support=support[best],
    )
