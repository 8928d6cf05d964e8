"""Batched RANSAC hypothesis support scoring.

The [B, N] scoring step of batch-parallel RANSAC (vo/ransac.py — the
replacement for the reference's sequential support loops,
ransac_dr_ye.m:59-71 / RANSAC_CALC_VER2.m:121-125): for every hypothesis
(R_b, t_b) and every matched point pair, compute ‖R_b·p2 + t_b − p1‖² and
reduce to per-hypothesis support counts and inlier errors.

The 3-term rotation contraction is written as a broadcast multiply-add
rather than an einsum: XLA then fuses prediction, residual, threshold and
both reductions into one loop fusion, with no matrix-library call and no
[B, N, 3] prediction in device memory. A hand-written Pallas (Triton)
kernel of the same computation did not beat this fusion on an H100
(PERF.md, Findings).
"""

from __future__ import annotations

import jax.numpy as jnp


def score_hypotheses(
    r: jnp.ndarray,  # [B, 3, 3]
    t: jnp.ndarray,  # [B, 3]
    p1: jnp.ndarray,  # [N, 3]
    p2: jnp.ndarray,  # [N, 3]
    valid: jnp.ndarray,  # [N]
    threshold: jnp.ndarray,  # [] squared-distance gate
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(support [B] int32, mean inlier squared error [B] float32)."""
    # pred[b, n, i] = Σ_j r[b, i, j]·p2[n, j] + t[b, i]
    pred = t[:, None, :]
    for j in range(3):
        pred = pred + r[:, None, :, j] * p2[None, :, j, None]
    resid2 = jnp.sum((pred - p1[None]) ** 2, axis=-1)
    inlier = (resid2 < threshold) & valid[None]
    support = jnp.sum(inlier, axis=-1).astype(jnp.int32)
    err = jnp.sum(jnp.where(inlier, resid2, 0.0), axis=-1) / jnp.maximum(
        support, 1
    )
    return support, err
