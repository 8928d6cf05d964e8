"""Unrolled batched Cholesky solve for tiny SPD systems.

The 1-point/3-point RANSAC hypothesis loop solves B≈256 independent
6×6 (or 2×2) SPD systems S·y = ν per SLAM step. jax.scipy's cho_factor
lowers to a solver-library custom call; for a FIXED tiny n the
factorization instead unrolls into ~n²/2 scalar recurrences that
vectorize over the batch as pure elementwise ops and fuse into the
surrounding kernel. Which is faster on an H100 is not measured
(ROADMAP Design 3).

Used by ekf/one_point_ransac.py (ransac_hypotheses.m:50-63's per-
hypothesis partial-update solve, batched).
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_solve_unrolled(s: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve S·y = b for batched SPD S.

    s: [..., n, n] SPD (n static and small — intended n ≤ 8)
    b: [..., n]
    returns y: [..., n]

    Unrolled Cholesky S = L·Lᵀ, then forward/back substitution, all as
    elementwise ops over the batch dims. Matches cho_factor/cho_solve to
    fp roundoff for well-conditioned S (the RANSAC S has a +σ²I ridge).
    """
    n = s.shape[-1]
    # l[i][j] for j <= i: batch-shaped scalars
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        d = s[..., j, j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        ljj = jnp.sqrt(jnp.maximum(d, 1e-30))
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, n):
            v = s[..., i, j]
            for k in range(j):
                v = v - l[i][k] * l[j][k]
            l[i][j] = v * inv
    # forward: L z = b
    z = [None] * n
    for i in range(n):
        v = b[..., i]
        for k in range(i):
            v = v - l[i][k] * z[k]
        z[i] = v / l[i][i]
    # back: Lᵀ y = z
    y = [None] * n
    for i in reversed(range(n)):
        v = z[i]
        for k in range(i + 1, n):
            v = v - l[k][i] * y[k]
        y[i] = v / l[i][i]
    return jnp.stack(y, axis=-1)
