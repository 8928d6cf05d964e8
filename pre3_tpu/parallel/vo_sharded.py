"""Hypothesis-parallel RANSAC VO over a device mesh.

The reference's RANSAC loops are sequential (RANSAC_CALC_VER2.m:86-162);
pre3_tpu already batches them (vo/ransac.py); this module spreads the
hypothesis batch across a Mesh axis ("hyp"). Each device solves and scores
its hypothesis shard; the winner is selected by a global reduction (XLA
inserts the all-reduce between devices from the sharding annotations — no
hand-written collectives needed at this level).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pre3_tpu.ops.ransac_score import score_hypotheses
from pre3_tpu.vo.ransac import RansacResult, _sample_hypotheses
from pre3_tpu.vo.rigid import kabsch


def sharded_ransac_rigid(
    mesh: Mesh,
    key: jax.Array,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    valid: jnp.ndarray,
    batch: int = 2048,
    sample_size: int = 4,
    support_threshold: float = 1e-3,
    min_inliers: int = 6,
) -> RansacResult:
    """ransac_rigid with the hypothesis batch sharded over mesh axis 'hyp'.

    Identical math to vo/ransac.py:ransac_rigid; the only difference is the
    with_sharding_constraint on the [B, ...] hypothesis tensors, which makes
    XLA partition the Kabsch solves and the [B, N] scoring
    (ops/ransac_score.py) across devices and all-reduce the argmax.
    """
    n = p1.shape[0]
    hyp_sharding = NamedSharding(mesh, P("hyp"))

    idx = _sample_hypotheses(key, n, batch, sample_size, valid)
    idx = jax.lax.with_sharding_constraint(idx, hyp_sharding)
    hp1 = p1[idx]
    hp2 = p2[idx]
    fits = kabsch(hp1, hp2)

    thr = jnp.asarray(support_threshold)
    support, err = score_hypotheses(fits.r, fits.t, p1, p2, valid, thr)
    support = jax.lax.with_sharding_constraint(support, hyp_sharding)
    score = support.astype(jnp.float32) - err / (err + 1.0)
    score = jnp.where(fits.ok, score, -1.0)
    best = jnp.argmax(score)  # global argmax → cross-device reduction

    pred_b = p2 @ fits.r[best].T + fits.t[best]
    resid2_b = jnp.sum((pred_b - p1) ** 2, axis=-1)
    w = ((resid2_b < thr) & valid).astype(p1.dtype)
    refit = kabsch(p1, p2, w)
    pred = jnp.einsum("ij,nj->ni", refit.r, p2) + refit.t
    resid2 = jnp.sum((pred - p1) ** 2, axis=-1)
    inl = (resid2 < thr) & valid
    n_inl = jnp.sum(inl)
    ok = refit.ok & (n_inl >= min_inliers)
    return RansacResult(
        r=refit.r, t=refit.t, inliers=inl, n_inliers=n_inl, ok=ok,
        rmse=refit.rmse, best_support=support[best],
    )
