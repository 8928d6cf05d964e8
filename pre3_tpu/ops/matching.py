"""Descriptor matching: distance matrix + Lowe ratio test.

Replaces the reference's brute-force C matcher (sift/siftmatch.c:93-126:
NN loop over descriptor pairs with ratio acceptance `d_best*thresh < d_2nd`
on *squared* L2 distances, default thresh 1.5) with a matmul-shaped design:
the [N1, N2] squared-distance matrix is a single matrix product
(|a|² + |b|² − 2a·b), and best/second-best reduction + ratio test fuse
behind it. Returns, per row of d1: the best-match column index, the two
smallest squared distances, and the accept mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

BIG = 1e30


class Matches(NamedTuple):
    index: jnp.ndarray  # [N1] int32 — best column in d2 per row of d1
    dist2: jnp.ndarray  # [N1] float32 — best squared distance
    dist2_second: jnp.ndarray  # [N1] float32 — runner-up squared distance
    accepted: jnp.ndarray  # [N1] bool — ratio test + validity


def _pairwise_dist2(d1: jnp.ndarray, d2: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 distances [N1, N2] via the matmul identity."""
    n1 = jnp.sum(d1 * d1, axis=-1, keepdims=True)
    n2 = jnp.sum(d2 * d2, axis=-1, keepdims=True).T
    # Throughput kernel: ratio-test distances tolerate reduced-precision
    # products, so opt out of the engine-wide "highest" matmul default
    # (pre3_tpu/__init__.py); on an NVIDIA GPU DEFAULT means TF32.
    g = jnp.dot(d1, d2.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT)
    return jnp.maximum(n1 + n2 - 2.0 * g, 0.0)


def _best_two(dist2: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-row (best_idx, best, second) without a full sort."""
    best = jnp.min(dist2, axis=-1)
    idx = jnp.argmin(dist2, axis=-1)
    masked = dist2.at[jnp.arange(dist2.shape[0]), idx].set(BIG)
    second = jnp.min(masked, axis=-1)
    return idx.astype(jnp.int32), best, second


def match_descriptors(
    d1: jnp.ndarray,
    d2: jnp.ndarray,
    valid1: jnp.ndarray | None = None,
    valid2: jnp.ndarray | None = None,
    ratio: float = 1.5,
    mutual: bool = False,
    pair_mask: jnp.ndarray | None = None,
) -> Matches:
    """Brute-force matcher. `ratio` follows siftmatch.c semantics: accept when
    best_dist2 * ratio < second_dist2 (ratio > 1).

    pair_mask [N1, N2]: optional per-pair candidate restriction (e.g. the
    EKF search ellipse) applied BEFORE the best/second reduction — the
    ratio test then runs among the admissible candidates only."""
    dist2 = _pairwise_dist2(d1, d2)
    if valid2 is not None:
        dist2 = jnp.where(valid2[None, :], dist2, BIG)
    if pair_mask is not None:
        dist2 = jnp.where(pair_mask, dist2, BIG)
    idx, best, second = _best_two(dist2)
    accepted = best * ratio < second
    accepted &= best < BIG
    if valid1 is not None:
        accepted &= valid1
    if mutual:
        # column-wise best must point back at this row
        back = jnp.argmin(
            jnp.where(
                (valid1[:, None] if valid1 is not None else True), dist2, BIG
            ),
            axis=0,
        )
        accepted &= back[idx] == jnp.arange(d1.shape[0])
    return Matches(index=idx, dist2=best, dist2_second=second, accepted=accepted)
