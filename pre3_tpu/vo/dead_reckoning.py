"""RANSAC dead-reckoning visual odometry over a sequence.

Re-design of the reference's VO-only driver (Test_RANSAC_dead_reckoning.m:
1-180: per frame, Calculate_V_Omega_RANSAC → chain H = H·Pose2H(...),
keeping the previous anchor on failure) and its per-pair engine
(vodometry_dr_ye.m / RANSAC_CALC_VER2.m).

Accelerator shape: all per-frame features are extracted up front (batched/jitted),
then a single `lax.scan` chains frame-to-frame RANSAC fits — the whole
sequence is ONE device program: no disk caches, no host round trips.
Failure handling matches the reference: if a pair has no valid solution,
the step contributes identity motion (Calculate_V_Omega_RANSAC_dr_ye.m:
41-45 substitutes zero motion on State_RANSAC != 1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.frontend.pipeline import Features
from pre3_tpu.geometry.quaternion import qprod, qnormalize, qrotate
from pre3_tpu.geometry.se3 import Pose
from pre3_tpu.geometry.quaternion import r2q
from pre3_tpu.ops.matching import match_descriptors
from pre3_tpu.vo.ransac import RansacResult, ransac_rigid


class VoStep(NamedTuple):
    delta: Pose  # camera k-1 ← camera k rigid motion (T_c{k-1}_ck)
    ok: jnp.ndarray  # [] bool
    n_inliers: jnp.ndarray  # [] int32
    n_matches: jnp.ndarray  # [] int32
    cov: jnp.ndarray  # [6, 6] covariance of [dt, dω] (zeros if not computed)


def vo_pair(
    f1: Features,
    f2: Features,
    key: jax.Array,
    batch: int = 1024,
    ratio: float = 1.3,
    min_inliers: int = 8,
    with_covariance: bool = False,
    range_weighted_refit: bool = False,
) -> VoStep:
    """Estimate the rigid motion between two feature sets.

    Returns T_c1_c2: p_c1 = R·p_c2 + t for a static scene — the pose of
    camera 2 expressed in camera 1 (what pose chaining composes with).
    With with_covariance=True, also the IFT covariance of the increment
    (vo/covariance.py) for use as EKF process noise.
    """
    m = match_descriptors(
        f1.desc, f2.desc, valid1=f1.valid, valid2=f2.valid, ratio=ratio
    )
    p1 = f1.xyz
    p2 = f2.xyz[m.index]
    valid = m.accepted & f1.valid & f2.valid[m.index]
    res = ransac_rigid(
        key, p1, p2, valid, batch=batch, min_inliers=min_inliers,
        range_weighted_refit=range_weighted_refit,
    )
    delta = Pose(t=res.t, q=r2q(res.r))
    if with_covariance:
        from pre3_tpu.vo.covariance import vo_covariance

        cov = vo_covariance(
            res.r, res.t, p1, p2, res.inliers.astype(p1.dtype)
        )
    else:
        cov = jnp.zeros((6, 6), p1.dtype)
    return VoStep(
        delta=delta, ok=res.ok, n_inliers=res.n_inliers,
        n_matches=jnp.sum(valid), cov=cov,
    )


class Trajectory(NamedTuple):
    t: jnp.ndarray  # [F, 3]
    q: jnp.ndarray  # [F, 4]
    ok: jnp.ndarray  # [F] bool (step validity; frame 0 is True)
    n_inliers: jnp.ndarray  # [F]


@partial(jax.jit, static_argnames=("batch", "ratio", "min_inliers"))
def run_sequence(
    feats: Features,  # stacked: every leaf has leading axis F
    key: jax.Array,
    batch: int = 1024,
    ratio: float = 1.3,
    min_inliers: int = 8,
) -> Trajectory:
    """Chain VO over a stacked feature sequence with one lax.scan.

    Failure semantics mirror Test_RANSAC_dead_reckoning.m:36-41: an invalid
    pair keeps the previous pose (identity motion step).
    """
    n_frames = feats.uv.shape[0]
    keys = jax.random.split(key, n_frames - 1)

    def step(carry, inp):
        t_w, q_w, prev = carry
        k, cur = inp
        s = vo_pair(prev, cur, k, batch=batch, ratio=ratio,
                    min_inliers=min_inliers)
        dt = jnp.where(s.ok, s.delta.t, jnp.zeros(3))
        dq = jnp.where(s.ok, s.delta.q, jnp.array([1.0, 0, 0, 0]))
        t_new = t_w + qrotate(q_w, dt)
        q_new = qnormalize(qprod(q_w, dq))
        return (t_new, q_new, cur), (t_new, q_new, s.ok, s.n_inliers)

    first = jax.tree.map(lambda x: x[0], feats)
    rest = jax.tree.map(lambda x: x[1:], feats)
    t0 = jnp.zeros(3)
    q0 = jnp.array([1.0, 0, 0, 0])
    (_, _, _), (ts, qs, oks, nis) = jax.lax.scan(
        step, (t0, q0, first), (keys, rest)
    )
    return Trajectory(
        t=jnp.concatenate([t0[None], ts], axis=0),
        q=jnp.concatenate([q0[None], qs], axis=0),
        ok=jnp.concatenate([jnp.ones(1, bool), oks]),
        n_inliers=jnp.concatenate([jnp.zeros(1, jnp.int32), nis]),
    )
