"""Landmark track building across keyframes → BA factor graph.

The reference has no multi-view track structure (its map lives inside the
EKF state; BA is the BASELINE north-star replacement). This module builds
one: a fixed-capacity track table matched keyframe-to-keyframe with the
same descriptor matcher as the frontend, producing the masked [M, L]
observation tensors backend/ba.py consumes.

Static-shaped scan over keyframes: per keyframe, (1) match features to
track descriptors, (2) record observations, (3) spawn new tracks from
unmatched features into free slots.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.backend.ba import BaProblem
from pre3_tpu.frontend.pipeline import Features
from pre3_tpu.geometry.quaternion import qrotate
from pre3_tpu.ops.matching import match_descriptors


class TrackTable(NamedTuple):
    desc: jnp.ndarray  # [L, D]
    active: jnp.ndarray  # [L] bool
    point_w: jnp.ndarray  # [L, 3] world-frame init (first observation)


@partial(jax.jit, static_argnames=("max_tracks", "adds_per_frame"))  # gate_px traced
def build_tracks(
    kf_feats: Features,  # stacked over M keyframes
    kf_t: jnp.ndarray,  # [M, 3] initial keyframe poses (world)
    kf_q: jnp.ndarray,  # [M, 4]
    kf_valid: jnp.ndarray,  # [M] bool
    max_tracks: int = 256,
    adds_per_frame: int = 64,
    ratio: float = 1.3,
    gate_px: float = 25.0,
):
    """Returns (obs_uv [M,L,2], obs_xyz [M,L,3], mask [M,L], table)."""
    m = kf_feats.uv.shape[0]
    l = max_tracks
    dd = kf_feats.desc.shape[-1]

    table = TrackTable(
        desc=jnp.zeros((l, dd)),
        active=jnp.zeros((l,), bool),
        point_w=jnp.zeros((l, 3)),
    )

    def per_kf(table, inp):
        feats, t_wc, q_wc, kfv = inp
        mt = match_descriptors(
            table.desc, feats.desc, valid1=table.active,
            valid2=feats.valid, ratio=ratio,
        )
        matched = mt.accepted & kfv
        obs_uv = feats.uv[mt.index]
        obs_xyz = feats.xyz[mt.index]
        has_depth = jnp.linalg.norm(obs_xyz, axis=-1) > 0.2
        # geometric gate: the track's world point reprojected through the
        # (initial) keyframe pose must land near the matched pixel — the
        # same search-region idea as search_IC_matches.m, protecting BA
        # from wrong long-baseline descriptor matches
        from pre3_tpu.geometry.camera import project, sr4000_camera
        from pre3_tpu.geometry.quaternion import qconj

        p_cam = qrotate(qconj(q_wc), table.point_w - t_wc)
        pred = project(sr4000_camera(), p_cam)
        close = (
            jnp.linalg.norm(pred - obs_uv, axis=-1) < gate_px
        ) & (p_cam[..., 2] > 0.2)
        matched = matched & close
        rec = matched & has_depth
        # refresh descriptor on match
        desc = jnp.where(matched[:, None], feats.desc[mt.index], table.desc)

        # spawn new tracks from unmatched frame features
        used = jnp.zeros((feats.uv.shape[0],), bool).at[mt.index].set(
            matched, mode="drop"
        )
        cand = feats.valid & ~used & (
            jnp.linalg.norm(feats.xyz, axis=-1) > 0.2
        ) & kfv
        score = jnp.where(cand, feats.score, -1.0)
        top_score, top_idx = jax.lax.top_k(score, adds_per_frame)
        slot_order = jnp.argsort(table.active.astype(jnp.int32), stable=True)
        free_slots = slot_order[:adds_per_frame]
        can_add = (top_score > 0) & ~table.active[free_slots]

        p_w = t_wc + qrotate(q_wc, feats.xyz[top_idx])  # [A, 3]
        desc = desc.at[free_slots].set(
            jnp.where(can_add[:, None], feats.desc[top_idx],
                      desc[free_slots])
        )
        point_w = table.point_w.at[free_slots].set(
            jnp.where(can_add[:, None], p_w, table.point_w[free_slots])
        )
        active = table.active.at[free_slots].set(
            table.active[free_slots] | can_add
        )
        # first observation of a spawned track is recorded too
        obs_uv = obs_uv.at[free_slots].set(
            jnp.where(can_add[:, None], feats.uv[top_idx],
                      obs_uv[free_slots])
        )
        obs_xyz = obs_xyz.at[free_slots].set(
            jnp.where(can_add[:, None], feats.xyz[top_idx],
                      obs_xyz[free_slots])
        )
        rec = rec.at[free_slots].set(rec[free_slots] | can_add)

        new_table = TrackTable(desc=desc, active=active, point_w=point_w)
        return new_table, (obs_uv, obs_xyz, rec)

    table, (obs_uv, obs_xyz, mask) = jax.lax.scan(
        per_kf, table, (kf_feats, kf_t, kf_q, kf_valid)
    )
    return obs_uv, obs_xyz, mask, table


def make_ba_problem_from_tracks(
    kf_feats: Features,
    kf_t: jnp.ndarray,
    kf_q: jnp.ndarray,
    kf_valid: jnp.ndarray,
    max_tracks: int = 256,
    min_obs: int = 2,
) -> BaProblem:
    """Full config-#4 assembly: tracks → masked BA problem. Tracks seen in
    fewer than min_obs keyframes are dropped (unconstrained in BA)."""
    obs_uv, obs_xyz, mask, table = build_tracks(
        kf_feats, kf_t, kf_q, kf_valid, max_tracks=max_tracks
    )
    seen = jnp.sum(mask, axis=0) >= min_obs
    mask = mask & seen[None]
    return BaProblem(
        obs_uv=obs_uv, mask=mask, kf_t=kf_t, kf_q=kf_q,
        points=table.point_w, obs_xyz=obs_xyz, mask_xyz=mask,
    )
