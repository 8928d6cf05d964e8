"""Distributed bundle adjustment: landmark blocks sharded over a device
mesh (BASELINE config #5).

The map is partitioned by landmarks across the mesh axis "lm" (the
keyframe-block sharding of SURVEY §2.4): every device linearizes and
eliminates ITS landmark shard locally (batched 3×3 inverses), the reduced
camera system — small, [6F, 6F] — is summed across devices with one psum
over the device links, solved redundantly on every device (cheaper than scattering a
tiny solve), and landmark updates back-substitute locally with zero
further communication. Per GN iteration the only collective traffic is
the psum of S [6F·6F] and rhs [6F].

Implemented with jax.shard_map over the normal-equation build + Schur
elimination; the outer GN loop stays in the (sharded) jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pre3_tpu.backend.ba import (
    BaProblem, BaResult, _build_normal_eqs, _cost_sums, _odo_cost_sums,
    _odo_terms, _pair_cost_sums, _pair_terms,
)
from pre3_tpu.parallel.distributed import globalize_replicated
from pre3_tpu.geometry.camera import Camera
from pre3_tpu.geometry.quaternion import qnormalize, qprod, v2q


def _pad_landmarks(problem: BaProblem, n_devices: int) -> tuple[BaProblem, int]:
    """Pad the landmark axis to a multiple of the mesh size."""
    f, l = problem.mask.shape
    lp = (l + n_devices - 1) // n_devices * n_devices
    if lp == l:
        return problem, l
    padl = lp - l

    def pad(x, axis):
        if x is None:
            return None
        width = [(0, 0)] * x.ndim
        width[axis] = (0, padl)
        return jnp.pad(x, width)

    return (
        problem._replace(
            obs_uv=pad(problem.obs_uv, 1),
            mask=pad(problem.mask, 1),
            points=pad(problem.points, 0),
            obs_xyz=pad(problem.obs_xyz, 1),
            mask_xyz=pad(problem.mask_xyz, 1),
            lc_lm=pad(problem.lc_lm, 0),
        ),
        l,
    )


def bundle_adjust_sharded(
    mesh: Mesh,
    cam: Camera,
    problem: BaProblem,
    iters: int = 10,
    damping: float = 1e-3,
    depth_weight: float = 50.0,
    odo_weight_t: float = 20.0,
    odo_weight_r: float = 50.0,
    depth_range_ref: float = 0.0,
    lcp_weight_t: float = 20.0,
    lcp_weight_r: float = 50.0,
    axis: str = "lm",
) -> BaResult:
    """Landmark-sharded BA. Numerically identical to backend.ba.
    bundle_adjust (same math, the psum just reorders the reduction),
    INCLUDING the keyframe odometry-chain factors (problem.odo_t/odo_q/
    odo_w): they couple only camera poses and are replicated, so their
    Gauss-Newton terms add to the psum'd reduced system once per device
    (post-psum, not summed across the mesh) and their residuals enter
    the LM accept/reject cost — without them the distributed path would
    re-estimate poses from landmark factors alone and regress on
    loop-free sequences exactly as the round-2 record measured."""
    n_dev = mesh.shape[axis]
    problem, l_orig = _pad_landmarks(problem, n_dev)
    f, l = problem.mask.shape
    has_odo = problem.odo_t is not None
    odo_w = (
        problem.odo_w if problem.odo_w is not None
        else jnp.ones(f - 1, problem.kf_t.dtype)
    ) if has_odo else None
    n_lcp = (
        int(problem.lcp_i.shape[0]) if problem.lcp_i is not None else 0
    )

    obs_xyz = (
        problem.obs_xyz
        if problem.obs_xyz is not None
        else jnp.zeros((f, l, 3), problem.obs_uv.dtype)
    )
    mask_xyz = (
        problem.mask_xyz if problem.mask_xyz is not None else problem.mask
    )
    from pre3_tpu.backend.ba import _depth_weights

    w_xyz_fl = _depth_weights(
        problem.mask & mask_xyz, obs_xyz, depth_weight,
        depth_range_ref, problem.obs_uv.dtype,
    )

    run = _make_run(mesh, cam, iters, damping, odo_weight_t,
                    odo_weight_r, axis, n_dev, f, has_odo, l_orig,
                    n_lcp, lcp_weight_t, lcp_weight_r)

    # dummy (zero-weight) odo tensors keep the jit signature static when
    # the problem has no odometry chain
    if has_odo:
        odo_t_in, odo_q_in, odo_w_in = problem.odo_t, problem.odo_q, odo_w
    else:
        odo_t_in = jnp.zeros((f - 1, 3), problem.kf_t.dtype)
        odo_q_in = jnp.tile(
            jnp.array([1.0, 0, 0, 0], problem.kf_t.dtype), (f - 1, 1)
        )
        odo_w_in = jnp.zeros(f - 1, problem.kf_t.dtype)
    lc_in = (
        problem.lc_lm if problem.lc_lm is not None
        else jnp.zeros(l, bool)
    )
    # lcp factors always flow as a 6-tensor group with a [G, 6, 6]
    # square-root information per factor (diag of the scalar weights
    # when the problem carries none) — one static jit signature
    if n_lcp > 0:
        info = (
            problem.lcp_info if problem.lcp_info is not None
            else jnp.tile(
                jnp.diag(jnp.asarray(
                    [lcp_weight_t] * 3 + [lcp_weight_r] * 3,
                    problem.kf_t.dtype,
                ))[None], (n_lcp, 1, 1),
            )
        )
        lcp_in = (
            problem.lcp_i, problem.lcp_j, problem.lcp_t, problem.lcp_q,
            problem.lcp_w if problem.lcp_w is not None
            else jnp.ones(n_lcp, problem.kf_t.dtype),
            info,
        )
    else:  # static-shape dummies (G=1, weight 0 → exact no-op factor)
        lcp_in = (
            jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
            jnp.zeros((1, 3), problem.kf_t.dtype),
            jnp.tile(jnp.array([1.0, 0, 0, 0], problem.kf_t.dtype),
                     (1, 1)),
            jnp.zeros(1, problem.kf_t.dtype),
            jnp.tile(jnp.eye(6, dtype=problem.kf_t.dtype)[None],
                     (1, 1, 1)),
        )

    g = partial(globalize_replicated, mesh)
    with jax.set_mesh(mesh):
        kf_t, kf_q, points, costs = run(
            g(problem.kf_t), g(problem.kf_q), g(problem.points),
            g(problem.obs_uv), g(problem.mask), g(obs_xyz), g(w_xyz_fl),
            g(odo_t_in), g(odo_q_in), g(odo_w_in), g(lc_in),
            *(g(x) for x in lcp_in),
        )
    return BaResult(kf_t=kf_t, kf_q=kf_q, points=points, cost=costs)


_RUN_CACHE: dict = {}


def _make_run(mesh, cam, iters, damping, odo_weight_t, odo_weight_r,
              axis, n_dev, f, has_odo, l_orig, n_lcp=0,
              lcp_weight_t=20.0, lcp_weight_r=50.0):
    """Build (once per configuration/shape) the jitted sharded GN loop.
    The cache is load-bearing: a fresh shard_map + jit closure per call
    would recompile the whole distributed program on every invocation
    (measured: a 10-iteration F=64/L=512 solve spent ~10 s/call in CPU
    recompiles before this cache — the 2-rank 'inefficiency' in the first
    tools/measure_2rank.py run was compile time, not communication).
    Keyed manually: Camera carries numpy 0-d arrays (unhashable)."""
    key = (
        mesh, tuple(float(v) for v in (cam.f, cam.cx, cam.cy, cam.k1,
                                       cam.k2)),
        cam.n_rows, cam.n_cols, iters, float(damping),
        float(odo_weight_t), float(odo_weight_r), axis, n_dev, f,
        has_odo, l_orig, n_lcp, float(lcp_weight_t),
        float(lcp_weight_r),
    )
    if key in _RUN_CACHE:
        return _RUN_CACHE[key]
    lm_spec = P(None, axis)  # [F, L*] tensors
    pt_spec = P(axis)  # [L*, ...] tensors
    rep = P()

    def local_step(kf_t, kf_q, points_l, obs_uv_l, mask_l, obs_xyz_l,
                   w_xyz_l, lam, odo_t, odo_q, odo_wv, lc_l,
                   lcp_i, lcp_j, lcp_t, lcp_q, lcp_w, lcp_info):
        """Runs per device on its landmark shard. odo_*/lcp_* are
        replicated (camera-camera factors, added once post-psum); lc_l
        is the local shard's loop-closure mask (un-Huberized factors)."""
        hcc, hpp, wcp, bc, bp = _build_normal_eqs(
            cam, kf_t, kf_q, points_l, obs_uv_l, mask_l, obs_xyz_l,
            w_xyz_l, lam, huber_delta=jnp.where(lc_l[None, :], 1e6, 3.0),
        )
        # local Schur contribution
        hpp_inv = jnp.linalg.inv(hpp)
        whw = jnp.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
        rhs_local = bc - jnp.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)
        # psum over the landmark mesh axis → every device holds the full
        # reduced system. NOTE: hcc (damping included) is summed too, so
        # divide the per-device copy... hcc depends only on local shard's
        # factors; damping must be added once → subtract extras.
        s_local = -whw
        s_local = s_local.at[jnp.arange(f), :, jnp.arange(f), :].add(hcc)
        s_full = jax.lax.psum(s_local, axis)
        rhs_full = jax.lax.psum(rhs_local, axis)
        # damping was added on every device: correct to a single copy
        extra = (n_dev - 1) * lam
        diag_idx = jnp.arange(f)
        s_full = s_full.at[diag_idx, :, diag_idx, :].add(
            -extra * jnp.eye(6)[None]
        )
        # odometry-chain camera-camera factors: every device holds the
        # full reduced system after the psum, so the replicated odo terms
        # are added exactly once per copy (NOT psum'd — that would scale
        # them by n_dev)
        if has_odo:
            s_add, rhs_add, _, _ = _odo_terms(
                kf_t, kf_q, odo_t, odo_q, odo_weight_t, odo_weight_r,
                odo_wv,
            )
            s_full = s_full + s_add
            rhs_full = rhs_full + rhs_add
        # loop-closure pose factors (replicated, zero-weight dummies
        # when the problem has none — exact no-ops)
        s_lc, rhs_lc, _, _ = _pair_terms(
            kf_t, kf_q, lcp_i, lcp_j, lcp_t, lcp_q,
            1.0, 1.0, lcp_w, lcp_info,
        )
        s_full = s_full + s_lc
        rhs_full = rhs_full + rhs_lc
        # gauge: freeze keyframe 0
        keep = jnp.ones((f,)).at[0].set(0.0)
        s_full = (
            s_full * keep[:, None, None, None] * keep[None, None, :, None]
        )
        s_full = s_full.at[0, :, 0, :].set(jnp.eye(6))
        rhs_full = rhs_full * keep[:, None]

        sd = s_full.reshape(f * 6, f * 6)
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(sd), 1e-12))
        sn = sd / d[:, None] / d[None, :]
        y = jnp.linalg.solve(sn, rhs_full.reshape(-1) / d)
        dc = (y / d).reshape(f, 6)
        # local back-substitution
        dp_l = jnp.einsum(
            "lab,lb->la", hpp_inv,
            bp - jnp.einsum("flab,fa->lb", wcp, dc),
        )
        return dc, dp_l

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(rep, rep, pt_spec, lm_spec, lm_spec, lm_spec, lm_spec,
                  rep, rep, rep, rep, pt_spec,
                  rep, rep, rep, rep, rep, rep),
        out_specs=(rep, pt_spec),
    )

    def cost_local(kf_t, kf_q, points_l, obs_uv_l, mask_l, obs_xyz_l,
                   w_xyz_l, lc_l):
        """Landmark-factor cost sums on the local shard, psum'd — the
        cost evaluation is separable along L, so evaluating it replicated
        would waste (n_dev−1)/n_dev of the FLOPs per LM accept/reject
        (measured 65% → the dominant 2-rank inefficiency)."""
        tot, n = _cost_sums(
            cam, kf_t, kf_q, points_l, obs_uv_l, mask_l, obs_xyz_l,
            w_xyz_l, huber_delta=jnp.where(lc_l[None, :], 1e6, 3.0),
        )
        return jax.lax.psum(tot, axis), jax.lax.psum(n, axis)

    sharded_cost = jax.shard_map(
        cost_local,
        mesh=mesh,
        in_specs=(rep, rep, pt_spec, lm_spec, lm_spec, lm_spec, lm_spec,
                  pt_spec),
        out_specs=(rep, rep),
    )

    # All tensors enter `run` as explicit (replicated global) arguments —
    # device-array closures would become process-local hoisted constants,
    # which cannot feed a computation spanning a multi-process mesh. The
    # shard_map in_specs distribute the landmark axis from the replicated
    # copies (a local slice, no communication).
    @jax.jit
    def run(kf_t, kf_q, points, obs_uv, mask, obs_xyz, w_xyz_fl,
            odo_t, odo_q, odo_wv, lc,
            lcp_i, lcp_j, lcp_t, lcp_q, lcp_w, lcp_info):
        odo = (
            (odo_t, odo_q, odo_weight_t, odo_weight_r, odo_wv)
            if has_odo else None
        )
        lcp = (lcp_i, lcp_j, lcp_t, lcp_q, 1.0, 1.0, lcp_w, lcp_info)

        def cost(kf_t, kf_q, points):
            tot, n = sharded_cost(kf_t, kf_q, points, obs_uv, mask,
                                  obs_xyz, w_xyz_fl, lc)
            if odo is not None:
                ot, on = _odo_cost_sums(kf_t, kf_q, odo)
                tot, n = tot + ot, n + on
            pt, pn = _pair_cost_sums(kf_t, kf_q, lcp)
            tot, n = tot + pt, n + pn
            return tot / jnp.maximum(n, 1)

        def gn_step(carry, _):
            kf_t, kf_q, points, lam = carry
            c0 = cost(kf_t, kf_q, points)
            dc, dp = sharded(
                kf_t, kf_q, points, obs_uv, mask, obs_xyz, w_xyz_fl, lam,
                odo_t, odo_q, odo_wv, lc,
                lcp_i, lcp_j, lcp_t, lcp_q, lcp_w, lcp_info,
            )
            t2 = kf_t + dc[:, :3]
            q2 = qnormalize(qprod(kf_q, v2q(dc[:, 3:])))
            p2 = points + dp
            c1 = cost(t2, q2, p2)
            better = c1 < c0
            # LM damping schedule — identical to backend.ba.bundle_adjust
            lam = jnp.where(
                better,
                jnp.maximum(lam * 0.5, 1e-8),
                jnp.minimum(lam * 10.0, 1e6),
            )
            return (
                jnp.where(better, t2, kf_t),
                jnp.where(better, q2, kf_q),
                jnp.where(better, p2, points),
                lam,
            ), jnp.where(better, c1, c0)

        cost0 = cost(kf_t, kf_q, points)
        lam0 = jnp.asarray(damping, kf_t.dtype)
        (t, q, p, _lam), costs = jax.lax.scan(
            gn_step, (kf_t, kf_q, points, lam0), None, length=iters
        )
        # gather the landmark shards so every process can read the result
        p = jax.lax.with_sharding_constraint(p, NamedSharding(mesh, P()))
        return t, q, p[:l_orig], jnp.concatenate([cost0[None], costs])

    _RUN_CACHE[key] = run
    return run
