"""Bundle adjustment: Gauss-Newton with Schur-complement landmark
elimination.

This is the backend the BASELINE north star specifies in place of the
reference's monolithic dense EKF (predict_state_and_covariance.m:131 /
update.m:32-38 are O(N²)–O(N³) in map size): a keyframe/landmark factor
graph where each factor is the reprojection of landmark l in keyframe f.

Structure exploited (the classic BA sparsity):
  H = [[Hcc, W], [Wᵀ, Hpp]] with Hcc block-diag over keyframes [F, 6, 6],
  Hpp block-diag over landmarks [L, 3, 3], W the coupling [F, 6, L, 3].
  Landmarks are eliminated in closed form (batched 3×3 inverses), the
  reduced camera system S = Hcc − W Hpp⁻¹ Wᵀ (size 6F, dense — F is tens)
  is solved on one device, and landmarks back-substitute independently.

Everything is masked/static-shaped: obs [F, L, 2] + mask [F, L]. The
landmark dimension is the parallel axis — the distributed version shards
L across devices and psums the reduced system (parallel/ba_sharded.py).

Parameterization: keyframe pose = (t[3], rotation-vector increment on a
reference quaternion); updates compose on the manifold each iteration.
Gauge freedom is fixed by freezing keyframe 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.geometry.camera import Camera, distort, project_point
from pre3_tpu.geometry.quaternion import qconj, qnormalize, qprod, qrotate, v2q


class BaProblem(NamedTuple):
    obs_uv: jnp.ndarray  # [F, L, 2] observed pixels
    mask: jnp.ndarray  # [F, L] bool
    kf_t: jnp.ndarray  # [F, 3] initial keyframe positions (world)
    kf_q: jnp.ndarray  # [F, 4] initial keyframe orientations (cam→world)
    points: jnp.ndarray  # [L, 3] initial landmark positions (world)
    # Optional RGB-D depth factors: camera-frame 3D observation of the
    # landmark (SR4000 per-pixel xyz). These pin the scale gauge that
    # reprojection-only BA leaves free, exactly as the reference's depth
    # priors do for the EKF (initialize_a_feature_sift_3.m:116).
    obs_xyz: jnp.ndarray | None = None  # [F, L, 3]
    mask_xyz: jnp.ndarray | None = None  # [F, L]
    # Optional odometry factors between CONSECUTIVE keyframes: the
    # relative pose measured by the front filter / VO chain. Without
    # them, BA re-estimates poses from raw landmark factors alone and
    # throws away the motion prior the filter accumulated — on
    # loop-closure-free sequences that reliably makes the global
    # trajectory WORSE even as the landmark cost drops (measured:
    # the round-2 record). With them this is a proper fixed-lag
    # smoother: pose-graph chain + landmark factors.
    odo_t: jnp.ndarray | None = None  # [F-1, 3] R_iᵀ(t_{i+1}−t_i)
    odo_q: jnp.ndarray | None = None  # [F-1, 4] q_i⁻¹ ⊗ q_{i+1}
    odo_w: jnp.ndarray | None = None  # [F-1] per-pair weight (0 disables a
    # factor — e.g. pairs touching padded/invalid keyframe slots)
    # Loop-closure landmarks: re-acquired by the filter after a long
    # invisibility gap (the implicit EKF loop closure, vetted by the χ²
    # rescue machinery rescue_hi_inliers.m:27-47). Their factors are NOT
    # Huber-down-weighted: a genuine long-baseline constraint looks
    # exactly like the outlier the robust loss exists to suppress, and
    # without full quadratic weight BA can smooth but not remove the
    # accumulated revisit drift (the round-3 record: BA/SLAM plateau ~0.6-0.8
    # without revisit constraints).
    lc_lm: jnp.ndarray | None = None  # [L] bool
    # Keyframe-to-keyframe loop-closure POSE factors (VERDICT r4 #3): a
    # relative SE(3) measurement between two non-adjacent keyframes,
    # mined from a filter re-acquisition by Kabsch on the co-measured
    # landmark set (ekf_ba.py::ba_problem_from_slam). These inject the
    # revisit constraint directly into the pose graph — stronger than
    # un-Huberizing the 1-2 re-acquired landmark factors (measured
    # neutral, the round-4 record), because the Kabsch estimate fuses EVERY
    # co-measured landmark into one rigid constraint. Same residual
    # convention as the odometry chain: lcp_t = R_iᵀ(t_j − t_i),
    # lcp_q = q_i⁻¹ ⊗ q_j. lcp_w = 0 disables a slot (padding).
    lcp_i: jnp.ndarray | None = None  # [G] int32 keyframe index i
    lcp_j: jnp.ndarray | None = None  # [G] int32 keyframe index j
    lcp_t: jnp.ndarray | None = None  # [G, 3]
    lcp_q: jnp.ndarray | None = None  # [G, 4]
    lcp_w: jnp.ndarray | None = None  # [G]
    # Optional per-factor square-root information [G, 6, 6] (rows order
    # [t(3), ω(3)]) — the Cholesky factor of the inverse IFT covariance
    # of the Kabsch fit that produced the measurement. When present it
    # REPLACES the scalar lcp weights: the anisotropy matters (see
    # _pair_residual_jacobians).
    lcp_info: jnp.ndarray | None = None


class BaResult(NamedTuple):
    kf_t: jnp.ndarray
    kf_q: jnp.ndarray
    points: jnp.ndarray
    cost: jnp.ndarray  # [iters+1] masked mean squared reprojection error


def _residual_one(
    cam: Camera, t: jnp.ndarray, q: jnp.ndarray, dx: jnp.ndarray,
    p: jnp.ndarray, uv: jnp.ndarray,
    xyz: jnp.ndarray, w_px: jnp.ndarray, w_xyz: jnp.ndarray,
) -> jnp.ndarray:
    """Stacked residual [5] for one (keyframe, landmark) pair with pose
    increment dx = [dt(3), dθ(3)] applied on the manifold:
    T ← (t + dt, q ⊗ exp(dθ)). Rows 0:2 = reprojection (pixels·w_px),
    rows 2:5 = camera-frame depth factor (meters·w_xyz)."""
    t2 = t + dx[:3]
    q2 = qprod(q, v2q(dx[3:]))
    p_cam = qrotate(qconj(q2), p - t2)
    r_px = (distort(cam, project_point(cam, p_cam)) - uv) * w_px
    r_xyz = (p_cam - xyz) * w_xyz
    return jnp.concatenate([r_px, r_xyz])


def _odo_residual(ti, qi, tj, qj, dxi, dxj, ot, oq, w_t, w_r):
    """[6] relative-pose residual between adjacent keyframes with manifold
    increments dxi/dxj = [dt, dθ]: translation residual in frame i, and
    the rotation-vector of the orientation error."""
    from pre3_tpu.geometry.quaternion import q2v

    t1, q1 = ti + dxi[:3], qprod(qi, v2q(dxi[3:]))
    t2, q2 = tj + dxj[:3], qprod(qj, v2q(dxj[3:]))
    r_t = (qrotate(qconj(q1), t2 - t1) - ot) * w_t
    r_r = q2v(qprod(qconj(oq), qprod(qconj(q1), q2))) * w_r
    return jnp.concatenate([r_t, r_r])


def _pair_residual_jacobians(kf_t, kf_q, i_idx, j_idx, rel_t, rel_q,
                             w_t, w_r, w, w_mat=None):
    """Residuals + Jacobian blocks of relative-pose factors between
    ARBITRARY keyframe pairs (i_idx, j_idx) — the odometry chain is the
    adjacent-pair special case, loop closures the non-adjacent one.
    Returns (r [G, 6], ji [G, 6, 6], jj [G, 6, 6]).

    w_mat [G, 6, 6]: optional per-factor square-root INFORMATION matrix
    replacing the scalar (w_t, w_r) weights — the whitened residual is
    wv·(L @ r_raw). A Kabsch-estimated loop-closure pose is strongly
    anisotropic (mm along the depth axis, cm laterally from the
    rotation-translation ambiguity of a narrow-FOV point set); isotropic
    weights either ignore its good directions or get poisoned by its bad
    ones (measured r5: iso-weighted rematch factors DOUBLED multi-loop
    post-BA ATE), so the factor carries the IFT covariance of its own
    fit (vo/covariance.py — the C16 machinery)."""
    zero6 = jnp.zeros(6)

    if w_mat is None:
        def per_pair(ti, qi, tj, qj, ot, oq, wv):
            args = (ot, oq, w_t * wv, w_r * wv)
            r = _odo_residual(ti, qi, tj, qj, zero6, zero6, *args)
            ji = jax.jacfwd(
                lambda d: _odo_residual(ti, qi, tj, qj, d, zero6, *args)
            )(zero6)  # [6, 6]
            jj = jax.jacfwd(
                lambda d: _odo_residual(ti, qi, tj, qj, zero6, d, *args)
            )(zero6)  # [6, 6]
            return r, ji, jj

        return jax.vmap(per_pair)(
            kf_t[i_idx], kf_q[i_idx], kf_t[j_idx], kf_q[j_idx],
            rel_t, rel_q, w,
        )

    def per_pair_m(ti, qi, tj, qj, ot, oq, wv, lmat):
        def res(di, dj):
            raw = _odo_residual(ti, qi, tj, qj, di, dj, ot, oq, 1.0, 1.0)
            return wv * (lmat @ raw)

        r = res(zero6, zero6)
        ji = jax.jacfwd(lambda d: res(d, zero6))(zero6)
        jj = jax.jacfwd(lambda d: res(zero6, d))(zero6)
        return r, ji, jj

    return jax.vmap(per_pair_m)(
        kf_t[i_idx], kf_q[i_idx], kf_t[j_idx], kf_q[j_idx],
        rel_t, rel_q, w, w_mat,
    )


def _pair_terms(kf_t, kf_q, i_idx, j_idx, rel_t, rel_q, w_t, w_r, w,
                w_mat=None):
    """Dense Gauss-Newton contribution of keyframe-pair factors. These
    couple only CAMERA poses, so they add directly to the Schur-reduced
    camera system (no landmark elimination involved). w [G] scales each
    pair's residual (0 = factor disabled). Returns (s_add [F,6,F,6],
    rhs_add [F,6], cost_sum, n_factors). Duplicate (i, j) pairs
    accumulate correctly (scatter-add)."""
    f = kf_t.shape[0]
    r, ji, jj = _pair_residual_jacobians(
        kf_t, kf_q, i_idx, j_idx, rel_t, rel_q, w_t, w_r, w, w_mat
    )
    s_add = jnp.zeros((f, 6, f, 6))
    s_add = s_add.at[i_idx, :, i_idx, :].add(
        jnp.einsum("pab,pac->pbc", ji, ji)
    )
    s_add = s_add.at[j_idx, :, j_idx, :].add(
        jnp.einsum("pab,pac->pbc", jj, jj)
    )
    cross = jnp.einsum("pab,pac->pbc", ji, jj)  # [G, 6, 6]
    s_add = s_add.at[i_idx, :, j_idx, :].add(cross)
    s_add = s_add.at[j_idx, :, i_idx, :].add(
        jnp.swapaxes(cross, -1, -2)
    )
    rhs_add = jnp.zeros((f, 6))
    rhs_add = rhs_add.at[i_idx].add(-jnp.einsum("pab,pa->pb", ji, r))
    rhs_add = rhs_add.at[j_idx].add(-jnp.einsum("pab,pa->pb", jj, r))
    return s_add, rhs_add, jnp.sum(r * r), jnp.sum(w > 0)


def _odo_terms(kf_t, kf_q, odo_t, odo_q, w_t, w_r, odo_w=None):
    """Gauss-Newton contribution of the keyframe odometry chain — the
    adjacent-pair case of _pair_terms."""
    f = kf_t.shape[0]
    if odo_w is None:
        odo_w = jnp.ones(f - 1, kf_t.dtype)
    return _pair_terms(
        kf_t, kf_q, jnp.arange(f - 1), jnp.arange(1, f), odo_t, odo_q,
        w_t, w_r, odo_w,
    )


def _build_normal_eqs(cam, kf_t, kf_q, points, obs_uv, mask,
                      obs_xyz, w_xyz_fl, damping, huber_delta=3.0):
    """One linearization: masked J/r over the [F, L] grid → blocks."""
    f, l = mask.shape
    zero6 = jnp.zeros(6)

    def per_pair(ti, qi, pj, uvij, xyzij, wxj, wpj):
        args = (pj, uvij, xyzij, wpj, wxj)
        r = _residual_one(cam, ti, qi, zero6, *args)
        jc = jax.jacfwd(
            lambda d: _residual_one(cam, ti, qi, d, *args)
        )(zero6)  # [5, 6]
        jp = jax.jacfwd(
            lambda pp: _residual_one(
                cam, ti, qi, zero6, pp, uvij, xyzij, wpj, wxj
            )
        )(pj)  # [5, 3]
        return r, jc, jp

    w_px_fl = mask.astype(obs_uv.dtype)  # [F, L]
    # vmap over landmarks then keyframes → [F, L, ...]
    r, jc, jp = jax.vmap(
        lambda ti, qi, uvi, xyzi, wxi, wpi: jax.vmap(
            lambda pj, uvij, xyzij, wxj, wpj: per_pair(
                ti, qi, pj, uvij, xyzij, wxj, wpj
            )
        )(points, uvi, xyzi, wxi, wpi)
    )(kf_t, kf_q, obs_uv, obs_xyz, w_xyz_fl, w_px_fl)

    # Huber IRLS: per-pair robust weight w = min(1, δ/‖r‖) down-weights
    # outlier factors (wrong long-baseline matches) so they cannot drag
    # the solution — applied to both J and r (the IRLS majorizer).
    rnorm = jnp.linalg.norm(r, axis=-1)  # [F, L]
    wr = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rnorm, 1e-9)))
    r = r * wr[..., None]
    jc = jc * wr[..., None, None]
    jp = jp * wr[..., None, None]

    hcc = jnp.einsum("flab,flac->fbc", jc, jc)  # [F, 6, 6]
    hpp = jnp.einsum("flab,flac->lbc", jp, jp)  # [L, 3, 3]
    wcp = jnp.einsum("flab,flac->flbc", jc, jp)  # [F, L, 6, 3]
    bc = -jnp.einsum("flab,fla->fb", jc, r)  # [F, 6]
    bp = -jnp.einsum("flab,fla->lb", jp, r)  # [L, 3]

    hcc = hcc + damping * jnp.eye(6)[None]
    hpp = hpp + damping * jnp.eye(3)[None]
    return hcc, hpp, wcp, bc, bp


def schur_solve(hcc, hpp, wcp, bc, bp, fixed_first: bool = True,
                s_extra=None, rhs_extra=None):
    """Eliminate landmarks, solve the reduced camera system, back-substitute.

    s_extra/rhs_extra: optional camera-camera factor contributions (the
    odometry chain, _odo_terms) added to the reduced system before the
    gauge fix. Returns (dc [F, 6], dp [L, 3]).
    """
    f = hcc.shape[0]
    l = hpp.shape[0]
    hpp_inv = jnp.linalg.inv(hpp)  # [L, 3, 3] batched
    # S = Hcc_blockdiag − Σ_l W_fl Hpp_l⁻¹ W_gl ᵀ  → [F, 6, F, 6]
    whw = jnp.einsum("flab,lbc,gldc->fagd", wcp, hpp_inv, wcp)
    s = -whw
    s = s.at[jnp.arange(f), :, jnp.arange(f), :].add(hcc)
    rhs = bc - jnp.einsum("flab,lbc,lc->fa", wcp, hpp_inv, bp)  # [F, 6]
    if s_extra is not None:
        s = s + s_extra
        rhs = rhs + rhs_extra

    if fixed_first:
        # gauge fix: freeze keyframe 0 by zeroing its rows/cols and
        # placing identity on its diagonal block
        e = jnp.zeros((f,)).at[0].set(1.0)
        keep = 1.0 - e
        s = s * keep[:, None, None, None] * keep[None, None, :, None]
        s = s.at[0, :, 0, :].set(jnp.eye(6))
        rhs = rhs * keep[:, None]

    # Jacobi normalization before the f32 solve: the raw reduced system has
    # cond ~1e8 (pixel-unit Jacobians ~f² on the diagonal), beyond f32;
    # D^{-1/2} S D^{-1/2} brings it into range. Algebraically exact.
    sd = s.reshape(f * 6, f * 6)
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(sd), 1e-12))
    sn = sd / d[:, None] / d[None, :]
    y = jnp.linalg.solve(sn, rhs.reshape(-1) / d)
    dc = (y / d).reshape(f, 6)
    dp = jnp.einsum(
        "lab,lb->la", hpp_inv, bp - jnp.einsum("flab,fa->lb", wcp, dc)
    )
    return dc, dp


def _cost_sums(cam, kf_t, kf_q, points, obs_uv, mask, obs_xyz, w_xyz_fl,
               huber_delta=3.0):
    """(Σ huber-cost, factor count) over the landmark factors only —
    separable along the landmark axis, so the distributed backend can
    evaluate it per shard and psum the two scalars."""
    zero6 = jnp.zeros(6)
    w_px_fl = mask.astype(obs_uv.dtype)
    r = jax.vmap(
        lambda ti, qi, uvi, xyzi, wxi, wpi: jax.vmap(
            lambda pj, uvij, xyzij, wxj, wpj: _residual_one(
                cam, ti, qi, zero6, pj, uvij, xyzij, wpj, wxj
            )
        )(points, uvi, xyzi, wxi, wpi)
    )(kf_t, kf_q, obs_uv, obs_xyz, w_xyz_fl, w_px_fl)
    # Huber cost: quadratic inside δ, linear outside — consistent with the
    # IRLS weights in _build_normal_eqs.
    rn = jnp.linalg.norm(r, axis=-1)
    rho = jnp.where(
        rn <= huber_delta, rn * rn,
        huber_delta * (2.0 * rn - huber_delta),
    )
    n = jnp.sum(mask) + jnp.sum(w_xyz_fl > 0)
    return jnp.sum(rho), n


def _odo_cost_sums(kf_t, kf_q, odo):
    """(Σ odo-chain cost, factor count) — replicated camera-chain part."""
    odo_t, odo_q, w_t, w_r, odo_w = odo
    zero6 = jnp.zeros(6)
    ro = jax.vmap(
        lambda ti, qi, tj, qj, ot, oq, w: _odo_residual(
            ti, qi, tj, qj, zero6, zero6, ot, oq, w_t * w, w_r * w
        )
    )(kf_t[:-1], kf_q[:-1], kf_t[1:], kf_q[1:], odo_t, odo_q, odo_w)
    return jnp.sum(ro * ro), jnp.sum(odo_w > 0)


def _pair_cost_sums(kf_t, kf_q, pair):
    """(Σ pair-factor cost, factor count) for arbitrary keyframe-pair
    relative-pose factors (loop closures). pair = (i_idx, j_idx, rel_t,
    rel_q, w_t, w_r, w, w_mat-or-None)."""
    i_idx, j_idx, rel_t, rel_q, w_t, w_r, w, w_mat = pair
    r, _, _ = _pair_residual_jacobians(
        kf_t, kf_q, i_idx, j_idx, rel_t, rel_q, w_t, w_r, w, w_mat
    )
    return jnp.sum(r * r), jnp.sum(w > 0)


def _cost(cam, kf_t, kf_q, points, obs_uv, mask, obs_xyz, w_xyz_fl,
          huber_delta=3.0, odo=None, lcp=None):
    """Masked mean factor cost. odo = (odo_t, odo_q, w_t, w_r, odo_w)
    adds the keyframe odometry-chain residuals (quadratic, not Huberized
    — the filter's own motion estimate has no gross outliers); lcp adds
    the loop-closure pose factors (_pair_cost_sums tuple)."""
    total, n = _cost_sums(cam, kf_t, kf_q, points, obs_uv, mask, obs_xyz,
                          w_xyz_fl, huber_delta)
    if odo is not None:
        ot, on = _odo_cost_sums(kf_t, kf_q, odo)
        total = total + ot
        n = n + on
    if lcp is not None:
        pt, pn = _pair_cost_sums(kf_t, kf_q, lcp)
        total = total + pt
        n = n + pn
    return total / jnp.maximum(n, 1)


def _depth_weights(
    mask_xyz: jnp.ndarray,  # [F, L] effective depth-factor mask
    obs_xyz: jnp.ndarray,  # [F, L, 3]
    depth_weight: float,
    depth_range_ref: float,
    dtype,
) -> jnp.ndarray:
    """Per-observation depth-factor weights [F, L].

    depth_range_ref = 0 → the constant depth_weight of the reference-
    parity setup. depth_range_ref > 0 → SR4000 range-noise model
    σ_d ∝ range² (ToF amplitude ∝ 1/d², cov_pose_shift_calc.m): weight
    = depth_weight·(ref/range)², equal to the constant at range = ref —
    far observations stop over-pinning the solution the way the
    constant σ = 2 cm prior does (the superlinear late-corridor drift of
    the round-5 record's 512-frame run)."""
    w = mask_xyz.astype(dtype) * depth_weight
    if depth_range_ref > 0:
        rng = jnp.linalg.norm(obs_xyz, axis=-1)  # [F, L]
        rng = jnp.maximum(rng, 0.4)  # SR4000 min-range gate
        w = w * (depth_range_ref / rng) ** 2
    return w


@partial(jax.jit, static_argnames=("iters", "fixed_first",
                                   "depth_range_ref"))
def bundle_adjust(
    cam: Camera,
    problem: BaProblem,
    iters: int = 10,
    damping: float = 1e-3,
    fixed_first: bool = True,
    depth_weight: float = 50.0,
    odo_weight_t: float = 20.0,
    odo_weight_r: float = 50.0,
    depth_range_ref: float = 0.0,
    lcp_weight_t: float = 20.0,
    lcp_weight_r: float = 50.0,
) -> BaResult:
    """Fixed-iteration Levenberg–Marquardt BA (static trip count; a step
    that increases the cost is rejected and the damping λ is raised ×10,
    an accepted step lowers it ×0.5 — the classic LM schedule as pure
    data-flow, no data-dependent control structure). A fixed-damping
    reject-only loop can stall forever re-computing the same overshooting
    Gauss-Newton step from a drifted initialization; the λ adaptation
    guarantees progress.

    depth_weight: residual weight of the 3D depth factors in 1/meters
    (default 1/σ with σ = 2 cm), relative to pixel residuals at weight 1.
    odo_weight_t / odo_weight_r: weights of the keyframe odometry-chain
    factors (1/meters, 1/radians) when problem.odo_t/odo_q are given —
    σ = 5 cm translation, ~1.1° rotation between keyframes.
    """
    f, l = problem.mask.shape
    odo_w = (
        problem.odo_w if problem.odo_w is not None
        else jnp.ones(f - 1, problem.kf_t.dtype)
    )
    odo = (
        (problem.odo_t, problem.odo_q, odo_weight_t, odo_weight_r, odo_w)
        if problem.odo_t is not None else None
    )
    lcp = (
        (problem.lcp_i, problem.lcp_j, problem.lcp_t, problem.lcp_q,
         lcp_weight_t, lcp_weight_r,
         problem.lcp_w if problem.lcp_w is not None
         else jnp.ones(problem.lcp_i.shape[0], problem.kf_t.dtype),
         problem.lcp_info)
        if problem.lcp_i is not None else None
    )
    if problem.obs_xyz is None:
        obs_xyz = jnp.zeros((f, l, 3), problem.obs_uv.dtype)
        w_xyz_fl = jnp.zeros((f, l), problem.obs_uv.dtype)
    else:
        obs_xyz = problem.obs_xyz
        mask_xyz = (
            problem.mask_xyz if problem.mask_xyz is not None else problem.mask
        )
        w_xyz_fl = _depth_weights(
            problem.mask & mask_xyz, obs_xyz, depth_weight,
            depth_range_ref, problem.obs_uv.dtype,
        )

    # loop-closure landmarks keep full quadratic weight (effectively
    # infinite Huber delta) — see BaProblem.lc_lm
    hub = (
        jnp.where(problem.lc_lm[None, :], 1e6, 3.0)
        if problem.lc_lm is not None else 3.0
    )

    def gn_step(carry, _):
        kf_t, kf_q, points, lam = carry
        c0 = _cost(cam, kf_t, kf_q, points, problem.obs_uv, problem.mask,
                   obs_xyz, w_xyz_fl, huber_delta=hub, odo=odo, lcp=lcp)
        hcc, hpp, wcp, bc, bp = _build_normal_eqs(
            cam, kf_t, kf_q, points, problem.obs_uv, problem.mask,
            obs_xyz, w_xyz_fl, lam, huber_delta=hub,
        )
        if odo is not None:
            s_extra, rhs_extra, _, _ = _odo_terms(
                kf_t, kf_q, problem.odo_t, problem.odo_q,
                odo_weight_t, odo_weight_r, odo_w,
            )
        else:
            s_extra = rhs_extra = None
        if lcp is not None:
            s_lc, rhs_lc, _, _ = _pair_terms(
                kf_t, kf_q, lcp[0], lcp[1], lcp[2], lcp[3],
                lcp_weight_t, lcp_weight_r, lcp[6], lcp[7],
            )
            s_extra = s_lc if s_extra is None else s_extra + s_lc
            rhs_extra = (
                rhs_lc if rhs_extra is None else rhs_extra + rhs_lc
            )
        dc, dp = schur_solve(hcc, hpp, wcp, bc, bp, fixed_first,
                             s_extra, rhs_extra)
        t2 = kf_t + dc[:, :3]
        q2 = qnormalize(qprod(kf_q, v2q(dc[:, 3:])))
        p2 = points + dp
        c1 = _cost(cam, t2, q2, p2, problem.obs_uv, problem.mask,
                   obs_xyz, w_xyz_fl, huber_delta=hub, odo=odo, lcp=lcp)
        better = c1 < c0
        kf_t = jnp.where(better, t2, kf_t)
        kf_q = jnp.where(better, q2, kf_q)
        points = jnp.where(better, p2, points)
        lam = jnp.where(
            better,
            jnp.maximum(lam * 0.5, 1e-8),
            jnp.minimum(lam * 10.0, 1e6),
        )
        return (kf_t, kf_q, points, lam), jnp.where(better, c1, c0)

    init = (problem.kf_t, problem.kf_q, problem.points,
            jnp.asarray(damping, problem.kf_t.dtype))
    (kf_t, kf_q, points, _lam), costs = jax.lax.scan(
        gn_step, init, None, length=iters
    )
    cost0 = _cost(
        cam, problem.kf_t, problem.kf_q, problem.points, problem.obs_uv,
        problem.mask, obs_xyz, w_xyz_fl, huber_delta=hub, odo=odo,
        lcp=lcp,
    )
    return BaResult(
        kf_t=kf_t, kf_q=kf_q, points=points,
        cost=jnp.concatenate([cost0[None], costs]),
    )
