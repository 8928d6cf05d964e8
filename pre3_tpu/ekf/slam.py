"""The full EKF-SLAM step and sequence driver.

Re-design of the reference main loop (mono_slam.m:113-435):

  per frame k —
    1. EKF prediction with the VO increment as control (ekf_prediction →
       predict_state_and_covariance.m; VO = vo/ransac.py instead of the
       disk-cached Calculate_V_Omega_RANSAC_dr_ye chain)
    2. measurement prediction + IC matching (search_IC_matches.m)
    3. 1-point RANSAC li-inlier selection (ransac_hypotheses.m), li update
       applied to the PRIOR (ekf_update_li_inliers.m:57)
    4. hi-inlier rescue at the post-li state (rescue_hi_inliers.m:32-33),
       hi update applied to the POSTERIOR (ekf_update_hi_inliers.m:57-58)
    5. bookkeeping counters (update_features_info.m)
    6. map management: delete / convert / add (map_management.m)

Deliberate deviation (SURVEY §7.3): the reference feeds the EKF the VO of
steps (k−2 → k−1) (fv.m:47 — a one-frame delay); here the current pair's
VO (k−1 → k) drives the prediction. The whole step is one jitted program;
sequences run under lax.scan.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.ekf.map_management import (
    add_features, convert_to_cartesian, delete_features,
)
from pre3_tpu.ekf.measurement import (
    Observations, predict_measurements, search_ic_matches,
)
from pre3_tpu.ekf.one_point_ransac import one_point_ransac, rescue_hi_inliers
from pre3_tpu.ekf.prediction import predict
from pre3_tpu.ekf.state import EkfState, init_state
from pre3_tpu.ekf.update import kalman_update
from pre3_tpu.frontend.pipeline import Features
from pre3_tpu.geometry.camera import Camera
from pre3_tpu.geometry.quaternion import qrotate, v2q
from pre3_tpu.vo.dead_reckoning import vo_pair


class SlamConfig(NamedTuple):
    std_z: float = 1.0  # px measurement noise (mono_slam.m:78)
    ransac_batch: int = 256  # 1-pt RANSAC hypotheses (ref: ≤1000 adaptive)
    ransac_points: int = 3  # matches stacked per hypothesis: 3 = the
    # namesake 3PRE mode (3-match hypotheses when >3 IC exist, 1 otherwise,
    # select_random_match.m:47-51); 1 = classic Civera 1-point RANSAC
    vo_batch: int = 512  # VO RANSAC hypotheses
    match_ratio: float = 1.5  # Lowe ratio (siftmatch.c default)
    max_adds: int = 8
    min_measured: int = 25  # re-init support target (mono_slam.m:91 uses 50)
    est_method: str = "1pre"  # "1pre" | "pure_ekf" (EST_METHOD flag:
    # pure_ekf updates on ALL IC matches at once, ekf_update_all.m:27-62)
    matcher: str = "desc"  # "desc" (search_IC_matches + siftmatch path) |
    # "ncc_warp" (warped-patch correlation scan, matching.m — requires
    # the intensity image per frame, FEATURE_EXTRACTOR='FAST' analog)
    ncc_threshold: float = 0.60  # matching.m:31 correlation gate
    only_predict: bool = False  # ONLY_PREDICT flag: dead-reckon, no update
    init_sampling: str = "topk"  # new-feature candidate selection: "topk"
    # (detector score, deterministic) | "weighted" (the reference's
    # Gaussian-center-weighted sampling without replacement,
    # Weighted_Smpl_wo_replacement.m, as Gumbel top-k)
    max_age: int = 10_000  # landmark lifetime in frames. The reference
    # deletes at age>20 (delete_features.m:41) as a stale-SIFT-descriptor
    # workaround, per its own comment; this engine refreshes descriptors
    # on every match, so long lifetimes are sound — and they are the
    # single biggest accuracy lever at length: 256-frame corridor ATE
    # 0.597 m (max_age=20) → 0.239 m (unlimited), BA 0.458 → 0.165 m,
    # at identical cost (the round-3 record sweep). Set 20 for reference
    # parity. Tracking-ratio deletion still prunes bad landmarks.
    max_invisible: int = 20  # frames a landmark may stay out of view
    # before deletion (delete_features.m:46). Large values keep a
    # persistent "memory map": on trajectory revisits the filter
    # re-acquires old landmarks through the (uncertainty-widened) search
    # gate — EKF loop closure. Costs map slots; pair with n_landmarks
    # sized for the whole environment.
    vo_noise_from_covariance: bool = True  # IFT VO covariance as process
    # noise (instead of the reference's fixed constant)
    vo_range_weighted: bool = True  # 1/range² weights in the VO refit
    # (inverse variance under the SR4000's angular-dominated noise).
    # Measured: 256-frame corridor ATE 0.243 → 0.209, 512-frame 1.80 →
    # 1.69, no cost. The reference refit is unweighted — set False for
    # parity (find_transform_matrix.m weights all inliers equally).
    initial_orientation: bool = True  # INITIAL_ORIENTATION_COMPENSATION:
    # plane-fit gravity-aligned q0 from frame 0's xyz image — the
    # reference's default startup (initialize_x_and_p.m:35-37), default
    # ON for parity (config_file.m:29). Needs the raw xyz image at
    # bootstrap (run_slam(xyz_imgs=...), OnlineSlam, or the pipelined
    # runner); silently identity when none is given. Measured (r5,
    # tools/measure_tilt.py, 15°-tilted start over a floor): the prior
    # changes only the output frame convention — SE(3)-aligned ATE
    # 0.0793 vs 0.0792 m with it off — and the 60° plausibility gate
    # keeps wall-only scenes at identity, so parity costs nothing.
    # (The reference's ONLINE heading updates stay default-off:
    # heading_update_every=8 measured 0.0874 m on the same scene — the
    # per-frame floor fit is noisier than the filter's own orientation.)
    heading_update_every: int = 0  # every N steps, re-fit the floor plane
    # and apply the gravity-direction update (the reference's commented
    # online heading correction, mono_slam.m:189-193 ran it every 4
    # steps). 0 = off. Needs per-frame xyz images.
    motion_model: str = "odometry"  # prediction model (MOTION_INPUT flag):
    # "odometry"         — VO increment as control (fv.m:47, the default);
    #                      VO failure → identity + inflated noise
    # "odo_cv_fallback"  — VO when it succeeds; on failure COAST on the
    #                      carried v/ω states (refreshed from VO each good
    #                      frame, fv.m:47-52) with the constant-velocity
    #                      transition — robust through texture-poor frames
    # "cv"               — pure Civera constant-velocity estimator, no VO
    #                      at all (the reference's MOTION_INPUT-off mode,
    #                      dfv_by_dxv.m:27-117): v/ω estimated by the EKF
    dt: float = 0.1  # sensor period (predict_state_and_covariance.m:35)
    std_a: float = 0.1  # linear acceleration noise (mono_slam.m:76)
    std_alpha: float = 0.1  # angular acceleration noise (mono_slam.m:77)
    depth_range_quadratic: bool = True  # SR4000 range noise ∝ range²
    # beyond the d0 knee in the landmark depth prior: σ_d = depth_sigma·
    # max(1, (d/d0)²) — the reference's constant 1 cm inside d0, honestly
    # looser beyond. THE round-4 accuracy lever, measured on corridors
    # (d0=1.5): 256-frame ATE 0.209 → 0.118, 512-frame 1.69 → 0.515 —
    # far landmarks' depth records carry range-proportional error the
    # constant prior over-trusts, and the over-pinned ρ then biases the
    # camera chain. Set False for reference parity
    # (initialize_a_feature_sift_3.m:116 uses the constant 1 cm).
    depth_range_d0: float = 1.5  # knee of the hybrid prior, meters
    # (d0=2.0 measured: 0.165 / 0.97 — the lower knee wins at both
    # lengths on SR4000-scale scenes)
    match_gate_first: bool = False  # restrict map matching to in-gate
    # candidates BEFORE the ratio test. False = the reference's order
    # (global siftmatch, then ellipse gate — matching_sift_based.m:
    # 118-130), which drops a landmark whose global best match is
    # out-of-gate even when the in-gate runner-up is right.
    max_update_slots: int = 0  # bound each Kalman update to this many
    # measurement slots (0 = full width, exact). The P downdate is
    # O(D²·2K) over ALL K slots even though only the measured tens have
    # nonzero rows; a bound of ~2-4× the typical inlier count makes the
    # update O(D²·2M) — exact (up to Cholesky-order fp, ~1e-8) while
    # ≤ M slots measure (see kalman_update). K ≥ 512 should set 128.


class StepStats(NamedTuple):
    """Per-step observability record (the StatData analog, §5 metrics)."""

    n_visible: jnp.ndarray
    n_ic: jnp.ndarray
    n_li: jnp.ndarray
    n_hi: jnp.ndarray
    n_active: jnp.ndarray
    vo_ok: jnp.ndarray
    vo_inliers: jnp.ndarray
    # inlier slots silently dropped because more than max_update_slots
    # measured this step (0 whenever the bound has margin — the bounded
    # update is then exact). Nonzero means max_update_slots is
    # under-provisioned for this scene (ADVICE r4: make the cliff
    # observable instead of silent).
    update_overflow: jnp.ndarray = 0


class StepRecord(NamedTuple):
    """Per-step inlier observations, recorded for the BA backend: the
    filter-vetted measurements (z, depth) of each landmark slot, plus the
    slot's init_frame to disambiguate slot reuse after deletion."""

    z: jnp.ndarray  # [K, 2]
    z_xyz: jnp.ndarray  # [K, 3]
    measured: jnp.ndarray  # [K] bool — li | hi inlier this step
    init_frame: jnp.ndarray  # [K] int32
    visible: jnp.ndarray  # [K] bool — predicted in image this step
    # (distinguishes a genuine revisit re-acquisition — invisible during
    # the measured-gap — from a visible-but-unmatched tracking dropout
    # when the BA bridge mines loop-closure factors, ekf_ba.py)


def slam_step(
    cam_model: Camera,
    state: EkfState,
    frame: Features,
    prev_frame: Features,
    step: jnp.ndarray,
    key: jax.Array,
    cfg: SlamConfig = SlamConfig(),
    image: jnp.ndarray | None = None,  # [H, W] — required for ncc_warp
    xyz_img: jnp.ndarray | None = None,  # [H, W, 3]
) -> tuple[EkfState, StepStats]:
    kv, kr, ka = jax.random.split(key, 3)

    # 1. VO control input + prediction. Process noise = estimated VO
    # covariance (vo/covariance.py, mapped [dt,dω]→[dX,dq]) plus the
    # reference's hand-tuned floor — replacing the purely-constant noise
    # of predict_state_and_covariance.m:98-102 (its commented-out
    # calc_cov_RANSAC_dr_ye intent, realized).
    if cfg.motion_model == "cv":
        # pure constant-velocity estimation: no VO at all (the reference
        # with MOTION_INPUT off) — v/ω are live filter states
        from pre3_tpu.ekf.prediction import predict_cv

        state = predict_cv(
            state, dt=cfg.dt, std_a=cfg.std_a, std_alpha=cfg.std_alpha
        )
        vo_ok = jnp.asarray(False)
        vo_inliers = jnp.asarray(0, jnp.int32)
    else:
        vo = vo_pair(
            prev_frame, frame, kv, batch=cfg.vo_batch,
            with_covariance=cfg.vo_noise_from_covariance,
            range_weighted_refit=cfg.vo_range_weighted,
        )
        u = jnp.where(
            vo.ok,
            jnp.concatenate([vo.delta.t, vo.delta.q]),
            jnp.array([0.0, 0, 0, 1, 0, 0, 0]),
        )
        q_pre = state.x[3:7]  # orientation BEFORE prediction (fv.m:47)
        if cfg.vo_noise_from_covariance:
            from pre3_tpu.ekf.prediction import _PN
            from pre3_tpu.geometry.quaternion import q2v

            jq = jax.jacfwd(v2q)(q2v(vo.delta.q))  # [4, 3] ∂q/∂ω at fit
            j = (
                jnp.zeros((7, 6)).at[:3, :3].set(jnp.eye(3))
                .at[3:, 3:].set(jq)
            )
            pn = j @ vo.cov @ j.T + _PN  # reference floor (precomputed)
            # failed VO: large-ish identity-motion uncertainty
            pn = jnp.where(vo.ok, pn, jnp.eye(7) * 1e-3)
        else:
            pn = None

        def _odo_predict(s: EkfState) -> EkfState:
            return predict(s, u) if pn is None else predict(s, u, pn)

        if cfg.motion_model == "odo_cv_fallback":
            # VO denied → coast on the carried velocities instead of
            # identity + inflated noise (the untested-texture robustness
            # the reference gets from its velocity refresh, fv.m:47-52)
            from pre3_tpu.ekf.prediction import predict_cv

            state = jax.lax.cond(
                vo.ok, _odo_predict,
                lambda s: predict_cv(
                    s, dt=cfg.dt, std_a=cfg.std_a, std_alpha=cfg.std_alpha
                ),
                state,
            )
        else:
            state = _odo_predict(state)

        # refresh the carried v/ω states from the VO velocity on success
        # (exactly fv.m:47-52: vW = R(q)·dX/Δt, wW = q2v(dq)/Δt) — this
        # is what makes the cv fallback coast on real motion. No effect
        # on the trajectory in plain odometry mode (v/ω don't enter the
        # odometry transition or the measurement model).
        from pre3_tpu.geometry.quaternion import q2v as _q2v

        v_vo = qrotate(q_pre, vo.delta.t) / cfg.dt
        w_vo = _q2v(vo.delta.q) / cfg.dt
        x = state.x
        x = x.at[7:10].set(jnp.where(vo.ok, v_vo, x[7:10]))
        x = x.at[10:13].set(jnp.where(vo.ok, w_vo, x[10:13]))
        state = state._replace(x=x)
        vo_ok = vo.ok
        vo_inliers = vo.n_inliers

    # 2. measurement prediction + matching (descriptor path, or the
    # warped-patch correlation scan of matching.m when matcher=ncc_warp)
    obs = predict_measurements(cam_model, state, std_z=cfg.std_z)
    if cfg.matcher == "ncc_warp":
        if image is None:
            raise ValueError("matcher='ncc_warp' needs the intensity image")
        from pre3_tpu.ekf.ncc_matching import search_ic_matches_ncc

        # sanitize on-device: raw SR4000 xyz has NaN background pixels and
        # bilinear sampling over them would poison inlier z_xyz records
        obs = search_ic_matches_ncc(
            cam_model, obs, state, image,
            xyz_img=None if xyz_img is None else jnp.nan_to_num(xyz_img),
            ncc_threshold=cfg.ncc_threshold,
        )
    else:
        obs, state = search_ic_matches(
            obs, state, frame, ratio=cfg.match_ratio,
            gate_first=cfg.match_gate_first,
        )

    # 3./4. estimation method dispatch (EST_METHOD, config_file.m:17):
    ms = cfg.max_update_slots if cfg.max_update_slots > 0 else None
    if cfg.only_predict:
        li = jnp.zeros_like(obs.ic)
        hi = jnp.zeros_like(obs.ic)
    elif cfg.est_method == "pure_ekf":
        # PURE_EKF: single update on every IC match (mono_slam.m:199 →
        # ekf_update_all.m:27-62); no RANSAC gating
        li = obs.ic
        hi = jnp.zeros_like(obs.ic)
        state = kalman_update(state, obs, li, std_z=cfg.std_z,
                              max_slots=ms)
    elif cfg.est_method == "iekf":
        # Iterated EKF on all IC matches — the working realization of the
        # reference's dead ekf_update_iterated.m path (update.py docstring)
        from pre3_tpu.ekf.update import iterated_kalman_update

        li = obs.ic
        hi = jnp.zeros_like(obs.ic)
        state = iterated_kalman_update(
            cam_model, state, obs.z, li, std_z=cfg.std_z
        )
    else:
        # 1PRE: 1-point RANSAC li update on the prior, then hi rescue on
        # the posterior
        li = one_point_ransac(
            kr, cam_model, state, obs, batch=cfg.ransac_batch,
            std_z=cfg.std_z, n_points=cfg.ransac_points, max_slots=ms,
        )
        state = kalman_update(state, obs, li, std_z=cfg.std_z,
                              max_slots=ms)
        hi, obs2 = rescue_hi_inliers(
            cam_model, state, obs, li, std_z=cfg.std_z
        )
        state = kalman_update(state, obs2, hi, std_z=cfg.std_z,
                              max_slots=ms)

    # 5. bookkeeping (update_features_info.m)
    measured = li | hi
    state = state._replace(
        times_predicted=state.times_predicted + obs.visible.astype(jnp.int32),
        times_measured=state.times_measured + measured.astype(jnp.int32),
        last_visible=jnp.where(obs.ic, step, state.last_visible),
    )

    # 6. map management on the posterior. The separation gate for new
    # features reuses the last available measurement prediction (exact
    # posterior h is not needed for a pixel-distance gate) — saves a full
    # H/S recompute per step.
    state = delete_features(
        state, step, max_age=cfg.max_age, max_invisible=cfg.max_invisible
    )
    state = convert_to_cartesian(state)
    gate_h = obs2.h if (cfg.est_method == "1pre" and
                        not cfg.only_predict) else obs.h
    state = add_features(
        cam_model, state, frame, gate_h, step,
        n_measured=jnp.sum(measured),
        max_adds=cfg.max_adds, min_measured=cfg.min_measured,
        std_pxl=cfg.std_z,
        depth_range_quadratic=cfg.depth_range_quadratic,
        depth_range_d0=cfg.depth_range_d0, image=image,
        sampling=cfg.init_sampling, key=ka,
    )

    # Optional periodic gravity-direction correction from a per-frame
    # floor-plane fit (the reference's commented heading update,
    # mono_slam.m:189-193). Inside the lax.cond so the RANSAC plane fit
    # costs nothing on the other N−1 steps.
    if cfg.heading_update_every > 0:
        if xyz_img is None:
            raise ValueError(
                "heading_update_every > 0 needs per-frame xyz images"
            )
        from pre3_tpu.backend.plane_fit import floor_up_direction
        from pre3_tpu.ekf.update import attitude_update

        # fold_in (not another split) keeps the kv/kr/ka streams — and
        # therefore every heading-off trajectory — bit-identical
        kh = jax.random.fold_in(key, 7)

        def _with_heading(s: EkfState) -> EkfState:
            fit = floor_up_direction(kh, jnp.nan_to_num(xyz_img))
            return attitude_update(s, fit.normal, ok=fit.ok)

        state = jax.lax.cond(
            jnp.mod(step, cfg.heading_update_every) == 0,
            _with_heading, lambda s: s, state,
        )

    if ms is not None:
        # each bounded kalman_update keeps at most ms used slots; count
        # what the li and hi updates would have silently dropped
        overflow = (
            jnp.maximum(jnp.sum(li) - ms, 0)
            + jnp.maximum(jnp.sum(hi) - ms, 0)
        )
    else:
        overflow = jnp.asarray(0, jnp.int32)
    stats = StepStats(
        n_visible=jnp.sum(obs.visible),
        n_ic=jnp.sum(obs.ic),
        n_li=jnp.sum(li),
        n_hi=jnp.sum(hi),
        n_active=jnp.sum(state.active),
        vo_ok=vo_ok,
        vo_inliers=vo_inliers,
        update_overflow=overflow,
    )
    record = StepRecord(
        z=obs.z, z_xyz=obs.z_xyz, measured=measured,
        init_frame=state.init_frame, visible=obs.visible,
    )
    return state, (stats, record)


class SlamTrajectory(NamedTuple):
    t: jnp.ndarray  # [F, 3]
    q: jnp.ndarray  # [F, 4]
    stats: StepStats  # leaves have leading axis F-1
    records: StepRecord  # leaves have leading axis F-1 (BA backend input)


def bootstrap_state(
    cam_model: Camera,
    first: Features,  # single frame
    key: jax.Array,
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    image: jnp.ndarray | None = None,
    xyz_img: jnp.ndarray | None = None,  # [H, W, 3] frame 0 — enables the
    # plane-fit orientation prior when cfg.initial_orientation
) -> EkfState:
    """Initialize the filter and seed the map from frame 0
    (initialize_features at step 0, mono_slam.m:140). With
    cfg.initial_orientation and a frame-0 xyz image, x₀'s orientation is
    the gravity-aligned plane-fit prior (initialize_x_and_p.m:35-37);
    identity when the fit fails (the flag-off fallback)."""
    q0 = None
    if cfg.initial_orientation and xyz_img is not None:
        from pre3_tpu.backend.plane_fit import initial_orientation_from_floor

        kp, key = jax.random.split(key)
        q0, _ok = initial_orientation_from_floor(
            kp, jnp.nan_to_num(xyz_img)
        )
    state0 = init_state(
        n_landmarks=n_landmarks, desc_dim=first.desc.shape[-1], q0=q0
    )
    obs0 = predict_measurements(cam_model, state0, std_z=cfg.std_z)
    return add_features(
        cam_model, state0, first, obs0.h, jnp.asarray(0, jnp.int32),
        n_measured=jnp.asarray(0, jnp.int32),
        max_adds=cfg.max_adds * 4, min_measured=cfg.min_measured,
        std_pxl=cfg.std_z,
        depth_range_quadratic=cfg.depth_range_quadratic,
        depth_range_d0=cfg.depth_range_d0, image=image,
        sampling=cfg.init_sampling, key=key,
    )


def scan_steps(
    cam_model: Camera,
    state: EkfState,
    prev_last: Features,  # the frame PRECEDING this chunk (VO anchor)
    feats: Features,  # stacked chunk, leading axis C
    keys: jax.Array,  # [C] PRNG keys
    steps: jnp.ndarray,  # [C] global step indices
    cfg: SlamConfig = SlamConfig(),
    images: jnp.ndarray | None = None,  # [C, H, W], matcher='ncc_warp'
    xyz_imgs: jnp.ndarray | None = None,  # [C, H, W, 3]
):
    """Scan slam_step over a feature chunk; resumable (returns the carry).

    This is the chunked backend stage of the stage pipeline
    (runtime/stage_pipeline.py): the frontend produces `feats` for chunk
    c+1 while this consumes chunk c. Returns
    (state, (t [C,3], q [C,4], stats, records))."""
    c = feats.uv.shape[0]
    prevs = jax.tree.map(
        lambda last, xs: jnp.concatenate([last[None], xs[:-1]]),
        prev_last, feats,
    )

    def body(st, inp):
        k, fr, pfr, i, img, xz = inp
        img = None if images is None else img
        xz = None if xyz_imgs is None else xz
        st, (stats, record) = slam_step(
            cam_model, st, fr, pfr, i, k, cfg, image=img, xyz_img=xz
        )
        return st, (st.x[0:3], st.x[3:7], stats, record)

    none_seq = jnp.zeros((c, 0)) if images is None else images
    none_xyz = jnp.zeros((c, 0)) if xyz_imgs is None else xyz_imgs
    return jax.lax.scan(
        body, state, (keys, feats, prevs, steps, none_seq, none_xyz)
    )


@partial(jax.jit, static_argnames=("cfg", "n_landmarks"))
def run_slam(
    cam_model: Camera,
    feats: Features,  # stacked, leading axis F
    key: jax.Array,
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    images: jnp.ndarray | None = None,  # [F, H, W], matcher='ncc_warp'
    xyz_imgs: jnp.ndarray | None = None,  # [F, H, W, 3]
) -> SlamTrajectory:
    """Run EKF-SLAM over a stacked feature sequence with lax.scan."""
    n_frames = feats.uv.shape[0]
    kboot, key = jax.random.split(key)
    first = jax.tree.map(lambda x: x[0], feats)
    state0 = bootstrap_state(
        cam_model, first, kboot, cfg, n_landmarks,
        image=None if images is None else images[0],
        xyz_img=None if xyz_imgs is None else xyz_imgs[0],
    )

    keys = jax.random.split(key, n_frames - 1)
    steps = jnp.arange(1, n_frames, dtype=jnp.int32)
    rest = jax.tree.map(lambda x: x[1:], feats)
    _, (ts, qs, stats, records) = scan_steps(
        cam_model, state0, first, rest, keys, steps, cfg,
        images=None if images is None else images[1:],
        xyz_imgs=None if xyz_imgs is None else xyz_imgs[1:],
    )
    t0 = jnp.zeros((1, 3))
    q0 = state0.x[3:7][None]  # identity, or the plane-fit prior
    return SlamTrajectory(
        t=jnp.concatenate([t0, ts]),
        q=jnp.concatenate([q0, qs]),
        stats=stats,
        records=records,
    )
