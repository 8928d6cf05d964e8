"""EKF prediction with odometry (VO) control input.

Re-design of predict_state_and_covariance.m:27-143 + fv.m + aux_code/
odometry_model.m: the camera pose is propagated by the frame-to-frame VO
increment u = (dX, dq); landmarks are static. The reference's hand-coded
F, G Jacobians (odometry_model.m:62-68) are obtained by jax.jacfwd of the
13-dim transition; covariance propagation is done blockwise so the
landmark-landmark block (the O(N²) bulk) is never multiplied by an
identity — only the camera row/column strips are touched, which is both
exactly the reference's block structure (predict_state_and_covariance.m:
131) and the cheap way to do it.

Process noise mirrors the reference's hand-tuned values
(predict_state_and_covariance.m:98-102): cov_dX = diag((0.01/3)²) and
cov_dq from Euler noise 0.24°/2·[1, 0.1, 1] pushed through e2q.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.ekf.state import CAM_DIM, EkfState
from pre3_tpu.geometry.quaternion import e2q, qnormalize, qprod, qrotate, v2q


def camera_transition(cam: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """13-dim camera state transition under odometry control u = [dX(3),
    dq(4)] (odometry_model.m:1-70): r' = r + R(q)·dX, q' = q ⊗ dq;
    velocity states pass through (they are carried but unused in odometry
    mode, as in the reference)."""
    r, q = cam[0:3], cam[3:7]
    dx, dq = u[0:3], u[3:7]
    r_new = r + qrotate(q, dx)
    q_new = qprod(q, dq)
    return jnp.concatenate([r_new, q_new, cam[7:13]])


def process_noise_u() -> np.ndarray:
    """[7, 7] control-space noise Pn (static constant)."""
    cov_dx = np.diag(np.full(3, (0.01 / 3.0) ** 2, np.float64))
    e = 0.24 / 2.0 * np.pi / 180.0 * np.array([1.0, 0.1, 1.0])
    # Qe = ∂q/∂e at the nominal Euler noise point (reference builds cov_dq
    # = Qe diag(e²) Qeᵀ with Qe evaluated at e itself)
    qe = np.asarray(jax.jacfwd(e2q)(jnp.asarray(e, jnp.float32)), np.float64)
    cov_dq = qe @ np.diag(e**2) @ qe.T
    pn = np.zeros((7, 7))
    pn[:3, :3] = cov_dx
    pn[3:, 3:] = cov_dq
    return pn.astype(np.float32)


# Kept as numpy: a device-array closure constant would be hoisted as an
# extra executable parameter (see geometry/camera.py::sr4000_camera).
_PN = process_noise_u()


def _norm_jac(q: jnp.ndarray) -> jnp.ndarray:
    """Jacobian of quaternion normalization (the reference's normJac)."""
    return jax.jacfwd(qnormalize)(q)


def _propagate(
    state: EkfState, cam_new: jnp.ndarray, f: jnp.ndarray,
    q_block: jnp.ndarray,
) -> EkfState:
    """Blockwise covariance propagation + quaternion renorm shared by the
    odometry and constant-velocity predictions
    (predict_state_and_covariance.m:131,137-143): only the camera
    row/column strips are touched; the [N²] landmark block passes
    through untouched."""
    p = state.p
    pcc = p[:CAM_DIM, :CAM_DIM]
    pcl = p[:CAM_DIM, CAM_DIM:]
    pcc_n = f @ pcc @ f.T + q_block
    pcl_n = f @ pcl
    jn = _norm_jac(cam_new[3:7])
    jfull = jnp.eye(CAM_DIM).at[3:7, 3:7].set(jn)
    pcc_n = jfull @ pcc_n @ jfull.T
    pcl_n = jfull @ pcl_n
    # Strip writes instead of jnp.block + a full [D, D] symmetrize: the
    # landmark block is untouched (and symmetric by induction — every
    # update symmetrizes the full P), the cam/landmark strips are written
    # symmetric by construction, and only the 13×13 block needs the
    # explicit 0.5(A+Aᵀ). Saves ~3 full-matrix memory passes per step —
    # the [D, D] block build is pure memory traffic.
    pcc_n = 0.5 * (pcc_n + pcc_n.T)
    p_new = p.at[:CAM_DIM, :CAM_DIM].set(pcc_n)
    p_new = p_new.at[:CAM_DIM, CAM_DIM:].set(pcl_n)
    p_new = p_new.at[CAM_DIM:, :CAM_DIM].set(pcl_n.T)
    cam_new = cam_new.at[3:7].set(qnormalize(cam_new[3:7]))
    x_new = state.x.at[:CAM_DIM].set(cam_new)
    return state._replace(x=x_new, p=p_new)


def camera_transition_cv(
    cam: jnp.ndarray, n: jnp.ndarray, dt: float
) -> jnp.ndarray:
    """Civera constant-velocity transition with acceleration impulse
    n = [a(3), α(3)] (the reference's no-odometry estimator path: the
    original fv.m 'constant_velocity' body, fv.m:98-106 commented form,
    with Jacobians dfv_by_dxv.m:27-117):
      v' = v + a·Δt, ω' = ω + α·Δt, r' = r + v'·Δt, q' = q ⊗ v2q(ω'·Δt).
    The impulse enters position/orientation through the updated
    velocities — the standard MonoSLAM noise coupling."""
    r, q = cam[0:3], cam[3:7]
    v2 = cam[7:10] + n[0:3] * dt
    w2 = cam[10:13] + n[3:6] * dt
    r_new = r + v2 * dt
    q_new = qprod(q, v2q(w2 * dt))
    return jnp.concatenate([r_new, q_new, v2, w2])


@partial(jax.jit, static_argnames=("dt", "std_a", "std_alpha"))
def predict_cv(
    state: EkfState,
    dt: float = 0.1,
    std_a: float = 0.1,
    std_alpha: float = 0.1,
) -> EkfState:
    """Constant-velocity EKF prediction — the reference estimator mode
    with MOTION_INPUT off (mono_slam.m:77-78 σa = σα = 0.1; Δt = 0.1 s,
    predict_state_and_covariance.m:35). The carried v/ω states become
    live: they propagate the pose and receive the acceleration
    random-walk noise, so measurement updates estimate them through the
    correlations this prediction builds."""
    cam = state.x[:CAM_DIM]
    zero6 = jnp.zeros(6)
    cam_new = camera_transition_cv(cam, zero6, dt)
    f = jax.jacfwd(lambda c: camera_transition_cv(c, zero6, dt))(cam)
    g = jax.jacfwd(lambda n: camera_transition_cv(cam, n, dt))(zero6)
    pn = jnp.diag(
        jnp.concatenate([
            jnp.full(3, std_a**2), jnp.full(3, std_alpha**2)
        ])
    )
    return _propagate(state, cam_new, f, g @ pn @ g.T)


@jax.jit
def predict(
    state: EkfState, u: jnp.ndarray, pn: jnp.ndarray | None = None
) -> EkfState:
    """One EKF prediction. u = [dX(3), dq(4)] VO increment (identity when
    VO failed, matching Calculate_V_Omega_RANSAC_dr_ye.m:41-45).

    pn: optional [7, 7] control-space noise. Default is the reference's
    hand-tuned constant; pass the estimated VO covariance
    (vo/covariance.py, mapped to u-space) for a principled process noise —
    the improvement the reference left commented out
    (predict_state_and_covariance.m:104 `Pn = calc_cov_RANSAC_dr_ye`)."""
    if pn is None:
        pn = _PN
    cam = state.x[:CAM_DIM]
    f_fn = lambda c: camera_transition(c, u)
    g_fn = lambda uu: camera_transition(cam, uu)
    cam_new = f_fn(cam)
    f = jax.jacfwd(f_fn)(cam)  # [13, 13]
    g = jax.jacfwd(g_fn)(u)  # [13, 7]
    return _propagate(state, cam_new, f, g @ pn @ g.T)
