"""Quaternion algebra (Hamilton convention, scalar-first [w, x, y, z]).

Semantics mirror the reference's SLAMTB rotation utilities
(matlab_code/slamToolbox_11_02_18/FrameTransforms/Rotations/
{q2R,R2q,qProd,v2q,q2v,e2q,q2e}.m): ``q2r(q) @ rb`` maps a body-frame vector
to the world frame. All functions are pure jnp, shaped for vmap (every
function acts on the trailing axis), and differentiable — the reference's
hand-written quaternion Jacobians (dq3_by_dq1.m, dRq_times_a_by_dq.m,
dqbar_by_dq.m) are obtained here via jax autodiff instead.
"""

from __future__ import annotations

import jax.numpy as jnp


def qprod(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product q1 ⊗ q2 (reference qProd.m)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def qconj(q: jnp.ndarray) -> jnp.ndarray:
    """Conjugate [w, -x, -y, -z] (reference qconj.m / q2qc.m)."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qnormalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Normalize to unit quaternion. Differentiable (its Jacobian is the
    reference's normJac, update.m:48-53, obtained by autodiff here)."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def q2r(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion → 3×3 rotation matrix, body→world (reference q2R.m)."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    ab, ac, ad = 2 * a * b, 2 * a * c, 2 * a * d
    bc, bd, cd = 2 * b * c, 2 * b * d, 2 * c * d
    row0 = jnp.stack([aa + bb - cc - dd, bc - ad, bd + ac], axis=-1)
    row1 = jnp.stack([bc + ad, aa - bb + cc - dd, cd - ab], axis=-1)
    row2 = jnp.stack([bd - ac, cd + ab, aa - bb - cc + dd], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def qrotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by unit quaternion q without forming R.

    Uses v' = v + 2*qv × (qv × v + w*v). Cheaper and fuses better than
    materializing the rotation matrix for single-vector use.
    """
    w = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def r2q(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix → unit quaternion (reference R2q.m).

    Branch-free Shepperd-style selection via jnp.where so it vmaps/jits:
    compute all four candidate constructions, pick the numerically safest.
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each valid when its pivot is the largest.
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-20))

    sw = safe_sqrt(1.0 + tr)  # 2w
    qw0 = jnp.stack(
        [0.5 * sw, (m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
         (m10 - m01) / (2 * sw)], axis=-1)

    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    qx0 = jnp.stack(
        [(m21 - m12) / (2 * sx), 0.5 * sx, (m01 + m10) / (2 * sx),
         (m02 + m20) / (2 * sx)], axis=-1)

    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    qy0 = jnp.stack(
        [(m02 - m20) / (2 * sy), (m01 + m10) / (2 * sy), 0.5 * sy,
         (m12 + m21) / (2 * sy)], axis=-1)

    sz = safe_sqrt(1.0 - m00 - m11 + m22)
    qz0 = jnp.stack(
        [(m10 - m01) / (2 * sz), (m02 + m20) / (2 * sz),
         (m12 + m21) / (2 * sz), 0.5 * sz], axis=-1)

    # Pivot selection.
    use_w = (tr > m00) & (tr > m11) & (tr > m22)
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)

    q = jnp.where(use_w[..., None], qw0,
                  jnp.where(use_x[..., None], qx0,
                            jnp.where(use_y[..., None], qy0, qz0)))
    # Canonical sign: w >= 0.
    q = jnp.where(q[..., :1] < 0, -q, q)
    return qnormalize(q)


def v2q(v: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector (axis*angle) → quaternion (reference v2q.m).

    Taylor-safe near zero so it is differentiable at v = 0.
    """
    angle2 = jnp.sum(v * v, axis=-1, keepdims=True)
    small = angle2 < 1e-12
    # "double-where": the non-Taylor branch must stay finite (incl. its
    # higher-order derivatives) even where it is unselected, or autodiff
    # (e.g. the IFT Hessians in vo/covariance.py) propagates NaNs.
    angle2_safe = jnp.where(small, 1.0, angle2)
    angle = jnp.sqrt(angle2_safe)
    # sin(a/2)/a with series fallback: 1/2 - a^2/48
    k = jnp.where(small, 0.5 - angle2 / 48.0, jnp.sin(angle / 2.0) / angle)
    w = jnp.where(small[..., 0], 1.0 - angle2[..., 0] / 8.0,
                  jnp.cos(angle[..., 0] / 2.0))
    return jnp.concatenate([w[..., None], k * v], axis=-1)


def q2v(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion → rotation vector (reference q2v.m). Taylor-safe."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # w >= 0 → angle in [0, pi]
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    s2 = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1)
    s = jnp.sqrt(jnp.maximum(s2, 1e-24))
    angle = 2.0 * jnp.arctan2(s, w)
    # angle / sin(angle/2) with series fallback near 0: 2 + s^2/3w... use 2/w approx
    k = jnp.where(s2 < 1e-12, 2.0 / jnp.maximum(w, 1e-12), angle / s)
    return k[..., None] * q[..., 1:]


def e2q(e: jnp.ndarray) -> jnp.ndarray:
    """Euler angles [roll(x), pitch(y), yaw(z)] → quaternion, ZYX order
    (reference e2q.m: q = qz ⊗ qy ⊗ qx)."""
    half = 0.5 * e
    cr, cp, cy = jnp.cos(half[..., 0]), jnp.cos(half[..., 1]), jnp.cos(half[..., 2])
    sr, sp, sy = jnp.sin(half[..., 0]), jnp.sin(half[..., 1]), jnp.sin(half[..., 2])
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def q2e(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion → Euler [roll, pitch, yaw] (reference q2e.m)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = jnp.arcsin(jnp.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)
