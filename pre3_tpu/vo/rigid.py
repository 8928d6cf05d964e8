"""Rigid-motion estimation from matched 3D point sets.

Re-design of the reference's alignment kernels
(mex_files/RANSAC_CALCULATION/find_transform_matrix.m — Kabsch/Arun SVD
with reflection handling — and absoluteOrientationQuaternion.m:28-127 —
Horn's quaternion method). Both are batched (vmap over thousands of RANSAC
hypotheses) and static-shaped with per-point weights so fixed-capacity
masked point sets flow straight through.

Convention (matches the reference): given point sets P (frame 1) and
Q (frame 2), solve  P ≈ R·Q + t  — the transform taking frame-2 coordinates
into frame 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pre3_tpu.geometry.quaternion import q2r
from pre3_tpu.ops.svd3 import svd3


class RigidFit(NamedTuple):
    r: jnp.ndarray  # [..., 3, 3]
    t: jnp.ndarray  # [..., 3]
    ok: jnp.ndarray  # [...] bool — well-conditioned solution
    rmse: jnp.ndarray  # [...] weighted RMS residual


def _weighted_stats(p, q, w):
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-12)
    cp = jnp.sum(p * wn[..., None], axis=-2)
    cq = jnp.sum(q * wn[..., None], axis=-2)
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    # cross-covariance H = Σ w·qc·pcᵀ  (maps frame-2 deviations to frame-1)
    h = jnp.einsum("...n,...ni,...nj->...ij", wn, qc, pc)
    return cp, cq, pc, qc, h


def kabsch(
    p: jnp.ndarray, q: jnp.ndarray, w: jnp.ndarray | None = None,
    cond_eps: float = 1e-2,
) -> RigidFit:
    """Weighted Kabsch/Arun: least-squares R, t minimizing Σw‖p − (Rq+t)‖².

    p, q: [..., N, 3]; w: [..., N] nonnegative weights (mask). Reflection is
    corrected by flipping the smallest singular direction (the standard
    det-based fix, replacing find_transform_matrix.m:25-37's branching —
    branch-free for vmap/jit). `ok` is False when the point set is
    degenerate (rank < 2 ⇒ rotation unobservable).
    """
    if w is None:
        w = jnp.ones(p.shape[:-1], p.dtype)
    cp, cq, pc, qc, h = _weighted_stats(p, q, w)
    # closed-form 3×3 SVD (ops/svd3.py): jnp.linalg.svd lowers to an
    # iterative solver; its cost on an H100 is not measured (ROADMAP
    # Design 3)
    u, s, vt = svd3(h)
    # R = Vᵀᵀ... we need R s.t. pc ≈ R qc: R = (V) diag(1,1,d) (Uᵀ) with
    # H = U S Vᵀ built as qc→pc: R = Vᵀᵀ? Derivation: maximize tr(R H) with
    # H = Σ qc pcᵀ ⇒ R = V D Uᵀ where D fixes the determinant.
    det = jnp.linalg.det(jnp.einsum("...ij,...kj->...ik", vt, u))  # det(VUᵀ)
    d = jnp.stack(
        [jnp.ones_like(det), jnp.ones_like(det), det], axis=-1
    )  # [..., 3]
    r = jnp.einsum("...ji,...j,...jk->...ik", vt, d, jnp.swapaxes(u, -1, -2))
    t = cp - jnp.einsum("...ij,...j->...i", r, cq)
    resid = p - (jnp.einsum("...ij,...nj->...ni", r, q) + t[..., None, :])
    wsum = jnp.maximum(jnp.sum(w, axis=-1), 1e-12)
    rmse = jnp.sqrt(
        jnp.sum(w * jnp.sum(resid * resid, axis=-1), axis=-1) / wsum
    )
    # Conditioning: need at least rank 2 (two non-tiny singular values).
    # cond_eps matches the f32 accuracy floor of σ₂ computed via AᵀA
    # (~√eps·σ₁); genuine minimal samples have σ₂/σ₁ well above this.
    ok = (s[..., 1] > cond_eps * jnp.maximum(s[..., 0], 1e-20)) & (
        jnp.sum(w > 0, axis=-1) >= 3
    )
    return RigidFit(r=r, t=t, ok=ok, rmse=rmse)


def horn_quaternion(
    p: jnp.ndarray, q: jnp.ndarray, w: jnp.ndarray | None = None
) -> RigidFit:
    """Horn's absolute-orientation quaternion method
    (absoluteOrientationQuaternion.m): build the 4×4 N matrix from the
    cross-covariance, take its dominant eigenvector as the rotation
    quaternion. Batched via jnp.linalg.eigh on [..., 4, 4].

    Unlike SVD-Kabsch this can never return a reflection — useful as a
    cross-check oracle and for covariance analysis.
    """
    if w is None:
        w = jnp.ones(p.shape[:-1], p.dtype)
    cp, cq, pc, qc, h = _weighted_stats(p, q, w)
    # h = Σ w·qc·pcᵀ is Horn's S matrix for the q→p rotation.
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    tr = sxx + syy + szz
    row0 = jnp.stack([tr, syz - szy, szx - sxz, sxy - syx], axis=-1)
    row1 = jnp.stack(
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], axis=-1
    )
    row2 = jnp.stack(
        [szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], axis=-1
    )
    row3 = jnp.stack(
        [sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], axis=-1
    )
    n = jnp.stack([row0, row1, row2, row3], axis=-2)
    evals, evecs = jnp.linalg.eigh(n)
    qrot = evecs[..., :, -1]  # dominant eigenvector
    qrot = jnp.where(qrot[..., :1] < 0, -qrot, qrot)
    r = q2r(qrot)
    t = cp - jnp.einsum("...ij,...j->...i", r, cq)
    resid = p - (jnp.einsum("...ij,...nj->...ni", r, q) + t[..., None, :])
    wsum = jnp.maximum(jnp.sum(w, axis=-1), 1e-12)
    rmse = jnp.sqrt(
        jnp.sum(w * jnp.sum(resid * resid, axis=-1), axis=-1) / wsum
    )
    gap = evals[..., -1] - evals[..., -2]
    ok = (gap > 1e-9) & (jnp.sum(w > 0, axis=-1) >= 3)
    return RigidFit(r=r, t=t, ok=ok, rmse=rmse)
