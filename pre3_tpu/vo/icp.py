"""Point-to-point ICP and generalized (plane-to-plane) ICP, batched and
fixed-iteration.

The reference cross-checks its RANSAC VO against ICP/GICP
(TestScripts/ICP_RANSAC{,2,3}.m, GICP_test_each_camera.m,
icp_with_init.m) — ICP is its verification oracle, not its estimator.
Same role here: jit-compatible ICP/GICP usable in tests and as VO
refiners.

Accelerator shape: nearest neighbors = one [N, M] distance matrix per iteration
(a matrix product via the ‖a‖² − 2a·b + ‖b‖² expansion), correspondence
trimming by distance threshold, Kabsch refit (ops/svd3) for point-to-
point / a batched 6×6 normal-equation solve for GICP, fixed iteration
count under lax.scan — no data-dependent control flow. GICP covariances
(Segal et al.: Σ = V·diag(ε,1,1)·Vᵀ from k-NN PCA) are computed once per
cloud with batched 3×3 eigh.

Convention matches vo/rigid.py: solves P ≈ R·Q + t (frame-2 → frame-1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pre3_tpu.vo.rigid import kabsch


class IcpResult(NamedTuple):
    r: jnp.ndarray  # [3, 3]
    t: jnp.ndarray  # [3]
    ok: jnp.ndarray  # [] bool
    rmse: jnp.ndarray  # [] inlier RMS distance
    n_inliers: jnp.ndarray  # [] int32


def _nn(a: jnp.ndarray, b: jnp.ndarray, valid_b: jnp.ndarray):
    """For each row of a [N,3], index+distance of nearest valid b [M,3]."""
    d2 = (
        jnp.sum(a * a, -1)[:, None]
        - 2.0 * a @ b.T
        + jnp.sum(b * b, -1)[None, :]
    )
    d2 = jnp.where(valid_b[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=-1)
    return idx, jnp.sqrt(jnp.maximum(jnp.take_along_axis(
        d2, idx[:, None], axis=-1)[:, 0], 0.0))


@partial(jax.jit, static_argnames=("iters",))
def icp(
    p: jnp.ndarray,  # [N, 3] target (frame 1)
    q: jnp.ndarray,  # [M, 3] source (frame 2)
    valid_p: jnp.ndarray,
    valid_q: jnp.ndarray,
    iters: int = 20,
    trim_dist: float = 0.25,
    r0: jnp.ndarray | None = None,
    t0: jnp.ndarray | None = None,
    min_inliers: int = 6,
) -> IcpResult:
    """Align q onto p. Optional initial guess (icp_with_init.m)."""
    r = jnp.eye(3) if r0 is None else r0
    t = jnp.zeros(3) if t0 is None else t0

    def body(carry, _):
        r, t = carry
        q_w = q @ r.T + t  # source moved into frame 1
        idx, dist = _nn(q_w, p, valid_p)
        w = (
            valid_q
            & (dist < trim_dist)
        ).astype(p.dtype)
        fit = kabsch(p[idx], q, w)
        r_new = jnp.where(fit.ok, fit.r, r)
        t_new = jnp.where(fit.ok, fit.t, t)
        return (r_new, t_new), None

    (r, t), _ = jax.lax.scan(body, (r, t), None, length=iters)

    q_w = q @ r.T + t
    idx, dist = _nn(q_w, p, valid_p)
    inl = valid_q & (dist < trim_dist)
    n_inl = jnp.sum(inl)
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(inl, dist * dist, 0.0))
        / jnp.maximum(n_inl, 1)
    )
    return IcpResult(
        r=r, t=t, ok=n_inl >= min_inliers, rmse=rmse,
        n_inliers=n_inl.astype(jnp.int32),
    )


# ---------------------------------------------------------------------------
# Generalized ICP (plane-to-plane, Segal et al.) — the GICP oracle of
# TestScripts/GICP_test_each_camera.m
# ---------------------------------------------------------------------------


def surface_covariances(
    pts: jnp.ndarray,  # [N, 3]
    valid: jnp.ndarray,  # [N] bool
    k: int = 8,
    eps: float = 1e-3,
) -> jnp.ndarray:
    """Per-point GICP covariance Σᵢ = V·diag(ε, 1, 1)·Vᵀ where V are the
    local k-NN PCA axes (ascending eigenvalue — the first axis is the
    surface normal). One [N, N] distance matmul + batched 3×3 eigh."""
    d2 = (
        jnp.sum(pts * pts, -1)[:, None]
        - 2.0 * pts @ pts.T
        + jnp.sum(pts * pts, -1)[None, :]
    )
    d2 = jnp.where(valid[None, :] & valid[:, None], d2, jnp.inf)
    _, idx = jax.lax.top_k(-d2, k)  # [N, k] nearest (incl. self)
    nb = pts[idx]  # [N, k, 3]
    mu = jnp.mean(nb, axis=1, keepdims=True)
    c = jnp.einsum("nka,nkb->nab", nb - mu, nb - mu) / k
    # regularize: degenerate neighborhoods fall back to isotropic
    c = c + 1e-9 * jnp.eye(3)
    _, v = jnp.linalg.eigh(c)  # ascending; v[:, :, 0] = normal
    d = jnp.array([eps, 1.0, 1.0])
    return jnp.einsum("nab,b,ncb->nac", v, d, v)  # [N, 3, 3]


def _so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues exp map [3] → [3, 3] (safe at 0)."""
    th = jnp.linalg.norm(w)
    th = jnp.maximum(th, 1e-12)
    k = w / th
    kx = jnp.array([
        [0.0, -k[2], k[1]],
        [k[2], 0.0, -k[0]],
        [-k[1], k[0], 0.0],
    ])
    return (
        jnp.eye(3) + jnp.sin(th) * kx + (1.0 - jnp.cos(th)) * (kx @ kx)
    )


@partial(jax.jit, static_argnames=("iters", "k_neighbors"))
def gicp(
    p: jnp.ndarray,  # [N, 3] target (frame 1)
    q: jnp.ndarray,  # [M, 3] source (frame 2)
    valid_p: jnp.ndarray,
    valid_q: jnp.ndarray,
    iters: int = 20,
    trim_dist: float = 0.25,
    r0: jnp.ndarray | None = None,
    t0: jnp.ndarray | None = None,
    min_inliers: int = 6,
    k_neighbors: int = 8,
    eps: float = 1e-3,
) -> IcpResult:
    """Plane-to-plane GICP: minimizes Σ dᵀ(Σp + RΣqRᵀ)⁻¹d over (R, t) by
    iterating NN correspondence + one Gauss-Newton step on the manifold
    (δ = [dt, dθ], batched 3×3 inverses, one 6×6 solve per iteration)."""
    cp = surface_covariances(p, valid_p, k=k_neighbors, eps=eps)
    cq = surface_covariances(q, valid_q, k=k_neighbors, eps=eps)
    r = jnp.eye(3) if r0 is None else r0
    t = jnp.zeros(3) if t0 is None else t0

    def body(carry, _):
        r, t = carry
        q_w = q @ r.T + t
        idx, dist = _nn(q_w, p, valid_p)
        w = (valid_q & (dist < trim_dist)).astype(p.dtype)  # [M]
        d = p[idx] - q_w  # [M, 3] residuals
        m = jnp.linalg.inv(
            cp[idx] + jnp.einsum("ab,nbc,dc->nad", r, cq, r)
            + 1e-9 * jnp.eye(3)
        )  # [M, 3, 3]
        m = m * w[:, None, None]
        # J_i = ∂(Rq+t)/∂[dt, dθ] = [I | −skew(q_w)] (left perturbation)
        sk = jnp.zeros((q.shape[0], 3, 3))
        sk = sk.at[:, 0, 1].set(-q_w[:, 2]).at[:, 0, 2].set(q_w[:, 1])
        sk = sk.at[:, 1, 0].set(q_w[:, 2]).at[:, 1, 2].set(-q_w[:, 0])
        sk = sk.at[:, 2, 0].set(-q_w[:, 1]).at[:, 2, 1].set(q_w[:, 0])
        jac = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3), sk.shape), -sk], axis=-1
        )  # [M, 3, 6]
        h = jnp.einsum("nia,nij,njb->ab", jac, m, jac) + 1e-8 * jnp.eye(6)
        g = jnp.einsum("nia,nij,nj->a", jac, m, d)
        delta = jnp.linalg.solve(h, g)  # [6]
        r_new = _so3_exp(delta[3:]) @ r
        t_new = t + delta[:3]
        ok = jnp.sum(w) >= 3
        return (
            jnp.where(ok, r_new, r), jnp.where(ok, t_new, t)
        ), None

    (r, t), _ = jax.lax.scan(body, (r, t), None, length=iters)

    q_w = q @ r.T + t
    idx, dist = _nn(q_w, p, valid_p)
    inl = valid_q & (dist < trim_dist)
    n_inl = jnp.sum(inl)
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(inl, dist * dist, 0.0))
        / jnp.maximum(n_inl, 1)
    )
    return IcpResult(
        r=r, t=t, ok=n_inl >= min_inliers, rmse=rmse,
        n_inliers=n_inl.astype(jnp.int32),
    )
