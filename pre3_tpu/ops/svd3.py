"""Closed-form batched 3×3 SVD for rigid alignment.

XLA lowers jnp.linalg.svd to an iterative algorithm with data-dependent
loops, for each of the thousands of tiny [3, 3] factorizations per RANSAC
batch (SURVEY §7.3 "3×3 SVD at scale"). This module computes the SVD in
closed form instead (its cost against the library SVD on an H100 is not
measured; ROADMAP Design 3):

  1. eigenvalues of the symmetric AᵀA via the trigonometric solution of
     the characteristic cubic (branch-free),
  2. eigenvectors via cross products of pivot rows (pivot chosen by
     magnitude with jnp.where — no control flow),
  3. U = A V S⁻¹ with orthogonal completion by cross product for
     rank-deficient inputs (handles the reference's coplanar/collinear
     degeneracies, find_transform_matrix.m:25-37).

Everything is elementwise arithmetic: vmaps and fuses cleanly.
Accuracy is ~1e-6 relative for well-conditioned inputs — ample for RANSAC
hypothesis fitting (the final refit can afford it too; verified against
jnp.linalg.svd in tests/test_svd3.py).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def sym3_eigvals(a: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric [..., 3, 3], descending, via the
    trigonometric closed form (stable for repeated roots)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    )
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, _EPS))
    # det(B)/2 with B = (A - qI)
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = detb / (2.0 * p * p * p)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return jnp.stack([e1, e2, e3], axis=-1)


def _eigvec(a: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of symmetric [..., 3, 3] for eigenvalue lam via the
    largest cross product of rows of (A − λI) (branch-free pivoting)."""
    b = a - lam[..., None, None] * jnp.eye(3, dtype=a.dtype)
    r0, r1, r2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where(
        (n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
        jnp.where((n02 >= n12)[..., None], c02, c12),
    )
    nbest = jnp.maximum(n01, jnp.maximum(n02, n12))
    # Degenerate (repeated eigenvalue / zero matrix): fall back to e_x; the
    # caller re-orthogonalizes, so any unit vector is acceptable there.
    ex = jnp.zeros_like(best).at[..., 0].set(1.0)
    ok = nbest > _EPS
    v = jnp.where(ok[..., None], best, ex)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def svd3(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closed-form SVD of [..., 3, 3]: returns (u, s, vt) with
    a = u @ diag(s) @ vt, s descending, u/v orthogonal (possibly improper —
    same contract as jnp.linalg.svd)."""
    # scale-normalize so the internal epsilons are relative, not absolute
    anorm = jnp.sqrt(
        jnp.maximum(jnp.sum(a * a, axis=(-2, -1), keepdims=True), _EPS)
    )
    scale = anorm[..., 0, 0]
    a = a / anorm
    ata = jnp.einsum("...ji,...jk->...ik", a, a)
    lam = sym3_eigvals(ata)
    s = jnp.sqrt(jnp.maximum(lam, 0.0))

    v0 = _eigvec(ata, lam[..., 0])
    v1 = _eigvec(ata, lam[..., 1])
    # enforce orthogonality (repeated eigenvalues make separate cross
    # products unreliable): Gram-Schmidt v1 ⊥ v0, v2 = v0 × v1
    v1 = v1 - jnp.sum(v1 * v0, axis=-1, keepdims=True) * v0
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    # if v1 collapsed (λ0 ≈ λ1: the cross-product eigvec landed on v0),
    # recover a vector in the λ1-eigenPLANE: the plane is the null space
    # of B1 = A − λ1 I, whose dominant row is ⊥ to it, so
    # v1 = normalize(r_max × v0) stays in the eigenplane and ⊥ v0.
    b1 = ata - lam[..., 1:2, None] * jnp.eye(3, dtype=a.dtype)
    row_norms = jnp.sum(b1 * b1, axis=-1)  # [..., 3]
    rmax_idx = jnp.argmax(row_norms, axis=-1)
    r_max = jnp.take_along_axis(
        b1, rmax_idx[..., None, None].repeat(3, -1), axis=-2
    )[..., 0, :]
    alt = jnp.cross(r_max, v0)
    alt_n = jnp.linalg.norm(alt, axis=-1, keepdims=True)
    # triple eigenvalue (A ∝ I): any orthogonal completion works
    alt2 = jnp.cross(v0, jnp.zeros_like(v0).at[..., 0].set(1.0))
    alt3 = jnp.cross(v0, jnp.zeros_like(v0).at[..., 1].set(1.0))
    alt2 = jnp.where(
        jnp.linalg.norm(alt2, axis=-1, keepdims=True) > 1e-6, alt2, alt3
    )
    alt = jnp.where(alt_n > 1e-6 * jnp.sqrt(row_norms.max(-1))[..., None],
                    alt, alt2)
    alt = alt / jnp.linalg.norm(alt, axis=-1, keepdims=True)
    v1 = jnp.where(n1 > 1e-4, v1 / jnp.maximum(n1, _EPS), alt)
    v2 = jnp.cross(v0, v1)
    v = jnp.stack([v0, v1, v2], axis=-1)  # columns

    # U columns: u_i = A v_i / s_i, with orthogonal completion when s_i ≈ 0
    av = jnp.einsum("...ij,...jk->...ik", a, v)
    u0 = av[..., 0]
    u0n = jnp.linalg.norm(u0, axis=-1, keepdims=True)
    u0 = jnp.where(
        u0n > 1e-9, u0 / jnp.maximum(u0n, _EPS),
        jnp.zeros_like(u0).at[..., 0].set(1.0),
    )
    u1 = av[..., 1]
    u1 = u1 - jnp.sum(u1 * u0, axis=-1, keepdims=True) * u0
    u1n = jnp.linalg.norm(u1, axis=-1, keepdims=True)
    altu = jnp.cross(u0, jnp.zeros_like(u0).at[..., 0].set(1.0))
    altu_n = jnp.linalg.norm(altu, axis=-1, keepdims=True)
    altu2 = jnp.cross(u0, jnp.zeros_like(u0).at[..., 1].set(1.0))
    altu = jnp.where(altu_n > 1e-6, altu, altu2)
    altu = altu / jnp.linalg.norm(altu, axis=-1, keepdims=True)
    u1 = jnp.where(u1n > 1e-9, u1 / jnp.maximum(u1n, _EPS), altu)
    u2raw = av[..., 2]
    u2raw = (
        u2raw
        - jnp.sum(u2raw * u0, axis=-1, keepdims=True) * u0
        - jnp.sum(u2raw * u1, axis=-1, keepdims=True) * u1
    )
    u2n = jnp.linalg.norm(u2raw, axis=-1, keepdims=True)
    u2 = jnp.where(
        u2n > 1e-9, u2raw / jnp.maximum(u2n, _EPS), jnp.cross(u0, u1)
    )
    u = jnp.stack([u0, u1, u2], axis=-1)
    return u, s * scale[..., None], jnp.swapaxes(v, -1, -2)
