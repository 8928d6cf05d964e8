"""Pose-sharded BA at scale (VERDICT r4 #4): wall-clock vs the
landmark-sharded path at F ∈ {128, 256, 512, 1024} keyframes, 8 blocks,
on (a) a long window-local corridor and (b) an out-and-back multi-loop
trajectory whose revisit observations violate window locality (they
route to the replicated global factor group — dropped_obs must be 0).

The landmark-sharded path materializes + psums the dense [6F, 6F]
reduced camera system every GN iteration (O(F²·L) build, O(F³) solve);
the pose-sharded path is block-banded + O(F) gathers. This measures the
crossover with numbers. Runs on the 8-device virtual CPU mesh (the only
multi-device runtime here); both paths run the same mesh, same problem,
same iteration count, so the comparison is apples-to-apples even though
absolute times are CPU times.

Usage: python tools/measure_pose_scale.py [max_F]
"""

import sys
import time

import numpy as np


def build_corridor(n_kf, lm_per_kf=4, span=2, seed=0, loop=False,
                   revisit_frac=0.1):
    """Synthetic corridor BA problem (numpy). loop=True: out-and-back —
    the second half revisits the first half's viewpoints; revisit_frac
    of the landmarks are additionally observed from the OTHER pass
    (long-baseline, non-window-local → routed to the global factor
    group). Sparse revisits mirror reality: re-acquisition across a loop
    touches a fraction of the map, not all of it."""
    import jax.numpy as jnp

    from pre3_tpu.backend.ba import BaProblem
    from pre3_tpu.geometry.camera import project, sr4000_camera

    cam = sr4000_camera()
    rng = np.random.default_rng(seed)
    kf_t = np.zeros((n_kf, 3), np.float32)
    if loop:
        half = n_kf // 2
        xs = np.concatenate([
            0.12 * np.arange(half),
            0.12 * (half - 1 - np.arange(n_kf - half)),
        ])
        kf_t[:, 0] = xs
        leg = np.arange(n_kf) >= half  # False=outbound, True=return
    else:
        kf_t[:, 0] = 0.12 * np.arange(n_kf)
        leg = np.zeros(n_kf, bool)
    kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_kf, 1))

    pts, obs, oxyz, msk = [], [], [], []
    for c in range(n_kf):
        for _ in range(lm_per_kf // (2 if loop else 1) or 1):
            p = np.array([
                kf_t[c, 0] + rng.uniform(-0.4, 0.4),
                rng.uniform(-0.8, 0.8), rng.uniform(2.0, 3.5),
            ], np.float32)
            pts.append(p)
            row_uv = np.zeros((n_kf, 2), np.float32)
            row_xyz = np.zeros((n_kf, 3), np.float32)
            row_m = np.zeros(n_kf, bool)
            if loop:
                near = np.abs(kf_t[:, 0] - p[0]) < 0.3
                cand = near & (leg == leg[c])
                if rng.uniform() < revisit_frac:  # sparse revisit
                    cand = near
                cand = np.nonzero(cand)[0]
            else:
                cand = range(max(0, c - 2), min(n_kf, c + 3))
            for fkf in cand:
                p_cam = p - kf_t[fkf]
                uv = np.asarray(project(cam, jnp.asarray(p_cam)))
                if 2 < uv[0] < 173 and 2 < uv[1] < 141:
                    row_uv[fkf], row_xyz[fkf], row_m[fkf] = uv, p_cam, True
            obs.append(row_uv)
            oxyz.append(row_xyz)
            msk.append(row_m)
    points = np.stack(pts)
    mask = np.stack(msk, axis=1)
    keep = mask.sum(0) >= 2
    obs_uv = np.stack(obs, axis=1)[:, keep]
    obs_xyz = np.stack(oxyz, axis=1)[:, keep]
    mask = mask[:, keep]
    points = points[keep]
    kf_t_init = kf_t + rng.normal(scale=0.02, size=kf_t.shape).astype(
        np.float32
    )
    kf_t_init[0] = kf_t[0]
    prob = BaProblem(
        obs_uv=jnp.asarray(obs_uv), mask=jnp.asarray(mask),
        kf_t=jnp.asarray(kf_t_init), kf_q=jnp.asarray(kf_q),
        points=jnp.asarray(
            points + rng.normal(scale=0.02, size=points.shape
                                ).astype(np.float32)
        ),
        obs_xyz=jnp.asarray(obs_xyz), mask_xyz=jnp.asarray(mask),
        odo_t=jnp.asarray(kf_t[1:] - kf_t[:-1]),
        odo_q=jnp.asarray(kf_q[1:]),
        odo_w=jnp.ones(n_kf - 1, jnp.float32),
    )
    return prob, kf_t


def main(max_f=1024):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

    from pre3_tpu.parallel.ba_pose_sharded import bundle_adjust_pose_sharded
    from pre3_tpu.parallel.ba_sharded import bundle_adjust_sharded
    from pre3_tpu.parallel.mesh import make_mesh
    from pre3_tpu.geometry.camera import sr4000_camera

    cam = sr4000_camera()
    iters = 5
    for loop in (False, True):
        tag = "multi-loop" if loop else "corridor"
        for n_kf in (128, 256, 512, 1024):
            if n_kf > max_f:
                continue
            prob, gt_t = build_corridor(n_kf, loop=loop)
            f, l = prob.mask.shape
            n_obs = int(np.asarray(prob.mask).sum())

            mesh_p = make_mesh(8, axis="blk")
            t0 = time.time()
            res_p, rep = bundle_adjust_pose_sharded(
                mesh_p, cam, prob, iters=iters, cg_iters=96, sep=3
            )
            p_compile = time.time() - t0
            t0 = time.time()
            res_p, rep = bundle_adjust_pose_sharded(
                mesh_p, cam, prob, iters=iters, cg_iters=96, sep=3
            )
            p_dt = time.time() - t0
            err_p = float(np.abs(
                np.asarray(res_p.kf_t) - gt_t
            ).max())
            assert rep["dropped_obs"] == 0, rep
            print(
                f"[{tag}] F={n_kf:5d} L={l:5d} obs={n_obs:6d} "
                f"global_lm={rep['global_lm']:4d} | pose-sharded "
                f"{p_dt:7.2f}s ({iters} LM iters, compile "
                f"{p_compile - p_dt:.0f}s) max|t-gt| {err_p:.4f}",
                flush=True,
            )

            # landmark-sharded comparison — skipped where the dense
            # [6F,6F] build is CPU-infeasible (the F²·L linearization
            # alone is ~2.4e12 flops at F=512 on this 2-core host)
            if n_kf <= 256:
                mesh_l = make_mesh(8, axis="lm")
                t0 = time.time()
                res_l = bundle_adjust_sharded(
                    mesh_l, cam, prob, iters=iters
                )
                l_compile = time.time() - t0
                t0 = time.time()
                res_l = bundle_adjust_sharded(
                    mesh_l, cam, prob, iters=iters
                )
                l_dt = time.time() - t0
                err_l = float(np.abs(
                    np.asarray(res_l.kf_t) - gt_t
                ).max())
                print(
                    f"[{tag}] F={n_kf:5d} {'':24s} | lm-sharded   "
                    f"{l_dt:7.2f}s ({iters} LM iters, compile "
                    f"{l_compile - l_dt:.0f}s) max|t-gt| {err_l:.4f} "
                    f"| ratio {l_dt / p_dt:.2f}x", flush=True,
                )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
