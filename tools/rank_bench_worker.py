"""One rank of the 2-process scaling measurement (tools/measure_2rank.py).

Times the two production sharded entry points on a FIXED total workload
(so efficiency = T1 / (N·TN) is the collective + runtime overhead, not a
work-size artifact):

  * distributed BA (parallel/ba_sharded.py) at the bench scale F=64
    keyframes, L=512 landmarks, WITH odometry-chain factors — the psum of
    the [6F, 6F] reduced system crosses the process boundary (Gloo here;
    NCCL between GPU hosts).
  * sharded frontend extraction (runtime/stage_pipeline.sharded_extract)
    of a 32-frame chunk — all-gather of the replicated features.

Each rank owns exactly ONE virtual CPU device and is core-pinned by the
parent, so per-rank compute resources are identical between the 1- and
2-rank configurations.

Usage: python tools/rank_bench_worker.py <pid> <nproc> <port> <outfile>
"""

import json
import os
import sys
import time


def main() -> None:
    pid, nproc, port, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)

    import numpy as np
    import jax.numpy as jnp

    from pre3_tpu.parallel.distributed import (
        global_landmark_mesh, initialize_distributed,
    )

    if nproc > 1:
        initialize_distributed(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc,
            process_id=pid,
        )
    assert jax.device_count() == nproc
    mesh = global_landmark_mesh(axis="lm")

    # --- distributed BA at bench scale (F=64, L=512, odo factors) -------
    from pre3_tpu.backend.ba import BaProblem
    from pre3_tpu.geometry.camera import project, sr4000_camera
    from pre3_tpu.parallel.ba_sharded import bundle_adjust_sharded

    cam = sr4000_camera()
    rng = np.random.default_rng(0)
    n_kf, n_lm = 64, 512
    points = np.stack(
        [rng.uniform(-1.5, 4.0, n_lm), rng.uniform(-1.0, 1.0, n_lm),
         rng.uniform(2.0, 4.0, n_lm)], axis=-1
    ).astype(np.float32)
    kf_t = np.zeros((n_kf, 3), np.float32)
    kf_t[:, 0] = 0.04 * np.arange(n_kf)
    kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_kf, 1))
    obs = np.zeros((n_kf, n_lm, 2), np.float32)
    obs_xyz = np.zeros((n_kf, n_lm, 3), np.float32)
    mask = np.zeros((n_kf, n_lm), bool)
    for f in range(n_kf):
        p_cam = points - kf_t[f]
        uv = np.asarray(project(cam, jnp.asarray(p_cam)))
        obs[f] = uv
        obs_xyz[f] = p_cam
        mask[f] = (
            (p_cam[:, 2] > 0.5)
            & (uv[:, 0] > 2) & (uv[:, 0] < 173)
            & (uv[:, 1] > 2) & (uv[:, 1] < 141)
        )
    kf_t_init = kf_t + rng.normal(scale=0.02, size=kf_t.shape).astype(
        np.float32
    )
    kf_t_init[0] = 0
    prob = BaProblem(
        obs_uv=jnp.asarray(obs), mask=jnp.asarray(mask),
        kf_t=jnp.asarray(kf_t_init), kf_q=jnp.asarray(kf_q),
        points=jnp.asarray(points), obs_xyz=jnp.asarray(obs_xyz),
        mask_xyz=jnp.asarray(mask),
        odo_t=jnp.asarray(kf_t[1:] - kf_t[:-1]),
        odo_q=jnp.asarray(kf_q[1:]),
        odo_w=jnp.ones(n_kf - 1, jnp.float32),
    )

    res = bundle_adjust_sharded(mesh, cam, prob, iters=10)  # compile+warm
    jax.block_until_ready(res.kf_t)
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        res = bundle_adjust_sharded(mesh, cam, prob, iters=10)
        jax.block_until_ready(res.kf_t)
    ba_s = (time.time() - t0) / reps

    # --- sharded frontend: 32-frame chunk over the process axis ---------
    from pre3_tpu.data.synthetic import render_sequence
    from pre3_tpu.runtime.stage_pipeline import sharded_extract

    frames, _, _ = render_sequence(n_frames=32, n_points=250, noise=0.004)
    intensity = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))
    kwargs = {"threshold": 0.05, "max_features": 128}

    from pre3_tpu.parallel.distributed import globalize_replicated

    with jax.set_mesh(mesh):
        gi = globalize_replicated(mesh, intensity)
        gx = globalize_replicated(mesh, xyz)
        gc = globalize_replicated(mesh, conf)
        out = sharded_extract(mesh, gi, gx, gc, extractor="fast",
                              extractor_kwargs=kwargs, axis="lm")
        jax.block_until_ready(out.uv)
        t0 = time.time()
        for _ in range(reps):
            out = sharded_extract(mesh, gi, gx, gc, extractor="fast",
                                  extractor_kwargs=kwargs, axis="lm")
            jax.block_until_ready(out.uv)
        fe_s = (time.time() - t0) / reps

    with open(outfile, "w") as fh:
        json.dump(
            {"rank": pid, "nproc": nproc, "ba_s": ba_s, "fe_s": fe_s,
             "ba_cost_final": float(res.cost[-1])}, fh,
        )


if __name__ == "__main__":
    main()
