"""Multi-process worker for tests/test_multiprocess.py.

Runs as one rank of an N-process CPU `jax.distributed` runtime (the
collective-backend target of SURVEY §2.4 — the reference has no
distribution at all; disk files are its only transport). Each rank owns
2 local virtual CPU devices, joins the coordinator, builds the production
`hybrid_mesh` (processes × local devices = ("lm", "hyp")), and runs the
two sharded production entry points on deterministic synthetic problems:

  * `bundle_adjust_sharded` — landmark shards split across *processes*
    (the "lm" axis), so the Schur-reduced camera-system psum crosses the
    process boundary (Gloo on CPU; NCCL between GPU hosts).
  * `sharded_ransac_rigid` — hypothesis batch split across the local
    "hyp" axis inside each process (NVLink between the GPUs of a host).

Results are dumped as JSON per rank; the parent test asserts cross-rank
agreement and equality with the single-process implementations.

Usage: python tests/mp_worker.py <pid> <nproc> <port> <outfile>
"""

import json
import os
import sys


def main() -> None:
    pid, nproc, port, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_threefry_partitionable", True)

    from pre3_tpu.parallel.distributed import initialize_distributed

    initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )

    import jax.numpy as jnp  # noqa: E402
    import numpy as np  # noqa: E402

    from pre3_tpu.parallel.ba_sharded import bundle_adjust_sharded
    from pre3_tpu.parallel.distributed import (
        globalize_replicated, hybrid_mesh,
    )
    from pre3_tpu.parallel.vo_sharded import sharded_ransac_rigid
    from tests.test_ba import CAM, make_ba_problem
    from tests.test_vo import make_rigid_problem

    assert jax.process_count() == nproc
    assert len(jax.devices()) == 2 * nproc

    mesh = hybrid_mesh()
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "lm": nproc, "hyp": 2,
    }

    # --- distributed BA: landmark shards across processes, WITH the
    # keyframe odometry-chain factors (feature parity with backend.ba) ---
    from pre3_tpu.geometry.quaternion import qconj, qprod, qrotate

    prob, (gt_t, gt_q, _) = make_ba_problem(
        n_kf=4, n_lm=24, seed=21, t_noise=0.03, p_noise=0.03
    )
    odo_t = jnp.stack([
        qrotate(qconj(gt_q[i]), gt_t[i + 1] - gt_t[i]) for i in range(3)
    ])
    odo_q = jnp.stack(
        [qprod(qconj(gt_q[i]), gt_q[i + 1]) for i in range(3)]
    )
    prob = prob._replace(
        odo_t=odo_t, odo_q=odo_q, odo_w=jnp.ones(3, jnp.float32)
    )
    ba = bundle_adjust_sharded(mesh, CAM, prob, iters=8, axis="lm")

    # --- hypothesis-sharded RANSAC across local devices ------------------
    p1, p2, r_gt, t_gt, _ = make_rigid_problem(
        n=96, noise=0.003, outlier_frac=0.3, seed=11
    )
    g = lambda x: globalize_replicated(mesh, x)

    @jax.jit
    def run_ransac(p1, p2, valid):
        return sharded_ransac_rigid(
            mesh, jax.random.PRNGKey(0), p1, p2, valid, batch=512,
            support_threshold=0.001,
        )

    with jax.set_mesh(mesh):
        res = run_ransac(g(p1), g(p2), g(np.ones(96, bool)))

    # --- stage pipeline: frame-sharded frontend feeds the backend -------
    # (SURVEY §2.4 pipeline-over-stages row: frontend work for a frame
    # chunk is split across the processes — the network between hosts — and the
    # replicated feature output feeds each rank's backend scan.)
    from pre3_tpu.data.synthetic import render_sequence
    from pre3_tpu.ekf.slam import SlamConfig, run_slam
    from pre3_tpu.geometry.camera import sr4000_camera
    from pre3_tpu.parallel.distributed import global_landmark_mesh
    from pre3_tpu.runtime.stage_pipeline import sharded_extract

    frames, _, _ = render_sequence(n_frames=8, n_points=250, noise=0.004)
    fmesh = global_landmark_mesh(axis="frame")
    g2 = lambda x: globalize_replicated(fmesh, x)
    intensity = g2(np.stack([f.intensity for f in frames]))
    xyzf = g2(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conff = g2(np.stack([f.confidence for f in frames]))
    feats_g = sharded_extract(
        fmesh, intensity, xyzf, conff, extractor="fast",
        extractor_kwargs={"threshold": 0.05, "max_features": 96},
    )
    # replicated output → every rank holds the full feature set
    feats_local = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), feats_g)
    traj = run_slam(
        sr4000_camera(), feats_local, jax.random.PRNGKey(5),
        cfg=SlamConfig(match_ratio=1.3), n_landmarks=24,
    )

    json.dump(
        {
            "pid": pid,
            "pipeline_t": np.asarray(traj.t).tolist(),
            "ba_kf_t": np.asarray(ba.kf_t).tolist(),
            "ba_points": np.asarray(ba.points).tolist(),
            "ba_cost_final": float(ba.cost[-1]),
            "ransac_ok": bool(res.ok),
            "ransac_r": np.asarray(res.r).tolist(),
            "ransac_t": np.asarray(res.t).tolist(),
            "ransac_n_inliers": int(res.n_inliers),
        },
        open(outfile, "w"),
    )


if __name__ == "__main__":
    main()
