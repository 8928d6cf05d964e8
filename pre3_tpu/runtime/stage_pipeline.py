"""Multi-host / multi-device SLAM stage pipeline.

SURVEY §2.4 "pipeline over SLAM stages": the reference pipelines its
frontend and backend through DISK — SIFT_extract_save.m writes .mat files
that SIFT_match_save.m / mono_slam.m read back
(RANSAC_CALC_SAVE_SR4000.m:14-15). The device replacement has two
cooperating mechanisms:

1. **Sharded frontend** (`sharded_extract`): per-frame feature extraction
   is embarrassingly parallel, so a stacked frame chunk is sharded over a
   mesh axis (devices within a host over NVLink; hosts over the network —
   the same entry point covers both) and the extractor runs SPMD. The
   output features are produced replicated: XLA inserts the all-gather
   that replaces the reference's .mat-file handoff. On h hosts the
   frontend costs 1/h of its serial time per chunk.

2. **Chunked software pipeline** (`run_slam_pipelined`): the EKF backend
   is a strict recursion over frames (it cannot be batch-parallelized),
   so the pipeline overlaps STAGES, not frames: while the backend scans
   chunk c, the (sharded) frontend for chunk c+1 is already dispatched —
   JAX async dispatch queues both programs with no host block between
   them, so wall-clock per chunk is max(frontend/h, backend), not the
   sum.

The multi-process realization is exercised in tests/mp_worker.py (2-rank
Gloo run: frame axis across processes) and on the 8-device virtual mesh
in __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pre3_tpu.ekf.slam import (
    SlamConfig, SlamTrajectory, bootstrap_state, scan_steps,
)
from pre3_tpu.frontend.pipeline import (
    Features, extract_features, extract_features_sift,
)
from pre3_tpu.geometry.camera import Camera


def _extractor(name: str, kwargs: dict | None) -> Callable:
    kw = dict(kwargs or {})
    if name == "fast":
        return partial(extract_features, **kw)
    if name == "sift":
        return partial(extract_features_sift, **kw)
    raise ValueError(f"unknown extractor {name!r}")


@lru_cache(maxsize=32)
def _sharded_extract_fn(
    mesh: Mesh, extractor: str, kwargs_items: tuple, axis: str
) -> Callable:
    """Build (once per (mesh, extractor, kwargs, axis)) the jitted SPMD
    extraction program. The cache is load-bearing: a fresh closure per
    call would defeat jax.jit's executable cache and recompile the
    frontend on every chunk, blocking the host mid-pipeline."""
    fe = _extractor(extractor, dict(kwargs_items))
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    # The frame sharding is imposed INSIDE the program
    # (with_sharding_constraint) rather than via in_shardings: committed
    # replicated inputs (the multi-process case, where every host holds
    # the full chunk) cannot be resharded at the jit boundary, but XLA
    # may freely scatter + all-gather within the program.
    def body(i, x, c):
        i = jax.lax.with_sharding_constraint(i, shard)
        x = jax.lax.with_sharding_constraint(x, shard)
        c = jax.lax.with_sharding_constraint(c, shard)
        return jax.vmap(fe)(i, x, c)

    return jax.jit(body, out_shardings=repl)


def sharded_extract(
    mesh: Mesh,
    intensity: jnp.ndarray,  # [C, H, W] — C divisible by the axis size
    xyz: jnp.ndarray,  # [C, H, W, 3]
    conf: jnp.ndarray,  # [C, H, W]
    extractor: str = "sift",
    extractor_kwargs: dict | None = None,
    axis: str | None = None,
) -> Features:
    """Frame-sharded frontend: extraction SPMD over `axis`, features
    returned replicated (XLA all-gathers — the .mat handoff analog)."""
    axis = axis or mesh.axis_names[0]
    fn = _sharded_extract_fn(
        mesh, extractor,
        tuple(sorted((extractor_kwargs or {}).items())), axis,
    )
    return fn(intensity, xyz, conf)


def run_slam_pipelined(
    cam: Camera,
    intensity: jnp.ndarray,  # [F, H, W]
    xyz: jnp.ndarray,  # [F, H, W, 3]
    conf: jnp.ndarray,  # [F, H, W]
    key: jax.Array,
    mesh: Mesh | None = None,
    cfg: SlamConfig = SlamConfig(),
    n_landmarks: int = 64,
    chunk: int = 32,
    extractor: str = "sift",
    extractor_kwargs: dict | None = None,
) -> SlamTrajectory:
    """Chunked frontend→backend pipeline over a full sequence.

    Frames are processed in chunks of `chunk`: the frontend for chunk c+1
    is dispatched (sharded over `mesh` if given) before the backend scan
    of chunk c runs, so the two stages overlap on device. Results match
    run_slam() exactly when the PRNG layout matches (same split
    schedule)."""
    n_frames = intensity.shape[0]
    fe = _extractor(extractor, extractor_kwargs)
    jfe = jax.jit(lambda i, x, c: jax.vmap(fe)(i, x, c))
    axis_size = 1 if mesh is None else mesh.devices.size

    def fe_chunk(lo, hi):
        # sharded SPMD extraction when the chunk divides the mesh;
        # replicated for ragged chunks (frame 0, sequence tail)
        if mesh is not None and (hi - lo) % axis_size == 0:
            return sharded_extract(
                mesh, intensity[lo:hi], xyz[lo:hi], conf[lo:hi],
                extractor=extractor, extractor_kwargs=extractor_kwargs,
            )
        return jfe(intensity[lo:hi], xyz[lo:hi], conf[lo:hi])

    jscan = jax.jit(
        lambda st, prev, fs, ks, steps: scan_steps(
            cam, st, prev, fs, ks, steps, cfg
        ),
        donate_argnums=(0,),
        static_argnames=(),
    )

    # frame 0: bootstrap
    kboot, key = jax.random.split(key)
    keys = jax.random.split(key, n_frames - 1)
    bounds = [(lo, min(lo + chunk, n_frames))
              for lo in range(1, n_frames, chunk)]

    feats0 = fe_chunk(0, 1)
    first = jax.tree.map(lambda a: a[0], feats0)
    state = jax.jit(
        lambda f, k, x0: bootstrap_state(
            cam, f, k, cfg, n_landmarks, xyz_img=x0
        )
    )(first, kboot, xyz[0])
    q0_row = state.x[3:7][None]  # before jscan donates the state buffers

    # software pipeline: keep the NEXT chunk's frontend in flight
    pending = fe_chunk(*bounds[0]) if bounds else None
    prev_last = first
    outs = []
    for ci, (lo, hi) in enumerate(bounds):
        feats = pending
        if ci + 1 < len(bounds):
            pending = fe_chunk(*bounds[ci + 1])  # dispatch ahead
        state, out = jscan(
            state, prev_last, feats,
            keys[lo - 1:hi - 1],
            jnp.arange(lo, hi, dtype=jnp.int32),
        )
        prev_last = jax.tree.map(lambda a: a[-1], feats)
        outs.append(out)

    ts = jnp.concatenate([jnp.zeros((1, 3))] + [o[0] for o in outs])
    qs = jnp.concatenate([q0_row] + [o[1] for o in outs])
    stats = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                         *[o[2] for o in outs])
    records = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                           *[o[3] for o in outs])
    return SlamTrajectory(t=ts, q=qs, stats=stats, records=records)
