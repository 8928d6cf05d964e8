"""Online streaming SLAM driver: ONE device dispatch per frame.

The reference's online loop (mono_slam.m:113-435) is strictly serial:
decode → SIFT → match → EKF per frame, with disk .mat files as the only
stage handoff (RANSAC_CALC_SAVE_SR4000.m:14-15). This driver is the
device-resident replacement for that whole arrangement:

  * the ENTIRE per-frame pipeline — feature extraction, VO, EKF predict/
    match/RANSAC/update, map management, key chaining, step counter — is
    one fused jitted program. The host performs exactly one dispatch per
    frame and zero per-frame host→device scalar uploads (the step counter
    and PRNG key live in the device-resident carry);
  * the carry (EkfState, key, step, previous-frame features) is donated,
    so the [D, D] covariance and feature buffers are reused in place;
  * JAX async dispatch queues frame k+1 while frame k computes: the host
    never blocks unless a pose is actually read, so throughput is
    max(device step time, host dispatch overhead) — not their sum, and
    not a host round-trip per frame;
  * decode / host IO can additionally run in a background thread pool
    (run(), prefetch depth N), overlapping disk + numpy work.

Snapshots (utils/checkpoint.py) every `snapshot_every` steps reproduce the
DataSnapshots resume tier (mono_slam.m:57-62,251-264).
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.ekf.map_management import add_features
from pre3_tpu.ekf.measurement import predict_measurements
from pre3_tpu.ekf.slam import SlamConfig, StepStats, scan_steps, slam_step
from pre3_tpu.ekf.state import EkfState, init_state
from pre3_tpu.frontend.pipeline import (
    Features, extract_features, extract_features_sift,
)
from pre3_tpu.geometry.camera import Camera
from pre3_tpu.utils.profiling import StageTimer


class StepResult(NamedTuple):
    step: int
    t: jnp.ndarray  # [3] device array (lazy)
    q: jnp.ndarray  # [4]
    stats: StepStats


class OnlineSlam:
    """Feed frames one at a time; poses stream out.

    >>> slam = OnlineSlam(cam)
    >>> for fr in frames:
    ...     res = slam.process(fr.intensity, fr.xyz, fr.confidence)
    """

    def __init__(
        self,
        cam: Camera,
        cfg: SlamConfig = SlamConfig(),
        n_landmarks: int = 64,
        extractor: str = "fast",
        extractor_kwargs: dict[str, Any] | None = None,
        key: jax.Array | None = None,
        snapshot_dir: str | None = None,
        snapshot_every: int = 0,
        timer: StageTimer | None = None,
        sync_timing: bool = False,
    ) -> None:
        self.cam = cam
        self.cfg = cfg
        self.n_landmarks = n_landmarks
        self.timer = timer or StageTimer()
        self.sync = sync_timing
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self._key0 = key if key is not None else jax.random.PRNGKey(0)
        ek = dict(extractor_kwargs or {})
        if extractor == "fast":
            self._featurize = partial(extract_features, **ek)
        elif extractor == "sift":
            self._featurize = partial(extract_features_sift, **ek)
        else:
            raise ValueError(f"unknown extractor {extractor!r}")
        needs_image = cfg.matcher == "ncc_warp"
        # the periodic floor-plane heading update needs the raw xyz image
        # even on the descriptor-matcher path
        needs_xyz = needs_image or cfg.heading_update_every > 0

        def fused(state, key, step_i, prev, intensity, xyz, conf):
            """Whole per-frame pipeline as one program. All recurrent
            quantities (key split, step increment, pose slice) stay on
            device — each eager equivalent would cost a dispatch."""
            img = jnp.asarray(intensity, jnp.float32)
            xyzj = jnp.asarray(xyz, jnp.float32)
            feats = self._featurize(img, xyzj, jnp.asarray(conf, jnp.float32))
            key, sub = jax.random.split(key)
            state, (stats, record) = slam_step(
                cam, state, feats, prev, step_i, sub, cfg,
                image=img if needs_image else None,
                xyz_img=xyzj if needs_xyz else None,
            )
            return (state, key, step_i + 1, feats,
                    state.x[0:3], state.x[3:7], stats, record)

        # Donating the carry aliases its input/output buffers so the
        # [D, D] covariance and the feature arrays are reused every step
        # instead of reallocated.
        self.fused_fn = fused  # raw (unjitted) — the flagship step program
        self._jfused = jax.jit(fused, donate_argnums=(0, 1, 2, 3))

        def boot(key, intensity, xyz, conf):
            img = jnp.asarray(intensity, jnp.float32)
            xyzj = jnp.asarray(xyz, jnp.float32)
            feats = self._featurize(
                img, xyzj, jnp.asarray(conf, jnp.float32)
            )
            q0 = None
            if cfg.initial_orientation:
                # plane-fit gravity prior from frame 0
                # (initialize_x_and_p.m:35-37); fold_in keeps the main
                # key stream identical to the flag-off run
                from pre3_tpu.backend.plane_fit import (
                    initial_orientation_from_floor,
                )

                q0, _ok = initial_orientation_from_floor(
                    jax.random.fold_in(key, 3), jnp.nan_to_num(xyzj)
                )
            state = init_state(
                n_landmarks=n_landmarks, desc_dim=feats.desc.shape[-1],
                q0=q0,
            )
            key, sub = jax.random.split(key)
            obs0 = predict_measurements(cam, state, std_z=cfg.std_z)
            state = add_features(
                cam, state, feats, obs0.h, jnp.asarray(0, jnp.int32),
                n_measured=jnp.asarray(0, jnp.int32),
                max_adds=cfg.max_adds * 4,
                min_measured=cfg.min_measured,
                std_pxl=cfg.std_z,
                depth_range_quadratic=cfg.depth_range_quadratic,
                depth_range_d0=cfg.depth_range_d0,
                image=img if needs_image else None,
                sampling=cfg.init_sampling, key=sub,
            )
            return (state, key, jnp.asarray(1, jnp.int32), feats,
                    state.x[0:3], state.x[3:7])

        # jitted: the eager form dispatches thousands of primitives
        # one-by-one
        self.boot_fn = boot  # raw (unjitted)
        self._jboot = jax.jit(boot)

        def fused_chunk(state, key, step_i, prev, intensity, xyz, conf):
            """C frames in ONE dispatch: vmapped frontend + on-device
            scan over the EKF steps. Per-execute overhead is paid once
            per chunk instead of per frame (measured ~35 ms/execute for
            the single-frame program vs ~5 ms/frame of actual compute on
            a remote chip), trading C frames of latency for near-scan
            throughput. Key schedule differs from chunk=1 (one split per
            chunk), so chunked and per-frame runs are each deterministic
            but not bit-identical to each other."""
            c = intensity.shape[0]
            img = jnp.asarray(intensity, jnp.float32)
            xyzj = jnp.asarray(xyz, jnp.float32)
            feats = jax.vmap(self._featurize)(
                img, xyzj, jnp.asarray(conf, jnp.float32)
            )
            keys = jax.random.split(key, c + 1)
            state, (ts, qs, stats, recs) = scan_steps(
                cam, state, prev, feats, keys[1:],
                step_i + jnp.arange(c, dtype=jnp.int32), cfg,
                images=img if needs_image else None,
                xyz_imgs=xyzj if needs_xyz else None,
            )
            last = jax.tree.map(lambda a: a[-1], feats)
            return (state, keys[0], step_i + c, last, ts, qs, stats, recs)

        self._jchunk = jax.jit(fused_chunk, donate_argnums=(0, 1, 2, 3))
        # carry = (EkfState, key, step int32 [], prev Features) on device
        self._carry: tuple | None = None
        self.step_i = 0
        self.results: list[StepResult] = []
        # per-step StepRecord pytrees (chunk entries carry a leading C
        # axis) — the BA/smoother input stream the offline scan also emits
        self._records: list = []

    @property
    def state(self) -> EkfState | None:
        return None if self._carry is None else self._carry[0]

    # -- streaming ----------------------------------------------------------

    def process(self, intensity, xyz, confidence) -> StepResult:
        """Feed one frame. Returns lazily-valued device pose arrays —
        reading them syncs; not reading them keeps the pipe full."""
        with self.timer.stage("dispatch"):
            if self._carry is None:
                state, key, step, feats, t, q = self._jboot(
                    self._key0, intensity, xyz, confidence
                )
                self._carry = (state, key, step, feats)
                res = StepResult(0, t, q, None)
            else:
                if self._carry[3] is None:
                    raise RuntimeError(
                        "previous-frame features are unset — call prime() "
                        "after resume() before streaming frames"
                    )
                state, key, step, feats, t, q, stats, rec = self._jfused(
                    *self._carry, intensity, xyz, confidence
                )
                self._carry = (state, key, step, feats)
                self._records.append(rec)
                res = StepResult(self.step_i, t, q, stats)
            if self.sync:
                jax.block_until_ready(res.t)
        self.step_i += 1
        self.results.append(res)
        if (
            self.snapshot_dir
            and self.snapshot_every
            and self.step_i % self.snapshot_every == 0
        ):
            self.snapshot()
        return res

    def process_chunk(self, intensity, xyz, confidence) -> list[StepResult]:
        """Feed C frames as one dispatch (arrays with leading axis C).
        Must be called after at least one process() (the bootstrap frame).
        Trades C frames of latency for near-offline throughput — the
        high-rate streaming mode; chunk=1 process() is the low-latency
        mode (both faster than the 10 Hz sensor)."""
        if self._carry is None:
            raise RuntimeError("bootstrap with process() before chunks")
        if self._carry[3] is None:
            raise RuntimeError(
                "previous-frame features are unset — call prime() after "
                "resume() before streaming frames"
            )
        c = intensity.shape[0]
        with self.timer.stage("dispatch"):
            state, key, step, feats, ts, qs, stats, recs = self._jchunk(
                *self._carry, intensity, xyz, confidence
            )
            self._carry = (state, key, step, feats)
            self._records.append(recs)  # leaves have leading axis C
        out = [
            StepResult(
                self.step_i + i, ts[i], qs[i],
                jax.tree.map(lambda a, i=i: a[i], stats),
            )
            for i in range(c)
        ]
        self.step_i += c
        self.results.extend(out)
        if (
            self.snapshot_dir
            and self.snapshot_every
            and self.step_i % self.snapshot_every == 0
        ):
            self.snapshot()
        return out

    def run(
        self,
        frames: Iterable,
        decode: Callable[[Any], tuple] | None = None,
        prefetch: int = 2,
        chunk: int = 1,
    ) -> list[StepResult]:
        """Drive a whole sequence with host-side decode prefetch.

        `decode(frame) -> (intensity, xyz, confidence)` runs in a
        background thread pool `prefetch` frames ahead of the device
        (defaults to attribute access for Frame-like objects). chunk > 1
        batches that many frames per device dispatch (process_chunk) after
        the per-frame bootstrap — the throughput mode."""
        if decode is None:
            def decode(f):
                return f.intensity, f.xyz, f.confidence

        it: Iterator = iter(frames)
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = [
                pool.submit(decode, f)
                for f in itertools.islice(it, prefetch)
            ]
            buf: list[tuple] = []
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(decode, nxt))
                with self.timer.stage("decode_wait"):
                    args = fut.result()
                if chunk <= 1 or self._carry is None:
                    self.process(*args)
                    continue
                buf.append(args)
                if len(buf) == chunk or not pending:
                    self.process_chunk(
                        np.stack([a[0] for a in buf]),
                        np.stack([a[1] for a in buf]),
                        np.stack([a[2] for a in buf]),
                    )
                    buf = []
        return self.results

    # -- persistence --------------------------------------------------------

    def snapshot(self) -> str:
        from pre3_tpu.utils.checkpoint import save_state

        path = f"{self.snapshot_dir}/snapshot_{self.step_i:05d}.npz"
        save_state(path, self._carry[0], self.step_i, self._carry[1])
        return path

    def resume(self, path: str) -> None:
        """Restore state/step/key from a snapshot. The previous frame's
        features are transient (not checkpointed — same as the reference,
        whose resume re-reads the image, mono_slam.m:121-135): call
        prime() with frame step_i−1 before the next process()."""
        from pre3_tpu.utils.checkpoint import load_state

        state, self.step_i, key, _ = load_state(path)
        self._carry = (state, key, jnp.asarray(self.step_i, jnp.int32), None)

    def prime(self, intensity, xyz, confidence) -> None:
        """Set the previous-frame features after resume()."""
        feats = self._featurize(
            jnp.asarray(intensity, jnp.float32),
            jnp.asarray(xyz, jnp.float32),
            jnp.asarray(confidence, jnp.float32),
        )
        state, key, step, _ = self._carry
        self._carry = (state, key, step, feats)

    # -- sliding-window smoothing -------------------------------------------

    def _stacked_records(self):
        """Stack the recorded per-step inlier observations to numpy
        leaves with leading axis F-1 (row r ↔ frame r+1, matching the
        offline scan's record stream)."""
        outs = []
        for r in self._records:
            z = np.asarray(r.z)
            if z.ndim == 2:  # per-frame entry [K, ...] → add step axis
                outs.append(jax.tree.map(lambda a: np.asarray(a)[None], r))
            else:  # chunk entry [C, K, ...]
                outs.append(jax.tree.map(np.asarray, r))
        return jax.tree.map(lambda *xs: np.concatenate(xs), *outs)

    def smooth(
        self,
        window: int | None = None,
        max_keyframes: int = 32,
        iters: int = 8,
        max_landmarks: int = 256,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-lag smoother over the streamed trajectory: keyframes are
        selected inside the trailing `window` frames (None = full
        history), a Schur-complement BA runs on the recorded filter-vetted
        observations (the same backend/ekf_ba.py bridge the offline path
        uses), and the corrections are interpolated back onto every frame
        in the window. Frames before the window are left untouched.
        Returns (t [F, 3], q [F, 4]). Records are transient (not
        checkpointed): after resume() the smoothable window restarts."""
        from pre3_tpu.backend.ba import bundle_adjust
        from pre3_tpu.backend.ekf_ba import ba_problem_from_slam
        from pre3_tpu.backend.keyframes import select_keyframes
        from pre3_tpu.backend.smoothing import apply_ba_corrections
        from pre3_tpu.ekf.slam import SlamTrajectory

        ts, qs = self.trajectory
        f = len(ts)
        if f < 3 or not self._records:
            return ts, qs
        records = self._stacked_records()
        lo = max(0, f - window) if window else 0
        traj = SlamTrajectory(
            t=jnp.asarray(ts[lo:]), q=jnp.asarray(qs[lo:]), stats=None,
            records=jax.tree.map(lambda a: jnp.asarray(a[lo:]), records),
        )
        n = f - lo
        ks = select_keyframes(
            traj.t, traj.q, jnp.ones(n, bool), max_keyframes=max_keyframes
        )
        prob = ba_problem_from_slam(
            traj, np.asarray(ks.indices), np.asarray(ks.valid),
            max_landmarks=max_landmarks,
        )
        if prob is None:
            return ts, qs
        res = bundle_adjust(self.cam, prob, iters=iters)
        sm_t, sm_q = apply_ba_corrections(
            traj.t, traj.q, ks.indices, ks.valid, res.kf_t, res.kf_q
        )
        out_t, out_q = ts.copy(), qs.copy()
        out_t[lo:] = np.asarray(sm_t)
        out_q[lo:] = np.asarray(sm_q)
        return out_t, out_q

    # -- views ---------------------------------------------------------------

    @property
    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """([F, 3], [F, 4]) — synchronizes."""
        ts = np.stack([np.asarray(r.t) for r in self.results])
        qs = np.stack([np.asarray(r.q) for r in self.results])
        return ts, qs
