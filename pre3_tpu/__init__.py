"""pre3_tpu — an accelerator RGB-D SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the 3PRE
reference system (ahtamjidi/3PRE: 1-point-RANSAC inverse-depth EKF SLAM for
the Mesa SR4000 ToF camera): SIFT/FAST feature frontend, RANSAC rigid-motion
visual odometry, inverse-depth EKF backend with 1-point RANSAC gating,
map management, keyframe selection, and a keyframe/landmark bundle-adjustment
backend distributed over device meshes.

This is NOT a port: every component is re-designed for a compiled
accelerator program — static shapes, masked fixed-capacity state,
vmap/scan instead of loops, and jax.sharding for multi-device scale-out.

Package layout:
  geometry/  quaternion, SE(3), camera, inverse-depth math (reference C18/C19)
  data/      SR4000 .dat IO + synthetic scene generator (reference C20)
  frontend/  FAST + SIFT feature extraction, depth lift (reference C9/C15/C15b)
  ops/       batched kernels-as-XLA (matching, RANSAC scoring, 3×3 SVD,
             small Cholesky)
  vo/        batched RANSAC rigid-motion estimation (reference C8/C16)
  ekf/       masked-state inverse-depth EKF + 1-pt RANSAC (reference C2-C7, C11-C14)
  backend/   keyframes, factor graph, Schur-complement BA (reference C17 + north star)
  parallel/  mesh / sharding helpers, distributed BA
  runtime/   streaming driver, frame-sharded stage pipeline
  eval/      ATE/RPE metrics, stats (reference C23)
  utils/     config, profiling, checkpointing (reference C24 + §5 aux)
"""

import os as _os

import jax as _jax

# Estimation accuracy first: on an NVIDIA GPU, f32 matmuls at
# precision=DEFAULT run as TF32 (about three decimal digits), which
# degrades the engine's small-matrix math — Kalman gains, Kabsch/GN
# solves, covariance propagation. Default the whole engine to "highest"
# (full fp32, no TF32); the few throughput-bound, precision-insensitive
# kernels (descriptor distance matmul) opt back into DEFAULT explicitly
# at their call sites.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise keep the cache at one fixed directory inside
# the checkout (listed in .gitignore), since the path is part of the key.
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

__version__ = "0.1.0"
