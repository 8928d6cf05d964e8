"""Test configuration: an 8-device virtual CPU platform.

Tests exercise multi-device sharding logic without a GPU, so JAX is pinned
to the CPU backend with 8 virtual devices. Must run before any backend
initializes. The compile cache comes from the package (pre3_tpu/__init__.py):
JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.jax_cache.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

import pre3_tpu  # noqa: E402,F401  (precision + compile-cache policy)

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)
# The suite is compile-dominated (large jitted SLAM/BA programs).
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
