"""Gaussian scale space + DoG pyramid (XLA convolutions).

Replaces the reference's gaussianss.m / diffss.m / imsmooth.c: separable
Gaussian blurs become lax.conv_general_dilated pairs (XLA fuses them),
octaves are built by 2× subsampling, and
every level has a static shape so the whole pyramid trace-compiles once.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """1-D Gaussian taps (static, computed at trace time)."""
    radius = max(1, int(math.ceil(truncate * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur of [H, W] with SAME edge behavior."""
    if sigma <= 0:
        return img
    k = jnp.asarray(gaussian_kernel(sigma))
    n = k.shape[0]
    x = img[None, None]  # [1, 1, H, W]
    kv = k.reshape(1, 1, n, 1)
    kh = k.reshape(1, 1, 1, n)
    x = jax.lax.conv_general_dilated(
        x, kv, (1, 1), [((n - 1) // 2, (n - 1) // 2), (0, 0)]
    )
    x = jax.lax.conv_general_dilated(
        x, kh, (1, 1), [(0, 0), ((n - 1) // 2, (n - 1) // 2)]
    )
    return x[0, 0]


class Octave(NamedTuple):
    gss: jnp.ndarray  # [S+3, H, W] Gaussian levels
    dog: jnp.ndarray  # [S+2, H, W] difference-of-Gaussian levels
    sigmas: tuple  # static per-level absolute σ (octave units)
    downsample: int  # 2**o factor back to input resolution


def build_pyramid(
    img: jnp.ndarray,
    n_octaves: int = 3,
    s_levels: int = 3,
    sigma0: float = 1.6,
    sigma_n: float = 0.5,
) -> list[Octave]:
    """Vedaldi-style pyramid (sift/gaussianss.m): levels s = -1..S+1 per
    octave with σ(o, s) = sigma0·2^(o + s/S); assumes the input already has
    nominal smoothing sigma_n (camera blur)."""
    k = 2.0 ** (1.0 / s_levels)
    octaves = []
    cur = img
    prev_sigma = sigma_n
    for o in range(n_octaves):
        levels = []
        sigmas = []
        run = cur
        run_sigma = prev_sigma
        for s in range(-1, s_levels + 2):
            target = sigma0 * (k**s)
            if target > run_sigma:
                inc = math.sqrt(max(target**2 - run_sigma**2, 1e-12))
                run = gaussian_blur(run, inc)
                run_sigma = target
            levels.append(run)
            sigmas.append(sigma0 * (k**s))
        gss = jnp.stack(levels)
        dog = gss[1:] - gss[:-1]
        octaves.append(
            Octave(gss=gss, dog=dog, sigmas=tuple(sigmas), downsample=2**o)
        )
        # next octave: start from the level with σ = 2·sigma0 (index S+1 in
        # the -1-based list → position s_levels), subsampled 2×
        base = levels[s_levels]
        cur = base[::2, ::2]
        prev_sigma = sigmas[s_levels] / 2.0  # σ in the subsampled grid
    return octaves


def gradient_polar(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference gradient magnitude and angle of [H, W]."""
    dx = 0.5 * (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1))
    dy = 0.5 * (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0))
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)
    return mag, ang
