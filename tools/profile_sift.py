"""Per-stage timing of the SIFT frontend on the default device (VERDICT
r2 #5).

Each stage program returns a SCALAR checksum which the host fetches per
rep. Inputs are varied per rep to defeat any identical-args memoization.

Each stage includes its prefix, so deltas attribute cost.

Run from the checkout root: python -u tools/profile_sift.py
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pre3_tpu.data.synthetic import render_sequence  # noqa: E402
from pre3_tpu.frontend import sift as S  # noqa: E402
from pre3_tpu.frontend.pipeline import extract_features_sift  # noqa: E402
from pre3_tpu.frontend.scalespace import (  # noqa: E402
    build_pyramid, gradient_polar,
)

N = 256
KPO = 96
N_OCT = 3
SIGMA0 = 1.6 * 2.0 ** (1.0 / 3)
REPS = 3


def _csum(tree):
    return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(tree))


def timeit(name, fn, variants, reps=REPS):
    v = float(fn(variants[0]))  # compile+warm
    t0 = time.time()
    for r in range(reps):
        v = float(fn(variants[1 + r]))
    dt = (time.time() - t0) / reps
    print(f"{name:28s} {1e3 * dt / N:7.3f} ms/frame (csum={v:.1f})",
          flush=True)
    return dt


def _pyr(im):
    return build_pyramid(im, n_octaves=N_OCT, s_levels=3, sigma0=SIGMA0)


def main():
    frames, _, _ = render_sequence(n_frames=N, n_points=832, noise=0.004,
                                   x_range=(-1.8, 0.03 * 0.5 * N + 1.8))
    img = jnp.asarray(np.stack([f.intensity for f in frames]))
    xyz = jnp.asarray(np.nan_to_num(np.stack([f.xyz for f in frames])))
    conf = jnp.asarray(np.stack([f.confidence for f in frames]))
    variants = [img * (1.0 + 1e-6 * r) for r in range(REPS + 1)]
    jax.block_until_ready(variants)

    @jax.jit
    def pyr_only(img):
        def one(im):
            octs = _pyr(im)
            return [o.dog for o in octs]
        return _csum(jax.vmap(one)(img))

    timeit("pyramid(gss+dog)", lambda im: pyr_only(im), variants)

    @jax.jit
    def pyr_grad(img):
        def one(im):
            octs = _pyr(im)
            outs = []
            for o in octs:
                mg, an = jax.vmap(gradient_polar)(o.gss)
                outs += [mg, an]
            return outs
        return _csum(jax.vmap(one)(img))

    timeit("pyramid+gradients", lambda im: pyr_grad(im), variants)

    @jax.jit
    def detect_only(img):
        def one(im):
            octs = _pyr(im)
            return [
                S._detect_octave(o, 0.004, KPO, 3, SIGMA0) for o in octs
            ]
        return _csum(jax.vmap(one)(img))

    timeit("pyramid+detect(top_k)", lambda im: detect_only(im), variants)

    @jax.jit
    def no_desc(img):
        """Everything except the descriptor stage."""
        def one(im):
            octs = _pyr(im)
            outs = []
            for o in octs:
                det = S._detect_octave(o, 0.004, KPO, 3, SIGMA0)
                for s in range(o.gss.shape[0]):
                    outs.append(gradient_polar(o.gss[s]))
                outs.append(det)
            return outs
        return _csum(jax.vmap(one)(img))

    timeit("all but descriptors", lambda im: no_desc(im), variants)

    @jax.jit
    def full(img):
        return _csum(jax.vmap(
            lambda im: S.extract_sift(
                im, n_octaves=N_OCT, keypoints_per_octave=KPO,
                peak_thresh=0.004, upright=True)
        )(img))

    timeit("extract_sift full", lambda im: full(im), variants)

    @jax.jit
    def fe(i, x, c):
        return _csum(jax.vmap(extract_features_sift)(i, x, c))

    timeit("extract_features_sift", lambda im: fe(im, xyz, conf), variants)


if __name__ == "__main__":
    main()
