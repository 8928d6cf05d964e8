"""RANSAC hypothesis scoring (ops/ransac_score.py) against a brute-force
NumPy loop, plus its edge cases. The same scorer runs compiled for the GPU
in chip_smoke.py's kernel phase against a float64 reference."""

import jax
import jax.numpy as jnp
import numpy as np

from pre3_tpu.data.synthetic import _rodrigues
from pre3_tpu.ops.ransac_score import score_hypotheses


def make_problem(b=100, n=90, seed=0):
    rng = np.random.default_rng(seed)
    r = np.stack([_rodrigues(rng.normal(scale=0.2, size=3)) for _ in range(b)])
    t = rng.normal(scale=0.1, size=(b, 3))
    p2 = rng.uniform(-1, 1, (n, 3))
    p1 = p2 @ r[0].T + t[0] + rng.normal(scale=0.01, size=(n, 3))
    valid = rng.uniform(size=n) > 0.2
    return (
        jnp.asarray(r, jnp.float32), jnp.asarray(t, jnp.float32),
        jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32),
        jnp.asarray(valid),
    )


def bruteforce(r, t, p1, p2, valid, thr):
    """One hypothesis and one point at a time, in float64."""
    r, t, p1, p2 = (np.asarray(a, np.float64) for a in (r, t, p1, p2))
    valid = np.asarray(valid)
    sup = np.zeros(len(r), np.int64)
    err = np.zeros(len(r))
    for b in range(len(r)):
        for i in range(len(p1)):
            d = r[b] @ p2[i] + t[b] - p1[i]
            e = float(d @ d)
            if valid[i] and e < thr:
                sup[b] += 1
                err[b] += e
    return sup, err / np.maximum(sup, 1)


def test_scorer_matches_bruteforce_numpy():
    """Real VO widths: 512 hypotheses × 288 SIFT matches."""
    r, t, p1, p2, valid = make_problem(b=512, n=288, seed=4)
    thr = 0.01
    sup, err = jax.jit(score_hypotheses)(r, t, p1, p2, valid,
                                         jnp.asarray(thr))
    sup_ref, err_ref = bruteforce(r, t, p1, p2, valid, thr)
    np.testing.assert_array_equal(np.asarray(sup), sup_ref)
    np.testing.assert_allclose(np.asarray(err), err_ref, rtol=1e-4,
                               atol=1e-9)


def test_hypothesis_zero_wins():
    """Hypothesis 0 is the true motion → must have max support."""
    r, t, p1, p2, valid = make_problem(seed=1)
    s, e = score_hypotheses(r, t, p1, p2, valid, jnp.asarray(0.01))
    assert int(jnp.argmax(s)) == 0


def test_all_invalid():
    r, t, p1, p2, _ = make_problem(seed=2)
    s, e = score_hypotheses(
        r, t, p1, p2, jnp.zeros(p1.shape[0], bool), jnp.asarray(0.01),
    )
    assert int(jnp.sum(s)) == 0
    np.testing.assert_array_equal(np.asarray(e), 0.0)


def test_zero_hypotheses():
    _, _, p1, p2, valid = make_problem(seed=3)
    s, e = score_hypotheses(
        jnp.zeros((0, 3, 3)), jnp.zeros((0, 3)), p1, p2, valid,
        jnp.asarray(0.01),
    )
    assert s.shape == (0,) and s.dtype == jnp.int32
    assert e.shape == (0,)
