"""chip_smoke.py on a CPU-only JAX: the device check refuses to run, and
the kernel-parity phase's own checks pass at small widths."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("args", [[], ["--devices", "4"]])
def test_exits_nonzero_without_gpu(args, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs" in p.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    """A directory with chip_smoke.py and nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_kernel_phase_checks_pass_on_cpu(capsys):
    chip_smoke.phase_kernels(vo_n=64, big_match=96)
    out = capsys.readouterr().out
    assert out.count("kernels ") == 6


def test_scoring_reference_flags_ties():
    """A residual exactly at the gate counts in the tie band."""
    import numpy as np

    r = np.eye(3)[None]
    t = np.zeros((1, 3))
    p2 = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 2.0]])
    p1 = p2 + np.array([[0.1, 0, 0], [0.5, 0, 0]])
    sup, err, band = chip_smoke.score_reference(
        r, t, p1, p2, np.array([True, True]), 0.01)
    assert sup.tolist() == [0] and band.tolist() == [1]
    sup, err, band = chip_smoke.score_reference(
        r, t, p1, p2, np.array([True, True]), 0.02)
    assert sup.tolist() == [1] and band.tolist() == [0]
    np.testing.assert_allclose(err, [0.01])



class _Dev:
    """Stand-in device with a settable allocation count."""

    def __init__(self, platform, allocs):
        self.platform, self.allocs = platform, allocs

    def memory_stats(self):
        return None if self.allocs is None else {"num_allocs": self.allocs}


def test_check_spread_needs_new_allocations_on_every_device():
    devs = [_Dev("gpu", 10), _Dev("gpu", 10)]
    before = chip_smoke._allocs(devs)
    devs[0].allocs = 12
    with pytest.raises(AssertionError, match="without new allocations"):
        chip_smoke.check_spread("path", devs, before)
    devs[1].allocs = 11
    assert "[2, 1]" in chip_smoke.check_spread("path", devs, before)


def test_check_spread_requires_statistics_on_gpu_only():
    assert "n/a" in chip_smoke.check_spread("path", [_Dev("cpu", None)],
                                            [None])
    with pytest.raises(AssertionError, match="no allocation statistics"):
        chip_smoke.check_spread("path", [_Dev("gpu", None)], [None])


def test_check_collectives_counts_cross_device_ops():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pre3_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4, axis="x")
    x = jax.device_put(jnp.arange(16.0), NamedSharding(mesh, P("x")))
    total = jax.jit(lambda a: a.sum(),
                    out_shardings=NamedSharding(mesh, P()))
    assert chip_smoke.check_collectives("sum", total, x) >= 1
    local = jax.jit(lambda a: a * 2.0)
    with pytest.raises(AssertionError, match="no collective"):
        chip_smoke.check_collectives("local", local, jnp.arange(16.0))


def test_time_reps_stats_keeps_every_output():
    import bench

    outs, first, times = bench.time_reps_stats(lambda r: r * 2, reps=3)
    assert outs == [0, 2, 4, 6] and first >= 0 and len(times) == 3
