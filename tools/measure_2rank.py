"""Measured 2-rank scaling of the sharded production paths (VERDICT r3
#6): replaces the inter-host bandwidth *assumption* in the round-5 record's multi-host
projection with a measured collective-overhead number on the real
2-process Gloo runtime this repo already exercises for correctness
(tests/test_multiprocess.py).

Method: fixed total work (BA F=64/L=512/10 LM iters + a 32-frame frontend
chunk); each rank owns ONE virtual CPU device and is pinned to ONE core
(taskset), so the 1-rank and 2-rank configurations have identical
per-rank compute. Efficiency = T1 / (N · TN).

Caveat printed with the result: Gloo over loopback on a 2-core host is a
pessimistic transport (no overlap with compute, shared memory bus); the number
LOWER-BOUNDS what the same code does on real multi-host links.

Usage: python tools/measure_2rank.py   (writes JSON lines to stdout)
"""

import json
import os
import socket
import subprocess
import sys
import tempfile


def run_config(nproc: int) -> dict:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for pid in range(nproc):
            cmd = [
                "taskset", "-c", str(pid),  # one pinned core per rank
                sys.executable,
                os.path.join(repo, "tools", "rank_bench_worker.py"),
                str(pid), str(nproc), str(port), f"{tmp}/rank{pid}.json",
            ]
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=repo,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        logs = [p.communicate(timeout=1800)[0] for p in procs]
        for pid, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank {pid}/{nproc} failed:\n{log[-3000:]}"
                )
        out = json.load(open(f"{tmp}/rank0.json"))
    return out


def main() -> None:
    r1 = run_config(1)
    r2 = run_config(2)
    ba_eff = r1["ba_s"] / (2 * r2["ba_s"])
    fe_eff = r1["fe_s"] / (2 * r2["fe_s"])
    print(json.dumps({
        "ba_1rank_s": round(r1["ba_s"], 3),
        "ba_2rank_s": round(r2["ba_s"], 3),
        "ba_2rank_efficiency": round(ba_eff, 3),
        "fe_1rank_s": round(r1["fe_s"], 3),
        "fe_2rank_s": round(r2["fe_s"], 3),
        "fe_2rank_efficiency": round(fe_eff, 3),
        "transport": "gloo loopback, 1 core/rank (pessimistic bound)",
    }))


if __name__ == "__main__":
    main()
