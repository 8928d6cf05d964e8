"""Multi-host initialization and mesh construction.

The reference has no distribution at all (SURVEY §2.4); this module is the
multi-host entry point for the engine's scale-out path (BASELINE config #5:
N ≥ 2 hosts): `jax.distributed.initialize` + a global mesh whose landmark
("lm") axis spans every device of every host so distributed BA
(parallel/ba_sharded.py) reduces its camera system over NVLink within a
host and the network across hosts — the layout keeps the heavy per-landmark elimination
local and ships only the [6F, 6F] reduced system, which is exactly the
traffic pattern that scales (one psum of a few hundred KB per GN
iteration regardless of map size).

Single-host fallback: everything degrades to the local-device mesh used by
the tests (8 virtual CPU devices) and the single-chip benchmark.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX. No-op when single-process (the common
    test/bench case). Pass the coordinator address, process count and
    process id explicitly: nothing detects a cluster here."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)


def global_landmark_mesh(axis: str = "lm") -> Mesh:
    """Mesh over every device in the (possibly multi-host) runtime, with a
    single landmark-sharding axis. jax.devices() enumerates global devices
    after initialize_distributed, so the same code path serves 1-chip,
    1-host-N-chip, and N-host slices."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def globalize_replicated(mesh: Mesh, x) -> jax.Array:
    """Turn identical per-process host data into a fully-replicated global
    array on `mesh`. In a multi-process runtime, plain (process-local)
    arrays cannot feed a computation spanning the global mesh; every
    process calls this with the same host values and gets the same global
    array. Single-process it is just a replicating device_put, so the same
    entry points serve tests, the 1-chip bench, and N-host runs."""
    sharding = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(x))


def hybrid_mesh(hyp_per_host: bool = True) -> Mesh:
    """2-D mesh (hosts × local chips) for running hypothesis-parallel VO
    within a host while landmark blocks shard across hosts:
    axes ("lm", "hyp")."""
    devs = np.asarray(jax.devices())
    n_proc = jax.process_count()
    local = len(devs) // max(n_proc, 1)
    return Mesh(devs.reshape(n_proc, local), ("lm", "hyp"))
