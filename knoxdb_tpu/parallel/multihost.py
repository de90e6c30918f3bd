"""Multi-host execution: process init + hybrid mesh construction.

The reference scales with a single Go process per node and no cross-node
query execution; the BASELINE north star instead demands "rows/s scaling
measured at 1 chip, 1 host, and N>=2 hosts" with "tables hash-partitioned
by primary key". The device-side shape of that:

- one jax process per host, joined via `jax.distributed.initialize`
  (this module's `initialize_from_env`), after which `jax.devices()`
  spans every host's devices and the SAME SPMD programs (engine_spmd,
  shuffle) run unchanged;
- a HYBRID mesh whose outer axis enumerates hosts (traffic over the
  network between hosts) and whose inner axis enumerates each host's
  devices (traffic over the host's interconnect, NVLink on a GPU host),
  built with `mesh_utils.create_hybrid_device_mesh`;
- the pack-partitioned scan layout (engine_spmd) keeps the host axis
  traffic-free by construction — segments are built `uniform=ndev` so
  every device owns a contiguous pack range, and the only cross-device
  data movement is the [P]-shaped per-pack partial combine (bytes per
  pack, not bytes per row). Hash-partitioning tables by pk IS the pack
  partition: build_segment orders rows by pk, so equal pk ranges land
  on equal devices (cf. the scaling-book recipe: choose shardings so
  collectives ride the fast intra-host links, and give the network
  between hosts only the tiny reductions).
- shuffle joins (parallel/shuffle.py) use all_to_all over the flattened
  device axis; on a hybrid mesh XLA decomposes it hierarchically
  (intra-host first, then between hosts) — the salted-skew logic is
  placement-agnostic.

Single-host processes (and the CPU test mesh) fall back transparently:
`initialize_from_env` is a no-op without coordinator env vars, and
`hybrid_mesh` collapses to a flat mesh when every device reports the
same process index.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_from_env", "hybrid_mesh", "attach"]


def initialize_from_env() -> bool:
    """Join the multi-process jax runtime when the standard coordinator
    env vars are set (KNOX_COORDINATOR or JAX_COORDINATOR_ADDRESS +
    process count/id). Returns
    True when distributed init ran. Safe to call more than once."""
    coord = os.environ.get("KNOX_COORDINATOR") \
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("KNOX_NUM_PROCESSES")
    pid = os.environ.get("KNOX_PROCESS_ID")
    if coord is None and nproc is None:
        return False
    if getattr(jax.distributed.global_state, "client", None) is not None:
        return True                       # already initialized
    kw = {}
    if coord:
        kw["coordinator_address"] = coord
    if nproc:
        kw["num_processes"] = int(nproc)
    if pid:
        kw["process_id"] = int(pid)
    jax.distributed.initialize(**kw)
    return True


def hybrid_mesh(hosts_axis: str = "hosts", chips_axis: str = "packs",
                devices=None) -> Mesh:
    """(n_hosts, chips_per_host) mesh: outer axis spans processes (the
    network between hosts), inner axis spans each process's local
    devices. Multi-process GPU runs are untested. With one process
    (or a virtual CPU mesh) the outer axis has size 1 unless
    KNOX_VIRTUAL_HOSTS forces a factorization for testing."""
    devs = list(devices if devices is not None else jax.devices())
    vh = int(os.environ.get("KNOX_VIRTUAL_HOSTS", "0"))
    nproc = max(1, getattr(jax, "process_count", lambda: 1)())
    if vh > 1:
        nproc = vh
    if nproc > 1 and len(devs) % nproc == 0:
        if vh > 1:
            # virtual factorization (tests): row-major host blocks
            grid = np.array(devs).reshape(nproc, len(devs) // nproc)
        else:
            from jax.experimental import mesh_utils
            grid = mesh_utils.create_hybrid_device_mesh(
                (1, len(devs) // nproc), (nproc, 1), devices=devs)
            grid = np.array(grid).reshape(nproc, len(devs) // nproc)
        return Mesh(grid, (hosts_axis, chips_axis))
    return Mesh(np.array(devs).reshape(1, len(devs)),
                (hosts_axis, chips_axis))


def attach(engine, mesh: Mesh | None = None) -> Mesh:
    """Wire a (hybrid) mesh into an engine. The engine's scan path
    (engine_spmd.ShardedScanner) partitions packs over ONE flat axis, so
    the hybrid grid flattens HOST-MAJOR: every host owns a contiguous
    pack (= pk) range and the host axis never carries row data — only the
    per-pack partial combine. Returns the flat mesh that was attached."""
    if mesh is None:
        mesh = hybrid_mesh()
    devs = np.asarray(mesh.devices).reshape(-1)      # host-major order
    flat = Mesh(devs, ("packs",))
    engine.mesh = flat
    return flat
