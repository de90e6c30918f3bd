"""Distributed execution tour (r4): a mesh-attached database running
SPMD scans/group-bys/series and the salted all_to_all shuffle join —
the axis where this engine EXCEEDS the single-process reference
(/root/reference/README.md:57).

Runs on the 8-device virtual CPU mesh; the same programs run on a mesh
of GPUs unchanged:

    JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/distributed.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import numpy as np

sys.path.insert(0, ".")
import jax

import knoxdb_tpu.knox as knox
from knoxdb_tpu.knox import F
from knoxdb_tpu.parallel.shard import make_mesh
from knoxdb_tpu.parallel.shuffle import shuffle_join_rows
from knoxdb_tpu.schema.schema import Builder
from knoxdb_tpu.series import SeriesRequest, run_series
from knoxdb_tpu.types import FieldType


def main(n=200_000):
    ndev = len(jax.devices())
    mesh = make_mesh(ndev)
    print(f"mesh: {ndev} x {jax.devices()[0].platform}")
    rng = np.random.default_rng(4)

    # mesh-attached database: every query on its tables executes SPMD
    # (pack-sharded segments under jax.shard_map, exact host combine)
    db = knox.create_database("dist", driver="mem", pack_size=4096,
                              mesh=mesh)
    tx = db.create_table(
        (Builder("tx").pk("id")
         .add("ts", FieldType.UINT64)
         .add("acct", FieldType.UINT32)
         .add("amount", FieldType.INT64)
         .finish()))
    T0, IV, NB = 1_700_000_000, 3600, 24
    tx.insert({
        "id": np.zeros(n, np.uint64),
        "ts": (T0 + rng.integers(0, NB * IV, n)).astype(np.uint64),
        "acct": rng.integers(0, 5000, n).astype(np.uint32),
        "amount": rng.integers(-10**6, 10**6, n),
    })
    tx.merge()

    q = tx.query().where(F("amount") > 0)
    print(f"SPMD filtered count: {q.count():,}")
    print(f"SPMD exact sum:      {tx.query().sum('amount'):,}")

    g = tx.query().where(F("amount") != 0).group_by("acct") \
        .aggregate(("count", ""), ("sum", "amount"))
    print(f"SPMD group-by: {len(g['keys'])} accounts, "
          f"top count {int(max(g['count']))}")

    s = run_series(SeriesRequest(table=tx, time_field="ts", start=T0,
                                 end=T0 + NB * IV, interval=IV,
                                 aggs=[("sum", "amount"),
                                       ("var", "amount")]))
    print(f"SPMD series: {len(s['time'])} hourly buckets "
          f"(bucket32 static-shift gids)")

    # distributed shuffle join: hash-partition both sides over the mesh,
    # exchange via all_to_all, local shift-core join per shard (heavy
    # keys salt/replicate, so skew never overloads one device)
    nl, nr = 120_000, 30_000
    rk = rng.permutation(np.arange(1, nr + 1)).astype(np.uint64)
    lk = rng.integers(1, nr * 2, nl).astype(np.uint64)
    lk[: nl // 10] = 7                      # a hot key (10% of probes)
    lidx, ridx, st = shuffle_join_rows(mesh, lk, rk, axis="packs",
                                       skew_factor=1.2,
                                       unique_build=True)
    print(f"shuffle join: {len(lidx):,} pairs, core={st['core']}, "
          f"heavy_buckets={st['heavy_buckets']}, "
          f"work_eff={st['work_eff']:.2f}, "
          f"exchanged {st['shuffle_bytes'] / 1e6:.1f} MB")
    db.close()
    print("done")


if __name__ == "__main__":
    main()
