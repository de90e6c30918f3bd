"""Synthetic end-to-end pipeline (reference examples/pipeline/main.go):
generate a transaction stream, ingest, merge, run the benchmark query
set, print per-phase stats.

    JAX_PLATFORMS=cpu python examples/pipeline.py
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
import knoxdb_tpu.knox as knox
from knoxdb_tpu.schema.schema import Builder
from knoxdb_tpu.series import FillMode, SeriesRequest, run_series
from knoxdb_tpu.types import FieldType, FilterType


def main(n=200_000, pack_size=1 << 14):
    rng = np.random.default_rng(42)
    db = knox.create_database("pipeline", pack_size=pack_size,
                              background_merge=False)
    db.create_enum("kind", ["transfer", "mint", "burn", "fee"])
    import dataclasses
    sch = (Builder("tx").pk("id")
           .add("ts", FieldType.TIMESTAMP)
           .add("acct", FieldType.UINT32, filter=FilterType.BLOOM_2B)
           .add("kind", FieldType.UINT16, is_enum=True, enum_name="kind")
           .add("amount", FieldType.DECIMAL64, scale=6)
           .finish())
    t = db.create_table(sch)

    t0 = time.perf_counter()
    ts = np.sort(rng.integers(0, 86_400 * 10**9, n))
    data = {
        "id": np.zeros(n, np.uint64),
        "ts": ts,
        "acct": rng.integers(1, 5000, n).astype(np.uint32),
        "kind": rng.integers(0, 4, n).astype(np.uint16),
        "amount": rng.integers(-10**12, 10**12, n),
    }
    t.insert(data)
    t.merge()
    print(f"ingest+merge {n} rows: {time.perf_counter()-t0:.2f}s "
          f"({len(t._t.segments)} segments)")

    q = t.query().where(knox.cond("kind", "eq", "transfer"),
                        knox.F("amount") > 0)
    t0 = time.perf_counter()
    cnt = q.count()
    s = q.sum("amount")
    print(f"filter+agg: count={cnt} sum={s:.6f} "
          f"({(time.perf_counter()-t0)*1e3:.1f} ms)")

    t0 = time.perf_counter()
    g = t.query().group_by("acct").aggregate(("sum", "amount"), ("count", ""))
    print(f"group-by acct: {len(g['keys'])} groups "
          f"({(time.perf_counter()-t0)*1e3:.1f} ms)")

    sr = run_series(SeriesRequest(table=t, time_field="ts", start=0,
                                  end=86_400 * 10**9,
                                  interval=3600 * 10**9,
                                  aggs=[("sum", "amount"), ("count", "")],
                                  fill=FillMode.ZERO))
    print(f"hourly series: {len(sr['time'])} buckets, "
          f"total count {int(sr['count'].sum())}")

    top = t.query().order_by("amount", desc=True).limit(5) \
        .select("acct", "amount").rows()
    print("top-5 amounts:", [float(v) for v in top["amount"]])

    with db.begin(read_only=True) as txn:
        res = t._t.query(txn.snapshot, q._tree())
    print("query stats:", {k: (f"{v*1e3:.2f}ms" if "time" in k else v)
                           for k, v in res.stats.items()})
    db.close()


if __name__ == "__main__":
    main()
