"""Round-2 feature tour: streaming import, full reducer surface,
joins, top-k, union, describe (reference operator-set walkthrough).

    JAX_PLATFORMS=cpu python examples/analytics_demo.py
"""

import io
import sys

import numpy as np

sys.path.insert(0, ".")
import knoxdb_tpu.knox as knox
from knoxdb_tpu.knox import F
from knoxdb_tpu.schema.schema import Builder
from knoxdb_tpu.series import FillMode, SeriesRequest, run_series
from knoxdb_tpu.types import FieldType


def main(n=100_000):
    rng = np.random.default_rng(11)
    db = knox.create_database("tour", driver="mem", pack_size=1 << 12)

    tx = db.create_table(
        (Builder("tx").pk("id")
         .add("ts", FieldType.TIMESTAMP)
         .add("acct", FieldType.UINT32)
         .add("amount", FieldType.DECIMAL64, scale=2)
         .finish()))
    acct = db.create_table(
        (Builder("acct").pk("id")
         .add("acct", FieldType.UINT32)
         .add("region", FieldType.STRING)
         .finish()))

    # 1. streaming CSV import (reference table_import operator)
    lines = ["acct,region"]
    regions = ["emea", "apac", "amer"]
    for a in range(500):
        lines.append(f"{a},{regions[a % 3]}")
    print("imported accounts:",
          acct.import_csv(io.StringIO("\n".join(lines)), batch_rows=128))

    # 2. bulk insert + merge
    tx.insert({
        "id": np.zeros(n, np.uint64),
        "ts": (rng.integers(0, 86_400, n) // 60) * 60 * 10**9,
        "acct": rng.integers(0, 500, n).astype(np.uint32),
        "amount": rng.integers(-10**6, 10**6, n),
    })
    tx.merge()

    # 3. full reducer surface over hourly buckets
    req = SeriesRequest(table=tx, time_field="ts", start=0,
                        end=86_400 * 10**9, interval=3_600 * 10**9,
                        aggs=[("count", ""), ("sum", "amount"),
                              ("first", "amount"), ("last", "amount"),
                              ("std", "amount"), ("mean_join", "amount"),
                              ("max_join", "amount")],
                        fill=FillMode.ZERO)
    s = run_series(req)
    print("hour0: count=%d sum=%s std=%.1f max_join=%s" % (
        s["count"][0], s[("sum", "amount")][0],
        s[("std", "amount")][0], s[("max_join", "amount")][0]))

    # 4. group-by with variance; top-k spenders
    g = tx.query().group_by("acct").aggregate(
        ("count", ""), ("sum", "amount"), ("var", "amount"))
    print("accounts grouped:", len(g["keys"]))
    top = tx.query().order_by("amount", desc=True).limit(3) \
        .select("acct", "amount").rows()
    print("top-3 amounts:", [float(v) for v in top["amount"]])

    # 5. device join tx x accounts, then streamed union + describe
    j = knox.join(tx.query().where(F("amount") > 0), acct.query(),
                  on=("acct", "acct"), select=("amount", "region"))
    print("join rows:", len(j["amount"]))
    total = 0
    for batch in knox.union(tx.query().where(acct=1).select("amount"),
                            tx.query().where(acct=2).select("amount")):
        total += len(batch["amount"])
    print("union rows:", total)
    d = db.describe("tx")
    print("describe: rows=%d segments=%d bytes=%d" %
          (d["rows"], d["segments"], d["bytes_stored"]))
    db.close()


if __name__ == "__main__":
    main()
