"""Seeded deterministic scenario runner with a model-based oracle.

This build's answer to the reference's deterministic simulation
testing (/root/reference/internal/tests/run/README.md: patched-Go WASM
runtime + seed-driven scheduler): our engine is single-threaded per
operation by construction, so determinism needs no runtime patching —
a seed fully determines the op sequence, and a python dict MODEL of the
table (pk -> row) is updated alongside every engine op. Invariants:

- after every step, count/contents queries agree with the model
- crash/reopen (file driver) recovers exactly the model state
- Sometimes/Reachable assertion sites (testing/assert_.py) all fire

Workload op mix mirrors the reference scenarios (internal/tests/
scenarios/workload{1..5}_test.go): bulk insert, update, delete, point
and range query, merge, reopen.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import assert_ as A

__all__ = ["run_scenario"]


@dataclasses.dataclass
class _Cfg:
    steps: int = 60
    max_batch: int = 200
    pack_size: int = 256
    check_every: int = 5


def run_scenario(seed: int, path: str, steps: int = 60,
                 reopen: bool = True) -> dict:
    """Run one seeded workload; raises on any divergence. Returns the
    assertion coverage report."""
    import knoxdb_tpu.knox as knox
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType

    rng = np.random.default_rng(seed)
    cfg = _Cfg(steps=steps)
    A.reset()

    def open_db():
        return knox.open_database("dst", driver="file", path=path,
                                  pack_size=cfg.pack_size,
                                  background_merge=False)

    db = open_db()
    sch = (Builder("t").pk("id")
           .add("grp", FieldType.UINT16)
           .add("val", FieldType.INT64)
           .finish())
    if "t" not in db.engine.tables:
        t = db.create_table(sch)
    else:
        t = db.table("t")
    model: dict[int, tuple[int, int]] = {}   # pk -> (grp, val)

    for step in range(cfg.steps):
        op = rng.choice(["insert", "insert", "insert", "insert", "update",
                         "update", "delete", "delete", "merge", "merge",
                         "reopen", "reopen", "query", "query", "tear",
                         "tear", "truncate"])   # truncate is rare (1/17)
        if op == "truncate":
            t.truncate()
            model.clear()
            A.reachable("op.truncate")
            _check(t, model)
            continue
        if op == "insert":
            n = int(rng.integers(1, cfg.max_batch))
            grp = rng.integers(0, 10, n).astype(np.uint16)
            val = rng.integers(-10**6, 10**6, n)
            pks = t.insert({"id": np.zeros(n, np.uint64), "grp": grp,
                            "val": val})
            for pk, g, v in zip(pks, grp, val):
                model[int(pk)] = (int(g), int(v))
            A.reachable("op.insert")
        elif op == "update" and model:
            pks = rng.choice(list(model), min(len(model), 20), replace=False)
            newv = rng.integers(-10**6, 10**6, len(pks))
            t.update({"id": pks.astype(np.uint64),
                      "grp": np.array([model[int(p)][0] for p in pks],
                                      np.uint16),
                      "val": newv})
            for p, v in zip(pks, newv):
                model[int(p)] = (model[int(p)][0], int(v))
            A.reachable("op.update")
        elif op == "delete" and model:
            g = int(rng.integers(0, 10))
            victims = [p for p, (gg, _) in model.items() if gg == g]
            n = t.delete(t.query().where(grp=g))
            A.always(n == len(victims), "delete.count", (n, len(victims)))
            for p in victims:
                del model[p]
            A.sometimes(n > 0, "delete.nonempty")
        elif op == "merge":
            t.merge()
            if model:     # an empty table (e.g. post-truncate) seals
                A.sometimes(len(t._t.segments) > 0, "merge.sealed")
            A.reachable("op.merge")
        elif op == "reopen" and reopen:
            db.close()
            db = open_db()
            t = db.table("t")
            A.reachable("op.reopen")
        elif op == "tear" and reopen:
            # WAL damage injection (reference DST fault model): a crash
            # mid-append leaves a torn tail record that was never
            # acknowledged. Recovery must TRUNCATE it (wal.go:33-40
            # damage policy) and lose NOTHING acknowledged (= the model).
            db.close()
            from pathlib import Path
            segs = sorted(Path(path).glob("**/wal_*.seg"))
            if segs:
                kind = int(rng.integers(0, 3))
                with open(segs[-1], "ab") as fh:
                    if kind == 0:      # partial header
                        fh.write(b"\x01\x02\x03")
                    elif kind == 1:    # header claiming a longer body
                        import struct as _s
                        fh.write(_s.pack("<BBIQI I", 1, 0, 1, 99,
                                         1 << 20, 0xDEAD))
                        fh.write(b"torn")
                    else:              # garbage bytes
                        fh.write(bytes(rng.integers(0, 256, 64,
                                                    dtype=np.uint8)))
                A.reachable("op.tear")
            db = open_db()
            t = db.table("t")
            _check(t, model)
        elif op == "query":
            A.reachable("op.query")

        if step % cfg.check_every == 0 or op in ("delete", "reopen"):
            _check(t, model)

    _check(t, model)
    db.close()
    rep = A.report()
    missing = [k for k, v in rep.items() if v == 0]
    A.always(not missing, "coverage", missing)
    return rep


def run_scenario_rich(seed: int, path: str, steps: int = 60) -> dict:
    """Wide-surface seeded workload: indexed + string + wide columns,
    tx aborts, group-by / top-k / point-lookup / index-query checks vs
    the model — the reference's workload2-5 breadth (scenarios/
    workload{2..5}_test.go: mixed types, secondary indexes, streaming
    checks) on top of run_scenario's crash/tear fault model."""
    import knoxdb_tpu.knox as knox
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType

    rng = np.random.default_rng(seed)
    A.reset()
    vocab = ["ares", "boreas", "chronos", "demeter", "eos", "freyja"]

    def open_db():
        return knox.open_database("dstr", driver="file", path=path,
                                  pack_size=128,
                                  background_merge=False)

    db = open_db()
    sch = (Builder("r").pk("id")
           .add("grp", FieldType.UINT16)
           .add("name", FieldType.STRING)
           .add("val", FieldType.INT64)
           .add("big", FieldType.INT128)
           .add("price", FieldType.FLOAT64)
           .finish())
    if "r" not in db.engine.tables:
        t = db.create_table(sch)
        t.create_index("grp", kind="hash")
    else:
        t = db.table("r")
    model: dict[int, tuple] = {}       # pk -> (grp, name, val, big)

    def ins(n, tx=None):
        grp = rng.integers(0, 8, n).astype(np.uint16)
        names = [vocab[int(i)] for i in rng.integers(0, len(vocab), n)]
        val = rng.integers(-10**6, 10**6, n)
        big = [int(rng.integers(-10**9, 10**9)) * (10**12) for _ in
               range(n)]
        # dyadic floats (k/64): engine float sums are EXACT RATIONAL,
        # and the model's fsum over dyadics is exact too -> == compare
        price = rng.integers(-10**5, 10**5, n) / 64.0
        pks = t.insert({"id": np.zeros(n, np.uint64), "grp": grp,
                        "name": names, "val": val,
                        "big": np.array(big, object), "price": price},
                       tx=tx)
        return pks, grp, names, val, big, price

    for step in range(steps):
        op = rng.choice(["insert", "insert", "insert", "abort", "update",
                         "delete", "merge", "merge", "reopen", "check",
                         "check", "tear"])
        if op == "insert":
            n = int(rng.integers(1, 120))
            pks, grp, names, val, big, price = ins(n)
            for pk, g, nm, v, b, pr in zip(pks, grp, names, val, big,
                                           price):
                model[int(pk)] = (int(g), nm, int(v), int(b), float(pr))
            A.reachable("op.insert")
        elif op == "abort":
            tx = db.begin()
            ins(int(rng.integers(1, 40)), tx=tx)
            tx.abort()                 # model unchanged
            A.reachable("op.abort")
        elif op == "update" and model:
            pks = rng.choice(list(model), min(len(model), 15),
                             replace=False)
            newv = rng.integers(-10**6, 10**6, len(pks))
            t.update({"id": pks.astype(np.uint64),
                      "grp": np.array([model[int(p)][0] for p in pks],
                                      np.uint16),
                      "name": [model[int(p)][1] for p in pks],
                      "val": newv,
                      "big": np.array([model[int(p)][3] for p in pks],
                                      object),
                      "price": np.array([model[int(p)][4] for p in pks])})
            for p, v in zip(pks, newv):
                g, nm, _, b, pr = model[int(p)]
                model[int(p)] = (g, nm, int(v), b, pr)
            A.reachable("op.update")
        elif op == "delete" and model:
            nm = vocab[int(rng.integers(0, len(vocab)))]
            victims = [p for p, r in model.items() if r[1] == nm]
            n = t.delete(t.query().where(name=nm))
            A.always(n == len(victims), "delete.count",
                     (n, len(victims)))
            for p in victims:
                del model[p]
        elif op == "merge":
            t.merge()
            A.reachable("op.merge")
        elif op == "reopen":
            db.close()
            db = open_db()
            t = db.table("r")
            A.reachable("op.reopen")
        elif op == "tear":
            db.close()
            from pathlib import Path
            segs = sorted(Path(path).glob("**/wal_*.seg"))
            if segs:
                with open(segs[-1], "ab") as fh:
                    fh.write(bytes(rng.integers(0, 256, 32,
                                                dtype=np.uint8)))
                A.reachable("op.tear")
            db = open_db()
            t = db.table("r")

        if op == "check" or step % 7 == 0:
            _check_rich(t, model, rng)
            A.reachable("op.check")

    _check_rich(t, model, rng)
    db.close()
    rep = A.report()
    missing = [k for k, v in rep.items() if v == 0]
    A.always(not missing, "coverage", missing)
    return rep


def _check_rich(t, model: dict, rng) -> None:
    A.always(t.count() == len(model), "count", (t.count(), len(model)))
    if not model:
        return
    # exact sums incl. the int128 column (split-limb device partials)
    s = t.query().sum("val")
    A.always(s == sum(r[2] for r in model.values()), "sum.val", s)
    sb = t.query().sum("big")
    A.always(sb == sum(r[3] for r in model.values()), "sum.big", sb)
    # float sum: engine is exact-rational; fsum over dyadic k/64 values
    # is exact too, so strict equality holds
    import math
    sp = t.query().sum("price")
    A.always(float(sp) == math.fsum(r[4] for r in model.values()),
             "sum.price", sp)
    # group-by counts vs model
    out = t.query().group_by("grp").aggregate(("count", ""))
    want: dict[int, int] = {}
    for g, *_ in model.values():
        want[g] = want.get(g, 0) + 1
    got = {int(k): int(c) for k, c in zip(out["keys"], out["count"])}
    A.always(got == want, "group.counts", (got, want))
    # index-decorated point query on grp
    g0 = int(rng.integers(0, 8))
    cnt = t.query().where(grp=g0).count()
    A.always(cnt == want.get(g0, 0), "index.point", (g0, cnt))
    # series buckets over the SIGNED val domain (r4: bucket32s
    # static-shift gids + the fused moments kernel) vs the model —
    # exact count and integer sum per non-empty bucket
    from ..series import SeriesRequest, run_series
    START, IV = -(1 << 20), 1 << 15
    sout = run_series(SeriesRequest(table=t, time_field="val",
                                    start=START, end=1 << 20,
                                    interval=IV, aggs=[("sum", "val")]))
    wsc: dict[int, list] = {}
    for _g, _nm, v, _b, _pr in model.values():
        b = (int(v) - START) // IV
        e = wsc.setdefault(b, [0, 0])
        e[0] += 1
        e[1] += int(v)
    gsc = {int((int(tv) - START) // IV): (int(c), int(s))
           for tv, c, s in zip(sout["time"], sout["count"],
                               sout[("sum", "val")]) if int(c)}
    A.always(gsc == {b: (c, s) for b, (c, s) in wsc.items()},
             "series.buckets", (len(gsc), len(wsc)))
    # top-k by val (bit-descent path) matches model ordering
    k = min(5, len(model))
    rows = t.query().order_by("val", desc=True).limit(k).select(
        "val").execute()
    got_top = [int(r["val"]) for r in rows]
    want_top = sorted((r[2] for r in model.values()), reverse=True)[:k]
    A.always(got_top == want_top, "topk", (got_top, want_top))
    # float GROUP sums/min (r3): moments path, dyadic k/64 -> exact
    outp = t.query().group_by("grp").aggregate(("sum", "price"),
                                               ("min", "price"))
    wantf: dict[int, list] = {}
    for g, _nm, _v, _b, pr in model.values():
        wantf.setdefault(g, []).append(pr)
    okf = True
    for k_, s_, mn_ in zip(outp["keys"], outp[("sum", "price")],
                           outp[("min", "price")]):
        vv = wantf[int(k_)]
        okf = okf and float(s_) == math.fsum(vv) and float(mn_) == min(vv)
    A.always(okf and len(outp["keys"]) == len(wantf), "group.fsum", okf)
    # string point query (bloom-backed bytes matcher)
    nm = next(iter(model.values()))[1]
    want_nm = sum(1 for r in model.values() if r[1] == nm)
    A.always(t.query().where(name=nm).count() == want_nm, "string.eq",
             nm)


def _check(t, model: dict) -> None:
    import knoxdb_tpu.knox as knox

    A.always(t.count() == len(model), "count", (t.count(), len(model)))
    if not model:
        return
    # contents equality (workload1-style stream-back)
    rows = t.query().select("id", "grp", "val").rows()
    got = {int(i): (int(g), int(v))
           for i, g, v in zip(rows["id"], rows["grp"], rows["val"])}
    A.always(got == model, "contents",
             {k: (got.get(k), model.get(k))
              for k in set(got) ^ set(model) or list(got)[:1]})
    # aggregate equality on a random-ish slice
    vals = [v for _, v in model.values()]
    s = t.query().sum("val")
    A.always(s == sum(vals), "sum", (s, sum(vals)))
