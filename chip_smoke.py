"""End-to-end smoke test of the knox SDK on one NVIDIA GPU.

    python chip_smoke.py                 # one card: phases 1-4
    python chip_smoke.py --devices 4     # four cards: the mesh phase only
    python chip_smoke.py --rows-log2 20  # a smaller table (rehearsal)

The deployment is KnoxDB's own: an append-heavy blockchain operations
table with analytics on top (reference README; SURVEY.md §4-§6). Every
result is checked against a plain numpy / Python-int reference computed
here from the same seeded data. Integer results must match bit for bit;
float variances on the f64 path within a relative 1e-12 (the GPU sums in
another order than the host). Any failed phase raises, so the process
exits non-zero and prints no result line. The last line of standard
output is one JSON object naming the device.

Phases (one process; it holds the card alone):
  1. device check: the platform must be "gpu"; no CPU fallback.
  2. load: a file-driver database with a 2^26-row `ops` table and a
     2^20-row `accounts` table, inserted in batches, then merged.
  3. queries (a)-(i) through the SDK, each cold then warm.
  4. kernels: the card-only tests, then hand-written kernel versus
     plain XLA timings.
With --devices 4 only the mesh phase runs: the same database is loaded
once on a 4-card mesh; queries (a), (b), (c), (d) and (f) run on it,
are checked against the reference, and must give the same results when
its segment files are reopened on one card; then the shuffle join runs
balanced and skewed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DB_DIR = ROOT / ".smoke_db"
OUT_DIR = ROOT / "chiprun_out"

N_ACCOUNTS = 1 << 20
N_KINDS = 20
T0_MS = 1_600_000_000_000
TS_STEP_MS = 250                     # one operation every 250 ms
HOUR_MS = 3_600_000
GROUP_GS = (1000, 8192, 65536)       # acct % G group keys
OP_NAMES = np.array(["transaction", "delegation", "origination", "reveal",
                     "endorsement", "ballot", "proposal", "activation",
                     "double_baking", "double_endorsement", "seed_nonce",
                     "register_constant", "set_deposits_limit",
                     "increase_paid_storage", "transfer_ticket",
                     "smart_rollup_add", "smart_rollup_cement",
                     "smart_rollup_publish", "dal_publish", "drain"],
                    dtype=object)
F64_RTOL = 1e-12
SHUFFLE_ROWS = 1 << 18               # probe rows of the shuffle-join check


# ----------------------------------------------------------------- setup --

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def make_ops(n: int, seed: int, first_row: int = 0) -> dict:
    """Seeded operations rows [first_row, first_row + n)."""
    rng = np.random.default_rng(seed)
    row = np.arange(first_row, first_row + n, dtype=np.uint64)
    acct = (rng.zipf(1.2, n) % N_ACCOUNTS + 1).astype(np.uint64)
    kind = rng.integers(0, N_KINDS, n).astype(np.uint32)
    cols = {
        "height": row // np.uint64(64),
        "ts": np.uint64(T0_MS) + row * np.uint64(TS_STEP_MS),
        "acct": acct,
        "amount": rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64),
        "fee": rng.integers(0, 1 << 20, n).astype(np.uint64),
        "kind": kind,
        "tname": OP_NAMES[kind],
    }
    for G in GROUP_GS:                   # the SDK groups on a column
        cols[f"g{G}"] = (acct % np.uint64(G)).astype(np.uint32)
    return cols


def make_accounts(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "id": np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64),
        "balance": rng.integers(-(1 << 30), 1 << 40, N_ACCOUNTS,
                                dtype=np.int64),
        "flags": rng.integers(0, 1 << 8, N_ACCOUNTS).astype(np.uint32),
    }


def schemas():
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType as FT
    b = (Builder("ops").pk("id")
         .add("height", FT.UINT64).add("ts", FT.UINT64)
         .add("acct", FT.UINT64).add("amount", FT.INT64)
         .add("fee", FT.UINT64).add("kind", FT.UINT32)
         .add("tname", FT.STRING))
    for G in GROUP_GS:
        b = b.add(f"g{G}", FT.UINT32)
    ops = b.finish()
    acc = (Builder("accounts").pk("id").add("balance", FT.INT64)
           .add("flags", FT.UINT32).finish())
    return ops, acc


def load(n: int, path: Path | None, mesh=None, batch_log2: int = 22):
    """Create the database and insert both tables in batches, then
    merge. Returns (db, ops, accounts, ref) with ref the host columns
    (ops ids are 1..n)."""
    import knoxdb_tpu.knox as knox
    ops_s, acc_s = schemas()
    kw = dict(background_merge=False, journal_size=1 << 40, mesh=mesh)
    if path is not None:
        kw.update(driver="file", path=str(path))
    db = knox.create_database("smoke", **kw)
    ops = db.create_table(ops_s)
    accounts = db.create_table(acc_s)
    ref = make_ops(n, seed=1)
    ref["id"] = np.arange(1, n + 1, dtype=np.uint64)
    acc = make_accounts(seed=2)
    step = 1 << batch_log2
    for s in range(0, n, step):
        ops.insert({k: v[s:s + step] for k, v in ref.items() if k != "id"})
    ops.merge()
    accounts.insert(acc)
    accounts.merge()
    return db, ops, accounts, (ref, acc)


def device_bytes(*tables) -> int:
    import jax
    total = 0
    for t in tables:
        for h in t._t.segments:
            d = h.scanner_().d
            leaves = jax.tree_util.tree_leaves(
                d.arrays_pytree(list(d.seg.columns)))
            total += sum(x.nbytes for x in leaves) + d.valid_words.nbytes
    return total


def timed(name: str, fn, card: str, reps: int = 2):
    """Run fn cold, then warm; print both wall times. Returns the last
    result."""
    out = None
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    log(f"query {name}: cold {times[0] * 1e3:.3f} ms, warm "
        f"{min(times[1:]) * 1e3:.3f} ms [{card}]")
    return out


# ------------------------------------------------------------ references --

def exact_sum(v) -> int:
    v = np.asarray(v)
    if v.dtype == np.uint64:
        hi = (v >> np.uint64(32)).astype(np.int64)
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    else:
        v = v.astype(np.int64)
        hi, lo = v >> 32, v & 0xFFFFFFFF
    return (int(hi.sum()) << 32) + int(lo.sum())


def group_ref(keys, vals, G: int, off: int):
    """Exact per-group (count, sum) of integer vals: three 16-bit chunks
    of vals + off through f64 bincounts (each chunk sum < 2^53)."""
    keys = np.asarray(keys, np.int64)
    u = (np.asarray(vals).astype(np.int64) + off).astype(np.uint64)
    cnt = np.bincount(keys, minlength=G)
    s = np.zeros(G, object)
    for c in range(3):
        w = ((u >> np.uint64(16 * c)) & np.uint64(0xFFFF)).astype(np.float64)
        part = np.bincount(keys, weights=w, minlength=G)
        s = s + np.rint(part).astype(np.int64).astype(object) * (1 << 16 * c)
    return cnt, s - off * cnt.astype(object)


def check_group(out: dict, keys, vals, G: int, field: str, what: str):
    cnt, s = group_ref(keys, vals, G, 1 << 40)
    nz = np.flatnonzero(cnt)
    got_keys = np.asarray(out["keys"]).astype(np.int64)
    assert np.array_equal(got_keys, nz), f"{what}: group keys"
    assert np.array_equal(np.asarray(out["count"]).astype(np.int64),
                          cnt[nz]), f"{what}: counts"
    got = [int(x) for x in out[("sum", field)]]
    assert got == [int(x) for x in s[nz]], f"{what}: sums"


# --------------------------------------------------------------- queries --

def q_a(ops):
    from knoxdb_tpu.knox import F
    return ops.query().where(F("fee").between(1 << 14, 3 << 17)) \
        .aggregate(("count", ""), ("sum", "fee"))


def ref_a(ref, alive):
    m = alive & (ref["fee"] >= 1 << 14) & (ref["fee"] <= 3 << 17)
    return {("count", ""): int(m.sum()), ("sum", "fee"): exact_sum(
        ref["fee"][m])}


def q_b(ops):
    from knoxdb_tpu.knox import F
    return ops.query().where(F("amount") > 0, F("fee") < 1 << 19,
                             F("tname") == "transaction") \
        .aggregate(("count", ""), ("sum", "amount"), ("min", "amount"),
                   ("max", "amount"))


def ref_b(ref, alive):
    m = alive & (ref["amount"] > 0) & (ref["fee"] < 1 << 19) \
        & (ref["tname"] == "transaction")
    a = ref["amount"][m]
    return {("count", ""): int(m.sum()), ("sum", "amount"): exact_sum(a),
            ("min", "amount"): int(a.min()), ("max", "amount"): int(a.max())}


def q_c(ops):
    from knoxdb_tpu.knox import F
    out = {"kind": ops.query().where(F("fee") >= 1 << 10).group_by("kind")
           .aggregate(("count", ""), ("sum", "amount"))}
    for G in GROUP_GS:
        out[G] = ops.query().group_by(f"g{G}").aggregate(
            ("count", ""), ("sum", "amount"))
    return out


def check_c(out, ref, alive):
    m = alive & (ref["fee"] >= 1 << 10)
    check_group(out["kind"], ref["kind"][m], ref["amount"][m], N_KINDS,
                "amount", "group kind")
    for G in GROUP_GS:
        check_group(out[G], ref[f"g{G}"][alive], ref["amount"][alive], G,
                    "amount", f"group acct % {G}")


def series_req(ops, n):
    from knoxdb_tpu.series import SeriesRequest
    end = T0_MS + n * TS_STEP_MS
    return SeriesRequest(table=ops, time_field="ts", start=T0_MS, end=end,
                         interval=HOUR_MS,
                         aggs=[("sum", "fee"), ("var", "fee"),
                               ("var", "amount")])


def q_d(ops, n):
    from knoxdb_tpu.series import run_series
    return run_series(series_req(ops, n))


def check_d(out, ref, alive, n):
    G = -(-(n * TS_STEP_MS) // HOUR_MS)
    b = ((ref["ts"][alive] - np.uint64(T0_MS)) // np.uint64(HOUR_MS)) \
        .astype(np.int64)
    times = np.asarray(out["time"]).astype(np.int64)
    gi = (times - T0_MS) // HOUR_MS
    cnt, fsum = group_ref(b, ref["fee"][alive], G, 0)
    assert np.array_equal(np.asarray(out["count"]).astype(np.int64),
                          cnt[gi]), "series counts"
    assert [int(x) for x in out[("sum", "fee")]] == \
        [int(x) for x in fsum[gi]], "series fee sums"
    # exact int moments (fee < 2^32 rides the exact one-hot path): the
    # engine rounds the exact S and Q to f64 once, as here -> identical
    _, Q = group_ref(b, ref["fee"][alive].astype(np.int64) ** 2, G, 0)
    want = []
    for g in gi:
        k, S, Qf = int(cnt[g]), float(fsum[g]), float(Q[g])
        want.append(max(0.0, Qf - S * S / k) / (k - 1))
    assert [float(x) for x in out[("var", "fee")]] == want, "series var fee"
    # f64 moments path (amount spans 41 bits): reduction order differs
    # from the host's, so a relative tolerance
    amt = ref["amount"][alive].astype(np.float64)
    S = np.bincount(b, weights=amt, minlength=G)
    Q = np.bincount(b, weights=amt * amt, minlength=G)
    k = cnt.astype(np.float64)
    want = np.maximum(0.0, Q - S * S / np.maximum(k, 1)) / np.maximum(k - 1, 1)
    got = np.array([float(x) for x in out[("var", "amount")]])
    np.testing.assert_allclose(got, want[gi], rtol=F64_RTOL,
                               err_msg="series var amount")


def q_e(ops):
    return ops.query().order_by("amount", desc=True).limit(100) \
        .select("id", "amount").rows()


def check_e(out, ref, alive):
    amt = ref["amount"][alive]
    want = np.sort(amt)[::-1][:100]
    got_a = np.asarray(out["amount"]).astype(np.int64)
    assert np.array_equal(got_a, want), "top-k amounts"
    ids = np.asarray(out["id"]).astype(np.int64)
    assert np.array_equal(ref["amount"][ids - 1], got_a), "top-k ids"


def q_f(ops, accounts):
    import knoxdb_tpu.knox as knox
    from knoxdb_tpu.knox import F
    return knox.join(ops.query().where(F("kind") == 3, F("fee") < 1 << 12),
                     accounts.query(), on=("acct", "id"),
                     where=F("balance") > 0)


def check_f(out, ref, acc, alive):
    m = alive & (ref["kind"] == 3) & (ref["fee"] < 1 << 12)
    bal = acc["balance"][ref["acct"][m].astype(np.int64) - 1]
    want_ids = np.sort(ref["id"][m][bal > 0])
    ids = np.asarray(out["id"]).astype(np.uint64)
    order = np.argsort(ids)
    assert np.array_equal(ids[order], want_ids), "join row set"
    got_bal = np.asarray(out["balance"]).astype(np.int64)[order]
    want_bal = acc["balance"][ref["acct"][want_ids.astype(np.int64) - 1]
                              .astype(np.int64) - 1]
    assert np.array_equal(got_bal, want_bal), "join balances"


def q_g(ops):
    from knoxdb_tpu.knox import F
    return ops.query().where(F("amount") >= (1 << 40) - (1 << 30)) \
        .select("id", "amount", "tname").limit(10_000).rows()


def check_g(out, ref, alive):
    m = alive & (ref["amount"] >= (1 << 40) - (1 << 30))
    ids = np.asarray(out["id"]).astype(np.int64)
    assert len(ids) == min(10_000, int(m.sum())), "rows: count"
    assert len(np.unique(ids)) == len(ids) and m[ids - 1].all(), \
        "rows: id set"
    assert np.array_equal(np.asarray(out["amount"]).astype(np.int64),
                          ref["amount"][ids - 1]), "rows: amount"
    assert list(out["tname"]) == list(ref["tname"][ids - 1]), "rows: tname"


def compare_families(name: str, q, table, card: str, reps: int = 5) -> None:
    """One query end to end with the Triton kernels and with plain XLA
    (the kernel family of the table's scanners), in alternating turns;
    prints the medians of the warm wall times."""
    import statistics
    ts = {"triton": [], "xla": []}
    try:
        for i in range(reps + 1):
            for fam in ("triton", "xla")[::1 if i % 2 else -1]:
                for h in table._t.segments:
                    h.scanner_().kernels = fam
                t0 = time.perf_counter()
                q()
                if i:                      # turn 0 compiles both plans
                    ts[fam].append(time.perf_counter() - t0)
    finally:
        for h in table._t.segments:
            h.scanner_().kernels = "triton"
    log(f"query {name} end to end, median of {reps}: triton "
        f"{statistics.median(ts['triton']) * 1e3:.3f} ms, xla "
        f"{statistics.median(ts['xla']) * 1e3:.3f} ms [{card}]")


def assert_eq(got, want, what):
    assert got == want, f"{what}: got {got} want {want}"


# ---------------------------------------------------------------- phases --

def phase_queries(n: int, card: str) -> None:
    import knoxdb_tpu.knox as knox
    shutil.rmtree(DB_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    db, ops, accounts, (ref, acc) = load(n, DB_DIR)
    log(f"load: {n} ops rows + {N_ACCOUNTS} accounts in "
        f"{time.perf_counter() - t0:.1f} s")
    nbytes = device_bytes(ops, accounts)
    log(f"device-resident bytes: {nbytes} ({nbytes / 2**30:.3f} GiB)")
    alive = np.ones(n, bool)

    assert_eq(timed("a range+count+sum", lambda: q_a(ops), card),
              ref_a(ref, alive), "(a)")
    assert_eq(timed("b 3-leaf AND sum/min/max", lambda: q_b(ops), card),
              ref_b(ref, alive), "(b)")
    check_c(timed("c group_by kind + acct%G", lambda: q_c(ops), card),
            ref, alive)
    compare_families("c", lambda: q_c(ops), ops, card)
    check_d(timed("d series sum/var hourly", lambda: q_d(ops, n), card),
            ref, alive, n)
    check_e(timed("e top-100 amount", lambda: q_e(ops), card), ref, alive)
    check_f(timed("f join ops-accounts", lambda: q_f(ops, accounts), card),
            ref, acc, alive)
    check_g(timed("g rows() capped", lambda: q_g(ops), card), ref, alive)

    # (h) 0.1% inserts and deletes: journal overlay, then merge
    k = n // 1000
    new = make_ops(k, seed=3, first_row=n)
    ops.insert(new)
    new["id"] = np.arange(n + 1, n + k + 1, dtype=np.uint64)
    ref = {c: np.concatenate([ref[c], new[c]]) for c in ref}
    d0 = n // 3
    from knoxdb_tpu.knox import F
    ndel = ops.delete(ops.query().where(F("id").between(d0, d0 + k - 1)))
    assert_eq(ndel, k, "(h) deleted rows")
    alive = np.ones(n + k, bool)
    alive[d0 - 1:d0 - 1 + k] = False
    assert_eq(timed("h overlay (a)", lambda: q_a(ops), card),
              ref_a(ref, alive), "(h) overlay (a)")
    check_c(timed("h overlay (c)", lambda: q_c(ops), card), ref, alive)
    ops.merge()
    assert_eq(timed("h merged (a)", lambda: q_a(ops), card),
              ref_a(ref, alive), "(h) merged (a)")
    check_c(timed("h merged (c)", lambda: q_c(ops), card), ref, alive)

    # (i) acknowledged writes survive close + reopen from disk
    db.close()
    db = knox.open_database("smoke", driver="file", path=str(DB_DIR),
                            background_merge=False)
    ops = db.table("ops")
    assert_eq(timed("i reopened (a)", lambda: q_a(ops), card),
              ref_a(ref, alive), "(i) reopened (a)")
    db.close()
    shutil.rmtree(DB_DIR, ignore_errors=True)


def phase_kernels(card: str) -> None:
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      str(ROOT / "tests" / "test_gpu_kernels.py")])
    assert rc == 0, f"card-only tests failed (pytest rc {rc})"
    from knoxdb_tpu.testing import gpu_bench
    for line in gpu_bench.kernel_timings(card, OUT_DIR):
        log(line)


def mesh_queries(tag: str, ops, accounts, n: int, card: str,
                 ref=None, acc=None) -> dict:
    """Queries (a), (b), (c), (d), (f); checked against the reference
    when it is given. Returns the results in comparable form."""
    alive = np.ones(n, bool)
    r = {"a": timed(f"{tag} a", lambda: q_a(ops), card),
         "b": timed(f"{tag} b", lambda: q_b(ops), card)}
    c = timed(f"{tag} c", lambda: q_c(ops), card)
    d = timed(f"{tag} d", lambda: q_d(ops, n), card)
    f = timed(f"{tag} f", lambda: q_f(ops, accounts), card)
    if ref is not None:
        assert_eq(r["a"], ref_a(ref, alive), f"{tag} (a)")
        assert_eq(r["b"], ref_b(ref, alive), f"{tag} (b)")
        check_c(c, ref, alive)
        check_d(d, ref, alive, n)
        check_f(f, ref, acc, alive)
    r["c"] = {k: {kk: [int(x) for x in vv] for kk, vv in v.items()}
              for k, v in c.items()}
    # exact columns compare bit for bit; the f64 variance of amount sums
    # in a device-dependent order (compared within F64_RTOL)
    r["d"] = {k: [int(x) for x in d[k]]
              for k in ("time", "count", ("sum", "fee"))}
    r["d"]["var fee"] = [float(x) for x in d[("var", "fee")]]
    r["d var amount"] = np.array([float(x) for x in d[("var", "amount")]])
    r["f"] = sorted((int(i), int(b)) for i, b in zip(f["id"],
                                                     f["balance"]))
    return r


def phase_mesh(n: int, ndev: int, card: str) -> None:
    """The database is loaded once, on the mesh; the one-card run
    reopens the same segment files without a mesh."""
    import jax
    import knoxdb_tpu.knox as knox
    from knoxdb_tpu.parallel import shard as PS
    from knoxdb_tpu.parallel.engine_spmd import ShardedScanner
    from knoxdb_tpu.parallel import shuffle as SH
    assert len(jax.devices()) >= ndev, f"need {ndev} devices"
    mesh = PS.make_mesh(ndev)
    shutil.rmtree(DB_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    db, ops, accounts, (ref, acc) = load(n, DB_DIR, mesh=mesh)
    log(f"load (mesh): {n} ops rows + {N_ACCOUNTS} accounts in "
        f"{time.perf_counter() - t0:.1f} s")
    nbytes = device_bytes(ops, accounts)
    log(f"device-resident bytes: {nbytes} ({nbytes / ndev / 2**20:.1f} "
        f"MiB per device)")
    for t in (ops, accounts):
        for h in t._t.segments:
            sc = h.scanner_()
            assert isinstance(sc, ShardedScanner), "mesh scanner"
            leaf = jax.tree_util.tree_leaves(
                sc.d.arrays_pytree(["id"]))[0]
            devs = {s.device for s in leaf.addressable_shards
                    if s.data.size}
            assert len(devs) == ndev, f"segment on {len(devs)} devices"
    mesh_r = mesh_queries("mesh", ops, accounts, n, card, ref, acc)
    db.close()

    t0 = time.perf_counter()
    db = knox.open_database("smoke", driver="file", path=str(DB_DIR),
                            background_merge=False)
    ops, accounts = db.table("ops"), db.table("accounts")
    one_r = mesh_queries("one", ops, accounts, n, card)
    log(f"one card, reopened and queried in "
        f"{time.perf_counter() - t0:.1f} s")
    db.close()
    shutil.rmtree(DB_DIR, ignore_errors=True)
    np.testing.assert_allclose(one_r.pop("d var amount"),
                               mesh_r.pop("d var amount"), rtol=F64_RTOL,
                               err_msg="one card vs mesh: var amount")
    assert one_r == mesh_r, "mesh differs from one card"
    del ref, acc

    # shuffle join, balanced and skewed, against the pair oracle; its
    # inputs are host key arrays of their own, not the table
    rng = np.random.default_rng(5)
    nl = SHUFFLE_ROWS
    nr = nl // 4
    rk = rng.integers(1, nr // 2, nr).astype(np.uint64)
    lk = rng.integers(1, nr, nl).astype(np.uint64)
    for tag, keys, skew in (("balanced", lk, 8.0), ("skewed", None, 1.2)):
        if keys is None:
            keys = lk.copy()
            keys[rng.choice(nl, nl // 3, replace=False)] = 7
        t0 = time.perf_counter()
        lidx, ridx, st = SH.shuffle_join_rows(mesh, keys, rk, how="left",
                                              axis=mesh.axis_names[0],
                                              skew_factor=skew)
        log(f"shuffle join {tag}: {len(lidx)} pairs in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms, work_eff "
            f"{st['work_eff']:.3f} [{card}]")
        bc = np.bincount(rk.astype(np.int64), minlength=nr + 1)
        assert len(lidx) == int(np.maximum(bc[keys.astype(np.int64)],
                                           1).sum()), f"{tag}: pair count"
        hit = ridx >= 0
        assert (keys[lidx[hit]] == rk[ridx[hit]]).all(), f"{tag}: keys"
        assert (bc[keys[lidx[~hit]].astype(np.int64)] == 0).all(), \
            f"{tag}: misses"
        if tag == "skewed":
            assert st["heavy_buckets"] >= 1, "hot key not spread"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4 runs the mesh phase only")
    ap.add_argument("--rows-log2", type=int, default=26,
                    help="ops table size (default 2^26 rows)")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (platform {dev.platform})",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    OUT_DIR.mkdir(exist_ok=True)
    n = 1 << args.rows_log2
    if args.devices > 1:
        phase_mesh(n, args.devices, card)
        count = args.devices
    else:
        phase_queries(n, card)
        phase_kernels(card)
        count = 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
