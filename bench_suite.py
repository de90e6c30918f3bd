"""Driver-runnable bench suite for BASELINE.json configs #2-#5 + a #6 series-reducer config.

One JSON line per config (same shape as bench.py's line). Marginal
timing method throughout where the op runs fully on device (see
bench.py: K query variants inside one jit, distinct traced constants per
iteration, rows/s = rows * dK / dt); host-coupled ops (top-k, join)
report median end-to-end latency, which includes the host merge and the
result fetch. Runs on the GPU, one process holding the card.

Baselines per config (denominator of vs_baseline):
- #2 multi-pred scan: 11 G rows/s — the reference's single-predicate
  u64 EQ AVX2 kernel (BASELINE.md); conservative (ours runs THREE
  predicates + sum in that time).
- #3 group-by:       1 G rows/s — the VERDICT round-1 bar (the
  reference has no group-by operator; plan.go:26-34 TODO).
- #4 top-k int128:   11 G rows/s row-scan equivalent (no reference
  sort operator exists; plan.go:26-34).
- #5 join:           11 G rows/s probe-side row equivalent (reference
  merge join is pk-cursor sequential, join.go:536-556).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

PACK = 1 << 16


def _marginal(run, k_lo=1, k_hi=129, reps=5):
    """MEDIAN of `reps` independent marginal estimates (medians, not
    best-of — VERDICT r1 methodology note)."""
    margs = sorted(
        max((_time(run, k_hi) - _time(run, k_lo)) / (k_hi - k_lo), 1e-9)
        for _ in range(reps))
    return margs[len(margs) // 2]


def _time(fn, *a):
    t0 = time.perf_counter()
    fn(*a)
    return time.perf_counter() - t0


def _emit(metric, rows_per_s, baseline):
    print(json.dumps({"metric": metric, "value": rows_per_s,
                      "unit": "rows/s",
                      "vs_baseline": rows_per_s / baseline}))


def bench_config2(n_packs: int, rng):
    """Multi-predicate AND over bytes + u64 + i64 with zone-map/bloom
    pruning (BASELINE config #2)."""
    import jax
    import jax.numpy as jnp

    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = PACK * n_packs
    sch = (Builder("c2").pk("id")
           .add("val", FieldType.UINT64)
           .add("acct", FieldType.BYTES)
           .add("bal", FieldType.INT64)
           .finish())
    accts = np.array([b"acct-%03d" % i for i in range(64)], object)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
        "acct": accts[rng.integers(0, 64, n)],
        "bal": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64),
    }
    seg = build_segment(sch, data, pack_size=PACK)
    sc = SegmentScanner(DeviceSegment(seg))
    tree = and_(
        leaf(Filter(sch.field("val"), FilterMode.RANGE, (1000, 50000))),
        leaf(Filter(sch.field("acct"), FilterMode.EQ, b"acct-042")),
        leaf(Filter(sch.field("bal"), FilterMode.GT, 0)),
    ).optimize()
    aggs = [AggSpec("count"), AggSpec("sum", "bal")]

    res = sc.scan(tree, aggs)
    m = ((data["val"] >= 1000) & (data["val"] <= 50000)
         & (data["acct"] == b"acct-042") & (data["bal"] > 0))
    assert res.count == int(m.sum()), "config2 count mismatch"
    assert res.aggs[("sum", "bal")] == int(
        data["bal"][m].astype(object).sum()), "config2 sum mismatch"

    _fn, args, raw = sc.prepare(tree, aggs)
    arrays, consts, overrides, valid, excl = args

    # TWO real query variants, dynamic_indexed per iteration: with
    # only scalar constants bumped, parts of the plan (the dict leaf's
    # code sets) are loop-invariant and XLA hoists them out of the scan
    tree2 = and_(
        leaf(Filter(sch.field("val"), FilterMode.RANGE, (1001, 50000))),
        leaf(Filter(sch.field("acct"), FilterMode.EQ, b"acct-042")),
        leaf(Filter(sch.field("bal"), FilterMode.GT, 1)),
    ).optimize()
    _f2, args2, _r2 = sc.prepare(tree2, aggs)
    consts_st = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), consts, args2[1])
    over_st = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), overrides, args2[2])

    def many(arrays, consts2, over2, valid, excl, idxs):
        def body(acc, i):
            j = (i % 2).astype(jnp.int32)
            c = jax.tree_util.tree_map(
                lambda s: jax.lax.dynamic_index_in_dim(s, j, 0, False),
                consts2)
            o = jax.tree_util.tree_map(
                lambda s: jax.lax.dynamic_index_in_dim(s, j, 0, False),
                over2)
            _mask, counts, parts = raw(arrays, c, o, valid, excl)
            lo, hi, _c = parts[1][0]
            chk = (lo.sum() + hi.sum()).astype(jnp.int64)
            return (acc[0] + counts.sum(), acc[1] + chk), None
        out, _ = jax.lax.scan(body, (jnp.int64(0), jnp.int64(0)), idxs)
        return out
    consts, overrides = consts_st, over_st

    g = jax.jit(many)

    def run(k):
        out = g(arrays, consts, overrides, valid, excl,
                jnp.arange(k, dtype=jnp.uint64))
        return int(out[0]), int(out[1])

    run(1)
    # a wide window: one iteration is well under a millisecond
    marg = _marginal(run, k_lo=1, k_hi=1025)
    _emit("multipred_scan_rows_per_s", n / marg, 11e9)


def bench_config3(n_packs: int, rng, G: int = 1000):
    """Group-by account, sum over decimal64 balances (BASELINE config
    #3) — one-hot matmul path. G parameterizes the group domain:
    config '3b' = G=8192, '3c' = G=65536."""
    import jax
    import jax.numpy as jnp

    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = PACK * n_packs
    sch = (Builder("c3").pk("id")
           .add("acct", FieldType.UINT64)
           .add("bal", FieldType.DECIMAL64, scale=4)
           .finish())
    acct = rng.integers(0, G, n, dtype=np.uint64)
    bal = rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64)
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "acct": acct, "bal": bal}
    seg = build_segment(sch, data, pack_size=PACK)
    sc = SegmentScanner(DeviceSegment(seg))
    # 99%-pass filter: the threshold sits INSIDE every pack's value
    # range, so zone maps cannot decide the leaf, its constant stays
    # traced, and per-iteration shifts defeat loop hoisting (a decidable
    # leaf is pruned to a constant and XLA collapses the K-iter loop)
    tree = leaf(Filter(sch.field("bal"), FilterMode.GT,
                       -((1 << 40) * 49) // 50)).optimize()

    gplan, counts, res = sc.group_scan(tree, "acct", ["bal"],
                                       minmax=False)
    fm = bal > -((1 << 40) * 49) // 50
    w_cnt = np.bincount(acct[fm].astype(np.int64), minlength=G)
    assert (counts == w_cnt).all(), "config3 counts mismatch"
    sums, _mn, _mx = res["bal"]
    bias = 1 << 63
    for g in (0, 1, G // 2, G - 1):
        sel = (acct == g) & fm
        want = int(bal[sel].astype(object).sum()) + int(w_cnt[g]) * bias
        assert sums[g] == want, f"config3 sum mismatch group {g}"

    # rebuild the pieces group_scan cached to drive the raw fn in a loop
    from knoxdb_tpu.exec import groupby as GB
    _fn, margs, _raw = sc.prepare(tree, [])
    sig = [s for s in sc._fns if isinstance(s, tuple) and s[0] == "group"]
    gfn_raw = sc._fns[sig[0]][1]
    garrays = sc.d.arrays_pytree(["acct", "bal"])
    gconsts = GB.gid_consts(gplan)
    biases = {"bal": jnp.uint64(
        GB.chunk_plan(sc.d.seg.stats.fields.get("bal"))[1])}
    arrays, consts, overrides, valid, excl = margs

    def many(arrays, consts, overrides, valid, excl, garrays, gconsts,
             idxs):
        def body(acc, i):
            step = (i * jnp.uint64(0x9E3779B1)) % jnp.uint64(4096)
            c = jax.tree_util.tree_map(
                lambda x: x - step
                if getattr(x, "dtype", None) == jnp.uint64 and x.ndim == 0
                else x, consts)
            out = gfn_raw((arrays, c, overrides, valid, excl),
                          garrays, gconsts, biases)
            o = out["bal"]
            cg = o[0]
            chk = sum(x.sum(dtype=jnp.int64) if x.dtype != jnp.uint64
                      else x.astype(jnp.int64).sum() for x in
                      (o[1] if isinstance(o[1], tuple) else (o[1], o[2])))
            return (acc[0] + cg.sum(), acc[1] + chk), None
        out, _ = jax.lax.scan(body, (jnp.int64(0), jnp.int64(0)), idxs)
        return out

    g = jax.jit(many)

    def run(k):
        out = g(arrays, consts, overrides, valid, excl, garrays, gconsts,
                jnp.arange(k, dtype=jnp.uint64))
        return int(out[0]), int(out[1])

    run(1)
    marg = _marginal(run, k_hi=33)
    tag = "" if G == 1000 else f"_g{G}"
    _emit(f"groupby_decimal64{tag}_rows_per_s", n / marg, 1e9)


def bench_config4(n_packs: int, rng):
    """Top-k over an int128 column under a filter (BASELINE config #4).
    End-to-end latency (host merge + fetch included). The kernel packs
    every output into ONE u32 buffer, so each call pays one fetch; 4x
    the suite's base rows amortizes the fixed per-call cost."""
    n_packs *= 4
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import SegmentScanner
    from knoxdb_tpu.exec.sort import segment_topk
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = PACK * n_packs
    sch = (Builder("c4").pk("id")
           .add("big", FieldType.INT128)
           .add("val", FieldType.UINT64)
           .finish())
    # pack-clustered magnitudes (pk-ordered wide columns cluster per
    # pack in practice) -> wide BITPACK planes -> the bit-descent radix
    # select handles int128 directly (exec/sort._topk_bit_descent)
    block = np.arange(n) // PACK
    big = np.array([int(b) * (1 << 70) + (int(x) << 9) for b, x in
                    zip(block, rng.integers(-1 << 50, 1 << 50, n))],
                   object)   # per-pack range < 2^63 -> wide BITPACK
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "big": big,
            "val": rng.integers(0, 1 << 16, n, dtype=np.uint64)}
    seg = build_segment(sch, data, pack_size=PACK)
    sc = SegmentScanner(DeviceSegment(seg))
    tree = leaf(Filter(sch.field("val"), FilterMode.LT, 50000)).optimize()

    keys, rows, nv = segment_topk(sc, tree, "big", 100, desc=True,
                                  project=["id"])
    m = data["val"] < 50000
    want = sorted(big[m].tolist(), reverse=True)[:100]
    got = [int(k) - (1 << 127) for k in keys]
    assert got == want, f"config4 top-k mismatch {got[:3]} {want[:3]}"

    lats = sorted(_time(lambda: segment_topk(sc, tree, "big", 100,
                                             desc=True, project=["id"]))
                  for _ in range(5))
    lat = lats[len(lats) // 2]
    _emit("topk_int128_rows_per_s", n / lat, 11e9)

    # narrow u64 order column -> the bit-descent radix-select kernel
    keys2, _r2, _nv2 = segment_topk(sc, tree, "val", 100, desc=True,
                                    project=["id"])
    m2 = sorted(data["val"][m].tolist(), reverse=True)[:100]
    assert [int(x) for x in keys2] == [int(x) for x in m2], \
        "config4 u64 top-k mismatch"
    lats2 = sorted(_time(lambda: segment_topk(sc, tree, "val", 100,
                                              desc=True, project=["id"]))
                   for _ in range(5))
    lat2 = lats2[len(lats2) // 2]
    _emit("topk_u64_bitdescent_rows_per_s", n / lat2, 11e9)


def bench_config5(n_packs: int, rng):
    """Single-chip device join: 1M x 1M u64 keys with duplicates
    (BASELINE config #5's per-chip kernel; the distributed shuffle path
    is validated on the virtual mesh in tests/test_shuffle.py and needs
    multi-chip hardware for a meaningful GB/s).

    Marginal method over join_pairs_core (the jittable sort-probe-
    expand; pairs stay ON DEVICE, so the fetch of 2M pairs is not
    timed)."""
    import jax
    import jax.numpy as jnp

    from knoxdb_tpu.exec.join import (join_keys_np, join_pairs_core,
                                      join_pairs_device)
    from knoxdb_tpu.types import JoinType

    nl = PACK * max(1, n_packs // 4)
    nr = nl
    lkeys = rng.integers(0, nl * 2, nl, dtype=np.uint64)
    rkeys = rng.integers(0, nl * 2, nr, dtype=np.uint64)
    li, ri = join_pairs_device(jnp.asarray(lkeys), jnp.asarray(rkeys),
                               JoinType.INNER)
    want = join_keys_np(lkeys, rkeys, JoinType.INNER)
    assert len(li) == want.n, "config5 join cardinality mismatch"
    assert (lkeys[li] == rkeys[ri]).all(), "config5 join pairs mismatch"

    cap = 1 << max(0, (want.n - 1).bit_length())

    def many(lk, rk, idxs):
        def body(acc, i):
            lidx, ridx, total = join_pairs_core(lk + i, rk + i, cap,
                                                JoinType.INNER)
            chk = lidx.astype(jnp.int64).sum() + ridx.astype(
                jnp.int64).sum()
            return acc + chk + total, None
        out, _ = jax.lax.scan(body, jnp.int64(0), idxs)
        return out

    g = jax.jit(many)
    lk = jnp.asarray(lkeys)
    rk = jnp.asarray(rkeys)

    def run(k):
        return int(g(lk, rk, jnp.arange(k, dtype=jnp.uint64)))

    run(1)
    marg = _marginal(run, k_hi=17)
    _emit("device_join_rows_per_s", (nl + nr) / marg, 11e9)

    # --- pk-join fast path: unique build side (2 sorts + 2 fills vs the
    # general core's ~7 sorts) — the common FK -> pk join shape
    from knoxdb_tpu.exec.join import join_pairs_core_unique
    rku = rng.permutation(np.arange(nr, dtype=np.uint64) * np.uint64(2))
    liu, riu, tot_u, dup_u = join_pairs_core_unique(
        jnp.asarray(lkeys), jnp.asarray(rku), JoinType.INNER, keys32=True)
    wantu = join_keys_np(lkeys, rku, JoinType.INNER)
    liu_np, riu_np = np.asarray(liu), np.asarray(riu)
    keep = liu_np != -2
    assert int(tot_u) == wantu.n and not bool(dup_u), "config5u total"
    assert (lkeys[liu_np[keep]] == rku[riu_np[keep]]).all(), \
        "config5u pairs mismatch"

    def many_u(lk, rk, idxs):
        def body(acc, i):
            lidx, ridx, total, dups = join_pairs_core_unique(
                lk + i, rk + i, JoinType.INNER, keys32=True)
            chk = lidx.astype(jnp.int64).sum() + ridx.astype(
                jnp.int64).sum()
            return acc + chk + total + dups.astype(jnp.int64), None
        out, _ = jax.lax.scan(body, jnp.int64(0), idxs)
        return out

    gu = jax.jit(many_u)
    rku_d = jnp.asarray(rku)

    def run_u(k):
        return int(gu(lk, rku_d, jnp.arange(k, dtype=jnp.uint64)))

    run_u(1)
    marg_u = _marginal(run_u, k_hi=17)
    _emit("device_join_unique_rows_per_s", (nl + nr) / marg_u, 11e9)

    # --- r3 shift core: the GENERAL dup-expansion join at the single-
    # sort roofline (one merged sort + S shifted equal-key compares;
    # bounded key-run spans, device-checked). keys32: bench keys are
    # < 2^21, the stats-proven common case.
    from knoxdb_tpu.exec.join import join_pairs_core_shift
    li_s, ri_s, tot_s, mn_s = join_pairs_core_shift(
        jnp.asarray(lkeys), jnp.asarray(rkeys), S=16, how=JoinType.INNER,
        keys32=True)
    assert int(mn_s) <= 16, f"bench workload run span {int(mn_s)} > 16"
    assert int(tot_s) == want.n, "config5 shift-core total mismatch"
    li_np, ri_np = np.asarray(li_s), np.asarray(ri_s)
    keep_s = li_np != -2
    assert (lkeys[li_np[keep_s]] == rkeys[ri_np[keep_s]]).all(), \
        "config5 shift-core pairs mismatch"

    def many_s(lk, rk, idxs):
        def body(acc, i):
            lidx, ridx, total, mn = join_pairs_core_shift(
                lk + i, rk + i, S=16, how=JoinType.INNER, keys32=True)
            chk = lidx.astype(jnp.int64).sum() + ridx.astype(
                jnp.int64).sum()
            return acc + chk + total + mn.astype(jnp.int64), None
        out, _ = jax.lax.scan(body, jnp.int64(0), idxs)
        return out

    gs = jax.jit(many_s)

    def run_s(k):
        return int(gs(lk, rk, jnp.arange(k, dtype=jnp.uint64)))

    run_s(1)
    marg_s = _marginal(run_s, k_hi=17)
    _emit("device_join_shift_rows_per_s", (nl + nr) / marg_s, 11e9)


def bench_config6(n_packs: int, rng):
    """Time-bucketed series moments (mean/var partials) over 1024
    buckets — the reference's streaming reducer surface
    (internal/reducer/reducer.go:24-48) as one fused device program."""
    import jax
    import jax.numpy as jnp

    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import SegmentScanner
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType

    n = PACK * n_packs
    G = 1024
    t0_, iv = 1_000_000, 64
    sch = (Builder("c6").pk("id")
           .add("ts", FieldType.UINT64)
           .add("val", FieldType.INT64)
           .finish())
    ts = (t0_ + rng.integers(0, G * iv, n)).astype(np.uint64)
    val = rng.integers(-1 << 30, 1 << 30, n)
    seg = build_segment(sch, {"id": np.arange(1, n + 1, dtype=np.uint64),
                              "ts": ts, "val": val}, pack_size=PACK)
    sc = SegmentScanner(DeviceSegment(seg))
    gplan = GB.plan_buckets(sc.d, "ts", t0_, iv, G)

    out = sc.series_scan(None, "ts", {"val": ("moments",)}, gplan)
    nb, sm, _sq = out[("val", "moments")]
    w_cnt = np.bincount(((ts - t0_) // iv).astype(np.int64), minlength=G)
    assert (np.asarray(nb) == w_cnt).all(), "config6 bucket counts"
    w_sum = np.bincount(((ts - t0_) // iv).astype(np.int64),
                        weights=val.astype(np.float64), minlength=G)
    assert np.allclose(np.asarray(sm), w_sum, rtol=1e-9), "config6 sums"

    sig = [s for s in sc._fns if isinstance(s, tuple) and s[0] == "series"]
    sfn_raw = sc._fns[sig[0]][1]
    _fn, margs, _raw = sc.prepare(None, [])
    garrays = sc.d.arrays_pytree(["ts", "val"])
    gconsts = GB.gid_consts(gplan)
    arrays, consts, overrides, valid, excl = margs
    # exact one-hot moments gate (mirrors scan.series_scan's mplan)
    C_m, gmin_m = GB.chunk_plan(sc.d.seg.stats.fields.get("val"))
    mb = {"val": jnp.uint64(gmin_m)} if C_m <= 4 else {}

    def many(arrays, consts, overrides, valid, excl, garrays, gconsts,
             mb, idxs):
        def body(acc, i):
            # shift the bucket origin every other iteration: real result
            # variance defeats loop hoisting of the scan body
            sh = (i % jnp.int32(2)).astype(jnp.uint64) * jnp.uint64(iv)
            g2 = [(c[0] - sh, c[1]) if isinstance(c, tuple) else c
                  for c in gconsts]
            # av = traced ALP decode constants (empty: integer columns)
            out = sfn_raw((arrays, consts, overrides, valid, excl),
                          garrays, g2, mb, ())
            parts = out[("val", "moments")]
            acc0 = acc[0] + parts[0].sum()
            acc1 = acc[1] + i.astype(jnp.float64)
            for p in parts[1:]:
                acc1 = acc1 + p.astype(jnp.float64).sum()
            return (acc0, acc1), None
        out, _ = jax.lax.scan(body, (jnp.int64(0), jnp.float64(0)), idxs)
        return out

    g = jax.jit(many)

    def run(k):
        o = g(arrays, consts, overrides, valid, excl, garrays, gconsts,
              mb, jnp.arange(k, dtype=jnp.int32))
        return int(o[0]), float(o[1])

    run(1)
    marg = _marginal(run, k_hi=33)
    _emit("series_bucket_moments_rows_per_s", n / marg, 11e9)


def bench_config7(n_packs: int, rng):
    """Row materialization + streaming (r5, VERDICT r4 weak-#8 tail):
    the reference's hot path RETURNS ROWS (reader.go:288-450), so this
    config measures (a) the DEVICE side of selection+projection — mask
    -> selection vector -> column decode -> row gather for two
    projected columns, marginal-timed fully on device — and (b)
    end-to-end scan(project=...) and stream_batches rates including the
    fetch, split out in stderr comments."""
    import jax
    import jax.numpy as jnp

    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.ops import bitset as bs
    from knoxdb_tpu.ops import compact as CP
    from knoxdb_tpu.exec import device as D
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = PACK * n_packs
    sch = (Builder("c7").pk("id")
           .add("val", FieldType.UINT64)
           .add("bal", FieldType.INT64)
           .finish())
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
        "bal": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64),
    }
    seg = build_segment(sch, data, pack_size=PACK)
    sc = SegmentScanner(DeviceSegment(seg))
    d = sc.d
    # ~12%-selective filter: a real selection vector, not a degenerate
    # all-rows or near-empty one
    tree = and_(
        leaf(Filter(sch.field("val"), FilterMode.RANGE, (1000, 9000))),
        leaf(Filter(sch.field("bal"), FilterMode.GT, 0)),
    ).optimize()
    m = ((data["val"] >= 1000) & (data["val"] <= 9000)
         & (data["bal"] > 0))
    r0 = sc.scan(tree, [AggSpec("count")], project=["val", "bal"],
                 limit=1000)
    assert r0.count == int(m.sum()), "config7 count"
    assert (np.asarray([int(v) for v in r0.rows["val"]])
            == data["val"][np.asarray(r0.row_ids, np.int64)]).all()

    # (a) device-side selection+projection marginal: two tree variants
    # (dual-program shape, see config 2) -> mask ->
    # mask_to_indexes -> decode BOTH projected columns -> take_rows,
    # returning only scalar checksums
    _f1, args, raw = sc.prepare(tree, [])
    tree2 = and_(
        leaf(Filter(sch.field("val"), FilterMode.RANGE, (1001, 9001))),
        leaf(Filter(sch.field("bal"), FilterMode.GT, 1)),
    ).optimize()
    _f2, args2, _r2 = sc.prepare(tree2, [])
    arrays, consts, overrides, valid, excl = args
    consts_st = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), consts, args2[1])
    over_st = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([a, b]), overrides, args2[2])
    cap = max(1, 1 << (int(m.sum()) - 1).bit_length())
    cap = min(cap, d.P * d.N)
    proj_sigs = {nm: [(g.sig(), g.idx) for g in d.column(nm).groups]
                 for nm in ("val", "bal")}

    def mat_many(arrays, consts2, over2, valid, excl, idxs):
        def body(acc, i):
            j = (i % 2).astype(jnp.int32)
            c = jax.tree_util.tree_map(
                lambda s: jax.lax.dynamic_index_in_dim(s, j, 0, False),
                consts2)
            o = jax.tree_util.tree_map(
                lambda s: jax.lax.dynamic_index_in_dim(s, j, 0, False),
                over2)
            mask, _counts, _parts = raw(arrays, c, o, valid, excl)
            flat = bs.unpack_mask(mask).reshape(-1)
            idx, count = CP.mask_to_indexes(flat, cap)
            chk = count.astype(jnp.int64)
            for nm in ("val", "bal"):
                L = d.seg.columns[nm].nlimbs
                dec = jnp.zeros((L, d.P, d.N), jnp.uint32)
                for gsig, gidx in proj_sigs[nm]:
                    lim = D.group_decode_limbs(
                        gsig, arrays[nm][0], d.W)
                    dec = dec.at[:, gidx].set(lim)
                rowsv = CP.take_rows(dec.reshape(L, -1), idx)
                chk = chk + rowsv.sum(dtype=jnp.uint32).astype(jnp.int64)
            return acc + chk, None
        out, _ = jax.lax.scan(body, jnp.int64(0), idxs)
        return out

    g = jax.jit(mat_many)

    def run(k):
        return int(g(arrays, consts_st, over_st, valid, excl,
                     jnp.arange(k, dtype=jnp.uint64)))

    run(1)
    marg = _marginal(run, k_lo=1, k_hi=129)
    nsel = int(m.sum())
    print(f"# config7 device mat: {marg*1e3:.2f} ms/iter = "
          f"{n/marg/1e9:.2f} G scanned rows/s, "
          f"{nsel/marg/1e6:.0f} M selected rows/s (cap {cap})",
          file=sys.stderr)
    _emit("materialize_rows_per_s", n / marg, 11e9)

    # (b) honest end-to-end: project with limit ladder + stream
    for limit in (1000, 100_000, 0):
        ts = sorted(
            _time(lambda: sc.scan(tree, [AggSpec("count")],
                                  project=["val", "bal"], limit=limit))
            for _ in range(3))
        eff = min(limit or nsel, nsel)
        print(f"# config7 e2e limit={limit or 'all'}: "
              f"{ts[1]*1e3:.0f} ms ({eff/max(ts[1],1e-9)/1e6:.1f} M "
              f"fetched rows/s incl. fetch)", file=sys.stderr)

    def stream_all():
        tot = 0
        for b in sc.scan_stream(tree, ["val", "bal"], batch_packs=64):
            tot += b.count
        return tot

    st = sorted(_time(stream_all) for _ in range(3))
    print(f"# config7 stream_batches: {st[1]*1e3:.0f} ms e2e = "
          f"{nsel/max(st[1],1e-9)/1e6:.1f} M streamed rows/s incl. "
          f"fetch", file=sys.stderr)


def main():
    import argparse
    ap = argparse.ArgumentParser("bench_suite")
    ap.add_argument("configs", nargs="?",
                    default=os.environ.get("KNOX_BENCH_CONFIGS",
                                           "2,3,4,5,6"),
                    help="comma list of configs to run, e.g. 3,5")
    ap.add_argument("--packs", type=int,
                    default=int(os.environ.get("KNOX_BENCH_PACKS", 64)))
    args = ap.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"bench_suite.py: no GPU (platform {dev.platform})")
    n_packs = args.packs
    rng = np.random.default_rng(0xC0FFEE)
    which = args.configs.split(",")
    for w in which:
        t0 = time.perf_counter()
        import functools
        {"2": bench_config2, "3": bench_config3,
         "3b": functools.partial(bench_config3, G=8192),
         "3c": functools.partial(bench_config3, G=65536),
         "4": bench_config4, "5": bench_config5,
         "6": bench_config6, "7": bench_config7}[w.strip()](n_packs, rng)
        print(f"# config {w} done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)


if __name__ == "__main__":
    main()
