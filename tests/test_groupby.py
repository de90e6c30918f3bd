"""Group-by aggregation vs numpy oracle (BASELINE config #3: group-by
account with sum/min/max over decimal64 balances)."""

from dataclasses import dataclass

import numpy as np
import pytest

import knoxdb_tpu.knox as knox
from knoxdb_tpu.schema.schema import Builder
from knoxdb_tpu.types import FieldType


@pytest.fixture
def db(tmp_path):
    d = knox.create_database("g", driver="mem", path=str(tmp_path),
                             pack_size=512, background_merge=False)
    yield d
    d.close()


def _mk(db, rng, n=4000, nacct=37):
    sch = (Builder("ledger").pk("id")
           .add("account", FieldType.UINT32)
           .add("balance", FieldType.DECIMAL64, scale=2)
           .add("delta", FieldType.INT64)
           .finish())
    t = db.create_table(sch)
    acct = rng.integers(1, nacct + 1, n).astype(np.uint32)
    bal = rng.integers(-10**6, 10**6, n)
    delta = rng.integers(-1000, 1000, n)
    t.insert({"id": np.zeros(n, np.uint64), "account": acct,
              "balance": bal, "delta": delta})
    return t, acct, bal, delta


def test_group_sum_min_max(db, rng):
    t, acct, bal, delta = _mk(db, rng)
    t.merge()
    out = t.query().group_by("account").aggregate(
        ("count", ""), ("sum", "balance"), ("min", "delta"), ("max", "delta"))
    keys = np.asarray(out["keys"], np.uint32)
    want_keys = np.unique(acct)
    np.testing.assert_array_equal(keys, want_keys)
    for i, a in enumerate(want_keys):
        m = acct == a
        assert out["count"][i] == m.sum()
        assert out[("sum", "balance")][i] == pytest.approx(
            bal[m].sum() / 100)
        assert out[("min", "delta")][i] == delta[m].min()
        assert out[("max", "delta")][i] == delta[m].max()


def test_group_with_filter_and_journal(db, rng):
    t, acct, bal, delta = _mk(db, rng, n=3000)
    t.merge()
    # journal-resident extra rows
    t.insert({"id": np.zeros(10, np.uint64),
              "account": np.full(10, 99, np.uint32),
              "balance": np.arange(10) * 100,
              "delta": np.full(10, 7)})
    out = t.query().where(knox.F("delta") >= 0) \
        .group_by("account").aggregate(("sum", "delta"), ("count", ""))
    aa = np.concatenate([acct, np.full(10, 99, np.uint32)])
    dd = np.concatenate([delta, np.full(10, 7)])
    m = dd >= 0
    want_keys = np.unique(aa[m])
    np.testing.assert_array_equal(np.asarray(out["keys"], np.uint32),
                                  want_keys)
    for i, a in enumerate(want_keys):
        mm = m & (aa == a)
        assert out[("sum", "delta")][i] == int(dd[mm].sum())


def test_group_avg_signed(db, rng):
    t, acct, bal, delta = _mk(db, rng, n=1000, nacct=5)
    t.merge()
    out = t.query().group_by("account").aggregate(("avg", "delta"))
    for i, a in enumerate(np.asarray(out["keys"], np.uint32)):
        m = acct == a
        assert float(out[("avg", "delta")][i]) == pytest.approx(
            delta[m].mean())


def test_group_dict_scheme(db, rng):
    """Sparse high keys force the DICT scheme -> LUT gid path."""
    sch = (Builder("s").pk("id")
           .add("k", FieldType.UINT64)
           .add("v", FieldType.INT64)
           .finish())
    t = db.create_table(sch)
    n = 2000
    keyspace = rng.choice(np.arange(1 << 30, 1 << 40, (1 << 40) // 19,
                                    dtype=np.uint64), 12, replace=False)
    k = rng.choice(keyspace, n)
    v = rng.integers(0, 1000, n)
    t.insert({"id": np.zeros(n, np.uint64), "k": k, "v": v})
    t.merge()
    out = t.query().group_by("k").aggregate(("sum", "v"))
    want = np.unique(k)
    np.testing.assert_array_equal(np.asarray(out["keys"], np.uint64), want)
    for i, kk in enumerate(want):
        assert out[("sum", "v")][i] == int(v[k == kk].sum())


def test_mxu_group_aggregate_matches_sort(rng):
    """One-hot MXU matmul kernel == sort kernel (count/sum), including
    extreme u64 values that stress chunk exactness."""
    import jax.numpy as jnp
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.ops import bitset as bs
    P, N, G = 4, 2048, 100
    gids = jnp.asarray(rng.integers(-1, G + 2, (P, N)).astype(np.int32))
    vals = rng.integers(0, 1 << 63, (P, N), dtype=np.uint64)
    vals[0, :10] = np.uint64(0xFFFFFFFFFFFFFFFF)     # extreme chunks
    vals_j = jnp.asarray(vals)
    mask = rng.random((P, N)) < 0.7
    mw = jnp.asarray(np.stack([bs.np_pack_mask(mask[p]) for p in range(P)]))
    c1, lo1, hi1, _, _ = GB.group_aggregate(gids, mw, vals_j, G)
    c2, chunks, _, _ = GB.group_aggregate_mxu(gids, mw, vals_j, G)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    s1 = [int(l) + (int(h) << 32) for l, h in zip(np.asarray(lo1),
                                                  np.asarray(hi1))]
    s2 = GB.mxu_chunk_sums(chunks)
    assert s1 == list(s2)


def test_mxu_factored_matches_sort(rng):
    """Two-level factored MXU kernel (G >= _MXU_FACTORED_MIN_G) == sort
    kernel, at G values that stress the hi/lo split edges: G just past
    the threshold, an exact H*L multiple, and a ragged last hi row."""
    import jax.numpy as jnp
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.ops import bitset as bs
    P, N = 4, 2048
    for G in (GB._MXU_FACTORED_MIN_G, 1000, 1024):
        gids = jnp.asarray(rng.integers(-1, G + 2, (P, N)).astype(np.int32))
        vals = rng.integers(0, 1 << 63, (P, N), dtype=np.uint64)
        vals[0, :10] = np.uint64(0xFFFFFFFFFFFFFFFF)
        vals_j = jnp.asarray(vals)
        mask = rng.random((P, N)) < 0.7
        mw = jnp.asarray(np.stack([bs.np_pack_mask(mask[p])
                                   for p in range(P)]))
        c1, lo1, hi1, _, _ = GB.group_aggregate(gids, mw, vals_j, G)
        c2, chunks, _, _ = GB._group_mxu_factored(gids, mw, vals_j, G)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        s1 = [int(l) + (int(h) << 32) for l, h in zip(np.asarray(lo1),
                                                      np.asarray(hi1))]
        assert s1 == list(GB.mxu_chunk_sums(chunks)), f"G={G}"


def test_group_query_sum_only_uses_mxu(rng):
    """count/sum group query must produce identical results through the
    MXU path (engine chooses it when no min/max is requested)."""
    import knoxdb_tpu.knox as knox
    from dataclasses import dataclass

    @dataclass
    class R:
        id: int = 0
        g: int = 0
        v: int = 0

    db = knox.create_database("mxu", driver="mem", pack_size=512,
                              background_merge=False)
    t = db.create_table(R)
    n = 20_000
    g = rng.integers(0, 50, n)
    v = rng.integers(-1 << 50, 1 << 50, n)
    t.insert({"id": np.zeros(n, np.uint64), "g": g, "v": v})
    t.merge()
    out = t.query().group_by("g").aggregate(("count", ""), ("sum", "v"))
    for i, k in enumerate(out["keys"]):
        m = g == int(k)
        assert out["count"][i] == int(m.sum())
        assert int(out[("sum", "v")][i]) == int(v[m].astype(object).sum())
    # and the min/max flavour still works (sort path)
    out2 = t.query().group_by("g").aggregate(("min", "v"), ("max", "v"))
    for i, k in enumerate(out2["keys"]):
        m = g == int(k)
        assert int(out2[("min", "v")][i]) == int(v[m].min())
        assert int(out2[("max", "v")][i]) == int(v[m].max())
    db.close()


def test_group_var_std(rng):
    """GroupQuery var/std (sample, NaN below 2 rows; decimal scaling
    squares for var) vs numpy oracle."""
    import math
    import knoxdb_tpu.knox as knox
    from dataclasses import dataclass

    @dataclass
    class R:
        id: int = 0
        g: int = 0
        v: int = 0

    db = knox.create_database("gvar", driver="mem", pack_size=256,
                              background_merge=False)
    t = db.create_table(R)
    n = 6000
    g = rng.integers(0, 30, n)
    v = rng.integers(-10**6, 10**6, n)
    t.insert({"id": np.zeros(n, np.uint64), "g": g, "v": v})
    t.merge()
    t.insert([R(g=99, v=5)])          # journal row, single-row group
    out = t.query().group_by("g").aggregate(("var", "v"), ("std", "v"))
    for i, k in enumerate(out["keys"]):
        m = g == int(k)
        if int(k) == 99:
            assert math.isnan(out[("var", "v")][i])
            continue
        w = float(np.var(v[m].astype(np.float64), ddof=1))
        assert abs(out[("var", "v")][i] - w) <= 1e-9 * max(w, 1)
        assert abs(out[("std", "v")][i] - math.sqrt(w)) <= 1e-9
    db.close()


def test_chunk_plan_and_bias(rng):
    """Stats-driven chunk shrink: biased narrow-range values aggregate
    exactly with fewer byte chunks across flat/factored kernels."""
    import jax.numpy as jnp
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.ops import bitset as bs
    from knoxdb_tpu.pack.stats import FieldStats

    # signed-keyform-like domain: huge bias, narrow 20-bit spread
    base = np.uint64(1 << 63)
    P, N = 4, 2048
    vals = base + rng.integers(0, 1 << 20, (P, N)).astype(np.uint64)
    fs = FieldStats(min_key=vals.min(axis=1), max_key=vals.max(axis=1))
    C, b = GB.chunk_plan(fs)
    assert C == 3 and b == int(vals.min())
    assert GB.chunk_plan(None) == (8, 0)
    wide = FieldStats(min_key=np.array([1 << 70], object),
                      max_key=np.array([1 << 80], object))
    assert GB.chunk_plan(wide) == (8, 0)
    small = FieldStats(min_key=np.array([0], np.uint64),
                       max_key=np.array([200], np.uint64))
    assert GB.chunk_plan(small) == (1, 0)

    mask = rng.random((P, N)) < 0.8
    mw = jnp.asarray(np.stack([bs.np_pack_mask(mask[p]) for p in range(P)]))
    vals_j = jnp.asarray(vals)
    for G in (100, 1000):            # flat and factored regimes
        gids = jnp.asarray(rng.integers(-1, G + 2, (P, N)).astype(np.int32))
        c1, lo1, hi1, _, _ = GB.group_aggregate(gids, mw, vals_j, G)
        c2, chunks, _, _ = GB.group_aggregate_mxu(
            gids, mw, vals_j, G, n_chunks=C, bias=jnp.uint64(b))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        want = [int(l) + (int(h) << 32) for l, h in zip(np.asarray(lo1),
                                                        np.asarray(hi1))]
        got = [s + b * int(cc) for s, cc in
               zip(GB.mxu_chunk_sums(chunks), np.asarray(c2))]
        assert got == want, f"G={G}"


def test_mxu_factored_high_g(rng):
    """G in (4096, 16384]: the factored one-hot path must match the sort
    kernel."""
    import jax.numpy as jnp
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.ops import bitset as bs
    P, N, G = 2, 4096, 8192
    gids = jnp.asarray(rng.integers(-1, G + 2, (P, N)).astype(np.int32))
    vals = rng.integers(0, 1 << 50, (P, N), dtype=np.uint64)
    vals_j = jnp.asarray(vals)
    mask = rng.random((P, N)) < 0.8
    mw = jnp.asarray(np.stack([bs.np_pack_mask(mask[p]) for p in range(P)]))
    c1, lo1, hi1, _, _ = GB.group_aggregate(gids, mw, vals_j, G)
    c2, chunks, _, _ = GB.group_aggregate_mxu(gids, mw, vals_j, G)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    s1 = [int(l) + (int(h) << 32) for l, h in zip(np.asarray(lo1),
                                                  np.asarray(hi1))]
    assert s1 == list(GB.mxu_chunk_sums(chunks))


@pytest.mark.slow
def test_group_query_g16384_and_orderby_k_large(rng):
    """Host-path scaling (r4, VERDICT r3 next-#5): a G=16384 group query
    and a k=25k top-k ORDER BY run with NO per-group/per-row host
    python — the vectorized combine must stay oracle-exact at sizes
    where the old G-loop took ~10^6 interpreter steps."""
    import time
    from dataclasses import dataclass

    @dataclass
    class R:
        id: int = 0
        g: int = 0
        v: int = 0

    db = knox.create_database("bigg", driver="mem", pack_size=8192,
                              background_merge=False)
    t = db.create_table(R)
    n, G = 200_000, 16_384
    g = rng.integers(0, G, n)
    v = rng.integers(-1 << 50, 1 << 50, n)
    t.insert({"id": np.zeros(n, np.uint64), "g": g, "v": v})
    t.merge()

    t0 = time.perf_counter()
    out = t.query().group_by("g").aggregate(
        ("count", ""), ("sum", "v"), ("min", "v"), ("max", "v"))
    t_group = time.perf_counter() - t0

    keys = np.asarray([int(k) for k in out["keys"]])
    order = np.argsort(g, kind="stable")
    gs, vs = g[order], v[order]
    bounds = np.searchsorted(gs, np.arange(G + 1))
    have = np.flatnonzero(np.diff(bounds) > 0)
    np.testing.assert_array_equal(keys, have)
    cnts = np.diff(bounds)[have]
    np.testing.assert_array_equal(np.asarray(out["count"]), cnts)
    csum = np.concatenate([[0], np.cumsum(vs.astype(object))])
    want_sum = (csum[bounds[1:]] - csum[bounds[:-1]])[have]
    assert [int(x) for x in out[("sum", "v")]] == [int(x) for x in want_sum]
    # sampled min/max (full vector min via reduceat is fine too)
    mn = np.minimum.reduceat(vs, bounds[:-1])[have]
    mx = np.maximum.reduceat(vs, bounds[:-1])[have]
    assert [int(x) for x in out[("min", "v")]] == [int(x) for x in mn]
    assert [int(x) for x in out[("max", "v")]] == [int(x) for x in mx]

    # top-k ORDER BY at k = n/8 (use_topk engages below n/4)
    k = 25_000
    t0 = time.perf_counter()
    res = t.query().order_by("v").limit(k).select("v").rows()
    t_topk = time.perf_counter() - t0
    want = np.sort(v)[:k]
    np.testing.assert_array_equal(np.asarray(res["v"], np.int64), want)
    # regression guard against the pre-r4 per-row/per-group python
    # paths (minutes at these sizes); generous bound — CI runs tests
    # under heavy CPU contention
    assert t_group < 120 and t_topk < 120, (t_group, t_topk)
    db.close()


def test_group_moments_mxu_fused_vs_oracle(rng):
    """Exact one-hot moments (value + square chunks) against a
    python-int oracle."""
    import jax.numpy as jnp
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.ops import bitset as bs
    P, N, G = 2, 2048, 1000
    gids = rng.integers(-1, G + 1, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << 31, (P, N), dtype=np.uint64)  # r < 2^32
    mask = rng.random((P, N)) < 0.7
    mw = jnp.asarray(np.stack([bs.np_pack_mask(mask[p]) for p in range(P)]))
    gj = jnp.asarray(gids)
    rlo = jnp.asarray(vals.astype(np.uint32))
    rhi = jnp.zeros((P, N), jnp.uint32)
    qlo, qhi = GB.square_halves(rlo)
    c, ch1, ch2 = GB.group_moments_mxu(gj, mw, (rlo, rhi), (qlo, qhi), G,
                                       4, 8)
    ok = mask & (gids >= 0) & (gids < G)
    wc = np.zeros(G, np.int64)
    ws = np.zeros(G, object)
    wq = np.zeros(G, object)
    for p in range(P):
        for i in np.flatnonzero(ok[p]):
            g = int(gids[p, i])
            v = int(vals[p, i])
            wc[g] += 1
            ws[g] += v
            wq[g] += v * v
    np.testing.assert_array_equal(np.asarray(c), wc)
    assert list(GB.mxu_chunk_sums(ch1)) == list(ws), "value sums"
    assert list(GB.mxu_chunk_sums(ch2)) == list(wq), "square sums"


def test_bucket32_gid_paths(rng):
    """r4 bucket32/bucket32s gid fast paths vs the u64 reference:
    below-t0 rows -> -1, beyond-range rows -> drop bin, pow2 interval
    rides the static shift tag."""
    import jax.numpy as jnp
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec import groupby as GB
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType

    n = 4096
    t0, G = 1_000_000, 64
    sch = Builder("b").pk("id").add("ts", FieldType.UINT64).finish()
    for iv, want_tag in ((64, "bucket32s:6"), (100, "bucket32"),
                         ((1 << 40), "bucket")):
        span = G * iv
        ts = (t0 - 500 + rng.integers(0, span + 3000, n)).astype(np.uint64)
        seg = build_segment(sch, {"id": np.zeros(n, np.uint64), "ts": ts},
                            pack_size=1024)
        d = DeviceSegment(seg)
        gplan = GB.plan_buckets(d, "ts", t0, iv, G)
        assert gplan.mode[0][0] == want_tag, (iv, gplan.mode[0][0])
        tcol = d.column("ts")
        gids = GB.row_gids(tuple(m[0] for m in gplan.mode),
                           tuple(g.sig() for g in tcol.groups),
                           tuple(g.idx for g in tcol.groups),
                           [g.arrays for g in tcol.groups],
                           GB.gid_consts(gplan), d.W)
        got = np.asarray(gids).reshape(-1)[:n]
        want = np.where(ts < t0, -1,
                        ((ts - t0) // np.uint64(iv)).astype(np.int64))
        # out-of-range rows may carry ANY gid >= G (drop bin); compare
        # in-range exactly and class out-of-range
        inr = (ts >= t0) & (ts < t0 + span)
        np.testing.assert_array_equal(got[inr], want[inr])
        assert (got[ts < t0] == -1).all()
        over = (ts >= t0 + span)
        assert (got[over] >= G).all()


def test_group_plan_cache_no_tree_collision(rng):
    """r5 regression: two group queries with DIFFERENT filter trees but
    the same (group field, agg fields, G) must not share a compiled
    closure — the pre-r5 cache signature omitted the mask plan, so the
    second query ran the first query's mask function (probe find)."""
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = 8192
    sch = (Builder("t").pk("id")
           .add("g", FieldType.UINT32)
           .add("v", FieldType.INT64)
           .finish())
    g = rng.integers(0, 16, n).astype(np.uint32)
    v = rng.integers(-1 << 30, 1 << 30, n)
    seg = build_segment(sch, {"id": np.arange(1, n + 1, dtype=np.uint64),
                              "g": g, "v": v}, pack_size=1024)
    sc = SegmentScanner(DeviceSegment(seg))

    def check(tree, m):
        gplan, counts, res = sc.group_scan(tree, "g", ["v"],
                                           minmax=False)
        want = np.bincount(g[m].astype(np.int64), minlength=16)
        np.testing.assert_array_equal(counts, want)
        wsum = np.zeros(16, object)
        np.add.at(wsum, g[m].astype(np.int64), v[m].astype(object))
        bias = 1 << 63
        sums = res["v"][0]
        assert [int(s) - int(c) * bias
                for s, c in zip(sums, counts)] == [int(x) for x in wsum]

    # no tree, then a 1-leaf tree, then a 2-leaf tree — same group sig
    check(None, np.ones(n, bool))
    t1 = leaf(Filter(sch.field("v"), FilterMode.GT, 0)).optimize()
    check(t1, v > 0)
    t2 = and_(leaf(Filter(sch.field("v"), FilterMode.GT, 0)),
              leaf(Filter(sch.field("g"), FilterMode.LT, 9))).optimize()
    check(t2, (v > 0) & (g < 9))
