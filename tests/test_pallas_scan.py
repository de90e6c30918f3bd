"""Bit-sliced scan (ops/bitslice, the XLA sweep every plan runs) vs
numpy oracles: range compare, masked per-plane counts and exact sums,
and whole filter trees with multi-aggregates through SegmentScanner."""

import numpy as np
import jax.numpy as jnp
import pytest

from knoxdb_tpu.encode import schemes as S
from knoxdb_tpu.ops import bitset as bs
from knoxdb_tpu.ops import bitslice as B


def _sweep(planes, mins, valid, lo, hi, width):
    """The XLA sweep: range compare, then masked per-plane counts."""
    import jax
    planes = jnp.asarray(planes)
    mask = B.range_planes(planes, jnp.asarray(mins), lo, hi, width) \
        & jnp.asarray(valid)
    cnt = jax.lax.population_count(mask).astype(jnp.int32).sum(axis=-1)
    pcnt = jnp.stack([
        jax.lax.population_count(planes[p] & mask).astype(jnp.int32)
        .sum(axis=-1) for p in range(width)], axis=1)
    return mask, pcnt, cnt


@pytest.mark.parametrize("width,P", [(8, 8), (16, 8), (1, 16),
                                     (41, 8)])
def test_fused_range_sum_matches_oracle(rng, width, P):
    N = 1024
    vals = rng.integers(0, 1 << width, (P, N), dtype=np.uint64)
    mins = rng.integers(0, 500, P, dtype=np.uint64)
    vals_abs = vals + mins[:, None]
    planes = np.stack([
        S.encode_bitpack(vals_abs[p], 1, int(mins[p]), width, N).planes
        for p in range(P)], axis=1)     # plane-major [w, P, W]
    valid = np.full((P, N // 32), 0xFFFFFFFF, np.uint32)
    valid[-1, -2:] = 0x0000FFFF      # partial pack edge
    vbits = np.stack([bs.np_unpack_mask(valid[p], N) for p in range(P)])

    for lo, hi in [(400, 900), (0, 10**6), (10**6, 2 * 10**6), (550, 550)]:
        mask, pcnt, cnt = _sweep(planes, mins, valid, jnp.uint64(lo),
                                 jnp.uint64(hi), width)
        m = (vals_abs >= lo) & (vals_abs <= hi) & vbits
        want_mask = np.stack([bs.np_pack_mask(m[p]) for p in range(P)])
        np.testing.assert_array_equal(np.asarray(mask), want_mask,
                                      err_msg=f"[{lo},{hi}] mask")
        want_pcnt = np.stack([((vals >> np.uint64(b)) & np.uint64(1))
                              .astype(bool) & m for b in range(width)],
                             axis=-1).sum(axis=1)
        np.testing.assert_array_equal(np.asarray(pcnt), want_pcnt)
        np.testing.assert_array_equal(np.asarray(cnt), m.sum(axis=1))


def test_exact_sum_reconstruction(rng):
    width, P, N = 12, 8, 2048
    vals = rng.integers(0, 1 << width, (P, N), dtype=np.uint64)
    mins = np.array([10, 10**6, 0, 5, 7, 9, 11, 13], np.uint64)
    vals_abs = vals + mins[:, None]
    planes = np.stack([
        S.encode_bitpack(vals_abs[p], 1, int(mins[p]), width, N).planes
        for p in range(P)], axis=1)     # plane-major [w, P, W]
    valid = np.full((P, N // 32), 0xFFFFFFFF, np.uint32)
    lo, hi = jnp.uint64(500), jnp.uint64(10**6 + 3000)
    mask, pcnt, cnt = _sweep(planes, mins, valid, lo, hi, width)
    sums, cnt2 = B.masked_sum_planes(jnp.asarray(planes),
                                     jnp.asarray(mins), mask, width)
    pcnt, cnt = np.asarray(pcnt), np.asarray(cnt)
    for p in range(P):
        m = (vals_abs[p] >= 500) & (vals_abs[p] <= 10**6 + 3000)
        want = int(vals_abs[p][m].sum(dtype=object))
        got = sum(int(pcnt[p, b]) << b for b in range(width)) \
            + int(mins[p]) * int(cnt[p])
        assert got == want and cnt[p] == m.sum()
        assert int(np.asarray(sums)[p]) == want
        assert int(np.asarray(cnt2)[p]) == m.sum()


def test_whole_tree_fusion_vs_oracle(rng):
    """Multi-leaf plan: an AND of two bitpack leaves + a bytes EQ (a
    DICT leaf) with sum on a third bitpack column (agg NOT in the tree)
    — results must match the numpy oracle exactly."""
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = 16384
    sch = (Builder("t").pk("id")
           .add("a", FieldType.UINT64)
           .add("b", FieldType.INT64)
           .add("s", FieldType.STRING)
           .add("v", FieldType.UINT64)
           .finish())
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "a": rng.integers(0, 50_000, n, dtype=np.uint64),
        "b": rng.integers(-1 << 30, 1 << 30, n, dtype=np.int64),
        "s": np.array(["x", "y", "z"], object)[rng.integers(0, 3, n)],
        "v": rng.integers(0, 1 << 40, n, dtype=np.uint64),
    }
    seg = build_segment(sch, data, pack_size=2048)
    sc = SegmentScanner(DeviceSegment(seg))
    tree = and_(
        leaf(Filter(sch.field("a"), FilterMode.RANGE, (1000, 40_000))),
        leaf(Filter(sch.field("b"), FilterMode.GT, 0)),
        leaf(Filter(sch.field("s"), FilterMode.EQ, "y")),
    ).optimize()
    aggs = [AggSpec("count"), AggSpec("sum", "v")]
    res = sc.scan(tree, aggs)
    m = ((data["a"] >= 1000) & (data["a"] <= 40_000)
         & (data["b"] > 0) & (data["s"] == "y"))
    assert res.count == int(m.sum())
    assert res.aggs[("sum", "v")] == int(data["v"][m].astype(object).sum())

    # same query with sum on a LEAF column (agg in tree)
    res2 = sc.scan(tree, [AggSpec("count"), AggSpec("sum", "b")])
    assert res2.count == int(m.sum())
    assert res2.aggs[("sum", "b")] == int(data["b"][m].astype(object).sum())


def test_dict_leaf_fusion_vs_oracle(rng):
    """DICT (bytes + int-dict) leaves compare as per-pack code sets. Every fusable mode vs the numpy oracle, incl. values absent
    from some packs' dictionaries (miss -> empty code range)."""
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = 8192
    sch = (Builder("t").pk("id")
           .add("s", FieldType.STRING)
           .add("k", FieldType.UINT32)
           .add("v", FieldType.UINT64)
           .finish())
    # uniform dictionaries (every pack sees the full pool) -> ONE
    # device group; a nowhere-present value
    # ("qq") covers the empty-code-range miss path
    svals = np.array(["aa", "bb", "cc", "dd", "zz"], object)
    sidx = rng.integers(0, 5, n)
    kpool = np.array([10, 20, 30, 40, 500_000], np.uint64)
    kidx = rng.integers(0, 5, n)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "s": svals[sidx],
        "k": kpool[kidx].astype(np.uint64),
        "v": rng.integers(0, 1 << 30, n, dtype=np.uint64),
    }
    seg = build_segment(sch, data, pack_size=1024)
    sc = SegmentScanner(DeviceSegment(seg))
    from knoxdb_tpu.encode.schemes import Scheme
    assert sc.d.column("s").groups[0].scheme == Scheme.DICT
    assert sc.d.column("k").groups[0].scheme == Scheme.DICT

    cases = [
        (Filter(sch.field("s"), FilterMode.EQ, "zz"),
         data["s"] == "zz"),
        (Filter(sch.field("s"), FilterMode.EQ, "qq"),   # miss everywhere
         np.zeros(n, bool)),
        (Filter(sch.field("s"), FilterMode.RANGE, ("bb", "dd")),
         (data["s"] >= "bb") & (data["s"] <= "dd")),
        (Filter(sch.field("s"), FilterMode.GT, "cc"),
         data["s"] > "cc"),
        (Filter(sch.field("k"), FilterMode.EQ, 500_000),
         data["k"] == 500_000),
        (Filter(sch.field("k"), FilterMode.LE, 20),
         data["k"] <= 20),
        (Filter(sch.field("k"), FilterMode.RANGE, (20, 40)),
         (data["k"] >= 20) & (data["k"] <= 40)),
    ]
    for f, m_leaf in cases:
        tree = and_(leaf(f),
                    leaf(Filter(sch.field("v"), FilterMode.GT, 1000))
                    ).optimize()
        m = m_leaf & (data["v"] > 1000)
        res = sc.scan(tree, [AggSpec("count"), AggSpec("sum", "v")])
        assert res.count == int(m.sum()), f"{f.mode} count"
        assert res.aggs[("sum", "v")] == \
            int(data["v"][m].astype(object).sum()), f"{f.mode} sum"


def test_fused_vs_unfused_equivalence(rng):
    """A three-leaf tree (dict leaf in every fusable mode, incl. a value
    in no dictionary) through the XLA plan agrees with the host oracle
    (exec/oracle.eval_tree) on counts and exact sums."""
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = 8192
    sch = (Builder("t").pk("id")
           .add("s", FieldType.STRING)
           .add("a", FieldType.UINT64)
           .add("v", FieldType.INT64)
           .finish())
    svals = np.array(["aa", "bb", "cc", "dd", "zz"], object)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "s": svals[rng.integers(0, 5, n)],
        "a": rng.integers(0, 60_000, n, dtype=np.uint64),
        "v": rng.integers(-1 << 30, 1 << 30, n, dtype=np.int64),
    }
    seg = build_segment(sch, data, pack_size=1024)
    queries = []
    for mode, val in [(FilterMode.EQ, "bb"), (FilterMode.GT, "cc"),
                      (FilterMode.LE, "aa"), (FilterMode.EQ, "qq"),
                      (FilterMode.RANGE, ("bb", "dd"))]:
        queries.append(and_(
            leaf(Filter(sch.field("s"), mode, val)),
            leaf(Filter(sch.field("a"), FilterMode.RANGE, (5, 55_000))),
            leaf(Filter(sch.field("v"), FilterMode.GT, -1000)),
        ).optimize())
    aggs = [AggSpec("count"), AggSpec("sum", "v")]

    from knoxdb_tpu.exec import oracle as ORC
    sc = SegmentScanner(DeviceSegment(seg))
    got = [(r.count, r.aggs[("sum", "v")])
           for r in (sc.scan(q, aggs) for q in queries)]
    want = []
    for q in queries:
        m = ORC.eval_tree(q, data, n)
        want.append((int(m.sum()), int(data["v"][m].astype(object).sum())))
    assert got == want


def test_mask_only_tree_fusion(rng):
    """Mask-only plans (count-only, no aggregate column) stay
    oracle-exact, incl. projection through the plan's mask, and a fresh
    scanner gives identical results."""
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = 8192
    sch = (Builder("t").pk("id")
           .add("a", FieldType.UINT64)
           .add("b", FieldType.INT64)
           .finish())
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "a": rng.integers(0, 50_000, n, dtype=np.uint64),
        "b": rng.integers(-1 << 30, 1 << 30, n, dtype=np.int64),
    }
    seg = build_segment(sch, data, pack_size=1024)
    sc = SegmentScanner(DeviceSegment(seg))
    tree = and_(
        leaf(Filter(sch.field("a"), FilterMode.RANGE, (100, 30_000))),
        leaf(Filter(sch.field("b"), FilterMode.LE, 12345)),
    ).optimize()
    m = (data["a"] >= 100) & (data["a"] <= 30_000) & (data["b"] <= 12345)
    res = sc.scan(tree, [AggSpec("count")])
    assert res.count == int(m.sum())
    res3 = sc.scan(tree, [AggSpec("count")], project=["a"], limit=50)
    assert len(res3.rows["a"]) == min(50, int(m.sum()))
    ids = np.asarray(res3.row_ids, np.int64)
    assert m[ids].all() and np.array_equal(
        np.asarray(res3.rows["a"], np.uint64), data["a"][ids])
    sc2 = SegmentScanner(DeviceSegment(seg))
    assert sc2.scan(tree, [AggSpec("count")]).count == res.count


def test_multi_agg_fused_kernel(rng):
    """count+sum+min+max (the driver entry() shape) over two aggregate
    columns matches the numpy oracle exactly, incl. a signed leaf
    column, a >32-bit-wide agg column (hi-half tournament bits), and an
    empty-result query."""
    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    n = 16384
    sch = (Builder("t").pk("id")
           .add("a", FieldType.UINT64)
           .add("b", FieldType.INT64)
           .add("v", FieldType.UINT64)
           .finish())
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "a": rng.integers(0, 50_000, n, dtype=np.uint64),
        "b": rng.integers(-1 << 30, 1 << 30, n, dtype=np.int64),
        "v": rng.integers(0, 1 << 40, n, dtype=np.uint64),
    }
    seg = build_segment(sch, data, pack_size=2048)
    sc = SegmentScanner(DeviceSegment(seg))
    tree = and_(
        leaf(Filter(sch.field("a"), FilterMode.RANGE, (1000, 40_000))),
        leaf(Filter(sch.field("b"), FilterMode.GT, -1 << 29)),
    ).optimize()
    aggs = [AggSpec("count"), AggSpec("sum", "v"), AggSpec("min", "v"),
            AggSpec("max", "v"), AggSpec("min", "b"), AggSpec("max", "b")]
    res = sc.scan(tree, aggs)
    m = ((data["a"] >= 1000) & (data["a"] <= 40_000)
         & (data["b"] > -(1 << 29)))
    assert res.count == int(m.sum())
    assert res.aggs[("sum", "v")] == int(data["v"][m].astype(object).sum())
    assert res.aggs[("min", "v")] == int(data["v"][m].min())
    assert res.aggs[("max", "v")] == int(data["v"][m].max())
    assert res.aggs[("min", "b")] == int(data["b"][m].min())
    assert res.aggs[("max", "b")] == int(data["b"][m].max())
    # the plan must fuse BOTH agg columns (v: sum+mm; b: mm only)
    # empty result: min/max are None, sum 0
    t0 = leaf(Filter(sch.field("a"), FilterMode.GT, 10 ** 9)).optimize()
    r0 = sc.scan(t0, aggs)
    assert r0.count == 0 and r0.aggs[("min", "v")] is None
    assert r0.aggs[("max", "b")] is None and r0.aggs[("sum", "v")] == 0
