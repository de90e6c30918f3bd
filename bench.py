"""Flagship benchmark: scan + filter + aggregate rows/s on one chip.

BASELINE.json config #1: uint64 range filter + count/sum over compressed
64K-row packs. The reference's best filter kernel does ~11 G rows/s
(~88 GB/s AVX2 u64 EQ, BASELINE.md); vs_baseline = our rows/s over that.

Timing method: K query variants (distinct traced constants each
iteration) run inside ONE compiled call, and the bench reports MARGINAL
rows/s, which leaves out the fixed per-call dispatch and fetch cost:
    rows/s = rows * (K_hi - K_lo) / (t(K_hi) - t(K_lo))
Every iteration's aggregate feeds the final result (no dead code), and
iteration constants are derived non-periodically from the index (no
hoisting). Correctness of the i=0 query is asserted against a numpy
oracle before timing. A measurement needs the GPU: the script fails
elsewhere unless JAX_PLATFORMS=cpu asks for the CPU on purpose.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline",
"device"}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REF_ROWS_PER_S = 11e9   # BASELINE.md: u64 EQ AVX2 ~88 GB/s = 11 G rows/s


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"bench.py: no GPU (platform {dev.platform})")

    from knoxdb_tpu.exec.device import DeviceSegment
    from knoxdb_tpu.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu.pack.segment import build_segment
    from knoxdb_tpu.query.filter import Filter, and_, leaf
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType, FilterMode

    pack_size = 1 << 16
    n_packs = int(os.environ.get("KNOX_BENCH_PACKS",
                                 sys.argv[1] if len(sys.argv) > 1 else 256))
    n_rows = pack_size * n_packs

    rng = np.random.default_rng(0xBEEF)
    sch = (Builder("bench").pk("id")
           .add("val", FieldType.UINT64)
           .add("bal", FieldType.INT64)
           .finish())
    data = {
        "id": np.arange(1, n_rows + 1, dtype=np.uint64),
        "val": rng.integers(0, 1 << 16, n_rows, dtype=np.uint64),
        "bal": rng.integers(-1 << 40, 1 << 40, n_rows, dtype=np.int64),
    }
    t0 = time.perf_counter()
    seg = build_segment(sch, data, pack_size=pack_size)
    t_build = time.perf_counter() - t0

    sc = SegmentScanner(DeviceSegment(seg))
    # BASELINE config #1: u64 range filter + count/sum over the filtered
    # column (same shape as the reference's 11 G rows/s u64 filter
    # kernel baseline). The harder multi-column AND query is asserted for
    # correctness below but not timed (that's config #2 territory).
    tree = leaf(Filter(sch.field("val"), FilterMode.RANGE,
                       (1000, 50000))).optimize()
    aggs = [AggSpec("count"), AggSpec("sum", "val")]

    # correctness first (exact vs numpy oracle), also warms the plan cache
    res = sc.scan(tree, aggs)
    m = (data["val"] >= 1000) & (data["val"] <= 50000)
    assert res.count == int(m.sum()), "bench result mismatch"
    assert res.aggs[("sum", "val")] == int(data["val"][m].astype(object).sum())
    tree2 = and_(
        leaf(Filter(sch.field("val"), FilterMode.RANGE, (1000, 50000))),
        leaf(Filter(sch.field("bal"), FilterMode.GT, 0)),
    ).optimize()
    res2 = sc.scan(tree2, [AggSpec("count"), AggSpec("sum", "bal")])
    m2 = m & (data["bal"] > 0)
    assert res2.count == int(m2.sum())
    assert res2.aggs[("sum", "bal")] == int(data["bal"][m2].astype(object).sum())

    # K-iteration variant: constants perturbed per iteration (golden-ratio
    # step keeps selectivity ~stable and defeats loop hoisting)
    marginal, t_lo, t_hi, t_compile = _timed_loop(sc, tree, aggs)

    rows_per_s = n_rows / marginal

    # SAME-RUN bandwidth self-calibration: measure what a plain device
    # memory stream achieves in this run, so a throttled card can't read
    # as a regression (or vice versa). The scan's device traffic model:
    # one pass over the filtered+summed column's bit planes, plus the
    # valid words in and the match mask out (the XLA plan reads the
    # planes a second time for the popcount sweep; the model counts one)
    col_bytes = sum(p.planes.nbytes for p in seg.columns["val"].packs)
    col_bytes += 3 * (n_rows // 8)
    stream_bps = _stream_bandwidth()
    eff_bps = col_bytes / marginal
    pct = 100.0 * eff_bps / stream_bps
    bw_note = (f" stream={stream_bps/1e9:.0f}GB/s "
               f"eff={eff_bps/1e9:.0f}GB/s pct_of_measured_bw={pct:.0f}")

    print(json.dumps({
        "metric": "scan_filter_agg_rows_per_s",
        "value": rows_per_s,
        "unit": "rows/s",
        "vs_baseline": rows_per_s / REF_ROWS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    print(f"# n_rows={n_rows} marginal={marginal*1e3:.3f}ms t_lo={t_lo*1e3:.1f}ms "
          f"t_hi={t_hi*1e3:.1f}ms compile={t_compile:.1f}s build={t_build:.1f}s "
          f"platform={jax.devices()[0].platform}{bw_note}", file=sys.stderr)


def _stream_bandwidth() -> float:
    """Achievable device memory read bandwidth (bytes/s), measured with the same
    marginal-throughput method as the query loop: K xor+reduce passes
    over a 256 MB u32 array inside one jit (per-iteration xor with the
    traced index defeats CSE; one read pass per iteration)."""
    import jax
    import jax.numpy as jnp
    n = (256 << 20) // 4
    x = jnp.arange(n, dtype=jnp.uint32)

    def many(x, idxs):
        def body(acc, i):
            return acc + (x ^ i).sum(dtype=jnp.uint32), None
        out, _ = jax.lax.scan(body, jnp.uint32(0), idxs)
        return out

    g = jax.jit(many)

    def run(k):
        return int(g(x, jnp.arange(k, dtype=jnp.uint32)))

    run(1)
    K_LO, K_HI = 1, 33
    pairs = [(_time(run, K_LO), _time(run, K_HI)) for _ in range(3)]
    margs = sorted(max((hi - lo) / (K_HI - K_LO), 1e-9)
                   for lo, hi in pairs)
    return x.nbytes / margs[len(margs) // 2]


def _timed_loop(sc, tree, aggs):
    import jax
    import jax.numpy as jnp

    _fn, args, raw = sc.prepare(tree, aggs)
    arrays, consts, overrides, valid, excl = args

    def shift_consts(consts, i):
        step = (i * jnp.uint64(0x9E3779B1)) % jnp.uint64(4096)

        def bump(x):
            if x.dtype == jnp.uint64 and x.ndim == 0:
                return x + step
            return x
        return jax.tree_util.tree_map(bump, consts)

    # static scan length -> one compiled program per K (two Ks total)
    def many(arrays, consts, overrides, valid, excl, idxs):
        def body(acc, i):
            c = shift_consts(consts, i)
            _mask, counts, parts = raw(arrays, c, overrides, valid, excl)
            lo, hi, _cnts = parts[1][0]
            chk = (lo.sum() + hi.sum()).astype(jnp.int64)
            return (acc[0] + counts.sum(), acc[1] + chk), None
        out, _ = jax.lax.scan(body, (jnp.int64(0), jnp.int64(0)), idxs)
        return out

    g = jax.jit(many)

    def run(k):
        out = g(arrays, consts, overrides, valid, excl,
                jnp.arange(k, dtype=jnp.uint64))
        return int(out[0]), int(out[1])   # host fetch forces completion

    t0 = time.perf_counter()
    run(1)
    t_compile = time.perf_counter() - t0

    # enough iterations that the marginal signal dwarfs host timing
    # noise; MEDIAN of 5 independent window pairs (medians, not best-of)
    K_LO, K_HI = 1, 513
    pairs = [(_time(run, K_LO), _time(run, K_HI)) for _ in range(5)]
    margs = sorted(max((hi - lo) / (K_HI - K_LO), 1e-9)
                   for lo, hi in pairs)
    marginal = margs[len(margs) // 2]
    t_lo = min(p[0] for p in pairs)
    t_hi = min(p[1] for p in pairs)
    return marginal, t_lo, t_hi, t_compile


def _time(fn, k):
    t0 = time.perf_counter()
    fn(k)
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
