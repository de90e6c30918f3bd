"""One-hot group-by (exec/groupby.group_aggregate_mxu: the flat and the
factored XLA paths) vs python oracles, from small G to MAX_GROUPS."""

import numpy as np
import jax.numpy as jnp
import pytest

from knoxdb_tpu.exec import groupby as GB


def _pack_mask(mask_rows):
    """bool[P, N] -> u32[P, N//32] valid words (bit i of word w = row
    w*32+i), matching ops/bitset layout used by unpack_mask."""
    P, N = mask_rows.shape
    bits = mask_rows.reshape(P, N // 32, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32)


def _oracle(gids, vals, maskb, G):
    ok = maskb & (gids >= 0) & (gids < G)
    want_cnt = np.bincount(gids[ok].astype(np.int64), minlength=G)
    want_sum = np.zeros(G, object)
    np.add.at(want_sum, gids[ok].astype(np.int64), vals[ok].astype(object))
    return want_cnt, [int(x) for x in want_sum]


@pytest.mark.parametrize("G,P,N", [(1000, 3, 8192), (200, 1, 4096),
                                   (4096, 2, 8192),
                                   (8192, 1, 8192),
                                   (6000, 1, 8192)])   # G < H*L
def test_pallas_group_matches_oracle(rng, G, P, N):
    gids = rng.integers(-2, G + 3, (P, N)).astype(np.int32)  # some invalid
    vals = rng.integers(0, 1 << 63, (P, N), dtype=np.uint64)
    vals[0, :16] = np.uint64(0xFFFFFFFFFFFFFFFF)             # carry stress
    maskb = rng.random((P, N)) < 0.7
    words = _pack_mask(maskb)

    counts, chunks, _, _ = GB.group_aggregate_mxu(
        jnp.asarray(gids), jnp.asarray(words), jnp.asarray(vals), G)
    want_cnt, want_sum = _oracle(gids, vals, maskb, G)
    np.testing.assert_array_equal(np.asarray(counts), want_cnt)
    assert list(GB.mxu_chunk_sums(chunks)) == want_sum


def test_pallas_group_dispatch(rng):
    """group_aggregate_mxu takes the flat one-hot below
    _MXU_FACTORED_MIN_G and the factored one from there up; both agree
    with the sort kernel."""
    P, N = 2, 4096
    for G in (GB._MXU_FACTORED_MIN_G - 1, GB._MXU_FACTORED_MIN_G, 512):
        gids = rng.integers(0, G, (P, N)).astype(np.int32)
        vals = rng.integers(0, 1 << 40, (P, N), dtype=np.uint64)
        words = np.full((P, N // 32), 0xFFFFFFFF, np.uint32)
        a = GB.group_aggregate_mxu(jnp.asarray(gids), jnp.asarray(words),
                                   jnp.asarray(vals), G)
        c, lo, hi, _, _ = GB.group_aggregate(
            jnp.asarray(gids), jnp.asarray(words), jnp.asarray(vals), G)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(c))
        want = [int(x) + (int(y) << 32) for x, y in zip(np.asarray(lo),
                                                       np.asarray(hi))]
        assert list(GB.mxu_chunk_sums(a[1])) == want, f"G={G}"


@pytest.mark.parametrize("G", [16384, 65536])
def test_factored_big_g_oracle(rng, G):
    """The factored path at the top of the group domain (MAX_GROUPS),
    incl. out-of-domain and masked rows and a partial last tile."""
    P, N = 2, 40960
    gids = rng.integers(-3, G + 5, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << 41, (P, N), dtype=np.uint64)
    maskb = rng.random((P, N)) < 0.9
    counts, chunks, _, _ = GB.group_aggregate_mxu(
        jnp.asarray(gids), jnp.asarray(_pack_mask(maskb)),
        jnp.asarray(vals), G, n_chunks=6)
    want_cnt, want_sum = _oracle(gids, vals, maskb, G)
    np.testing.assert_array_equal(np.asarray(counts), want_cnt)
    assert list(GB.mxu_chunk_sums(chunks)) == want_sum


def test_multipass_bigG_oracle(rng):
    """Oracle-exact counts + chunk sums at G=20000 through the factored
    path, incl. out-of-domain and masked rows."""

    G = 20000
    n = 65536
    gid = rng.integers(-5, G + 7, n).astype(np.int32)   # incl. invalid
    vlo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vhi = rng.integers(0, 1 << 8, n, dtype=np.uint64).astype(np.uint32)
    from knoxdb_tpu.ops import bitset as bs
    maskbits = rng.random(n) < 0.9
    mw = bs.np_pack_mask(maskbits).reshape(1, -1)
    keys = (vhi.astype(np.uint64) << np.uint64(32)) | vlo.astype(np.uint64)
    c_, ch, _mn, _mx = GB.group_aggregate_mxu(
        jnp.asarray(gid).reshape(1, -1), jnp.asarray(mw),
        jnp.asarray(keys).reshape(1, -1), G, n_chunks=6)
    ok = maskbits & (gid >= 0) & (gid < G)
    want_c = np.bincount(gid[ok], minlength=G)
    np.testing.assert_array_equal(np.asarray(c_), want_c)
    want = np.zeros((G, 6), object)
    for c in range(6):
        np.add.at(want[:, c], gid[ok],
                  (keys[ok].astype(object) >> (8 * c)) & 0xFF)
    for c in range(6):
        np.testing.assert_array_equal(
            np.asarray(ch[c]).astype(object), want[:, c])


def test_group_query_bigG_engine(rng):
    """Engine-level group query at G=20000 rides the factored one-hot
    path and stays oracle-exact."""
    import knoxdb_tpu.knox as knox
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.types import FieldType

    n = 1 << 15
    G = 20000
    db = knox.create_database("bigg", driver="mem", pack_size=4096,
                              background_merge=False)
    sch = (Builder("t").pk("id")
           .add("g", FieldType.UINT32)
           .add("v", FieldType.INT64)
           .finish())
    t = db.create_table(sch)
    g = rng.integers(0, G, n).astype(np.uint32)
    g[:G:7] = np.arange(0, G, 7)       # ensure domain spread
    v = rng.integers(-1 << 40, 1 << 40, n)
    t.insert({"id": np.zeros(n, np.uint64), "g": g, "v": v})
    t.merge()
    out = t.query().group_by("g").aggregate(("count", ""), ("sum", "v"))
    keys = np.asarray(out["keys"], np.int64)
    want_c = np.bincount(g.astype(np.int64), minlength=G)
    present = np.flatnonzero(want_c)
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], present)
    np.testing.assert_array_equal(
        np.asarray(out["count"])[order], want_c[present])
    wsum = np.zeros(G, object)
    np.add.at(wsum, g.astype(np.int64), v.astype(object))
    got = np.asarray(out[("sum", "v")])[order]
    assert [int(x) for x in got] == [int(wsum[i]) for i in present]
    db.close()


@pytest.mark.parametrize("G", [40, 3000])
def test_scanner_kernel_family_dispatch(rng, monkeypatch, G):
    """A scanner whose kernel family is "triton" routes the engine's
    group and series-moments plans through the Triton kernel (run here
    in interpret mode), and gives the same exact results as "xla"."""
    import knoxdb_tpu.knox as knox
    from knoxdb_tpu.schema.schema import Builder
    from knoxdb_tpu.series import SeriesRequest, run_series
    from knoxdb_tpu.types import FieldType

    calls = []
    real = GB._group_triton

    def traced(*a, **kw):
        calls.append(a[3])
        return real(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(GB, "_group_triton", traced)
    n = 1 << 13
    db = knox.create_database("fam", driver="mem", pack_size=4096,
                              background_merge=False)
    t = db.create_table(Builder("t").pk("id").add("g", FieldType.UINT32)
                        .add("ts", FieldType.UINT64)
                        .add("v", FieldType.UINT32).finish())
    t.insert({"id": np.zeros(n, np.uint64),
              "g": rng.integers(0, G, n).astype(np.uint32),
              "ts": np.arange(n, dtype=np.uint64) * np.uint64(10),
              "v": rng.integers(0, 1 << 20, n).astype(np.uint32)})
    t.merge()
    req = SeriesRequest(table=t, time_field="ts", start=0, end=n * 10,
                        interval=640, aggs=[("sum", "v"), ("var", "v")])
    out = {}
    for fam in ("xla", "triton"):
        for h in t._t.segments:
            h.scanner_().kernels = fam
        grp = t.query().group_by("g").aggregate(("count", ""), ("sum", "v"))
        ser = run_series(req)
        out[fam] = ({k: [int(x) for x in v] for k, v in grp.items()},
                    {k: [float(x) for x in v] for k, v in ser.items()})
    db.close()
    assert out["triton"] == out["xla"]
    assert G in calls and (n * 10) // 640 in calls   # group + moments


@pytest.mark.parametrize("G,P,N,C", [(20, 1, 4096, 6), (1000, 2, 8192, 6),
                                     (300, 1, 8192, 8), (8192, 1, 8192, 3)])
def test_triton_group_kernel_interpret(rng, G, P, N, C):
    """The Triton group kernel (ops/pallas_group) in Pallas interpret
    mode: exact counts and chunk sums vs the python oracle, incl. invalid
    gids, masked rows, full 8-byte values and a padded last split."""
    gids = rng.integers(-2, G + 3, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << min(63, 8 * C), (P, N), dtype=np.uint64)
    if C == 8:
        vals[0, :16] = np.uint64(0xFFFFFFFFFFFFFFFF)
    maskb = rng.random((P, N)) < 0.7
    counts, chunks, _, _ = GB._group_triton(
        jnp.asarray(gids), jnp.asarray(_pack_mask(maskb)),
        jnp.asarray(vals), G, n_chunks=C, interpret=True)
    want_cnt, want_sum = _oracle(gids, vals, maskb, G)
    np.testing.assert_array_equal(np.asarray(counts), want_cnt)
    assert list(GB.mxu_chunk_sums(chunks)) == want_sum


def test_triton_group_split_plan():
    """Row splits: multiples of the flush size, at most MAX_SPLIT rows
    (int32-exact accumulators), covering every row, and enough programs
    to fill the card at deployment sizes."""
    from knoxdb_tpu.ops import pallas_group as PG
    for n in (1, 4096, 5000, 1 << 20, 1 << 26, (1 << 26) + 12345):
        for blocks in (1, 8, 64):
            flush, split, splits = PG._split_plan(n, blocks)
            assert flush <= PG.MAX_FLUSH and flush % PG.ROWS_T == 0
            assert split % flush == 0 and split <= PG.MAX_SPLIT
            assert splits * split >= n > (splits - 1) * split
            if n >= 1 << 26:
                assert splits * blocks >= PG.TARGET_PROGRAMS // 2
    assert PG.geometry(1000, 6) == (8, 8)
    assert PG.geometry(65536, 8) == (512, 16)
    assert PG.geometry(20, 2) == (1, 4)
