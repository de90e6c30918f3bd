"""Incremental merge + index maintenance (VERDICT r2 missing #3/#4).

Reference: pack-granular rewrite protocol merge.go:21-101 and
incremental index AddPack/DelPack (engine/interface.go:207-208). The
engine's segments are immutable, so the incremental form is a
persistent per-segment dead bitmap: scattered deletes merge in
O(tombstones), a rewrite happens only past DEAD_REWRITE_FRAC, and the
sealed-segment count stays bounded by MAX_SEGMENTS.
"""

import dataclasses

import numpy as np
import pytest

import knoxdb_tpu.knox as knox
from knoxdb_tpu.types import IndexType


@dataclasses.dataclass
class Row:
    id: int = 0
    v: int = 0
    tag: int = 0


def _mkdb(tmp_path, name="t"):
    return knox.create_database(name, driver="file", path=str(tmp_path),
                                pack_size=256, journal_size=1 << 20,
                                background_merge=False)


def _fill(t, n, start=0, rng=None):
    ids = np.zeros(n, np.uint64)
    v = np.arange(start, start + n, dtype=np.int64)
    tag = (v % 97).astype(np.int64)
    t.insert({"id": ids, "v": v, "tag": tag})
    t.merge()


def test_scattered_delete_is_incremental(tmp_path, rng):
    db = _mkdb(tmp_path)
    t = db.create_table(Row)
    _fill(t, 3000)                     # big sealed segment (> tail thresh)
    assert len(t._t.segments) == 1
    seg0 = t._t.segments[0].seg
    n0 = t.count()

    # scattered deletes, far below the rewrite fraction
    dels = [5, 777, 1500, 2998]
    t.delete(t.query().where(knox.F("v").in_(dels)))
    t.merge()
    h = t._t.segments[0]
    assert h.seg is seg0, "segment must NOT be rewritten for 4 deletes"
    assert h.n_dead == len(dels)
    assert t.count() == n0 - len(dels)
    assert t.query().where(knox.F("v").in_(dels)).count() == 0
    got = t.query().where(knox.F("v") < 10).select("v").rows()
    assert sorted(int(x) for x in got["v"]) == [0, 1, 2, 3, 4, 6, 7, 8, 9]
    # sums reflect the deletions exactly
    assert t.query().sum("v") == sum(range(3000)) - sum(dels)
    db.close()


def test_dead_fraction_triggers_rewrite(tmp_path, rng):
    db = _mkdb(tmp_path)
    t = db.create_table(Row)
    _fill(t, 3000)
    seg0 = t._t.segments[0].seg
    # delete > DEAD_REWRITE_FRAC of rows -> full rewrite reclaims space
    t.delete(t.query().where(knox.F("v") < 600))        # 20% > 12.5%
    t.merge()
    assert len(t._t.segments) == 1
    h = t._t.segments[0]
    assert h.seg is not seg0, "above the dead fraction: rewrite"
    assert h.n_dead == 0 and h.seg.nrows_total == 2400
    assert t.count() == 2400
    db.close()


def test_dead_bitmap_survives_reopen(tmp_path, rng):
    db = _mkdb(tmp_path)
    t = db.create_table(Row)
    _fill(t, 3000)
    t.delete(t.query().where(knox.F("v").in_([10, 20, 30])))
    t.merge()
    db.close()

    db2 = knox.open_database("t", driver="file", path=str(tmp_path),
                             background_merge=False)
    t2 = db2.table("row")
    h = t2._t.segments[0]
    assert h.n_dead == 3
    assert t2.count() == 2997
    assert t2.query().where(knox.F("v").in_([10, 20, 30])).count() == 0
    assert t2.query().sum("v") == sum(range(3000)) - 60
    db2.close()


def test_segment_count_bounded(tmp_path, rng):
    db = _mkdb(tmp_path)
    t = db.create_table(Row)
    # many separate merges of above-tail-threshold batches
    for i in range(18):
        _fill(t, 1100, start=i * 1100)
    from knoxdb_tpu.engine.table import Table
    assert len(t._t.segments) <= Table.MAX_SEGMENTS
    assert t.count() == 18 * 1100
    assert t.query().sum("v") == sum(range(18 * 1100))
    db.close()


def test_index_incremental_consistency(tmp_path, rng):
    db = _mkdb(tmp_path)
    t = db.create_table(Row)
    _fill(t, 3000)
    idx = t._t.create_index(["tag"], kind=IndexType.INT)
    n_index0 = len(idx.rids)
    assert n_index0 == 3000

    # delete some tag=7 rows + insert fresh ones; merge must maintain
    # the index incrementally (no full rebuild)
    t.delete(t.query().where(knox.F("v").in_([7, 104, 201])))          # all tag 7
    t.insert({"id": np.zeros(50, np.uint64),
              "v": np.arange(9000, 9050, dtype=np.int64),
              "tag": np.full(50, 7, np.int64)})
    t.merge()
    # index-served count equals scan-served count
    got = t.query().where(tag=7).count()
    oracle = (len([v for v in range(3000)
                   if v % 97 == 7 and v not in (7, 104, 201)])
              + sum(1 for v in range(9000, 9050) if True))
    assert got == oracle
    assert len(idx.rids) == 3000 - 3 + 50
    # point lookups through the index stay consistent after a second
    # incremental round
    t.delete(t.query().where(knox.F("v") == 9001))
    t.merge()
    assert t.query().where(tag=7).count() == oracle - 1
    db.close()
