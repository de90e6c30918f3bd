"""Multi-host layout: hybrid mesh construction + engine queries
over a virtual 2-host x 4-device arrangement return results identical to
single-device execution (parallel/multihost.py)."""

from dataclasses import dataclass

import numpy as np
import pytest

import knoxdb_tpu.knox as knox
from knoxdb_tpu.knox import F
from knoxdb_tpu.parallel import multihost

pytestmark = pytest.mark.slow  # full tier only (see pytest.ini)


@dataclass
class Row:
    id: int = 0
    val: int = 0
    bal: int = 0


def test_hybrid_mesh_shape(monkeypatch):
    monkeypatch.setenv("KNOX_VIRTUAL_HOSTS", "2")
    m = multihost.hybrid_mesh()
    assert m.axis_names == ("hosts", "packs")
    assert m.shape["hosts"] == 2 and m.shape["packs"] == 4


def test_initialize_noop_without_env(monkeypatch):
    monkeypatch.delenv("KNOX_COORDINATOR", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("KNOX_NUM_PROCESSES", raising=False)
    assert multihost.initialize_from_env() is False


def test_engine_query_on_hybrid_mesh(monkeypatch, rng):
    monkeypatch.setenv("KNOX_VIRTUAL_HOSTS", "2")
    hybrid = multihost.hybrid_mesh()

    db_s = knox.create_database("mh_s", driver="mem", pack_size=512,
                                background_merge=False)
    db_m = knox.create_database("mh_m", driver="mem", pack_size=512,
                                background_merge=False)
    flat = multihost.attach(db_m.engine, hybrid)
    assert flat.axis_names == ("packs",) and flat.shape["packs"] == 8

    n = 20_000
    data = {"id": np.zeros(n, np.uint64),
            "val": rng.integers(0, 50_000, n),
            "bal": rng.integers(-1 << 40, 1 << 40, n)}
    for db in (db_s, db_m):
        t = db.create_table(Row)
        t.insert({k: v.copy() for k, v in data.items()})
        t.merge()

    # bit-identical across single-device and hybrid-mesh execution
    for q in (lambda t: t.query().where(F("val") > 25_000).count(),
              lambda t: t.query().where(F("val") <= 10_000).sum("bal"),
              lambda t: t.query().min("bal"),
              lambda t: t.query().max("bal")):
        assert q(db_s.table("row")) == q(db_m.table("row"))

    # the sharded path actually engaged
    h = db_m.table("row")._t.segments[0]
    from knoxdb_tpu.parallel.engine_spmd import ShardedScanner
    assert isinstance(h.scanner_(), ShardedScanner)
    db_s.close()
    db_m.close()


def test_series_on_mesh(monkeypatch, rng):
    """run_series through a mesh-attached engine (inherited series_scan
    runs under plain jit over sharded arrays) == plain engine."""
    from knoxdb_tpu.series import FillMode, SeriesRequest, run_series

    @dataclass
    class TRow:
        id: int = 0
        ts: int = 0
        v: int = 0

    monkeypatch.setenv("KNOX_VIRTUAL_HOSTS", "2")
    hybrid = multihost.hybrid_mesh()
    db_s = knox.create_database("mh_ts_s", driver="mem", pack_size=512,
                                background_merge=False)
    db_m = knox.create_database("mh_ts_m", driver="mem", pack_size=512,
                                background_merge=False)
    multihost.attach(db_m.engine, hybrid)
    n = 8000
    ts = (rng.integers(0, 1000, n) // 5) * 5
    v = rng.integers(-10**6, 10**6, n)
    for db in (db_s, db_m):
        t = db.create_table(TRow)
        t.insert({"id": np.zeros(n, np.uint64), "ts": ts.copy(),
                  "v": v.copy()})
        t.merge()
    outs = []
    for db in (db_s, db_m):
        req = SeriesRequest(table=db.table("trow"), time_field="ts",
                            start=0, end=1000, interval=100,
                            aggs=[("count", ""), ("sum", "v"),
                                  ("first", "v"), ("last", "v"),
                                  ("last_join", "v")],
                            fill=FillMode.NULL)
        outs.append(run_series(req))
    a, b = outs
    np.testing.assert_array_equal(a["count"], b["count"])
    for key in (("sum", "v"), ("first", "v"), ("last", "v"),
                ("last_join", "v")):
        assert list(a[key]) == list(b[key]), key
    db_s.close()
    db_m.close()
