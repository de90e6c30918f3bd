"""knox — the public SDK facade.

The device analog of the reference SDK (/root/reference/pkg/knox/
interface.go:87-137, query.go:29-45, table.go:244-296): databases hold
tables; tables ingest dataclass rows or column batches under implicit
per-call transactions; queries build AND/OR condition trees with a
fluent builder and execute as fused device scans.

    import knoxdb_tpu.knox as knox

    @dataclass
    class Account:
        id: int = 0
        balance: int = 0

    db = knox.create_database("demo")
    acc = db.create_table(Account)
    acc.insert([Account(balance=100), Account(balance=250)])
    n = acc.query().where(knox.F("balance") > 120).count()
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from .engine.engine import Engine, Options, Tx
from .engine.table import Table
from .exec.scan import AggSpec, ScanResult
from .query.filter import Filter, Node, and_, leaf, or_
from .schema.schema import Builder, Schema, field_meta, schema_of
from .types import FieldType, FilterMode
from .utils import limbs as lb

__all__ = ["create_database", "open_database", "Database", "TableHandle",
           "Query", "F", "cond", "Builder", "field_meta", "schema_of",
           "join", "union"]


def create_database(name: str, **kw) -> "Database":
    return Database(Engine(name, Options(**kw)))


def open_database(name: str, **kw) -> "Database":
    return Database(Engine(name, Options(**kw)))


class Database:
    def __init__(self, engine: Engine):
        self.engine = engine

    def create_enum(self, name: str, values: list[str] | None = None):
        """Named string enum (reference internal/engine/enum.go); fields
        declare membership with field_meta(enum='name')."""
        return self.engine.enums.create(name, values)

    def extend_enum(self, name: str, values: list[str]) -> None:
        self.engine.enums.extend(name, values)

    def create_table(self, schema_or_cls, **kw) -> "TableHandle":
        if isinstance(schema_or_cls, Schema):
            schema, cls = schema_or_cls, None
        else:
            schema, cls = schema_of(schema_or_cls), schema_or_cls
        t = self.engine.create_table(schema, **kw)
        return TableHandle(self, t, cls)

    def describe(self, name: str) -> dict:
        """Schema + storage introspection (reference describe operator):
        fields (type/scale/pk/index/filter), row/segment/journal counts,
        stored bytes, per-table metrics."""
        t = self.engine.tables[name]
        m = t.metrics
        return {
            "name": name,
            "fields": [{
                "name": f.name, "type": f.type.name, "scale": f.scale,
                "pk": f.name == t.schema.pk.name,
                "filter": f.filter.name,
            } for f in t.schema.fields],
            "indexes": [{"name": i.name, "kind": i.kind.name,
                         "fields": list(i.fields)} for i in t.indexes],
            "segments": len(t.segments),
            "rows": sum(h.seg.nrows_total for h in t.segments)
            + t.journal.nrows,
            "journal_rows": t.journal.nrows,
            "bytes_stored": m.bytes_stored,
            "merges": m.merges,
            "queries": m.num_calls,
        }

    def table(self, name: str, cls=None) -> "TableHandle":
        return TableHandle(self, self.engine.table(name), cls)

    def drop_table(self, name: str) -> None:
        self.engine.drop_table(name)

    def begin(self, read_only: bool = False) -> Tx:
        return self.engine.begin(read_only)

    def close(self) -> None:
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TableHandle:
    def __init__(self, db: Database, table: Table, cls=None):
        self.db = db
        self._t = table
        self._cls = cls

    @property
    def schema(self) -> Schema:
        return self._t.schema

    @property
    def name(self) -> str:
        return self._t.schema.name

    def metrics(self):
        return self._t.metrics

    # ------------------------------------------------------------- write --

    def insert(self, rows, tx: Tx | None = None) -> np.ndarray:
        """rows: list of dataclass instances / dicts, or a dict of column
        arrays. Returns assigned pks."""
        data, n = self._to_columns(rows)
        return self._write(tx, lambda x: self._t.insert_rows(x, data))

    def update(self, rows, tx: Tx | None = None) -> int:
        data, n = self._to_columns(rows)
        return self._write(tx, lambda x: self._t.update_rows(x, data))

    def delete(self, query: "Query", tx: Tx | None = None) -> int:
        tree = query._tree()
        return self._write(tx, lambda x: self._t.delete_rows(x, tree))

    def _write(self, tx, fn):
        if tx is not None:
            return fn(tx)
        with self.db.begin() as x:
            return fn(x)

    def _to_columns(self, rows) -> tuple[dict, int]:
        if isinstance(rows, dict):
            n = len(next(iter(rows.values())))
            return rows, n
        rows = list(rows)
        if not rows:
            return {f.name: [] for f in self.schema.fields}, 0
        first = rows[0]
        if dataclasses.is_dataclass(first):
            cols = {f.name: [getattr(r, f.name) for r in rows]
                    for f in self.schema.fields}
        else:
            cols = {f.name: [r[f.name] for r in rows]
                    for f in self.schema.fields}
        return self._translate_enums(
            {k: np.asarray(v) if not _is_wide(self.schema, k) else v
             for k, v in cols.items()}), len(rows)

    def _translate_enums(self, cols: dict) -> dict:
        for f in self.schema.fields:
            if f.is_enum and f.name in cols:
                e = self.db.engine.enums.get(f.enum_name)
                vals = cols[f.name]
                if len(vals) and isinstance(
                        vals[0] if not isinstance(vals, np.ndarray)
                        else vals.flat[0], str):
                    cols[f.name] = np.array([e.code(str(v)) for v in vals],
                                            np.uint16)
        return cols

    def merge(self) -> None:
        """Force a synchronous journal merge (background merges happen
        automatically past the journal high-water mark)."""
        self._t.merge()

    def truncate(self) -> None:
        """Drop all rows, keep schema/indexes (reference
        engine.TruncateTable)."""
        self._t.truncate()

    def create_index(self, fields, kind=None, name: str = ""):
        """Secondary index: 'hash' (EQ/IN), 'int' (EQ..RANGE) or
        composite (multi-field prefix EQ)."""
        from .types import IndexType
        if isinstance(kind, str):
            kind = IndexType[kind.upper()]
        return self._t.create_index(fields, kind, name)

    # -------------------------------------------------------------- read --

    def query(self) -> "Query":
        return Query(self)

    def history(self) -> "TableHandle":
        """Handle on the shadow history table (tables created with
        history=True; reference 'history' table kind). Rows carry the
        original columns plus $src_rid/$src_xmin/$del_xid."""
        h = self.db.engine.history_table_for(self._t)
        return TableHandle(self.db, h)

    def count(self) -> int:
        return self.query().count()

    def get(self, pk: int):
        """Point lookup by primary key."""
        q = self.query().where(cond(self.schema.pk.name, FilterMode.EQ, pk))
        rows = q.execute()
        return rows[0] if rows else None

    def import_csv(self, src, delimiter: str | None = None,
                   batch_rows: int = 65536) -> int:
        """STREAMING CSV import (reference table_import operator,
        internal/operator/pipeline.go op set): parse + insert in bounded
        row batches — file size never hits host memory at once. src is a
        path or a text file object. Returns rows imported."""
        import csv as _csv
        import io as _io
        from .utils import csvio as CS
        from .utils import limbs as lb
        close = False
        if isinstance(src, str):
            src = open(src, "r", newline="")
            close = True
        try:
            sample = src.read(4096)
            src.seek(0)
            dialect = CS.sniff_dialect(sample) if delimiter is None else None
            r = _csv.reader(src, dialect) if dialect else \
                _csv.reader(src, delimiter=delimiter)
            header = next(r)
            pk = self.schema.pk.name
            fields = [f for f in self.schema.with_meta().fields
                      if not f.is_meta]
            col_of = {}
            for f in fields:
                if f.name not in header:
                    if f.name == pk:
                        col_of[f.name] = -1    # auto-assigned on insert
                        continue
                    raise ValueError(f"csv: missing column {f.name}")
                col_of[f.name] = header.index(f.name)
            total = 0
            batch: list[list[str]] = []

            def flush():
                nonlocal total
                if not batch:
                    return
                cols: dict = {}
                for f in fields:
                    if col_of[f.name] < 0:     # absent pk: auto-assign
                        cols[f.name] = np.zeros(len(batch), np.uint64)
                        continue
                    vals = [CS._parse(row[col_of[f.name]], f.type, f.scale)
                            for row in batch]
                    if f.type.is_bytes_like or f.type.nlimbs > 2 or f.scale:
                        cols[f.name] = vals
                    else:
                        cols[f.name] = np.asarray(vals,
                                                  lb.numpy_dtype(f.type))
                self.insert(cols)
                total += len(batch)
                batch.clear()

            for row in r:
                if not row:
                    continue
                batch.append(row)
                if len(batch) >= batch_rows:
                    flush()
            flush()
            return total
        finally:
            if close:
                src.close()


class _FieldExpr:
    """Operator-overloaded field reference: F('bal') > 100 -> Node."""

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, v):           # noqa: DunderEq returns Node by design
        return ("cond", self.name, FilterMode.EQ, v)

    def __ne__(self, v):
        return ("cond", self.name, FilterMode.NE, v)

    def __gt__(self, v):
        return ("cond", self.name, FilterMode.GT, v)

    def __ge__(self, v):
        return ("cond", self.name, FilterMode.GE, v)

    def __lt__(self, v):
        return ("cond", self.name, FilterMode.LT, v)

    def __le__(self, v):
        return ("cond", self.name, FilterMode.LE, v)

    def in_(self, vals):
        return ("cond", self.name, FilterMode.IN, list(vals))

    def not_in(self, vals):
        return ("cond", self.name, FilterMode.NOT_IN, list(vals))

    def between(self, lo, hi):
        return ("cond", self.name, FilterMode.RANGE, (lo, hi))


def F(name: str) -> _FieldExpr:
    return _FieldExpr(name)


def cond(field: str, mode: FilterMode | str, value) -> tuple:
    if isinstance(mode, str):
        from .types import parse_filter_mode
        mode = parse_filter_mode(mode)
    return ("cond", field, mode, value)


_KW_OPS = {
    "eq": FilterMode.EQ, "ne": FilterMode.NE, "gt": FilterMode.GT,
    "ge": FilterMode.GE, "lt": FilterMode.LT, "le": FilterMode.LE,
    "in": FilterMode.IN, "nin": FilterMode.NOT_IN, "range": FilterMode.RANGE,
}


class Query:
    """Fluent query builder (reference pkg/knox/query.go)."""

    def __init__(self, table: TableHandle):
        self._table = table
        self._conds: list[Node] = []
        self._limit = 0
        self._select: list[str] | None = None
        self._order: tuple[str, bool] | None = None

    # --------------------------------------------------------- condition --

    def where(self, *conds, **kw) -> "Query":
        """AND the given conditions. kwargs: field=value (EQ) or
        field__op=value with op in eq/ne/gt/ge/lt/le/in/nin/range."""
        for c in conds:
            self._conds.append(self._node(c))
        for k, v in kw.items():
            if "__" in k:
                fname, op = k.rsplit("__", 1)
                mode = _KW_OPS[op]
            else:
                fname, mode = k, FilterMode.EQ
            self._conds.append(self._node(("cond", fname, mode, v)))
        return self

    def or_where(self, *conds) -> "Query":
        """OR-group of conditions appended as one AND term."""
        self._conds.append(or_(*[self._node(c) for c in conds]))
        return self

    def _node(self, c) -> Node:
        if isinstance(c, Node):
            return c
        if isinstance(c, tuple) and c and c[0] == "cond":
            _, fname, mode, value = c
            f = self._table.schema.with_meta().field(fname)
            if f.is_enum:
                e = self._table.db.engine.enums.get(f.enum_name)
                if isinstance(value, str):
                    value = e.code(value)
                elif isinstance(value, (list, tuple)) and value and \
                        isinstance(value[0], str):
                    value = [e.code(v) for v in value]
            return leaf(Filter(f, mode, value))
        raise TypeError(f"bad condition {c!r}")

    def _tree(self) -> Node | None:
        if not self._conds:
            return None
        return and_(*self._conds).optimize()

    # ----------------------------------------------------------- shaping --

    def limit(self, n: int) -> "Query":
        self._limit = n
        return self

    def select(self, *names: str) -> "Query":
        self._select = list(names)
        return self

    def order_by(self, field: str, desc: bool = False) -> "Query":
        self._order = (field, desc)
        return self

    # ----------------------------------------------------------- execute --

    def _run(self, aggs, project=None) -> ScanResult:
        with self._table.db.begin(read_only=True) as tx:
            if self._order is not None and project is not None:
                field, desc = self._order
                return self._table._t.sorted_query(
                    tx.snapshot, self._tree(), field, desc=desc,
                    limit=self._limit, project=project)
            return self._table._t.query(tx.snapshot, self._tree(), aggs,
                                        project=project, limit=self._limit)

    def count(self) -> int:
        return self._run([AggSpec("count")]).count

    def sum(self, field: str):
        return self._scaled(field,
                            self._run([AggSpec("sum", field)])
                            .aggs[("sum", field)])

    def min(self, field: str):
        return self._scaled(field,
                            self._run([AggSpec("min", field)])
                            .aggs[("min", field)])

    def max(self, field: str):
        return self._scaled(field,
                            self._run([AggSpec("max", field)])
                            .aggs[("max", field)])

    def avg(self, field: str):
        return self._scaled(field,
                            self._run([AggSpec("avg", field)])
                            .aggs[("avg", field)])

    def count_distinct(self, field: str, exact: bool = True):
        """Distinct values of a column under the filter. exact=False uses
        a LogLogBeta sketch (~0.8% relative error; reference
        internal/filter/llb)."""
        rows = self.select(field).rows()
        vals = rows[field]
        if exact:
            return len(set(_pyval(v) for v in vals))
        from .exec import oracle as ORC
        from .filter.llb import LLB
        ft = self._table.schema.with_meta().field(field).type
        if ft.is_bytes_like:
            return len(set(vals))
        sk = LLB()
        keys = ORC.column_keys(vals, ft)
        sk.add_keys64(np.array([int(k) & ((1 << 64) - 1) for k in keys],
                               np.uint64))
        return int(round(sk.cardinality()))

    def aggregate(self, *specs: tuple) -> dict:
        """specs: ('sum'|'min'|'max'|'avg'|'count', field)."""
        a = [AggSpec(op, f) if f else AggSpec(op) for op, f in specs]
        r = self._run(a)
        return {k: self._scaled(k[1], v) if k[1] else v
                for k, v in r.aggs.items()}

    def _scaled(self, field: str, v):
        f = self._table.schema.with_meta().field(field)
        if v is not None and f.scale:
            return v / (10 ** f.scale)
        return v

    def group_by(self, field: str) -> "GroupQuery":
        """Hash-aggregate by a key column (EXCEEDS reference parity: the
        reference lists group-by as TODO, internal/query/plan.go:26-34)."""
        return GroupQuery(self, field)

    def rows(self) -> dict:
        """Column-batch results (the device-native shape). Decimal fields are
        scaled to floats (value / 10^scale)."""
        names = self._select or [f.name for f in self._table.schema.fields]
        r = self._run([AggSpec("count")], project=names)
        sch = self._table.schema.with_meta()
        for name in list(r.rows):
            f = sch.field(name)
            if f.scale:
                r.rows[name] = np.array(
                    [None if v is None else int(v) / 10**f.scale
                     for v in r.rows[name]], object)
            elif f.is_enum:
                e = self._table.db.engine.enums.get(f.enum_name)
                r.rows[name] = np.array(
                    [e.value(int(v)) for v in r.rows[name]], object)
        return r.rows

    def execute(self) -> list:
        """Typed row results (reference GenericQuery.Execute)."""
        rows = self.rows()
        names = list(rows.keys())
        n = min((len(v) for v in rows.values()), default=0)
        cls = self._table._cls
        out = []
        for i in range(n):
            kw = {k: _pyval(rows[k][i]) for k in names}
            if cls is not None and self._select is None:
                out.append(cls(**kw))
            else:
                out.append(kw)
        return out

    def stream_batches(self, batch_packs: int = 64):
        """INCREMENTAL column-batch generator (reference operator
        pipeline pull model, operator/pipeline.go:26-38): each yielded
        dict covers one pack window; host memory stays bounded by the
        window regardless of result size. Decimals scale to floats."""
        names = self._select or [f.name for f in self._table.schema.fields]
        sch = self._table.schema.with_meta()
        with self._table.db.begin(read_only=True) as tx:
            for batch in self._table._t.stream_query(
                    tx.snapshot, self._tree(), names,
                    batch_packs=batch_packs, limit=self._limit):
                for name in list(batch):
                    f = sch.field(name)
                    if f.scale:
                        batch[name] = np.array(
                            [None if v is None else int(v) / 10**f.scale
                             for v in batch[name]], object)
                    elif f.is_enum:
                        e = self._table.db.engine.enums.get(f.enum_name)
                        batch[name] = np.array(
                            [e.value(int(v)) for v in batch[name]], object)
                yield batch

    def stream(self, fn) -> int:
        """Row-callback streaming (reference Query.Stream) — pulls
        batches INCREMENTALLY (no full materialization)."""
        if self._order is not None:     # ordered results need the sort
            cnt = 0
            for row in self.execute():
                fn(row)
                cnt += 1
            return cnt
        cnt = 0
        names = None
        cls = self._table._cls
        for batch in self.stream_batches():
            if names is None:
                names = list(batch.keys())
            n = min((len(v) for v in batch.values()), default=0)
            for i in range(n):
                kw = {k: _pyval(batch[k][i]) for k in names}
                row = cls(**kw) if cls is not None and \
                    self._select is None else kw
                fn(row)
                cnt += 1
        return cnt


def union(*queries: "Query", batch_packs: int = 64):
    """Streamed UNION ALL (reference union operator,
    internal/operator/pipeline.go op set): yields column batches from
    each same-shaped query in order, pulled incrementally — no full
    materialization of any input."""
    names = None
    for q in queries:
        for b in q.stream_batches(batch_packs=batch_packs):
            if names is None:
                names = list(b)
            elif list(b) != names:
                raise ValueError(
                    f"union: column mismatch {list(b)} vs {names}")
            yield b


def join(left: "Query", right: "Query", on: tuple[str, str],
         how: "JoinType | str" = None, select: tuple | None = None,
         where=None, limit: int = 0) -> dict:
    """Equi-join two filtered queries (reference pkg/knox/join.go:28-47).

    on=(left_field, right_field); how: JoinType or
    'inner'|'left'|'right'|'full'|'cross'. Returns column dict with
    right-side columns prefixed 'r_' on name collisions. Outer-side
    misses yield None.

    where/limit (reference join.go:490-503 post-join filter + output
    limit): `where` is a condition over OUTPUT column names — a
    ("cond", name, mode, value) tuple (as built by F()/cond()), a
    list of them (ANDed), or nested ("and"/"or"/"not", ...) combos —
    applied AFTER the join; outer-miss None values fail every
    predicate (SQL NULL semantics). `limit` caps output rows (join
    pair order is UNSPECIFIED — the limit takes a deterministic but
    arbitrary subset, like the reference's block-iteration order).
    On the device path predicate columns are fetched FIRST and
    non-predicate projections only for surviving rows — the post-
    filter prunes the device-to-host fetch, not just the output.

    Execution: integer-keyed INNER/LEFT joins run DEVICE-SIDE — both
    sides' keys are compacted on device from the filter masks, joined
    with the sort-probe kernel (exec/join.join_pairs_device), and only
    the MATCHED rows' projections are fetched (reference merge-join
    semantics, join.go:536-556, without its full block fetches). Other
    shapes (bytes/float/wide keys, RIGHT/FULL/CROSS) use the host path."""
    from .types import JoinType

    if how is None:
        how = JoinType.INNER
    elif isinstance(how, str):
        how = JoinType[how.upper()]

    lf, rf = on
    lft = left._table._t.full_schema.field(lf).type
    rft = right._table._t.full_schema.field(rf).type
    device_ok = (
        how in (JoinType.INNER, JoinType.LEFT)
        and not (lft.is_bytes_like or rft.is_bytes_like)
        and not (lft.is_float or rft.is_float)
        and lft.nlimbs <= 2 and rft.nlimbs <= 2
        # mixed signedness would alias in the u64 two's-complement
        # join domain (e.g. -1 == 2^64-1); keep exact via host ints
        and lft.is_signed == rft.is_signed)
    if not device_ok:
        return _join_host(left, right, (lf, rf), how, select, where,
                          limit)

    from .exec import join as J
    lt, rt = left._table._t, right._table._t
    lsel = left._select or [f.name for f in left._table.schema.fields]
    rsel = right._select or [f.name for f in right._table.schema.fields]
    # r_-rename base: collisions judged against the FULL left selection
    # so output keys stay stable when select= prunes columns
    orig_l = set(lsel)
    orig_r = set(rsel)
    if select:
        # projection PUSHDOWN: drop unselected columns BEFORE the
        # materialization fetch (decoding then discarding whole
        # columns is the expensive order).
        # select names address OUTPUT keys (r_-renamed on collisions).
        lsel, rsel = _join_pushdown(lsel, rsel, orig_l, select)

    with lt.engine.begin(read_only=True) as txl:
        lkeys, lpos, lview = lt.join_side(txl.snapshot, left._tree(), lf)
    with rt.engine.begin(read_only=True) as txr:
        rkeys, rpos, rview = rt.join_side(txr.snapshot, right._tree(), rf)

    # joining on the build table's pk guarantees unique build keys: the
    # 2-sort unique cores replace the ~7-sort general cores
    rpk = rt.full_schema.pk
    unique = rpk is not None and rf == rpk.name

    mesh = getattr(lt.engine, "mesh", None)
    # keys32: both sides' TYPES prove the join domain fits u32
    # (unsigned <=32-bit; signed types bias to the 2^63 flip domain
    # and never qualify) — drops the hi-limb operand of the dominant
    # sort on every core, local or distributed
    k32 = (not lft.is_signed and not rft.is_signed
           and lft.bits <= 32 and rft.bits <= 32)
    if mesh is not None and getattr(rt.engine, "mesh", None) is mesh:
        # distributed path: salted all_to_all shuffle over the mesh
        # (BASELINE config #5), pairs index the key arrays like the
        # single-chip kernel's; r4 rides the same unique -> shift ->
        # general core ladder per shard
        from .parallel.shuffle import shuffle_join_rows
        lidx, ridx, _stats = shuffle_join_rows(
            mesh, np.asarray(lkeys), np.asarray(rkeys),
            how="left" if how == JoinType.LEFT else "inner",
            axis=mesh.axis_names[0], unique_build=unique, keys32=k32)
    else:
        lidx, ridx = J.join_pairs_device(lkeys, rkeys, how,
                                         unique_build=unique,
                                         keys32=k32)

    import jax.numpy as jnp
    lp = np.asarray(jnp.take(lpos, jnp.asarray(lidx, jnp.int32))) \
        if len(lidx) else np.empty(0, np.int64)
    rvalid = ridx >= 0
    rp = np.full(len(ridx), -1, np.int64)
    if rvalid.any():
        rp[rvalid] = np.asarray(
            jnp.take(rpos, jnp.asarray(ridx[rvalid], jnp.int32)))

    def rname(name):
        return _rname(name, orig_l)

    pre = {}                     # predicate name -> values (prefetch)
    pre_side = {}                # predicate name -> (side, field)
    if where is not None:
        # post-filter BEFORE the projection fetch: only the predicate
        # columns are fetched at full match size
        lflds = {f.name for f in lt.full_schema.fields}
        rflds = {f.name for f in rt.full_schema.fields}
        pre_side = _post_where_resolve(
            _post_where_names(where), lflds, rflds, orig_l, orig_r)
        lpred = sorted({f for s, f in pre_side.values() if s == "l"})
        rpred = sorted({f for s, f in pre_side.values() if s == "r"})
        lpr = lt.rows_at_positions(lview, lp, lpred)
        rpr = rt.rows_at_positions(rview, rp, rpred)
        for name, (s, f) in pre_side.items():
            pre[name] = lpr[f] if s == "l" else rpr[f]
        keep = np.flatnonzero(_post_where_eval(where, pre, len(lidx)))
        if limit:
            keep = keep[:limit]
        lp, rp = lp[keep], rp[keep]
        pre = {k: v[keep] for k, v in pre.items()}
    elif limit:
        lp, rp = lp[:limit], rp[:limit]

    # reuse a prefetched predicate column for the output ONLY when it
    # resolved to the same column the output name denotes (a predicate
    # on an unselected left column must not shadow a right-side output)
    def pre_of(name, side, field):
        if name in pre and pre_side.get(name) == (side, field):
            return pre[name]
        return None

    lrows = lt.rows_at_positions(
        lview, lp, [n for n in lsel if pre_of(n, "l", n) is None])
    rrows = rt.rows_at_positions(
        rview, rp, [n for n in rsel
                    if pre_of(rname(n), "r", n) is None])

    out: dict = {}
    for name in lsel:
        v = pre_of(name, "l", name)
        out[name] = v if v is not None else lrows[name]
    for name in rsel:
        key = rname(name)
        v = pre_of(key, "r", name)
        out[key] = v if v is not None else rrows[name]
    out["__n"] = len(lp)
    return _join_select(out, select)


def _join_host(left: "Query", right: "Query", on: tuple[str, str],
               how, select, where=None, limit: int = 0) -> dict:
    """Host join path (bytes/float/wide keys, RIGHT/FULL/CROSS): value-
    domain python-int join, exact for any key type mix. where/limit
    apply post-join (same semantics as the device path)."""
    from .exec import join as J

    lf, rf = on
    lsel = left._select or [f.name for f in left._table.schema.fields]
    rsel = right._select or [f.name for f in right._table.schema.fields]
    orig_l = set(lsel)
    orig_r = set(rsel)
    if select:
        lsel, rsel = _join_pushdown(lsel, rsel, orig_l, select)
    # post-filter columns join the fetch set (pruned from the output
    # below unless selected); same output-name resolver as the device
    # path so both paths agree on shadowed names
    wl, wr = [], []
    wside = {}
    if where is not None:
        lflds = {f.name for f in left._table._t.full_schema.fields}
        rflds = {f.name for f in right._table._t.full_schema.fields}
        wside = _post_where_resolve(_post_where_names(where), lflds,
                                    rflds, orig_l, orig_r)
        wl = sorted({f for s, f in wside.values() if s == "l"})
        wr = sorted({f for s, f in wside.values() if s == "r"})
    lrows = left.select(*dict.fromkeys(lsel + wl + [lf])).rows()
    rrows = right.select(*dict.fromkeys(rsel + wr + [rf])).rows()

    def keyed(col, ft):
        if ft.is_bytes_like:
            return np.array([v.encode() if isinstance(v, str) else bytes(v)
                             for v in col], object)
        if ft.is_float:
            return np.array([float(v) for v in col], object)
        return np.array([int(v) for v in col], object)

    lkeys = keyed(lrows[lf], left._table._t.full_schema.field(lf).type)
    rkeys = keyed(rrows[rf], right._table._t.full_schema.field(rf).type)
    res = J.join_keys_np(lkeys, rkeys, how)

    def expand_l(col):
        return np.array([col[i] if i >= 0 else None for i in res.lidx],
                        object)

    def expand_r(col):
        return np.array([col[j] if j >= 0 else None for j in res.ridx],
                        object)

    out: dict = {}
    for name in lsel:
        out[name] = expand_l(lrows[name])
    for name in rsel:
        out[_rname(name, orig_l)] = expand_r(rrows[name])
    out["__n"] = res.n
    if where is not None:
        eval_cols = {name: (expand_l(lrows[f]) if s == "l"
                            else expand_r(rrows[f]))
                     for name, (s, f) in wside.items()}
        keep = np.flatnonzero(_post_where_eval(where, eval_cols, res.n))
        if limit:
            keep = keep[:limit]
        out = {k: (v[keep] if isinstance(v, np.ndarray) else v)
               for k, v in out.items()}
        out["__n"] = len(keep)
    elif limit and res.n > limit:
        out = {k: (v[:limit] if isinstance(v, np.ndarray) else v)
               for k, v in out.items()}
        out["__n"] = limit
    return _join_select(out, select)


def _rname(name: str, orig_l: set) -> str:
    """Join OUTPUT key for a right-side column: 'r_'-prefixed only on
    a collision with the left selection."""
    return f"r_{name}" if name in orig_l else name


def _post_where_names(where) -> list:
    """Column names referenced by a post-join condition tree."""
    if isinstance(where, list) or (isinstance(where, tuple)
                                   and where and where[0] in
                                   ("and", "or", "not")):
        kids = where[1:] if isinstance(where, tuple) else where
        out = []
        for k in kids:
            out += _post_where_names(k)
        return out
    if isinstance(where, tuple) and where and where[0] == "cond":
        return [where[1]]
    raise TypeError(f"join where: bad condition {where!r}")


def _post_where_resolve(names, lflds: set, rflds: set,
                        orig_l: set, orig_r: set) -> dict:
    """Predicate name -> (side, field), mirroring the join's OUTPUT
    naming (r5 review fix: resolution previously consulted the left
    table's full schema first, so a right-side output column shadowed
    by an UNSELECTED left-schema column filtered the wrong side):
      1. a left OUTPUT name (in the left selection) wins,
      2. 'r_X' exists only when X collides with the left selection,
      3. a SELECTED right name not colliding is addressed unprefixed,
      4. otherwise an unselected table column — left first, then right.
    Unknown names raise KeyError BEFORE any fetch."""
    out = {}
    for name in dict.fromkeys(names):
        if name in orig_l and name in lflds:
            out[name] = ("l", name)
        elif name.startswith("r_") and name[2:] in rflds \
                and name[2:] in orig_l:
            out[name] = ("r", name[2:])
        elif name in orig_r and name in rflds and name not in orig_l:
            out[name] = ("r", name)
        elif name in lflds:
            out[name] = ("l", name)
        elif name in rflds:
            out[name] = ("r", name)
        else:
            raise KeyError(f"join where: unknown column {name}")
    return out


def _post_where_eval(where, cols: dict, n: int) -> np.ndarray:
    """Evaluate a post-join condition over output columns -> bool[n]
    of rows the filter KEEPS, under SQL three-valued logic: an
    outer-miss None makes a comparison UNKNOWN, unknown propagates
    through and/or/not, and only TRUE rows survive — so NE and
    ('not', EQ) agree on NULL rows (r5 review fix)."""
    t, _u = _post_where_eval3(where, cols, n)
    return t


def _post_where_eval3(where, cols: dict, n: int):
    """-> (true bool[n], unknown bool[n]); false = ~true & ~unknown."""
    from .types import FilterMode as FM
    if isinstance(where, list):
        where = tuple(["and"] + where)
    if isinstance(where, tuple) and where and where[0] in ("and", "or",
                                                           "not"):
        kids = [_post_where_eval3(k, cols, n) for k in where[1:]]
        if where[0] == "not":
            if len(kids) != 1:
                raise TypeError("join where: not() takes one condition")
            t, u = kids[0]
            return ~t & ~u, u
        if not kids:                   # AND of nothing = TRUE (empty
            if where[0] == "or":       # OR = FALSE), not a crash
                return np.zeros(n, bool), np.zeros(n, bool)
            return np.ones(n, bool), np.zeros(n, bool)
        t, u = kids[0]
        for t2, u2 in kids[1:]:
            if where[0] == "and":
                f = (~t & ~u) | (~t2 & ~u2)
                t = t & t2
                u = (u | u2) & ~f
            else:
                t = t | t2
                u = (u | u2) & ~t
        return t, u
    _, name, mode, value = where
    col = np.asarray(cols[name], object)
    notnull = np.array([x is not None for x in col], bool)
    sub = col[notnull]
    r = np.zeros(n, bool)
    if mode == FM.EQ:
        r[notnull] = sub == value
    elif mode == FM.NE:
        r[notnull] = sub != value
    elif mode == FM.GT:
        r[notnull] = sub > value
    elif mode == FM.GE:
        r[notnull] = sub >= value
    elif mode == FM.LT:
        r[notnull] = sub < value
    elif mode == FM.LE:
        r[notnull] = sub <= value
    elif mode == FM.RANGE:
        lo, hi = value
        r[notnull] = (sub >= lo) & (sub <= hi)
    elif mode == FM.IN:
        vs = set(value)
        r[notnull] = np.array([x in vs for x in sub], bool)
    elif mode == FM.NOT_IN:
        vs = set(value)
        r[notnull] = np.array([x not in vs for x in sub], bool)
    else:
        raise ValueError(f"join where: unsupported mode {mode}")
    return r, ~notnull


def _join_pushdown(lsel: list, rsel: list, orig_l: set,
                   select) -> tuple[list, list]:
    """Validate select names against the join's OUTPUT keys and prune
    both sides' projections to the selected subset (unknowns raise
    BEFORE any fetch)."""
    out_names = set(lsel) | {_rname(n, orig_l) for n in rsel}
    missing = [s for s in select if s not in out_names]
    if missing:
        raise KeyError(f"join select: unknown columns {missing}")
    want = set(select)
    return ([n for n in lsel if n in want],
            [n for n in rsel if _rname(n, orig_l) in want])


def _join_select(out: dict, select) -> dict:
    """Apply a join-level output projection (reference join.go Select:
    final column subset over the combined row). Unknown names raise."""
    if not select:
        return out
    missing = [s for s in select if s not in out]
    if missing:
        raise KeyError(f"join select: unknown columns {missing}")
    kept = {s: out[s] for s in select}
    kept["__n"] = out["__n"]
    return kept


class GroupQuery:
    def __init__(self, q: Query, field: str):
        self._q = q
        self._field = field

    def aggregate(self, *specs: tuple) -> dict:
        """specs: (op, field) with op in count/sum/min/max/avg/var/std.
        Returns {"keys": group keys, "count": counts, (op, field): values}
        with per-field decimal scaling applied (variance scales by the
        SQUARE of the decimal factor)."""
        t = self._q._table
        with t.db.begin(read_only=True) as tx:
            out = t._t.group_query(tx.snapshot, self._q._tree(),
                                   self._field, list(specs))
        sch = t.schema.with_meta()
        for key in list(out.keys()):
            if isinstance(key, tuple):
                f = sch.field(key[1])
                if f.scale:
                    div = 10 ** (f.scale * (2 if key[0] == "var" else 1))
                    out[key] = np.array(
                        [None if v is None else v / div for v in out[key]],
                        object)
        return out

    def count(self) -> dict:
        return self.aggregate(("count", ""))

    def sum(self, field: str) -> dict:
        return self.aggregate(("sum", field))


def _is_wide(schema: Schema, name: str) -> bool:
    return schema.field(name).type.nlimbs > 2


def _pyval(v):
    if isinstance(v, np.generic):
        return v.item()
    return v
