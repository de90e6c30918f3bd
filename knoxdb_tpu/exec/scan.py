"""Segment scan executor: filter tree + aggregates -> one fused device pass.

The device form of the reference's per-pack query loop
(/root/reference/internal/pack/table/reader.go:288-450 + operator/filter/
match_core.go): where the reference walks packs one at a time through
matcher dispatch, this executor compiles the WHOLE plan — every filter
leaf over every (scheme, width) pack group, the AND/OR mask combine, and
the aggregate partials — into a single jitted function over stacked
device arrays. Constants are traced (queries differing only in literals
share the compilation); plan/segment shapes form the cache signature.

Zone-map/bloom pruning (pack/stats.py) contributes per-pack tri-states:
ALL/NONE packs skip kernel work via mask overrides, and leaves whose packs
are fully decided skip their kernels entirely (signature-visible).

Aggregates return per-pack split partials; the host combines them with
exact python-int arithmetic (keyform bias, wide bases, decimal scale), so
integer results are bit-exact at any width. Float sums use a fixed
log-depth pairwise order on device (documented determinism contract).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..encode.schemes import Scheme
from ..ops import bitset as bs
from ..ops import bitslice as B
from ..ops import compact as CP
from ..pack.stats import TriState, prune_leaf
from ..query.filter import Filter, Node
from ..types import FieldType, FilterMode
from ..utils import limbs as lb
from . import device as D
from . import rewrite as RW

__all__ = ["AggSpec", "ScanResult", "SegmentScanner"]

# numpy, not jax, scalars: a module-level jax array would be captured by
# every traced plan as a device constant argument
_FULL = np.uint32(0xFFFFFFFF)


@dataclass(frozen=True)
class AggSpec:
    op: str          # count | sum | min | max | avg
    field: str = ""  # unused for count


@dataclass
class ScanResult:
    count: int = 0
    aggs: dict = dc_field(default_factory=dict)    # (op, field) -> value
    rows: dict = dc_field(default_factory=dict)    # field -> np array
    row_ids: np.ndarray | None = None              # u64 segment-local rids
    stats: dict = dc_field(default_factory=dict)   # pruning / timing info


def _tree_desc(node: Node, leaf_index: dict) -> tuple:
    """Static tree shape for the jit signature; assigns leaf indices."""
    if node.is_leaf:
        i = len(leaf_index)
        leaf_index[i] = node.filter
        return ("leaf", i, node.filter.field.name, int(node.filter.mode))
    return ("or" if node.or_ else "and",
            tuple(_tree_desc(c, leaf_index) for c in node.children))


class SegmentScanner:
    """Executes filter+aggregate plans against one DeviceSegment."""

    def __init__(self, dseg: D.DeviceSegment):
        from ..config import kernel_family
        self.d = dseg
        # kernel family of the group and series plans; set it to "xla"
        # to run the plain path on a GPU (for comparison)
        self.kernels = kernel_family()
        self._fns: dict = {}
        self._plan_sigs: dict = {}   # id(raw) -> full plan signature
        self._acache: dict = {}    # (tdesc, leaf values) -> uploaded args

    # ------------------------------------------------------------ public --

    def prepare(self, tree: Node | None, aggs: list[AggSpec],
                exclude_words=None, include_words=None):
        """Compile (or fetch) the fused scan fn and build its arguments.

        exclude_words: optional packed u32[P, W] bitset of rows to EXCLUDE
        (journal tombstones — reference reader.go:349-376 exclude mask).
        include_words: optional packed bitset RESTRICTING the scan (index
        rid pushdown — reference plan.go:312-449 `$rid IN bitmap`).
        Returns (jitted_fn, args_tuple, raw_fn)."""
        d = self.d
        leaves: dict[int, Filter] = {}
        tdesc = _tree_desc(tree, leaves) if tree is not None else ("true",)

        # upload cache: a REPEATED query re-uses the device copies of its
        # leaf constants and tristate overrides — each fresh jnp.asarray
        # is a separate host-to-device transfer
        try:
            akey = (tdesc, tuple(_leaf_cache_key(f)
                                 for f in leaves.values()))
        except Exception:
            akey = None
        cached = self._acache.get(akey) if akey is not None else None
        if cached is not None:
            tri, consts, skip_leaf = cached
            return self._prepare_tail(tdesc, leaves, tri, consts,
                                      skip_leaf, aggs, exclude_words,
                                      include_words)

        # --- host: stats pruning + constant preparation per leaf ---
        tri: list[TriState] = []
        consts: list[list[dict]] = []
        skip_leaf: list[bool] = []
        for i in range(len(leaves)):
            f = leaves[i]
            t = self._leaf_tristate(f)
            tri.append(t)
            decided = bool((t.all_ | t.none).all())
            skip_leaf.append(decided)
            if decided:
                consts.append([])
                continue
            col = d.seg.columns[f.field.name]
            dcol = d.column(f.field.name)
            consts.append([RW.leaf_group_consts(f, col, g)
                           for g in dcol.groups])

        tri = [(jnp.asarray(t.all_), jnp.asarray(t.none)) for t in tri]
        if akey is not None and len(self._acache) < 256:
            self._acache[akey] = (tri, consts, skip_leaf)
        return self._prepare_tail(tdesc, leaves, tri, consts, skip_leaf,
                                  aggs, exclude_words, include_words)

    def _prepare_tail(self, tdesc, leaves, overrides, consts, skip_leaf,
                      aggs, exclude_words, include_words):
        d = self.d
        agg_fields = sorted({a.field for a in aggs if a.field})
        filter_fields = sorted({f.field.name for f in leaves.values()})
        used = sorted(set(agg_fields) | set(filter_fields))

        has_excl = exclude_words is not None
        has_incl = include_words is not None
        sig = (d.sig(used), tdesc, tuple(skip_leaf), has_excl, has_incl,
               tuple((a.op, a.field) for a in aggs),
               tuple(RW.leaf_group_static(leaves[i], g)
                     for i in range(len(leaves)) if not skip_leaf[i]
                     for g in d.column(leaves[i].field.name).groups))

        pair = self._fns.get(sig)
        if pair is None:
            raw = self._build_fn(tdesc, leaves, skip_leaf, aggs, agg_fields,
                                 has_excl, has_incl)
            pair = (jax.jit(raw), raw)
            self._fns[sig] = pair
        fn, raw = pair
        # plan identity for DEPENDENT caches (group/series/top-k close
        # over this raw fn): two queries with the same (field, G) but
        # different TREES must not share a compiled closure — the old
        # sigs omitted the mask plan and collided (r5 probe find)
        self._plan_sigs[id(raw)] = sig

        arrays = d.arrays_pytree(used)
        excl = (jnp.asarray(exclude_words),) if has_excl else ()
        if has_incl:
            excl = excl + (jnp.asarray(include_words),)
        return fn, (arrays, consts, overrides, d.valid_words, excl), raw

    def scan(self, tree: Node | None, aggs: list[AggSpec],
             project: list[str] | None = None, limit: int = 0,
             exclude_words=None, include_words=None) -> ScanResult:
        d = self.d
        fn, args, _ = self.prepare(tree, aggs, exclude_words, include_words)
        mask_words, pack_counts, agg_parts = fn(*args)

        res = ScanResult()
        counts_np = np.asarray(pack_counts)
        res.count = int(counts_np.sum())
        res.stats["packs_scanned"] = d.P
        res.stats["packs_matched"] = int((counts_np > 0).sum())
        self._combine_aggs(res, aggs, agg_parts)

        if project:
            cap = limit if limit else res.count
            cap = max(1, 1 << (max(0, cap - 1)).bit_length())
            cap = min(cap, d.P * d.N)
            self._materialize(res, mask_words, project or [], cap, limit)
        return res

    def scan_stream(self, tree: Node | None, project: list[str],
                    batch_packs: int = 64, exclude_words=None,
                    include_words=None):
        """STREAMING scan: yields ScanResult row batches one pack-window
        at a time (the reference's pull-operator pipeline,
        operator/pipeline.go:26-38, re-shaped for the device: the filter
        runs ONCE over the whole segment, then each window compacts and
        fetches only its own matches — host memory stays bounded by
        batch_packs * pack_size regardless of result size)."""
        d = self.d
        fn, args, _ = self.prepare(tree, [], exclude_words, include_words)
        mask_words, pack_counts, _parts = fn(*args)
        counts = np.asarray(pack_counts)
        for s in range(0, d.P, batch_packs):
            e = min(s + batch_packs, d.P)
            n_win = int(counts[s:e].sum())
            if n_win == 0:
                continue
            win = jnp.zeros_like(mask_words).at[s:e].set(mask_words[s:e])
            res = ScanResult()
            res.count = n_win
            # pow2 cap: at most log2(P*N) distinct compiled shapes
            cap = max(1, 1 << (n_win - 1).bit_length())
            cap = min(cap, d.P * d.N)
            self._materialize(res, win, project, cap, 0)
            yield res

    # ---------------------------------------------------------- group-by --

    def group_scan(self, tree: Node | None, group_field: str,
                   agg_fields: list[str], exclude_words=None,
                   global_keys: np.ndarray | None = None, gplan=None,
                   minmax: bool = True):
        """Hash-aggregate: per-group (count, exact int sum, min, max) for
        each agg field. Returns (gplan, counts i64[G],
        {field: (sum int[G] python, min u64[G], max u64[G])}).

        Group domain comes from host metadata (dicts/zone maps); pass
        global_keys to align multiple segments on one domain. With
        minmax=False and G <= MXU_MAX_G the one-hot matmul kernel
        replaces the sort (exec/groupby.group_aggregate_mxu) — min/max
        outputs are then empty sentinels."""
        from . import groupby as GB
        d = self.d
        if not agg_fields:
            agg_fields = [group_field]   # count-only: aggregate the key
        if gplan is None:
            gplan = GB.plan_groups(d, group_field, global_keys)
        use_mxu = (not minmax) and gplan.G <= GB.MXU_MAX_G
        _fn, margs, mask_raw = self.prepare(tree, [], exclude_words)

        used = sorted(set([group_field] + agg_fields))
        garrays = d.arrays_pytree(used)
        dcol = d.column(group_field)
        mode_tags = tuple(m[0] for m in gplan.mode)
        gsigs = tuple(g.sig() for g in dcol.groups)
        gidxs = tuple(g.idx for g in dcol.groups)
        agg_sigs = {f: [(gi, g.sig(), g.idx)
                        for gi, g in enumerate(d.column(f).groups)]
                    for f in agg_fields}
        gconsts = GB.gid_consts(gplan)
        # stats-driven chunk shrink for the one-hot matmul kernels: n_chunks is a
        # STATIC program shape (part of sig); the rebase bias is TRACED
        # (constants are never baked into the graph — CLAUDE.md)
        cplan = {f: (GB.chunk_plan(d.seg.stats.fields.get(f))
                     if use_mxu else (8, 0)) for f in agg_fields}
        biases = {f: jnp.uint64(cplan[f][1]) for f in agg_fields}

        family = self.kernels
        sig = ("group", d.sig(used), group_field, tuple(agg_fields),
               mode_tags, gplan.G, exclude_words is not None, use_mxu,
               family,
               tuple(cplan[f][0] for f in agg_fields),
               self._plan_sigs[id(mask_raw)])
        gfn = self._fns.get(sig)
        if gfn is None:
            def gf(margs, garrays, gconsts, biases):
                mask, _, _ = mask_raw(*margs)
                gids = GB.row_gids(mode_tags, gsigs, gidxs,
                                   garrays[group_field], gconsts, d.W)
                out = {}
                for f in agg_fields:
                    # one-hot matmul kernels take fused u32 half pairs;
                    # the sort kernel takes u64 keys
                    dec_one = (D.group_decode_halves if use_mxu
                               else D.group_decode_keys)
                    if len(agg_sigs[f]) == 1 and \
                            agg_sigs[f][0][1][-1] == d.P:
                        gi_, gsig_, _ = agg_sigs[f][0]
                        dec = dec_one(gsig_, garrays[f][gi_], d.W)
                    elif use_mxu:
                        lo = jnp.zeros((d.P, d.N), jnp.uint32)
                        hi = jnp.zeros((d.P, d.N), jnp.uint32)
                        for gi_, gsig_, gidx_ in agg_sigs[f]:
                            l_, h_ = D.group_decode_halves(
                                gsig_, garrays[f][gi_], d.W)
                            lo = lo.at[gidx_].set(l_)
                            hi = hi.at[gidx_].set(h_)
                        dec = (lo, hi)
                    else:
                        dec = jnp.zeros((d.P, d.N), jnp.uint64)
                        for gi_, gsig_, gidx_ in agg_sigs[f]:
                            keys = D.group_decode_keys(
                                gsig_, garrays[f][gi_], d.W)
                            dec = dec.at[gidx_].set(keys)
                    if use_mxu:
                        out[f] = GB.group_aggregate_mxu(
                            gids, mask, dec, gplan.G,
                            n_chunks=cplan[f][0], bias=biases[f],
                            family=family)
                    else:
                        out[f] = GB.group_aggregate(gids, mask, dec,
                                                    gplan.G)
                return out

            gfn = (jax.jit(gf), gf)
            self._fns[sig] = gfn

        out = gfn[0](margs, garrays, gconsts, biases)
        results = {}
        counts = None
        for f in agg_fields:
            if use_mxu:
                c, chunks, mn, mx = out[f]
                sums = GB.mxu_chunk_sums(chunks)
                b = cplan[f][1]
                if b:
                    sums = sums + b * np.asarray(c).astype(object)
            else:
                c, slo, shi, mn, mx = out[f]
                sums = (np.asarray(slo).astype(object)
                        + (np.asarray(shi).astype(object) << 32))
            if counts is None:
                counts = np.asarray(c)
            # sums: OBJECT ndarray of exact python ints [G]
            results[f] = (sums, np.asarray(mn), np.asarray(mx))
        return gplan, counts, results

    def series_scan(self, tree: Node | None, time_field: str, kinds: dict,
                    gplan, exclude_words=None):
        """Extended reducer partials for the series layer (series.py):
        first/last, var/std moments, and *_join timestamp-run aggregates
        (reference reducer.go:24-48 full surface).

        kinds: {field: iterable from {"moments", "firstlast", "tsruns",
        "fminmax"}}. Returns {(field, kind): tuple of numpy arrays} —
          moments   -> (n i64[G], sum f64[G], sumsq f64[G])
          firstlast -> (f_ts, f_val, l_ts, l_val u64 keyform, counts)
          tsruns    -> exec/groupby.group_ts_runs output (14 arrays)
          fminmax   -> (n i64[G], min u64[G], max u64[G]) FLOAT keyform
                       (float group min/max — table.group_query; ALP
                       packs decode to f64 then map via f64_to_keyform,
                       keyform packs stay pure u64)
        """
        from . import groupby as GB
        d = self.d
        fields = sorted(kinds)
        _fn, margs, mask_raw = self.prepare(tree, [], exclude_words)

        used = sorted(set([time_field] + fields))
        garrays = d.arrays_pytree(used)
        tcol = d.column(time_field)
        mode_tags = tuple(m[0] for m in gplan.mode)
        tsigs = tuple(g.sig() for g in tcol.groups)
        tidxs = tuple(g.idx for g in tcol.groups)
        fsigs = {f: [(gi, g.sig(), g.idx)
                     for gi, g in enumerate(d.column(f).groups)]
                 for f in used}
        gconsts = GB.gid_consts(gplan)
        meta = {}
        for f in fields:
            ft = d.seg.columns[f].field.type
            meta[f] = (np.uint64(1 << (ft.bits - 1)) if ft.is_signed
                       else np.uint64(0), ft.is_float)

        kspec = tuple((f, tuple(sorted(kinds[f]))) for f in fields)

        # plan-static EXACT one-hot moments gate: int fields whose rebased
        # keyform range fits 4 byte chunks (r < 2^32, so r^2 is exact
        # u64 via 16-bit-limb u32 math — groupby.square_halves) ride
        # TWO one-hot matmul passes instead of the 3-operand sort;
        # host recombines python-int-exact
        # moments. C/q_chunks shape the traced graph -> part of sig.
        mplan = {}
        for f in fields:
            if "moments" in kinds[f] and not meta[f][1]:
                C_m, gmin_m = GB.chunk_plan(d.seg.stats.fields.get(f))
                if C_m <= 4:
                    mplan[f] = (C_m, gmin_m, min(8, 2 * C_m))
        mbias = {f: jnp.uint64(v[1]) for f, v in mplan.items()}

        # per-pack ALP decode constants: TRACED, not baked — XLA rewrites
        # division by a CONSTANT into reciprocal multiplication (1 ulp
        # off the correctly-rounded decode the encoder's round-trip gate
        # verified); a runtime divisor keeps true division
        alp_c = {}
        for f in used:
            for gi, g in enumerate(d.column(f).groups):
                if g.scheme == Scheme.ALP:
                    alp_c[(f, gi)] = (
                        jnp.asarray([float(b) for b in g.bases],
                                    jnp.float64),
                        jnp.asarray([10.0 ** e for e in g.exps],
                                    jnp.float64))
        alp_keys = tuple(sorted(alp_c))
        alp_vals = tuple(alp_c[k] for k in alp_keys)

        family = self.kernels
        sig = ("series", d.sig(used), time_field, kspec, mode_tags,
               gplan.G, exclude_words is not None, alp_keys, family,
               tuple(sorted((f, v[0], v[2]) for f, v in mplan.items())),
               self._plan_sigs[id(mask_raw)])
        sfn = self._fns.get(sig)
        if sfn is None:
            def decode(f, garrays):
                if len(fsigs[f]) == 1 and fsigs[f][0][1][-1] == d.P:
                    gi_, gsig_, _ = fsigs[f][0]
                    return D.group_decode_keys(gsig_, garrays[f][gi_], d.W)
                dec = jnp.zeros((d.P, d.N), jnp.uint64)
                for gi_, gsig_, gidx_ in fsigs[f]:
                    keys = D.group_decode_keys(gsig_, garrays[f][gi_], d.W)
                    dec = dec.at[gidx_].set(keys)
                return dec

            def decode_f64(f, garrays, ac):
                """Float column -> f64 VALUES [P, N] (ALP packs decode
                via per-pack base/exponent; others via IEEE keyform).
                ac: traced {(f, gi): (base, scale)} — see alp_c above."""
                from ..encode import schemes as S

                def one(gi_, gsig_):
                    if Scheme(gsig_[0]) == Scheme.ALP:
                        base, scale = ac[(f, gi_)]
                        dec = S.decode_bitplanes_u64(
                            garrays[f][gi_]["planes"], gsig_[1])
                        return (dec.astype(jnp.float64)
                                + base[:, None]) / scale[:, None]
                    keys = D.group_decode_keys(gsig_, garrays[f][gi_],
                                               d.W)
                    return GB.keyform_to_f64(keys, jnp.uint64(0), True)

                if len(fsigs[f]) == 1 and fsigs[f][0][1][-1] == d.P:
                    gi_, gsig_, _ = fsigs[f][0]
                    return one(gi_, gsig_)
                out = jnp.zeros((d.P, d.N), jnp.float64)
                for gi_, gsig_, gidx_ in fsigs[f]:
                    out = out.at[gidx_].set(one(gi_, gsig_))
                return out

            def decode_fkey(f, garrays, ac):
                """Float column -> ORDER-PRESERVING u64 keyform [P, N].
                Keyform packs pass through exactly (no f64 round trip);
                ALP packs decode to f64 and map via f64_to_keyform."""
                has_alp = any(Scheme(gsig_[0]) == Scheme.ALP
                              for _, gsig_, _ in fsigs[f])
                if not has_alp:
                    return decode(f, garrays)
                return GB.f64_to_keyform(decode_f64(f, garrays, ac))

            def sf(margs, garrays, gconsts, mb, av):
                ac = dict(zip(alp_keys, av))
                mask, _, _ = mask_raw(*margs)
                gids = GB.row_gids(mode_tags, tsigs, tidxs,
                                   garrays[time_field], gconsts, d.W)
                ts_keys = None
                out = {}
                for f, fk in kspec:
                    bias, is_float = meta[f]
                    if is_float:
                        vf = decode_f64(f, garrays, ac)
                        vk = jax.lax.bitcast_convert_type(vf, jnp.uint64)
                    else:
                        vf = None
                        vk = decode(f, garrays)
                    if "fminmax" in fk:
                        kf = decode_fkey(f, garrays, ac)
                        cmm, _slo, _shi, mn_f, mx_f = GB.group_aggregate(
                            gids, mask, kf, gplan.G)
                        # unused split sums DCE away under jit
                        out[(f, "fminmax")] = (cmm, mn_f, mx_f)
                    if "moments" in fk and f in mplan:
                        C_m, _gm, qC = mplan[f]
                        rlo, rhi = GB._value_halves(vk, mb[f])
                        qlo, qhi = GB.square_halves(rlo)
                        c1, ch1, ch2 = GB.group_moments_mxu(
                            gids, mask, (rlo, rhi), (qlo, qhi),
                            gplan.G, C_m, qC, family=family)
                        out[(f, "moments")] = \
                            (c1,) + tuple(ch1) + tuple(ch2)
                    elif "moments" in fk:
                        out[(f, "moments")] = GB.group_moments(
                            gids, mask, vf if is_float else vk, gplan.G,
                            jnp.uint64(bias), is_float)
                    if "firstlast" in fk or "tsruns" in fk:
                        if ts_keys is None:
                            ts_keys = decode(time_field, garrays)
                    if "firstlast" in fk:
                        # float values travel as raw f64 BITS (payload
                        # only; host bit-casts back)
                        out[(f, "firstlast")] = GB.group_first_last(
                            gids, mask, ts_keys, vk, gplan.G)
                    if "tsruns" in fk:
                        out[(f, "tsruns")] = GB.group_ts_runs(
                            gids, mask, ts_keys, vk, gplan.G,
                            jnp.uint64(bias))
                return out

            sfn = (jax.jit(sf), sf)     # (jit, raw) like the scan plans
            self._fns[sig] = sfn

        out = sfn[0](margs, garrays, gconsts, mbias, alp_vals)
        res = {}
        for k, v in out.items():
            f, kind = k
            if kind == "moments" and f in mplan:
                # exact host recombination: value = r + base where
                # base = keyform_min - sign_offset (python ints)
                C_m, gmin_m, qC = mplan[f]
                counts = np.asarray(v[0]).astype(np.int64)
                Sr = GB.mxu_chunk_sums(v[1:1 + C_m])
                Sq = GB.mxu_chunk_sums(v[1 + C_m:1 + C_m + qC])
                base = gmin_m - int(meta[f][0])
                no = counts.astype(object)
                sums = (base * no + Sr).astype(np.float64)
                sqs = (no * (base * base) + (2 * base) * Sr
                       + Sq).astype(np.float64)
                res[k] = (counts, sums, sqs)
            else:
                res[k] = tuple(np.asarray(a) for a in v)
        return res

    # ------------------------------------------------------- compilation --

    def _leaf_tristate(self, f: Filter) -> TriState:
        st = self.d.seg.stats
        if f.mode == FilterMode.TRUE:
            return TriState(np.ones(self.d.P, bool), np.zeros(self.d.P, bool))
        if f.mode == FilterMode.FALSE:
            return TriState(np.zeros(self.d.P, bool), np.ones(self.d.P, bool))
        fs = st.fields.get(f.field.name)
        if fs is None:
            return TriState.unknown(self.d.P)
        kb = None
        if f.field.type.is_bytes_like and f.mode in (
                FilterMode.EQ, FilterMode.IN):
            vb = f.value_bytes
            kb = vb if isinstance(vb, list) else [vb]
        return prune_leaf(fs, f.mode, lo=f.key, hi=f.key_hi, keys=f.keys,
                          key_limbs=None if kb else f.key_limbs,
                          key_bytes=kb)

    def _build_fn(self, tdesc, leaves, skip_leaf, aggs, agg_fields,
                  has_excl=False, has_incl=False):
        d = self.d
        W = d.W
        # static per-leaf group sigs + scatter indices
        leaf_groups = {}
        for i, f in leaves.items():
            if skip_leaf[i]:
                continue
            gs = d.column(f.field.name).groups
            leaf_groups[i] = [(g.sig(), g.idx, f.field.name) for g in gs]
        agg_groups = {name: [(gi, g.sig(), g.idx)
                             for gi, g in enumerate(d.column(name).groups)]
                      for name in agg_fields}
        agg_specs = [(a.op, a.field) for a in aggs]
        float_fields = {name for name in agg_fields
                        if d.seg.columns[name].field.type.is_float}
        float_types = {name: d.seg.columns[name].field.type
                       for name in float_fields}

        def eval_node(desc, arrays, consts, overrides, valid):
            # all shapes derive from TRACED arrays (valid u32[P, W]), not
            # static segment geometry: under shard_map the same fn traces
            # with device-local P (parallel/engine_spmd.py)
            kind = desc[0]
            if kind == "true":
                return jnp.full(valid.shape, _FULL)
            if kind == "leaf":
                i, fname, mode = desc[1], desc[2], FilterMode(desc[3])
                all_, none = overrides[i]
                if skip_leaf[i]:
                    return jnp.where(all_[:, None], _FULL, jnp.uint32(0))
                if len(leaf_groups[i]) == 1 and \
                        leaf_groups[i][0][0][-1] == d.P:
                    # single full-coverage group: no scatter needed
                    gsig, gidx, _ = leaf_groups[i][0]
                    full = D.group_match(gsig, mode, arrays[fname][0],
                                         consts[i][0], W)
                else:
                    full = jnp.zeros(valid.shape, jnp.uint32)
                    for gi, (gsig, gidx, _) in enumerate(leaf_groups[i]):
                        m = D.group_match(gsig, mode, arrays[fname][gi],
                                          consts[i][gi], W)
                        full = full.at[gidx].set(m)
                full = jnp.where(all_[:, None], _FULL, full)
                return jnp.where(none[:, None], jnp.uint32(0), full)
            kids = [eval_node(c, arrays, consts, overrides, valid)
                    for c in desc[1]]
            out = kids[0]
            for k in kids[1:]:
                out = (out | k) if kind == "or" else (out & k)
            return out

        def fn(arrays, consts, overrides, valid, excl=()):
            mask = eval_node(tdesc, arrays, consts, overrides,
                             valid) & valid
            if has_excl:
                mask = mask & ~excl[0]
            if has_incl:
                mask = mask & excl[1 if has_excl else 0]
            pack_counts = B.popcount_words(mask)
            parts = []
            for op, fname in agg_specs:
                if op == "count" or not fname:
                    parts.append(None)
                    continue
                col_parts = []
                full_cov = (len(agg_groups[fname]) == 1
                            and agg_groups[fname][0][1][-1] == d.P)
                for gi, gsig, gidx in agg_groups[fname]:
                    # full-coverage single group: identity gather elided
                    # (required under shard_map: gidx is global)
                    gmask = mask if full_cov else mask[gidx]
                    garr = arrays[fname][gi]
                    is_alp = Scheme(gsig[0]) == Scheme.ALP
                    if op == "sum" or op == "avg":
                        if fname in float_fields and not is_alp:
                            col_parts.append(D.group_masked_sum_float(
                                gsig, garr, gmask, W, float_types[fname]))
                        else:
                            col_parts.append(
                                D.group_masked_sum(gsig, garr, gmask, W))
                    elif op in ("min", "max"):
                        col_parts.append(
                            D.group_masked_minmax(gsig, garr, gmask, W)
                            + (B.popcount_words(gmask),))
                    else:
                        raise ValueError(f"agg op {op}")
                parts.append(col_parts)
            return mask, pack_counts, parts

        return fn

    # ------------------------------------------------------ host combine --

    def _combine_aggs(self, res: ScanResult, aggs, agg_parts):
        for spec, part in zip(aggs, agg_parts):
            key = (spec.op, spec.field)
            if spec.op == "count":
                res.aggs[key] = res.count
                continue
            col = self.d.seg.columns[spec.field]
            ft = col.field.type
            groups = self.d.column(spec.field).groups
            if spec.op in ("sum", "avg"):
                total, cnt = self._combine_sum(part, groups, ft)
                if spec.op == "sum":
                    res.aggs[key] = total
                else:
                    res.aggs[key] = (total / cnt) if cnt else None
            else:
                res.aggs[key] = self._combine_minmax(part, groups, ft,
                                                     spec.op == "min")

    def _combine_sum(self, parts, groups, ft: FieldType):
        from ..encode.schemes import Scheme as Sch
        if ft.is_float:
            # ALP packs contribute EXACT rationals (enc sums / 10^e);
            # keyform packs contribute device float sums
            from fractions import Fraction
            frac = Fraction(0)
            fl = 0.0
            any_frac = False
            cnt = 0
            for part, g in zip(parts, groups):
                if g.scheme == Sch.ALP:
                    lo, hi, c = (np.asarray(x) for x in part)
                    for j in range(len(c)):
                        enc = int(lo[j]) + (int(hi[j]) << 32) \
                            + g.bases[j] * int(c[j])
                        frac += Fraction(enc, 10 ** g.exps[j])
                    any_frac = True
                    cnt += int(c.sum())
                else:
                    s, c = part
                    fl += float(np.asarray(s).sum())
                    cnt += int(np.asarray(c).sum())
            total = float(frac) + fl if any_frac else fl
            if any_frac and fl == 0.0:
                total = float(frac)       # fully exact path
            return total, cnt
        total = 0
        cnt = 0
        for part, g in zip(parts, groups):
            if len(part) == 2:            # wide per-limb form: u64[L, Pg]
                sums = np.asarray(part[0])
                c = np.asarray(part[1])
                L = sums.shape[0]
                for j in range(sums.shape[1]):
                    s = 0
                    for l in range(L):
                        s += int(sums[l, j]) << (32 * (L - 1 - l))
                    total += s
                cnt += int(c.sum())
                continue
            lo, hi, c = part
            lo = np.asarray(lo)
            hi = np.asarray(hi)
            c = np.asarray(c)
            for j in range(len(lo)):
                s = int(lo[j]) + (int(hi[j]) << 32)
                if g.wide and g.bases is not None:
                    s += g.bases[j] * int(c[j])
                total += s
            cnt += int(c.sum())
        if ft.is_signed and not ft.is_float:
            total -= cnt << (ft.bits - 1)
        return total, cnt

    def _combine_minmax(self, parts, groups, ft: FieldType, want_min: bool):
        """Combine per-pack winners in the NATIVE value domain (ALP packs
        decode exactly to floats; keyform packs convert at the end)."""
        from ..encode.schemes import Scheme as Sch
        best = None
        for part, g in zip(parts, groups):
            mn, mx, c = part
            mn = np.asarray(mn)
            mx = np.asarray(mx)
            c = np.asarray(c)
            for j in range(len(c)):
                if int(c[j]) == 0:
                    continue
                if g.scheme == Sch.ALP:
                    rel = int(mn[j]) if want_min else int(mx[j])
                    v = (g.bases[j] + rel) / (10 ** g.exps[j])
                elif mn.ndim == 2:        # wide limb form u32[L, Pg]
                    src = mn if want_min else mx
                    k = 0
                    for l in range(src.shape[0]):
                        k = (k << 32) | int(src[l, j])
                    v = _key_to_value(k, ft)
                else:
                    k = int(mn[j]) if want_min else int(mx[j])
                    if g.wide and g.bases is not None:
                        k += g.bases[j]
                    v = _key_to_value(k, ft)
                if best is None or (v < best if want_min else v > best):
                    best = v
        return best

    # ---------------------------------------------------- materialization --

    def _materialize(self, res: ScanResult, mask_words, project, cap, limit):
        d = self.d
        sig = ("mat", d.sig(project), cap)
        fn = self._fns.get(sig)
        if fn is None:
            proj_groups = {name: [(g.sig(), g.idx) for g in d.column(name).groups]
                           for name in project}

            bytes_cols = {name for name in project
                          if d.seg.columns[name].field.type.is_bytes_like}

            def mat(mask, arrays):
                from ..encode import schemes as S
                flat = bs.unpack_mask(mask).reshape(-1)
                idx, count = CP.mask_to_indexes(flat, cap)
                outs = {}
                for name in project:
                    if name in bytes_cols:
                        # decode dictionary CODES; host maps via dict_bytes
                        codes = jnp.zeros((d.P, d.N), jnp.uint32)
                        for gi, (gsig, gidx) in enumerate(proj_groups[name]):
                            w = gsig[1]
                            c = S.decode_bitplanes_u32(
                                arrays[name][gi]["planes"], w)
                            codes = codes.at[gidx].set(c)
                        outs[name] = CP.take_rows(
                            codes.reshape(1, -1), idx)
                        continue
                    L = d.seg.columns[name].nlimbs
                    dec = jnp.zeros((L, d.P, d.N), jnp.uint32)
                    for gi, (gsig, gidx) in enumerate(proj_groups[name]):
                        lim = D.group_decode_limbs(gsig, arrays[name][gi], d.W)
                        dec = dec.at[:, gidx].set(lim)
                    outs[name] = CP.take_rows(dec.reshape(L, -1), idx)
                return idx, count, outs

            fn = jax.jit(mat)
            self._fns[sig] = fn

        arrays = d.arrays_pytree(project)
        idx, count, outs = fn(mask_words, arrays)
        n = int(count) if not limit else min(int(count), limit)
        n = min(n, cap)
        idx_np = np.asarray(idx)[:n]
        res.row_ids = idx_np.astype(np.uint64)
        for name in project:
            col = self.d.seg.columns[name]
            limbs = np.asarray(outs[name])[:, :n]
            if col.field.type.is_bytes_like:
                res.rows[name] = self._bytes_values(col, limbs[0], idx_np)
            elif col.wide:
                res.rows[name] = self._wide_values(col, limbs, idx_np)
            elif any(p.scheme == Scheme.ALP for p in col.packs):
                res.rows[name] = self._float_alp_values(col, limbs, idx_np)
            else:
                res.rows[name] = lb.from_keyform(limbs, col.field.type)

    # Host materialization is VECTORIZED per pack (per-row python loops
    # cost ~1 us/row — quadratic-feeling on wide result sets; VERDICT r2
    # weak #6): rows group by pack via idx // N, each pack's rows resolve
    # with one fancy-index / object-array expression.

    def _bytes_values(self, col, codes: np.ndarray, idx_np: np.ndarray):
        """Code rows -> byte values via per-pack host dictionaries."""
        N = self.d.N
        as_str = col.field.type == FieldType.STRING
        n = len(codes)
        out = np.empty(n, object)
        packs = (idx_np[:n] // N).astype(np.int64)
        cd = codes.astype(np.int64)
        for p in np.unique(packs):
            ep = col.packs[int(p)]
            # decoded-dict cache on the pack: repeated projections of
            # the same pack pay the dict decode once
            key = "_mat_dict_str" if as_str else "_mat_dict_bytes"
            arr = getattr(ep, key, None)
            if arr is None:
                arr = np.empty(len(ep.dict_bytes), object)
                arr[:] = [b.decode() for b in ep.dict_bytes] if as_str \
                    else ep.dict_bytes
                try:
                    setattr(ep, key, arr)
                except AttributeError:
                    pass                      # slotted/frozen pack: skip
            m = packs == p
            out[m] = arr[cd[m]]
        return out

    def _float_alp_values(self, col, limbs: np.ndarray, idx_np: np.ndarray):
        """FLOAT64 rows from mixed ALP / keyform packs (exact decode:
        ALP enc ints stay < 2^52, so f64 add + correctly-rounded numpy
        divide reproduce the encoder's round-trip gate exactly)."""
        N = self.d.N
        n = limbs.shape[1]
        out = np.empty(n, np.float64)
        packs = (idx_np[:n] // N).astype(np.int64)
        k64 = (limbs[0].astype(np.uint64) << np.uint64(32)) \
            | limbs[1].astype(np.uint64)
        for p in np.unique(packs):
            ep = col.packs[int(p)]
            m = packs == p
            if ep.scheme == Scheme.ALP:
                out[m] = (np.float64(ep.min_key)
                          + k64[m].astype(np.float64)) / (10.0 ** ep.exp)
            else:
                out[m] = lb.from_keyform(
                    np.stack([limbs[0][m], limbs[1][m]]), col.field.type)
        return out

    def _wide_values(self, col, limbs: np.ndarray, idx_np: np.ndarray):
        """Recombine wide rows: device limbs hold either full RAW limbs or
        (zeros..., hi, lo) packed-relative keys needing per-pack base."""
        ft = col.field.type
        N = self.d.N
        n = limbs.shape[1]
        bias = 1 << (ft.bits - 1) if ft.is_signed else 0
        out = np.empty(n, object)
        packs = (idx_np[:n] // N).astype(np.int64)
        # object-int vector arithmetic: exact at any width, no row loop
        rel = (limbs[-2].astype(object) << 32) | limbs[-1].astype(object)
        for p in np.unique(packs):
            ep = col.packs[int(p)]
            m = packs == p
            if ep.scheme == Scheme.BITPACK:
                out[m] = rel[m] + (col.wide_bases[int(p)] - bias)
            else:
                # RAW / CONST carry full absolute keyform limbs
                v = np.zeros(int(m.sum()), object)
                for l in range(limbs.shape[0]):
                    v = (v << 32) | limbs[l][m].astype(object)
                out[m] = v - bias
        return out


def _leaf_cache_key(f: Filter) -> tuple:
    """Hashable EXACT identity of a leaf's constants for the upload
    cache. Built from the canonical keyform attributes — never repr():
    numpy's repr truncates long IN lists ('...'), which would collide
    two different queries onto one cached constant set."""
    ks = getattr(f, "keys", None)
    if ks is not None:
        ks = tuple(int(k) for k in ks)
    vb = getattr(f, "value_bytes", None)
    if vb is not None:
        if hasattr(vb, "pattern"):              # compiled REGEXP
            vb = ("re", vb.pattern)
        elif isinstance(vb, (list, tuple, np.ndarray)):
            vb = tuple(bytes(x) for x in vb)
        else:
            vb = bytes(vb)
    return (f.field.name, int(f.mode),
            getattr(f, "key", None), getattr(f, "key_hi", None), ks, vb)


def _key_to_value(key: int, ft: FieldType):
    """Keyform python int -> native value."""
    if ft.is_float:
        return float(lb.keyform_to_scalar(_split_limbs(key, ft.nlimbs), ft))
    if ft.is_signed:
        return key - (1 << (ft.bits - 1))
    return key


def _split_limbs(key: int, L: int) -> tuple:
    out = []
    for l in range(L - 1, -1, -1):
        out.append((key >> (32 * l)) & 0xFFFFFFFF)
    return tuple(out)
