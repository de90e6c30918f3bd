"""Engine-integrated SPMD query execution: the GENERAL fused scan plan
(arbitrary filter tree + multi-column aggregates + group-by + pruning)
running under jax.shard_map over a device mesh.

This is the multi-chip form of the whole reference read path
(/root/reference/internal/pack/table/query.go:27-144): where round 1's
`parallel/shard.py` handled exactly one RANGE+sum shape, this wraps the
SegmentScanner's compiled plan itself — the same traced function, the
same host combine, therefore bit-identical results to single-device
execution by construction.

Layout contract (pack/segment.build_segment uniform=N):
- every column is ONE (scheme, width, k) device group covering all P
  packs, P a multiple of the mesh axis size (padded with empty packs)
- all per-pack arrays shard on their pack axis; filter constants shard on
  their per-pack axes (see _const_entry_specs); scalars replicate
- outputs stay pack-sharded; the host's exact python-int combination is
  unchanged (per-pack partials are tiny: a few u64 per pack)

On a single host the driver validates this on a virtual CPU mesh; the
same program runs on a mesh of GPUs unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..encode.schemes import Scheme
from ..exec.scan import SegmentScanner
from ..exec import device as D

__all__ = ["ShardedScanner", "is_uniform_segment"]


def is_uniform_segment(dseg: D.DeviceSegment, ndev: int) -> bool:
    """True when the segment satisfies the SPMD layout contract."""
    if dseg.P % ndev:
        return False
    for name in dseg.seg.columns:
        col = dseg.column(name)
        if len(col.groups) != 1 or col.groups[0].npacks != dseg.P:
            return False
    return True


def _const_entry_specs(entry: dict, axis: str):
    """PartitionSpecs for one leaf-group constants dict (exec/rewrite.py
    layouts): per-pack arrays shard, query constants replicate."""
    out = {}
    for k, v in entry.items():
        if k in ("rel", "rel_lo", "rel_hi"):
            out[k] = tuple(P(axis) for _ in v)       # 4 x [Pg]
        elif k == "rels":
            out[k] = [tuple(P(axis) for _ in t) for t in v]
        elif k == "const_match":
            out[k] = P(axis)                          # bool[Pg]
        elif k == "dict_mask":
            out[k] = P(axis, None)                    # bool[Pg, k]
        elif k == "cs":
            # DICT per-pack code sets [K, Pg] vs narrow key set [K]
            out[k] = P(None, axis) if v.ndim == 2 else P(None)
        elif k in ("lo", "hi"):
            out[k] = P(axis) if v.ndim == 1 else P()  # DICT [Pg] / scalar
        elif k in ("cs_limbs", "lo_limbs", "hi_limbs"):
            out[k] = P(*(None,) * v.ndim)             # limb constants
        else:
            raise ValueError(f"unknown const key {k!r}")
    return out


def _arg_specs(args, axis: str):
    arrays, consts, overrides, valid, excl = args

    def arr_spec(k, x):
        # "planes" are PLANE-MAJOR [w, Pg, W] since r4 (pack axis 1);
        # every other group array leads with the pack axis
        if k == "planes":
            return P(None, axis, *([None] * (x.ndim - 2)))
        return P(axis, *([None] * (x.ndim - 1)))

    arrays_s = {n: [{k: arr_spec(k, a) for k, a in g.items()} for g in gs]
                for n, gs in arrays.items()}

    def leaf_spec(leaf):
        if isinstance(leaf, list):
            return [_const_entry_specs(g, axis) for g in leaf]
        return tuple(P(axis, None) for _ in leaf)

    consts_s = [leaf_spec(leaf) for leaf in consts]
    overrides_s = [(P(axis), P(axis)) for _ in overrides]
    return (arrays_s, consts_s, overrides_s, P(axis, None),
            tuple(P(axis, None) for _ in excl))


def _out_specs_parts(out_shapes, axis: str):
    """(mask, pack_counts, parts) -> matching spec pytree. Per-pack part
    arrays: 1-d [Pg] shard axis 0; 2-d LIMB forms [L, Pg] shard axis 1."""
    def part_spec(s):
        return P(axis) if s.ndim == 1 else P(None, axis)
    _mask, _cnt, parts = out_shapes
    parts_s = jax.tree_util.tree_map(part_spec, parts)
    return (P(axis, None), P(axis), parts_s)


class ShardedScanner(SegmentScanner):
    """SegmentScanner whose compiled plans execute SPMD over a mesh.

    Requires a uniform segment (build_segment uniform=ndev). prepare()
    returns a shard_map-wrapped version of the SAME raw plan the parent
    builds, so scan()/group_scan() host logic — exact aggregate
    combination, materialization, stats — is inherited untouched."""

    def __init__(self, dseg: D.DeviceSegment, mesh: Mesh,
                 axis: str = "packs"):
        super().__init__(dseg)
        self.mesh = mesh
        self.axis = axis
        ndev = mesh.shape[axis]
        if not is_uniform_segment(dseg, ndev):
            raise ValueError(
                "ShardedScanner needs a uniform segment (one group per "
                f"column, P % {ndev} == 0); build with uniform={ndev}")
        self._sharded: dict = {}
        self._place_arrays()

    def _place_arrays(self) -> None:
        """Pin segment arrays to the pack-sharded layout once, so every
        query reuses the placement instead of resharding per call."""
        def sh(x, key=None):
            if key == "planes":   # plane-major [w, Pg, W]: pack axis 1
                spec = P(None, self.axis, *([None] * (x.ndim - 2)))
            else:
                spec = P(self.axis, *([None] * (x.ndim - 1)))
            return NamedSharding(self.mesh, spec)
        for name in self.d.seg.columns:
            col = self.d.column(name)
            for g in col.groups:
                g.arrays = {k: jax.device_put(v, sh(v, k))
                            for k, v in g.arrays.items()}
        self.d.valid_words = jax.device_put(
            self.d.valid_words, sh(self.d.valid_words))

    def prepare(self, tree, aggs, exclude_words=None, include_words=None):
        fn, args, raw = super().prepare(tree, aggs, exclude_words,
                                        include_words)
        key = id(raw)
        sfn = self._sharded.get(key)
        if sfn is None:
            in_specs = _arg_specs(args, self.axis)
            out_shapes = jax.eval_shape(raw, *args)
            out_specs = _out_specs_parts(out_shapes, self.axis)
            sfn = jax.jit(jax.shard_map(
                raw, mesh=self.mesh, in_specs=in_specs,
                out_specs=out_specs))
            self._sharded[key] = sfn
        return sfn, args, raw

    # ---------------------------------------------------------- group-by --

    def group_scan(self, tree, group_field: str, agg_fields: list[str],
                   exclude_words=None, global_keys=None, gplan=None,
                   minmax: bool = True):
        """SPMD group-by: each device aggregates its local packs into
        [G] partials (the same sort-based kernel, exec/groupby.py);
        out_specs concatenate them to [ndev*G] and the host combines
        exactly — the multi-chip form of config #3."""
        from . import shard as _  # noqa: F401 (doc cross-ref)
        from ..exec import groupby as GB
        d = self.d
        ndev = self.mesh.shape[self.axis]
        if not agg_fields:
            agg_fields = [group_field]
        if gplan is None:
            gplan = GB.plan_groups(d, group_field, global_keys)
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

        use_mxu = (not minmax) and gplan.G <= GB.MXU_MAX_G
        cplan = {f: (GB.chunk_plan(d.seg.stats.fields.get(f))
                     if use_mxu else (8, 0)) for f in agg_fields}
        biases = {f: jnp.uint64(cplan[f][1]) for f in agg_fields}
        sig = ("group-spmd", d.sig(used), group_field, tuple(agg_fields),
               mode_tags, gplan.G, exclude_words is not None, use_mxu,
               tuple(cplan[f][0] for f in agg_fields),
               self._plan_sigs[id(mask_raw)])
        gfn = self._fns.get(sig)
        if gfn is None:
            W = d.W

            def gf(margs, garrays, gconsts, biases):
                mask, _, _ = mask_raw(*margs)
                gids = GB.row_gids(mode_tags, gsigs, gidxs,
                                   garrays[group_field], gconsts, W)
                out = {}
                for f in agg_fields:
                    gi_, gsig_, _ = agg_sigs[f][0]
                    if use_mxu:
                        dec = D.group_decode_halves(gsig_,
                                                    garrays[f][gi_], W)
                        # inside shard_map: the plain XLA path
                        out[f] = GB.group_aggregate_mxu(
                            gids, mask, dec, gplan.G,
                            n_chunks=cplan[f][0], bias=biases[f],
                            family="xla")
                    else:
                        dec = D.group_decode_keys(gsig_,
                                                  garrays[f][gi_], W)
                        out[f] = GB.group_aggregate(gids, mask, dec,
                                                    gplan.G)
                return out

            # garrays spec: every group array shards on its pack axis
            in_specs = (_arg_specs(margs, self.axis),
                        {n: [{k: (P(None, self.axis,
                                    *([None] * (a.ndim - 2)))
                                  if k == "planes" else
                                  P(self.axis, *([None] * (a.ndim - 1))))
                              for k, a in g.items()} for g in gs]
                         for n, gs in garrays.items()},
                        _gconst_specs(gconsts, self.axis),
                        {f: P() for f in agg_fields})
            out_specs = jax.tree_util.tree_map(
                lambda _: P(self.axis),
                jax.eval_shape(gf, margs, garrays, gconsts, biases))
            smapped = jax.shard_map(gf, mesh=self.mesh,
                                    in_specs=in_specs,
                                    out_specs=out_specs)
            gfn = (jax.jit(smapped), smapped)
            self._fns[sig] = gfn

        out = gfn[0](margs, garrays, gconsts, biases)
        G = gplan.G
        results = {}
        counts = None
        for f in agg_fields:
            if use_mxu:
                c, chunks, mn, mx = out[f]
                c = np.asarray(c).reshape(ndev, G)
                mn = np.asarray(mn).reshape(ndev, G)
                mx = np.asarray(mx).reshape(ndev, G)
                per_dev = [GB.mxu_chunk_sums(
                    [np.asarray(ch).reshape(ndev, G)[d] for ch in chunks])
                    for d in range(ndev)]
                # object-array reduce: exact python-int adds driven by
                # numpy instead of a G x ndev python loop
                sums = np.array(per_dev, object).sum(axis=0)
                b = cplan[f][1]
                if b:
                    sums = sums + b * c.sum(axis=0).astype(object)
            else:
                c, slo, shi, mn, mx = (np.asarray(x).reshape(ndev, G)
                                       for x in out[f])
                sums = (slo.astype(object)
                        + (shi.astype(object) << 32)).sum(axis=0)
            if counts is None:
                counts = c.sum(axis=0)
            results[f] = (sums, mn.min(axis=0), mx.max(axis=0))
        return gplan, counts, results


def _gconst_specs(gconsts, axis: str):
    """Specs for exec/groupby.gid_consts output: per-pack LUTs shard on
    the pack axis; scalars and global key tables replicate."""
    out = []
    for c in gconsts:
        if isinstance(c, tuple):                       # bucket (t0, iv)
            out.append(tuple(P() for _ in c))
        elif getattr(c, "ndim", 0) == 2:               # lut [Pg, k]
            out.append(P(axis, None))
        elif getattr(c, "ndim", 0) == 1:
            # "const" gids are per-pack [Pg]; "search" tables are [G].
            # Distinguish by dtype: gid_consts casts const/lut to i32,
            # search tables stay u64.
            out.append(P(axis) if c.dtype == jnp.int32 else P(None))
        else:
            out.append(P())
    return out
