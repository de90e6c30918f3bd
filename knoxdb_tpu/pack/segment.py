"""Immutable column segments: the unit of device-resident table storage.

Device-first re-design of the reference's pack storage
(/root/reference/internal/pack/package.go:23-34 + internal/block): a
segment is a horizontal slice of a table as a set of fixed-geometry packs
(PACK_SIZE rows, padded), each column encoded per pack with the cheapest
scheme (encode/select.py) and covered by zone-map + bloom stats
(pack/stats.py). Unlike the reference's heap-object packs, all packs of a
segment share shapes so the device side (exec/device.py) stacks them into
scheme-grouped arrays and runs ONE kernel per (scheme, width) group.

Wide types (int128/256, decimal128/256) analyze in the python-int key
domain; when the per-pack value RANGE fits 64 bits (typical for balances)
they bitpack like narrow types — predicates are rewritten to the packed
domain on the host (per-pack constants), so the device never needs >64-bit
arithmetic for filtering.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..encode import select as sel
from ..encode import schemes as S
from ..encode.analyze import analyze_keys
from ..encode.schemes import EncodedPack, Scheme
from ..schema.schema import Field, Schema
from ..types import FieldType, FilterType
from ..utils import limbs as lb
from .stats import FieldStats, SegmentStats

__all__ = ["EncodedColumn", "Segment", "build_segment"]


@dataclass
class EncodedColumn:
    field: Field
    packs: list[EncodedPack]
    wide: bool                      # keyform wider than 64 bits
    # wide columns: per-pack python-int bases (min key), None for narrow
    wide_bases: list[int] | None = None

    @property
    def nlimbs(self) -> int:
        return self.field.type.nlimbs

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.packs)


@dataclass
class Segment:
    schema: Schema
    pack_size: int
    nrows_total: int
    nrows: np.ndarray                      # i64[P] valid rows per pack
    columns: dict[str, EncodedColumn]
    stats: SegmentStats
    epoch: int = 0

    @property
    def npacks(self) -> int:
        return len(self.nrows)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())


def _split(n: int, pack_size: int) -> list[tuple[int, int]]:
    return [(i, min(i + pack_size, n)) for i in range(0, max(n, 1), pack_size)]


def _encode_narrow(field: Field, keys64: np.ndarray, bounds,
                   pack_size: int, raw=None
                   ) -> tuple[EncodedColumn, list[np.ndarray]]:
    packs, per_pack_keys = [], []
    L = field.type.nlimbs
    is_f64 = field.type == FieldType.FLOAT64
    for lo, hi in bounds:
        k = keys64[lo:hi]
        per_pack_keys.append(k)
        if is_f64 and raw is not None:
            # floats: try exact decimal-int transform first (ALP)
            p = S.encode_alp(np.asarray(raw[lo:hi], np.float64), pack_size,
                             width_round=sel.round_width)
            if p is not None:
                packs.append(p)
                continue
        packs.append(sel.encode_pack(k, L, pack_size))
    return EncodedColumn(field, packs, wide=False), per_pack_keys


def _encode_wide(field: Field, limbs: np.ndarray, bounds,
                 pack_size: int) -> tuple[EncodedColumn, list[np.ndarray]]:
    """128/256-bit columns. Per pack: if (max-min) fits 64 bits -> bitpack
    relative keys; elif low cardinality -> dict of limb rows; else raw."""
    L = limbs.shape[0]
    packs, bases, per_pack_keys = [], [], []
    for lo, hi in bounds:
        sub = limbs[:, lo:hi]
        ints = _limbs_to_ints(sub)
        per_pack_keys.append(ints)
        mn, mx = int(ints.min()), int(ints.max())
        rng = mx - mn
        if rng == 0:
            packs.append(S.encode_const(sub[:, :1], hi - lo))
            bases.append(mn)
        elif rng < (1 << 63):
            rel = np.array([int(v) - mn for v in ints], dtype=np.uint64)
            w = sel.round_width(rng.bit_length())
            packs.append(S.encode_bitpack(rel, L, 0, w, pack_size))
            bases.append(mn)
        else:
            packs.append(S.encode_raw(sub, hi - lo, pack_size))
            bases.append(0)
    return EncodedColumn(field, packs, wide=True, wide_bases=bases), per_pack_keys


def _encode_strings(field: Field, raw, bounds, pack_size: int):
    """STRING/BYTES columns: per-pack sorted byte dictionary + code planes
    (see encode/schemes.encode_string_dict). Zone maps hold 8-byte prefix
    keys (CONSERVATIVE: pruning uses strict compares only — equal prefixes
    cannot decide); optional bloom over full byte values."""
    from ..filter import bloom as BL
    if field.filter == FilterType.BITS:
        raise ValueError(
            f"field {field.name}: FilterType.BITS is not supported for "
            f"STRING/BYTES (reference filter.go:369-397); use bloom/bfuse")
    vals = list(raw)
    packs = []
    pref_min = []
    pref_max = []
    blooms = [] if field.filter.is_bloom else None
    fuses = [] if field.filter.is_fuse else None
    for lo, hi in bounds:
        p = S.encode_string_dict(vals[lo:hi], pack_size,
                                 width_round=sel.round_width)
        packs.append(p)
        pref_min.append(int(p.dict_keys[0]) if p.card else 0)
        pref_max.append(int(p.dict_keys[-1]) if p.card else 0)
        if blooms is not None:
            nbits = BL.bloom_bits(pack_size, field.filter)
            blooms.append(BL.build_bytes_np(p.dict_bytes, nbits))
        if fuses is not None:
            from ..filter import fuse as FU
            bits = 8 if field.filter == FilterType.BFUSE8 else 16
            fuses.append(FU.build_bytes(p.dict_bytes, bits))
    col = EncodedColumn(field, packs, wide=False)
    fs = FieldStats(np.array(pref_min, np.uint64),
                    np.array(pref_max, np.uint64),
                    np.stack(blooms) if blooms else None,
                    field.filter, pack_filters=fuses)
    fs.is_prefix = True
    return col, fs


def _limbs_to_ints(limbs: np.ndarray) -> np.ndarray:
    L, n = limbs.shape
    out = np.empty(n, object)
    for i in range(n):
        x = 0
        for l in range(L):
            x = (x << 32) | int(limbs[l, i])
        out[i] = x
    return out


def build_segment(schema: Schema, data: dict[str, np.ndarray],
                  pack_size: int, epoch: int = 0,
                  uniform: int | None = None) -> Segment:
    """data: field name -> native-typed numpy array (or python-int list for
    wide types). All columns must share length. Rows are stored in input
    order (the table engine sorts by pk before building).

    uniform=N builds a SHARD-UNIFORM segment for N-device SPMD execution
    (parallel/engine_spmd.py): pack count padded to a multiple of N and
    every column encoded as exactly ONE (scheme, width, k) group, so the
    fused scan plan traces identically on each device's pack shard."""
    if pack_size < 32 or pack_size & (pack_size - 1):
        raise ValueError(f"pack_size must be a power of two >= 32, "
                         f"got {pack_size}")
    names = [f.name for f in schema.fields]
    n = len(data[names[0]])
    bounds = _split(n, pack_size)
    if uniform:
        P0 = len(bounds)
        P_pad = -(-P0 // uniform) * uniform
        bounds = bounds + [(n, n)] * (P_pad - P0)
    P = len(bounds)
    nrows = np.array([hi - lo for lo, hi in bounds], np.int64)

    columns: dict[str, EncodedColumn] = {}
    fstats: dict[str, FieldStats] = {}
    for f in schema.fields:
        raw = data[f.name]
        if f.type.is_bytes_like:
            columns[f.name], fstats[f.name] = _encode_strings(
                f, raw, bounds, pack_size)
            if uniform:
                _uniform_strings(columns[f.name])
            continue
        wide = f.type.nlimbs > 2
        if wide:
            limbs = lb.to_keyform(raw, f.type)
            if uniform:
                col, keys = _encode_wide_uniform(f, limbs, bounds, pack_size)
            else:
                col, keys = _encode_wide(f, limbs, bounds, pack_size)
        else:
            keys64 = lb.to_keys64(raw, f.type)
            if uniform:
                col, keys = _encode_narrow_uniform(f, keys64, bounds,
                                                   pack_size, raw=raw)
            else:
                col, keys = _encode_narrow(f, keys64, bounds, pack_size,
                                           raw=raw)
        columns[f.name] = col
        limbs_per_pack = None
        if f.filter != FilterType.NONE:
            limbs = lb.to_keyform(raw, f.type)
            limbs_per_pack = [limbs[:, lo:hi] for lo, hi in bounds]
        fstats[f.name] = FieldStats.from_packs(
            keys, wide, limbs_per_pack, f.filter, pack_size)

    rid_base = np.arange(P, dtype=np.uint64) * np.uint64(pack_size)
    stats = SegmentStats(nrows, rid_base, fstats)
    return Segment(schema, pack_size, n, nrows, columns, stats, epoch)


# ----------------------------------------------------- uniform encoders ---
# One (scheme, width, k) group per column: the SPMD layout contract.

def _pad_planes(p: EncodedPack, width: int) -> None:
    """Grow a bitplane pack to `width` by appending zero planes (high bits
    of in-domain values are zero, so match/sum semantics are unchanged)."""
    if p.width >= width:
        return
    W = p.planes.shape[1]
    out = np.zeros((max(width, 1), W), np.uint32)
    if p.width:
        out[:p.width] = p.planes[:p.width]
    p.planes = out
    p.width = width


def _uniform_strings(col: EncodedColumn) -> None:
    wmax = max(p.width for p in col.packs)
    kmax = max(p.k for p in col.packs)
    for p in col.packs:
        _pad_planes(p, wmax)
        p.k = kmax


def _encode_narrow_uniform(field: Field, keys64: np.ndarray, bounds,
                           pack_size: int, raw=None):
    L = field.type.nlimbs
    per_pack_keys = [keys64[lo:hi] for lo, hi in bounds]
    if field.type == FieldType.FLOAT64 and raw is not None:
        packs = []
        ok = True
        for lo, hi in bounds:
            if lo == hi:        # empty pad pack: compatible with any exp
                packs.append(EncodedPack(Scheme.ALP, 0, 2, width=0,
                                         min_key=0, exp=0,
                                         planes=np.zeros(
                                             (1, pack_size // 32), np.uint32)))
                continue
            p = S.encode_alp(np.asarray(raw[lo:hi], np.float64), pack_size,
                             width_round=sel.round_width)
            if p is None:
                ok = False
                break
            packs.append(p)
        if ok:
            wmax = max(p.width for p in packs)
            for p in packs:
                _pad_planes(p, wmax)
            return EncodedColumn(field, packs, wide=False), per_pack_keys
    mins, rngs = [], []
    for k in per_pack_keys:
        mn = int(k.min()) if len(k) else 0
        mins.append(mn)
        rngs.append((int(k.max()) - mn) if len(k) else 0)
    gw = sel.round_width(max(rngs).bit_length()) if max(rngs) else 0
    packs = [S.encode_bitpack(k, L, mn, gw, pack_size)
             for k, mn in zip(per_pack_keys, mins)]
    return EncodedColumn(field, packs, wide=False), per_pack_keys


def _encode_wide_uniform(field: Field, limbs: np.ndarray, bounds,
                         pack_size: int):
    L = limbs.shape[0]
    per_pack, infos = [], []
    for lo, hi in bounds:
        sub = limbs[:, lo:hi]
        ints = _limbs_to_ints(sub)
        per_pack.append(ints)
        if len(ints):
            mn = min(int(v) for v in ints)
            mx = max(int(v) for v in ints)
        else:
            mn = mx = 0
        infos.append((mn, mx - mn, sub))
    if all(rng < (1 << 63) for _, rng, _ in infos):
        gw = sel.round_width(
            max(rng.bit_length() for _, rng, _ in infos)) \
            if any(rng for _, rng, _ in infos) else 0
        packs, bases = [], []
        for (mn, rng, sub), ints in zip(infos, per_pack):
            rel = np.array([int(v) - mn for v in ints], dtype=np.uint64)
            packs.append(S.encode_bitpack(rel, L, 0, gw, pack_size))
            bases.append(mn)
        return EncodedColumn(field, packs, wide=True,
                             wide_bases=bases), per_pack
    packs = [S.encode_raw(sub, sub.shape[1], pack_size)
             for _, _, sub in infos]
    return EncodedColumn(field, packs, wide=True,
                         wide_bases=[0] * len(infos)), per_pack
