"""Host-side predicate rewriting: filter leaves -> per-group kernel consts.

The device kernels (exec/device.py) are compiled per (scheme, width) group
with CONSTANTS TRACED, so queries that differ only in literal values reuse
the compilation. This module prepares those constants each query:

- BITPACK/DELTA (narrow): the global u64 keyform constant(s).
- BITPACK (wide): per-pack domain relations computed with exact python
  ints (pack bases exceed u64) -> (c_rel, lt_all, ge_none, in_dom) arrays
  consumed by ops/bitslice.cmp_planes_rel.
- DICT: predicates rewritten into per-pack CODE space via searchsorted on
  each pack's sorted dictionary — the fused dict matcher never touches the
  value arrays at all (the device form of the reference's dict container
  matcher, internal/encode/container.go:72-76).
- RLE/RAW: u32 limb constants for the lexicographic limb compare.
- CONST packs: fully decided on host -> bool verdict per pack.

IN-set sizes are padded to the next power of two with repeated/sentinel
keys so set queries of similar size share compilations.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..encode.schemes import Scheme
from ..pack.segment import EncodedColumn
from ..query.filter import Filter
from ..types import FilterMode
from .device import DeviceGroup

__all__ = ["leaf_group_consts", "leaf_group_static"]

_U64_MAX = (1 << 64) - 1
_MISS = 1 << 63          # sentinel: outside every packed domain
_IN_DICT_MASK_MIN_K = 64  # above this, dict IN uses a bool dict mask
#                           (below, the K-way code sweep compiles fast
#                           and avoids the [Pg, N] gather)
_IN_SORT_MIN_K_WIDE = 17  # wide IN lists above this take L-limb
#                           sort-membership (decode + merged sort)


def _pow2_pad(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def leaf_group_static(leaf: Filter, g: DeviceGroup) -> tuple:
    """Static part of the rewrite (goes into the jit-cache signature)."""
    K = 0
    if leaf.mode in (FilterMode.IN, FilterMode.NOT_IN):
        K = _pow2_pad(len(leaf.keys))
    # byte dicts rewrite IN/REGEXP to a per-pack dict-mask gather
    mask_path = g.dict_bytes is not None and leaf.mode in (
        FilterMode.IN, FilterMode.NOT_IN, FilterMode.REGEXP)
    return (int(leaf.mode), int(g.scheme), g.width, g.nlimbs, g.wide, K,
            mask_path)


def leaf_group_consts(leaf: Filter, col: EncodedColumn, g: DeviceGroup):
    """Traced constants for one (leaf, group). Returns a dict of jnp
    arrays (possibly empty for CONST groups decided entirely by verdicts)."""
    mode = leaf.mode
    if g.scheme == Scheme.CONST:
        return {"const_match": jnp.asarray(_const_verdicts(leaf, col, g))}

    if g.scheme == Scheme.DICT:
        if g.dict_bytes is not None:
            return _dict_consts_bytes(leaf, g)
        return _dict_consts(leaf, g)

    if g.scheme == Scheme.ALP:
        return _alp_consts(leaf, g)

    if g.scheme in (Scheme.BITPACK, Scheme.DELTA):
        if g.wide:
            return _wide_bitpack_consts(leaf, g)
        out = {}
        if mode in (FilterMode.IN, FilterMode.NOT_IN):
            out["cs"] = jnp.asarray(_pad_keys(leaf.keys))
        elif mode == FilterMode.RANGE:
            out["lo"] = jnp.uint64(leaf.key)
            out["hi"] = jnp.uint64(leaf.key_hi)
        else:
            out["lo"] = jnp.uint64(leaf.key)
        return out

    # RAW / RLE: limb-domain constants
    out = {}
    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        limbs = leaf.key_limbs
        K = _pow2_pad(limbs.shape[1])
        pad = np.repeat(limbs[:, :1], K - limbs.shape[1], axis=1)
        out["cs_limbs"] = jnp.asarray(np.concatenate([limbs, pad], axis=1))
    elif mode == FilterMode.RANGE:
        out["lo_limbs"] = jnp.asarray(_int_to_limbs(leaf.key, g.nlimbs))
        out["hi_limbs"] = jnp.asarray(_int_to_limbs(leaf.key_hi, g.nlimbs))
    else:
        out["lo_limbs"] = jnp.asarray(_int_to_limbs(leaf.key, g.nlimbs))
    return out


def _int_to_limbs(key: int, L: int) -> np.ndarray:
    out = np.empty(L, np.uint32)
    for l in range(L - 1, -1, -1):
        out[l] = key & 0xFFFFFFFF
        key >>= 32
    return out


def _pad_keys(keys: np.ndarray) -> np.ndarray:
    K = _pow2_pad(len(keys))
    if K == len(keys):
        return keys.astype(np.uint64)
    pad = np.repeat(keys[:1], K - len(keys))
    return np.concatenate([keys, pad]).astype(np.uint64)


def _pack_const_value(col: EncodedColumn, g: DeviceGroup, j: int) -> int:
    """Python-int key of a CONST pack (wide bases included)."""
    if g.wide:
        return g.bases[j]
    p = col.packs[int(g.idx[j])]
    x = 0
    for l in range(p.values.shape[0]):
        x = (x << 32) | int(p.values[l, 0])
    return x


def _const_verdicts(leaf: Filter, col: EncodedColumn, g: DeviceGroup) -> np.ndarray:
    out = np.empty(g.npacks, bool)
    m = leaf.mode
    for j in range(g.npacks):
        v = _pack_const_value(col, g, j)
        if m == FilterMode.EQ:
            out[j] = v == leaf.key
        elif m == FilterMode.NE:
            out[j] = v != leaf.key
        elif m == FilterMode.LT:
            out[j] = v < leaf.key
        elif m == FilterMode.LE:
            out[j] = v <= leaf.key
        elif m == FilterMode.GT:
            out[j] = v > leaf.key
        elif m == FilterMode.GE:
            out[j] = v >= leaf.key
        elif m == FilterMode.RANGE:
            out[j] = leaf.key <= v <= leaf.key_hi
        elif m == FilterMode.IN:
            out[j] = v in set(int(k) for k in leaf.keys)
        elif m == FilterMode.NOT_IN:
            out[j] = v not in set(int(k) for k in leaf.keys)
        else:
            raise ValueError(f"const verdict: {m}")
    return out


# ---------------------------------------------------------------- alp ---

def _wide_rel_list(cs: list[int], bases: list[int], width: int):
    """Per-pack constants version of _wide_rel (exact python ints)."""
    maxp = (1 << width) - 1
    P = len(bases)
    c_rel = np.zeros(P, np.uint64)
    lt_all = np.zeros(P, bool)
    ge_none = np.zeros(P, bool)
    in_dom = np.zeros(P, bool)
    for j, (c, b) in enumerate(zip(cs, bases)):
        d = c - b
        if d < 0:
            ge_none[j] = True
        elif d > maxp:
            lt_all[j] = True
        else:
            in_dom[j] = True
            c_rel[j] = d
    return (jnp.asarray(c_rel), jnp.asarray(lt_all), jnp.asarray(ge_none),
            jnp.asarray(in_dom))


def _alp_keybound(key: int, ft) -> float:
    """Exact float bound from a keyform key. The optimizer's strict-bound
    merges (query/filter._merge_and_bounds: GT -> key+1, LT -> key-1) are
    +-1-ulp adjustments in keyform space; converting the key back gives the
    correct INCLUSIVE float bound, so `x > 5.0 AND x <= 10.0` prunes 5.0
    on ALP packs exactly like on keyform packs. Keys in the NaN keyform
    regions clamp to +-inf (ALP packs hold finite values only)."""
    import math
    from ..utils import limbs as lb
    L = ft.nlimbs
    ninf = lb.scalar_to_keyform(-math.inf, ft)
    pinf = lb.scalar_to_keyform(math.inf, ft)
    k_lo = 0
    k_hi = 0
    for l in range(L):
        k_lo = (k_lo << 32) | ninf[l]
        k_hi = (k_hi << 32) | pinf[l]
    key = min(max(key, k_lo), k_hi)
    parts = tuple((key >> (32 * (L - 1 - l))) & 0xFFFFFFFF for l in range(L))
    return float(lb.keyform_to_scalar(parts, ft))


def _alp_consts(leaf: Filter, g: DeviceGroup):
    """Float predicates -> per-pack ALP enc-domain bounds (double-domain
    exact; encode/alp.enc_bounds). Kernel modes: LT->LE(bound),
    GT->GE(bound) folded here; device maps statically. GE/LE/RANGE bounds
    come from the merged keyform keys (see _alp_keybound) — NOT leaf.value,
    which loses strictness after optimizer merges."""
    from ..encode.alp import enc_bounds
    m = leaf.mode
    ft = leaf.field.type
    _MISS_BOUND = 1 << 62

    def bounds_for(c: float):
        return [enc_bounds(float(c), e) for e in g.exps]

    if m == FilterMode.RANGE:
        lo_v = _alp_keybound(leaf.key, ft)
        hi_v = _alp_keybound(leaf.key_hi, ft)
        lo_b = [ge for _, ge, _ in bounds_for(lo_v)]
        hi_b = [le for le, _, _ in bounds_for(hi_v)]
        return {"rel_lo": _wide_rel_list(lo_b, g.bases, g.width),
                "rel_hi": _wide_rel_list(hi_b, g.bases, g.width)}
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        rels = []
        K = _pow2_pad(len(leaf.value))
        vals = list(leaf.value) + [leaf.value[0]] * (K - len(leaf.value))
        for v in vals:
            cs = [eq if eq is not None else _MISS_BOUND
                  for _, _, eq in bounds_for(v)]
            rels.append(_wide_rel_list(cs, g.bases, g.width))
        return {"rels": rels}
    bs_ = bounds_for(leaf.value)
    if m in (FilterMode.EQ, FilterMode.NE):
        cs = [eq if eq is not None else _MISS_BOUND for _, _, eq in bs_]
    elif m == FilterMode.LT:      # v < c ⟺ enc <= (largest with dec < c)
        cs = [le - 1 if eq is not None else le for le, _, eq in bs_]
    elif m == FilterMode.LE:
        cs = [le for le, _, _ in bounds_for(_alp_keybound(leaf.key, ft))]
    elif m == FilterMode.GT:
        cs = [ge + 1 if eq is not None else ge for _, ge, eq in bs_]
    elif m == FilterMode.GE:
        cs = [ge for _, ge, _ in bounds_for(_alp_keybound(leaf.key, ft))]
    else:
        raise ValueError(f"alp rewrite: {m}")
    return {"rel": _wide_rel_list(cs, g.bases, g.width)}


# --------------------------------------------------------------- wide ---

def _wide_rel(c: int, bases: list[int], width: int):
    """Exact python-int domain relation for wide bitpack groups."""
    maxp = (1 << width) - 1
    P = len(bases)
    c_rel = np.zeros(P, np.uint64)
    lt_all = np.zeros(P, bool)
    ge_none = np.zeros(P, bool)
    in_dom = np.zeros(P, bool)
    for j, b in enumerate(bases):
        d = c - b
        if d < 0:
            ge_none[j] = True
        elif d > maxp:
            lt_all[j] = True
        else:
            in_dom[j] = True
            c_rel[j] = d
    return (jnp.asarray(c_rel), jnp.asarray(lt_all), jnp.asarray(ge_none),
            jnp.asarray(in_dom))


def _wide_bitpack_consts(leaf: Filter, g: DeviceGroup):
    m = leaf.mode
    if m == FilterMode.RANGE:
        return {"rel_lo": _wide_rel(leaf.key, g.bases, g.width),
                "rel_hi": _wide_rel(leaf.key_hi, g.bases, g.width)}
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        if g.scheme == Scheme.BITPACK and \
                len(leaf.keys) >= _IN_SORT_MIN_K_WIDE:
            # big wide IN list: L-limb sort-membership (the per-key
            # rels sweep traces O(K * width) graph ops — the same
            # compile pathology as the narrow schemes). Keys + per-pack
            # absolute-rebase bases travel as arrays; the device
            # decodes limbs, rebases, and runs one merged (L+1)-key
            # sort (exec/join._probe_bounds_merged_limbs).
            limbs = leaf.key_limbs
            K = _pow2_pad(limbs.shape[1])
            pad = np.repeat(limbs[:, :1], K - limbs.shape[1], axis=1)
            base = np.zeros((g.npacks, g.nlimbs), np.uint32)
            for j, b in enumerate(g.bases):
                x = int(b)
                for l in range(g.nlimbs - 1, -1, -1):
                    base[j, l] = x & 0xFFFFFFFF
                    x >>= 32
            return {"cs_limbs": jnp.asarray(
                        np.concatenate([limbs, pad], axis=1)),
                    "base_limbs": jnp.asarray(base)}
        keys = [int(k) for k in leaf.keys]
        K = _pow2_pad(len(keys))
        keys = keys + [keys[0]] * (K - len(keys))
        return {"rels": [_wide_rel(k, g.bases, g.width) for k in keys]}
    return {"rel": _wide_rel(leaf.key, g.bases, g.width)}


# -------------------------------------------------------------- bytes ---

def _dict_consts_bytes(leaf: Filter, g: DeviceGroup):
    """STRING/BYTES predicates -> per-pack code space via the byte-sorted
    host dictionaries. All modes are EXACT (full byte comparison happens
    on the dictionary, device only compares codes):
      EQ/NE/LT/LE/GT/GE/RANGE -> bisect bounds (as _dict_consts)
      IN / NOT_IN / REGEXP    -> per-pack bool dict mask, gathered by code
    """
    import bisect
    m = leaf.mode
    P = g.npacks

    if m in (FilterMode.IN, FilterMode.NOT_IN, FilterMode.REGEXP):
        dm = np.zeros((P, g.k), bool)
        for j, db in enumerate(g.dict_bytes):
            if m == FilterMode.REGEXP:
                rx = leaf.value_bytes
                for c, b in enumerate(db):
                    try:
                        s = b.decode()
                    except UnicodeDecodeError:
                        s = b.decode("latin-1")
                    dm[j, c] = rx.search(s) is not None
            else:
                want = set(leaf.value_bytes)
                for c, b in enumerate(db):
                    dm[j, c] = b in want
        if m == FilterMode.NOT_IN:
            dm = ~dm
        return {"dict_mask": jnp.asarray(dm)}

    lo = np.zeros(P, np.uint64)
    hi = np.zeros(P, np.uint64)
    for j, db in enumerate(g.dict_bytes):
        card = len(db)
        if m in (FilterMode.EQ, FilterMode.NE):
            pos = bisect.bisect_left(db, leaf.value_bytes)
            found = pos < card and db[pos] == leaf.value_bytes
            lo[j] = pos if found else _MISS
        elif m == FilterMode.LT:
            lo[j] = bisect.bisect_left(db, leaf.value_bytes)
        elif m == FilterMode.LE:
            lo[j] = bisect.bisect_right(db, leaf.value_bytes)
        elif m == FilterMode.GT:
            lo[j] = bisect.bisect_right(db, leaf.value_bytes)
        elif m == FilterMode.GE:
            lo[j] = bisect.bisect_left(db, leaf.value_bytes)
        elif m == FilterMode.RANGE:
            l = bisect.bisect_left(db, leaf.value_bytes[0])
            h = bisect.bisect_right(db, leaf.value_bytes[1])
            if h == 0:
                lo[j], hi[j] = 1, 0
            else:
                lo[j], hi[j] = l, h - 1
        else:
            raise ValueError(f"bytes dict rewrite: {m}")
    out = {"lo": jnp.asarray(lo)}
    if m == FilterMode.RANGE:
        out["hi"] = jnp.asarray(hi)
    return out


# --------------------------------------------------------------- dict ---

def _dict_consts(leaf: Filter, g: DeviceGroup):
    """Rewrite value-space predicate to per-pack code space.

    Code space is order-preserving (dictionaries are sorted), so:
      EQ v   -> EQ  pos        (or miss sentinel)
      LT v   -> LT  lower_bound(v)
      LE v   -> LT  upper_bound(v)
      GT v   -> GE  upper_bound(v)
      GE v   -> GE  lower_bound(v)
      RANGE  -> RANGE [lower_bound(lo), upper_bound(hi) - 1]
    (static mode mapping lives in exec/device.group_match)."""
    m = leaf.mode
    P = g.npacks
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        keys = np.asarray(leaf.keys, np.uint64)
        if len(keys) >= _IN_DICT_MASK_MIN_K:
            # big IN list: per-pack bool DICT MASK (host np.isin) +
            # one code gather — the K-way code-plane sweep traces O(K)
            # graph ops (same compile pathology as the narrow schemes,
            # fixed r2-cont)
            dm = np.zeros((P, g.k), bool)
            for j, dk in enumerate(g.dict_keys):
                dm[j, :len(dk)] = np.isin(dk, keys)
            if m == FilterMode.NOT_IN:
                dm = ~dm
            return {"dict_mask": jnp.asarray(dm)}
        K = _pow2_pad(len(keys))
        cs = np.full((K, P), _MISS, np.uint64)
        for j, dk in enumerate(g.dict_keys):
            pos = np.searchsorted(dk, keys)
            pos_c = np.minimum(pos, len(dk) - 1)
            found = dk[pos_c] == keys
            cs[:len(keys), j] = np.where(found, pos_c, _MISS)
        return {"cs": jnp.asarray(cs)}

    lo = np.zeros(P, np.uint64)
    hi = np.zeros(P, np.uint64)
    for j, dk in enumerate(g.dict_keys):
        card = len(dk)
        if m in (FilterMode.EQ, FilterMode.NE):
            pos = int(np.searchsorted(dk, np.uint64(leaf.key)))
            found = pos < card and int(dk[pos]) == leaf.key
            lo[j] = pos if found else _MISS
        elif m == FilterMode.LT:
            lo[j] = np.searchsorted(dk, np.uint64(leaf.key), side="left")
        elif m == FilterMode.LE:
            lo[j] = np.searchsorted(dk, np.uint64(leaf.key), side="right")
        elif m == FilterMode.GT:
            lo[j] = np.searchsorted(dk, np.uint64(leaf.key), side="right")
        elif m == FilterMode.GE:
            lo[j] = np.searchsorted(dk, np.uint64(leaf.key), side="left")
        elif m == FilterMode.RANGE:
            l = int(np.searchsorted(dk, np.uint64(leaf.key), side="left"))
            h = int(np.searchsorted(dk, np.uint64(leaf.key_hi), side="right"))
            if h == 0:
                lo[j], hi[j] = 1, 0       # empty code range
            else:
                lo[j], hi[j] = l, h - 1
        else:
            raise ValueError(f"dict rewrite: {m}")
    out = {"lo": jnp.asarray(lo)}
    if m == FilterMode.RANGE:
        out["hi"] = jnp.asarray(hi)
    return out
