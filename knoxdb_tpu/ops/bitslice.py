"""Fused predicate + aggregate kernels on bit-sliced (bitplane) packs.

This is the device answer to the reference's "fusion kernels" that match on
compressed data without decoding (/root/reference/internal/encode/
container.go:72-76 and the fused cmp-on-bitpacked kernels in
internal/encode/bitpack/cmp_{eq,lt,le,bw}.go) — re-designed for word-parallel vector units
instead of translated:

Packs store values bit-sliced: plane p of a pack is a u32[N/32] word array
where bit k of word j is bit p of row j*32+k. A predicate against a
constant is then evaluated BitWeaving/V-style, MSB plane down, with ~4
bitwise word-ops per plane — i.e. 32 rows per vector lane op and memory traffic
of exactly width/8 bytes per row. The output IS a packed bitset (ops/
bitset.py format), so filter -> mask-combine -> aggregate never touches
row-expanded data.

Aggregates on the filtered mask also stay in the packed domain:
    sum  = sum_p 2^p * popcount(plane_p & mask)       (+ count * min_key)
    min/max = MSB-down candidate-narrowing tournament on planes

All kernels are batched over a leading pack axis P and take per-pack base
keys (min_keys), handling constants that fall outside a pack's packed
domain with per-pack all/none overrides. Inputs are plain jnp so XLA fuses
the whole plane loop into one device-memory pass; shapes are static per
(width, P, W) so one compilation serves every query constant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import FilterMode

__all__ = [
    "cmp_planes", "range_planes", "in_planes", "match_planes",
    "masked_sum_planes", "masked_min_planes", "masked_max_planes",
    "popcount_words",
]

_FULL = np.uint32(0xFFFFFFFF)   # numpy scalars: never captured device
_ZERO = np.uint32(0)            # arrays in traced programs


def _rel_const(c, min_keys, width: int):
    """Relate a u64 keyform constant to each pack's packed domain.

    Returns (c_rel u64[P] clamped into [0, 2^width-1], lt_all bool[P],
    ge_none bool[P], in_dom bool[P]):
      lt_all:  every packed value < c  (c above the domain)
      ge_none: no packed value < c     (c at/below the domain base)
      in_dom:  c - min_key representable in `width` bits (EQ can match)
    """
    c = jnp.asarray(c, jnp.uint64)
    maxp = jnp.uint64((1 << width) - 1 if width < 64 else 0xFFFFFFFFFFFFFFFF)
    ge_min = c >= min_keys
    diff = jnp.where(ge_min, c - min_keys, jnp.uint64(0))
    lt_all = ge_min & (diff > maxp)
    ge_none = ~ge_min
    in_dom = ge_min & ~lt_all
    c_rel = jnp.where(in_dom, diff, jnp.uint64(0))
    return c_rel, lt_all, ge_none, in_dom


def _const_bit_masks(c_rel, width: int):
    """u64[P] -> list of u32[P, 1] full/zero word masks, one per plane."""
    out = []
    for p in range(width):
        bit = ((c_rel >> jnp.uint64(p)) & jnp.uint64(1)) != 0
        out.append(jnp.where(bit, _FULL, _ZERO)[:, None])
    return out


def _lt_eq_planes(planes, cmasks, width: int):
    """Core MSB-down sweep. planes: u32[w, P, W] (PLANE-MAJOR, r4).

    Returns (lt, eq): packed u32[P, W] word masks for x < c and x == c
    over the packed domain."""
    _, P, W = planes.shape
    lt = jnp.zeros((P, W), jnp.uint32)
    eq = jnp.full((P, W), _FULL)
    for p in range(width - 1, -1, -1):
        x = planes[p]
        cm = cmasks[p]
        # c bit 1 & x bit 0 while equal so far => x < c
        lt = lt | (eq & ~x & cm)
        # stay equal where x bit == c bit
        eq = eq & ~(x ^ cm)
    return lt, eq


def _apply_overrides(m, lt_all, ge_none, mode_is_lt: bool):
    """Override packed word-mask m with per-pack all/none degenerate cases."""
    sel_all = lt_all[:, None]
    sel_none = ge_none[:, None]
    m = jnp.where(sel_all, _FULL if mode_is_lt else _ZERO, m)
    m = jnp.where(sel_none, _ZERO if mode_is_lt else m, m)
    return m


def cmp_planes_rel(mode: FilterMode, planes, rel, width: int):
    """Compare with a host/device-precomputed domain relation.

    rel = (c_rel u64[P], lt_all bool[P], ge_none bool[P], in_dom bool[P])
    as produced by _rel_const — or by the host with exact python-int
    arithmetic for WIDE types whose pack bases exceed u64
    (pack/segment.py _encode_wide). Packed-domain planes compare against
    c_rel; the flags override packs where the constant falls outside the
    packed domain."""
    c_rel, lt_all, ge_none, in_dom = rel
    cmasks = _const_bit_masks(c_rel, width)

    if mode in (FilterMode.EQ, FilterMode.NE):
        eq = jnp.full(planes.shape[1:], _FULL)
        for p in range(width):
            eq = eq & ~(planes[p] ^ cmasks[p])
        eq = jnp.where(in_dom[:, None], eq, _ZERO)
        return ~eq if mode == FilterMode.NE else eq

    lt, eq = _lt_eq_planes(planes, cmasks, width)
    if mode == FilterMode.LT:
        lt = jnp.where(lt_all[:, None], _FULL, lt)
        return jnp.where(ge_none[:, None], _ZERO, lt)
    if mode == FilterMode.GE:
        lt = jnp.where(lt_all[:, None], _FULL, lt)
        return ~jnp.where(ge_none[:, None], _ZERO, lt)
    if mode == FilterMode.LE:
        le = lt | jnp.where(in_dom[:, None], eq, _ZERO)
        le = jnp.where(lt_all[:, None], _FULL, le)
        return jnp.where(ge_none[:, None], _ZERO, le)
    if mode == FilterMode.GT:
        le = lt | jnp.where(in_dom[:, None], eq, _ZERO)
        le = jnp.where(lt_all[:, None], _FULL, le)
        return ~jnp.where(ge_none[:, None], _ZERO, le)
    raise ValueError(f"cmp_planes_rel: unsupported mode {mode!r}")


def range_planes_rel(planes, rel_lo, rel_hi, width: int):
    """lo <= x <= hi with precomputed relations, one sweep (see
    range_planes)."""
    lo_rel, lo_lt_all, lo_ge_none, _lo_in = rel_lo
    hi_rel, hi_lt_all, hi_ge_none, hi_in = rel_hi
    lo_masks = _const_bit_masks(lo_rel, width)
    hi_masks = _const_bit_masks(hi_rel, width)

    _, P, W = planes.shape
    lt_lo = jnp.zeros((P, W), jnp.uint32)
    eq_lo = jnp.full((P, W), _FULL)
    lt_hi = jnp.zeros((P, W), jnp.uint32)
    eq_hi = jnp.full((P, W), _FULL)
    for p in range(width - 1, -1, -1):
        x = planes[p]
        cl, ch = lo_masks[p], hi_masks[p]
        lt_lo = lt_lo | (eq_lo & ~x & cl)
        eq_lo = eq_lo & ~(x ^ cl)
        lt_hi = lt_hi | (eq_hi & ~x & ch)
        eq_hi = eq_hi & ~(x ^ ch)

    lt_lo = jnp.where(lo_lt_all[:, None], _FULL, lt_lo)
    ge_lo = ~jnp.where(lo_ge_none[:, None], _ZERO, lt_lo)
    le_hi = lt_hi | jnp.where(hi_in[:, None], eq_hi, _ZERO)
    le_hi = jnp.where(hi_lt_all[:, None], _FULL, le_hi)
    le_hi = jnp.where(hi_ge_none[:, None], _ZERO, le_hi)
    return ge_lo & le_hi


def in_planes_rel(planes, rels, width: int):
    """x in set given per-key precomputed relations (list of rel tuples)."""
    _, P, W = planes.shape
    eq_states = [jnp.full((P, W), _FULL) for _ in rels]
    masks = [_const_bit_masks(r[0], width) for r in rels]
    for p in range(width - 1, -1, -1):
        x = planes[p]
        for k in range(len(rels)):
            eq_states[k] = eq_states[k] & ~(x ^ masks[k][p])
    acc = jnp.zeros((P, W), jnp.uint32)
    for k, r in enumerate(rels):
        acc = acc | jnp.where(r[3][:, None], eq_states[k], _ZERO)
    return acc


def cmp_planes(mode: FilterMode, planes, min_keys, c, width: int):
    """Fused compare on bit-sliced packs.

    planes:   u32[width, P, W] bitplanes (plane-major) (W words of 32 rows each)
    min_keys: u64[P] per-pack base (value = packed + min_key)
    c:        u64 keyform constant — scalar, or u64[P] per-pack constants
              (used by the fused dict matcher, which rewrites value-space
              predicates into per-pack code-space constants)
    returns packed bitset u32[P, W].
    """
    return cmp_planes_rel(mode, planes, _rel_const(c, min_keys, width), width)


def range_planes(planes, min_keys, lo, hi, width: int):
    """lo <= x <= hi in ONE sweep over the planes (shared loads; the
    reference's between kernels read the data once too — cmp asm bw_*)."""
    return range_planes_rel(planes, _rel_const(lo, min_keys, width),
                            _rel_const(hi, min_keys, width), width)


def in_planes(planes, min_keys, cs, width: int):
    """x in {cs[k]}; cs: u64[K] (static K), or u64[K, P] per-pack key sets.
    K-way OR of EQ sweeps sharing one pass over the planes."""
    rels = [_rel_const(cs[k], min_keys, width) for k in range(cs.shape[0])]
    return in_planes_rel(planes, rels, width)


def match_planes(mode: FilterMode, planes, min_keys, width: int,
                 lo=None, hi=None, cs=None):
    """Mode dispatch (static) for bit-sliced packs -> packed bitset."""
    if mode == FilterMode.RANGE:
        return range_planes(planes, min_keys, lo, hi, width)
    if mode == FilterMode.IN:
        return in_planes(planes, min_keys, cs, width)
    if mode == FilterMode.NOT_IN:
        return ~in_planes(planes, min_keys, cs, width)
    return cmp_planes(mode, planes, min_keys, lo, width)


# ------------------------------------------------------------ aggregates ---

def popcount_words(words):
    """u32[..., W] -> i64[...] set-bit count over the last axis."""
    return jax.lax.population_count(words).astype(jnp.int64).sum(axis=-1)


def masked_sum_planes(planes, min_keys, mask_words, width: int):
    """Masked sum WITHOUT decode.

    planes u32[w, P, W], min_keys u64[P], mask u32[P, W] packed.
    Returns (sums u64[P], counts i64[P]) where sums are in the VALUE
    domain: sum_p 2^p popcount(plane & mask) + count * min_key (mod 2^64;
    caller widens per-pack partials on the host for >64-bit exactness)."""
    counts = popcount_words(mask_words)
    total = jnp.zeros(planes.shape[1], jnp.uint64)
    for p in range(width):
        c = popcount_words(planes[p] & mask_words).astype(jnp.uint64)
        total = total + (c << jnp.uint64(p))
    total = total + counts.astype(jnp.uint64) * min_keys
    return total, counts


def _tournament_planes(planes, mask_words, width: int, want_max: bool):
    """MSB-down candidate narrowing. Returns packed-domain winner u64[P]
    (0 when mask empty — caller checks counts)."""
    _, P, W = planes.shape
    cand = mask_words
    out = jnp.zeros(P, jnp.uint64)
    for p in range(width - 1, -1, -1):
        x = planes[p]
        t = cand & (x if want_max else ~x)
        has = (t != 0).any(axis=-1)
        cand = jnp.where(has[:, None], t, cand)
        if want_max:
            out = out | (has.astype(jnp.uint64) << jnp.uint64(p))
        else:
            # min: bit is 1 only when NO candidate had a 0 there
            out = out | ((~has).astype(jnp.uint64) << jnp.uint64(p))
    return out


def masked_min_planes(planes, min_keys, mask_words, width: int):
    """Masked min in VALUE domain: u64[P] (= min_key when mask empty)."""
    rel = _tournament_planes(planes, mask_words, width, want_max=False)
    return rel + min_keys


def masked_max_planes(planes, min_keys, mask_words, width: int):
    rel = _tournament_planes(planes, mask_words, width, want_max=True)
    return rel + min_keys


# ------------------------------------------------------------------ top-k ---

def add_const_planes(planes, const_bits, width_out: int):
    """Bit-sliced ripple-carry add of a PER-PACK constant.

    planes u32[w, P, W] (plane-major) encode x (pack-relative offsets);
    const_bits u32[width_out, P] holds bit b of each pack's constant as
    a full/zero word mask (0xFFFFFFFF / 0) — computed on the HOST from
    pack metadata (no device 64-bit shifts). Returns u32[width_out, P, W] bitplanes of
    (x + c) mod 2^width_out.

    Cost: width_out sequential full-adder steps of [P, W] word ops —
    ~2 reads + 1 write of the plane volume, bandwidth-bound."""
    w, P, W = planes.shape
    carry = jnp.zeros((P, W), jnp.uint32)
    outs = []
    for b in range(width_out):
        xb = planes[b] if b < w else jnp.zeros((P, W), jnp.uint32)
        cb = const_bits[b][:, None]
        s = xb ^ cb ^ carry
        carry = (xb & cb) | (carry & (xb ^ cb))
        outs.append(s)
    return jnp.stack(outs, axis=0)


def topk_select(planes, mask_words, k, width: int, want_max: bool):
    """Exact top-k THRESHOLD + candidate masks via MSB-first RADIX-4 bit
    descent: ceil(width/2) dependent steps of 4-bucket popcounts over
    [P, W] words — bandwidth bound, no sort of the row population
    (lax.top_k/sort over P*N keys).

    TWO bits per step: the steps form a dependent chain of small
    kernels, so halving the chain (64 -> 32 steps at w=64) halves the
    number of launches; the extra popcounts per step ride the same
    plane reads.

    planes must be in a COMPARABLE domain across packs (absolute keys
    minus a global base — see add_const_planes). k is a traced i32.

    Returns (t_words tuple of u32 scalars LSW-first, better u32[P, W],
    tie u32[P, W], n_better i32): `better` rows beat the threshold
    T = sum_j t_words[j] << 32j strictly, ties equal it; the top-k set =
    better + any (k - n_better) tie rows. Works at ANY width (wide
    int128/256 keyform planes included)."""
    _, P, W = planes.shape
    nw = -(-width // 32)
    pm = mask_words                      # rows still matching the prefix
    better = jnp.zeros((P, W), jnp.uint32)
    t_words = [jnp.uint32(0)] * nw
    k_rem = k.astype(jnp.int32)
    U1 = jnp.uint32(1)
    U0 = jnp.uint32(0)

    def setbit(b, tbit):
        t_words[b // 32] = t_words[b // 32] | (tbit << jnp.uint32(b % 32))

    def pcount(m):
        return jnp.sum(jax.lax.population_count(m).astype(jnp.int32),
                       dtype=jnp.int32)

    b = width - 1
    if width % 2:                        # odd width: one single-bit step
        x = planes[b]
        pref = pm & (x if want_max else ~x)
        rest = pm & (~x if want_max else x)
        c = pcount(pref)
        take = c >= k_rem
        pm = jnp.where(take, pref, rest)
        better = jnp.where(take, better, better | pref)
        k_rem = jnp.where(take, k_rem, k_rem - c)
        setbit(b, jnp.where(take == want_max, U1, U0))
        b -= 1
    while b >= 1:
        # preferred-direction bit pair: after the conditional complement
        # "1" always means "sorts toward the top", so bucket preference
        # is p=3 > 2 > 1 > 0 regardless of want_max
        x1 = planes[b]
        x0 = planes[b - 1]
        if not want_max:
            x1 = ~x1
            x0 = ~x0
        g3 = pm & x1 & x0
        g2 = pm & x1 & ~x0
        g1 = pm & ~x1 & x0
        c3 = pcount(g3)
        c2 = pcount(g2)
        c1 = pcount(g1)
        cum2 = c3 + c2
        cum1 = cum2 + c1
        s3 = c3 >= k_rem
        s2 = (~s3) & (cum2 >= k_rem)
        s1 = (~s3) & (~s2) & (cum1 >= k_rem)
        in3 = s3
        in23 = s3 | s2
        in123 = in23 | s1
        pm = jnp.where(in3, g3,
                       jnp.where(s2, g2,
                                 jnp.where(s1, g1, pm & ~x1 & ~x0)))
        better = better | jnp.where(in3, U0, g3) \
            | jnp.where(in23, U0, g2) | jnp.where(in123, U0, g1)
        k_rem = k_rem - jnp.where(in3, 0, c3) \
            - jnp.where(in23, 0, c2) - jnp.where(in123, 0, c1)
        # chosen bucket bits in preferred space; actual bit = pref bit
        # for max, complement for min
        p1 = jnp.where(in23, U1, U0)
        p0 = jnp.where(s3 | s1, U1, U0)
        if not want_max:
            p1 = p1 ^ U1
            p0 = p0 ^ U1
        setbit(b, p1)
        setbit(b - 1, p0)
        b -= 2
    # the single-bit MSB step leaves an ODD remaining count in both
    # parities, so the pair loop always lands exactly on (1, 0)
    n_better = pcount(better)
    return tuple(t_words), better, pm, n_better
