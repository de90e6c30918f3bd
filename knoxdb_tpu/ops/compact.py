"""Mask -> selection-vector compaction and masked gather.

Device-side replacement for the reference's bitset.Indexes selection-vector
builder (/root/reference/internal/bitset/kernel.go:31-43, iterator.go):
instead of a serial bit iterator, compaction is an exclusive prefix-sum of
the mask followed by a scatter-with-drop — O(N) elementwise + one scatter,
all on device, static output capacity (callers size by popcount or pack
geometry).

Row order is preserved (stable), matching the reference's ascending rid
semantics.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import bitset as bs

__all__ = ["mask_to_indexes", "take_rows", "compact_rows", "masked_row_ids"]


def mask_to_indexes(mask, cap: int, base: int | jnp.ndarray = 0):
    """bool[N] -> (idx u32[cap], count i64).

    idx[:count] are the (base + row) positions of set bits in ascending
    order; idx[count:] == SENTINEL (0xFFFFFFFF). cap is static.

    Implemented with lax.top_k over negated row ids (a partial sort)
    rather than a scatter (`.at[dest].set`); which is faster on the GPU
    is open (ROADMAP A5)."""
    import jax
    mask = mask.reshape(-1)
    n = mask.shape[0]
    count = mask.sum(dtype=jnp.int64)
    k = min(cap, n)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    neg = jnp.where(mask, -rows, jnp.int32(-(1 << 30)))
    top, _ = jax.lax.top_k(neg, k)          # descending -> rows ascending
    idx = (-top)
    valid = idx < jnp.int32(1 << 30)
    out = jnp.where(valid,
                    idx.astype(jnp.uint32) + jnp.asarray(base, jnp.uint32),
                    jnp.uint32(0xFFFFFFFF))
    if k < cap:
        out = jnp.concatenate(
            [out, jnp.full(cap - k, 0xFFFFFFFF, jnp.uint32)])
    return out, count


def packed_mask_to_indexes(words, cap: int, base=0):
    """Packed u32[W] bitset -> selection vector (unpacks on the fly)."""
    return mask_to_indexes(bs.unpack_mask(words), cap, base)


def take_rows(limbs, idx):
    """Gather rows of a limb column by selection vector.

    limbs: u32[L, N], idx: u32[K] (sentinels allowed; they gather row 0 —
    callers slice by count). Returns u32[L, K]."""
    n = limbs.shape[-1]
    safe = jnp.where(idx == 0xFFFFFFFF, 0, idx).astype(jnp.int32)
    safe = jnp.minimum(safe, n - 1)
    return jnp.take(limbs, safe, axis=-1)


def compact_rows(limbs, mask, cap: int):
    """Fused filter-materialize: keep rows of `limbs` where mask is set.

    Returns (u32[L, cap], count). Rows past count are copies of row 0."""
    idx, count = mask_to_indexes(mask, cap)
    return take_rows(limbs, idx), count


def masked_row_ids(mask, rid_base):
    """bool[P, N] per-pack masks + u64[P] first-rid-per-pack -> global row
    ids of matches, flattened pack-major (ascending when packs are rid-
    ordered). Returned dense with sentinel padding via mask_to_indexes on
    the flat mask; rid arithmetic stays u64."""
    P, n = mask.shape
    flat = mask.reshape(-1)
    local = jnp.arange(P * n, dtype=jnp.uint64) % jnp.uint64(n)
    base = jnp.repeat(rid_base, n)
    return jnp.where(flat, base + local, jnp.uint64(0xFFFFFFFFFFFFFFFF))


def first_k_indexes(mask_words, kcap: int):
    """Packed u32[P, W] mask -> (idx i32[kcap], count i64): the first
    kcap set rows in ascending order (idx past count = 0).

    cumsum + vectorized searchsorted: one bandwidth pass over the mask
    plus kcap binary searches — unlike mask_to_indexes' full-population
    top_k this stays cheap at 16M+ rows when k is small (top-k path)."""
    flat = bs.unpack_mask(mask_words).reshape(-1)
    cs = jnp.cumsum(flat.astype(jnp.int32))
    count = cs[-1].astype(jnp.int64)
    targets = jnp.arange(1, kcap + 1, dtype=jnp.int32)
    idx = jnp.searchsorted(cs, targets).astype(jnp.int32)
    idx = jnp.where(targets <= cs[-1], idx, jnp.int32(0))
    return idx, count


def gather_plane_values(planes, idx, N: int):
    """Bit-sliced u32[w, P, W] planes (plane-major, r4) + flat row ids
    i32[K] -> tuple of u32[K] value words, LSW-first (any width incl.
    wide 128/256-bit).

    Pure 32-bit gathers/shifts (no device u64 arithmetic — see the
    x64-emulation notes); K is top-k-small so the [w, K] gather is
    cheap."""
    w, P, W = planes.shape
    pk = idx // N
    wd = (idx % N) // 32
    bit = (idx % 32).astype(jnp.uint32)
    words = planes[:, pk, wd].T               # [K, w]
    bits = (words >> bit[:, None]) & jnp.uint32(1)
    nw = -(-w // 32)
    out = [jnp.zeros(idx.shape[0], jnp.uint32) for _ in range(nw)]
    for b in range(w):
        out[b // 32] = out[b // 32] | (bits[:, b] << jnp.uint32(b % 32))
    return tuple(out)
