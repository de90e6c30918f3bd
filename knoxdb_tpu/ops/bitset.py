"""Packed u32 bitset ops — the materialized-mask format.

Device-side analog of the reference bitset package
(/root/reference/internal/bitset/kernel.go:31-43): masks that cross kernel
boundaries (selection vectors, MVCC exclude masks, index results) are packed
32 rows/word to cut memory traffic 32x; masks inside a fused scan stay bool and
never leave registers.

Bit order: bit k of word w = row w*32 + k (LSB-first within the word).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pack_mask", "unpack_mask", "bs_and", "bs_or", "bs_xor", "bs_and_not",
    "bs_neg", "popcount", "np_pack_mask", "np_unpack_mask", "np_indexes",
]

_SHIFTS = tuple(range(32))


def pack_mask(mask):
    """bool[..., N] -> uint32[..., N//32] packed bitset."""
    n = mask.shape[-1]
    assert n % 32 == 0, "mask length must be a multiple of 32"
    m = mask.reshape(*mask.shape[:-1], n // 32, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return (m * weights).sum(axis=-1, dtype=jnp.uint32)


def unpack_mask(words, n=None):
    """uint32[..., W] -> bool[..., W*32]."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    out = bits.reshape(*words.shape[:-1], words.shape[-1] * 32).astype(bool)
    return out if n is None else out[..., :n]


def bs_and(a, b):
    return a & b


def bs_or(a, b):
    return a | b


def bs_xor(a, b):
    return a ^ b


def bs_and_not(a, b):
    return a & ~b


def bs_neg(a):
    return ~a


def popcount(words) -> jnp.ndarray:
    """Total set bits (i64 scalar)."""
    return jax.lax.population_count(words).astype(jnp.int64).sum()


# --- host (numpy) versions for journal/stats paths ---

def np_pack_mask(mask: np.ndarray) -> np.ndarray:
    n = mask.shape[-1]
    pad = (-n) % 32
    if pad:
        mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
    return np.packbits(mask.reshape(-1, 32), axis=-1, bitorder="little").view(np.uint32).reshape(-1)


def np_unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return bits[:n].astype(bool)


def np_indexes(mask: np.ndarray) -> np.ndarray:
    """Selection vector (row indices of set bits) — reference
    bitset.Indexes. Host-side; device compaction lives in ops/compact.py."""
    return np.flatnonzero(mask).astype(np.uint32)
