"""Vectorized predicate kernels over uint32 keyform limbs.

Device-side replacement for the reference's per-type SIMD compare kernels
(/root/reference/internal/cmp/cmp.go:35-42 + 25k lines of AVX2/AVX512 asm).
Because every type is in order-preserving keyform (utils/limbs.py), ONE
lexicographic unsigned limb comparison family covers all of
i8..i64, u8..u64, f32, f64, i128, i256, decimals and timestamps.

All functions take:
  x: uint32[L, *shape]  column limbs (L = 1, 2, 4 or 8)
  c: uint32[L]          constant limbs (traced, so queries don't recompile
                        when only the constant changes)
and return bool[*shape] masks. XLA fuses these with the surrounding decode
and mask-combine stages into a single device-memory pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import FilterMode

__all__ = ["eq", "ne", "lt", "le", "gt", "ge", "between", "in_set",
           "not_in_set", "match", "lt_vec", "eq_vec", "le_vec"]


def _bc(c, x_limb):
    # broadcast a scalar limb against column limb shape
    return c.astype(jnp.uint32)


def eq(x, c):
    m = x[0] == c[0]
    for l in range(1, x.shape[0]):
        m = m & (x[l] == c[l])
    return m


def ne(x, c):
    return ~eq(x, c)


def lt(x, c):
    """Lexicographic unsigned x < c over limbs (limb 0 most significant)."""
    L = x.shape[0]
    m = x[0] < c[0]
    if L == 1:
        return m
    eq_so_far = x[0] == c[0]
    for l in range(1, L):
        m = m | (eq_so_far & (x[l] < c[l]))
        if l < L - 1:
            eq_so_far = eq_so_far & (x[l] == c[l])
    return m


def le(x, c):
    L = x.shape[0]
    m = x[0] < c[0]
    eq_so_far = x[0] == c[0]
    for l in range(1, L):
        m = m | (eq_so_far & (x[l] < c[l]))
        eq_so_far = eq_so_far & (x[l] == c[l])
    return m | eq_so_far if L > 1 else (x[0] <= c[0])


def gt(x, c):
    return ~le(x, c)


def ge(x, c):
    return ~lt(x, c)


def between(x, lo, hi):
    """lo <= x <= hi (reference FilterModeRange semantics)."""
    return ge(x, lo) & le(x, hi)


def in_set(x, cs):
    """x in {cs[:, k]}. cs: uint32[L, K] with static K.

    For large K prefer hash/bitmap pushdown (exec/ridset.py); this is the
    direct small-set kernel (reference cmp IN uses slice contains)."""
    K = cs.shape[1]
    m = eq(x, cs[:, 0])
    for k in range(1, K):
        m = m | eq(x, cs[:, k])
    return m


def not_in_set(x, cs):
    return ~in_set(x, cs)


# --- column-vs-column comparisons (join keys, sort) ---

def eq_vec(x, y):
    m = x[0] == y[0]
    for l in range(1, x.shape[0]):
        m = m & (x[l] == y[l])
    return m


def lt_vec(x, y):
    L = x.shape[0]
    m = x[0] < y[0]
    if L == 1:
        return m
    eq_so_far = x[0] == y[0]
    for l in range(1, L):
        m = m | (eq_so_far & (x[l] < y[l]))
        if l < L - 1:
            eq_so_far = eq_so_far & (x[l] == y[l])
    return m


def le_vec(x, y):
    return ~lt_vec(y, x)


def match(mode: FilterMode, x, lo=None, hi=None, in_limbs=None):
    """Dispatch by filter mode (static python value -> traced kernel)."""
    if mode == FilterMode.EQ:
        return eq(x, lo)
    if mode == FilterMode.NE:
        return ne(x, lo)
    if mode == FilterMode.GT:
        return gt(x, lo)
    if mode == FilterMode.GE:
        return ge(x, lo)
    if mode == FilterMode.LT:
        return lt(x, lo)
    if mode == FilterMode.LE:
        return le(x, lo)
    if mode == FilterMode.RANGE:
        return between(x, lo, hi)
    if mode == FilterMode.IN:
        return in_set(x, in_limbs)
    if mode == FilterMode.NOT_IN:
        return not_in_set(x, in_limbs)
    if mode == FilterMode.TRUE:
        return jnp.ones(x.shape[1:], dtype=bool)
    if mode == FilterMode.FALSE:
        return jnp.zeros(x.shape[1:], dtype=bool)
    raise ValueError(f"unsupported filter mode {mode!r}")
