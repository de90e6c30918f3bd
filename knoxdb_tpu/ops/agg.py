"""Masked aggregation kernels over keyform limbs.

Integer sums are computed as per-limb masked u64 partial sums on device and
combined into arbitrary-width exact integers on the host (a 64K-row pack sums
2^16 u32 limbs -> fits in 48 bits per limb, so u64 accumulators never
overflow). Signed values are recovered from the keyform bias:
    sum(x) = sum(keyform(x)) - count * 2^(bits-1)   (mod 2^bits)

Min/max are lexicographic limb tournaments. Float sums decode keyform ->
float on device and use a fixed log-depth pairwise reduction order, so
results are deterministic for a given pack geometry (documented deviation
from the reference's sequential Go accumulation order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..types import FieldType
from ..utils import limbs as lb

__all__ = ["masked_count", "masked_limb_sums", "combine_limb_sums",
           "masked_min", "masked_max", "first_index", "last_index",
           "masked_sum_float", "pairwise_sum"]


def masked_count(mask):
    return mask.sum(dtype=jnp.int64)


def masked_limb_sums(x, mask):
    """x: u32[L, *s], mask: bool[*s] -> u64[L] per-limb masked sums."""
    m = mask.astype(jnp.uint64)
    red = tuple(range(1, x.ndim))
    return (x.astype(jnp.uint64) * m).sum(axis=red, dtype=jnp.uint64)


def combine_limb_sums(limb_sums: np.ndarray, count: int, ft: FieldType):
    """Host: exact integer sum from per-limb u64 sums (+ bias correction)."""
    total = 0
    for l in range(ft.nlimbs):
        total = (total << 32) + int(limb_sums[l])
    if ft.is_signed and not ft.is_float:
        total -= int(count) << (ft.bits - 1)
    # KnoxDB sums wrap at the type width for fixed ints; keep python-int
    # exactness for wide/decimal types and let callers wrap if desired.
    return total


def _tournament(x, mask, want_min: bool):
    """Lexicographic masked min/max over the last axis.

    x: u32[L, N] (N power of two), mask: bool[N] -> u32[L] winner limbs.
    Log-depth halving keeps everything elementwise and fusable."""
    from . import cmp as C

    L, n = x.shape
    fill = jnp.uint32(0xFFFFFFFF) if want_min else jnp.uint32(0)
    x = jnp.where(mask[None, :], x, fill)
    while n > 1:
        n //= 2
        a, b = x[:, :n], x[:, n:]
        take_b = C.lt_vec(b, a) if want_min else C.lt_vec(a, b)
        x = jnp.where(take_b[None, :], b, a)
    return x[:, 0]


def masked_min(x, mask):
    """Returns u32[L]; all-ones when mask is empty (caller checks count)."""
    flat = x.reshape(x.shape[0], -1)
    return _tournament(flat, mask.reshape(-1), want_min=True)


def masked_max(x, mask):
    flat = x.reshape(x.shape[0], -1)
    return _tournament(flat, mask.reshape(-1), want_min=False)


def first_index(mask):
    """Index of first set bit (N if none)."""
    m = mask.reshape(-1)
    return jnp.where(m.any(), jnp.argmax(m), m.shape[0]).astype(jnp.int64)


def last_index(mask):
    m = mask.reshape(-1)
    n = m.shape[0]
    rev = jnp.argmax(m[::-1])
    return jnp.where(m.any(), n - 1 - rev, n).astype(jnp.int64)


def keyform_to_float(x, ft: FieldType):
    """Device decode: keyform limbs -> float values (f64 for FLOAT64).

    NOTE: where a backend emulates f64 (some accelerators use a
    two-float form with ~48-bit mantissa) the decoded f64 VALUES may
    lose low mantissa bits; compare/min/max stay bit-exact (they run on integer keyform), and
    query results are materialized from keyform on the host (exact). Only
    in-device float arithmetic (sum/avg) carries the emulated precision."""
    if ft is FieldType.FLOAT32:
        k = x[0]
        sign = (k & jnp.uint32(0x80000000)) != 0
        bits = jnp.where(sign, k ^ jnp.uint32(0x80000000), ~k)
        return jax_bitcast(bits, jnp.float32)
    assert ft is FieldType.FLOAT64
    key = (x[0].astype(jnp.uint64) << jnp.uint64(32)) | x[1].astype(jnp.uint64)
    sign = (key & jnp.uint64(1 << 63)) != 0
    bits = jnp.where(sign, key ^ jnp.uint64(1 << 63), ~key)
    return jax_bitcast(bits, jnp.float64)


def jax_bitcast(x, dtype):
    import jax
    return jax.lax.bitcast_convert_type(x, dtype)


def pairwise_sum(v):
    """Deterministic log-depth pairwise float sum over a flat vector."""
    v = v.reshape(-1)
    n = v.shape[0]
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]


def masked_sum_float(x, mask, ft: FieldType, acc_dtype=None):
    vals = keyform_to_float(x, ft)
    acc = acc_dtype or (jnp.float64 if ft is FieldType.FLOAT64 else jnp.float32)
    vals = jnp.where(mask, vals.astype(acc), jnp.zeros((), acc))
    return pairwise_sum(vals)
