"""Predicate kernels vs numpy oracle, across types and filter modes.

Mirrors the reference's kernel-vs-generic-oracle test strategy
(/root/reference/internal/cmp/avx2/kernel_test.go pattern): the device kernel
must produce bit-identical masks to a trivial numpy implementation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from knoxdb_tpu.types import FieldType, FilterMode
from knoxdb_tpu.ops import cmp as C
from knoxdb_tpu.ops import bitset as B
from knoxdb_tpu.utils import limbs as lb

TYPES = [FieldType.UINT32, FieldType.UINT64, FieldType.INT64,
         FieldType.INT16, FieldType.FLOAT64, FieldType.FLOAT32,
         FieldType.INT128]

MODES = [FilterMode.EQ, FilterMode.NE, FilterMode.GT, FilterMode.GE,
         FilterMode.LT, FilterMode.LE, FilterMode.RANGE, FilterMode.IN,
         FilterMode.NOT_IN]


def gen(ft, rng, n):
    if ft is FieldType.INT128:
        # cluster values so EQ/IN hit
        pool = [int(x) for x in rng.integers(-1000, 1000, 50)] + \
               [int(rng.integers(-(2**62), 2**62)) << int(rng.integers(0, 60))
                for _ in range(20)]
        return np.array([pool[i] for i in rng.integers(0, len(pool), n)], dtype=object)
    dt = lb.numpy_dtype(ft)
    if ft.is_float:
        return rng.integers(-100, 100, n).astype(dt)  # exact float values
    info = np.iinfo(dt)
    lo, hi = max(info.min, -1000), min(int(info.max), 1000)
    vals = rng.integers(lo, hi, size=n).astype(dt)
    return vals


def oracle(mode, vals, lo, hi=None, inset=None):
    if mode == FilterMode.EQ:
        return vals == lo
    if mode == FilterMode.NE:
        return vals != lo
    if mode == FilterMode.GT:
        return vals > lo
    if mode == FilterMode.GE:
        return vals >= lo
    if mode == FilterMode.LT:
        return vals < lo
    if mode == FilterMode.LE:
        return vals <= lo
    if mode == FilterMode.RANGE:
        return (vals >= lo) & (vals <= hi)
    if mode == FilterMode.IN:
        return np.isin(vals, inset) if vals.dtype != object else \
            np.array([v in set(inset) for v in vals])
    if mode == FilterMode.NOT_IN:
        return ~oracle(FilterMode.IN, vals, lo, hi, inset)
    raise AssertionError(mode)


@pytest.mark.parametrize("ft", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_match_vs_oracle(ft, mode, rng):
    n = 2048
    vals = gen(ft, rng, n)
    lo_v, hi_v = sorted([vals[7], vals[1033]], key=lambda v: (v if ft is not FieldType.INT128 else int(v)))
    inset = list({vals[3], vals[99], vals[500], vals[1500]})

    x = jnp.asarray(lb.to_keyform(vals, ft))
    lo = jnp.asarray(np.array(lb.scalar_to_keyform(lo_v, ft), dtype=np.uint32))
    hi = jnp.asarray(np.array(lb.scalar_to_keyform(hi_v, ft), dtype=np.uint32))
    ins = jnp.asarray(np.stack(
        [np.array(lb.scalar_to_keyform(v, ft), dtype=np.uint32) for v in inset], axis=1))

    got = np.asarray(C.match(mode, x, lo, hi, ins))
    want = oracle(mode, vals, lo_v, hi_v, inset)
    np.testing.assert_array_equal(got, want, err_msg=f"{ft.name} {mode.name}")


def test_vec_compare(rng):
    a = rng.integers(0, 50, 4096).astype(np.uint64)
    b = rng.integers(0, 50, 4096).astype(np.uint64)
    xa = jnp.asarray(lb.to_keyform(a, FieldType.UINT64))
    xb = jnp.asarray(lb.to_keyform(b, FieldType.UINT64))
    np.testing.assert_array_equal(np.asarray(C.eq_vec(xa, xb)), a == b)
    np.testing.assert_array_equal(np.asarray(C.lt_vec(xa, xb)), a < b)
    np.testing.assert_array_equal(np.asarray(C.le_vec(xa, xb)), a <= b)


def test_bitset_roundtrip_and_ops(rng):
    n = 8192
    m1 = rng.integers(0, 2, n).astype(bool)
    m2 = rng.integers(0, 2, n).astype(bool)
    w1, w2 = B.pack_mask(jnp.asarray(m1)), B.pack_mask(jnp.asarray(m2))
    assert w1.shape == (n // 32,)
    np.testing.assert_array_equal(np.asarray(B.unpack_mask(w1)), m1)
    np.testing.assert_array_equal(np.asarray(B.unpack_mask(B.bs_and(w1, w2))), m1 & m2)
    np.testing.assert_array_equal(np.asarray(B.unpack_mask(B.bs_or(w1, w2))), m1 | m2)
    np.testing.assert_array_equal(np.asarray(B.unpack_mask(B.bs_and_not(w1, w2))), m1 & ~m2)
    assert int(B.popcount(w1)) == int(m1.sum())
    # numpy versions agree with device versions
    np.testing.assert_array_equal(B.np_pack_mask(m1), np.asarray(w1))
    np.testing.assert_array_equal(B.np_unpack_mask(np.asarray(w1), n), m1)
    np.testing.assert_array_equal(B.np_indexes(m1), np.flatnonzero(m1))
