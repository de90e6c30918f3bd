"""Multi-chip scan: pack-parallel execution over a jax.sharding.Mesh.

The reference is single-process by design (/root/reference/README.md:57);
this layer is the genuinely new part (SURVEY.md §2.4): table segments
are hash/range-partitioned by pack across devices, the fused
filter+aggregate kernel runs on each device's local packs (embarrassingly
parallel — the scan has no cross-pack dependencies), and only the tiny
per-query partials cross the device interconnect via psum.

Layout contract: per-pack arrays shard on their PACK axis — planes are
PLANE-MAJOR u32[w, P, W] since r4 (pack axis = dim 1), min_keys u64[P]
and valid u32[P, W] on dim 0; P must be a multiple of the mesh axis
size (the segment builder pads with empty packs). Aggregation partials are exact (split-limb sums, see
exec/device.group_masked_sum).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import bitslice as B
from ..types import FilterMode

__all__ = ["make_mesh", "shard_packs", "sharded_range_scan",
           "sharded_scan_fn"]


def make_mesh(n_devices: int | None = None, axis: str = "packs") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_packs(mesh: Mesh, tree, axis: str = "packs"):
    """Place every array of a pytree sharded on its pack axis: 3-d
    arrays are plane-major planes [w, P, W] (pack axis 1, r4); 1-/2-d
    arrays lead with the pack axis."""
    def put(x):
        if x.ndim == 3:
            spec = P(None, axis, None)
        else:
            spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def sharded_scan_fn(mesh: Mesh, width: int, axis: str = "packs"):
    """Build the jitted multi-chip scan step: bitsliced RANGE filter +
    count/sum over pack-sharded planes. Returns fn(planes, min_keys,
    valid, lo, hi) -> (count i64, sum_lo u64, sum_hi u64) replicated."""
    shard_map = jax.shard_map

    pspec = P(None, axis, None)
    vspec = P(axis, None)
    kspec = P(axis)

    def local(planes, min_keys, valid, lo, hi):
        m = B.range_planes(planes, min_keys, lo, hi, width) & valid
        s_lo, s_hi, cnt = _split_sum(planes, min_keys, m, width)
        cnt = jax.lax.psum(cnt.sum(), axis)
        s_lo = jax.lax.psum(s_lo.sum(), axis)
        s_hi = jax.lax.psum(s_hi.sum(), axis)
        return cnt, s_lo, s_hi

    fn = shard_map(local, mesh=mesh,
                   in_specs=(pspec, kspec, vspec, P(), P()),
                   out_specs=(P(), P(), P()))
    return jax.jit(fn)


def _split_sum(planes, min_keys, mask_words, width: int):
    cnt = B.popcount_words(mask_words).astype(jnp.uint64)
    lo = jnp.zeros(planes.shape[1], jnp.uint64)
    hi = jnp.zeros(planes.shape[1], jnp.uint64)
    for p in range(width):
        c = B.popcount_words(planes[p] & mask_words).astype(jnp.uint64)
        if p < 32:
            lo = lo + (c << jnp.uint64(p))
        else:
            hi = hi + (c << jnp.uint64(p - 32))
    lo = lo + (min_keys & jnp.uint64(0xFFFFFFFF)) * cnt
    hi = hi + (min_keys >> jnp.uint64(32)) * cnt
    return lo, hi, cnt.astype(jnp.int64)


def sharded_range_scan(mesh: Mesh, planes, min_keys, valid, lo: int, hi: int,
                       width: int, axis: str = "packs"):
    """One-call helper: shard inputs, run the multi-chip scan, return
    (count, exact_sum) as python ints."""
    fn = sharded_scan_fn(mesh, width, axis)
    planes, min_keys, valid = shard_packs(mesh, (planes, min_keys, valid), axis)
    cnt, s_lo, s_hi = fn(planes, min_keys, valid,
                         jnp.uint64(lo), jnp.uint64(hi))
    return int(cnt), int(s_lo) + (int(s_hi) << 32)
