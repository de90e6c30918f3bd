"""Vectorized hashing over keyform limbs.

Device-side replacement for the reference's xxh3 vector-hash kernels
(/root/reference/internal/hash/hash.go:25-34, xxh3_amd64.s): a murmur3-
style 32-bit combine/finalize over u32 limbs, chosen because 32-bit
multiplies are native on every device it targets. The
exact hash function differs from the reference (xxh3) by design — hashes
never leave the system, only their distribution matters.

Host (numpy) and device (jnp) implementations are bit-identical so filters
built at encode time on the host can be probed on device and vice versa
(tested in tests/test_hash.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["hash32", "hash32_np", "hash2", "hash2_np", "mix32"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35


def _rotl(x, r, xp):
    r_ = xp.uint32(r)
    return (x << r_) | (x >> xp.uint32(32 - r))


def _mm3_combine(h, k, xp):
    k = k * xp.uint32(_C1)
    k = _rotl(k, 15, xp)
    k = k * xp.uint32(_C2)
    h = h ^ k
    h = _rotl(h, 13, xp)
    return h * xp.uint32(5) + xp.uint32(0xE6546B64)


def _fmix(h, xp):
    h = h ^ (h >> xp.uint32(16))
    h = h * xp.uint32(_FMIX1)
    h = h ^ (h >> xp.uint32(13))
    h = h * xp.uint32(_FMIX2)
    return h ^ (h >> xp.uint32(16))


def _hash32(limbs, seed, xp):
    h = xp.uint32(seed ^ 0x9747B28C)
    for l in range(limbs.shape[0]):
        h = _mm3_combine(h, limbs[l].astype(xp.uint32), xp)
    return _fmix(h, xp)


def hash32(limbs, seed: int = 0):
    """u32[L, *s] -> u32[*s] (device)."""
    return _hash32(limbs, seed, jnp)


def hash32_np(limbs: np.ndarray, seed: int = 0) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _hash32(np.asarray(limbs, np.uint32), seed, np)


def hash2(limbs):
    """Two independent 32-bit hashes (device) for double-hashing bloom
    probes (h_i = h1 + i*h2, reference bloom uses 4 derived probes)."""
    return hash32(limbs, 0), hash32(limbs, 0x8BADF00D)


def hash2_np(limbs: np.ndarray):
    return hash32_np(limbs, 0), hash32_np(limbs, 0x8BADF00D)


def mix32(x, xp=jnp):
    """Single-word finalizer (fast partition/bucket hash for u32 codes)."""
    return _fmix(x.astype(xp.uint32), xp)
