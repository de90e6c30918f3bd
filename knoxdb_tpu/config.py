"""Global configuration for the knoxdb_tpu engine.

- PACK_SIZE: rows per pack (column segment tile). The reference allows
  2^8..2^22 rows per pack (/root/reference/README.md:60); we fix 2^16, a
  storage choice: one pack row of a bitplane is 2,048 u32 words (8 KB),
  a u64 column pack is 512 KiB, and zone maps stay fine-grained enough
  to prune.
- All device compute uses uint32 limbs (order-preserving "key form", see
  utils/limbs.py); jax x64 is enabled only for host<->device conversion and
  aggregation outputs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# Enable 64-bit types globally: host conversion paths and aggregation
# accumulators need u64/i64. Hot kernels still operate on uint32 limbs.
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache lives at a fixed path in the checkout (the path
# is part of the cache key, so it must not move between runs).
CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def compile_cache_dir(env=os.environ) -> str | None:
    """Directory this package sets as JAX's compile cache: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX honours it unaided), else the
    checkout's fixed .jax_cache."""
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CACHE_DIR)


if compile_cache_dir() is not None:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

# Rows per pack. Must be a multiple of 32 (bitset word) * 128.
PACK_SIZE = int(os.environ.get("KNOX_TPU_PACK_SIZE", 1 << 16))
assert PACK_SIZE % 4096 == 0, "PACK_SIZE must be a multiple of 4096"

# Words per pack for packed u32 bitsets.
PACK_WORDS = PACK_SIZE // 32

# Journal size (rows) before a background merge is scheduled.
JOURNAL_SIZE = int(os.environ.get("KNOX_TPU_JOURNAL_SIZE", 1 << 17))

# Statistics: max string prefix bytes kept in zone maps (reference:
# internal/pack/stats/index.go:177 STATS_STRING_MAX_LEN = 8).
STATS_STRING_MAX_LEN = 8


def kernel_family(platform: str | None = None) -> str:
    """The one place that decides which kernels run: "triton" (the
    hand-written Pallas kernel — the one-hot group-by, ops/pallas_group
    — compiled for the GPU through Triton) or "xla" (plain JAX
    everywhere). gpu -> "triton", anything else -> "xla". A scanner
    takes this as its default (exec/scan.SegmentScanner.kernels) and
    is the one place to override it. Interpret mode is never chosen
    here: only a test asks for it, explicitly."""
    if platform is None:
        platform = jax.devices()[0].platform
    return "triton" if platform == "gpu" else "xla"
