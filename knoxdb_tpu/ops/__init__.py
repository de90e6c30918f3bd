"""Device kernel layer: compare, bitset, bit-sliced fused scan, hashing,
compaction, aggregation (SURVEY.md L1 analog, device-first)."""

from . import agg, bitset, bitslice, cmp, compact, hash  # noqa: F401
