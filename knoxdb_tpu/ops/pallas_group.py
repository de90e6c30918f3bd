"""Pallas kernel (Triton route): factored one-hot group-by partials.

The XLA factored path (exec/groupby._group_mxu_factored) writes its
one-hot operands to device memory around every dot — the optimized HLO
on the H100 materializes the [T, L*NC] chunk matrix — which keeps it at
a few per cent of the card's memory rate. This kernel builds both
one-hots in registers, so device memory sees only the 12 B/row of
(gid, value) inputs and the per-program partials.

Decomposition (same as the XLA kernel): gid = hi*L + lo over a fixed
H=128 hi axis and L = 2^ceil(log2(G/128)) lo bins; output column
j = l*NCP + c holds byte chunk c (c < C) or the count (c == C) of the
rows with lo == l, NCP = C+1 padded to a power of two. Each program
owns a contiguous row split and one block of COLS output columns, and
walks its rows ROWS_T at a time:

    acc[h, j] += sum_t hi_onehot[h, t] * m2[t, j]      (bf16 in, f32 acc)

Exactness: an f32 partial covers at most `flush` <= 65,536 rows, so each
entry stays below 255 * 65,536 < 2^24 (exact in f32); it is then added
into an int32 accumulator, exact because a split holds at most 2^23 rows
(255 * 2^23 < 2^31). Cross-split sums are u64 adds outside the kernel,
and the byte recombination is on the host (groupby.mxu_chunk_sums).
No float32 matmul exists on the path: the dot's operands are bf16 one-hots
and bf16 bytes, both exact.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["H_BINS", "geometry", "group_partials"]

H_BINS = 128            # hi-axis bins (the dot's M)
ROWS_T = 128            # rows per dot step (the dot's K)
MAX_FLUSH = 1 << 16     # rows per exact f32 partial (255 * 2^16 < 2^24)
MAX_SPLIT = 1 << 23     # rows per int32 accumulator (255 * 2^23 < 2^31)
MAX_COLS = 64           # output columns per program (the dot's N)
TARGET_PROGRAMS = 528   # 4 waves over the H100's 132 SMs
_NUM_WARPS = 4
_Z = np.int32(0)        # index-map zero: a python 0 traces as i64 (x64)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def geometry(G: int, n_chunks: int) -> tuple[int, int]:
    """(L, NCP): lo bins and the padded chunk-column count."""
    L = _pow2(-(-max(G, 1) // H_BINS))
    return L, max(2, _pow2(n_chunks + 1))


def _split_plan(n: int, n_blocks: int) -> tuple[int, int, int]:
    """(flush, rows per split, splits): enough programs to fill the card,
    splits a multiple of flush rows, at most MAX_SPLIT rows each."""
    flush = min(MAX_FLUSH, max(ROWS_T, _pow2(n)))
    n_flush = -(-n // flush)
    want = -(-TARGET_PROGRAMS // n_blocks)
    per = max(1, min(MAX_SPLIT // flush, -(-n_flush // want)))
    return flush, per * flush, -(-n_flush // per)


def _kernel(gid_ref, lo_ref, hi_ref, out_ref, *, shift: int, L: int,
            ncp: int, C: int, cols: int, flush: int, split: int):
    r = pl.program_id(0)
    cb = pl.program_id(1)
    # output column block: column j -> (lo bin, chunk) = (j / ncp, j % ncp)
    j = cb * cols + jax.lax.broadcasted_iota(jnp.int32, (cols,), 0)
    col_l = j // ncp
    col_c = j % ncp
    use_hi = (col_c >= 4)[None, :]
    sh = (8 * (col_c % 4)).astype(jnp.uint32)[None, :]
    is_chunk = (col_c < C)[None, :]
    is_cnt = (col_c == C)[None, :]
    iota_h = jax.lax.broadcasted_iota(jnp.int32, (H_BINS, ROWS_T), 0)

    def step(i, acc, base):
        rows = pl.ds(base + i * ROWS_T, ROWS_T)
        g = gid_ref[rows]
        lo = lo_ref[rows]
        hi = hi_ref[rows]
        hot = (iota_h == (g >> shift)[None, :]).astype(jnp.bfloat16)
        word = jnp.where(use_hi, hi[:, None], lo[:, None])
        byte = ((word >> sh) & np.uint32(0xFF)).astype(jnp.int32)
        val = jnp.where(is_chunk, byte, is_cnt.astype(jnp.int32))
        val = jnp.where((g & (L - 1))[:, None] == col_l[None, :], val, 0)
        m2 = val.astype(jnp.float32).astype(jnp.bfloat16)
        return acc + pl.dot(hot, m2)

    def flush_body(k, acc_i):
        base = r * split + k * flush
        acc_f = jax.lax.fori_loop(
            0, flush // ROWS_T, partial(step, base=base),
            jnp.zeros((H_BINS, cols), jnp.float32))
        return acc_i + acc_f.astype(jnp.int32)

    out_ref[...] = jax.lax.fori_loop(0, split // flush, flush_body,
                                     jnp.zeros((H_BINS, cols), jnp.int32))


def group_partials(gid, vlo, vhi, G: int, n_chunks: int,
                   interpret: bool = False):
    """gid i32[n] with invalid rows set to >= H*L; vlo/vhi u32[n] value
    words (zero on invalid rows). Returns i32[splits, H, L*NCP] partials:
    entry (h, l*NCP + c) = chunk-c byte sum (c < n_chunks) or count
    (c == n_chunks) of the split's rows with gid == h*L + l. The caller
    sums over splits with u64 adds."""
    L, ncp = geometry(G, n_chunks)
    width = L * ncp
    cols = max(16, min(MAX_COLS, width))
    n_blocks = -(-width // cols)
    n = gid.shape[0]
    flush, split, splits = _split_plan(n, n_blocks)
    pad = splits * split - n
    if pad:
        gid = jnp.concatenate([gid, jnp.full(pad, H_BINS * L, jnp.int32)])
        z = jnp.zeros(pad, jnp.uint32)
        vlo = jnp.concatenate([vlo, z])
        vhi = jnp.concatenate([vhi, z])
    whole = pl.BlockSpec((splits * split,), lambda r, c: (_Z,))
    out = pl.pallas_call(
        partial(_kernel, shift=L.bit_length() - 1, L=L, ncp=ncp,
                C=n_chunks, cols=cols, flush=flush, split=split),
        grid=(splits, n_blocks),
        in_specs=[whole, whole, whole],
        out_specs=pl.BlockSpec((None, H_BINS, cols),
                               lambda r, c: (r, _Z, c)),
        out_shape=jax.ShapeDtypeStruct((splits, H_BINS, n_blocks * cols),
                                       jnp.int32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=2),
        interpret=interpret,
        name="knox_group_onehot",
    )(gid, vlo, vhi)
    return out[:, :, :width]
