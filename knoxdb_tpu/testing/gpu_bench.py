"""Kernel checks and timings on the card (chip_smoke.py phase 4).

Compares the hand-written group-by kernel with the plain XLA version of
the same operator at a deployment width (2^26 rows), reads the optimized
HLO of the XLA group-by to see whether its one-hot operands are written
to device memory, and times the XLA scan sweep at 1,024 packs. Only
meaningful on a GPU; the helpers that build inputs and references are
shared with tests/test_gpu_kernels.py.
"""

from __future__ import annotations

import re
import statistics
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

P_PACKS = 1024
W_WORDS = 2048                       # u32 words per pack row (2^16 rows)


def random_planes(seed: int, width: int, P: int = P_PACKS,
                  W: int = W_WORDS):
    """Random bitplanes u32[w, P, W] (every bit pattern is a valid packed
    value) and per-pack min keys below 2^w, so pack domains overlap and
    min + 2^w - 1 stays inside u64 (all zero at w = 64)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    planes = jax.random.bits(k1, (width, P, W), jnp.uint32)
    top = 1 << min(width, 62) if width < 64 else 1
    mins = jax.random.randint(k2, (P,), 0, top, jnp.int64) \
        .astype(jnp.uint64)
    return planes, mins


def query_range(width: int) -> tuple[int, int]:
    """A range that cuts through most packs' domains."""
    lo = (1 << width) // 3
    return lo, lo + (1 << width) // 2


def xla_scan(planes, mins, valid, lo, hi, width: int):
    """The XLA scan sweep: range compare, then the masked per-plane
    counts and the min/max tournaments over the planes."""
    from ..ops import bitslice as B
    mask = B.range_planes(planes, mins, lo, hi, width) & valid
    cnt = jax.lax.population_count(mask).astype(jnp.int32).sum(axis=-1)
    pcnt = jnp.stack([jax.lax.population_count(planes[p] & mask)
                      .astype(jnp.int32).sum(axis=-1)
                      for p in range(width)], axis=1)
    mn = B._tournament_planes(planes, mask, width, want_max=False)
    mx = B._tournament_planes(planes, mask, width, want_max=True)
    return mask, pcnt, cnt, mn, mx


def group_inputs(seed: int, G: int, P: int = P_PACKS, N: int = 1 << 16,
                 hi_bits: int = 9):
    """Random gids in [0, G), all rows valid, value halves (lo, hi) with
    hi < 2^hi_bits (41-bit values at the default)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    gids = jax.random.randint(k1, (P, N), 0, G, jnp.int32)
    lo = jax.random.bits(k2, (P, N), jnp.uint32)
    hi = jax.random.bits(k3, (P, N), jnp.uint32) >> (32 - hi_bits)
    mask = jnp.full((P, N // 32), 0xFFFFFFFF, jnp.uint32)
    return gids, mask, lo, hi


def group_oracle(gids, lo, hi, G: int):
    """Exact per-group counts and sums as Python ints (16-bit chunks
    through f64 bincounts, each below 2^53)."""
    g = np.asarray(gids).reshape(-1).astype(np.int64)
    v = (np.asarray(hi).reshape(-1).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).reshape(-1).astype(np.uint64)
    cnt = np.bincount(g, minlength=G)
    s = np.zeros(G, object)
    for c in range(4):
        w = ((v >> np.uint64(16 * c)) & np.uint64(0xFFFF)).astype(np.float64)
        s = s + np.rint(np.bincount(g, weights=w, minlength=G)) \
            .astype(np.int64).astype(object) * (1 << 16 * c)
    return cnt, s


def group_xla(gids, mask, lo, hi, G: int, n_chunks: int = 6):
    """The XLA one-hot group-by (flat below 192 groups, else factored)."""
    from ..exec import groupby as GB
    f = GB._group_mxu_factored if G >= GB._MXU_FACTORED_MIN_G \
        else GB._group_mxu_flat
    return f(gids, mask, (lo, hi), G, n_chunks, jnp.uint64(0))


def group_kernel(gids, mask, lo, hi, G: int, n_chunks: int = 6):
    """The Triton one-hot group-by kernel on the same inputs."""
    from ..exec import groupby as GB
    return GB._group_triton(gids, mask, (lo, hi), G, n_chunks,
                            jnp.uint64(0))


def onehot_buffers(hlo: str, min_elems: int) -> list[str]:
    """Instructions OUTSIDE fused computations that produce a bf16 array
    of at least min_elems elements: a one-hot operand written to device
    memory. Fused computations are those named by a `calls=`."""
    fused = set(re.findall(r"calls=%?([\w.\-]+)", hlo))
    out = []
    comp = None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if m:
            comp = m.group(1)
            continue
        if comp in fused:
            continue
        for dims in re.findall(r"= bf16\[([\d,]+)\]", line):
            if int(np.prod([int(d) for d in dims.split(",")])) >= min_elems:
                out.append(line.strip()[:200])
    return out


def _median_s(fn, *args, reps: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def stream_gbps() -> float:
    """Same-run device memory rate: a 1 GiB u32 read + write."""
    x = jnp.zeros(1 << 28, jnp.uint32)
    f = jax.jit(lambda a: a + jnp.uint32(1))
    return 2 * x.nbytes / _median_s(f, x) / 1e9


def kernel_timings(card: str, out_dir: Path):
    """Yield one printable line per measurement."""
    bw = stream_gbps()
    yield f"stream copy: {bw:.1f} GB/s [{card}]"
    valid = jnp.full((P_PACKS, W_WORDS), 0xFFFFFFFF, jnp.uint32)
    for width in (20, 41):
        planes, mins = random_planes(7, width)
        lo, hi = query_range(width)
        args = (planes, mins, valid, jnp.uint64(lo), jnp.uint64(hi))
        fx = jax.jit(xla_scan, static_argnums=5)
        tx = _median_s(fx, *args, width)
        nbytes = planes.nbytes + 2 * valid.nbytes
        yield (f"scan xla sweep w={width} P={P_PACKS}: {tx * 1e3:.4f} ms "
               f"({nbytes / tx / 1e9:.1f} GB/s of one plane pass) [{card}]")
        del planes
    for G in (20, 1000, 8192, 65536):
        gids, mask, lo, hi = group_inputs(11, G)
        fx = jax.jit(group_xla, static_argnums=4)
        fk = jax.jit(group_kernel, static_argnums=4)
        if G >= 1000:
            hlo = fx.lower(gids, mask, lo, hi, G).compile().as_text()
            (out_dir / f"hlo_group_G{G}.txt").write_text(hlo)
            bufs = len(onehot_buffers(hlo, 1 << 16))
        else:
            bufs = "n/a"
        tk = _median_s(fk, gids, mask, lo, hi, G, reps=5)
        tx = _median_s(fx, gids, mask, lo, hi, G, reps=5)
        rows = gids.size
        yield (f"group G={G} rows={rows}: triton {tk * 1e3:.3f} ms "
               f"({rows / tk / 1e9:.3f} G rows/s, "
               f"{12 * rows / tk / 1e9:.1f} GB/s of 12 B/row), xla "
               f"{tx * 1e3:.3f} ms ({rows / tx / 1e9:.3f} G rows/s); xla "
               f"one-hot buffers outside fusions: {bufs} [{card}]")
        del gids, mask, lo, hi
