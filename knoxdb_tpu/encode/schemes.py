"""Compression containers: host encode (numpy) + device decode (jnp).

Scheme set mirrors the reference container families
(/root/reference/internal/encode/container.go:20-55) re-designed for the accelerator:

- CONST    one value per pack
- RAW      keyform limbs as-is
- BITPACK  (v - min) stored as w bitplanes of N/32 u32 words each —
           arbitrary width 1..64, decode is w fused shift/or passes,
           memory traffic = exactly N*w/8 bytes (vs the reference's horizontal
           64-bit-word packing, internal/encode/bitpack)
- DELTA    zigzag(first differences) bitplane-packed; decode = cumsum
- RLE      run values + exclusive run ends; decode/matcher via searchsorted
           (filters evaluate on the RUN VALUES then expand — the
           matcher-on-compressed-data "fusion kernel" idea,
           reference internal/encode/container.go:72-76)
- DICT     codes bitplane-packed + sorted unique values; filters evaluate
           on the dictionary then gather bool by code

All decode functions are batched over a leading pack axis so a scheme-group
of packs decodes in ONE kernel launch, and are pure jnp so XLA fuses
decode -> compare -> aggregate into a single device-memory pass.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


class Scheme(enum.IntEnum):
    CONST = 0
    RAW = 1
    BITPACK = 2
    DELTA = 3
    RLE = 4
    DICT = 5
    ALP = 6      # floats as decimal-scaled ints (encode/alp.py); device
    #              kernels identical to BITPACK in the enc-min domain


@dataclass
class EncodedPack:
    """Host-side encoded form of one column pack (key domain)."""
    scheme: Scheme
    n: int                      # valid rows
    nlimbs: int                 # limbs of the logical type
    width: int = 0              # packed bit width (BITPACK/DELTA/DICT codes)
    min_key: int = 0            # subtracted base (BITPACK), base value (DELTA)
    planes: np.ndarray | None = None    # u32[width, N//32] bitplanes
    values: np.ndarray | None = None    # u32[L, k] CONST/RAW/RLE/DICT values
    ends: np.ndarray | None = None      # u32[k] RLE exclusive run ends
    k: int = 0                  # padded #values (RLE/DICT)
    card: int = 0               # true #values before padding (RLE/DICT)
    exp: int = 0                # ALP decimal exponent (v = enc / 10^exp)
    dict_keys: np.ndarray | None = None  # u64[card] sorted dict keys (host,
                                         # for code-space predicate rewrite)
    dict_bytes: list | None = None       # bytes dict for STRING/BYTES packs
                                         # (host-only; device sees codes)

    @property
    def nbytes(self) -> int:
        total = 0
        for a in (self.planes, self.values, self.ends):
            if a is not None:
                total += a.nbytes
        return total + 32


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pack_bitplanes(vals: np.ndarray, width: int, n_pad: int) -> np.ndarray:
    """vals: u64[N] (< 2^width) -> u32[width, n_pad//32] bitplanes.

    Dispatches to the native C++ transpose when available (the reference
    does this hot loop in AVX2 asm; see native/knox_native.cc)."""
    from ..utils import native as NT
    if NT.available():
        return NT.bitplane_pack(np.asarray(vals, np.uint64), width, n_pad)
    return _pack_bitplanes_np(vals, width, n_pad)


def _pack_bitplanes_np(vals: np.ndarray, width: int, n_pad: int) -> np.ndarray:
    n = len(vals)
    out = np.zeros((max(width, 1), n_pad // 32), dtype=np.uint32)
    if width == 0:
        return out
    bits = np.zeros(n_pad, dtype=bool)
    for p in range(width):
        bits[:n] = (vals >> np.uint64(p)) & np.uint64(1)
        out[p] = np.packbits(bits.reshape(-1, 8), axis=-1,
                             bitorder="little").reshape(-1, 4).view(np.uint32).reshape(-1)
    return out


def _key_to_limbs(keys: np.ndarray, nlimbs: int) -> np.ndarray:
    """u64 keys -> u32[L, N] (L in {1, 2})."""
    if nlimbs == 1:
        return keys.astype(np.uint32)[None, :]
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo])


def _zigzag(d: np.ndarray) -> np.ndarray:
    di = d.view(np.int64)
    return ((di << 1) ^ (di >> 63)).view(np.uint64)


# ---------------------------------------------------------------- encode ---

def encode_const(value_limbs: np.ndarray, n: int) -> EncodedPack:
    return EncodedPack(Scheme.CONST, n, value_limbs.shape[0],
                       values=np.asarray(value_limbs, np.uint32).reshape(-1, 1))


def encode_raw(limbs: np.ndarray, n: int, n_pad: int) -> EncodedPack:
    L = limbs.shape[0]
    out = np.zeros((L, n_pad), dtype=np.uint32)
    out[:, :n] = limbs
    return EncodedPack(Scheme.RAW, n, L, values=out)


def encode_bitpack(keys: np.ndarray, nlimbs: int, min_key: int, width: int,
                   n_pad: int) -> EncodedPack:
    shifted = keys - np.uint64(min_key)
    planes = _pack_bitplanes(shifted, width, n_pad)
    return EncodedPack(Scheme.BITPACK, len(keys), nlimbs, width=width,
                       min_key=min_key, planes=planes)


def encode_delta(keys: np.ndarray, nlimbs: int, width: int, n_pad: int) -> EncodedPack:
    d = np.empty(len(keys), dtype=np.uint64)
    d[0] = 0
    d[1:] = keys[1:] - keys[:-1]
    zz = _zigzag(d)
    planes = _pack_bitplanes(zz, width, n_pad)
    return EncodedPack(Scheme.DELTA, len(keys), nlimbs, width=width,
                       min_key=int(keys[0]), planes=planes)


def encode_rle(run_values_limbs: np.ndarray, run_ends: np.ndarray, n: int,
               nlimbs: int) -> EncodedPack:
    r = run_ends.shape[0]
    k = _ceil_pow2(max(r, 1))
    vals = np.zeros((nlimbs, k), dtype=np.uint32)
    vals[:, :r] = run_values_limbs
    ends = np.full(k, 0xFFFFFFFF, dtype=np.uint32)
    ends[:r] = run_ends
    return EncodedPack(Scheme.RLE, n, nlimbs, values=vals, ends=ends, k=k,
                       card=r)


def encode_string_dict(values: list, n_pad: int,
                       width_round=None) -> EncodedPack:
    """STRING/BYTES pack: sorted byte dictionary (host) + bitplane-packed
    codes (device). The device analog of the reference string containers
    (internal/encode/container.go string family): every predicate —
    EQ/LT/RANGE/IN and even REGEXP — rewrites exactly into code space
    because the dictionary is byte-sorted and host-resident."""
    vals = [v.encode() if isinstance(v, str) else bytes(v) for v in values]
    uniq = sorted(set(vals))
    index = {b: i for i, b in enumerate(uniq)}
    codes = np.array([index[b] for b in vals], np.uint64)
    card = len(uniq)
    width = max(1, (card - 1).bit_length())
    if width_round:
        width = width_round(width)
    planes = _pack_bitplanes(codes, width, n_pad)
    # prefix keys (8-byte big-endian) for zone maps / ordering hints
    pref = np.array([_prefix_key(b) for b in uniq], np.uint64)
    return EncodedPack(Scheme.DICT, len(vals), 2, width=width, planes=planes,
                       values=np.zeros((2, 1), np.uint32), k=_ceil_pow2(card),
                       card=card, dict_keys=pref, dict_bytes=uniq)


def encode_alp(vals: np.ndarray, n_pad: int, width_round=None
               ) -> EncodedPack | None:
    """FLOAT64 pack -> ALP ints bitplane-packed, or None (fallback)."""
    from . import alp as A
    got = A.try_alp(np.asarray(vals, np.float64))
    if got is None:
        return None
    enc, e = got
    mn = int(enc.min()) if len(enc) else 0
    rel64 = (enc - mn).astype(np.uint64)   # 0 <= rel < 2^52, no overflow
    width = int(rel64.max()).bit_length() if len(rel64) else 0
    if width_round:
        width = width_round(width)
    planes = _pack_bitplanes(rel64, width, n_pad)
    return EncodedPack(Scheme.ALP, len(vals), 2, width=width, min_key=mn,
                       planes=planes, exp=e)


def _prefix_key(b: bytes) -> int:
    """First 8 bytes big-endian (reference stats cap strings at 8 bytes,
    internal/pack/stats/index.go:177)."""
    p = b[:8].ljust(8, b"\x00")
    return int.from_bytes(p, "big")


def encode_dict(codes: np.ndarray, unique_limbs: np.ndarray, n: int,
                nlimbs: int, n_pad: int, width: int = 0,
                dict_keys: np.ndarray | None = None) -> EncodedPack:
    card = unique_limbs.shape[1]
    width = width or max(1, (card - 1).bit_length())
    planes = _pack_bitplanes(codes.astype(np.uint64), width, n_pad)
    k = _ceil_pow2(card)
    vals = np.zeros((nlimbs, k), dtype=np.uint32)
    vals[:, :card] = unique_limbs
    # pad with the last value so padded codes (never produced) stay benign
    if card < k:
        vals[:, card:] = unique_limbs[:, -1:]
    return EncodedPack(Scheme.DICT, n, nlimbs, width=width, planes=planes,
                       values=vals, k=k, card=card, dict_keys=dict_keys)


# ---------------------------------------------------------------- decode ---
# Batched device decodes: inputs carry a leading pack axis P.

_SHIFTS32 = None


def _expand_bits(words):
    """u32[..., W] -> u32[..., W*32] of 0/1 (bit k of word w -> row w*32+k)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)


_T32_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def _bit_transpose32(x):
    """u32[..., 32, W] -> u32[..., 32, W]: transpose each 32x32 bit block
    (axis -2 indexes the 32 words, W vectorizes). Hacker's Delight
    transpose32 with the row loop turned into reshaped tensor halves —
    5 masked exchange passes total, each a full-array elementwise op."""
    j = 16
    for m in _T32_MASKS:
        sh = x.shape
        xr = x.reshape(*sh[:-2], 32 // (2 * j), 2, j, sh[-1])
        a = xr[..., 0, :, :]
        b = xr[..., 1, :, :]
        t = (a ^ (b >> jnp.uint32(j))) & jnp.uint32(m)
        x = jnp.stack([a ^ t, b ^ (t << jnp.uint32(j))],
                      axis=-3).reshape(sh)
        j //= 2
    return x


def _bit_transpose32_pm(x):
    """Plane-major form of _bit_transpose32: the 32 axis LEADS
    (u32[32, ..., W]) so exchange halves slice the leading dim — no
    middle-axis relayouts under the r4 [w, P, W] device layout."""
    j = 16
    for m in _T32_MASKS:
        sh = x.shape
        xr = x.reshape(32 // (2 * j), 2, j, *sh[1:])
        a = xr[:, 0]
        b = xr[:, 1]
        t = (a ^ (b >> jnp.uint32(j))) & jnp.uint32(m)
        x = jnp.stack([a ^ t, b ^ (t << jnp.uint32(j))],
                      axis=1).reshape(sh)
        j //= 2
    return x


def decode_bitplanes_pair(planes, width: int):
    """u32[w, P, N32] (plane-major, r4) -> (lo u32[P, N], hi u32[P, N])
    packed-domain value halves via 32x32 BIT-MATRIX TRANSPOSE: plane
    word b of rows 32k..32k+31 is row b of a bit matrix whose
    transpose's row i IS the value word of row 32k+i. 5 masked exchange
    passes + one final relayout replace the per-plane expand/or chain,
    whose plane steps XLA may materialize one by one instead of fusing
    (w passes over [P, N] in place of 5 over the planes)."""
    w, P, n32 = planes.shape

    def tr(block32):
        # HD transpose32 is the ANTI-transpose (T[i] bit b = M[31-b]
        # bit (31-i)); flipping the 32-axis on both sides straightens it
        t = _bit_transpose32_pm(block32[::-1])[::-1]
        return t.transpose(1, 2, 0).reshape(P, n32 * 32)

    def pad32(arr):
        k = 32 - arr.shape[0]
        if k:
            arr = jnp.concatenate(
                [arr, jnp.zeros((k, P, n32), jnp.uint32)], axis=0)
        return arr

    lo = tr(pad32(planes[:min(width, 32)]))
    if width > 32:
        hi = tr(pad32(planes[32:width]))
    else:
        hi = jnp.zeros((P, n32 * 32), jnp.uint32)
    return lo, hi


def decode_bitplanes_u64(planes, width: int):
    """u32[w, P, N32] -> u64[P, N] packed-domain values (transpose
    decode + one bitcast combine — no emulated u64 shifts)."""
    lo, hi = decode_bitplanes_pair(planes, width)
    return jax.lax.bitcast_convert_type(
        jnp.stack([lo, hi], axis=-1), jnp.uint64)


def decode_bitplanes_u32(planes, width: int):
    """Like decode_bitplanes_u64 but stays in u32 (width <= 32). Small
    widths keep the expand/or chain (padding to a 32-plane transpose
    costs more than the short chain); wider ones transpose."""
    if width > 8:
        lo, _ = decode_bitplanes_pair(planes, width)
        return lo
    w, P, n32 = planes.shape
    out = jnp.zeros((P, n32 * 32), dtype=jnp.uint32)
    for p in range(width):
        bit = _expand_bits(planes[p])
        out = out | (bit << jnp.uint32(p))
    return out


def key_u64_to_limbs(keys, nlimbs: int):
    """u64[P, N] -> u32[L, P, N]."""
    if nlimbs == 1:
        return keys.astype(jnp.uint32)[None]
    hi = (keys >> jnp.uint64(32)).astype(jnp.uint32)
    lo = keys.astype(jnp.uint32)
    return jnp.stack([hi, lo])


def decode_const(values, P: int, N: int):
    """values: u32[P, L, 1] -> u32[L, P, N] broadcast."""
    return jnp.broadcast_to(values.transpose(1, 0, 2), (values.shape[1], P, N))


def decode_raw(values):
    """values: u32[P, L, N] -> u32[L, P, N]."""
    return values.transpose(1, 0, 2)


def decode_bitpack(planes, min_keys, width: int, nlimbs: int):
    """planes u32[P, w, N32], min_keys u64[P] -> u32[L, P, N]."""
    if width <= 32 and nlimbs == 1:
        v = decode_bitplanes_u32(planes, width) + min_keys.astype(jnp.uint32)[:, None]
        return v[None]
    v = decode_bitplanes_u64(planes, width) + min_keys[:, None]
    return key_u64_to_limbs(v, nlimbs)


def decode_delta(planes, base_keys, width: int, nlimbs: int):
    """zigzag deltas -> cumsum + base. planes u32[P, w, N32], base u64[P]."""
    zz = decode_bitplanes_u64(planes, width)
    d = (zz >> jnp.uint64(1)) ^ (-(zz & jnp.uint64(1)))
    v = jnp.cumsum(d, axis=-1) + base_keys[:, None]
    return key_u64_to_limbs(v, nlimbs)


def rle_run_index(ends, N: int):
    """ends u32[P, k] -> i32[P, N] run index per row (vectorized searchsorted:
    run[i] = #ends <= i)."""
    row = jnp.arange(N, dtype=jnp.uint32)[None, None, :]
    return (ends[:, :, None] <= row).sum(axis=1, dtype=jnp.int32)


def decode_rle(values, ends, N: int):
    """values u32[P, L, k], ends u32[P, k] -> u32[L, P, N]."""
    idx = rle_run_index(ends, N)                    # i32[P, N]
    g = jnp.take_along_axis(values, idx[:, None, :], axis=2)
    return g.transpose(1, 0, 2)


def decode_dict(planes, values, width: int):
    """planes u32[P, w, N32] codes, values u32[P, L, k] -> u32[L, P, N]."""
    codes = decode_bitplanes_u32(planes, width).astype(jnp.int32)
    g = jnp.take_along_axis(values, codes[:, None, :], axis=2)
    return g.transpose(1, 0, 2)


def dict_gather_mask(code_planes, width: int, dict_mask):
    """Fused dict matcher: evaluate predicate on the dictionary (k values),
    then gather by code. dict_mask: bool[P, k] -> bool[P, N]."""
    codes = decode_bitplanes_u32(code_planes, width).astype(jnp.int32)
    return jnp.take_along_axis(dict_mask, codes, axis=1)


def rle_gather_mask(ends, run_mask, N: int):
    """Fused RLE matcher: predicate on run values -> expand to rows."""
    idx = rle_run_index(ends, N)
    return jnp.take_along_axis(run_mask, idx, axis=1)
