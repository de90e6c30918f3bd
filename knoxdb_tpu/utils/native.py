"""ctypes bindings for the native host kernels (native/knox_native.cc).

Builds the shared library from the committed source on first import,
into native/build under a name keyed by a hash of the source, so a
changed source (or a checkout without the build) always rebuilds and a
stale binary is never loaded. Every entry point has a numpy fallback so
the package works without a toolchain; the fallback is announced on
stderr. The native side replaces the reference's encode-path SIMD
assembly on the HOST (the device side is ops/bitslice.py)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["lib", "bitplane_pack", "bitplane_unpack", "analyze_u64",
           "bitset_indexes", "available", "lz4_compress",
           "lz4_decompress"]

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "knox_native.cc"
_BUILD = _ROOT / "native" / "build"

lib = None


def library_path() -> Path:
    """Build output for the current source: libknox_native-<sha>.so."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libknox_native-{digest}.so"


def _build() -> Path:
    so = library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True)
        os.replace(tmp, so)           # concurrent builders: last one wins
    return so


def _load() -> None:
    global lib
    if lib is not None or os.environ.get("KNOX_NO_NATIVE"):
        return
    try:
        L = ctypes.CDLL(str(_build()))
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        L.bitplane_pack.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int32, u32p]
        L.bitplane_unpack.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int32, u64p]
        L.analyze_u64.argtypes = [u64p, ctypes.c_int64, u64p]
        L.bitset_indexes.argtypes = [u32p, ctypes.c_int64, ctypes.c_uint32,
                                     u32p]
        L.bitset_indexes.restype = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        L.lz4_compress.argtypes = [u8p, ctypes.c_int64, u8p,
                                   ctypes.c_int64]
        L.lz4_compress.restype = ctypes.c_int64
        L.lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                     ctypes.c_int64]
        L.lz4_decompress.restype = ctypes.c_int64
        lib = L
    except (OSError, subprocess.CalledProcessError) as e:
        lib = None
        print(f"knoxdb: native host library unavailable ({e}); "
              f"using numpy fallbacks", file=sys.stderr)


_load()


def available() -> bool:
    return lib is not None


def bitplane_pack(values: np.ndarray, width: int, n_pad: int) -> np.ndarray:
    """u64[n] -> u32[width, n_pad//32] bitplanes."""
    n = len(values)
    w = max(width, 1)
    if lib is not None and n:
        out = np.empty((w, n_pad // 32), np.uint32)
        vals = np.ascontiguousarray(values, np.uint64)
        lib.bitplane_pack(vals, n, n_pad, width, out)
        if width == 0:
            out[:] = 0
        return out
    from ..encode.schemes import _pack_bitplanes_np
    return _pack_bitplanes_np(values, width, n_pad)


def bitplane_unpack(planes: np.ndarray, width: int, n: int) -> np.ndarray:
    if lib is not None and n:
        out = np.empty(n, np.uint64)
        p = np.ascontiguousarray(planes, np.uint32)
        lib.bitplane_unpack(p, n, p.shape[1] * 32, width, out)
        return out
    vals = np.zeros(planes.shape[1] * 32, np.uint64)
    for b in range(width):
        bits = np.unpackbits(planes[b].view(np.uint8),
                             bitorder="little").astype(np.uint64)
        vals |= bits << np.uint64(b)
    return vals[:n]


def analyze_u64(values: np.ndarray):
    """(min, max, num_runs, delta_width, pack_width, sorted)."""
    if lib is not None and len(values):
        out = np.empty(6, np.uint64)
        vals = np.ascontiguousarray(values, np.uint64)
        lib.analyze_u64(vals, len(vals), out)
        return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
                int(out[4]), bool(out[5]))
    keys = np.asarray(values, np.uint64)
    mn, mx = int(keys.min()), int(keys.max())
    runs = 1 + int((keys[1:] != keys[:-1]).sum())
    if len(keys) > 1:
        with np.errstate(over="ignore"):
            d = (keys[1:] - keys[:-1]).view(np.int64)
            zz = ((d << 1) ^ (d >> 63)).view(np.uint64)
        dw = int(zz.max()).bit_length()
        sorted_ = bool((d >= 0).all())
    else:
        dw, sorted_ = 0, True
    return mn, mx, runs, dw, (mx - mn).bit_length(), sorted_


def bitset_indexes(words: np.ndarray, base: int = 0) -> np.ndarray:
    if lib is not None:
        w = np.ascontiguousarray(words, np.uint32)
        cap = int(np.bitwise_count(w).sum()) if hasattr(np, "bitwise_count") \
            else int(sum(bin(int(x)).count("1") for x in w))
        out = np.empty(max(cap, 1), np.uint32)
        k = lib.bitset_indexes(w, len(w), base, out)
        return out[:k]
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return (np.flatnonzero(bits) + base).astype(np.uint32)


# ------------------------------------------------------------------ lz4 --
# LZ4 block codec (native C++; python fallbacks keep the decode-any-
# codec contract alive without a toolchain — see store/segio.py).

def lz4_compress(data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    if lib is not None:
        cap = n + n // 255 + 16
        out = np.empty(cap, np.uint8)
        src_c = np.ascontiguousarray(src)
        k = lib.lz4_compress(src_c if n else np.zeros(1, np.uint8), n,
                             out, cap)
        if k > 0:
            return out[:k].tobytes()
    # fallback: a literal-only LZ4 block (valid, decodable, ratio 1.0)
    out = bytearray()
    lit = n
    if lit >= 15:
        out.append(15 << 4)
        r = lit - 15
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)
    else:
        out.append(lit << 4)
    out += data
    return bytes(out)


def lz4_decompress(data: bytes, out_len: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    if lib is not None:
        out = np.empty(max(out_len, 1), np.uint8)
        src_c = np.ascontiguousarray(src)
        k = lib.lz4_decompress(src_c if len(src) else
                               np.zeros(1, np.uint8), len(src),
                               out, out_len)
        if k == out_len:
            return out[:k].tobytes()
        if k >= 0:
            raise ValueError(f"lz4: decoded {k} != expected {out_len}")
        raise ValueError("lz4: malformed block")
    # python fallback decoder (slow; correctness only). Truncated input
    # must raise the same ValueError contract as the native path, never
    # a bare IndexError (r4 review find).
    try:
        ip, iend = 0, len(data)
        out = bytearray()
        while ip < iend:
            token = data[ip]
            ip += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = data[ip]
                    ip += 1
                    lit += b
                    if b != 255:
                        break
            if ip + lit > iend:
                raise ValueError("lz4: truncated literals")
            out += data[ip:ip + lit]
            ip += lit
            if ip >= iend:
                break
            off = data[ip] | (data[ip + 1] << 8)
            ip += 2
            if off == 0 or off > len(out):
                raise ValueError("lz4: bad offset")
            mlen = (token & 15) + 4
            if (token & 15) == 15:
                while True:
                    b = data[ip]
                    ip += 1
                    mlen += b
                    if b != 255:
                        break
            for _ in range(mlen):
                out.append(out[-off])
    except IndexError:
        raise ValueError("lz4: malformed block") from None
    if len(out) != out_len:
        raise ValueError(f"lz4: decoded {len(out)} != expected {out_len}")
    return bytes(out)
