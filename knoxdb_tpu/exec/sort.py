"""Order-by / top-k over device segments.

EXCEEDS reference parity per the BASELINE north star (config #4): the
reference orders only by pk (docs list sort/top-k as future operator
work, internal/query/plan.go:26-34).

Design: ordering happens in the KEYFORM domain (utils/limbs.py), where
every type — signed/unsigned/float/decimal/wide — is an unsigned
lexicographic integer, so ONE sort kernel family serves all types:
- narrow (<=64-bit): single u64 argsort (descending = argsort of ~key)
- wide (128/256-bit): LSB->MSB multi-pass STABLE argsort over u64 chunks
  (radix-style over limb pairs)
Filtered-out rows get sentinel keys that sink to the end; top-k is a
static slice of the sorted order. Per-segment top-k results merge on the
host (k is small); full sorts merge with a host keyform argsort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bitset as bs
from . import device as D

__all__ = ["segment_topk"]

_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _flat_keys_u64(scanner, fname: str, arrays, W: int):
    """Decode a narrow column to flat u64 keys [P*N] (value domain)."""
    d = scanner.d
    dec = jnp.zeros((d.P, d.N), jnp.uint64)
    for gi, g in enumerate(d.column(fname).groups):
        keys = D.group_decode_keys(g.sig(), arrays[fname][gi], W)
        dec = dec.at[g.idx].set(keys)
    return dec.reshape(-1)


def _flat_limbs(scanner, fname: str, arrays, W: int):
    """Absolute keyform limbs [L, P*N] (wide bitpack rebased on device)."""
    d = scanner.d
    L = d.seg.columns[fname].nlimbs
    dec = jnp.zeros((L, d.P, d.N), jnp.uint32)
    for gi, g in enumerate(d.column(fname).groups):
        lim = D.group_decode_limbs_abs(g.sig(), g, arrays[fname][gi], W)
        dec = dec.at[:, g.idx].set(lim)
    return dec.reshape(L, -1)


def segment_topk(scanner, tree, order_field: str, k: int,
                 desc: bool = False, project: list[str] | None = None,
                 exclude_words=None):
    """Top-k rows of one segment under a filter.

    Returns (order_keys, rows) where order_keys are python-int keyform
    keys (host merges segments with these) and rows maps projected field
    -> u32 limb matrix [L, k] (+ "__idx" row positions). Rows beyond the
    match count carry sentinel keys."""
    d = scanner.d
    project = project or []
    col = d.seg.columns[order_field]
    wide = col.wide
    used = sorted(set([order_field] + project))

    _fn, margs, mask_raw = scanner.prepare(tree, [], exclude_words)
    arrays = d.arrays_pytree(used)

    # the plan builds per-pack const-bit masks with a host loop over
    # wo*P bits — O(100k) python steps at 1000 packs; cache per field
    # (segments are immutable, scanner._fns dies with the segment)
    fp_key = ("topk-fastplan", order_field)
    if fp_key in scanner._fns:
        fast = scanner._fns[fp_key]
    else:
        fast = _topk_fast_plan(d, col, order_field)
        scanner._fns[fp_key] = fast
    if fast is not None:
        return _topk_bit_descent(scanner, margs, mask_raw, arrays, fast,
                                 order_field, k, desc, project,
                                 exclude_words is not None)

    sig = ("topk", d.sig(used), order_field, k, desc, wide,
           tuple(project), exclude_words is not None,
           scanner._plan_sigs[id(mask_raw)])
    fn = scanner._fns.get(sig)
    if fn is None:
        proj_cols = list(project)

        def f(margs, arrays):
            mask, _, _ = mask_raw(*margs)
            flat_mask = bs.unpack_mask(mask).reshape(-1)
            if wide:
                limbs = _flat_limbs(scanner, order_field, arrays, d.W)
                if desc:
                    limbs = ~limbs
                limbs = jnp.where(flat_mask[None], limbs,
                                  jnp.uint32(0xFFFFFFFF))
                L = limbs.shape[0]
                # radix over u64 chunks, LSB chunk first, stable
                order = jnp.arange(limbs.shape[1])
                for c in range((L + 1) // 2 - 1, -1, -1):
                    hi_l = max(0, 2 * c)
                    chunk = (limbs[hi_l].astype(jnp.uint64) << jnp.uint64(32))
                    if 2 * c + 1 < L:
                        chunk = chunk | limbs[2 * c + 1].astype(jnp.uint64)
                    order = order[jnp.argsort(chunk[order], stable=True)]
                top = order[:k]
            else:
                keys = _flat_keys_u64(scanner, order_field, arrays, d.W)
                if desc:
                    keys = ~keys
                keys = jnp.where(flat_mask, keys, _SENT)
                # partial sort: top_k of flipped keys == k smallest keys
                # ascending (no full argsort + gather)
                _vals, top = jax.lax.top_k(~keys, k)
            outs = {"__idx": top}
            okeys = None
            if wide:
                okeys = jnp.take(_flat_limbs(scanner, order_field, arrays,
                                             d.W), top, axis=1)
            else:
                okeys = jnp.take(_flat_keys_u64(scanner, order_field,
                                                arrays, d.W), top)
            valid = jnp.take(flat_mask, top)
            for name in proj_cols:
                lim = _flat_limbs(scanner, name, arrays, d.W)
                outs[name] = jnp.take(lim, top, axis=1)
            return outs, okeys, valid

        fn = jax.jit(f)
        scanner._fns[sig] = fn

    outs, okeys, valid = fn(margs, arrays)
    valid = np.asarray(valid)
    nvalid = int(valid.sum())
    okeys = np.asarray(okeys)
    kk = min(k, nvalid)
    if wide:                       # vectorized object-int assembly (r4)
        keys_a = okeys[0, :kk].astype(object)
        for l in range(1, okeys.shape[0]):
            keys_a = (keys_a << 32) + okeys[l, :kk].astype(object)
    else:
        keys_a = okeys[:kk].astype(object)
    keys_int = keys_a.tolist()
    rows = {name: np.asarray(v)[..., :nvalid] for name, v in outs.items()}
    return keys_int, rows, nvalid


def _topk_fast_plan(d, col, order_field: str):
    """Bit-descent eligibility: single-group full-coverage BITPACK order
    column (narrow AND wide int128/256 — the descent works at any
    width). Returns (width_out, const_bits u32[wo, P] np, gmin) —
    per-pack (base - gmin) bit masks computed on the HOST as python
    ints (device 64-bit shifts are off-limits, see
    ops/bitslice.add_const_planes)."""
    from ..encode.schemes import Scheme
    dcol = d.column(order_field)
    if any(g.scheme != Scheme.BITPACK for g in dcol.groups):
        return None
    if sum(g.npacks for g in dcol.groups) != d.P:
        return None
    if col.wide and any(g.bases is None for g in dcol.groups):
        return None
    # per-PACK minimum bases in pack order (groups partition the packs;
    # widths may differ per group — add_const_planes zero-extends)
    mins = [0] * d.P
    wmax = 0
    for g in dcol.groups:
        w = g.sig()[1]
        wmax = max(wmax, w)
        for j, pi in enumerate(np.asarray(g.idx)):
            mins[int(pi)] = int(g.bases[j]) if col.wide \
                else int(col.packs[int(pi)].min_key)
    gmin = min(mins)
    rel_max = max(m - gmin for m in mins) + (1 << wmax) - 1
    wo = max(1, rel_max.bit_length())
    if wo > 272:
        return None
    cb = np.zeros((wo, d.P), np.uint32)
    for b in range(wo):
        for j, m in enumerate(mins):
            if ((m - gmin) >> b) & 1:
                cb[b, j] = 0xFFFFFFFF
    return wo, cb, gmin


def _topk_bit_descent(scanner, margs, mask_raw, arrays, fast,
                      order_field: str, k: int, desc: bool,
                      project: list[str], has_excl: bool):
    """Device top-k: MSB-first radix SELECT over comparable bitplanes
    (ops/bitslice.topk_select) instead of sorting the row population —
    width popcount passes + K-scale gathers, bandwidth-bound (the
    lax.top_k path sorts all P*N keys)."""
    from ..ops import bitslice as BS
    from ..ops import compact as C
    d = scanner.d
    wo, cb_np, gmin = fast
    kcap = max(1, 1 << (k - 1).bit_length())
    used = sorted(set([order_field] + project))
    # the bit-pair descent is bandwidth-cheap mask ops (one popcount
    # pass per plane pair); a wide-radix histogram descent would cost R
    # MACs per row per 13-bit digit instead
    sig = ("topk-bd", d.sig(used), order_field, kcap, desc,
           tuple(project), has_excl,
           scanner._plan_sigs[id(mask_raw)])
    fn = scanner._fns.get(sig)
    nw = -(-wo // 32)
    proj_cols = list(project)
    proj_limbs = [d.seg.columns[nm].nlimbs for nm in proj_cols]
    if fn is None:

        def f(margs, arrays, cb, kk):
            mask, _, _ = mask_raw(*margs)
            groups = scanner.d.column(order_field).groups
            if len(groups) == 1:
                absp = BS.add_const_planes(arrays[order_field][0]["planes"],
                                           cb, wo)
            else:
                # groups partition the packs: rebase each group's planes
                # to width wo, scatter into pack order (P-scale move;
                # plane-major [wo, P, W] since r4)
                absp = jnp.zeros((wo, d.P, d.W), jnp.uint32)
                for gi, g in enumerate(groups):
                    idx = jnp.asarray(np.asarray(g.idx))
                    part = BS.add_const_planes(
                        arrays[order_field][gi]["planes"], cb[:, idx], wo)
                    absp = absp.at[:, idx].set(part)
            _tw, better, tie, nb = BS.topk_select(
                absp, mask, kk, wo, want_max=desc)
            bi, _bc = C.first_k_indexes(better, kcap)
            ti, tc = C.first_k_indexes(tie, kcap)
            idx = jnp.concatenate([bi, ti])
            vwords = C.gather_plane_values(absp, idx, d.N)
            ar = jnp.arange(kcap, dtype=jnp.int32)
            # tie picks are bounded by BOTH the remaining quota and the
            # actual tie population (fewer matches than k)
            sel = jnp.concatenate(
                [ar < nb, (ar < (kk - nb)) & (ar < tc.astype(jnp.int32))])
            # ONE packed u32 buffer -> ONE host fetch: every synchronized
            # fetch pays a fixed cost, and this path's latency was
            # fetch-bound, not compute-bound
            parts = [sel.astype(jnp.uint32), idx.astype(jnp.uint32)]
            parts.extend(vwords)
            for name in proj_cols:
                lim = _flat_limbs(scanner, name, arrays, d.W)
                parts.append(jnp.take(lim, idx, axis=1).reshape(-1))
            return jnp.concatenate(parts)

        fn = jax.jit(f)
        scanner._fns[sig] = fn

    cb_key = ("topk-cb", order_field)
    cb_dev = scanner._fns.get(cb_key)      # cache the H2D upload
    if cb_dev is None:
        cb_dev = jnp.asarray(cb_np)
        scanner._fns[cb_key] = cb_dev
    buf = np.asarray(fn(margs, arrays, cb_dev, jnp.int32(k)))
    K2 = 2 * kcap
    sel = buf[:K2] != 0
    idx_np = buf[K2:2 * K2].astype(np.int64)
    vw = [buf[(2 + j) * K2:(3 + j) * K2] for j in range(nw)]
    off = (2 + nw) * K2
    outs = {"__idx": idx_np}
    for name, L in zip(proj_cols, proj_limbs):
        outs[name] = buf[off:off + L * K2].reshape(L, K2)
        off += L * K2
    pick = np.flatnonzero(sel)
    # vectorized object-int key assembly (r4: no per-row python at any k)
    keys_a = np.full(len(pick), gmin, object)
    for j, w in enumerate(vw):
        keys_a = keys_a + (w[pick].astype(object) << (32 * j))
    order = np.argsort(keys_a, kind="stable")
    if desc:
        order = order[::-1]
    pick = pick[order]
    keys = keys_a[order].tolist()
    rows = {}
    for name, v in outs.items():
        a = np.asarray(v)
        rows[name] = a[..., pick] if a.ndim > 1 else a[pick]
    return keys, rows, len(keys)
