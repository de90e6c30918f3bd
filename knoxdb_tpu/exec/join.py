"""Equi-joins over keyform keys.

The reference ships merge/loop join strategies with a pk-cursor block
fetch (/root/reference/internal/operator/join/join.go:380-427,536-556)
and leaves hash join TODO (join.go:6-9,825). Here the single-chip path is
a sort+probe join in the keyform domain:

- build side sorted once (payload co-sort / host for tiny sides)
- probe bounds, duplicate expansion and rank->row translation are ALL
  payload-carrying co-sorts + log-doubling forward fills — zero gathers
  and zero searchsorteds (both ran far below bandwidth on the
  accelerator this was first built for)

The multi-chip path (parallel/shuffle.py) hash-partitions both sides by
key over the mesh with all_to_all and runs this same kernel per shard.
"""

from __future__ import annotations

import numpy as np

from ..types import JoinType

__all__ = ["join_keys_np", "JoinResult"]


class JoinResult:
    def __init__(self, lidx: np.ndarray, ridx: np.ndarray):
        self.lidx = lidx      # row indices into the left batch (-1 = none)
        self.ridx = ridx      # row indices into the right batch (-1 = none)

    @property
    def n(self) -> int:
        return len(self.lidx)


def join_keys_np(lkeys: np.ndarray, rkeys: np.ndarray,
                 how: JoinType = JoinType.INNER) -> JoinResult:
    """Join two keyform key arrays (u64 or object ints).

    Host reference implementation (also the oracle for the device path):
    sort-probe with duplicate expansion. Returns matched index pairs in
    left-row order (stable), with -1 on the outer side's misses."""
    order = np.argsort(rkeys, kind="stable")
    rs = rkeys[order]
    lo = np.searchsorted(rs, lkeys, side="left")
    hi = np.searchsorted(rs, lkeys, side="right")
    counts = hi - lo

    if how == JoinType.CROSS:
        li = np.repeat(np.arange(len(lkeys)), len(rkeys))
        ri = np.tile(np.arange(len(rkeys)), len(lkeys))
        return JoinResult(li, ri)

    lidx: list[int] = []
    ridx: list[int] = []
    matched_r = np.zeros(len(rkeys), bool)
    for i in range(len(lkeys)):
        c = counts[i]
        if c:
            for j in range(lo[i], hi[i]):
                lidx.append(i)
                ridx.append(int(order[j]))
                matched_r[order[j]] = True
        elif how in (JoinType.LEFT, JoinType.FULL):
            lidx.append(i)
            ridx.append(-1)
    if how in (JoinType.RIGHT, JoinType.FULL):
        for j in np.flatnonzero(~matched_r):
            lidx.append(-1)
            ridx.append(int(j))
    return JoinResult(np.asarray(lidx, np.int64), np.asarray(ridx, np.int64))


SHIFT_S = 16     # shift-core span: covers key runs up to 17 entries


def join_pairs_device(lkeys, rkeys, how: JoinType = JoinType.INNER,
                      unique_build: bool = False,
                      keys32: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Device sort-probe join with duplicate expansion.

    lkeys/rkeys: u64 device arrays in a common join domain. Returns
    (lidx i64[M], ridx i64[M]) host arrays of matched index pairs into
    the input arrays; LEFT-join misses emit ridx == -1. Gather-free
    co-sorts only (no [rows]-scale host fetch; reference merge-join
    semantics, join.go:536-556).

    Core ladder (each rung falls back to the next on a device-checked
    violation; all rungs share one oracle contract):
      unique_build=True  -> join_pairs_core_unique: ONE sort + fills
                            (dup check falls back)
      default            -> join_pairs_core_shift: ONE sort + SHIFT_S
                            shifted compares; key runs spanning > SHIFT_S
                            entries fall back
      fallback           -> join_pairs_core: cap-retry expansion core
                            (3 sorts + 2 output-scale sorts), any data

    keys32=True (both sides' keys < 2^32 — pass it when zone maps /
    stats prove it) drops the hi-limb sort operand, ~15% off the
    dominant sort."""
    Nl = int(lkeys.shape[0])
    Nr = int(rkeys.shape[0])
    empty = np.empty(0, np.int64)
    if Nl == 0:
        return empty, empty
    if Nr == 0:
        if how == JoinType.LEFT:
            return np.arange(Nl, dtype=np.int64), np.full(Nl, -1, np.int64)
        return empty, empty

    def filtered(lidx, ridx):
        lidx_np = np.asarray(lidx)
        ridx_np = np.asarray(ridx)
        keep = lidx_np != -2
        return (lidx_np[keep].astype(np.int64),
                ridx_np[keep].astype(np.int64))

    if unique_build:
        lidx, ridx, total_d, dups_d = _unique_jit()(
            lkeys, rkeys, how=how, keys32=keys32)
        if not bool(dups_d):
            if int(total_d) == 0:
                return empty, empty
            return filtered(lidx, ridx)
        # stale uniqueness hint: fall through

    # shift core first: one sort + elementwise shifts; exact whenever no
    # key run spans more than SHIFT_S entries (device-checked)
    lidx, ridx, total_d, maxneed_d = _shift_jit()(
        lkeys, rkeys, S=SHIFT_S, how=how, keys32=keys32)
    if int(maxneed_d) <= SHIFT_S:
        if int(total_d) == 0:
            return empty, empty
        return filtered(lidx, ridx)

    # cap-retry expansion core: join_pairs_core always returns the TRUE
    # total even when cap truncates, so one retry with the right cap
    # covers duplicate-heavy joins.
    cap = 1 << max(0, (Nl - 1).bit_length())
    while True:
        lidx, ridx, total_d = join_pairs_core(lkeys, rkeys, cap, how,
                                              keys32=keys32)
        total = int(total_d)
        if total <= cap:
            break
        cap = 1 << (total - 1).bit_length()
    if total == 0:
        return empty, empty
    return filtered(lidx, ridx)


def join_count_device(lkeys, rkeys, how: JoinType = JoinType.INNER):
    """Match-pair count (phase 1; one scalar host fetch). Sort-only:
    searchsorted is ~20 gather passes, and gathers were the slow
    primitive where this was first built."""
    import jax
    import jax.numpy as jnp
    rh = jax.lax.bitcast_convert_type(rkeys, jnp.uint32)
    lh = jax.lax.bitcast_convert_type(lkeys, jnp.uint32)
    rs_hi, rs_lo = jax.lax.sort((rh[:, 1], rh[:, 0]), dimension=0,
                                num_keys=2)
    lo, hi = _probe_bounds_merged(rs_hi, rs_lo, lh[:, 1], lh[:, 0])
    counts = (hi - lo).astype(jnp.int64)
    eff = jnp.maximum(counts, 1) if how == JoinType.LEFT else counts
    return eff.sum()


def _fill_forward_max(vals):
    """Inclusive running maximum via log-doubling elementwise maximum
    (the elementwise form stays at bandwidth; lax.cummax lowers to a
    reduce-window)."""
    import jax.numpy as jnp
    n = vals.shape[0]
    sh = 1
    while sh < n:
        vals = jnp.maximum(
            vals, jnp.concatenate([jnp.zeros(sh, vals.dtype), vals[:-sh]]))
        sh <<= 1
    return vals


def _fill_forward_last(vals, sent):
    """Forward-fill: each position takes the nearest preceding (or own)
    value != sent; positions with no predecessor keep sent. Log-doubling
    — after pass k every gap up to 2^k is filled."""
    import jax.numpy as jnp
    n = vals.shape[0]
    sh = 1
    while sh < n:
        prev = jnp.concatenate([jnp.full(sh, sent, vals.dtype), vals[:-sh]])
        vals = jnp.where(vals == sent, prev, vals)
        sh <<= 1
    return vals


def merge_sorted_stable(na: int, key, *payloads):
    """Stable merge of two concatenated ASCENDING u32 runs key[:na] and
    key[na:] with payload channels (equal keys keep concatenation
    order, which lax.sort's stability guarantees).

    A hand-rolled bitonic-merge network reshapes at stride s in every
    compare-exchange pass; XLA's sort is used instead. Kept as an API
    (callers say "merge") but implemented AS the sort."""
    import jax
    srt = jax.lax.sort((key,) + payloads, dimension=0, num_keys=1)
    return srt


def _probe_bounds_merged(rs_hi, rs_lo, qk_hi, qk_lo):
    """BOTH probe bounds (lo = builds strictly below, hi = builds <=)
    from ONE merged co-sort + one restore sort — halves the rank-phase
    sort count vs two separate rank co-sorts (sorts dominate the
    join).

    Builds sort before equal-key queries, so at a query's slot the
    exclusive build count IS hi; lo is the build count at the slot's
    key-run START, forward-filled through the run with a cummax (run
    starts carry non-decreasing build counts). Returns (lo, hi) i32[Nq]
    in query order."""
    import jax
    import jax.numpy as jnp
    Nb = rs_hi.shape[0]
    Nq = qk_hi.shape[0]
    M = Nb + Nq
    kh = jnp.concatenate([rs_hi, qk_hi])
    kl = jnp.concatenate([rs_lo, qk_lo])
    tag = jnp.concatenate([jnp.zeros(Nb, jnp.int32),
                           jnp.ones(Nq, jnp.int32)])
    oid = jnp.concatenate([jnp.full(Nb, Nq, jnp.int32),
                           jnp.arange(Nq, dtype=jnp.int32)])
    kh_s, kl_s, tag_s, oid_s = jax.lax.sort((kh, kl, tag, oid),
                                            dimension=0, num_keys=3)
    is_q = tag_s == 1
    pos = jnp.arange(M, dtype=jnp.int32)
    cq = jnp.cumsum(is_q.astype(jnp.int32))          # inclusive
    bb = pos + 1 - cq - (1 - is_q.astype(jnp.int32))  # builds before slot
    start = (pos == 0) | (kh_s != jnp.roll(kh_s, 1)) \
        | (kl_s != jnp.roll(kl_s, 1))
    # forward-fill run-start build counts via log-doubling max:
    # ~log2(M) elementwise maximum passes stay at bandwidth
    lo_all = jnp.where(start, bb, 0)
    sh = 1
    while sh < M:
        lo_all = jnp.maximum(
            lo_all,
            jnp.concatenate([jnp.zeros(sh, lo_all.dtype), lo_all[:-sh]]))
        sh <<= 1
    key2 = jnp.where(is_q, oid_s, jnp.int32(Nq))     # queries first, unique
    _k2, lo_q, hi_q = jax.lax.sort((key2, lo_all, bb), dimension=0,
                                   num_keys=1)
    return lo_q[:Nq], hi_q[:Nq]


def _probe_bounds_merged_limbs(b_cols, q_cols):
    """L-limb generalization of _probe_bounds_merged (MSW-first u32 limb
    lists): build-rank bounds per query via one merged (L+1)-key sort +
    one restore sort. Used by the wide (int128/256) IN membership path;
    the 2-limb join fast paths keep the specialized version."""
    import jax
    import jax.numpy as jnp
    L = len(b_cols)
    Nb = b_cols[0].shape[0]
    Nq = q_cols[0].shape[0]
    M = Nb + Nq
    ks = [jnp.concatenate([b.reshape(-1), q.reshape(-1)])
          for b, q in zip(b_cols, q_cols)]
    tag = jnp.concatenate([jnp.zeros(Nb, jnp.int32),
                           jnp.ones(Nq, jnp.int32)])
    oid = jnp.concatenate([jnp.full(Nb, Nq, jnp.int32),
                           jnp.arange(Nq, dtype=jnp.int32)])
    srt = jax.lax.sort(tuple(ks) + (tag, oid), dimension=0,
                       num_keys=L + 1)
    ks_s, tag_s, oid_s = srt[:L], srt[L], srt[L + 1]
    is_q = tag_s == 1
    pos = jnp.arange(M, dtype=jnp.int32)
    cq = jnp.cumsum(is_q.astype(jnp.int32))
    bb = pos + 1 - cq - (1 - is_q.astype(jnp.int32))
    start = pos == 0
    for k in ks_s:
        start = start | (k != jnp.roll(k, 1))
    lo_all = _fill_forward_max(jnp.where(start, bb, 0))
    key2 = jnp.where(is_q, oid_s, jnp.int32(Nq))
    _k2, lo_q, hi_q = jax.lax.sort((key2, lo_all, bb), dimension=0,
                                   num_keys=1)
    return lo_q[:Nq], hi_q[:Nq]


def _merged_sort_tagged(lkeys, rkeys, keys32: bool):
    """ONE merged sort of [build ∪ probe] with the side tag riding bit
    31 of the id operand (builds sort first within a key run). Returns
    (key_limbs_sorted tuple, pidt_s u32[M]). keys32=True drops the hi
    limb from the sort operands (each operand adds to the sort's
    traffic; u32 join keys are the common case)."""
    import jax
    import jax.numpy as jnp
    Nr = rkeys.shape[0]
    Nl = lkeys.shape[0]
    TAGBIT = jnp.uint32(1 << 31)
    rh = jax.lax.bitcast_convert_type(rkeys, jnp.uint32)  # [Nr, 2]
    lh = jax.lax.bitcast_convert_type(lkeys, jnp.uint32)  # [Nl, 2]
    kl = jnp.concatenate([rh[:, 0], lh[:, 0]])
    pidt = jnp.concatenate([jnp.arange(Nr, dtype=jnp.uint32),
                            jnp.arange(Nl, dtype=jnp.uint32) | TAGBIT])
    if keys32:
        kl_s, pidt_s = jax.lax.sort((kl, pidt), dimension=0, num_keys=2)
        return (kl_s,), pidt_s
    kh = jnp.concatenate([rh[:, 1], lh[:, 1]])
    kh_s, kl_s, pidt_s = jax.lax.sort((kh, kl, pidt), dimension=0,
                                      num_keys=3)
    return (kh_s, kl_s), pidt_s


def join_pairs_core_shift(lkeys, rkeys, S: int = 16,
                          how: JoinType = JoinType.INNER,
                          keys32: bool = False):
    """General dup-expansion join at the SINGLE-SORT roofline for
    bounded key-run spans: ONE merged sort + S shifted equal-key
    compares (all elementwise, bandwidth-speed).

    After the merged sort, a key run is [builds..., probes...]; every
    (probe, build) pair of a run sits at a unique position distance
    s ∈ [1, span-1], so shift-compare s emits exactly the pairs at that
    distance:  valid(p, s) = probe(p) & build(p-s) & key[p]==key[p-s].

    Returns (lidx i32[C*M], ridx i32[C*M], total i64, maxneed i32) with
    C = S (+1 for LEFT's miss channel), M = Nl + Nr. Valid pairs are
    INTERSPERSED (-2 elsewhere, LEFT misses ridx == -1 in the extra
    channel) — the house join contract. maxneed is the max distance any
    matched probe needs; maxneed > S means runs span wider than S and
    the output UNDERCOUNTS: the caller must fall back to
    join_pairs_core (the cap-retry expansion core). total is the
    EMITTED pair count (== true count iff maxneed <= S).

    The general expansion core costs 3 population sorts + 2
    output-scale sorts; this core is one sort plus elementwise shifts
    and fills. Reference semantics: merge join join.go:536-556 with dup
    expansion."""
    import jax
    import jax.numpy as jnp
    Nl = lkeys.shape[0]
    Nr = rkeys.shape[0]
    M = Nl + Nr
    assert Nl < (1 << 30) and Nr < (1 << 30) and S >= 1
    left = how == JoinType.LEFT
    SENT = jnp.uint32(0xFFFFFFFF)
    TAGBIT = jnp.uint32(1 << 31)

    ks, pidt_s = _merged_sort_tagged(lkeys, rkeys, keys32)
    is_b = (pidt_s & TAGBIT) == 0
    pid_s = (pidt_s & ~TAGBIT).astype(jnp.int32)

    pos = jnp.arange(M, dtype=jnp.uint32)
    start = pos == 0
    for k in ks:
        start = start | (k != jnp.roll(k, 1))
    # run start position, forward-filled; builds sort first in-run so
    # the run's builds occupy [rs, rs+nb) and a probe at p needs
    # shift distances (p - rs - nb + 1) .. (p - rs)
    rs = _fill_forward_max(jnp.where(start, pos, jnp.uint32(0)))
    # does this run start with a build (<=> run contains any build)?
    hb = _fill_forward_last(
        jnp.where(start, is_b.astype(jnp.uint32), SENT), SENT)
    matched = (~is_b) & (hb == 1)
    need = jnp.where(matched, pos - rs, jnp.uint32(0))
    maxneed = need.max().astype(jnp.int32)

    lidx_ch = []
    ridx_ch = []
    total = jnp.int64(0)
    for s in range(1, S + 1):
        if s >= M:
            break
        eq = jnp.ones(M, bool)
        for k in ks:
            eq = eq & (k == jnp.concatenate([k[:s], k[:-s]]))
        eq = eq & (pos >= s)
        b_sh = jnp.concatenate([jnp.zeros(s, bool), is_b[:-s]])
        pid_sh = jnp.concatenate([jnp.zeros(s, jnp.int32), pid_s[:-s]])
        valid = (~is_b) & b_sh & eq
        lidx_ch.append(jnp.where(valid, pid_s, jnp.int32(-2)))
        ridx_ch.append(jnp.where(valid, pid_sh, jnp.int32(-2)))
        total = total + valid.sum(dtype=jnp.int64)
    if left:
        miss = (~is_b) & (hb != 1)
        lidx_ch.append(jnp.where(miss, pid_s, jnp.int32(-2)))
        ridx_ch.append(jnp.where(miss, jnp.int32(-1), jnp.int32(-2)))
        total = total + miss.sum(dtype=jnp.int64)
    return (jnp.concatenate(lidx_ch), jnp.concatenate(ridx_ch),
            total, maxneed)


def _merged_bounds_inorder(lkeys, rkeys, keys32: bool = False):
    """ONE merged 3-key sort of [build ∪ probe] -> per-MERGED-position
    arrays (is_probe, probe-id, lo, hi): lo/hi are the probe's build-
    rank bounds, valid at probe positions. The side tag rides bit 31 of
    the id operand (builds sort first within a key run), so probe ids
    arrive as payloads and NO probe-order restore sort is needed — the
    r3 join cores consume bounds in merged key order. Returns
    (is_q bool[M], pid u32[M], lo i32[M], hi i32[M])."""
    import jax.numpy as jnp
    Nr = rkeys.shape[0]
    Nl = lkeys.shape[0]
    M = Nl + Nr
    TAGBIT = jnp.uint32(1 << 31)
    ks, pidt_s = _merged_sort_tagged(lkeys, rkeys, keys32)
    is_q = (pidt_s & TAGBIT) != 0
    pid = pidt_s & ~TAGBIT
    pos = jnp.arange(M, dtype=jnp.int32)
    cq = jnp.cumsum(is_q.astype(jnp.int32))          # inclusive
    bb = pos + 1 - cq - (1 - is_q.astype(jnp.int32))  # builds before
    start = pos == 0
    for k in ks:
        start = start | (k != jnp.roll(k, 1))
    # builds sort before equal-key probes, so at a probe slot the
    # exclusive build count IS hi; lo is the run-start build count,
    # forward-filled (log-doubling max, _fill_forward_max)
    lo = _fill_forward_max(jnp.where(start, bb, 0))
    return is_q, pid, lo, bb


def join_pairs_core(lkeys, rkeys, cap: int,
                    how: JoinType = JoinType.INNER,
                    keys32: bool = False):
    """Pure jittable sort-probe join with duplicate expansion at a
    STATIC cap: returns DEVICE arrays (lidx, ridx, total) of length
    Nr + Nl + Nr + cap with valid pairs INTERSPERSED in build-rank
    order (-2 elsewhere, ridx -1 on LEFT misses). Callers filter; pair
    ORDER is unspecified (key-clustered). total is always the TRUE
    pair count even when cap truncates.

    GATHER-FREE and (r3) RESTORE-FREE formulation: every cross-array
    lookup is a payload-carrying co-sort +
    log-doubling forward fill. Round 3 drops the three probe/slot-order
    restore sorts entirely (output order is free) — THREE full sorts +
    TWO bitonic merges total:

      1. build sort    (kh, kl, iota)        -> build order payload
      2. merged bounds _merged_bounds_inorder -> lo/hi per probe, in
         merged key order (one 3-key sort + fills, no restore)
      3. expansion     bitonic merge (offs ∪ slot iota): slot ->
         (probe id, build rank j, miss) via shifted payloads + fills
      4. slot rank sort (j, probe-id|flags)  -> slots in rank order
      5. rank->build-id bitonic merge (build ranks ∪ slot ranks) +
         forward fill — replaces take(order, rank)

    All composites are 32-bit (cap < 2^30 and Nl, Nr < 2^30 always hold
    for per-chip shards).
    Reference semantics: merge join join.go:536-556 with dup expansion."""
    import jax
    import jax.numpy as jnp
    Nl = lkeys.shape[0]
    Nr = rkeys.shape[0]
    M = Nl + Nr
    assert (M + cap) < (1 << 31) and cap < (1 << 30) and Nr < (1 << 30)
    left = how == JoinType.LEFT
    U1 = jnp.uint32(1)
    SENT = jnp.uint32(0xFFFFFFFF)
    INVK = jnp.uint32(0xFFFFFFFE)     # below the bitonic-merge pad key
    MISSBIT = jnp.uint32(1 << 31)

    rh = jax.lax.bitcast_convert_type(rkeys, jnp.uint32)  # [Nr, 2]
    if keys32:
        _rs_lo, order_s = jax.lax.sort(
            (rh[:, 0], jnp.arange(Nr, dtype=jnp.uint32)),
            dimension=0, num_keys=1)            # rank -> original index
    else:
        _rs_hi, _rs_lo, order_s = jax.lax.sort(
            (rh[:, 1], rh[:, 0], jnp.arange(Nr, dtype=jnp.uint32)),
            dimension=0, num_keys=2)
    is_q, pid_m, lo_m, hi_m = _merged_bounds_inorder(lkeys, rkeys, keys32)
    counts = jnp.where(is_q, hi_m - lo_m, 0)
    eff = jnp.where(is_q & left, jnp.maximum(counts, 1), counts) \
        if left else counts
    offs = jnp.cumsum(eff)                      # inclusive, i32, [M]
    total = offs[-1]

    # --- expansion: offs-entries ∪ slot-entries, key = (value<<1)|tag.
    # Slot t belongs to merged position i <=> offs[i-1] <= t < offs[i]
    # (necessarily a probe: builds have eff 0); the number of offs-
    # entries sorting before slot t is exactly i. Payloads are SHIFTED
    # (offs-entry i carries position i+1's lo/pid/count) so the nearest
    # PRECEDING offs entry i-1 carries the owner i's values.
    tl = jnp.arange(cap, dtype=jnp.uint32)
    comp = jnp.concatenate([offs.astype(jnp.uint32) << U1,
                            (tl << U1) | U1])

    def shifted(x):
        return jnp.concatenate([
            jnp.concatenate([x[1:].astype(jnp.uint32),
                             jnp.full(1, SENT, jnp.uint32)]),
            jnp.full(cap, SENT, jnp.uint32)])

    ops = [comp, shifted(lo_m), shifted(pid_m)]
    if left:
        ops.append(shifted(counts))
    # both runs of comp are pre-sorted (offs is a cumsum, slots are an
    # iota): a bitonic MERGE (log passes) replaces a full sort network
    srt = merge_sorted_stable(M, *ops)
    c_s = srt[0]
    is_t = (c_s & U1) == U1
    pos = jnp.arange(M + cap, dtype=jnp.int32)
    ct = jnp.cumsum(is_t.astype(jnp.int32))     # inclusive slot count
    ic = pos + 1 - ct                           # owner position i
    prevv = _fill_forward_max(
        jnp.where(is_t, jnp.uint32(0), c_s >> U1))       # offs[i-1]
    lof = _fill_forward_last(srt[1], SENT)
    lof = jnp.where(lof == SENT, lo_m[0].astype(jnp.uint32), lof)
    pidf = _fill_forward_last(srt[2], SENT)
    pidf = jnp.where(pidf == SENT, pid_m[0], pidf)
    k = (c_s >> U1).astype(jnp.int32) - prevv.astype(jnp.int32)
    j = lof.astype(jnp.int32) + k               # build RANK per slot
    slot_ok = is_t & (ic < M)                   # t < total
    if left:
        cntf = _fill_forward_last(srt[3], SENT)
        cntf = jnp.where(cntf == SENT, counts[0].astype(jnp.uint32),
                         cntf)
        miss = k >= cntf.astype(jnp.int32)
        # a missing probe's single slot still needs a DEFINED rank for
        # the sort/merge below; rank 0 always exists (Nr > 0 guarded by
        # the device wrapper)
        j = jnp.where(miss, 0, j)
        pidf = pidf | jnp.where(miss, MISSBIT, jnp.uint32(0))

    # --- slots to rank order (invalid entries -> INVK tail)
    key3 = jnp.where(slot_ok, j.astype(jnp.uint32), INVK)
    j_s, pid_s3 = jax.lax.sort((key3, pidf), dimension=0, num_keys=1)

    # --- rank -> build original index: bitonic merge of build entries
    # (key rank<<1, order payload) with slot entries (key (j<<1)|1,
    # probe-id payload) — both runs ascending — then forward-fill.
    key_a = jnp.arange(Nr, dtype=jnp.uint32) << U1
    key_b = jnp.where(j_s == INVK, INVK, (j_s << U1) | U1)
    key_m = jnp.concatenate([key_a, key_b])
    pay_oid = jnp.concatenate([order_s,
                               jnp.full(M + cap, SENT, jnp.uint32)])
    pay_pid = jnp.concatenate([jnp.full(Nr, SENT, jnp.uint32), pid_s3])
    km_s, oid_m, pid_f = merge_sorted_stable(Nr, key_m, pay_oid, pay_pid)
    # build entries have even keys; INVK is even too but its oid payload
    # is already SENT, so it never pollutes the fill
    oid_f = _fill_forward_last(
        jnp.where((km_s & U1) == 0, oid_m, SENT), SENT)

    is_slot = ((km_s & U1) == 1) & (km_s != INVK) & (pid_f != SENT)
    lidx = jnp.where(is_slot,
                     (pid_f & ~MISSBIT).astype(jnp.int32), jnp.int32(-2))
    ridx = jnp.where(is_slot, oid_f.astype(jnp.int32), jnp.int32(-2))
    if left:
        ridx = jnp.where(is_slot & ((pid_f & MISSBIT) != 0),
                         jnp.int32(-1), ridx)
    return lidx, ridx, total.astype(jnp.int64)


_UNIQUE_JIT = None
_SHIFT_JIT = None


def _unique_jit():
    global _UNIQUE_JIT
    if _UNIQUE_JIT is None:
        import jax
        _UNIQUE_JIT = jax.jit(join_pairs_core_unique,
                              static_argnames=("how", "keys32"))
    return _UNIQUE_JIT


def _shift_jit():
    global _SHIFT_JIT
    if _SHIFT_JIT is None:
        import jax
        _SHIFT_JIT = jax.jit(join_pairs_core_shift,
                             static_argnames=("S", "how", "keys32"))
    return _SHIFT_JIT


def join_pairs_core_unique(lkeys, rkeys, how: JoinType = JoinType.INNER,
                           keys32: bool = False):
    """Sort-probe join for a UNIQUE build side (e.g. joining on the
    build table's pk): every probe has at most one match, so the dup-
    expansion machinery (expansion sort + slot restore + rank merge +
    restore — 5 of the general core's ~7 sorts) collapses to nothing.

    ONE sort + TWO forward fills total (r3: the former probe-order
    restore sort is GONE — join pair order is unspecified, callers
    filter interspersed invalids anyway, so pairs are emitted in merged
    KEY order directly):

      1. merged 3-key sort of (key_hi, key_lo, tag|id): the side tag
         rides bit 31 of the id word, so builds sort BEFORE probes of
         the same key and each entry still carries its original row id
         — one less sort operand, no rank translation pass.
      2. in merged order: key-run ids from run starts (cumsum); forward
         fill (build id, build run-id) with ALIGNED sentinel positions.
         A probe matches iff its filled run-id equals its own run id
         (unique build => that run's single build).

    Returns (lidx i32[Nl+Nr], ridx i32[Nl+Nr], total i64, dup_builds
    bool) — valid pairs INTERSPERSED in key order (build rows and
    non-matching probes -2, LEFT misses ridx -1), callers filter.
    dup_builds=True means the uniqueness guarantee was violated (a
    build key repeats): results then UNDERCOUNT matches and the caller
    must re-run the general core.

    Reference semantics: merge join join.go:536-556 restricted to its
    unique-rhs case."""
    import jax
    import jax.numpy as jnp
    Nl = lkeys.shape[0]
    Nr = rkeys.shape[0]
    M = Nl + Nr
    assert Nl < (1 << 30) and Nr < (1 << 30)
    left = how == JoinType.LEFT
    SENT = jnp.uint32(0xFFFFFFFF)
    TAGBIT = jnp.uint32(1 << 31)

    ks, pidt_s = _merged_sort_tagged(lkeys, rkeys, keys32)
    is_b = (pidt_s & TAGBIT) == 0
    pid_s = pidt_s & ~TAGBIT

    start = jnp.arange(M, dtype=jnp.uint32) == 0
    for k in ks:
        start = start | (k != jnp.roll(k, 1))
    seg = jnp.cumsum(start.astype(jnp.uint32))             # run id, >= 1
    # unique-violation probe: a build NOT at its run start can only
    # follow another build of the same key (builds sort first in-run)
    dup_builds = (is_b & ~start).any()

    fb = _fill_forward_last(jnp.where(is_b, pid_s, SENT), SENT)
    fs = _fill_forward_last(jnp.where(is_b, seg, SENT), SENT)
    match = (~is_b) & (fs == seg) & (fb != SENT)

    li = pid_s.astype(jnp.int32)
    bid = fb.astype(jnp.int32)
    if left:
        lidx = jnp.where(is_b, jnp.int32(-2), li)
        ridx = jnp.where(is_b, jnp.int32(-2),
                         jnp.where(match, bid, jnp.int32(-1)))
        total = jnp.int64(Nl)
    else:
        lidx = jnp.where(match, li, jnp.int32(-2))
        ridx = jnp.where(match, bid, jnp.int32(-2))
        total = match.sum(dtype=jnp.int64)
    return lidx, ridx, total, dup_builds
