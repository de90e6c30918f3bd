"""Device-resident segment store + per-group fused kernels.

The device image of a pack/segment.Segment: every column's packs are
grouped by (scheme, width, k) and stacked into single arrays so one XLA
kernel serves a whole group (the reference dispatches per-pack per-type
matchers, internal/operator/filter/match.go:60-66; here the grid IS the
pack axis). All group kernels are pure jnp functions of (arrays, consts)
so exec/scan.py can jit whole query plans with constants traced.

Match kernels return PACKED bitset words u32[Pg, W]; aggregate kernels
return per-pack partials that the host combines exactly (python ints) —
see ops/bitslice.py for the no-decode bitpack paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..encode.schemes import EncodedPack, Scheme
from ..ops import bitset as bs
from ..ops import bitslice as B
from ..ops import cmp as C
from ..pack.segment import EncodedColumn, Segment
from ..types import FieldType, FilterMode

__all__ = ["DeviceGroup", "DeviceColumn", "DeviceSegment", "group_match",
           "group_decode_keys", "group_masked_sum", "group_masked_minmax",
           "rle_row_runs"]


@dataclass
class DeviceGroup:
    scheme: Scheme
    width: int                 # bitplane width (BITPACK/DELTA/DICT)
    k: int                     # padded value count (RLE/DICT)
    nlimbs: int
    wide: bool
    idx: np.ndarray            # i64[Pg] pack indices into the segment
    arrays: dict = field(default_factory=dict)   # name -> jnp array
    # host-side per-pack metadata aligned with idx:
    bases: list[int] | None = None       # wide bitpack / ALP bases
    exps: list[int] | None = None        # ALP decimal exponents per pack
    dict_keys: list[np.ndarray] | None = None  # per-pack sorted u64 keys
    dict_bytes: list[list] | None = None  # per-pack sorted byte dicts (str)
    rle_host: list[EncodedPack] | None = None   # host packs (RLE value access)

    @property
    def npacks(self) -> int:
        return len(self.idx)

    def sig(self) -> tuple:
        return (int(self.scheme), self.width, self.k, self.nlimbs,
                self.wide, self.npacks)


@dataclass
class DeviceColumn:
    field_type: FieldType
    wide: bool
    groups: list[DeviceGroup]

    def sig(self) -> tuple:
        return (int(self.field_type), tuple(g.sig() for g in self.groups))


class DeviceSegment:
    """Uploaded image of one Segment."""

    def __init__(self, seg: Segment):
        self.seg = seg
        self.P = seg.npacks
        self.N = seg.pack_size
        self.W = seg.pack_size // 32
        self.columns: dict[str, DeviceColumn] = {}
        # validity: mask padding rows of the last pack
        valid = np.zeros((self.P, self.W), np.uint32)
        for p in range(self.P):
            n = int(seg.nrows[p])
            full, rem = divmod(n, 32)
            valid[p, :full] = 0xFFFFFFFF
            if rem:
                valid[p, full] = (1 << rem) - 1
        self.valid_words = jnp.asarray(valid)

    def column(self, name: str) -> DeviceColumn:
        col = self.columns.get(name)
        if col is None:
            col = _upload_column(self.seg.columns[name], self.N)
            self.columns[name] = col
        return col

    def arrays_pytree(self, names: list[str]) -> dict:
        """Pytree of device arrays for the jitted scan fn."""
        return {n: [g.arrays for g in self.column(n).groups] for n in names}

    def sig(self, names: list[str]) -> tuple:
        return (self.P, self.N, tuple((n, self.column(n).sig()) for n in names))


def _upload_column(col: EncodedColumn, pack_size: int) -> DeviceColumn:
    bykey: dict[tuple, list[int]] = {}
    for i, p in enumerate(col.packs):
        bykey.setdefault((p.scheme, p.width, p.k), []).append(i)

    groups = []
    for (scheme, width, k), idxs in sorted(bykey.items()):
        packs = [col.packs[i] for i in idxs]
        g = DeviceGroup(scheme, width, k, col.nlimbs, col.wide,
                        np.asarray(idxs, np.int64))
        if scheme in (Scheme.BITPACK, Scheme.DELTA, Scheme.DICT, Scheme.ALP):
            # PLANE-MAJOR device layout [w, P, W]: per-plane slices
            # hit the LEADING dim, so one plane of every pack is one
            # contiguous block
            g.arrays["planes"] = jnp.asarray(
                np.stack([p.planes for p in packs], axis=1))
        if scheme == Scheme.ALP:
            g.bases = [p.min_key for p in packs]
            g.exps = [p.exp for p in packs]
            g.arrays["min_keys"] = jnp.zeros(len(idxs), jnp.uint64)
        if scheme in (Scheme.CONST, Scheme.RAW, Scheme.RLE, Scheme.DICT):
            kmax = max(p.values.shape[1] for p in packs)
            vals = np.stack([_pad_vals(p.values, kmax) for p in packs])
            g.arrays["values"] = jnp.asarray(vals)
        if scheme == Scheme.RLE:
            kmax = max(len(p.ends) for p in packs)
            ends = np.stack([_pad_ends(p.ends, kmax) for p in packs])
            g.arrays["ends"] = jnp.asarray(ends)
            g.rle_host = packs
        if scheme in (Scheme.BITPACK, Scheme.DELTA):
            if col.wide:
                g.bases = [col.wide_bases[i] for i in idxs]
                g.arrays["min_keys"] = jnp.zeros(len(idxs), jnp.uint64)
            else:
                g.arrays["min_keys"] = jnp.asarray(
                    np.array([p.min_key for p in packs], np.uint64))
        if scheme == Scheme.DICT:
            g.dict_keys = [p.dict_keys for p in packs]
            if packs[0].dict_bytes is not None:
                g.dict_bytes = [p.dict_bytes for p in packs]
        if scheme == Scheme.CONST and col.wide:
            g.bases = [col.wide_bases[i] for i in idxs]
        groups.append(g)
    return DeviceColumn(col.field.type, col.wide, groups)


def _pad_vals(v: np.ndarray, k: int) -> np.ndarray:
    if v.shape[1] == k:
        return v
    out = np.empty((v.shape[0], k), v.dtype)
    out[:, :v.shape[1]] = v
    out[:, v.shape[1]:] = v[:, -1:]
    return out


def _pad_ends(e: np.ndarray, k: int) -> np.ndarray:
    out = np.full(k, 0xFFFFFFFF, np.uint32)
    out[:len(e)] = e
    return out


# ------------------------------------------------------------ run expand ---

def rle_row_runs(ends, N: int):
    """u32[Pg, k] exclusive run ends -> i32[Pg, N] run index per row.

    O(N) scatter+cumsum (replaces the O(N*k) broadcast compare): run r
    starts at ends[r-1]; scatter 1 at each start, inclusive-cumsum - 1."""
    Pg, k = ends.shape
    starts = jnp.concatenate(
        [jnp.zeros((Pg, 1), jnp.uint32), ends[:, :-1]], axis=1)
    # flatten to one scatter; padded ends (0xFFFFFFFF) fall outside and drop
    row_off = (jnp.arange(Pg, dtype=jnp.uint32) * jnp.uint32(N))[:, None]
    flat_idx = (starts + row_off).reshape(-1)
    # padded entries repeat the same start; add counts then clamp via min
    oneh = jnp.zeros(Pg * N, jnp.int32).at[flat_idx].add(
        1, mode="drop").reshape(Pg, N)
    # repeated starts from padding would overcount: padded starts equal the
    # last real end which is == N (end of pack) -> dropped. Runs inside the
    # pack are strictly increasing, so counts are 0/1 except position 0.
    oneh = oneh.at[:, 0].set(1)
    return jnp.cumsum(oneh, axis=1) - 1


def rle_expand_mask(ends, run_mask, N: int):
    """u32[Pg, k] exclusive run ends + bool[Pg, k] run verdicts ->
    bool[Pg, N] row mask, via boundary-delta cumsum (no row gathers)."""
    Pg, k = ends.shape
    starts = jnp.concatenate(
        [jnp.zeros((Pg, 1), jnp.uint32), ends[:, :-1]], axis=1)
    off = (jnp.arange(Pg, dtype=jnp.uint32) * jnp.uint32(N))[:, None]
    big = jnp.uint32(Pg * N)            # out-of-bounds -> dropped
    real = ends <= jnp.uint32(N)        # padded runs have ends=0xFFFFFFFF
    s_idx = jnp.where(real & (starts < jnp.uint32(N)), starts + off, big)
    e_idx = jnp.where(real & (ends < jnp.uint32(N)), ends + off, big)
    m = run_mask.astype(jnp.int32)
    delta = jnp.zeros(Pg * N, jnp.int32)
    delta = delta.at[s_idx.reshape(-1)].add(m.reshape(-1), mode="drop")
    delta = delta.at[e_idx.reshape(-1)].add(-m.reshape(-1), mode="drop")
    return jnp.cumsum(delta.reshape(Pg, N), axis=1) > 0


def rle_expand_values(ends, run_values_u64, N: int):
    """Decode RLE to u64 rows via value-difference deltas + cumsum.

    run_values_u64: u64[Pg, k] (padded tail repeats any value — padded
    runs start at/after N and drop out of the scatter)."""
    Pg, k = ends.shape
    starts = jnp.concatenate(
        [jnp.zeros((Pg, 1), jnp.uint32), ends[:, :-1]], axis=1)
    prev = jnp.concatenate(
        [jnp.zeros((Pg, 1), jnp.uint64), run_values_u64[:, :-1]], axis=1)
    diffs = run_values_u64 - prev                  # mod 2^64
    off = (jnp.arange(Pg, dtype=jnp.uint32) * jnp.uint32(N))[:, None]
    big = jnp.uint32(Pg * N)
    real = ends <= jnp.uint32(N)
    s_idx = jnp.where(real & (starts < jnp.uint32(N)), starts + off, big)
    acc = jnp.zeros(Pg * N, jnp.uint64)
    acc = acc.at[s_idx.reshape(-1)].add(diffs.reshape(-1), mode="drop")
    return jnp.cumsum(acc.reshape(Pg, N), axis=1)


# --------------------------------------------------------------- matching ---

def group_match(g_sig: tuple, mode: FilterMode, arrays: dict, consts: dict,
                W: int):
    """Evaluate one predicate leaf over one device group.

    g_sig: DeviceGroup.sig() (static); arrays: the group's device arrays;
    consts: prepared constants from exec/rewrite.py (traced). Returns
    packed u32[Pg, W]."""
    scheme, width, k, nlimbs, wide, Pg = Scheme(g_sig[0]), *g_sig[1:]
    N = W * 32

    if scheme == Scheme.CONST:
        # per-pack scalar compare: host rewrite provides a bool[Pg] verdict
        return jnp.where(consts["const_match"][:, None], jnp.uint32(0xFFFFFFFF),
                         jnp.uint32(0))

    if scheme in (Scheme.BITPACK, Scheme.ALP):
        if wide or scheme == Scheme.ALP:
            # host-precomputed exact domain relations (python-int bases /
            # Fraction-derived ALP enc bounds; exec/rewrite.py). ALP mode
            # adjustments (v < c ⟺ enc <= host-bound) are static:
            if scheme == Scheme.ALP:
                kmode = {FilterMode.LT: FilterMode.LE,
                         FilterMode.GT: FilterMode.GE}.get(mode, mode)
            else:
                kmode = mode
            if kmode == FilterMode.RANGE:
                return B.range_planes_rel(arrays["planes"], consts["rel_lo"],
                                          consts["rel_hi"], width)
            if kmode in (FilterMode.IN, FilterMode.NOT_IN):
                if "cs_limbs" in consts:
                    # big wide IN list: decode + absolute rebase + one
                    # merged (L+1)-key sort membership (fixed-shape;
                    # the per-key rels sweep traces O(K*width) ops)
                    from .join import _probe_bounds_merged_limbs
                    lim = group_decode_limbs(g_sig, arrays, W)
                    lim = add_base_limbs(lim, consts["base_limbs"])
                    csl = consts["cs_limbs"]
                    lo, hi = _probe_bounds_merged_limbs(
                        [csl[l] for l in range(lim.shape[0])],
                        [lim[l].reshape(-1) for l in range(lim.shape[0])])
                    mem = (hi > lo).reshape(lim.shape[1], N)
                    m = bs.pack_mask(mem)
                else:
                    m = B.in_planes_rel(arrays["planes"], consts["rels"],
                                        width)
                return ~m if kmode == FilterMode.NOT_IN else m
            return B.cmp_planes_rel(kmode, arrays["planes"], consts["rel"],
                                    width)
        cs = consts.get("cs")
        if mode in (FilterMode.IN, FilterMode.NOT_IN) and cs is not None \
                and cs.shape[0] >= _IN_SORT_MIN_K:
            # sort-membership: the K-way EQ sweep traces O(K*width) graph
            # ops — a 2048-key IN list took >10 min to COMPILE. One
            # merged co-sort is a fixed-shape program for any K.
            vlo, vhi = group_decode_halves(g_sig, arrays, W)
            m = membership_words(vlo, vhi, cs)
            return ~m if mode == FilterMode.NOT_IN else m
        return B.match_planes(mode, arrays["planes"], arrays["min_keys"],
                              width, lo=consts.get("lo"), hi=consts.get("hi"),
                              cs=cs)

    if scheme == Scheme.DICT:
        if "dict_mask" in consts:
            # byte-dict IN/NOT_IN/REGEXP: bool verdict per dictionary
            # entry, gathered by code (the reference's dict matcher shape,
            # internal/encode/container.go:72-76)
            from ..encode import schemes as S
            codes = S.decode_bitplanes_u32(arrays["planes"], width) \
                .astype(jnp.int32)
            rows = jnp.take_along_axis(consts["dict_mask"], codes, axis=1)
            return bs.pack_mask(rows)
        # predicates rewritten to code space on host (exec/rewrite.py);
        # code space is order-preserving, so mode maps statically:
        code_mode = {
            FilterMode.EQ: FilterMode.EQ, FilterMode.NE: FilterMode.NE,
            FilterMode.LT: FilterMode.LT, FilterMode.LE: FilterMode.LT,
            FilterMode.GT: FilterMode.GE, FilterMode.GE: FilterMode.GE,
            FilterMode.RANGE: FilterMode.RANGE,
            FilterMode.IN: FilterMode.IN, FilterMode.NOT_IN: FilterMode.IN,
        }[mode]
        # shapes derive from traced arrays, not the static sig: under
        # shard_map (parallel/engine_spmd.py) arrays are device-local
        zero = jnp.zeros(arrays["planes"].shape[1], jnp.uint64)
        m = B.match_planes(code_mode, arrays["planes"], zero, width,
                           lo=consts.get("lo"), hi=consts.get("hi"),
                           cs=consts.get("cs"))
        if mode == FilterMode.NOT_IN:
            m = ~m
        return m

    if scheme == Scheme.DELTA:
        keys = _delta_keys_impl(arrays, width)
        cs = consts.get("cs")
        if mode in (FilterMode.IN, FilterMode.NOT_IN) and cs is not None \
                and cs.shape[0] >= _IN_SORT_MIN_K:
            # sort-membership for big IN lists (compile-time pathology
            # of the K-way EQ sweep — see membership_bool). u64 split
            # via bitcast only (u64 shifts mis-lower — CLAUDE.md)
            h = jax.lax.bitcast_convert_type(keys, jnp.uint32)
            m = membership_words(h[..., 0], h[..., 1], cs)
            return ~m if mode == FilterMode.NOT_IN else m
        mask = _cmp_u64(mode, keys, consts)
        return bs.pack_mask(mask)

    if scheme == Scheme.RLE:
        # fused: evaluate on run VALUES, expand by boundary deltas —
        # +1 at matched run starts, -1 at matched run ends, prefix-sum >0
        # (k-sized scatters + one cumsum instead of [P, N] gathers)
        rv = arrays["values"].transpose(1, 0, 2)     # u32[L, Pg, k]
        run_mask = _limb_mask_in_or_cmp(mode, rv, consts, nlimbs)
        rows = rle_expand_mask(arrays["ends"], run_mask, N)
        return bs.pack_mask(rows)

    if scheme == Scheme.RAW:
        x = arrays["values"].transpose(1, 0, 2)      # u32[L, Pg, N]
        mask = _limb_mask_in_or_cmp(mode, x, consts, nlimbs)
        return bs.pack_mask(mask)

    raise ValueError(f"group_match: {scheme}")


def _delta_keys_impl(arrays, width: int):
    from ..encode import schemes as S
    zz = S.decode_bitplanes_u64(arrays["planes"], width)
    d = (zz >> jnp.uint64(1)) ^ (-(zz & jnp.uint64(1)))
    return jnp.cumsum(d, axis=-1) + arrays["min_keys"][:, None]


def _cmp_u64(mode: FilterMode, keys, consts):
    """u64-domain compare (narrow types, decoded keys)."""
    if mode == FilterMode.EQ:
        return keys == consts["lo"]
    if mode == FilterMode.NE:
        return keys != consts["lo"]
    if mode == FilterMode.LT:
        return keys < consts["lo"]
    if mode == FilterMode.LE:
        return keys <= consts["lo"]
    if mode == FilterMode.GT:
        return keys > consts["lo"]
    if mode == FilterMode.GE:
        return keys >= consts["lo"]
    if mode == FilterMode.RANGE:
        return (keys >= consts["lo"]) & (keys <= consts["hi"])
    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        cs = consts["cs"]
        m = keys == cs[0]
        for i in range(1, cs.shape[0]):
            m = m | (keys == cs[i])
        return ~m if mode == FilterMode.NOT_IN else m
    raise ValueError(f"_cmp_u64: {mode}")


def _cmp_limbs(mode: FilterMode, x, consts):
    """Limb-domain compare via ops/cmp (works for wide types)."""
    if mode == FilterMode.RANGE:
        return C.between(x, consts["lo_limbs"], consts["hi_limbs"])
    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        return C.match(mode, x, in_limbs=consts["cs_limbs"])
    return C.match(mode, x, lo=consts["lo_limbs"])


def _limb_mask_in_or_cmp(mode: FilterMode, x, consts, nlimbs: int):
    """_cmp_limbs, except big IN lists take the fixed-shape sort-
    membership program instead of the K-way unrolled EQ sweep (limb 0
    is the MSW — exec/rewrite._int_to_limbs). <= 2 limbs ride the
    2-word merged sort; wider values the L-limb generalization.
    Returns bool mask of x.shape[1:]."""
    cs_l = consts.get("cs_limbs")
    if mode in (FilterMode.IN, FilterMode.NOT_IN) and cs_l is not None \
            and cs_l.shape[1] >= _IN_SORT_MIN_K:
        if nlimbs <= 2:
            vlo = x[nlimbs - 1]
            vhi = x[0] if nlimbs == 2 else jnp.zeros_like(vlo)
            klo = cs_l[nlimbs - 1]
            khi = cs_l[0] if nlimbs == 2 else jnp.zeros_like(klo)
            m = membership_bool(vlo, vhi, klo, khi)
        else:
            from .join import _probe_bounds_merged_limbs
            lo, hi = _probe_bounds_merged_limbs(
                [cs_l[l] for l in range(nlimbs)],
                [x[l].reshape(-1) for l in range(nlimbs)])
            m = (hi > lo).reshape(x.shape[1:])
        return ~m if mode == FilterMode.NOT_IN else m
    return _cmp_limbs(mode, x, consts)


# -------------------------------------------------------------- decoding ---

_MXU_LOOKUP_MAX_K = 1024    # above this the FLOPs outgrow the gather win


def onehot_lookup_u64(codes, values):
    """EXACT dict decode via ONE-HOT MATMULS: codes i32[Pg, N] in
    [0, k), values u64[Pg, k] -> u64[Pg, N].

    take_along_axis at [Pg, N] row scale is a row-scale gather; the
    tensor cores do the same lookup as 8 batched one-hot x byte-plane
    matmuls. Every number
    stays exact: byte chunks are exact in bf16, each one-hot row has ONE
    nonzero so f32 accumulation is a single exact product, and the u64
    reassembles from two u32 halves via bitcast (no 64-bit shifts)."""
    Pg, k = values.shape
    N = codes.shape[1]
    # byte planes bf16 [Pg, k, 8]: u32 halves via bitcast, then 32-bit
    # shifts only
    halves = jax.lax.bitcast_convert_type(values, jnp.uint32)  # [Pg,k,2]
    planes = []
    for c in range(8):
        h = halves[..., c // 4]
        planes.append(((h >> jnp.uint32(8 * (c % 4)))
                       & jnp.uint32(0xFF)).astype(jnp.bfloat16))
    vm = jnp.stack(planes, axis=-1)                    # [Pg, k, 8]
    iota = jnp.arange(k, dtype=jnp.int32)
    oneh = (codes[:, :, None] == iota[None, None, :]).astype(jnp.bfloat16)
    ch = jax.lax.dot_general(
        oneh, vm, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)            # [Pg, N, 8]
    ch = ch.astype(jnp.uint32)
    lo = ch[..., 0] | (ch[..., 1] << jnp.uint32(8)) \
        | (ch[..., 2] << jnp.uint32(16)) | (ch[..., 3] << jnp.uint32(24))
    hi = ch[..., 4] | (ch[..., 5] << jnp.uint32(8)) \
        | (ch[..., 6] << jnp.uint32(16)) | (ch[..., 7] << jnp.uint32(24))
    return jax.lax.bitcast_convert_type(
        jnp.stack([lo, hi], axis=-1), jnp.uint64)


def onehot_lookup_u16(codes, table):
    """One-hot matmul lookup for small int tables: codes i32[Pg, N] in
    [0, k), table i32[Pg, k] with values < 2^16 (group ids: G <=
    MAX_GROUPS = 65536) -> i32[Pg, N]. Two exact byte-chunk matmuls."""
    Pg, k = table.shape
    lo8 = (table & jnp.int32(0xFF)).astype(jnp.bfloat16)
    hi8 = ((table >> jnp.int32(8)) & jnp.int32(0xFF)).astype(jnp.bfloat16)
    vm = jnp.stack([lo8, hi8], axis=-1)                # [Pg, k, 2]
    iota = jnp.arange(k, dtype=jnp.int32)
    oneh = (codes[:, :, None] == iota[None, None, :]).astype(jnp.bfloat16)
    ch = jax.lax.dot_general(
        oneh, vm, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    return ch[..., 0] | (ch[..., 1] << jnp.int32(8))


def group_decode_keys(g_sig: tuple, arrays: dict, W: int):
    """Decode a NARROW group to u64 key values [Pg, N] (value domain for
    narrow columns; packed-relative domain for wide bitpack groups)."""
    scheme, width, k, nlimbs, wide, Pg = Scheme(g_sig[0]), *g_sig[1:]
    N = W * 32
    from ..encode import schemes as S
    if scheme == Scheme.CONST:
        v = _limbs_to_u64(arrays["values"])          # u64[Pg, 1]
        return jnp.broadcast_to(v, (v.shape[0], N))
    if scheme == Scheme.RAW:
        return _limbs_to_u64(arrays["values"])
    if scheme in (Scheme.BITPACK, Scheme.ALP):
        v = S.decode_bitplanes_u64(arrays["planes"], width)
        return v + arrays["min_keys"][:, None]
    if scheme == Scheme.DELTA:
        return _delta_keys_impl(arrays, width)
    if scheme == Scheme.RLE:
        rv = _limbs_to_u64(arrays["values"])         # u64[Pg, k]
        return rle_expand_values(arrays["ends"], rv, N)
    if scheme == Scheme.DICT:
        codes = S.decode_bitplanes_u32(arrays["planes"], width).astype(jnp.int32)
        dv = _limbs_to_u64(arrays["values"])
        if dv.shape[1] <= _MXU_LOOKUP_MAX_K:
            return onehot_lookup_u64(codes, dv)
        return jnp.take_along_axis(dv, codes, axis=1)
    raise ValueError(f"group_decode_keys: {scheme}")


_IN_SORT_MIN_K = 17    # below this the K-way EQ plane sweep is cheaper


def membership_bool(vlo, vhi, klo, khi):
    """Bool membership mask (value-in-key-set) from u32 half pairs via
    ONE merged co-sort over [rows ∪ keys] (exec/join.
    _probe_bounds_merged): a row is a member iff its (lo, hi) key-rank
    bounds differ. Fixed-shape program for any K — the alternative
    K-way EQ sweep traces O(K*width) graph ops, so its trace and
    compile time grow with K (the same holds for the decoded-keys/limb
    IN paths, where a large pk update would compile one filter per
    key count)."""
    from .join import _probe_bounds_merged
    lo, hi = _probe_bounds_merged(khi.reshape(-1), klo.reshape(-1),
                                  vhi.reshape(-1), vlo.reshape(-1))
    return (hi > lo).reshape(vlo.shape)


def membership_words(vlo, vhi, keys):
    """Packed membership mask over u64 `keys` (see membership_bool)."""
    Pg, N = vlo.shape
    kh = jax.lax.bitcast_convert_type(keys, jnp.uint32)     # [K, 2]
    mem = membership_bool(vlo, vhi, kh[:, 0], kh[:, 1]) \
        .reshape(Pg, N // 32, 32)
    return (mem.astype(jnp.uint32)
            << jnp.arange(32, dtype=jnp.uint32)).sum(
                axis=2, dtype=jnp.uint32)


def group_decode_halves(g_sig: tuple, arrays: dict, W: int):
    """Decode a NARROW group to VALUE-domain u32 half pairs
    (lo u32[Pg, N], hi u32[Pg, N]). BITPACK/ALP stay entirely in u32
    (decode_bitplanes_pair + carry-add of per-pack mins), which stays
    in fused u32 chains. Other schemes decode u64 (add/cumsum ops) and
    split via bitcast."""
    scheme = Scheme(g_sig[0])
    width = g_sig[1]
    from ..encode import schemes as S
    if scheme in (Scheme.BITPACK, Scheme.ALP):
        lo, hi = S.decode_bitplanes_pair(arrays["planes"], width)
        mh = jax.lax.bitcast_convert_type(arrays["min_keys"], jnp.uint32)
        ml = mh[:, 0][:, None]
        lo2 = lo + ml
        carry = (lo2 < ml).astype(jnp.uint32)   # unsigned wrap <=> carry
        hi2 = hi + mh[:, 1][:, None] + carry
        return lo2, hi2
    keys = group_decode_keys(g_sig, arrays, W)
    h = jax.lax.bitcast_convert_type(keys, jnp.uint32)
    return h[..., 0], h[..., 1]


def group_decode_limbs(g_sig: tuple, arrays: dict, W: int):
    """Decode any group to limb form u32[L, Pg, N] (wide-capable)."""
    scheme, width, k, nlimbs, wide, Pg = Scheme(g_sig[0]), *g_sig[1:]
    N = W * 32
    from ..encode import schemes as S
    if scheme == Scheme.CONST:
        return jnp.broadcast_to(arrays["values"].transpose(1, 0, 2),
                                (nlimbs, arrays["values"].shape[0], N))
    if scheme == Scheme.RAW:
        return arrays["values"].transpose(1, 0, 2)
    if scheme == Scheme.RLE:
        ridx = rle_row_runs(arrays["ends"], N)
        rv = arrays["values"].transpose(1, 0, 2)
        return jnp.stack([jnp.take_along_axis(rv[l], ridx, axis=1)
                          for l in range(nlimbs)])
    if scheme == Scheme.DICT:
        codes = S.decode_bitplanes_u32(arrays["planes"], width).astype(jnp.int32)
        dv = arrays["values"].transpose(1, 0, 2)
        if nlimbs <= 2 and dv.shape[2] <= _MXU_LOOKUP_MAX_K:
            # one-hot matmul lookup (see group_decode_keys) instead of a
            # take_along_axis gather at [Pg, N]
            u = _limbs_to_u64(arrays["values"])
            keys = onehot_lookup_u64(codes, u)
            halves = jax.lax.bitcast_convert_type(keys, jnp.uint32)
            if nlimbs == 1:
                return halves[..., 0][None]
            return jnp.stack([halves[..., 1], halves[..., 0]])
        return jnp.stack([jnp.take_along_axis(dv[l], codes, axis=1)
                          for l in range(nlimbs)])
    if scheme in (Scheme.BITPACK, Scheme.DELTA, Scheme.ALP):
        keys = group_decode_keys(g_sig, arrays, W)   # u64 (+min already)
        if nlimbs == 1:
            return keys.astype(jnp.uint32)[None]
        hi = (keys >> jnp.uint64(32)).astype(jnp.uint32)
        lo = keys.astype(jnp.uint32)
        if nlimbs == 2:
            return jnp.stack([hi, lo])
        # wide bitpack: relative keys in 2 limbs; host adds bases after
        # materialization (bases exceed u64)
        pads = [jnp.zeros_like(hi)] * (nlimbs - 2)
        return jnp.stack(pads + [hi, lo])
    raise ValueError(f"group_decode_limbs: {scheme}")


def _lex_minmax(limbs, mask, want_min: bool):
    """Masked lexicographic min/max per pack: u32[L, Pg, N] -> u32[L, Pg].
    Log-depth halving tournament on the row axis (empty -> fill value)."""
    fill = jnp.uint32(0xFFFFFFFF) if want_min else jnp.uint32(0)
    x = jnp.where(mask[None], limbs, fill)
    n = x.shape[-1]
    while n > 1:
        n //= 2
        a, b = x[..., :n], x[..., n:2 * n]
        take_b = C.lt_vec(b, a) if want_min else C.lt_vec(a, b)
        x = jnp.where(take_b[None], b, a)
    return x[..., 0]


def add_base_limbs(lim, base):
    """Multi-limb add with carry: lim u32[L, Pg, N] + base u32[Pg, L]
    (limb 0 most significant) -> u32[L, Pg, N]. Used to rebase wide
    bitpack packs to absolute keyform on device (sort path)."""
    L = lim.shape[0]
    out = [None] * L
    carry = jnp.zeros(lim.shape[1:], jnp.uint64)
    for l in range(L - 1, -1, -1):
        s = lim[l].astype(jnp.uint64) + base[:, l].astype(jnp.uint64)[:, None] \
            + carry
        out[l] = s.astype(jnp.uint32)
        carry = s >> jnp.uint64(32)
    return jnp.stack(out)


def group_decode_limbs_abs(g_sig: tuple, g, arrays: dict, W: int):
    """Like group_decode_limbs but wide BITPACK/CONST groups are rebased
    to ABSOLUTE keyform (order-correct across packs)."""
    lim = group_decode_limbs(g_sig, arrays, W)
    scheme, width, k, nlimbs, wide, Pg = Scheme(g_sig[0]), *g_sig[1:]
    if wide and scheme in (Scheme.BITPACK, Scheme.CONST) and g.bases:
        base = np.zeros((Pg, nlimbs), np.uint32)
        for j, b in enumerate(g.bases):
            x = int(b)
            for l in range(nlimbs - 1, -1, -1):
                base[j, l] = x & 0xFFFFFFFF
                x >>= 32
        if scheme == Scheme.CONST:
            # CONST wide stores raw limbs already? No: values hold the
            # original keyform limbs, bases duplicate them; skip rebase.
            return lim
        lim = add_base_limbs(lim, jnp.asarray(base))
    return lim


def _limbs_to_u64(values):
    """u32[Pg, L, k] -> u64[Pg, k] (L <= 2)."""
    if values.shape[1] == 1:
        return values[:, 0, :].astype(jnp.uint64)
    hi = values[:, 0, :].astype(jnp.uint64)
    return (hi << jnp.uint64(32)) | values[:, 1, :].astype(jnp.uint64)


# ------------------------------------------------------------- aggregates ---

def group_masked_sum(g_sig: tuple, arrays: dict, mask_words, W: int):
    """Per-pack masked sums, split exactly: returns (lo u64[Pg], hi u64[Pg],
    counts i64[Pg]) with total = lo + 2^32*hi (packed/value domain per
    scheme; host combines with bases/bias)."""
    scheme, width, k, nlimbs, wide, Pg = Scheme(g_sig[0]), *g_sig[1:]
    Pl = mask_words.shape[0]       # local pack count (== Pg off-mesh)
    if scheme in (Scheme.BITPACK, Scheme.ALP):
        counts = B.popcount_words(mask_words)
        lo = jnp.zeros(Pl, jnp.uint64)
        hi = jnp.zeros(Pl, jnp.uint64)
        for p in range(width):
            c = B.popcount_words(arrays["planes"][p] & mask_words)
            c = c.astype(jnp.uint64)
            if p < 32:
                lo = lo + (c << jnp.uint64(p))
            else:
                hi = hi + (c << jnp.uint64(p - 32))
        # add min_key * count (narrow path; wide bases handled on host)
        mk = arrays.get("min_keys")
        if mk is not None:
            cnt = counts.astype(jnp.uint64)
            lo = lo + (mk & jnp.uint64(0xFFFFFFFF)) * cnt
            hi = hi + (mk >> jnp.uint64(32)) * cnt
        return lo, hi, counts
    if scheme == Scheme.CONST:
        counts = B.popcount_words(mask_words)
        if wide:
            # value = host base (python int); host adds base * count
            z = jnp.zeros(Pl, jnp.uint64)
            return z, z, counts
        v = _limbs_to_u64(arrays["values"])[:, 0]    # u64[Pg]
        cnt = counts.astype(jnp.uint64)
        return (v & jnp.uint64(0xFFFFFFFF)) * cnt, (v >> jnp.uint64(32)) * cnt, counts
    if wide:
        # exact per-limb masked sums: u64[L, Pg]; host recombines with
        # python ints (keyform bias correction included there)
        limbs = group_decode_limbs(g_sig, arrays, W)   # u32[L, Pg, N]
        mask = bs.unpack_mask(mask_words)
        m = mask.astype(jnp.uint64)
        counts = mask.sum(axis=-1, dtype=jnp.int64)
        sums = (limbs.astype(jnp.uint64) * m[None]).sum(
            axis=-1, dtype=jnp.uint64)
        return (sums, counts)        # 2-tuple marks the per-limb form
    # generic: decode keys, split-limb masked sums
    keys = group_decode_keys(g_sig, arrays, W)
    mask = bs.unpack_mask(mask_words)
    m = mask.astype(jnp.uint64)
    counts = mask.sum(axis=-1, dtype=jnp.int64)
    lo = ((keys & jnp.uint64(0xFFFFFFFF)) * m).sum(axis=-1, dtype=jnp.uint64)
    hi = ((keys >> jnp.uint64(32)) * m).sum(axis=-1, dtype=jnp.uint64)
    return lo, hi, counts


def group_masked_sum_float(g_sig: tuple, arrays: dict, mask_words, W: int,
                           ft: FieldType):
    """Per-pack masked float sums: (sums f64/f32[Pg], counts i64[Pg]).

    Decode keyform -> IEEE floats on device and reduce with a fixed
    log-depth pairwise order per pack (deterministic for a given pack
    geometry). NOTE: on stacks where f64 is emulated as double-float the
    low mantissa bits differ from strict IEEE f64 accumulation."""
    keys = group_decode_keys(g_sig, arrays, W)       # u64 keyform [Pg, N]
    mask = bs.unpack_mask(mask_words)
    counts = mask.sum(axis=-1, dtype=jnp.int64)
    if ft == FieldType.FLOAT32:
        k32 = keys.astype(jnp.uint32)
        sign = (k32 & jnp.uint32(0x80000000)) != 0
        bits = jnp.where(sign, k32 ^ jnp.uint32(0x80000000), ~k32)
        vals = jax.lax.bitcast_convert_type(bits, jnp.float32)
        acc = jnp.float32
    else:
        sign = (keys & jnp.uint64(1 << 63)) != 0
        bits = jnp.where(sign, keys ^ jnp.uint64(1 << 63), ~keys)
        vals = jax.lax.bitcast_convert_type(bits, jnp.float64)
        acc = jnp.float64
    vals = jnp.where(mask, vals, jnp.zeros((), acc))
    # log-depth pairwise reduction along rows
    n = vals.shape[-1]
    while n > 1:
        n //= 2
        vals = vals[..., :n] + vals[..., n:2 * n]
    return vals[..., 0], counts


def group_masked_minmax(g_sig: tuple, arrays: dict, mask_words, W: int):
    """Per-pack masked (min, max) u64 keys. Empty packs: (all-ones, 0).
    Wide groups return packed-relative keys; host adds python-int bases."""
    scheme, width, k, nlimbs, wide, Pg = Scheme(g_sig[0]), *g_sig[1:]
    if scheme == Scheme.CONST and wide:
        z = jnp.zeros(mask_words.shape[0], jnp.uint64)
        return z, z
    if scheme in (Scheme.BITPACK, Scheme.ALP):
        mn = B.masked_min_planes(arrays["planes"], arrays["min_keys"],
                                 mask_words, width)
        mx = B.masked_max_planes(arrays["planes"], arrays["min_keys"],
                                 mask_words, width)
        empty = B.popcount_words(mask_words) == 0
        mn = jnp.where(empty, jnp.uint64(0xFFFFFFFFFFFFFFFF), mn)
        mx = jnp.where(empty, jnp.uint64(0), mx)
        return mn, mx
    if wide:
        limbs = group_decode_limbs(g_sig, arrays, W)   # u32[L, Pg, N]
        mask = bs.unpack_mask(mask_words)
        mn = _lex_minmax(limbs, mask, want_min=True)
        mx = _lex_minmax(limbs, mask, want_min=False)
        return mn, mx                # u32[L, Pg] (host detects by ndim)
    keys = group_decode_keys(g_sig, arrays, W)
    mask = bs.unpack_mask(mask_words)
    mn = jnp.where(mask, keys, jnp.uint64(0xFFFFFFFFFFFFFFFF)).min(axis=-1)
    mx = jnp.where(mask, keys, jnp.uint64(0)).max(axis=-1)
    return mn, mx
