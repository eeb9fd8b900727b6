"""Host<->device sparse coefficient exchange.

Why this exists: only compressed-domain information should cross the
host<->device link.  Dense bitplane stacks cost 10-20 bits per grid
point on the link; the information content at typical bounds is 1-3 bits.

  encode direction (device -> host), ~1.3 B per significant coefficient:
    1. the encode program's small outputs (cuts, ranges, nnz, ...) come
       back bit-packed in ONE uint32 buffer (codec._fetch_small_packed);
    2. a separate compaction program sized to the actual nnz
       (:func:`compact_rice_exchange`) derives significant positions from
       the packed significance bitmap with a two-level popcount select,
       gathers the signed kept-values, and Rice-packs position GAPS and
       values into one self-describing buffer — values coded with the
       Rice parameter of their own subband class, gaps with that of the
       PREVIOUS position's class (:func:`coeff_class`; ~4 bits/value and
       ~1.6 bits/gap under a single global k);
    3. the host fetches a 4-byte exact size, then the payload, and the
       native C++ readers (rice_decode / rice_decode_classed) expand it.

  decode direction (host -> device), ~1.3 B per significant coefficient:
    the host parses the stream into sorted (positions, values) (C-speed
    native sparse_unpack), tier-codes gaps and zigzag values into nibble /
    u8 / u16 / int32 streams (:func:`nibble_pack_sparse_host`; byte and
    bitmap/index forms remain as fallbacks), uploads one buffer per dtype,
    and the device rebuilds (idx, vals) with cumsums + rank gathers and
    ONE scatter — no bitplane stack ever crosses the link.

Everything is either a dense vector op, a large-slice transfer, or an
nnz-sized gather/scatter (element-granularity work scales with the number
of significant coefficients, not with the grid).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


# Link-byte accounting: every exchange transfer reports its payload size
# here so benchmarks can attribute wall time to bytes-on-the-wire
# (bench.py extras ``link_bytes_up/down_per_point``).  The pipelined
# paths increment from several worker threads, and ``dict[k] += v`` is a
# non-atomic load/add/store — hence the lock.
import threading as _threading

LINK_STATS = {"up": 0, "down": 0}
_LINK_LOCK = _threading.Lock()


def count_up(nbytes: int) -> None:
    with _LINK_LOCK:
        LINK_STATS["up"] += int(nbytes)


def count_down(nbytes: int) -> None:
    with _LINK_LOCK:
        LINK_STATS["down"] += int(nbytes)


def reset_link_stats() -> None:
    with _LINK_LOCK:
        LINK_STATS["up"] = 0
        LINK_STATS["down"] = 0


# Above this compacted-pair capacity the fast exchange stops paying: the
# device words buffer costs 13 B/slot and rice_pack_pair's int32 bit
# offsets must stay under 2^31 (52 bits/slot worst case) — beyond it the
# bitmap/index fallback both bounds memory and stays correct.
COMPACT_CAP_LIMIT = 1 << 22


# ---------------------------------------------------------------------------
# Sliced concurrent link transfers
# ---------------------------------------------------------------------------
#
# A single host<->device stream need not saturate the link on
# network-attached accelerators, where per-stream windows cap each
# transfer.  Splitting one transfer into a few concurrent slice streams
# recovers that bandwidth; on a locally attached device the split only
# adds a couple of cheap slice dispatches.  EBCC_LINK_STREAMS overrides
# the stream count (1 disables slicing).

_SLICE_MIN_BYTES = 112 * 1024  # below this a slice is latency, not bandwidth
_XFER_POOL = None
_XFER_POOL_LOCK = _threading.Lock()


def _link_streams() -> int:
    import os

    try:
        return max(1, int(os.environ.get("EBCC_LINK_STREAMS", "4")))
    except ValueError:
        return 4


def _xfer_pool():
    from concurrent.futures import ThreadPoolExecutor

    global _XFER_POOL
    with _XFER_POOL_LOCK:
        if _XFER_POOL is None:
            # Wide enough for several pipelined sub-batches to slice
            # concurrently; threads are idle-cheap (they block in RPC).
            _XFER_POOL = ThreadPoolExecutor(
                max_workers=4 * _link_streams(),
                thread_name_prefix="ebcc-xfer")
        return _XFER_POOL


def _slice_count(nbytes: int) -> int:
    streams = _link_streams()
    if streams <= 1:
        return 1
    return max(1, min(streams, int(nbytes) // _SLICE_MIN_BYTES))


def sliced_get(arr) -> np.ndarray:
    """Fetch a 1-D device array as a few concurrent slice streams.

    Byte-identical to ``np.asarray(jax.device_get(arr))``; only the wire
    schedule differs.  Each slice is its own device view (an XLA slice) so
    the runtime issues independent RPCs that overlap on the link.
    """
    nbytes = arr.size * arr.dtype.itemsize
    k = _slice_count(nbytes)
    if k <= 1:
        return np.asarray(jax.device_get(arr))
    n = int(arr.shape[0])
    step = -(-n // k)
    parts = [arr[s:s + step] for s in range(0, n, step)]
    got = list(_xfer_pool().map(
        lambda p: np.asarray(jax.device_get(p)), parts))
    return np.concatenate(got)


def sliced_put(buf: np.ndarray):
    """Upload a 1-D host array as concurrent slice streams -> device array.

    The slices are re-joined by one tiny on-device concatenate; callers
    that feed the result straight into a jit program pay one extra fused
    copy for ~2x effective upload bandwidth on multi-stream links.
    """
    k = _slice_count(buf.nbytes)
    if k <= 1:
        return jax.device_put(buf)
    n = buf.shape[0]
    step = -(-n // k)
    parts = [buf[s:s + step] for s in range(0, n, step)]
    devs = list(_xfer_pool().map(jax.device_put, parts))
    return jnp.concatenate(devs)


def bucket_count(n: int) -> int:
    """Round a count up a 1.25x-step ladder so gather/scatter programs
    compile a handful of variants."""
    cap = 4096
    while True:
        for m in (cap, cap + cap // 4, cap + cap // 2, cap + 3 * cap // 4):
            if n <= m:
                return m
        cap *= 2


@functools.partial(jax.jit, static_argnames=("cap", "as_int16"))
def gather_values(flat_values, idx, *, cap: int, as_int16: bool):
    """Compact ``flat_values`` (int32) at ``idx`` ((cap,) int32, padded with
    0) into a (cap,) vector, optionally narrowed to int16."""
    v = jnp.take(flat_values, idx)
    return v.astype(jnp.int16) if as_int16 else v


def pack_bitmap(bits):
    """Device-side: boolean (..., N) with N % 8 == 0 -> packed uint8."""
    n = bits.shape[-1]
    b = bits.reshape(*bits.shape[:-1], n // 8, 8).astype(jnp.uint8)
    weights = (1 << jnp.arange(7, -1, -1, dtype=jnp.uint8)).astype(jnp.uint8)
    return (b * weights).sum(axis=-1, dtype=jnp.uint8)


def host_bitmap_positions(bitmap_bytes: np.ndarray) -> np.ndarray:
    """Host-side: packed uint8 bitmap -> int32 indices of set bits (in
    MSB-first order, matching :func:`pack_bitmap`).

    Two-level: locate nonzero BYTES first (typical density well under
    30%), then expand bits only for those — several times faster than
    unpacking the whole bitmap."""
    flat = bitmap_bytes.reshape(-1)
    nzb = np.flatnonzero(flat)
    if nzb.size == 0:
        return np.zeros(0, np.int32)
    bits = np.unpackbits(flat[nzb]).reshape(-1, 8).astype(bool)
    base = (nzb.astype(np.int64) * 8)[:, None] + np.arange(8)
    return base[bits].astype(np.int32)


def pad_index(idx: np.ndarray, cap: int, fill: int) -> np.ndarray:
    out = np.full(cap, fill, np.int32)
    out[: idx.size] = idx
    return out


# ---------------------------------------------------------------------------
# Rice-coded value exchange (device packs, host C++ decodes)
# ---------------------------------------------------------------------------

RICE_ESC = 20          # quotients >= ESC escape to 32 raw bits
RICE_HEADER_WORDS = 2  # words[0] = total payload bits, words[1] = k


@functools.partial(jax.jit, static_argnames=("cap",))
def rice_pack(vals, nnz, *, cap: int):
    """Rice/Golomb-pack the first ``nnz`` signed values of a (cap,) int32
    vector into a self-describing uint32 word buffer.

    Layout: words[0] = total payload bits, words[1] = rice parameter k,
    then LSB-first bit stream: per value, zigzag z -> min(z>>k, ESC) one
    bits; if the quotient escaped, 32 raw bits of z follow the ESC ones,
    else a zero terminator then k remainder bits.  Bit packing is a pure
    cumsum + disjoint-bit scatter-add (element work scales with nnz).
    """
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < nnz
    v = jnp.where(valid, vals.astype(jnp.int32), 0)
    z = ((v << 1) ^ (v >> 31)).astype(jnp.uint32)  # zigzag

    # Rice parameter from the mean of valid values (standard estimate);
    # clamped so every non-escape code fits 32 bits (q + 1 + k <= 32 with
    # q < ESC) — the whole packer then runs in pure uint32 (jax x64 off).
    mean = z.astype(jnp.float32).sum() / jnp.maximum(nnz, 1).astype(jnp.float32)
    k = jnp.clip(jnp.floor(jnp.log2(mean + 1.0)), 0,
                 31 - RICE_ESC).astype(jnp.uint32)

    q = (z >> k).astype(jnp.int32)
    esc = q >= RICE_ESC
    lens = jnp.where(valid,
                     jnp.where(esc, RICE_ESC + 32, q + 1 + k.astype(jnp.int32)),
                     0)
    off = jnp.cumsum(lens) - lens  # exclusive
    total_bits = off[-1] + lens[-1]

    one = jnp.uint32(1)
    qq = jnp.minimum(q, RICE_ESC).astype(jnp.uint32)
    ones = (one << qq) - one  # qq <= 20 < 32
    rem = z & ((one << k) - one)
    # code split into (lo: bits 0-31, hi: bits 32+); normal codes are
    # lo-only by the k clamp; escapes put z's low 12 bits in lo.
    lo = jnp.where(esc, ones | (z << RICE_ESC), ones | (rem << (qq + 1)))
    hi = jnp.where(esc, z >> (32 - RICE_ESC), jnp.uint32(0))

    sh = (off & 31).astype(jnp.uint32)
    w = (off >> 5) + RICE_HEADER_WORDS
    inv = jnp.where(sh == 0, jnp.uint32(0), jnp.uint32(32) - sh)
    spill = lambda x: jnp.where(sh == 0, jnp.uint32(0), x >> inv)
    upd_w = jnp.concatenate([w, w + 1, w + 1, w + 2])
    upd_v = jnp.concatenate([
        lo << sh, spill(lo), hi << sh, spill(hi)])
    valid4 = jnp.concatenate([valid] * 4)
    n_words = RICE_HEADER_WORDS + cap * 2 + 4
    words = jnp.zeros(n_words, jnp.uint32)
    # invalid lanes carry upd_v == 0, but scatter them past the end anyway
    # (-1 would WRAP onto the last word, not drop)
    words = words.at[jnp.where(valid4, upd_w, n_words)].add(upd_v,
                                                            mode="drop")
    words = words.at[0].set(total_bits.astype(jnp.uint32))
    words = words.at[1].set(k)
    return words


def rice_bound_words(nnz: int) -> int:
    """Words to fetch so the payload fits in one transfer for typical data
    (~<=12 bits/value); callers re-fetch the tail in the rare overflow."""
    return RICE_HEADER_WORDS + bucket_count(max(1, (nnz * 12) // 32 + 2))


# ---------------------------------------------------------------------------
# Fully device-side exchange: compaction + paired Rice streams
# ---------------------------------------------------------------------------
#
# The round-1 exchange still moved two raw legs across the link: the packed
# significance bitmap down (1 bit per grid coefficient, both layers) and the
# int32 index vector back up.  Both are redundant — the positions of the
# significant coefficients ARE derivable on device.  Here the device
# compacts (position, value) pairs itself (one cumsum-backed ``nonzero`` +
# one gather) and Rice-codes the position GAPS and the values into a single
# self-describing uint32 buffer, so the whole encode-direction exchange is
# two transfers: the scalar outputs (which size the second fetch exactly)
# and the compressed pair buffer.  ~1 byte per significant coefficient
# replaces ~(grid/8 + 6*nnz) bytes, and the index upload disappears.

RICE_PAIR_HEADER_WORDS = 4  # [gap_bits, gap_k, val_bits, val_ks_packed]

# Subband-class count for the classed value stream: wavelet magnitudes vary
# by orders of magnitude across decomposition levels, so the value stream
# codes each coefficient with its class's Rice parameter (saves ~4 bits per
# value on ERA5 data vs one global k).  The class of a padded-grid position
# is integer-exact on both sides: cls = clip(min(lr, lc), 0, 7) with
# lr = floor(log2(hp // (r+1))) (and lc likewise) — 0 = finest bands.
RICE_NUM_CLASSES = 8


def _floor_log2_int(t):
    """floor(log2(t)) for positive int32, exact (t fits float32 exactly
    below 2^24 and log2 of powers of two is IEEE-exact)."""
    return jnp.floor(jnp.log2(jnp.maximum(t, 1).astype(jnp.float32))
                     ).astype(jnp.int32)


def coeff_class(pos, hp: int, wp: int):
    """Subband class of flat positions into a (..., Hp, Wp) grid (device)."""
    r = (pos // wp) % hp
    c = pos % wp
    lr = _floor_log2_int(hp // (r + 1))
    lc = _floor_log2_int(wp // (c + 1))
    return jnp.clip(jnp.minimum(lr, lc), 0, RICE_NUM_CLASSES - 1)


def coeff_class_host(pos: np.ndarray, hp: int, wp: int) -> np.ndarray:
    """Host mirror of :func:`coeff_class` (same integer-exact formula)."""
    r = (pos // wp) % hp
    c = pos % wp
    lr = np.floor(np.log2(np.maximum(hp // (r + 1), 1))).astype(np.int64)
    lc = np.floor(np.log2(np.maximum(wp // (c + 1), 1))).astype(np.int64)
    return np.clip(np.minimum(lr, lc), 0, RICE_NUM_CLASSES - 1).astype(
        np.uint8)


@functools.partial(jax.jit, static_argnames=("cap",))
def rice_pack_pair(a_vals, b_vals, nnz, *, cap: int, a_cls=None,
                   b_cls=None):
    """Rice-pack TWO signed int32 (cap,) vectors (first ``nnz`` entries
    valid) into one uint32 buffer.

    Layout: words[0..3] = [bits_a, k_a_or_ks, bits_b, ks_b_packed]; payload
    region starts at word 4 with stream a at bit 0 and stream b at the
    first WORD boundary after stream a (so the host can hand each stream
    to the native Rice readers by prepending a synthetic 2-word header).
    Same per-value code as :func:`rice_pack`.

    ``a_cls``/``b_cls``: optional per-element subband class — each class
    gets its own Rice parameter (packed 4 bits each into the header word).
    Without it, the header word holds the single k for that stream.
    """
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < nnz
    nnzf = jnp.maximum(nnz, 1).astype(jnp.float32)
    one = jnp.uint32(1)

    def plan(v, cls=None):
        v = jnp.where(valid, v.astype(jnp.int32), 0)
        z = ((v << 1) ^ (v >> 31)).astype(jnp.uint32)
        if cls is None:
            mean = z.astype(jnp.float32).sum() / nnzf
            k = jnp.clip(jnp.floor(jnp.log2(mean + 1.0)), 0,
                         31 - RICE_ESC).astype(jnp.uint32)
            kvec = k
            khdr = k
        else:
            zf = z.astype(jnp.float32)
            # Unrolled masked sums: segment_sum lowers to a scatter-add;
            # eight full-row masked reductions are plain vector work.
            zf_valid = jnp.where(valid, zf, 0.0)
            vf = valid.astype(jnp.float32)
            csum = jnp.stack([
                jnp.where(cls == c, zf_valid, 0.0).sum()
                for c in range(RICE_NUM_CLASSES)])
            ccnt = jnp.stack([
                jnp.where(cls == c, vf, 0.0).sum()
                for c in range(RICE_NUM_CLASSES)])
            cmean = csum / jnp.maximum(ccnt, 1.0)
            ks = jnp.clip(jnp.floor(jnp.log2(cmean + 1.0)), 0,
                          31 - RICE_ESC).astype(jnp.uint32)
            kvec = ks[cls]
            khdr = (ks << (4 * jnp.arange(RICE_NUM_CLASSES,
                                          dtype=jnp.uint32))).sum()
        q = (z >> kvec).astype(jnp.int32)
        esc = q >= RICE_ESC
        lens = jnp.where(
            valid,
            jnp.where(esc, RICE_ESC + 32, q + 1 + kvec.astype(jnp.int32)), 0)
        qq = jnp.minimum(q, RICE_ESC).astype(jnp.uint32)
        ones = (one << qq) - one
        rem = z & ((one << kvec) - one)
        lo = jnp.where(esc, ones | (z << RICE_ESC), ones | (rem << (qq + 1)))
        hi = jnp.where(esc, z >> (32 - RICE_ESC), jnp.uint32(0))
        return khdr, lens, lo, hi

    ka, lens_a, lo_a, hi_a = plan(a_vals, a_cls)
    kb, lens_b, lo_b, hi_b = plan(b_vals, b_cls)
    off_a = jnp.cumsum(lens_a) - lens_a
    bits_a = off_a[-1] + lens_a[-1]
    start_b = ((bits_a + 31) >> 5) << 5  # word-aligned
    off_b = jnp.cumsum(lens_b) - lens_b + start_b
    bits_b = off_b[-1] + lens_b[-1] - start_b

    # Capacity: both streams are <= 52 bits/value + one alignment word.
    n_words = RICE_PAIR_HEADER_WORDS + (104 * cap) // 32 + 8
    words = jnp.zeros(n_words, jnp.uint32)

    def legs(off, lo, hi):
        # Invalid elements carry z = 0 (plan() masks them), so lo/hi are
        # exactly 0 and their adds are no-ops — no index redirection
        # needed, which keeps every leg's index vector monotone.
        sh = (off & 31).astype(jnp.uint32)
        w = (off >> 5) + RICE_PAIR_HEADER_WORDS
        inv = jnp.where(sh == 0, jnp.uint32(0), jnp.uint32(32) - sh)
        spill = lambda x: jnp.where(sh == 0, jnp.uint32(0), x >> inv)
        return w, lo << sh, spill(lo) | (hi << sh), spill(hi)

    # Three SORTED scatter-adds covering BOTH streams (stream b's word
    # offsets all follow stream a's, so the concatenated index vector
    # stays non-decreasing): the sorted hint plus halved scatter-op count
    # beats per-stream 4-way concatenated scatters.
    # spill(lo) and hi<<sh land on disjoint bits of word w+1, so their OR
    # folds into one update.
    wa, a0, a1, a2 = legs(off_a, lo_a, hi_a)
    wb, b0, b1, b2 = legs(off_b, lo_b, hi_b)
    w2 = jnp.concatenate([wa, wb])
    words = words.at[w2].add(jnp.concatenate([a0, b0]), mode="drop",
                             indices_are_sorted=True)
    words = words.at[w2 + 1].add(jnp.concatenate([a1, b1]), mode="drop",
                                 indices_are_sorted=True)
    words = words.at[w2 + 2].add(jnp.concatenate([a2, b2]), mode="drop",
                                 indices_are_sorted=True)
    words = words.at[0].set(bits_a.astype(jnp.uint32))
    words = words.at[1].set(ka)
    words = words.at[2].set(bits_b.astype(jnp.uint32))
    words = words.at[3].set(kb)
    words_needed = (RICE_PAIR_HEADER_WORDS + (start_b >> 5)
                    + ((bits_b + 31) >> 5))
    return words, words_needed.astype(jnp.int32)


@functools.lru_cache(maxsize=1)
def _setbit_lut_np() -> np.ndarray:
    """(256*8,) int32: entry [b*8 + r] = index (MSB-first) of the r-th set
    bit of byte b, or 7 when r >= popcount(b) (matching the clamped select
    the unpacked formulation produced)."""
    lut = np.full(256 * 8, 7, np.int32)
    for b in range(256):
        r = 0
        for t in range(8):
            if (b >> (7 - t)) & 1:
                lut[b * 8 + r] = t
                r += 1
    return lut


def _SETBIT_LUT():
    return jnp.asarray(_setbit_lut_np())


@functools.partial(jax.jit, static_argnames=("cap", "hw"))
def compact_rice_exchange(vals_flat, sig_bytes, *, cap: int, hw=None):
    """Device-side encode-direction exchange: flat int32 coefficient vector
    + its packed significance bitmap -> (words, words_needed).

    Dispatched as its OWN program after the encode program reported nnz, so
    the caller buckets ``cap`` from the actual significance count.  ``cap``
    must be >= the true nnz; the compacted tail is garbage otherwise.

    Position extraction is two-level to avoid any dense-length scan
    beyond one popcount: per-64-coefficient block counts (popcount of the
    bitmap the encode program already produced) -> small block cumsum ->
    per-query block via sorted search -> in-block byte/bit rank selection.
    Every op after the popcount is cap- or block-count-sized, so the
    program's cost scales with the significant count, not the grid.
    """
    nb = sig_bytes.shape[0]
    pad = (-nb) % 8
    if pad:
        sig_bytes = jnp.concatenate(
            [sig_bytes, jnp.zeros(pad, sig_bytes.dtype)])
    blocks = (nb + pad) // 8
    pc = jax.lax.population_count(sig_bytes).astype(jnp.int32)
    pcb = pc.reshape(blocks, 8)
    psum_b = jnp.cumsum(pcb.sum(axis=1))              # (blocks,)
    nnz = psum_b[-1]

    j = jnp.arange(1, cap + 1, dtype=jnp.int32)
    # method='sort': queries are pre-sorted, so one merge-sort replaces
    # the default per-query binary-search gathers.
    blk = jnp.clip(jnp.searchsorted(psum_b, j, method="sort"), 0,
                   blocks - 1).astype(jnp.int32)
    prev = jnp.where(blk > 0, psum_b[jnp.maximum(blk - 1, 0)], 0)
    rank = j - 1 - prev                               # 0-based within block
    # In-block rank selection in TRANSPOSED (8, cap) layout: a (cap, 8)
    # array pads its 8-wide minor dim to the 128-lane tile (16x wasted
    # lanes); keeping cap on the lane axis makes the byte selection eight
    # full-width VPU ops.  The bit within the byte comes from a 256x8
    # "index of r-th set bit (MSB-first)" table — one small gather instead
    # of an 8-wide unpack + cumsum + compare.
    countsT = pcb.T[:, blk]                           # (8, cap)
    ciT = jnp.cumsum(countsT, axis=0)                 # inclusive byte cums
    bi = jnp.minimum((ciT <= rank[None, :]).sum(axis=0), 7)
    sel = lambda m: jnp.where(
        jnp.arange(8, dtype=jnp.int32)[:, None] == bi[None, :], m, 0
    ).sum(axis=0)
    rank_b = rank - (sel(ciT) - sel(countsT))
    byte_val = sig_bytes[blk * 8 + bi]
    bit = _SETBIT_LUT()[byte_val.astype(jnp.int32) * 8
                        + jnp.clip(rank_b, 0, 7)]
    pos = (blk * 64 + bi * 8 + bit).astype(jnp.int32)

    vv = jnp.take(vals_flat, pos)
    prev_pos = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pos[:-1]])
    gaps = pos - prev_pos - 1  # >= 0 in the valid region; padding masked
    # ``hw`` enables the subband-classed streams: values use the class of
    # their own position (~4 bits/value saved), gaps the class of the
    # PREVIOUS position (known to the decoder before it reads the gap —
    # LL gaps are tiny, fine-band gaps huge; ~1.6 bits/gap saved).  The
    # host recomputes both classings from the decoded positions.
    if hw is not None:
        b_cls = coeff_class(pos, hw[0], hw[1])
        prev_ref = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.maximum(pos[:-1], 0)])
        a_cls = coeff_class(prev_ref, hw[0], hw[1])
    else:
        a_cls = b_cls = None
    return rice_pack_pair(gaps, vv, jnp.minimum(nnz, cap), cap=cap,
                          a_cls=a_cls, b_cls=b_cls)


def unpack_rice_ks(word) -> np.ndarray:
    """Inverse of the 4-bit-per-class ks packing in :func:`rice_pack_pair`
    (``khdr = (ks << 4*arange(RICE_NUM_CLASSES)).sum()``)."""
    return np.array([(int(word) >> (4 * i)) & 15
                     for i in range(RICE_NUM_CLASSES)], np.uint8)


def split_rice_pair(head: np.ndarray, nnz: int):
    """Host-side: split a fetched :func:`rice_pack_pair` buffer into the two
    2-word-headered streams ``native.rice_decode`` understands."""
    bits_a, k_a, bits_b, k_b = (int(head[0]), int(head[1]), int(head[2]),
                                int(head[3]))
    gw = (bits_a + 31) // 32
    h = RICE_PAIR_HEADER_WORDS
    stream_a = np.concatenate(
        [np.array([bits_a, k_a], np.uint32), head[h:h + gw]])
    stream_b = np.concatenate(
        [np.array([bits_b, k_b], np.uint32), head[h + gw:]])
    return stream_a, stream_b


# ---------------------------------------------------------------------------
# Byte-granular decode-direction upload (host packs, device unpacks)
# ---------------------------------------------------------------------------
#
# The decode direction originally uploaded a dense significance bitmap
# (1 bit per grid coefficient, both layers) + int16 values — ~6 bytes per
# significant coefficient at typical densities.  Gap + zigzag-value byte
# coding cuts that to ~2 B/coeff: each leg is one uint8 per coefficient
# with a 255 escape marker into a small int32 side array.  The device
# recovers positions with one cumsum and values with one gather — all
# nnz-sized work, no dense-grid leg on the link at all.

BYTE_ESC = 255


def overflow_bucket(n: int) -> int:
    """Pad ladder for the (small) escape side arrays: powers of 4 from 64
    keep the jit-variant count low without 4096-entry minimum padding."""
    cap = 64
    while cap < n:
        cap *= 4
    return cap


def byte_pack_sparse_host(idx: np.ndarray, vals: np.ndarray):
    """Host-side: sorted positions + signed values -> (gaps_u8, gap_ov,
    zvals_u8, val_ov16, val_ov32).

    Gap escapes (255) land in an int32 side array (rare at any realistic
    density).  Value escapes land in a uint16 side array — zigzag values in
    [255, 65535) are the common escape case and cost 1+2 bytes instead of
    1+4; the u16 sentinel 65535 nests into an int32 side array for the
    rare giants."""
    gaps = np.diff(idx.astype(np.int64), prepend=-1) - 1
    gof = gaps >= BYTE_ESC
    g8 = np.where(gof, BYTE_ESC, gaps).astype(np.uint8)
    g_ov = gaps[gof].astype(np.int32)
    v = vals.astype(np.int32)
    z = ((v.astype(np.int64) << 1) ^ (v >> 31)).astype(np.uint32)
    vof = z >= BYTE_ESC
    v8 = np.where(vof, BYTE_ESC, z).astype(np.uint8)
    zo = z[vof]
    nested = zo >= 0xFFFF
    v_ov16 = np.where(nested, 0xFFFF, zo).astype(np.uint16)
    v_ov32 = zo[nested].astype(np.int32)
    return g8, g_ov, v8, v_ov16, v_ov32


def byte_unpack_sparse(g8, g_ov, v8, v_ov16, v_ov32, nnz):
    """Device-side inverse of :func:`byte_pack_sparse_host` -> (idx, vals);
    idx padding is -1 (scatter-drop), traced (jit inside the caller)."""
    cap = g8.shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < nnz
    esc = jnp.uint8(BYTE_ESC)

    gof = (g8 == esc) & valid
    grank = jnp.cumsum(gof.astype(jnp.int32)) - 1
    g = jnp.where(gof, jnp.take(g_ov, jnp.clip(grank, 0, g_ov.shape[0] - 1)),
                  g8.astype(jnp.int32))
    idx = jnp.cumsum(jnp.where(valid, g + 1, 0)) - 1
    idx = jnp.where(valid, idx, -1)

    vof = (v8 == esc) & valid
    vrank = jnp.cumsum(vof.astype(jnp.int32)) - 1
    z16 = jnp.take(v_ov16, jnp.clip(vrank, 0, v_ov16.shape[0] - 1))
    nested = vof & (z16 == jnp.uint16(0xFFFF))
    nrank = jnp.cumsum(nested.astype(jnp.int32)) - 1
    z = jnp.where(
        nested,
        jnp.take(v_ov32, jnp.clip(nrank, 0, v_ov32.shape[0] - 1)),
        jnp.where(vof, z16.astype(jnp.int32), v8.astype(jnp.int32)))
    # un-zigzag with a LOGICAL right shift (z is a uint32 reinterpreted
    # through int32; an arithmetic shift would sign-extend large codes)
    vals = (z.astype(jnp.uint32) >> 1).astype(jnp.int32) ^ -(z & 1)
    return idx, vals


# --- Nibble-tiered upload -------------------------------------------------
#
# Measured on ERA5 exchanges: ~95% of position gaps and ~84% of zigzag
# values fit 4 bits.  The nibble tiering cuts the upload to ~1.3 B per
# significant coefficient (from ~2.3 with plain byte coding): a packed
# nibble primary stream, escaping (sentinel 15) to a u8 tier, then
# (sentinel 255) to a u16 tier, then (sentinel 65535) to int32.  Every
# tier's capacity is a fixed function of ``cap`` (below), so the device
# program has a single static size axis; a batch whose tier counts exceed
# the derived capacities falls back to the byte path (caller checks
# :func:`nibble_fits`).

NIB_ESC = 15


def nib_tier_caps(cap: int, leg: str):
    """(u8, u16, i32) tier capacities derived from the main cap.

    Fixed fractions per leg (measured on ERA5 exchanges: ~5% of gaps and
    ~17% of values escape the nibble tier) — static functions of ``cap``
    so the device program keeps a single size axis; batches beyond these
    rates fall back to the byte path."""
    if leg == "gap":
        return cap // 8 + 4, cap // 64 + 4, cap // 256 + 16
    return cap // 4 + 4, cap // 24 + 4, cap // 256 + 16


def _tier_split(x: np.ndarray):
    nib = np.where(x >= NIB_ESC, NIB_ESC, x).astype(np.uint8)
    e1 = x[x >= NIB_ESC]
    b8 = np.where(e1 >= 0xFF, 0xFF, e1).astype(np.uint8)
    e2 = e1[e1 >= 0xFF]
    b16 = np.where(e2 >= 0xFFFF, 0xFFFF, e2).astype(np.uint16)
    b32 = e2[e2 >= 0xFFFF].astype(np.int64).astype(np.uint32).astype(
        np.int32)
    return nib, b8, b16, b32


def nibble_pack_sparse_host(idx: np.ndarray, vals: np.ndarray):
    """Host-side: sorted positions + signed values -> per-leg tier arrays
    ((gap_nib, gap8, gap16, gap32), (val_nib, val8, val16, val32))."""
    gaps = np.diff(idx.astype(np.int64), prepend=-1) - 1
    v = vals.astype(np.int32)
    z = ((v.astype(np.int64) << 1) ^ (v >> 31))
    return _tier_split(gaps), _tier_split(z)


def nibble_fits(tiers, cap: int, leg: str) -> bool:
    c8, c16, c32 = nib_tier_caps(cap, leg)
    _, b8, b16, b32 = tiers
    return b8.size <= c8 and b16.size <= c16 and b32.size <= c32


def pack_nibbles(nib: np.ndarray, cap: int) -> np.ndarray:
    """(n,) uint8 nibbles -> ((cap+1)//2,) packed bytes (low nibble first)."""
    out = np.zeros(2 * ((cap + 1) // 2), np.uint8)
    out[: nib.size] = nib
    return (out[0::2] | (out[1::2] << 4)).astype(np.uint8)


def _untier(nibs_packed, s8, s16, s32, valid):
    i = jnp.arange(valid.shape[0], dtype=jnp.int32)
    byte = jnp.take(nibs_packed, i >> 1)
    nib = jnp.where((i & 1) == 1, byte >> 4, byte & 0xF).astype(jnp.int32)
    e1 = (nib == NIB_ESC) & valid
    r1 = jnp.cumsum(e1.astype(jnp.int32)) - 1
    v8 = jnp.take(s8, jnp.clip(r1, 0, s8.shape[0] - 1))
    e2 = e1 & (v8 == jnp.uint8(0xFF))
    r2 = jnp.cumsum(e2.astype(jnp.int32)) - 1
    v16 = jnp.take(s16, jnp.clip(r2, 0, s16.shape[0] - 1))
    e3 = e2 & (v16 == jnp.uint16(0xFFFF))
    r3 = jnp.cumsum(e3.astype(jnp.int32)) - 1
    v32 = jnp.take(s32, jnp.clip(r3, 0, s32.shape[0] - 1))
    return jnp.where(
        e3, v32,
        jnp.where(e2, v16.astype(jnp.int32),
                  jnp.where(e1, v8.astype(jnp.int32), nib)))


def nibble_unpack_sparse(gap_tiers, val_tiers, nnz):
    """Device-side inverse of :func:`nibble_pack_sparse_host` ->
    (idx, vals); idx padding -1.  ``*_tiers`` = (nibs_packed, s8, s16, s32)
    device arrays; traced (jit inside the caller)."""
    cap = 2 * gap_tiers[0].shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < nnz
    g = _untier(*gap_tiers, valid)
    idx = jnp.cumsum(jnp.where(valid, g + 1, 0)) - 1
    idx = jnp.where(valid, idx, -1)
    z = _untier(*val_tiers, valid)
    vals = (z.astype(jnp.uint32) >> 1).astype(jnp.int32) ^ -(z & 1)
    return idx, vals


# --- Blocked-Rice upload ----------------------------------------------------
#
# The nibble-tier upload ships the FULL padded tier capacities (~1.9 B per
# significant coefficient with bucketing) because the device program needs
# static shapes.  Rice coding the same (gap, zigzag-value) pair reaches
# ~1.0 B/coeff — near the downlink's entropy — but a Rice stream is
# bit-serial.  The blocked form restores device parallelism: the host packs
# ELEMENT BLOCKS of ``RICE_BLOCK`` entries as independent bit regions (each
# with its own Rice parameter k, adapted per block) and uploads a restart
# table [bit offset, k] per lane plus the previous position per gap block;
# the device then decodes all gap blocks AND all value blocks as parallel
# lanes of one lax.scan over RICE_BLOCK steps — one code per lane per step.
# Same code family as :func:`rice_pack`: q unary ones, zero terminator, k
# remainder bits; quotients >= RICE_ESC escape to 32 raw bits after the ESC
# ones (no terminator).  Gaps are coded RAW (not zigzagged — they are
# non-negative); values are zigzagged.

RICE_BLOCK = 128


def rice_block_bucket(n: int) -> int:
    """Pad ladder for lane/word counts: 1/8 steps from 64 (~3% average
    padding; the 4096 floor and 25% steps of :func:`bucket_count` would
    swamp the upload with zeros).  Every rung is a multiple of 8, which
    keeps the fused buffer's u16/nibble sections 4-byte aligned."""
    cap = 64
    while True:
        for i in range(8):
            m = cap + (cap // 8) * i
            if n <= m:
                return m
        cap *= 2


def _rice_k_for(z_sum: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Per-block Rice parameter from the block mean (k = floor(log2(mean+1)),
    the standard estimate), clamped so q+1+k <= 31 for non-escapes."""
    mean = z_sum / np.maximum(cnt, 1)
    return np.clip(np.floor(np.log2(mean + 1.0)), 0,
                   31 - RICE_ESC).astype(np.int32)


def rice_block_pack_host(idx: np.ndarray, vals: np.ndarray,
                         block: int = RICE_BLOCK):
    """Host-side packer: sorted int64 positions + signed int32 values ->
    (words_u32, lens_g_u16, lens_v_u16, k_packed_u8, base_pos_i32,
    n_blocks).

    Lane layout: lanes [0, nb) decode gaps (raw, non-negative), lanes
    [nb, 2nb) decode zigzag values.  The per-lane bit offsets are NOT
    shipped — the device derives them by cumsum of the per-block bit
    LENGTHS (u16: 128 codes x 52 bits max = 6656 < 2^16), with the value
    region starting right after the gap region.  ``k_packed`` holds both
    Rice parameters per block (gap k low nibble, value k high);
    ``base_pos`` (nb,) is the position preceding each gap block (-1 for
    block 0)."""
    n = int(idx.size)
    nb = max(1, -(-n // block))
    gaps = np.diff(idx.astype(np.int64), prepend=-1) - 1
    v = vals.astype(np.int32)
    zv = ((v.astype(np.int64) << 1) ^ (v >> 31)).astype(np.uint64)
    zg = gaps.astype(np.uint64)

    edges = np.arange(nb) * block
    k_g = _rice_k_for(np.add.reduceat(zg, edges) if n else np.zeros(nb),
                      np.diff(np.append(edges, n)))
    k_v = _rice_k_for(np.add.reduceat(zv, edges) if n else np.zeros(nb),
                      np.diff(np.append(edges, n)))

    def plan(z, k_blk):
        k = np.repeat(k_blk, block)[:n].astype(np.uint64)
        q = (z >> k).astype(np.int64)
        esc = q >= RICE_ESC
        lens = np.where(esc, RICE_ESC + 32, q + 1 + k.astype(np.int64))
        qq = np.minimum(q, RICE_ESC).astype(np.uint64)
        ones = (np.uint64(1) << qq) - np.uint64(1)
        rem = z & ((np.uint64(1) << k) - np.uint64(1))
        code = np.where(esc, ones | ((z & np.uint64(0xFFFFFFFF)) << np.uint64(RICE_ESC)),
                        ones | (rem << (qq + np.uint64(1))))
        return lens.astype(np.int64), code

    lens_g, code_g = plan(zg, k_g)
    lens_v, code_v = plan(zv, k_v)
    lens = np.concatenate([lens_g, lens_v])
    code = np.concatenate([code_g, code_v])
    off = np.cumsum(lens) - lens
    total_bits = int(off[-1] + lens[-1]) if n else 0
    n_words = total_bits // 32 + 3

    # Disjoint-bit scatter via bincount (float64 sums are exact: disjoint
    # bits within a word never carry past 2^32).
    lo = code & np.uint64(0xFFFFFFFF)
    hi = code >> np.uint64(32)
    sh = (off & 31).astype(np.uint64)
    w = (off >> 5).astype(np.int64)
    legs_w = np.concatenate([w, w + 1, w + 1, w + 2])
    l1 = lo << sh
    l2 = hi << sh
    legs_v = np.concatenate([l1 & np.uint64(0xFFFFFFFF), l1 >> np.uint64(32),
                             l2 & np.uint64(0xFFFFFFFF), l2 >> np.uint64(32)])
    words = np.bincount(legs_w, weights=legs_v.astype(np.float64),
                        minlength=n_words).astype(np.int64).astype(
                            np.uint32) if n else np.zeros(n_words, np.uint32)

    lane_e = np.arange(nb) * block
    if n:
        blk_edges = np.append(lane_e, n)
        lens_bg = np.add.reduceat(lens_g, lane_e)
        lens_bv = np.add.reduceat(lens_v, lane_e)
        del blk_edges
    else:
        lens_bg = lens_bv = np.zeros(nb, np.int64)
    k_packed = (k_g.astype(np.uint8) | (k_v.astype(np.uint8) << 4))
    base_pos = np.where(lane_e > 0, idx[np.maximum(lane_e - 1, 0)] if n
                        else -1, -1).astype(np.int64)
    return (words, lens_bg.astype(np.uint16), lens_bv.astype(np.uint16),
            k_packed, base_pos.astype(np.int32), nb)


def rice_block_unpack(words, lens_g, lens_v, k_packed, base_pos, nnz,
                      *, n_blocks: int, block: int = RICE_BLOCK):
    """Device-side inverse of :func:`rice_block_pack_host` -> (idx, vals);
    idx padding -1.  Traced (jit inside the caller).

    One lax.scan over ``block`` steps; lanes = 2 * n_blocks (gap blocks
    then value blocks).  Each step decodes one Rice code per lane from a
    64-bit window gathered at the lane's running bit offset.  Lane start
    offsets are derived here by cumsum of the u16 block bit lengths
    (padded lanes carry length 0, so the value region's start — the total
    gap bits — is unaffected by padding)."""
    nb = n_blocks
    nw = words.shape[0]
    lanes = 2 * nb
    lg = lens_g.astype(jnp.int32)
    lv = lens_v.astype(jnp.int32)
    cg = jnp.cumsum(lg)
    off_g = cg - lg
    off_v = cg[-1] + jnp.cumsum(lv) - lv
    off_lane = jnp.concatenate([off_g, off_v])
    kp = k_packed.astype(jnp.uint32)
    k_lane = jnp.concatenate([kp & 15, kp >> 4])
    k = k_lane.astype(jnp.uint32)
    kmask = (jnp.uint32(1) << k) - jnp.uint32(1)
    lane_blk = jnp.arange(lanes, dtype=jnp.int32) % nb
    lane_valid_n = jnp.clip(nnz - lane_blk * block, 0, block)
    one = jnp.uint32(1)

    def step(carry, t):
        off, pos = carry
        sh = (off & 31).astype(jnp.uint32)
        wi = jnp.clip(off >> 5, 0, nw - 3)
        w0 = jnp.take(words, wi)
        w1 = jnp.take(words, wi + 1)
        w2 = jnp.take(words, wi + 2)
        shl = (jnp.uint32(32) - sh) & jnp.uint32(31)
        up1 = jnp.where(sh == 0, jnp.uint32(0), w1 << shl)
        up2 = jnp.where(sh == 0, jnp.uint32(0), w2 << shl)
        lo = (w0 >> sh) | up1
        hi = (w1 >> sh) | up2
        y = ~lo
        q = jnp.where(y == 0, jnp.uint32(32),
                      jax.lax.population_count((y & (jnp.uint32(0) - y))
                                               - one))
        esc = q >= RICE_ESC
        qn = jnp.minimum(q, jnp.uint32(30))
        rem = (lo >> (qn + one)) & kmask
        zn = (qn << k) | rem
        ze = (lo >> jnp.uint32(RICE_ESC)) | (hi << jnp.uint32(32 - RICE_ESC))
        z = jnp.where(esc, ze, zn)
        ln = jnp.where(esc, jnp.uint32(RICE_ESC + 32), qn + one + k)
        valid = t < lane_valid_n
        off = off + jnp.where(valid, ln.astype(jnp.int32), 0)
        gap_half = jnp.arange(lanes, dtype=jnp.int32) < nb
        newpos = pos + z.astype(jnp.int32) + 1
        pos = jnp.where(gap_half & valid, newpos, pos)
        emit = jnp.where(gap_half, pos, z.astype(jnp.int32))
        emit = jnp.where(valid, emit, -1)
        return (off, pos), emit

    init = (off_lane.astype(jnp.int32),
            jnp.concatenate([base_pos.astype(jnp.int32),
                             jnp.zeros(nb, jnp.int32)]))
    _, ys = jax.lax.scan(step, init,
                         jnp.arange(block, dtype=jnp.int32))
    # ys: (block, 2nb) -> element order (lane-major within each half)
    idx = ys[:, :nb].T.reshape(-1)
    zv = ys[:, nb:].T.reshape(-1)
    valid = jnp.arange(nb * block, dtype=jnp.int32) < nnz
    idx = jnp.where(valid, idx, -1)
    vals = ((zv.astype(jnp.uint32) >> 1).astype(jnp.int32)
            ^ -(zv & 1))
    return idx, vals


@functools.partial(jax.jit, static_argnames=("n",))
def unpack_bitmap(packed, *, n: int):
    """Device-side inverse of :func:`pack_bitmap`: packed uint8 (N//8,) ->
    bool (n,) in MSB-first order."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[:, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(-1)[:n] != 0
