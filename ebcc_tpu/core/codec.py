"""Host orchestration: the public codec API.

API parity with the reference C API (``src/ebcc_codec.h:41-49``):

  =====================  =========================================
  reference              this module
  =====================  =========================================
  ``ebcc_encode``        :func:`encode`
  ``ebcc_decode``        :func:`decode`
  ``ebcc_encode_chunking``        :func:`encode_chunked`
  ``ebcc_encode_chunking_compat`` :func:`encode_chunked_compat`
  ``ebcc_decode_chunking``        :func:`decode_chunked`
  ``print_config``       ``CodecConfig.describe``
  ``free_buffer``        (garbage collector)
  =====================  =========================================

Architecture: the reference encodes chunks one at a time in a serial loop
(ebcc_codec.c:1007-1046); here ALL equally-shaped chunks are gathered into a
batch and pushed through one jitted device program (``core.kernels``), with
host work limited to stream assembly + entropy coding.  The same batched path
backs the sharded multi-device encoder in ``ebcc_tpu.parallel``.
"""

from __future__ import annotations

import functools
import os
import threading as _threading_mod
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as cfg
from ..config import CodecConfig, EncodeOptions
from ..utils.logging import TRACE, logger, set_level_from_env, trace
from ..utils.timing import stage
from . import entropy, kernels, stream, transfer

# Residual payloads at or below this many compressed bytes are dropped
# (parity: reference drop rule `coeffs_size <= 16`, ebcc_codec.c:811).
RESIDUAL_DROP_BYTES = 16

# Chunk batches are processed in device-side slices of this many chunks to
# bound HBM footprint; shapes are padded to the slice size to avoid
# recompilation churn.
DEFAULT_MAX_BATCH = 32


def _padded_hw(h: int, w: int, levels_max: int) -> Tuple[int, int]:
    mult = 1 << levels_max
    return (-(-h // mult)) * mult, (-(-w // mult)) * mult


def _layout(dims: Sequence[int]) -> Tuple[int, int, int]:
    """Map logical (d0, d1, d2) onto (n_frames, height, width).

    The reference flattens leading dims into one tall image and lets J2K tile
    it (ebcc_codec.c:661-669); frames here are independent batch entries, so
    d0 becomes the batch axis whenever d1 is a valid frame height.  Only when
    d1 is below the minimum frame dim do we merge leading dims (and then the
    reference's [32, 2047] flattened-height validation applies).
    """
    d0, d1, d2 = dims
    if not (cfg.MIN_INTERNAL_IMAGE_DIM <= d2 <= cfg.MAX_INTERNAL_IMAGE_DIM):
        raise ValueError(
            f"width {d2} outside [{cfg.MIN_INTERNAL_IMAGE_DIM}, "
            f"{cfg.MAX_INTERNAL_IMAGE_DIM}]")
    if cfg.MIN_INTERNAL_IMAGE_DIM <= d1 <= cfg.MAX_INTERNAL_IMAGE_DIM:
        return d0, d1, d2
    flat = d0 * d1
    if not (cfg.MIN_INTERNAL_IMAGE_DIM <= flat <= cfg.MAX_INTERNAL_IMAGE_DIM):
        raise ValueError(
            f"invalid dims {tuple(dims)}: product(dims[0:2]) and dims[2] must "
            f"be within [{cfg.MIN_INTERNAL_IMAGE_DIM}, "
            f"{cfg.MAX_INTERNAL_IMAGE_DIM}]")
    return 1, flat, d2


def build_layer_payload(v, stored_cut: int, cut: int, num_planes: int):
    """Assemble one layer's raw payload for one chunk from its dense signed
    kept-values.

    v: (D0, Hp, Wp) int32, values = sign * (|q| >> stored_cut) with
    stored_cut <= cut.  The payload is the dense bitplane stack of the
    magnitudes at ``cut`` — rows [top, num_planes - cut), MSB first — plus
    the sign plane masked to coefficients significant at the cut (exactly
    the ETPU stream layout; see core.stream).
    Returns (payload_bytes, top, kept).
    """
    mag = np.abs(v) >> (cut - stored_cut)
    mx = int(mag.max()) if mag.size else 0
    if mx == 0:
        return b"", min(num_planes - cut, 255), 0
    msb = mx.bit_length()
    kept = msb
    top = num_planes - cut - msb
    parts = [
        np.packbits(((mag >> s) & 1).astype(np.uint8), axis=-1).tobytes()
        for s in range(msb - 1, -1, -1)
    ]
    signs = np.packbits(((v < 0) & (mag > 0)).astype(np.uint8), axis=-1)
    return b"".join(parts) + signs.tobytes(), top, kept


def _native_packer():
    """Native module for C-speed sparse->planes payload packing, or None
    (numpy fallback).  EBCC_NO_NATIVE_PACK=1 forces the fallback (tests)."""
    if os.environ.get("EBCC_NO_NATIVE_PACK"):
        return None
    from .. import native

    try:
        native.load()
        return native
    except Exception:
        return None


def build_layer_payload_sparse(pos, vals, shape, stored_cut: int, cut: int,
                               num_planes: int):
    """:func:`build_layer_payload` computed straight from the sparse
    exchange pair — identical bytes, but element work scales with the
    significant count instead of the dense grid (the dense scatter +
    per-plane packbits cost ~dense-size work per CANDIDATE, and the
    assembler evaluates up to three candidates per chunk).

    pos: int32 flat positions within the chunk's (D0, Hp, Wp) space;
    vals: signed kept-values at ``stored_cut``; shape: (D0, Hp, Wp).
    Returns (payload_bytes, top, kept).
    """
    d0v, hpv, wpv = shape
    # Both packers assume byte-aligned rows (flat pos>>3 byte math in the
    # fallback, explicit guard in C); the padded grid guarantees wp % 8 == 0
    # for every supported level count, so a violation here is a geometry
    # bug — fail loudly instead of emitting a mispacked payload.
    if wpv % 8 != 0:
        raise ValueError(f"padded width {wpv} not a multiple of 8")
    shift = cut - stored_cut
    if vals.size == 0:
        return b"", min(num_planes - cut, 255), 0
    v32 = np.ascontiguousarray(vals, dtype=np.int32)
    mags = np.abs(v32) >> shift
    mx = int(mags.max())
    if mx == 0:
        return b"", min(num_planes - cut, 255), 0
    msb = mx.bit_length()
    top = num_planes - cut - msb
    nm = _native_packer()
    if nm is not None:
        return (nm.sparse_to_planes(pos, v32, shift, msb, d0v, hpv, wpv),
                top, msb)
    plane_bytes = d0v * hpv * (wpv // 8)
    payload = np.zeros((msb + 1) * plane_bytes, np.uint8)
    byte = (pos >> 3).astype(np.int64)
    mask = (1 << (7 - (pos & 7))).astype(np.uint8)
    for s in range(msb):
        sel = ((mags >> s) & 1).astype(bool)
        row = msb - 1 - s
        np.bitwise_or.at(payload, row * plane_bytes + byte[sel], mask[sel])
    sel = (v32 < 0) & (mags > 0)
    np.bitwise_or.at(payload, msb * plane_bytes + byte[sel], mask[sel])
    return payload.tobytes(), top, msb


def _entropy_encode(payload: bytes, backend: int, level: int, meta=None):
    """-> (compressed, backend_id_used); resolves the AUTO pseudo-backend
    by trying both real backends."""
    if not payload:
        return b"", (entropy.BACKEND_ZSTD
                     if backend == entropy.BACKEND_AUTO else backend)
    return entropy.compress_best(payload, backend, level, meta)


class _SparseBatch:
    """Host-side view of a batch's sparse coefficient exchange (see
    core.transfer): sorted flat indices into the (layer, chunk, D0, Hp, Wp)
    coefficient space + signed kept-values."""

    def __init__(self, idx: np.ndarray, vals: np.ndarray, b: int, d0: int,
                 hp: int, wp: int):
        self.idx = idx
        self.vals = vals
        self.b = b
        self.sc = d0 * hp * wp
        self.shape = (d0, hp, wp)
        bounds = np.arange(2 * b + 1, dtype=np.int64) * self.sc
        self.splits = np.searchsorted(idx, bounds)

    def dense(self, layer: int, i: int) -> np.ndarray:
        """Dense (D0, Hp, Wp) int32 signed kept-values of one chunk/layer."""
        j = layer * self.b + i
        lo, hi = self.splits[j], self.splits[j + 1]
        out = np.zeros(self.sc, np.int32)
        out[self.idx[lo:hi] - j * self.sc] = self.vals[lo:hi]
        return out.reshape(self.shape)

    def pair(self, layer: int, i: int):
        """(chunk-local int32 positions, signed values) of one chunk/layer
        — the zero-densification view build_layer_payload_sparse wants."""
        j = layer * self.b + i
        lo, hi = self.splits[j], self.splits[j + 1]
        return ((self.idx[lo:hi] - j * self.sc).astype(np.int32),
                self.vals[lo:hi])


class _ChunkResult:
    """Host-side view of one chunk's device outputs (numpy scalars/arrays)."""

    def __init__(self, out, i):
        self._i = i
        for k, v in out.items():
            if v is None or k == "sparse" or np.ndim(v) == 0:
                setattr(self, k, v)
            elif k.endswith("_sizes") or k.endswith("_quantiles"):
                setattr(self, k, v[:, i])
            else:
                setattr(self, k, v[i])

    def base_values(self):
        return self.sparse.dense(0, self._i)

    def res_values(self):
        return self.sparse.dense(1, self._i)

    def base_pair(self):
        return self.sparse.pair(0, self._i)

    def res_pair(self):
        return self.sparse.pair(1, self._i)


def _assemble_error_mode_stream(res: _ChunkResult, config: CodecConfig,
                                opts: EncodeOptions, n_frames, h, w,
                                backend: int) -> bytes:
    """Per-chunk candidate selection + serialization for MAX/RELATIVE modes.

    Mirrors the reference's endgame (ebcc_codec.c:737-868): skip-residual,
    pure-base-required, pure-base-vs-base+residual size comparison, residual
    drop rule, mean-error adjustment folded into stored min/max.
    """
    level = config.zstd_level
    minval = float(res.minval)
    maxval = float(res.maxval)

    if bool(res.const):
        header = stream.FrameHeader(
            flags=stream.FLAG_CONST, entropy=entropy.BACKEND_ZSTD,
            n_frames=n_frames, height=h, width=w,
            minval=minval, maxval=maxval, rmin=0.0, rmax=0.0,
            base_levels=config.base_levels, res_levels=config.residual_levels,
            base_nplanes=cfg.BASE_NUM_PLANES, base_cut=0, base_top=0,
            res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
            base_comp_size=0, res_comp_size=0)
        return stream.pack_frame_stream(header, b"", b"")

    if getattr(res, "overflow", False) and bool(res.overflow):
        raise RuntimeError(
            "internal coefficient overflow: bitplane count too small for "
            "this data (please report)")

    base_cut = int(res.base_cut)
    pure_cut = int(res.pure_cut)
    res_cut = int(res.res_cut)
    skip_residual = bool(res.skip_residual)
    res_feasible = bool(res.res_feasible)
    pure_feasible = bool(res.pure_feasible)

    store_cut = int(res.store_cut)

    # Candidate A: base @ base_cut (+ residual @ res_cut unless skipped).
    base_pos, base_vals = res.base_pair()
    d0v, hpv, wpv = res.sparse.shape
    base_meta = lambda kept: (kept, d0v, hpv, wpv, config.base_levels)
    res_meta = lambda kept: (kept, d0v, hpv, wpv, config.residual_levels)
    base_payload, base_top, base_kept = build_layer_payload_sparse(
        base_pos, base_vals, res.sparse.shape, store_cut, base_cut,
        cfg.BASE_NUM_PLANES)
    base_comp, base_be = _entropy_encode(base_payload, backend, level,
                                         base_meta(base_kept))

    use_residual = (not skip_residual) and res_feasible
    res_comp = b""
    res_top = 0
    if use_residual:
        res_payload, res_top, res_kept = build_layer_payload_sparse(
            *res.res_pair(), res.sparse.shape, res_cut, res_cut,
            cfg.RES_NUM_PLANES)
        res_comp, res_be = _entropy_encode(res_payload, backend, level,
                                           res_meta(res_kept))
        if len(res_comp) <= RESIDUAL_DROP_BYTES:  # drop rule (ref c:811)
            # The reference drops unconditionally and tolerates the
            # resulting overshoot; we promise an exact bound, so drop only
            # if the base layer alone still meets it in some shippable form
            # (mean-adjusted/centered or raw — the adjustment gate below
            # picks whichever is verified).
            base_ok = (float(res.base_maxerr_centered) <= float(res.target_abs)
                       or float(res.base_maxerr) <= float(res.target_abs))
            if base_ok:
                res_comp = b""
                use_residual = False

    # Candidate B: pure base @ pure_cut (quantile-1.0 analog, ref c:819-854).
    choose_pure = False
    pure_comp = None
    pure_top = 0
    if (not skip_residual) and (not res_feasible):
        # pure-base required (ref c:755-758): residual can't reach the bound.
        if not pure_feasible:
            logger.warning(
                "Could not reach error target %g in any configuration; "
                "shipping best effort (finest cut).", float(res.target_abs))
        choose_pure = True
    elif use_residual and pure_feasible and not opts.disable_pure_base_fallback:
        # pure_feasible gate: when even cut 0 misses the centered bound,
        # pure_cut is a best-effort fallback value — picking it on byte size
        # alone could ship a bound-violating stream while a feasible
        # base+residual candidate exists.
        pure_payload, pure_top, pure_kept = build_layer_payload_sparse(
            base_pos, base_vals, res.sparse.shape, store_cut, pure_cut,
            cfg.BASE_NUM_PLANES)
        pure_comp, pure_be = _entropy_encode(pure_payload, backend, level,
                                             base_meta(pure_kept))
        if len(pure_comp) < len(base_comp) + len(res_comp):
            logger.info(
                "Pure base compression (%d) is better than base (%d) + "
                "residual (%d)", len(pure_comp), len(base_comp), len(res_comp))
            choose_pure = True

    if choose_pure:
        if pure_comp is None:
            pure_payload, pure_top, pure_kept = build_layer_payload_sparse(
                base_pos, base_vals, res.sparse.shape, store_cut, pure_cut,
                cfg.BASE_NUM_PLANES)
            pure_comp, pure_be = _entropy_encode(pure_payload, backend, level,
                                                 base_meta(pure_kept))
        base_comp, base_cut, base_top = pure_comp, pure_cut, pure_top
        base_be = pure_be
        use_residual = False
        res_comp = b""
        mean = float(res.pure_mean)
    elif use_residual:
        mean = float(res.res_mean)
    else:
        mean = float(res.base_mean)

    flags = 0
    if use_residual:
        flags |= stream.FLAG_HAS_RESIDUAL
    # Mean-adjustment guard: the pure and residual candidates were verified
    # with the CENTERED criterion, so shifting by the mean keeps the bound.
    # The skip-residual/dropped-residual path was verified UNCENTERED (ref
    # c:737 parity) — shifting by a mean of opposite sign to the error
    # extreme can push past the target (the reference ships that overshoot,
    # c:863-868; we don't).  Only adjust there when the centered error is
    # also verified within bound.
    adjust_ok = True
    if not choose_pure and not use_residual:
        adjust_ok = (float(res.base_maxerr_centered)
                     <= float(res.target_abs))
    if not opts.disable_mean_adjustment and abs(mean) > 1e-18 and adjust_ok:
        # Fold the mean error into the stored min/max (ref c:863-868).
        minval += mean
        maxval += mean
        flags |= stream.FLAG_MEAN_ADJUSTED
        logger.info("Mean of compression error: %e; adjusting min/max", mean)

    # Observability parity: the reference logs per-trial search state at
    # TRACE (ebcc_codec.c:554-803) and a per-encode summary at INFO
    # (c:877).  The scan's whole quantile curve is the trial log here.
    if logger.isEnabledFor(TRACE):
        trace("chunk %d: quantile curve (coarse cuts %d..0 step -3): %s",
              res._i, cfg.BASE_NUM_PLANES - 1,
              np.array2string(1.0 - res.base_quantiles, precision=2))
        trace("chunk %d: base_cut=%d pure_cut=%d res_cut=%d skip=%s "
              "res_feasible=%s pure=%s", res._i, base_cut, pure_cut,
              res_cut, skip_residual, res_feasible, choose_pure)
    raw_bytes = n_frames * h * w * 4
    logger.info(
        "chunk %d: base_size=%d res_size=%d compression ratio: %.2f",
        res._i, len(base_comp), len(res_comp),
        raw_bytes / (stream.FRAME_HEADER_SIZE + len(base_comp)
                     + len(res_comp)))

    header = stream.FrameHeader(
        flags=flags, entropy=base_be,
        n_frames=n_frames, height=h, width=w,
        minval=minval, maxval=maxval,
        rmin=float(res.rmin) if use_residual else 0.0,
        rmax=float(res.rmax) if use_residual else 0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=base_cut,
        base_top=base_top,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=res_cut if use_residual else 0,
        res_top=res_top,
        base_comp_size=len(base_comp), res_comp_size=len(res_comp),
        res_entropy=res_be if use_residual else 0)
    return stream.pack_frame_stream(header, base_comp, res_comp)


def _assemble_temporal_stream(res: _ChunkResult, config: CodecConfig,
                              opts: EncodeOptions, n_frames, h, w,
                              backend: int,
                              parallel_deltas: bool = True) -> bytes:
    """Serialization for a TEMPORAL chunk (closed-loop predictive coding,
    see kernels.encode_batch_temporal).

    Frame-0 candidate selection mirrors the DEVICE's deterministic rules —
    the device already baked that choice into the prediction chain, so the
    host may not re-decide on byte sizes (no pure-vs-residual comparison,
    no drop rule, no mean adjustment).
    """
    level = config.zstd_level

    if bool(res.const):
        header = stream.FrameHeader(
            flags=stream.FLAG_CONST, entropy=entropy.BACKEND_ZSTD,
            n_frames=n_frames, height=h, width=w,
            minval=float(res.minval), maxval=float(res.maxval),
            rmin=0.0, rmax=0.0,
            base_levels=config.base_levels, res_levels=config.residual_levels,
            base_nplanes=cfg.BASE_NUM_PLANES, base_cut=0, base_top=0,
            res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
            base_comp_size=0, res_comp_size=0)
        return stream.pack_frame_stream(header, b"", b"")

    if bool(res.overflow):
        raise RuntimeError(
            "internal coefficient overflow: bitplane count too small for "
            "this data (please report)")

    skip_residual = bool(res.skip_residual)
    res_feasible = bool(res.res_feasible)
    ship_pure = (not skip_residual) and (not res_feasible)
    base_cut = int(res.pure_cut) if ship_pure else int(res.base_cut)
    res_cut = int(res.res_cut)
    store_cut = int(res.store_cut)
    use_residual = (not skip_residual) and res_feasible
    if ship_pure and not bool(res.pure_feasible):
        logger.warning(
            "Could not reach error target %g on the intra frame in any "
            "configuration; shipping best effort (finest cut).",
            float(res.target_abs))
    t_feas = np.asarray(res.t_feasible)
    if not t_feas.all():
        logger.warning(
            "Could not reach error target %g on %d delta frame(s); "
            "shipping best effort (max shipped error %g).",
            float(res.target_abs), int((~t_feas).sum()),
            float(np.asarray(res.t_maxerr).max()))

    # Sparse per-frame views: entries are (T, Hp, Wp) with frame 0's two
    # layers in slot 0 and each delta in its frame slot; searchsorted on
    # the sorted positions gives zero-densification per-frame slices for
    # the sparse payload builder.
    d0v, hpv, wpv = res.sparse.shape
    fsz = hpv * wpv
    fshape = (1, hpv, wpv)

    def frame_pair(layer, t):
        pos, vals = res.sparse.pair(layer, res._i)
        lo, hi = np.searchsorted(pos, [t * fsz, (t + 1) * fsz])
        return pos[lo:hi] - t * fsz, vals[lo:hi]

    base_meta = lambda kept: (kept, 1, hpv, wpv, config.base_levels)
    res_meta = lambda kept: (kept, 1, hpv, wpv, config.residual_levels)

    base_payload, base_top, base_kept = build_layer_payload_sparse(
        *frame_pair(0, 0), fshape, store_cut, base_cut, cfg.BASE_NUM_PLANES)
    base_comp, base_be = _entropy_encode(base_payload, backend, level,
                                         base_meta(base_kept))
    res_comp = b""
    res_top = 0
    res_be = 0
    if use_residual:
        res_payload, res_top, res_kept = build_layer_payload_sparse(
            *frame_pair(1, 0), fshape, res_cut, res_cut, cfg.RES_NUM_PLANES)
        res_comp, res_be = _entropy_encode(res_payload, backend, level,
                                           res_meta(res_kept))

    t_cut = np.asarray(res.t_cut)
    t_rmin = np.asarray(res.t_rmin, np.float32)
    t_rmax = np.asarray(res.t_rmax, np.float32)

    def delta_one(t):
        # Per-frame payload build + entropy coding; zstd and the CAB coder
        # release the GIL, so the pool parallelizes the recommended
        # single-multi-frame-chunk configuration (the chunk-level pool in
        # _assemble_batch has nothing to parallelize there; with many
        # chunks the caller disables this inner pool to avoid nesting).
        cut_t = int(t_cut[t - 1])
        payload, top_t, kept_t = build_layer_payload_sparse(
            *frame_pair(1, t), fshape, cut_t, cut_t, cfg.DELTA_NUM_PLANES)
        comp_t, be_t = _entropy_encode(payload, backend, level,
                                       res_meta(kept_t))
        return (stream.DeltaRecord(
            rmin=float(t_rmin[t - 1]), rmax=float(t_rmax[t - 1]),
            cut=cut_t, top=top_t, entropy=be_t, comp_size=len(comp_t)),
            comp_t)

    if n_frames <= 2 or not parallel_deltas:
        parts = [delta_one(t) for t in range(1, n_frames)]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, n_frames - 1)) as pool:
            parts = list(pool.map(delta_one, range(1, n_frames)))
    records = [p[0] for p in parts]
    dpayloads = [p[1] for p in parts]

    flags = stream.FLAG_TEMPORAL
    if use_residual:
        flags |= stream.FLAG_HAS_RESIDUAL

    total = (stream.FRAME_HEADER_SIZE + len(base_comp) + len(res_comp)
             + (n_frames - 1) * stream.DELTA_RECORD_SIZE
             + sum(len(p) for p in dpayloads))
    raw_bytes = n_frames * h * w * 4
    logger.info(
        "chunk %d (temporal): base=%d res=%d deltas=%d skipped=%d "
        "compression ratio: %.2f", res._i, len(base_comp), len(res_comp),
        sum(len(p) for p in dpayloads), int(np.asarray(res.t_skip).sum()),
        raw_bytes / total)

    header = stream.FrameHeader(
        flags=flags, entropy=base_be,
        n_frames=n_frames, height=h, width=w,
        minval=float(res.minval), maxval=float(res.maxval),
        rmin=float(res.rmin) if use_residual else 0.0,
        rmax=float(res.rmax) if use_residual else 0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=base_cut,
        base_top=base_top,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=res_cut if use_residual else 0,
        res_top=res_top,
        base_comp_size=len(base_comp), res_comp_size=len(res_comp),
        res_entropy=res_be if use_residual else 0)
    return stream.pack_temporal_stream(header, base_comp, res_comp,
                                       records, dpayloads)


def build_partial_payload(v, stored_cut: int, cut: int, pb: int,
                          num_planes: int):
    """Rate-mode payload with a PARTIAL next-finer plane: the full planes
    of the magnitudes at ``cut``, then the first ``pb`` bytes of the packed
    plane at ``cut - 1`` (flat scan order), then the sign plane masked to
    coefficients significant in this truncated representation (see
    stream.FLAG_BASE_PARTIAL).  Returns (payload_bytes, top) where the
    header must record ``base_cut = cut - 1``.
    """
    assert cut > stored_cut and pb >= 0
    mag = np.abs(v) >> (cut - stored_cut)
    mx = int(mag.max()) if mag.size else 0
    msb = mx.bit_length()
    top = num_planes - cut - msb
    parts = [
        np.packbits(((mag >> s) & 1).astype(np.uint8), axis=-1).tobytes()
        for s in range(msb - 1, -1, -1)
    ]
    pbit = ((np.abs(v) >> (cut - 1 - stored_cut)) & 1).astype(np.uint8)
    flat = pbit.reshape(-1)
    covered = np.zeros_like(flat)
    covered[: pb * 8] = flat[: pb * 8]
    partial = np.packbits(covered)[:pb].tobytes()
    vis = (mag.astype(np.int64) << 1) | covered.reshape(mag.shape)
    signs = np.packbits(((v < 0) & (vis > 0)).astype(np.uint8), axis=-1)
    return b"".join(parts) + partial + signs.tobytes(), top


def _assemble_rate_mode_stream(res: _ChunkResult, config: CodecConfig,
                               n_frames, h, w, backend: int) -> bytes:
    """Residual-NONE mode: pick the finest cut whose ACTUAL compressed size
    fits the base_cr byte budget (role of J2K rate allocation hitting
    ``tcp_rates[0] = base_cr / 2``, ref ebcc_codec.c:116), then fill the
    remaining budget with a PREFIX of the next-finer plane
    (FLAG_BASE_PARTIAL) for byte-granular rate control — the analog of
    J2K's post-compression rate-distortion truncation, without which rate
    utilization is quantized to octaves.

    The device size estimate seeds the search; each host step is one zstd
    call (no device re-encode), and size is monotone in the cut.
    """
    level = config.zstd_level
    if bool(res.const):
        header = stream.FrameHeader(
            flags=stream.FLAG_CONST, entropy=entropy.BACKEND_ZSTD,
            n_frames=n_frames, height=h, width=w,
            minval=float(res.minval), maxval=float(res.maxval),
            rmin=0.0, rmax=0.0,
            base_levels=config.base_levels, res_levels=config.residual_levels,
            base_nplanes=cfg.BASE_NUM_PLANES, base_cut=0, base_top=0,
            res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
            base_comp_size=0, res_comp_size=0)
        return stream.pack_frame_stream(header, b"", b"")

    numel = n_frames * h * w
    budget = max(0, int(numel * 4 / config.base_cr) - stream.FRAME_HEADER_SIZE)
    est = res.base_est_sizes  # (P+1,)
    store_cut = int(res.store_cut)
    cut = int(np.argmax(est <= budget)) if (est <= budget).any() \
        else cfg.BASE_NUM_PLANES
    cut = max(cut, store_cut)

    base_v = res.base_values()
    d0v, hpv, wpv = base_v.shape

    def payload_at(c):
        if c >= cfg.BASE_NUM_PLANES:
            return b"", entropy.BACKEND_ZSTD, 0
        pl, top, kept = build_layer_payload(
            base_v, store_cut, c, cfg.BASE_NUM_PLANES)
        comp, be = _entropy_encode(
            pl, backend, level, (kept, d0v, hpv, wpv, config.base_levels))
        return comp, be, top

    comp, base_be, top = payload_at(cut)
    while len(comp) > budget and cut < cfg.BASE_NUM_PLANES:
        cut += 1
        comp, base_be, top = payload_at(cut)
    while cut > store_cut:
        trial, trial_be, trial_top = payload_at(cut - 1)
        if len(trial) <= budget:
            cut -= 1
            comp, base_be, top = trial, trial_be, trial_top
        else:
            break

    # Byte-granular fill: bisect the partial-plane prefix length for the
    # largest zstd'd payload still within budget.  Worth a header flag only
    # when it actually improves on the full-plane candidate.
    flags = 0
    if store_cut < cut <= cfg.BASE_NUM_PLANES and len(comp) < budget:
        plane_bytes = d0v * hpv * wpv // 8
        zbk = entropy.BACKEND_ZSTD

        def partial_at(pb):
            pl, ptop = build_partial_payload(
                base_v, store_cut, cut, pb, cfg.BASE_NUM_PLANES)
            return compress_fn(pl), ptop

        compress_fn = lambda pl: entropy.compress(pl, zbk, level)
        lo, hi = 0, plane_bytes  # lo feasible-by-construction analog
        best = None
        for _ in range(8):
            mid = (lo + hi + 1) // 2
            trial, ptop = partial_at(mid)
            if len(trial) <= budget:
                lo = mid
                best = (trial, ptop, mid)
            else:
                hi = mid - 1
            if lo >= hi:
                break
        if best is not None and len(best[0]) > len(comp):
            comp, top, _pb = best[0], best[1], best[2]
            base_be = zbk
            cut = cut - 1
            flags |= stream.FLAG_BASE_PARTIAL

    header = stream.FrameHeader(
        flags=flags, entropy=base_be,
        n_frames=n_frames, height=h, width=w,
        minval=float(res.minval), maxval=float(res.maxval),
        rmin=0.0, rmax=0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=cut, base_top=top,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
        base_comp_size=len(comp), res_comp_size=0)
    return stream.pack_frame_stream(header, comp, b"")


def _fetch_rice_values(words_dev, nnz: int,
                       bound_words=None) -> np.ndarray:
    """Fetch a device Rice word buffer (transfer.rice_pack) and decode it.

    One optimistic transfer sized for typical entropy; the tail is fetched
    only when the self-describing header says the payload overflowed the
    initial bound."""
    from .. import native

    bound = min(bound_words or transfer.rice_bound_words(nnz),
                int(words_dev.shape[0]))
    transfer.count_down(4 * bound)
    head = transfer.sliced_get(words_dev[:bound])
    need = transfer.RICE_HEADER_WORDS + (int(head[0]) + 31) // 32
    if need > bound:  # rare: high-entropy values
        tail = transfer.sliced_get(
            words_dev[bound:transfer.bucket_count(need)])
        transfer.count_down(tail.nbytes)
        head = np.concatenate([head, tail])
    return native.rice_decode(head, nnz)


def _native_unpacker():
    """The native module for C-speed plane unpacking in the decode
    direction, or None (numpy fallback).  EBCC_NO_NATIVE_UNPACK=1 forces
    the fallback (tests)."""
    if os.environ.get("EBCC_NO_NATIVE_UNPACK"):
        return None
    from .. import native

    try:
        native.load(auto_build=False)
        return native
    except Exception:
        return None


def _rice_enabled() -> bool:
    """Rice-coded value fetch (transfer.rice_pack + native decode): on by
    default when the native library is available; EBCC_NO_RICE=1 disables."""
    if os.environ.get("EBCC_NO_RICE"):
        return False
    from .. import native

    try:
        native.load(auto_build=False)
        return True
    except Exception:
        return False


def _max_safe_batch(chunk_numel: int) -> int:
    """Largest batch size whose sparse-exchange index space (2 layers x B x
    chunk coefficients, padded grid) stays within int32."""
    return max(1, (2 ** 31 - 1) // (2 * max(1, chunk_numel)))


def _pack_small_flat(small):
    """Device-side: bit-pack every small encode output into ONE uint32
    vector (traceable helper shared by the standalone and fused fetch
    programs)."""
    parts = []
    for k in sorted(small.keys()):
        v = small[k]
        v = v.reshape(-1) if v.ndim else v.reshape(1)
        if v.dtype == jnp.bool_:
            u = v.astype(jnp.uint32)
        elif v.dtype in (jnp.int32, jnp.float32):
            u = jax.lax.bitcast_convert_type(v, jnp.uint32)
        else:
            u = v.astype(jnp.uint32)
        parts.append(u)
    return jnp.concatenate(parts)


@jax.jit
def _pack_small_program(small):
    """Bit-pack every small encode output into ONE uint32 vector so the
    host fetch is a single link round trip.  ~25 scalar/(B,)-sized leaves
    fetched individually cost one link round trip each; packed they
    cost one.  jax.jit caches per pytree structure."""
    return _pack_small_flat(small)


def _split_small_flat(flat: np.ndarray, small) -> dict:
    """Host-side inverse of :func:`_pack_small_flat`: split/bitcast the
    fetched uint32 vector back into the dict of numpy arrays/scalars,
    using ``small`` (the device output dict) as the shape/dtype template."""
    outd = {}
    off = 0
    for k in sorted(small.keys()):
        v = small[k]
        n = int(np.prod(v.shape)) if v.ndim else 1
        raw = flat[off:off + n]
        off += n
        dt = v.dtype
        if dt == np.bool_ or str(dt) == "bool":
            arr = raw != 0
        elif str(dt) in ("int32", "float32"):
            arr = raw.view(str(dt))
        else:
            arr = raw.astype(dt)
        outd[k] = arr.reshape(v.shape) if v.ndim else arr[0]
    return outd


def _small_flat_size(small) -> int:
    return sum((int(np.prod(v.shape)) if v.ndim else 1)
               for v in small.values())


def _fetch_small_packed(small):
    """One-RPC fetch of the small encode outputs: device-side bit-pack
    (:func:`_pack_small_program`) + host-side split/bitcast back to the
    original dict of numpy arrays/scalars."""
    packed = _pack_small_program(small)
    transfer.count_down(packed.nbytes)
    flat = np.asarray(jax.device_get(packed))
    return _split_small_flat(flat, small)


# ---------------------------------------------------------------------------
# Fused encode-direction fetch: smalls + Rice pair in ONE transfer
# ---------------------------------------------------------------------------
#
# The 3-RPC exchange (small fetch -> exact-size fetch -> payload fetch) costs
# three round trips of latency per sub-batch.  With a size HINT from the
# previous same-shaped sub-batch, one program packs the smalls and the
# compacted Rice pair into a single buffer fetched in ONE round trip; the
# smalls then reveal the true nnz and the Rice header the
# true word count, so a hint miss costs extra transfers but never
# correctness.  Streams stay byte-identical: the hint only sizes transfers.

_EXCH_HINTS: dict = {}
_EXCH_LOCK = _threading_mod.Lock()


@functools.partial(jax.jit, static_argnames=("cap", "hw"))
def _fused_exchange_program(small, vals_flat, sig_bytes, *, cap, hw):
    packed = _pack_small_flat(small)
    words, _needed = transfer.compact_rice_exchange(
        vals_flat, sig_bytes, cap=cap, hw=hw)
    return packed, words


@functools.partial(jax.jit, static_argnames=("bound",))
def _fused_head_program(packed, words, *, bound):
    """Tiny per-bound program: one fetchable buffer of smalls + words
    prefix.  Separate from :func:`_fused_exchange_program` so a new bound
    only recompiles this concat, not the whole compaction pipeline —
    which lets the bound ride a fine (1/8-step) pad ladder."""
    return jnp.concatenate([packed, words[:bound]])


def _exch_hint_get(key):
    with _EXCH_LOCK:
        return _EXCH_HINTS.get(key)


def _exch_hint_put(key, nnz: int, words: int) -> None:
    with _EXCH_LOCK:
        _EXCH_HINTS[key] = {"nnz": int(nnz), "words": int(words)}


def _decode_rice_pair_host(head: np.ndarray, nnz: int, hp: int, wp: int):
    """Host side of the compact exchange: split the fetched pair buffer and
    Rice-decode positions + classed values via the native walkers."""
    from .. import native

    ga, vb_ = transfer.split_rice_pair(head, nnz)
    idx = native.rice_decode_gaps_classed(
        ga, nnz, hp, wp, transfer.unpack_rice_ks(ga[1]))
    cls = transfer.coeff_class_host(idx, hp, wp)
    vals = native.rice_decode_classed(
        vb_, nnz, cls, transfer.unpack_rice_ks(vb_[1]))
    return idx, vals


def _fused_fetch_encode_outputs(out, small, key, hint, b, d0, hp, wp):
    """Hint-sized single-RPC fetch of smalls + Rice pair.  Returns the
    completed output dict, or None when the hinted cap cannot be used
    (caller falls back to the 3-RPC path)."""
    cap = transfer.bucket_count(max(1, int(hint["nnz"] * 1.15)))
    if cap > transfer.COMPACT_CAP_LIMIT:
        return None
    max_words = transfer.RICE_PAIR_HEADER_WORDS + (104 * cap) // 32 + 8
    bound = min(transfer.rice_block_bucket(
        max(64, int(hint["words"] * 1.04))), max_words)
    n_small = _small_flat_size(small)
    with stage("enc: fused fetch"):
        with stage("enc: fused dispatch"):
            packed_dev, words_dev = _fused_exchange_program(
                small, out["vals_comb"], out["sig_comb"].reshape(-1),
                cap=cap, hw=(hp, wp))
            head_dev = _fused_head_program(packed_dev, words_dev,
                                           bound=bound)
        transfer.count_down(4 * (n_small + bound))
        with stage("enc: fused get"):
            flat = transfer.sliced_get(head_dev)
        outd = _split_small_flat(flat[:n_small], small)
        nnz = int(outd.pop("exchange_nnz", -1))
        if nnz == 0:
            _exch_hint_put(key, 0, 64)
            outd["sparse"] = _SparseBatch(
                np.zeros(0, np.int32), np.zeros(0, np.int32), b, d0, hp, wp)
            return outd
        if nnz < 0:
            return None
        if nnz > cap:
            # Hint miss (density jumped >15%): redo the compaction at the
            # true capacity — correct, just pays the extra round trips.
            cap2 = transfer.bucket_count(nnz)
            if cap2 > transfer.COMPACT_CAP_LIMIT:
                return None
            words_dev, needed_dev = transfer.compact_rice_exchange(
                out["vals_comb"], out["sig_comb"].reshape(-1), cap=cap2,
                hw=(hp, wp))
            need = int(jax.device_get(needed_dev))
            transfer.count_down(4)
            bound2 = min(transfer.rice_block_bucket(need),
                         int(words_dev.shape[0]))
            head = transfer.sliced_get(words_dev[:bound2])
            transfer.count_down(4 * bound2)
            _exch_hint_put(key, nnz, need)
            idx, vals = _decode_rice_pair_host(head, nnz, hp, wp)
            outd["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
            return outd
        head = flat[n_small:]
        bits_a, bits_b = int(head[0]), int(head[2])
        need = (transfer.RICE_PAIR_HEADER_WORDS
                + (bits_a + 31) // 32 + (bits_b + 31) // 32)
        if need > bound:
            # Rare: entropy above the hinted bound — fetch the tail from
            # the still-resident full words buffer.
            hi = min(transfer.rice_block_bucket(need), max_words)
            tail = transfer.sliced_get(words_dev[bound:hi])
            transfer.count_down(tail.nbytes)
            head = np.concatenate([head, tail])
        _exch_hint_put(key, nnz, need)
        with stage("enc: fused host rice"):
            idx, vals = _decode_rice_pair_host(head, nnz, hp, wp)
        outd["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
        return outd


def _fetch_encode_outputs(out, error_mode: bool):
    """Transfer device encode outputs to host via the sparse coefficient
    exchange (core.transfer).

    Fast path (device-side compaction, ``compact_rice_exchange``): two
    transfers total — the scalar outputs (whose ``exchange_words`` sizes
    the second fetch exactly) and one Rice-coded buffer holding position
    gaps + values at ~1 byte per significant coefficient.  Nothing is
    uploaded.

    Fallback (no native Rice decoder, or significance density above the
    compaction capacity): fetch the packed significance bitmap, upload the
    index vector, fetch the compacted values."""
    nl, b, d0, hp, wb = out["sig_comb"].shape
    wp = wb * 8
    small_dev = {k: v for k, v in out.items()
                 if k not in ("vals_comb", "sig_comb")}

    if _rice_enabled() and "exchange_nnz" in small_dev:
        key = (nl, b, d0, hp, wb)
        hint = _exch_hint_get(key)
        if hint is not None:
            res = _fused_fetch_encode_outputs(out, small_dev, key, hint,
                                              b, d0, hp, wp)
            if res is not None:
                return res

    with stage("enc: small fetch (+compute)"):
        small = _fetch_small_packed(small_dev)

    nnz = int(small.pop("exchange_nnz", -1))
    if nnz == 0:
        small["sparse"] = _SparseBatch(
            np.zeros(0, np.int32), np.zeros(0, np.int32), b, d0, hp, wp)
        return small
    if (nnz > 0 and _rice_enabled()
            and transfer.bucket_count(nnz) <= transfer.COMPACT_CAP_LIMIT):
        # Fast path: a separate device program (sized to the ACTUAL nnz via
        # the bucket ladder) compacts positions+values and Rice-packs both;
        # a 4-byte size fetch then prices the payload fetch exactly.
        # Above COMPACT_CAP_LIMIT (extreme density) the bitmap fallback
        # below bounds device memory and (with the same gate on its own
        # rice_pack leg) avoids int32 bit-offset overflow in the packers.
        cap = transfer.bucket_count(nnz)
        with stage(f"enc: compact+rice fetch {nnz} vals"):
            words_dev, needed_dev = transfer.compact_rice_exchange(
                out["vals_comb"], out["sig_comb"].reshape(-1), cap=cap,
                hw=(hp, wp))
            # Exact-size fetch: one extra 4-byte round trip for the true
            # word count beats the optimistic-bound fetch by ~2.5x in
            # bytes (the bound must assume ~18 bits/value; typical is ~7),
            # and the pipeline's fetch workers hide the added latency.
            need = int(jax.device_get(needed_dev))
            transfer.count_down(4)
            bound = min(transfer.rice_block_bucket(need),
                        int(words_dev.shape[0]))
            head = transfer.sliced_get(words_dev[:bound])
            transfer.count_down(4 * bound)
            _exch_hint_put((nl, b, d0, hp, wb), nnz, need)
            idx, vals = _decode_rice_pair_host(head, nnz, hp, wp)
        small["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
        return small

    with stage("enc: bitmap fetch -> positions"):
        transfer.count_down(out["sig_comb"].nbytes)
        sig = transfer.sliced_get(out["sig_comb"].reshape(-1)).reshape(
            out["sig_comb"].shape)
        idx = transfer.host_bitmap_positions(sig)
    cap = transfer.bucket_count(max(1, idx.size))
    transfer.count_up(4 * cap)
    idx_dev = jax.device_put(transfer.pad_index(idx, cap, 0))

    vals = None
    # rice_pack also builds int32 bit offsets (up to 52 bits/value with
    # escapes), so gate it the same way; beyond the limit the raw
    # int16/int32 gather below is the safe path.
    if idx.size and _rice_enabled() and cap <= transfer.COMPACT_CAP_LIMIT:
        with stage(f"enc: gather+rice fetch {idx.size} vals"):
            gathered = transfer.gather_values(
                out["vals_comb"], idx_dev, cap=cap, as_int16=False)
            words_dev = transfer.rice_pack(
                gathered, np.int32(idx.size), cap=cap)
            vals = _fetch_rice_values(words_dev, idx.size)
    if vals is None:
        as16 = int(small["max_kept"]) < (1 << 15)
        with stage(f"enc: gather+fetch {idx.size} vals"):
            transfer.count_down((2 if as16 else 4) * cap)
            vals = np.asarray(jax.device_get(transfer.gather_values(
                out["vals_comb"], idx_dev, cap=cap,
                as_int16=as16)))[: idx.size]

    small["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
    return small


def _assemble_batch(out_np, config, opts, n_frames, h, w, backend,
                    error_mode: bool, n_chunks: int) -> List[bytes]:
    """Host-side stream assembly for a fetched batch, with zstd spread over
    a thread pool (zstandard releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    if _temporal_active(config, n_frames):
        fn = lambda i: _assemble_temporal_stream(
            _ChunkResult(out_np, i), config, opts, n_frames, h, w, backend,
            parallel_deltas=n_chunks <= 1)
    elif error_mode:
        fn = lambda i: _assemble_error_mode_stream(
            _ChunkResult(out_np, i), config, opts, n_frames, h, w, backend)
    else:
        fn = lambda i: _assemble_rate_mode_stream(
            _ChunkResult(out_np, i), config, n_frames, h, w, backend)
    with stage("assemble+zstd"):
        if n_chunks <= 1:
            return [fn(i) for i in range(n_chunks)]
        with ThreadPoolExecutor(max_workers=min(4, n_chunks)) as pool:
            return list(pool.map(fn, range(n_chunks)))


def _mask_fill_check(x_batch: np.ndarray, allow_nan: bool):
    """Input gate shared by every host entry point -> (finite batch, masks).

    Without ``allow_nan``: parity with the reference's ``check_nan_inf``
    (ebcc_codec.c:598-605; raise instead of hard-exit).  With it (beyond
    reference): NaN samples are masked out — replaced by their frame's
    valid-sample mean so the encoder sees finite data (valid samples are
    untouched, so the shipped bound holds on them unchanged) — and the
    boolean invalid bitmap is returned for the stream's mask section
    (``stream.FLAG_MASKED``).  Inf always raises: it is junk, not a mask.
    ``masks`` is None when nothing was masked."""
    if not allow_nan:
        if not np.isfinite(x_batch).all():
            raise ValueError("NaN or Inf found in data")
        return x_batch, None
    m = np.isnan(x_batch)
    if not m.any():
        if not np.isfinite(x_batch).all():
            raise ValueError("Inf found in data")
        return x_batch, None
    if np.isinf(x_batch).any():
        raise ValueError("Inf found in data")
    cnt = (~m).sum(axis=(2, 3))
    s = np.where(m, 0.0, x_batch).sum(axis=(2, 3), dtype=np.float64)
    fill = np.divide(s, np.maximum(cnt, 1))
    # Frames with no valid sample fall back to the CHUNK's valid mean,
    # then to 1.0 (any fill is within-bound for a fully masked frame;
    # a positive in-range fill keeps the relative-range and log-domain
    # paths honest — a 0.0 fill inflated the REL range and broke the
    # pointwise mode's positivity on valid input).
    ccnt = cnt.sum(axis=1)
    cfill = np.where(ccnt > 0, s.sum(axis=1) / np.maximum(ccnt, 1), 1.0)
    fill = np.where(cnt > 0, fill, cfill[:, None]).astype(np.float32)
    return np.where(m, fill[:, :, None, None], x_batch), m


def _append_mask_sections(streams: List[bytes], masks,
                          zstd_level: int) -> List[bytes]:
    """Append a mask section (and set FLAG_MASKED) to each assembled
    stream whose chunk actually carries invalid samples.  ``masks`` is the
    (B, d0, h, w) bitmap from :func:`_mask_fill_check` (or None).  Works on
    any backend's output — the section is a trailing add-on the assembly
    paths never need to know about."""
    if masks is None:
        return streams
    out = []
    for i, s in enumerate(streams):
        mi = masks[i]
        if not mi.any():
            out.append(s)
            continue
        packed = np.packbits(mi.reshape(-1)).tobytes()
        ent_id = entropy.BACKEND_ZSTD
        z = entropy.compress(packed, ent_id, zstd_level)
        if len(z) >= len(packed):
            z, ent_id = packed, entropy.BACKEND_STORE
        out.append(stream.append_mask_section(s, ent_id, z))
    return out


def _apply_nan_masks_host(out: np.ndarray, nan_masks) -> np.ndarray:
    """Restore NaN at masked positions (host arrays, in place)."""
    if nan_masks is None:
        return out
    n, d0, h, w = out.shape
    for i, p in enumerate(nan_masks):
        if p is None:
            continue
        m = np.unpackbits(np.frombuffer(p, np.uint8),
                          count=d0 * h * w).astype(bool)
        out[i][m.reshape(d0, h, w)] = np.nan
    return out


@functools.lru_cache(maxsize=None)
def _nan_where_program():
    import jax.numpy as jnp

    @jax.jit
    def _nan_where(out, packed):
        n = out.shape[0]
        sz = out.shape[1] * out.shape[2] * out.shape[3]
        bits = (packed[:, :, None]
                >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
        m = bits.reshape(n, -1)[:, :sz].reshape(out.shape)
        return jnp.where(m.astype(bool), jnp.float32(np.nan), out)

    return _nan_where


def _apply_nan_masks_device(out, nan_masks):
    """Restore NaN at masked positions on a device-resident batch: upload
    the packed bitmaps (masked chunks only are non-zero) and apply one
    jitted where.  Used by the device-resident decode paths."""
    if nan_masks is None:
        return out
    n, d0, h, w = out.shape
    need = (d0 * h * w + 7) // 8
    packed = np.zeros((n, need), np.uint8)
    for i, p in enumerate(nan_masks):
        if p is not None:
            packed[i] = np.frombuffer(p, np.uint8, count=need)
    transfer.count_up(packed.nbytes)
    return _nan_where_program()(out, jax.device_put(packed))


def _f32_to_ordered_u32(x: np.ndarray) -> np.ndarray:
    """Order-preserving bijection float32 bits -> uint32 (negative floats
    map below positives; every bit pattern, incl. NaN/Inf, round-trips)."""
    b = x.reshape(-1).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _ordered_u32_to_f32(u: np.ndarray) -> np.ndarray:
    b = np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u).astype(np.uint32)
    return b.view(np.float32)


def _lorenzo_fwd(u: np.ndarray) -> np.ndarray:
    """Per-frame 2-D Lorenzo predictor residuals of (d0, h, w) uint32
    (u[-1, :] ≡ 0 convention makes it uniform): separable as a vertical
    wrapping diff then a horizontal one.  Interior residual =
    u - left - up + upleft; measured ~9% better than the 1-D delta on
    ERA5 (docs/RESULTS.md)."""
    v = u.copy()
    v[:, 1:] = u[:, 1:] - u[:, :-1]      # axis -2 (rows), wrapping
    d = v.copy()
    d[:, :, 1:] = v[:, :, 1:] - v[:, :, :-1]  # axis -1 (cols), wrapping
    return d


def _lorenzo_inv(d: np.ndarray) -> np.ndarray:
    """Inverse: wrapping cumulative sums along cols then rows."""
    v = (np.cumsum(d.astype(np.uint64), axis=-1)
         & 0xFFFFFFFF).astype(np.uint32)
    return (np.cumsum(v.astype(np.uint64), axis=-2)
            & 0xFFFFFFFF).astype(np.uint32)


def _lossless_encode_frames(x_batch: np.ndarray,
                            config: CodecConfig) -> List[bytes]:
    """Bit-exact coder (RESIDUAL_LOSSLESS): per chunk, map the float bits
    to order-preserving uint32, per-frame 2-D Lorenzo-predict, entropy-code
    (the residual stream is where zstd finds the structure — measured
    better than byte-shuffle and 1-D-delta variants on ERA5,
    docs/RESULTS.md).  NaN/Inf pass through bit-exactly; no finite check
    applies."""
    from concurrent.futures import ThreadPoolExecutor

    x_batch = np.ascontiguousarray(x_batch, dtype=np.float32)
    b = x_batch.shape[0]
    d0, h, w = x_batch.shape[1:]

    def one(i):
        u = _f32_to_ordered_u32(x_batch[i]).reshape(d0, h, w)
        # Candidate 0: per-frame 2-D Lorenzo.  Candidate 1 (multi-frame
        # chunks): frame-axis wrapping diff first — a big win on
        # correlated stacks (levels/time), a loss on unrelated frames, so
        # pick by compressed size and record the choice in the otherwise-
        # zero base_levels header field (docs/FORMAT.md).
        ent_id = entropy.BACKEND_ZSTD
        # Predictor ids: 2 = per-frame 2-D Lorenzo, 3 = frame-axis diff
        # first.  Ids 0/1 belonged to interim same-round coders and are
        # rejected on decode so no stream can silently misdecode.
        cands = [(_lorenzo_fwd(u).tobytes(), 2)]
        if d0 > 1:
            w_ = u.copy()
            w_[1:] = u[1:] - u[:-1]  # uint32 wraparound
            cands.append((_lorenzo_fwd(w_).tobytes(), 3))
        best = None
        for raw, tdiff in cands:
            payload, eid = entropy.compress(raw, ent_id,
                                            config.zstd_level), ent_id
            if len(payload) >= len(raw):
                payload, eid = raw, entropy.BACKEND_STORE
            if best is None or len(payload) < len(best[0]):
                best = (payload, eid, tdiff)
        payload, eid, tdiff = best
        header = stream.FrameHeader(
            flags=stream.FLAG_LOSSLESS, entropy=eid,
            n_frames=d0, height=h, width=w,
            minval=0.0, maxval=0.0, rmin=0.0, rmax=0.0,
            base_levels=tdiff, res_levels=0, base_nplanes=0, base_cut=0,
            base_top=0, res_nplanes=0, res_cut=0, res_top=0,
            base_comp_size=len(payload), res_comp_size=0)
        return stream.pack_frame_stream(header, payload, b"")

    if b <= 1:
        return [one(i) for i in range(b)]
    with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, b)) as p:
        return list(p.map(one, range(b)))


def _lossless_decode_streams(headers, streams: List[bytes]) -> np.ndarray:
    """-> (N, d0, h, w) float32, bit-exact."""
    from concurrent.futures import ThreadPoolExecutor

    h0 = headers[0]
    n = len(streams)
    sz = h0.n_frames * h0.height * h0.width

    for hd in headers:
        if (hd.height > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.width > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.n_frames > 1 << 20):
            raise stream.StreamError("implausible ETPU header dimensions")
        if hd.base_levels not in (2, 3):
            raise stream.StreamError(
                "unsupported lossless predictor id (ids 0/1 were interim "
                "pre-release coders; re-encode with a current build)")
        if (hd.n_frames, hd.height, hd.width) != (h0.n_frames, h0.height,
                                                  h0.width):
            raise stream.StreamError("inconsistent chunk stream shapes")

    def one(i):
        hd = headers[i]
        payload = streams[i][stream.FRAME_HEADER_SIZE:
                             stream.FRAME_HEADER_SIZE + hd.base_comp_size]
        raw = entropy.decompress(payload, hd.entropy, sz * 4)
        if len(raw) != sz * 4:
            raise stream.StreamError("lossless payload size mismatch")
        d = np.frombuffer(raw, np.uint32).reshape(
            hd.n_frames, hd.height, hd.width)
        u = _lorenzo_inv(d)
        if hd.base_levels == 3:  # frame-axis diff was applied first
            u = (np.cumsum(u.astype(np.uint64), axis=0)
                 & 0xFFFFFFFF).astype(np.uint32)
        return _ordered_u32_to_f32(u.reshape(-1)).reshape(
            hd.n_frames, hd.height, hd.width)

    if n <= 1:
        parts = [one(i) for i in range(n)]
    else:
        with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1,
                                                n)) as p:
            parts = list(p.map(one, range(n)))
    return np.stack(parts)


# Float32 safety margin for the log-domain bound: the encoder's log
# rounds within ~1 ulp of |log x| (an ABSOLUTE log-domain error scaling
# with the magnitude, <= 89 for any finite positive f32) and the
# decoder's exp adds ~1 ulp relative — both sides included, doubled for
# safety.  A FIXED conservative constant (not data-dependent) so every
# encode route — including the streaming pipeline, which never sees the
# global data — derives the identical internal target and stays
# byte-compatible; mirrored in native/etpu_codec.cc.
_LOG_MARGIN = 1.3e-7 * (89.0 + 2.0)


def _log_transform_check(x_batch, config: CodecConfig):
    """Pointwise-relative preprocessing -> (log-domain batch, internal
    MAX_ERROR config).  No-op for every other mode.

    ``|x̂/x - 1| <= eps`` for every sample follows from bounding the log
    reconstruction by ``log1p(eps)`` (the binding side: ``e^T <= 1+eps``
    implies ``e^-T >= 1/(1+eps) > 1-eps``) minus the float32 log/exp
    margin; the existing MAX_ERROR scans then guarantee it exactly, and
    temporal prediction (ratio prediction in the log domain) and NaN
    masking compose unchanged.  Requires strictly positive finite data
    (call after the allow_nan fill)."""
    if config.residual_mode != cfg.RESIDUAL_POINTWISE_RELATIVE_ERROR:
        return x_batch, config
    import dataclasses

    if isinstance(x_batch, np.ndarray):
        if not (x_batch > 0).all():
            raise ValueError(
                "pointwise-relative mode requires strictly positive data")
        y = np.log(x_batch, dtype=np.float32)
    else:
        # Device arrays: the caller owns the positivity contract (like the
        # NaN/Inf check).
        y = jnp.log(x_batch)
    target = float(np.log1p(config.error)) - _LOG_MARGIN
    if target <= 0:
        raise ValueError(
            f"error {config.error} too small to guarantee in float32 at "
            "this magnitude range")
    internal = dataclasses.replace(
        config, residual_mode=cfg.RESIDUAL_MAX_ERROR, error=target)
    return y, internal


def _set_log_flags(streams: List[bytes], config: CodecConfig,
                   orig_config: CodecConfig) -> List[bytes]:
    """Mark streams produced by a log-domain encode (decoders apply exp)."""
    if orig_config.residual_mode != cfg.RESIDUAL_POINTWISE_RELATIVE_ERROR:
        return streams
    return [stream.set_flag(s, stream.FLAG_LOG_DOMAIN) for s in streams]


def _temporal_active(config: CodecConfig, n_frames: int) -> bool:
    """Temporal coding applies when requested AND the chunk actually
    carries a multi-frame leading axis (single-frame chunks fall back to
    plain intra coding — a 1-frame temporal stream would be pure
    overhead)."""
    return (config.temporal and n_frames > 1
            and config.residual_mode != cfg.RESIDUAL_NONE)


# Enable the u16 upload only when the (per-chunk absolute) target is at
# least this many times the u16 quantization slack, so the slack eats at
# most ~3% of the error budget.
_U16_MIN_TARGET_OVER_SLACK = 32.0


def _u16_upload_ok(minv: np.ndarray, maxv: np.ndarray,
                   config: CodecConfig) -> bool:
    slack = (maxv - minv) / (2.0 * kernels.BASE_SCALE)
    if config.residual_mode == cfg.RESIDUAL_RELATIVE_ERROR:
        targets = config.error * (maxv - minv)
    else:
        targets = np.full_like(slack, config.error)
    return bool(np.all(targets >= _U16_MIN_TARGET_OVER_SLACK * slack))


_MIN_ENCODE_BATCH = 4


def _pad_min_batch(xb):
    """Pad sub-minimum batches up to ``_MIN_ENCODE_BATCH`` by repeating the
    last chunk (assembly only reads the real entries).

    Byte determinism: the per-chunk ``lax.map`` bodies in kernels.py are
    bitwise stable only while XLA keeps the map a real loop — a trip count
    of 1 gets elided and the body inlined+fused differently, which changed
    a singleton encode's stored mean relative to the same chunk inside a
    larger batch (round-5 fuzz finding).  Keeping every compiled trip
    count >= 4 keeps the loop (and its body) intact."""
    b = xb.shape[0]
    if b >= _MIN_ENCODE_BATCH:
        return xb
    reps = [xb, ] + [xb[-1:]] * (_MIN_ENCODE_BATCH - b)
    if isinstance(xb, np.ndarray):
        return np.concatenate(reps, axis=0)
    return jnp.concatenate(reps, axis=0)


def encode_batch_device(xb, config: CodecConfig, opts: EncodeOptions):
    """Dispatch the device encode program on an already-device-resident
    (or host numpy) batch.  Returns the device output dict (async)."""
    if config.residual_mode == cfg.RESIDUAL_NONE:
        numel = int(np.prod(xb.shape[1:]))
        budget = max(0, int(numel * 4 / config.base_cr)
                     - stream.FRAME_HEADER_SIZE)
        return kernels.encode_batch_rate_only(
            xb, np.int32(budget), base_levels=config.base_levels,
            res_levels=config.residual_levels)
    relative = config.residual_mode == cfg.RESIDUAL_RELATIVE_ERROR
    if _temporal_active(config, xb.shape[1]):
        if isinstance(xb, np.ndarray):
            transfer.count_up(xb.nbytes)
        return kernels.encode_batch_temporal(
            xb, np.float32(config.error),
            np.float32(opts.base_quantile_target),
            base_levels=config.base_levels,
            res_levels=config.residual_levels,
            relative_mode=relative)
    common = dict(
        base_levels=config.base_levels, res_levels=config.residual_levels,
        relative_mode=relative,
        use_centered=not opts.disable_mean_adjustment)
    if opts.u16_upload and isinstance(xb, np.ndarray):
        minv = xb.min(axis=(1, 2, 3)).astype(np.float32)
        maxv = xb.max(axis=(1, 2, 3)).astype(np.float32)
        if _u16_upload_ok(minv, maxv, config):
            rngv = np.where(minv == maxv, np.float32(1.0), maxv - minv)
            xq = np.rint(
                (xb - minv[:, None, None, None])
                / rngv[:, None, None, None] * kernels.BASE_SCALE
            ).astype(np.uint16)
            transfer.count_up(xq.nbytes)
            return kernels.encode_batch_u16(
                xq, minv, maxv, np.float32(config.error),
                np.float32(opts.base_quantile_target), **common)
    if isinstance(xb, np.ndarray):
        transfer.count_up(xb.nbytes)
    return kernels.encode_batch(
        xb, np.float32(config.error), np.float32(opts.base_quantile_target),
        **common)


def _encode_chunk_batch(x_batch, config: CodecConfig,
                        opts: EncodeOptions,
                        skip_finite_check: bool = False) -> List[bytes]:
    """Encode a batch of equally-shaped chunks -> per-chunk stream bytes.

    x_batch: (B, n_frames, h, w) float32 (numpy or device array).
    """
    is_np = isinstance(x_batch, np.ndarray)
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        xb = (np.asarray(jax.device_get(x_batch)) if not is_np
              else x_batch)
        return _lossless_encode_frames(xb, config)
    masks = None
    orig_config = config
    if is_np and not skip_finite_check:
        # parity: reference check_nan_inf hard-exits (ebcc_codec.c:598-605);
        # we raise instead — or, with allow_nan, fill + collect the mask
        # bitmaps for the trailing sections.  Device-array inputs skip this
        # (callers own the check; allow_nan is a host-input feature).
        x_batch, masks = _mask_fill_check(x_batch, config.allow_nan)
    x_batch, config = _log_transform_check(x_batch, config)

    b, n_frames, h, w = x_batch.shape
    hp, wp = _padded_hw(h, w, max(config.base_levels, config.residual_levels))
    if b > _max_safe_batch(n_frames * hp * wp):
        raise ValueError(
            f"batch of {b} chunks x {n_frames * hp * wp} coefficients "
            "exceeds the int32 sparse-index space; lower max_batch")
    backend = entropy.backend_id(config)
    xb = np.ascontiguousarray(x_batch, dtype=np.float32) if is_np else x_batch

    error_mode = config.residual_mode != cfg.RESIDUAL_NONE
    out = encode_batch_device(_pad_min_batch(xb), config, opts)
    out_np = _fetch_encode_outputs(out, error_mode)
    streams = _assemble_batch(out_np, config, opts, n_frames, h, w, backend,
                              error_mode, b)
    streams = _set_log_flags(streams, config, orig_config)
    return _append_mask_sections(streams, masks, config.zstd_level)


def _pipeline_encode_slices(slices, counts, config: CodecConfig,
                            opts: EncodeOptions, n_frames, h, w) -> List[bytes]:
    """Encode a sequence of equally-typed batch slices with a pipelined
    schedule: fetch workers keep the (latency-bound) device round-trips
    of slices k+1..k+3 in flight while ASSEMBLER workers entropy-code the
    already-fetched slices — nothing heavier than orchestration runs on
    the main thread, so host zstd/stream assembly fully overlaps both
    link legs (round-2 VERDICT #1: assembly used to serialize ~0.5 s/rep
    on the main thread between fetches)."""
    from concurrent.futures import ThreadPoolExecutor

    error_mode = config.residual_mode != cfg.RESIDUAL_NONE
    backend = entropy.backend_id(config)

    def run_batch(sl):
        return _fetch_encode_outputs(
            encode_batch_device(_pad_min_batch(sl), config, opts),
            error_mode)

    depth = min(int(os.environ.get("EBCC_PIPELINE_DEPTH", "6")),
                max(1, len(slices) - 1))
    with ThreadPoolExecutor(max_workers=depth) as fetcher, \
            ThreadPoolExecutor(max_workers=2) as assembler:
        futs = [fetcher.submit(run_batch, s) for s in slices[:depth]]
        asm = []
        for i, b in enumerate(counts):
            out_np = futs[i].result()
            if i + depth < len(slices):
                futs.append(fetcher.submit(run_batch, slices[i + depth]))
            asm.append(assembler.submit(
                _assemble_batch, out_np, config, opts, n_frames, h, w,
                backend, error_mode, b))
        per_slice = [f.result() for f in asm]
    return [s for ss in per_slice for s in ss]


def _native_encoder(opts: Optional[EncodeOptions] = None,
                    config: Optional[CodecConfig] = None,
                    n_frames: int = 1):
    """The native C++ encoder module when the host encode path routes
    native (explicit ``EBCC_ENCODE_BACKEND=native`` or the automatic
    link-vs-cores decision, see ``core.routing``), else None.  An all-host
    encode (threaded across chunks) beats the device path when the
    host-device link is the bottleneck, and it makes the framework fully
    usable on machines with no accelerator.

    The C++ encoder reads the EBCC_* tuning env vars itself, so a
    programmatically-customized EncodeOptions cannot be forwarded — the
    AUTO route steps aside in that case (explicit ``native`` still wins;
    configure via the environment when routing natively)."""
    from . import routing

    choice = routing.explicit("encode")
    if choice is None:
        if opts is not None and opts != EncodeOptions.from_env():
            return None  # programmatic opts only flow through the device path
        if routing.backend_choice("encode") != "native":
            return None
    elif choice != "native":
        return None
    try:
        from .. import native as native_mod
        native_mod.load()
        return native_mod
    except Exception:
        logger.warning("EBCC_ENCODE_BACKEND=native requested but the native "
                       "codec is unavailable; using the device encoder")
        return None


def encode(data: np.ndarray, config: CodecConfig,
           opts: Optional[EncodeOptions] = None) -> bytes:
    """Encode one logical array (= one chunk) -> ETPU stream bytes.

    Parity: ``ebcc_encode`` (ebcc_codec.c:607-918).
    """
    set_level_from_env()
    opts = opts or EncodeOptions.from_env()
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    n_frames, h, w = _layout(config.dims)
    x = data.reshape(1, n_frames, h, w)
    logger.info("%s", config.describe())
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        nm = _native_encoder(opts, config, n_frames)
        if nm is not None:
            return nm.native_encode(x, config)
        return _lossless_encode_frames(x, config)[0]
    x, masks = _mask_fill_check(x, config.allow_nan)
    nm = _native_encoder(opts, config, n_frames)
    if nm is not None:
        s = nm.native_encode(x, config)
    else:
        s = _encode_chunk_batch(x, config, opts, skip_finite_check=True)[0]
    return _append_mask_sections([s], masks, config.zstd_level)[0]


def _parse_streams(streams):
    headers = []
    payloads = []
    temporal_parts = []
    mask_payloads = []
    for s in streams:
        hd, basep, resp = stream.split_frame_stream(s)
        # Sanity caps before any allocation sized from header fields
        # (robust-decoder posture: a corrupt header must raise, not OOM).
        if (hd.height > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.width > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.n_frames > 1 << 20
                or hd.base_levels > 10 or hd.res_levels > 10
                or hd.base_nplanes > 32 or hd.res_nplanes > 32):
            raise stream.StreamError("implausible ETPU header dimensions")
        headers.append(hd)
        payloads.append((basep, resp))
        # Const + temporal can co-occur (native encoder: const FRAME 0 in
        # a non-const chunk) — the delta records still apply.
        temporal_parts.append(stream.split_temporal_section(s, hd)
                              if hd.temporal else ([], []))
        if hd.masked:
            ent_id, mp = stream.split_mask_section(s, hd)
            if ent_id not in (entropy.BACKEND_STORE, entropy.BACKEND_ZSTD):
                raise stream.StreamError("invalid mask section backend")
            need = (hd.n_frames * hd.height * hd.width + 7) // 8
            raw = entropy.decompress(mp, ent_id, need)
            if len(raw) != need:
                raise stream.StreamError("mask section size mismatch")
            mask_payloads.append(raw)
        else:
            mask_payloads.append(None)
    h0 = headers[0]
    key = (h0.n_frames, h0.height, h0.width, h0.base_levels, h0.res_levels,
           h0.base_nplanes, h0.res_nplanes)
    for hd in headers[1:]:
        k = (hd.n_frames, hd.height, hd.width, hd.base_levels, hd.res_levels,
             hd.base_nplanes, hd.res_nplanes)
        if k != key:
            raise stream.StreamError("inconsistent chunk stream shapes")
    # Plain const chunks decode identically either way; every other stream
    # in a batch must agree on temporal-vs-intra (a temporal container can
    # still hold const chunks, serialized as plain CONST streams).
    tflags = {hd.temporal for hd in headers
              if hd.temporal or not hd.const_field}
    if len(tflags) > 1:
        raise stream.StreamError("inconsistent temporal flags across chunks")
    if all(m is None for m in mask_payloads):
        mask_payloads = None
    return headers, payloads, temporal_parts, mask_payloads


def _decode_streams_device(streams: List[bytes], sharding=None):
    """Decode a list of ETPU streams (must share shape) into a DEVICE array
    ``(N, d0, h, w)`` plus host-side (const_mask, minval).

    Single-device path: the sparse coefficient exchange (core.transfer) —
    host entropy-decodes the payloads, extracts (indices, signed
    kept-values), uploads both, and ONE device scatter + inverse transforms
    produce the batch.  With ``sharding`` the batched sparse arrays are laid
    out over the mesh so the program runs SPMD.
    """
    from concurrent.futures import ThreadPoolExecutor

    lossless_arr = _maybe_lossless_batch(streams)
    if lossless_arr is not None:
        n = lossless_arr.shape[0]
        return (jax.device_put(lossless_arr), np.zeros(n, bool),
                np.zeros(n, np.float32), None)
    headers, payloads, temporal_parts, nan_masks = _parse_streams(streams)
    h0 = headers[0]
    n = len(headers)
    d0, h, w = h0.n_frames, h0.height, h0.width
    hp, wp = _padded_hw(h, w, max(h0.base_levels, h0.res_levels))
    # Temporal streams decode as n_frames independent single-frame ENTRIES
    # per chunk (frame 0's two layers + one delta layer per later frame),
    # then a sequential accumulation adds each delta onto the previous
    # frame's reconstruction — the exact arithmetic the encoder's closed
    # prediction loop carried (kernels.encode_batch_temporal).
    temporal = any(hd.temporal for hd in headers)
    # Temporal streams stay SPMD under chunk-axis sharding: entries are
    # laid out chunk-major (j = chunk * T + frame) and the sharded caller
    # pads the CHUNK count to a mesh multiple, so shard boundaries always
    # land on chunk boundaries and each device scans its own chunks'
    # accumulation locally (verified: tests/test_temporal.py sharded
    # decode asserts the bound on an 8-device mesh).
    t_frames = d0 if temporal else 1
    ent_d0 = 1 if temporal else d0
    ne = n * t_frames
    sc = ent_d0 * hp * wp
    if ne > _max_safe_batch(sc):
        raise stream.StreamError(
            "decode batch exceeds int32 sparse-index space; use a smaller "
            "max_batch")

    minval = np.zeros(ne, np.float32)
    maxval = np.zeros(ne, np.float32)
    rmin = np.zeros(ne, np.float32)
    rmax = np.zeros(ne, np.float32)
    base_cut = np.zeros(ne, np.int32)
    res_cut = np.zeros(ne, np.int32)
    const_mask = np.zeros(n, bool)
    any_residual = temporal or any(hd.has_residual for hd in headers)

    wb = wp // 8
    plane_bytes = ent_d0 * hp * wb

    for i, hd in enumerate(headers):
        j = i * t_frames
        minval[j], maxval[j] = hd.minval, hd.maxval
        # const+temporal means only FRAME 0 is flat (the device entry for
        # it decodes to minval already); whole-chunk const fill applies to
        # plain const streams only.
        const_mask[i] = hd.const_field and not hd.temporal
        base_cut[j] = hd.base_cut
        if hd.has_residual:
            rmin[j], rmax[j] = hd.rmin, hd.rmax
            res_cut[j] = hd.res_cut
        for t, rec in enumerate(temporal_parts[i][0], start=1):
            if rec.cut > 32 or rec.top > 32:
                raise stream.StreamError("implausible delta record geometry")
            rmin[j + t], rmax[j + t] = rec.rmin, rec.rmax
            res_cut[j + t] = rec.cut

    # Host-side const fill wants one minval per CHUNK (the entry axis is
    # per-frame when temporal).  Log-domain chunks (pointwise-relative
    # mode) store log values: exp them for the const fill, and apply the
    # device-side exp as the last arithmetic step in _finish below.
    _chunk_minval = minval[::t_frames].copy() if temporal else minval.copy()
    log_flags = np.array([hd.log_domain for hd in headers], bool)
    if log_flags.any():
        with np.errstate(over="ignore"):
            _chunk_minval = np.where(
                log_flags, np.exp(_chunk_minval), _chunk_minval
            ).astype(np.float32)

    def _decompress_layer(hd, payload, which):
        """One chunk layer -> (raw bytes, kept, pb) where pb = bytes
        present in the LAST plane row (== plane_bytes unless the layer is a
        FLAG_BASE_PARTIAL prefix); (None, 0, 0) for an empty layer.
        Validation parity: reference decoder bounds checks
        (ebcc_codec.c:1235-1258)."""
        if which == "base":
            num_planes, cut, top = hd.base_nplanes, hd.base_cut, hd.base_top
            backend = hd.entropy
        else:
            num_planes, cut, top = hd.res_nplanes, hd.res_cut, hd.res_top
            backend = hd.res_entropy_effective
        kept = num_planes - cut - top
        if kept <= 0 or not payload:
            return None, 0, 0
        levels = hd.base_levels if which == "base" else hd.res_levels
        partial = which == "base" and bool(hd.flags
                                           & stream.FLAG_BASE_PARTIAL)
        max_size = (kept + 1) * plane_bytes
        if partial:
            if backend in (entropy.BACKEND_NATIVE_CAB,
                           entropy.BACKEND_NATIVE_CAB2):
                raise stream.StreamError(
                    "partial-plane payloads require a zstd/store entropy "
                    "layer")
            raw = entropy.decompress(payload, backend, max_size,
                                     meta=(kept, ent_d0, hp, wp, levels))
            pb = len(raw) - kept * plane_bytes
            if not 0 <= pb <= plane_bytes:
                raise stream.StreamError(
                    f"partial payload size {len(raw)} outside "
                    f"[{kept * plane_bytes}, {max_size}]")
            return raw, kept, pb
        raw = entropy.decompress(payload, backend, max_size,
                                 meta=(kept, ent_d0, hp, wp, levels))
        if len(raw) != max_size:
            raise stream.StreamError(
                f"decompressed payload size {len(raw)} != expected "
                f"{max_size}")
        return raw, kept, plane_bytes

    def _decompress_delta(rec, payload):
        # Delta geometry is measured against base_nplanes (the deeper
        # budget the adaptive quantization scale needs; see
        # config.DELTA_NUM_PLANES).
        kept = h0.base_nplanes - rec.cut - rec.top
        if kept <= 0 or not payload:
            return None, 0, 0
        max_size = (kept + 1) * plane_bytes
        raw = entropy.decompress(payload, rec.entropy, max_size,
                                 meta=(kept, ent_d0, hp, wp, h0.res_levels))
        if len(raw) != max_size:
            raise stream.StreamError(
                f"decompressed delta payload size {len(raw)} != expected "
                f"{max_size}")
        return raw, kept, plane_bytes

    def _decompress_one(j):
        i, t = divmod(j, t_frames)
        hd = headers[i]
        if hd.const_field and not hd.temporal:
            return (None, 0, 0), (None, 0, 0)
        if t > 0:
            records, dpayloads = temporal_parts[i]
            return (None, 0, 0), _decompress_delta(records[t - 1],
                                                   dpayloads[t - 1])
        basep, resp = payloads[i]
        base = _decompress_layer(hd, basep, "base")
        res = (_decompress_layer(hd, resp, "res") if hd.has_residual
               else (None, 0, 0))
        return base, res

    with stage("dec: entropy decode"):
        if ne <= 1:
            raws = [_decompress_one(j) for j in range(ne)]
        else:
            with ThreadPoolExecutor(max_workers=min(4, ne)) as pool:
                raws = list(pool.map(_decompress_one, range(ne)))

    def _layer_values(which: int):
        """Vectorized planes -> signed kept-values for one layer across the
        whole batch: bottom-aligned plane stack (leading zero planes do not
        change the magnitudes), ONE unpackbits + shift-accumulate per plane
        row over all chunks, one masked sign apply.  Returns (n, sc) int32
        or None when the layer is empty batch-wide."""
        kmax = max((r[which][1] for r in raws), default=0)
        if kmax == 0:
            return None
        planes = np.zeros((ne, kmax, plane_bytes), np.uint8)
        signs = np.zeros((ne, plane_bytes), np.uint8)
        for i, r in enumerate(raws):
            raw, kept, pb = r[which]
            if raw is None:
                continue
            pl = np.frombuffer(raw, np.uint8)
            off = kmax - kept
            full = kept - 1
            planes[i, off:off + full] = pl[: full * plane_bytes].reshape(
                full, plane_bytes)
            planes[i, off + full, :pb] = pl[full * plane_bytes:
                                            full * plane_bytes + pb]
            signs[i] = pl[full * plane_bytes + pb:]
        mag = np.zeros((ne, plane_bytes * 8), np.int32)
        for k in range(kmax):
            mag = (mag << 1) | np.unpackbits(planes[:, k], axis=-1)
        sb = np.unpackbits(signs, axis=-1).astype(bool)
        return np.where(sb, -mag, mag)

    nm = _native_unpacker()
    with stage("dec: unpack planes"):
        parts_idx = []
        parts_val = []
        if nm is not None:
            # C-speed sparse extraction per chunk-layer (ctypes releases
            # the GIL, so the pool gives real parallelism); (layer, chunk)
            # order keeps the concatenated global index sorted.
            def sparse_one(t):
                layer, j = t
                raw, kept, pb = raws[j][layer]
                if raw is None:
                    return None
                pos, vv = nm.planes_to_sparse(raw, kept, pb, ent_d0, hp, wp)
                return pos.astype(np.int64) + (layer * ne + j) * sc, vv

            tasks = [(l, j) for l in (0, 1) for j in range(ne)]
            if ne <= 1:
                results = [sparse_one(t) for t in tasks]
            else:
                with ThreadPoolExecutor(max_workers=min(4, 2 * ne)) as pool:
                    results = list(pool.map(sparse_one, tasks))
            for r in results:
                if r is not None and r[0].size:
                    parts_idx.append(r[0])
                    parts_val.append(r[1])
        else:
            for layer in (0, 1):
                v = _layer_values(layer)
                if v is None:
                    continue
                flat = v.reshape(-1)
                pos = np.flatnonzero(flat)
                parts_idx.append(pos.astype(np.int64) + layer * ne * sc)
                parts_val.append(flat[pos])
        idx = (np.concatenate(parts_idx) if parts_idx
               else np.zeros(0, np.int64))
        vals = (np.concatenate(parts_val) if idx.size
                else np.zeros(0, np.int32))
    cap = transfer.bucket_count(max(1, idx.size))

    def padded_vals():
        as16 = bool(np.abs(vals).max() < (1 << 15)) if vals.size else True
        up = np.zeros(cap, np.int16 if as16 else np.int32)
        up[: vals.size] = vals.astype(up.dtype)
        return up

    kw = dict(base_levels=h0.base_levels, res_levels=h0.res_levels,
              out_hw=(h, w), has_residual=any_residual,
              grid_shape=(ne, ent_d0, hp, wp))

    def _finish(out_dev):
        """Temporal entries -> accumulated frames (n, T, h, w); intra
        batches pass through.  Log-domain chunks get their exp here (the
        decoder's final arithmetic step, matching the encoder's verified
        criterion)."""
        if temporal:
            out_dev = kernels.temporal_accumulate(out_dev, t_frames=t_frames)
        if log_flags.any():
            fl = log_flags[:, None, None, None]
            fl_dev = (jax.device_put(fl, sharding) if sharding is not None
                      else jax.device_put(fl))
            out_dev = jnp.where(fl_dev, jnp.exp(out_dev), out_dev)
        return out_dev

    # Upload-leg representation: byte-coded gaps + zigzag values (~2 B per
    # significant coefficient, transfer.byte_pack_sparse_host) is the
    # default; the dense bitmap and the int32 index vector remain as the
    # sharded-path form and an env-selectable fallback
    # (EBCC_NO_BYTE_UPLOAD=1).  Bitmap wins over indices above ~1/32
    # density but both lose to the byte coding at every density.
    use_bytes = (sharding is None
                 and not os.environ.get("EBCC_NO_BYTE_UPLOAD"))
    use_bitmap = (sharding is None and not use_bytes
                  and 4 * cap > (2 * ne * sc) // 8)
    with stage("dec: upload sparse + decode"):
        scalars = [base_cut, res_cut, minval, maxval, rmin, rmax]
        if (use_bytes and not os.environ.get("EBCC_NO_RICE_UPLOAD")
                and cap <= transfer.COMPACT_CAP_LIMIT):
            # The cap gate mirrors the encode-direction rice legs:
            # rice_block_unpack derives lane bit offsets via int32 cumsum,
            # so total packed bits >= 2^31 (reachable around ~20M coeffs at
            # the 104-bit escape worst case) would silently overflow and
            # corrupt the decode.  Above the limit fall through to the
            # nibble/byte paths, whose offsets are element-indexed.
            # Blocked-Rice upload (~1.0 B per significant coefficient —
            # near the downlink's entropy) decoded on device by parallel
            # block lanes; nibble tiers remain the fallback below.
            with stage("dec: rice pack host"):
                pack = transfer.rice_block_pack_host
                if _rice_enabled():
                    from .. import native
                    pack = native.rice_block_pack  # GIL-free C loop
                words, lens_g, lens_v, k_packed, base_pos, nb = pack(
                    idx, vals)
            nbk = transfer.rice_block_bucket(nb)
            nwk = transfer.rice_block_bucket(words.size)
            n_ints = nbk + 2 * ne + 1
            buf = np.zeros(4 * nwk + 5 * nbk + 4 * n_ints + 16 * ne,
                           np.uint8)
            o = 0
            buf[:4 * words.size] = words.view(np.uint8)
            o += 4 * nwk
            # Padded lanes keep length 0 (cumsum-derived offsets stay
            # correct) and decode garbage that the nnz mask drops.
            buf[o:o + 2 * nb] = lens_g.view(np.uint8)
            o += 2 * nbk
            buf[o:o + 2 * nb] = lens_v.view(np.uint8)
            o += 2 * nbk
            buf[o:o + nb] = k_packed
            o += nbk
            ints = np.zeros(n_ints, np.int32)
            ints[:nb] = base_pos
            ints[nbk:nbk + ne] = base_cut
            ints[nbk + ne:nbk + 2 * ne] = res_cut
            ints[nbk + 2 * ne] = idx.size
            floats = np.stack([minval, maxval, rmin, rmax]).astype(
                np.float32)
            buf[o:o + 4 * n_ints] = ints.view(np.uint8)
            buf[o + 4 * n_ints:] = floats.reshape(-1).view(np.uint8)
            transfer.count_up(buf.nbytes)
            with stage("dec: rice device_put"):
                buf_dev = transfer.sliced_put(buf)
            with stage("dec: rice dispatch"):
                qflat, bc, rc, fl = kernels.rice_unpack_qflat(
                    buf_dev, n_blocks=nbk, n_words=nwk,
                    n_entries=ne, s=ne * ent_d0 * hp * wp)
                out = kernels.decode_from_qflat_program(qflat, bc, rc, fl,
                                                        **kw)
            return _finish(out), const_mask, _chunk_minval, nan_masks
        if use_bytes and not os.environ.get("EBCC_NO_NIBBLE_UPLOAD"):
            gt, vt = transfer.nibble_pack_sparse_host(idx, vals)
            if (transfer.nibble_fits(gt, cap, "gap")
                    and transfer.nibble_fits(vt, cap, "val")):
                nb2 = (cap + 1) // 2
                g8c, g16c, g32c = transfer.nib_tier_caps(cap, "gap")
                v8c, v16c, v32c = transfer.nib_tier_caps(cap, "val")
                n_bytes = 2 * nb2 + g8c + v8c + 2 * (g16c + v16c)
                n_ints = g32c + v32c + 2 * ne + 1
                # One fused upload buffer: [tier bytes | ints LE | floats
                # LE] — a single device_put instead of three (latency
                # dominates small uploads).
                buf = np.zeros(n_bytes + 4 * n_ints + 16 * ne, np.uint8)
                o = 0
                buf[o:o + nb2] = transfer.pack_nibbles(gt[0], cap)
                o += nb2
                buf[o:o + nb2] = transfer.pack_nibbles(vt[0], cap)
                o += nb2
                buf[o:o + gt[1].size] = gt[1]
                o += g8c
                buf[o:o + vt[1].size] = vt[1]
                o += v8c
                buf[o:o + 2 * gt[2].size] = gt[2].astype(
                    "<u2").view(np.uint8)
                o += 2 * g16c
                buf[o:o + 2 * vt[2].size] = vt[2].astype(
                    "<u2").view(np.uint8)
                ints = np.zeros(n_ints, np.int32)
                ints[: gt[3].size] = gt[3]
                ints[g32c: g32c + vt[3].size] = vt[3]
                ints[g32c + v32c: g32c + v32c + ne] = base_cut
                ints[g32c + v32c + ne: g32c + v32c + 2 * ne] = res_cut
                ints[g32c + v32c + 2 * ne] = idx.size
                floats = np.stack([minval, maxval, rmin, rmax]).astype(
                    np.float32)
                buf[n_bytes:n_bytes + 4 * n_ints] = ints.view(np.uint8)
                buf[n_bytes + 4 * n_ints:] = floats.reshape(-1).view(
                    np.uint8)
                transfer.count_up(buf.nbytes)
                out = kernels.decode_batch_sparse_nibble_fused(
                    transfer.sliced_put(buf), cap=cap, **kw)
                return _finish(out), const_mask, _chunk_minval, nan_masks
        if use_bytes:
            g8, g_ov, v8, v_ov16, v_ov32 = transfer.byte_pack_sparse_host(
                idx, vals)
            gcap = transfer.overflow_bucket(max(1, g_ov.size))
            vcap = transfer.overflow_bucket(max(1, v_ov16.size))
            wcap = transfer.overflow_bucket(max(1, v_ov32.size))
            # One buffer per dtype -> three uploads total (latency, not
            # bandwidth, prices small transfers).
            bytes_u8 = np.zeros(2 * cap + 2 * vcap, np.uint8)
            bytes_u8[: g8.size] = g8
            bytes_u8[cap: cap + v8.size] = v8
            bytes_u8[2 * cap: 2 * cap + 2 * v_ov16.size] = (
                v_ov16.astype("<u2").view(np.uint8))
            ints = np.zeros(gcap + wcap + 2 * ne + 1, np.int32)
            ints[: g_ov.size] = g_ov
            ints[gcap: gcap + v_ov32.size] = v_ov32
            ints[gcap + wcap: gcap + wcap + ne] = base_cut
            ints[gcap + wcap + ne: gcap + wcap + 2 * ne] = res_cut
            ints[gcap + wcap + 2 * ne] = idx.size
            floats = np.stack([minval, maxval, rmin, rmax]).astype(np.float32)
            transfer.count_up(bytes_u8.nbytes + ints.nbytes + floats.nbytes)
            out = kernels.decode_batch_sparse_bytes(
                jax.device_put(bytes_u8), jax.device_put(ints),
                jax.device_put(floats), cap=cap, gcap=gcap, vcap=vcap,
                wcap=wcap, **kw)
            return _finish(out), const_mask, _chunk_minval, nan_masks
        if use_bitmap:
            sigb = np.zeros(2 * ne * sc, np.uint8)
            sigb[idx] = 1
            packed = np.packbits(sigb)
            pv = padded_vals()
            transfer.count_up(packed.nbytes + pv.nbytes
                              + sum(a.nbytes for a in scalars))
            out = kernels.decode_batch_sparse_bitmap(
                jax.device_put(packed), jax.device_put(pv),
                *(jax.device_put(a) for a in scalars), **kw)
            return _finish(out), const_mask, _chunk_minval, nan_masks
        idx_up = transfer.pad_index(idx.astype(np.int32), cap, -1)
        pv = padded_vals()
        transfer.count_up(idx_up.nbytes + pv.nbytes
                          + sum(a.nbytes for a in scalars))
        args = [jax.device_put(idx_up), jax.device_put(pv)] + [
            jax.device_put(a) for a in scalars]
        if sharding is not None:
            # SPMD layout: scalars shard on the chunk axis; the sparse
            # vectors are replicated (their scatter targets span chunks).
            import jax.sharding as jsh
            mesh = sharding.mesh
            repl = jsh.NamedSharding(mesh, jsh.PartitionSpec())
            args = ([jax.device_put(a, repl) for a in args[:2]]
                    + [jax.device_put(a, sharding) for a in args[2:]])
        out = kernels.decode_batch_sparse(*args, **kw)
    return _finish(out), const_mask, _chunk_minval, nan_masks


def _maybe_lossless_batch(streams: List[bytes]):
    """-> decoded (N, d0, h, w) array when the batch is lossless streams,
    else None (cheap flags-byte peek; mixed batches are rejected)."""
    if not streams or len(streams[0]) <= 5 or not (
            streams[0][5] & stream.FLAG_LOSSLESS):
        return None
    headers = [stream.split_frame_stream(s)[0] for s in streams]
    if not all(hd.lossless for hd in headers):
        raise stream.StreamError("mixed lossless/lossy batch")
    return _lossless_decode_streams(headers, streams)


def _decode_streams(streams: List[bytes], sharding=None) -> np.ndarray:
    """Host-resident decode: :func:`_decode_streams_device` + fetch.
    Lossless batches decode entirely on host (no device bounce)."""
    arr = _maybe_lossless_batch(streams)
    if arr is not None:
        return arr
    out, const_mask, minval, nanm = _decode_streams_device(streams, sharding)
    transfer.count_down(out.nbytes)
    out = np.array(jax.device_get(out))  # copy: device_get can be read-only
    if const_mask.any():
        out[const_mask] = minval[const_mask, None, None, None]
    return _apply_nan_masks_host(out, nanm)


def encode_frames_device(x_dev, config: CodecConfig,
                         opts: Optional[EncodeOptions] = None,
                         max_batch: Optional[int] = None) -> List[bytes]:
    """Device-resident encode: ``x_dev`` is a ``(B, n_frames, h, w)`` jax
    array already living in device memory (e.g. compressing
    model/simulation output or re-compressing an archive that is consumed on
    device).  Only compressed-domain data crosses the host link.  Returns
    one ETPU stream per batch entry.

    Input contract: callers own the NaN/Inf check for DEVICE arrays — the
    host-side ``np.isfinite`` gate (and the ``allow_nan`` mask/fill, a
    host-input feature) cannot run on them, and non-finite device input
    yields a garbage stream.  Numpy inputs get the full gate, including
    ``allow_nan`` masking.

    ``max_batch`` splits the batch into sub-batches run through the 2-stage
    pipeline (device+link work for slice k+1 overlaps host entropy coding
    of slice k)."""
    opts = opts or EncodeOptions.from_env()
    b, n_frames, h, w = x_dev.shape
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        # No device work to pipeline, but max_batch still bounds peak host
        # memory (each slice is device_get'd and coded independently).
        if max_batch is None or b <= max_batch:
            return _encode_chunk_batch(x_dev, config, opts)
        out: List[bytes] = []
        for s in range(0, b, max_batch):
            out.extend(_encode_chunk_batch(x_dev[s:s + max_batch], config,
                                           opts))
        return out
    if max_batch is None or b <= max_batch:
        return _encode_chunk_batch(x_dev, config, opts)
    masks = None
    orig_config = config
    if isinstance(x_dev, np.ndarray):
        x_dev, masks = _mask_fill_check(x_dev, config.allow_nan)
    x_dev, config = _log_transform_check(x_dev, config)
    slices = [x_dev[s:s + max_batch] for s in range(0, b, max_batch)]
    counts = [s.shape[0] for s in slices]
    streams = _pipeline_encode_slices(slices, counts, config, opts,
                                      n_frames, h, w)
    streams = _set_log_flags(streams, config, orig_config)
    return _append_mask_sections(streams, masks, config.zstd_level)


def decode_frames_device(streams: List[bytes], max_batch: Optional[int] = None):
    """Device-resident decode: returns a ``(B, n_frames, h, w)`` jax array
    still in device memory (feed it straight into a device consumer).  Only the
    compressed-domain payloads cross the host link.

    ``max_batch`` pipelines host-side parsing/entropy decode of sub-batch
    k+1 under the device work of sub-batch k."""
    if max_batch is None or len(streams) <= max_batch:
        out, _, _, nanm = _decode_streams_device(streams)
        return _apply_nan_masks_device(out, nanm)
    from concurrent.futures import ThreadPoolExecutor

    batches = [streams[s:s + max_batch]
               for s in range(0, len(streams), max_batch)]
    depth = min(2, len(batches))
    outs = []
    with ThreadPoolExecutor(max_workers=depth) as worker:
        futs = [worker.submit(_decode_streams_device, b)
                for b in batches[:depth]]
        for i in range(len(batches)):
            out, _, _, nanm = futs[i].result()
            if i + depth < len(batches):
                futs.append(worker.submit(_decode_streams_device,
                                          batches[i + depth]))
            outs.append(_apply_nan_masks_device(out, nanm))
    return jnp.concatenate(outs, axis=0)


def roundtrip_frames_device(x_dev, config: CodecConfig,
                            opts: Optional[EncodeOptions] = None,
                            max_batch: Optional[int] = None):
    """Device-resident encode THEN decode of the same frames, pipelined:
    sub-batch k's decode (upload-heavy) runs while sub-batch k+1 encodes
    (download-heavy), so the two link directions overlap (full duplex) and
    total wall time approaches max(encode, decode) instead of their sum.

    The transcode/verify-after-write shape: streams fully materialize on
    host per sub-batch (byte-identical to ``encode_frames_device``), and
    the decoded batch returns in HBM.  Returns ``(streams, decoded)``.
    """
    from concurrent.futures import ThreadPoolExecutor

    opts = opts or EncodeOptions.from_env()
    b, n_frames, h, w = x_dev.shape
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        # No device work to pipeline; max_batch still bounds host memory.
        streams = encode_frames_device(x_dev, config, opts, max_batch)
        step = max_batch or len(streams)
        outs = []
        for s in range(0, len(streams), max(1, step)):
            o, _, _, _ = _decode_streams_device(streams[s:s + step])
            outs.append(o)
        return streams, (outs[0] if len(outs) == 1
                         else jnp.concatenate(outs, axis=0))
    if max_batch is None or b <= max_batch:
        streams = _encode_chunk_batch(x_dev, config, opts)
        out, _, _, nanm = _decode_streams_device(streams)
        return streams, _apply_nan_masks_device(out, nanm)

    orig_config = config
    masks = None
    if isinstance(x_dev, np.ndarray):
        x_dev, masks = _mask_fill_check(x_dev, config.allow_nan)
    x_dev, config = _log_transform_check(x_dev, config)
    starts = list(range(0, b, max_batch))
    slices = [x_dev[s:s + max_batch] for s in starts]
    error_mode = config.residual_mode != cfg.RESIDUAL_NONE
    backend = entropy.backend_id(config)

    def run_batch(sl):
        return _fetch_encode_outputs(
            encode_batch_device(_pad_min_batch(sl), config, opts),
            error_mode)

    def post_batch(i, out_np, count):
        """Assemble slice i's streams, then start its device decode —
        runs on a worker so host entropy/assembly work overlaps the link
        legs of the other slices (nothing heavy on the main thread)."""
        streams = _assemble_batch(out_np, config, opts, n_frames, h, w,
                                  backend, error_mode, count)
        streams = _set_log_flags(streams, config, orig_config)
        if masks is not None:
            s0 = starts[i]
            streams = _append_mask_sections(
                streams, masks[s0:s0 + count], config.zstd_level)
        out, _, _, nanm = _decode_streams_device(streams)
        return streams, _apply_nan_masks_device(out, nanm)

    depth = min(int(os.environ.get("EBCC_PIPELINE_DEPTH", "6")),
                max(1, len(slices) - 1))
    # Poster width: zstd assembly is light, while the CAB backend spends
    # far more coder CPU per sub-batch in post_batch; wider posting
    # overlaps more of it with the link legs (the coder releases the GIL
    # inside the ctypes call).
    posters = int(os.environ.get("EBCC_PIPELINE_POSTERS",
                                 "4" if backend != entropy.BACKEND_ZSTD
                                 else "2"))
    with ThreadPoolExecutor(max_workers=depth) as fetcher, \
            ThreadPoolExecutor(max_workers=max(1, posters)) as poster:
        futs = [fetcher.submit(run_batch, s) for s in slices[:depth]]
        post_futs = []
        for i, sl in enumerate(slices):
            out_np = futs[i].result()
            if i + depth < len(slices):
                futs.append(fetcher.submit(run_batch, slices[i + depth]))
            post_futs.append(poster.submit(post_batch, i, out_np,
                                           sl.shape[0]))
        results = [f.result() for f in post_futs]
    streams_out = [s for streams, _ in results for s in streams]
    return streams_out, jnp.concatenate([d for _, d in results], axis=0)


def _native_decoder():
    """The native C++ decoder module when the host decode path routes
    native (explicit ``EBCC_DECODE_BACKEND=native`` or the automatic
    link-vs-cores decision, see ``core.routing``), else None.

    Why: a host-destined decode through the accelerator pays two link
    transfers per batch; the native decoder runs entirely on the host CPU
    (and threads across chunks), which wins whenever the link — not
    compute — is the bottleneck.  Native reconstruction matches the device
    decoder to float32 rounding (see native/etpu_codec.h), so the shipped
    bound holds up to that ulp-level noise."""
    from . import routing

    choice = routing.explicit("decode")
    if choice is None:
        if routing.backend_choice("decode") != "native":
            return None
    elif choice != "native":
        return None
    try:
        from .. import native as native_mod
        native_mod.load()
        return native_mod
    except Exception:
        logger.warning("EBCC_DECODE_BACKEND=native requested but the native "
                       "codec is unavailable; using the device decoder")
        return None


def decode(buf: bytes) -> np.ndarray:
    """Decode one ETPU stream -> (n_frames, h, w) float32.

    Parity: ``ebcc_decode`` (ebcc_codec.c:1215-1320); like the reference this
    accepts either a plain frame stream or (for convenience) dispatches a
    chunked container to :func:`decode_chunked`.
    """
    if buf[:4] == stream.MAGIC_CHUNKED:
        return decode_chunked(buf)
    if buf[:4] in (b"EBCC", b"EBCK"):
        # Reference-format stream (the original codec's magics): decode
        # through the legacy interop layer (compat/legacy.py), like the
        # reference's own magic dispatch accepts older layouts (c:1222).
        from .. import compat
        return compat.decode(buf)
    nm = _native_decoder()
    if nm is not None:
        header, _, _ = stream.split_frame_stream(buf)
        return nm.native_decode(buf).reshape(
            header.n_frames, header.height, header.width)
    return _decode_streams([buf])[0]


# ---------------------------------------------------------------------------
# Chunked container paths (parity: ebcc_encode_chunking /
# ebcc_encode_chunking_compat / ebcc_decode_chunking, ebcc_codec.c:920-1449).
# ---------------------------------------------------------------------------

def _chunk_grid(dims, chunk_dims):
    counts = tuple(-(-d // c) for d, c in zip(dims, chunk_dims))
    return counts


def _gather_chunks(data: np.ndarray, chunk_dims, counts) -> np.ndarray:
    """Extract the full chunk batch with edge-replicate padding for partial
    edge chunks (parity: copy_chunk_from_data_padded, ebcc_codec.c:339-351).
    One vectorized numpy gather instead of a per-chunk loop."""
    dims = data.shape
    idx = []
    for d, c, n in zip(dims, chunk_dims, counts):
        ax = (np.arange(n)[:, None] * c + np.arange(c)[None, :])
        idx.append(np.minimum(ax, d - 1))  # clamp = edge replication
    g = data[
        idx[0][:, None, None, :, None, None],
        idx[1][None, :, None, None, :, None],
        idx[2][None, None, :, None, None, :],
    ]  # (n0, n1, n2, c0, c1, c2)
    return g.reshape(-1, *chunk_dims)


def _scatter_chunks(chunks: np.ndarray, dims, chunk_dims, counts) -> np.ndarray:
    """Inverse of :func:`_gather_chunks` (drops padding; parity:
    copy_chunk_to_data_unpadded, ebcc_codec.c:353-370)."""
    n0, n1, n2 = counts
    c0, c1, c2 = chunk_dims
    full = chunks.reshape(n0, n1, n2, c0, c1, c2).transpose(0, 3, 1, 4, 2, 5)
    full = full.reshape(n0 * c0, n1 * c1, n2 * c2)
    return np.ascontiguousarray(full[: dims[0], : dims[1], : dims[2]])


def encode_chunked(data: np.ndarray, config: CodecConfig,
                   opts: Optional[EncodeOptions] = None,
                   max_batch: int = DEFAULT_MAX_BATCH) -> bytes:
    """Chunked encode -> ETPK container.

    Parity: ``ebcc_encode_chunking`` (ebcc_codec.c:920-1052), with the serial
    per-chunk loop replaced by batched device encodes over all chunks.
    """
    set_level_from_env()
    opts = opts or EncodeOptions.from_env()
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)

    chunk_dims = tuple(config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = tuple(config.dims)
    if any(c == 0 for c in chunk_dims):
        raise ValueError("dims and chunk_dims must be non-zero")
    # validation parity (ebcc_codec.c:937-941)
    _layout(chunk_dims)

    counts = _chunk_grid(config.dims, chunk_dims)
    num_chunks = int(np.prod(counts))
    chunk_size = int(np.prod(chunk_dims))
    total = int(np.prod(config.dims))
    padded = chunk_size * num_chunks
    if padded > total and padded - total > total // 10:
        logger.warning(
            "Chunk padding adds %d values over %d real values (%.2f%%)",
            padded - total, total, 100.0 * (padded - total) / total)

    chunks = _gather_chunks(data, chunk_dims, counts)
    n_frames, h, w = _layout(chunk_dims)
    chunks = chunks.reshape(num_chunks, n_frames, h, w)
    hp, wp = _padded_hw(h, w, max(config.base_levels, config.residual_levels))
    max_batch = min(max_batch, _max_safe_batch(n_frames * hp * wp))

    chunk_cfg = config.per_chunk(chunk_dims)

    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        nm = _native_encoder(opts, config, n_frames)
        if nm is not None:
            from concurrent.futures import ThreadPoolExecutor

            workers = max(1, min(os.cpu_count() or 1, num_chunks))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                streams_out = list(pool.map(
                    lambda c: nm.native_encode(c, chunk_cfg), chunks))
        else:
            streams_out = _lossless_encode_frames(chunks, chunk_cfg)
        header = stream.ChunkedHeader(
            dims=tuple(config.dims), chunk_dims=chunk_dims,
            num_chunks=num_chunks, chunk_size=chunk_size)
        return stream.pack_chunked(header, streams_out)

    chunks, masks = _mask_fill_check(chunks, config.allow_nan)

    nm = _native_encoder(opts, config, n_frames)
    if nm is not None:
        from concurrent.futures import ThreadPoolExecutor

        workers = max(1, min(os.cpu_count() or 1, num_chunks))
        with stage("enc: native"):
            with ThreadPoolExecutor(max_workers=workers) as pool:
                streams_out = list(pool.map(
                    lambda c: nm.native_encode(c, chunk_cfg), chunks))
        streams_out = _append_mask_sections(streams_out, masks,
                                            config.zstd_level)
        header = stream.ChunkedHeader(
            dims=tuple(config.dims), chunk_dims=chunk_dims,
            num_chunks=num_chunks, chunk_size=chunk_size)
        return stream.pack_chunked(header, streams_out)

    chunks, chunk_cfg = _log_transform_check(chunks, chunk_cfg)

    slices, counts_per = [], []
    for start in range(0, num_chunks, max_batch):
        sl = chunks[start:start + max_batch]
        b = sl.shape[0]
        if b < max_batch and num_chunks > max_batch:
            # pad to the bucket size to reuse the compiled program
            sl = np.concatenate(
                [sl, np.repeat(sl[-1:], max_batch - b, axis=0)], axis=0)
        slices.append(sl)
        counts_per.append(b)

    streams_out = _pipeline_encode_slices(slices, counts_per, chunk_cfg,
                                          opts, n_frames, h, w)
    streams_out = _set_log_flags(streams_out, chunk_cfg, config)
    streams_out = _append_mask_sections(streams_out, masks, config.zstd_level)

    header = stream.ChunkedHeader(
        dims=tuple(config.dims), chunk_dims=chunk_dims,
        num_chunks=num_chunks, chunk_size=chunk_size)
    return stream.pack_chunked(header, streams_out)


def encode_chunked_compat(data: np.ndarray, config: CodecConfig,
                          opts: Optional[EncodeOptions] = None) -> bytes:
    """Parity: ``ebcc_encode_chunking_compat`` (ebcc_codec.c:1054-1090) —
    defaults chunk dims to (1, <=1024, <=1024) tiles and converts
    RELATIVE_ERROR to MAX_ERROR using the GLOBAL data range so the bound is
    uniform across chunks."""
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    compat = CodecConfig(**{**config.__dict__})
    if all(c == 0 for c in compat.chunk_dims):
        d = compat.dims
        # Temporal prediction runs along the chunk's leading axis, so the
        # reference's per-frame default tiles would silently disable it;
        # default to 8-frame groups instead (CR/random-access tradeoff —
        # set chunk_dims explicitly for longer prediction chains).
        lead = min(d[0], 8) if compat.temporal else 1
        compat.chunk_dims = (
            lead,
            1024 if d[1] > cfg.MAX_INTERNAL_IMAGE_DIM else d[1],
            1024 if d[2] > cfg.MAX_INTERNAL_IMAGE_DIM else d[2])
        logger.info("compat chunk dimensions: %s", compat.chunk_dims)
    if compat.residual_mode == cfg.RESIDUAL_RELATIVE_ERROR:
        if compat.allow_nan:
            if np.isinf(data).any():
                raise ValueError("Inf found in data")
            rng = float(np.nanmax(data) - np.nanmin(data))
            if not np.isfinite(rng):
                raise ValueError("relative mode needs at least one valid "
                                 "sample to derive the range")
        else:
            if not np.isfinite(data).all():
                raise ValueError("NaN or Inf found in data")
            rng = float(data.max() - data.min())
        compat.error = compat.error * rng
        compat.residual_mode = cfg.RESIDUAL_MAX_ERROR
    return encode_chunked(data, compat, opts)


def decode_chunked(buf: bytes, max_batch: int = DEFAULT_MAX_BATCH) -> np.ndarray:
    """Decode an ETPK container -> array shaped like the original dims.

    Parity: ``ebcc_decode_chunking`` (ebcc_codec.c:1322-1449) including the
    plain-stream dispatch for non-ETPK payloads (c:1326-1329)."""
    if buf[:4] != stream.MAGIC_CHUNKED:
        return decode(buf)
    header, chunk_streams = stream.iter_chunked(buf)
    counts = _chunk_grid(header.dims, header.chunk_dims)
    if int(np.prod(counts)) != header.num_chunks:
        raise stream.StreamError("inconsistent chunk metadata")
    if int(np.prod(header.chunk_dims)) != header.chunk_size:
        raise stream.StreamError("inconsistent chunk metadata")
    n_frames_c, h_c, w_c = _layout(header.chunk_dims)
    hp_c, wp_c = _padded_hw(h_c, w_c, 5)
    max_batch = min(max_batch, _max_safe_batch(n_frames_c * hp_c * wp_c))

    nm = _native_decoder()
    if nm is not None:
        from concurrent.futures import ThreadPoolExecutor

        workers = min(os.cpu_count() or 1, len(chunk_streams))
        with stage("dec: native"):
            with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
                parts = list(pool.map(nm.native_decode, chunk_streams))
        chunks = np.stack(parts).reshape(header.num_chunks,
                                         *header.chunk_dims)
        return _scatter_chunks(chunks, header.dims, header.chunk_dims,
                               counts)

    return _decode_chunk_subset(header, chunk_streams, counts,
                                header.dims, max_batch)


def decode_chunked_region(buf: bytes, region,
                          max_batch: int = DEFAULT_MAX_BATCH) -> np.ndarray:
    """Random-access decode of a sub-region from an ETPK container.

    ``region`` is a 3-tuple of ``(start, stop)`` pairs (or slices with
    step 1) in the container's logical dims; only the chunks intersecting
    the region are parsed, entropy-decoded, and sent through the device —
    the capability chunk independence exists for (the reference leans on
    HDF5 chunking for this; a standalone ETPK gets it here).  Returns an
    array of the region's shape.
    """
    if buf[:4] != stream.MAGIC_CHUNKED:
        raise stream.StreamError("region decode needs an ETPK container")
    header, chunk_streams = stream.iter_chunked(buf)
    counts = _chunk_grid(header.dims, header.chunk_dims)
    if int(np.prod(counts)) != header.num_chunks:
        raise stream.StreamError("inconsistent chunk metadata")
    n_frames_c, h_c, w_c = _layout(header.chunk_dims)
    hp_c, wp_c = _padded_hw(h_c, w_c, 5)
    max_batch = min(max_batch, _max_safe_batch(n_frames_c * hp_c * wp_c))

    bounds = []
    for d, r in enumerate(region):
        if isinstance(r, slice):
            if r.step not in (None, 1):
                raise ValueError("region slices must have step 1")
            lo = 0 if r.start is None else int(r.start)
            hi = header.dims[d] if r.stop is None else int(r.stop)
        else:
            lo, hi = (int(r[0]), int(r[1]))
        if not 0 <= lo < hi <= header.dims[d]:
            raise ValueError(
                f"region {region} outside dims {header.dims} (axis {d})")
        bounds.append((lo, hi))

    # chunk index ranges intersecting the region, per axis
    crange = [range(lo // c, -(-hi // c))
              for (lo, hi), c in zip(bounds, header.chunk_dims)]
    ids = [
        (i0 * counts[1] + i1) * counts[2] + i2
        for i0 in crange[0] for i1 in crange[1] for i2 in crange[2]
    ]
    sub_streams = [chunk_streams[i] for i in ids]
    sub_counts = tuple(len(r) for r in crange)
    origin = tuple(r.start * c for r, c in zip(crange, header.chunk_dims))
    covered = tuple(len(r) * c for r, c in zip(crange, header.chunk_dims))
    # Decode the covering chunk block, then crop to the exact region.
    # Chunks at the container's edge decode to full chunk_dims (they were
    # encoded edge-replicated); clamp the covered extent to the dims.
    block_dims = tuple(min(o + cv, d) - o for o, cv, d
                       in zip(origin, covered, header.dims))
    nm = _native_decoder()
    if nm is not None:
        from concurrent.futures import ThreadPoolExecutor

        workers = max(1, min(os.cpu_count() or 1, len(sub_streams)))
        with stage("dec: native region"):
            with ThreadPoolExecutor(max_workers=workers) as pool:
                parts = list(pool.map(nm.native_decode, sub_streams))
        chunks = np.stack(parts).reshape(len(sub_streams),
                                         *header.chunk_dims)
        block = _scatter_chunks(chunks, block_dims, header.chunk_dims,
                                sub_counts)
    else:
        block = _decode_chunk_subset(header, sub_streams, sub_counts,
                                     block_dims, max_batch)
    sl = tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(bounds, origin))
    return np.ascontiguousarray(block[sl])


def _decode_chunk_subset(header, chunk_streams, counts, out_dims,
                         max_batch) -> np.ndarray:
    """Decode a chunk-stream list laid out on a ``counts`` grid into an
    array of ``out_dims`` (the grid's coverage, clipped to the container's
    dims).  The pipeline overlaps parse/entropy-decode/upload of batch k+1
    with the device work and output fetch of batch k.  Lossless chunks
    decode entirely on host."""
    arr = _maybe_lossless_batch(chunk_streams)
    if arr is not None:
        chunks = arr.reshape(len(chunk_streams), *header.chunk_dims)
        return _scatter_chunks(chunks, out_dims, header.chunk_dims, counts)
    from concurrent.futures import ThreadPoolExecutor

    batches = [chunk_streams[s:s + max_batch]
               for s in range(0, len(chunk_streams), max_batch)]
    decoded = []
    with ThreadPoolExecutor(max_workers=1) as worker:
        fut = worker.submit(_decode_streams_device, batches[0])
        for i in range(len(batches)):
            out, const_mask, minval, nanm = fut.result()
            if i + 1 < len(batches):
                fut = worker.submit(_decode_streams_device, batches[i + 1])
            with stage(f"dec: output fetch batch {i}"):
                arr = np.array(jax.device_get(out))
            if const_mask.any():
                arr[const_mask] = minval[const_mask, None, None, None]
            decoded.append(_apply_nan_masks_host(arr, nanm))
    chunks = np.concatenate(decoded, axis=0)
    chunks = chunks.reshape(len(chunk_streams), *header.chunk_dims)
    return _scatter_chunks(chunks, out_dims, header.chunk_dims, counts)
