"""Host-side lossless entropy backends for packed bitplane payloads.

Role parity: the reference backends are (a) OpenJPEG's EBCOT/MQ arithmetic
coder inside the J2K base codestream and (b) zstd level 22 over the SPIHT
residual bytes (reference ``src/ebcc_codec.c:813-817, 1301``).  Here all
entropy coding is host-side (accelerators don't entropy-code), is
applied to the device-produced dense bitplane payloads of BOTH layers, and is
pluggable: a backend id byte is recorded in every stream header so formats
can evolve (zstd today, the native context-modeling coder as it lands).

zstd notes: level is configurable (default well below the reference's 22 —
level 22 costs ~100x encode time for a few % on these structured bitmask
payloads; the bench sweeps this trade-off).  zstd frames come from the
``zstandard`` package when it is installed, and otherwise from the system
libzstd through the native library: the frame format is the same either
way.  Without either, asking for zstd raises — it never degrades to STORE.
"""

from __future__ import annotations

from ..utils.logging import logger

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None
    logger.warning("zstandard not installed: zstd (entropy id 1) runs "
                   "through the native library's libzstd")

BACKEND_STORE = 0
BACKEND_ZSTD = 1
BACKEND_NATIVE_CAB = 2  # native context-adaptive binary coder (cab_coder.cc)
BACKEND_AUTO = 3        # pseudo-id: try zstd AND cab, keep the smaller
                        # (never appears in streams)
BACKEND_NATIVE_CAB2 = 4  # relaxed-eligibility CAB profile: ~2x fewer coder
                         # calls for ~1-2% stream growth (the throughput
                         # point's backend; cab_coder.cc file header)


def compress(data: bytes, backend: int = BACKEND_ZSTD, level: int = 9,
             threads: int = 0, meta=None) -> bytes:
    """``meta`` = (kept, d0, hp, wp, levels), required by the CAB backend
    (its context model walks the payload's plane structure)."""
    if backend == BACKEND_STORE:
        return bytes(data)
    if backend == BACKEND_ZSTD:
        # Checksummed frames: a flipped payload byte must fail loudly at
        # decode, not silently reconstruct garbage (robust-decoder posture).
        if _zstd is None:
            from .. import native

            return native.zstd_compress(bytes(data), level)
        cctx = _zstd.ZstdCompressor(level=level, threads=threads,
                                    write_checksum=True)
        return cctx.compress(data)
    if backend == BACKEND_NATIVE_CAB:
        from .. import native

        return native.cab_compress(data, *meta)
    if backend == BACKEND_NATIVE_CAB2:
        from .. import native

        return native.cab2_compress(data, *meta)
    raise ValueError(f"unknown entropy backend {backend}")


def decompress(data: bytes, backend: int, orig_size: int, meta=None) -> bytes:
    if backend == BACKEND_STORE:
        return bytes(data)
    if backend == BACKEND_ZSTD:
        if _zstd is None:
            from .. import native

            return native.zstd_decompress(bytes(data), orig_size)
        dctx = _zstd.ZstdDecompressor()
        try:
            return dctx.decompress(data, max_output_size=orig_size)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupt entropy payload: {e}") from e
    if backend == BACKEND_NATIVE_CAB:
        from .. import native

        return native.cab_decompress(data, *meta)
    if backend == BACKEND_NATIVE_CAB2:
        from .. import native

        return native.cab2_decompress(data, *meta)
    raise ValueError(f"unknown entropy backend {backend}")


def backend_id(config) -> int:
    """Resolve a CodecConfig's entropy backend to its (pseudo-)id."""
    name = getattr(config, "entropy_backend", "zstd")
    if name == "cab":
        return BACKEND_NATIVE_CAB
    if name == "cab2":
        return BACKEND_NATIVE_CAB2
    if name == "auto":
        return BACKEND_AUTO
    return BACKEND_ZSTD


def compress_best(data: bytes, backend: int, level: int, meta):
    """-> (compressed, backend_id_used).  For BACKEND_AUTO, compress with
    both real backends and keep the smaller."""
    if backend != BACKEND_AUTO:
        return compress(data, backend, level, meta=meta), backend
    z = compress(data, BACKEND_ZSTD, level)
    try:
        c = compress(data, BACKEND_NATIVE_CAB, level, meta=meta)
    except Exception:
        return z, BACKEND_ZSTD
    return (c, BACKEND_NATIVE_CAB) if len(c) < len(z) else (z, BACKEND_ZSTD)
