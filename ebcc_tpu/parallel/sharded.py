"""Sharded (multi-device) encode/decode over a chunk batch.

The device programs in ``core.kernels`` are pure SPMD over the leading chunk
axis, so scale-out is sharding-annotation-only: place the chunk batch with a
``NamedSharding`` over the mesh and jit the same program — XLA partitions it
with zero inserted collectives (the decomposition is halo-free by design,
SURVEY §2.9).  The one semantic collective (global min/max for the compat
RELATIVE->MAX conversion, mirroring reference ebcc_codec.c:1078-1087) is a
``psum``-style reduction expressed here as a tiny sharded program.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec
from . import mesh as mesh_lib


def global_range(data_sharded, mesh) -> tuple:
    """Global (min, max) over a sharded array — the compat-mode collective."""
    sharding = mesh_lib.batch_sharding(mesh)

    @jax.jit
    def _mm(x):
        return x.min(), x.max()

    x = jax.device_put(data_sharded, sharding)
    lo, hi = _mm(x)
    return float(lo), float(hi)


def encode_chunked_sharded(data: np.ndarray, config: CodecConfig,
                           opts: Optional[EncodeOptions] = None,
                           mesh=None) -> bytes:
    """Sharded version of :func:`ebcc_tpu.encode_chunked`: the chunk batch is
    laid out over the mesh, one jitted program encodes every shard in
    parallel, and the (host-side) stream assembly walks the gathered result.

    Semantics match the unsharded path; byte-level output is identical in
    practice on smooth data (pinned by tests) but NOT contractual — XLA
    may compile ulp-different f32 arithmetic per sharding layout, and a
    half-ulp straddle can flip a floor-quantized coefficient.  The
    contract is the error bound, which the sharded program verifies with
    its own arithmetic.  Multi-host deployments call this per-process with
    ``jax.distributed`` initialized and write per-host chunk subsets (see
    parallel/mesh.py notes).
    """
    opts = opts or EncodeOptions.from_env()
    if mesh is None:
        mesh = mesh_lib.make_mesh()

    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    chunk_dims = tuple(config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = tuple(config.dims)
    _codec._layout(chunk_dims)

    counts = _codec._chunk_grid(config.dims, chunk_dims)
    num_chunks = int(np.prod(counts))
    chunks = _codec._gather_chunks(data, chunk_dims, counts)
    n_frames, h, w = _codec._layout(chunk_dims)
    chunks = chunks.reshape(num_chunks, n_frames, h, w)
    # Same input contract as the host path (and the reference, which
    # hard-exits): NaN/Inf must raise (or, with allow_nan, fill+mask) here,
    # before device_put — the device kernels would silently produce a
    # garbage stream.
    chunk_cfg = config.per_chunk(chunk_dims)
    from ..config import RESIDUAL_LOSSLESS

    if config.residual_mode == RESIDUAL_LOSSLESS:
        # No device program to shard: the lossless coder is host-side
        # (thread-parallel over chunks) and the container matches
        # encode_chunked exactly.
        from ..core import stream as _stream

        streams = _codec._lossless_encode_frames(chunks, chunk_cfg)
        header = _stream.ChunkedHeader(
            dims=tuple(config.dims), chunk_dims=chunk_dims,
            num_chunks=num_chunks, chunk_size=int(np.prod(chunk_dims)))
        return _stream.pack_chunked(header, streams)

    chunks, nan_masks = _codec._mask_fill_check(chunks, config.allow_nan)
    chunks, chunk_cfg = _codec._log_transform_check(chunks, chunk_cfg)

    # Pad the batch to a multiple of the mesh size and shard the chunk axis.
    padded_n = mesh_lib.pad_batch_to_mesh(num_chunks, mesh)
    if padded_n != num_chunks:
        pad = np.repeat(chunks[-1:], padded_n - num_chunks, axis=0)
        chunks = np.concatenate([chunks, pad], axis=0)
    sharding = mesh_lib.batch_sharding(mesh)
    xb = jax.device_put(chunks, sharding)

    from ..config import RESIDUAL_NONE
    from ..core import entropy, stream

    backend = entropy.backend_id(chunk_cfg)
    error_mode = config.residual_mode != RESIDUAL_NONE
    out = _codec.encode_batch_device(xb, chunk_cfg, opts)
    out_np = _codec._fetch_encode_outputs(out, error_mode)
    streams = _codec._assemble_batch(
        out_np, chunk_cfg, opts, n_frames, h, w, backend, error_mode,
        num_chunks)
    streams = _codec._set_log_flags(streams, chunk_cfg, config)
    streams = _codec._append_mask_sections(streams, nan_masks,
                                           config.zstd_level)

    header = stream.ChunkedHeader(
        dims=tuple(config.dims), chunk_dims=chunk_dims,
        num_chunks=num_chunks, chunk_size=int(np.prod(chunk_dims)))
    return stream.pack_chunked(header, streams)


def decode_chunked_sharded(buf: bytes, mesh=None) -> np.ndarray:
    """Sharded decode of an ETPK container: entropy decode on host, one
    sharded device program for unpack + inverse transforms."""
    from ..core import stream

    if mesh is None:
        mesh = mesh_lib.make_mesh()
    if buf[:4] != stream.MAGIC_CHUNKED:
        return _codec.decode(buf)
    header, chunk_streams = stream.iter_chunked(buf)
    counts = _codec._chunk_grid(header.dims, header.chunk_dims)

    # Host-side parse/entropy-decode, then one sharded device call.  The
    # batch is padded to the mesh size by repeating the last stream.
    n = len(chunk_streams)
    padded_n = mesh_lib.pad_batch_to_mesh(n, mesh)
    padded = list(chunk_streams) + [chunk_streams[-1]] * (padded_n - n)
    out = _codec._decode_streams(padded, sharding=mesh_lib.batch_sharding(mesh))
    chunks = out[:n].reshape(n, *header.chunk_dims)
    return _codec._scatter_chunks(chunks, header.dims, header.chunk_dims,
                                  counts)
