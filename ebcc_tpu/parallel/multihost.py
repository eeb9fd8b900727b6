"""Multi-host deployment glue.

Role parity: the reference has no distributed backend at all (SURVEY §2.9);
its multi-file practice is "run many processes".  This codec's multi-host
story (BASELINE config 5: year-scale archives over N hosts):

  * ``initialize()`` wraps ``jax.distributed.initialize`` (cluster
    autodetection or explicit coordinator) and builds the global
    (hosts, chips) mesh.
  * Chunk ownership is a pure function of (chunk index, process) —
    :func:`host_chunk_slice` — so every host gathers, encodes, and WRITES
    only its own contiguous run of chunks.  The ETPK layout's per-chunk
    independence (like EBCK's, reference ebcc_codec.c:1037-1044) makes the
    final container a byte concatenation of per-host parts
    (:func:`merge_container_parts`), so no host ever holds the whole
    archive and there is no cross-host data collective — the only global
    communication the codec semantics need is the compat-mode min/max
    reduce (``parallel.sharded.global_range``).

Runs unchanged on one host (process_count == 1); the multi-process paths
are exercised by the driver's virtual-device dry run and, on real pods, by
``jax.distributed``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec
from ..core import stream


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Initialize jax.distributed (no-op if already initialized or if
    running single-process with no coordinator configured).

    Must run before anything touches the XLA backend (jax.devices /
    device_put / any computation) — so the already-initialized probe uses
    ``jax.distributed.is_initialized``, never ``jax.process_count`` (which
    would itself initialize the backend and poison the real init)."""
    import jax

    if jax.distributed.is_initialized():
        return
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    else:
        try:
            jax.distributed.initialize()
        except Exception:  # single-host / no cluster env: stay local
            pass


def host_chunk_slice(num_chunks: int, process_id: int,
                     process_count: int) -> Tuple[int, int]:
    """The contiguous [start, stop) run of chunk indices owned by a host.

    Contiguous runs (rather than round-robin) keep each host's output a
    single byte range of the final container."""
    per = -(-num_chunks // process_count)
    start = min(process_id * per, num_chunks)
    stop = min(start + per, num_chunks)
    return start, stop


def encode_owned_chunks(data: np.ndarray, config: CodecConfig,
                        opts: Optional[EncodeOptions] = None,
                        process_id: Optional[int] = None,
                        process_count: Optional[int] = None,
                        max_batch: int = _codec.DEFAULT_MAX_BATCH
                        ) -> Tuple[List[bytes], Tuple[int, int]]:
    """Encode THIS host's chunk range -> (streams, (start, stop)).

    ``data`` may be the full array or any array supporting numpy basic
    indexing over the chunk grid (e.g. a lazily-read HDF5/Zarr dataset)."""
    import jax

    opts = opts or EncodeOptions.from_env()
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count

    chunk_dims = tuple(config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = tuple(config.dims)
    counts = _codec._chunk_grid(config.dims, chunk_dims)
    num_chunks = int(np.prod(counts))
    start, stop = host_chunk_slice(num_chunks, pid, pcount)
    if start >= stop:
        return [], (start, stop)

    chunks = _codec._gather_chunks(np.asarray(data, np.float32),
                                   chunk_dims, counts)
    n_frames, h, w = _codec._layout(chunk_dims)
    owned = chunks[start:stop].reshape(stop - start, n_frames, h, w)

    chunk_cfg = config.per_chunk(chunk_dims)

    slices = [owned[s:s + max_batch] for s in range(0, len(owned), max_batch)]
    counts_per = [s.shape[0] for s in slices]
    streams = _codec._pipeline_encode_slices(
        slices, counts_per, chunk_cfg, opts, n_frames, h, w)
    return streams, (start, stop)


def container_part(streams: List[bytes]) -> bytes:
    """Serialize one host's chunk streams as a container body fragment."""
    import struct

    parts = []
    for s in streams:
        parts.append(struct.pack("<Q", len(s)))
        parts.append(s)
    return b"".join(parts)


def merge_container_parts(config: CodecConfig, parts: List[bytes]) -> bytes:
    """Concatenate per-host body fragments (in chunk order) under one ETPK
    header -> a container identical to a single-host encode."""
    chunk_dims = tuple(config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = tuple(config.dims)
    counts = _codec._chunk_grid(config.dims, chunk_dims)
    header = stream.ChunkedHeader(
        dims=tuple(config.dims), chunk_dims=chunk_dims,
        num_chunks=int(np.prod(counts)),
        chunk_size=int(np.prod(chunk_dims)))
    return header.pack() + b"".join(parts)
