"""Streamed-cube throughput (BASELINE config 4 shape): a full pressure-level
ERA5-shaped cube (37 levels x 24 hours x 721x1440) compressed through
``io.pipeline.compress_stream`` from a DISK-BACKED npy memmap, with the
slab reader overlapping the encode pipeline — the Zarr-backed-I/O
deployment shape (in this image zarr is absent; the memmap exercises the
same lazy slab-read path, ``pipeline._slab_chunks``).

Reports streamed wall/pts-per-s next to the same data encoded fully
in-memory (``encode_chunked``): their ratio is the I/O-overlap efficiency
(1.0 = the disk reads are fully hidden under the encode pipeline).

Run on the GPU (default env, one process):
    python scripts/stream_bench.py [--levels 37] [--hours 24]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def build_cube(path: str, levels: int, hours: int) -> np.memmap:
    """Disk-backed cube: the real ERA5 frame's spatial texture scaled to
    per-level amplitudes (standard-atmosphere flavored, like
    scripts/ab_reference.py), evolving smoothly over the hour axis."""
    h, w = bench.H, bench.W
    n = levels * hours
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(n, h, w))
    base_hours = bench.load_frames(hours)  # (hours, H, W), smooth evolution
    rng = np.random.default_rng(3)
    level_mean = np.linspace(200.0, 290.0, levels).astype(np.float32)
    level_amp = np.linspace(0.4, 1.6, levels).astype(np.float32)
    mean0 = float(base_hours.mean())
    for li in range(levels):
        sl = (base_hours - mean0) * level_amp[li] + level_mean[li]
        mm[li * hours:(li + 1) * hours] = sl
    mm.flush()
    return np.lib.format.open_memmap(path, mode="r")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=37)
    ap.add_argument("--hours", type=int, default=24)
    ap.add_argument("--error", type=float, default=0.5)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR, decode_chunked, \
        encode_chunked
    from ebcc_tpu.io import pipeline

    tmpdir = tempfile.mkdtemp(prefix="ebcc_stream_")
    cube_path = os.path.join(tmpdir, "cube.npy")
    out_path = os.path.join(tmpdir, "cube.etpk")
    data = build_cube(cube_path, args.levels, args.hours)
    n, h, w = data.shape
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=args.error,
                         chunk_dims=(1, h, w))

    # Warm/compile on a small prefix so the timed runs measure steady state.
    small = np.asarray(data[:8])
    scfg = CodecConfig(dims=small.shape, base_cr=30,
                       residual_mode=RESIDUAL_MAX_ERROR, error=args.error,
                       chunk_dims=(1, h, w))
    encode_chunked(small, scfg)

    # Streamed: disk memmap -> compress_stream -> ETPK file on disk.
    t0 = time.perf_counter()
    with open(out_path, "wb") as f:
        nbytes = pipeline.compress_stream(data, config, f)
    t_stream = time.perf_counter() - t0

    # In-memory reference: same chunks, no read/write legs.
    ram = np.asarray(data)
    t0 = time.perf_counter()
    blob = encode_chunked(ram, config)
    t_mem = time.perf_counter() - t0

    # Verify the streamed container end-to-end.
    with open(out_path, "rb") as f:
        streamed = f.read()
    dec = decode_chunked(streamed)
    maxerr = float(np.abs(dec - ram).max())
    assert maxerr <= args.error, maxerr
    assert len(streamed) == nbytes

    pts = data.size
    print(json.dumps({
        "cube": [n, h, w],
        "streamed_seconds": round(t_stream, 2),
        "streamed_pts_per_s": round(pts / t_stream, 1),
        "in_memory_seconds": round(t_mem, 2),
        "in_memory_pts_per_s": round(pts / t_mem, 1),
        "overlap_efficiency": round(t_mem / t_stream, 3),
        "compression_ratio": round(data.nbytes / nbytes, 2),
        "max_error": maxerr,
        "container_bytes": nbytes,
    }))
    if not args.keep:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)


if __name__ == "__main__":
    main()
