"""Attribute the device-resident roundtrip wall time (bench.py headline).

Runs the exact bench roundtrip with EBCC_TIMING=2 accumulation on, then
prints wall per rep, the link-leg floors implied by the measured link
bandwidths, and the per-stage host/link work totals.  Run on the GPU
(default env, ONE process).
"""

import json
import os
import sys
import time

os.environ.setdefault("EBCC_TIMING", "2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from ebcc_tpu import CodecConfig, EncodeOptions, RESIDUAL_MAX_ERROR
    from ebcc_tpu.core import codec as codec_mod
    from ebcc_tpu.core import transfer
    from ebcc_tpu.utils import timing

    n = int(os.environ.get("EBCC_BENCH_FRAMES", "32"))
    sub = int(os.environ.get("EBCC_BENCH_SUBBATCH", "4"))
    reps = int(os.environ.get("EBCC_BENCH_REPS", "3"))
    data = bench.load_frames(n)
    config = CodecConfig(
        dims=data.shape, base_cr=30, residual_mode=RESIDUAL_MAX_ERROR,
        error=0.5, chunk_dims=(1, bench.H, bench.W),
        zstd_level=int(os.environ.get("EBCC_BENCH_ZSTD_LEVEL", "3")),
        entropy_backend=os.environ.get("EBCC_BENCH_ENTROPY", "zstd"))
    opts = EncodeOptions.from_env()
    x_dev = jax.device_put(data.reshape(n, 1, bench.H, bench.W))
    jax.block_until_ready(x_dev)
    maxerr_fn = jax.jit(lambda a, b: jnp.abs(a - b).max())

    def roundtrip():
        streams, dec = codec_mod.roundtrip_frames_device(
            x_dev, config, opts, max_batch=sub)
        err = float(maxerr_fn(x_dev, dec))
        return streams, err

    streams, err = roundtrip()  # compile/warm
    assert err <= 0.5, err

    up_mbps, down_mbps = bench.measure_link()
    timing.reset_stats()
    transfer.reset_link_stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        roundtrip()
        walls.append(time.perf_counter() - t0)
    up_b = transfer.LINK_STATS["up"] / reps
    down_b = transfer.LINK_STATS["down"] / reps
    stats = timing.snapshot()
    for k in stats:
        stats[k]["per_rep_s"] = round(stats[k]["total_s"] / reps, 4)
    print(json.dumps({
        "wall_per_rep_s": [round(w, 4) for w in walls],
        "best_wall_s": round(min(walls), 4),
        "pts_per_s": round(data.size / min(walls), 1),
        "link_up_MBps": round(up_mbps, 1),
        "link_down_MBps": round(down_mbps, 1),
        "bytes_up_per_rep": int(up_b),
        "bytes_down_per_rep": int(down_b),
        "up_floor_s": round(up_b / (up_mbps * 1e6), 4),
        "down_floor_s": round(down_b / (down_mbps * 1e6), 4),
        "stages": stats,
    }, indent=1))


if __name__ == "__main__":
    main()
