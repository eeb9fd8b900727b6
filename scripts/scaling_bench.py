"""Multi-chip scaling-efficiency measurement (BASELINE north star: >=80%
efficiency from 1 chip to N>=2 hosts).

Defines HOW scaling is measured so a real pod run is one command away:
encode a fixed per-device workload (weak scaling) through
``parallel.sharded.encode_chunked_sharded`` on 1, 2, 4, ..., N-device
meshes and report

    efficiency(N) = throughput(N) / (N * throughput(1))

Chunks are embarrassingly parallel (no halos, no cross-chunk state —
reference ebcc_codec.c:1007-1019), so the expected loss terms are only the
device->host gather of the sparse exchange and host stream assembly.

Validate the mechanics on a virtual CPU mesh:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/scaling_bench.py

On real cards, run with the default environment (and under
``jax.distributed`` for multi-host; the mesh picks up all global devices).
Virtual CPU devices share the machine's cores, so CPU-mesh "efficiency"
UNDERSTATES real-chip scaling — the number that matters from this script
is the real-slice one; the CPU run checks the harness, shardings, and
byte-identity.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR
from ebcc_tpu.parallel import mesh as mesh_lib
from ebcc_tpu.parallel import sharded

FRAMES_PER_DEVICE = int(os.environ.get("EBCC_SCALE_FRAMES_PER_DEV", "8"))
H = int(os.environ.get("EBCC_SCALE_H", "721"))
W = int(os.environ.get("EBCC_SCALE_W", "1440"))
REPS = int(os.environ.get("EBCC_SCALE_REPS", "3"))


def frames(n):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 260 + 25 * np.sin(yy / H * np.pi) * np.cos(xx / W * 2 * np.pi)
    return np.stack([
        (base + 0.3 * i + rng.normal(scale=0.5, size=(H, W))).astype(
            np.float32) for i in range(n)])


def run(n_dev, devices):
    data = frames(FRAMES_PER_DEVICE * n_dev)
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=0.5,
                         chunk_dims=(1, H, W))
    m = mesh_lib.make_mesh(devices[:n_dev], shape=(1, n_dev))
    blob = sharded.encode_chunked_sharded(data, config, mesh=m)  # warm-up
    best = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        blob = sharded.encode_chunked_sharded(data, config, mesh=m)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return data.size / best, blob


def main():
    devices = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    base = None
    rows = []
    for n in sizes:
        pts, blob = run(n, devices)
        if base is None:
            base = pts
        eff = pts / (n * base)
        rows.append({"devices": n, "pts_per_s": round(pts, 1),
                     "efficiency_vs_1dev": round(eff, 3)})
        print(json.dumps(rows[-1]))
    print(json.dumps({"metric": "weak-scaling encode efficiency",
                      "platform": str(devices[0].platform),
                      "rows": rows}))


if __name__ == "__main__":
    main()
