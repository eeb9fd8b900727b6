"""Error-target sweep table (parity: the reference's standalone benchmark
scripts compress_and_compare.py — rmse/max/size/CR tables per target).

Usage:
  JAX_PLATFORMS=cpu python scripts/compare_targets.py
(or on the GPU with the default environment)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ebcc_tpu
from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR


def load_frame():
    path = "/root/reference/data/test_data.npy"
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    yy, xx = np.mgrid[0:721, 0:1440].astype(np.float32)
    return (260 + 25 * np.sin(yy / 721 * np.pi)
            * np.cos(xx / 1440 * 2 * np.pi)).astype(np.float32)


def main():
    x = load_frame()
    data = x[None]
    rng = float(x.max() - x.min())
    print(f"# ERA5 temperature frame 721x1440, range {rng:.2f} K")
    print(f"| abs target | rel target | backend | bytes | CR | max err | "
          f"rmse | encode s |")
    print("|---|---|---|---|---|---|---|---|")
    for target in [2.0, 0.5, 0.1, 0.02]:
        for backend in ["zstd", "cab", "auto"]:
            config = CodecConfig(dims=data.shape, base_cr=30,
                                 residual_mode=RESIDUAL_MAX_ERROR,
                                 error=target, entropy_backend=backend)
            t0 = time.perf_counter()
            blob = ebcc_tpu.encode(data, config)
            dt = time.perf_counter() - t0
            out = ebcc_tpu.decode(blob).reshape(x.shape)
            err = np.abs(out - x)
            print(f"| {target} | {target / rng:.1e} | {backend} | "
                  f"{len(blob)} | {x.nbytes / len(blob):.1f} | "
                  f"{err.max():.4f} | {np.sqrt((err ** 2).mean()):.4f} | "
                  f"{dt:.2f} |")
            assert err.max() <= target


if __name__ == "__main__":
    main()
