"""A/B table at the reference's recorded operating point.

The reference's headline numbers (BASELINE.md rows 1-2, 6) come from
`geopotential_pl_small.nc` — ERA5 geopotential, 37 pressure levels of
721x1440 — at absolute error target 10.0, base_cr 30, chunked
(1, 721, 1440) (reference data/compress_logs.txt:1-5, data/logs.txt:17-20):
1.81 MB, RMSE 1.608, max 9.979, end-to-end CR 21.97.

That file cannot be downloaded here (no egress), so this script rebuilds
the SAME comparison shape from the real ERA5 temperature frame the
reference ships: a 37-level geopotential-like stack whose per-level means
follow the standard atmosphere (z = g*h at each pressure level) and whose
spatial anomalies are the real temperature frame's texture scaled to
per-level geopotential anomaly amplitudes (~400 m**2/s**2 near the surface
growing to ~5000 aloft — ERA5-typical synoptic variability), plus
decorrelating small-scale noise.  Same frame count, same grid, same
absolute bound, same chunking, same base_cr — so the bound regime
(target / per-chunk range) matches the reference run chunk for chunk.

Usage:
  JAX_PLATFORMS=cpu python scripts/ab_reference.py     # CPU
  python scripts/ab_reference.py                       # GPU
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ebcc_tpu
from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR

G = 9.80665
# (pressure hPa, standard-atmosphere geopotential height m, anomaly std
# in m**2/s**2 — ERA5-typical synoptic variability per level)
LEVELS_HPA = [1000, 975, 950, 925, 900, 875, 850, 825, 800, 775, 750, 700,
              650, 600, 550, 500, 450, 400, 350, 300, 250, 225, 200, 175,
              150, 125, 100, 70, 50, 30, 20, 10, 7, 5, 3, 2, 1]


def std_height(p_hpa: float) -> float:
    """ICAO standard-atmosphere geopotential height for a pressure level."""
    if p_hpa >= 226.32:  # troposphere
        return 44330.8 * (1.0 - (p_hpa / 1013.25) ** 0.190263)
    if p_hpa >= 54.75:  # lower stratosphere (isothermal)
        return 11000.0 + 6341.6 * np.log(226.32 / p_hpa)
    return 20000.0 + 216650.0 * ((54.75 / p_hpa) ** 0.0292713 - 1.0)


def anomaly_std(p_hpa: float) -> float:
    """Synoptic geopotential anomaly amplitude: ~400 m2/s2 at 1000 hPa
    growing with height to ~5e3 at 50 hPa (ERA5 climatology shape)."""
    return 400.0 + 4600.0 * (1.0 - p_hpa / 1000.0) ** 1.5


def build_stack():
    path = "/root/reference/data/test_data.npy"
    t = np.load(path).astype(np.float64) if os.path.exists(path) else None
    if t is None:
        yy, xx = np.mgrid[0:721, 0:1440].astype(np.float64)
        t = 260 + 25 * np.sin(yy / 721 * np.pi) * np.cos(xx / 1440 * 2 * np.pi)
    tex = (t - t.mean()) / t.std()  # real spatial texture, unit variance
    rng = np.random.default_rng(42)
    frames = []
    for p in LEVELS_HPA:
        z = G * std_height(p) + anomaly_std(p) * tex
        # decorrelate the levels a little (smooth per-level perturbation)
        coarse = rng.normal(scale=0.25 * anomaly_std(p), size=(24, 46))
        yi = np.linspace(0, 22.999, 721)
        xi = np.linspace(0, 44.999, 1440)
        y0, x0 = yi.astype(int), xi.astype(int)
        fy, fx = (yi - y0)[:, None], (xi - x0)[None, :]
        pert = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
                + coarse[y0][:, x0 + 1] * (1 - fy) * fx
                + coarse[y0 + 1][:, x0] * fy * (1 - fx)
                + coarse[y0 + 1][:, x0 + 1] * fy * fx)
        frames.append((z + pert).astype(np.float32))
    return np.stack(frames)


def main():
    import argparse

    parser = argparse.ArgumentParser(
        description="A/B table: native backends vs the legacy EBCC v1 "
                    "interop codec on a geopotential-like proxy stack.")
    parser.add_argument("--rows", choices=("all", "native", "legacy"),
                        default="all", help="which table rows to run")
    parser.add_argument("--levels", type=int, default=None, metavar="N",
                        help="truncate the stack to N pressure levels "
                             "(quick checks on loaded boxes)")
    ns = parser.parse_args()
    rows, max_levels = ns.rows, ns.levels
    data = build_stack()
    if max_levels is not None:
        data = data[:max_levels]
    n_levels = data.shape[0]
    target = 10.0
    print(f"# geopotential-like stack: {data.shape}, abs target {target}, "
          f"base_cr 30, chunks (1, 721, 1440)")
    print("| backend | size MB | CR (f32) | CR (f64-equiv) | RMSE | max err "
          "| encode+decode s |")
    print("|---|---|---|---|---|---|---|")
    # Temporal rows predict each level from the previous level's
    # reconstruction (chunk = the whole stack) — the capability the
    # reference's per-level chunking forgoes; intra rows mirror the
    # reference's recorded per-level configuration exactly.
    native_rows = (("zstd", False), ("cab", False), ("auto", False),
                   ("zstd", True), ("cab", True)) if rows != "legacy" else ()
    for backend, temporal in native_rows:
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=target,
                             chunk_dims=(data.shape if temporal
                                         else (1, 721, 1440)),
                             entropy_backend=backend, temporal=temporal)
        t0 = time.perf_counter()
        blob = ebcc_tpu.encode_chunked(data, config)
        out = ebcc_tpu.decode_chunked(blob)
        dt = time.perf_counter() - t0
        err = out.astype(np.float64) - data
        rmse = float(np.sqrt((err ** 2).mean()))
        maxe = float(np.abs(err).max())
        assert maxe <= target, (maxe, target)
        mb = len(blob) / 1e6
        cr32 = data.nbytes / len(blob)
        name = backend + (" temporal" if temporal else "")
        print(f"| {name} | {mb:.2f} | {cr32:.2f} | {2 * cr32:.2f} "
              f"| {rmse:.3f} | {maxe:.3f} | {dt:.1f} |")
    # Same-data A/B via the legacy interop codec: the reference's OWN
    # format and algorithm (real OpenJPEG J2K base at base_cr/2, SPIHT
    # residual truncation search, zstd-22 — compat/legacy.py) run on the
    # identical proxy stack.  This isolates format-vs-data effects that
    # the recorded-number comparison below cannot.
    if rows == "native":
        return
    # Only the optional-dependency surface (Pillow/OpenJPEG import and the
    # codepaths that call into it) may skip the row; a bound violation in
    # the legacy codec must FAIL the script, not print a skip line.
    legacy_result = None
    try:
        from ebcc_tpu.compat import legacy as _legacy
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=target,
                             chunk_dims=(1, 721, 1440))
        t0 = time.perf_counter()
        blob = _legacy.encode_chunked(data.astype(np.float32), config)
        out = _legacy.decode(blob).reshape(data.shape)
        dt = time.perf_counter() - t0
        legacy_result = (blob, out, dt)
    except (ImportError, OSError) as e:  # pragma: no cover - Pillow optional
        print(f"\n(legacy-format row skipped: {e})")
    if legacy_result is not None:
        blob, out, dt = legacy_result
        err = out.astype(np.float64) - data
        rmse = float(np.sqrt((err ** 2).mean()))
        maxe = float(np.abs(err).max())
        # Reference semantics can overshoot the bound slightly (the mean
        # adjustment runs AFTER its feasibility check); its own tests
        # allow observed error <= 1.5x target (reference
        # tests/benchmarks/test_compression_benchmarks.py:43).  The native
        # rows above use centered feasibility and never overshoot.
        assert maxe <= 1.5 * target, (maxe, target)
        mb = len(blob) / 1e6
        cr32 = data.nbytes / len(blob)
        print(f"| legacy EBCC v1 (J2K+SPIHT, same data) | {mb:.2f} "
              f"| {cr32:.2f} | {2 * cr32:.2f} | {rmse:.3f} | {maxe:.3f} "
              f"| {dt:.1f} |")
    # The REFERENCE BINARY itself: its own C sources compiled against the
    # shim J2K layer (compat.reference_bin) — same-data ground truth.
    try:
        from ebcc_tpu.compat import reference_bin as _rb
        _rb.load()
        t0 = time.perf_counter()
        blob = _rb.encode(data.astype(np.float32), base_cr=30, mode=1,
                          error=target, chunked="chunking",
                          chunk_dims=(1, 721, 1440))
        out = _rb.decode(blob, chunked=True).reshape(data.shape)
        dt = time.perf_counter() - t0
        err = out.astype(np.float64) - data
        rmse = float(np.sqrt((err ** 2).mean()))
        maxe = float(np.abs(err).max())
        assert maxe <= 1.5 * target, (maxe, target)  # reference semantics
        mb = len(blob) / 1e6
        cr32 = data.nbytes / len(blob)
        print(f"| REFERENCE binary (own C, shim J2K) | {mb:.2f} "
              f"| {cr32:.2f} | {2 * cr32:.2f} | {rmse:.3f} | {maxe:.3f} "
              f"| {dt:.1f} |")
    except (ImportError, OSError, RuntimeError) as e:  # pragma: no cover
        print(f"\n(reference-binary row skipped: {e})")
    print(f"\nreference recorded at this operating point "
          f"(data/logs.txt:17-20): 1.81 MB, RMSE 1.608, max 9.979, "
          f"CR 21.97 (compress_logs.txt:642)")


if __name__ == "__main__":
    main()
