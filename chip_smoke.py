"""Smoke run of the codec's main paths on an NVIDIA GPU.

    python chip_smoke.py                  # one card: phases a-d below
    python chip_smoke.py --four           # only the sharded path, 4 cards
    python chip_smoke.py --trace DIR      # phase a alone, warm, under jax.profiler

Data: 100 frames of the ERA5 0.25-degree grid (721 x 1440 float32, the
BASELINE.json config-2 shape), generated from a seed by ``bench.py``'s
generator.  Operating point: base_cr 30, MAX_ERROR 0.5, one frame per
chunk, zstd.  The host-destined entry points are pinned to the device
path, so the router cannot hand the work to the host codec.

Phases (each asserts its bound on every point):
  a. host in/out: ``encode_chunked`` + ``decode_chunked``; every stream
     carries zstd (entropy id 1); CR within 2% of the native C++ encoder's.
  b. HBM-resident: ``roundtrip_frames_device`` on the same frames; reports
     whether its streams are byte-identical to phase a's.
  c. cross-decoder: the native C++ decoder reads phase a's streams; its
     divergence from the device decoder stays within DECODER_EPS_REL.
  d. the modes users reach, on a few frames each, decoded by both the
     device and the native C++ decoder.

Exits non-zero, printing no result, unless JAX's first device is a GPU.
The last line of stdout is one JSON object naming the device.  Phase
timings include compilation: they are smoke timings, not benchmarks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H, W = 721, 1440
N_FRAMES = 100
BASE_CR = 30
MAX_ERROR = 0.5
PIPELINE_BATCH = 4       # roundtrip_frames_device sub-batch (bench.py's)
CR_FRAMES = 8            # frames of the JAX-vs-native CR comparison
CR_GAP = 0.02            # JAX CR may trail the native encoder's by this much
MODE_FRAMES = 4
TEMPORAL_FRAMES = 8


def card() -> str:
    """The card's name and power limit, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def frame_config(n: int, h: int = H, w: int = W, **kw):
    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR

    args = dict(dims=(n, h, w), base_cr=BASE_CR,
                residual_mode=RESIDUAL_MAX_ERROR, error=MAX_ERROR,
                chunk_dims=(1, h, w), entropy_backend="zstd")
    args.update(kw)
    return CodecConfig(**args)


def _streams(blob: bytes):
    from ebcc_tpu.core import stream

    return stream.iter_chunked(blob)[1]


def _native_decode_all(streams, shape):
    from ebcc_tpu import native

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        parts = list(pool.map(native.native_decode, streams))
    return np.stack(parts).reshape(shape)


def _divergence(a, b, ref, chunk: int, log: bool = False) -> float:
    """Largest per-chunk max|a - b| over the chunk's range of ``ref``,
    on ``ref``'s finite points (log values for log-domain streams)."""
    a, b, ref = (np.asarray(v, np.float64) for v in (a, b, ref))
    if log:
        a, b, ref = np.log(a), np.log(b), np.log(ref)
    worst = 0.0
    for i in range(0, ref.shape[0], chunk):
        ok = np.isfinite(ref[i:i + chunk])
        r = ref[i:i + chunk][ok]
        d = np.abs(a[i:i + chunk] - b[i:i + chunk])[ok].max()
        span = r.max() - r.min()
        worst = max(worst, float(d / span if span > 0 else d))
    return worst


def phase_host(frames: np.ndarray, config) -> dict:
    """a. Host arrays in and out through the normal entry points."""
    import ebcc_tpu
    from ebcc_tpu import native
    from ebcc_tpu.core import entropy, stream

    blob = ebcc_tpu.encode_chunked(frames, config)
    out = ebcc_tpu.decode_chunked(blob)
    err = float(np.abs(out - frames).max())
    assert err <= config.error, (err, config.error)
    streams = _streams(blob)
    for s in streams:
        hd = stream.FrameHeader.unpack(s)
        assert hd.entropy == entropy.BACKEND_ZSTD, hd.entropy
        assert hd.res_entropy_effective == entropy.BACKEND_ZSTD, hd

    k = min(CR_FRAMES, frames.shape[0])
    chunk_cfg = config.per_chunk(tuple(config.chunk_dims))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        nat = list(pool.map(lambda f: native.native_encode(f[None], chunk_cfg),
                            frames[:k]))
    raw = frames[:k].nbytes
    cr_jax = raw / sum(len(s) for s in streams[:k])
    cr_native = raw / sum(len(s) for s in nat)
    assert cr_jax >= (1.0 - CR_GAP) * cr_native, (cr_jax, cr_native)
    return {"streams": streams, "decoded": out, "max_error": err,
            "cr": frames.nbytes / len(blob), "cr_first": cr_jax,
            "cr_native_first": cr_native}


def phase_device(frames: np.ndarray, config, streams_a) -> dict:
    """b. Frames resident in device memory, pipelined roundtrip."""
    import jax
    import jax.numpy as jnp

    import ebcc_tpu

    x_dev = jax.device_put(frames.reshape(frames.shape[0], 1, *frames.shape[1:]))
    streams, dec = ebcc_tpu.roundtrip_frames_device(
        x_dev, config, max_batch=PIPELINE_BATCH)
    err = float(jnp.abs(dec - x_dev).max())
    assert err <= config.error, (err, config.error)
    same = sum(a == b for a, b in zip(streams, streams_a))
    return {"max_error": err, "identical": same, "n": len(streams),
            "cr": frames.nbytes / sum(len(s) for s in streams)}


def phase_cross(frames: np.ndarray, config, streams_a, decoded_a) -> dict:
    """c. The native C++ decoder on the device encoder's streams."""
    from ebcc_tpu.core.kernels import DECODER_EPS_REL

    nat = _native_decode_all(streams_a, frames.shape)
    err = float(np.abs(nat - frames).max())
    assert err <= config.error, (err, config.error)
    ratio = _divergence(nat, decoded_a, frames, 1)
    assert ratio <= DECODER_EPS_REL, (ratio, DECODER_EPS_REL)
    return {"max_error": err, "divergence_rel": ratio,
            "eps_rel": DECODER_EPS_REL}


def land_mask(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Continent-like blobs covering roughly a third of the grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.zeros((h, w), np.float32)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sy, sx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.05, 0.15) * w
        f += np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2)
    return f > np.quantile(f, 0.67)


def phase_modes(frames: np.ndarray) -> list:
    """d. The other modes users reach, through encode/decode_chunked.

    Each mode's streams are also decoded by the native C++ decoder: the
    bound must hold for both decoders, and their divergence must stay
    within the allowance the encoder budgeted (DECODER_EPS_REL x chunk
    range; 2T of them for a T-frame temporal chain, in the log domain for
    pointwise-relative streams)."""
    import ebcc_tpu
    from ebcc_tpu import (RESIDUAL_LOSSLESS, RESIDUAL_NONE,
                          RESIDUAL_POINTWISE_RELATIVE_ERROR,
                          RESIDUAL_RELATIVE_ERROR)
    from ebcc_tpu.core.kernels import DECODER_EPS_REL

    n, h, w = MODE_FRAMES, frames.shape[1], frames.shape[2]
    x = np.ascontiguousarray(frames[:n])
    rows = []

    def run(name, data, cfg, bound, log=False, allowance=DECODER_EPS_REL):
        """Encode+decode ``data``; ``bound(out, blob)`` asserts the mode's
        bound on a decoded array and returns its worst value."""
        t0 = time.perf_counter()
        blob = ebcc_tpu.encode_chunked(data, cfg)
        out = ebcc_tpu.decode_chunked(blob)
        dt = time.perf_counter() - t0
        assert out.shape == data.shape, (name, out.shape)
        nat = _native_decode_all(_streams(blob), data.shape)
        worst, worst_nat = bound(out, blob), bound(nat, blob)
        div = _divergence(nat, out, data, cfg.chunk_dims[0], log)
        assert div <= allowance, (name, div, allowance)
        rows.append({"name": name, "worst": worst, "worst_native": worst_nat,
                     "divergence": div, "allowance": allowance,
                     "cr": data.nbytes / len(blob), "wall_s": dt})

    rel = 1e-3
    rng = x.max(axis=(1, 2)) - x.min(axis=(1, 2))

    def relative(out, blob):
        worst = float((np.abs(out - x).max(axis=(1, 2)) / rng).max())
        assert worst <= rel, worst
        return worst

    run("relative 1e-3", x, frame_config(
        n, h, w, residual_mode=RESIDUAL_RELATIVE_ERROR, error=rel), relative)

    t = min(TEMPORAL_FRAMES, frames.shape[0])
    xt = np.ascontiguousarray(frames[:t])

    def absolute(out, blob):
        err = float(np.abs(out - xt).max())
        assert err <= MAX_ERROR, err
        return err

    run("temporal 8-frame chunk", xt, frame_config(
        t, h, w, chunk_dims=(t, h, w), temporal=True), absolute,
        allowance=2 * t * DECODER_EPS_REL)

    xm = x.copy()
    xm[:, land_mask(h, w)] = np.nan
    valid = ~np.isnan(xm)

    def masked(out, blob):
        assert np.array_equal(np.isnan(out), ~valid)
        err = float(np.abs(out[valid] - xm[valid]).max())
        assert err <= MAX_ERROR, err
        return err

    run("allow_nan land mask", xm, frame_config(n, h, w, allow_nan=True),
        masked)

    # humidity-like: strictly positive, spanning three decades
    lo, hi = x.min(), x.max()
    q = (1e-5 * 10.0 ** (3.0 * (x - lo) / (hi - lo))).astype(np.float32)
    pw = 1e-2

    def pointwise(out, blob):
        worst = float((np.abs(out - q) / np.abs(q)).max())
        assert worst <= pw, worst
        return worst

    run("pointwise-relative 1e-2", q, frame_config(
        n, h, w, residual_mode=RESIDUAL_POINTWISE_RELATIVE_ERROR, error=pw),
        pointwise, log=True)

    def exact(out, blob):
        assert np.array_equal(out.view(np.uint32), x.view(np.uint32))
        return 0.0

    run("lossless", x, frame_config(n, h, w, residual_mode=RESIDUAL_LOSSLESS),
        exact, allowance=0.0)

    budget = 4 * h * w / BASE_CR

    def rate(out, blob):
        biggest = max(len(s) for s in _streams(blob))
        assert biggest <= budget, (biggest, budget)
        assert np.isfinite(out).all()
        return biggest / budget

    run("rate (residual NONE)", x, frame_config(
        n, h, w, residual_mode=RESIDUAL_NONE), rate)
    return rows


def phase_sharded(frames: np.ndarray, config, n_devices: int) -> dict:
    """The multi-device path: sharded encode+decode on an n-device mesh
    against the same run on one device, plus the global-range collective."""
    import jax

    from ebcc_tpu import parallel

    res = {}
    for nd in (n_devices, 1):
        mesh = parallel.make_mesh(jax.devices()[:nd], shape=(1, nd))
        t0 = time.perf_counter()
        blob = parallel.encode_chunked_sharded(frames, config, mesh=mesh)
        out = parallel.decode_chunked_sharded(blob, mesh=mesh)
        dt = time.perf_counter() - t0
        err = float(np.abs(out - frames).max())
        assert err <= config.error, (nd, err)
        res[nd] = {"blob": blob, "max_error": err, "wall_s": dt,
                   "cr": frames.nbytes / len(blob)}
    mesh = parallel.make_mesh(jax.devices()[:n_devices], shape=(1, n_devices))
    lo, hi = parallel.global_range(
        frames.reshape(frames.shape[0], -1), mesh)
    assert (lo, hi) == (float(frames.min()), float(frames.max())), (lo, hi)
    res["identical"] = res[n_devices]["blob"] == res[1]["blob"]
    res["range"] = (lo, hi)
    return res


def _compile_seconds():
    """Running total of JAX trace + lower + compile seconds in this
    process, summed over threads (so it can exceed a phase's wall)."""
    import jax

    total = [0.0]
    names = ("/jax/core/compile/jaxpr_trace_duration",
             "/jax/core/compile/jaxpr_to_mlir_module_duration",
             "/jax/core/compile/backend_compile_duration")

    def listen(event, duration, **kw):
        if event in names:
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listen)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on a 4-device mesh")
    ap.add_argument("--trace", metavar="DIR",
                    help="run only phase a, under jax.profiler into DIR")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from bench import load_frames
    from ebcc_tpu import native
    from ebcc_tpu.core import routing
    from ebcc_tpu.utils import profiling
    from ebcc_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    compile_s = _compile_seconds()
    gpu = card()
    print(f"card: {gpu}")
    print(f"jax {jax.__version__}, devices {len(jax.devices())} x "
          f"{dev.device_kind}, compile cache {cache}")
    t0 = time.perf_counter()
    native.build()
    print(f"native library ready in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    frames = load_frames(N_FRAMES)
    print(f"data: {frames.shape} float32 ({frames.nbytes / 1e6:.1f} MB) "
          f"in {time.perf_counter() - t0:.3f} s")
    config = frame_config(N_FRAMES)
    # What the router would pick here, then pin both host-destined paths
    # to the device so the phases below always exercise it.
    up, down = routing.link_mbps()
    print(f"router: encode -> {routing.backend_choice('encode')}, decode -> "
          f"{routing.backend_choice('decode')} (link {up:.0f}/{down:.0f} MB/s"
          f", {os.cpu_count()} host cores); pinned to device below")
    os.environ["EBCC_ENCODE_BACKEND"] = "device"
    os.environ["EBCC_DECODE_BACKEND"] = "device"

    def timed(label, fn, *a):
        c0, t = compile_s[0], time.perf_counter()
        r = fn(*a)
        dt = time.perf_counter() - t
        print(f"[{label}] wall {dt:.3f} s (trace+lower+compile summed over "
              f"threads {compile_s[0] - c0:.3f} s) on {gpu}")
        return r

    if args.four:
        if len(jax.devices()) < 4:
            print(f"chip_smoke: --four needs 4 devices, JAX found "
                  f"{len(jax.devices())}", file=sys.stderr)
            return 1
        r = timed("sharded", phase_sharded, frames, config, 4)
        for nd in (4, 1):
            print(f"[sharded] {nd} device(s): max error "
                  f"{r[nd]['max_error']:.6f} <= {MAX_ERROR}, CR "
                  f"{r[nd]['cr']:.3f}, wall {r[nd]['wall_s']:.3f} s")
        print(f"[sharded] containers byte-identical 4 vs 1: {r['identical']}")
        print(f"[sharded] global_range {r['range']} matches numpy")
    elif args.trace:
        # Two warm-ups: the second compiles the programs that take the
        # exchange-size hint the first one leaves behind.
        for _ in range(2):
            timed("a warm-up", phase_host, frames, config)
        with profiling.trace("chip_smoke.a", args.trace):
            a = timed("a trace", phase_host, frames, config)
        print(f"[a trace] max error {a['max_error']:.6f}, CR {a['cr']:.3f}")
    else:
        a = timed("a", phase_host, frames, config)
        print(f"[a] host in/out: max error {a['max_error']:.6f} <= "
              f"{MAX_ERROR}, CR {a['cr']:.3f}; first {CR_FRAMES} frames CR "
              f"{a['cr_first']:.3f} vs native C++ {a['cr_native_first']:.3f}"
              f"; every stream zstd (entropy id 1)")
        b = timed("b", phase_device, frames, config, a["streams"])
        print(f"[b] HBM-resident roundtrip: max error {b['max_error']:.6f} <= "
              f"{MAX_ERROR}, CR {b['cr']:.3f}; streams byte-identical to "
              f"phase a: {b['identical']}/{b['n']}")
        c = timed("c", phase_cross, frames, config, a["streams"],
                  a["decoded"])
        print(f"[c] native C++ decode of GPU streams: max error "
              f"{c['max_error']:.6f} <= {MAX_ERROR}; divergence "
              f"{c['divergence_rel']:.3e} x range <= {c['eps_rel']:.1e}")
        rows = timed("d", phase_modes, frames)
        for r in rows:
            print(f"[d] {r['name']}: worst {r['worst']:.6g} (native C++ "
                  f"{r['worst_native']:.6g}) within bound; divergence "
                  f"{r['divergence']:.3e} x range <= {r['allowance']:.1e}; "
                  f"CR {r['cr']:.3f}, wall {r['wall_s']:.3f} s")
        worst = max(r["divergence"] / r["allowance"] for r in rows
                    if r["allowance"] > 0)
        print(f"[d] worst divergence / allowance over modes: {worst:.3f}")
    print(f"trace+lower+compile summed over threads, total "
          f"{compile_s[0]:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
