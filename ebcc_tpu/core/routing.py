"""Automatic backend routing for host-destined codec calls.

The public numpy entry points (``encode``/``decode``/``encode_chunked``/
``decode_chunked``) can run through the accelerator (batched device
programs + sparse exchange) or entirely on the host CPU via the native C++
codec.  Which one wins is a property of the MACHINE, not the workload: a
host-destined call through the device must move the raw frames across the
host<->device link both ways, so once the link is slow relative to the
host cores (a saturated PCIe switch, a remote accelerator) the native path
wins.

The reference has no such decision (it is host-serial only,
``ebcc_codec.c``); this module makes its implicit "always host" choice
explicit and measured.

Policy (first call per process, then cached):
  1. ``EBCC_ENCODE_BACKEND`` / ``EBCC_DECODE_BACKEND`` = ``native`` or
     ``device`` override everything (unset or ``auto`` = decide).
  2. Without a loadable native library the device path is the only one.
  3. Otherwise compare modeled per-point costs:
       device ~ bytes_up/link_up + bytes_down/link_down
       native ~ 1 / (per-core rate x cores)
     with link bandwidth from ``EBCC_LINK_MBPS`` (test/ops override) or a
     one-time 4 MB probe.  A probe that fails raises: the device is never
     silently replaced by the host codec.  The native per-core rates are
     deliberately conservative (measured ~5M enc / ~39M dec pts/s
     single-thread on an ERA5 frame; modeled at half) so the device path
     is preferred whenever it is close.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..utils.logging import logger

# Bytes per grid point moved by the device path for HOST-destined calls.
# Uploads are float32 frames (4 B/pt); the compressed-domain exchange legs
# are ~0.1-0.3 B/pt at typical bounds (see core.transfer), padded here to
# 1 B/pt as a stand-in for per-leg protocol latency the byte model can't
# see (the exchange is a CHAIN of round trips per batch).
_ENC_UP_BPP, _ENC_DOWN_BPP = 4.0, 1.0
_DEC_UP_BPP, _DEC_DOWN_BPP = 1.0, 4.0

# Conservative native throughput model (pts/s per core).
_NATIVE_ENC_PPS = 2.5e6
_NATIVE_DEC_PPS = 15e6

_PROBE_BYTES = 4 << 20

_cache: dict = {}
# Concurrent first calls (the pipelined paths fan out worker threads) must
# not run duplicate 4 MB link probes or native builds; the lock also makes
# the cache fill atomic.
_cache_lock = threading.Lock()


def _native_available() -> bool:
    with _cache_lock:
        if "native_ok" not in _cache:
            try:
                from .. import native

                native.load(auto_build=True)
                _cache["native_ok"] = True
            except Exception:
                _cache["native_ok"] = False
        return _cache["native_ok"]


def link_mbps() -> tuple:
    """(up, down) host<->device bandwidth in MB/s.  ``EBCC_LINK_MBPS``
    (one number, both directions) skips the probe — tests use it to force
    a routing decision."""
    # Held across the whole probe: concurrent first calls would otherwise
    # run overlapping 4 MB transfers that contend for the link, each
    # measuring deflated bandwidth, with the last (wrong) writer cached
    # for the process lifetime.  The lock is recursive-safe here because
    # nothing inside the probe calls back into this module.
    with _cache_lock:
        if "link" in _cache:
            return _cache["link"]
        env = os.environ.get("EBCC_LINK_MBPS")
        if env:
            v = float(env)
            _cache["link"] = (v, v)
            return _cache["link"]
        import jax

        # Distinct INCOMPRESSIBLE payload per probe: a transport that
        # compresses or dedupes a repeated buffer would inflate the
        # estimate and mis-route host-destined calls onto a slow link.
        rng = np.random.default_rng(0)

        def probe_once():
            x = rng.integers(0, 256, _PROBE_BYTES, np.uint8)
            t0 = time.perf_counter()
            a = jax.device_put(x)
            # fetching a derived slice forces the upload to complete
            np.asarray(jax.device_get(a[-8:]))
            t1 = time.perf_counter()
            np.asarray(jax.device_get(a))
            t2 = time.perf_counter()
            return t1 - t0, t2 - t1

        probe_once()  # warm-up: device claim + slice-op compile
        tu, td = probe_once()
        up = _PROBE_BYTES / max(tu, 1e-9) / 1e6
        down = _PROBE_BYTES / max(td, 1e-9) / 1e6
        _cache["link"] = (up, down)
    logger.info("link probe: %.1f MB/s up, %.1f MB/s down", up, down)
    return _cache["link"]


def explicit(kind: str):
    """The explicit env override for ``kind`` ("encode"/"decode"), or None."""
    v = os.environ.get(f"EBCC_{kind.upper()}_BACKEND", "").lower()
    if v in ("native", "host"):
        return "native"
    if v in ("device", "jax", "accel"):
        return "device"
    return None


def backend_choice(kind: str) -> str:
    """-> "native" or "device" for host-destined ``kind`` calls."""
    e = explicit(kind)
    if e is not None:
        return e
    if not _native_available():
        return "device"
    up, down = link_mbps()
    cores = os.cpu_count() or 1
    if kind == "encode":
        dev_spp = (_ENC_UP_BPP / (up * 1e6)) + (_ENC_DOWN_BPP / (down * 1e6))
        nat_spp = 1.0 / (_NATIVE_ENC_PPS * cores)
    else:
        dev_spp = (_DEC_UP_BPP / (up * 1e6)) + (_DEC_DOWN_BPP / (down * 1e6))
        nat_spp = 1.0 / (_NATIVE_DEC_PPS * cores)
    choice = "native" if nat_spp < dev_spp else "device"
    key = f"logged_{kind}"
    if key not in _cache:
        _cache[key] = True
        logger.info("auto-routing host %s path -> %s (link %.0f/%.0f MB/s)",
                    kind, choice, up, down)
    return choice


def reset_cache() -> None:
    """Drop cached probe/availability results (tests)."""
    _cache.clear()
