"""Automatic host-path backend routing (core.routing).

The host-destined entry points must pick the native C++ codec when the
host<->device link would make the device path lose, without any env
routing — and a forced fake-slow link must be observable doing so."""

import numpy as np
import pytest

from ebcc_tpu.config import EncodeOptions
from ebcc_tpu.core import codec, routing


@pytest.fixture()
def clean_routing(monkeypatch):
    monkeypatch.delenv("EBCC_ENCODE_BACKEND", raising=False)
    monkeypatch.delenv("EBCC_DECODE_BACKEND", raising=False)
    monkeypatch.delenv("EBCC_LINK_MBPS", raising=False)
    routing.reset_cache()
    yield monkeypatch
    routing.reset_cache()


def _require_native():
    from ebcc_tpu import native

    try:
        native.load()
    except Exception:
        pytest.skip("native library unavailable")


def test_slow_link_routes_native(clean_routing):
    _require_native()
    clean_routing.setenv("EBCC_LINK_MBPS", "1")
    assert routing.backend_choice("encode") == "native"
    assert routing.backend_choice("decode") == "native"
    assert codec._native_encoder(EncodeOptions.from_env()) is not None
    assert codec._native_decoder() is not None


def test_fast_link_routes_device(clean_routing):
    clean_routing.setenv("EBCC_LINK_MBPS", "100000")
    assert routing.backend_choice("encode") == "device"
    assert routing.backend_choice("decode") == "device"
    assert codec._native_encoder(EncodeOptions.from_env()) is None
    assert codec._native_decoder() is None


def test_explicit_override_wins(clean_routing):
    _require_native()
    clean_routing.setenv("EBCC_LINK_MBPS", "1")
    clean_routing.setenv("EBCC_ENCODE_BACKEND", "device")
    clean_routing.setenv("EBCC_DECODE_BACKEND", "device")
    assert codec._native_encoder(EncodeOptions.from_env()) is None
    assert codec._native_decoder() is None
    clean_routing.setenv("EBCC_ENCODE_BACKEND", "native")
    clean_routing.setenv("EBCC_LINK_MBPS", "100000")
    routing.reset_cache()
    assert codec._native_encoder(EncodeOptions.from_env()) is not None


def test_custom_opts_stay_on_device_path(clean_routing):
    """The native encoder reads tuning from the environment, so AUTO
    routing must step aside when the caller customized EncodeOptions
    programmatically (explicit env routing still wins)."""
    _require_native()
    clean_routing.setenv("EBCC_LINK_MBPS", "1")
    opts = EncodeOptions.from_env()
    opts.base_error_quantile = 0.123
    assert codec._native_encoder(opts) is None
    assert codec._native_encoder(EncodeOptions.from_env()) is not None


def test_slow_link_end_to_end_roundtrip(clean_routing, small_frame):
    """Public API under fake-slow link: auto-routed native encode+decode
    still honors the bound."""
    _require_native()
    clean_routing.setenv("EBCC_LINK_MBPS", "1")
    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR

    cfg = CodecConfig(dims=(1, 64, 64), base_cr=20,
                      residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
    blob = codec.encode(small_frame, cfg)
    out = codec.decode(blob)
    assert np.abs(out.reshape(64, 64) - small_frame).max() <= 0.1


def test_failed_link_probe_raises(clean_routing):
    """A probe that cannot reach the device is an error, never a silent
    route of every host-destined call to the host codec."""
    import jax

    def broken(*a, **k):
        raise RuntimeError("device unreachable")

    clean_routing.setattr(jax, "device_put", broken)
    with pytest.raises(RuntimeError, match="device unreachable"):
        routing.link_mbps()
    assert "link" not in routing._cache
