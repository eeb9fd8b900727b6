"""Native (C++) codec tests: cross-implementation equivalence with the JAX
codec and the HDF5 filter-plugin integration (parity role: reference
tests/test_c_api.py via ctypes + tests/test_netcdf.py via the plugin)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR, RESIDUAL_NONE, decode, encode
from ebcc_tpu import native as native_mod

# Decoder-conformance contract (docs/FORMAT.md "Decoder conformance"):
# conforming decoders may differ from each other by at most
# DECODER_EPS_REL x chunk range; the encoders verify feasibility at
# target minus that allowance, so ROUND-TRIPS assert `<= target` exactly
# regardless of encoder/decoder pairing, and only decoder-vs-decoder
# parity asserts use the allowance.
from ebcc_tpu.core.kernels import DECODER_EPS_REL


def eps_dec(data) -> float:
    rng = float(np.nanmax(data) - np.nanmin(data))
    return DECODER_EPS_REL * rng


@pytest.fixture(scope="module")
def native():
    try:
        native_mod.load()
    except (RuntimeError, FileNotFoundError, subprocess.CalledProcessError):
        pytest.skip("native toolchain unavailable")
    return native_mod


class TestCrossCodec:
    def test_jax_encode_native_decode(self, native, medium_frame):
        data = medium_frame[None]
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = encode(data, config)
        nat = native.native_decode(blob).reshape(data.shape)
        jx = decode(blob).reshape(data.shape)
        assert np.abs(nat - data).max() <= 0.1
        assert np.abs(nat - jx).max() <= eps_dec(data)

    def test_native_encode_jax_decode(self, native, medium_frame):
        data = medium_frame[None]
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = native.native_encode(data, config)
        out = decode(blob).reshape(data.shape)
        assert np.abs(out - data).max() <= 0.1

    def test_native_roundtrip_bound(self, native, medium_frame):
        data = medium_frame[None]
        for target in (0.5, 0.05):
            config = CodecConfig(dims=data.shape, base_cr=30,
                                 residual_mode=RESIDUAL_MAX_ERROR,
                                 error=target)
            blob = native.native_encode(data, config)
            out = native.native_decode(blob).reshape(data.shape)
            assert np.abs(out - data).max() <= target

    def test_native_rate_mode(self, native, medium_frame):
        data = medium_frame[None]
        config = CodecConfig(dims=data.shape, base_cr=40,
                             residual_mode=RESIDUAL_NONE)
        blob = native.native_encode(data, config)
        assert data.nbytes / len(blob) >= 40 * 0.95
        out = native.native_decode(blob)
        assert out.size == data.size

    def test_native_encode_cab_backend(self, native, medium_frame):
        """The native encoder honors entropy_backend (cab/auto) and writes
        the chosen backend ids into the header so BOTH decoders dispatch."""
        data = medium_frame[None]
        mk = lambda be: CodecConfig(dims=data.shape, base_cr=30,
                                    residual_mode=RESIDUAL_MAX_ERROR,
                                    error=0.1, entropy_backend=be)
        blob_z = native.native_encode(data, mk("zstd"))
        blob_c = native.native_encode(data, mk("cab"))
        blob_a = native.native_encode(data, mk("auto"))
        assert len(blob_c) < len(blob_z)
        assert len(blob_a) <= min(len(blob_c), len(blob_z))
        for blob in (blob_c, blob_a):
            nat = native.native_decode(blob).reshape(data.shape)
            assert np.abs(nat - data).max() <= 0.1
            jx = decode(blob).reshape(data.shape)
            assert np.abs(jx - data).max() <= 0.1

    def test_native_const_field(self, native, constant_frame):
        config = CodecConfig(dims=constant_frame.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.01)
        blob = native.native_encode(constant_frame, config)
        out = native.native_decode(blob).reshape(constant_frame.shape)
        assert np.abs(out - constant_frame).max() <= 1e-6
        # ... and the JAX decoder agrees on the const stream
        assert np.abs(decode(blob).reshape(constant_frame.shape)
                      - constant_frame).max() <= 1e-6

    def test_native_chunked_container(self, native, base_test_data):
        data = np.ascontiguousarray(base_test_data[:100, :150])[None]
        config = CodecConfig(dims=data.shape, base_cr=20,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                             chunk_dims=(1, 64, 64))
        blob = native.native_encode_chunked(data, config)
        out = native.native_decode(blob).reshape(data.shape)
        assert np.abs(out - data).max() <= 0.1
        # JAX chunked decoder accepts the native container
        from ebcc_tpu import decode_chunked
        out2 = decode_chunked(blob)
        assert np.abs(out2 - data).max() <= 0.1

    def test_corrupt_stream_fails(self, native, small_frame):
        config = CodecConfig(dims=(1, 64, 64), base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = bytearray(native.native_encode(small_frame[None], config))
        blob[100] ^= 0xFF
        with pytest.raises(RuntimeError):
            native.native_decode(bytes(blob))


class TestHDF5Plugin:
    def test_h5py_filter_roundtrip(self, native, tmp_path):
        """Full h5py pipeline through the plugin (filter id 33030), parity
        with the reference's netCDF/HDF5 integration tests."""
        pytest.importorskip("h5py")
        script = textwrap.dedent("""
            import numpy as np, h5py, sys
            from ebcc_tpu.api.filter_wrapper import EBCC_Filter
            path = sys.argv[1]
            rng = np.random.default_rng(0)
            yy, xx = np.mgrid[0:128, 0:128].astype(np.float32)
            x = (270 + 10*np.sin(yy/9) * np.cos(xx/7)).astype(np.float32)
            filt = EBCC_Filter(base_cr=20, height=128, width=128,
                               residual_opt=("max_error_target", 0.05),
                               data_dim=3)
            with h5py.File(path, "w") as f:
                d = f.create_dataset("v", shape=(2, 128, 128), **filt)
                d[...] = np.stack([x, x + 1.0])
            with h5py.File(path, "r") as f:
                out = f["v"][...]
            err = float(np.abs(out - np.stack([x, x + 1.0])).max())
            assert err <= 0.05, err
            print("PLUGIN_OK", err)
        """)
        env = dict(os.environ)
        env["HDF5_PLUGIN_PATH"] = str(native_mod.BUILD_DIR)
        proc = subprocess.run(
            [sys.executable, "-c", script, str(tmp_path / "t.h5")],
            capture_output=True, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert proc.returncode == 0, proc.stderr
        assert "PLUGIN_OK" in proc.stdout


class TestCABBackend:
    """Entropy backend 2 (native context-adaptive arithmetic coder)."""

    def test_cab_payload_roundtrip_random(self, native):
        """Random magnitudes with a contract-respecting sign plane (signs
        are defined only where some magnitude bit is set — exactly how
        build_layer_payload masks them)."""
        rng = np.random.default_rng(0)
        d0, hp, wp, kept, levels = 1, 64, 64, 5, 3
        plane_bytes = d0 * hp * (wp // 8)
        planes = rng.integers(0, 256, (kept, plane_bytes), dtype=np.uint8)
        sig_mask = np.bitwise_or.reduce(planes, axis=0)
        signs = rng.integers(0, 256, plane_bytes, dtype=np.uint8) & sig_mask
        payload = planes.tobytes() + signs.tobytes()
        comp = native.cab_compress(payload, kept, d0, hp, wp, levels)
        assert native.cab_decompress(comp, kept, d0, hp, wp, levels) == payload

    def test_cab_run_mode_break_positions(self, native):
        """Run groups of 4 must break correctly at every in-group position:
        isolated significant coefficients placed at columns k, 4+k, ... for
        each offset k, far enough apart that their neighborhoods stay
        zero-context (run-mode eligible) when first coded."""
        d0, hp, wp, kept, levels = 1, 32, 64, 3, 2
        wb = wp // 8
        for k in range(4):
            mag = np.zeros((hp, wp), np.uint8)
            for r in range(4, hp, 8):
                for c in range(k, wp, 16):
                    mag[r, c] = np.uint8(1 + ((r + c) % (1 << kept - 1)))
            planes = [
                np.packbits((mag >> s) & 1, axis=-1).reshape(-1)
                for s in range(kept - 1, -1, -1)
            ]
            signs = np.packbits((mag > 0) & ((mag % 3) == 0), axis=-1)
            payload = b"".join(p.tobytes() for p in planes) + signs.tobytes()
            comp = native.cab_compress(payload, kept, d0, hp, wp, levels)
            out = native.cab_decompress(comp, kept, d0, hp, wp, levels)
            assert out == payload, f"break position {k}"

    def test_cab_run_mode_wins_on_sparse(self, native):
        """The run mode exists so CAB beats LZ on sparse planes; a mostly-
        zero payload must compress tighter with CAB than with zstd."""
        import zstandard

        rng = np.random.default_rng(5)
        d0, hp, wp, kept, levels = 1, 128, 128, 4, 3
        mag = np.where(rng.random((hp, wp)) < 0.01,
                       rng.integers(1, 1 << kept, (hp, wp)), 0).astype(np.uint8)
        planes = [np.packbits((mag >> s) & 1, axis=-1).reshape(-1)
                  for s in range(kept - 1, -1, -1)]
        signs = np.packbits((mag > 0) & (rng.random((hp, wp)) < 0.5), axis=-1)
        payload = b"".join(p.tobytes() for p in planes) + signs.tobytes()
        comp = native.cab_compress(payload, kept, d0, hp, wp, levels)
        zc = zstandard.ZstdCompressor(level=19).compress(payload)
        assert len(comp) < len(zc)
        assert native.cab_decompress(comp, kept, d0, hp, wp, levels) == payload

    def test_cab_stream_roundtrip_and_smaller(self, native, medium_frame):
        data = medium_frame[None]
        blob_z = encode(data, CodecConfig(
            dims=data.shape, base_cr=30, residual_mode=RESIDUAL_MAX_ERROR,
            error=0.1))
        cfg_cab = CodecConfig(dims=data.shape, base_cr=30,
                              residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                              entropy_backend="cab")
        blob_c = encode(data, cfg_cab)
        assert len(blob_c) < len(blob_z)  # CAB beats zstd on these payloads
        out = decode(blob_c).reshape(data.shape)
        assert np.abs(out - data).max() <= 0.1
        # native decoder reads CAB streams too
        nat = native.native_decode(blob_c).reshape(data.shape)
        assert np.abs(nat - data).max() <= 0.1

    def test_cab_corruption_detected_or_bounded(self, native, small_frame):
        """Arithmetic streams have no checksum; corruption must at worst
        produce a parse failure, never a crash."""
        cfg_cab = CodecConfig(dims=(1, 64, 64), base_cr=30,
                              residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                              entropy_backend="cab")
        blob = bytearray(encode(small_frame[None], cfg_cab))
        blob[100] ^= 0xFF
        try:
            decode(bytes(blob))
        except Exception:
            pass  # acceptable: loud failure


class TestCAB2Backend:
    """Entropy backend 4 (relaxed-eligibility CAB profile, cab_coder.cc
    file header): same context model, different bitstream, ~2x fewer coder
    calls for ~1-2% stream growth — the throughput operating point."""

    def test_cab2_payload_roundtrip_random(self, native):
        rng = np.random.default_rng(1)
        d0, hp, wp, kept, levels = 2, 64, 64, 5, 3
        plane_bytes = d0 * hp * (wp // 8)
        planes = rng.integers(0, 256, (kept, plane_bytes), dtype=np.uint8)
        sig_mask = np.bitwise_or.reduce(planes, axis=0)
        signs = rng.integers(0, 256, plane_bytes, dtype=np.uint8) & sig_mask
        payload = planes.tobytes() + signs.tobytes()
        comp = native.cab2_compress(payload, kept, d0, hp, wp, levels)
        assert native.cab2_decompress(comp, kept, d0, hp, wp,
                                      levels) == payload

    def test_cab2_sparse_roundtrip_near_strict_size(self, native):
        """On a sparse wavelet-like payload the relaxed profile must stay
        within a few percent of the strict profile's size (the design
        trade: speed for ~1-2% ratio)."""
        rng = np.random.default_rng(7)
        d0, hp, wp, kept, levels = 1, 256, 256, 8, 4
        mag = np.where(rng.random((hp, wp)) < 0.02,
                       rng.integers(1, 1 << kept, (hp, wp)),
                       0).astype(np.int64)
        planes = [np.packbits((mag >> s) & 1, axis=-1).reshape(-1)
                  for s in range(kept - 1, -1, -1)]
        signs = np.packbits((mag > 0) & (rng.random((hp, wp)) < 0.5),
                            axis=-1)
        payload = b"".join(p.tobytes() for p in planes) + signs.tobytes()
        c1 = native.cab_compress(payload, kept, d0, hp, wp, levels)
        c2 = native.cab2_compress(payload, kept, d0, hp, wp, levels)
        assert native.cab2_decompress(c2, kept, d0, hp, wp,
                                      levels) == payload
        assert len(c2) <= int(len(c1) * 1.15)

    def test_cab2_stream_roundtrip_cross_decoders(self, native,
                                                  medium_frame):
        """cab2 streams decode on every route: python device decoder AND
        the native C++ decoder (entropy id 4 in the header)."""
        data = medium_frame[None]
        cfg = CodecConfig(dims=data.shape, base_cr=30,
                          residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                          entropy_backend="cab2")
        blob = encode(data, cfg)
        out = decode(blob).reshape(data.shape)
        assert np.abs(out - data).max() <= 0.1
        nat = native_mod.native_decode(blob).reshape(data.shape)
        assert np.abs(nat - data).max() <= 0.1
        # and the native ENCODER's cab2 stream decodes on the python route
        nblob = native_mod.native_encode(data, cfg)
        nout = decode(nblob).reshape(data.shape)
        assert np.abs(nout - data).max() <= 0.1

    def test_cab2_corruption_detected_or_bounded(self, native, small_frame):
        cfg = CodecConfig(dims=(1, 64, 64), base_cr=30,
                          residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                          entropy_backend="cab2")
        blob = bytearray(encode(small_frame[None], cfg))
        blob[100] ^= 0xFF
        try:
            decode(bytes(blob))
        except Exception:
            pass  # acceptable: loud failure


class TestNativeEncodeRouting:
    """EBCC_ENCODE_BACKEND=native routes the public encode entry points
    through the host C++ encoder (no accelerator needed at all)."""

    def test_plain_encode_routed(self, native, medium_frame, monkeypatch):
        data = medium_frame[None]
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
        blob = encode(data, config)
        assert blob == native_mod.native_encode(data, config)
        out = decode(blob).reshape(data.shape)
        assert np.abs(out - data).max() <= 0.1

    def test_chunked_encode_routed_and_threaded(self, native, base_test_data,
                                                monkeypatch):
        from ebcc_tpu import decode_chunked, encode_chunked
        data = np.ascontiguousarray(base_test_data[:128, :192])[None]
        config = CodecConfig(dims=data.shape, base_cr=20,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                             chunk_dims=(1, 64, 64))
        monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
        blob = encode_chunked(data, config)
        out = decode_chunked(blob)
        assert np.abs(out - data).max() <= 0.1
        # all-native pipeline: encode AND decode without a device
        monkeypatch.setenv("EBCC_DECODE_BACKEND", "native")
        out2 = decode_chunked(blob)
        assert np.abs(out2 - data).max() <= 0.1

    def test_lossless_chunked_native_route(self, native, base_test_data,
                                           monkeypatch):
        """Regression (round-2 VERDICT #2): a function-local ``import os``
        in encode_chunked shadowed the module import, so the lossless
        branch (which calls os.cpu_count() before that line) crashed with
        UnboundLocalError whenever the native encoder was routed."""
        from ebcc_tpu import (RESIDUAL_LOSSLESS, decode_chunked,
                              encode_chunked)
        data = np.ascontiguousarray(base_test_data[:128, :192])[None]
        config = CodecConfig(dims=data.shape,
                             residual_mode=RESIDUAL_LOSSLESS,
                             chunk_dims=(1, 64, 64))
        monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
        monkeypatch.setenv("EBCC_DECODE_BACKEND", "native")
        blob = encode_chunked(data, config)
        out = decode_chunked(blob)
        assert np.array_equal(out.view(np.uint32), data.view(np.uint32))


class TestChunkedEntropyBackend:
    def test_chunked_respects_cab_backend(self, native, base_test_data):
        """Regression: encode_chunked used to drop entropy_backend when
        deriving the per-chunk config, silently re-encoding with zstd."""
        from ebcc_tpu import decode_chunked, encode_chunked
        data = np.ascontiguousarray(base_test_data[:128, :192])[None]
        mk = lambda be: CodecConfig(dims=data.shape, base_cr=20,
                                    residual_mode=RESIDUAL_MAX_ERROR,
                                    error=0.1, chunk_dims=(1, 64, 64),
                                    entropy_backend=be)
        blob_z = encode_chunked(data, mk("zstd"))
        blob_c = encode_chunked(data, mk("cab"))
        assert len(blob_c) < len(blob_z)
        assert np.abs(decode_chunked(blob_c) - data).max() <= 0.1


class TestNativeDecodeRouting:
    """EBCC_DECODE_BACKEND=native routes the public decode entry points
    through the host C++ decoder (no device round-trips)."""

    def test_plain_stream_routed(self, native, medium_frame, monkeypatch):
        data = medium_frame[None]
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = encode(data, config)
        ref = decode(blob)
        monkeypatch.setenv("EBCC_DECODE_BACKEND", "native")
        out = decode(blob)
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= eps_dec(data)
        assert np.abs(out.reshape(data.shape) - data).max() \
            <= 0.1

    def test_chunked_container_routed(self, native, base_test_data,
                                      monkeypatch):
        from ebcc_tpu import decode_chunked, encode_chunked
        data = np.ascontiguousarray(base_test_data[:100, :150])[None]
        config = CodecConfig(dims=data.shape, base_cr=20,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                             chunk_dims=(1, 64, 64))
        blob = encode_chunked(data, config)
        ref = decode_chunked(blob)
        monkeypatch.setenv("EBCC_DECODE_BACKEND", "native")
        out = decode_chunked(blob)
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= eps_dec(data)
        assert np.abs(out - data).max() <= 0.1


class TestRiceExchange:
    def test_tail_refetch_path(self, native):
        """High-entropy values overflow the optimistic first transfer; the
        self-describing header must drive an exact tail refetch."""
        import jax.numpy as jnp

        from ebcc_tpu.core import transfer
        from ebcc_tpu.core.codec import _fetch_rice_values

        rng = np.random.default_rng(7)
        nnz = 5000
        cap = transfer.bucket_count(nnz)
        vals = np.zeros(cap, np.int32)
        vals[:nnz] = rng.laplace(scale=500000, size=nnz).astype(np.int32)
        words = transfer.rice_pack(jnp.asarray(vals), np.int32(nnz), cap=cap)
        # force the refetch: a bound far below the ~50 bits/value payload
        out = _fetch_rice_values(words, nnz, bound_words=64)
        assert np.array_equal(out, vals[:nnz])

    def test_no_rice_env_fallback(self, native, small_frame, monkeypatch):
        monkeypatch.setenv("EBCC_NO_RICE", "1")
        config = CodecConfig(dims=(1, 64, 64), base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = encode(small_frame[None], config)
        out = decode(blob).reshape(1, 64, 64)
        assert np.abs(out - small_frame[None]).max() <= 0.1


class TestZstdWithoutPackage:
    """Entropy id 1 when the ``zstandard`` package is absent: the native
    library's libzstd serves it, and with no coder at all the request
    raises instead of writing STORE streams."""

    def test_native_serves_zstd(self, native, monkeypatch, small_frame):
        import zstandard

        from ebcc_tpu.core import entropy, routing, stream

        monkeypatch.setattr(entropy, "_zstd", None)
        monkeypatch.setenv("EBCC_ENCODE_BACKEND", "device")
        monkeypatch.setenv("EBCC_DECODE_BACKEND", "device")
        routing.reset_cache()
        payload = np.random.default_rng(1).integers(
            0, 3, 50_000).astype(np.uint8).tobytes()
        comp = entropy.compress(payload, entropy.BACKEND_ZSTD, 9)
        assert len(comp) < len(payload)
        # same frame format as the package writes: either side decodes it
        assert zstandard.ZstdDecompressor().decompress(comp) == payload
        assert entropy.decompress(comp, entropy.BACKEND_ZSTD,
                                  len(payload)) == payload
        # orig_size is an upper bound (partial-plane payloads pass one)
        assert entropy.decompress(comp, entropy.BACKEND_ZSTD,
                                  len(payload) + 999) == payload
        bad = bytearray(comp)
        bad[len(bad) // 2] ^= 0xFF
        with pytest.raises(ValueError):
            entropy.decompress(bytes(bad), entropy.BACKEND_ZSTD,
                               len(payload))
        cfg = CodecConfig(dims=(1, 64, 64), base_cr=20,
                          residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = encode(small_frame, cfg)
        assert stream.FrameHeader.unpack(blob).entropy == 1
        assert np.abs(decode(blob).reshape(64, 64) - small_frame).max() <= 0.1
        # rate mode ships partial-plane payloads, sized only by a bound
        rblob = encode(small_frame, CodecConfig(
            dims=(1, 64, 64), base_cr=20, residual_mode=RESIDUAL_NONE))
        assert len(rblob) <= 64 * 64 * 4 / 20
        assert np.isfinite(decode(rblob)).all()

    def test_zstd_without_coder_raises(self, monkeypatch):
        from ebcc_tpu.core import entropy

        def no_library(*a, **k):
            raise FileNotFoundError("libh5z_etpu.so not built")

        monkeypatch.setattr(entropy, "_zstd", None)
        monkeypatch.setattr(native_mod, "load", no_library)
        with pytest.raises(FileNotFoundError):
            entropy.compress(b"\0" * 4096, entropy.BACKEND_ZSTD, 9)
        assert entropy.backend_id(CodecConfig(dims=(1, 8, 8))) == \
            entropy.BACKEND_ZSTD
