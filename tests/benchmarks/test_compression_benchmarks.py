"""Performance/property benchmark tests.

Parity: reference tests/benchmarks/test_compression_benchmarks.py —
compression timing with bound & CR asserts (tb:14-48), memory-leak check
via psutil RSS (tb:50-81), scalability across frame sizes with a throughput
floor (tb:83-123), and error-bound accuracy monotonicity across targets
with bounded overshoot (tb:125-154).  These run on the CPU test mesh; the
real-hardware numbers come from bench.py.
"""

import time

import numpy as np
import pytest

from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR, decode, encode


def _frame(base_test_data, size):
    return np.ascontiguousarray(base_test_data[:size, :size])[None]


class TestCompressionPerformance:
    @pytest.mark.parametrize("target", [0.01, 0.1])
    def test_bound_and_cr(self, base_test_data, target):
        data = _frame(base_test_data, 256)
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=target)
        blob = encode(data, config)
        out = decode(blob).reshape(data.shape)
        assert np.abs(out - data).max() <= target
        assert data.nbytes / len(blob) > 2  # parity floor (tb:48)

    def test_throughput_floor(self, base_test_data):
        """Parity: >1 MB/s compression floor on a 512^2 frame including the
        searches (tb:119-123) — generous on CPU."""
        data = _frame(base_test_data, 512)
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        encode(data, config)  # warm the compile cache
        # Best-of-3: a single rep loses to scheduler noise when the full
        # suite saturates the box (the floor itself is generous).
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            blob = encode(data, config)
            dt = min(dt, time.perf_counter() - t0)
        assert data.nbytes / dt > 1e6, f"{data.nbytes / dt / 1e6:.2f} MB/s"
        assert len(blob) > 0

    def test_lossless_throughput_and_cr_floor(self, base_test_data):
        """The lossless host coder must stay fast (it is a delta + zstd
        pass, no transforms) and above a modest ratio floor on real
        data."""
        import time

        from ebcc_tpu import RESIDUAL_LOSSLESS
        data = _frame(base_test_data, 512)
        config = CodecConfig(dims=data.shape,
                             residual_mode=RESIDUAL_LOSSLESS)
        encode(data, config)  # warm (zstd ctx etc.)
        dt = float("inf")
        for _ in range(3):  # best-of-3: robust to co-tenant load spikes
            t0 = time.perf_counter()
            blob = encode(data, config)
            out = decode(blob)
            dt = min(dt, time.perf_counter() - t0)
        assert np.array_equal(out.view(np.uint32),
                              data.reshape(out.shape).view(np.uint32))
        assert data.nbytes / dt > 20e6, f"{data.nbytes / dt / 1e6:.1f} MB/s"
        assert data.nbytes / len(blob) > 1.5

    def test_no_memory_leak(self, base_test_data):
        """Parity: RSS growth check over repeated encodes (tb:50-81)."""
        psutil = pytest.importorskip("psutil")
        data = _frame(base_test_data, 128)
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        encode(data, config)  # warm-up: compile caches etc.
        proc = psutil.Process()
        rss0 = proc.memory_info().rss
        for _ in range(10):
            encode(data, config)
        growth = proc.memory_info().rss - rss0
        assert growth < 200 * 1024 * 1024, f"RSS grew {growth / 1e6:.0f} MB"

    @pytest.mark.parametrize("size", [64, 128, 256])
    def test_scalability_sizes(self, base_test_data, size):
        data = _frame(base_test_data, size)
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
        blob = encode(data, config)
        out = decode(blob).reshape(data.shape)
        assert np.abs(out - data).max() <= 0.1


class TestErrorBoundAccuracy:
    def test_monotone_and_no_overshoot(self, base_test_data):
        """Parity: targets sweep with <=1.5x observed overshoot allowed in
        the reference (tb:125-154); this codec's bound is exact (<=1.0x)."""
        data = _frame(base_test_data, 256)
        achieved = []
        sizes = []
        for target in [0.001, 0.01, 0.1, 1.0]:
            config = CodecConfig(dims=data.shape, base_cr=30,
                                 residual_mode=RESIDUAL_MAX_ERROR,
                                 error=target)
            blob = encode(data, config)
            out = decode(blob).reshape(data.shape)
            err = float(np.abs(out - data).max())
            assert err <= target  # exact, not 1.5x
            achieved.append(err)
            sizes.append(len(blob))
        # tighter targets -> larger streams (monotone RD behavior)
        assert sizes == sorted(sizes, reverse=True)
