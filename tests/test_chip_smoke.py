"""chip_smoke.py's phases at small shapes on the CPU, its refusal to run
without a GPU, the compile-cache helper, and (on a GPU only) the
pipelined-vs-sequential byte-identity contract."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from bench import load_frames

_REPO = Path(__file__).resolve().parents[1]
_N, _H, _W = 8, 96, 160


@pytest.fixture(scope="module")
def small():
    frames = np.ascontiguousarray(load_frames(_N)[:, :_H, :_W])
    return frames, chip_smoke.frame_config(_N, _H, _W)


@pytest.fixture(scope="module")
def phase_a(small):
    return chip_smoke.phase_host(*small)


@pytest.mark.parametrize("phase", ["a", "b", "c", "d"])
def test_phase_small(phase, small, phase_a):
    frames, config = small
    if phase == "a":
        assert phase_a["max_error"] <= config.error
        assert len(phase_a["streams"]) == _N
        assert phase_a["cr_first"] >= ((1 - chip_smoke.CR_GAP)
                                       * phase_a["cr_native_first"])
    elif phase == "b":
        b = chip_smoke.phase_device(frames, config, phase_a["streams"])
        assert b["max_error"] <= config.error
        # per-chunk formulation on the CPU: pipelined == sequential bytes
        assert b["identical"] == b["n"] == _N
    elif phase == "c":
        c = chip_smoke.phase_cross(frames, config, phase_a["streams"],
                                   phase_a["decoded"])
        assert c["max_error"] <= config.error
        assert 0 <= c["divergence_rel"] <= c["eps_rel"]
    else:
        rows = chip_smoke.phase_modes(frames)
        assert [r["name"].split()[0] for r in rows] == [
            "relative", "temporal", "allow_nan", "pointwise-relative",
            "lossless", "rate"]
        assert all(r["cr"] > 1 for r in rows)
        assert all(0 <= r["divergence"] <= r["allowance"] for r in rows)


def test_sharded_phase_on_virtual_mesh(small):
    frames, config = small
    r = chip_smoke.phase_sharded(frames, config, 4)
    assert r[4]["max_error"] <= config.error
    assert r[1]["max_error"] <= config.error
    assert r["range"] == (float(frames.min()), float(frames.max()))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and '"metric"' not in r.stdout
    assert "GPU" in r.stderr


def test_divergence_is_per_chunk_over_finite_points():
    ref = np.array([[0.0, 10.0], [np.nan, 4.0], [2.0, 3.0]], np.float32)
    a = np.array([[0.0, 10.0], [np.nan, 4.0], [2.0, 3.0]], np.float32)
    b = a + np.array([[0.01, 0.0], [5.0, 0.0], [0.0, 0.002]], np.float32)
    # chunk of one row: row 0 1e-3 of range 10, row 2 2e-3 of range 1,
    # row 1 has one finite point (range 0: the raw difference, 0)
    assert chip_smoke._divergence(a, b, ref, 1) == pytest.approx(2e-3,
                                                                rel=1e-3)
    # one chunk of all rows: the largest difference over range 10
    assert chip_smoke._divergence(a, b, ref, 3) == pytest.approx(1e-3,
                                                                rel=1e-3)


def test_trace_summary_refuses_a_trace_without_device_planes(tmp_path):
    """A CPU-only trace holds no device plane: the script must refuse it
    instead of reporting host threads as device time."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(_REPO / "scripts"))
    try:
        import trace_summary
    finally:
        sys.path.pop(0)
    if jax.devices()[0].platform != "cpu":
        pytest.skip("needs a trace without device planes")
    with jax.profiler.trace(str(tmp_path)):
        jax.jit(lambda v: v * 2)(jnp.ones(8)).block_until_ready()
    with pytest.raises(SystemExit, match="no /device: plane"):
        trace_summary.summarize(str(tmp_path))


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        import jax

        from ebcc_tpu.utils.compile_cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_checkout_cache_without_env(self, monkeypatch):
        import jax

        from ebcc_tpu.utils.compile_cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            path = enable_compile_cache()
            assert path == str(_REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert enable_compile_cache() == path       # fixed, not per-run
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture()
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX found " + jax.devices()[0].platform)


@pytest.mark.gpu
def test_pipelined_streams_match_sequential_on_gpu(gpu, small):
    """The pipelined device-resident roundtrip ships the same bytes as the
    sequential encode_chunked of the same frames (README contract)."""
    import ebcc_tpu

    frames, config = small
    seq = chip_smoke._streams(ebcc_tpu.encode_chunked(frames, config))
    b = chip_smoke.phase_device(frames, config, seq)
    assert b["identical"] == b["n"] == _N, json.dumps(b)
