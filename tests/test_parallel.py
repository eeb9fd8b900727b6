"""Multi-device tests on the 8-device virtual CPU mesh — the capability the
reference entirely lacks (SURVEY §2.9): chunk-batch data parallelism over a
jax Mesh, the compat-mode global-range collective, and result equivalence
with the single-device path."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR, decode_chunked, encode_chunked
from ebcc_tpu.parallel import (
    decode_chunked_sharded,
    encode_chunked_sharded,
    global_range,
    make_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices (virtual CPU mesh)")
    return make_mesh()


def test_mesh_shape(mesh):
    assert int(np.prod(mesh.devices.shape)) == len(jax.devices())
    assert mesh.axis_names == ("hosts", "chunks")


def test_global_range_collective(mesh, base_test_data):
    data = np.stack([base_test_data[:64, :64] + i for i in range(8)])
    lo, hi = global_range(data, mesh)
    assert lo == pytest.approx(float(data.min()))
    assert hi == pytest.approx(float(data.max()))


def test_sharded_encode_matches_unsharded(mesh, base_test_data):
    data = np.stack([
        np.ascontiguousarray(base_test_data[64 * i:64 * (i + 1), :64])
        for i in range(8)
    ])
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                         chunk_dims=(1, 64, 64))
    blob_sharded = encode_chunked_sharded(data, config, mesh=mesh)
    out = decode_chunked(blob_sharded)
    assert np.abs(out - data).max() <= 0.1

    # Same decisions as the single-device path => identical streams.
    blob_single = encode_chunked(data, config)
    assert blob_sharded == blob_single


def test_sharded_decode(mesh, base_test_data):
    data = np.stack([
        np.ascontiguousarray(base_test_data[64 * i:64 * (i + 1), 128:192])
        for i in range(6)
    ])
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=0.05,
                         chunk_dims=(1, 64, 64))
    blob = encode_chunked(data, config)
    out = decode_chunked_sharded(blob, mesh=mesh)
    assert out.shape == data.shape
    assert np.abs(out - data).max() <= 0.05


def test_uneven_chunk_count_padding(mesh, base_test_data):
    """Chunk count not a multiple of the mesh size."""
    data = np.stack([
        np.ascontiguousarray(base_test_data[:64, 64 * i:64 * (i + 1)])
        for i in range(5)
    ])
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                         chunk_dims=(1, 64, 64))
    blob = encode_chunked_sharded(data, config, mesh=mesh)
    out = decode_chunked_sharded(blob, mesh=mesh)
    assert out.shape == data.shape
    assert np.abs(out - data).max() <= 0.1


def test_dryrun_multichip_entrypoint():
    """The driver contract: full sharded step compiles and runs."""
    import __graft_entry__ as graft

    n = min(8, len(jax.devices()))
    if n < 2:
        pytest.skip("needs multiple devices")
    graft.dryrun_multichip(n)


class TestScalingGates:
    """Scaling regression gates (round-2 VERDICT #5).

    Real pods measure real scaling (scripts/scaling_bench.py); on this
    virtual CPU mesh all 8 devices share the host's few cores, so absolute
    speedup is physically capped near 1x.  What IS enforceable here:
    (a) the batch axis genuinely shards one-chunk-per-device through the
    encode program (the structural property pod scaling rides on), and
    (b) sharded throughput never COLLAPSES relative to single-device —
    a sharding bug that serialized per-chunk dispatches or inserted
    gather/scatter collectives would push the ratio far below the gate.
    """

    def test_encode_program_shards_one_chunk_per_device(self, mesh,
                                                        base_test_data):
        from ebcc_tpu.config import EncodeOptions
        from ebcc_tpu.core import codec as codec_mod
        from ebcc_tpu.parallel import mesh as mesh_lib

        nd = int(np.prod(mesh.devices.shape))
        data = np.stack([
            np.ascontiguousarray(base_test_data[:64, :64]) + i
            for i in range(nd)
        ])[:, None]
        config = CodecConfig(dims=(nd, 64, 64), base_cr=20,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                             chunk_dims=(1, 64, 64))
        sharding = mesh_lib.batch_sharding(mesh)
        xb = jax.device_put(data, sharding)
        # input shards: exactly one chunk per device
        shard_rows = [s.data.shape[0] for s in xb.addressable_shards]
        assert shard_rows == [1] * nd
        out = codec_mod.encode_batch_device(
            xb, config.per_chunk((1, 64, 64)), EncodeOptions.from_env())
        # the dominant output (the significance bitmap stack, batch axis 1)
        # must come back sharded over the mesh, not replicated
        sig = out["sig_comb"]
        rows = [s.data.shape[1] for s in sig.addressable_shards]
        assert sorted(rows) == [1] * nd, rows
        devs = {s.device for s in sig.addressable_shards}
        assert len(devs) == nd

    def test_sharded_throughput_no_collapse(self, mesh, base_test_data):
        import time

        from ebcc_tpu.parallel import encode_chunked_sharded

        rng = np.random.default_rng(0)
        data = np.stack([
            np.ascontiguousarray(base_test_data[(i * 8) % 400:
                                                (i * 8) % 400 + 256, :256])
            + rng.normal(scale=0.01, size=(256, 256)).astype(np.float32)
            for i in range(16)
        ])
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                             chunk_dims=(1, 256, 256))
        encode_chunked_sharded(data, config, mesh=mesh)  # warm
        encode_chunked(data, config)                     # warm
        ts = t1 = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            encode_chunked_sharded(data, config, mesh=mesh)
            ts = min(ts, time.perf_counter() - t0)
            t0 = time.perf_counter()
            encode_chunked(data, config)
            t1 = min(t1, time.perf_counter() - t0)
        # shared-core ceiling is ~1x; measured ~0.67x on a 4-core host.
        # 0.35 is the collapse gate, not a scaling claim.
        assert ts < t1 / 0.35, (ts, t1)

    def test_compute_only_sharding_efficiency(self, mesh, base_test_data):
        """Device-program-only scaling gate (round-3 VERDICT #5): the same
        compute-bound encode batch, 8 chunks on ONE device vs 8 chunks
        sharded one-per-device, no host assembly or link legs in either
        measurement.  Both runs burn identical FLOPs on the same host
        cores, so the ratio isolates SHARDING overhead (resharding
        collectives, per-shard dispatch serialization); a regression that
        the 0.35 collapse gate sleeps through fails here at 0.6."""
        import time

        from ebcc_tpu.config import EncodeOptions
        from ebcc_tpu.core import codec as codec_mod
        from ebcc_tpu.parallel import mesh as mesh_lib

        nd = int(np.prod(mesh.devices.shape))
        rng = np.random.default_rng(1)
        data = np.stack([
            np.ascontiguousarray(base_test_data[:256, :256])
            + rng.normal(scale=0.01, size=(256, 256)).astype(np.float32)
            for _ in range(nd)
        ])[:, None]
        config = CodecConfig(dims=(nd, 256, 256), base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=0.1,
                             chunk_dims=(1, 256, 256))
        pc = config.per_chunk((1, 256, 256))
        opts = EncodeOptions.from_env()

        sharding = mesh_lib.batch_sharding(mesh)
        x_sh = jax.device_put(data, sharding)
        x_one = jax.device_put(data, jax.devices()[0])

        def run(xb, **kw):
            out = codec_mod.encode_batch_device(xb, pc, opts, **kw)
            jax.block_until_ready(
                [v for v in out.values() if hasattr(v, "block_until_ready")])

        run(x_sh)           # warm/compile
        run(x_one)
        t_sh = t_one = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(x_sh)
            t_sh = min(t_sh, time.perf_counter() - t0)
            t0 = time.perf_counter()
            run(x_one)
            t_one = min(t_one, time.perf_counter() - t0)
        # per-device efficiency = total-throughput ratio (equal work)
        assert t_one / t_sh >= 0.6, (t_sh, t_one)
