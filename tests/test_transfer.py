"""Unit tests for the host<->device sparse exchange (core.transfer).

The exchange is the codec's link-bytes budget: encode direction = device-
side compaction + one Rice-coded pair buffer (positions-as-gaps + values);
decode direction = bitmap-or-index upload + one scatter/gather.  These
tests pin the exact bit-level round trip against numpy references.
"""

import numpy as np
import pytest

import jax

from ebcc_tpu.core import kernels, transfer


def _native():
    from ebcc_tpu import native

    try:
        native.load()
        return native
    except Exception:
        pytest.skip("native library unavailable")


def _sparse_vals(n, density, lo=-3000, hi=3000, seed=0):
    rng = np.random.default_rng(seed)
    vals = np.zeros(n, np.int32)
    k = int(n * density)
    if k:
        pos = rng.choice(n, size=k, replace=False)
        v = rng.integers(lo, hi, size=k).astype(np.int32)
        v[v == 0] = 7
        vals[pos] = v
    return vals


@pytest.mark.parametrize("n,density", [
    (8192, 0.05), (65536, 0.2), (4096, 0.0), (5000, 0.3),
    (4096, 1.0 / 4096),  # single value
])
def test_compact_rice_exchange_roundtrip(n, density):
    native = _native()
    vals = _sparse_vals(n, density)
    ref_idx = np.flatnonzero(vals)
    nnz = ref_idx.size
    if nnz == 0:
        return
    cap = transfer.bucket_count(nnz)
    words, wn = transfer.compact_rice_exchange(
        vals, np.packbits(vals != 0), cap=cap)
    head = np.asarray(jax.device_get(words))[: int(wn)]
    ga, vb = transfer.split_rice_pair(head, nnz)
    gaps = native.rice_decode(ga, nnz)
    v = native.rice_decode(vb, nnz)
    idx = np.cumsum(gaps.astype(np.int64) + 1) - 1
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(v, vals[ref_idx])


def test_compact_rice_exchange_large_values():
    """Escape path: values beyond the Rice quotient cap round-trip."""
    native = _native()
    vals = np.zeros(4096, np.int32)
    vals[[3, 100, 4095]] = [2 ** 21 - 1, -(2 ** 21), 123456]
    nnz = 3
    words, wn = transfer.compact_rice_exchange(
        vals, np.packbits(vals != 0), cap=transfer.bucket_count(nnz))
    head = np.asarray(jax.device_get(words))[: int(wn)]
    ga, vb = transfer.split_rice_pair(head, nnz)
    v = native.rice_decode(vb, nnz)
    np.testing.assert_array_equal(v, vals[np.flatnonzero(vals)])
    idx = np.cumsum(native.rice_decode(ga, nnz).astype(np.int64) + 1) - 1
    np.testing.assert_array_equal(idx, np.flatnonzero(vals))


def test_unpack_bitmap_roundtrip():
    rng = np.random.default_rng(3)
    bits = rng.random(8192) < 0.2
    packed = np.packbits(bits)
    out = np.asarray(transfer.unpack_bitmap(packed, n=8192))
    np.testing.assert_array_equal(out, bits)


def test_decode_bitmap_variant_matches_index_variant():
    """decode_batch_sparse_bitmap == decode_batch_sparse on the same
    exchange content."""
    b, d0, hp, wp = 2, 1, 64, 64
    s = b * d0 * hp * wp
    flat = _sparse_vals(2 * s, 0.1, lo=-128, hi=128, seed=5)
    idx = np.flatnonzero(flat)
    vals = flat[idx]
    cap = transfer.bucket_count(max(1, idx.size))
    vals_up = np.zeros(cap, np.int16)
    vals_up[: vals.size] = vals.astype(np.int16)
    scalars = [np.zeros(b, np.int32), np.zeros(b, np.int32),
               np.zeros(b, np.float32), np.ones(b, np.float32),
               np.zeros(b, np.float32), np.ones(b, np.float32)]
    kw = dict(base_levels=3, res_levels=3, out_hw=(64, 64),
              has_residual=True, grid_shape=(b, d0, hp, wp))
    idx_up = transfer.pad_index(idx.astype(np.int32), cap, -1)
    a = np.asarray(kernels.decode_batch_sparse(idx_up, vals_up, *scalars,
                                               **kw))
    sigb = np.zeros(2 * s, np.uint8)
    sigb[idx] = 1
    packed = np.packbits(sigb)
    bm = np.asarray(kernels.decode_batch_sparse_bitmap(packed, vals_up,
                                                       *scalars, **kw))
    np.testing.assert_array_equal(a, bm)


def test_encode_exchange_fast_path_streams_identical(small_frame):
    """Streams from the device-compacted exchange must be byte-identical
    to the bitmap/index fallback (EBCC_NO_RICE=1)."""
    import os

    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR
    from ebcc_tpu.core import codec

    _native()
    cfg = CodecConfig(dims=(1, 64, 64), base_cr=20,
                      residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
    fast = codec.encode(small_frame, cfg)
    os.environ["EBCC_NO_RICE"] = "1"
    try:
        slow = codec.encode(small_frame, cfg)
    finally:
        os.environ.pop("EBCC_NO_RICE", None)
    assert fast == slow


def test_native_plane_unpack_matches_numpy(medium_frame, monkeypatch):
    """Decode-direction sparse extraction: the native C unpacker and the
    numpy fallback must produce identical reconstructions."""
    _native()
    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR
    from ebcc_tpu.core import codec

    cfg = CodecConfig(dims=(1, 256, 256), base_cr=30,
                      residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
    blob = codec.encode(medium_frame, cfg)
    a = codec.decode(blob)
    monkeypatch.setenv("EBCC_NO_NATIVE_UNPACK", "1")
    b = codec.decode(blob)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,density", [
    (8192, 0.05), (65536, 0.25), (5000, 0.6), (4096, 1.0 / 4096),
])
def test_byte_pack_sparse_roundtrip(n, density):
    """Decode-direction byte upload: host pack -> device unpack must
    reproduce (idx, vals) exactly, including 255-escaped gaps/values."""
    vals_dense = _sparse_vals(n, density, lo=-70000, hi=70000, seed=3)
    idx = np.flatnonzero(vals_dense).astype(np.int64)
    vals = vals_dense[idx]
    if idx.size == 0:
        return
    g8, g_ov, v8, v_ov16, v_ov32 = transfer.byte_pack_sparse_host(idx, vals)
    cap = transfer.bucket_count(idx.size)
    g8u = np.zeros(cap, np.uint8); g8u[: g8.size] = g8
    v8u = np.zeros(cap, np.uint8); v8u[: v8.size] = v8
    gcap = transfer.overflow_bucket(max(1, g_ov.size))
    vcap = transfer.overflow_bucket(max(1, v_ov16.size))
    wcap = transfer.overflow_bucket(max(1, v_ov32.size))
    govu = np.zeros(gcap, np.int32); govu[: g_ov.size] = g_ov
    vov16u = np.zeros(vcap, np.uint16); vov16u[: v_ov16.size] = v_ov16
    vov32u = np.zeros(wcap, np.int32); vov32u[: v_ov32.size] = v_ov32
    didx, dvals = jax.jit(transfer.byte_unpack_sparse)(
        g8u, govu, v8u, vov16u, vov32u, np.int32(idx.size))
    didx = np.asarray(didx)[: idx.size]
    dvals = np.asarray(dvals)[: idx.size]
    np.testing.assert_array_equal(didx, idx)
    np.testing.assert_array_equal(dvals, vals)


def test_byte_upload_decode_matches_fallback(medium_frame, monkeypatch):
    """Full decode through the byte-upload kernel == the bitmap/index
    fallback (EBCC_NO_BYTE_UPLOAD=1) bit for bit."""
    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR
    from ebcc_tpu.core import codec

    cfg = CodecConfig(dims=(1, 256, 256), base_cr=30,
                      residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
    blob = codec.encode(medium_frame, cfg)
    a = codec.decode(blob)
    monkeypatch.setenv("EBCC_NO_BYTE_UPLOAD", "1")
    b = codec.decode(blob)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,density", [(65536, 0.1), (736 * 1440, 0.03)])
def test_compact_rice_exchange_classed_roundtrip(n, density):
    """Subband-classed value stream: device pack + host classed decode must
    reproduce (idx, vals) exactly; classes derived identically on both
    sides from positions."""
    native = _native()
    hp, wp = (256, 256) if n == 65536 else (736, 1440)
    vals = _sparse_vals(n, density, lo=-60000, hi=60000, seed=9)
    ref_idx = np.flatnonzero(vals)
    nnz = ref_idx.size
    cap = transfer.bucket_count(nnz)
    words, wn = transfer.compact_rice_exchange(
        vals, np.packbits(vals != 0), cap=cap, hw=(hp, wp))
    head = np.asarray(jax.device_get(words))[: int(wn)]
    ga, vb = transfer.split_rice_pair(head, nnz)

    idx = native.rice_decode_gaps_classed(
        ga, nnz, hp, wp, transfer.unpack_rice_ks(ga[1]))
    np.testing.assert_array_equal(idx, ref_idx)
    cls = transfer.coeff_class_host(idx, hp, wp)
    dev_cls = np.asarray(transfer.coeff_class(
        jax.numpy.asarray(idx.astype(np.int32)), hp, wp))
    np.testing.assert_array_equal(cls, dev_cls)
    out = native.rice_decode_classed(vb, nnz, cls,
                                     transfer.unpack_rice_ks(vb[1]))
    np.testing.assert_array_equal(out, vals[ref_idx])


@pytest.mark.parametrize("n,density", [
    (8192, 0.05), (65536, 0.25), (5000, 0.6),
])
def test_nibble_pack_sparse_roundtrip(n, density):
    """Nibble-tiered upload: host pack -> device unpack reproduces
    (idx, vals) exactly through all four tiers (wavelet-like geometric
    magnitudes with a heavy-tail sprinkle exercising u16/i32 tiers)."""
    rng = np.random.default_rng(13)
    vals_dense = np.zeros(n, np.int32)
    k = max(1, int(n * density))
    pos = rng.choice(n, size=k, replace=False)
    mag = np.maximum(1, rng.geometric(0.3, size=k))
    heavy = rng.random(k) < 0.02
    mag = np.where(heavy, rng.integers(200, 100000, size=k), mag)
    sign = np.where(rng.random(k) < 0.5, -1, 1)
    vals_dense[pos] = (sign * mag).astype(np.int32)
    idx = np.flatnonzero(vals_dense).astype(np.int64)
    vals = vals_dense[idx]
    gt, vt = transfer.nibble_pack_sparse_host(idx, vals)
    cap = transfer.bucket_count(idx.size)
    if not (transfer.nibble_fits(gt, cap, "gap")
            and transfer.nibble_fits(vt, cap, "val")):
        pytest.skip("tier overflow for this distribution")

    def tiers(t, leg):
        c8, c16, c32 = transfer.nib_tier_caps(cap, leg)
        nibs = transfer.pack_nibbles(t[0], cap)
        s8 = np.zeros(c8, np.uint8); s8[: t[1].size] = t[1]
        s16 = np.zeros(c16, np.uint16); s16[: t[2].size] = t[2]
        s32 = np.zeros(c32, np.int32); s32[: t[3].size] = t[3]
        return (jax.numpy.asarray(nibs), jax.numpy.asarray(s8),
                jax.numpy.asarray(s16), jax.numpy.asarray(s32))

    didx, dvals = jax.jit(transfer.nibble_unpack_sparse)(
        tiers(gt, "gap"), tiers(vt, "val"), np.int32(idx.size))
    np.testing.assert_array_equal(np.asarray(didx)[: idx.size], idx)
    np.testing.assert_array_equal(np.asarray(dvals)[: idx.size], vals)


def test_nibble_upload_decode_matches_fallbacks(medium_frame, monkeypatch):
    """decode via nibble upload == byte upload == bitmap/index fallback."""
    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR
    from ebcc_tpu.core import codec

    cfg = CodecConfig(dims=(1, 256, 256), base_cr=30,
                      residual_mode=RESIDUAL_MAX_ERROR, error=0.1)
    blob = codec.encode(medium_frame, cfg)
    a = codec.decode(blob)
    monkeypatch.setenv("EBCC_NO_NIBBLE_UPLOAD", "1")
    b = codec.decode(blob)
    monkeypatch.setenv("EBCC_NO_BYTE_UPLOAD", "1")
    c = codec.decode(blob)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, c)


def test_scatter_last_coefficient_not_clobbered():
    """Regression: -1 padding in the sparse uploads must NOT wrap onto the
    LAST coefficient (jnp scatter mode='drop' drops only out-of-bounds-HIGH
    indices; negative ones wrap NumPy-style).  A batch whose final padded-
    grid coefficient is significant exercises exactly that slot."""
    b, d0, hp, wp = 1, 1, 32, 32
    s = b * d0 * hp * wp
    flat = np.zeros(2 * s, np.int32)
    flat[3] = 5
    flat[2 * s - 1] = -9          # LAST residual coefficient significant
    idx = np.flatnonzero(flat).astype(np.int64)
    vals = flat[idx]
    scalars = [np.zeros(b, np.int32), np.zeros(b, np.int32),
               np.zeros(b, np.float32), np.ones(b, np.float32),
               np.zeros(b, np.float32), np.ones(b, np.float32)]
    kw = dict(base_levels=3, res_levels=3, out_hw=(32, 32),
              has_residual=True, grid_shape=(b, d0, hp, wp))
    cap = transfer.bucket_count(idx.size)  # cap >> nnz: padding present

    # reference: bitmap kernel (immune to the wrap by construction)
    sigb = np.zeros(2 * s, np.uint8)
    sigb[idx] = 1
    vals_up = np.zeros(cap, np.int16)
    vals_up[: vals.size] = vals.astype(np.int16)
    ref = np.asarray(kernels.decode_batch_sparse_bitmap(
        np.packbits(sigb), vals_up, *scalars, **kw))

    # index kernel
    idx_up = transfer.pad_index(idx.astype(np.int32), cap, -1)
    got = np.asarray(kernels.decode_batch_sparse(idx_up, vals_up, *scalars,
                                                 **kw))
    np.testing.assert_array_equal(got, ref)

    # byte kernel
    g8, g_ov, v8, v_ov16, v_ov32 = transfer.byte_pack_sparse_host(idx, vals)
    gcap = transfer.overflow_bucket(max(1, g_ov.size))
    vcap = transfer.overflow_bucket(max(1, v_ov16.size))
    wcap = transfer.overflow_bucket(max(1, v_ov32.size))
    bytes_u8 = np.zeros(2 * cap + 2 * vcap, np.uint8)
    bytes_u8[: g8.size] = g8
    bytes_u8[cap: cap + v8.size] = v8
    bytes_u8[2 * cap: 2 * cap + 2 * v_ov16.size] = (
        v_ov16.astype("<u2").view(np.uint8))
    ints = np.zeros(gcap + wcap + 2 * b + 1, np.int32)
    ints[: g_ov.size] = g_ov
    ints[gcap: gcap + v_ov32.size] = v_ov32
    ints[gcap + wcap + 2 * b] = idx.size
    floats = np.stack([scalars[2], scalars[3], scalars[4], scalars[5]])
    got_b = np.asarray(kernels.decode_batch_sparse_bytes(
        bytes_u8, ints, floats, cap=cap, gcap=gcap, vcap=vcap, wcap=wcap,
        **kw))
    np.testing.assert_array_equal(got_b, ref)

    # nibble kernel (the default upload path)
    gt, vt = transfer.nibble_pack_sparse_host(idx, vals)
    assert transfer.nibble_fits(gt, cap, "gap")
    assert transfer.nibble_fits(vt, cap, "val")
    nb2 = (cap + 1) // 2
    g8c, g16c, g32c = transfer.nib_tier_caps(cap, "gap")
    v8c, v16c, v32c = transfer.nib_tier_caps(cap, "val")
    nbuf = np.zeros(2 * nb2 + g8c + v8c + 2 * (g16c + v16c), np.uint8)
    o = 0
    nbuf[o:o + nb2] = transfer.pack_nibbles(gt[0], cap); o += nb2
    nbuf[o:o + nb2] = transfer.pack_nibbles(vt[0], cap); o += nb2
    nbuf[o:o + gt[1].size] = gt[1]; o += g8c
    nbuf[o:o + vt[1].size] = vt[1]; o += v8c
    nbuf[o:o + 2 * gt[2].size] = gt[2].astype("<u2").view(np.uint8)
    o += 2 * g16c
    nbuf[o:o + 2 * vt[2].size] = vt[2].astype("<u2").view(np.uint8)
    nints = np.zeros(g32c + v32c + 2 * b + 1, np.int32)
    nints[: gt[3].size] = gt[3]
    nints[g32c: g32c + vt[3].size] = vt[3]
    nints[g32c + v32c + 2 * b] = idx.size
    got_n = np.asarray(kernels.decode_batch_sparse_nibble(
        nbuf, nints, floats, cap=cap, **kw))
    np.testing.assert_array_equal(got_n, ref)


class TestRiceBlockUpload:
    """Blocked-Rice decode-direction exchange (transfer.rice_block_pack_host
    / rice_block_unpack): exact round-trip at every size/escape regime and
    through the staged kernel (rice_unpack_qflat)."""

    @pytest.mark.parametrize("n,scale", [
        (100_000, 5), (5_000, 500), (1, 1), (0, 1),
        (300, 2 ** 20),                 # forces 32-bit escape codes
        (127, 3), (128, 3), (129, 3),   # block-boundary sizes
    ])
    def test_roundtrip_exact(self, n, scale):
        rng = np.random.default_rng(n + scale)
        if n:
            idx = np.sort(rng.choice(20_000_000, size=n,
                                     replace=False)).astype(np.int64)
            vals = np.clip(rng.standard_cauchy(n) * scale,
                           -2 ** 31 + 1, 2 ** 31 - 1).astype(np.int32)
        else:
            idx = np.zeros(0, np.int64)
            vals = np.zeros(0, np.int32)
        words, lg, lv, kp, bp, nb = transfer.rice_block_pack_host(idx, vals)
        assert int(lg.astype(np.int64).sum() + lv.astype(np.int64).sum()
                   ) <= 32 * words.size
        nbk = transfer.rice_block_bucket(nb)
        pad = lambda a, c, dt: np.concatenate(
            [a, np.zeros(c - a.size, dt)]).astype(dt)
        f = jax.jit(lambda w, a, b_, c, d, z: transfer.rice_block_unpack(
            w, a, b_, c, d, z, n_blocks=nbk))
        i2, v2 = f(words, pad(lg, nbk, np.uint16), pad(lv, nbk, np.uint16),
                   pad(kp, nbk, np.uint8), pad(bp, nbk, np.int32),
                   np.int32(n))
        i2, v2 = np.asarray(i2), np.asarray(v2)
        np.testing.assert_array_equal(i2[:n], idx)
        assert (i2[n:] == -1).all()
        np.testing.assert_array_equal(v2[:n], vals)

    def test_near_entropy_size(self):
        """On geometric-ish gaps + small values (the ERA5 exchange shape)
        the blocked-Rice stream must land well under the nibble tiers'
        ~1.9 B/coeff shipped footprint."""
        rng = np.random.default_rng(0)
        n = 200_000
        gaps = rng.geometric(1 / 15, size=n)
        idx = np.cumsum(gaps).astype(np.int64) - 1
        vals = np.round(rng.standard_t(4, size=n) * 4).astype(np.int32)
        words, *_ = transfer.rice_block_pack_host(idx, vals)
        assert words.nbytes / n < 1.6

    def test_staged_kernel_matches_reference_scatter(self):
        rng = np.random.default_rng(7)
        grid = (2, 1, 64, 64)
        s = int(np.prod(grid))
        n = 800
        idx = np.sort(rng.choice(2 * s, size=n, replace=False)).astype(
            np.int64)
        vals = rng.integers(-4000, 4000, size=n).astype(np.int32)
        words, lg, lv, kp, bp, nb = transfer.rice_block_pack_host(idx, vals)
        nbk = transfer.rice_block_bucket(nb)
        nwk = transfer.rice_block_bucket(words.size)
        ne = grid[0]
        n_ints = nbk + 2 * ne + 1
        buf = np.zeros(4 * nwk + 5 * nbk + 4 * n_ints + 16 * ne, np.uint8)
        o = 0
        buf[:4 * words.size] = words.view(np.uint8)
        o += 4 * nwk
        buf[o:o + 2 * nb] = lg.view(np.uint8)
        o += 2 * nbk
        buf[o:o + 2 * nb] = lv.view(np.uint8)
        o += 2 * nbk
        buf[o:o + nb] = kp
        o += nbk
        ints = np.zeros(n_ints, np.int32)
        ints[:nb] = bp
        ints[nbk:nbk + ne] = 3          # base_cut
        ints[nbk + ne:nbk + 2 * ne] = 2  # res_cut
        ints[nbk + 2 * ne] = n
        buf[o:o + 4 * n_ints] = ints.view(np.uint8)
        floats = np.stack([np.zeros(ne), np.ones(ne), np.zeros(ne),
                           np.ones(ne)]).astype(np.float32)
        buf[o + 4 * n_ints:] = floats.reshape(-1).view(np.uint8)
        qflat, bc, rc, fl = kernels.rice_unpack_qflat(
            buf, n_blocks=nbk, n_words=nwk, n_entries=ne, s=s)
        ref = np.zeros(2 * s, np.int32)
        ref[idx] = vals
        np.testing.assert_array_equal(np.asarray(qflat), ref)
        assert (np.asarray(bc) == 3).all() and (np.asarray(rc) == 2).all()
        np.testing.assert_array_equal(np.asarray(fl), floats)

    @pytest.mark.parametrize("n,scale", [
        (100_000, 5), (5_000, 500), (1, 1), (0, 1),
        (300, 2 ** 20),                 # forces 32-bit escape codes
        (127, 3), (128, 3), (129, 3),   # block-boundary sizes
    ])
    def test_native_pack_matches_host(self, n, scale):
        """The C packer (native.rice_block_pack) is the production path for
        the decode-direction upload; its bit output must equal the numpy
        reference (rice_block_pack_host) exactly — otherwise a C-side
        packing divergence surfaces only as corrupted integration
        roundtrips, never as a targeted failure."""
        native = _native()
        rng = np.random.default_rng(n + scale)
        if n:
            idx = np.sort(rng.choice(20_000_000, size=n,
                                     replace=False)).astype(np.int64)
            vals = np.clip(rng.standard_cauchy(n) * scale,
                           -2 ** 31 + 1, 2 ** 31 - 1).astype(np.int32)
        else:
            idx = np.zeros(0, np.int64)
            vals = np.zeros(0, np.int32)
        hw, hlg, hlv, hkp, hbp, hnb = transfer.rice_block_pack_host(
            idx, vals)
        nw, nlg, nlv, nkp, nbp, nnb = native.rice_block_pack(idx, vals)
        assert hnb == nnb
        np.testing.assert_array_equal(hlg, nlg)
        np.testing.assert_array_equal(hlv, nlv)
        np.testing.assert_array_equal(hkp, nkp)
        np.testing.assert_array_equal(hbp, nbp)
        total_bits = int(hlg.astype(np.int64).sum()
                         + hlv.astype(np.int64).sum())
        used = -(-total_bits // 32)
        assert hw.size >= used and nw.size >= used
        np.testing.assert_array_equal(hw[:used], nw[:used])
        # Trailing pad words must be zero in both (the device unpacker
        # reads a 3-word window past the final code).
        assert not hw[used:].any() and not nw[used:].any()


class TestSlicedTransfers:
    """sliced_get/sliced_put must be byte-identical to plain device_get/
    device_put — only the wire schedule differs (concurrent slice RPCs)."""

    def test_sliced_get_identity(self):
        import jax

        rng = np.random.default_rng(11)
        for n in (100, 500_000, 1_000_001):
            host = rng.integers(0, 2**31, n, np.int64).astype(np.int32)
            dev = jax.device_put(host)
            got = transfer.sliced_get(dev)
            assert got.dtype == host.dtype
            np.testing.assert_array_equal(got, host)

    def test_sliced_put_identity(self):
        import jax

        rng = np.random.default_rng(12)
        for n in (64, 900_000):
            host = rng.integers(0, 256, n, np.int64).astype(np.uint8)
            dev = transfer.sliced_put(host)
            np.testing.assert_array_equal(
                np.asarray(jax.device_get(dev)), host)

    def test_stream_env_disable(self, monkeypatch):
        import jax

        monkeypatch.setenv("EBCC_LINK_STREAMS", "1")
        host = np.arange(500_000, dtype=np.int32)
        got = transfer.sliced_get(jax.device_put(host))
        np.testing.assert_array_equal(got, host)
