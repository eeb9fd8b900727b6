"""Transform-layer unit tests (parity role: golden tests for the transform
engine behind both layers, cf. reference dwt.h behavior)."""

import numpy as np
import pytest

import jax.numpy as jnp

jnp = pytest.importorskip("jax.numpy")

from ebcc_tpu.ops import bitplane, dwt


@pytest.mark.parametrize("shape,levels", [
    ((1, 32, 32), 1),
    ((2, 64, 96), 3),
    ((3, 2, 64, 128), 4),
    ((1, 160, 224), 5),
])
def test_perfect_reconstruction(shape, levels):
    rng = np.random.default_rng(42)
    x = (rng.normal(size=shape) * 100).astype(np.float32)
    y = dwt.dwt2d(jnp.asarray(x), levels)
    xr = np.asarray(dwt.idwt2d(y, levels))
    np.testing.assert_allclose(xr, x, atol=5e-3)


def test_constant_annihilation():
    """9/7 highpass must annihilate constants (2 vanishing moments),
    including at the replicated boundaries."""
    c = jnp.full((1, 64, 64), 777.0, jnp.float32)
    y = np.asarray(dwt.dwt2d(c, 3))
    detail = y.copy()
    detail[0, :8, :8] = 0.0
    assert np.abs(detail).max() < 1e-2


def test_energy_compaction_smooth():
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (np.sin(yy / 9.0) * np.cos(xx / 7.0) * 1000).astype(np.float32)
    y = np.asarray(dwt.dwt2d(jnp.asarray(smooth[None]), 3))
    ll = y[0, :16, :16]
    assert (ll ** 2).sum() / (y ** 2).sum() > 0.95


def test_pad_unpad_roundtrip():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 45, 70)).astype(np.float32))
    xp, hw = dwt.pad_to_multiple(x, 32)
    assert xp.shape[-2] % 32 == 0 and xp.shape[-1] % 32 == 0
    assert np.array_equal(np.asarray(dwt.unpad(xp, hw)), np.asarray(x))


def test_subband_shapes_cover():
    bands = dwt.subband_shapes(64, 128, 3)
    total = sum(r * c for _, (_, _, r, c) in bands)
    assert total == 64 * 128
    assert bands[0][0] == "LL3"


class TestBitplane:
    def test_pack_unpack(self):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, size=(3, 5, 64)).astype(np.uint8)
        packed = bitplane.pack_bits_last_axis(jnp.asarray(bits))
        assert packed.shape == (3, 5, 8)
        out = np.asarray(bitplane.unpack_bits_last_axis(packed))
        assert np.array_equal(out, bits)

    def test_planes_roundtrip_exact(self):
        rng = np.random.default_rng(2)
        q = rng.integers(-5000, 5000, size=(2, 32, 64)).astype(np.int32)
        planes, signs = bitplane.extract_planes(jnp.asarray(q), 14)
        mag = np.asarray(bitplane.assemble_magnitude(planes, 14))
        sbits = np.asarray(bitplane.unpack_bits_last_axis(signs)).astype(bool)
        q2 = np.where(sbits, -mag, mag)
        assert np.array_equal(q2, q)

    @pytest.mark.parametrize("cut", [0, 2, 5, 9])
    def test_cut_error_bound(self, cut):
        """Midpoint deadzone reconstruction error must be < 2^cut per coeff."""
        rng = np.random.default_rng(3)
        q = rng.integers(-4000, 4000, size=(1, 16, 32)).astype(np.int32)
        rec = np.asarray(bitplane.reconstruct_at_cut(jnp.asarray(q), jnp.int32(cut)))
        assert np.abs(rec - q).max() <= (1 << cut)

    def test_cut_monotone(self):
        rng = np.random.default_rng(4)
        q = rng.integers(-4000, 4000, size=(1, 16, 32)).astype(np.int32)
        errs = [
            np.abs(np.asarray(bitplane.reconstruct_at_cut(jnp.asarray(q), jnp.int32(c))) - q).max()
            for c in range(12)
        ]
        assert all(a <= b + 1e-6 for a, b in zip(errs, errs[1:]))


class TestMathematicalProperties:
    """Independent checks against known CDF 9/7 mathematics (not
    self-referential golden data): vanishing moments, DC gain, and
    near-orthogonality."""

    def test_linear_ramp_annihilation(self):
        """The 9/7 analysis highpass has 4 vanishing moments: polynomials
        up to degree 3 must map to (near-)zero detail coefficients away
        from boundaries."""
        n = 256
        t = np.arange(n, dtype=np.float32)
        for poly in [t, t ** 2 / n, t ** 3 / n ** 2]:
            sig = jnp.asarray(np.tile(poly, (8, 1)))
            y = np.asarray(dwt.dwt1d(sig))
            detail_interior = y[:, n // 2 + 4: n - 4]
            scale = float(np.abs(poly).max())
            assert np.abs(detail_interior).max() < 1e-3 * scale

    def test_dc_gain_sqrt2(self):
        """Scaled lifting lowpass DC gain is sqrt(2) per 1-D pass (the
        energy-preserving normalization)."""
        c = jnp.full((1, 128), 10.0, jnp.float32)
        y = np.asarray(dwt.dwt1d(c))
        lo = y[0, :64]
        np.testing.assert_allclose(lo, 10.0 * np.sqrt(2), rtol=1e-4)

    def test_near_orthogonality(self):
        """9/7 with this normalization is near-orthogonal: energy is
        preserved to within a few percent for white noise."""
        rng = np.random.default_rng(0)
        x = rng.normal(size=(4, 128, 128)).astype(np.float32)
        y = np.asarray(dwt.dwt2d(jnp.asarray(x), 3))
        ratio = (y ** 2).sum() / (x ** 2).sum()
        assert 0.85 < ratio < 1.15, ratio

    def test_impulse_response_taps(self):
        """The lowpass analysis taps (impulse responses) must match the
        published CDF 9/7 filter (float32 lifting precision) after the sqrt(2) normalization."""
        # JPEG2000 / CDF 9/7 analysis lowpass, DC-gain-1 convention.
        h_ref = np.array([
            0.026748757411, -0.016864118443, -0.078223266529,
            0.266864118443, 0.602949018236, 0.266864118443,
            -0.078223266529, -0.016864118443, 0.026748757411])
        n = 64
        rows = []
        for shift in range(-4, 5):
            e = np.zeros((1, n), np.float32)
            e[0, n // 2 + shift] = 1.0
            y = np.asarray(dwt.dwt1d(jnp.asarray(e)))
            rows.append(y[0, n // 4])  # lowpass coefficient at center
        taps = np.array(rows[::-1])
        np.testing.assert_allclose(taps, np.sqrt(2) * h_ref, atol=1e-4)


class TestCoarseFineSearch:
    """The coarse-to-fine cut search must agree with a brute-force dense
    scan whenever feasibility is monotone in the cut (always true up to
    float rounding; the refinement logic is the risky part)."""

    def _dense_reference(self, q, num_planes, levels, metrics_fn, crit):
        import jax

        b = q.shape[0]

        def body(cut):
            spatial = dwt.idwt2d_dequant(
                q, jnp.broadcast_to(cut, (b,)), levels)
            return metrics_fn(spatial, cut)

        stacked = jax.lax.map(body, jnp.arange(num_planes, dtype=jnp.int32))
        feas = np.asarray(crit(stacked))
        cuts = np.zeros(b, np.int32)
        for i in range(b):
            idx = np.flatnonzero(feas[:, i])
            cuts[i] = int(idx.max()) if idx.size else 0
        return cuts, feas.any(axis=0)

    def test_matches_dense_scan(self):
        from ebcc_tpu.core.kernels import _coarse_fine_search
        from ebcc_tpu.ops import bitplane as bp

        rng = np.random.default_rng(11)
        levels, num_planes = 2, 10
        x = (rng.normal(0, 1, (4, 1, 32, 32)) * 300).astype(np.float32)
        q = bp.quantize_floor(dwt.dwt2d(jnp.asarray(x), levels))
        # a spread of targets so chunks land on different cuts
        targets = jnp.asarray([2.0, 10.0, 45.0, 500.0], jnp.float32)

        def metrics(spatial, cut):
            err = jnp.abs(jnp.asarray(x) - spatial)
            return (err.max(axis=(1, 2, 3)),)

        crit = lambda m: m[0] <= targets
        [(cut, anyf, (maxe,))], _, _ = _coarse_fine_search(
            q, num_planes, levels, metrics, [crit])
        ref_cut, ref_any = self._dense_reference(
            q, num_planes, levels, metrics, crit)
        np.testing.assert_array_equal(np.asarray(cut), ref_cut)
        np.testing.assert_array_equal(np.asarray(anyf), ref_any)
        # reported metrics must be the metrics AT the chosen cut
        feasible = np.asarray(anyf)
        me = np.asarray(maxe)
        tg = np.asarray(targets)
        assert (me[feasible] <= tg[feasible]).all()

    def test_none_feasible_defaults_to_cut_zero(self):
        from ebcc_tpu.core.kernels import _coarse_fine_search

        rng = np.random.default_rng(3)
        levels, num_planes = 1, 6
        x = (rng.normal(0, 1, (2, 1, 32, 32)) * 300).astype(np.float32)
        from ebcc_tpu.ops import bitplane as bp
        q = bp.quantize_floor(dwt.dwt2d(jnp.asarray(x), levels))

        def metrics(spatial, cut):
            err = jnp.abs(jnp.asarray(x) - spatial)
            return (err.max(axis=(1, 2, 3)),)

        crit = lambda m: m[0] <= jnp.float32(-1.0)  # impossible
        [(cut, anyf, (maxe,))], _, _ = _coarse_fine_search(
            q, num_planes, levels, metrics, [crit])
        assert not np.asarray(anyf).any()
        np.testing.assert_array_equal(np.asarray(cut), 0)
        # metrics reported at cut 0 (the finest), not at a coarse row
        spatial0 = dwt.idwt2d_dequant(q, jnp.zeros(2, jnp.int32), levels)
        ref = np.abs(x - np.asarray(spatial0)).max(axis=(1, 2, 3))
        np.testing.assert_allclose(np.asarray(maxe), ref, rtol=1e-6)


class TestMetrics:
    """ops.metrics — the reduction primitives the encode programs' scans
    are built from (reference get_* scans, ebcc_codec.c:450-533)."""

    def test_against_numpy(self):
        from ebcc_tpu.ops import metrics

        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 2, 16, 16)).astype(np.float32)
        r = x + rng.normal(scale=0.1, size=x.shape).astype(np.float32)
        err = x - r
        lo, hi = metrics.minmax(x)
        np.testing.assert_allclose(lo, x.min(axis=(1, 2, 3)))
        np.testing.assert_allclose(hi, x.max(axis=(1, 2, 3)))
        np.testing.assert_allclose(
            metrics.max_abs_error(x, r), np.abs(err).max(axis=(1, 2, 3)),
            rtol=1e-6)
        np.testing.assert_allclose(
            metrics.mean_error(x, r), err.mean(axis=(1, 2, 3)), atol=1e-6)
        maxc, m = metrics.centered_max_abs_error(x, r)
        ref = np.abs(err - err.mean(axis=(1, 2, 3), keepdims=True)).max(
            axis=(1, 2, 3))
        np.testing.assert_allclose(maxc, ref, rtol=1e-5)
        tgt = np.full(3, 0.1, np.float32)
        q = metrics.error_quantile(x, r, tgt)
        refq = (np.abs(err) <= 0.1).mean(axis=(1, 2, 3))
        np.testing.assert_allclose(q, refq, atol=1e-6)
        assert bool(metrics.check_finite(x))
        x[0, 0, 0, 0] = np.nan
        assert not bool(metrics.check_finite(x))


class TestQuantizeDequantHelpers:
    """ops.dwt.dwt2d_quantize / idwt2d_dequant — the fused forms every
    encode scan and decode program calls — against the unfused
    transform + bitplane primitives, per chunk."""

    @pytest.mark.parametrize("shape,levels,cuts", [
        ((2, 1, 64, 64), 3, (0, 5)),
        ((3, 2, 32, 64), 2, (7, 1, 0)),
    ])
    def test_matches_unfused(self, shape, levels, cuts):
        rng = np.random.default_rng(3)
        x = (rng.normal(size=shape) * 3000).astype(np.float32)
        q = dwt.dwt2d_quantize(jnp.asarray(x), levels)
        q_ref = np.trunc(np.asarray(dwt.dwt2d(jnp.asarray(x), levels)))
        assert q.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(q), q_ref.astype(np.int32))

        got = np.asarray(dwt.idwt2d_dequant(q, jnp.asarray(cuts), levels))
        for i, cut in enumerate(cuts):
            rec = bitplane.reconstruct_at_cut(q[i:i + 1], jnp.int32(cut))
            want = np.asarray(dwt.idwt2d(rec, levels))[0]
            np.testing.assert_array_equal(got[i], want)
        # a scalar cut broadcasts over the batch
        one = np.asarray(dwt.idwt2d_dequant(q, cuts[0], levels))
        np.testing.assert_array_equal(
            one[0], np.asarray(dwt.idwt2d_dequant(
                q[:1], jnp.asarray([cuts[0]]), levels))[0])
