"""Device-side bitplane quantization, packing, and cut reconstruction.

Role parity: replaces the reference's two entropy-oriented coefficient
representations — SPIHT's bit-serial set-partitioned stream (reference
``src/spiht/spiht_re.c:208-430``) and OpenJPEG's EBCOT code-blocks — with a
vector-friendly *dense fixed-layout* bitplane code:

  * Coefficients are floor-quantized toward zero (parity with ``normalize``,
    reference ``src/spiht/dwt.h:355-368``), giving exact integer bitplane
    semantics.
  * Every magnitude bitplane is emitted as a dense packed bitmask over the
    whole coefficient array (MSB-plane first).  Signs are a single dense
    masked plane.  The stream is prefix-truncatable at plane granularity:
    dropping low planes = coarser deadzone quantization, with monotonically
    decreasing quality — the same embedded property SPIHT's truncation search
    exploits (reference ``src/ebcc_codec.c:765-807``), but the whole
    error-vs-cut curve is computable in one batched pass on device.
  * Entropy coding of the packed planes happens on host (zstd or the native
    coder); see ``ebcc_tpu.core.entropy``.

All functions are shape-static and jit/vmap-friendly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def quantize_floor(coeffs):
    """Floor-toward-zero integer quantization of float coefficients.

    Parity: reference ``normalize`` (dwt.h:355-368).  Returns int32.
    """
    return jnp.trunc(coeffs).astype(jnp.int32)


def pack_bits_last_axis(bits):
    """Pack a {0,1} uint8/int32 array's last axis (len divisible by 8) into bytes.

    MSB-first within each byte.  ``(..., W)`` -> ``(..., W // 8)`` uint8.
    """
    w = bits.shape[-1]
    assert w % 8 == 0, w
    b = bits.reshape(*bits.shape[:-1], w // 8, 8).astype(jnp.uint8)
    weights = (1 << jnp.arange(7, -1, -1, dtype=jnp.uint8)).astype(jnp.uint8)
    return (b * weights).sum(axis=-1, dtype=jnp.uint8)


def unpack_bits_last_axis(packed):
    """Inverse of :func:`pack_bits_last_axis`: ``(..., Wb)`` -> ``(..., Wb*8)``."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


@functools.partial(jax.jit, static_argnames=("num_planes",))
def extract_planes(q, num_planes: int):
    """Split int32 coefficients into packed magnitude bitplanes + sign plane.

    Args:
      q: ``(..., H, W)`` int32 quantized coefficients, |q| < 2**num_planes.
      num_planes: static number of magnitude planes.

    Returns:
      planes: ``(num_planes, ..., H, W//8)`` uint8 — plane ``p`` holds bit
        ``num_planes-1-p`` (MSB plane first).
      signs:  ``(..., H, W//8)`` uint8 — sign bits masked to significant
        (|q| > 0) coefficients only, so insignificant positions are
        deterministic zeros (compressibility + determinism).
    """
    mag = jnp.abs(q)
    outs = []
    for p in range(num_planes - 1, -1, -1):
        outs.append(pack_bits_last_axis((mag >> p) & 1))
    planes = jnp.stack(outs, axis=0)
    sign_bits = ((q < 0) & (mag > 0)).astype(jnp.uint8)
    signs = pack_bits_last_axis(sign_bits)
    return planes, signs


@functools.partial(jax.jit, static_argnames=("num_planes",))
def assemble_magnitude(planes, num_planes: int):
    """Rebuild |q| from packed planes: inverse of the magnitude half of
    :func:`extract_planes`.  Planes below the transmitted cut must be
    zero-filled by the caller.  Returns int32 magnitudes ``(..., H, W)``.
    """
    mag = None
    for i in range(num_planes):
        p = num_planes - 1 - i  # bit index of plane row i
        bits = unpack_bits_last_axis(planes[i]).astype(jnp.int32) << p
        mag = bits if mag is None else mag + bits
    return mag


def reconstruct_at_cut(q, cut, *, deadzone_offset: bool = True):
    """Dequantized float coefficients when planes below bit ``cut`` are dropped.

    ``cut`` may be a traced scalar (or broadcastable per-batch array), making
    the whole error-vs-cut curve computable with ``vmap``/``lax.map`` over
    candidate cuts — this replaces the reference's serial truncation bisection
    (HOT LOOP 2, ebcc_codec.c:765-807) with one batched pass.

    Reconstruction uses midpoint (half-step) dequantization inside the
    retained interval and a deadzone at zero: strictly better rate-distortion
    than the reference's floor-value reconstruction, allowed because this is
    our own format.
    """
    mag = jnp.abs(q)
    kept = (mag >> cut) << cut
    significant = kept > 0
    if deadzone_offset:
        offset = jnp.where(cut > 0, (1 << cut) >> 1, 0)
        recon_mag = kept.astype(jnp.float32) + jnp.where(
            significant, offset, 0
        ).astype(jnp.float32) + jnp.where(significant & (cut == 0), 0.5, 0.0)
    else:
        recon_mag = kept.astype(jnp.float32)
    return jnp.where(q < 0, -recon_mag, recon_mag)


def plane_bit_density(q, num_planes: int):
    """Fraction of 1-bits per magnitude plane: ``(num_planes, ...)`` float32,
    plane order MSB-first (matching :func:`extract_planes`).

    Used for the device-side coded-size estimate that drives rate targeting
    (role of OpenJPEG's rate allocation for ``tcp_rates``/base_cr,
    reference ebcc_codec.c:116).
    """
    mag = jnp.abs(q)
    dens = []
    n = q.shape[-1] * q.shape[-2]
    for p in range(num_planes - 1, -1, -1):
        dens.append(((mag >> p) & 1).sum(axis=(-1, -2)).astype(jnp.float32) / n)
    return jnp.stack(dens, axis=0)


def estimated_code_bytes(q, num_planes: int, zstd_efficiency: float = 1.35):
    """Estimated entropy-coded size (bytes) of the stream cut at each plane.

    For cut index c (keeping plane rows [0, num_planes-c)), the estimate is
    the binary entropy of each kept plane plus one sign bit per coefficient
    significant at that cut, inflated by ``zstd_efficiency`` (zstd does not
    reach the iid entropy bound on packed bitmasks).  Returns
    ``(num_planes + 1, ...)`` float32 where index k = size when cutting at
    bit k (k=0 keeps everything; k=num_planes keeps nothing).
    """
    mag = jnp.abs(q)
    n = q.shape[-1] * q.shape[-2]
    dens = plane_bit_density(q, num_planes)  # MSB first
    eps = 1e-12
    ent = -(dens * jnp.log2(dens + eps) + (1 - dens) * jnp.log2(1 - dens + eps))
    plane_bits = ent * n  # (num_planes, ...)
    zero = jnp.zeros(q.shape[:-2], jnp.float32)
    sizes = []
    for cutbit in range(num_planes + 1):
        if cutbit < num_planes:
            keep = plane_bits[: num_planes - cutbit].sum(axis=0)
            sig = (mag >> cutbit).astype(bool).sum(axis=(-1, -2)).astype(jnp.float32)
        else:
            keep = sig = zero
        sizes.append((keep + sig) / 8.0 * zstd_efficiency)
    return jnp.stack(sizes, axis=0)
