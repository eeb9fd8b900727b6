"""Batched multi-level CDF 9/7 wavelet transform (lifting scheme).

Role parity: this is the transform engine behind BOTH layers of the codec,
re-expressing the reference's two separate DWTs — OpenJPEG's internal 9/7
DWT for the J2K base layer (reference ``src/ebcc_codec.c:105-180``) and the
hand-written residual DWT (reference ``src/spiht/dwt.h:87-317``) — as one
batched, jit-friendly implementation.

Architecture notes (why this is NOT a port):
  * The reference transforms one frame at a time with per-row/per-column C
    loops (``dwt_row``/``dwt_col``, dwt.h:87-194) and a hand-unrolled 8-wide
    inverse (``idwt_col8``, dwt.h:196-272).  Here every lifting step is a
    whole-array vector op over ``(..., H, W)`` batches: the batch dimension
    and the orthogonal spatial dimension are both vectorized by XLA, and
    frames are independent so the batch axis can be sharded across a
    device mesh with no halo exchange.
  * Boundary handling: the lifting steps use edge replication on the opposite
    parity array, which is algebraically identical to whole-point symmetric
    extension of the input signal (the scheme JPEG2000 uses).  Perfect
    reconstruction is exact by construction — every lifting step is
    individually invertible regardless of the boundary rule.
  * Layout: in-place Mallat pyramid, like the reference (dwt.h:293-317):
    after ``dwt2d(x, L)`` the top-left ``(H/2^l, W/2^l)`` block holds the
    level-l LL band; detail bands sit in the remaining quadrants.

Lifting constants match the canonical CDF 9/7 factorization (reference
dwt.h:3-7); they are public-domain wavelet math, not reference-specific.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import bitplane

# Canonical CDF 9/7 lifting coefficients (Daubechies & Sweldens 1998).
ALPHA = -1.586134342
BETA = -0.05298011854
GAMMA = 0.8829110762
DELTA = 0.44355068522
XI = 1.149604398


def _predict(odd, even, coef):
    """odd_i += coef * (even_i + even_{i+1}); even end-replicated."""
    even_next = jnp.concatenate([even[..., 1:], even[..., -1:]], axis=-1)
    return odd + coef * (even + even_next)


def _update(even, odd, coef):
    """even_i += coef * (odd_{i-1} + odd_i); odd front-replicated."""
    odd_prev = jnp.concatenate([odd[..., :1], odd[..., :-1]], axis=-1)
    return even + coef * (odd_prev + odd)


def dwt1d(x):
    """Forward 9/7 lifting along the last axis (length must be even).

    Returns the transformed axis laid out as [lowpass | highpass] halves.
    """
    even = x[..., 0::2]
    odd = x[..., 1::2]
    odd = _predict(odd, even, ALPHA)
    even = _update(even, odd, BETA)
    odd = _predict(odd, even, GAMMA)
    even = _update(even, odd, DELTA)
    return jnp.concatenate([even * XI, odd * (1.0 / XI)], axis=-1)


def idwt1d(y):
    """Inverse of :func:`dwt1d` along the last axis."""
    n = y.shape[-1]
    even = y[..., : n // 2] * (1.0 / XI)
    odd = y[..., n // 2 :] * XI
    even = _update(even, odd, -DELTA)
    odd = _predict(odd, even, -GAMMA)
    even = _update(even, odd, -BETA)
    odd = _predict(odd, even, -ALPHA)
    # Interleave even/odd back into the original sample order.
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(y.shape)


def _dwt_rows_cols(a):
    """One 2-D separable analysis step on the full (trailing HxW) block."""
    a = dwt1d(a)  # rows (last axis)
    a = jnp.swapaxes(dwt1d(jnp.swapaxes(a, -1, -2)), -1, -2)  # cols
    return a


def _idwt_rows_cols(a):
    a = jnp.swapaxes(idwt1d(jnp.swapaxes(a, -1, -2)), -1, -2)  # cols
    a = idwt1d(a)  # rows
    return a


@functools.partial(jax.jit, static_argnames=("levels",))
def dwt2d(x, levels: int):
    """Multi-level 2-D forward DWT, in-place Mallat layout.

    Args:
      x: ``(..., H, W)`` float32 with H, W divisible by ``2**levels``.
      levels: number of dyadic decomposition levels (static).
    """
    h, w = x.shape[-2], x.shape[-1]
    if h % (1 << levels) or w % (1 << levels):
        raise ValueError(f"dims ({h},{w}) not divisible by 2^{levels}")
    for lvl in range(levels):
        hl, wl = h >> lvl, w >> lvl
        block = _dwt_rows_cols(x[..., :hl, :wl])
        if (hl, wl) == (h, w):
            x = block
        else:
            x = jax.lax.dynamic_update_slice(
                x, block, (0,) * (x.ndim - 2) + (0, 0)
            )
    return x


@functools.partial(jax.jit, static_argnames=("levels",))
def idwt2d(y, levels: int):
    """Multi-level 2-D inverse DWT (inverse of :func:`dwt2d`)."""
    h, w = y.shape[-2], y.shape[-1]
    for lvl in range(levels - 1, -1, -1):
        hl, wl = h >> lvl, w >> lvl
        block = y[..., :hl, :wl]
        block = _idwt_rows_cols(block)
        if (hl, wl) == (h, w):
            y = block
        else:
            y = jax.lax.dynamic_update_slice(
                y, block, (0,) * (y.ndim - 2) + (0, 0)
            )
    return y


def dwt2d_quantize(x, levels: int):
    """Forward DWT + floor quantization: ``(..., Hp, Wp)`` f32 -> int32
    coefficients.  XLA fuses the quantization into the last lifting pass."""
    return bitplane.quantize_floor(dwt2d(x, levels))


def idwt2d_dequant(q, cut, levels: int):
    """Dequantize at a per-chunk cut + inverse DWT.

    q: (B, D0, Hp, Wp) int32; cut: (B,) int32 (or scalar).  This is the
    reconstruction arithmetic every decoder mirrors, and the one the
    encoder's cut searches verify the bound with.
    """
    cut = jnp.atleast_1d(jnp.asarray(cut, jnp.int32))
    if cut.shape[0] != q.shape[0]:
        cut = jnp.broadcast_to(cut, (q.shape[0],))
    rec = bitplane.reconstruct_at_cut(q, cut[:, None, None, None])
    return idwt2d(rec, levels)


def pad_to_multiple(x, multiple: int):
    """Symmetrically (reflect) pad trailing H, W up to a multiple.

    Mirrors the capability of the reference's ``load_image`` symmetric
    extension (dwt.h:48-76) but uses numpy-style reflect padding on device.
    Returns (padded, (orig_h, orig_w)).
    """
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return x, (h, w)
    pad_cfg = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
    # 'symmetric' (edge-inclusive mirror) matches the reference's extension
    # style; any invertible-pad works since we crop after reconstruction.
    mode = "symmetric" if ph < h and pw < w else "edge"
    return jnp.pad(x, pad_cfg, mode=mode), (h, w)


def unpad(x, orig_hw):
    h, w = orig_hw
    return x[..., :h, :w]


def subband_shapes(h: int, w: int, levels: int):
    """Return [(name, (row0, col0, rows, cols)), ...] coarse-to-fine.

    Describes the Mallat layout produced by :func:`dwt2d`: the deepest LL
    first, then (HL, LH, HH) per level from deepest to finest.
    """
    out = []
    hl, wl = h >> levels, w >> levels
    out.append((f"LL{levels}", (0, 0, hl, wl)))
    for lvl in range(levels, 0, -1):
        hh, ww = h >> lvl, w >> lvl
        out.append((f"HL{lvl}", (0, ww, hh, ww)))
        out.append((f"LH{lvl}", (hh, 0, hh, ww)))
        out.append((f"HH{lvl}", (hh, ww, hh, ww)))
    return out
