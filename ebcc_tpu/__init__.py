"""ebcc_tpu — an error-bounded climate-data compressor in JAX.

A from-scratch JAX/XLA framework with the capabilities of spcl/EBCC: a
two-layer (base + residual) error-bounded lossy compressor for batches of
2-D float32 climate frames, with MAX_ERROR / RELATIVE_ERROR / NONE bound modes, chunked
self-describing containers, HDF5/Zarr/CLI integration, and multi-chip
scale-out over a `jax.sharding.Mesh`.

Quick start::

    import numpy as np
    from ebcc_tpu import CodecConfig, RESIDUAL_MAX_ERROR, encode, decode

    data = np.random.rand(1, 721, 1440).astype(np.float32)
    config = CodecConfig(dims=data.shape, base_cr=30,
                         residual_mode=RESIDUAL_MAX_ERROR, error=0.01)
    blob = encode(data, config)
    out = decode(blob)          # max |data - out| <= 0.01
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    BASE_NUM_PLANES,
    RES_NUM_PLANES,
    CodecConfig,
    EncodeOptions,
    RESIDUAL_LOSSLESS,
    RESIDUAL_MAX_ERROR,
    RESIDUAL_NONE,
    RESIDUAL_POINTWISE_RELATIVE_ERROR,
    RESIDUAL_RELATIVE_ERROR,
)
from .core.codec import (  # noqa: F401
    decode,
    decode_chunked,
    decode_chunked_region,
    decode_frames_device,
    encode,
    encode_chunked,
    encode_chunked_compat,
    encode_frames_device,
    roundtrip_frames_device,
)

# Subpackages (imported lazily by attribute access to keep import light):
# ebcc_tpu.api, ebcc_tpu.parallel, ebcc_tpu.io, ebcc_tpu.native, ebcc_tpu.ops

