"""HDF5 integration.

The reference integrates via an HDF5 filter plugin (id 308) loaded by the
HDF5 C library (reference ``src/h5z_ebcc.c``; SURVEY §2.6), so plain
``h5py``/netCDF tooling reads filtered datasets transparently.  This package
offers two routes:

1. :func:`save_dataset` / :func:`load_dataset` — self-contained: the ETPK
   container is stored as an opaque byte dataset with shape/codec metadata
   in attributes.  Works with stock h5py, compresses through the batched
   device codec, and round-trips without any plugin.
2. The native filter plugin (``ebcc_tpu/native``; filter id 33030, built by
   the CMake project there) — registered through ``HDF5_PLUGIN_PATH`` just
   like the reference, decoding ETPU/ETPK payloads inside the HDF5 pipeline
   for h5py/netCDF/CDO consumers without JAX.

``EBCC_Filter`` (api.filter_wrapper) produces ``create_dataset`` kwargs for
route 2, parity with the reference wrapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec

_ATTR_PREFIX = "ebcc_tpu"


def save_dataset(group, name: str, data: np.ndarray, config: CodecConfig,
                 opts: Optional[EncodeOptions] = None):
    """Compress ``data`` and store it as an opaque dataset under ``group``.

    Attributes record dims and the codec id so :func:`load_dataset` (or any
    reader of the self-describing ETPK container) can reconstruct.
    """
    data = np.asarray(data, dtype=np.float32)
    blob = _codec.encode_chunked(data.reshape(config.dims), config, opts)
    dset = group.create_dataset(
        name, data=np.frombuffer(blob, dtype=np.uint8))
    dset.attrs[f"{_ATTR_PREFIX}:format"] = "ETPK"
    dset.attrs[f"{_ATTR_PREFIX}:shape"] = data.shape
    dset.attrs[f"{_ATTR_PREFIX}:dims"] = config.dims
    return dset


def load_dataset(group, name: str) -> np.ndarray:
    """Decompress a dataset written by :func:`save_dataset`."""
    dset = group[name]
    fmt = dset.attrs.get(f"{_ATTR_PREFIX}:format")
    if fmt not in ("ETPK", b"ETPK"):
        raise ValueError(f"dataset {name!r} is not an ebcc_tpu payload")
    blob = bytes(np.asarray(dset[...], dtype=np.uint8))
    out = _codec.decode_chunked(blob)
    shape = tuple(dset.attrs[f"{_ATTR_PREFIX}:shape"])
    return out.reshape(shape)
