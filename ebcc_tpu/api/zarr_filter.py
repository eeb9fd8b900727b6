"""numcodecs Codec for Zarr integration.

API parity: reference ``ebcc/zarr_filter.py`` — ``EBCCZarrFilter(Codec)``
with codec_id "ebcc_filter", constructed from the same uint32 ``arglist``
(cd_values) vocabulary, encode/decode of raveled float32 buffers, and
numcodecs registration (zf.py:19-88).  The reference reaches the C codec via
ctypes; here encode/decode run through the batched device codec.

Gated: ``numcodecs`` is optional.  When absent, a minimal stand-in base class
keeps the codec usable directly (``encode``/``decode``/``get_config``) —
only automatic Zarr integration needs the real package.
"""

from __future__ import annotations

import numpy as np

try:
    import numcodecs
    from numcodecs.abc import Codec as _Codec
    _HAVE_NUMCODECS = True
except ImportError:  # pragma: no cover - numcodecs optional
    _HAVE_NUMCODECS = False

    class _Codec:  # minimal protocol stand-in
        codec_id: str = ""

        def get_config(self):
            raise NotImplementedError

        @classmethod
        def from_config(cls, config):
            return cls(**{k: v for k, v in config.items() if k != "id"})


from ..core import codec as _codec
from .filter_wrapper import populate_config


class EBCCZarrFilter(_Codec):
    """Parity: EBCCZarrFilter (zarr_filter.py:19-88)."""

    codec_id = "ebcc_tpu_filter"

    def __init__(self, arglist):
        self.arglist = np.array(arglist, dtype=np.uint32)

    def encode(self, buf):
        assert isinstance(buf, np.ndarray), "Input buffer must be a numpy array"
        assert buf.dtype == np.float32, "Input buffer must be of dtype float32"
        buf = np.ascontiguousarray(buf, dtype=np.float32).ravel()
        config = populate_config(self.arglist, buf.nbytes)
        return _codec.encode(buf.reshape(config.dims), config)

    def decode(self, buf, out=None):
        decoded = _codec.decode(bytes(buf)).ravel()
        if out is not None:
            out_view = out.view(np.float32).ravel()
            out_view[:] = decoded
            return out
        return decoded

    def get_config(self):
        return {"id": self.codec_id,
                "arglist": self.arglist.astype(int).tolist()}

    @classmethod
    def from_config(cls, config):
        return cls(config["arglist"])


if _HAVE_NUMCODECS:  # registration parity (zarr_filter.py:88)
    numcodecs.register_codec(EBCCZarrFilter)
