"""Legacy EBCC v1 format interop.

The reference codec (reference src/ebcc_codec.c) persists a JPEG2000 base
layer plus a zstd-compressed SPIHT residual inside "EBCC" frame streams and
"EBCK" chunking containers.  This package reads and writes that format so
users migrating from the reference can decode their existing archives with
this framework (and produce archives the reference plugin can read), using:

- the system OpenJPEG (via Pillow) for the J2K base layer — the same
  library family the reference links, so base-layer bytes are genuinely
  interoperable;
- the native SPIHT mirror (native/spiht_coder.cc) for the residual layer.

This is an interop/validation surface, not the device hot path; the ETPU
format (core/stream.py, docs/FORMAT.md) remains the native format.
"""

from .legacy import (LegacyFormatError, decode, decode_container,
                     decode_frame, encode_chunked, encode_chunked_compat,
                     encode_frame, is_legacy)

__all__ = [
    "LegacyFormatError",
    "decode",
    "decode_container",
    "decode_frame",
    "encode_chunked",
    "encode_chunked_compat",
    "encode_frame",
    "is_legacy",
]
