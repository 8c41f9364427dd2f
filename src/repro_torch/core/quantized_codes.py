"""Content checksums of sparse codes (twin of the checksum helpers of
``repro.core.quantized_codes``).

The CRC32 runs over the same bytes as the JAX package's: each array's
field name, numpy dtype, shape and raw little-endian bytes.  An index
built by either package therefore carries the same checksum for the same
arrays.  The quantized code format itself is not ported yet.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch


def _host_array(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def content_checksum(named_arrays) -> int:
    """CRC32 over ``(name, array)`` pairs: name, dtype, shape and bytes.
    ``None`` arrays (optional index fields) are skipped."""
    crc = 0
    for name, arr in named_arrays:
        if arr is None:
            continue
        a = _host_array(arr)
        crc = zlib.crc32(f"{name}:{a.dtype}:{a.shape}:".encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def codes_checksum(codes) -> int:
    """Content checksum of fp32 ``SparseCodes``."""
    crc = content_checksum([("values", codes.values),
                            ("indices", codes.indices)])
    return zlib.crc32(f"dim:{codes.dim}".encode(), crc)
