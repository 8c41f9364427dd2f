"""Quantized sparse codes and content checksums (twin of
``repro.core.quantized_codes``).

The compound-compressed format: per-row symmetric int8 values, int16
indices while h < 65536 (int32 above), and one f32 scale a row, so a row
of k codes takes k·(1 + 2) + 4 bytes against the fp32 codes' 8k.  Indices
in [32768, 65536) wrap to negative int16 on the way in and are recovered
by ``widen_indices`` (widen, then keep the low 16 bits).

The CRC32 runs over the same bytes as the JAX package's: each array's
field name, numpy dtype, shape and raw little-endian bytes.  An index
built by either package therefore carries the same checksum for the same
arrays.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import SparseCodes

SCALE_FLOOR = 1e-12   # smallest per-row scale: an all-zero row quantizes to zeros


class QuantizedCodes(NamedTuple):
    """q_values (N, k) int8, indices (N, k) int16 bit patterns (h < 65536)
    or int32, scales (N,) f32 per-row symmetric scales, dim = h."""

    q_values: torch.Tensor
    indices: torch.Tensor
    scales: torch.Tensor
    dim: int

    @property
    def n(self) -> int:
        return self.q_values.shape[0]

    @property
    def k(self) -> int:
        return self.q_values.shape[1]

    @property
    def nbytes_logical(self) -> int:
        """Storage bytes of the format: k·(1 + index bytes) + 4 a row."""
        return (self.q_values.numel()
                + self.indices.numel() * self.indices.element_size()
                + self.scales.numel() * 4)


def widen_indices(indices: torch.Tensor) -> torch.Tensor:
    """int16-stored (possibly wrapped) indices -> exact int32; int32
    passes through."""
    if indices.dtype == torch.int32:
        return indices
    return indices.to(torch.int32) & 0xFFFF


def quantize_rows(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of (N, w) f32 values:
    scale = max(amax / 127, 1e-12), q = clip(round(v / scale), ±127),
    rounding half to even.  Returns ((N, w) int8, (N,) f32 scales).  The
    arithmetic of ``quantize_codes`` and of the int8-scoring query panel."""
    amax = values.abs().amax(dim=-1)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not always amax / 127.
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=SCALE_FLOOR)
    q = torch.clamp(torch.round(values / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def quantize_codes(codes: SparseCodes) -> QuantizedCodes:
    """Per-row symmetric int8 quantization of the k values; int16 indices
    for h < 65536, else int32."""
    q, scale = quantize_rows(codes.values)
    idx_dtype = torch.int16 if codes.dim < 65536 else torch.int32
    return QuantizedCodes(q_values=q, indices=codes.indices.to(idx_dtype),
                          scales=scale, dim=codes.dim)


def dequantize_codes(q: QuantizedCodes) -> SparseCodes:
    """int8 -> f32 (exact), one f32 multiply by the row's scale."""
    vals = q.q_values.to(torch.float32) * q.scales[:, None]
    return SparseCodes(values=vals, indices=widen_indices(q.indices), dim=q.dim)


def compression_ratio(d: int, k: int, h: int) -> float:
    """Dense fp32 bytes / compound-quantized bytes."""
    idx_b = 2 if h < 65536 else 4
    return d * 4 / (k * (1 + idx_b) + 4)


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
    """Content checksum of ``SparseCodes`` or ``QuantizedCodes``."""
    if isinstance(codes, QuantizedCodes):
        fields = [("q_values", codes.q_values), ("indices", codes.indices),
                  ("scales", codes.scales)]
    else:
        fields = [("values", codes.values), ("indices", codes.indices)]
    return zlib.crc32(f"dim:{codes.dim}".encode(), content_checksum(fields))
