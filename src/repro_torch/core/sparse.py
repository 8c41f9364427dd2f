"""Fixed-k sparse layout utilities (twin of ``repro.core.sparse``)."""
from __future__ import annotations

import torch

from repro_torch.core.types import SparseCodes


def densify_rows(values: torch.Tensor, indices: torch.Tensor, h: int) -> torch.Tensor:
    """(Q, k) codes -> (Q, h) dense.  Duplicate indices in a row sum in
    slot order: each slot is added in its own pass, one entry per row, so
    the accumulation order is fixed on every device (a one-shot
    ``scatter_add_`` on CUDA adds duplicates in atomic order)."""
    dense = torch.zeros(values.shape[0], h, dtype=values.dtype,
                        device=values.device)
    rows = torch.arange(values.shape[0], device=values.device)
    idx = indices.long()
    for slot in range(values.shape[1]):
        dense[rows, idx[:, slot]] += values[:, slot]
    return dense


def densify(codes: SparseCodes) -> torch.Tensor:
    """(..., k) sparse -> (..., h) dense.  Duplicate indices sum."""
    lead = codes.values.shape[:-1]
    k = codes.values.shape[-1]
    flat = densify_rows(codes.values.reshape(-1, k),
                        codes.indices.reshape(-1, k), codes.dim)
    return flat.reshape(*lead, codes.dim)
