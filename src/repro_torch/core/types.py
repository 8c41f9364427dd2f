"""Shared core types for CompresSAE (twin of ``repro.core.types``).

The encoder's sparse code is fixed-k: every row has exactly ``k`` nonzero
entries, stored as ``values[N, k]`` + ``indices[N, k]`` (an ELL layout,
byte-identical to CSR with a uniform row length).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class SparseCodes(NamedTuple):
    """Fixed-k sparse embedding batch.

    values:  (N, k) float32 nonzero values.
    indices: (N, k) int32 column index in [0, h) of each value; duplicate
             indices in a row are tolerated by every consumer (they sum).
    dim:     h, the latent dimensionality.
    """

    values: torch.Tensor
    indices: torch.Tensor
    dim: int

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def k(self) -> int:
        return self.values.shape[1]

    @property
    def nbytes_logical(self) -> int:
        """Storage bytes of the compressed representation (paper §3.2)."""
        return self.values.numel() * 4 + self.indices.numel() * 4


@dataclasses.dataclass(frozen=True)
class SAEConfig:
    """CompresSAE hyperparameters (paper §3); defaults are the paper's."""

    d: int = 768          # dense input dimensionality
    h: int = 4096         # sparse latent dimensionality (h >> d)
    k: int = 32           # nonzeros kept by the abs-top-k activation
    aux_k_mult: int = 4   # auxiliary reconstruction uses k * aux_k_mult
    aux_weight: float = 1.0
    dtype: torch.dtype = torch.float32
    topk_groups: int = 0  # >0: exact two-stage grouped top-k

    def __post_init__(self):
        if self.k <= 0 or self.h < self.d or self.k > self.h:
            raise ValueError(f"invalid SAEConfig: d={self.d} h={self.h} k={self.k}")
        if self.k * self.aux_k_mult > self.h:
            raise ValueError("aux_k_mult * k must not exceed h")

    @property
    def aux_k(self) -> int:
        return self.k * self.aux_k_mult

    @property
    def compression_ratio(self) -> float:
        """Dense fp32 bytes / sparse bytes (values+indices), paper's 12x."""
        return (self.d * 4) / (2 * self.k * 4)
