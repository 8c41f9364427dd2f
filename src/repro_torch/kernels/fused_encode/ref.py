"""Plain PyTorch version of the fused encoder: matmul + bias + abs-top-k."""
from __future__ import annotations

import torch

from repro_torch.core.topk import abs_topk_sparse


def fused_encode_ref(
    x_norm: torch.Tensor, w_enc: torch.Tensor, b_enc: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x_norm (B, d) already L2-normalised, w_enc (d, h), b_enc (h,) ->
    (values (B, k) f32, indices (B, k) i32) of φ(x̄·W + b, k)."""
    return abs_topk_sparse(x_norm @ w_enc + b_enc, k)
