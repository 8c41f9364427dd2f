"""Public wrappers of the sparse-query fused retrieves: check, dispatch by device.

``use_kernel`` as in ``fused_encode``: "auto" is the CUDA kernel for CUDA
tensors and the plain version for CPU tensors; True demands the kernel
(and raises on the CPU); False runs the plain version on any device.
The kernels mask the ragged ends of Q and N themselves; nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.core.retrieval import kernel_path
from repro_torch.kernels.sparse_dot.kernel import (
    fused_retrieve_quantized_mxu_sparse_q_cuda, fused_retrieve_quantized_sparse_q_cuda,
    fused_retrieve_sparse_q_cuda,
)
from repro_torch.kernels.sparse_dot.ref import (
    retrieve_quantized_mxu_sparse_q_ref, retrieve_quantized_sparse_q_ref,
    retrieve_sparse_q_ref,
)


def _dispatch(kernel, plain, cand, q_values, q_indices, h, n, use_kernel):
    squeeze = q_values.ndim == 1
    if squeeze:
        q_values, q_indices = q_values[None], q_indices[None]
    if n > cand[0].shape[0]:
        raise ValueError(f"top-n {n} exceeds candidate count {cand[0].shape[0]}")
    if kernel_path(use_kernel, q_values.device):
        out_v, out_i = kernel(*cand, q_values, q_indices, h, n)
    else:
        out_v, out_i = plain(*cand, q_values, q_indices, h, n=n)
    return (out_v[0], out_i[0]) if squeeze else (out_v, out_i)


def fused_retrieve_sparse_q(
    values: torch.Tensor,
    indices: torch.Tensor,
    inv_norms: torch.Tensor,
    q_values: torch.Tensor,
    q_indices: torch.Tensor,
    h: int,
    *,
    n: int,
    use_kernel="auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse-query fused score+select -> ((Q, n) scores, (Q, n) ids).

    values (N, k) f32, indices (N, k) i32, inv_norms (N,) f32, q_values
    (Q, kq) or (kq,) f32 + matching q_indices i32 over [0, h).  n must
    not exceed N."""
    return _dispatch(fused_retrieve_sparse_q_cuda, retrieve_sparse_q_ref,
                     (values, indices, inv_norms), q_values, q_indices, h, n, use_kernel)


def fused_retrieve_quantized_sparse_q(
    q_values: torch.Tensor,
    indices: torch.Tensor,
    scales: torch.Tensor,
    inv_norms: torch.Tensor,
    query_values: torch.Tensor,
    query_indices: torch.Tensor,
    h: int,
    *,
    n: int,
    use_kernel="auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized candidates (q_values (N, k) int8, indices (N, k)
    int16/int32, scales (N,) f32) × sparse query codes, exact: equal to
    ``fused_retrieve_sparse_q`` over the dequantized arrays."""
    return _dispatch(fused_retrieve_quantized_sparse_q_cuda, retrieve_quantized_sparse_q_ref,
                     (q_values, indices, scales, inv_norms), query_values, query_indices,
                     h, n, use_kernel)


def fused_retrieve_quantized_mxu_sparse_q(
    q_values: torch.Tensor,
    indices: torch.Tensor,
    scales: torch.Tensor,
    inv_norms: torch.Tensor,
    query_values: torch.Tensor,
    query_indices: torch.Tensor,
    h: int,
    *,
    n: int,
    use_kernel="auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 scoring of sparse query codes against quantized candidates
    (approximate against the exact path; kernel and plain version agree
    bit for bit)."""
    return _dispatch(fused_retrieve_quantized_mxu_sparse_q_cuda,
                     retrieve_quantized_mxu_sparse_q_ref,
                     (q_values, indices, scales, inv_norms), query_values, query_indices,
                     h, n, use_kernel)
