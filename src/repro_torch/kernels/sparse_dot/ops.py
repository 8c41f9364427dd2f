"""Public wrapper of the sparse-query fused retrieve: check, dispatch by device."""
from __future__ import annotations

import torch

from repro_torch.core.retrieval import kernel_path
from repro_torch.kernels.sparse_dot.kernel import fused_retrieve_sparse_q_cuda
from repro_torch.kernels.sparse_dot.ref import retrieve_sparse_q_ref


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
    not exceed N.  ``use_kernel`` as in ``fused_encode``: "auto" is the
    CUDA kernel for CUDA tensors and the plain version for CPU tensors.
    The kernel masks the ragged ends of Q and N itself; nothing is padded.
    """
    squeeze = q_values.ndim == 1
    if squeeze:
        q_values, q_indices = q_values[None], q_indices[None]
    if n > values.shape[0]:
        raise ValueError(f"top-n {n} exceeds candidate count {values.shape[0]}")
    if kernel_path(use_kernel, q_values.device):
        out_v, out_i = fused_retrieve_sparse_q_cuda(
            values, indices, inv_norms, q_values, q_indices, h, n)
    else:
        out_v, out_i = retrieve_sparse_q_ref(
            values, indices, inv_norms, q_values, q_indices, h, n=n)
    return (out_v[0], out_i[0]) if squeeze else (out_v, out_i)
