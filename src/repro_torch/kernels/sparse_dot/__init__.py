from repro_torch.kernels.sparse_dot.ops import (
    fused_retrieve_quantized_mxu_sparse_q, fused_retrieve_quantized_sparse_q,
    fused_retrieve_sparse_q,
)
from repro_torch.kernels.sparse_dot.ref import (
    retrieve_quantized_mxu_sparse_q_ref, retrieve_quantized_sparse_q_ref, retrieve_ref,
    retrieve_sparse_q_ref,
)

__all__ = ["fused_retrieve_quantized_mxu_sparse_q", "fused_retrieve_quantized_sparse_q",
           "fused_retrieve_sparse_q", "retrieve_quantized_mxu_sparse_q_ref",
           "retrieve_quantized_sparse_q_ref", "retrieve_ref", "retrieve_sparse_q_ref"]
