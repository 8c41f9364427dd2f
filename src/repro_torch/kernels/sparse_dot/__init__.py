from repro_torch.kernels.sparse_dot.ops import fused_retrieve_sparse_q
from repro_torch.kernels.sparse_dot.ref import retrieve_ref, retrieve_sparse_q_ref

__all__ = ["fused_retrieve_sparse_q", "retrieve_ref", "retrieve_sparse_q_ref"]
