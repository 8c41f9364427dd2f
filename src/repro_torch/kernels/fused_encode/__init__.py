from repro_torch.kernels.fused_encode.ops import fused_encode, fused_encode_chunked
from repro_torch.kernels.fused_encode.ref import fused_encode_ref

__all__ = ["fused_encode", "fused_encode_chunked", "fused_encode_ref"]
