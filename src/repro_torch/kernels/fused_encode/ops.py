"""Public wrapper of the fused encoder: normalise, check, dispatch by device."""
from __future__ import annotations

import torch

from repro_torch.core.retrieval import kernel_path
from repro_torch.core.sae import normalize_input
from repro_torch.core.types import SparseCodes
from repro_torch.kernels.fused_encode.kernel import fused_encode_cuda
from repro_torch.kernels.fused_encode.ref import fused_encode_ref


def fused_encode(
    x: torch.Tensor,
    w_enc: torch.Tensor,
    b_enc: torch.Tensor,
    k: int,
    *,
    use_kernel="auto",
) -> SparseCodes:
    """Dense (B, d) -> fixed-k SparseCodes, equal to ``sae.encode`` (same
    selection, ties to the lowest index).  ``use_kernel``: "auto" runs the
    CUDA kernel for a CUDA tensor and the plain version for a CPU tensor;
    True demands the kernel (and raises on the CPU); False runs the plain
    version on any device."""
    if x.ndim != 2:
        raise ValueError(f"x: expected (B, d), got shape {tuple(x.shape)}")
    fn = fused_encode_cuda if kernel_path(use_kernel, x.device) else fused_encode_ref
    vals, idx = fn(normalize_input(x), w_enc, b_enc, k)
    return SparseCodes(values=vals, indices=idx, dim=w_enc.shape[1])


def fused_encode_chunked(
    x: torch.Tensor,
    w_enc: torch.Tensor,
    b_enc: torch.Tensor,
    k: int,
    *,
    chunk: int = 65536,
    use_kernel="auto",
) -> SparseCodes:
    """``fused_encode`` over ``chunk`` rows at a time, for catalog-sized
    batches: the kernel's per-tile lists (about h/256·min(k, 256)·8 bytes
    a row) and the plain version's (chunk, h) pre-activations stay
    bounded."""
    parts = [fused_encode(x[i:i + chunk], w_enc, b_enc, k, use_kernel=use_kernel)
             for i in range(0, x.shape[0], chunk)]
    return SparseCodes(values=torch.cat([p.values for p in parts]),
                       indices=torch.cat([p.indices for p in parts]),
                       dim=w_enc.shape[1])
