"""CompresSAE model (paper §3), twin of ``repro.core.sae``.

    s  = φ(W_enc · x̄ + b_enc, k)          x̄ = x / ‖x‖₂        (eq. 1)
    x̂  = W_dec · s                         W_dec row-normalized  (eq. 2)

Parameters are a plain dict of tensors with the JAX package's keys and
layouts, so arrays cross between the two packages unchanged:

    params = {"w_enc": (d, h), "b_enc": (h,), "w_dec": (h, d)}
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.topk import abs_topk_sparse, abs_topk_sparse_grouped
from repro_torch.core.types import SAEConfig, SparseCodes
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]
PARAM_KEYS = ("w_enc", "b_enc", "w_dec")


def init_params(cfg: SAEConfig, generator: torch.Generator) -> Params:
    """Tied init on ``generator``'s device: W_dec rows unit-norm random,
    W_enc = W_dec.T, b_enc = 0.  Same distribution as the JAX
    ``init_params``; the numbers differ (another RNG)."""
    dev = generator.device
    w_dec = torch.randn(cfg.h, cfg.d, generator=generator, device=dev,
                        dtype=cfg.dtype)
    w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=-1, keepdim=True)
    return {
        "w_enc": w_dec.T.contiguous(),                          # (d, h)
        "b_enc": torch.zeros(cfg.h, dtype=cfg.dtype, device=dev),
        "w_dec": w_dec.contiguous(),                            # (h, d)
    }


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> Params:
    """A params dict of numpy arrays (e.g. JAX ``init_params`` passed
    through ``np.asarray``) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    missing = [key for key in PARAM_KEYS if key not in arrays]
    if missing:
        raise KeyError(f"params missing {missing}")
    return {key: torch.tensor(np.asarray(arrays[key]), dtype=torch.float32,
                              device=dev).contiguous()
            for key in PARAM_KEYS}


def params_to_numpy(params: Params) -> dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``."""
    return {key: params[key].detach().cpu().numpy() for key in PARAM_KEYS}


def normalize_input(x: torch.Tensor) -> torch.Tensor:
    """x̄ = x / max(‖x‖₂, 1e-8)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-8)


def preactivations(params: Params, x: torch.Tensor) -> torch.Tensor:
    """W_enc x̄ + b_enc, shape (..., h)."""
    return normalize_input(x) @ params["w_enc"] + params["b_enc"]


def encode(params: Params, x: torch.Tensor, k: int, groups: int = 0) -> SparseCodes:
    """f_enc: dense (..., d) -> fixed-k SparseCodes (plain PyTorch)."""
    pre = preactivations(params, x)
    if groups:
        vals, idx = abs_topk_sparse_grouped(pre, k, groups)
    else:
        vals, idx = abs_topk_sparse(pre, k)
    return SparseCodes(values=vals, indices=idx, dim=pre.shape[-1])


def encode_chunked(params: Params, x: torch.Tensor, k: int,
                   chunk: int = 8192, groups: int = 0) -> SparseCodes:
    """Bulk encode in row chunks, so the (chunk, h) pre-activations are
    the largest transient."""
    parts = [encode(params, x[i:i + chunk], k, groups)
             for i in range(0, x.shape[0], chunk)]
    return SparseCodes(values=torch.cat([p.values for p in parts]),
                       indices=torch.cat([p.indices for p in parts]),
                       dim=params["w_enc"].shape[1])


def decode(params: Params, codes: SparseCodes) -> torch.Tensor:
    """f_dec: x̂ = Σ_j vals_j · W_dec[idx_j], a k-row gather of W_dec."""
    atoms = params["w_dec"][codes.indices.long()]             # (..., k, d)
    return torch.einsum("...k,...kd->...d", codes.values, atoms)
