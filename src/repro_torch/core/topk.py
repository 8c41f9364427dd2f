"""φ(·, k): the abs-top-k activation (paper eq. 1), twin of ``repro.core.topk``.

Keeps the k entries of largest |value| per row.  Ties go to the lowest
index, as ``lax.top_k`` breaks them: the selection is a STABLE descending
sort of |x|, never ``torch.topk``, whose tie order is unspecified.
"""
from __future__ import annotations

import torch


def _stable_top(key: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest ``key`` entries per row, descending,
    equal keys in ascending position order."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]


def abs_topk_sparse(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values (..., k), indices (..., k) int32) of the k largest-|x| entries."""
    idx = _stable_top(x.abs(), k)
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def abs_topk(x: torch.Tensor, k: int, groups: int = 0) -> torch.Tensor:
    """Dense φ(x, k): zero all but the k largest-|value| entries per row."""
    if groups:
        vals, idx = abs_topk_sparse_grouped(x, k, groups)
    else:
        vals, idx = abs_topk_sparse(x, k)
    return torch.zeros_like(x).scatter(-1, idx.long(), vals)


def abs_topk_sparse_grouped(
    x: torch.Tensor, k: int, groups: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage EXACT abs-top-k: per-group top-k, then a re-selection over
    the groups·k candidates.  Equal to ``abs_topk_sparse``, because the
    global top-k set is a subset of the union of the per-group sets, and
    each group's list is ordered (|v| desc, index asc).  The fused-encode
    CUDA kernel runs this algorithm with one group per h-tile."""
    *lead, h = x.shape
    if h % groups or groups * k > h:
        raise ValueError(f"grouped top-k needs groups | h and groups*k <= h: "
                         f"h={h} groups={groups} k={k}")
    xg = x.reshape(*lead, groups, h // groups)
    li = _stable_top(xg.abs(), k)                              # (..., G, k)
    vals_g = torch.gather(xg, -1, li)
    offs = (torch.arange(groups, device=x.device) * (h // groups))[:, None]
    cand_v = vals_g.reshape(*lead, groups * k)
    cand_i = (li + offs).reshape(*lead, groups * k)
    sel = _stable_top(cand_v.abs(), k)
    return (torch.gather(cand_v, -1, sel),
            torch.gather(cand_i, -1, sel).to(torch.int32))
