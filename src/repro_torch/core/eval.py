"""Retrieval-quality metrics (twin of ``recall_at_n`` in ``repro.core.eval``).

Plain numpy on the host: offline metrics, never part of a serving
computation.  Accepts tensors on any device, numpy arrays or lists.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _as_2d(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.ndim == 1:
        a = a[None]
    if a.ndim != 2:
        raise ValueError(f"expected (n,) or (Q, n) array, got shape {a.shape}")
    return a


def recall_at_n(ids, ref_ids, n: Optional[int] = None) -> float:
    """Mean fraction of the reference top-n ids present in ``ids``.

    Both are truncated to their first ``n`` entries (default: the
    reference row length); the denominator is the number of distinct
    reference ids per row.
    """
    got = _as_2d(ids)
    ref = _as_2d(ref_ids)
    if got.shape[0] != ref.shape[0]:
        raise ValueError(f"query-count mismatch: {got.shape[0]} vs {ref.shape[0]}")
    if n is None:
        n = ref.shape[1]
    got = got[:, : min(n, got.shape[1])]
    ref = ref[:, : min(n, ref.shape[1])]
    recs = []
    for g, r in zip(got, ref):
        want = set(r.tolist())
        recs.append(len(want & set(g.tolist())) / max(len(want), 1))
    return float(np.mean(recs)) if recs else 0.0
