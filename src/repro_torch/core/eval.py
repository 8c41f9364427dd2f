"""Retrieval-quality metrics (twin of ``repro.core.eval``).

The int8-scoring path is approximate against the exact one, so it is
held to measured quality, not to equality:

``recall_at_n``        — fraction of the reference top-n ids recovered.
``score_mae``          — positional mean |difference| of the two
                         rank-sorted top-n score curves.
``rank_displacement``  — mean |rank - reference rank|; ids missing from
                         the reference row cost the list width.
``retrieval_quality``  — the bundle over two ``(scores, ids)`` pairs.

Plain numpy on the host: offline metrics, never part of a serving
computation.  Accepts tensors on any device, numpy arrays or lists.
Edge rules as in the JAX package: n beyond a row's length clamps to what
is there; duplicate reference ids count once (first rank wins); exact
score ties cost nothing in ``score_mae`` and their true positional
distance in ``rank_displacement``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _as_2d(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x, dtype=dtype)
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


def score_mae(scores, ref_scores, n: Optional[int] = None) -> float:
    """Positional MAE between two rank-sorted top-n score curves: both
    sorted descending per row, cut to the shorter row (or ``n``)."""
    s = _as_2d(scores, np.float64)
    r = _as_2d(ref_scores, np.float64)
    if s.shape[0] != r.shape[0]:
        raise ValueError(f"query-count mismatch: {s.shape[0]} vs {r.shape[0]}")
    width = min(s.shape[1], r.shape[1])
    if n is not None:
        width = min(width, n)
    s = -np.sort(-s, axis=1)[:, :width]
    r = -np.sort(-r, axis=1)[:, :width]
    return float(np.mean(np.abs(s - r))) if width else 0.0


def rank_displacement(ids, ref_ids, n: Optional[int] = None) -> float:
    """Mean |rank − reference rank| over the (cut-to-n) list; an id the
    reference row lacks costs the list width.  0.0 is the same ranking."""
    got = _as_2d(ids)
    ref = _as_2d(ref_ids)
    if got.shape[0] != ref.shape[0]:
        raise ValueError(f"query-count mismatch: {got.shape[0]} vs {ref.shape[0]}")
    if n is None:
        n = min(got.shape[1], ref.shape[1])
    got = got[:, : min(n, got.shape[1])]
    ref = ref[:, : min(n, ref.shape[1])]
    width = got.shape[1]
    if width == 0:
        return 0.0
    disps = []
    for g, r in zip(got, ref):
        pos: dict = {}
        for j, rid in enumerate(r.tolist()):
            pos.setdefault(rid, j)
        disps.extend(abs(i - pos[gid]) if gid in pos else width
                     for i, gid in enumerate(g.tolist()))
    return float(np.mean(disps))


def retrieval_quality(approx, exact, n: Optional[int] = None) -> dict:
    """Compare two ``(scores, ids)`` outputs (pairs or
    ``RetrievalResponse``s, (n,) or (Q, n)): ``{"n", "recall",
    "score_mae", "rank_displacement"}`` with ``n`` the clamped width."""
    a_scores, a_ids = approx[0], approx[1]
    e_scores, e_ids = exact[0], exact[1]
    width = min(_as_2d(a_ids).shape[1], _as_2d(e_ids).shape[1])
    if n is not None:
        width = min(width, n)
    return {
        "n": int(width),
        "recall": recall_at_n(a_ids, e_ids, n=width),
        "score_mae": score_mae(a_scores, e_scores, n=width),
        "rank_displacement": rank_displacement(a_ids, e_ids, n=width),
    }
