"""Shared helpers of the ``test_torch_*`` parity tests: inputs made with
numpy and handed to both packages, and the float64 gap rules that choose
inputs on which two correct f32 implementations must agree exactly.

Two f32 computations that sum in different orders may order two values
that are within rounding of each other differently.  So an exact
comparison of indices or ids is made only on inputs whose float64
values keep every compared neighbour pair apart by more than ``GAP``
(relative).  Inputs are drawn in bulk and kept by that rule, whatever
the seed; exact ties (equal in float64) are kept on purpose, since every
implementation breaks them by the lowest index.
"""
from __future__ import annotations

import numpy as np

GAP = 1e-5


def rel_gaps(sorted_desc: np.ndarray) -> np.ndarray:
    """Relative gaps between neighbours of rows sorted descending."""
    a = sorted_desc
    return (a[:, :-1] - a[:, 1:]) / np.maximum(np.abs(a[:, :-1]), 1e-300)


def encode_clear(x: np.ndarray, w_enc: np.ndarray, b_enc: np.ndarray, k: int) -> np.ndarray:
    """Rows of x whose top-(k+1) |pre-activations| (float64) are pairwise
    more than GAP apart: both packages must pick and order the same k."""
    x64 = x.astype(np.float64)
    xn = x64 / np.maximum(np.linalg.norm(x64, axis=-1, keepdims=True), 1e-8)
    pre = np.abs(xn @ w_enc.astype(np.float64) + b_enc.astype(np.float64))
    top = -np.sort(-pre, axis=-1)[:, : k + 1]
    return rel_gaps(top).min(axis=1) > GAP


def sparse_scores64(cand_v, cand_i, q_v, q_i, h: int) -> np.ndarray:
    """(Q, N) float64 sparse cosine numerators times 1/‖c‖ (duplicate
    indices sum, as densify does)."""
    qd = np.zeros((q_v.shape[0], h))
    for row in range(q_v.shape[0]):
        np.add.at(qd[row], q_i[row], q_v[row].astype(np.float64))
    cd = np.zeros((cand_v.shape[0], h))
    for row in range(cand_v.shape[0]):
        np.add.at(cd[row], cand_i[row], cand_v[row].astype(np.float64))
    norms = np.linalg.norm(cand_v.astype(np.float64), axis=-1)
    return (qd @ cd.T) / np.maximum(norms, 1e-8)


def retrieve_clear(scores64: np.ndarray, n: int) -> np.ndarray:
    """Queries whose top-(n+1) float64 scores are, pairwise, exactly tied
    or more than GAP apart: every f32 implementation returns the same
    ids in the same order."""
    top = -np.sort(-scores64, axis=-1)[:, : n + 1]
    g = rel_gaps(top)
    return ((g == 0) | (g > GAP)).all(axis=1)


def sae_params(d: int, h: int, seed: int, bias: float = 0.0) -> dict:
    """Tied SAE params as numpy: unit-norm decoder rows, w_enc = w_dec.T."""
    rng = np.random.default_rng(seed)
    w_dec = rng.standard_normal((h, d))
    w_dec /= np.linalg.norm(w_dec, axis=-1, keepdims=True)
    return {"w_enc": np.ascontiguousarray(w_dec.T, dtype=np.float32),
            "b_enc": (bias * rng.standard_normal(h)).astype(np.float32),
            "w_dec": w_dec.astype(np.float32)}


def tie_inputs(rng, rows: int, d: int, h: int):
    """Encoder inputs whose pre-activations are exact in f32 whatever the
    summation order, with many exact ties: rows of four ±1 entries
    (x̄ = ±0.5 exactly), integer weights and bias."""
    x = np.zeros((rows, d), np.float32)
    for row in x:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    w = rng.integers(-2, 3, (d, h)).astype(np.float32)
    b = rng.integers(-1, 2, h).astype(np.float32)
    return x, w, b
