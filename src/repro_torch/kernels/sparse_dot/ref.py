"""Plain PyTorch versions of the sparse-query fused retrieve.

``retrieve_ref``          — chunked streaming score+select of dense (Q, h)
                            queries against fixed-k candidates.  It scans
                            (block_n, k) candidate blocks and carries a
                            per-query running top-n, merging each block
                            with one stable sort over n + block_n entries:
                            the running list precedes the block, so equal
                            scores go to the lowest candidate id.
``retrieve_sparse_q_ref`` — the same over (Q, kq) query codes, densified
                            one ≤q_chunk slab at a time (duplicate indices
                            sum in slot order, as ``densify`` does).

Transients stay bounded: a (q_chunk, h) dense slab and (q_chunk, block_n)
scores, never (Q, N).  A candidate's score sums its k products in slot
order, product by product, as the TPU kernel's ``_score_tile`` does, and
the CUDA kernel is held to that bit for bit.  (The JAX package's
``retrieve_ref`` sums with ``jnp.sum``, whose order XLA picks, so it
agrees with this file to f32 rounding.)
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import densify_rows as _densify_rows


def retrieve_ref(
    values: torch.Tensor,
    indices: torch.Tensor,
    inv_norms: torch.Tensor,
    q: torch.Tensor,
    *,
    n: int,
    block_n: int = 8192,
    q_chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """((Q, n) norm-folded scores, (Q, n) int32 ids) of dense queries
    q (Q, h) against values (N, k) f32, indices (N, k) i32 with reciprocal
    candidate norms inv_norms (N,).  The 1/‖q‖ factor is the caller's."""
    nq = q.shape[0]
    if nq > q_chunk:
        parts = [retrieve_ref(values, indices, inv_norms, q[i:i + q_chunk],
                              n=n, block_n=block_n, q_chunk=q_chunk)
                 for i in range(0, nq, q_chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    N, k = values.shape
    dev = values.device
    best_v = torch.full((nq, n), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((nq, n), dtype=torch.int32, device=dev)
    for s in range(0, N, block_n):
        bv = values[s:s + block_n]
        bi = indices[s:s + block_n].long()
        acc = torch.zeros(nq, bv.shape[0], dtype=torch.float32, device=dev)
        for j in range(k):
            acc = acc + q[:, bi[:, j]] * bv[:, j]
        acc = acc * inv_norms[s:s + block_n]
        ids = torch.arange(s, s + bv.shape[0], dtype=torch.int32, device=dev)
        cand_v = torch.cat([best_v, acc], dim=1)
        cand_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
        order = torch.sort(cand_v, dim=1, descending=True, stable=True).indices[:, :n]
        best_v = torch.gather(cand_v, 1, order)
        best_i = torch.gather(cand_i, 1, order)
    return best_v, best_i


def retrieve_sparse_q_ref(
    values: torch.Tensor,
    indices: torch.Tensor,
    inv_norms: torch.Tensor,
    q_values: torch.Tensor,
    q_indices: torch.Tensor,
    h: int,
    *,
    n: int,
    block_n: int = 8192,
    q_chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse-query streaming top-n: (Q, kq) query codes over [0, h),
    densified one ≤q_chunk slab at a time, then ``retrieve_ref``."""
    parts = [
        retrieve_ref(values, indices, inv_norms,
                     _densify_rows(q_values[i:i + q_chunk],
                                   q_indices[i:i + q_chunk], h),
                     n=n, block_n=block_n, q_chunk=q_chunk)
        for i in range(0, q_values.shape[0], q_chunk)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
