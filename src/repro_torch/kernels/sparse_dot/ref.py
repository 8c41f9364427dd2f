"""Plain PyTorch versions of the sparse-query fused retrieves.

``retrieve_ref``          — chunked streaming score+select of dense (Q, h)
                            queries against fixed-k candidates.  It scans
                            (block_n, k) candidate blocks and carries a
                            per-query running top-n, merging each block
                            with one stable sort over n + block_n entries:
                            the running list precedes the block, so equal
                            scores go to the lowest candidate id, and NaN
                            ranks above every number, as in ``lax.top_k``.
``retrieve_sparse_q_ref`` — the same over (Q, kq) query codes, densified
                            one ≤q_chunk slab at a time (duplicate indices
                            sum in slot order, as ``densify`` does).
``retrieve_quantized_sparse_q_ref`` — quantized candidates (int8 values,
                            int16/int32 indices, f32 row scales), each
                            block dequantized inside the scan as
                            ``float(q) * scale`` with the indices widened:
                            bit-identical to ``retrieve_sparse_q_ref`` over
                            the dequantized arrays.
``retrieve_quantized_mxu_sparse_q_ref`` — int8 scoring: the densified
                            query slab is quantized per row
                            (``quantize_rows``), products of int8 codes
                            accumulate exactly in int32, and one f32
                            rescale (f32(acc)·q_scale)·(scale·1/‖c‖)
                            gives the score.

Transients stay bounded: a (q_chunk, h) dense slab and (q_chunk, block_n)
scores, never (Q, N).  A candidate's fp32 score sums its k products in
slot order, product by product, as the TPU kernel's ``_score_tile`` does,
and the CUDA kernels are held to that bit for bit.  (The JAX package's
refs sum with ``jnp.sum``, whose order XLA picks, so they agree with
this file to f32 rounding; the int32 sums of the int8 path agree
exactly.)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantized_codes import quantize_rows
from repro_torch.core.quantized_codes import widen_indices as _widen_idx
from repro_torch.core.sparse import densify_rows as _densify_rows


def _merge_block(best_v, best_i, scores, s: int, n: int):
    """Merge a block's (Q, b) scores of ids s.. into the running top-n:
    one stable descending sort, the running list first."""
    nq, width = scores.shape
    ids = torch.arange(s, s + width, dtype=torch.int32, device=scores.device)
    cand_v = torch.cat([best_v, scores], dim=1)
    cand_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
    order = torch.sort(cand_v, dim=1, descending=True, stable=True).indices[:, :n]
    return torch.gather(cand_v, 1, order), torch.gather(cand_i, 1, order)


def _empty_top(nq: int, n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((nq, n), float("-inf"), dtype=torch.float32, device=dev),
            torch.zeros((nq, n), dtype=torch.int32, device=dev))


def _retrieve_chunked(values, indices, inv_norms, q, scales: Optional[torch.Tensor],
                      *, n: int, block_n: int):
    """Streaming top-n of dense queries q (Q, h) over (N, k) codes.  With
    ``scales``, ``values`` are int8 and ``indices`` int16/int32: each
    block is dequantized inside the scan."""
    N, k = values.shape
    best_v, best_i = _empty_top(q.shape[0], n, values.device)
    for s in range(0, N, block_n):
        bv = values[s:s + block_n]
        bi = indices[s:s + block_n]
        if scales is not None:
            bv = bv.to(torch.float32) * scales[s:s + block_n, None]
            bi = _widen_idx(bi)
        bi = bi.long()
        acc = torch.zeros(q.shape[0], bv.shape[0], dtype=torch.float32, device=q.device)
        for j in range(k):
            acc = acc + q[:, bi[:, j]] * bv[:, j]
        best_v, best_i = _merge_block(best_v, best_i, acc * inv_norms[s:s + block_n], s, n)
    return best_v, best_i


def int8_accumulators(q_values: torch.Tensor, indices: torch.Tensor,
                      qp_i8: torch.Tensor) -> torch.Tensor:
    """(Q, b) int32 sums of int8 products: candidate codes q_values
    (b, k) int8 with indices (b, k) int16/int32 against a quantized (Q, h)
    int8 query panel.  Exact, so any order gives these integers."""
    bv = q_values.to(torch.int32)
    bi = _widen_idx(indices).long()
    acc = torch.zeros(qp_i8.shape[0], bv.shape[0], dtype=torch.int32, device=bv.device)
    for j in range(bv.shape[1]):
        acc += qp_i8[:, bi[:, j]].to(torch.int32) * bv[:, j]
    return acc


def _retrieve_chunked_int8(q_values, indices, scales, inv_norms, qp_i8, q_scales,
                           *, n: int, block_n: int):
    """Streaming top-n over int8 scores: per block the exact int32 sums,
    then (f32(acc) · q_scale) · (scale · 1/‖c‖)."""
    N = q_values.shape[0]
    best_v, best_i = _empty_top(qp_i8.shape[0], n, q_values.device)
    for s in range(0, N, block_n):
        acc = int8_accumulators(q_values[s:s + block_n], indices[s:s + block_n], qp_i8)
        sc = acc.to(torch.float32) * q_scales[:, None]
        sc = sc * (scales[s:s + block_n] * inv_norms[s:s + block_n])
        best_v, best_i = _merge_block(best_v, best_i, sc, s, n)
    return best_v, best_i


def _by_query_chunks(fn, q_values, q_indices, q_chunk: int):
    parts = [fn(q_values[i:i + q_chunk], q_indices[i:i + q_chunk])
             for i in range(0, q_values.shape[0], q_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


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
    return _by_query_chunks(
        lambda qc, _: _retrieve_chunked(values, indices, inv_norms, qc, None,
                                        n=n, block_n=block_n),
        q, q, q_chunk)


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
    return _by_query_chunks(
        lambda qv, qi: _retrieve_chunked(values, indices, inv_norms,
                                         _densify_rows(qv, qi, h), None,
                                         n=n, block_n=block_n),
        q_values, q_indices, q_chunk)


def retrieve_quantized_sparse_q_ref(
    q_values: torch.Tensor,
    indices: torch.Tensor,
    scales: torch.Tensor,
    inv_norms: torch.Tensor,
    query_values: torch.Tensor,
    query_indices: torch.Tensor,
    h: int,
    *,
    n: int,
    block_n: int = 8192,
    q_chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized candidates (q_values (N, k) int8, indices (N, k)
    int16/int32, scales (N,) f32) × sparse query codes; each candidate
    block dequantized in the scan.  Bit-identical to
    ``retrieve_sparse_q_ref`` over ``dequantize_codes`` of the same
    arrays."""
    return _by_query_chunks(
        lambda qv, qi: _retrieve_chunked(q_values, indices, inv_norms,
                                         _densify_rows(qv, qi, h), scales,
                                         n=n, block_n=block_n),
        query_values, query_indices, q_chunk)


def quantized_query_panel(query_values: torch.Tensor, query_indices: torch.Tensor,
                          h: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, kq) query codes -> ((Q, h) int8 panel, (Q,) f32 scales): the
    densified rows (duplicates summed in slot order), quantized per row by
    the arithmetic of ``quantize_codes`` (the JAX ``_quantize_panel``);
    zero rows quantize to zeros."""
    return quantize_rows(_densify_rows(query_values.to(torch.float32),
                                       query_indices, h))


def retrieve_quantized_mxu_sparse_q_ref(
    q_values: torch.Tensor,
    indices: torch.Tensor,
    scales: torch.Tensor,
    inv_norms: torch.Tensor,
    query_values: torch.Tensor,
    query_indices: torch.Tensor,
    h: int,
    *,
    n: int,
    block_n: int = 8192,
    q_chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 scoring of sparse query codes against quantized candidates
    (approximate against the exact path; exact in its own arithmetic):
    query slabs densify and quantize per row, then int8 × int8 products
    sum in int32 and one f32 rescale folds in the scales and 1/‖c‖."""
    def one_chunk(qv, qi):
        qp_i8, q_scales = quantized_query_panel(qv, qi, h)
        return _retrieve_chunked_int8(q_values, indices, scales, inv_norms,
                                      qp_i8, q_scales, n=n, block_n=block_n)

    return _by_query_chunks(one_chunk, query_values, query_indices, q_chunk)
