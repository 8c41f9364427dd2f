"""The sparse-query fused retrieves as hand-written CUDA kernels for Hopper.

One kernel body in ``repro_torch/csrc/sparse_dot.cu``, bound with ctypes
and templated on the candidate format, replaces three TPU kernels of
``repro/kernels/sparse_dot/kernel.py`` (without their alive mask, which
comes with the segmented index):

- ``fused_retrieve_sparse_q_cuda``: fp32 codes
  (``fused_retrieve_sparse_q_pallas``);
- ``fused_retrieve_quantized_sparse_q_cuda``: int8 values with f32 row
  scales, int16/int32 indices, dequantized in the kernel and then scored
  as the fp32 kernel scores, so bit-identical to it over the dequantized
  index (``fused_retrieve_quantized_sparse_q_pallas``);
- ``fused_retrieve_quantized_mxu_sparse_q_cuda``: the same codes scored
  in int8 against the per-row quantized query panel, int32 sums, one f32
  rescale (``fused_retrieve_quantized_mxu_sparse_q_pallas``).

Each densifies the (Q, kq) query codes into a panel, scores every
candidate against it, folds in the reciprocal norms, keeps a streaming
top-n and writes only (Q, n).

What bounds them on an H100: the bytes of the catalog.  At Q=64,
N=1,048,576, k=32 the fp32 candidates and norms are 272.6 MB, 81.4 µs at
3.35 TB/s; the quantized ones 104 B an item, 109.1 MB or 32.6 µs.  The
TPU kernels walk the candidate axis serially per 8-row query panel,
which at Q=64 would be 8 blocks on 132 SMs, each reading the catalog.
This design builds a panel of up to 64 queries once per request, as CSR
(value, row) entries per latent in device memory, which each block
copies to shared memory (the h + 1 segment starts too, where they fit),
so a request of 64 queries reads the catalog once; it splits the
candidates over S blocks (at least two per SM), keeps a top-n per split
(in shared memory where it fits, else in device memory, so any n <= N is
served), and merges the splits in a further launch by score descending,
then id ascending, NaN above every number.  The splits of a query share
a bar (the best n-th score any holds, seeded from a catalog prefix), so
a split drops what cannot reach the top n.  A candidate's fp32 products
are summed in slot order with no fused multiply-add, as the plain
version sums them, so the two agree bit for bit; int8 products sum
exactly in int32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

TN = 256                  # candidates per tile, one a thread
MAX_SPLITS = 1024         # candidate splits one merge block takes
MAX_ROWS = 64             # query rows one block scores
SMEM_LIMIT = 232448       # dynamic shared memory a block may use on sm_90
FMT_F32, FMT_DEQ, FMT_INT8 = 0, 1, 2

_ARGTYPES = {"sparse_dot_retrieve_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 16
             + [ctypes.c_int] * 11 + [ctypes.c_void_p]}

# Kernel launches since the last reset, by kernel name.
launches = {"fused_retrieve_sparse_q": 0, "fused_retrieve_quantized_sparse_q": 0,
            "fused_retrieve_quantized_mxu_sparse_q": 0}
_NAMES = {FMT_F32: "fused_retrieve_sparse_q", FMT_DEQ: "fused_retrieve_quantized_sparse_q",
          FMT_INT8: "fused_retrieve_quantized_mxu_sparse_q"}


def smem_bytes(bq: int, n: int, kq: int, h: int, lists_smem: bool, seg_smem: bool) -> int:
    """Shared memory of one block of bq query rows, as laid out by
    ``retrieve_tiles``: each tile candidate's touched-row bits and factor,
    the (bq, TN) tile sums, the rows' query scales, the (bq, n) running
    lists where they live there, the bq*kq panel entries, and the h + 1
    segment starts as 16-bit values where they live there."""
    return (TN * 12 + bq * TN * 4 + (bq * 4 + 7) // 8 * 8
            + (bq * n * 8 if lists_smem else 0) + bq * kq * 8
            + (((h + 1) * 2 + 3) // 4 * 4 if seg_smem else 0))


class Plan(NamedTuple):
    """How a request is laid out: query rows per block, and whether the
    running lists and the segment starts fit shared memory."""

    bq: int
    lists_smem: bool
    seg_smem: bool


def plan(Q: int, h: int, n: int, kq: int) -> Plan:
    """As many query rows a block as MAX_ROWS, Q and the shared memory of
    the tile sums and entries allow; then the running lists in shared
    memory if they fit beside those, then the segment starts likewise
    (16-bit, so only for panels of fewer than 65,536 entries)."""
    for bq in range(min(Q, MAX_ROWS), 0, -1):
        if smem_bytes(bq, n, kq, h, False, False) <= SMEM_LIMIT:
            lists = smem_bytes(bq, n, kq, h, True, False) <= SMEM_LIMIT
            seg = bq * kq < 65536 and smem_bytes(bq, n, kq, h, lists, True) <= SMEM_LIMIT
            return Plan(bq, lists, seg)
    raise ValueError(f"kq={kq}: even a one-row query panel exceeds {SMEM_LIMIT} "
                     "bytes of shared memory")


def num_splits(N: int, Q: int, bq: int, sms: int, n: int) -> int:
    """Candidate splits S: enough for two blocks per SM, at most one per
    tile of candidates, at most MAX_SPLITS, and at most N // n, so the
    (Q, S, n) partial lists stay within Q times the catalog."""
    panels = -(-Q // bq)
    return max(1, min(-(-2 * sms // panels), -(-N // TN), MAX_SPLITS, N // n))


def _retrieve(fmt: int, values, indices, scales, inv_norms, q_values, q_indices,
              h: int, n: int):
    _build.check_tensor("values", values, torch.float32 if fmt == FMT_F32 else torch.int8, 2)
    dev = values.device
    if fmt == FMT_F32:
        _build.check_tensor("indices", indices, torch.int32, 2, dev)
    else:
        if indices.dtype not in (torch.int16, torch.int32):
            raise ValueError(f"indices: expected int16 or int32, got {indices.dtype}")
        _build.check_tensor("indices", indices, indices.dtype, 2, dev)
        _build.check_tensor("scales", scales, torch.float32, 1, dev)
    _build.check_tensor("inv_norms", inv_norms, torch.float32, 1, dev)
    _build.check_tensor("q_values", q_values, torch.float32, 2, dev)
    _build.check_tensor("q_indices", q_indices, torch.int32, 2, dev)
    N, k = values.shape
    Q, kq = q_values.shape
    if (indices.shape != values.shape or inv_norms.shape[0] != N
            or (scales is not None and scales.shape[0] != N)):
        raise ValueError(f"candidate shapes disagree: values {tuple(values.shape)}, "
                         f"indices {tuple(indices.shape)}, inv_norms "
                         f"{tuple(inv_norms.shape)}")
    if q_indices.shape != q_values.shape:
        raise ValueError(f"query shapes disagree: {tuple(q_values.shape)} vs "
                         f"{tuple(q_indices.shape)}")
    if not 1 <= n <= N:
        raise ValueError(f"top-n {n} outside [1, N={N}]")
    if N >= 2**31 - 2 * TN or Q < 1 or k < 1 or kq < 1 or not 1 <= h < 2**31 - 1:
        raise ValueError(f"unsupported sizes N={N}, Q={Q}, k={k}, kq={kq}, h={h}")
    bq, lists_smem, seg_smem = plan(Q, h, n, kq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = num_splits(N, Q, bq, sms, n)
    panels = -(-Q // bq)
    vec = int(k % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (values, indices)))
    i32 = dict(dtype=torch.int32, device=dev)
    cnt = torch.empty(panels, h + 1, **i32)
    seg = torch.empty(panels, h + 1, **i32)
    raw = torch.empty(panels, bq * kq, 2, **i32)
    ent = torch.empty(panels, bq * kq, 2, **i32)
    qscale = torch.empty(panels * bq, dtype=torch.float32, device=dev)
    part_v = torch.empty(Q, S, n, dtype=torch.float32, device=dev)
    part_i = torch.empty(Q, S, n, **i32)
    bar = torch.empty(Q, **i32)             # zeroed by the launch
    out_v = torch.empty(Q, n, dtype=torch.float32, device=dev)
    out_i = torch.empty(Q, n, **i32)
    lib = _build.load("sparse_dot", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.sparse_dot_retrieve_launch(
            fmt, indices.element_size(), values.data_ptr(), indices.data_ptr(),
            None if scales is None else scales.data_ptr(), inv_norms.data_ptr(),
            q_values.data_ptr(), q_indices.data_ptr(), cnt.data_ptr(), seg.data_ptr(),
            raw.data_ptr(), ent.data_ptr(), qscale.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), bar.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            N, k, Q, kq, h, n, bq, S, vec, int(lists_smem), int(seg_smem), stream)
    _build.check(lib, "sparse_dot", status)
    launches[_NAMES[fmt]] += 1
    return out_v, out_i


def fused_retrieve_sparse_q_cuda(
    values: torch.Tensor,
    indices: torch.Tensor,
    inv_norms: torch.Tensor,
    q_values: torch.Tensor,
    q_indices: torch.Tensor,
    h: int,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """((Q, n) norm-folded scores, (Q, n) int32 ids) on the card.

    values (N, k) f32, indices (N, k) i32, inv_norms (N,) f32, q_values
    (Q, kq) f32, q_indices (Q, kq) i32 over [0, h); all contiguous CUDA
    tensors on one device, 1 <= n <= N.  Raises on anything the kernel
    does not take."""
    return _retrieve(FMT_F32, values, indices, None, inv_norms, q_values, q_indices, h, n)


def fused_retrieve_quantized_sparse_q_cuda(
    q_values: torch.Tensor,
    indices: torch.Tensor,
    scales: torch.Tensor,
    inv_norms: torch.Tensor,
    query_values: torch.Tensor,
    query_indices: torch.Tensor,
    h: int,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact retrieve over quantized candidates on the card: q_values
    (N, k) int8, indices (N, k) int16/int32, scales (N,) f32, each value
    dequantized as float(q) * scale.  Bit-identical to
    ``fused_retrieve_sparse_q_cuda`` over the dequantized arrays."""
    return _retrieve(FMT_DEQ, q_values, indices, scales, inv_norms, query_values,
                     query_indices, h, n)


def fused_retrieve_quantized_mxu_sparse_q_cuda(
    q_values: torch.Tensor,
    indices: torch.Tensor,
    scales: torch.Tensor,
    inv_norms: torch.Tensor,
    query_values: torch.Tensor,
    query_indices: torch.Tensor,
    h: int,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8-scoring retrieve on the card: the query panel quantized per
    row, int8 × int8 products summed in int32, scores (f32(acc) · q_scale)
    · (scale · 1/‖c‖).  Bit-identical to
    ``retrieve_quantized_mxu_sparse_q_ref``."""
    return _retrieve(FMT_INT8, q_values, indices, scales, inv_norms, query_values,
                     query_indices, h, n)
