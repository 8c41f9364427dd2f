"""The sparse-query fused retrieve as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/sparse_dot/kernel.py::fused_retrieve_sparse_q_pallas``
(without its alive mask, which comes with the segmented index): query
codes densified into an on-chip panel, every candidate scored against it,
reciprocal norms folded in, a streaming top-n, and only (Q, n) written.
Source: ``repro_torch/csrc/sparse_dot.cu``, bound with ctypes.

What bounds it on an H100: the bytes of the catalog.  At Q=64,
N=1,048,576, k=32 the candidates and norms are 272.6 MB, 81.4 µs at
3.35 TB/s, against 4.3 GFLOP of products (64.1 µs at 67 TFLOP/s).  The
TPU kernel walks the candidate axis serially per 8-row query panel,
which at Q=64 would be 8 blocks on 132 SMs, each reading the catalog.
This design holds up to 64 queries in one block, as the (query, value)
entries of each latent they hold, in shared memory, so a request of 64
queries reads the catalog once; it splits the candidates over S blocks
(at least two per SM), keeps a top-n per split, and merges the splits
in a second launch by score descending, then id ascending.  The splits
of a query share a bar (the best n-th score any holds, seeded from a
catalog prefix), so a split drops what cannot reach the top n.  A
candidate's k products are summed in slot order with no fused
multiply-add, as the plain version sums them, so the two agree bit for
bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TN = 256                  # candidates per tile, one a thread
MAX_N = 256               # top-n cap of the in-kernel merge
MAX_SPLITS = 1024         # candidate splits one merge block takes
MAX_ROWS = 64             # query rows one block scores
SMEM_LIMIT = 232448       # dynamic shared memory a block may use on sm_90

_ARGTYPES = {"fused_retrieve_sparse_q_launch": [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 9 + [ctypes.c_void_p]}

launches = 0              # kernel launches since the last reset


def smem_bytes(bq: int, h: int, n: int, kq: int) -> int:
    """Shared memory of one block of bq query rows, as laid out by
    ``retrieve_tiles``: each tile candidate's touched-row bits and 1/‖c‖,
    a scratch area (the (bq, TN) tile sums, or the panel's build), the
    (bq, n) running top-n, the bq*kq query entries and h 16-bit segment
    ends."""
    scratch = (max(bq * TN, h + 2 + 2 * bq * kq) + 1) // 2 * 2
    return TN * 12 + (scratch + 2 * bq * (n + kq)) * 4 + (h * 2 + 3) // 4 * 4


def panel_rows(Q: int, h: int, n: int, kq: int) -> int:
    """Query rows per block (BQ): as many as MAX_ROWS and Q allow while
    the shared memory fits and the bq*kq entries have 16-bit links."""
    for bq in range(min(Q, MAX_ROWS), 0, -1):
        if smem_bytes(bq, h, n, kq) <= SMEM_LIMIT and bq * kq < 65535:
            return bq
    raise ValueError(f"h={h}, kq={kq}, n={n}: even a one-row query panel "
                     f"exceeds {SMEM_LIMIT} bytes of shared memory")


def num_splits(N: int, Q: int, bq: int, sms: int) -> int:
    """Candidate splits S: enough for two blocks per SM, at most one per
    tile of candidates and at most MAX_SPLITS."""
    panels = -(-Q // bq)
    return max(1, min(-(-2 * sms // panels), -(-N // TN), MAX_SPLITS))


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
    tensors on one device, 1 <= n <= min(N, 256).  Raises on anything the
    kernel does not take."""
    global launches
    _build.check_tensor("values", values, torch.float32, 2)
    dev = values.device
    _build.check_tensor("indices", indices, torch.int32, 2, dev)
    _build.check_tensor("inv_norms", inv_norms, torch.float32, 1, dev)
    _build.check_tensor("q_values", q_values, torch.float32, 2, dev)
    _build.check_tensor("q_indices", q_indices, torch.int32, 2, dev)
    N, k = values.shape
    Q, kq = q_values.shape
    if indices.shape != values.shape or inv_norms.shape[0] != N:
        raise ValueError(f"candidate shapes disagree: values {tuple(values.shape)}, "
                         f"indices {tuple(indices.shape)}, inv_norms "
                         f"{tuple(inv_norms.shape)}")
    if q_indices.shape != q_values.shape:
        raise ValueError(f"query shapes disagree: {tuple(q_values.shape)} vs "
                         f"{tuple(q_indices.shape)}")
    if not 1 <= n <= min(N, MAX_N):
        raise ValueError(f"top-n {n} outside [1, min(N={N}, {MAX_N})]: the "
                         f"kernel's merge holds at most {MAX_N}")
    if N >= 2**31 - 2 * TN or Q < 1 or k < 1 or kq < 1:
        raise ValueError(f"unsupported sizes N={N}, Q={Q}, k={k}, kq={kq}")
    bq = panel_rows(Q, h, n, kq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = num_splits(N, Q, bq, sms)
    vec = int(k % 4 == 0 and values.data_ptr() % 16 == 0
              and indices.data_ptr() % 16 == 0)
    part_v = torch.empty(Q, S, n, dtype=torch.float32, device=dev)
    part_i = torch.empty(Q, S, n, dtype=torch.int32, device=dev)
    bar = torch.empty(Q, dtype=torch.int32, device=dev)     # zeroed by the launch
    out_v = torch.empty(Q, n, dtype=torch.float32, device=dev)
    out_i = torch.empty(Q, n, dtype=torch.int32, device=dev)
    lib = _build.load("sparse_dot", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.fused_retrieve_sparse_q_launch(
            values.data_ptr(), indices.data_ptr(), inv_norms.data_ptr(),
            q_values.data_ptr(), q_indices.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), bar.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            N, k, Q, kq, h, n, bq, S, vec, stream)
    _build.check(lib, "sparse_dot", status)
    launches += 1
    return out_v, out_i
