"""The fused encoder as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/fused_encode/kernel.py::fused_encode_pallas``:
(x̄ @ W_enc + b) followed by abs-top-k, writing only the (B, k) codes.
Source: ``repro_torch/csrc/fused_encode.cu``, bound with ctypes.

What bounds it on an H100: the encoder product, 2·B·d·h operations
(0.40 GFLOP at B=64, d=768, h=4096: 6.0 µs at 67 TFLOP/s fp32) against
12.8 MB of bytes (3.8 µs at 3.35 TB/s), so compute.  The TPU kernel's
(128, h) on-chip accumulator does not fit a block's 227 KB here, so the
design tiles h: each block computes a (64, 256) pre-activation tile, or a
(16, 128) one where a small batch would leave SMs idle, in fp32 FMAs (no
TF32), and keeps the min(k, tile width) largest |pre| of each row of its
tile; a second launch merges the per-tile lists of each row (more
launches where a row has more than 256 tiles).  That is the exact
grouped abs-top-k of ``core/topk.py``, so indices match the plain version
wherever no two |pre| are within rounding, with ties to the lowest index
and NaN first.  Any h >= k >= 1: a ragged last tile is masked in the
kernel.  The (B, h) pre-activations never reach device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

GROUP = 256       # sorted lists one merge pass takes per output list

_ARGTYPES = {"fused_encode_launch": [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def tile_width(B: int, h: int, sms: int) -> int:
    """The tile width bh: 256 latents by 64 rows, unless that grid would
    not give every SM two blocks; then 128 latents by 16 rows.  Both
    widths compute the same exact abs-top-k."""
    return 256 if -(-B // 64) * -(-h // 256) >= 2 * sms else 128

launches = 0      # kernel launches since the last reset


def fused_encode_cuda(
    x_norm: torch.Tensor, w_enc: torch.Tensor, b_enc: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values (B, k) f32, indices (B, k) i32) of φ(x_norm @ w_enc + b_enc, k)
    on the card.  x_norm (B, d) already L2-normalised, w_enc (d, h),
    b_enc (h,); all contiguous float32 CUDA tensors.  Raises on anything
    the kernel does not take."""
    global launches
    _build.check_tensor("x_norm", x_norm, torch.float32, 2)
    dev = x_norm.device
    _build.check_tensor("w_enc", w_enc, torch.float32, 2, dev)
    _build.check_tensor("b_enc", b_enc, torch.float32, 1, dev)
    B, d = x_norm.shape
    h = w_enc.shape[1]
    if w_enc.shape[0] != d or b_enc.shape[0] != h:
        raise ValueError(f"shape mismatch: x {tuple(x_norm.shape)}, w_enc "
                         f"{tuple(w_enc.shape)}, b_enc {tuple(b_enc.shape)}")
    if not 1 <= k <= h:
        raise ValueError(f"fused_encode kernel needs 1 <= k <= h: h={h}, k={k}")
    if B < 1 or d < 1:
        raise ValueError(f"empty input: B={B}, d={d}")
    bh = tile_width(B, h, torch.cuda.get_device_properties(dev).multi_processor_count)
    groups, kt = -(-h // bh), min(k, bh)
    list_v = torch.empty(B, groups, kt, dtype=torch.float32, device=dev)
    list_i = torch.empty(B, groups, kt, dtype=torch.int32, device=dev)
    wide = groups > GROUP                  # a second merge pass is needed
    merge_shape = (B, -(-groups // GROUP), min(k, GROUP * kt)) if wide else (0,)
    merge_v = torch.empty(merge_shape, dtype=torch.float32, device=dev)
    merge_i = torch.empty(merge_shape, dtype=torch.int32, device=dev)
    out_v = torch.empty(B, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(B, k, dtype=torch.int32, device=dev)
    lib = _build.load("fused_encode", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.fused_encode_launch(
            x_norm.data_ptr(), w_enc.data_ptr(), b_enc.data_ptr(),
            list_v.data_ptr(), list_i.data_ptr(), merge_v.data_ptr(),
            merge_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            B, d, h, k, bh, stream)
    _build.check(lib, "fused_encode", status)
    launches += 1
    return out_v, out_i
