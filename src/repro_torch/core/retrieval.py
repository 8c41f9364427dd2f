"""Retrieval from compressed space (paper §3.2), twin of ``repro.core.retrieval``.

Sparse-space cosine is served from an fp32 ``SparseIndex`` or from a
``QuantizedIndex`` (int8 values, int16/int32 indices, f32 per-row
scales): the codes of N candidates plus precomputed norms and reciprocal
norms, which the fused retrieval kernels fold into their scoring.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import sae
from repro_torch.core.quantized_codes import (
    QuantizedCodes, codes_checksum, content_checksum, dequantize_codes, quantize_codes,
)
from repro_torch.core.types import SparseCodes
from repro_torch.errors import (
    EngineConfigError, IndexIntegrityError, InvalidCodesError,
)

NORM_EPS = 1e-8
DECODE_CHUNK = 8192   # rows decoded at a time for the reconstructed norms
UseKernel = Union[str, bool]  # "auto" | True | False


def kernel_path(use_kernel: UseKernel, device) -> bool:
    """Resolve ``use_kernel`` for tensors on ``device`` (True = the CUDA
    kernels).  "auto" is the kernel on a CUDA device and the plain
    PyTorch path on the CPU; True on the CPU raises."""
    dev = torch.device(device)
    if use_kernel == "auto":
        return dev.type == "cuda"
    if not isinstance(use_kernel, bool):
        raise EngineConfigError(
            f"use_kernel must be 'auto', True or False: {use_kernel!r}")
    if use_kernel and dev.type != "cuda":
        raise EngineConfigError(
            f"use_kernel=True needs a CUDA device; got {str(dev)!r}")
    return use_kernel


class SparseIndex(NamedTuple):
    """A retrieval index over fp32 fixed-k codes.

    codes:        fixed-k sparse codes of all N candidates.
    sparse_norms: ‖s_c‖₂ per candidate.
    recon_norms:  ‖W_dec s_c‖₂ per candidate, None without decoder weights.
    inv_sparse_norms / inv_recon_norms: 1/max(norm, NORM_EPS).
    checksum:     build-time CRC over codes + norms; ``verify_index``
                  recomputes it.
    """

    codes: SparseCodes
    sparse_norms: torch.Tensor
    recon_norms: Optional[torch.Tensor]
    inv_sparse_norms: Optional[torch.Tensor] = None
    inv_recon_norms: Optional[torch.Tensor] = None
    checksum: Optional[int] = None


class QuantizedIndex(NamedTuple):
    """A retrieval index whose codes stay in the compound-compressed
    format on the device (``QuantizedCodes``).  The fields mirror
    ``SparseIndex``; every norm is computed on the dequantized values, so
    serving it is bit-identical to serving ``dequantize_index(index)``."""

    codes: QuantizedCodes
    sparse_norms: torch.Tensor
    recon_norms: Optional[torch.Tensor]
    inv_sparse_norms: Optional[torch.Tensor] = None
    inv_recon_norms: Optional[torch.Tensor] = None
    checksum: Optional[int] = None


Index = Union[SparseIndex, QuantizedIndex]


def index_checksum(index: Index) -> int:
    """The content CRC of an index (codes + every norm array), over the
    same bytes as the JAX package's ``index_checksum``."""
    base = codes_checksum(index.codes)
    extra = content_checksum([
        ("sparse_norms", index.sparse_norms),
        ("recon_norms", index.recon_norms),
        ("inv_sparse_norms", index.inv_sparse_norms),
        ("inv_recon_norms", index.inv_recon_norms),
    ])
    return zlib.crc32(f"{base:08x}:{extra:08x}".encode())


def verify_index(index: Index, *, require: bool = True) -> bool:
    """True when the stored checksum matches the content; a mismatch
    raises ``IndexIntegrityError``, and so does a missing checksum when
    ``require`` (else False)."""
    fmt = type(index).__name__
    if index.checksum is None:
        if require:
            raise IndexIntegrityError(
                f"{fmt} has no stored checksum; rebuild with build_index(...) "
                "to make integrity verifiable")
        return False
    got = index_checksum(index)
    if got != index.checksum:
        raise IndexIntegrityError(
            f"{fmt} content checksum mismatch: stored 0x{index.checksum:08x}, "
            f"recomputed 0x{got:08x} (N={index.codes.n}, k={index.codes.k}); "
            "the index bytes changed since build_index")
    return True


def _check_codes(codes: SparseCodes) -> None:
    if codes.indices.dtype != torch.int32 or codes.values.dtype != torch.float32:
        raise InvalidCodesError(
            "build_index needs float32 values and int32 indices, got "
            f"{codes.values.dtype} / {codes.indices.dtype}")
    if codes.indices.numel() and not (
            0 <= int(codes.indices.min()) and int(codes.indices.max()) < codes.dim):
        raise InvalidCodesError(
            f"code indices outside [0, {codes.dim}): min "
            f"{int(codes.indices.min())}, max {int(codes.indices.max())}")
    if not bool(torch.isfinite(codes.values).all()):
        raise InvalidCodesError("code values must be finite")


def build_index(
    codes: SparseCodes,
    params: Optional[sae.Params] = None,
    *,
    quantize: bool = False,
) -> Index:
    """Precompute per-candidate norms and their reciprocals.  With
    ``params`` also the reconstructed-space norms ‖W_dec s_c‖, decoded
    DECODE_CHUNK rows at a time.  Code indices outside [0, h) and non-finite
    values raise: the retrieve kernels skip the latents no query holds,
    which equals adding their zero products only for finite values.

    ``quantize=True`` returns a ``QuantizedIndex``: the codes quantized by
    ``quantize_codes`` and every norm computed on their dequantized
    values, so it serves exactly as ``dequantize_index`` of it."""
    _check_codes(codes)
    if quantize:
        q_codes = quantize_codes(codes)
        base = build_index(dequantize_codes(q_codes), params)
        idx = QuantizedIndex(
            codes=q_codes,
            sparse_norms=base.sparse_norms,
            recon_norms=base.recon_norms,
            inv_sparse_norms=base.inv_sparse_norms,
            inv_recon_norms=base.inv_recon_norms,
        )
        return idx._replace(checksum=index_checksum(idx))
    sparse_norms = torch.linalg.vector_norm(codes.values, dim=-1)
    recon_norms = inv_recon_norms = None
    if params is not None:
        recon_norms = torch.cat([
            torch.linalg.vector_norm(sae.decode(params, SparseCodes(
                codes.values[i:i + DECODE_CHUNK], codes.indices[i:i + DECODE_CHUNK],
                codes.dim)), dim=-1)
            for i in range(0, codes.n, DECODE_CHUNK)])
        inv_recon_norms = 1.0 / torch.clamp(recon_norms, min=NORM_EPS)
    idx = SparseIndex(
        codes=codes,
        sparse_norms=sparse_norms,
        recon_norms=recon_norms,
        inv_sparse_norms=1.0 / torch.clamp(sparse_norms, min=NORM_EPS),
        inv_recon_norms=inv_recon_norms,
    )
    return idx._replace(checksum=index_checksum(idx))


def dequantize_index(index: QuantizedIndex) -> SparseIndex:
    """The fp32 ``SparseIndex`` a ``QuantizedIndex`` serves identically
    to: dequantized codes, the stored norms, a fresh checksum."""
    idx = SparseIndex(
        codes=dequantize_codes(index.codes),
        sparse_norms=index.sparse_norms,
        recon_norms=index.recon_norms,
        inv_sparse_norms=index.inv_sparse_norms,
        inv_recon_norms=index.inv_recon_norms,
    )
    return idx._replace(checksum=index_checksum(idx))


def index_codes_f32(index: Index) -> SparseCodes:
    """The index's codes as fp32 ``SparseCodes``, dequantized if needed
    (for evaluation; serving keeps quantized codes quantized)."""
    if isinstance(index.codes, QuantizedCodes):
        return dequantize_codes(index.codes)
    return index.codes


def index_nbytes(index: Index) -> int:
    """Bytes of every tensor the index holds (codes, norms, reciprocals):
    what it occupies on its device."""
    tensors = [*index.codes[:-1], index.sparse_norms, index.recon_norms,
               index.inv_sparse_norms, index.inv_recon_norms]
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def score_dense(database: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact dense cosine baseline.  database (N, d), q (Q?, d)."""
    db = database / torch.clamp(
        torch.linalg.vector_norm(database, dim=-1, keepdim=True), min=NORM_EPS)
    qq = q / torch.clamp(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=NORM_EPS)
    return qq @ db.T if q.ndim > 1 else db @ qq


def top_n(scores: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-n over the last axis -> (scores, ids); ties to the lowest id."""
    s, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :n], ids[..., :n].to(torch.int32)
