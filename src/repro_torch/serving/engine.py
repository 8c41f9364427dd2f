"""End-to-end dense-query serving engine (twin of ``repro.serving.engine``).

``RetrievalEngine`` owns (index, params, config, device) and serves

    engine.retrieve_dense(x, n)   # dense embeddings in, RetrievalResponse out

On a CUDA device a request runs two hand-written kernels:

    fused_encode  ->  fused_retrieve_sparse_q                (fp32 SparseIndex)
                      fused_retrieve_quantized_sparse_q      (QuantizedIndex, exact)
                      fused_retrieve_quantized_mxu_sparse_q  (QuantizedIndex, int8)

so only the (Q, k) query codes and the (Q, n) results reach device
memory: the encoder's abs-top-k stays on chip (no (Q, h)
pre-activations) and the retrieve kernel builds a sparse query panel
instead of a dense one.  A quantized index stays int8/int16 on the
device; the exact path dequantizes in the kernel and serves what the
dequantized index serves, bit for bit.  On the CPU, or with
``use_kernel=False``, the plain PyTorch versions (``sae.encode`` and the
``*_ref`` retrieves) serve the same contract.

The request is factored as in the JAX package: ``prep_query`` turns
codes into the mode's query representation plus ‖q‖, and
``retrieve_prepped`` runs the streaming score+select and folds ‖q‖ into
the (Q, n) panel.  Sparse mode is served on one device; other
configurations raise "not yet ported" (``serving.config``).
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.core import sae
from repro_torch.core.quantized_codes import QuantizedCodes
from repro_torch.core.retrieval import NORM_EPS, Index, kernel_path
from repro_torch.core.types import SparseCodes
from repro_torch.device import resolve_device
from repro_torch.errors import EngineConfigError, InvalidQueryError
from repro_torch.kernels.fused_encode import fused_encode
from repro_torch.kernels.sparse_dot import (
    fused_retrieve_quantized_mxu_sparse_q, fused_retrieve_quantized_sparse_q,
    fused_retrieve_sparse_q, retrieve_quantized_mxu_sparse_q_ref,
    retrieve_quantized_sparse_q_ref, retrieve_sparse_q_ref,
)
from repro_torch.serving.config import EngineConfig, check_precision
from repro_torch.serving.response import RetrievalResponse, ServingStatus

BLOCK_Q = 8  # serve panels are padded to a multiple of this many rows

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def path_name(engine: "RetrievalEngine") -> str:
    """The canonical serving-path name of an engine's configuration:
    ``{fp32|quantized|int8}-{kernel|ref}``."""
    quantized = isinstance(engine.index.codes, QuantizedCodes)
    fmt = ("int8" if engine.precision == "int8"
           else "quantized" if quantized else "fp32")
    return f"{fmt}-{'kernel' if engine.use_fused else 'ref'}"


def validate_topn(n, n_candidates: int) -> int:
    """Admission check for the ``n`` of a top-n request."""
    if isinstance(n, bool) or not isinstance(n, int):
        raise InvalidQueryError(f"n: expected a Python int, got {type(n).__name__} ({n!r})")
    if n < 1:
        raise InvalidQueryError(f"n: top-n must be >= 1, got {n}")
    if n > n_candidates:
        raise InvalidQueryError(f"n: top-n {n} exceeds candidate count {n_candidates}")
    return n


def validate_dense_query(x, *, d: Optional[int] = None, name: str = "x"):
    """Admission checks for a dense query batch: a tensor of rank 1 or 2,
    the SAE's input dim, a floating dtype."""
    if not isinstance(x, torch.Tensor):
        raise InvalidQueryError(
            f"{name}: expected a torch.Tensor of dense embeddings, got {type(x).__name__}")
    if x.ndim not in (1, 2):
        raise InvalidQueryError(
            f"{name}: expected shape (d,) or (Q, d), got rank-{x.ndim} shape {tuple(x.shape)}")
    if d is not None and x.shape[-1] != d:
        raise InvalidQueryError(
            f"{name}: embedding dim mismatch — expected last axis {d} (the SAE "
            f"input dim), got {x.shape[-1]} (shape {tuple(x.shape)})")
    if not x.dtype.is_floating_point:
        raise InvalidQueryError(f"{name}: expected a floating dtype, got {x.dtype}")
    return x


def validate_query_codes(q: SparseCodes, *, h: int, name: str = "q") -> SparseCodes:
    """Admission checks for query codes: paired shapes, integer indices,
    code dim equal to the index's."""
    if tuple(q.values.shape) != tuple(q.indices.shape):
        raise InvalidQueryError(
            f"{name}: values shape {tuple(q.values.shape)} != indices shape "
            f"{tuple(q.indices.shape)} (fixed-k codes pair one index per value)")
    if q.values.ndim not in (1, 2):
        raise InvalidQueryError(
            f"{name}: expected code shape (k,) or (Q, k), got rank-"
            f"{q.values.ndim} shape {tuple(q.values.shape)}")
    if q.indices.dtype not in _INT_DTYPES:
        raise InvalidQueryError(f"{name}: indices must be an integer dtype, got {q.indices.dtype}")
    if int(q.dim) != h:
        raise InvalidQueryError(
            f"{name}: code dim mismatch — query codes address a {int(q.dim)}-wide "
            f"latent space, index stores {h}")
    return q


class PreppedQuery(NamedTuple):
    """A query batch in the representation its retrieval mode scores with:
    sparse mode carries the (Q?, k) codes (``dense`` is None) and
    ``norm``, the per-query cosine denominator ‖s_q‖."""

    values: Optional[torch.Tensor]
    indices: Optional[torch.Tensor]
    dense: Optional[torch.Tensor]
    norm: torch.Tensor

    @property
    def is_sparse(self) -> bool:
        return self.values is not None


def mode_inv_norms(index: Index, mode: str) -> torch.Tensor:
    """The index's reciprocal candidate norms for a scoring mode."""
    if mode != "sparse":
        raise EngineConfigError(f"mode={mode!r} is not yet ported")
    inv = index.inv_sparse_norms
    if inv is None:
        inv = 1.0 / torch.clamp(index.sparse_norms, min=NORM_EPS)
    return inv


def prep_query(index: Index, q: SparseCodes, mode: str,
               params: Optional[sae.Params] = None) -> PreppedQuery:
    """Query codes -> the mode's scoring representation."""
    if mode != "sparse":
        raise EngineConfigError(f"mode={mode!r} is not yet ported")
    return PreppedQuery(
        values=q.values.contiguous(),
        indices=q.indices.to(torch.int32).contiguous(),
        dense=None,
        norm=torch.linalg.vector_norm(q.values, dim=-1),
    )


def select_retrieve_fn(*, sparse_query: bool, quantized: bool,
                       int8_scoring: bool, use_fused: bool):
    """The kernel-generation dispatch table: (query representation, index
    format, scoring precision, backend) -> the streaming retrieve.  The
    port has the sparse-query column, each row a CUDA kernel or its plain
    version; dense queries (reconstructed mode) are not yet ported."""
    if not sparse_query:
        raise EngineConfigError(
            "the dense-query retrieves are not yet ported "
            f"(sparse_query={sparse_query}, quantized={quantized}, "
            f"int8_scoring={int8_scoring})")
    if int8_scoring:
        kernel, plain = fused_retrieve_quantized_mxu_sparse_q, retrieve_quantized_mxu_sparse_q_ref
    elif quantized:
        kernel, plain = fused_retrieve_quantized_sparse_q, retrieve_quantized_sparse_q_ref
    else:
        kernel, plain = fused_retrieve_sparse_q, retrieve_sparse_q_ref
    return functools.partial(kernel, use_kernel=True) if use_fused else plain


def retrieve_prepped(
    index: Index,
    pq: PreppedQuery,
    n: int,
    *,
    use_fused: bool,
    inv_norms: Optional[torch.Tensor] = None,
    precision: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-device streaming score+select over a prepped query batch;
    folds ‖q‖ into the (Q, n) panel only.  A ``QuantizedIndex`` streams
    its int8/int16 codes and row scales into the quantized retrieve
    (exact) or, at ``precision="int8"``, the int8-scoring one."""
    check_precision(index, precision)
    if inv_norms is None:
        inv_norms = mode_inv_norms(index, "sparse")
    squeeze = pq.norm.ndim == 0
    quantized = isinstance(index.codes, QuantizedCodes)
    cand = (index.codes.q_values, index.codes.indices, index.codes.scales) if quantized \
        else (index.codes.values, index.codes.indices)
    fn = select_retrieve_fn(sparse_query=pq.is_sparse, quantized=quantized,
                            int8_scoring=precision == "int8", use_fused=use_fused)
    qv = pq.values[None] if squeeze else pq.values
    qi = pq.indices[None] if squeeze else pq.indices
    vals, ids = fn(*cand, inv_norms, qv, qi, index.codes.dim, n=n)
    norm = pq.norm[None] if squeeze else pq.norm
    scores = vals / torch.clamp(norm[..., None], min=NORM_EPS)
    if squeeze:
        scores, ids = scores[0], ids[0]
    return scores, ids


def _on_device(t: Optional[torch.Tensor], dev: torch.device):
    return None if t is None else t.to(dev).contiguous()


class RetrievalEngine:
    """One object owns the serving lifecycle: a ``SparseIndex`` or a
    ``QuantizedIndex``, the SAE params, one ``EngineConfig`` and a device.  Construct once,
    ``RetrievalEngine(index, params, config=EngineConfig(...),
    device="cuda")``, then serve ``retrieve_dense(x, n)``.

    ``device`` defaults to "cuda" and raises when there is no card; pass
    "cpu" for the plain PyTorch path.  The index and params are moved to
    the device once, here.  ``use_kernel`` "auto" is the CUDA kernels on
    a CUDA device; True on the CPU raises; False runs the plain version.
    """

    def __init__(self, index: Index, params: Optional[sae.Params] = None,
                 *, config: Optional[EngineConfig] = None, device="cuda"):
        cfg = EngineConfig() if config is None else config
        cfg.validate(index, params)
        dev = resolve_device(device)
        self.config = cfg
        self.device = dev
        self.use_kernel = cfg.use_kernel
        self.use_fused = kernel_path(cfg.use_kernel, dev)
        self.mode = cfg.mode
        self.precision = cfg.precision
        self.params = (None if params is None
                       else {key: _on_device(val, dev) for key, val in params.items()})
        codes = index.codes
        self.index = index._replace(
            codes=codes._replace(**{f: _on_device(getattr(codes, f), dev)
                                    for f in codes._fields if f != "dim"}),
            sparse_norms=_on_device(index.sparse_norms, dev),
            recon_norms=_on_device(index.recon_norms, dev),
            inv_sparse_norms=_on_device(index.inv_sparse_norms, dev),
            inv_recon_norms=_on_device(index.inv_recon_norms, dev),
        )
        self.k = self.index.codes.k if cfg.k is None else cfg.k
        self._inv_norms = mode_inv_norms(self.index, cfg.mode)

    def encode_queries(self, x: torch.Tensor) -> SparseCodes:
        """Dense (Q, d) embeddings -> fixed-k query codes: the fused-encode
        kernel on the kernel path, ``sae.encode`` on the plain one."""
        if self.params is None:
            raise EngineConfigError("encoding queries requires SAE params")
        if self.use_fused:
            return fused_encode(x, self.params["w_enc"], self.params["b_enc"],
                                self.k, use_kernel=True)
        return sae.encode(self.params, x, self.k)

    def prep_query(self, q: SparseCodes) -> PreppedQuery:
        return prep_query(self.index, q, self.mode, self.params)

    def retrieve_codes(self, q: SparseCodes, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Serve a request whose queries are already compressed codes."""
        n = validate_topn(n, self.index.codes.n)
        validate_query_codes(q, h=self.index.codes.dim)
        q = SparseCodes(q.values.to(self.device, torch.float32),
                        q.indices.to(self.device), q.dim)
        return retrieve_prepped(self.index, self.prep_query(q), n,
                                use_fused=self.use_fused, inv_norms=self._inv_norms,
                                precision=self.precision)

    def retrieve_dense(self, x: torch.Tensor, n: int) -> RetrievalResponse:
        """Dense embeddings (Q?, d) in, a ``RetrievalResponse`` out.

        Every panel is padded with zero rows to a multiple of BLOCK_Q
        (scored and sliced off), so a lone request and a coalesced panel
        of the same bucket compute identically.  ``compute_us`` is host
        dispatch time; device completion is the caller's synchronize.
        """
        t0 = time.monotonic()
        d = None if self.params is None else self.params["w_enc"].shape[0]
        validate_dense_query(x, d=d)
        validate_topn(n, self.index.codes.n)
        squeeze = x.ndim == 1
        xb = (x[None] if squeeze else x).to(self.device, torch.float32)
        rows = xb.shape[0]
        pad = (-rows) % BLOCK_Q
        if pad:
            xb = torch.cat([xb, xb.new_zeros(pad, xb.shape[1])])
        scores, ids = self.retrieve_codes(self.encode_queries(xb), n)
        if pad:
            scores, ids = scores[:rows], ids[:rows]
        if squeeze:
            scores, ids = scores[0], ids[0]
        return RetrievalResponse(
            scores=scores, ids=ids,
            status=ServingStatus(path=path_name(self)),
            queue_us=0.0,
            compute_us=(time.monotonic() - t0) * 1e6,
        )
