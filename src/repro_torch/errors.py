"""Typed serving/retrieval errors, the same hierarchy as ``repro.errors``.

Every failure the serving stack can name derives from ``RetrievalError``.
Validation errors also subclass ``ValueError`` and the deadline error
``TimeoutError``, so callers matching the standard-library taxonomy keep
working.  The class names match the JAX package's, so a caller can
handle both packages' errors by name.
"""
from __future__ import annotations

from typing import Optional


class RetrievalError(Exception):
    """Base of every typed failure raised by the serving stack."""


class EngineConfigError(RetrievalError, ValueError):
    """Engine/request construction is invalid (bad mode, precision,
    missing params/norms, or a configuration the port does not serve yet)."""


class InvalidQueryError(RetrievalError, ValueError):
    """A request failed admission: wrong shape/dtype or an unservable
    top-n.  Messages name the offending argument and the expected vs
    actual value."""


class InvalidCodesError(RetrievalError, ValueError):
    """Sparse codes are structurally invalid for the operation, e.g. a
    code index outside ``[0, h)``."""


class IndexIntegrityError(RetrievalError):
    """Index content does not match its build-time checksum."""


class SegmentMutationError(RetrievalError, ValueError):
    """A segmented-index lifecycle op is invalid."""


class DeadlineExceededError(RetrievalError, TimeoutError):
    """The per-request deadline budget ran out at the recorded stage."""


class QueueFullError(RetrievalError):
    """The microbatching front shed this request at admission."""

    def __init__(self, message: str, *, queued_rows: int = 0,
                 max_queue_rows: int = 0):
        super().__init__(message)
        self.queued_rows = queued_rows
        self.max_queue_rows = max_queue_rows


class ShardFailureError(RetrievalError):
    """A candidate shard failed to answer (``shard``: its position)."""

    def __init__(self, message: str, shard: Optional[int] = None):
        super().__init__(message)
        self.shard = shard


class KernelFaultError(RetrievalError):
    """The kernel serving path raised."""


class SelfCheckError(RetrievalError):
    """The startup self-check's canary batch failed."""


class DegradationExhaustedError(RetrievalError):
    """Every rung of the degradation ladder failed for one request."""
