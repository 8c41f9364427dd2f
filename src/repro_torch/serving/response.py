"""The serving response surface (twin of ``repro.serving.response``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ServingStatus(NamedTuple):
    """How a request was served.

    path:      name of the serving path that produced the answer.
    step:      rung index (0 = the configured primary path).
    degraded:  True whenever the answer differs from the healthy path's.
    fault:     why serving left the primary path (None when healthy).
    shards_total / shards_used: shard accounting (1/1 unsharded).
    coverage:  fraction of the catalog scored (1.0 = full catalog).
    retries:   shard retry attempts spent before this answer.
    sanitized: count of non-finite query values zeroed at admission.
    deadline_exceeded: the budget ran out.
    """

    path: str
    step: int = 0
    degraded: bool = False
    fault: Optional[str] = None
    shards_total: int = 1
    shards_used: int = 1
    coverage: float = 1.0
    retries: int = 0
    sanitized: int = 0
    deadline_exceeded: bool = False


class RetrievalResponse(NamedTuple):
    """One served request: (Q?, n) scores and ids, the status, and the
    host time spent queued (0 for direct calls) and serving.
    ``compute_us`` of a direct engine call is host dispatch time: CUDA
    work is asynchronous, so device completion is the caller's
    ``torch.cuda.synchronize()``."""

    scores: torch.Tensor
    ids: torch.Tensor
    status: ServingStatus
    queue_us: float = 0.0
    compute_us: float = 0.0

    @property
    def pair(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The ``(scores, ids)`` view."""
        return self.scores, self.ids
