"""Typed engine configuration (twin of ``repro.serving.config``).

``EngineConfig`` keeps every field of the JAX package's config and its
field-space checks.  The port serves sparse mode, a single stage, one
device, from an fp32 ``SparseIndex`` at exact precision or from a
``QuantizedIndex`` at exact or int8 precision.  Any other value of a
field is a typed "not yet ported" error the moment the config exists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.quantized_codes import QuantizedCodes
from repro_torch.core.retrieval import QuantizedIndex, SparseIndex
from repro_torch.errors import EngineConfigError

PRECISIONS = ("exact", "int8")
MODES = ("sparse", "reconstructed")
STAGES = ("single", "two_stage")
STAGE1S = ("auto", "device", "host")


def check_precision(index, precision: str) -> str:
    """Validate a scoring precision against an index format: "exact" for
    every index, "int8" (approximate int8 × int8 scoring) only for a
    ``QuantizedIndex``."""
    if precision not in PRECISIONS:
        raise EngineConfigError(
            f"unknown precision {precision!r} (expected one of {PRECISIONS})")
    if precision == "int8" and not isinstance(index.codes, QuantizedCodes):
        raise EngineConfigError(
            "precision='int8' requires a QuantizedIndex "
            "(build_index(..., quantize=True)); got fp32 codes")
    return precision


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every serving knob of a ``RetrievalEngine``, as one frozen value.

    mode:      "sparse" (direct sparse-space cosine) or "reconstructed".
    use_kernel: "auto" | True | False: the CUDA kernels vs the plain
               PyTorch path ("auto": the kernels on a CUDA device).
    precision: "exact" or "int8".
    stage:     "single" or "two_stage"; stage1, candidate_fraction and
               inverted_cap configure two-stage retrieval.
    mesh / shard_axis: candidate-sharded serving.
    k:         encoder top-k override (defaults to the index's k).
    """

    mode: str = "sparse"
    use_kernel: Any = "auto"
    precision: str = "exact"
    stage: str = "single"
    stage1: str = "auto"
    candidate_fraction: float = 0.25
    inverted_cap: int = 2048
    mesh: Any = None
    shard_axis: str = "cand"
    k: Optional[int] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise EngineConfigError(f"unknown retrieval mode: {self.mode!r}")
        if self.stage not in STAGES:
            raise EngineConfigError(
                f"unknown stage {self.stage!r} (expected 'single' or 'two_stage')")
        if self.stage1 not in STAGE1S:
            raise EngineConfigError(
                f"unknown stage1 {self.stage1!r} "
                "(expected 'auto', 'device' or 'host')")
        if self.precision not in PRECISIONS:
            raise EngineConfigError(
                f"unknown precision {self.precision!r} "
                f"(expected one of {PRECISIONS})")
        if self.stage == "two_stage":
            if self.mesh is not None:
                raise EngineConfigError(
                    "stage='two_stage' does not compose with a mesh")
            if self.mode != "sparse":
                raise EngineConfigError("stage='two_stage' requires mode='sparse'")
            if not 0.0 < self.candidate_fraction <= 1.0:
                raise EngineConfigError(
                    f"candidate_fraction must be in (0, 1]: {self.candidate_fraction}")
        for field, value, served in (("mode", self.mode, "sparse"),
                                     ("stage", self.stage, "single"),
                                     ("mesh", self.mesh, None)):
            if value != served:
                raise EngineConfigError(
                    f"{field}={value!r} is not yet ported (the port serves "
                    "mode='sparse', stage='single', mesh=None)")
        if self.k is not None and self.k < 1:
            raise EngineConfigError(f"k must be >= 1: {self.k}")

    def validate(self, index, params=None) -> None:
        """The checks that need the index and params."""
        if not isinstance(index, (SparseIndex, QuantizedIndex)):
            raise EngineConfigError(
                f"{type(index).__name__} is not yet ported; the port serves a "
                "SparseIndex or a QuantizedIndex (build_index(codes[, quantize=True]))")
        if params is not None and index.codes.dim != params["w_enc"].shape[1]:
            raise EngineConfigError(
                "params/index latent-dim mismatch: w_enc encodes into "
                f"h={params['w_enc'].shape[1]} but the index codes address "
                f"h={index.codes.dim}")
        check_precision(index, self.precision)

    def replace(self, **changes) -> "EngineConfig":
        """A modified copy (frozen dataclasses are immutable)."""
        return dataclasses.replace(self, **changes)
