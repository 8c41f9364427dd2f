"""Device resolution for every entry point of the port.

Entry points take an explicit ``device`` and default to ``"cuda"``.  A
CUDA device that is not there is an error, never a silent move to the
CPU.  Setting up a CUDA device also turns TF32 off for matrix products
and convolutions: TF32 rounding moves near-tied encoder pre-activations,
and abs-top-k would then keep other latents than the fp32 reference.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` ("cuda", "cuda:1", "cpu" or a ``torch.device``) as a
    checked ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (expected cuda or cpu)")
    return dev
