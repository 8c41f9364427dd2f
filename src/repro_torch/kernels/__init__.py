"""Hand-written CUDA kernels of the port, each beside its plain version.

Every kernel wrapper counts its launches, so a run can show that its main
path went through the kernels: ``reset_launch_counts()`` before the run,
``launch_counts()`` after.
"""
from repro_torch.kernels.fused_encode import kernel as _fused_encode
from repro_torch.kernels.sparse_dot import kernel as _sparse_dot


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {"fused_encode": _fused_encode.launches, **_sparse_dot.launches}


def reset_launch_counts() -> None:
    _fused_encode.launches = 0
    for name in _sparse_dot.launches:
        _sparse_dot.launches[name] = 0
