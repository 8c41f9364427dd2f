"""Package rules of the PyTorch/CUDA port ``repro_torch``.

It imports neither JAX nor the JAX package ``repro``; importing it builds
nothing; a CUDA device that is missing is an error, never a move to the
CPU; and a kernel is never asked for on CPU tensors.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_importing_every_module_loads_no_jax_and_runs_no_compiler():
    """In a fresh interpreter, with process creation made to fail, import
    every module of the port: no JAX, no ``repro``, no nvcc, no library."""
    script = f"""
import importlib, pkgutil, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess was started during import")
subprocess.Popen = refuse
sys.path.insert(0, {str(REPO / 'src')!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import _build
assert not _build._LIBS, _build._LIBS
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so cuda does not raise")
    from repro_torch.core.sae import params_from_numpy
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        params_from_numpy({"w_enc": [[1.0]], "b_enc": [0.0], "w_dec": [[1.0]]})
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--catalog", "100", "--requests", "2"])


def test_kernels_refuse_cpu_tensors():
    from repro_torch.errors import EngineConfigError
    from repro_torch.kernels.fused_encode import fused_encode
    from repro_torch.kernels.fused_encode.kernel import fused_encode_cuda
    from repro_torch.kernels.sparse_dot import fused_retrieve_sparse_q
    from repro_torch.kernels.sparse_dot.kernel import fused_retrieve_sparse_q_cuda

    x, w, b = torch.ones(4, 8), torch.ones(8, 256), torch.zeros(256)
    with pytest.raises(EngineConfigError, match="needs a CUDA device"):
        fused_encode(x, w, b, 4, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_encode_cuda(x, w, b, 4)
    vals, idx = torch.ones(10, 4), torch.zeros(10, 4, dtype=torch.int32)
    inv = torch.ones(10)
    with pytest.raises(EngineConfigError, match="needs a CUDA device"):
        fused_retrieve_sparse_q(vals, idx, inv, vals[:2], idx[:2], 256, n=3, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_retrieve_sparse_q_cuda(vals, idx, inv, vals[:2], idx[:2], 256, 3)
    # "auto" on CPU tensors is the plain version, not an error
    s, i = fused_retrieve_sparse_q(vals, idx, inv, vals[:2], idx[:2], 256, n=3)
    assert i.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_kernel_sizing_rules():
    from repro_torch.kernels.fused_encode.kernel import tile_width
    from repro_torch.kernels.sparse_dot.kernel import Plan, num_splits, plan

    assert tile_width(64, 4096, 132) == 128              # a request: 16-row tiles
    assert tile_width(65536, 4096, 132) == 256           # a catalog chunk: 64-row
    assert tile_width(64, 1000, 132) == 128              # ragged h
    assert tile_width(20000, 49152, 132) == 256

    # bq rows a block; the running lists, then the h + 1 segment starts,
    # in shared memory where they fit beside the tile sums and entries
    assert plan(64, 4096, 32, 32) == Plan(64, True, True)      # a request
    assert plan(13, 4096, 32, 32) == Plan(13, True, True)
    assert plan(64, 4096, 256, 32) == Plan(64, True, True)
    assert plan(64, 4096, 1000, 32) == Plan(64, False, True)   # any n: lists in memory
    assert plan(64, 49152, 32, 32) == Plan(64, True, True)
    assert plan(64, 70000, 32, 32) == Plan(64, True, False)    # wide h: seg in memory
    assert plan(13, 70000, 32, 32) == Plan(13, True, True)
    assert plan(64, 70000, 1000, 32) == Plan(64, False, True)
    assert plan(1, 4096, 20000, 32) == Plan(1, True, True)
    assert plan(64, 4096, 32, 2048) == Plan(13, False, False)  # wide query codes
    with pytest.raises(ValueError, match="shared memory"):
        plan(64, 4096, 32, 30000)
    assert num_splits(1 << 20, 64, 64, 132, 32) == 264   # 1 panel x 264 = 264 blocks
    assert num_splits(1000, 13, 13, 132, 16) == 4        # one split per 256-row tile
    assert num_splits(10 ** 9, 4096, 64, 132, 32) == 5
    assert num_splits(200_003, 64, 64, 132, 1000) == 200  # S * n stays within N
    assert num_splits(200_003, 64, 64, 132, 200_003) == 1


def test_build_paths_stay_in_the_repo():
    from repro_torch.kernels import _build

    assert _build.BUILD_DIR == REPO / "build"
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == sorted(
        f"{name}.cu" for name in _build.EXTRA_FLAGS)
    assert "-fmad=false" in _build.EXTRA_FLAGS["sparse_dot"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS


def test_quantized_kernels_refuse_cpu_tensors():
    from repro_torch.errors import EngineConfigError
    from repro_torch.kernels.sparse_dot import (
        fused_retrieve_quantized_mxu_sparse_q, fused_retrieve_quantized_sparse_q,
    )
    from repro_torch.kernels.sparse_dot.kernel import (
        fused_retrieve_quantized_mxu_sparse_q_cuda, fused_retrieve_quantized_sparse_q_cuda,
    )

    q8, idx = torch.ones(10, 4, dtype=torch.int8), torch.zeros(10, 4, dtype=torch.int16)
    scales, inv = torch.ones(10), torch.ones(10)
    qv, qi = torch.ones(2, 4), torch.zeros(2, 4, dtype=torch.int32)
    for ops_fn, cuda_fn in ((fused_retrieve_quantized_sparse_q,
                             fused_retrieve_quantized_sparse_q_cuda),
                            (fused_retrieve_quantized_mxu_sparse_q,
                             fused_retrieve_quantized_mxu_sparse_q_cuda)):
        with pytest.raises(EngineConfigError, match="needs a CUDA device"):
            ops_fn(q8, idx, scales, inv, qv, qi, 256, n=3, use_kernel=True)
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_fn(q8, idx, scales, inv, qv, qi, 256, 3)
        s, i = ops_fn(q8, idx, scales, inv, qv, qi, 256, n=3)   # "auto" on the CPU: plain
        assert i.tolist() == [[0, 1, 2], [0, 1, 2]]
        with pytest.raises(ValueError, match="exceeds candidate count"):
            ops_fn(q8, idx, scales, inv, qv, qi, 256, n=11)
