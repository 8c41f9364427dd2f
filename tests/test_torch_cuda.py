"""The port's CUDA kernels held against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips, with its reason, where there is no
card (decided inside the fixture, never at import).  On a machine with a
card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Encoder indices are compared where the float64 gap rule of
``_torch_parity`` leaves no room for rounding to reorder them; the
retrieve kernel sums in the plain version's order, so its ids and scores
must be identical.
"""
import numpy as np
import pytest
import torch

from _torch_parity import encode_clear, sae_params, tie_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from repro_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("b,d,h,k", [(37, 96, 512, 16), (64, 768, 4096, 32),
                                     (5000, 768, 4096, 32), (5, 40, 256, 256)])
def test_encode_kernel_matches_plain(dev, b, d, h, k):
    from repro_torch.core.sae import normalize_input
    from repro_torch.kernels.fused_encode.kernel import fused_encode_cuda
    from repro_torch.kernels.fused_encode.ref import fused_encode_ref

    params = sae_params(d, h, seed=b, bias=0.01)
    x = np.random.default_rng(b).standard_normal((b, d)).astype(np.float32)
    clear = torch.tensor(encode_clear(x, params["w_enc"], params["b_enc"], k), device=dev)
    xn = normalize_input(torch.tensor(x, device=dev))
    w = torch.tensor(params["w_enc"], device=dev)
    bias = torch.tensor(params["b_enc"], device=dev)
    kv, ki = fused_encode_cuda(xn, w, bias, k)
    pv, pi = fused_encode_ref(xn, w, bias, k)
    assert clear.any()
    assert torch.equal(ki[clear], pi[clear])
    torch.testing.assert_close(kv[clear], pv[clear], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows", [77, 5000])
def test_encode_kernel_exact_ties(dev, rows):
    from repro_torch.core.sae import normalize_input
    from repro_torch.kernels.fused_encode.kernel import fused_encode_cuda
    from repro_torch.kernels.fused_encode.ref import fused_encode_ref

    x, w, b = tie_inputs(np.random.default_rng(0), rows, 768, 4096)
    args = (normalize_input(torch.tensor(x, device=dev)), torch.tensor(w, device=dev),
            torch.tensor(b, device=dev))
    kv, ki = fused_encode_cuda(*args, 32)
    pv, pi = fused_encode_ref(*args, 32)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("n_cand,q,n,k,kq", [
    (1000, 13, 16, 32, 32), (70_001, 64, 32, 32, 32), (300, 3, 256, 32, 32),
    (200_003, 77, 32, 32, 32),                  # two query panels, the prefix pass
    (5000, 9, 32, 30, 7),                       # 4-byte code loads, kq != k
])
def test_retrieve_kernel_matches_plain(dev, n_cand, q, n, k, kq):
    from repro_torch.core.retrieval import build_index
    from repro_torch.core.types import SparseCodes
    from repro_torch.kernels.sparse_dot.kernel import fused_retrieve_sparse_q_cuda
    from repro_torch.kernels.sparse_dot.ref import retrieve_sparse_q_ref

    h = 4096
    g = torch.Generator(device=dev).manual_seed(n_cand)
    cv = torch.randn(n_cand, k, device=dev, generator=g)
    ci = torch.randint(0, 256, (n_cand, k), device=dev, generator=g, dtype=torch.int32)
    cv[-20:], ci[-20:] = cv[:20], ci[:20]                  # duplicate rows
    idx = build_index(SparseCodes(cv, ci, h))
    qv = torch.randn(q, kq, device=dev, generator=g)
    qi = torch.randint(0, 256, (q, kq), device=dev, generator=g, dtype=torch.int32)
    qi[:, 1] = qi[:, 0]                                    # duplicate query indices
    args = (idx.codes.values, idx.codes.indices, idx.inv_sparse_norms, qv, qi, h)
    ks, kid = fused_retrieve_sparse_q_cuda(*args, n)
    ps, pid = retrieve_sparse_q_ref(*args, n=n)
    assert torch.equal(kid, pid)
    assert torch.equal(ks, ps)


def test_retrieve_kernel_refuses_n_above_cap(dev):
    from repro_torch.kernels.sparse_dot.kernel import fused_retrieve_sparse_q_cuda

    vals = torch.ones(500, 4, device=dev)
    idx = torch.zeros(500, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="top-n 257"):
        fused_retrieve_sparse_q_cuda(vals, idx, torch.ones(500, device=dev),
                                     vals[:2], idx[:2], 256, 257)


def test_engine_serves_through_both_kernels(dev):
    from repro_torch.core.retrieval import build_index
    from repro_torch.core.sae import init_params
    from repro_torch.core.types import SAEConfig
    from repro_torch.data.synthetic import clustered_embeddings
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_encode import fused_encode_chunked
    from repro_torch.serving import EngineConfig, RetrievalEngine

    cfg = SAEConfig()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    catalog = clustered_embeddings(torch.Generator(device=dev).manual_seed(0), 20_000)
    reset_launch_counts()
    codes = fused_encode_chunked(catalog, params["w_enc"], params["b_enc"], cfg.k,
                                 chunk=8192)
    fast = RetrievalEngine(build_index(codes), params, device=dev)
    plain = RetrievalEngine(fast.index, params, config=EngineConfig(use_kernel=False),
                            device=dev)
    q = clustered_embeddings(torch.Generator(device=dev).manual_seed(5), 21)
    got = fast.retrieve_dense(q, 32)
    assert launch_counts() == {"fused_encode": 4, "fused_retrieve_sparse_q": 1}
    assert got.status.path == "fp32-kernel"
    want_s, want_i = plain.retrieve_codes(fast.encode_queries(q), 32)
    assert torch.equal(got.ids, want_i) and torch.equal(got.scores, want_s)
