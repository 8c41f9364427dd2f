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
                                     (5000, 768, 4096, 32), (5, 40, 256, 256),
                                     (64, 768, 4096, 128),     # the 4k auxiliary sparsity
                                     (37, 96, 1000, 32),       # ragged h
                                     (64, 768, 49_152, 32),    # 192 tiles a row
                                     (37, 64, 40_000, 130),    # k above the tile width
                                     (3, 32, 70_000, 8)])      # two merge passes
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


def _codes(dev, n_cand, k, h, lat, seed):
    """Random (n_cand, k) codes over `lat` latents of [0, h), with the last
    20 rows duplicates of the first 20 and rows 32,764.. duplicates of
    rows 0.. (ties across the end of the bar's prefix)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cv = torch.randn(n_cand, k, device=dev, generator=g)
    ci = lat[torch.randint(0, lat.numel(), (n_cand, k), device=dev, generator=g)].to(torch.int32)
    cv[-20:], ci[-20:] = cv[:20], ci[:20]
    if n_cand > 32_772:
        cv[32_764:32_772], ci[32_764:32_772] = cv[:8], ci[:8]
    return cv, ci, g


def _queries(dev, g, q, kq, lat, cv, ci):
    qv = torch.randn(q, kq, device=dev, generator=g)
    qi = lat[torch.randint(0, lat.numel(), (q, kq), device=dev, generator=g)].to(torch.int32)
    qi[:, 1] = qi[:, 0]                                    # duplicate query indices
    m = min(q, 4)
    qv[:m], qi[:m] = cv[:m, :kq], ci[:m, :kq]              # queries equal to rows 0..
    return qv.contiguous(), qi.contiguous()


def _retrieve(fmt, index, qv, qi, h, n, kernel):
    from repro_torch.kernels.sparse_dot import kernel as kern
    from repro_torch.kernels.sparse_dot import ref

    c = index.codes
    if fmt == "fp32":
        fn = kern.fused_retrieve_sparse_q_cuda if kernel else ref.retrieve_sparse_q_ref
        cand = (c.values, c.indices, index.inv_sparse_norms)
    else:
        fn = {("quantized", True): kern.fused_retrieve_quantized_sparse_q_cuda,
              ("quantized", False): ref.retrieve_quantized_sparse_q_ref,
              ("int8", True): kern.fused_retrieve_quantized_mxu_sparse_q_cuda,
              ("int8", False): ref.retrieve_quantized_mxu_sparse_q_ref}[fmt, kernel]
        cand = (c.q_values, c.indices, c.scales, index.inv_sparse_norms)
    return fn(*cand, qv, qi, h, n) if kernel else fn(*cand, qv, qi, h, n=n)


def _check(fmt, index, qv, qi, h, n):
    ks, kid = _retrieve(fmt, index, qv, qi, h, n, True)
    ps, pid = _retrieve(fmt, index, qv, qi, h, n, False)
    torch.cuda.synchronize()
    assert torch.equal(kid, pid)
    assert torch.equal(ks, ps)
    return ks, kid


@pytest.mark.parametrize("fmt", ["quantized", "int8"])
@pytest.mark.parametrize("n_cand,q,n,k,kq", [
    (200_003, 77, 32, 32, 32),                  # two query panels, the prefix pass
    (5000, 9, 32, 30, 7),                       # 4-byte code loads, kq != k
    (1000, 13, 16, 32, 32),
])
def test_quantized_kernels_match_plain(dev, fmt, n_cand, q, n, k, kq):
    from repro_torch.core.retrieval import build_index
    from repro_torch.core.types import SparseCodes

    h = 4096
    lat = torch.arange(256, device=dev)
    cv, ci, g = _codes(dev, n_cand, k, h, lat, n_cand)
    index = build_index(SparseCodes(cv, ci, h), quantize=True)
    qv, qi = _queries(dev, g, q, kq, lat, cv, ci)
    _, kid = _check(fmt, index, qv, qi, h, n)
    if fmt == "quantized" and n_cand > 32_772:           # duplicates tie to the lowest id
        assert kid[:4, :3].tolist() == [[r, 32_764 + r, n_cand - 20 + r] for r in range(4)]


def test_quantized_kernel_is_the_fp32_kernel_over_the_dequantized_index(dev):
    from repro_torch.core.retrieval import build_index, dequantize_index
    from repro_torch.core.types import SparseCodes

    h = 4096
    lat = torch.arange(256, device=dev)
    cv, ci, g = _codes(dev, 200_003, 32, h, lat, 7)
    index = build_index(SparseCodes(cv, ci, h), quantize=True)
    qv, qi = _queries(dev, g, 64, 32, lat, cv, ci)
    qs, qid = _retrieve("quantized", index, qv, qi, h, 32, True)
    fs, fid = _retrieve("fp32", dequantize_index(index), qv, qi, h, 32, True)
    assert torch.equal(qid, fid) and torch.equal(qs, fs)


@pytest.mark.parametrize("fmt", ["fp32", "quantized", "int8"])
@pytest.mark.parametrize("h,q,n", [(49_152, 9, 1000),   # int16 wrap, n = 1000
                                   (49_152, 64, 32),
                                   (70_000, 13, 32),    # int32 indices
                                   (70_000, 64, 32)])   # seg in device memory
def test_retrieve_kernels_at_wide_h(dev, fmt, h, q, n):
    from repro_torch.core.retrieval import build_index
    from repro_torch.core.types import SparseCodes

    lat = torch.arange(h - 3000, h, device=dev)         # latents above 32,767
    cv, ci, g = _codes(dev, 60_001, 32, h, lat, h + q)
    codes = SparseCodes(cv, ci, h)
    index = build_index(codes, quantize=fmt != "fp32")
    if fmt != "fp32":
        assert index.codes.indices.dtype == (torch.int16 if h < 65536 else torch.int32)
    qv, qi = _queries(dev, g, q, 32, lat, cv, ci)
    _check(fmt, index, qv, qi, h, n)


@pytest.mark.parametrize("fmt", ["fp32", "quantized", "int8"])
@pytest.mark.parametrize("n_cand,q,n", [(200_003, 64, 257), (200_003, 13, 1000),
                                        (1237, 13, 1237), (1237, 64, 1237)])
def test_retrieve_kernel_serves_any_n(dev, fmt, n_cand, q, n):
    """Any n <= N: the kernel equals the plain version at n = 257 and
    1000, and at n = N for a small ragged N, with the running lists in
    shared and in device memory."""
    from repro_torch.core.retrieval import build_index
    from repro_torch.core.types import SparseCodes

    h = 4096
    lat = torch.arange(256, device=dev)
    cv, ci, g = _codes(dev, n_cand, 32, h, lat, n + q)
    index = build_index(SparseCodes(cv, ci, h), quantize=fmt != "fp32")
    qv, qi = _queries(dev, g, q, 32, lat, cv, ci)
    _, kid = _check(fmt, index, qv, qi, h, n)
    if n == n_cand:
        assert (kid.sort(dim=1).values == torch.arange(n, device=dev)).all()


@pytest.mark.parametrize("fmt", ["fp32", "quantized", "int8"])
def test_nan_queries_rank_as_on_the_plain_path(dev, fmt):
    """A NaN query row and a row with one NaN: the encode kernel selects
    latents 0..k-1 as the plain encoder does, and the retrieve kernel gives
    the plain retrieve's ids and scores on the same codes (NaN above every
    number, lowest id first)."""
    from repro_torch.core.retrieval import build_index
    from repro_torch.core.sae import init_params
    from repro_torch.core.types import SAEConfig
    from repro_torch.data.synthetic import clustered_embeddings
    from repro_torch.kernels.fused_encode import fused_encode_chunked
    from repro_torch.serving import EngineConfig, RetrievalEngine

    cfg = SAEConfig()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    catalog = clustered_embeddings(torch.Generator(device=dev).manual_seed(0), 20_000)
    codes = fused_encode_chunked(catalog, params["w_enc"], params["b_enc"], cfg.k)
    precision = "int8" if fmt == "int8" else "exact"
    index = build_index(codes, quantize=fmt != "fp32")
    fast = RetrievalEngine(index, params, config=EngineConfig(precision=precision), device=dev)
    plain = RetrievalEngine(index, params, config=EngineConfig(precision=precision,
                                                               use_kernel=False), device=dev)
    q = clustered_embeddings(torch.Generator(device=dev).manual_seed(5), 16)
    q[0] = float("nan")
    q[1, 3] = float("nan")
    kc, pc = fast.encode_queries(q), plain.encode_queries(q)
    assert torch.equal(kc.indices[:2], pc.indices[:2])
    assert kc.indices[:2].tolist() == [list(range(cfg.k))] * 2
    assert torch.isnan(kc.values[:2]).all()
    got, want = fast.retrieve_codes(kc, 32), plain.retrieve_codes(kc, 32)
    assert torch.equal(got[1], want[1])
    assert torch.isnan(got[0][:2]).all()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
    served = fast.retrieve_dense(q, 32)
    assert torch.equal(served.ids[:2], got[1][:2])


@pytest.mark.parametrize("fmt", ["quantized", "int8"])
def test_engine_serves_a_quantized_index_through_its_kernels(dev, fmt):
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
    codes = fused_encode_chunked(catalog, params["w_enc"], params["b_enc"], cfg.k)
    precision = "int8" if fmt == "int8" else "exact"
    fast = RetrievalEngine(build_index(codes, quantize=True), params,
                           config=EngineConfig(precision=precision), device=dev)
    plain = RetrievalEngine(fast.index, params, config=EngineConfig(
        precision=precision, use_kernel=False), device=dev)
    q = clustered_embeddings(torch.Generator(device=dev).manual_seed(5), 21)
    reset_launch_counts()
    got = fast.retrieve_dense(q, 32)
    name = ("fused_retrieve_quantized_mxu_sparse_q" if fmt == "int8"
            else "fused_retrieve_quantized_sparse_q")
    counts = launch_counts()
    assert counts.pop("fused_encode") == 1 and counts.pop(name) == 1
    assert set(counts.values()) == {0}
    assert got.status.path == f"{fmt}-kernel"
    want_s, want_i = plain.retrieve_codes(fast.encode_queries(q), 32)
    assert torch.equal(got.ids, want_i[:21]) and torch.equal(got.scores, want_s[:21])


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
    assert launch_counts() == {"fused_encode": 4, "fused_retrieve_sparse_q": 1,
                               "fused_retrieve_quantized_sparse_q": 0,
                               "fused_retrieve_quantized_mxu_sparse_q": 0}
    assert got.status.path == "fp32-kernel"
    want_s, want_i = plain.retrieve_codes(fast.encode_queries(q), 32)
    assert torch.equal(got.ids, want_i) and torch.equal(got.scores, want_s)
