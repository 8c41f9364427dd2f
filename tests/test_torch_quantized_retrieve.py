"""The port's quantized retrieves (plain PyTorch, on the CPU) and its engine
over a ``QuantizedIndex``, held against the JAX package on the same index.

The JAX retrieves run as its own tests run them: the Pallas kernels in
interpret mode (``ops.fused_retrieve_quantized[_mxu]_sparse_q``) and the
jnp references.  Exact path: ids exactly equal, scores rtol 1e-6 (the JAX
references sum a candidate's products with ``jnp.sum``), and bit-identical
to the port's fp32 retrieve over the dequantized index.  Int8 path: the
quantized query panel, its scales and the int32 accumulators exactly
equal; ids exactly equal; scores rtol 1e-6.  The int8 scores are not
bit-identical to JAX's: the port rounds (f32(acc) · q_scale) · (scale ·
1/‖c‖) in that order, as the JAX code is written, and XLA on the CPU
orders those multiplies otherwise (one ulp apart on about 14% of the
scores of this input).  Queries are drawn
in bulk and kept by the float64 gap rules of ``_torch_parity``; the exact
ties of duplicate catalog rows are kept on purpose.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import encode_clear, retrieve_clear, sae_params, sparse_scores64
from repro.core import quantized_codes as jq
from repro.core import sae as jsae
from repro.core.retrieval import build_index as j_build_index
from repro.core.types import SAEConfig as JSAEConfig
from repro.core.types import SparseCodes as JSparseCodes
from repro.kernels.sparse_dot import kernel as jkernel
from repro.kernels.sparse_dot import ref as jref
from repro.kernels.sparse_dot.ops import fused_retrieve_quantized_mxu_sparse_q as j_mxu_kernel
from repro.kernels.sparse_dot.ops import fused_retrieve_quantized_sparse_q as j_q_kernel
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import RetrievalEngine as JRetrievalEngine
from repro_torch.core import sae as tsae
from repro_torch.core.eval import retrieval_quality
from repro_torch.core.quantized_codes import QuantizedCodes, dequantize_codes, quantize_codes
from repro_torch.core.retrieval import QuantizedIndex, build_index, dequantize_index
from repro_torch.core.types import SAEConfig, SparseCodes
from repro_torch.data.synthetic import clustered_embeddings
from repro_torch.errors import EngineConfigError
from repro_torch.kernels.sparse_dot import (
    fused_retrieve_quantized_mxu_sparse_q, fused_retrieve_quantized_sparse_q,
    retrieve_sparse_q_ref,
)
from repro_torch.kernels.sparse_dot.ref import (
    int8_accumulators, quantized_query_panel, retrieve_quantized_mxu_sparse_q_ref,
    retrieve_quantized_sparse_q_ref,
)
from repro_torch.serving import EngineConfig, RetrievalEngine
from repro_torch.serving.engine import path_name

N, Q, D, H, K, NTOP = 2000, 13, 96, 512, 32, 16
DUP_SRC, DUP_DST = slice(0, 40), slice(1200, 1240)


def _int8_scores64(qi8, qs, cand_q, cand_i, scales, inv):
    """(Q, N) float64 int8-path scores from the exact int32 sums."""
    acc = int8_accumulators(torch.tensor(cand_q), torch.tensor(cand_i),
                            torch.tensor(qi8)).numpy().astype(np.float64)
    return acc * qs.astype(np.float64)[:, None] * (scales.astype(np.float64) * inv)[None]


@pytest.fixture(scope="module")
def case():
    """JAX's own codes of a numpy catalog with 40 duplicated rows, its
    quantized index, and queries that pass the gap rule on both the exact
    (dequantized) and the int8 scores."""
    params = sae_params(D, H, seed=0, bias=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    c = jsae.encode(jp, jnp.asarray(x), K)
    cv, ci = np.array(c.values), np.array(c.indices)
    cv[DUP_DST], ci[DUP_DST] = cv[DUP_SRC], ci[DUP_SRC]
    jidx = j_build_index(JSparseCodes(jnp.asarray(cv), jnp.asarray(ci), H), quantize=True)
    qc = jidx.codes
    cq, cidx, cs = (np.asarray(qc.q_values), np.asarray(qc.indices), np.asarray(qc.scales))
    inv = np.asarray(jidx.inv_sparse_norms)
    dv = np.asarray(jq.dequantize_codes(qc).values)
    pool_x = np.random.default_rng(6).standard_normal((6 * Q, D)).astype(np.float32)
    pc = jsae.encode(jp, jnp.asarray(pool_x), K)
    pv, pi = np.array(pc.values), np.array(pc.indices)
    pv[:6], pi[:6] = dv[:6], ci[:6]              # queries equal to duplicated rows
    pi[6:12, 1] = pi[6:12, 0]                    # duplicate query indices
    exact_ok = retrieve_clear(sparse_scores64(dv, ci, pv, pi, H), NTOP)
    qi8, qs = quantized_query_panel(torch.tensor(pv), torch.tensor(pi), H)
    int8_ok = retrieve_clear(_int8_scores64(qi8.numpy(), qs.numpy(), cq, cidx, cs, inv), NTOP)
    keep = exact_ok & int8_ok
    assert keep[:12].all(), "the designed queries must pass the gap rules"
    qv, qidx = pv[keep][:Q], pi[keep][:Q]
    assert qv.shape[0] == Q
    return jidx, (cq, cidx, cs, inv), qv, qidx


def _port_index(jidx) -> QuantizedIndex:
    """The JAX quantized index's arrays as the port's ``QuantizedIndex``."""
    def t(a):
        return torch.tensor(np.asarray(a))

    c = jidx.codes
    return QuantizedIndex(
        codes=QuantizedCodes(t(c.q_values), t(c.indices), t(c.scales), c.dim),
        sparse_norms=t(jidx.sparse_norms), recon_norms=None,
        inv_sparse_norms=t(jidx.inv_sparse_norms), checksum=jidx.checksum)


@pytest.mark.parametrize("which", ["jax_kernel", "jax_ref"])
def test_quantized_retrieve_matches_jax(case, which):
    _, (cq, cidx, cs, inv), qv, qi = case
    got_s, got_i = fused_retrieve_quantized_sparse_q(
        *(torch.tensor(a) for a in (cq, cidx, cs, inv, qv, qi)), H, n=NTOP)
    jfn = j_q_kernel if which == "jax_kernel" else jref.retrieve_quantized_sparse_q_ref
    want_s, want_i = jfn(*(jnp.asarray(a) for a in (cq, cidx, cs, inv, qv, qi)), H, n=NTOP)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
    assert got_i[:6, 0].tolist() == list(range(6))              # the lowest duplicate first
    assert got_i[:6, 1].tolist() == list(range(1200, 1206))


def test_quantized_retrieve_is_the_fp32_retrieve_of_the_dequantized_index(case):
    jidx, (cq, cidx, cs, inv), qv, qi = case
    idx = _port_index(jidx)
    twin = dequantize_index(idx)
    args = (torch.tensor(qv), torch.tensor(qi), H)
    q_s, q_i = retrieve_quantized_sparse_q_ref(
        idx.codes.q_values, idx.codes.indices, idx.codes.scales, idx.inv_sparse_norms,
        *args, n=NTOP, block_n=301, q_chunk=5)
    f_s, f_i = retrieve_sparse_q_ref(twin.codes.values, twin.codes.indices,
                                     twin.inv_sparse_norms, *args, n=NTOP)
    assert torch.equal(q_i, f_i) and torch.equal(q_s, f_s)


def test_int8_panel_and_accumulators_match_jax(case):
    _, (cq, cidx, cs, inv), qv, qi = case
    qi8, qs = quantized_query_panel(torch.tensor(qv), torch.tensor(qi), H)
    j_panel = jref._densify_rows(jnp.asarray(qv), jnp.asarray(qi), H)
    j_qi8, j_qs = jref._quantize_panel(j_panel)
    np.testing.assert_array_equal(qi8.numpy(), np.asarray(j_qi8))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(j_qs)[:, 0])
    got = int8_accumulators(torch.tensor(cq), torch.tensor(cidx), qi8)
    want = jkernel._score_tile_int8(jnp.asarray(cq), jref._widen_idx(jnp.asarray(cidx)), j_qi8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["jax_kernel", "jax_ref"])
def test_int8_retrieve_matches_jax(case, which):
    _, (cq, cidx, cs, inv), qv, qi = case
    got_s, got_i = fused_retrieve_quantized_mxu_sparse_q(
        *(torch.tensor(a) for a in (cq, cidx, cs, inv, qv, qi)), H, n=NTOP)
    jfn = j_mxu_kernel if which == "jax_kernel" else jref.retrieve_quantized_mxu_sparse_q_ref
    want_s, want_i = jfn(*(jnp.asarray(a) for a in (cq, cidx, cs, inv, qv, qi)), H, n=NTOP)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)


def test_int8_ref_is_exact_across_chunk_edges(case):
    """Small candidate blocks and query chunks give the same bits."""
    _, (cq, cidx, cs, inv), qv, qi = case
    args = [torch.tensor(a) for a in (cq, cidx, cs, inv, qv, qi)]
    s0, i0 = retrieve_quantized_mxu_sparse_q_ref(*args, H, n=NTOP)
    s1, i1 = retrieve_quantized_mxu_sparse_q_ref(*args, H, n=NTOP, block_n=301, q_chunk=4)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


def test_int16_wrap_retrieve_matches_jax():
    """h = 49,152: indices above 32,767 are stored wrapped in int16."""
    h, n_cand, nq = 49_152, 1500, 9
    rng = np.random.default_rng(11)
    ci = np.stack([rng.choice(np.arange(30_000, 40_000), K, replace=False)
                   for _ in range(n_cand)]).astype(np.int32)
    cv = rng.standard_normal((n_cand, K)).astype(np.float32)
    q = quantize_codes(SparseCodes(torch.tensor(cv), torch.tensor(ci), h))
    assert q.indices.dtype == torch.int16 and int(q.indices.min()) < 0
    dv = dequantize_codes(q).values.numpy()
    inv = (1.0 / np.maximum(np.linalg.norm(dv, axis=-1), 1e-8)).astype(np.float32)
    pi = np.stack([rng.choice(np.arange(30_000, 40_000), K, replace=False)
                   for _ in range(8 * nq)]).astype(np.int32)
    pi[:, :4] = ci[:8 * nq, :4]                  # overlap with some candidates
    pv = rng.standard_normal((8 * nq, K)).astype(np.float32)
    keep = retrieve_clear(sparse_scores64(dv, ci, pv, pi, h), NTOP)
    qv, qidx = pv[keep][:nq], pi[keep][:nq]
    assert qv.shape[0] == nq
    cand = (q.q_values, q.indices, q.scales, torch.tensor(inv))
    got_s, got_i = retrieve_quantized_sparse_q_ref(*cand, torch.tensor(qv),
                                                   torch.tensor(qidx), h, n=NTOP)
    want_s, want_i = jref.retrieve_quantized_sparse_q_ref(
        *(jnp.asarray(a.numpy()) for a in cand), jnp.asarray(qv), jnp.asarray(qidx), h, n=NTOP)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
    got8 = int8_accumulators(q.q_values, q.indices,
                             quantized_query_panel(torch.tensor(qv), torch.tensor(qidx), h)[0])
    j_qi8, _ = jref._quantize_panel(jref._densify_rows(jnp.asarray(qv), jnp.asarray(qidx), h))
    want8 = jkernel._score_tile_int8(jnp.asarray(q.q_values.numpy()),
                                     jref._widen_idx(jnp.asarray(q.indices.numpy())), j_qi8)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))


@pytest.fixture(scope="module")
def engine_case():
    """Params, a catalog whose JAX codes form both packages' quantized
    index, and dense queries that pass the encoder gap rule and, through
    JAX's codes, the exact and int8 retrieval gap rules."""
    jp = jsae.init_params(JSAEConfig(d=D, h=H, k=K), jax.random.PRNGKey(0))
    params = {key: np.asarray(val) for key, val in jp.items()}
    rng = np.random.default_rng(8)
    catalog = rng.standard_normal((N, D)).astype(np.float32)
    catalog[1500:1520] = catalog[100:120]                # duplicate items: exact ties
    jcodes = jsae.encode(jp, jnp.asarray(catalog), K)
    jidx = j_build_index(jcodes, quantize=True)
    qc = jidx.codes
    cq, cidx, cs = (np.asarray(qc.q_values), np.asarray(qc.indices), np.asarray(qc.scales))
    inv = np.asarray(jidx.inv_sparse_norms)
    dv = np.asarray(jq.dequantize_codes(qc).values)
    qpool = rng.standard_normal((10 * Q, D)).astype(np.float32)
    qpool[:4] = catalog[100:104]
    qpool = qpool[encode_clear(qpool, params["w_enc"], params["b_enc"], K)]
    pc = jsae.encode(jp, jnp.asarray(qpool), K)
    pv, pi = np.asarray(pc.values), np.asarray(pc.indices)
    qi8, qs = quantized_query_panel(torch.tensor(pv), torch.tensor(pi), H)
    keep = (retrieve_clear(sparse_scores64(dv, np.asarray(jcodes.indices), pv, pi, H), NTOP)
            & retrieve_clear(_int8_scores64(qi8.numpy(), qs.numpy(), cq, cidx, cs, inv), NTOP))
    assert keep[:4].all()
    queries = qpool[keep][:Q]
    assert queries.shape == (Q, D)
    return jp, params, jidx, queries


@pytest.mark.parametrize("precision", ["exact", "int8"])
@pytest.mark.parametrize("jax_kernel", [False, True])
def test_engine_on_quantized_index_matches_jax_engine(engine_case, precision, jax_kernel):
    jp, params, jidx, queries = engine_case
    tp = tsae.params_from_numpy(params, device="cpu")
    idx = _port_index(jidx)
    got = RetrievalEngine(idx, tp, config=EngineConfig(precision=precision),
                          device="cpu").retrieve_dense(torch.tensor(queries), NTOP)
    jengine = JRetrievalEngine(jidx, jp, config=JEngineConfig(use_kernel=jax_kernel,
                                                               precision=precision))
    want = jengine.retrieve_dense(jnp.asarray(queries), NTOP)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    assert got.ids[:4, 0].tolist() == [100, 101, 102, 103]
    assert got.status.path == f"{'int8' if precision == 'int8' else 'quantized'}-ref"


def test_int8_precision_needs_a_quantized_index(engine_case):
    _, params, jidx, _ = engine_case
    tp = tsae.params_from_numpy(params, device="cpu")
    twin = dequantize_index(_port_index(jidx))
    with pytest.raises(EngineConfigError, match="requires a QuantizedIndex"):
        RetrievalEngine(twin, tp, config=EngineConfig(precision="int8"), device="cpu")
    fp32 = RetrievalEngine(twin, tp, device="cpu")
    assert path_name(fp32) == "fp32-ref"


def test_int8_recall_at_32_meets_bound():
    """The JAX gate's configuration (tests/test_retrieval_quality.py):
    N=16,384, Q=64, k=32, d=256, h=1024, untrained params; the port's
    int8 recall@32 against its exact quantized path is at least 0.95."""
    d, h, k, n, q, topn = 256, 1024, 32, 16_384, 64, 32
    params = tsae.init_params(SAEConfig(d=d, h=h, k=k), torch.Generator().manual_seed(0))
    corpus = clustered_embeddings(torch.Generator().manual_seed(1), n, d=d)
    queries = clustered_embeddings(torch.Generator().manual_seed(2), q, d=d)
    index = build_index(tsae.encode_chunked(params, corpus, k), params, quantize=True)
    exact = RetrievalEngine(index, params, device="cpu").retrieve_dense(queries, topn)
    approx = RetrievalEngine(index, params, config=EngineConfig(precision="int8"),
                             device="cpu").retrieve_dense(queries, topn)
    quality = retrieval_quality(approx, exact)
    assert quality["n"] == topn
    assert quality["recall"] >= 0.95, quality
    assert quality["score_mae"] < 5e-3, quality
