"""The whole slice on the CPU: the port's ``RetrievalEngine.retrieve_dense``
held against the JAX ``RetrievalEngine`` on the same params, catalog and
queries, with the JAX engine on its jnp path and on its Pallas kernels in
interpret mode.

Each package encodes the catalog and the queries itself.  Catalog rows
and queries are drawn in bulk and kept by the float64 gap rules of
``_torch_parity`` (encoder and retrieval), so ids must be exactly equal;
scores agree to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import encode_clear, retrieve_clear, sparse_scores64
from repro.core import sae as jsae
from repro.core.retrieval import build_index as j_build_index
from repro.core.types import SAEConfig as JSAEConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import RetrievalEngine as JRetrievalEngine
from repro_torch.core import sae as tsae
from repro_torch.core.retrieval import build_index
from repro_torch.core.types import SparseCodes
from repro_torch.errors import EngineConfigError, InvalidQueryError
from repro_torch.kernels.fused_encode import fused_encode_chunked
from repro_torch.serving import EngineConfig, RetrievalEngine
from repro_torch.serving.engine import path_name, select_retrieve_fn

N, Q, D, H, K, NTOP = 1000, 13, 96, 512, 16, 16


@pytest.fixture(scope="module")
def slice_case():
    jp = jsae.init_params(JSAEConfig(d=D, h=H, k=K), jax.random.PRNGKey(0))
    params = {key: np.asarray(val) for key, val in jp.items()}
    rng = np.random.default_rng(8)
    pool = rng.standard_normal((2 * N, D)).astype(np.float32)
    catalog = pool[encode_clear(pool, params["w_enc"], params["b_enc"], K)][:N]
    assert catalog.shape == (N, D)
    catalog[700:720] = catalog[100:120]                 # duplicate items: exact ties
    qpool = rng.standard_normal((8 * Q, D)).astype(np.float32)
    qpool[:4] = catalog[100:104]
    qpool = qpool[encode_clear(qpool, params["w_enc"], params["b_enc"], K)]
    jcodes = jsae.encode(jp, jnp.asarray(catalog), K)
    qcodes = jsae.encode(jp, jnp.asarray(qpool), K)
    keep = retrieve_clear(sparse_scores64(
        np.asarray(jcodes.values), np.asarray(jcodes.indices),
        np.asarray(qcodes.values), np.asarray(qcodes.indices), H), NTOP)
    assert keep[:4].all()
    queries = qpool[keep][:Q]
    assert queries.shape == (Q, D)
    return jp, params, catalog, jcodes, queries


@pytest.fixture(scope="module")
def port_engine(slice_case):
    _, params, catalog, _, _ = slice_case
    tp = tsae.params_from_numpy(params, device="cpu")
    codes = fused_encode_chunked(torch.tensor(catalog), tp["w_enc"], tp["b_enc"], K,
                                 chunk=300)
    return RetrievalEngine(build_index(codes), tp, device="cpu")


@pytest.mark.parametrize("jax_kernel", [False, True])
def test_retrieve_dense_matches_jax_engine(slice_case, port_engine, jax_kernel):
    jp, _, _, jcodes, queries = slice_case
    jengine = JRetrievalEngine(j_build_index(jcodes), jp,
                               config=JEngineConfig(use_kernel=jax_kernel))
    want = jengine.retrieve_dense(jnp.asarray(queries), NTOP)
    got = port_engine.retrieve_dense(torch.tensor(queries), NTOP)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=0)
    assert got.ids[:4, 0].tolist() == [100, 101, 102, 103]   # lowest of the duplicates
    assert got.ids[:4, 1].tolist() == [700, 701, 702, 703]
    assert got.status.path == "fp32-ref" and not got.status.degraded


def test_port_index_matches_jax_index(slice_case, port_engine):
    _, _, _, jcodes, _ = slice_case
    np.testing.assert_array_equal(port_engine.index.codes.indices.numpy(),
                                  np.asarray(jcodes.indices))
    np.testing.assert_allclose(port_engine.index.codes.values.numpy(),
                               np.asarray(jcodes.values), rtol=1e-5, atol=1e-6)


def test_single_query_and_panel_padding(slice_case, port_engine):
    _, _, _, _, queries = slice_case
    batch = port_engine.retrieve_dense(torch.tensor(queries), NTOP)
    one = port_engine.retrieve_dense(torch.tensor(queries[5]), NTOP)
    assert one.ids.shape == (NTOP,)
    assert torch.equal(one.ids, batch.ids[5]) and torch.equal(one.scores, batch.scores[5])
    codes = port_engine.encode_queries(torch.tensor(queries))
    s, i = port_engine.retrieve_codes(codes, NTOP)
    assert torch.equal(i, batch.ids)


def test_engine_rejects_bad_requests(port_engine):
    with pytest.raises(InvalidQueryError, match="embedding dim mismatch"):
        port_engine.retrieve_dense(torch.zeros(2, D + 1), NTOP)
    with pytest.raises(InvalidQueryError, match="exceeds candidate count"):
        port_engine.retrieve_dense(torch.zeros(2, D), N + 1)
    with pytest.raises(InvalidQueryError, match="floating dtype"):
        port_engine.retrieve_dense(torch.zeros(2, D, dtype=torch.int32), NTOP)
    with pytest.raises(InvalidQueryError, match="torch.Tensor"):
        port_engine.retrieve_dense(np.zeros((2, D), np.float32), NTOP)
    with pytest.raises(InvalidQueryError, match="top-n must be >= 1"):
        port_engine.retrieve_dense(torch.zeros(2, D), 0)


@pytest.mark.parametrize("field,value", [
    ("mode", "reconstructed"), ("stage", "two_stage"), ("mesh", object()),
])
def test_config_off_the_slice_is_not_yet_ported(field, value):
    with pytest.raises(EngineConfigError, match="not yet ported"):
        EngineConfig(**{field: value})


def test_config_keeps_the_field_checks():
    with pytest.raises(EngineConfigError, match="unknown retrieval mode"):
        EngineConfig(mode="dense")
    with pytest.raises(EngineConfigError, match="unknown precision"):
        EngineConfig(precision="fp16")
    with pytest.raises(EngineConfigError, match="candidate_fraction"):
        EngineConfig(stage="two_stage", candidate_fraction=0.0)
    assert EngineConfig().replace(k=4).k == 4
    with pytest.raises(EngineConfigError, match="not yet ported"):
        select_retrieve_fn(sparse_query=False, quantized=True, int8_scoring=False,
                           use_fused=False)


def test_engine_kernel_switch_on_cpu(port_engine):
    assert path_name(port_engine) == "fp32-ref" and not port_engine.use_fused
    with pytest.raises(EngineConfigError, match="needs a CUDA device"):
        RetrievalEngine(port_engine.index, port_engine.params,
                        config=EngineConfig(use_kernel=True), device="cpu")
    with pytest.raises(EngineConfigError, match="latent-dim mismatch"):
        RetrievalEngine(port_engine.index, {**port_engine.params,
                                            "w_enc": torch.zeros(D, 2 * H)}, device="cpu")


@pytest.mark.parametrize("fmt", ["fp32", "quantized", "int8"])
def test_nan_queries_rank_as_lax_top_k(slice_case, fmt):
    """A query row of NaNs and a row with one NaN (which normalisation
    spreads over the row) encode to NaN codes on latents 0..k-1; every
    candidate holding one of them scores NaN, and NaN ranks above every
    number, lowest id first, as in ``lax.top_k``.  Held against the JAX
    engine on its jnp path on the same index."""
    jp, params, _, jcodes, queries = slice_case
    q = queries[:4].copy()
    q[0] = np.nan
    q[1, 3] = np.nan
    quantize, precision = fmt != "fp32", "int8" if fmt == "int8" else "exact"
    jengine = JRetrievalEngine(j_build_index(jcodes, quantize=quantize), jp,
                               config=JEngineConfig(use_kernel=False, precision=precision))
    want = jengine.retrieve_dense(jnp.asarray(q), NTOP)
    assert np.isnan(np.asarray(want.scores)[:2]).all()
    codes = SparseCodes(torch.tensor(np.asarray(jcodes.values)),
                        torch.tensor(np.asarray(jcodes.indices)), H)
    port = RetrievalEngine(build_index(codes, quantize=quantize),
                           tsae.params_from_numpy(params, device="cpu"),
                           config=EngineConfig(precision=precision), device="cpu")
    got = port.retrieve_dense(torch.tensor(q), NTOP)
    np.testing.assert_array_equal(got.ids[:2].numpy(), np.asarray(want.ids)[:2])
    assert torch.isnan(got.scores[:2]).all()
    np.testing.assert_allclose(got.scores[2:].numpy(), np.asarray(want.scores)[2:],
                               rtol=1e-6, atol=0)
    codes_q = port.encode_queries(torch.tensor(q[:2]))
    assert codes_q.indices.tolist() == [list(range(K))] * 2
    if fmt == "int8":                       # a NaN query scale: every score NaN
        assert got.ids[:2].tolist() == [list(range(NTOP))] * 2
