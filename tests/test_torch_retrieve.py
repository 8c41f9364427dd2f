"""The port's sparse-query retrieve (plain PyTorch, on the CPU) and its index
held against the JAX package, on the JAX package's own codes.

The JAX retrieve runs as its own tests run it: the Pallas kernel in
interpret mode (``ops.fused_retrieve_sparse_q``) and the jnp reference
(``ref.retrieve_sparse_q_ref``).  Ids must be exactly equal; scores agree
to rtol 1e-6, since the JAX reference sums the k products in an order XLA
picks.  Queries are drawn in bulk and kept by the float64 gap rule of
``_torch_parity``; the exact ties of duplicate catalog rows are kept on
purpose.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import retrieve_clear, sae_params, sparse_scores64
from repro.core import sae as jsae
from repro.core.retrieval import build_index as j_build_index
from repro.kernels.sparse_dot.ops import fused_retrieve_sparse_q as j_fused_retrieve
from repro.kernels.sparse_dot.ref import retrieve_sparse_q_ref as j_retrieve_ref
from repro_torch.core.retrieval import (
    SparseIndex, build_index, index_checksum, score_dense, top_n, verify_index,
)
from repro_torch.core.types import SparseCodes
from repro_torch.errors import IndexIntegrityError, InvalidCodesError
from repro_torch.kernels.sparse_dot import fused_retrieve_sparse_q, retrieve_sparse_q_ref

N, Q, D, H, K, NTOP = 1000, 13, 96, 512, 16, 16   # N ragged against 256
DUP_SRC, DUP_DST = slice(0, 40), slice(600, 640)


def _catalog_codes():
    """JAX's own codes of a numpy catalog, with 40 duplicated rows."""
    params = sae_params(D, H, seed=0, bias=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    c = jsae.encode(jp, jnp.asarray(x), K)
    v, i = np.array(c.values), np.array(c.indices)
    v[DUP_DST], i[DUP_DST] = v[DUP_SRC], i[DUP_SRC]
    return params, v, i


@pytest.fixture(scope="module")
def encoded():
    params, cv, ci = _catalog_codes()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pool_x = np.random.default_rng(6).standard_normal((4 * Q, D)).astype(np.float32)
    pc = jsae.encode(jp, jnp.asarray(pool_x), K)
    pv, pi = np.array(pc.values), np.array(pc.indices)
    pv[:8], pi[:8] = cv[:8], ci[:8]             # queries equal to duplicated rows
    pi[8:16, 1] = pi[8:16, 0]                   # duplicate query indices
    keep = retrieve_clear(sparse_scores64(cv, ci, pv, pi, H), NTOP)
    assert keep[:16].all(), "the designed queries must pass the gap rule"
    qv, qi = pv[keep][:Q], pi[keep][:Q]
    assert qv.shape[0] == Q
    return params, cv, ci, qv, qi


@pytest.fixture(scope="module")
def all_negative():
    """Every score negative: catalog values > 0 and query values < 0 on
    16 of the same 20 latents, so every pair overlaps."""
    rng = np.random.default_rng(7)
    ci = np.stack([rng.choice(20, K, replace=False) for _ in range(N)]).astype(np.int32)
    cv = rng.uniform(0.1, 1.0, (N, K)).astype(np.float32)
    cv[DUP_DST], ci[DUP_DST] = cv[DUP_SRC], ci[DUP_SRC]
    pi = np.stack([rng.choice(20, K, replace=False) for _ in range(4 * Q)]).astype(np.int32)
    pv = -rng.uniform(0.1, 1.0, (4 * Q, K)).astype(np.float32)
    s64 = sparse_scores64(cv, ci, pv, pi, H)
    assert (s64 < 0).all()
    keep = retrieve_clear(s64, NTOP)
    return None, cv, ci, pv[keep][:Q], pi[keep][:Q]


def _index(cv, ci):
    return build_index(SparseCodes(torch.tensor(cv), torch.tensor(ci), H))


@pytest.mark.parametrize("which", ["jax_kernel", "jax_ref"])
@pytest.mark.parametrize("data", ["encoded", "all_negative"])
def test_plain_retrieve_matches_jax(request, data, which):
    _, cv, ci, qv, qi = request.getfixturevalue(data)
    idx = _index(cv, ci)
    got_s, got_i = fused_retrieve_sparse_q(
        idx.codes.values, idx.codes.indices, idx.inv_sparse_norms,
        torch.tensor(qv), torch.tensor(qi), H, n=NTOP)
    jfn = j_fused_retrieve if which == "jax_kernel" else j_retrieve_ref
    inv = jnp.asarray(idx.inv_sparse_norms.numpy())
    want_s, want_i = jfn(jnp.asarray(cv), jnp.asarray(ci), inv,
                         jnp.asarray(qv), jnp.asarray(qi), H, n=NTOP)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0)
    if data == "all_negative":
        assert (got_s < 0).all()


def test_duplicate_rows_tie_to_lowest_id(encoded):
    _, cv, ci, qv, qi = encoded
    idx = _index(cv, ci)
    _, ids = fused_retrieve_sparse_q(idx.codes.values, idx.codes.indices,
                                     idx.inv_sparse_norms, torch.tensor(qv[:8]),
                                     torch.tensor(qi[:8]), H, n=NTOP)
    assert ids[:, 0].tolist() == list(range(8))
    assert ids[:, 1].tolist() == list(range(600, 608))


def test_chunked_ref_is_exact_across_chunk_edges(encoded):
    """Small candidate blocks and query chunks merge to the same bits."""
    _, cv, ci, qv, qi = encoded
    idx = _index(cv, ci)
    args = (idx.codes.values, idx.codes.indices, idx.inv_sparse_norms,
            torch.tensor(qv), torch.tensor(qi), H)
    s0, i0 = retrieve_sparse_q_ref(*args, n=NTOP)
    s1, i1 = retrieve_sparse_q_ref(*args, n=NTOP, block_n=37, q_chunk=4)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    one_s, one_i = fused_retrieve_sparse_q(*args[:3], args[3][2], args[4][2], H, n=NTOP)
    assert torch.equal(one_i, i0[2]) and torch.equal(one_s, s0[2])
    with pytest.raises(ValueError, match="exceeds candidate count"):
        fused_retrieve_sparse_q(*args, n=N + 1)


def test_index_matches_jax_checksum_and_norms():
    params, cv, ci = _catalog_codes()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    from repro.core.types import SparseCodes as JSparseCodes

    jidx = j_build_index(JSparseCodes(jnp.asarray(cv), jnp.asarray(ci), H), jp)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    mirrored = SparseIndex(
        codes=SparseCodes(t(jidx.codes.values), t(jidx.codes.indices), H),
        sparse_norms=t(jidx.sparse_norms), recon_norms=t(jidx.recon_norms),
        inv_sparse_norms=t(jidx.inv_sparse_norms),
        inv_recon_norms=t(jidx.inv_recon_norms), checksum=jidx.checksum)
    assert index_checksum(mirrored) == jidx.checksum
    assert verify_index(mirrored)

    from repro_torch.core.sae import params_from_numpy

    own = build_index(SparseCodes(torch.tensor(cv), torch.tensor(ci), H),
                      params_from_numpy(params, device="cpu"))
    for field in ("sparse_norms", "inv_sparse_norms", "recon_norms", "inv_recon_norms"):
        np.testing.assert_allclose(getattr(own, field).numpy(),
                                   np.asarray(getattr(jidx, field)), rtol=1e-6)
    assert verify_index(own)
    flipped = own.codes.values.clone()
    flipped[3, 2] = -flipped[3, 2]
    bad = own._replace(codes=own.codes._replace(values=flipped))
    with pytest.raises(IndexIntegrityError, match="checksum mismatch"):
        verify_index(bad)
    with pytest.raises(IndexIntegrityError, match="no stored checksum"):
        verify_index(own._replace(checksum=None))
    assert verify_index(own._replace(checksum=None), require=False) is False


def test_build_index_rejects_what_it_does_not_serve():
    codes = SparseCodes(torch.ones(4, 2), torch.tensor([[0, 1], [2, 3], [4, 9], [1, 1]],
                                                       dtype=torch.int32), 8)
    with pytest.raises(InvalidCodesError, match=r"outside \[0, 8\)"):
        build_index(codes)
    with pytest.raises(InvalidCodesError, match=r"outside \[0, 8\)"):
        build_index(codes, quantize=True)
    nan_values = torch.ones(2, 2)
    nan_values[1, 0] = float("inf")
    with pytest.raises(InvalidCodesError, match="finite"):
        build_index(SparseCodes(nan_values, codes.indices[:2], 8))


def test_dense_baseline_top_n_ties():
    db = torch.tensor([[1.0, 0.0], [0.0, 1.0], [2.0, 0.0], [1.0, 1.0]])
    s, ids = top_n(score_dense(db, torch.tensor([[1.0, 0.0]])), 3)
    assert ids.tolist() == [[0, 2, 3]] and ids.dtype == torch.int32
    torch.testing.assert_close(s, torch.tensor([[1.0, 1.0, 2 ** -0.5]]))
