"""The port's encoder (plain PyTorch, on the CPU) held against the JAX package.

Inputs are made with numpy and handed to both packages.  The JAX fused
encoder runs as its own tests run it: the Pallas kernel in interpret mode
(``ops.fused_encode``) and its jnp reference (``ref.fused_encode_ref``).
Indices must be exactly equal; values agree to rtol 1e-5, atol 1e-6,
because the two matmuls sum over d in different orders.  Rows are drawn
in bulk and kept by the float64 gap rule of ``_torch_parity``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import encode_clear, sae_params, tie_inputs
from repro.core import sae as jsae
from repro.core import sparse as jsparse
from repro.core.topk import abs_topk_sparse_grouped as j_grouped
from repro.core.types import SAEConfig as JSAEConfig
from repro.core.types import SparseCodes as JSparseCodes
from repro.kernels.fused_encode.ops import fused_encode as j_fused_encode
from repro.kernels.fused_encode.ref import fused_encode_ref as j_fused_encode_ref
from repro_torch.core import sae as tsae
from repro_torch.core import sparse as tsparse
from repro_torch.core.topk import abs_topk, abs_topk_sparse, abs_topk_sparse_grouped
from repro_torch.core.types import SAEConfig, SparseCodes
from repro_torch.kernels.fused_encode import fused_encode, fused_encode_chunked

B, D, H, K = 37, 96, 512, 16     # ragged B, d no multiple of 16 or 128
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def case():
    params = sae_params(D, H, seed=0, bias=0.01)
    pool = np.random.default_rng(1).standard_normal((4 * B, D)).astype(np.float32)
    keep = encode_clear(pool, params["w_enc"], params["b_enc"], K)
    x = pool[keep][:B]
    assert x.shape == (B, D), "too few rows pass the gap rule"
    assert encode_clear(x, params["w_enc"], params["b_enc"], K).all()
    return x, params


def _jax_codes(which, x, params):
    jp = {key: jnp.asarray(val) for key, val in params.items()}
    if which == "jax_kernel":
        c = j_fused_encode(jnp.asarray(x), jp["w_enc"], jp["b_enc"], K)
        return np.asarray(c.values), np.asarray(c.indices)
    v, i = j_fused_encode_ref(jsae.normalize_input(jnp.asarray(x)),
                              jp["w_enc"], jp["b_enc"], K)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("which", ["jax_kernel", "jax_ref"])
def test_fused_encode_matches_jax(case, which):
    x, params = case
    tp = tsae.params_from_numpy(params, device="cpu")
    got = fused_encode(torch.tensor(x), tp["w_enc"], tp["b_enc"], K)
    want_v, want_i = _jax_codes(which, x, params)
    assert got.dim == H
    np.testing.assert_array_equal(got.indices.numpy(), want_i)
    np.testing.assert_allclose(got.values.numpy(), want_v, rtol=RTOL, atol=ATOL)


def test_sae_encode_matches_jax(case):
    x, params = case
    tp = tsae.params_from_numpy(params, device="cpu")
    got = tsae.encode(tp, torch.tensor(x), K)
    want = jsae.encode({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), K)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=RTOL, atol=ATOL)
    chunked = tsae.encode_chunked(tp, torch.tensor(x), K, chunk=8)
    assert torch.equal(chunked.indices, got.indices)
    assert torch.equal(chunked.values, got.values)
    plain = fused_encode_chunked(torch.tensor(x), tp["w_enc"], tp["b_enc"], K, chunk=10)
    assert torch.equal(plain.indices, got.indices)


@pytest.mark.parametrize("groups", [2, 8])
def test_grouped_topk_matches_jax(case, groups):
    """Same f32 pre-activations in: the selection alone is compared, exactly."""
    x, params = case
    pre = (x @ params["w_enc"] + params["b_enc"]).astype(np.float32)
    pre[0, :4] = pre[0, 4]                              # an exact tie
    v, i = abs_topk_sparse_grouped(torch.tensor(pre), K, groups)
    jv, ji = j_grouped(jnp.asarray(pre), K, groups)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    fv, fi = abs_topk_sparse(torch.tensor(pre), K)
    assert torch.equal(fi, i) and torch.equal(fv, v)


@pytest.mark.parametrize("which", ["jax_kernel", "jax_ref"])
def test_exact_ties_go_to_lowest_index(which):
    """Integer-valued inputs: pre-activations are exact in every summation
    order and full of ties, so values and indices must match exactly."""
    x, w, b = tie_inputs(np.random.default_rng(2), B, D, H)
    params = {"w_enc": w, "b_enc": b, "w_dec": np.ascontiguousarray(w.T)}
    tp = tsae.params_from_numpy(params, device="cpu")
    got = fused_encode(torch.tensor(x), tp["w_enc"], tp["b_enc"], K)
    want_v, want_i = _jax_codes(which, x, params)
    np.testing.assert_array_equal(got.indices.numpy(), want_i)
    np.testing.assert_array_equal(got.values.numpy(), want_v)
    # the kept values really are tied, so the rule was exercised
    absv = np.abs(want_v)
    assert (absv[:, 1:] == absv[:, :-1]).any()


def test_abs_topk_tie_rule_and_dense_form():
    x = torch.tensor([[1.0, -3.0, 3.0, 2.0, -3.0, 0.5]])
    v, i = abs_topk_sparse(x, 3)
    assert i.tolist() == [[1, 2, 4]] and v.tolist() == [[-3.0, 3.0, -3.0]]
    assert abs_topk(x, 3).tolist() == [[0.0, -3.0, 3.0, 0.0, -3.0, 0.0]]
    assert torch.equal(abs_topk(x, 3, groups=2), abs_topk(x, 3))


def test_densify_sums_duplicates_like_jax():
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((5, 6)).astype(np.float32)
    idx = rng.integers(0, 9, (5, 6)).astype(np.int32)
    idx[:, 1] = idx[:, 0]
    got = tsparse.densify(SparseCodes(torch.tensor(vals), torch.tensor(idx), 9))
    want = jsparse.densify(JSparseCodes(jnp.asarray(vals), jnp.asarray(idx), 9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_cross_from_jax():
    """JAX ``init_params`` -> numpy -> the port and back, bit for bit."""
    import jax

    jp = jsae.init_params(JSAEConfig(d=D, h=H, k=K), jax.random.PRNGKey(0))
    arrays = {key: np.asarray(val) for key, val in jp.items()}
    tp = tsae.params_from_numpy(arrays, device="cpu")
    assert tp["w_enc"].shape == (D, H) and tp["w_enc"].is_contiguous()
    for key, val in tsae.params_to_numpy(tp).items():
        np.testing.assert_array_equal(val, arrays[key])


def test_init_params_is_tied_and_unit_norm():
    cfg = SAEConfig(d=D, h=H, k=K)
    p = tsae.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(p["w_enc"], p["w_dec"].T)
    torch.testing.assert_close(torch.linalg.vector_norm(p["w_dec"], dim=-1),
                               torch.ones(H), rtol=1e-6, atol=1e-6)
    assert not p["b_enc"].any()
    again = tsae.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["w_dec"], p["w_dec"])


def test_decode_matches_jax(case):
    x, params = case
    tp = tsae.params_from_numpy(params, device="cpu")
    codes = tsae.encode(tp, torch.tensor(x), K)
    jcodes = JSparseCodes(jnp.asarray(codes.values.numpy()),
                          jnp.asarray(codes.indices.numpy()), H)
    want = jsae.decode({k: jnp.asarray(v) for k, v in params.items()}, jcodes)
    np.testing.assert_allclose(tsae.decode(tp, codes).numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_gap_rule_is_not_vacuous(case):
    """The gap rule keeps most rows: the parity checks are not vacuous."""
    x, params = case
    pool = np.random.default_rng(1).standard_normal((4 * B, D)).astype(np.float32)
    assert encode_clear(pool, params["w_enc"], params["b_enc"], K).mean() > 0.5
