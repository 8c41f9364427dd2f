"""The port's quantized code format, quantized index and quality metrics held
against the JAX package on the same numpy arrays.

Quantization is exact arithmetic on both sides (an f32 division, rounding
half to even, a clip), so int8 codes and scales must be equal, including
values placed exactly on the half-steps of a row's scale.  Indices,
CRC32s and widened indices are integers and must be equal; norms agree to
rtol 1e-6 (another summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jeval
from repro.core import quantized_codes as jq
from repro.core.retrieval import build_index as j_build_index
from repro.core.retrieval import dequantize_index as j_dequantize_index
from repro.core.retrieval import index_checksum as j_index_checksum
from repro.core.types import SparseCodes as JSparseCodes
from repro_torch.core import eval as teval
from repro_torch.core import quantized_codes as tq
from repro_torch.core.retrieval import (
    QuantizedIndex, build_index, dequantize_index, index_checksum, index_codes_f32,
    index_nbytes, verify_index,
)
from repro_torch.core.sae import params_from_numpy
from repro_torch.core.types import SparseCodes
from repro_torch.errors import IndexIntegrityError

from _torch_parity import sae_params

N, K = 500, 32


def _codes(h: int, seed: int = 0, n: int = N):
    """Random fixed-k codes over [0, h): distinct latents a row, values of
    both signs spread over three decades."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(h, K, replace=False) for _ in range(n)]).astype(np.int32)
    vals = (rng.standard_normal((n, K)) * 10.0 ** rng.uniform(-2, 1, (n, 1))).astype(np.float32)
    return vals, idx


def _both(vals, idx, h):
    return (SparseCodes(torch.tensor(vals), torch.tensor(idx), h),
            JSparseCodes(jnp.asarray(vals), jnp.asarray(idx), h))


def _half_steps():
    """Rows whose scale is a power of two (amax = 127 * 2^-e), with values
    (m + 0.5) * 2^-e: v / scale lands exactly on a half-step, so rounding
    half to even decides each code."""
    rng = np.random.default_rng(3)
    rows = []
    for e in range(1, 9):
        s = 2.0 ** -e
        m = rng.integers(-127, 127, K - 1)
        rows.append(np.concatenate([[127 * s], (m + 0.5) * s]))
    return np.array(rows, np.float32)


@pytest.mark.parametrize("h", [4096, 49_152, 70_000])
def test_quantize_codes_matches_jax(h):
    vals, idx = _codes(h)
    vals[:8] = _half_steps()
    vals[8] = 0.0                                    # an all-zero row: the 1e-12 floor
    tc, jc = _both(vals, idx, h)
    got, want = tq.quantize_codes(tc), jq.quantize_codes(jc)
    np.testing.assert_array_equal(got.q_values.numpy(), np.asarray(want.q_values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.indices.dtype == (torch.int16 if h < 65536 else torch.int32)
    assert got.nbytes_logical == want.nbytes_logical
    # the half-steps round to even: scale is exactly 2^-e, every code even
    scale = got.scales[:8].numpy()[:, None]
    np.testing.assert_array_equal(scale[:, 0], 2.0 ** -np.arange(1, 9))
    np.testing.assert_array_equal(got.q_values[:8].numpy(), np.round(vals[:8] / scale))
    assert (got.q_values[:8, 1:].numpy() % 2 == 0).all()
    deq = tq.dequantize_codes(got)
    jdeq = jq.dequantize_codes(want)
    np.testing.assert_array_equal(deq.values.numpy(), np.asarray(jdeq.values))
    np.testing.assert_array_equal(deq.indices.numpy(), np.asarray(jdeq.indices))
    assert tq.compression_ratio(768, K, h) == jq.compression_ratio(768, K, h)


@pytest.mark.parametrize("h", [49_152, 70_000])
def test_widen_indices_round_trips(h):
    vals, idx = _codes(h, seed=1)
    idx[0, :4] = [0, 32767, 32768, h - 1]           # both sides of the int16 wrap
    q = tq.quantize_codes(SparseCodes(torch.tensor(vals), torch.tensor(idx), h))
    if h < 65536:
        assert int(q.indices.min()) < 0                 # stored wrapped
    wide = tq.widen_indices(q.indices)
    assert wide.dtype == torch.int32
    np.testing.assert_array_equal(wide.numpy(), idx)
    np.testing.assert_array_equal(
        wide.numpy(), np.asarray(jq.widen_indices(jnp.asarray(q.indices.numpy()))))


@pytest.mark.parametrize("h", [4096, 70_000])
def test_checksums_match_jax(h):
    vals, idx = _codes(h, seed=2)
    tc, jc = _both(vals, idx, h)
    assert tq.codes_checksum(tc) == jq.codes_checksum(jc)
    tqc, jqc = tq.quantize_codes(tc), jq.quantize_codes(jc)
    assert tq.codes_checksum(tqc) == jq.codes_checksum(jqc)
    assert tq.codes_checksum(tqc) != tq.codes_checksum(tc)
    tidx, jidx = build_index(tc, quantize=True), j_build_index(jc, quantize=True)
    mirrored = QuantizedIndex(
        codes=tq.QuantizedCodes(*(torch.tensor(np.asarray(a)) for a in jidx.codes[:3]), h),
        sparse_norms=torch.tensor(np.asarray(jidx.sparse_norms)), recon_norms=None,
        inv_sparse_norms=torch.tensor(np.asarray(jidx.inv_sparse_norms)),
        checksum=jidx.checksum)
    assert index_checksum(mirrored) == jidx.checksum == j_index_checksum(jidx)
    assert verify_index(mirrored)
    assert verify_index(tidx)


def test_quantized_index_matches_jax():
    h, d = 512, 96
    params = sae_params(d, h, seed=0, bias=0.01)
    vals, idx = _codes(h, seed=4)
    tc, jc = _both(vals, idx, h)
    own = build_index(tc, params_from_numpy(params, device="cpu"), quantize=True)
    jidx = j_build_index(jc, {k: jnp.asarray(v) for k, v in params.items()}, quantize=True)
    assert isinstance(own, QuantizedIndex)
    np.testing.assert_array_equal(own.codes.q_values.numpy(), np.asarray(jidx.codes.q_values))
    np.testing.assert_array_equal(own.codes.scales.numpy(), np.asarray(jidx.codes.scales))
    for field in ("sparse_norms", "inv_sparse_norms", "recon_norms", "inv_recon_norms"):
        np.testing.assert_allclose(getattr(own, field).numpy(),
                                   np.asarray(getattr(jidx, field)), rtol=1e-6)
    # the norms are those of the dequantized values: the fp32 twin is exact
    twin = dequantize_index(own)
    jtwin = j_dequantize_index(jidx)
    np.testing.assert_array_equal(twin.codes.values.numpy(), np.asarray(jtwin.codes.values))
    assert torch.equal(twin.sparse_norms, own.sparse_norms)
    assert verify_index(twin) and twin.checksum != own.checksum
    fresh = build_index(index_codes_f32(own), params_from_numpy(params, device="cpu"))
    assert torch.equal(fresh.sparse_norms, own.sparse_norms)
    assert torch.equal(index_codes_f32(twin).values, twin.codes.values)
    assert index_nbytes(own) == own.codes.nbytes_logical + 4 * 4 * N
    assert own.codes.nbytes_logical == N * (K * 3 + 4)
    bad = own._replace(codes=own.codes._replace(q_values=-own.codes.q_values))
    with pytest.raises(IndexIntegrityError, match="checksum mismatch"):
        verify_index(bad)


def test_retrieval_quality_matches_jax():
    rng = np.random.default_rng(9)
    exact_ids = np.stack([rng.permutation(50)[:10] for _ in range(6)]).astype(np.int32)
    exact_s = -np.sort(-rng.random((6, 10)).astype(np.float32), axis=1)
    approx_ids = exact_ids.copy()
    approx_ids[0, [2, 3]] = approx_ids[0, [3, 2]]       # a swapped pair
    approx_ids[1, -1] = 99                              # a miss
    approx_ids[2, :] = approx_ids[2, 0]                 # duplicate ids
    approx_s = exact_s + rng.normal(0, 1e-3, exact_s.shape).astype(np.float32)
    approx_s[3, 4] = approx_s[3, 5]                     # an exact score tie
    for n in (None, 4, 25):
        got = teval.retrieval_quality((torch.tensor(approx_s), torch.tensor(approx_ids)),
                                      (exact_s, exact_ids), n=n)
        want = jeval.retrieval_quality((approx_s, approx_ids), (exact_s, exact_ids), n=n)
        assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert teval.retrieval_quality((exact_s, exact_ids), (exact_s, exact_ids)) == {
        "n": 10, "recall": 1.0, "score_mae": 0.0, "rank_displacement": 0.0}
    assert teval.rank_displacement(approx_ids[4], exact_ids[4]) == 0.0
    assert teval.score_mae(approx_s[:, :7], exact_s, n=9) == jeval.score_mae(
        approx_s[:, :7], exact_s, n=9)
