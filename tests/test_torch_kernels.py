"""PyTorch port: streaming-fold kernels against the JAX package's pure-XLA
references (the CUDA kernels against their plain versions on the card are
in tests/test_torch_cuda.py).

On the CPU the port's wrappers run their plain versions, so the
cross-framework checks here pin the arithmetic the CUDA kernels must
reproduce: plain fold ≤ 1e-6 abs from ``lax.scan`` (float32 rounding of
the same op sequence in two frameworks), fold_chunk in both modes and
both strides ≤ 1e-6 abs (the conv sums in another order)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.p2m_conv.ops import _extract_patches as jax_patches
from repro.kernels.stream_fold import ops as jax_ops
from repro.kernels.stream_fold import ref as jax_ref
from repro_torch.kernels.p2m_conv.ops import _extract_patches
from repro_torch.kernels.stream_fold import ops, ref, stream_fold as sf

ATOL = 1e-6


def _fold_inputs(seed, S, N, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    dep = (rng.standard_normal((S, N, F)) * 0.01).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, dep, a


def _mac_inputs(seed, S, N, K, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    patches = rng.poisson(0.5, (S, N, K)).astype(np.float32)
    w = (np.round(rng.uniform(-1, 1, (K, F)) * 8) / 8).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, patches, w, a


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _chunk_inputs(seed, B, S, hw, cin, F):
    rng = np.random.default_rng(seed)
    frames = rng.poisson(0.4, (B, S, hw, hw, cin)).astype(np.float32)
    w_q = (np.round(rng.uniform(-1, 1, (3, 3, cin, F)) * 8) / 8
           ).astype(np.float32)
    a = np.exp(-rng.uniform(0, 0.5, F)).astype(np.float32)
    return frames, w_q, a


@pytest.mark.parametrize("S,N,F", [(1, 8, 3), (4, 37, 5), (6, 64, 16)])
def test_stream_fold_ref_matches_jax(S, N, F):
    x0, dep, a = _fold_inputs(S * 1000 + N, S, N, F)
    want = np.asarray(jax_ref.stream_fold_ref(*map(jnp.asarray, (x0, dep, a))))
    got = sf.stream_fold(*_t(x0, dep, a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S,N,K,F", [(1, 40, 18, 16), (3, 29, 8, 4)])
def test_stream_fold_mac_ref_matches_jax(S, N, K, F):
    x0, patches, w, a = _mac_inputs(S + N, S, N, K, F)
    want = np.asarray(jax_ref.stream_fold_mac_ref(
        *map(jnp.asarray, (x0, patches, w, a)), dv_unit=0.01))
    got = sf.stream_fold_mac(*_t(x0, patches, w, a), dv_unit=0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["deposit", "mac"])
@pytest.mark.parametrize("stride", [1, 2])
def test_fold_chunk_matches_jax(mode, stride):
    B, S, hw, cin, F = 2, 4, 12, 2, 8
    frames, w_q, a = _chunk_inputs(7 * stride, B, S, hw, cin, F)
    ho = hw // stride
    x = (np.random.default_rng(stride).standard_normal((B, ho, ho, F))
         * 0.05).astype(np.float32)
    want = np.asarray(jax_ops.fold_chunk(
        jnp.asarray(x), jnp.asarray(frames), jnp.asarray(w_q), jnp.asarray(a),
        stride=stride, dv_unit=0.01, mode=mode, use_ref=True))
    got = ops.fold_chunk(*_t(x, frames, w_q, a), stride=stride,
                         dv_unit=0.01, mode=mode).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("stride,hw", [(1, 12), (2, 12), (2, 13)])
def test_extract_patches_matches_jax(stride, hw):
    rng = np.random.default_rng(hw + stride)
    frames = rng.poisson(0.5, (3, hw, hw, 2)).astype(np.float32)
    want, want_hw = jax_patches(jnp.asarray(frames), 3, stride)
    got, got_hw = _extract_patches(torch.from_numpy(frames), 3, stride)
    assert got_hw == tuple(want_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_chunk_modes_agree():
    """The two modes fold the same deposits (≤ 1e-5: matmul vs conv order)."""
    frames, w_q, a = _chunk_inputs(3, 3, 2, 10, 2, 16)
    x = torch.zeros((3, 10, 10, 16))
    args = (x, *_t(frames, w_q, a))
    dep = ops.fold_chunk(*args, stride=1, dv_unit=0.01, mode="deposit")
    mac = ops.fold_chunk(*args, stride=1, dv_unit=0.01, mode="mac")
    np.testing.assert_allclose(mac.numpy(), dep.numpy(), rtol=0, atol=1e-5)


def test_fold_chunk_rejects_unknown_mode():
    frames, w_q, a = _chunk_inputs(0, 1, 1, 6, 2, 4)
    with pytest.raises(ValueError, match="unknown stream_fold mode"):
        ops.fold_chunk(torch.zeros((1, 6, 6, 4)), *_t(frames, w_q, a),
                       stride=1, dv_unit=0.01, mode="scan")


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = dict(sf.LAUNCHES)
    x0, dep, a = _fold_inputs(0, 2, 5, 3)
    out = sf.stream_fold(*_t(x0, dep, a))
    np.testing.assert_array_equal(
        out.numpy(), ref.stream_fold_ref(*_t(x0, dep, a)).numpy())
    assert sf.LAUNCHES == before
