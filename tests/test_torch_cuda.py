"""PyTorch port: the CUDA streaming-fold kernels against their plain
versions, on the card. Imports no JAX, so it runs on the machine with the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a GPU every test here skips."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.stream_fold import ref, stream_fold as sf


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _fold_inputs(seed, S, N, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    dep = (rng.standard_normal((S, N, F)) * 0.01).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, dep, a


def _mac_inputs(seed, S, N, K, F):
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((N, F)) * 0.05).astype(np.float32)
    patches = (rng.poisson(0.5, (S, N, K))
               + rng.uniform(0, 0.01, (S, N, K))).astype(np.float32)
    w = (np.round(rng.uniform(-1, 1, (K, F)) * 8) / 8).astype(np.float32)
    a = np.exp(-rng.uniform(size=F)).astype(np.float32)
    return x0, patches, w, a


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels.backend import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,N,F", [(1, 4099, 16), (4, 1000, 5)])
def test_cuda_fold_bit_exact_vs_plain(cuda_device, S, N, F):
    ts = [t.to(cuda_device) for t in _t(*_fold_inputs(S, S, N, F))]
    n = sf.LAUNCHES["fold"]
    got = sf.stream_fold(*ts)
    assert sf.LAUNCHES["fold"] == n + 1
    torch.testing.assert_close(got, ref.stream_fold_ref(*ts), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,N,K,F", [(1, 4099, 18, 16), (4, 1000, 18, 8)])
def test_cuda_fold_mac_vs_plain(cuda_device, S, N, K, F):
    ts = [t.to(cuda_device) for t in _t(*_mac_inputs(S, S, N, K, F))]
    n = sf.LAUNCHES["fold_mac"]
    got = sf.stream_fold_mac(*ts, dv_unit=0.01)
    assert sf.LAUNCHES["fold_mac"] == n + 1
    torch.testing.assert_close(got, ref.stream_fold_mac_ref(*ts, dv_unit=0.01),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    x0, dep, a = [t.to(cuda_device) for t in _t(*_fold_inputs(0, 2, 8, 4))]
    with pytest.raises(TypeError):
        sf.stream_fold(x0.double(), dep, a)
    with pytest.raises(ValueError):
        sf.stream_fold(x0, dep, a.cpu())
    with pytest.raises(ValueError):
        sf.stream_fold(x0.t().contiguous().t(), dep[:, :, :3], a)
