"""The port's CUDA kernels against their plain versions, on a Hopper card.

Imports neither JAX nor the JAX package, so that it runs where only the
port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

Without a CUDA device every test skips: a CUDA kernel has no CPU mode. The
tolerances are those of ``tests/test_kernels.py`` for the same op.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def ssd_inputs(bsz, seqlen, nheads, hdim, ngroups, nstate, dtype, device):
    g = torch.Generator(device=device).manual_seed(seqlen)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    x = (0.2 * rn(bsz, seqlen, nheads, hdim)).to(dtype)
    dt = torch.nn.functional.softplus(rn(bsz, seqlen, nheads))
    a = -torch.exp(0.2 * rn(nheads))
    b = (rn(bsz, seqlen, ngroups, nstate) * nstate ** -0.5).to(dtype)
    c = (rn(bsz, seqlen, ngroups, nstate) * nstate ** -0.5).to(dtype)
    return x, dt, a, b, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("n", [16, 100, 4096])
def test_reduce_scan_kernels_match_plain(cuda, n, dtype):
    x = torch.randn(37, n, device=cuda).to(dtype)
    before = kops.launch_counts()
    torch.testing.assert_close(kops.segmented_reduce(x),
                               ref.segmented_reduce_ref(x), rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(kops.segmented_scan(x),
                               ref.segmented_scan_ref(x), rtol=1e-3,
                               atol=1e-2)
    after = kops.launch_counts()
    assert after["tcu_reduce"] == before["tcu_reduce"] + 1
    assert after["tcu_scan"] == before["tcu_scan"] + 1


@pytest.mark.cuda
def test_scan_carry_across_tiles_and_warps(cuda):
    """Constant input: the scan is i + 1 everywhere, across every tile and
    every warp's column range."""
    x = torch.ones(16, 8192, device=cuda)
    want = torch.arange(1, 8193, device=cuda,
                        dtype=torch.float32).expand(16, -1)
    torch.testing.assert_close(kops.segmented_scan(x), want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 100, 4, 16, 2, 8),
                                   (1, 200, 2, 64, 1, 128)])
def test_ssd_kernel_matches_plain(cuda, shape, dtype):
    ins = ssd_inputs(*shape, dtype, cuda)
    y, st = kops.ssd_scan(*ins, return_state=True)
    yr, sr = ref.ssd_scan_ref(*ins, return_state=True)
    assert y.dtype == dtype and st.dtype == torch.float32
    # bf16 output: one rounding of the same f32 value, at most one ulp apart
    tol = 2e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_weighted_scan_kernel_matches_plain(cuda):
    x = torch.randn(5, 300, device=cuda)
    la = -0.5 * torch.rand(5, 300, device=cuda)
    torch.testing.assert_close(kops.weighted_scan(x, la),
                               ref.weighted_scan_ref(x, la), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 2048])
def test_rmsnorm_kernel_matches_plain(cuda, d, dtype):
    x = torch.randn(33, d, device=cuda).to(dtype)
    w = (torch.rand(d, device=cuda) + 0.5).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(kops.rmsnorm(x, w, eps=1e-5),
                               ref.rmsnorm_ref(x, w, eps=1e-5), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        kops.segmented_reduce(torch.ones(4, 16, device=cuda,
                                         dtype=torch.float64))
    with pytest.raises(ValueError):
        kops.rmsnorm(torch.ones(4, 16, device=cuda), torch.ones(8,
                                                                device=cuda))
