"""PyTorch port, CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and the CUDA toolkit; each skips
without one.  The file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops import flash_attention as fa
from analytics_zoo_torch.ops import fused, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("t,d,causal", [(128, 64, False), (128, 64, True),
                                        (100, 128, False), (100, 128, True),
                                        (1, 64, False), (257, 64, True)])
def test_flash_kernel_matches_plain(dev, t, d, causal):
    q, k, v = (_randn(dev, 2, 3, t, d, seed=s) for s in range(3))
    before = kernels.launch_counts()["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 1


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q = _randn(dev, 1, 2, 64, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = _randn(dev, 1, 2, 64, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("rows,d", [(64, 256), (33, 3072), (7, 30)])
def test_bias_gelu_kernel_matches_plain(dev, rows, d):
    x, b = _randn(dev, rows, d, seed=1), _randn(dev, d, seed=2)
    torch.testing.assert_close(fused.bias_gelu_kernel(x, b),
                               fused.bias_gelu_ref(x, b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("rows,d,act", [(8, 768, acts.gelu), (64, 256, None),
                                        (5, 30, acts.gelu)])
def test_layernorm_act_kernel_matches_plain(dev, rows, d, act):
    x = _randn(dev, rows, d, seed=3)
    g, b = _randn(dev, d, seed=4) * 0.1 + 1, _randn(dev, d, seed=5) * 0.1
    torch.testing.assert_close(
        fused.layernorm_act_kernel(x, g, b, 1e-5, act),
        fused.layernorm_act_ref(x, g, b, 1e-5, act), atol=1e-5, rtol=0)
