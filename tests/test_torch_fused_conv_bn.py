"""Port parity: the fused 1x1-conv + BatchNorm (+ReLU) op against the JAX
package.

Inputs come from numpy and go through both; the JAX kernels run in Pallas
interpret mode (off-TPU default), the port through its plain backward (CPU
tensors). f32 throughout, at the JAX tests' geometry and anchors
(``tests/test_fused_conv_bn.py``): B, H, W, K, N = 4, 4, 8, 128, 128,
forward within 1e-5 and gradients within 2e-4 (the BN-backward sums over M
run in another order). JAX is imported inside the tests so that the
card-only tests also run where JAX is not installed.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

B, H, W, K, N = 4, 4, 8, 128, 128


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, K)).astype(np.float32)
    kernel = (rng.standard_normal((1, 1, K, N)) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(N)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return x, kernel, gamma, beta


@pytest.mark.parametrize("relu,strides", [(True, 1), (False, 1), (True, 2)])
def test_conv1x1_bn_act_matches_jax(relu, strides):
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops.fused_conv_bn import conv1x1_bn_act

    arrays = _inputs(10 + strides + 2 * relu)

    def jax_loss(*args):
        a, mean, var = conv1x1_bn_act(*args, relu=relu, strides=strides)
        return jnp.sum(jnp.sin(a * 0.7)), (a, mean, var)

    (_, outs_ref), grads_ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                  has_aux=True)(*arrays)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    a, mean, var = fcb.conv1x1_bn_act(*ts, relu=relu, strides=strides)
    assert a.shape == (B, H // strides, W // strides, N)
    assert not mean.requires_grad and not var.requires_grad
    torch.sin(a * 0.7).sum().backward()
    for got, ref in zip((a, mean, var), outs_ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    for t, ref, name in zip(ts, grads_ref, ("dx", "dW", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=2e-4, err_msg=name)


def test_fused_supported_matches_jax(monkeypatch):
    jfcb = importlib.import_module("distributed_tensorflow_tpu.ops.fused_conv_bn")

    shapes = [(100352, 512, 128), (25088, 1024, 256), (401408, 256, 64),
              (401408, 64, 256), (100353, 512, 128), (6272, 2048, 512), (128, 128, 128),
              (16, 4096, 4096), (32, 4097, 128)]
    assert fcb.fused_supported(100352, 512, 128)
    assert not fcb.fused_supported(401408, 256, 64)   # N = 64
    assert not fcb.fused_supported(100353, 512, 128)  # M does not tile
    for env in ({}, {"FUSED_CONV_BN_MAXM": "30000"}, {"FUSED_CONV_BN_MINM": "30000"}):
        for key in ("FUSED_CONV_BN_MAXM", "FUSED_CONV_BN_MINM"):
            monkeypatch.delenv(key, raising=False)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        for shape in shapes:
            assert fcb.fused_supported(*shape) == jfcb.fused_supported(*shape), (env, shape)
    with pytest.raises(ValueError, match="fused_supported"):
        t = torch.zeros(1, 2, 2, 64)
        fcb.conv1x1_bn_act(t, torch.zeros(64, 64), torch.ones(64), torch.zeros(64), relu=True)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1024, 256, 128), (2051, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_bwd_kernels_match_plain_versions(cuda_device, m, k, n, dtype, relu):
    """Reduce, apply-dx and apply-dW against their plain versions on the
    card (M = 2051 ragged). s1, s2 and dW are f32 sums over M in another
    order (1e-5 of the terms' magnitudes); dx within one bf16 rounding
    step in bf16, 1e-4 in fp32."""
    gen = torch.Generator(cuda_device).manual_seed(m + n)
    x = torch.randn(m, k, device=cuda_device, generator=gen).to(dtype)
    w = (torch.randn(k, n, device=cuda_device, generator=gen) * k**-0.5).to(dtype)
    z = torch.matmul(x, w)
    da = torch.randn(m, n, device=cuda_device, generator=gen).to(dtype)
    zf = z.float()
    mean = zf.mean(0)
    inv = torch.rsqrt(zf.square().mean(0) - mean.square() + 1e-5)
    gamma = torch.rand(n, device=cuda_device, generator=gen) + 0.5
    beta = torch.randn(n, device=cuda_device, generator=gen) * 0.5
    consts = fcb._pack_consts(mean, inv, gamma, beta)
    s1, s2 = fcb.bn_bwd_reduce_cuda(da, z, consts, relu)
    r1, r2 = fcb.bn_bwd_reduce_reference(da, z, consts, relu)
    g, xh = fcb._g_xhat(da, z, consts, relu)
    assert torch.all((s1 - r1).abs() <= 1e-5 * g.abs().sum(0) + 1e-6)
    assert torch.all((s2 - r2).abs() <= 1e-5 * (g * xh).abs().sum(0) + 1e-6)
    consts = fcb._pack_consts(mean, inv, gamma, beta, r1 / m, r2 / m)
    dx = fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, relu)
    rdx = fcb.bn_bwd_apply_dx_reference(da, z, w, consts, relu)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * rdx.float().abs() + 1e-3
    assert dx.dtype == dtype and torch.all((dx.float() - rdx.float()).abs() <= tol)
    dw = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
    rdw = fcb.bn_bwd_apply_dw_reference(da, z, x, consts, relu)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32
    assert (dw - rdw).abs().max() <= 1e-5 * rdw.abs().max() + 1e-5


def test_fused_unit_launches_each_kernel_once(cuda_device):
    """On CUDA tensors the fused op's backward is the three kernels, once
    each, and matches the plain backward of the same op on the CPU."""
    arrays = _inputs(5)
    grads = {}
    for dev in ("cpu", cuda_device):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
        fcb.reset_launch_counts()
        a, _, _ = fcb.conv1x1_bn_act(*ts, relu=True)
        torch.sin(a * 0.7).sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    assert fcb.LAUNCHES == {"bn_bwd_reduce": 1, "bn_bwd_apply_dx": 1, "bn_bwd_apply_dw": 1}
    for got, ref in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)
