"""Port parity: the 1x1-conv ops with the dgrad kernel, and the wgrad
kernel's plain version, against the JAX package.

Inputs come from numpy and go through both; the JAX kernels run in Pallas
interpret mode (off-TPU default), the port through its plain versions (CPU
tensors). f32 for the ops: values and gradients within 1e-5, as the JAX
package holds its own Pallas gradients against a plain dot
(``tests/test_pointwise_conv.py``); bf16 in, f32 out for the wgrad. JAX is imported inside the tests so
that the card-only tests also run where JAX is not installed.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import pointwise_conv as pc

TOL = 1e-5


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _jax_value_and_grads(fn, *arrays):
    import jax
    import jax.numpy as jnp

    def loss(*args):
        y = fn(*args)
        return jnp.sum(jnp.sin(y)), y

    (_, y), grads = jax.value_and_grad(loss, argnums=tuple(range(len(arrays))),
                                       has_aux=True)(*arrays)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _torch_value_and_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = fn(*ts)
    torch.sin(y).sum().backward()
    return y, [t.grad.numpy() for t in ts]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m,k,n,routed", [(128, 128, 128, True), (64, 32, 48, False)])
def test_pointwise_matmul_matches_jax(m, k, n, routed):
    jpc = importlib.import_module("distributed_tensorflow_tpu.ops.pointwise_conv")

    x, w = _arrays(m + k + n, (m, k), (k, n), scale=0.5)
    assert pc._supported(m, k, n) == jpc._supported(m, k, n) == routed
    y_ref, (gx_ref, gw_ref) = _jax_value_and_grads(jpc.pointwise_matmul, x, w)
    y, (gx, gw) = _torch_value_and_grads(pc.pointwise_matmul, x, w)
    assert (type(y.grad_fn).__name__ == "_PwMatmulBackward") == routed
    _close(y.detach(), y_ref)
    _close(gx, gx_ref)
    _close(gw, gw_ref)


def test_pointwise_conv_strided_matches_jax():
    jpc = importlib.import_module("distributed_tensorflow_tpu.ops.pointwise_conv")

    x, w4 = _arrays(1, (2, 8, 8, 128), (1, 1, 128, 128), scale=0.3)
    assert pc._supported(2 * 4 * 4, 128, 128)
    y_ref, grads_ref = _jax_value_and_grads(lambda a, b: jpc.pointwise_conv(a, b, 2), x, w4)
    y, grads = _torch_value_and_grads(lambda a, b: pc.pointwise_conv(a, b, 2), x, w4)
    assert y.shape == (2, 4, 4, 128)
    _close(y.detach(), y_ref)
    for g, r in zip(grads, grads_ref):
        _close(g, r)


def test_pointwise_conv_n64_matches_jax():
    jpc = importlib.import_module("distributed_tensorflow_tpu.ops.pointwise_conv")

    x4, w = _arrays(2, (2, 4, 8, 128), (128, 64), scale=0.3)
    y_ref, (dx_ref, dw_ref) = _jax_value_and_grads(jpc.pointwise_conv_n64, x4, w)
    y, (dx, dw) = _torch_value_and_grads(pc.pointwise_conv_n64, x4, w)
    assert type(y.grad_fn).__name__ == "_Pw4dN64Backward"
    _close(y.detach(), y_ref)
    _close(dx, dx_ref)
    _close(dw, dw_ref)


@pytest.fixture(scope="module")
def jax_wgrad():
    """The JAX package's wgrad kernel in Pallas interpret mode, jitted."""
    import jax

    jpc = importlib.import_module("distributed_tensorflow_tpu.ops.pointwise_conv")
    return jax.jit(lambda x2, g: jpc._wgrad_pallas(x2, g, interpret=True))


@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (2048, 128, 256)])
def test_wgrad_reference_matches_jax_pallas_wgrad(jax_wgrad, m, k, n):
    """bf16 inputs, f32 ``[K, N]`` out. (2048, 128, 256) runs the JAX
    kernel over two 1024-row tiles, summed across its sequential grid; the
    plain version sums all M at once. bf16 x bf16 products are exact in
    f32, so only the order of the f32 sums differs: within 1e-5 of the
    largest |dW|."""
    import jax.numpy as jnp

    x, g = _arrays(m + n, (m, k), (m, n))
    ref = np.asarray(jax_wgrad(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)))
    assert ref.dtype == np.float32
    for fn in (pc.wgrad_reference, pc.wgrad):
        dw = fn(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
        assert dw.dtype == torch.float32 and dw.shape == (k, n)
        np.testing.assert_allclose(dw.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n,route", [(1000, 256, 128, "pw_dgrad"),
                                          (4099, 128, 64, "pw_dgrad_n64")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dgrad_kernel_matches_plain_version(cuda_device, m, k, n, route, dtype):
    """The kernel against its plain version on the card (M = 4099 ragged):
    bf16 within one bf16 rounding step of the plain value (both round the
    same f32 sum once, summed in another order), fp32 within 1e-4."""
    g, w = (torch.from_numpy(a).to(cuda_device, dtype)
            for a in _arrays(3, (m, n), (k, n), scale=1.0))
    w = w * n**-0.5
    before = pc.LAUNCHES[route]
    dx = pc.dgrad_cuda(g, w, route)
    assert pc.LAUNCHES[route] == before + 1
    ref = pc.dgrad_reference(g, w)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs() + 1e-3
    assert torch.all((dx.float() - ref.float()).abs() <= tol)


def test_dgrad_kernel_runs_in_backward(cuda_device):
    """On CUDA tensors the autograd backward launches the kernel (and a
    refused operand raises instead of falling back)."""
    x = torch.randn(256, 128, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(128, 128, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    pc.reset_launch_counts()
    pc.pointwise_matmul(x, w).float().sum().backward()
    torch.cuda.synchronize()
    assert pc.LAUNCHES == {"pw_dgrad": 1, "pw_dgrad_n64": 0, "pw_wgrad": 0}
    with pytest.raises(TypeError):
        pc.dgrad_cuda(x.detach().half(), w.detach().half())


@pytest.mark.parametrize("m,k,n", [(25091, 256, 128), (4099, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgrad_kernel_matches_plain_version(cuda_device, m, k, n, dtype):
    """The wgrad kernel against its plain version on the card (ragged M,
    several M splits): f32 out, exact products summed over M in another
    order, within 1e-5 of the largest |dW|."""
    x2, g = (torch.from_numpy(a).to(cuda_device, dtype) for a in _arrays(4, (m, k), (m, n)))
    before = pc.LAUNCHES["pw_wgrad"]
    dw = pc.wgrad(x2, g)
    assert pc.LAUNCHES["pw_wgrad"] == before + 1
    ref = pc.wgrad_reference(x2, g)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32
    assert (dw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
