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
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

B, H, W, K, N = 4, 4, 8, 128, 128


def _load_pw_bench():
    """``scripts/torch_pw_bench.py``, which holds the shape tables of the
    fused kernels' main paths and their risk shapes."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_pw_bench.py"
    spec = importlib.util.spec_from_file_location("torch_pw_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_PWB = _load_pw_bench()


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


def _bn_apply_inputs(seed, m, k, n, relu_scale=1.0):
    """dA, z, x, W and the packed [8, N] constants of an apply pass, from
    numpy, with the batch statistics and s1/M, s2/M of the plain reduce."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    da = rng.standard_normal((m, n)).astype(np.float32)
    z = x @ w
    mean = z.mean(0)
    inv = 1.0 / np.sqrt((z * z).mean(0) - mean * mean + 1e-5)
    gamma = (rng.random(n) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return x, w, da, z.astype(np.float32), [a.astype(np.float32) for a in (mean, inv, gamma, beta)]


@pytest.mark.parametrize("relu", [True, False])
def test_bn_bwd_apply_dw_reference_matches_jax(relu):
    """The plain dW of the apply pass against the dW of the JAX package's
    ``_bn_bwd_apply`` (Pallas interpret mode) at a ragged M (208: no whole
    number of the card kernel's 64-row chunks) and N = 160 (Inception's,
    partway through a 128-column tile), with the ReLU mask on and off. f32
    operands: the same dz from the same f32 steps, summed over M in
    another order, within 1e-5 of the largest |dW|."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import fused_conv_bn as jfcb

    m, k, n = 208, 128, 160
    x, w, da, z, stats = _bn_apply_inputs(30 + relu, m, k, n)
    c0 = fcb._pack_consts(*(torch.from_numpy(a) for a in stats))
    s1, s2 = fcb.bn_bwd_reduce_reference(torch.from_numpy(da), torch.from_numpy(z), c0, relu)
    consts = fcb._pack_consts(*(torch.from_numpy(a) for a in stats), s1 / m, s2 / m)
    _, ref = jfcb._bn_bwd_apply(jnp.asarray(da), jnp.asarray(z), jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(consts.numpy()), relu, True)
    ref = np.asarray(ref)
    dw = fcb.bn_bwd_apply_dw_reference(torch.from_numpy(da), torch.from_numpy(z),
                                       torch.from_numpy(x), consts, relu)
    assert dw.dtype == torch.float32 and dw.shape == (k, n)
    np.testing.assert_allclose(dw.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("relu", [True, False])
def test_bn_bwd_reduce_reference_matches_jax(relu):
    """The plain reduce against the JAX package's ``_bn_bwd_reduce`` (Pallas
    interpret mode) at (208, 128, 160), with the ReLU mask on and off: the
    same f32 terms summed over M in another order, within 1e-5 of the sum
    of their magnitudes."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import fused_conv_bn as jfcb

    m, k, n = 208, 128, 160
    _, _, da, z, stats = _bn_apply_inputs(40 + relu, m, k, n)
    c0 = fcb._pack_consts(*(torch.from_numpy(a) for a in stats))
    r1, r2 = jfcb._bn_bwd_reduce(jnp.asarray(da), jnp.asarray(z), jnp.asarray(c0.numpy()), relu,
                                 True)
    s1, s2 = fcb.bn_bwd_reduce_reference(torch.from_numpy(da), torch.from_numpy(z), c0, relu)
    g, xh = fcb._g_xhat(torch.from_numpy(da), torch.from_numpy(z), c0, relu)
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == s2.shape == (n,)
    for got, ref, mag in ((s1, r1, g.abs().sum(0)), (s2, r2, (g * xh).abs().sum(0))):
        assert np.all(np.abs(got.numpy() - np.asarray(ref)) <= 1e-5 * mag.numpy() + 1e-6)


@pytest.mark.parametrize("relu", [True, False])
def test_bn_bwd_apply_dx_reference_matches_jax(relu):
    """The plain dx of the apply pass against the dx of the JAX package's
    ``_bn_bwd_apply`` (Pallas interpret mode) at (208, 128, 160) (N partway
    through a 64-column chunk of the card kernels), with the ReLU mask on
    and off. f32 operands: the same dz from the same f32 steps, its
    products over N summed in another order, within 1e-5 of the largest
    |dx|."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import fused_conv_bn as jfcb

    m, k, n = 208, 128, 160
    x, w, da, z, stats = _bn_apply_inputs(50 + relu, m, k, n)
    c0 = fcb._pack_consts(*(torch.from_numpy(a) for a in stats))
    s1, s2 = fcb.bn_bwd_reduce_reference(torch.from_numpy(da), torch.from_numpy(z), c0, relu)
    consts = fcb._pack_consts(*(torch.from_numpy(a) for a in stats), s1 / m, s2 / m)
    ref, _ = jfcb._bn_bwd_apply(jnp.asarray(da), jnp.asarray(z), jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(consts.numpy()), relu, True)
    ref = np.asarray(ref)
    dx = fcb.bn_bwd_apply_dx_reference(torch.from_numpy(da), torch.from_numpy(z),
                                       torch.from_numpy(w), consts, relu)
    assert dx.dtype == torch.float32 and dx.shape == (m, k)
    np.testing.assert_allclose(dx.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# (M, K, N) of the bf16 dW kernel's main paths: ResNet-50's 12 fused unit
# shapes and its N = 64 unit at b=128, Inception-v3's 12 at 299x299, 128
# images; then ragged and small shapes and the card tests' risk shapes.
_RESNET50_SHAPES = [_PWB.mkn(*sh) for sh in (*_PWB.RESNET50, *_PWB.RESNET50_N64)]
_INCEPTION_SHAPES = [_PWB.mkn(*sh) for sh in _PWB.INCEPTION_FUSED]
_RAGGED_SHAPES = [(1, 128, 128), (63, 128, 128), (65, 256, 200), (208, 128, 160),
                  (777777, 128, 128), (12345, 4096, 4096)]
_DW_PLAN_SHAPES = list(dict.fromkeys(_RESNET50_SHAPES + _INCEPTION_SHAPES + _RAGGED_SHAPES
                                     + _PWB.BN_RISK_SHAPES))


@pytest.mark.parametrize("m,k,n", _DW_PLAN_SHAPES)
def test_bn_dw_split_plan_covers_every_row_once(m, k, n):
    """The M ranges of the bf16 dW kernel: whole 64-row chunks, consecutive
    and non-empty, together exactly [0, M), so no range reads another's
    rows; at most 65535 of them (the grid's z limit)."""
    rows = fcb.dw_rows_per_split(m, k, n, 132)
    splits = -(-m // rows)
    assert rows % 64 == 0 and 1 <= splits <= 65535
    bounds = [(z * rows, min(m, (z + 1) * rows)) for z in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("m,k,n", _DW_PLAN_SHAPES)
def test_bn_dw_split_plan_fills_one_wave(m, k, n):
    """The blocks of the bf16 dW kernel (one per dW tile, 256 rows of K
    where K > 128 else 128 by 128 columns, and M range) fill at most one
    wave of the H100's 132 SMs: one range where the tiles alone leave no
    room for a second; otherwise ranges one 64-row chunk shorter would
    overflow the wave, unless every range is already a single chunk. A
    range takes at most 4096 rows (the accumulators' precision), which
    alone may add splits."""
    rows = fcb.dw_rows_per_split(m, k, n, 132)
    tile_rows = fcb._dw_tile_rows(k)
    splits, tiles, chunks = -(-m // rows), -(-k // tile_rows) * -(-n // 128), -(-m // 64)
    assert rows <= 4096  # the range cap, which may add splits past one wave
    if rows == 4096:
        assert m > 4096
    elif 2 * tiles > 132:
        assert splits == 1
    else:
        assert tiles * splits <= 132
        assert rows == 64 or tiles * -(-chunks // (rows // 64 - 1)) > 132


@pytest.mark.parametrize("m,k,n", _DW_PLAN_SHAPES)
def test_bn_dx_plan_covers_every_row_and_column_once(m, k, n):
    """The tiles of the bf16 dx kernel: N <= 512 takes the strip kernel
    (128 rows, dz of all N resident: at most 8 atoms of 64 columns, over a
    group of whole 128-column K tiles); N > 512 the panel kernel (64 rows,
    256 columns of K where K <= 256, else 512). Strips of M and groups of K
    are consecutive and non-empty and cover [0, M) and [0, K) exactly
    once; no more groups than K tiles."""
    plan = fcb.dx_plan(m, k, n, 132)
    if n <= 512:
        assert plan.kernel == "strip" and plan.rows == 128 and -(-n // 64) <= 8
        assert plan.k_cols % 128 == 0 and 128 <= plan.k_cols <= 128 * -(-k // 128)
    else:
        assert plan == ("panel", 64, 256 if k <= 256 else 512)
    for extent, step in ((m, plan.rows), (k, plan.k_cols)):
        bounds = [(lo, min(extent, lo + step)) for lo in range(0, extent, step)]
        assert bounds[0][0] == 0 and bounds[-1][1] == extent
        assert all(lo < hi for lo, hi in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_bn_dx_plan_regimes_of_the_model_shapes():
    """The regimes the models' shapes take: every Inception-v3 unit and
    ResNet-50's reducing units in the strip kernel, dz made once per strip
    where the strips fill the SMs many times over (ResNet-50's stages 1-2),
    twice on the 17x17 grid (289 strips) and where M is small (6272 and
    8192 rows: 49 and 64 strips), three times at 3200 rows; the expanding
    units in the panel kernel with all of K in one tile, except (6272,
    1024, 2048), which takes two (dz made twice)."""
    def groups(m, k, n):
        plan = fcb.dx_plan(m, k, n, 132)
        return plan.kernel, -(-k // plan.k_cols)

    for m, k, n in [(401408, 256, 128), (100352, 512, 128), (100352, 128, 512)]:
        assert groups(m, k, n) == ("strip", 1), (m, k, n)
    for m, k, n in [(36992, 768, 192), (8192, 1280, 192), (8192, 2048, 448), (6272, 2048, 512)]:
        assert groups(m, k, n) == ("strip", 2), (m, k, n)
    assert groups(3200, 768, 128) == ("strip", 3)
    assert fcb.dx_plan(25088, 256, 1024, 132) == ("panel", 64, 256)
    assert fcb.dx_plan(6272, 512, 2048, 132) == ("panel", 64, 512)
    assert fcb.dx_plan(6272, 1024, 2048, 132) == ("panel", 64, 512)  # two ranges of K
    panel = [(m, k, n) for m, k, n in _RESNET50_SHAPES if n > 512]
    assert sorted({(k, n) for _, k, n in panel}) == [(256, 1024), (512, 1024), (512, 2048),
                                                     (1024, 2048)]


@pytest.mark.parametrize("m,k,n", _DW_PLAN_SHAPES)
@pytest.mark.parametrize("fp32", [False, True])
def test_bn_reduce_plan_covers_every_row_and_column_once(m, k, n, fp32):
    """The blocks of the reduce kernel: strips of 128 bytes of columns (64
    bf16, 32 fp32) cover [0, N) once; M ranges of whole 128-row boxes are
    consecutive, non-empty and cover [0, M) once; together one wave of the
    H100's 132 SMs at two blocks each, and as many ranges as that wave
    holds unless every range is already one box."""
    cols, rows = fcb.reduce_plan(m, n, fp32, 132)
    assert cols == (32 if fp32 else 64) and rows % 128 == 0
    strips, splits = -(-n // cols), -(-m // rows)
    assert strips * cols >= n > (strips - 1) * cols
    bounds = [(z * rows, min(m, (z + 1) * rows)) for z in range(splits)]
    assert bounds[-1][1] == m and all(lo < hi for lo, hi in bounds)
    assert strips * splits <= 264 or splits == 1
    assert rows == 128 or strips * -(-m // (rows - 128)) > 264


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


def _card_apply_inputs(device, dtype, m, k, n, seed):
    x, w, da, z, stats = _bn_apply_inputs(seed, m, k, n)
    x_t, w_t, da_t = (torch.from_numpy(a).to(device, dtype) for a in (x, w, da))
    z_t = torch.matmul(x_t, w_t)
    zf = z_t.float()
    mean = zf.mean(0)
    inv = torch.rsqrt(zf.square().mean(0) - mean.square() + 1e-5)
    gamma, beta = (torch.from_numpy(a).to(device) for a in stats[2:])
    return x_t, w_t, da_t, z_t, (mean, inv, gamma, beta)


def _apply_consts(da, z, stats, relu):
    """The apply pass's constants from the plain reduce (s1/M, s2/M)."""
    m = da.shape[0]
    r1, r2 = fcb.bn_bwd_reduce_reference(da, z, fcb._pack_consts(*stats), relu)
    return fcb._pack_consts(*stats, r1 / m, r2 / m)


@pytest.mark.parametrize("m,k,n", _PWB.BN_RISK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_apply_dw_kernel_risk_shapes_match_plain_version(cuda_device, m, k, n, dtype, relu):
    """The dW kernel against its plain version at the risk shapes: f32 dW,
    exact products summed over M in another order, within 1e-5 of the
    largest |dW|; two runs give the same bits (fixed-order sums, no
    atomics)."""
    x, _, da, z, stats = _card_apply_inputs(cuda_device, dtype, m, k, n, m + k + n)
    consts = _apply_consts(da, z, stats, relu)
    before = fcb.LAUNCHES["bn_bwd_apply_dw"]
    dw = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
    again = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
    assert fcb.LAUNCHES["bn_bwd_apply_dw"] == before + 2
    ref = fcb.bn_bwd_apply_dw_reference(da, z, x, consts, relu)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32 and torch.isfinite(dw).all()
    assert (dw - ref).abs().max() <= 1e-5 * ref.abs().max() + 1e-5
    assert torch.equal(dw.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("m,n", [(2048, 160), (1000, 200)])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_apply_dw_kernel_dz_is_the_plain_versions(cuda_device, m, n, relu):
    """With x2 the identity (M = K), dW = x2^T dz is dz itself, every other
    term an exact zero: the kernel's dz, ReLU mask and bf16 rounding
    included, equals the plain version's bit for bit, over several M
    ranges (2048: 4 ranges) and a ragged one (1000)."""
    _, _, da, z, stats = _card_apply_inputs(cuda_device, torch.bfloat16, m, m, n, m + n)
    x = torch.eye(m, device=cuda_device, dtype=torch.bfloat16)
    consts = _apply_consts(da, z, stats, relu)
    dw = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
    dz = fcb._dz(da, z, consts, relu, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(dw, dz.float())


# ResNet-50's 12 fused shapes, Inception-v3's 12 and the risk shapes.
_DX_CARD_SHAPES = list(dict.fromkeys(
    [_PWB.mkn(*sh) for sh in (*_PWB.RESNET50, *_PWB.INCEPTION_FUSED)] + _PWB.BN_RISK_SHAPES))


@pytest.mark.parametrize("m,k,n", _DX_CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_apply_dx_kernel_matches_plain_version(cuda_device, m, k, n, dtype, relu):
    """The dx kernels (bf16: the strip kernel at N <= 512, the panel kernel
    above; fp32: the first design) against the plain dx: the same dz,
    summed over N in another order; bf16 within one bf16 rounding step of
    the plain value (2^-7 |ref|) plus 1e-3, fp32 within 1e-4."""
    _, w, da, z, stats = _card_apply_inputs(cuda_device, dtype, m, k, n, m + k + n)
    consts = _apply_consts(da, z, stats, relu)
    before = fcb.LAUNCHES["bn_bwd_apply_dx"]
    dx = fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, relu)
    assert fcb.LAUNCHES["bn_bwd_apply_dx"] == before + 1
    ref = fcb.bn_bwd_apply_dx_reference(da, z, w, consts, relu).float()
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.abs() + 1e-3
    assert dx.dtype == dtype and dx.shape == (m, k)
    assert torch.all((dx.float() - ref).abs() <= tol)


@pytest.mark.parametrize("m,n", [(1000, 160), (2048, 512), (1000, 1024), (777, 520)])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_apply_dx_kernel_dz_is_the_plain_versions(cuda_device, m, n, relu):
    """With K = N and W the identity, dx = dz W^T is dz itself, every other
    product an exact zero: the kernel's dz, ReLU mask and bf16 rounding
    included, equals the plain version's bit for bit, in the strip kernel
    (N = 160, 512) and the panel kernel (N = 1024: two ranges of K; 520:
    a chunk 8 columns wide), at an M that is no whole number of strips."""
    _, _, da, z, stats = _card_apply_inputs(cuda_device, torch.bfloat16, m, n, n, m + n)
    w = torch.eye(n, device=cuda_device, dtype=torch.bfloat16)
    consts = _apply_consts(da, z, stats, relu)
    dx = fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, relu)
    dz = fcb._dz(da, z, consts, relu, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(dx, dz)


def _reduce_inputs(device, dtype, m, n, seed):
    _, _, da, z, stats = _card_apply_inputs(device, dtype, m, 128, n, seed)
    return da, z, stats


@pytest.mark.parametrize("m,n", [(401408, 128), (6272, 2048), (1000, 200)])
def test_bn_reduce_kernel_repeats_bitwise_and_under_graph_replay(cuda_device, m, n):
    """The reduce sums over M in a fixed order inside its one launch: two
    launches give the same bits, and so do two replays of one CUDA graph
    that holds it (its tickets reset themselves)."""
    da, z, stats = _reduce_inputs(cuda_device, torch.bfloat16, m, n, m + n)
    consts = fcb._pack_consts(*stats)
    first = fcb.bn_bwd_reduce_cuda(da, z, consts, True)
    again = fcb.bn_bwd_reduce_cuda(da, z, consts, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fcb.bn_bwd_reduce_cuda(da, z, consts, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fcb.bn_bwd_reduce_cuda(da, z, consts, True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip((*again, *replayed), (*first, *first)):
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    r1, r2 = fcb.bn_bwd_reduce_reference(da, z, consts, True)
    g, xh = fcb._g_xhat(da, z, consts, True)
    assert torch.all((first[0] - r1).abs() <= 1e-5 * g.abs().sum(0) + 1e-6)
    assert torch.all((first[1] - r2).abs() <= 1e-5 * (g * xh).abs().sum(0) + 1e-6)


@pytest.mark.parametrize("m,n,dtype", [(25088, 256, torch.bfloat16),
                                       (36992, 160, torch.bfloat16), (17, 8, torch.bfloat16),
                                       (4099, 200, torch.float32)])
def test_bn_reduce_kernel_constant_rows_are_the_plain_paths(cuda_device, m, n, dtype):
    """With ``write_consts`` the reduce writes s1/M and s2/M into rows 4-5
    of the constants bit for bit as the CPU path divides the same s1 and s2
    (``s / m`` on CPU tensors: IEEE division, where PyTorch's CUDA division
    by a Python number multiplies by the reciprocal), and leaves the other
    rows as they were."""
    da, z, stats = _reduce_inputs(cuda_device, dtype, m, n, m + n)
    consts = fcb._pack_consts(*stats)
    before = consts.clone()
    s1, s2 = fcb.bn_bwd_reduce_cuda(da, z, consts, True, write_consts=True)
    torch.cuda.synchronize()
    assert torch.equal(consts[4].cpu(), s1.cpu() / m)
    assert torch.equal(consts[5].cpu(), s2.cpu() / m)
    assert torch.equal(consts[:4], before[:4]) and torch.equal(consts[6:], before[6:])
