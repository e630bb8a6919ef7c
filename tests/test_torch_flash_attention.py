"""Port parity: the PyTorch flash-attention forward against the JAX package.

Inputs come from numpy and go through both; the JAX kernels run in Pallas
interpret mode (off-TPU default), the port through its plain path (CPU
tensors). fp32 throughout, atol 2e-5: both compute f32 scores and sums
from the same values, so only summation order differs.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_block,
    flash_attention_reference,
)
from distributed_tensorflow_tpu_torch.parallel.ring_attention import dense_attention

# The package re-exports the function under the module's name.
flash_mod = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")

ATOL = 2e-5


def _qkv(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3)]


def _mask(b, l):
    m = np.ones((b, l), bool)
    m[0, l * 2 // 3:] = False   # padded tail
    if b > 1:
        m[1, : l // 4] = False  # masked head
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so the card-only tests below also run
    on a host without JAX (``pytest --noconftest -k kernel``)."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import flash_attention
    from distributed_tensorflow_tpu.ops.flash_attention import flash_attention_block
    from distributed_tensorflow_tpu.parallel.ring_attention import dense_attention

    return SimpleNamespace(jnp=jnp, flash=flash_attention,
                           block=flash_attention_block, dense=dense_attention)


@pytest.mark.parametrize(
    "h,d",
    [(4, 32), (2, 64), (3, 16)],
    ids=["flat-4x32", "flat-2x64", "bh-3x16"],
)
def test_flash_block_matches_jax(jx, h, d):
    """o and lse of flash_attention_block, packed and bh geometries."""
    q, k, v = _qkv(0, 2, 32, h, d)
    m = _mask(2, 32)
    jnp = jx.jnp
    o_ref, lse_ref = jx.block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        block_q=16, block_k=16,
    )
    o, lse = flash_attention_block(_t(q), _t(k), _t(v), _t(m), block_q=16, block_k=16)
    assert o.shape == (2, 32, h, d) and lse.shape == (2, h, 32)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL, rtol=1e-6)


def test_flash_fully_masked_rows_zero_and_neg_lse(jx):
    q, k, v = _qkv(1, 2, 16, 2, 8)
    m = np.ones((2, 16), bool)
    m[1] = False  # every key of batch row 1 masked
    jnp = jx.jnp
    o_ref, lse_ref = jx.block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        block_q=16, block_k=16,
    )
    o, lse = flash_attention_block(_t(q), _t(k), _t(v), _t(m), block_q=16, block_k=16)
    assert torch.all(o[1] == 0)
    assert torch.all(lse[1] == -1e30)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_array_equal(lse[1].numpy(), np.asarray(lse_ref)[1])


@pytest.mark.parametrize(
    "l,bq,bk",
    [(48, 32, 16), (24, 16, 24)],
    ids=["pad-48-to-64", "bq-ne-bk-lcm"],
)
def test_flash_padding_paths_match_jax(jx, l, bq, bk):
    """Ragged L pads to lcm(block_q, block_k) with masked keys, rows sliced."""
    q, k, v = _qkv(2, 2, l, 2, 16)
    m = _mask(2, l)
    jnp = jx.jnp
    ref = jx.flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        block_q=bq, block_k=bk,
    )
    out = flash_attention(_t(q), _t(k), _t(v), _t(m), block_q=bq, block_k=bk)
    assert out.shape == (2, l, 2, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_matches_dense_and_reference(jx):
    """The plain path agrees with the ported dense attention and with the
    JAX dense attention, and the reference is the padded wrapper's core."""
    q, k, v = _qkv(3, 2, 40, 3, 8)
    m = _mask(2, 40)
    out = flash_attention(_t(q), _t(k), _t(v), _t(m), block_q=16, block_k=16)
    dense = dense_attention(_t(q), _t(k), _t(v), _t(m))
    ref_o, _ = flash_attention_reference(_t(q), _t(k), _t(v), _t(m))
    jnp = jx.jnp
    jd = jx.dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), ref_o.numpy(), atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jd), atol=ATOL)


def test_flash_packing_is_validated_and_result_free():
    q, k, v = (_t(x) for x in _qkv(4, 1, 16, 2, 64))
    base = flash_attention(q, k, v)
    for packing in ("flat", "bh"):
        torch.testing.assert_close(flash_attention(q, k, v, packing=packing), base)
    q3, k3, v3 = (_t(x) for x in _qkv(4, 1, 16, 3, 16))
    with pytest.raises(ValueError, match="packing='flat'"):
        flash_attention(q3, k3, v3, packing="flat")
    with pytest.raises(ValueError, match="packing must be"):
        flash_attention(q, k, v, packing="lanes")
    with pytest.raises(ValueError, match="no multiple-of-8 divisor"):
        flash_attention_block(*(_t(x) for x in _qkv(4, 1, 12, 2, 8)))


def test_flash_backward_raises_until_training_slice():
    q, k, v = (_t(x).requires_grad_() for x in _qkv(5, 1, 16, 2, 8))
    out = flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_flash_cpu_path_never_counts_a_launch():
    flash_mod.reset_launch_counts()
    flash_attention(*(_t(x) for x in _qkv(6, 1, 16, 2, 8)))
    assert flash_mod.LAUNCHES["flash_fwd"] == 0


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, atol):
    """The CUDA kernel against its plain version on the card: bf16 within
    1e-2 (P rounds to bf16 per 64-key tile in the kernel, once in the plain
    version), fp32 within 1e-4; lse within 1e-3 either way."""
    q, k, v = (_t(x).to(cuda_device, dtype) for x in _qkv(7, 2, 300, 12, 64))
    m = _t(_mask(2, 300)).to(cuda_device)
    before = flash_mod.LAUNCHES["flash_fwd"]
    o, lse = flash_mod.flash_fwd_cuda(q, k, v, m)  # ragged L = 300
    assert flash_mod.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, m)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_kernel_runs_in_bert_forward(cuda_device):
    """At L >= 256 every BERT layer attends through the kernel: one launch
    per layer per forward."""
    from distributed_tensorflow_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
    )

    cfg = BertConfig(vocab_size=64, hidden_size=128, num_layers=3, num_heads=2,
                     intermediate_size=256, max_position=256, dtype=torch.bfloat16)
    model = BertForPreTraining(cfg, device=cuda_device)
    ids = torch.randint(0, 64, (2, 256), device=cuda_device)
    mask = torch.ones(2, 256, dtype=torch.bool, device=cuda_device)
    flash_mod.reset_launch_counts()
    with torch.inference_mode():
        logits, _, _ = model.serve_outputs(ids, mask, torch.zeros_like(ids))
    torch.cuda.synchronize()
    assert flash_mod.LAUNCHES["flash_fwd"] == 3
    assert torch.isfinite(logits.float()).all()
