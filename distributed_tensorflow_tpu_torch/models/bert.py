"""BERT for masked-LM serving: port of ``models/bert.py``, dense path.

Original BERT-base (Devlin et al.): post-LayerNorm encoder, learned
positions, tanh-GELU FFN, tied MLM decoder, NSP head; 12L/768H/12A/3072FF/
vocab 30522 at :class:`BertConfig`'s defaults.

Numerics follow the flax modules they replace:

- parameters may be stored in any float dtype; every layer casts its inputs,
  weights and biases to ``cfg.dtype`` (flax's ``Dense(dtype=...)``);
- LayerNorm statistics and the affine step run in f32 with the fast
  variance E[x^2] - E[x]^2 (flax's ``LayerNorm(dtype=bf16)``), eps 1e-12,
  output cast to ``cfg.dtype``;
- the NSP head runs in f32; the MLM logits keep ``cfg.dtype``.

Attention follows the JAX auto rule: flash attention (the CUDA kernel on a
card) at sequence length >= 256, dense attention below.

The tensor-, sequence-, expert- and pipeline-parallel fields of
:class:`BertConfig` exist so configs carry over, and raise
``NotImplementedError`` when set: they come with the model-parallel slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.parallel.ring_attention import dense_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32
    seq_axis: str | None = None
    sp_impl: str = "ring"
    model_axis: str | None = None
    model_parallel: int = 1
    # "auto" (flash for L >= 256, dense below), "dense" or "flash".
    attn_impl: str = "auto"
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    expert_axis: str | None = None
    expert_parallel: int = 1
    moe_dispatch: str = "replicated"
    moe_topk: int = 1
    pipeline_axis: str | None = None
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0
    # Activation rematerialisation is a training lever; the forward is the
    # same with or without it.
    remat: bool = False

    def __post_init__(self):
        unported = {
            "seq_axis": self.seq_axis is not None,
            "model_axis": self.model_axis is not None,
            "model_parallel": self.model_parallel != 1,
            "moe_experts": self.moe_experts != 0,
            "expert_axis": self.expert_axis is not None,
            "expert_parallel": self.expert_parallel != 1,
            "pipeline_axis": self.pipeline_axis is not None,
            "pipeline_parallel": self.pipeline_parallel != 1,
        }
        bad = [name for name, is_set in unported.items() if is_set]
        if bad:
            raise NotImplementedError(
                f"BertConfig fields {bad} (sequence/tensor/expert/pipeline "
                "parallelism) are ported with the model-parallel slice"
            )


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def _linear(x, layer: nn.Linear, dtype: torch.dtype):
    """flax ``Dense(dtype=dtype)``: inputs, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` semantics: f32 statistics (fast variance) and f32
    affine step whatever the input dtype, result in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.token_type = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, input_ids, token_type_ids):
        dt = self.cfg.dtype
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (
            self.word(input_ids).to(dt)
            + self.position(positions).to(dt)[None]
            + self.token_type(token_type_ids).to(dt)
        )
        return self.dropout(self.ln(x))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.head_dim = h // cfg.num_heads
        width = cfg.num_heads * self.head_dim
        self.query = nn.Linear(h, width)
        self.key = nn.Linear(h, width)
        self.value = nn.Linear(h, width)
        self.out = nn.Linear(width, h, bias=False)
        self.out_bias = nn.Parameter(torch.zeros(h))
        self.ln = LayerNorm(h, 1e-12, cfg.dtype)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask):
        cfg = self.cfg
        b, l, _ = x.shape
        shape = (b, l, cfg.num_heads, self.head_dim)
        q = _linear(x, self.query, cfg.dtype).view(shape)
        k = _linear(x, self.key, cfg.dtype).view(shape)
        v = _linear(x, self.value, cfg.dtype).view(shape)
        impl = cfg.attn_impl
        if impl == "auto":
            # The JAX package's measured crossover: flash from L = 256 up.
            impl = "flash" if l >= 256 else "dense"
        if impl == "flash":
            ctx = flash_attention(q, k, v, mask=mask)
        else:
            ctx = dense_attention(q, k, v, mask=mask)
        out = _linear(ctx.reshape(b, l, -1), self.out, cfg.dtype)
        out = out + self.out_bias.to(out.dtype)
        return self.ln(x + self.dropout(out))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)
        self.output_bias = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask):
        dt = self.cfg.dtype
        x = self.attention(x, mask)
        y = F.gelu(_linear(x, self.intermediate, dt), approximate="tanh")
        y = _linear(y, self.output, dt)
        y = y + self.output_bias.to(y.dtype)
        return self.ln(x + self.dropout(y))


class BertModel(nn.Module):
    """Encoder + pooler. Returns (hidden [B,L,H], pooled [B,H])."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, attention_mask, token_type_ids):
        mask = attention_mask.to(torch.bool)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            x = layer(x, mask)
        pooled = torch.tanh(_linear(x[:, 0], self.pooler, self.cfg.dtype))
        return x, pooled


class BertForPreTraining(nn.Module):
    """MLM (tied decoder) + NSP heads over :class:`BertModel`.

    ``forward(input_ids, attention_mask, token_type_ids) -> (mlm_logits
    [B, L, V], nsp_logits [B, 2])``. Parameters are created on ``device``
    (default the card; raises without one) and drawn from ``generator`` (a
    ``torch.Generator`` on that device; default: seeded with ``seed``) with
    the JAX package's initialisers: normal(0.02) kernels and embeddings,
    zero biases, unit LayerNorm scales.
    """

    def __init__(self, cfg: BertConfig, *, device="cuda", generator=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.nsp_head = nn.Linear(cfg.hidden_size, 2)
        self.to(dev)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(seed)
        self._init_params(generator)
        # Serving slice: inference mode (no dropout) unless .train() is asked.
        self.eval()

    @torch.no_grad()
    def _init_params(self, generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            if isinstance(mod, nn.Linear) and mod.bias is not None:
                mod.bias.zero_()

    def _heads(self, hidden, pooled):
        dt = self.cfg.dtype
        h = self.mlm_ln(F.gelu(_linear(hidden, self.mlm_transform, dt), approximate="tanh"))
        # Tied decoder against the word-embedding table; logits keep the
        # compute dtype (the largest tensor of the forward).
        mlm_logits = F.linear(
            h, self.bert.embeddings.word.weight.to(dt), self.mlm_bias.to(dt)
        )
        nsp_logits = _linear(pooled, self.nsp_head, torch.float32)
        return mlm_logits, nsp_logits

    def forward(self, input_ids, attention_mask, token_type_ids):
        hidden, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        return self._heads(hidden, pooled)

    def serve_outputs(self, input_ids, attention_mask, token_type_ids):
        """Inference forward for the serving engine: ``(mlm_logits,
        nsp_logits, pooled)`` from one encoder pass."""
        hidden, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        mlm_logits, nsp_logits = self._heads(hidden, pooled)
        return mlm_logits, nsp_logits, pooled
