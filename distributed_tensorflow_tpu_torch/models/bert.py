"""BERT pretraining and masked-LM serving: port of ``models/bert.py``.

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

Attention follows the JAX auto rule: flash attention (the CUDA kernels on
a card) at sequence length >= 256, dense attention below.

Dropout runs only in ``forward(..., train=True)`` and draws its keep masks
from the ``torch.Generator`` the caller passes (never the global RNG), in
flax's form: keep with probability 1 - rate, kept values scaled by
1 / (1 - rate). With ``cfg.remat`` each encoder layer runs under
``torch.utils.checkpoint`` and its recompute restores the generator state
the layer started from, so the recomputed masks are the same.

Training half: :func:`make_bert_pretraining_loss` (MLM + NSP) and
:func:`make_bert_eval_metrics`, sharing :func:`_mlm_stats`.

Model parallelism, as in the JAX package, reads the active mesh
(:func:`..parallel.mesh.active_mesh`) where the JAX modules read the axes
their ``shard_map`` binds:

- ``model_axis``/``model_parallel`` (Megatron tensor parallelism): each
  rank holds ``num_heads / model_parallel`` heads of Q/K/V and the matching
  rows of the attention output projection, and ``intermediate_size /
  model_parallel`` of the FFN; the row-parallel outputs are summed over the
  axis (:func:`_tp_psum`) and ``out_bias``/``output_bias`` are added after
  the sum. Parameters are drawn global, as the unsharded model draws them,
  and sliced (:func:`bert_param_specs`, :func:`..interop.shard_params`);
- ``seq_axis`` with ``sp_impl`` ``"ring"`` or ``"ulysses"``: every
  ``[B, L]`` input holds this rank's slice of the sequence; positions are
  offset by the slice's start, attention runs over the global sequence
  (:mod:`..parallel.ring_attention`, :mod:`..parallel.ulysses`), the pooler
  takes the global ``[CLS]`` from the first slice, and the MLM sums are
  summed over the axis.

The expert and pipeline fields exist so configs carry over, and raise
``NotImplementedError`` when set: they come with Queue A item 6b.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.quant import dequantize_leaf
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    dense_attention,
    ring_attention,
)
from distributed_tensorflow_tpu_torch.parallel.ulysses import ulysses_attention


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
            "moe_experts": self.moe_experts != 0,
            "expert_axis": self.expert_axis is not None,
            "expert_parallel": self.expert_parallel != 1,
            "pipeline_axis": self.pipeline_axis is not None,
            "pipeline_parallel": self.pipeline_parallel != 1,
        }
        bad = [name for name, is_set in unported.items() if is_set]
        if bad:
            raise NotImplementedError(
                f"BertConfig fields {bad} (mixture-of-experts/expert/pipeline "
                "parallelism) are not ported yet: they come with Queue A item 6b"
            )
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")
        tp = self.model_parallel
        if tp < 1 or self.num_heads % tp or self.intermediate_size % tp:
            raise ValueError(
                f"model_parallel {tp} must divide num_heads {self.num_heads} and "
                f"intermediate_size {self.intermediate_size}")
        if tp > 1 and self.model_axis is None:
            raise ValueError("model_parallel > 1 needs a model_axis")


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def _global_config(cfg: BertConfig) -> BertConfig:
    """The unsharded model's config: what the parameters are drawn under."""
    return dataclasses.replace(cfg, seq_axis=None, model_axis=None, model_parallel=1)


def _seq_offset(cfg: BertConfig, l_local: int) -> int:
    """Global position of this rank's first token (0 without a seq axis)."""
    if cfg.seq_axis is None:
        return 0
    return coll.axis_index(cfg.seq_axis) * l_local


def _tp_psum(cfg: BertConfig, y):
    """Sum row-parallel partial outputs over the model axis (identity at
    model_parallel 1)."""
    if cfg.model_axis is not None and cfg.model_parallel > 1:
        return coll.psum(y, cfg.model_axis)
    return y


def _kernel(layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A ``Linear``'s weight in ``dtype``; an int8-packed one
    (:func:`~.quant.load_params`) is dequantized here, once a call."""
    if getattr(layer, "weight_q8", None) is not None:
        return dequantize_leaf({"_q8": layer.weight_q8, "_q8_scale": layer.weight_scale}, dtype)
    return layer.weight.to(dtype)


def _linear(x, layer: nn.Linear, dtype: torch.dtype):
    """flax ``Dense(dtype=dtype)``: inputs, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), _kernel(layer, dtype), bias)


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


def dropout(x, rate: float, train: bool, generator):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The mask comes from
    ``generator`` (a ``torch.Generator`` on x's device); identity unless
    ``train`` and ``rate > 0``."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.token_type = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)

    def forward(self, input_ids, token_type_ids, train=False, generator=None):
        dt = self.cfg.dtype
        l_local = input_ids.shape[1]
        positions = _seq_offset(self.cfg, l_local) + torch.arange(
            l_local, device=input_ids.device)
        x = (
            self.word(input_ids).to(dt)
            + self.position(positions).to(dt)[None]
            + self.token_type(token_type_ids).to(dt)
        )
        return dropout(self.ln(x), self.cfg.dropout_rate, train, generator)


class BertSelfAttention(nn.Module):
    """Multi-head attention, Megatron-sharded over ``cfg.model_axis``:
    column-parallel Q/K/V (this rank's ``num_heads / model_parallel``
    heads), attention per local head (the seq ring or Ulysses compose), a
    row-parallel output projection whose partial sums are summed over the
    axis, and ``out_bias`` added once, after the sum."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.head_dim = h // cfg.num_heads
        self.local_heads = cfg.num_heads // cfg.model_parallel
        width = self.local_heads * self.head_dim
        self.query = nn.Linear(h, width)
        self.key = nn.Linear(h, width)
        self.value = nn.Linear(h, width)
        self.out = nn.Linear(width, h, bias=False)
        self.out_bias = nn.Parameter(torch.zeros(h))
        self.ln = LayerNorm(h, 1e-12, cfg.dtype)

    def forward(self, x, mask, train=False, generator=None):
        cfg = self.cfg
        b, l, _ = x.shape
        shape = (b, l, self.local_heads, self.head_dim)
        q = _linear(x, self.query, cfg.dtype).view(shape)
        k = _linear(x, self.key, cfg.dtype).view(shape)
        v = _linear(x, self.value, cfg.dtype).view(shape)
        impl = cfg.attn_impl
        if impl == "auto":
            # The JAX package's measured crossover: flash from L = 256 up,
            # on the length the inner attention sees: the local shard for
            # the ring (its inner runs per L_local block), the gathered
            # sequence for Ulysses.
            eff_l = l
            if cfg.seq_axis is not None and cfg.sp_impl == "ulysses":
                eff_l = l * coll.axis_size(cfg.seq_axis)
            impl = "flash" if eff_l >= 256 else "dense"
        if cfg.seq_axis is not None:
            if cfg.sp_impl == "ulysses":
                ctx = ulysses_attention(q, k, v, cfg.seq_axis, mask=mask,
                                        inner="flash" if impl == "flash" else "dense")
            else:
                ctx = ring_attention(q, k, v, cfg.seq_axis, mask=mask,
                                     inner="flash" if impl == "flash" else "einsum")
        elif impl == "flash":
            ctx = flash_attention(q, k, v, mask=mask)
        else:
            ctx = dense_attention(q, k, v, mask=mask)
        out = _tp_psum(cfg, _linear(ctx.reshape(b, l, -1), self.out, cfg.dtype))
        out = out + self.out_bias.to(out.dtype)
        out = dropout(out, cfg.dropout_rate, train, generator)
        return self.ln(x + out)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        # Column-parallel up-projection, row-parallel down-projection with
        # its bias added after the sum over the model axis.
        ff = cfg.intermediate_size // cfg.model_parallel
        self.intermediate = nn.Linear(cfg.hidden_size, ff)
        self.output = nn.Linear(ff, cfg.hidden_size, bias=False)
        self.output_bias = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)

    def forward(self, x, mask, train=False, generator=None):
        dt = self.cfg.dtype
        x = self.attention(x, mask, train, generator)
        y = F.gelu(_linear(x, self.intermediate, dt), approximate="tanh")
        y = _tp_psum(self.cfg, _linear(y, self.output, dt))
        y = y + self.output_bias.to(y.dtype)
        y = dropout(y, self.cfg.dropout_rate, train, generator)
        return self.ln(x + y)


class BertModel(nn.Module):
    """Encoder + pooler. Returns (hidden [B,L,H], pooled [B,H])."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, attention_mask, token_type_ids, train=False,
                generator=None):
        mask = attention_mask.to(torch.bool).contiguous()
        x = self.embeddings(input_ids, token_type_ids, train, generator)
        for layer in self.layers:
            if self.cfg.remat and train and torch.is_grad_enabled():
                x = _remat_layer(layer, x, mask, generator)
            else:
                x = layer(x, mask, train, generator)
        first = x[:, 0]
        if self.cfg.seq_axis is not None:
            # The global [CLS] token lives on seq position 0: select it by a
            # sum over the axis, so every rank pools the same vector (its
            # gradient flows back to position 0 only).
            is_first = float(coll.axis_index(self.cfg.seq_axis) == 0)
            first = coll.psum(first * is_first, self.cfg.seq_axis)
        pooled = torch.tanh(_linear(first, self.pooler, self.cfg.dtype))
        return x, pooled


def _remat_layer(layer, x, mask, generator):
    """``layer`` under activation checkpointing (``nn.remat``'s
    counterpart): its activations are recomputed in the backward. The
    recompute first puts ``generator`` back to the state the layer started
    from, so it draws the same dropout masks."""
    start = None if generator is None else generator.get_state()

    def run(x, mask):
        if start is not None:
            generator.set_state(start)
        return layer(x, mask, True, generator)

    return checkpoint(run, x, mask, use_reentrant=False)


class BertForPreTraining(nn.Module):
    """MLM (tied decoder) + NSP heads over :class:`BertModel`.

    ``forward(input_ids, attention_mask, token_type_ids, *, train=False,
    generator=None) -> (mlm_logits [B, L, V], nsp_logits [B, 2])``;
    ``train=True`` turns dropout on, drawn from ``generator``. Parameters
    are created on ``device`` (default the card; raises without one) and
    drawn from ``generator`` (a ``torch.Generator`` on that device;
    default: seeded with ``seed``) with the JAX package's initialisers:
    normal(0.02) kernels and embeddings, zero biases, unit LayerNorm scales.
    Under ``model_parallel > 1`` they are drawn for the unsharded model and
    this rank's slices kept (the active mesh's coordinate on the model
    axis), so every layout starts from the same global parameters.
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
        if cfg.model_parallel > 1:
            from distributed_tensorflow_tpu_torch.interop import shard_params
            from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

            full = BertForPreTraining(_global_config(cfg), device=dev, generator=generator)
            local = shard_params(full.state_dict(), bert_param_specs(
                full.state_dict(), cfg.model_axis), active_mesh())
            self.load_state_dict(local)
        else:
            self._init_params(generator)

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

    def forward(self, input_ids, attention_mask, token_type_ids, *, train=False,
                generator=None):
        hidden, pooled = self.bert(input_ids, attention_mask, token_type_ids, train, generator)
        return self._heads(hidden, pooled)

    def serve_outputs(self, input_ids, attention_mask, token_type_ids):
        """Inference forward for the serving engine: ``(mlm_logits,
        nsp_logits, pooled)`` from one encoder pass."""
        hidden, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        mlm_logits, nsp_logits = self._heads(hidden, pooled)
        return mlm_logits, nsp_logits, pooled


# Rows of [rows, V] logits per f32 chunk in the MLM statistics: 2**26 f32
# elements (256 MiB) at any vocab, so the [B, L, V] logits are never
# upcast whole.
_CHUNK_ELEMENTS = 2**26


class _RowLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim, in f32, of logits kept in their storage
    dtype: the max shift, exp and sum run in f32 one row chunk at a time,
    and the backward emits softmax * g in the storage dtype, chunk by chunk
    (the JAX loss's convert-in-the-reduce, ``bert.py:656-674``)."""

    @staticmethod
    def forward(ctx, logits):
        flat = logits.reshape(-1, logits.shape[-1])
        rows = max(1, _CHUNK_ELEMENTS // flat.shape[1])
        lse = torch.empty(flat.shape[0], dtype=torch.float32, device=logits.device)
        for i in range(0, flat.shape[0], rows):
            lse[i:i + rows] = torch.logsumexp(flat[i:i + rows].float(), dim=-1)
        ctx.save_for_backward(logits, lse)
        return lse.view(logits.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        flat = logits.reshape(-1, logits.shape[-1])
        g = g.reshape(-1).float()
        rows = max(1, _CHUNK_ELEMENTS // flat.shape[1])
        grad = torch.empty_like(flat)
        for i in range(0, flat.shape[0], rows):
            sl = slice(i, i + rows)
            soft = torch.exp(flat[sl].float() - lse[sl, None])
            grad[sl] = (soft * g[sl, None]).to(grad.dtype)
        return grad.view(logits.shape)


def _mlm_stats(mlm_logits, batch, seq_axis=None):
    """MLM statistics shared by the train loss and the eval metrics: CE
    sum, masked-token count and correct count (targets < 0 are ignored),
    summed over ``seq_axis`` when the sequence is sharded, so every rank
    holds the global sums.

    The CE is taken in f32 from the logits' storage dtype
    (:class:`_RowLogSumExp`), never upcasting ``[B, L, V]`` whole. A masked
    position counts correct iff its target logit equals the row max (ties
    count correct), as in the JAX package.
    """
    targets = batch["mlm_targets"].long()
    weights = (targets >= 0).to(torch.float32)
    lse = _RowLogSumExp.apply(mlm_logits)
    tgt_logit = mlm_logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    ce = lse - tgt_logit.float()
    num = (ce * weights).sum()
    den = weights.sum()
    row_max = mlm_logits.detach().amax(dim=-1)
    correct = ((tgt_logit.detach() == row_max).to(torch.float32) * weights).sum()
    if seq_axis is not None:
        num = coll.psum(num, seq_axis)
        den = coll.psum(den, seq_axis)
        correct = coll.psum(correct, seq_axis)
    return num, den, correct


def _forward_batch(model, batch, train, generator=None):
    return model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"],
                 train=train, generator=generator)


def make_bert_pretraining_loss(model: BertForPreTraining):
    """Loss for the train step: MLM (ignore targets < 0) + NSP.

    ``loss_fn(params, model_state, batch, generator) -> (loss,
    (model_state, metrics))``. Batches: ``input_ids, attention_mask,
    token_type_ids, mlm_targets`` ``[B, L]`` and ``nsp_label [B]``.
    ``params`` are ``model``'s own parameters (the train state holds them
    by reference), so the forward reads them through ``model``; dropout
    draws from ``generator``. With ``cfg.seq_axis`` the MLM sums are summed
    over the axis, so every rank returns the global loss (the step's seq
    contract, :mod:`..train.step`).
    """
    seq_axis = model.cfg.seq_axis

    def loss_fn(params, model_state, batch, generator):
        del params
        mlm_logits, nsp_logits = _forward_batch(model, batch, True, generator)
        num, den, correct = _mlm_stats(mlm_logits, batch, seq_axis)
        den = den.clamp_min(1.0)
        mlm_loss = num / den
        nsp_loss = F.cross_entropy(nsp_logits.float(), batch["nsp_label"].long())
        metrics = {
            "mlm_loss": mlm_loss,
            "nsp_loss": nsp_loss,
            "mlm_accuracy": correct / den,
        }
        return mlm_loss + nsp_loss, (model_state, metrics)

    return loss_fn


def make_bert_eval_metrics(model: BertForPreTraining):
    """Eval ``metric_fn(params, model_state, batch)`` for
    :func:`~..train.step.make_eval_step`: MLM/NSP losses and accuracies on
    held-out batches, no dropout, no gradient. Every entry is a
    ``(num, den)`` pair, reduced as a global ratio; the MLM sums are
    summed over ``cfg.seq_axis`` first, as in the loss."""
    seq_axis = model.cfg.seq_axis

    def metric_fn(params, model_state, batch):
        del params, model_state
        with torch.no_grad():
            mlm_logits, nsp_logits = _forward_batch(model, batch, False)
            num, den, correct = _mlm_stats(mlm_logits, batch, seq_axis)
            labels = batch["nsp_label"].long()
            nsp_ce = F.cross_entropy(nsp_logits.float(), labels, reduction="sum")
            nsp_correct = (nsp_logits.argmax(-1) == labels).to(torch.float32).sum()
        rows = torch.tensor(float(labels.shape[0]), device=nsp_ce.device)
        return {
            "mlm_loss": (num, den),
            "mlm_accuracy": (correct, den),
            "nsp_loss": (nsp_ce, rows),
            "nsp_accuracy": (nsp_correct, rows),
        }

    return metric_fn


# The leaves Megatron tensor parallelism shards: (module, leaf) suffix of
# the parameter name -> the dimension of the torch tensor that the model
# axis splits (flax's column-parallel kernels [H, heads, d] are rows of the
# torch [heads*d, H] weight; the row-parallel ones are its columns).
_TP_RULES = (
    (("query", "weight"), 0), (("key", "weight"), 0), (("value", "weight"), 0),
    (("query", "bias"), 0), (("key", "bias"), 0), (("value", "bias"), 0),
    (("out", "weight"), 1),
    (("intermediate", "weight"), 0), (("intermediate", "bias"), 0),
    (("output", "weight"), 1),
)


def bert_param_specs(params, model_axis: str | None = "model") -> dict:
    """The tensor-parallel sharding of BERT's parameters (JAX
    ``bert_param_specs`` for the model axis), in the port's form: for each
    name of ``params`` (a state dict of the GLOBAL model), ``(model_axis,
    dim)`` for a leaf the axis shards along ``dim``, or None for a
    replicated one. Q/K/V weights and biases and the FFN up-projection are
    column-parallel, the attention output and FFN down-projection
    row-parallel; embeddings, LayerNorms, the post-sum biases, the pooler
    and the heads are replicated. ``model_axis=None`` replicates everything.
    The expert and pipeline rules come with Queue A item 6b."""
    specs = {}
    for name in params:
        parts = tuple(name.split("."))
        spec = None
        if model_axis is not None:
            for suffix, dim in _TP_RULES:
                if parts[-len(suffix):] == suffix:
                    spec = (model_axis, dim)
                    break
        specs[name] = spec
    return specs
