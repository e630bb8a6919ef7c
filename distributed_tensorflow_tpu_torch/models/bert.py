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

- ``moe_experts`` > 0 replaces every layer's FFN with a Switch (top-1) or
  GShard (``moe_topk=2``) mixture of experts (:class:`MoeFfn`,
  :mod:`..parallel.moe`); ``expert_axis``/``expert_parallel`` shard the
  experts, dispatched ``"replicated"``, ``"alltoall"`` or ``"sharded"``
  (the batch rows split over the expert axis too). Each layer returns its
  load-balance aux beside its output (flax ``sow``s it); the loss averages
  it over the layers and adds ``moe_aux_weight`` times it;
- ``pipeline_axis``/``pipeline_parallel``: the encoder's parameters are one
  stacked ``[num_layers, ...]`` tree (``bert.encoder.layer.*``, flax's
  ``nn.scan`` layout; :class:`StackedEncoder`), and with a live pipeline
  axis each rank holds its stage's layers and the encoder runs the GPipe
  schedule (:func:`..parallel.pipeline.pipeline_apply`) over
  ``pipeline_microbatches`` (0: ``4 * pipeline_parallel``) microbatches,
  each (layer, microbatch) with its slice of the attention mask and its own
  dropout generator. With ``pipeline_parallel > 1`` and no axis the stacked
  tree runs sequentially (serving a pipeline checkpoint on one process).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.quant import dequantize_leaf
from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.moe import moe_apply, moe_apply_a2a
from distributed_tensorflow_tpu_torch.parallel.pipeline import pipeline_apply
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
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")
        tp = self.model_parallel
        if tp < 1 or self.num_heads % tp or self.intermediate_size % tp:
            raise ValueError(
                f"model_parallel {tp} must divide num_heads {self.num_heads} and "
                f"intermediate_size {self.intermediate_size}")
        if tp > 1 and self.model_axis is None:
            raise ValueError("model_parallel > 1 needs a model_axis")
        if self.moe_dispatch not in ("replicated", "alltoall", "sharded"):
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}")
        ep = self.expert_parallel
        if self.moe_dispatch == "sharded" and ep <= 1:
            raise ValueError("moe_dispatch='sharded' routes from the expert-sharded batch "
                             "— it requires expert_parallel > 1")
        if self.moe_experts < 0 or ep < 1 or (ep > 1 and (not self.moe_experts
                                                          or self.moe_experts % ep)):
            raise ValueError(f"expert_parallel {ep} must divide moe_experts "
                             f"{self.moe_experts}")
        if ep > 1 and self.expert_axis is None:
            raise ValueError("expert_parallel > 1 needs an expert_axis")
        if self.moe_experts and not 1 <= self.moe_topk <= self.moe_experts:
            raise ValueError(f"moe_topk {self.moe_topk} must be in [1, moe_experts "
                             f"{self.moe_experts}]")
        pp = self.pipeline_parallel
        if pp < 1 or self.num_layers % pp:
            raise ValueError(f"num_layers {self.num_layers} not divisible by "
                             f"pipeline_parallel {pp}")
        if self.pipeline_microbatches < 0:
            raise ValueError(f"pipeline_microbatches must be >= 0 (0: 4 x stages), got "
                             f"{self.pipeline_microbatches}")

    @property
    def stacked(self) -> bool:
        """The encoder's parameters are one stacked tree (a pipeline config)."""
        return self.pipeline_axis is not None or self.pipeline_parallel > 1

    @property
    def pipelined(self) -> bool:
        """The encoder runs the GPipe schedule over ``pipeline_axis``."""
        return self.pipeline_axis is not None and self.pipeline_parallel > 1

    @property
    def local_layers(self) -> int:
        """The encoder layers this rank holds."""
        return self.num_layers // self.pipeline_parallel if self.pipelined else self.num_layers


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def _global_config(cfg: BertConfig) -> BertConfig:
    """The unsharded model's config: what the parameters are drawn under
    (every expert, every layer; a stacked encoder stays stacked)."""
    return dataclasses.replace(
        cfg, seq_axis=None, model_axis=None, model_parallel=1, expert_axis=None,
        expert_parallel=1, moe_dispatch="replicated",
        pipeline_axis=None if cfg.pipeline_parallel > 1 else cfg.pipeline_axis)


def _sharded(cfg: BertConfig) -> bool:
    return cfg.model_parallel > 1 or cfg.expert_parallel > 1 or cfg.pipelined


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


class MoeFfn(nn.Module):
    """The mixture-of-experts FFN (JAX ``MoeFfn``): an f32 router with no
    bias, and this rank's experts stacked ``[e_local, ...]``, each a
    tanh-GELU FFN whose hidden dim is Megatron-sharded over
    ``cfg.model_axis`` (``experts_w1``/``experts_b1`` column-parallel,
    ``experts_w2`` row-parallel, ``experts_b2`` entering as ``b2 / tp`` so
    the sum over the model axis adds it once). The attention mask is the
    routing's ``valid``: pads take no capacity. The routing statistics are
    summed over ``"seq"`` under sequence parallelism, and over the expert
    axis under the all-to-all dispatch of replicated tokens; the sharded
    dispatch keeps per-group statistics. ``forward`` returns ``(y, aux)``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        ff = cfg.intermediate_size // cfg.model_parallel
        e_local = cfg.moe_experts // cfg.expert_parallel
        self.router = nn.Linear(h, cfg.moe_experts, bias=False)
        self.experts_w1 = nn.Parameter(torch.empty(e_local, h, ff))
        self.experts_b1 = nn.Parameter(torch.zeros(e_local, ff))
        self.experts_w2 = nn.Parameter(torch.empty(e_local, ff, h))
        self.experts_b2 = nn.Parameter(torch.zeros(e_local, h))

    def _experts(self, p, tokens):
        dt, tp = self.cfg.dtype, self.cfg.model_parallel
        t = F.gelu(torch.bmm(tokens, p["w1"].to(dt)) + p["b1"].to(dt)[:, None],
                   approximate="tanh")
        return torch.bmm(t, p["w2"].to(dt)) + (p["b2"].to(dt) / tp)[:, None]

    def forward(self, x, mask=None):
        cfg = self.cfg
        b, l, h = x.shape
        tokens = x.reshape(b * l, h)
        # An int8-packed router (serving) dequantizes to the compute dtype,
        # as the JAX engine's dequantize_params does; the logits stay f32.
        router = (self.router.weight if getattr(self.router, "weight_q8", None) is None
                  else _kernel(self.router, cfg.dtype))
        logits = F.linear(tokens.float(), router.float())
        stats_axes = () if cfg.seq_axis is None else (cfg.seq_axis,)
        experts = {"w1": self.experts_w1, "b1": self.experts_b1, "w2": self.experts_w2,
                   "b2": self.experts_b2}
        kwargs = dict(capacity_factor=cfg.moe_capacity_factor,
                      valid=None if mask is None else mask.reshape(b * l), topk=cfg.moe_topk)
        if cfg.moe_dispatch == "sharded":
            y, aux = moe_apply_a2a(self._experts, experts, logits, tokens,
                                   axis_name=cfg.expert_axis, stats_axes=stats_axes,
                                   tokens_sharded=True, **kwargs)
        elif cfg.moe_dispatch == "alltoall" and cfg.expert_parallel > 1:
            y, aux = moe_apply_a2a(self._experts, experts, logits, tokens,
                                   axis_name=cfg.expert_axis,
                                   stats_axes=stats_axes + (cfg.expert_axis,), **kwargs)
        else:
            y, aux = moe_apply(self._experts, experts, logits, tokens,
                               axis_name=cfg.expert_axis if cfg.expert_parallel > 1 else None,
                               stats_axes=stats_axes, **kwargs)
        return _tp_psum(cfg, y).reshape(b, l, h), aux


class BertLayer(nn.Module):
    """Attention, then the dense FFN or :class:`MoeFfn`. ``forward`` returns
    ``(x, aux)``: aux the MoE's load-balance loss, None for a dense FFN."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        if cfg.moe_experts:
            self.moe = MoeFfn(cfg)
        else:
            # Column-parallel up-projection, row-parallel down-projection
            # with its bias added after the sum over the model axis.
            ff = cfg.intermediate_size // cfg.model_parallel
            self.intermediate = nn.Linear(cfg.hidden_size, ff)
            self.output = nn.Linear(ff, cfg.hidden_size, bias=False)
            self.output_bias = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)

    def forward(self, x, mask, train=False, generator=None):
        dt = self.cfg.dtype
        x = self.attention(x, mask, train, generator)
        aux = None
        if self.cfg.moe_experts:
            # Dropped tokens emit 0 and ride the residual.
            y, aux = self.moe(x, mask)
        else:
            y = F.gelu(_linear(x, self.intermediate, dt), approximate="tanh")
            y = _tp_psum(self.cfg, _linear(y, self.output, dt))
            y = y + self.output_bias.to(y.dtype)
        y = dropout(y, self.cfg.dropout_rate, train, generator)
        return self.ln(x + y), aux


def _mean_aux(auxes: list):
    return None if not auxes or auxes[0] is None else sum(auxes) / len(auxes)


def _derived_generator(device, seed: int, *data: int) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` mixed with ``data``."""
    from distributed_tensorflow_tpu_torch.train.step import fold_in

    return torch.Generator(device).manual_seed(fold_in(seed, *data))


class StackedEncoder(nn.Module):
    """The encoder of a pipeline config: one :class:`BertLayer` whose every
    parameter is stacked ``[cfg.local_layers, ...]`` (``encoder.layer.*``,
    flax ``nn.scan``'s tree), layer ``i`` run on slice ``i`` through
    ``torch.func.functional_call``. With ``cfg.pipelined`` the stack is this
    stage's and the layers run the GPipe schedule; otherwise sequentially.
    ``forward`` returns ``(x, aux)``, aux the mean over the layers."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = BertLayer(cfg)
        n = cfg.local_layers
        for mod in self.layer.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(p.detach()[None].repeat(n, *(1,) * p.dim())))

    def _run(self, params: dict, x, mask, train, generator):
        return torch.func.functional_call(self.layer, params, (x, mask, train, generator))

    def _layer(self, i: int, x, mask, train, generator):
        return self._run({n: p[i] for n, p in self.layer.named_parameters()}, x, mask,
                         train, generator)

    def forward(self, x, mask, train=False, generator=None):
        cfg = self.cfg
        if cfg.pipelined:
            return self._pipelined(x, mask, train, generator)
        auxes = []
        for i in range(cfg.local_layers):
            if cfg.remat and train and torch.is_grad_enabled():
                x, aux = _remat_layer(functools.partial(self._layer, i), x, mask, generator)
            else:
                x, aux = self._layer(i, x, mask, train, generator)
            auxes.append(aux)
        return x, _mean_aux(auxes)

    def _pipelined(self, x, mask, train, generator):
        """The GPipe schedule over this stage's layers: each (layer,
        microbatch) reads its microbatch's rows of ``mask`` and draws its
        dropout from a generator derived from (one draw of ``generator``,
        layer, microbatch), so a recompute or a skipped tick draws nothing
        stray; under ``cfg.remat`` each (layer, microbatch) is
        checkpointed."""
        from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

        cfg = self.cfg
        mesh = active_mesh()
        if mesh.shape.get(cfg.pipeline_axis, 1) != cfg.pipeline_parallel:
            raise ValueError(
                f"pipeline_parallel {cfg.pipeline_parallel} needs a "
                f"{cfg.pipeline_parallel}-way {cfg.pipeline_axis!r} axis on the active mesh, "
                f"which is {dict(mesh.shape)}")
        M = cfg.pipeline_microbatches or 4 * cfg.pipeline_parallel
        B, L = mask.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by pipeline_microbatches {M}")
        mask_mb = mask.reshape(M, B // M, L)
        seed = None
        if train and cfg.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("dropout in train mode needs an explicit torch.Generator")
            seed = int(torch.randint(0, 2**62, (), generator=generator,
                                     device=generator.device))
        moe = cfg.moe_experts > 0
        remat = cfg.remat and train and torch.is_grad_enabled()

        def call(p_one, h, ctx):
            gen = (None if seed is None
                   else _derived_generator(h.device, seed, ctx["layer"], ctx["microbatch"]))
            return self._run(p_one, h, mask_mb[ctx["microbatch"]], train, gen)

        def layer_fn(p_one, h, ctx):
            if remat:
                out = checkpoint(lambda h_: call(p_one, h_, ctx), h, use_reentrant=False)
            else:
                out = call(p_one, h, ctx)
            return out if moe else out[0]

        out = pipeline_apply(layer_fn, dict(self.layer.named_parameters()), x,
                             axis_name=cfg.pipeline_axis, n_microbatches=M,
                             with_context=True, with_aux=moe)
        return out if moe else (out, None)


class BertModel(nn.Module):
    """Encoder + pooler. Returns ``(hidden [B,L,H], pooled [B,H], aux)``,
    aux the MoE load-balance loss averaged over the layers (None for dense
    FFNs)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        if cfg.stacked:
            self.encoder = StackedEncoder(cfg)
        else:
            self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, attention_mask, token_type_ids, train=False,
                generator=None):
        mask = attention_mask.to(torch.bool).contiguous()
        x = self.embeddings(input_ids, token_type_ids, train, generator)
        if self.cfg.stacked:
            x, aux = self.encoder(x, mask, train, generator)
        else:
            auxes = []
            for layer in self.layers:
                if self.cfg.remat and train and torch.is_grad_enabled():
                    x, a = _remat_layer(layer, x, mask, generator)
                else:
                    x, a = layer(x, mask, train, generator)
                auxes.append(a)
            aux = _mean_aux(auxes)
        first = x[:, 0]
        if self.cfg.seq_axis is not None:
            # The global [CLS] token lives on seq position 0: select it by a
            # sum over the axis, so every rank pools the same vector (its
            # gradient flows back to position 0 only).
            is_first = float(coll.axis_index(self.cfg.seq_axis) == 0)
            first = coll.psum(first * is_first, self.cfg.seq_axis)
        pooled = torch.tanh(_linear(first, self.pooler, self.cfg.dtype))
        return x, pooled, aux


def _remat_layer(layer, x, mask, generator):
    """``layer`` (a module or a function of the same arguments) under
    activation checkpointing (``nn.remat``'s counterpart): its activations
    are recomputed in the backward. The
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
    Under a sharded layout (``model_parallel``, ``expert_parallel`` or
    ``pipeline_parallel`` > 1 with its axis) they are drawn for the
    unsharded model and this rank's slices kept (the active mesh's
    coordinates), so every layout starts from the same global parameters. A
    stacked encoder is drawn as the module list and stacked, so a pipeline
    config starts from the parameters of the same config without it.
    """

    def __init__(self, cfg: BertConfig, *, device="cuda", generator=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # Made on the device: every value below is drawn or loaded anew,
        # so the modules' own initialisation need not run on the host.
        with dev:
            self.bert = BertModel(cfg)
            self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
            self.mlm_ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)
            self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
            self.nsp_head = nn.Linear(cfg.hidden_size, 2)
        if dev.type == "meta":
            return  # a template: every value is loaded into it
        if generator is None:
            generator = torch.Generator(dev).manual_seed(seed)
        if _sharded(cfg):
            from distributed_tensorflow_tpu_torch.interop import shard_params
            from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

            full = BertForPreTraining(_global_config(cfg), device=dev, generator=generator)
            local = shard_params(full.state_dict(), bert_param_specs(
                full.state_dict(), cfg.model_axis if cfg.model_parallel > 1 else None,
                cfg.expert_axis if cfg.expert_parallel > 1 else None,
                cfg.pipeline_axis if cfg.pipelined else None), active_mesh())
            self.load_state_dict(local)
        elif cfg.stacked:
            flat = BertForPreTraining(
                dataclasses.replace(cfg, pipeline_axis=None, pipeline_parallel=1),
                device=dev, generator=generator)
            self.load_state_dict(stack_layer_state(flat.state_dict(), cfg.num_layers))
        else:
            self._init_params(generator)

    @torch.no_grad()
    def _init_params(self, generator) -> None:
        for mod in self.modules():
            if isinstance(mod, MoeFfn):
                mod.experts_w1.normal_(0.0, 0.02, generator=generator)
                mod.experts_w2.normal_(0.0, 0.02, generator=generator)
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
        mlm_logits, nsp_logits, _ = self.forward_with_aux(
            input_ids, attention_mask, token_type_ids, train=train, generator=generator)
        return mlm_logits, nsp_logits

    def forward_with_aux(self, input_ids, attention_mask, token_type_ids, *, train=False,
                         generator=None):
        """:meth:`forward` and the MoE load-balance aux averaged over the
        layers (None for dense FFNs): ``(mlm_logits, nsp_logits, aux)``."""
        hidden, pooled, aux = self.bert(input_ids, attention_mask, token_type_ids, train,
                                        generator)
        return (*self._heads(hidden, pooled), aux)

    def serve_outputs(self, input_ids, attention_mask, token_type_ids):
        """Inference forward for the serving engine: ``(mlm_logits,
        nsp_logits, pooled)`` from one encoder pass."""
        hidden, pooled, _ = self.bert(input_ids, attention_mask, token_type_ids)
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
    return model.forward_with_aux(batch["input_ids"], batch["attention_mask"],
                                  batch["token_type_ids"], train=train, generator=generator)


def make_bert_pretraining_loss(model: BertForPreTraining):
    """Loss for the train step: MLM (ignore targets < 0) + NSP.

    ``loss_fn(params, model_state, batch, generator) -> (loss,
    (model_state, metrics))``. Batches: ``input_ids, attention_mask,
    token_type_ids, mlm_targets`` ``[B, L]`` and ``nsp_label [B]``.
    ``params`` are ``model``'s own parameters (the train state holds them
    by reference), so the forward reads them through ``model``; dropout
    draws from ``generator``. With ``cfg.seq_axis`` the MLM sums are summed
    over the axis, so every rank returns the global loss (the step's seq
    contract, :mod:`..train.step`). A MoE model adds ``moe_aux_weight``
    times the layers' mean load-balance aux, reported as ``moe_aux``.
    """
    seq_axis = model.cfg.seq_axis
    moe = model.cfg.moe_experts > 0

    def loss_fn(params, model_state, batch, generator):
        del params
        mlm_logits, nsp_logits, moe_aux = _forward_batch(model, batch, True, generator)
        num, den, correct = _mlm_stats(mlm_logits, batch, seq_axis)
        den = den.clamp_min(1.0)
        mlm_loss = num / den
        nsp_loss = F.cross_entropy(nsp_logits.float(), batch["nsp_label"].long())
        metrics = {
            "mlm_loss": mlm_loss,
            "nsp_loss": nsp_loss,
            "mlm_accuracy": correct / den,
        }
        loss = mlm_loss + nsp_loss
        if moe:
            loss = loss + model.cfg.moe_aux_weight * moe_aux
            metrics["moe_aux"] = moe_aux
        return loss, (model_state, metrics)

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
            mlm_logits, nsp_logits, _ = _forward_batch(model, batch, False)
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
# torch [heads*d, H] weight; the row-parallel ones are its columns). The
# expert stacks keep flax's [E, in, out] layout.
_TP_RULES = (
    (("query", "weight"), 0), (("key", "weight"), 0), (("value", "weight"), 0),
    (("query", "bias"), 0), (("key", "bias"), 0), (("value", "bias"), 0),
    (("out", "weight"), 1),
    (("intermediate", "weight"), 0), (("intermediate", "bias"), 0),
    (("output", "weight"), 1),
    (("experts_w1",), 2), (("experts_w2",), 1), (("experts_b1",), 1),
)
_EXPERT_LEAVES = ("experts_w1", "experts_b1", "experts_w2", "experts_b2")


def spec_axes(spec) -> tuple[str, ...]:
    """The mesh axes a spec of :func:`bert_param_specs` shards over."""
    return () if spec is None else tuple(axis for axis, _ in spec)


def bert_param_specs(params, model_axis: str | None = "model",
                     expert_axis: str | None = None,
                     pipeline_axis: str | None = None) -> dict:
    """BERT's parameter sharding (JAX ``bert_param_specs``) in the port's
    form: for each name of ``params`` (a state dict of the GLOBAL model), a
    tuple of ``(axis, dim)`` pairs, one for each mesh axis that splits the
    torch tensor along ``dim``, or None for a replicated leaf. An axis given
    as None shards nothing.

    - ``model_axis`` (Megatron TP): Q/K/V weights and biases and the FFN
      up-projection column-parallel, the attention output and FFN
      down-projection row-parallel; the MoE experts' hidden dim
      (``experts_w1``/``experts_b1`` column, ``experts_w2`` row);
    - ``expert_axis``: dim 0 of every ``experts_*`` stack;
    - ``pipeline_axis``: the leading ``[num_layers]`` dim of every leaf of
      the stacked encoder (``encoder`` in the name), the other rules behind
      it, one dim further in.

    Embeddings, LayerNorms, the post-sum biases, the router, the pooler and
    the heads are replicated."""
    specs = {}
    for name in params:
        parts = tuple(name.split("."))
        stacked = pipeline_axis is not None and "encoder" in parts
        shift = 1 if "encoder" in parts else 0
        pairs = []
        if stacked:
            pairs.append((pipeline_axis, 0))
        if expert_axis is not None and parts[-1] in _EXPERT_LEAVES:
            pairs.append((expert_axis, shift))
        if model_axis is not None:
            for suffix, dim in _TP_RULES:
                if parts[-len(suffix):] == suffix:
                    pairs.append((model_axis, dim + shift))
                    break
        specs[name] = tuple(pairs) or None
    return specs


def stack_layer_state(state_dict: dict, num_layers: int) -> dict:
    """A module-list state dict (``bert.layers.<i>.*``) in the stacked
    encoder's form (``bert.encoder.layer.*``, leading ``[num_layers]``)."""
    out = {k: v for k, v in state_dict.items() if not k.startswith("bert.layers.")}
    rests = dict.fromkeys(k.split(".", 3)[3] for k in state_dict if k.startswith("bert.layers."))
    for rest in rests:
        out[f"bert.encoder.layer.{rest}"] = torch.stack(
            [state_dict[f"bert.layers.{i}.{rest}"] for i in range(num_layers)])
    return out


def unstack_layer_state(state_dict: dict) -> dict:
    """Inverse of :func:`stack_layer_state`."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("bert.encoder.layer."):
            rest = k.removeprefix("bert.encoder.layer.")
            for i in range(v.shape[0]):
                out[f"bert.layers.{i}.{rest}"] = v[i]
        else:
            out[k] = v
    return out
