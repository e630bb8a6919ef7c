"""Decoder-only causal LM, the generative serving workload (port of
``models/causal_lm.py``).

The transformer block is BERT's (:mod:`.bert`) reassembled for decoding:
post-LayerNorm residual blocks, learned positions, tanh-GELU FFN and a TIED
LM head (``transform -> LN -> logits against the word-embedding table``).
Parameter names match BERT's (``query``/``key``/``value``/``out``/
``intermediate``/``output`` and the ``*_bias`` twins), so :mod:`..interop`
maps the flax tree with BERT's rules.

Five forwards share one set of parameters:

- ``forward(input_ids, attention_mask) -> logits [B, L, V]``: the full
  causally-masked forward (training loss, and the one-shot reference the
  decode path is held to);
- ``prefill(input_ids, attention_mask) -> (logits, k [nl, B, L, h, d], v)``;
- ``decode_step(token [S], position [S], k_cache, v_cache)``: one token a
  cache slot, written at ``position``, attending positions ``<= position``;
- ``prefill_chunk(input_ids [B, C], positions [B, C], k_cache, v_cache)``: a
  chunk of each row's prompt at absolute positions against per-row caches;
- ``verify_step(tokens [S, K+1], positions, k_cache, v_cache)``: speculative
  decoding's verify, which is ``prefill_chunk`` with ``C = K + 1``.

**Caches.** A cache is ``[nl, S, Lc + 1, h, d]`` (or the int8 dict ``{"q":
int8[nl, S, Lc + 1, h, d], "s": f32[nl, S, Lc + 1]}``): ``Lc`` positions
plus one SPARE position that attention never reads. The JAX package drops
the writes of idle and padding lanes (position ``== Lc``) with
``mode="drop"``; here those writes land in the spare position, which needs
no host sync and no bounds check on the card (an out-of-range index is a
device assert there), and never collides with a real write at ``Lc - 1``.
The cache-taking forwards write in place and return the caches they were
given; ``prefill_chunk(..., rows=)`` addresses slots of a slot table
directly (the JAX package gathers and scatters whole rows).

**Numerics.** Scores and context accumulate in f32 from the storage
dtype's values (bf16 -> f32 is exact), with TF32 off for those products
(building a ``CausalLM`` turns the process's matmul TF32 flag off once;
nothing in the package turns it back on); the context is cast back to the compute
dtype, as the JAX einsums' ``preferred_element_type=f32`` then
``.astype(q.dtype)`` do. The mask value is ``-1e30`` and ``softmax(s) *
m`` makes fully-masked rows exactly 0. int8 KV keeps the factored order:
the k-scale multiplies the scores after QK^T, the v-scale folds into the
softmax weights before P.V.

:func:`sample_tokens` is greedy at temperature 0 and otherwise draws JAX's
Gumbel-max categorical from ``fold_in(PRNGKey(seed), step)``, with the
threefry2x32 counter hash computed on the device in int64 masked to 32
bits, so a seeded stream is the JAX package's bit for bit up to the last
ulp of ``log``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.bert import (
    LayerNorm,
    _linear,
    _RowLogSumExp,
    _tp_psum,
    bert_param_specs,
)
from distributed_tensorflow_tpu_torch.models.quant import quantize_kv

_MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    dtype: torch.dtype = torch.float32
    # Megatron tensor parallelism, BertConfig's contract: the parameters are
    # drawn global and sliced (causal_param_specs); each rank runs
    # num_heads / model_parallel heads and intermediate_size /
    # model_parallel of the FFN, and sums the row-parallel outputs over
    # model_axis of the active mesh.
    model_axis: str | None = None
    model_parallel: int = 1

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_heads {self.num_heads}"
            )
        tp = self.model_parallel
        if tp < 1 or self.num_heads % tp or self.intermediate_size % tp:
            raise ValueError(
                f"model_parallel {tp} must divide num_heads {self.num_heads} and "
                f"intermediate_size {self.intermediate_size}")
        if tp > 1 and self.model_axis is None:
            raise ValueError("model_parallel > 1 needs a model_axis")


def causal_lm_base(**overrides) -> CausalLMConfig:
    return CausalLMConfig(**overrides)


def _pin_ieee_f32() -> None:
    """Keep f32 products IEEE f32, not TF32: the attention's scores and
    contexts accumulate in f32, as the JAX einsums'
    ``preferred_element_type`` does. Set once where a model is built and
    never toggled around a call: the flag is process-wide, and a serving
    process runs other forwards on other threads."""
    torch.backends.cuda.matmul.allow_tf32 = False


def _layer_cache(cache, i):
    """Layer ``i`` of a stacked cache (plain tensor or ``{"q", "s"}``): a
    view, so writes reach the stack."""
    if isinstance(cache, dict):
        return {"q": cache["q"][i], "s": cache["s"][i]}
    return cache[i]


def _cache_len(cache) -> int:
    """``Lc``: a layer cache's positions, the spare one not counted."""
    leaf = cache["q"] if isinstance(cache, dict) else cache
    return leaf.shape[-3] - 1


def _write_kv(cache, rows, positions, fresh) -> None:
    """Write ``fresh [..., h, d]`` at ``(rows, positions)`` of a layer cache
    in place; int8 caches quantize at the write (one scale a position)."""
    if isinstance(cache, dict):
        q, s = quantize_kv(fresh)
        cache["q"].index_put_((rows, positions), q)
        cache["s"].index_put_((rows, positions), s)
    else:
        cache.index_put_((rows, positions), fresh.to(cache.dtype))


def _read_kv(cache, rows=None):
    """``(pages [B, Lc, h, d], scale [B, Lc] or None)`` of ``rows`` (a
    gather) or of every row (a view), spare position dropped."""
    lc = _cache_len(cache)
    sel = slice(None) if rows is None else rows
    if isinstance(cache, dict):
        return cache["q"][sel, :lc], cache["s"][sel, :lc]
    return cache[sel, :lc], None


def _causal_attention(q, k, v, pad_mask):
    """Full-sequence causally-masked attention. ``q, k, v: [B, L, h, d]``;
    ``pad_mask: [B, L]`` True = real token. Fully-masked rows -> exactly 0."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bkhd->bhlk", q.float(), k.float())
    s = s * scale
    l = q.shape[1]
    causal = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    m = causal[None, None] & pad_mask.to(torch.bool)[:, None, None, :]
    s = torch.where(m, s, _MASK_VALUE)
    p = torch.softmax(s, dim=-1) * m
    ctx = torch.einsum("bhlk,bkhd->blhd", p.to(v.dtype).float(), v.float())
    return ctx.to(q.dtype)


def _cached_attention(q, k_cache, v_cache, position, k_scale=None, v_scale=None):
    """One-token-per-slot attention against the slot cache.

    ``q: [S, h, d]``; caches ``[S, Lmax, h, d]`` (no spare position);
    ``position: [S]``, the index the newest token was written at (attends
    ``<= position``). ``k_scale``/``v_scale`` ``[S, Lmax]``: the int8 cache's
    per-position factors, applied in the factored order.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("shd,slhd->shl", q.float(), k_cache.float())
    if k_scale is not None:
        s = s * k_scale[:, None, :]
    s = s * scale
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] <= position[:, None]
    s = torch.where(valid[:, None, :], s, _MASK_VALUE)
    p = torch.softmax(s, dim=-1) * valid[:, None, :]
    if v_scale is not None:
        p = p * v_scale[:, None, :]
    else:
        p = p.to(v_cache.dtype)
    ctx = torch.einsum("shl,slhd->shd", p.float(), v_cache.float())
    return ctx.to(q.dtype)


def _chunk_attention(q, k_cache, v_cache, position, k_scale=None, v_scale=None):
    """Chunk-of-queries attention against per-row caches.

    ``q: [B, C, h, d]``; caches ``[B, Lc, h, d]``; ``position: [B, C]``, the
    (clamped) cache index each query was written at; each attends ``<=`` its
    own position. Same accumulation and masking as :func:`_cached_attention`
    (and the same factored int8 order), so a verify column is the decode
    step it stands for.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bchd,blhd->bhcl", q.float(), k_cache.float())
    if k_scale is not None:
        s = s * k_scale[:, None, None, :]
    s = s * scale
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
             <= position[:, :, None])  # [B, C, Lc]
    m = valid[:, None]
    s = torch.where(m, s, _MASK_VALUE)
    p = torch.softmax(s, dim=-1) * m
    if v_scale is not None:
        p = p * v_scale[:, None, None, :]
    else:
        p = p.to(v_cache.dtype)
    ctx = torch.einsum("bhcl,blhd->bchd", p.float(), v_cache.float())
    return ctx.to(q.dtype)


class CausalSelfAttention(nn.Module):
    """The BERT attention block: column-parallel Q/K/V over this rank's
    ``num_heads / model_parallel`` heads, the row-parallel ``out``
    projection summed over the model axis with its bias added once, after
    the sum, then post-LN."""

    def __init__(self, cfg: CausalLMConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.head_dim = h // cfg.num_heads
        self.local_heads = cfg.num_heads // cfg.model_parallel
        local = self.local_heads * self.head_dim
        self.query = nn.Linear(h, local)
        self.key = nn.Linear(h, local)
        self.value = nn.Linear(h, local)
        self.out = nn.Linear(local, h, bias=False)
        self.out_bias = nn.Parameter(torch.zeros(h))
        self.ln = LayerNorm(h, 1e-12, cfg.dtype)

    def _qkv(self, x):
        shape = (*x.shape[:-1], self.local_heads, self.head_dim)
        dt = self.cfg.dtype
        return (_linear(x, self.query, dt).view(shape), _linear(x, self.key, dt).view(shape),
                _linear(x, self.value, dt).view(shape))

    def _finish(self, x, ctx):
        out = _tp_psum(self.cfg, _linear(ctx.reshape(*ctx.shape[:-2], -1), self.out,
                                         self.cfg.dtype))
        out = out + self.out_bias.to(out.dtype)
        return self.ln(x + out)

    def forward(self, x, pad_mask):
        q, k, v = self._qkv(x)
        ctx = _causal_attention(q, k, v, pad_mask)
        # K/V returned pre-attention: prefill writes exactly these into the
        # slot cache, so the decode path attends identical values.
        return self._finish(x, ctx), k, v

    def decode(self, x, k_cache, v_cache, position):
        """``x [S, H]``; layer caches ``[S, Lc + 1, h, d]``; ``position ==
        Lc`` marks an idle lane (its write lands in the spare position, its
        attention clamps: its output is garbage nobody reads)."""
        q, k, v = self._qkv(x)  # [S, h, d]
        rows = torch.arange(x.shape[0], device=x.device)
        _write_kv(k_cache, rows, position, k)
        _write_kv(v_cache, rows, position, v)
        kc, ks = _read_kv(k_cache)
        vc, vs = _read_kv(v_cache)
        ctx = _cached_attention(q, kc, vc, position.clamp_max(kc.shape[1] - 1), ks, vs)
        return self._finish(x, ctx)

    def prefill_chunk(self, x, positions, k_cache, v_cache, rows=None):
        """``x [B, C, H]``; ``positions [B, C]`` absolute (``Lc`` on padding
        lanes: spare position); ``rows [B]`` the cache rows (slots), or
        None for cache row ``b`` = batch row ``b``."""
        q, k, v = self._qkv(x)  # [B, C, h, d]
        wrows = (torch.arange(x.shape[0], device=x.device) if rows is None else rows)[:, None]
        _write_kv(k_cache, wrows, positions, k)
        _write_kv(v_cache, wrows, positions, v)
        kc, ks = _read_kv(k_cache, rows)
        vc, vs = _read_kv(v_cache, rows)
        ctx = _chunk_attention(q, kc, vc, positions.clamp_max(kc.shape[1] - 1), ks, vs)
        return self._finish(x, ctx)


class CausalLmLayer(nn.Module):
    """Attention + FFN, both post-LN: BertLayer's shape with the cached
    decode twins. The FFN holds ``intermediate_size / model_parallel`` of
    the hidden width; its row-parallel output is summed over the model
    axis before ``output_bias``."""

    def __init__(self, cfg: CausalLMConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = CausalSelfAttention(cfg)
        ff = cfg.intermediate_size // cfg.model_parallel
        self.intermediate = nn.Linear(cfg.hidden_size, ff)
        self.output = nn.Linear(ff, cfg.hidden_size, bias=False)
        self.output_bias = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)

    def _ffn(self, x):
        dt = self.cfg.dtype
        y = F.gelu(_linear(x, self.intermediate, dt), approximate="tanh")
        y = _tp_psum(self.cfg, _linear(y, self.output, dt))
        y = y + self.output_bias.to(y.dtype)
        return self.ln(x + y)

    def forward(self, x, pad_mask):
        x, k, v = self.attention(x, pad_mask)
        return self._ffn(x), k, v

    def decode(self, x, k_cache, v_cache, position):
        return self._ffn(self.attention.decode(x, k_cache, v_cache, position))

    def prefill_chunk(self, x, positions, k_cache, v_cache, rows):
        return self._ffn(self.attention.prefill_chunk(x, positions, k_cache, v_cache, rows))


class CausalLM(nn.Module):
    """Decoder-only LM over :class:`CausalLmLayer` blocks with a tied head.

    Parameters are created on ``device`` (default the card; raises without
    one) and drawn from ``generator`` (default: seeded with ``seed``) with
    the JAX package's initialisers: normal(0.02) kernels and embeddings,
    zero biases, unit LayerNorm scales. Under tensor parallelism
    (``model_parallel > 1``) they are drawn for the unsharded model and
    this rank's slices kept (:func:`causal_param_specs`, the active mesh's
    coordinates), so every width starts from the same global parameters.
    The tied head and the embeddings stay whole on every rank. See the
    module docstring for the five forwards and the cache layout; under TP
    the caches hold this rank's ``num_heads / model_parallel`` heads.
    """

    def __init__(self, cfg: CausalLMConfig, *, device="cuda", generator=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # Made on the device: every value below is drawn or loaded anew.
        with dev:
            self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.position = nn.Embedding(cfg.max_position, cfg.hidden_size)
            self.embed_ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)
            self.layers = nn.ModuleList(CausalLmLayer(cfg) for _ in range(cfg.num_layers))
            self.lm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
            self.lm_ln = LayerNorm(cfg.hidden_size, 1e-12, cfg.dtype)
            self.lm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        _pin_ieee_f32()
        if dev.type == "meta":
            return  # a template: every value is loaded into it
        if generator is None:
            generator = torch.Generator(dev).manual_seed(seed)
        if cfg.model_parallel > 1:
            from distributed_tensorflow_tpu_torch.interop import shard_params
            from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

            full = CausalLM(dataclasses.replace(cfg, model_axis=None, model_parallel=1),
                            device=dev, generator=generator)
            self.load_state_dict(shard_params(
                full.state_dict(), causal_param_specs(full.state_dict(), cfg.model_axis),
                active_mesh()))
            return
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    mod.weight.normal_(0.0, 0.02, generator=generator)
                if isinstance(mod, nn.Linear) and mod.bias is not None:
                    mod.bias.zero_()

    def _embed(self, token_ids, positions):
        dt = self.cfg.dtype
        return self.embed_ln(self.word(token_ids).to(dt) + self.position(positions).to(dt))

    def _head(self, h):
        # Tied decoder against the embedding table: transform -> LN ->
        # attend + bias, logits in the compute dtype.
        dt = self.cfg.dtype
        h = self.lm_ln(F.gelu(_linear(h, self.lm_transform, dt), approximate="tanh"))
        return F.linear(h, self.word.weight.to(dt)) + self.lm_bias.to(dt)

    def forward(self, input_ids, attention_mask):
        l = input_ids.shape[1]
        x = self._embed(input_ids, torch.arange(l, device=input_ids.device)[None])
        for layer in self.layers:
            x, _, _ = layer(x, attention_mask)
        return self._head(x)

    def prefill(self, input_ids, attention_mask):
        l = input_ids.shape[1]
        x = self._embed(input_ids, torch.arange(l, device=input_ids.device)[None])
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = layer(x, attention_mask)
            ks.append(k)
            vs.append(v)
        return self._head(x), torch.stack(ks), torch.stack(vs)

    def decode_step(self, token, position, k_cache, v_cache):
        """``token``/``position`` ``[S]``; caches ``[nl, S, Lc + 1, h, d]``,
        written in place. Position ``Lc`` marks an idle lane."""
        # The clamp is for the position-embedding lookup only; the raw
        # (possibly sentinel) position drives the layers' writes.
        x = self._embed(token, position.clamp_max(self.cfg.max_position - 1))  # [S, H]
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, _layer_cache(k_cache, i), _layer_cache(v_cache, i), position)
        return self._head(x), k_cache, v_cache

    def prefill_chunk(self, input_ids, positions, k_cache, v_cache, rows=None):
        """``input_ids``/``positions`` ``[B, C]`` against caches ``[nl, R,
        Lc + 1, h, d]``, written in place: batch row ``b`` uses cache row
        ``rows[b]`` (default ``b``). Cache positions past a row's written
        length hold zeros or a prior occupant's values, finite either way,
        and the causal mask gives them exactly-0 weight."""
        lc = _cache_len(_layer_cache(k_cache, 0))
        x = self._embed(input_ids, positions.clamp_max(lc - 1))
        for i, layer in enumerate(self.layers):
            x = layer.prefill_chunk(x, positions, _layer_cache(k_cache, i),
                                    _layer_cache(v_cache, i), rows)
        return self._head(x), k_cache, v_cache

    def verify_step(self, tokens, positions, k_cache, v_cache):
        """Speculative decoding's verify over the slot table: ``[S, K+1]``
        tokens at absolute positions. Column 0 is each slot's last verified
        token, columns 1.. the drafts; dead columns carry ``Lc``. This IS
        ``prefill_chunk`` with ``C = K + 1``."""
        return self.prefill_chunk(tokens, positions, k_cache, v_cache)


def causal_param_specs(params, model_axis: str | None = "model") -> dict:
    """The causal LM's Megatron-TP sharding (JAX ``causal_param_specs``):
    the block reuses BERT's leaf names, so it is :func:`..bert.
    bert_param_specs`' suffix rules with the expert and pipeline families
    off. Embeddings, LayerNorms, the post-sum biases and the tied head stay
    replicated."""
    return bert_param_specs(params, model_axis=model_axis, expert_axis=None,
                            pipeline_axis=None)


# ---------------------------------------------------------------- sampling

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x0, x1):
    """JAX's threefry2x32 hash (``jax/_src/prng.py``) on int64 tensors
    holding uint32 values; arguments broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits(seed, step, n: int) -> torch.Tensor:
    """``jax.random.bits(fold_in(PRNGKey(seed), step), (n,))`` per row, with
    ``jax_threefry_partitionable``: ``[S, n]`` uint32 values in int64.
    ``seed``/``step``: int tensors ``[S]``."""
    seed = seed.to(torch.int64)
    zero = torch.zeros_like(seed)
    # PRNGKey(int32 seed) = (seed >> 32, seed & 0xFFFFFFFF) = (0, seed).
    k1, k2 = _threefry2x32(zero, seed & _M32, zero, step.to(torch.int64) & _M32)
    counts = torch.arange(n, dtype=torch.int64, device=seed.device)[None, :]
    b1, b2 = _threefry2x32(k1[:, None], k2[:, None], 0, counts)
    return b1 ^ b2


def uniform_tiny(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` in f32 from 32 random
    bits: the mantissa trick (23 bits under the exponent of 1.0), then the
    range's affine map and floor, in f32."""
    one_bits = (bits >> 9) | 0x3F800000
    floats = one_bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float32,
                        device=bits.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=bits.device) - tiny
    return torch.maximum(tiny, floats * span + tiny)


def sample_tokens(logits, temperature, seed, step):
    """Per-row next-token choice: greedy at ``temperature == 0``, seeded
    categorical otherwise, keyed on ``fold_in(PRNGKey(seed), step)`` with
    ``step`` the ABSOLUTE position being generated: a function of the
    request alone, never of its batchmates or slot.

    ``logits [S, V]``; ``temperature`` f32, ``seed`` and ``step`` int ``[S]``.
    The draw is JAX's ``categorical``: argmax of ``logits / t`` plus Gumbel
    noise ``-log(-log(u))``."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    u = uniform_tiny(random_bits(seed, step, logits.shape[-1]))
    gumbel = -torch.log(-torch.log(u))
    scaled = logits.float() / torch.clamp_min(temperature.float(), 1e-6)[:, None]
    sampled = (gumbel + scaled).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


# ---------------------------------------------------------------- training


def _next_token_stats(logits, batch):
    """Shift-by-one CE sums: position t's logits score token t+1; pad
    positions and the final position carry zero weight. Returns ``(ce_sum,
    weight_sum, correct_sum)`` in f32, the logsumexp taken in f32 from the
    storage dtype one row chunk at a time (the BERT loss's recipe)."""
    targets = batch["input_ids"][:, 1:].long()
    weights = batch["attention_mask"][:, 1:].to(torch.float32)
    # logsumexp over every position (no copy of the shifted slice); the last
    # position's weight is 0, so it adds nothing, gradient included.
    lse = _RowLogSumExp.apply(logits)[:, :-1]
    tgt = logits[:, :-1].gather(-1, targets[..., None])[..., 0]
    ce_sum = ((lse - tgt.float()) * weights).sum()
    correct = ((logits[:, :-1].detach().argmax(dim=-1) == targets).to(torch.float32)
               * weights).sum()
    return ce_sum, weights.sum(), correct


def make_causal_lm_loss(model: CausalLM):
    """Next-token cross-entropy for the train step over ``{"input_ids" [B,
    L], "attention_mask" [B, L]}`` batches: ``loss_fn(params, model_state,
    batch, generator) -> (loss, (model_state, metrics))``. ``params`` are
    ``model``'s own parameters, read through ``model``; the decoder draws
    no dropout."""

    def loss_fn(params, model_state, batch, generator):
        del params, generator
        logits = model(batch["input_ids"], batch["attention_mask"])
        ce_sum, den, correct = _next_token_stats(logits, batch)
        den = den.clamp_min(1.0)
        loss = ce_sum / den
        return loss, (model_state, {"lm_loss": loss, "lm_accuracy": correct / den})

    return loss_fn


def make_causal_lm_eval_metrics(model: CausalLM):
    """Eval ``metric_fn(params, model_state, batch)``: next-token loss and
    accuracy as ``(num, den)`` pairs, reduced as global ratios."""

    def metric_fn(params, model_state, batch):
        del params, model_state
        with torch.no_grad():
            logits = model(batch["input_ids"], batch["attention_mask"])
            ce_sum, den, correct = _next_token_stats(logits, batch)
        return {"lm_loss": (ce_sum, den), "lm_accuracy": (correct, den)}

    return metric_fn
