"""Post-training int8 quantization for the serving path (port of
``models/quant.py``).

Two independent modes, both opt-in per engine and invisible to training
(checkpoints stay in their training dtype on disk):

**Weights**: per-output-channel absmax int8. Every eligible kernel of a
state dict (a 2-D or wider ``weight`` that is not an embedding table) is
replaced by the two-leaf dict ``{"_q8": int8, "_q8_scale": f32}``, with the
scale taken per channel of the kernel's **flax last axis**
(``max|w| / 127`` over every other flax axis), so the packing is the JAX
package's bit for bit:

- ``Linear`` ``[out, in]`` (flax ``Dense`` ``[in, out]``) and the attention
  ``out`` ``[H, heads*d]`` (flax ``[heads, d, H]``): one scale a row;
- the attention ``query``/``key``/``value`` ``[heads*d, H]`` (flax
  ``DenseGeneral`` ``[H, heads, d]``): one scale per lane of the head dim,
  ``[d]``, shared across heads, so :func:`quantize_params` needs
  ``num_heads`` for them.

``_q8`` keeps the port's layout of the kernel it replaces and ``_q8_scale``
the flax shape, so :mod:`..interop` carries packed trees across with the
scale axis intact. Embeddings (the tied LM head scores against the exact
table), biases and LayerNorms keep their dtype. :func:`dequantize_params`
and the model's forward (through :func:`load_params`) materialise each
packed kernel in the compute dtype once a call (the JAX package fuses that
convert into the matmul's operand read; here it is one elementwise pass a
kernel).

**KV cache**: int8 pages with one absmax scale per written position
(:func:`quantize_kv`); a quantized cache is the dict ``{"q": int8[..., h,
d], "s": f32[...]}``. Attention never materialises a dequantized cache:
the k-scale multiplies the scores after the QK^T product and the v-scale
folds into the softmax weights before P.V (:mod:`.causal_lm`).

``normalize_quant_dtype`` is the one validator of the ``weight_dtype`` /
``kv_dtype`` knobs: an unknown name dies in a ``ValueError`` at plan time.
"""

from __future__ import annotations

import torch

QUANT_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# absmax floor: an all-zero channel/position quantizes with a scale > 0 (q is
# 0 either way), so the dequant multiply never sees a zero scale.
_EPS = 1e-8

# Modules whose 2-D ``weight`` is an embedding table (flax ``embedding``),
# and the DenseGeneral projections whose flax kernel is [H, heads, d].
_EMBEDDINGS = frozenset({"word", "position", "token_type"})
_HEAD_PROJ = frozenset({"query", "key", "value"})


def normalize_quant_dtype(value, what: str = "dtype") -> str | None:
    """Canonicalize a quantization knob: ``None`` keeps the model dtype;
    anything else must name one of :data:`QUANT_DTYPES` (a string, a numpy
    or a torch dtype). Raises ``ValueError`` on unknown names."""
    if value is None:
        return None
    if isinstance(value, torch.dtype):
        name = str(value).removeprefix("torch.")
    elif isinstance(value, str):
        name = value
    else:
        name = getattr(value, "name", str(value))
    name = {"f32": "float32", "fp32": "float32", "bf16": "bfloat16"}.get(name, name)
    if name not in QUANT_DTYPES:
        raise ValueError(
            f"{what} {value!r} not supported: pick one of {QUANT_DTYPES} "
            "(or None to keep the model dtype)"
        )
    return name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a normalized float dtype name."""
    return _TORCH_DTYPES[name]


def is_quantized_leaf(x) -> bool:
    """True for the packed ``{"_q8", "_q8_scale"}`` kernel dict."""
    return isinstance(x, dict) and "_q8" in x and "_q8_scale" in x


def is_quantized_tree(tree) -> bool:
    """True when any kernel of the state dict ``tree`` is int8-packed."""
    return any(is_quantized_leaf(v) for v in tree.values())


def _kernel_kind(name: str, leaf) -> str | None:
    """``"heads"`` for a DenseGeneral q/k/v kernel, ``"rows"`` for any other
    eligible kernel (scale per output row), None when the leaf stays as it
    is: the flax path's rule (a ``kernel`` of rank >= 2) read off the
    port's names."""
    parts = name.split(".")
    if (
        parts[-1] != "weight"
        or not isinstance(leaf, torch.Tensor)
        or leaf.dim() < 2
        or not leaf.is_floating_point()
    ):
        return None
    parent = parts[-2] if len(parts) > 1 else ""
    if parent in _EMBEDDINGS:
        return None
    return "heads" if parent in _HEAD_PROJ else "rows"


def quantize_params(params: dict, num_heads: int | None = None) -> dict:
    """Per-output-channel absmax int8 over every eligible kernel of the
    state dict ``params``.

    Returns a new dict where each quantized kernel is ``{"_q8": int8 (the
    kernel's layout), "_q8_scale": f32 (flax last axis)}``; every other
    leaf is the ORIGINAL tensor (shared, not copied). Idempotent: packed
    leaves pass through. ``num_heads`` is needed when the dict holds
    attention q/k/v kernels (their scales are per head-dim lane)."""
    out = {}
    for name, leaf in params.items():
        kind = None if is_quantized_leaf(leaf) else _kernel_kind(name, leaf)
        if kind is None:
            out[name] = leaf
            continue
        w = leaf.detach().to(torch.float32)
        if kind == "heads":
            if not num_heads:
                raise ValueError(
                    f"{name}: quantizing an attention projection needs num_heads"
                )
            wv = w.view(num_heads, w.shape[0] // num_heads, w.shape[1])  # [heads, d, H]
            s = torch.clamp_min(wv.abs().amax(dim=(0, 2)) / 127.0, _EPS)
            q = torch.clamp(torch.round(wv / s[None, :, None]), -127, 127)
            q = q.view_as(w)
        else:
            red = tuple(range(1, w.dim()))
            s = torch.clamp_min(w.abs().amax(dim=red) / 127.0, _EPS)
            q = torch.clamp(torch.round(w / s.view(-1, *([1] * (w.dim() - 1)))), -127, 127)
        out[name] = {"_q8": q.to(torch.int8), "_q8_scale": s}
    return out


def _row_scale(leaf: dict) -> torch.Tensor:
    """The packed kernel's scale broadcast over its rows: per row, or per
    head-dim lane repeated once a head (q/k/v)."""
    q, s = leaf["_q8"], leaf["_q8_scale"]
    if s.numel() != q.shape[0]:
        s = s.repeat(q.shape[0] // s.numel())
    return s.view(-1, *([1] * (q.dim() - 1)))


def dequantize_leaf(leaf: dict, dtype=torch.float32) -> torch.Tensor:
    """One packed kernel back to dense ``dtype``: ``q * scale`` in f32."""
    return (leaf["_q8"].to(torch.float32) * _row_scale(leaf)).to(dtype)


def dequantize_params(params: dict, dtype=torch.float32) -> dict:
    """Unpack every ``{"_q8", "_q8_scale"}`` leaf to a dense kernel in
    ``dtype``; other leaves pass through (the same objects)."""
    return {
        k: dequantize_leaf(v, dtype) if is_quantized_leaf(v) else v
        for k, v in params.items()
    }


def load_params(model: torch.nn.Module, params: dict) -> None:
    """Load a state dict that may hold packed kernels into ``model`` (the
    tensors themselves, as ``load_state_dict(assign=True)`` does): dense
    leaves through ``load_state_dict`` (every leaf must be there), each
    packed kernel as two buffers of its module, ``weight_q8`` and
    ``weight_scale``, with the float ``weight`` dropped. The model's
    forward then dequantizes it once a call (``models.bert._kernel``)."""
    packed = {k: v for k, v in params.items() if is_quantized_leaf(v)}
    for name, leaf in packed.items():
        module = model.get_submodule(name.rsplit(".", 1)[0])
        module.weight = None
        module.register_buffer("weight_q8", leaf["_q8"])
        module.register_buffer("weight_scale", leaf["_q8_scale"])
    dense = {k: v for k, v in params.items() if k not in packed}
    missing, unexpected = model.load_state_dict(dense, strict=False, assign=True)
    missing = [k for k in missing if not k.endswith((".weight_q8", ".weight_scale"))]
    if missing or unexpected:
        raise KeyError(f"state dict does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")


def cast_params(params: dict, dtype) -> dict:
    """Cast every floating tensor of a state dict (bf16 weight mode); ints
    and packed int8 leaves pass through."""
    if isinstance(dtype, str):
        dtype = torch_dtype(normalize_quant_dtype(dtype))
    return {
        k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
        for k, v in params.items()
    }


def fp32_equiv_nbytes(tree) -> int:
    """Bytes the tree's payload would occupy at fp32, the baseline of the
    ``/memz`` ``bytes_saved_vs_fp32`` ledger: packed kernels count their
    kernel elements only (the scales are overhead the actual byte count
    carries); quantized KV dicts likewise count the ``q`` payload."""
    if is_quantized_leaf(tree):
        return tree["_q8"].numel() * 4
    if isinstance(tree, dict):
        if "q" in tree and "s" in tree and isinstance(tree["q"], torch.Tensor):
            return tree["q"].numel() * 4
        return sum(fp32_equiv_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(fp32_equiv_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * 4
    return 0


def free_replaced_leaves(old_tree: dict, new_tree: dict) -> int:
    """Release every ``old_tree`` tensor that ``new_tree`` REPLACED
    (quantized or cast; leaves shared by identity survive), as the JAX
    package deletes their device buffers: the entry leaves ``old_tree``, and
    a resizable storage that no tensor of ``new_tree`` views is emptied (the
    memory returns even while another reference to the tensor lives).
    Returns the bytes reclaimed."""

    def tensors(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from tensors(v)
            elif isinstance(v, torch.Tensor):
                yield v

    live = {t.untyped_storage().data_ptr() for t in tensors(new_tree)}
    reclaimed = 0
    for name, leaf in list(old_tree.items()):
        if not isinstance(leaf, torch.Tensor) or new_tree.get(name) is leaf:
            continue
        reclaimed += leaf.numel() * leaf.element_size()
        del old_tree[name]
        storage = leaf.untyped_storage()
        if storage.resizable() and storage.data_ptr() not in live:
            storage.resize_(0)
    return reclaimed


# ---------------------------------------------------------------- KV cache


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize K or V activations position-wise: absmax over the trailing
    ``(heads, head_dim)`` axes. ``x: [..., h, d]`` -> ``(q int8[..., h, d],
    scale f32[...])``."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=(-2, -1)) / 127.0, _EPS)
    q = torch.clamp(torch.round(xf / s[..., None, None]), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Materialize a quantized KV stage back to dense (wire and debug paths
    only: attention uses the factored form and never calls this)."""
    return (q.to(torch.float32) * s[..., None, None]).to(dtype)
