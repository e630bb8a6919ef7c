"""Serving dtype knobs (port of ``models/quant.py``: the dtype names and the
float cast). Per-channel int8 packing comes with a later slice: asking for
``"int8"`` raises ``NotImplementedError``."""

from __future__ import annotations

import torch

QUANT_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    if name == "int8":
        raise NotImplementedError(
            f"{what}='int8': int8 weights and KV are ported with a later slice"
        )
    return name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a normalized float dtype name."""
    return _TORCH_DTYPES[name]


def cast_params(params: dict, dtype) -> dict:
    """Cast every floating tensor of a state dict; others pass through."""
    if isinstance(dtype, str):
        dtype = torch_dtype(normalize_quant_dtype(dtype))
    return {
        k: v.to(dtype) if torch.is_floating_point(v) else v
        for k, v in params.items()
    }
