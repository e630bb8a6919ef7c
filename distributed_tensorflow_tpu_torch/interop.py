"""Parameter conversion between the JAX package's flax trees and the port.

The flax side is a nested dict of **numpy** arrays (``jax.tree.map(
np.asarray, params)`` on the JAX side), so this module needs no JAX. The
torch side is a :class:`~.models.bert.BertForPreTraining` or
:class:`~.models.causal_lm.CausalLM` ``state_dict``
(:func:`bert_params_from_flax`, :func:`causal_lm_params_from_flax`: the
decoder reuses BERT's leaf names) or an image model's ``state_dict`` and
``batch_stats`` (:func:`resnet_params_from_flax`, for ResNet-20/50 and
LeNet-5).

BERT mappings:

- ``Dense`` kernel ``[in, out]`` <-> ``Linear.weight`` ``[out, in]``;
- ``DenseGeneral`` q/k/v kernels ``[H, heads, d]`` and biases ``[heads, d]``
  <-> ``Linear`` ``[heads*d, H]`` / ``[heads*d]``;
- the attention ``out`` kernel ``[heads, d, H]`` <-> ``Linear`` ``[H, heads*d]``
  (its bias is the separate ``out_bias`` leaf, unchanged);
- ``Embed.embedding`` <-> ``Embedding.weight``;
- ``LayerNorm`` ``scale``/``bias`` <-> ``weight``/``bias``;
- ``layer_<i>`` <-> ``layers.<i>``;
- the mixture-of-experts FFN: ``moe/router/kernel`` <-> ``moe.router.weight``
  (a Dense kernel); the ``experts_w1/b1/w2/b2`` stacks keep their layout;
- the stacked encoder of a pipeline config (flax ``nn.scan``'s
  ``encoder/layer/...``, every leaf with a leading ``[num_layers]``) <->
  ``encoder.layer.*``: each layer's slice maps as above.

Int8-packed kernels (``{"_q8", "_q8_scale"}``, :mod:`.models.quant`) carry
over in both BERT-family directions: ``_q8`` moves like the kernel it
replaced and ``_q8_scale``, one scale per channel of the flax last axis,
keeps its shape. The image walkers refuse them (image serving has no int8
mode). bf16 numpy arrays (``ml_dtypes``) arrive as bf16 tensors; bf16 tensors leave
as float32 arrays, which hold every bf16 value exactly.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.quant import _EMBEDDINGS, _HEAD_PROJ
from distributed_tensorflow_tpu_torch.models.quant import is_quantized_leaf as _is_packed


def _is_norm(module: str) -> bool:
    return module == "ln" or module.endswith("_ln")


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _flatten(tree: dict, prefix: tuple = (), packed_leaves: bool = False):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if packed_leaves and _is_packed(val):
            yield path, val
        elif isinstance(val, dict):
            yield from _flatten(val, path, packed_leaves)
        else:
            yield path, val


def _kernel_from_flax(parent: str, a: np.ndarray) -> np.ndarray:
    if parent in _HEAD_PROJ:  # [H, heads, d] -> [heads*d, H]
        return a.reshape(a.shape[0], -1).T
    if parent == "out":       # [heads, d, H] -> [H, heads*d]
        return a.reshape(-1, a.shape[-1]).T
    return a.T                # [in, out] -> [out, in]


def _kernel_to_flax(parent: str, a: np.ndarray, num_heads: int) -> np.ndarray:
    if parent in _HEAD_PROJ:  # [heads*d, H] -> [H, heads, d]
        return a.T.reshape(a.shape[1], num_heads, -1)
    if parent == "out":       # [H, heads*d] -> [heads, d, H]
        return a.T.reshape(num_heads, -1, a.shape[0])
    return a.T


def _per_layer(fn, a: np.ndarray, stacked: bool) -> np.ndarray:
    """``fn`` of ``a``, or of each leading-dim slice of a stacked leaf."""
    return np.stack([fn(x) for x in a]) if stacked else fn(a)


def bert_params_from_flax(tree: dict) -> dict:
    """flax ``BertForPreTraining`` (or ``CausalLM``) params (numpy leaves)
    -> torch state dict; a packed kernel becomes ``{"_q8", "_q8_scale"}``
    tensors under the kernel's torch name."""
    out = {}
    for path, leaf in _flatten(tree, packed_leaves=True):
        stacked = "encoder" in path
        names = [re.sub(r"^layer_(\d+)$", r"layers.\1", p) for p in path]
        parent, name = (path[-2] if len(path) > 1 else ""), path[-1]
        if _is_packed(leaf):
            names[-1] = "weight"
            q = _kernel_from_flax(parent, np.asarray(leaf["_q8"]))
            out[".".join(names)] = {
                "_q8": _to_tensor(np.ascontiguousarray(q)),
                "_q8_scale": _to_tensor(np.asarray(leaf["_q8_scale"])),
            }
            continue
        a = np.asarray(leaf)
        if name in ("embedding", "scale"):
            names[-1] = "weight"
        elif name == "kernel":
            names[-1] = "weight"
            a = _per_layer(lambda k: _kernel_from_flax(parent, k), a, stacked)
        elif name == "bias" and parent in _HEAD_PROJ:  # [heads, d] -> [heads*d]
            a = _per_layer(lambda b: b.reshape(-1), a, stacked)
        out[".".join(names)] = _to_tensor(np.ascontiguousarray(a))
    return out


def bert_params_to_flax(state_dict: dict, num_heads: int) -> dict:
    """Inverse of :func:`bert_params_from_flax` (numpy leaves); needs the
    head count to restore the ``DenseGeneral`` shapes."""
    tree: dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        path, i = [], 0
        while i < len(parts):
            if parts[i] == "layers":
                path.append(f"layer_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        parent = path[-2] if len(path) > 1 else ""
        if _is_packed(t):
            a = {"_q8": np.ascontiguousarray(
                     _kernel_to_flax(parent, _to_numpy(t["_q8"]), num_heads)),
                 "_q8_scale": _to_numpy(t["_q8_scale"])}
            path[-1] = "kernel"
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = a
            continue
        a = _to_numpy(t)
        stacked = "encoder" in path
        if path[-1] == "weight":
            if parent in _EMBEDDINGS:
                path[-1] = "embedding"
            elif _is_norm(parent):
                path[-1] = "scale"
            else:
                path[-1] = "kernel"
                a = _per_layer(lambda k: _kernel_to_flax(parent, k, num_heads), a, stacked)
        elif path[-1] == "bias" and parent in _HEAD_PROJ:
            a = _per_layer(lambda b: b.reshape(num_heads, -1), a, stacked)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


# The decoder's tree uses BERT's leaf names and layout rules.
causal_lm_params_from_flax = bert_params_from_flax
causal_lm_params_to_flax = bert_params_to_flax


def _refuse_quantized(path) -> None:
    if any(p in ("_q8", "_q8_scale") for p in path):
        raise NotImplementedError(
            f"int8-packed leaf {'/'.join(path)}: image models are served in "
            "float (image serving has no int8 mode)"
        )


def resnet_params_from_flax(params: dict, batch_stats: dict | None = None):
    """flax image-model params and ``batch_stats`` (numpy leaves; ResNet-20,
    ResNet-50, Inception-v3 and LeNet-5 trees) -> ``(state_dict,
    batch_stats)`` of the port's models.

    Conv kernels HWIO ``[kh, kw, in, out]`` (any kh, kw) -> ``weight`` OIHW (the stem's
    ``[7, 7, 3, F]`` stays a 7x7 leaf); Dense ``[in, out]`` -> ``weight``
    ``[out, in]``; BatchNorm ``scale`` -> ``weight``; biases unchanged;
    ``batch_stats`` ``mean``/``var`` -> ``"<module path>.mean"``/``".var"``.
    Module names are the flax ones, joined by dots.
    """
    out = {}
    for path, leaf in _flatten(params):
        _refuse_quantized(path)
        a = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        elif name == "scale":
            name = "weight"
        out[".".join(path[:-1] + (name,))] = _to_tensor(np.ascontiguousarray(a))
    stats = {".".join(path): _to_tensor(np.asarray(leaf))
             for path, leaf in _flatten(batch_stats or {})}
    return out, stats


def resnet_params_to_flax(state_dict: dict, batch_stats: dict | None = None):
    """Inverse of :func:`resnet_params_from_flax`: ``(params, batch_stats)``
    flax trees of numpy arrays. Leaves are told apart by rank: a 4-D
    ``weight`` is a conv kernel, a 2-D one a Dense kernel, a 1-D one a
    BatchNorm scale."""

    def nest(flat: dict, rename) -> dict:
        tree: dict = {}
        for key, t in flat.items():
            path = key.split(".")
            a = _to_numpy(t)
            path[-1], a = rename(path[-1], a)
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = np.ascontiguousarray(a)
        return tree

    def leaf(name, a):
        if name != "weight":
            return name, a
        if a.ndim == 4:
            return "kernel", a.transpose(2, 3, 1, 0)
        if a.ndim == 2:
            return "kernel", a.T
        return "scale", a

    return nest(state_dict, leaf), nest(batch_stats or {}, lambda name, a: (name, a))


# The walkers map every image model's tree, not only ResNet's.
image_params_from_flax = resnet_params_from_flax
image_params_to_flax = resnet_params_to_flax


def shard_params(state_dict: dict, specs: dict, mesh) -> dict:
    """This rank's slice of a GLOBAL state dict: each leaf that ``specs``
    shards (pairs of ``(axis, dim)``, as :func:`.models.bert.bert_param_specs`
    gives them) is cut, for each pair, into ``mesh.shape[axis]`` equal parts
    along ``dim`` and the part at this rank's coordinate on ``axis`` kept (a
    contiguous copy); the others are returned as they are. The JAX
    package's placement of a global tree under ``PartitionSpec``s, for one
    rank.

    An int8-packed kernel (``{"_q8", "_q8_scale"}``, packed from the GLOBAL
    kernel) cuts its ``_q8`` like the kernel; its scale, one a kernel row
    (or a head-dim lane for q/k/v), is cut only where the kernel's rows
    are, so a row-parallel kernel keeps its whole scale on every rank and a
    column-parallel one takes its channels' scales, as the JAX package's
    last-axis scales shard."""
    from distributed_tensorflow_tpu_torch.models.quant import is_quantized_leaf
    from distributed_tensorflow_tpu_torch.parallel.mesh import coordinate

    def cut(name, t, spec):
        for axis, dim in spec:
            n = mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(f"{name}: dimension {dim} of size {t.shape[dim]} not "
                                 f"divisible by the {n}-way {axis!r} axis")
            t = t.chunk(n, dim)[coordinate(mesh, (axis,))]
        return t.contiguous()

    out = {}
    for name, t in state_dict.items():
        spec = specs.get(name)
        if spec is None:
            out[name] = t
        elif is_quantized_leaf(t):
            q, s = t["_q8"], t["_q8_scale"]
            per_row = s.numel() == q.shape[0]
            out[name] = {"_q8": cut(name, q, spec),
                         "_q8_scale": cut(name, s, [(a, d) for a, d in spec
                                                    if d == 0 and per_row])}
        else:
            out[name] = cut(name, t, spec)
    return out


def gather_params(state_dict: dict, specs: dict, mesh) -> dict:
    """The GLOBAL state dict rebuilt on every rank from each rank's slices
    (the inverse of :func:`shard_params`): every sharded leaf is
    all-gathered over each of its axes of ``mesh``, the job's active mesh,
    and concatenated along the axis's dim. Every rank of the job must call
    it."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll
    from distributed_tensorflow_tpu_torch.parallel.mesh import axis_group, axis_ranks

    out = {}
    for name, t in state_dict.items():
        t = t.detach()
        for axis, dim in specs.get(name) or ():
            n = len(axis_ranks(mesh, axis))
            if n > 1:
                t = coll._gather(t, axis_group(mesh, axis), n, dim)
        out[name] = t
    return out
