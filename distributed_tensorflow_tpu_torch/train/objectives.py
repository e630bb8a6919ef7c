"""Classification objectives over the port's image models (port of
``train/objectives.py``).

Models with BatchNorm (:class:`~..models.resnet.ResNet`,
:class:`~..models.inception.InceptionV3`) take and return
their running statistics, ``model(x, batch_stats, train=...) -> (out,
new_batch_stats)``, and keep them in the train state's ``model_state`` as
``{"batch_stats": {...}}``, as flax keeps its mutable collection; models
without (:class:`~..models.lenet.LeNet5`) take ``model(x, train=...)`` and an
empty ``model_state``.
"""

from __future__ import annotations

import inspect
from typing import Any

import torch
import torch.nn.functional as F


def _apply(model, model_state: dict, images, train: bool, **kwargs):
    """``(out, new_model_state)``: the forward, with the model's mutable
    statistics threaded through when it has them."""
    if "batch_stats" in model_state:
        out, stats = model(images, model_state["batch_stats"], train=train, **kwargs)
        return out, {**model_state, "batch_stats": stats}
    return model(images, train=train, **kwargs), model_state


def make_classification_loss(model, *, label_smoothing: float = 0.0, aux_weight: float = 0.3):
    """Return the train step's ``loss_fn(params, model_state, batch,
    generator) -> (loss, (model_state, {"accuracy"}))``.

    Batches are ``{"image": [B, H, W, C], "label": [B] int}``. The loss is
    the f32 softmax cross-entropy against one-hot labels (smoothed by
    ``label_smoothing``); a model whose train-mode output is ``(logits,
    aux_logits)`` adds ``aux_weight`` x the aux cross-entropy. ``params``
    are ``model``'s own parameters (the train state holds them by
    reference), so the forward reads them through ``model``. A model whose
    forward takes a ``generator`` (Inception-v3's dropout) is given the
    step's; the others draw no randomness and are not.
    """
    takes_generator = "generator" in inspect.signature(model.forward).parameters

    def ce(logits, labels):
        n = logits.shape[-1]
        onehot = F.one_hot(labels.long(), n).to(torch.float32)
        if label_smoothing:
            onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n
        return -(onehot * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()

    def loss_fn(params, model_state, batch, generator):
        del params
        kwargs = {"generator": generator} if takes_generator else {}
        out, new_state = _apply(model, model_state, batch["image"], True, **kwargs)
        logits, aux = out if isinstance(out, tuple) else (out, None)
        labels = batch["label"]
        loss = ce(logits, labels)
        if aux is not None:
            loss = loss + aux_weight * ce(aux, labels)
        acc = (logits.argmax(-1) == labels.long()).to(torch.float32).mean()
        return loss, (new_state, {"accuracy": acc})

    return loss_fn


def make_classification_metrics(model):
    """Return an eval ``metric_fn(params, model_state, batch)``: loss and
    accuracy in eval mode, no gradient, no update of the statistics."""

    def metric_fn(params, model_state, batch):
        del params
        with torch.no_grad():
            logits, _ = _apply(model, model_state, batch["image"], False)
            labels = batch["label"].long()
            loss = F.cross_entropy(logits.float(), labels)
            acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return {"loss": loss, "accuracy": acc}

    return metric_fn


def init_model(model) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """``(params, model_state)`` of a built model: its own parameters by
    name, and ``{"batch_stats": ...}`` at init for models with BatchNorm."""
    params = dict(model.named_parameters())
    if hasattr(model, "init_batch_stats"):
        return params, {"batch_stats": model.init_batch_stats()}
    return params, {}
