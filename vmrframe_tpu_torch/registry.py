"""Model registry (counterpart of ``vmrframe_tpu/registry.py``), trimmed to
what serving and training need: the module class, its batcher, its loss
(stateful or not), its span inference, and the distillation family's frozen
parameters and init hook."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

MODEL_REGISTRY: Dict[str, "ModelEntry"] = {}


@dataclasses.dataclass
class ModelEntry:
    name: str
    model_cls: Any  # nn.Module class, built as model_cls(cfg, derived, word_vectors)
    batcher_cls: Any = None  # static-shape batch assembler; None = data.batcher.Batcher
    loss_fn: Optional[Callable] = None  # (outputs, batch, cfg) -> scalar tensor
    infer_fn: Optional[Callable] = None  # (outputs, batch, cfg) -> (B, 2) fractions
    # stateful losses (ActionFormer's EMA loss normaliser):
    # loss_fn(outputs, batch, cfg, extras) -> (loss, new_extras)
    stateful: bool = False
    init_extras: Optional[Callable] = None  # (cfg) -> dict of tensors
    # distillation: a parameter whose name (``teach_model.predictor...``)
    # matches ``frozen_filter`` gets no optimizer update (a frozen teacher);
    # ``init_hook`` runs once after the seeded init, e.g. to load a
    # pretrained teacher into the model's parameters in place
    frozen_filter: Optional[Callable] = None  # (name) -> bool
    init_hook: Optional[Callable] = None  # (trainer, cfg) -> None
    # the JAX package's measured choice between its two AdamW formulations;
    # a record only here: the port has one AdamW (train/optim.py)
    optimizer_impl: Optional[str] = None


def register_model(name: str, **kwargs):
    """Class decorator: ``@register_model("SeqPAN", loss_fn=..., infer_fn=...)``."""

    def wrap(model_cls):
        MODEL_REGISTRY[name] = ModelEntry(name=name, model_cls=model_cls, **kwargs)
        return model_cls

    return wrap


def get_model_entry(name: str) -> ModelEntry:
    import vmrframe_tpu_torch.models  # noqa: F401  (registration side effects)

    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
