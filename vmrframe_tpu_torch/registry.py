"""Model registry (counterpart of ``vmrframe_tpu/registry.py``), trimmed to
what serving needs: the module class, its loss and its span inference."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

MODEL_REGISTRY: Dict[str, "ModelEntry"] = {}


@dataclasses.dataclass
class ModelEntry:
    name: str
    model_cls: Any  # nn.Module class, built as model_cls(cfg, derived, word_vectors)
    loss_fn: Optional[Callable] = None  # (outputs, batch, cfg) -> scalar tensor
    infer_fn: Optional[Callable] = None  # (outputs, batch, cfg) -> (B, 2) fractions


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
