"""The eval engine (counterpart of ``vmrframe_tpu/train/trainer.py``'s
``Trainer._eval_step`` and ``run_eval_epoch``).

One eval step is the deterministic forward, the loss, span inference and
per-sample IoU.  Under ``train.compute_dtype: bfloat16`` the model's rank >= 2
weights and the batch's rank >= 2 floats run in bf16 (``ops/precision.py``);
outputs come back to f32 before the loss and the spans, as
``_cast_for_compute``/``_upcast_outputs`` do.  A stateful model's loss
(ActionFormer's EMA normaliser) reads the ``extras`` its ``init_extras``
made, as the trainer's eval step reads them from its state.  A batch of raw
features (``dataprocess.device_pipeline``) is resampled and labelled on the
device first (``ops/input_pipeline.py``, no augmentation).  There is no
optimizer here.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from vmrframe_tpu_torch.device import batch_to, resolve_device
from vmrframe_tpu_torch.metrics import AverageMeter, iou_device
from vmrframe_tpu_torch.ops.input_pipeline import apply_device_pipeline
from vmrframe_tpu_torch.ops.precision import cast_batch, cast_module_
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.weights import init_weights

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Evaluator:
    """Owns one model on one device.  ``device`` defaults to ``cuda``."""

    def __init__(self, cfg, derived, word_vectors: np.ndarray, device=None, seed: int = 0):
        self.cfg = cfg
        self.derived = derived
        self.device = resolve_device(device)
        self.entry = get_model_entry(cfg.model.name)
        self.compute_dtype = _DTYPES[cfg.train.get("compute_dtype", "float32")]
        model = init_weights(self.entry.model_cls(cfg, derived, word_vectors), seed)
        self.model = cast_module_(model.to(self.device).eval(), self.compute_dtype)
        self.extras = None
        if self.entry.stateful:
            self.extras = {k: v.to(self.device) for k, v in self.entry.init_extras(cfg).items()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load f32 weights; the bf16 policy casts them on the way in."""
        self.model.load_state_dict(state, strict=True)

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return batch_to(batch, self.device)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The model's outputs on a device batch, upcast to f32."""
        outputs = self.model(cast_batch(batch, self.compute_dtype))
        return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in outputs.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = apply_device_pipeline(batch, self.cfg, augment=False)
        outputs = self.forward(batch)
        if self.entry.stateful:
            loss, _ = self.entry.loss_fn(outputs, batch, self.cfg, self.extras)
        else:
            loss = self.entry.loss_fn(outputs, batch, self.cfg)
        props = self.entry.infer_fn(outputs, batch, self.cfg)
        ious = iou_device(batch["se_fracs"], props)
        return {"loss": loss, "ious": ious, "props": props, "sample_mask": batch["sample_mask"]}

    def run_eval_epoch(self, batches: Iterable, lossmeter: Optional[AverageMeter] = None,
                       collect_props: bool = False):
        """(ious, lossmeter, compute_seconds[, props]) over host batches."""
        return run_epoch(self.eval_step, self.to_device, batches, lossmeter, collect_props)


def run_epoch(step_fn: Callable, to_device: Callable, batches: Iterable,
              lossmeter: Optional[AverageMeter] = None, collect_props: bool = False):
    """(ious, lossmeter, compute_seconds[, props]) of ``step_fn`` over host
    batches; the padded tail of a partial batch is dropped by ``num_valid``.
    compute_seconds runs from the step's first launch to its IoUs on the host."""
    ious: list = []
    props_all: list = []
    lossmeter = lossmeter or AverageMeter()
    compute_seconds = 0.0
    for batch in batches:
        n_valid = int(batch["num_valid"]) if "num_valid" in batch else None
        device_batch = to_device(batch)
        t0 = time.perf_counter()
        metrics = step_fn(device_batch)
        loss = float(metrics["loss"])
        batch_ious = metrics["ious"].cpu().numpy()
        compute_seconds += time.perf_counter() - t0
        ious.extend(batch_ious[:n_valid].tolist())
        if collect_props:
            props_all.append(metrics["props"].cpu().numpy()[:n_valid])
        lossmeter.update(loss)
    if collect_props:
        props = np.concatenate(props_all) if props_all else np.zeros((0, 2))
        return ious, lossmeter, compute_seconds, props
    return ious, lossmeter, compute_seconds
