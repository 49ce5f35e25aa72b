"""The eval engine (counterpart of ``vmrframe_tpu/train/trainer.py``'s
``Trainer._eval_step`` and ``run_eval_epoch``).

One eval step is the deterministic forward, the loss, span inference and
per-sample IoU.  Under ``train.compute_dtype: bfloat16`` the model's rank >= 2
weights and the batch's rank >= 2 floats run in bf16 (``ops/precision.py``);
outputs come back to f32 before the loss and the spans, as
``_cast_for_compute``/``_upcast_outputs`` do.  There is no optimizer here.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from vmrframe_tpu_torch.device import resolve_device
from vmrframe_tpu_torch.metrics import AverageMeter, iou_device
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

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load f32 weights; the bf16 policy casts them on the way in."""
        self.model.load_state_dict(state, strict=True)

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "num_valid"}

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The model's outputs on a device batch, upcast to f32."""
        outputs = self.model(cast_batch(batch, self.compute_dtype))
        return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in outputs.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outputs = self.forward(batch)
        loss = self.entry.loss_fn(outputs, batch, self.cfg)
        props = self.entry.infer_fn(outputs, batch, self.cfg)
        ious = iou_device(batch["se_fracs"], props)
        return {"loss": loss, "ious": ious, "props": props, "sample_mask": batch["sample_mask"]}

    def run_eval_epoch(self, batches: Iterable, lossmeter: Optional[AverageMeter] = None,
                       collect_props: bool = False):
        """(ious, lossmeter, compute_seconds[, props]) over host batches; the
        padded tail of a partial batch is dropped by ``num_valid``."""
        ious: list = []
        props_all: list = []
        lossmeter = lossmeter or AverageMeter()
        compute_seconds = 0.0
        for batch in batches:
            n_valid = int(batch["num_valid"]) if "num_valid" in batch else None
            device_batch = self.to_device(batch)
            t0 = time.perf_counter()
            metrics = self.eval_step(device_batch)
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
