"""The trainer (counterpart of ``vmrframe_tpu/train/trainer.py``'s ``Trainer``
and ``fit``), on one device, ``cuda`` unless the caller asks for another.

A ``Trainer`` holds the model with its f32 master weights, the optimizer
(``train/optim.py``, with the registry entry's frozen parameters held
fixed), the step count and the ``extras`` of a stateful loss
(ActionFormer's EMA loss normaliser, detached after each step).  One train
step is the train-mode forward, the loss, the backward, clipping and AdamW,
then span inference and IoU on the step's outputs, as the JAX step does.
Under ``train.compute_dtype: bfloat16`` the forward reads bf16 copies of
the rank >= 2 weights and of the batch (``ops/precision.py``), and the
outputs come back to f32 before the loss.  Dropout (``train.dropout_bits``
wide, read by the model when it is built), the gumbel match head and
stochastic depth draw, in module order, from one ``torch.Generator`` per
step seeded from (seed, step), the counterpart of ``fold_in(rng, step)``: a
resumed run draws what an uninterrupted one would.

A batch whose batcher shipped raw features (``dataprocess.device_pipeline``)
goes through ``ops/input_pipeline.py`` on the device first: the train step
augments it with the config's augmentation, the eval step does not.

``fit`` runs the epochs: each a shuffled train pass seeded ``seed + epoch``
and a test pass at seed 0, a rolling ``last_`` full checkpoint and a
``best_`` one by test mIoU (``train/checkpoints.py``).  Torch modules need no
example batch to build, so ``fit`` takes none.

Under ``torch.distributed`` (``parallel/mesh.py``; ``torchrun``) the trainer
is data parallel, with the JAX sharded step's semantics: every process
takes the same global batch, runs the forward on its rows (its draws the
rows of the one-process draw), gathers the outputs, and computes the loss,
inference and IoU of the whole batch; the gradients are averaged, so every
process's AdamW applies the same update.  The same global batch through N
processes and through one gives the same losses and parameters, up to the
order of the sums.  Only rank 0 writes checkpoints and logs.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch.func import functional_call

from vmrframe_tpu_torch.device import batch_to, resolve_device
from vmrframe_tpu_torch.layers.dropout import batch_rows
from vmrframe_tpu_torch.metrics import AverageMeter, get_i345_mi, iou_device
from vmrframe_tpu_torch.ops.input_pipeline import apply_device_pipeline
from vmrframe_tpu_torch.ops.precision import cast_batch, cast_params
from vmrframe_tpu_torch.parallel import mesh
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.train.evaluator import run_epoch
from vmrframe_tpu_torch.train.optim import build_optimizer
from vmrframe_tpu_torch.weights import init_weights

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def step_seed(seed: int, step: int) -> int:
    """The random stream of one step (dropout, gumbel noise, stochastic
    depth), from (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    def __init__(self, cfg, derived, word_vectors: Optional[np.ndarray], device=None):
        self.cfg = cfg
        self.derived = derived
        self.device = resolve_device(device)
        self.entry = get_model_entry(cfg.model.name)
        self.compute_dtype = _DTYPES[cfg.train.get("compute_dtype", "float32")]
        self.model = self.entry.model_cls(cfg, derived, word_vectors).to(self.device)
        self.init_state(derived.seed)

    def init_state(self, seed: int) -> None:
        """Seeded initial weights, the entry's ``init_hook`` (a distillation
        model's pretrained teacher, copied into the parameters in place), a
        fresh optimizer with the entry's frozen parameters, step 0, initial
        extras."""
        self.seed = int(seed)
        init_weights(self.model.cpu(), self.seed).to(self.device)
        if self.entry.init_hook is not None:
            self.entry.init_hook(self, self.cfg)
        self.optimizer = build_optimizer(self.cfg, max(1, self.derived.num_train_steps),
                                         dict(self.model.named_parameters()),
                                         self.entry.frozen_filter)
        self.step = 0
        self.extras = {}
        if self.entry.stateful:
            self.extras = {k: v.to(self.device)
                           for k, v in self.entry.init_extras(self.cfg).items()}

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return batch_to(batch, self.device)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The model's outputs (in its current mode) from cast copies of the
        masters and the batch, upcast to f32.  Data parallel: this process's
        rows through the model, every process's outputs gathered."""
        if not mesh.is_distributed():
            return self._forward(batch, generator)
        total = batch["sample_mask"].shape[0]
        start, size = mesh.local_batch_slice(total)
        with batch_rows(start, size, total):
            outputs = self._forward(mesh.shard_batch(batch, start, size), generator)
        return mesh.gather_outputs(outputs, size)

    def _forward(self, batch, generator):
        outputs = functional_call(self.model, cast_params(self.model, self.compute_dtype),
                                  (cast_batch(batch, self.compute_dtype),),
                                  {"generator": generator})
        return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in outputs.items()}

    def _loss(self, outputs, batch):
        if self.entry.stateful:
            return self.entry.loss_fn(outputs, batch, self.cfg, self.extras)
        return self.entry.loss_fn(outputs, batch, self.cfg), self.extras

    def loss_and_grads(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None):
        """(loss, grads by parameter name, outputs, new extras) of the model
        in its current mode; nothing is updated.  Data parallel: the whole
        batch's loss and the processes' mean gradients."""
        outputs = self.forward(batch, generator)
        loss, new_extras = self._loss(outputs, batch)
        named = dict(self.model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
        if mesh.is_distributed():
            grads = mesh.all_reduce_grads(grads)
        return loss, grads, outputs, new_extras

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = apply_device_pipeline(batch, self.cfg, augment=True)
        self.model.train()
        generator = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, self.step))
        loss, grads, outputs, new_extras = self.loss_and_grads(batch, generator)
        self.optimizer.step(grads)
        self.extras = {k: v.detach() for k, v in new_extras.items()}
        self.step += 1
        with torch.no_grad():
            outputs = {k: v.detach() for k, v in outputs.items()}
            props = self.entry.infer_fn(outputs, batch, self.cfg)
            ious = iou_device(batch["se_fracs"], props)
        return {"loss": loss.detach(), "ious": ious, "sample_mask": batch["sample_mask"]}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = apply_device_pipeline(batch, self.cfg, augment=False)
        self.model.eval()
        outputs = self.forward(batch)
        loss, _ = self._loss(outputs, batch)
        props = self.entry.infer_fn(outputs, batch, self.cfg)
        ious = iou_device(batch["se_fracs"], props)
        return {"loss": loss, "ious": ious, "props": props, "sample_mask": batch["sample_mask"]}

    def run_train_epoch(self, batches: Iterable, lossmeter: Optional[AverageMeter] = None):
        """(ious, lossmeter, compute_seconds) over host batches."""
        return run_epoch(self.train_step, self.to_device, batches, lossmeter)

    def run_eval_epoch(self, batches: Iterable, lossmeter: Optional[AverageMeter] = None,
                       collect_props: bool = False):
        """(ious, lossmeter, compute_seconds[, props]) over host batches."""
        return run_epoch(self.eval_step, self.to_device, batches, lossmeter, collect_props)


def fit(trainer: Trainer, train_batcher, test_batcher, rng_seed: int = 1234,
        ckpt_dir: Optional[str] = None, log=print,
        resume_from: Optional[str] = None) -> Dict[str, Any]:
    """``cfg.train.epochs`` epochs of a train pass and a test pass, the best
    checkpoint by test mIoU.  ``resume_from`` restores a checkpoint (weights,
    and the optimizer state, step and extras when present) before training.
    Data parallel, every process runs the epochs (their metrics are the
    whole batch's on each) and rank 0 alone logs and writes checkpoints."""
    from vmrframe_tpu_torch.data.batcher import BatchPrefetcher
    from vmrframe_tpu_torch.train.checkpoints import restore_into, save_checkpoint

    cfg = trainer.cfg
    name = cfg.model.name
    if mesh.rank() != 0:
        ckpt_dir, log = None, (lambda *_: None)
    trainer.init_state(rng_seed)
    if resume_from:
        restore_into(trainer, resume_from)
        log(f"resumed from {resume_from} at step {trainer.step}")

    best_miou, best_path = -1.0, None
    history = []
    for epoch in range(cfg.train.epochs):
        t_epoch = time.time()
        batches = BatchPrefetcher(train_batcher.epoch(seed=rng_seed + epoch))
        try:
            ious, lossmeter, secs = trainer.run_train_epoch(batches)
        finally:
            batches.close()
        r1i3, r1i5, _, r1i7, mi = get_i345_mi(ious)
        log(f"TRAIN {epoch + 1:2d}|{cfg.train.epochs:2d} R1I3: {r1i3:.2f}\tR1I5: {r1i5:.2f}\t"
            f"R1I7: {r1i7:.2f}\tmIoU: {mi:.2f}\tloss: {lossmeter.avg:.4f}\t"
            f"step_s: {secs / max(1, len(train_batcher)):.4f}\t"
            f"samples/s: {train_batcher.num_samples / max(secs, 1e-9):.0f}")
        train_loss = lossmeter.avg

        batches = BatchPrefetcher(test_batcher.epoch(seed=0))
        try:
            ious, lossmeter, secs = trainer.run_eval_epoch(batches)
        finally:
            batches.close()
        r1i3, r1i5, _, r1i7, mi = get_i345_mi(ious)
        log(f"TEST  {epoch + 1:2d}|{cfg.train.epochs:2d} R1I3: {r1i3:.2f}\tR1I5: {r1i5:.2f}\t"
            f"R1I7: {r1i7:.2f}\tmIoU: {mi:.2f}\tloss: {lossmeter.avg:.4f}\t"
            f"eval_qps: {test_batcher.num_samples / max(secs, 1e-9):.0f}\t"
            f"epoch_s: {time.time() - t_epoch:.1f}")
        history.append({"epoch": epoch + 1, "train_loss": train_loss, "test_loss": lossmeter.avg,
                        "r1i3": r1i3, "r1i5": r1i5, "r1i7": r1i7, "miou": mi})

        if ckpt_dir:  # rolling full checkpoint (with the optimizer) for an exact resume
            save_checkpoint(ckpt_dir, trainer, name=f"last_{name}", full=True)
        if mi > best_miou:
            best_miou = mi
            if ckpt_dir:
                best_path = save_checkpoint(ckpt_dir, trainer, name=f"best_{name}")
                log(f"*** saved best checkpoint to {best_path}, mIoU={mi:.2f} ***")

    return {"best_miou": best_miou, "best_path": best_path, "history": history,
            "steps": trainer.step, "extras": trainer.extras}
