"""Optimizer (counterpart of ``vmrframe_tpu/train/optim.py``'s ``tree_adamw``):
global-norm clipping, then AdamW with a linear-warmup-linear-decay schedule,
with optax's semantics rather than torch's defaults.

- ``linear_warmup_decay``: HuggingFace's ``get_linear_schedule_with_warmup``
  with a fractional warmup of ``num_train_steps * warmup_proportion`` steps,
  computed in f32 as the JAX schedule is, and read at ``count - 1`` (optax's
  ``scale_by_schedule``), so the first update runs at lr 0 when there is a
  warmup.
- Clipping as ``optax.clip_by_global_norm``: ``g * clip / norm`` when
  ``norm >= clip``, with no epsilon (``clip_grad_norm_``'s ``+1e-6`` differs).
- AdamW as ``optax.adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)``:
  ``u = mu_hat / (sqrt(nu_hat) + eps)``, plus ``wd * p`` on the decayed
  leaves, times ``-lr``.  A leaf is decayed unless its name contains one of
  the reference's no-decay tokens (``bias``, ``layer_norm``, ...), the JAX
  package's ``_decay_mask``: the port's names are the flax paths with ``.``
  for ``/`` and ``weight`` for ``kernel``/``scale``, so the mask is the same
  (ActionFormer's ``ChannelLayerNorm`` weights are decayed, biases are not).

- A frozen parameter (``frozen_filter(name)``, a distillation model's
  teacher) gets no update, no weight decay, and moments that stay exactly
  zero, as ``flat_adamw``'s ``keep`` mask and ``tree_adamw``'s
  ``set_to_zero`` give; its gradient still counts toward the global clip
  norm.  The mask matters even where the gradient is zero: AdamW would
  still decay the weight by ``lr * 0.01 * p`` every step.

The JAX package also has a raveled single-buffer form (``flat_adamw``) with
the same values; the port has this one AdamW.  Its state is a dict keyed by
parameter name (frozen ones too, at zero), so a checkpoint restores by key.
The updates run as ``torch._foreach_*`` ops.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from vmrframe_tpu_torch.weights import jax_name

NO_DECAY = ("bias", "layer_norm", "self_ln_", "enc_ln_", "final_ln_")
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01  # the reference's AdamW


def linear_warmup_decay(base_lr: float, num_train_steps: int,
                        warmup_proportion: float) -> Callable[[int], float]:
    """lr at an optimizer count: warmup ``count / warmup`` then linear decay
    to 0 at ``num_train_steps``, in f32."""
    f32 = np.float32
    warmup = float(num_train_steps * warmup_proportion)

    def schedule(count: int) -> float:
        step = f32(count)
        warm = step / f32(max(1.0, warmup))
        span = f32(max(1.0, num_train_steps - warmup))
        decay = max(f32(0.0), (f32(num_train_steps) - step) / span)
        return float(f32(base_lr) * (warm if step < warmup else decay))

    return schedule


def decays(name: str) -> bool:
    """Whether the parameter ``name`` gets weight decay: the JAX mask on the
    JAX name.  An LSTM's biases are ``b_ih_l0``... there, without "bias",
    so they are decayed, whereas ``nn.LSTM`` names them ``bias_ih_l0``."""
    return not any(tok in jax_name(name).lower() for tok in NO_DECAY)


class AdamW:
    """Clip-by-global-norm + AdamW over named parameters, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float],
                 clip_norm: float, frozen_filter: Optional[Callable[[str], bool]] = None):
        self.params = dict(params)
        self.schedule, self.clip_norm = schedule, float(clip_norm)
        frozen = frozen_filter or (lambda name: False)
        self.trained = [n for n in self.params if not frozen(n)]
        self._decayed = [i for i, n in enumerate(self.trained) if decays(n)]
        self.state = self.init_state()

    def init_state(self) -> dict:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in self.params.items()}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """One update from ``grads`` (by name; a missing one counts as zero).
        Returns the global norm before clipping, frozen gradients included."""
        g = {n: grads[n] if grads.get(n) is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(g.values()))))
        coef = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
        params = [self.params[n] for n in self.trained]
        g = torch._foreach_mul([g[n] for n in self.trained], coef)

        count = self.state["count"] + 1
        mu = [self.state["mu"][n] for n in self.trained]
        nu = [self.state["nu"][n] for n in self.trained]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(B1) ** f32(count))  # optax's bias corrections, in f32
        bc2 = float(f32(1.0) - f32(B2) ** f32(count))
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(u, den)
        if self._decayed:
            torch._foreach_add_([u[i] for i in self._decayed], [params[i] for i in self._decayed],
                                alpha=WEIGHT_DECAY)
        torch._foreach_mul_(u, -self.schedule(count - 1))
        torch._foreach_add_(params, u)
        self.state["count"] = count
        return norm


def build_optimizer(cfg, num_train_steps: int, params: Dict[str, torch.Tensor],
                    frozen_filter: Optional[Callable[[str], bool]] = None) -> AdamW:
    """The config's AdamW (``train.lr``, ``train.warmup_proportion``,
    ``train.clip_norm``) over ``params``, those named by ``frozen_filter``
    held fixed."""
    schedule = linear_warmup_decay(float(cfg.train.lr), num_train_steps,
                                   float(cfg.train.warmup_proportion))
    return AdamW(params, schedule, float(cfg.train.clip_norm), frozen_filter)
