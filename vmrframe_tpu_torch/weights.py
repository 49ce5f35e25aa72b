"""Weights for the port: seeded initialisation, and the carry-over of the JAX
package's parameter trees (the counterpart of ``tools/convert_torch.py``,
in the other direction).

The port's parameter names follow the flax tree, so a leaf maps by rule:

- path ``a/b/kernel`` -> ``a.b.weight``: a dense (in, out) is transposed to
  (out, in); a conv (k, in, out) -- depthwise (k, 1, D) or char conv
  (k, char_dim, ch) -- becomes (out, in, k);
- path ``a/b/scale`` (LayerNorm) -> ``a.b.weight``;
- every other leaf keeps its name and shape: ``bias``, ``w4C``/``w4Q``
  (D, 1), ``w4mlu`` (1, 1, D), ``label_embs`` (dim, 4),
  ``weighted_pool/weight`` (dim, 1), embeddings, ``unk_vec``, and the GloVe
  constant ``text_encoder/word_emb/glove_vec`` (a buffer).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from vmrframe_tpu_torch.layers.basic import DepthwiseConv1D, LayerNorm


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _leaf(path: str, value: np.ndarray):
    parts = path.split("/")
    name = parts[-1]
    if name == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 3:
            value = value.transpose(2, 1, 0)
        else:
            raise ValueError(f"{path}: no torch layout for a rank-{value.ndim} kernel")
        name = "weight"
    elif name == "scale":
        name = "weight"
    return ".".join(parts[:-1] + [name]), torch.tensor(np.asarray(value, np.float32))


def from_jax_params(params: Mapping, constants: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's ``variables["params"]``
    and ``variables["constants"]`` (nested trees, or flat dicts with
    ``/``-joined leaf names).  Raises if two leaves map to one name;
    ``load_state_dict(..., strict=True)`` then checks that every leaf found
    its parameter."""
    state: Dict[str, torch.Tensor] = {}
    for tree in (params, constants):
        for path, value in _flatten(tree).items():
            key, tensor = _leaf(path, value)
            if key in state:
                raise ValueError(f"two JAX leaves map to {key}")
            state[key] = tensor
    return state


def load_jax_params(model: nn.Module, params: Mapping, constants: Mapping) -> nn.Module:
    """``from_jax_params`` loaded strictly: a leaf without a parameter, a
    parameter without a leaf, or a shape that disagrees raises."""
    model.load_state_dict(from_jax_params(params, constants), strict=True)
    return model


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """State dict from an ``.npz`` of the JAX variables flattened with
    ``/``-joined names (``params/...``, ``constants/...``)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    trees = {"params": {}, "constants": {}}
    for key, value in flat.items():
        top, _, rest = key.partition("/")
        if top not in trees or not rest:
            raise ValueError(f"{path}: leaf {key!r} is neither params/... nor constants/...")
        trees[top][rest] = value
    return from_jax_params(trees["params"], trees["constants"])


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a ``torch.save``d state_dict, or an ``.npz`` of the JAX tree."""
    if path.endswith(".npz"):
        state = load_npz(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights with the JAX package's initialisers in kind:
    torch's fan-in uniform for dense and conv layers, ones/zeros for
    LayerNorm, N(0, 1) tables, Xavier-uniform vectors, orthogonal label
    embeddings, zero BiLinear extra bias."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t, bound):
        t.uniform_(-bound, bound, generator=g)

    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv1d, DepthwiseConv1D)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            uniform_(mod.weight, bound)
            if getattr(mod, "bias", None) is not None:
                uniform_(mod.bias, bound)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("position_embeddings", "char_table"):
            p.normal_(0.0, 1.0, generator=g)
        elif leaf in ("unk_vec", "w4C", "w4Q", "w4mlu") or name.endswith("weighted_pool.weight"):
            uniform_(p, math.sqrt(6.0 / (p.numel() + 1)))  # Xavier: one fan is 1
        elif leaf == "label_embs":
            q, r = torch.linalg.qr(torch.randn(p.shape, generator=g))
            p.copy_(q * torch.sign(torch.diagonal(r)))
        elif leaf == "bias_value":
            p.zero_()
    return model
