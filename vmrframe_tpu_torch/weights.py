"""Weights for the port: seeded initialisation, and the carry-over of the JAX
package's parameter trees (the counterpart of ``tools/convert_torch.py``,
in the other direction).

The port's parameter names follow the flax tree, so a leaf maps by rule:

- path ``a/b/kernel`` -> ``a.b.weight``: a dense (in, out) is transposed to
  (out, in); a conv (k, in/groups, out) -- depthwise (k, 1, D), grouped, or
  char conv (k, char_dim, ch) -- becomes (out, in/groups, k);
- path ``a/b/scale`` -> ``a.b.weight`` in its own shape: a LayerNorm scale,
  and ActionFormer's ``Scale`` (shape ()) and ``AffineDropPath`` (1, 1, D)
  scalars, which the port's modules name ``weight``;
- every other leaf keeps its name and shape: ``bias`` (ActionFormer's
  ``ChannelLayerNorm`` has ``weight``/``bias`` in flax too), ``w4C``/``w4Q``
  (D, 1), ``w4mlu`` (1, 1, D), ``label_embs`` (dim, 4),
  ``weighted_pool/weight`` (dim, 1), embeddings, ``unk_vec``, and the GloVe
  constant ``text_encoder/word_emb/glove_vec`` (a buffer).

The rules cover the whole SeqPAN family: BackBone's tree adds a
``tfeat_encoder`` and drops the match head, BaseFast's drops the two
dual-attention blocks and has 2 encoder layers; BackBoneBertSentence's has a
``text_affine`` projection in place of the GloVe/char ``text_encoder``,
BackBoneAlignFeature's is BackBone's without the match head, and
BackBoneActionFormer's adds a ``backbone`` of ActionFormer's.  On
ActionFormer's trees, the conv backbone (``embd_*``, ``stem_*/conv1``,
``conv2``, ``branch_*/downsample``: conv kernels), the FPN neck
(``lateral_*``, the depthwise ``fpn_conv_*``, ``fpn_norm_*``) and rel-PE
(``rel_pe``, (n_head, window) as it is) follow the same rules.  BAN's LSTM
leaves are already in ``nn.LSTM``'s layout and only renamed: ``w_ih_l{k}``
-> ``weight_ih_l{k}``, ``b_hh_l{k}_reverse`` -> ``bias_hh_l{k}_reverse``;
its ``map2d_proj_kernel`` (3F, F) and ``map2d_proj_bias`` keep name and
shape.  CCA's conv2d kernels (kh, kw, in, out) become (out, in, kh, kw); its
BatchNorm statistics come from the ``batch_stats`` collection
(``sim_map/bn/mean`` and ``var`` -> ``sim_map.bn.running_mean`` and
``running_var``); every leaf that carries its layout in its own name keeps
name and shape: CCA's GCN weights ``gc1_weight``/``gc2_weight`` (in, out),
the torch-layout ``in_proj_weight`` (3E, E) of CCA's batch-attending layer
and of CPL's attention, and the (in, out) ``out_proj_kernel``,
``ff1_kernel``, ``fc1_kernel``, ``word_fc_kernel``, ... of both models.
The distillation models'
teachers are whole SeqPAN trees nested under one prefix (``teacher_t0/...``
in ``OneTeacher``, ``teach_model/...`` in the frozen-teacher models), which
the same rules carry across as ``teacher_t0.`` and ``teach_model.``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from vmrframe_tpu_torch.layers.basic import DepthwiseConv1D, LayerNorm

# CCA's batch-attending transformer and CPL's attention keep torch's layout
# and names, with flax's xavier_uniform init
_XAVIER = ("in_proj_weight", "out_proj_kernel", "ff1_kernel", "ff2_kernel")

# the std of a standard normal truncated at +-2: flax's truncated_normal
# divides by it so that the truncated draw has the std asked for
TRUNCATED_NORMAL_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


# an LSTM's leaves, the same shape in both packages: JAX's w_ih_l0 and
# b_hh_l1_reverse are nn.LSTM's weight_ih_l0 and bias_hh_l1_reverse
_LSTM_LEAF = re.compile(r"^(w|b|weight|bias)(_(?:ih|hh)_l\d+(?:_reverse)?)$")
_LSTM_TORCH = {"w": "weight", "b": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def jax_name(name: str) -> str:
    """The JAX package's name of the port's parameter ``name`` where the
    leaf names differ: an LSTM's (the other leaves differ in layout only)."""
    head, _, leaf = name.rpartition(".")
    m = _LSTM_LEAF.match(leaf)
    if m and m.group(1) in ("weight", "bias"):
        leaf = m.group(1)[0] + m.group(2)
    return f"{head}.{leaf}" if head else leaf


def _leaf(path: str, value: np.ndarray):
    parts = path.split("/")
    name = parts[-1]
    m = _LSTM_LEAF.match(name)
    if m and m.group(1) in _LSTM_TORCH:
        name = _LSTM_TORCH[m.group(1)] + m.group(2)
    elif name == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 3:
            value = value.transpose(2, 1, 0)
        elif value.ndim == 4:  # a 2D conv (kh, kw, in, out) -> (out, in, kh, kw)
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{path}: no torch layout for a rank-{value.ndim} kernel")
        name = "weight"
    elif name == "scale":
        name = "weight"
    elif parts[0] == "batch_stats":  # flax's BatchNorm statistics: buffers
        parts, name = parts[1:], _STATS[name]
    return ".".join(parts[:-1] + [name]), torch.tensor(np.asarray(value, np.float32))


def from_jax_params(params: Mapping, constants: Mapping,
                    batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's ``variables["params"]``,
    ``variables["constants"]`` and, for a model with BatchNorm (CCA),
    ``variables["batch_stats"]`` (nested trees, or flat dicts with
    ``/``-joined leaf names).  Raises if two leaves map to one name;
    ``load_state_dict(..., strict=True)`` then checks that every leaf found
    its parameter."""
    state: Dict[str, torch.Tensor] = {}
    trees = [_flatten(params), _flatten(constants)]
    if batch_stats:
        trees.append({f"batch_stats/{k}": v for k, v in _flatten(batch_stats).items()})
    for tree in trees:
        for path, value in tree.items():
            key, tensor = _leaf(path, value)
            if key in state:
                raise ValueError(f"two JAX leaves map to {key}")
            state[key] = tensor
    return state


def load_jax_params(model: nn.Module, params: Mapping, constants: Mapping,
                    batch_stats: Optional[Mapping] = None) -> nn.Module:
    """``from_jax_params`` loaded strictly: a leaf without a parameter, a
    parameter without a leaf, or a shape that disagrees raises."""
    model.load_state_dict(from_jax_params(params, constants, batch_stats), strict=True)
    return model


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """State dict from an ``.npz`` of the JAX variables flattened with
    ``/``-joined names (``params/...``, ``constants/...``,
    ``batch_stats/...``)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    trees = {"params": {}, "constants": {}, "batch_stats": {}}
    for key, value in flat.items():
        top, _, rest = key.partition("/")
        if top not in trees or not rest:
            raise ValueError(f"{path}: leaf {key!r} is not params/..., constants/... "
                             "or batch_stats/...")
        trees[top][rest] = value
    return from_jax_params(trees["params"], trees["constants"], trees["batch_stats"])


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``torch.save``d state_dict, of the ``params`` of a
    trainer's checkpoint (``train/checkpoints.py``), or of an ``.npz`` of the
    JAX tree.  A missing file raises ``FileNotFoundError``."""
    if path.endswith(".npz"):
        return load_npz(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state.get("params"), dict):
        state = state["params"]
    return state


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """``read_checkpoint`` loaded strictly into ``model``."""
    model.load_state_dict(read_checkpoint(path), strict=True)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights with the JAX package's initialisers in kind:
    torch's fan-in uniform for dense and conv layers (ActionFormer's with
    zero biases: ``zero_bias_init``), ones/zeros for LayerNorm, N(0, 1)
    tables, Xavier-uniform vectors, orthogonal label embeddings, zero
    BiLinear extra bias; a module that states an ``init_value`` (ActionFormer's
    ``ChannelLayerNorm``, ``Scale`` and ``AffineDropPath``) gets its weight
    filled with it and its bias zeroed (CCA's BatchNorm, whose running
    statistics are reset too); ``MaskedMHCA``'s ``rel_pe`` a normal
    truncated at 2 sigma with std ``rel_pe_std`` after the truncation, as
    flax's ``truncated_normal``; the leaves named in flax's layout as flax
    inits them: ``*_kernel`` (in, out) fan-in uniform, the attention
    layers' ``in_proj_weight``/``out_proj_kernel``/``ff*_kernel`` Xavier
    uniform, CCA's GCN weights U(+-1/sqrt(out)); their biases, LayerNorm
    scales and CPL's start vector as built (zeros, ones)."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t, bound):
        t.uniform_(-bound, bound, generator=g)

    for mod in model.modules():
        if getattr(mod, "rel_pe_std", None):  # ActionFormer's rel-PE: flax's truncated normal
            std = mod.rel_pe_std / TRUNCATED_NORMAL_STD  # the std after truncation at 2 sigma
            nn.init.trunc_normal_(mod.rel_pe, std=std, a=-2.0 * std, b=2.0 * std, generator=g)
        if isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, DepthwiseConv1D)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            uniform_(mod.weight, bound)
            if getattr(mod, "bias", None) is not None:
                if getattr(mod, "zero_bias_init", False):
                    mod.bias.zero_()
                else:
                    uniform_(mod.bias, bound)
        elif hasattr(mod, "init_value"):
            mod.weight.fill_(mod.init_value)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LSTM):  # every leaf U(-1/sqrt(H), 1/sqrt(H)), as flax's BAN
            for p in mod.parameters(recurse=False):
                uniform_(p, 1.0 / math.sqrt(mod.hidden_size))
        if hasattr(mod, "reset_running_stats"):  # CCA's BatchNorm
            mod.reset_running_stats()
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
        elif leaf == "map2d_proj_bias":  # BAN's: fan-in 3F
            uniform_(p, 1.0 / math.sqrt(3 * p.shape[0]))
        elif leaf in _XAVIER:  # torch's attention layout: flax's xavier_uniform
            uniform_(p, math.sqrt(6.0 / (p.shape[0] + p.shape[1])))
        elif leaf.endswith("_kernel"):  # an (in, out) dense kernel: fan-in in
            uniform_(p, 1.0 / math.sqrt(p.shape[0]))
        elif leaf in ("gc1_weight", "gc2_weight"):  # CCA's GCN: U(+-1/sqrt(out))
            uniform_(p, 1.0 / math.sqrt(p.shape[1]))
    return model
