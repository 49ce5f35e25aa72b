"""The original PyTorch repository's SeqPAN-family checkpoints into the port
(counterpart of ``vmrframe_tpu/tools/convert_torch.py``).

The reference saves ``state_dict``s (``ckpt/{task}_{suffix}/best_{model}.pkl``,
its ``utils/utils.py:208-215``) whose names and layouts are its own.
``convert_seqpan_family`` maps them onto the JAX package's parameter tree,
by the JAX tool's rules (kept here as the port's own copy); the port's
``weights.from_jax_params`` then names them as the port's modules do:

- Conv1d k=1 (the reference's ``Conv1D``): (out, in, 1) -> (in, out);
- depthwise Conv1d k=7: (dim, 1, 7) -> (7, 1, dim);
- Conv2d (1, k) char convs: (ch, char_dim, 1, k) -> (k, char_dim, ch);
- Linear: (out, in) -> (in, out); LayerNorm weight/bias -> scale/bias;
- ``nn.MultiheadAttention``'s in_proj_weight (3D, D) -> separate q/k/v
  kernels (the predictor's ``TopSelfAttention2``);
- LSTM weights keep torch's layout.

Dead reference tensors are dropped (``DEAD_PATTERNS``): ``BiLinear.dense_2``
(the reference applies ``dense_1`` to both inputs) and
``DualMultiAttention.{layer_norm1, layer_norm2, out_layer}`` (never called
in its forward), and BatchNorm's ``num_batches_tracked``.

``reference_layout`` is the inverse for the SeqPAN family: a port model's
weights under the reference's names and layouts, which the tests and
``chip_smoke.py`` use as a synthetic reference checkpoint.

    python -m vmrframe_tpu_torch.tools.convert_torch --config configs/charades_seqpan_fused.yaml \\
        --checkpoint best_SeqPAN.pkl --out best_SeqPAN.pt

The ``.pt`` it writes loads wherever the port reads a checkpoint
(``weights.read_checkpoint``: the CLI's ``--checkpoint``, the service).
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


DEAD_PATTERNS = [
    re.compile(r"\.bilinear_\d\.dense_2\."),
    re.compile(r"dual_multihead_attention\.(layer_norm1|layer_norm2|out_layer)\."),
    re.compile(r"\.num_batches_tracked$"),
]


def _np(v) -> np.ndarray:
    """A copy in f32: a tensor's ``.numpy()`` shares its memory."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32, copy=True)


def convert_seqpan_family(state_dict: Dict[str, Any]) -> Dict[str, Dict]:
    """A SeqPAN/BaseFast/BackBone-family reference ``state_dict`` as the JAX
    package's trees: ``{'params': tree, 'constants': tree}``."""
    params: Dict = {}
    constants: Dict = {}
    for name, value in state_dict.items():
        if any(p.search(name) for p in DEAD_PATTERNS):
            continue
        v = _np(value)
        parts = name.split(".")

        # the frozen GloVe table; the pad row is zeros, rebuilt at run time
        if parts[-1] == "glove_vec":
            _set(constants, tuple(parts[:-1]) + ("glove_vec",), v)
            continue
        if parts[-1] == "pad_vec":
            continue

        name = name.replace(".conv1d.weight", ".kernel").replace(".conv1d.bias", ".bias")

        # char conv stacks: char_convs.{i}.0.{weight,bias} -> conv_k{i+1}
        m = re.search(r"char_emb\.char_convs\.(\d)\.0\.(weight|bias)", name)
        if m:
            k = int(m.group(1)) + 1
            base = tuple((name[: m.start()] + "char_emb").split("."))
            if m.group(2) == "weight":  # (ch, char_dim, 1, k) -> (k, char_dim, ch)
                _set(params, base + (f"conv_k{k}", "kernel"), v.squeeze(2).transpose(2, 1, 0))
            else:
                _set(params, base + (f"conv_k{k}", "bias"), v)
            continue
        if name.endswith("char_emb.char_emb.weight"):
            _set(params, tuple(name.split(".")[:-2]) + ("char_table",), v)
            continue

        # depthwise-separable conv blocks
        m = re.search(r"conv_block\.depthwise_separable_conv\.(\d)\.([01])\.(weight|bias)", name)
        if m:
            i, which, wb = int(m.group(1)), m.group(2), m.group(3)
            base = tuple(name[: m.start()].split(".")[:-1]) + ("conv_block",)
            if which == "0":  # depthwise (dim, 1, 7) -> (7, 1, dim)
                _set(params, base + (f"depthwise_{i}", "kernel"), v.transpose(2, 1, 0))
            elif wb == "weight":  # pointwise (dim, dim, 1)
                _set(params, base + (f"pointwise_{i}", "kernel"), v.squeeze(2).T)
            else:
                _set(params, base + (f"pointwise_{i}", "bias"), v)
            continue
        m = re.search(r"conv_block\.layer_norms\.(\d)\.(weight|bias)", name)
        if m:
            i, wb = int(m.group(1)), m.group(2)
            base = tuple(name[: m.start()].split(".")[:-1]) + ("conv_block",)
            _set(params, base + (f"layer_norm_{i}", "scale" if wb == "weight" else "bias"), v)
            continue

        if name.endswith("pos_embedding.position_embeddings.weight"):
            _set(params, tuple(name.split(".")[:-1]), v)
            continue

        # the predictor's nn.MultiheadAttention (TopSelfAttention2)
        m = re.search(r"top_self_attention\.selfattn\.(.*)", name)
        if m:
            base = tuple(name[: m.start()].split(".")[:-1]) + ("top_self_attention",)
            sub = m.group(1)
            if sub in ("in_proj_weight", "in_proj_bias"):
                leaf = "kernel" if sub == "in_proj_weight" else "bias"
                for nm, part in zip(("query", "key", "value"), np.split(v, 3, axis=0)):
                    _set(params, base + (nm, leaf), part.T if leaf == "kernel" else part)
            elif sub == "out_proj.weight":
                _set(params, base + ("out_proj", "kernel"), v.T)
            elif sub == "out_proj.bias":
                _set(params, base + ("out_proj", "bias"), v)
            continue

        # LSTM weights: weight_ih_l{k}[_reverse] -> w_ih_l{k}[_reverse], one layout
        m = re.search(r"\.(weight|bias)_(ih|hh)_l(\d+)(_reverse)?$", name)
        if m:
            w, which, layer, rev = m.groups()
            leaf = f"{'w' if w == 'weight' else 'b'}_{which}_l{layer}{rev or ''}"
            _set(params, tuple(name[: m.start()].split(".")) + (leaf,), v)
            continue

        parts = name.split(".")
        if len(parts) >= 2 and "layer_norm" in parts[-2] and parts[-1] in ("weight", "bias"):
            _set(params, tuple(parts[:-1]) + ("scale" if parts[-1] == "weight" else "bias",), v)
            continue
        if parts[-1] == "kernel":  # a renamed Conv1D: (out, in, 1) -> (in, out)
            if v.ndim == 3 and v.shape[-1] == 1:
                v = v.squeeze(2).T
            elif v.ndim == 2:
                v = v.T
            _set(params, tuple(parts), v)
            continue
        if len(parts) >= 2 and parts[-2] == "weighted_pool":  # (dim, 1) as it is
            _set(params, tuple(parts), v)
            continue
        if parts[-1] == "weight" and v.ndim == 2:  # a Linear
            _set(params, tuple(parts[:-1]) + ("kernel",), v.T)
            continue
        # biases, label_embs, w4C/w4Q/w4mlu, bias_value, unk_vec
        _set(params, tuple(parts), v)
    return {"params": params, "constants": constants}


def to_port_state(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` under the port's names and layouts."""
    from vmrframe_tpu_torch.weights import from_jax_params

    tree = convert_seqpan_family(state_dict)
    return from_jax_params(tree["params"], tree["constants"])


def load_reference(model: torch.nn.Module, state_dict: Dict[str, Any]) -> torch.nn.Module:
    """``to_port_state`` loaded strictly into ``model``: a leaf without a
    parameter, a parameter without a leaf, or a shape that disagrees raises."""
    model.load_state_dict(to_port_state(state_dict), strict=True)
    return model


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference checkpoint (a pickled ``state_dict``) on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def compare_trees(converted: Dict, target: Dict, atol: float = 1e-4):
    """Per-leaf report: (missing_in_converted, extra, mismatched shapes)."""
    a, b = flatten_tree(converted), flatten_tree(target)
    missing = sorted(set(b) - set(a))
    extra = sorted(set(a) - set(b))
    mismatched = [(key, a[key].shape, b[key].shape) for key in sorted(set(a) & set(b))
                  if a[key].shape != b[key].shape]
    return missing, extra, mismatched


def reference_layout(model: torch.nn.Module, dead: bool = True) -> Dict[str, torch.Tensor]:
    """The inverse of ``to_port_state`` for a SeqPAN-family model: its
    weights under the reference's names and layouts (``pad_vec`` included),
    and, with ``dead``, the reference's dead tensors filled with noise, which
    the conversion must drop."""
    from vmrframe_tpu_torch.layers.basic import Conv1D, DepthwiseConv1D, LayerNorm

    modules = dict(model.named_modules())
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in model.state_dict().items():
        value = value.detach().cpu().float()
        owner_name, _, leaf = key.rpartition(".")
        owner = modules[owner_name]
        parent, _, child = owner_name.rpartition(".")
        m = re.match(r"conv_k(\d)$", child)
        if m:  # char conv (ch, cd, k) -> (ch, cd, 1, k)
            out[f"{parent}.char_convs.{int(m.group(1)) - 1}.0.{leaf}"] = \
                value[:, :, None, :] if leaf == "weight" else value
        elif leaf == "char_table":
            out[f"{owner_name}.char_emb.weight"] = value
        elif leaf == "position_embeddings":
            out[f"{key}.weight"] = value
        elif leaf == "glove_vec":
            out[key] = value
            out[f"{owner_name}.pad_vec"] = torch.zeros(1, value.shape[1])
        elif isinstance(owner, DepthwiseConv1D):
            i = child.split("_")[1]
            out[f"{parent}.depthwise_separable_conv.{i}.0.{leaf}"] = value
        elif isinstance(owner, LayerNorm) and re.match(r"layer_norm_\d$", child) \
                and parent.endswith("conv_block"):
            out[f"{parent}.layer_norms.{child.split('_')[-1]}.{leaf}"] = value
        elif isinstance(owner, Conv1D) and parent.endswith("top_self_attention"):
            if child == "out_proj":
                out[f"{parent}.selfattn.out_proj.{leaf}"] = value
            else:
                qkv.setdefault(parent, {})[f"{child}.{leaf}"] = value
        elif isinstance(owner, Conv1D) and child.startswith("pointwise_"):
            i = child.split("_")[1]
            out[f"{parent}.depthwise_separable_conv.{i}.1.{leaf}"] = \
                value[:, :, None] if leaf == "weight" else value
        elif isinstance(owner, Conv1D):
            out[f"{owner_name}.conv1d.{leaf}"] = value[:, :, None] if leaf == "weight" else value
        else:  # LayerNorm weight/bias, label_embs, w4*, bias_value, weighted_pool, unk_vec
            out[key] = value
    for parent, parts in qkv.items():
        for leaf in ("weight", "bias"):
            out[f"{parent}.selfattn.in_proj_{leaf}"] = torch.cat(
                [parts[f"{w}.{leaf}"] for w in ("query", "key", "value")])
    if dead:
        g = torch.Generator().manual_seed(0)
        for key in list(out):
            m = re.match(r"(.*\.dual_multihead_attention)\.bilinear_(\d)\.dense_1\.conv1d\.weight$",
                         key)
            if m:
                D = out[key].shape[0]
                att, i = m.group(1), m.group(2)
                out[f"{att}.bilinear_{i}.dense_2.conv1d.weight"] = torch.randn(D, D, 1,
                                                                               generator=g)
                if i == "1":
                    out[f"{att}.layer_norm1.weight"] = torch.randn(D, generator=g)
                    out[f"{att}.out_layer.conv1d.weight"] = torch.randn(D, D, 1, generator=g)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="a reference SeqPAN-family checkpoint into the "
                                             "port: a state_dict the port loads")
    ap.add_argument("--config", required=True, help="the model's config (checks the result)")
    ap.add_argument("--checkpoint", required=True, help="the reference's pickled state_dict")
    ap.add_argument("--out", required=True, help="where to torch.save the port's state_dict")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.registry import get_model_entry

    cfg = load_config(args.config)
    reference = load_torch_checkpoint(args.checkpoint)
    state = to_port_state(reference)
    glove = state["text_encoder.word_emb.glove_vec"].numpy() \
        if "text_encoder.word_emb.glove_vec" in state else None
    words = len(glove) + 2 if glove is not None else 2
    derived = Derived(num_words=words, num_chars=state["text_encoder.char_emb.char_table"]
                      .shape[0] if "text_encoder.char_emb.char_table" in state else 2)
    model = get_model_entry(str(cfg.model.name)).model_cls(cfg, derived, glove)
    model.load_state_dict(state, strict=True)  # every leaf found its parameter
    torch.save(state, args.out)
    print(f"{len(reference)} reference tensors -> {len(state)} port tensors ({args.out})")


if __name__ == "__main__":
    main()
