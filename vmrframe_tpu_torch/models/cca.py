"""CCA, commonsense-aware cross-modal alignment (counterpart of
``vmrframe_tpu/models/cca.py``).

A concept GCN over the commonsense graph gives a concept basis (A, E); the
projected clip features, seen as H channel rows of T columns, get the basis
appended as A more columns and go through one transformer layer of width
T + A; the first T columns become the strided sparse 2D map (cell (i, i + o)
the maximum over clips i .. i + o on the diagonals of ``POOLING_COUNTS``);
an LSTM query vector meets the map twice, as cosine scores against the map
after a conv5x5 -> BatchNorm -> tanh -> conv3x3 branch, and, fused with the
concept basis by attention, against the raw map; a learned scalar blends
the two.  The loss is the scaled-IoU BCE over ``mask2d(NUM_CLIPS)``.

As in the JAX package:

- the transformer attends per sample over the channel rows;
  ``model.ref_transformer_quirk`` selects the reference's layer that
  attends across the batch instead (``RefBatchTransformerLayer``);
- the concept adjacency, the concept embeddings and the GloVe table are
  constants (buffers here), the adjacency normalized once
  (``data/concepts.py``);
- BatchNorm is flax's: momentum 0.9 on the old value, the biased batch
  variance E[x^2] - E[x]^2 in f32, batch statistics where the forward is not
  deterministic (train mode here) and the running ones where it is;
- the dropouts are fixed: 0.5 in ``FuseAttention``, 0.1 in the transformer;
  ``model.droprate`` is not read.

The JAX package's formulation switches are TPU formulations of one value:
``others.cca_map_impl`` ("gather" or "scatter") and
``others.cca_contraction_scores`` ("vjp", "eval", "always", "never").  The
port accepts each and computes one form: the gathered map
(``ops/windowed.py::cell_segment_max_map``) and ``CosineSumScores``, the
contraction forward with the hand-derived backward.

Under the bf16 policy the map, the transformer, the GCN and the query branch
run in bf16 like the JAX model's; BatchNorm normalizes in f32 and its tanh
returns to bf16; the f32 ``v_t_param`` promotes the blended ``scores2d`` to
f32.  The query LSTM runs in its input's type, as the JAX scan does: bf16
through the scan, each gate's two f32 biases summed in f32 and rounded once
(``layers/recurrent.py::LSTM``).  CCA runs no hand-written kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vmrframe_tpu_torch.config import others
from vmrframe_tpu_torch.data.cca_batcher import CCABatcher
from vmrframe_tpu_torch.data.concepts import load_concepts
from vmrframe_tpu_torch.data.labels import mask2d as build_mask2d
from vmrframe_tpu_torch.layers.basic import layer_norm
from vmrframe_tpu_torch.layers.dropout import Dropout, dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.recurrent import LSTM
from vmrframe_tpu_torch.losses import lossfun_loc2d
from vmrframe_tpu_torch.models.ban import Linear
from vmrframe_tpu_torch.ops.span import infer_span_2d
from vmrframe_tpu_torch.ops.windowed import cell_segment_max_map
from vmrframe_tpu_torch.parallel.mesh import all_reduce_sum, is_distributed, world
from vmrframe_tpu_torch.registry import register_model

HARD_DROP_FUSE = 0.5  # FuseAttention's fixed rate
HARD_DROP_TRANSFORMER = 0.1  # the transformer layer's
MAP_IMPLS = ("gather", "scatter")
SCORE_IMPLS = ("vjp", "eval", "always", "never")
_COS_EPS2 = 1e-24  # l2norm's clamp (1e-12) squared
# key biases shift every score of a softmax row alike: their gradients are
# zero up to rounding in both packages
SHIFT_INVARIANT = ("T_fuse_attn.key.bias", "V_TransformerLayer.k.bias")
# in train mode BatchNorm subtracts each channel's batch mean, and the conv
# bias before it with it
TRAIN_SHIFT_INVARIANT = SHIFT_INVARIANT + ("sim_map.conv.bias",)


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / ||x|| over the last axis, the squared norm clamped at eps^2 (safe
    at all-zero vectors)."""
    return x / (x * x).sum(dim=-1, keepdim=True).clamp_min(eps * eps).sqrt()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the wider of the two dtypes, as flax promotes."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


@functools.lru_cache(maxsize=None)
def cca_strided_mask_meta(pooling_counts, N: int):
    """CCA's strided sparse map: (mask (N, N), [(offset, stride), ...]); the
    diagonals of stage k are taken at every 2**k-th start."""
    mask = np.zeros((N, N), dtype=bool)
    mask[np.arange(N), np.arange(N)] = True
    cells = []
    stride, offset = 1, 0
    for c in pooling_counts:
        for _ in range(c):
            offset += stride
            if offset >= N:
                break
            i = np.arange(0, N - offset, stride)
            mask[i, i + offset] = True
            cells.append((offset, stride))
        stride *= 2
    return mask, tuple(cells)


class CosineSumScores(torch.autograd.Function):
    """sum_h l2norm(q * m)_h = (sum_h q_h m_h) / sqrt(max(sum_h q_h^2 m_h^2,
    eps^2)) for q (B, H) and m (B, L, L, H), the (B, L, L, H) product never
    formed.  The backward is the JAX package's hand-derived one:

        dm = (g / den) q - (g num / den^3) q^2 m
        dq = <g / den, m> - q <g num / den^3, m^2>

    with the second term only where d2 > eps^2 (all-zero map cells sit on
    the clamp, where den is constant)."""

    @staticmethod
    def forward(ctx, q, m):
        num = torch.einsum("bh,bijh->bij", q, m)
        d2 = torch.einsum("bh,bijh->bij", q * q, m * m)
        den = d2.clamp_min(_COS_EPS2).sqrt()
        ctx.save_for_backward(q, m, num, den, d2)
        return num / den

    @staticmethod
    def backward(ctx, g):
        q, m, num, den, d2 = ctx.saved_tensors
        a = g / den
        b = torch.where(d2 > _COS_EPS2, g * num / (den * den * den), g.new_zeros(()))
        q2 = q * q
        dm = a[..., None] * q[:, None, None, :] - b[..., None] * q2[:, None, None, :] * m
        dq = torch.einsum("bij,bijh->bh", a, m) - q * torch.einsum("bij,bijh->bh", b, m * m)
        return dq, dm


def cosine_sum_scores(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return CosineSumScores.apply(q, m)


class ConceptGCN(nn.Module):
    """Two GCN layers over the frozen normalized adjacency, LeakyReLU(0.2)
    between, l2norm after.  The weights are (in, out), applied as x @ w."""

    def __init__(self, embed_size: int, adj: np.ndarray, concept_embs: np.ndarray):
        super().__init__()
        half = embed_size // 2
        self.register_buffer("adj_all", torch.from_numpy(np.asarray(adj, np.float32)))
        self.register_buffer("concept_embs", torch.from_numpy(np.asarray(concept_embs,
                                                                         np.float32)))
        self.gc1_weight = nn.Parameter(torch.zeros(concept_embs.shape[-1], half))
        self.gc2_weight = nn.Parameter(torch.zeros(half, embed_size))

    def forward(self):
        adj = self.adj_all
        x = adj @ (self.concept_embs @ self.gc1_weight)
        x = F.leaky_relu(x, 0.2)
        return l2norm(adj @ (x @ self.gc2_weight))


class FuseAttention(nn.Module):
    """Single-head attention of the query vector over the concept basis at
    temperature x10, dropout 0.5 on the weights, residual, l2norm."""

    def __init__(self, hidden_dim: int, concept_dim: int):
        super().__init__()
        self.query = Linear(hidden_dim, concept_dim)
        self.key = Linear(concept_dim, hidden_dim)
        self.value = Linear(concept_dim, hidden_dim)
        self.dropout = Dropout(HARD_DROP_FUSE)

    def forward(self, feat, concept, generator=None):
        scores = torch.softmax(self.query(feat) @ self.key(concept).t() * 10.0, dim=1)
        out = self.dropout(scores, generator) @ self.value(concept)
        return l2norm(out + feat)


class TransformerLayer(nn.Module):
    """Per-sample post-norm encoder layer over the channel rows (the
    intended semantics of the reference's call): d_model over the last
    axis, 8 heads, FFN 2048, ReLU, dropout 0.1."""

    def __init__(self, d_model: int, nhead: int = 8, dim_feedforward: int = 2048):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"CCA's transformer width {d_model} (NUM_CLIPS + num_attribute) "
                             f"is not a multiple of its {nhead} heads")
        self.nhead = nhead
        self.q, self.k, self.v = (Linear(d_model, d_model) for _ in range(3))
        self.out_proj = Linear(d_model, d_model)
        self.ff1 = Linear(d_model, dim_feedforward)
        self.ff2 = Linear(dim_feedforward, d_model)
        for name in ("ln1", "ln2"):
            self.register_parameter(f"{name}_scale", nn.Parameter(torch.ones(d_model)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(d_model)))
        self.drop = Dropout(HARD_DROP_TRANSFORMER)

    def forward(self, x, generator=None):
        B, S, D = x.shape
        H = self.nhead
        heads = lambda t: t.reshape(B, S, H, D // H).transpose(1, 2)  # noqa: E731
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // H), dim=-1)
        out = (self.drop(att, generator) @ v).transpose(1, 2).reshape(B, S, D)
        x = layer_norm(x + self.drop(self.out_proj(out), generator), self.ln1_scale,
                        self.ln1_bias)
        ff = self.ff2(self.drop(torch.relu(self.ff1(x)), generator))
        return layer_norm(x + self.drop(ff, generator), self.ln2_scale, self.ln2_bias)


class RefBatchTransformerLayer(nn.Module):
    """The reference's encoder layer as it runs there: the (B, C, E) tensor
    reaches ``nn.TransformerEncoderLayer`` without ``batch_first``, so each
    channel row attends across the B samples.  Torch's parameter layout:
    ``in_proj_weight`` (3E, E) applied as x @ w.T; ``out_proj_kernel``,
    ``ff1_kernel``, ``ff2_kernel`` (in, out) applied as x @ w.  Its biases
    are added unbiased by ``biased``, so under the bf16 policy the layer
    promotes to f32 from the first projection on, as flax does."""

    def __init__(self, d_model: int, nhead: int = 8, dim_feedforward: int = 2048):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"CCA's transformer width {d_model} is not a multiple of {nhead}")
        E, Fd = d_model, dim_feedforward
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj_kernel = nn.Parameter(torch.zeros(E, E))
        self.out_proj_bias = nn.Parameter(torch.zeros(E))
        self.ff1_kernel = nn.Parameter(torch.zeros(E, Fd))
        self.ff1_bias = nn.Parameter(torch.zeros(Fd))
        self.ff2_kernel = nn.Parameter(torch.zeros(Fd, E))
        self.ff2_bias = nn.Parameter(torch.zeros(E))
        for name in ("ln1", "ln2"):
            self.register_parameter(f"{name}_scale", nn.Parameter(torch.ones(E)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(E)))
        self.drop = Dropout(HARD_DROP_TRANSFORMER)

    def forward(self, x, generator=None):
        B, C, E = x.shape
        H, hd = self.nhead, E // self.nhead
        w, b = self.in_proj_weight, self.in_proj_bias
        q = (_dot(x, w[:E].t()) + b[:E]) * (hd ** -0.5)
        k = _dot(x, w[E:2 * E].t()) + b[E:2 * E]
        v = _dot(x, w[2 * E:].t()) + b[2 * E:]
        q, k, v = (t.reshape(B, C, H, hd) for t in (q, k, v))
        att = torch.softmax(torch.einsum("ichd,jchd->chij", q, k), dim=-1)
        out = torch.einsum("chij,jchd->ichd", self.drop(att, generator), v).reshape(B, C, E)
        x = layer_norm(x + self.drop(_dot(out, self.out_proj_kernel) + self.out_proj_bias,
                                      generator), self.ln1_scale, self.ln1_bias)
        hidden = self.drop(torch.relu(_dot(x, self.ff1_kernel) + self.ff1_bias), generator)
        ff = _dot(hidden, self.ff2_kernel) + self.ff2_bias
        return layer_norm(x + self.drop(ff, generator), self.ln2_scale, self.ln2_bias)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the last axis (momentum 0.9, eps 1e-5):
    statistics in f32, the variance the biased E[x^2] - E[x]^2 clipped at 0,
    over every process's rows under data parallelism (``parallel/mesh.py``);
    ``deterministic`` reads the running statistics, otherwise the batch's,
    which also update the running ones (momentum on the old value).  The
    result is f32 (the f32 scale and statistics promote it)."""

    init_value = 1.0  # weights.init_weights: scale 1, bias 0

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = float(momentum), float(eps)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def reset_running_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, deterministic: bool):
        if deterministic:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            if is_distributed():  # the statistics of every process's rows
                n = xf.numel() // xf.shape[-1] * world()
                sums = all_reduce_sum(torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]))
                mean, sq = sums[0] / n, sums[1] / n
            else:
                mean, sq = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = x - mean
        return y * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Conv2d(nn.Conv2d):
    """SAME-padded conv over a channels-last (B, L, L, C) map; the bias is
    cast to the map's dtype, as flax's ``nn.Conv(dtype=...)`` casts it."""

    zero_bias_init = True  # flax's Conv bias starts at zero

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__(in_ch, out_ch, k, padding=k // 2)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias.to(x.dtype),
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm2dTanhConv(nn.Module):
    """conv5x5 -> tanh(BatchNorm) -> conv3x3 over (B, L, L, C) maps."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = Conv2d(in_ch, features, 5)
        self.bn = BatchNorm(features)
        self.conv1 = Conv2d(features, features, 3)

    def forward(self, map2d, deterministic: bool):
        y = torch.tanh(self.bn(self.conv(map2d), deterministic)).to(map2d.dtype)
        return self.conv1(y)


def _cca_cfg(cfg):
    return cfg.MODEL.CCA



class CCA(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        mc = _cca_cfg(cfg)
        m = cfg.model
        L, hidden, E = int(mc.NUM_CLIPS), int(mc.FEATPOOL.HIDDEN_SIZE), int(cfg.embed_size)
        if hidden != E:
            raise ValueError(f"CCA concatenates the concept basis (embed_size {E}) to the "
                             f"{hidden} feature rows: they must be equal")
        self.L = L
        map_impl = str(others(cfg, "cca_map_impl", "gather"))
        if map_impl not in MAP_IMPLS:  # each gives cell_segment_max_map's map
            raise ValueError(f"others.cca_map_impl {map_impl!r} is not one of {MAP_IMPLS}")
        scores = str(others(cfg, "cca_contraction_scores", "vjp"))
        if scores not in SCORE_IMPLS:  # each is CosineSumScores' value
            raise ValueError(f"others.cca_contraction_scores {scores!r} is not one of "
                             f"{SCORE_IMPLS}")
        concept_embs, adj = load_concepts(cfg, word_dim=int(cfg.INPUT.PRE_QUERY_SIZE))
        A = concept_embs.shape[0]
        self.C_GCN = ConceptGCN(E, adj, concept_embs)
        self.featpool_conv = Linear(int(m.vdim), hidden)
        layer = RefBatchTransformerLayer if bool(m.get("ref_transformer_quirk", False)) \
            else TransformerLayer
        self.V_TransformerLayer = layer(L + A)
        _, self.cells = cca_strided_mask_meta(tuple(int(c) for c in mc.FEAT2D.POOLING_COUNTS), L)
        word_dim = int(m.word_dim)
        self.unk_vec = nn.Parameter(torch.zeros(1, word_dim))
        self.register_buffer("glove_vec", torch.tensor(np.asarray(word_vectors, np.float32)))
        qh = int(mc.INTEGRATOR.QUERY_HIDDEN_SIZE)
        self.sim_lstm = LSTM(word_dim, qh // 2, int(mc.INTEGRATOR.LSTM.NUM_LAYERS),
                             bidirectional=True)
        self.fc_full = Linear(qh, hidden)
        self.sim_map = BatchNorm2dTanhConv(hidden, hidden)
        self.T_fuse_attn = FuseAttention(hidden, E)
        self.v_t_param = nn.Parameter(torch.full((1,), 0.5))
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g, deterministic = generator, not self.training
        concept_basis = self.C_GCN()  # (A, E)
        feats = torch.relu(self.featpool_conv(batch["vfeats"])).transpose(1, 2)  # (B, H, T)
        B = feats.shape[0]
        cb = concept_basis.t()[None].expand(B, -1, -1)  # (B, E, A)
        x = self.V_TransformerLayer(torch.cat([feats, cb], dim=2), g)
        feats = x[:, :, : self.L].transpose(1, 2)  # (B, L, H)
        map2d = cell_segment_max_map(feats, self.cells)  # (B, L, L, H)

        glove = self.glove_vec
        table = torch.cat([glove.new_zeros(1, glove.shape[1]), self.unk_vec.to(glove.dtype),
                           glove], dim=0)
        tfeat = table[batch["words_ids"].long()]
        q_out = self.sim_lstm(tfeat, None)
        wordlens = batch["tmasks"].sum(dim=1).to(torch.int64)
        q_end = q_out[torch.arange(B, device=q_out.device), (wordlens - 1).clamp_min(0)]
        queries = self.fc_full((q_out[:, 0] + q_end) / 2)  # (B, H)

        map2d_fused = self.sim_map(map2d, deterministic)
        queries_fused = self.T_fuse_attn(queries, concept_basis, g)
        v2t = cosine_sum_scores(queries, map2d_fused)
        t2v = cosine_sum_scores(queries_fused, map2d)
        v_t = self.v_t_param
        return {"scores2d": v_t * v2t + (1 - v_t) * t2v, "vmask": batch["vmasks"]}


@functools.lru_cache(maxsize=None)
def _dense_mask(L: int) -> np.ndarray:
    return build_mask2d(L)


def _mask(cfg, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_dense_mask(int(_cca_cfg(cfg).NUM_CLIPS)), device=like.device)


def cca_loss(outputs, batch, cfg) -> torch.Tensor:
    """Scaled-IoU BCE over ``mask2d(NUM_CLIPS)``'s cells."""
    mc = _cca_cfg(cfg)
    scores = outputs["scores2d"]
    return lossfun_loc2d(scores, batch["label2ds"], _mask(cfg, scores), float(mc.LOSS.MIN_IOU),
                         float(mc.LOSS.MAX_IOU), sample_mask=batch.get("sample_mask"))


def cca_infer(outputs, batch, cfg) -> torch.Tensor:
    scores = outputs["scores2d"]
    return infer_span_2d(scores, _mask(cfg, scores), outputs["vmask"])


register_model("CCA", loss_fn=cca_loss, infer_fn=cca_infer, batcher_cls=CCABatcher,
               optimizer_impl="tree")(CCA)
