"""CPL's Gaussian-weighted transformer decoder (counterpart of
``vmrframe_tpu/layers/cpl_decoder.py``).

Post-norm decoder layers whose attention probabilities are reweighted by a
proposal's Gaussian over the keys after the softmax and renormalized, the
mechanism that focuses reconstruction on one temporal proposal; causal
(-inf above the diagonal) self-attention on the target; padded keys at
-1e30.  Parameters keep the JAX package's names and layouts:
``in_proj_weight`` (3E, E) applied as x @ w.T, ``out_proj_kernel``,
``fc1_kernel`` and ``fc2_kernel`` (in, out) applied as x @ w.

The shared-prefix path (``n_props`` = P > 1): the query, key, value and
masks arrive at batch B, the Gaussian at B * P rows, the output leaves at
B * P rows.  The P copies of a clip share q, k, v, the logits and the
softmax.  Since the Gaussian weighs only the keys, the deterministic output
is (softmax(qk) @ (g_p * v)) / (softmax(qk) @ g_p); with dropout the
probabilities are formed per proposal after the shared softmax, so the masks
stay independent per (clip, proposal) row.  The JAX package's switch
``others.cpl_shared_prefix`` picks between this path and repeating the
inputs P times; both give the same values, and the port computes this one.
``others.cpl_remat`` (rematerialize each layer in the backward) changes no
value either, and the port accepts it and stores the activations.
"""

from __future__ import annotations

import torch
from torch import nn

from vmrframe_tpu_torch.layers.basic import layer_norm
from vmrframe_tpu_torch.layers.dropout import Dropout
from vmrframe_tpu_torch.ops.precision import biased


class GaussMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        E = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj_kernel = nn.Parameter(torch.zeros(E, E))
        self.out_proj_bias = nn.Parameter(torch.zeros(E))
        self.dropout = Dropout(dropout)

    def forward(self, query, key, value, key_padding_mask=None, attn_mask=None,
                gauss_weight=None, generator=None, n_props: int = 1):
        """key_padding_mask (B, Tk), 1 = pad; attn_mask (Tq, Tk) additive;
        gauss_weight (B, Tk), or (B * P, Tk) with ``n_props`` P > 1."""
        B, Tq, E = query.shape
        Tk = key.shape[1]
        H, P = self.num_heads, int(n_props)
        hd = E // H
        w, b = self.in_proj_weight, self.in_proj_bias
        q = biased(query @ w[:E].t(), b[:E]) * (hd ** -0.5)
        k = biased(key @ w[E:2 * E].t(), b[E:2 * E])
        v = biased(value @ w[2 * E:].t(), b[2 * E:])
        q, k, v = q.reshape(B, Tq, H, hd), k.reshape(B, Tk, H, hd), v.reshape(B, Tk, H, hd)

        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if attn_mask is not None:
            s = s + attn_mask[None, None]
        if key_padding_mask is not None:
            s = torch.where(key_padding_mask[:, None, None, :] == 1, s.new_full((), -1e30), s)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        deterministic = not self.training or self.dropout.rate == 0.0

        if P > 1:
            if gauss_weight is not None:
                gw = gauss_weight.reshape(B, P, Tk) + 1e-10
                if deterministic:
                    num = torch.einsum("bhqk,bpk,bkhd->bpqhd", p, gw, v)
                    den = torch.einsum("bhqk,bpk->bpqh", p, gw)
                    out = num / den[..., None]
                else:
                    pp = p[:, None] * gw[:, :, None, None, :]  # (B, P, H, Tq, Tk)
                    pp = self.dropout(pp / pp.sum(dim=-1, keepdim=True), generator)
                    out = torch.einsum("bphqk,bkhd->bpqhd", pp, v)
            elif deterministic:  # the same for every proposal: project at B, then repeat
                o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Tq, E)
                return biased(o @ self.out_proj_kernel, self.out_proj_bias).repeat_interleave(
                    P, dim=0)
            else:
                pp = self.dropout(p[:, None].expand(B, P, H, Tq, Tk), generator)
                out = torch.einsum("bphqk,bkhd->bpqhd", pp, v)
            out = out.reshape(B * P, Tq, E)
        else:
            if gauss_weight is not None:
                p = p * (gauss_weight[:, None, None, :] + 1e-10)
                p = p / p.sum(dim=-1, keepdim=True)
            p = self.dropout(p, generator)
            out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Tq, E)
        return biased(out @ self.out_proj_kernel, self.out_proj_bias)


class TransformerDecoderLayer(nn.Module):
    """Self-attention, then (``cross``) attention over the encoder output,
    then a 2x-wide ReLU FFN, each post-normed with a dropped residual."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, cross: bool = False):
        super().__init__()
        D = d_model
        self.self_attn = GaussMultiheadAttention(D, num_heads, dropout)
        names = ["self_ln", "final_ln"]
        if cross:
            self.encoder_attn = GaussMultiheadAttention(D, num_heads, dropout)
            names.append("enc_ln")
        for name in names:
            self.register_parameter(f"{name}_scale", nn.Parameter(torch.ones(D)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(D)))
        self.fc1_kernel = nn.Parameter(torch.zeros(D, 2 * D))
        self.fc1_bias = nn.Parameter(torch.zeros(2 * D))
        self.fc2_kernel = nn.Parameter(torch.zeros(2 * D, D))
        self.fc2_bias = nn.Parameter(torch.zeros(D))
        self.drop = Dropout(dropout)

    def forward(self, x, pad_mask, encoder_out, encoder_pad_mask, self_attn_mask,
                src_gauss_weight, tgt_gauss_weight, n_props: int = 1, generator=None):
        g = generator
        res = x
        x = self.self_attn(x, x, x, pad_mask, self_attn_mask, tgt_gauss_weight, g,
                           n_props=n_props)
        if n_props > 1:  # the shared-prefix layer: x entered at B, leaves at B * P
            res = res.repeat_interleave(n_props, dim=0)
        x = layer_norm(res + self.drop(x, g), self.self_ln_scale, self.self_ln_bias)
        if encoder_out is not None:
            res = x
            x = self.encoder_attn(x, encoder_out, encoder_out, encoder_pad_mask, None,
                                  src_gauss_weight, g)
            x = layer_norm(res + self.drop(x, g), self.enc_ln_scale, self.enc_ln_bias)
        res = x
        x = biased(torch.relu(biased(x @ self.fc1_kernel, self.fc1_bias)) @ self.fc2_kernel,
                   self.fc2_bias)
        return layer_norm(res + self.drop(x, g), self.final_ln_scale, self.final_ln_bias)


class TransformerDecoder(nn.Module):
    """``num_layers`` decoder layers, causal on the target.  The masks are
    {0, 1} valid masks, flipped to pad masks inside.  ``n_props`` P > 1: the
    target and its mask arrive at batch B, the source, its mask and the
    Gaussians at B * P rows; layer 0 runs the shared-prefix attention."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, dropout: float = 0.0,
                 cross: bool = False):
        super().__init__()
        self.num_layers = int(num_layers)
        for i in range(self.num_layers):  # the JAX tree's layer_0, layer_1, ...
            setattr(self, f"layer_{i}", TransformerDecoderLayer(d_model, num_heads, dropout, cross))

    def forward(self, src, src_mask, tgt, tgt_mask, src_gauss_weight=None,
                tgt_gauss_weight=None, generator=None, n_props: int = 1):
        T = tgt.shape[1]
        attn_mask = torch.full((T, T), float("-inf"), device=tgt.device).triu(1)
        pad_tgt = None if tgt_mask is None else 1 - tgt_mask
        pad_src = None if src_mask is None else 1 - src_mask
        x = tgt
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            x = layer(x, pad_tgt, src, pad_src, attn_mask, src_gauss_weight,
                      tgt_gauss_weight, n_props if i == 0 else 1, generator=generator)
            if i == 0 and n_props > 1 and pad_tgt is not None:
                pad_tgt = pad_tgt.repeat_interleave(n_props, dim=0)
        return x

