"""The zoo's losses (counterpart of ``vmrframe_tpu/losses.py``): SeqPAN's
``lossfun_loc`` and ``lossfun_match``, the distillation loss
``lossfun_softloc``, CCA's 2D-map BCE ``lossfun_loc2d``, and CPL's
label-smoothed reconstruction NLL (``cal_nll_loss``, ``rec_loss_cpl``) and
proposal diversity penalty (``div_loss_cpl``).  ``sample_mask`` weights out
the padded tail of a partial batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vmrframe_tpu_torch.ops.masking import mask_logits


def _weighted_mean(per_sample: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_mask is None:
        return per_sample.mean()
    return (per_sample * sample_mask).sum() / sample_mask.sum().clamp_min(1.0)


def lossfun_loc(start_logits, end_logits, s_labels, e_labels, vmask,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE against soft, unnormalised boundary labels; the logits are not
    masked, as in the reference (the labels are ~0 outside the clip)."""
    del vmask
    sloss = -(s_labels * F.log_softmax(start_logits, dim=1)).sum(dim=1)
    eloss = -(e_labels * F.log_softmax(end_logits, dim=1)).sum(dim=1)
    return _weighted_mean(sloss, sample_mask) + _weighted_mean(eloss, sample_mask)


def lossfun_match(match_probs, label_embs, m_labels, vmask,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-sum onehot(NER) * probs over valid frames, plus an orthogonality
    penalty on the 4 label embeddings.  Callers pass ``match_score`` as
    ``match_probs``, as the reference's engine does."""
    m_onehot = F.one_hot(m_labels.long(), 4).to(match_probs.dtype)
    loss_per_pos = -(m_onehot * match_probs).sum(dim=-1)  # (B, L)
    weight = vmask
    if sample_mask is not None:
        weight = weight * sample_mask[:, None]
    m_loss = (loss_per_pos * weight).sum() / (weight.sum() + 1e-12)
    eye = torch.eye(4, dtype=label_embs.dtype, device=label_embs.device)
    gram = (label_embs.T @ label_embs) * (1.0 - eye)
    return m_loss + torch.linalg.vector_norm(gram.reshape(-1), ord=2)


def lossfun_softloc(slogits, elogits, s_labels, e_labels, vmask,
                    temperature: float) -> torch.Tensor:
    """Distillation loss: mask, L2-normalise over positions (floor 1e-12),
    softmax at ``temperature``, then the per-sample KL(teacher || student) of
    the start and the end curves.  Returns (B,); callers reduce.

    The norm is ``sqrt(sum(x * x))`` as ``jnp.linalg.norm`` computes it: a
    padded position's -1e30 squares to inf in f32, so a sample with padding
    normalises to zeros and its KL is 0, as in the JAX package."""

    def prep(x):
        x = mask_logits(x, vmask)
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True))
        return torch.softmax(x / norm.clamp_min(1e-12) / temperature, dim=-1)

    def kl(p, q):  # F.kl_div(log q, p) summed over positions
        return (p * (torch.log(p.clamp_min(1e-30)) - torch.log(q.clamp_min(1e-30)))).sum(dim=1)

    return kl(prep(s_labels), prep(slogits)) + kl(prep(e_labels), prep(elogits))


def lossfun_loc2d(scores2d, labels2d, mask2d, min_iou: float = 0.5, max_iou: float = 1.0,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled-IoU BCE over the masked 2D proposal map: labels (iou - min) /
    (max - min) clipped to [0, 1], mean over the mask's cells."""
    labels = ((labels2d - min_iou) / (max_iou - min_iou)).clamp(0.0, 1.0)
    per_cell = labels * F.softplus(-scores2d) + (1 - labels) * F.softplus(scores2d)
    weight = mask2d.to(scores2d.dtype).expand_as(per_cell)
    if sample_mask is not None:
        weight = weight * sample_mask.reshape((-1,) + (1,) * (per_cell.dim() - 1))
    return (per_cell * weight).sum() / weight.sum().clamp_min(1.0)


def cal_nll_loss(logit, idx, mask, weights=None, eps: float = 0.1):
    """CPL's label-smoothed NLL.  logit (N, T, V), idx (N, T) targets, mask
    (N, T); returns (per-sequence loss (N,), mean accuracy)."""
    acc = (logit.argmax(dim=-1) == idx).float()
    mean_acc = (acc * mask).sum() / mask.sum().clamp_min(1.0)
    logp = F.log_softmax(logit, dim=-1)
    nll = -logp.gather(-1, idx.long()[..., None]).squeeze(-1)
    nll = (1 - eps) * nll + eps / logit.shape[-1] * -logp.sum(dim=-1)
    if weights is None:
        nll = torch.where(mask == 0, nll.new_zeros(()), nll)
        nll = nll.sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
    else:
        nll = (nll * weights).sum(dim=-1)
    return nll, mean_acc


def rec_loss_cpl(tlogit_prop, words_id, words_mask, num_props: int) -> torch.Tensor:
    """Each clip's smallest reconstruction NLL over its P proposals, averaged."""
    P = num_props
    nll, _ = cal_nll_loss(tlogit_prop, words_id.repeat_interleave(P, dim=0),
                          words_mask.repeat_interleave(P, dim=0))
    return nll.reshape(-1, P).amin(dim=-1).mean()


def div_loss_cpl(gauss_weight, num_props: int, lam: float, alpha: float) -> torch.Tensor:
    """Proposal diversity ||lam I - G G^T||^2 over each clip's P Gaussians,
    each normalized to sum 1; mean over clips times ``alpha``."""
    P = num_props
    gw = gauss_weight.reshape(-1, P, gauss_weight.shape[-1])
    gw = gw / gw.sum(dim=-1, keepdim=True)
    target = torch.eye(P, dtype=gw.dtype, device=gw.device)[None] * lam
    return (target - gw @ gw.transpose(1, 2)).square().sum(dim=(1, 2)).mean() * alpha
