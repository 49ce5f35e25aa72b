"""SeqPAN's losses (counterpart of ``vmrframe_tpu/losses.py::lossfun_loc`` and
``lossfun_match``).  ``sample_mask`` weights out the padded tail of a
partial batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
