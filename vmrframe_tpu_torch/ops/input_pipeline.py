"""On-device input pipeline: augmentation, resampling and labels as torch
operations on the batch's device (counterpart of
``vmrframe_tpu/ops/input_pipeline.py``, which is jitted XLA, not a Pallas
kernel).

The host pads each sample's raw features to the dataset's longest video
and ships (raw_vfeats, raw_lens, se_fracs, pipeline_seed)
(``data/batcher.py::Batcher._make_raw_batch``, opt-in with
``dataprocess.device_pipeline: true``); the rest happens here, batched over
B, with no host synchronisation:

- ``erosion``: crop bounds drawn by rejection (the first of 100 draws that
  keeps the gt span inside, else the clamp to the whole clip);
- ``dilation``: windows of the clip's negative (outside-gt) frames
  prepended and appended, as an index remapping on a static grid of
  ``max_raw + 2 ceil(p max_raw)`` frames (the negative pool packed to the
  front by a stable sort); uniform noise where a clip has no negative frame;
- the mean-pool resampling onto ``vlen``, as one (B, vlen, grid) weight
  matrix applied by ``torch.bmm``;
- the boundary span, the clipped-Gaussian ``label1ds`` and the O/B/I/E
  ``NER_labels``, from index arithmetic.

Random draws come from a ``torch.Generator`` on the batch's device seeded by
``pipeline_seed``, so a batch is reproducible on one device; the JAX draws
come from its own PRNG and are not reproduced.  ``unchanged`` and
``samelen`` draw nothing and equal the JAX function.
"""

from __future__ import annotations

from typing import Dict

import torch

RAW_KEYS = ("raw_vfeats", "raw_lens", "pipeline_seed")


def _round(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).long()  # half to even, as jnp.round and python's round


def _first_true(ok: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where there is none)."""
    return ok.to(torch.int32).argmax(-1)


def _sample_erosion_bounds(g: torch.Generator, p: float, T, sidx, eidx):
    """(head, tail) with head <= sidx and tail >= eidx on the raw grid: the
    first accepted of 100 draws each, else 0 and T - 1."""
    B, dev = T.shape[0], T.device
    u1 = torch.rand((B, 100), generator=g, device=dev)
    u2 = torch.rand((B, 100), generator=g, device=dev)
    Tf = T.float()[:, None]
    head_cand = _round(u1 * p * Tf)
    tail_cand = T[:, None] - 1 - _round(u2 * p * Tf)
    head_ok = head_cand <= sidx[:, None]
    tail_ok = tail_cand >= eidx[:, None]
    head = head_cand.gather(1, _first_true(head_ok)[:, None].long())[:, 0]
    tail = tail_cand.gather(1, _first_true(tail_ok)[:, None].long())[:, 0]
    head = torch.where(head_ok.any(1), head, torch.zeros_like(head))
    tail = torch.where(tail_ok.any(1), tail, T - 1)
    return head, tail


def _segment_weights(head, cur_len, vlen: int, max_raw: int, resample) -> torch.Tensor:
    """(B, vlen, max_raw) weights over each clip [head, head + cur_len): the
    segment means of the reference's ``interpolate_avrage`` where
    ``resample``, else the copy of the first ``vlen`` frames."""
    dev = head.device
    i = torch.arange(vlen, device=dev)
    t = torch.arange(max_raw, device=dev)
    idxs = _round(i.float()[None, :] / vlen * (cur_len - 1).float()[:, None])  # (B, vlen)
    ends = torch.cat([idxs[:, 1:], cur_len[:, None]], dim=1)
    counts = ends - idxs
    lo = (head[:, None] + idxs)[..., None]
    hi = (head[:, None] + ends)[..., None]
    in_seg = (t >= lo) & (t < hi)
    w_mean = in_seg.float() / counts.clamp(min=1)[..., None].float()
    # an empty segment (start == end) copies the single frame at its start
    at = (head[:, None] + torch.minimum(idxs, cur_len[:, None] - 1))[..., None]
    w_res = torch.where((counts > 0)[..., None], w_mean, (t == at).float())
    w_id = ((t == (head[:, None] + i)[..., None]) & (i < cur_len[:, None])[..., None]).float()
    return torch.where(resample[:, None, None], w_res, w_id)


def _dist_idx(sidx, eidx, vlen: int) -> torch.Tensor:
    """(B, 2, vlen) start and end heatmaps: a Gaussian of width 0.1 of the
    span, 1 above 0.8, 0 below 0.1353, the peak set to 1 where nothing
    passes 0.4."""
    grid = torch.arange(vlen, device=sidx.device, dtype=torch.float32)
    length = (eidx - sidx + 1).float()

    def curve(center):
        p = torch.exp(-0.5 * torch.square((grid - center.float()[:, None])
                                          / (0.1 * length)[:, None]))
        q = torch.where(p >= 0.8, torch.ones_like(p), p)
        q = torch.where(p < 0.1353, torch.zeros_like(q), q)
        fallback = q.scatter(1, p.argmax(1, keepdim=True), 1.0)
        return torch.where(((q > 0.4).sum(1) == 0)[:, None], fallback, q)

    return torch.stack([curve(sidx), curve(eidx)], dim=1)


def _ner_label(sidx, eidx, cur_len, vlen: int, ext_len: int = 1) -> torch.Tensor:
    """(B, vlen) int32: 1 around the start, 2 inside, 3 around the end."""
    zero = torch.zeros_like(sidx)
    st_l = torch.maximum(zero, sidx - ext_len)
    st_r = torch.minimum(sidx + ext_len, cur_len - 1)
    et_l = torch.maximum(zero, eidx - ext_len)
    et_r = torch.minimum(eidx + ext_len, cur_len - 1)
    st_r = torch.where(st_r >= et_l, torch.maximum(sidx, et_l - 1), st_r)
    t = torch.arange(vlen, device=sidx.device)
    col = lambda x: x[:, None]  # noqa: E731
    lab = torch.zeros(sidx.shape[0], vlen, dtype=torch.int32, device=sidx.device)
    lab = torch.where((t >= col(st_l)) & (t <= col(st_r)), 1, lab)
    lab = torch.where((t > col(st_r)) & (t < col(et_l)), 2, lab)
    lab = torch.where((t >= col(et_l)) & (t <= col(et_r)), 3, lab)
    return lab.to(torch.int32)


def _dilate(g: torch.Generator, raw, T, sidx0, eidx0, p: float, max_raw: int):
    """Dilation as an index remapping: (features on a grid of ``max_raw +
    2 ceil(p max_raw)`` frames, new length, shifted sidx, eidx)."""
    B, dev = raw.shape[0], raw.device
    pad = int(-(-p * max_raw // 1))  # ceil(p * max_raw), static
    grid = max_raw + 2 * pad
    Tf = T.float()
    head_len = _round(torch.rand(B, generator=g, device=dev) * p * Tf)
    tail_len = _round(torch.rand(B, generator=g, device=dev) * p * Tf)

    r = torch.arange(max_raw, device=dev)
    neg = (r < T[:, None]) & ((r < sidx0[:, None]) | (r > eidx0[:, None]))
    n_neg = neg.sum(1)
    # negative frame indices, ascending, packed to the front
    neg_order = torch.sort((~neg).to(torch.int32), dim=1, stable=True).indices
    denom = n_neg.clamp(min=1)
    r_h = (torch.rand(B, generator=g, device=dev) * denom).long().clamp(max=denom - 1)
    r_t = (torch.rand(B, generator=g, device=dev) * denom).long().clamp(max=denom - 1)

    t = torch.arange(grid, device=dev)
    hl, body_end = head_len[:, None], (head_len + T)[:, None]
    in_head = t < hl
    in_body = (t >= hl) & (t < body_end)
    in_tail = (t >= body_end) & (t < body_end + tail_len[:, None])
    head_src = neg_order.gather(1, (r_h[:, None] + t) % denom[:, None])
    tail_src = neg_order.gather(1, (r_t[:, None] + (t - body_end)) % denom[:, None])
    src = torch.where(in_body, t - hl, torch.where(in_head, head_src, tail_src))
    rows = torch.arange(B, device=dev)[:, None]
    dfeat = raw[rows, src.clamp(0, max_raw - 1)]
    dfeat = dfeat * (in_head | in_body | in_tail)[..., None].to(raw.dtype)
    noise = torch.rand(dfeat.shape, generator=g, device=dev, dtype=dfeat.dtype)
    use_noise = (n_neg == 0)[:, None] & (in_head | in_tail)
    dfeat = torch.where(use_noise[..., None], noise, dfeat)
    return dfeat, head_len + T + tail_len, sidx0 + head_len, eidx0 + head_len


def device_augment_resample(raw_vfeats: torch.Tensor, raw_lens: torch.Tensor,
                            se_fracs: torch.Tensor, seed: int, *, vlen: int,
                            aug_mode: str = "unchanged", erosion_p: float = 0.05,
                            sample_type: str = "truncation",
                            label_threshold: float = 0.01) -> Dict[str, torch.Tensor]:
    """(B, max_raw, D) padded raw features -> the batch's ``vfeats``,
    ``vmasks``, ``label1ds`` and ``NER_labels``, on their device."""
    B, max_raw, _ = raw_vfeats.shape
    dev = raw_vfeats.device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    raw = raw_vfeats
    T = raw_lens.long()
    sidx0 = _round(se_fracs[:, 0] * (T - 1).float())
    eidx0 = _round(se_fracs[:, 1] * (T - 1).float())
    head = torch.zeros_like(T)
    if aug_mode == "erosion":
        head, tail = _sample_erosion_bounds(g, erosion_p, T, sidx0, eidx0)
        cur = tail - head + 1
    elif aug_mode == "dilation":
        raw, cur, sidx0, eidx0 = _dilate(g, raw, T, sidx0, eidx0, erosion_p, max_raw)
    elif aug_mode == "unchanged":
        cur = T
    else:
        raise ValueError(f"the device pipeline takes unchanged, erosion or dilation, "
                         f"not {aug_mode!r}")
    grid = raw.shape[1]

    if sample_type == "samelen":
        resample = torch.ones(B, dtype=torch.bool, device=dev)
    elif sample_type == "truncation":
        resample = cur > vlen
    else:  # original
        resample = torch.zeros(B, dtype=torch.bool, device=dev)

    W = _segment_weights(head, cur, vlen, grid, resample)  # (B, vlen, grid)
    vfeats = torch.bmm(W.to(raw.dtype), raw)
    t = torch.arange(grid, device=dev)
    raw_label = ((t >= sidx0[:, None]) & (t <= eidx0[:, None])).float()
    label = torch.bmm(W, raw_label[..., None])[..., 0]  # the gt span through the same weights

    out_len = torch.where(resample, torch.full_like(cur, vlen), cur.clamp(max=vlen))
    vmasks = (torch.arange(vlen, device=dev) < out_len[:, None]).float()
    hit = label >= label_threshold
    sidx = _first_true(hit).long()
    eidx = vlen - 1 - _first_true(hit.flip(1)).long()
    return {"vfeats": vfeats, "vmasks": vmasks, "label1ds": _dist_idx(sidx, eidx, vlen),
            "NER_labels": _ner_label(sidx, eidx, out_len, vlen)}


def apply_device_pipeline(batch: Dict, cfg, augment: bool) -> Dict:
    """A device batch whose batcher shipped raw features, with the
    pipeline's outputs in place of them; any other batch as it is.  A train
    step augments with the config's one augmentation; evaluation and
    serving (``augment`` False) apply none, as their host batches do."""
    if "raw_vfeats" not in batch:
        return batch
    dp = cfg.dataprocess
    aug = dp.video_augmentation
    aug_mode = next(iter(aug.to_dict() if hasattr(aug, "to_dict") else aug))
    strength = aug.get(aug_mode) or 0.05  # erosion/dilation p
    out = device_augment_resample(
        batch["raw_vfeats"], batch["raw_lens"], batch["se_fracs"], batch["pipeline_seed"],
        vlen=int(cfg.model.vlen), aug_mode=aug_mode if augment else "unchanged",
        erosion_p=float(strength), sample_type=dp.get("sample_type", "truncation"),
        label_threshold=float(dp.get("label_threshold", 0.01)))
    return {**{k: v for k, v in batch.items() if k not in RAW_KEYS}, **out}
