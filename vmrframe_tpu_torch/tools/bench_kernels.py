"""The table of the hand-written kernels (``PERF.md`` §6) from one command
(counterpart of ``vmrframe_tpu/tools/bench_kernels.py``).

For each of the seven kernels at the shapes the main paths give it (SeqPAN's
Charades forward for #1-#4, ActionFormer's long config for #5-#7, launch
weighted over a forward's shapes), and as extra rows at TACoS and ANet
widths, #4 at D 256-1024 (Charades lengths, 4 heads, beside the module
path; D 640-1024 the cluster body, its heads of 160-256 crossing slice
edges) and at every head count of D 128-512 whose head dim is past 128 or
not a multiple of 4 (``ODD_HEADS``: the wide and the narrow heads, the same
way) and at the cluster's wide and narrow heads (``CLUSTER_HEADS``: D 1024
at 1 head, D 640 at 128, D 896 at 64), at the sentence variants' shapes
and at the JAX tool's own shapes
(``--jax-shapes``: #2 at Charades and TACoS widths, #5 at T 512, 1024 and
2304 with window 19, #3 at L 64 and 256): the kernel's time, its plain
version's, one PyTorch call computing the same function where there is one
(SDPA for #1, #2 and #5-#7; none for #3 and #4), and the least time the
card could take (``bound_ms``: the larger of the bytes over 3.35 TB/s and
the matrix products over the dense peak of their type, f32 #1/#2 and
#5-#7 at the 3xTF32 rate their bodies run at: ``tools/h100.py``).  Device
times are CUDA events around calls queued behind a sleep kernel, median of
5; on the CPU (``--device cpu``, where a wrapper runs its plain version)
the host clock.  ``chip_smoke.py``'s time phase calls ``time_kernels``.

The per-kernel tools ``bench_banded``, ``bench_cq`` and ``bench_stack``
time a parent against a change; this one writes the whole table, or some
kernels' rows (#1/#2 of a parent against a change: run it from each
checkout's root with ``--kernels``).  ``--f32-modes`` narrows the staging
modes the f32 body of #1/#2 may take (``kernels/attention.py``'s
``F32_STAGED_MODES``; "chunked" stays the last resort), to compare them:

    python -m vmrframe_tpu_torch.tools.bench_kernels --out chiprun_out/bench_kernels.json
    python -m vmrframe_tpu_torch.tools.bench_kernels --no-jax-shapes \
        --kernels fused_masked_attention,fused_dual_attention --f32-modes both
    python -m vmrframe_tpu_torch.tools.bench_kernels --device cpu --batch 2 \
        --kernels fused_masked_attention --out /tmp/k.json

Writes ``--out`` (JSON) and one JSON line a kernel to stdout; never the JAX
package's ``docs/*.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time

import torch
import torch.nn.functional as F

from vmrframe_tpu_torch.kernels.dual_stack import CLUSTER_WIDTHS, KERNEL_WIDTHS
from vmrframe_tpu_torch.tools.h100 import HBM_BYTES_PER_S, peak_ops

B, H, HD, LV, LT, D = 128, 4, 32, 64, 30, 128
LV_LONG = 256  # SeqPAN's vlen at TACoS width (the reference's longest SeqPAN grid)
LV_ANET = 100  # SeqPAN's vlen at ANet width
D_ALIGN, HD_ALIGN = 768, 192  # BackBoneAlignFeature's width (the SBERT width), 4 heads
SLEEP_CYCLES = 100_000_000  # ~50 ms of GPU clock: the host queues a timed run meanwhile
B_AF, H_AF, HD_AF, WINDOW = 8, 4, 128, 19
AF_LAUNCHES = {2304: 2, 1152: 1, 576: 1}  # banded launches per forward at each length
B_TRAIN = 2  # the long config's training batch
BWD_KERNELS = ("banded_attention_dq", "banded_attention_dkv")
STACK = "dual_attention_stack"
# #4's wider instances and the cluster's widths: extra rows at Charades
# lengths, 4 heads
STACK_WIDTHS = KERNEL_WIDTHS[1:] + CLUSTER_WIDTHS
# #4's wide (192-512) and narrow (1, 2, 3, 6) head dims: extra rows, (D, heads)
ODD_HEADS = tuple((w, h) for w in KERNEL_WIDTHS for h in range(1, w + 1)
                  if w % h == 0 and ((w // h) % 4 or w // h > 128))
# the cluster's wide and narrow heads: head dims 1024, 5 and 14
CLUSTER_HEADS = ((1024, 1), (640, 128), (896, 64))
ATTENTION = ("fused_masked_attention", "fused_dual_attention", "fused_cq_attention")
BOTH_DTYPES = BWD_KERNELS + (STACK,) + ATTENTION  # timed in f32 and bf16
STACK_CAST = (0, 1, 4, 8)  # of a stack case, what the policy casts: v, t and the two W
# calls queued per timed repetition of the stack's plain version and module
# path: each is hundreds of small launches, and more than the host can queue
# during the sleep kernel would time the host, not the card
N_QUEUED_SMALL_OPS = 1
REPLACES = {
    "fused_masked_attention": "vmrframe_tpu/kernels/attention.py:65",
    "fused_dual_attention": "vmrframe_tpu/kernels/attention.py:116",
    "fused_cq_attention": "vmrframe_tpu/kernels/attention.py:188",
    "banded_attention": "vmrframe_tpu/kernels/window_attention.py:41",
    "banded_attention_dq": "vmrframe_tpu/kernels/window_attention.py:63",
    "banded_attention_dkv": "vmrframe_tpu/kernels/window_attention.py:89",
    STACK: "vmrframe_tpu/kernels/dual_stack.py:153",
}
SOURCES = {
    "attention": "vmrframe_tpu_torch/kernels/csrc/attention.cu",
    "window_attention": "vmrframe_tpu_torch/kernels/csrc/window_attention.cu",
    "dual_stack": "vmrframe_tpu_torch/kernels/csrc/dual_stack.cu",
}
SOURCE_OF = {"fused_masked_attention": "attention", "fused_dual_attention": "attention",
             "fused_cq_attention": "attention", "banded_attention": "window_attention",
             "banded_attention_dq": "window_attention", "banded_attention_dkv": "window_attention",
             STACK: "dual_stack"}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- inputs


def lengths_mask(g: torch.Generator, L: int, batch: int = B) -> torch.Tensor:
    """(batch, L) {0,1} mask of random valid lengths on ``g``'s device;
    sample 0 is wholly padded."""
    lens = torch.randint(1, L + 1, (batch,), generator=g, device=g.device)
    lens[0] = 0
    return (torch.arange(L, device=g.device)[None] < lens[:, None]).float()


def kernel_cases(g: torch.Generator, batch: int = B):
    """name -> list of argument tuples, one per shape the forward launches."""
    vm, tm = lengths_mask(g, LV, batch), lengths_mask(g, LT, batch)
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    heads = lambda L: torch.randn(batch, H, L, HD, generator=g, device=g.device)  # noqa: E731
    rows = lambda L: torch.randn(batch, L, D, generator=g, device=g.device)  # noqa: E731
    bound = math.sqrt(6.0 / (D + 1))
    vec = lambda *s: (torch.rand(*s, generator=g, device=g.device) * 2 - 1) * bound  # noqa: E731
    w4C, w4Q, w4mlu = vec(D, 1), vec(D, 1), vec(1, 1, D)
    return {
        "fused_masked_attention": [(heads(LV), heads(LV), heads(LV), outer(vm, vm))],
        "fused_dual_attention": [
            (heads(LV), heads(LV), heads(LV), heads(LT), heads(LT), outer(vm, vm), outer(vm, tm)),
            (heads(LT), heads(LT), heads(LT), heads(LV), heads(LV), outer(tm, tm), outer(tm, vm)),
        ],
        "fused_cq_attention": [(rows(LV), rows(LT), w4C, w4Q, w4mlu, vm, tm),
                               (rows(LT), rows(LV), w4C, w4Q, w4mlu, tm, vm)],
    }


def long_kernel_cases(g: torch.Generator, batch: int = B):
    """The shapes SeqPAN at TACoS width (vlen 256, tlen 30) gives #1-#3,
    then those at ANet width (vlen 100) gives #3."""
    vm, tm = lengths_mask(g, LV_LONG, batch), lengths_mask(g, LT, batch)
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    heads = lambda L: torch.randn(batch, H, L, HD, generator=g, device=g.device)  # noqa: E731
    rows = lambda L: torch.randn(batch, L, D, generator=g, device=g.device)  # noqa: E731
    bound = math.sqrt(6.0 / (D + 1))
    vec = lambda *s: (torch.rand(*s, generator=g, device=g.device) * 2 - 1) * bound  # noqa: E731
    w4C, w4Q, w4mlu = vec(D, 1), vec(D, 1), vec(1, 1, D)
    L, A = LV_LONG, LV_ANET
    va = lengths_mask(g, A, batch)
    return {
        "fused_masked_attention": [(heads(L), heads(L), heads(L), outer(vm, vm))],
        "fused_dual_attention": [
            (heads(L), heads(L), heads(L), heads(LT), heads(LT), outer(vm, vm), outer(vm, tm)),
            (heads(LT), heads(LT), heads(LT), heads(L), heads(L), outer(tm, tm), outer(tm, vm)),
        ],
        "fused_cq_attention": [(rows(L), rows(LT), w4C, w4Q, w4mlu, vm, tm),
                               (rows(LT), rows(L), w4C, w4Q, w4mlu, tm, vm),
                               (rows(A), rows(LT), w4C, w4Q, w4mlu, va, tm),
                               (rows(LT), rows(A), w4C, w4Q, w4mlu, tm, va)],
    }


def sentence_kernel_cases(g: torch.Generator, batch: int = B):
    """The shapes the sentence variants give #1-#3 at full width:
    BackBoneAlignFeature (D 768, 4 heads of 192; 64 video and 30 text
    positions: #1 in the predictor, #2 both ways, #3 both ways) and
    BackBoneBertSentence (D 128, 4 heads of 32; one text position: #1 over
    one key, #2 with one cross key and with one query over one self key, #3
    with one query and with one context row), and #3 at D 768 with one
    query and with one context row.  Sample 0 is wholly masked, the
    one-position side too."""
    vm, tm, one = lengths_mask(g, LV, batch), lengths_mask(g, LT, batch), lengths_mask(g, 1, batch)
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    heads = lambda L, hd: torch.randn(batch, H, L, hd, generator=g, device=g.device)  # noqa: E731
    rows = lambda L, d: torch.randn(batch, L, d, generator=g, device=g.device)  # noqa: E731

    def vecs(d):
        bound = math.sqrt(6.0 / (d + 1))
        return [(torch.rand(*s, generator=g, device=g.device) * 2 - 1) * bound
                for s in ((d, 1), (d, 1), (1, 1, d))]

    wa, wb = vecs(D_ALIGN), vecs(D)
    hd = HD_ALIGN
    return {
        "fused_masked_attention": [
            (heads(LV, hd), heads(LV, hd), heads(LV, hd), outer(vm, vm)),
            (heads(LV, HD), heads(1, HD), heads(1, HD), outer(vm, one))],
        "fused_dual_attention": [
            (heads(LV, hd), heads(LV, hd), heads(LV, hd), heads(LT, hd), heads(LT, hd),
             outer(vm, vm), outer(vm, tm)),
            (heads(LT, hd), heads(LT, hd), heads(LT, hd), heads(LV, hd), heads(LV, hd),
             outer(tm, tm), outer(tm, vm)),
            (heads(LV, HD), heads(LV, HD), heads(LV, HD), heads(1, HD), heads(1, HD),
             outer(vm, vm), outer(vm, one)),
            (heads(1, HD), heads(1, HD), heads(1, HD), heads(LV, HD), heads(LV, HD),
             outer(one, one), outer(one, vm))],
        "fused_cq_attention": [
            (rows(LV, D_ALIGN), rows(LT, D_ALIGN), *wa, vm, tm),
            (rows(LT, D_ALIGN), rows(LV, D_ALIGN), *wa, tm, vm),
            (rows(LV, D), rows(1, D), *wb, vm, one),
            (rows(1, D), rows(LV, D), *wb, one, vm),
            (rows(LV, D_ALIGN), rows(1, D_ALIGN), *wa, vm, one),
            (rows(1, D_ALIGN), rows(LV, D_ALIGN), *wa, one, vm)],
    }


def stack_blocks(seed: int, device="cuda", dim: int = D, heads: int = H):
    """Two ``DualAttentionBlock``s of width ``dim`` with ``heads`` heads on
    the card in f32, seeded, with every leaf random (the initialisers leave
    LN at 1/0 and the BiLinear extra bias at 0, which would hide them)."""
    from vmrframe_tpu_torch.layers.attention import DualAttentionBlock
    from vmrframe_tpu_torch.weights import init_weights

    g = torch.Generator().manual_seed(seed)
    blocks = []
    for i in range(2):
        block = init_weights(DualAttentionBlock(dim, heads), seed + i).eval()
        with torch.no_grad():
            for name, p in block.named_parameters():
                if "layer_norm" in name or name.endswith("bias_value"):
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
        blocks.append(block.to(device))
    return blocks


def stack_cases(g: torch.Generator, blocks, shapes):
    """(v, t, vmask, tmask, W1, b1, ln1, xb1, W2, b2, ln2, xb2) per shape, at
    the blocks' width; random lengths, sample 0 wholly masked."""
    with torch.no_grad():
        stacks = [p[key] for block in blocks for p in (block.stacks(),)
                  for key in ("W", "b", "ln", "xb")]
    Dc = stacks[0].shape[-1]
    cases = []
    for Bc, Lv, Lt in shapes:
        masks = []
        for L in (Lv, Lt):
            lens = torch.randint(1, L + 1, (Bc,), generator=g, device=g.device)
            lens[0] = 0
            masks.append((torch.arange(L, device=g.device)[None] < lens[:, None]).float())
        cases.append((torch.randn(Bc, Lv, Dc, generator=g, device=g.device),
                      torch.randn(Bc, Lt, Dc, generator=g, device=g.device), *masks, *stacks))
    return cases


def wide_stack_cases(g: torch.Generator, batch: int = B, pairs=None) -> list:
    """[(D, heads, seeded blocks, one case at Charades lengths)] for each
    (D, heads) of ``pairs``: by default each of ``STACK_WIDTHS`` at 4 heads,
    #4's wider instances and the cluster's widths.  A case at other than ``H`` heads ends with its
    head count (``stack_call``)."""
    out = []
    for dim, heads in pairs or [(w, H) for w in STACK_WIDTHS]:
        blocks = stack_blocks(seed=0, device=g.device, dim=dim, heads=heads)
        case = stack_cases(g, blocks, ((batch, LV, LT),))[0]
        out.append((dim, heads, blocks, case if heads == H else case + (heads,)))
    return out


def stack_call(fn):
    """``fn`` of the stack module on one case's flat arguments: the two
    layers' stacks, then the number of heads where the case gives one (else
    ``H``)."""
    def call(v, t, vm, tm, *stacks):
        p1, p2 = (dict(zip(("W", "b", "ln", "xb"), stacks[i:i + 4])) for i in (0, 4))
        return fn(v, t, vm, tm, p1, p2, stacks[8] if len(stacks) > 8 else H)
    return call


def cast_args(name: str, args, dtype: torch.dtype):
    """One case's arguments in ``dtype``; of a stack case only what the bf16
    policy casts (activations and rank >= 2 weights; masks cast too, as the
    batch's are, would change nothing: the wrapper reads them as f32)."""
    if name == STACK:
        return tuple(a.to(dtype) if i in STACK_CAST else a for i, a in enumerate(args))
    return tuple(a.to(dtype) for a in args)


def heads_of(qkv: torch.Tensor) -> int:
    return qkv.shape[3] if qkv.dim() == 5 else H_AF


def head_dim(qkv: torch.Tensor) -> int:
    return qkv.shape[-1] if qkv.dim() == 5 else qkv.shape[-1] // (3 * H_AF)


def split_heads(qkv: torch.Tensor):
    """q, k, v as the model passes them: head-split views of one (B, T, 3C)
    projection (``H_AF`` heads), or of a (B, T, 3, H, hd) one; (B, H, T, hd)
    each."""
    if qkv.dim() == 5:
        return [t.transpose(1, 2) for t in qkv.unbind(2)]
    hd = head_dim(qkv)
    return [t.unflatten(-1, (H_AF, hd)).transpose(1, 2) for t in qkv.split(H_AF * hd, dim=-1)]


def banded_cases(g: torch.Generator, lengths, batch: int = B_AF, hd: int = HD_AF):
    """(qkv, kv_mask) per length; sample 0 is wholly masked."""
    cases = []
    for T in lengths:
        lens = torch.randint(T // 2, T + 1, (batch,), generator=g, device=g.device)
        lens[0] = 0
        mask = (torch.arange(T, device=g.device)[None] < lens[:, None]).float()
        cases.append((torch.randn(batch, T, 3 * H_AF * hd, generator=g, device=g.device), mask))
    return cases


def banded_bwd_cases(g: torch.Generator, lengths, hd: int = HD_AF):
    """(qkv, kv_mask, cotangent) per length at the training batch: sample 0
    wholly masked, sample 1 of a random length with a hole wider than the
    band; the cotangent random on every row, in (B, T, H, hd) memory as
    autograd hands it back for the forward's output."""
    cases = []
    for T in lengths:
        mask = torch.zeros(B_TRAIN, T, device=g.device)
        mask[1, :int(torch.randint(T // 2, T + 1, (1,), generator=g, device=g.device))] = 1.0
        mask[1, T // 4:T // 4 + 3 * WINDOW] = 0.0
        qkv = torch.randn(B_TRAIN, T, 3 * H_AF * hd, generator=g, device=g.device)
        cases.append((qkv, mask, torch.randn(B_TRAIN, T, H_AF, hd, generator=g, device=g.device)))
    return cases


def functions(K, W, S) -> dict:
    """name -> (kernel wrapper, plain version), each taking one case's args."""
    return {
        STACK: (stack_call(S.dual_attention_stack), stack_call(S.dual_attention_stack_plain)),
        "fused_masked_attention": (K.fused_masked_attention, K.masked_attention_plain),
        "fused_dual_attention": (K.fused_dual_attention, K.dual_attention_plain),
        "fused_cq_attention": (K.fused_cq_attention, K.cq_attention_plain),
        "banded_attention": (
            lambda qkv, m: W.banded_attention(*split_heads(qkv), m, WINDOW),
            lambda qkv, m: W.banded_attention_plain(*split_heads(qkv), m, WINDOW)),
        "banded_attention_dq": (
            lambda qkv, m, c: W.banded_attention_dq(*split_heads(qkv), m, c.transpose(1, 2),
                                                    WINDOW),
            lambda qkv, m, c: W.banded_attention_dq_plain(*split_heads(qkv), m,
                                                          c.transpose(1, 2), WINDOW)),
        "banded_attention_dkv": (
            lambda qkv, m, c: W.banded_attention_dkv(*split_heads(qkv), m, c.transpose(1, 2),
                                                     WINDOW),
            lambda qkv, m, c: W.banded_attention_dkv_plain(*split_heads(qkv), m,
                                                           c.transpose(1, 2), WINDOW)),
    }


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# ------------------------------------------------------------ bounds


def work(name: str, args) -> tuple:
    """(bytes, operations) the function needs: each input read once, each
    output written once; the operations are its matrix products."""
    size = args[0].element_size()
    if name == STACK:
        from vmrframe_tpu_torch.tools.bench_stack import stack_work

        Bs, Lv, Ds = args[0].shape
        return stack_work(Bs, Lv, args[1].shape[1], size, Ds)
    if name.startswith("banded_attention"):
        # tensors read and written besides the mask (forward: q, k, v, out;
        # dq: q, k, v, g, dq; dk/dv: q, k, v, g, dk, dv); the band's products
        # (forward: scores, p v; dq: scores, dp, ds k; dk/dv: scores, dp,
        # p^T g, ds^T q), each 2 * T * (2 half + 1) * hd per (batch, head)
        tensors, products = {"banded_attention": (4, 2), "banded_attention_dq": (5, 3),
                             "banded_attention_dkv": (6, 4)}[name]
        Bm, T = args[1].shape
        band, hd = 2 * (WINDOW // 2) + 1, head_dim(args[0])
        Hb = heads_of(args[0])
        return (tensors * Bm * Hb * T * hd + Bm * T) * size, \
            products * 2 * Bm * Hb * T * band * hd
    if name == "fused_cq_attention":
        from vmrframe_tpu_torch.tools.bench_cq import cq_work

        (Bc, Lc, Dc), Lq = args[0].shape, args[1].shape[1]
        return cq_work(Bc, Lc, Lq, Dc, size)
    Bq, Hq, L, hd = args[0].shape
    # Lk of each branch: (q, k, v, mask) or (q, f_k, f_v, t_k, t_v, s_mask, x_mask)
    keys = [args[1].shape[2]] if name == "fused_masked_attention" else \
        [args[1].shape[2], args[3].shape[2]]
    elems = Bq * Hq * L * hd * (1 + len(keys))  # q, and one output per branch
    elems += sum(2 * Bq * Hq * Lk * hd + Bq * L * Lk for Lk in keys)  # k, v, mask
    ops = sum(4 * Bq * Hq * L * Lk * hd for Lk in keys)
    return elems * size, ops


def bound_ms(name: str, args) -> tuple:
    nbytes, ops = work(name, args)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops(args[0].dtype, name) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ timing


def device_ms(fn, n: int = 20, reps: int = 5, device: str = "cuda") -> dict:
    """Per-call device time of ``fn``: CUDA events around ``n`` calls queued
    behind a sleep kernel, so host overhead does not show; median of reps.
    On the CPU (``device``), the host clock around ``n`` calls."""
    if torch.device(device).type != "cuda":
        return _host_ms(fn, n, reps)
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def sdpa_masked(q, k, v, mask):
    add = ((1.0 - mask) * -1e30).to(q.dtype)[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add)


def band_mask(mask: torch.Tensor) -> torch.Tensor:
    """The band-and-key boolean mask, (B, 1, T, T)."""
    i = torch.arange(mask.shape[1], device=mask.device)
    band = (i[:, None] - i[None, :]).abs() <= WINDOW // 2
    return (band[None] & (mask[:, None, :] > 0))[:, None]


def library_ms(name: str, args):
    """Device time of one PyTorch call computing the same function, or None;
    timed only.  For the backward kernels: SDPA's backward with the same
    boolean band mask (it computes dq, dk and dv together), timed as forward
    plus backward less forward."""
    if name in BWD_KERNELS:
        qkv, mask, cot = args
        q, k, v = (t.detach().requires_grad_() for t in split_heads(qkv))
        allowed, g = band_mask(mask), cot.transpose(1, 2)
        fwd = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)  # noqa: E731
        both = device_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), g), device=q.device.type)
        alone = device_ms(fwd, device=q.device.type)
        return {key: both[key] - alone[key] for key in both}
    lib = library_call(name, args)
    return device_ms(lib, device=args[0].device.type) if lib else None


def library_call(name: str, args):
    """One PyTorch call computing the same function, or None; timed only."""
    if name == "banded_attention":  # SDPA with the band-and-key boolean mask
        qkv, mask = args
        q, k, v = split_heads(qkv)
        allowed = band_mask(mask)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
    if name == "fused_masked_attention":
        return sdpa_masked(*args)
    if name == "fused_dual_attention":
        q, fk, fv, tk, tv, s_mask, x_mask = args
        s, x = sdpa_masked(q, fk, fv, s_mask), sdpa_masked(q, tk, tv, x_mask)
        return lambda: (s(), x())
    return None  # CQ attention: no single PyTorch call computes it


# ------------------------------------------------------------ the table


DTYPE_KEYS = {"f32": torch.float32, "bf16": torch.bfloat16}


def time_row(name: str, wrapper, plain, args, key: str, weight: int) -> dict:
    """One shape's kernel, plain and library times, and its bound."""
    args = cast_args(name, args, DTYPE_KEYS[key])
    dev = args[0].device.type
    shaped = (args[0], args[3]) if name == "fused_dual_attention" else args[:2]  # q, cross k
    row = {
        "shape": [list(a.shape) for a in shaped], "launches_per_forward": weight,
        "ms": device_ms(lambda: wrapper(*args), device=dev),
        "plain_ms": device_ms(lambda: plain(*args),
                              n=N_QUEUED_SMALL_OPS if name == STACK else 20, device=dev),
        "library_ms": library_ms(name, args),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(name, args)
    lib_txt = f"{row['library_ms']['median']:.4f}" if row["library_ms"] else \
        "none (no single PyTorch call computes it)"
    log(f"[time] {name:24s} {key:4s} {row['shape']}  kernel "
        f"{row['ms']['median']:.4f} ms  plain {row['plain_ms']['median']:.4f}  "
        f"library {lib_txt}  bound {row['bound_ms']:.4f} ({row['bound_by']})")
    return row


def weighted(rows) -> dict:
    """The launch-weighted means of a kernel's per-shape rows."""
    total = sum(r["launches_per_forward"] for r in rows)
    mean = lambda f: sum(r["launches_per_forward"] * f(r) for r in rows) / total  # noqa: E731
    return {"ms": mean(lambda r: r["ms"]["median"]),
            "plain_ms": mean(lambda r: r["plain_ms"]["median"]),
            "library_ms": mean(lambda r: r["library_ms"]["median"]) if rows[0]["library_ms"]
            else None,
            "bound_ms": mean(lambda r: r["bound_ms"]),
            "bound_by": rows[0]["bound_by"], "shapes": rows}


def time_kernels(fns, cases, weights, card: str, long_cases: dict, f32_cases: dict,
                 sentence_cases: dict, jax_cases: dict = None) -> dict:
    """Per call; a kernel's ms are its launch-weighted mean over the shapes
    one forward (or train step) gives it (``weights``: launches per forward).
    The forward kernels in bf16 (#1-#3 in f32 too); the backward kernels in
    f32 (the long config's type) and bf16; the whole-stack kernel in both.
    ``long_cases`` (#1-#4 at TACoS width, #3 at ANet width) and
    ``sentence_cases`` (#1-#3 at the sentence variants' shapes: head dim 192,
    D 768, one text position) are extra rows, outside the means, so that the
    means stay comparable with earlier runs.
    ``f32_cases`` give a kernel timed in bf16 its f32 time at other shapes
    (the banded forward at the training batch).  ``jax_cases`` (the JAX
    package's ``tools/bench_kernels.py`` shapes) are extra rows too."""
    results = {}
    for name, shapes in cases.items():
        wrapper, plain = fns[name]
        for key in (("f32", "bf16") if name in BOTH_DTYPES else ("bf16",)):
            log(f"[time] {name} {key}, per call, on {card}")
            rows = [time_row(name, wrapper, plain, args, key, weight)
                    for args, weight in zip(shapes, weights[name])]
            long_rows = [time_row(name, wrapper, plain, args, key, 0)
                         for args in long_cases.get(name, ())]
            sentence_rows = [time_row(name, wrapper, plain, args, key, 0)
                             for args in sentence_cases.get(name, ())]
            results.setdefault(name, {})[key] = {**weighted(rows), "long_shapes": long_rows,
                                                 "sentence_shapes": sentence_rows}
            if (jax_cases or {}).get(name):
                results[name][key]["jax_tool_shapes"] = [
                    time_row(name, wrapper, plain, args, key, 0) for args in jax_cases[name]]
    for name, shapes in f32_cases.items():
        wrapper, plain = fns[name]
        log(f"[time] {name} f32 at the training batch, per call, on {card}")
        results[name]["f32"] = weighted([time_row(name, wrapper, plain, args, "f32", weight)
                                         for args, weight in zip(shapes, weights[name])])
    return results


def module_path_ms(blocks, case, dtype: torch.dtype) -> dict:
    """The module path's time for the same stack on the same inputs: 4
    ``DualAttentionBlock`` calls, each through kernel #2
    (``fused_dual_attention``; past its head dim 256 the plain attention),
    the projections in cuBLAS.  The other route to the same result, not a
    library call."""
    import copy

    from vmrframe_tpu_torch.ops.precision import cast_module_

    x, y, vm, tm = (a.to(dtype) for a in case[:4])  # the masks too, as the policy casts a batch
    mods = [cast_module_(copy.deepcopy(b), dtype) for b in blocks]

    @torch.no_grad()
    def run():
        a, b = x, y
        for m in mods:
            a, b = m(a, b, vm, tm), m(b, a, tm, vm)
        return a, b

    return device_ms(run, n=N_QUEUED_SMALL_OPS, device=x.device.type)


def time_module_path(blocks, case, results, card: str) -> None:
    """``module_path_ms`` in both types, written beside the stack kernel's
    numbers."""
    for key, dtype in DTYPE_KEYS.items():
        ms = module_path_ms(blocks, case, dtype)
        results[STACK][key]["module_path_ms"] = ms["median"]
        results[STACK][key]["module_path_ms_spread"] = ms
        log(f"[time] {STACK} {key}: the module path for the same stack (4 DualAttentionBlock "
            f"calls through fused_dual_attention) {ms['median']:.4f} ms, against the one-launch "
            f"kernel's {results[STACK][key]['ms']:.4f} ms, on {card}")


def time_wide_stack(fns, wide: list, results, card: str) -> None:
    """#4 at each (D, heads) of ``wide`` (``wide_stack_cases``), in both
    types: the kernel, its plain version and its bound (``time_row``) beside
    the module path, as extra rows (``wide_shapes``) outside the means."""
    wrapper, plain = fns[STACK]
    for dim, heads, blocks, case in wide:
        for key, dtype in DTYPE_KEYS.items():
            row = time_row(STACK, wrapper, plain, case, key, 0)
            ms = module_path_ms(blocks, case, dtype)
            row["heads"], row["module_path_ms"] = heads, ms["median"]
            results[STACK][key].setdefault("wide_shapes", []).append(row)
            log(f"[time] {STACK} {key} D {dim}, {heads} heads: kernel {row['ms']['median']:.4f} "
                f"ms, module path {ms['median']:.4f}, bound {row['bound_ms']:.4f}, on {card}")


def _host_ms(fn, n: int, reps: int) -> dict:
    """Per-call host time of ``fn`` (the CPU's route), median of reps."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / n)
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card_name(device) -> str:
    """``card_line()`` on the card; what the CPU's numbers are, off it."""
    if torch.device(device).type != "cuda":
        return "cpu (host clock; each wrapper runs its plain version)"
    return card_line()


KERNEL_NAMES = ATTENTION + (STACK, "banded_attention") + BWD_KERNELS


def table_cases(g: torch.Generator, names=KERNEL_NAMES, batch: int = B):
    """(cases, weights, long_cases, f32_cases, sentence_cases, blocks) of the
    kernels in ``names`` on ``g``'s device: the main paths' shapes (SeqPAN's
    Charades forward at ``batch``; ActionFormer's long config), the launches
    a forward (or train step) gives each, the TACoS/ANet and sentence rows,
    the banded forward at the training batch, and the stack's seeded blocks
    (None without #4)."""
    want = set(names)
    cases, long_cases, f32_cases, sentence_cases, blocks = {}, {}, {}, {}, None
    if want & set(ATTENTION):
        main, long_, sentence = (kernel_cases(g, batch), long_kernel_cases(g, batch),
                                 sentence_kernel_cases(g, batch))
        for name in want & set(ATTENTION):
            cases[name], long_cases[name] = main[name], long_[name]
            sentence_cases[name] = sentence[name]
    if STACK in want:
        blocks = stack_blocks(seed=0, device=g.device)
        cases[STACK] = stack_cases(g, blocks, ((batch, LV, LT),))
        long_cases[STACK] = stack_cases(g, blocks, ((batch, LV_LONG, LT),))
    if "banded_attention" in want:
        cases["banded_attention"] = banded_cases(g, tuple(AF_LAUNCHES), batch=min(batch, B_AF))
        f32_cases["banded_attention"] = banded_cases(g, tuple(AF_LAUNCHES),
                                                     batch=min(batch, B_TRAIN))
    if want & set(BWD_KERNELS):
        bwd = banded_bwd_cases(g, tuple(AF_LAUNCHES))  # the two share their cases
        for name in want & set(BWD_KERNELS):
            cases[name] = bwd
    weights = {name: ([1] * len(shapes) if name in ATTENTION + (STACK,)
                      else list(AF_LAUNCHES.values())) for name, shapes in cases.items()}
    return cases, weights, long_cases, f32_cases, sentence_cases, blocks


def jax_tool_cases(g: torch.Generator, names=KERNEL_NAMES) -> dict:
    """The JAX package's ``tools/bench_kernels.py`` shapes (its ``main``):
    #2 at (B, H, L, M, hd) = (128, 4, 64, 20, 32) and (64, 8, 256, 30, 16);
    #5 at (B, H, T, hd) = (8, 16, 512, 32), (8, 16, 1024, 32), (2, 16, 2304,
    32), window 19; #3 at (B, Lc, Lq, D) = (128, 64, 20, 128), (64, 256, 30,
    128).  Random lengths, sample 0 wholly masked."""
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    dev = g.device

    def dual(Bq, Hq, L, M, hd):
        heads = lambda n: torch.randn(Bq, Hq, n, hd, generator=g, device=dev)  # noqa: E731
        vm, tm = lengths_mask(g, L, Bq), lengths_mask(g, M, Bq)
        return (heads(L), heads(L), heads(L), heads(M), heads(M), outer(vm, vm), outer(vm, tm))

    def banded(Bb, Hb, T, hd):
        lens = torch.randint(T // 2, T + 1, (Bb,), generator=g, device=dev)
        lens[0] = 0
        mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
        return torch.randn(Bb, T, 3, Hb, hd, generator=g, device=dev), mask

    def cq(Bc, Lc, Lq, Dc):
        bound = math.sqrt(6.0 / (Dc + 1))
        vec = lambda *s: (torch.rand(*s, generator=g, device=dev) * 2 - 1) * bound  # noqa: E731
        rows = lambda n: torch.randn(Bc, n, Dc, generator=g, device=dev)  # noqa: E731
        return (rows(Lc), rows(Lq), vec(Dc, 1), vec(Dc, 1), vec(1, 1, Dc),
                lengths_mask(g, Lc, Bc), lengths_mask(g, Lq, Bc))

    out = {"fused_dual_attention": lambda: [dual(128, 4, 64, 20, 32), dual(64, 8, 256, 30, 16)],
           "banded_attention": lambda: [banded(8, 16, 512, 32), banded(8, 16, 1024, 32),
                                        banded(2, 16, 2304, 32)],
           "fused_cq_attention": lambda: [cq(128, 64, 20, 128), cq(64, 256, 30, 128)]}
    return {name: make() for name, make in out.items() if name in names}


def extra_row(r: dict) -> dict:
    """An extra row's medians (and the module path's, where it was timed)."""
    out = {"shape": r["shape"], "ms": r["ms"]["median"], "plain_ms": r["plain_ms"]["median"],
           "bound_ms": r["bound_ms"],
           "library_ms": r["library_ms"]["median"] if r["library_ms"] else None}
    for key in ("heads", "module_path_ms"):
        if key in r:
            out[key] = r[key]
    return out


def kernel_rows(results: dict, card: str) -> list:
    """One row a kernel: its line type's numbers (bf16 for the forward
    kernels, f32 for the backward ones, as the long config trains), and the
    other type's beside them."""
    rows = []
    for name, by_type in results.items():
        key = "f32" if name in BWD_KERNELS else "bf16"
        t = by_type[key]
        row = {"name": name, "route": "cuda", "source": SOURCES[SOURCE_OF[name]],
               "replaces": REPLACES[name], "dtype": {"bf16": "bfloat16", "f32": "float32"}[key],
               "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"], "card": card}
        other = "bf16" if key == "f32" else "f32"
        if other in by_type:
            row.update({f"ms_{other}": by_type[other]["ms"],
                        f"bound_ms_{other}": by_type[other]["bound_ms"],
                        f"library_ms_{other}": by_type[other]["library_ms"]})
        if "module_path_ms" in t:
            row["module_path_ms"] = t["module_path_ms"]
        for extra in ("long_shapes", "sentence_shapes", "jax_tool_shapes", "wide_shapes"):
            if t.get(extra):
                row[extra] = [extra_row(r) for r in t[extra]]
        rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default=",".join(KERNEL_NAMES))
    ap.add_argument("--batch", type=int, default=B, help="SeqPAN's batch for #1-#4")
    ap.add_argument("--no-jax-shapes", action="store_true", help="skip the JAX tool's shapes")
    ap.add_argument("--f32-modes", default=None,
                    help="the staging modes #1/#2's f32 body may take, in order (both, alt)")
    ap.add_argument("--out", default="chiprun_out/bench_kernels.json")
    args = ap.parse_args(argv)

    from vmrframe_tpu_torch.device import resolve_device, strict_f32
    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import build
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.kernels import window_attention as W

    device = resolve_device(args.device)
    strict_f32()
    names = tuple(n.strip() for n in args.kernels.split(",") if n.strip())
    unknown = set(names) - set(KERNEL_NAMES)
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}; known: {KERNEL_NAMES}")
    if args.f32_modes is not None:
        modes = tuple(m.strip() for m in args.f32_modes.split(",") if m.strip())
        if not modes or set(modes) - set(K.F32_STAGED_MODES):
            raise SystemExit(f"--f32-modes: some of {K.F32_STAGED_MODES}, got {modes}")
        K.F32_STAGED_MODES = modes
    card = card_name(device)
    if device.type == "cuda":
        build.build_all(sorted({SOURCE_OF[n] for n in names}))
    log(card)
    g = torch.Generator(device=device).manual_seed(0)
    cases, weights, long_cases, f32_cases, sentence_cases, blocks = table_cases(g, names,
                                                                               args.batch)
    jax_cases = {} if args.no_jax_shapes else jax_tool_cases(g, names)
    results = time_kernels(functions(K, W, S), cases, weights, card, long_cases, f32_cases,
                           sentence_cases, jax_cases)
    if blocks is not None:
        time_module_path(blocks, cases[STACK][0], results, card)
        time_wide_stack(functions(K, W, S), wide_stack_cases(g, args.batch)
                        + wide_stack_cases(g, args.batch, ODD_HEADS + CLUSTER_HEADS), results,
                        card)
    rows = kernel_rows({n: results[n] for n in names}, card)
    for row in rows:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "device": str(device), "f32_modes": list(K.F32_STAGED_MODES),
                   "kernels": rows, "detail": results}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
