"""The whole 2-layer dual-attention stack of the SeqPAN family as one
hand-written CUDA kernel for Hopper, beside its plain PyTorch version.

``dual_attention_stack`` -> CUDA ``vmr_dual_stack`` (``csrc/dual_stack.cu``,
its body ``dual_stack.cuh``, with a part of its own for each wider width,
and ``dual_stack_cluster.cu`` for D 640-1024);
replaces ``vmrframe_tpu/kernels/dual_stack.py::dual_attention_stack``
(``_stack_kernel``).  It computes

    v1 = dab1(v, t);  t1 = dab1(t, v);  v2 = dab2(v1, t1);  t2 = dab2(t1, v1)

where one ``dab`` call is LN of both sides, the shared query and the two
key/value pairs, H-head self and cross attention, the cross gates, the
BiLinear sigmoid gate, dense + residual, LN, dense + residual: 14 D x D
projections per call, every product inside the kernel's own source.

The weights come as the stacks of ``layers/attention.py::
DualAttentionBlock.stacks``: ``W (14, D, D)`` in the compute type with each
matrix laid out (in, out) as flax keeps it, ``b (14, D)``, ``ln (6, D)``,
``xb (2, D)`` in f32, in the order of ``W_*`` and ``LN*`` below.

Rounding follows the TPU kernel body: fn, tn, k, v, the probabilities and
every matmul operand are rounded to the weights' type; LN, softmax, the
sigmoid and all accumulation are f32; nothing is rounded between the two
layers; the BiLinear is two products, ``fn W + gc W + 2 b + xb``.

Masks: additive -1e30 on keys, per sample.  A from-row without validity has
its gate at exactly 0 and comes out as ``dense_2(LN2(b_d1 + x)) + b_d1 + x``
on every route.  A valid from-row facing a to-side with no valid key gets the
uniform average over that sample's own ``Lt`` to-rows, as the module path
(``DualAttentionBlock``) gives it; the TPU kernel, which stacks two samples
per program, spreads it over the pair's ``2 Lt`` columns instead.  The
service's padding samples have no valid from-row either, so they are the
same on every route.

On the card every product runs on the tensor cores but the f32
projections: the bf16 projections and both types' attention on
``mma.sync`` (f32 attention in 3xTF32).  Attention is a warp task of 16
query rows and one head (head dims padded to the instruction's k and n with
zeros in registers; head dims 192-512 looped over at run time; head dims 1,
2, 3 and 6 read one element at a time, their max and sum a (row, head) in
device memory, ``NARROW_STAT_FLOATS`` a sample), a side of up to ``kStage``
keys in one stage and one walk, a longer one in chunks: bf16 twice (the max
and sum, then p rounded to bf16 and P.V), f32 once with the max and sum
rescaled.  The kernel takes D = 128, 256, 384 and 512 (``KERNEL_WIDTHS``)
at every head count dividing D, each width with a layout of its own
(``Lay<D>`` in the source: row tiles of 64, 32, 16 and 16 so that five f32
buffers fit a block's shared memory), and 4 heads (every config that sets
``model.fused_dual_stack``) have a kernel of their own at each width.  At D
640, 768, 896 and 1024 (``CLUSTER_WIDTHS``) one block no longer holds a row
tile: a thread-block cluster of D / 128 CTAs takes each sample, each CTA
128 columns of every activation (LN partials, the products' operand chunks
and the partial scores of heads that cross 128-column edges exchanged
through distributed shared memory), at every head count dividing D.
``tests/test_torch_stack_tiles.py`` emulates both schedules on the CPU.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises (``takes``: D in ``KERNEL_WIDTHS`` or
``CLUSTER_WIDTHS``, heads dividing D, any lengths Lv, Lt >= 1; past D 1024
it raises), and counts the launch in ``dual_attention_stack.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from vmrframe_tpu_torch.kernels import count_plain, launch_range, plain_route

from vmrframe_tpu_torch.kernels.attention import _DTYPE_CODE, _raise_on, _stream
from vmrframe_tpu_torch.ops.masking import MASK_VALUE

# weight-stack indices, the JAX package's order
W_Q, W_FK, W_FV, W_TK, W_TV = 0, 1, 2, 3, 4
W_SD, W_XD, W_SG, W_XG, W_GD = 5, 6, 7, 8, 9
W_BL1, W_BL2, W_D1, W_D2 = 10, 11, 12, 13
LN1_S, LN1_B, LNT_S, LNT_B, LN2_S, LN2_B = 0, 1, 2, 3, 4, 5
KERNEL_WIDTHS = (128, 256, 384, 512)  # the D csrc/dual_stack.cuh takes, a CTA a sample (kWidths)
# the D csrc/dual_stack_cluster.cu takes, a cluster of D / 128 CTAs a sample
# (kMinCluster-kMaxCluster: the portable cluster sizes)
CLUSTER_WIDTHS = (640, 768, 896, 1024)
# f32 a sample of the narrow heads' statistics (head dims not a multiple of
# 4) at D 128-512: a max and a sum for each (row, head) of a tile
# (kNarrowStat; the cluster keeps them in shared memory)
NARROW_STAT_FLOATS = 16384

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I] + [_P] * 13 + [_I] * 5 + [_P]
_lib = None


def load_kernels() -> ctypes.CDLL:
    """The compiled ``csrc/dual_stack.cu`` and its parts (built on first use)."""
    global _lib
    if _lib is None:
        from vmrframe_tpu_torch.kernels import build

        lib = build.load("dual_stack")
        lib.vmr_dual_stack.argtypes = _ARGTYPES
        lib.vmr_dual_stack.restype = ctypes.c_int
        _lib = lib
    return _lib


# ------------------------------------------------------------ plain version


def _ln(x, s, b, eps=1e-6):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _dot(a, w):
    """a (..., D) and w (D, D) in the compute type, accumulated in f32."""
    return a.float() @ w.float()


def _branch_attention(q, kv_src, Wk, bk, Wv, bv, add_mask, H, cd):
    """q (B, F, D) f32, kv_src (B, T, D) in cd, add_mask (B, F, T): the
    merged multi-head context (B, F, D) in f32."""
    B, F, D = q.shape
    heads = lambda x: x.float().unflatten(-1, (H, D // H)).transpose(1, 2)  # noqa: E731
    k = (_dot(kv_src, Wk) + bk).to(cd)
    v = (_dot(kv_src, Wv) + bv).to(cd)
    scores = heads(q.to(cd)) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(D // H))
    p = torch.softmax(scores + add_mask[:, None], dim=-1)
    return (p.to(cd).float() @ heads(v)).transpose(1, 2).reshape(B, F, D)


def _dab_call(x, y, fm, tm, W, b, ln, xb, H, cd):
    """One DualAttentionBlock call: x (B, F, D) from-side, y (B, T, D)
    to-side, fm (B, F) and tm (B, T) validity; (B, F, D) in f32."""
    xf = x.float()
    fn = _ln(xf, ln[LN1_S], ln[LN1_B]).to(cd)
    tn = _ln(y, ln[LNT_S], ln[LNT_B]).to(cd)
    add_self = MASK_VALUE * (1.0 - fm[:, :, None] * fm[:, None, :])
    add_cross = MASK_VALUE * (1.0 - fm[:, :, None] * tm[:, None, :])

    q = _dot(fn, W[W_Q]) + b[W_Q]
    s_att = _branch_attention(q, fn, W[W_FK], b[W_FK], W[W_FV], b[W_FV], add_self, H, cd)
    x_att = _branch_attention(q, tn, W[W_TK], b[W_TK], W[W_TV], b[W_TV], add_cross, H, cd)

    s_value = _dot(s_att.to(cd), W[W_SD]) + b[W_SD]
    x_value = _dot(x_att.to(cd), W[W_XD]) + b[W_XD]
    s_score = _dot(s_value.to(cd), W[W_SG]) + b[W_SG]
    x_score = _dot(x_value.to(cd), W[W_XG]) + b[W_XG]
    gc = (_dot((s_score * x_value + x_score * s_value).to(cd), W[W_GD]) + b[W_GD]).to(cd)

    scores = _dot(fn, W[W_BL1]) + _dot(gc, W[W_BL1]) + 2.0 * b[W_BL1] + xb[0]
    values = _dot(fn, W[W_BL2]) + _dot(gc, W[W_BL2]) + 2.0 * b[W_BL2] + xb[1]
    dma = torch.sigmoid(scores + MASK_VALUE * (1.0 - fm[:, :, None])) * values

    residual = _dot(dma.to(cd), W[W_D1]) + b[W_D1] + xf
    z = _ln(residual, ln[LN2_S], ln[LN2_B])
    return _dot(z.to(cd), W[W_D2]) + b[W_D2] + residual


def dual_attention_stack_plain(vfeat, tfeat, vmask, tmask, p1: Dict[str, torch.Tensor],
                               p2: Dict[str, torch.Tensor], num_heads: int):
    """The stack in plain PyTorch, rounding where the kernel rounds."""
    cd = p1["W"].dtype
    vm, tm = vmask.float(), tmask.float()
    v, t = vfeat, tfeat
    for p in (p1, p2):
        args = (p["W"], p["b"].float(), p["ln"].float(), p["xb"].float(), num_heads, cd)
        v, t = _dab_call(v, t, vm, tm, *args), _dab_call(t, v, tm, vm, *args)
    return v.to(vfeat.dtype), t.to(tfeat.dtype)


# ------------------------------------------------------------------ wrapper


def _check(vfeat, tfeat, vmask, tmask, p1, p2, num_heads) -> Tuple[int, int, int, int]:
    what = "dual_attention_stack"
    if vfeat.dim() != 3 or tfeat.dim() != 3:
        raise ValueError(f"{what}: vfeat and tfeat must be (B, L, D)")
    B, Lv, D = vfeat.shape
    Lt = tfeat.shape[1]
    if tfeat.shape != (B, Lt, D) or vmask.shape != (B, Lv) or tmask.shape != (B, Lt):
        raise ValueError(f"{what}: vfeat {tuple(vfeat.shape)}, tfeat {tuple(tfeat.shape)}, "
                         f"vmask {tuple(vmask.shape)}, tmask {tuple(tmask.shape)} disagree")
    for p in (p1, p2):
        shapes = {"W": (14, D, D), "b": (14, D), "ln": (6, D), "xb": (2, D)}
        for key, shape in shapes.items():
            if tuple(p[key].shape) != shape:
                raise ValueError(f"{what}: stack {key} is {tuple(p[key].shape)}, want {shape}")
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"{what}: {num_heads} heads do not divide D = {D}")
    return B, Lv, Lt, D


def takes(dtype: torch.dtype, D: int, num_heads: int, Lv: int, Lt: int) -> bool:
    """Whether the kernel takes these shapes: f32 or bf16, D in
    ``KERNEL_WIDTHS`` or ``CLUSTER_WIDTHS`` (every multiple of 128 up to
    1024), heads dividing D (every head dim 1-1024), Lv, Lt >= 1 (the C
    entry refuses the rest).  The wrapper raises on what it refuses."""
    return (dtype in _DTYPE_CODE and D in KERNEL_WIDTHS + CLUSTER_WIDTHS and num_heads > 0
            and D % num_heads == 0 and Lv >= 1 and Lt >= 1)


def dual_attention_stack(vfeat, tfeat, vmask, tmask, p1, p2, num_heads: int):
    """(vfeat', tfeat') of the 2-layer stack, in the shapes and type given.

    vfeat (B, Lv, D), tfeat (B, Lt, D); masks (B, L) {0,1}; p1/p2: the
    stacks ``{'W': (14, D, D), 'b': (14, D), 'ln': (6, D), 'xb': (2, D)}``.
    """
    B, Lv, Lt, D = _check(vfeat, tfeat, vmask, tmask, p1, p2, num_heads)
    if vfeat.device.type == "cpu":
        return plain_route("dual_attention_stack", dual_attention_stack_plain, vfeat, tfeat,
                           vmask, tmask, p1, p2, num_heads)
    what = "dual_attention_stack"
    device, dtype = vfeat.device, vfeat.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, got {dtype}")
    if not takes(dtype, D, num_heads, Lv, Lt):
        raise ValueError(f"{what}: the kernel takes D in {KERNEL_WIDTHS + CLUSTER_WIDTHS} at "
                         f"every head count dividing D, and Lv, Lt >= 1; got D = {D}, "
                         f"{num_heads} heads, Lv = {Lv}, Lt = {Lt}")
    if device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU or a CUDA device, got {device}")
    for t in (tfeat, p1["W"], p2["W"]):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{what}: features and weights must share {device} and {dtype}")
    f32 = lambda key: torch.stack([p1[key], p2[key]]).to(device, torch.float32).contiguous()  # noqa: E731
    W = torch.stack([p1["W"], p2["W"]]).contiguous()
    b, ln, xb = f32("b"), f32("ln"), f32("xb")
    v, t = vfeat.contiguous(), tfeat.contiguous()
    vm = vmask.to(device, torch.float32).contiguous()
    tm = tmask.to(device, torch.float32).contiguous()
    v_out, t_out = torch.empty_like(v), torch.empty_like(t)
    # written and read back by the same block (L2-resident): the first
    # layer's results in f32, and a call's keys and values in the compute type
    scratch = torch.empty(B, Lv + Lt, D, dtype=torch.float32, device=device)
    kv_scratch = torch.empty(B, 2 * (Lv + Lt), D, dtype=dtype, device=device)
    # narrow heads at D 128-512: each (row, head)'s max and sum between the
    # chunks of a side
    stats = (torch.empty(B, NARROW_STAT_FLOATS, dtype=torch.float32, device=device)
             if (D // num_heads) % 4 and D in KERNEL_WIDTHS else None)
    with launch_range("dual_attention_stack"):
        err = load_kernels().vmr_dual_stack(
            _DTYPE_CODE[dtype], v.data_ptr(), t.data_ptr(), vm.data_ptr(), tm.data_ptr(),
            W.data_ptr(), b.data_ptr(), ln.data_ptr(), xb.data_ptr(), v_out.data_ptr(),
            t_out.data_ptr(), scratch.data_ptr(), kv_scratch.data_ptr(),
            None if stats is None else stats.data_ptr(), B, D, Lv, Lt, num_heads, _stream(v))
    _raise_on(err, "vmr_dual_stack")
    dual_attention_stack.launches += 1
    layer = lambda i: {"W": W[i], "b": b[i], "ln": ln[i], "xb": xb[i]}  # noqa: E731
    count_plain(dual_attention_stack_plain, v, t, vm, tm, layer(0), layer(1), num_heads,
                name="dual_attention_stack")
    return v_out, t_out


KERNELS = (dual_attention_stack,)
dual_attention_stack.launches = 0
