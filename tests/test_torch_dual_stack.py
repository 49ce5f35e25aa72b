"""The port's whole-stack dual-attention function (kernel #4's plain version)
and its weight stacks against the JAX package.

- ``dual_attention_stack_plain`` against the Pallas kernel
  ``dual_attention_stack(..., interpret=True)`` on the same numpy inputs and
  carried-over weights: f32 at 1e-5 on EVERY returned row, padding rows and
  wholly padded samples included (a row without validity has its gate at
  exactly 0, so it is ``dense_2(LN2(b_d1 + x)) + b_d1 + x`` on both sides);
- the same at SeqPAN's ANet and TACoS lengths (100 and 256 video
  positions, and 256 on the text side), which the kernel walks in row
  tiles and key chunks;
- bf16 weights and activations at 2**-6 of the largest output (a few bf16
  ulps: both sides round at the same points, sums differ in order), at the
  Charades and the TACoS length;
- a sample whose to-side has no valid key: there the TPU kernel spreads a
  valid from-row's softmax over the 2 Lt columns of its stacked pair, the
  port over the sample's own Lt rows, as the JAX MODULE path does; so that
  sample is held against the module path (1e-4, the modules' bar) and the
  other samples against the kernel;
- the same at D 256 (4 heads, f32) and D 512 (8 heads, bf16), the widths
  the kernel's wider instances take, and at D 640 (4 heads of 160, f32) and
  768 (4 of 192, bf16), two of the cluster's, on stacks made with numpy from
  a seed;
- the wide and the narrow heads, head dims 192, 512, 1, 3 and 6, and the
  cluster's head dims 5 (D 640), 14 (D 896) and 1024 (D 1024), against
  the JAX module path (``DualAttentionBlock``, jitted: the Pallas body
  walks the heads one at a time, 20-40 s a call in interpret mode at 64-128
  heads), f32 at ``ATOL`` and bf16 at 2**-6 of the largest output, on every
  row;
- ``takes`` accepts every (D, H) the models' gate (``use_fused_stack``, the
  JAX package's conditions) passes up to D 1024, and the wrapper refuses D
  1152, 1280 and 2048 with a message that names the set;
- the stacks of the port's ``DualAttentionBlock`` equal
  ``DualAttentionBlockParams.apply`` on the carried-over weights, exactly;
- ``MultiHeadAttentionBlock`` against the flax module at 1e-4.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.kernels.dual_stack import dual_attention_stack as j_stack
from vmrframe_tpu.layers import attention as jl
from vmrframe_tpu_torch.kernels import dual_stack as S
from vmrframe_tpu_torch.layers.attention import DualAttentionBlock, MultiHeadAttentionBlock
from vmrframe_tpu_torch.weights import load_jax_params

D, H = 128, 4
ATOL = 1e-5


def _jax_block_params(seed):
    """One DualAttentionBlock's flax params with every leaf random (the
    initialisers leave biases and LN at 0/1, which would hide them)."""
    v, t = jnp.zeros((1, 8, D)), jnp.zeros((1, 8, D))
    params = jl.DualAttentionBlock(D, H, 0.0).init(
        jax.random.PRNGKey(seed), v, t, jnp.ones((1, 8)), jnp.ones((1, 8)), True)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "kernel":
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.1
        return noise + (1.0 if name == "scale" else 0.0)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def blocks():
    """(flax params, port module, JAX stacks, port stacks) for two blocks."""
    out = []
    for seed in (0, 1):
        params = _jax_block_params(seed)
        module = load_jax_params(DualAttentionBlock(D, H), params, {}).eval()
        jstacks = jl.DualAttentionBlockParams(D, H, 0.0).apply({"params": params})
        with torch.no_grad():
            out.append((params, module, jstacks, module.stacks()))
    return out


def _inputs(seed, B, Lv, Lt, empty_to_side=False):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, Lv, D)).astype(np.float32)
    t = rng.standard_normal((B, Lt, D)).astype(np.float32)
    vlens = rng.integers(Lv // 2, Lv + 1, B)
    tlens = rng.integers(2, Lt + 1, B)
    if B > 2:
        vlens[-1] = tlens[-1] = 0  # a wholly padded sample, as the service pads a batch
    if empty_to_side:
        tlens[0] = 0  # valid video rows facing a text side with no valid key
    vm = (np.arange(Lv)[None] < vlens[:, None]).astype(np.float32)
    tm = (np.arange(Lt)[None] < tlens[:, None]).astype(np.float32)
    return v, t, vm, tm


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def test_stacks_equal_the_jax_collector(blocks):
    for _, _, jstacks, stacks in blocks:
        assert set(stacks) == set(jstacks) == {"W", "b", "ln", "xb"}
        for key in jstacks:
            assert tuple(stacks[key].shape) == jstacks[key].shape
            np.testing.assert_array_equal(stacks[key].numpy(), np.asarray(jstacks[key]))


@pytest.mark.parametrize("B,Lv,Lt", [(4, 64, 25), (3, 64, 25), (2, 40, 12), (2, 64, 30),
                                     (2, 100, 30), (2, 256, 30), (2, 30, 256)])
def test_plain_matches_pallas_interpret_on_every_row(blocks, B, Lv, Lt):
    v, t, vm, tm = _inputs(B, B, Lv, Lt)
    (_, _, j1, p1), (_, _, j2, p2) = blocks
    want_v, want_t = j_stack(*(jnp.asarray(a) for a in (v, t, vm, tm)), j1, j2, H,
                             interpret=True)
    before = S.dual_attention_stack.launches
    with torch.no_grad():
        got_v, got_t = S.dual_attention_stack(_t(v), _t(t), _t(vm), _t(tm), p1, p2, H)
    assert S.dual_attention_stack.launches == before  # CPU tensors: the plain version
    assert got_v.shape == (B, Lv, D) and got_t.shape == (B, Lt, D)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL)


def _check_bf16(blocks, B, Lv, Lt, seed):
    v, t, vm, tm = _inputs(seed, B, Lv, Lt)
    (_, _, j1, p1), (_, _, j2, p2) = blocks
    cast = lambda p, to: {k: to(x, k == "W") for k, x in p.items()}  # noqa: E731
    jb = lambda x, w: jnp.asarray(x, jnp.bfloat16) if w else jnp.asarray(x)  # noqa: E731
    tb = lambda x, w: x.to(torch.bfloat16) if w else x  # noqa: E731
    want = j_stack(jnp.asarray(v, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16), jnp.asarray(vm),
                   jnp.asarray(tm), cast(j1, jb), cast(j2, jb), H, interpret=True)
    with torch.no_grad():
        got = S.dual_attention_stack_plain(_t(v, torch.bfloat16), _t(t, torch.bfloat16), _t(vm),
                                           _t(tm), cast(p1, tb), cast(p2, tb), H)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        tol = 2.0 ** -6 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol)


def test_plain_matches_pallas_interpret_in_bf16(blocks):
    _check_bf16(blocks, 2, 64, 30, seed=7)


def test_plain_matches_pallas_interpret_in_bf16_at_tacos_length(blocks):
    """SeqPAN's TACoS video length (256) against 30 text positions."""
    _check_bf16(blocks, 2, 256, 30, seed=8)


def test_empty_to_side_follows_the_module_path(blocks):
    B, Lv, Lt = 4, 64, 30
    v, t, vm, tm = _inputs(11, B, Lv, Lt, empty_to_side=True)
    assert tm[0].sum() == 0 and vm[0].sum() > 0
    (q1, m1, j1, p1), (q2, m2, j2, p2) = blocks
    with torch.no_grad():
        got_v, got_t = S.dual_attention_stack_plain(_t(v), _t(t), _t(vm), _t(tm), p1, p2, H)
        # the port's own module path, and the JAX module path
        mv, mt = _t(v), _t(t)
        for m in (m1, m2):
            mv, mt = m(mv, mt, _t(vm), _t(tm)), m(mt, mv, _t(tm), _t(vm))
    jv, jt = jnp.asarray(v), jnp.asarray(t)
    for params in (q1, q2):
        apply = lambda x, y, xm, ym: jl.DualAttentionBlock(D, H, 0.0).apply(  # noqa: E731
            {"params": params}, x, y, jnp.asarray(xm), jnp.asarray(ym), True)
        jv, jt = apply(jv, jt, vm, tm), apply(jt, jv, tm, vm)
    for got, own, want in ((got_v, mv, jv), (got_t, mt, jt)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(got.numpy(), own.numpy(), atol=1e-4)
    # the other samples agree with the TPU kernel; sample 0 shares its pair
    # with sample 1 there, so only sample 0 itself differs
    want_v, want_t = j_stack(*(jnp.asarray(a) for a in (v, t, vm, tm)), j1, j2, H,
                             interpret=True)
    np.testing.assert_allclose(got_v[1:].numpy(), np.asarray(want_v)[1:], atol=ATOL)
    np.testing.assert_allclose(got_t[1:].numpy(), np.asarray(want_t)[1:], atol=ATOL)
    assert np.abs(got_v[0].numpy() - np.asarray(want_v)[0]).max() > 1e-3


def _np_stacks(rng, D):
    """One layer's stacks at width D, every leaf random, as numpy arrays."""
    ln = 0.1 * rng.standard_normal((6, D)).astype(np.float32)
    ln[0::2] += 1.0  # the scales
    return {"W": rng.standard_normal((14, D, D)).astype(np.float32) / np.sqrt(D),
            "b": 0.1 * rng.standard_normal((14, D)).astype(np.float32), "ln": ln,
            "xb": 0.1 * rng.standard_normal((2, D)).astype(np.float32)}


@pytest.mark.parametrize("D,H,dtype,B,Lv,Lt", [(256, 4, "f32", 3, 20, 9),
                                               (512, 8, "bf16", 2, 12, 5),
                                               (640, 4, "f32", 3, 9, 5),
                                               (768, 4, "bf16", 2, 6, 3)])
def test_plain_matches_pallas_interpret_at_wider_d(D, H, dtype, B, Lv, Lt):
    """The widths #4's wider instances take, and two of the cluster's (D 640
    and 768, heads of 160 and 192): f32 at ``ATOL`` on every row (the last
    sample wholly padded), bf16 (features and W) at 2**-6 of the largest
    output."""
    rng = np.random.default_rng(D + H)
    p1, p2 = _np_stacks(rng, D), _np_stacks(rng, D)
    v = rng.standard_normal((B, Lv, D)).astype(np.float32)
    t = rng.standard_normal((B, Lt, D)).astype(np.float32)
    vlens, tlens = rng.integers(1, Lv + 1, B), rng.integers(1, Lt + 1, B)
    vlens[-1] = tlens[-1] = 0
    vm = (np.arange(Lv)[None] < vlens[:, None]).astype(np.float32)
    tm = (np.arange(Lt)[None] < tlens[:, None]).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jp = lambda p: {k: jnp.asarray(x, jd if k == "W" else jnp.float32) for k, x in p.items()}  # noqa: E731
    tp = lambda p: {k: _t(x, td if k == "W" else torch.float32) for k, x in p.items()}  # noqa: E731
    want = j_stack(jnp.asarray(v, jd), jnp.asarray(t, jd), jnp.asarray(vm), jnp.asarray(tm),
                   jp(p1), jp(p2), H, interpret=True)
    with torch.no_grad():
        got = S.dual_attention_stack(_t(v, td), _t(t, td), _t(vm), _t(tm), tp(p1), tp(p2), H)
    for g, w in zip(got, want):
        assert g.dtype == td and g.shape == w.shape
        w = np.asarray(w.astype(jnp.float32))
        tol = ATOL if dtype == "f32" else 2.0 ** -6 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_stack_params(D, H, seed):
    """One layer's flax params at width D (the collector's tree, the same as
    the module's), every leaf random, and its stacks (made once for both
    types)."""
    params = jl.DualAttentionBlockParams(D, H, 0.0).init(jax.random.PRNGKey(seed))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return np.asarray(leaf)
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.1
        return noise + (1.0 if name == "scale" else 0.0)

    params = jax.tree_util.tree_map_with_path(fill, params)
    return params, jl.DualAttentionBlockParams(D, H, 0.0).apply({"params": params})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,H", [(384, 2), (512, 1), (128, 128), (384, 128), (384, 64),
                                 (640, 128), (896, 64), (1024, 1)],
                         ids=["hd192", "hd512", "hd1", "hd3", "hd6", "d640-hd5", "d896-hd14",
                              "d1024-hd1024"])
def test_plain_matches_jax_at_wide_and_narrow_heads(D, H, dtype):
    """The head dims #4's wide and narrow bodies take (192, 512; 1, 3, 6;
    and the cluster's 5 and 14 at D 640 and 896, 1024 at D 1024) against
    the JAX module path (two ``DualAttentionBlock``s, jitted; in
    bf16 every leaf and the features cast, as the JAX bf16 route casts
    them): the Pallas kernel in interpret mode takes 3-4 s a call at 1-2
    heads and 20-40 s at 64-128.  f32 at ``ATOL``, bf16 at 2**-6 of the
    largest output, on every row (the last sample wholly padded)."""
    (q1, j1), (q2, j2) = (_jax_stack_params(D, H, seed) for seed in (D, D + 1))
    rng = np.random.default_rng(H)
    B, Lv, Lt = 3, 20, 9
    v = rng.standard_normal((B, Lv, D)).astype(np.float32)
    t = rng.standard_normal((B, Lt, D)).astype(np.float32)
    vlens, tlens = rng.integers(1, Lv + 1, B), rng.integers(1, Lt + 1, B)
    vlens[-1] = tlens[-1] = 0
    vm = (np.arange(Lv)[None] < vlens[:, None]).astype(np.float32)
    tm = (np.arange(Lt)[None] < tlens[:, None]).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)

    @jax.jit
    def module_path(v, t, vm, tm, trees):
        for tree in trees:
            apply = lambda x, y, xm, ym: jl.DualAttentionBlock(D, H, 0.0).apply(  # noqa: E731
                {"params": tree}, x, y, xm, ym, True)
            v, t = apply(v, t, vm, tm), apply(t, v, tm, vm)
        return v, t

    cast = lambda x: jnp.asarray(x, jd)  # noqa: E731
    want = module_path(cast(v), cast(t), cast(vm), cast(tm), jax.tree_util.tree_map(cast, (q1, q2)))
    tp = lambda p: {k: _t(x, td if k == "W" else torch.float32) for k, x in p.items()}  # noqa: E731
    with torch.no_grad():
        got = S.dual_attention_stack(_t(v, td), _t(t, td), _t(vm), _t(tm), tp(j1), tp(j2), H)
    for g, w in zip(got, want):
        assert g.dtype == td and g.shape == w.shape
        w = np.asarray(w.astype(jnp.float32))
        tol = ATOL if dtype == "f32" else 2.0 ** -6 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol)


def test_takes_every_width_the_gate_passes_up_to_512():
    """The models' gate passes D a multiple of 128 and heads dividing D; the
    kernel takes those of D <= 1024 (every head dim, 1-1024: one CTA a
    sample to D 512, a cluster of D / 128 past it), and no other."""
    from vmrframe_tpu_torch.models.common import use_fused_stack
    from vmrframe_tpu_torch.tools.serve import make_cfg

    for D in range(64, 1216, 64):
        for H in (h for h in range(1, D + 1) if D % h == 0):
            m = make_cfg(dim=D, fused_dual_stack=True).updated({"model.num_heads": H}).model
            gate = use_fused_stack(m, deterministic=True)
            want = gate and D <= 1024
            assert S.takes(torch.bfloat16, D, H, 64, 30) == want, (D, H)
            assert S.takes(torch.float32, D, H, 1, 1) == want, (D, H)
    assert set(S.KERNEL_WIDTHS) == {128, 256, 384, 512}
    assert set(S.CLUSTER_WIDTHS) == {640, 768, 896, 1024}
    assert not S.takes(torch.float16, 256, 4, 64, 30) and not S.takes(torch.float32, 256, 4, 0, 3)


@pytest.mark.parametrize("D,H", [(1152, 4), (1280, 4), (2048, 2)])
def test_wrapper_refuses_past_the_limit_naming_the_set(D, H):
    """Off the CPU the wrapper holds the shapes to ``takes`` before it looks
    for a card: D 1152, 1280 and 2048 (4 heads of 288 and 320, 2 of 1024),
    past the largest portable cluster, raise the ValueError that names the
    widths it takes at every head count (shown here on meta tensors); D 128
    at 1 head and at 128 (head dims 128 and 1) and D 1024 at 4 heads and at
    1024 pass that check (and then want a card)."""
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    p = {"W": meta(14, D, D), "b": meta(14, D), "ln": meta(6, D), "xb": meta(2, D)}
    args = (meta(2, 16, D), meta(2, 8, D), meta(2, 16), meta(2, 8), p, p)
    with pytest.raises(ValueError, match=r"the kernel takes D in \(128, 256, 384, 512, 640, 768, "
                                         r"896, 1024\) at every head count dividing D"):
        S.dual_attention_stack(*args, H)
    for width, heads in ((128, 1), (128, 128), (1024, 4), (1024, 1024)):
        p1 = {"W": meta(14, width, width), "b": meta(14, width), "ln": meta(6, width),
              "xb": meta(2, width)}
        with pytest.raises(ValueError, match="on the CPU or a CUDA device"):
            S.dual_attention_stack(meta(2, 16, width), meta(2, 8, width), meta(2, 16),
                                   meta(2, 8), p1, p1, heads)


def test_wrapper_checks_shapes_on_any_device(blocks):
    (_, _, _, p1), (_, _, _, p2) = blocks
    v, t, vm, tm = (_t(a) for a in _inputs(3, 2, 16, 8))
    with pytest.raises(ValueError, match="disagree"):
        S.dual_attention_stack(v, t, vm[:, :5], tm, p1, p2, H)
    with pytest.raises(ValueError, match="heads"):
        S.dual_attention_stack(v, t, vm, tm, p1, p2, 3)
    with pytest.raises(ValueError, match="stack W"):
        S.dual_attention_stack(v, t, vm, tm, {**p1, "W": p1["W"][:13]}, p2, H)


@pytest.mark.parametrize("masked", [True, False])
def test_multi_head_attention_block(masked):
    rng = np.random.default_rng(5)
    B, L, dim = 3, 10, 16
    x = rng.standard_normal((B, L, dim)).astype(np.float32)
    lens = np.array([L, 4, 0])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32) if masked else None
    flax_m = jl.MultiHeadAttentionBlock(dim, 4, 0.0)
    args = (jnp.asarray(x),) + ((jnp.asarray(mask),) if masked else ())
    variables = flax_m.init(jax.random.PRNGKey(0), *args)
    torch_m = load_jax_params(MultiHeadAttentionBlock(dim, 4), variables["params"], {}).eval()
    want = flax_m.apply(variables, *args)
    with torch.no_grad():
        got = torch_m(_t(x), _t(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
