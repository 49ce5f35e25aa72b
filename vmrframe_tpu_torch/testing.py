"""Synthetic data for tests, smoke runs and the serve self-test (counterpart
of ``vmrframe_tpu/testing.py``: the same seed gives the same records), and a
writer of dataset files in the reference's formats (``write_dataset_files``)."""

from __future__ import annotations

import json
import os
import string

import numpy as np

from vmrframe_tpu_torch.data.features import SyntheticFeatureStore

_WORDS = (
    "person opens door closes window holds cup drinks water walks runs sits "
    "stands table chair book phone laptop puts takes picks box bag room floor "
    "kitchen light turns plays watches eats food camera looks towards away a "
    "the on off in out of to and then begins starts stops finishes"
).split()


def make_synthetic_data(cfg, seed: int = 0, n_train: int = 64, n_test: int = 32,
                        n_videos: int = 24):
    """A dataset dict (train/test records, vocabularies, word vectors) plus a
    SyntheticFeatureStore, with no files on disk."""
    rng = np.random.default_rng(seed)
    vids = [f"vid{i:04d}" for i in range(n_videos)]
    store = SyntheticFeatureStore(vids, vdim=cfg.model.vdim, min_len=24,
                                  max_len=max(64, cfg.model.vlen * 2), seed=seed)
    lens = store.lengths()

    word_list = sorted(set(_WORDS))
    word_dict = {"<PAD>": 0, "<UNK>": 1}
    for w in word_list:
        word_dict[w] = len(word_dict)
    chars = sorted(set("".join(word_list)))
    char_dict = {"<PAD>": 0, "<UNK>": 1}
    for c in chars:
        char_dict[c] = len(char_dict)
    word_vector = rng.standard_normal((len(word_dict) - 2, cfg.model.word_dim)).astype(np.float32) * 0.1

    def make_records(n, offset):
        records = []
        for i in range(n):
            vid = vids[(i + offset) % n_videos]
            duration = round(float(lens[vid]) / 3.0, 2)
            s = float(rng.uniform(0, duration * 0.7))
            e = float(rng.uniform(s + duration * 0.05, duration))
            n_words = int(rng.integers(4, min(12, cfg.model.tlen)))
            words = [word_list[int(rng.integers(0, len(word_list)))] for _ in range(n_words)]
            records.append({
                "vid": vid,
                "se_time": [s, e],
                "duration": duration,
                "se_frac": [s / duration, e / duration],
                "sentence": " ".join(words),
                "words": words,
                "wids": [word_dict[w] for w in words],
                "cids": [[char_dict.get(c, 1) for c in w] for w in words],
            })
        return records

    dataset = {
        "train_set": make_records(n_train, 0),
        "val_set": None,
        "test_set": make_records(n_test, 7),
        "word_dict": word_dict,
        "char_dict": char_dict,
        "word_vector": word_vector,
        "n_train": n_train,
        "n_val": 0,
        "n_test": n_test,
        "n_words": len(word_dict),
        "n_chars": len(char_dict),
    }
    return dataset, store


def lift_drop_path(model, seed: int = 0):
    """Draws ActionFormer's ``AffineDropPath`` scales in [0.5, 1.5] from
    ``seed``, the same on every device.  At their init of 1e-4 they shrink
    each attention and MLP branch to almost nothing, so a comparison of two
    whole forwards would not see what the branches compute."""
    import torch

    from vmrframe_tpu_torch.layers.actionformer import AffineDropPath

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, AffineDropPath):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
    return model


def lift_label_embs(model, seed: int = 0):
    """Draws every match head's ``label_embs`` (a distillation model has two)
    from N(0, 1) by ``seed``, in parameter order, the same on every device.
    At their orthogonal init the loss's orthogonality penalty, the norm of
    the Gram matrix's off-diagonal, sits at zero, where the norm has no
    gradient: what comes out is the direction of the rounding noise, which
    differs between two devices."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.split(".")[-1] == "label_embs":
                p.copy_(torch.randn(p.shape, generator=g))
    return model


def _vocabulary(n_words: int, rng: np.random.Generator) -> list:
    """The caption words of ``make_synthetic_data`` and made-up lowercase
    words after them, ``n_words`` distinct ones in all."""
    words = sorted(set(_WORDS))
    seen = set(words)
    letters = np.array(list(string.ascii_lowercase))
    while len(words) < n_words:
        word = "".join(letters[rng.integers(0, 26, size=int(rng.integers(3, 10)))])
        if word not in seen:
            seen.add(word)
            words.append(word)
    return words


def write_dataset_files(root: str, cfg, n_videos: int = 24, n_train: int = 64,
                        n_test: int = 32, seed: int = 0, n_words: int = 200,
                        min_len: int = 30, max_len: int = 250) -> str:
    """Writes a dataset in the reference's formats under ``root`` and returns
    the path of a config (``cfg`` with its ``paths`` set to them, as JSON):

    - ``features/<vid>.npy``: float32 (frames, ``model.vdim``) features, one
      file per video, frames drawn in [min_len, max_len];
    - ``train.json``/``test.json``: annotation lists ``[vid, duration,
      [stime, etime], sentence]``; some end times pass the duration (clamped
      when read), some captions are longer than ``model.tlen``, and a few
      training records name a video that has no features (dropped when
      read), beyond the ``n_train`` that remain;
    - ``glove.txt``: a header line, then 300-d vectors for nine in ten of the
      ``n_words`` caption words (the rest read as UNK) and a few words that
      no caption uses.

    A writer of fixtures for tests and smoke runs: the same arguments write
    the same bytes."""
    rng = np.random.default_rng(seed)
    feature_dir = os.path.join(root, "features")
    os.makedirs(feature_dir, exist_ok=True)
    vdim, tlen = int(cfg.model.vdim), int(cfg.model.tlen)
    durations = {}
    for i in range(n_videos):
        vid = f"v{i:05d}"
        frames = int(rng.integers(min_len, max_len + 1))
        np.save(os.path.join(feature_dir, f"{vid}.npy"),
                rng.standard_normal((frames, vdim)).astype(np.float32))
        durations[vid] = round(frames / float(rng.uniform(2.0, 4.0)), 2)
    vocab = _vocabulary(n_words, rng)
    # word frequencies fall off as 1 / rank, as a caption corpus's do
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    weights /= weights.sum()

    def annotations(n, offset, n_missing=0):
        out = []
        for i in range(n + n_missing):
            if i < n:
                vid = f"v{(i + offset) % n_videos:05d}"
                duration = durations[vid]
            else:
                vid, duration = f"missing{i - n}", 30.0
            s = float(rng.uniform(0.0, duration * 0.7))
            e = float(rng.uniform(s + duration * 0.05, duration * 1.05))
            words = rng.choice(vocab, size=int(rng.integers(4, tlen + 4)), p=weights)
            out.append([vid, duration, [round(s, 2), round(e, 2)], " ".join(words)])
        return out

    paths = {"feature_path": feature_dir, "glove_path": os.path.join(root, "glove.txt"),
             "train_path": os.path.join(root, "train.json"),
             "test_path": os.path.join(root, "test.json"), "val_path": "",
             "cache_dir": os.path.join(root, "cache")}
    with open(paths["train_path"], "w", encoding="utf8") as f:
        json.dump(annotations(n_train, 0, n_missing=max(1, n_train // 64)), f)
    with open(paths["test_path"], "w", encoding="utf8") as f:
        json.dump(annotations(n_test, n_videos // 3), f)
    glove_words = [w for i, w in enumerate(vocab) if i % 10 != 9] + ["zzunused", "qqunused"]
    vectors = rng.standard_normal((len(glove_words), 300)).astype(np.float32) * 0.3
    with open(paths["glove_path"], "w", encoding="utf8") as f:
        f.write(f"{len(glove_words)} 300\n")
        for word, vec in zip(glove_words, vectors):
            f.write(word + " " + " ".join(f"{x:.5f}" for x in vec) + "\n")
    data = cfg.to_dict()
    data["paths"] = {**data.get("paths", {}), **paths}
    config_path = os.path.join(root, "config.json")
    with open(config_path, "w", encoding="utf8") as f:
        json.dump(data, f, indent=1)
    return config_path


def past_limit_cases(seed: int = 0) -> dict:
    """One case just past each hand-written kernel's limit, for checking on
    a card that the models' gates route it to the plain version: name ->
    (the kernel wrapper that must count no launch, a seeded module in eval
    mode on the CPU, its CPU inputs).  #5 at head dim 192, #3 at a
    1025-position context, #1 at head dim 264; f32, small batches.  #4 has
    no such route: past its limit the wrapper raises on the card
    (``stack_past_limit_case``)."""
    import torch

    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import window_attention as W
    from vmrframe_tpu_torch.layers.actionformer import MaskedMHCA
    from vmrframe_tpu_torch.layers.attention import CQAttention
    from vmrframe_tpu_torch.layers.predictor import TopSelfAttention
    from vmrframe_tpu_torch.weights import init_weights

    g = torch.Generator().manual_seed(seed)

    def mask(B, L):
        lens = torch.randint(L // 2, L + 1, (B,), generator=g)
        return (torch.arange(L)[None] < lens[:, None]).float()

    cases = {
        "banded_attention hd=192": (
            W.banded_attention, MaskedMHCA(768, 4, window_size=19, pallas_min_len=256),
            (torch.randn(2, 512, 768, generator=g), mask(2, 512))),
        "fused_cq_attention Lc=1025": (
            K.fused_cq_attention, CQAttention(32),
            (torch.randn(2, 1025, 32, generator=g), torch.randn(2, 8, 32, generator=g),
             mask(2, 1025), mask(2, 8))),
        "fused_masked_attention hd=264": (
            K.fused_masked_attention, TopSelfAttention(1056, 4),
            (torch.randn(2, 16, 1056, generator=g), mask(2, 16))),
    }
    for _, module, _ in cases.values():
        init_weights(module, seed).eval()
    return cases


def stack_past_limit_case(dim: int = 1152, num_heads: int = 4, seed: int = 0):
    """(a seeded BackBone with ``model.fused_dual_stack`` set, in eval mode on
    the CPU, one batch of its CPU inputs) at a width the gate passes (D a
    multiple of 128, heads dividing it) and #4 does not take (D 1152 by
    default): its forward on the card raises the wrapper's ``ValueError``;
    on the CPU it runs the plain stack.  f32, batch 2."""
    import torch

    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.weights import init_weights

    cfg = make_cfg(vlen=16, tlen=8, vdim=32, dim=dim, batch_size=2, compute_dtype="float32",
                   model="BackBone", fused_dual_stack=True).updated({"model.num_heads": num_heads})
    data, store = make_synthetic_data(cfg, seed=seed, n_train=2, n_test=2)
    derived = Derived(num_words=data["n_words"], num_chars=data["n_chars"])
    batch = Batcher(data["test_set"], store, cfg, derived, "test").make_batch([0, 1])
    batch = {k: torch.as_tensor(v) for k, v in batch.items() if k != "num_valid"}
    model = get_model_entry("BackBone").model_cls(cfg, derived, data["word_vector"])
    return init_weights(model, seed).eval(), batch
