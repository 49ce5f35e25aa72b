"""Synthetic data for tests, smoke runs and the serve self-test (counterpart
of ``vmrframe_tpu/testing.py``: the same seed gives the same records)."""

from __future__ import annotations

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
    """Draws the match head's ``label_embs`` from N(0, 1) by ``seed``, the
    same on every device.  At their orthogonal init the loss's orthogonality
    penalty, the norm of the Gram matrix's off-diagonal, sits at zero, where
    the norm has no gradient: what comes out is the direction of the
    rounding noise, which differs between two devices."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.label_embs.copy_(torch.randn(model.label_embs.shape, generator=g))
    return model
