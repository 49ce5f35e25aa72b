"""GloVe vocabulary and embedding extraction (counterpart of
``vmrframe_tpu/data/glove.py``, kept line for line in behaviour).

Two passes over the GloVe text file, as the reference's ``data_gen``: a
vocabulary scan finds which corpus words have a vector, a second scan takes
those vectors in corpus-frequency order.  Row 0 of the word table is PAD,
row 1 UNK; the embedding matrix holds the GloVe words only (the model adds
the PAD and UNK rows).  Two traps of the original are kept on purpose:
``load_glove_vocab`` keeps only lines of 301 fields whatever ``word_dim``
is, while ``filter_glove_embedding`` takes ``dim + 1``; so a 50-d GloVe file
gives an empty vocabulary here as there.  Without a GloVe file every corpus
word gets a seeded random vector (``default_rng(0)``, times 0.1).
"""

from __future__ import annotations

import codecs
import os
from collections import Counter
from typing import Dict, Sequence, Set, Tuple

import numpy as np

PAD, UNK = "<PAD>", "<UNK>"


def load_glove_vocab(glove_path: str) -> Set[str]:
    vocab = []
    with codecs.open(glove_path, mode="r", encoding="utf-8") as f:
        for line in f:
            parts = line.lstrip().rstrip().split(" ")
            if len(parts) == 2 or len(parts) != 301:
                continue
            vocab.append(parts[0])
    return set(vocab)


def filter_glove_embedding(word_dict: Dict[str, int], glove_path: str,
                           dim: int = 300) -> np.ndarray:
    vectors = np.zeros(shape=[len(word_dict), dim], dtype=np.float32)
    with codecs.open(glove_path, mode="r", encoding="utf-8") as f:
        for line in f:
            parts = line.lstrip().rstrip().split(" ")
            if len(parts) == 2 or len(parts) != dim + 1:
                continue
            word = parts[0]
            if word in word_dict:
                vectors[word_dict[word]] = np.asarray([float(x) for x in parts[1:]])
    return vectors


def vocab_emb_gen(datasets: Sequence[Sequence[dict]], glove_path: str, word_dim: int = 300,
                  char_min_count: int = 5) -> Tuple[Dict[str, int], Dict[str, int], np.ndarray]:
    """(word_dict, char_dict, vectors): the corpus words that have a GloVe
    vector, by corpus frequency, after PAD and UNK; the chars seen at least
    ``char_min_count`` times, after PAD and UNK; the vectors of the words."""
    word_counter: Counter = Counter()
    char_counter: Counter = Counter()
    for data in datasets:
        for record in data:
            for word in record["words"]:
                word_counter[word] += 1
                for char in word:
                    char_counter[char] += 1

    if glove_path and os.path.exists(glove_path):
        emb_vocab = load_glove_vocab(glove_path)
        word_vocab = [w for w, _ in word_counter.most_common() if w in emb_vocab]
        tmp_word_dict = {w: i for i, w in enumerate(word_vocab)}
        vectors = filter_glove_embedding(tmp_word_dict, glove_path, dim=word_dim)
    else:  # no GloVe file: every corpus word, seeded random vectors
        word_vocab = [w for w, _ in word_counter.most_common()]
        rng = np.random.default_rng(0)
        vectors = rng.standard_normal((len(word_vocab), word_dim)).astype(np.float32) * 0.1

    word_vocab = [PAD, UNK] + word_vocab
    word_dict = {w: i for i, w in enumerate(word_vocab)}
    char_vocab = [PAD, UNK] + [c for c, n in char_counter.most_common() if n >= char_min_count]
    char_dict = {c: i for i, c in enumerate(char_vocab)}
    return word_dict, char_dict, vectors
