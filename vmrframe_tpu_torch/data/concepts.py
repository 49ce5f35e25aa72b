"""CCA's concept graph (counterpart of ``vmrframe_tpu/data/concepts.py``;
numpy only, the port's own copy).

``load_concepts`` reads the five pickles that the config names (``inp_name``,
``com_emb``, ``adj_file``, ``num_path``, ``com_concept``) and builds the
adjacency as the reference's ``gen_A_concept`` does (``build_adjacency``:
zero diagonal, per-concept count normalization, exponential rescale,
threshold at t, the commonsense block, 0.25 column normalization, + I).
When any of them is absent it builds the deterministic graph of
``num_attribute`` nodes from ``default_rng(7)``; nothing is downloaded.
Either way the adjacency comes back D^-1/2-normalized (``normalized_adj``).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np


def rescale_adj_matrix(adj_mat: np.ndarray, t: float = 5, p: float = 0.02) -> np.ndarray:
    return np.power(t, adj_mat - p) - np.power(t, -p)


def build_adjacency(result: np.ndarray, nums: np.ndarray, com_weight: np.ndarray,
                    t: float) -> np.ndarray:
    result = np.array(result, dtype=np.float64)
    np.fill_diagonal(result, 0)
    adj = rescale_adj_matrix(result / nums)
    adj = np.where(adj < t, 0.0, 1.0)
    train_len, com_len = adj.shape[0], com_weight.shape[0]
    full = np.zeros((train_len + com_len, train_len + com_len), dtype=np.float64)
    full[:train_len, :train_len] = adj
    full[train_len:, :] = com_weight
    full[:, train_len:] = com_weight.T
    full = full * 0.25 / (full.sum(0, keepdims=True) + 1e-6)
    full = full + np.identity(train_len + com_len)
    return full.astype(np.float32)


def normalized_adj(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 symmetric normalization (the reference's ``gen_adj``)."""
    D = np.diag(np.power(adj.sum(1), -0.5))
    return ((adj @ D).T @ D).astype(np.float32)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_concepts(cfg, word_dim: int = 300) -> Tuple[np.ndarray, np.ndarray]:
    """(concept embeddings (A, word_dim), normalized adjacency (A, A))."""

    def existing(key):
        p = cfg.get(key)
        return p if p and os.path.exists(str(p)) else None

    paths = [existing(k) for k in ("inp_name", "com_emb", "adj_file", "num_path", "com_concept")]
    if all(paths):
        inp_path, com_emb_path, adj_path, num_path, com_path = paths
        com_dict = _load(com_emb_path)
        com_vectors = np.array([com_dict[k] for k in com_dict.keys()])
        embs = np.concatenate([np.asarray(_load(inp_path)), com_vectors], 0).astype(np.float32)
        result = _load(adj_path)
        result = result.numpy() if hasattr(result, "numpy") else np.asarray(result)
        concept_dict = _load(num_path)
        nums = np.array([[concept_dict[k]] for k in concept_dict.keys()], dtype=np.int32)
        adj = build_adjacency(result, nums, np.asarray(_load(com_path)), t=0.3)
    else:
        num_attr = int(cfg.num_attribute)
        rng = np.random.default_rng(7)
        embs = rng.standard_normal((num_attr, word_dim)).astype(np.float32) * 0.1
        raw = rng.random((num_attr, num_attr)) * 0.5
        adj = ((raw + raw.T) * 0.125 + np.identity(num_attr)).astype(np.float32)
    return embs, normalized_adj(adj)
