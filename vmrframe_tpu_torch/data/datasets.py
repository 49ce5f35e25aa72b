"""Dataset preparation from annotation files, and its cache (counterpart of
``vmrframe_tpu/data/datasets.py``, the reference's ``data_gen`` pipeline).

Annotation JSON is a list of ``[vid, duration, [stime, etime], sentence,
(sample_id)]``.  Records are tokenized, the word and char vocabularies built
against the GloVe file (``data/glove.py``), ids truncated at ``tlen``, and
the whole dataset (train/val/test records, vocabularies, the embedding
matrix and counts) pickled once per (task, suffix) under
``paths.cache_dir``; a later run reads the pickle.  The records are those
of the JAX package for the same files, so either package reads the other's
cache.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from vmrframe_tpu_torch.data.glove import UNK, vocab_emb_gen
from vmrframe_tpu_torch.data.tokenize import word_tokenize


def load_json(filename: str):
    with open(filename, encoding="utf8") as fr:
        return json.load(fr)


def save_pickle(data, filename: str):
    with open(filename, mode="wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickle(filename: str):
    with open(filename, mode="rb") as handle:
        return pickle.load(handle)


def process_data(data_file: str) -> List[dict]:
    """Annotation list -> tokenized records."""
    results = []
    for record in load_json(data_file):
        vid, duration, (stime, etime), sentence = record[:4]
        results.append({"vid": str(vid), "stime": stime, "etime": etime,
                        "duration": round(duration, 2), "sentence": sentence,
                        "words": word_tokenize(sentence)})
    return results


def dataset_gen(data: List[dict], vfeat_lens: Dict[str, int], word_dict: Dict[str, int],
                char_dict: Dict[str, int], max_tlen: int, scope: str) -> List[dict]:
    """Records -> id-mapped samples: a record whose video has no features is
    dropped; etime is clamped to the duration; ``se_frac`` (time over
    duration) must lie in [0, 1]; word and char ids stop at ``max_tlen``."""
    dataset = []
    for record in data:
        vid = record["vid"]
        if vid not in vfeat_lens:
            continue
        if record["etime"] > record["duration"]:
            record = dict(record, etime=record["duration"])
        sfrac = record["stime"] / record["duration"]
        efrac = record["etime"] / record["duration"]
        if not (0.0 <= sfrac <= 1.0 and 0.0 <= efrac <= 1.0):
            raise ValueError(f"{scope} record outside its video's duration: {record}")
        word_ids, char_ids = [], []
        for word in record["words"][0:max_tlen]:
            word_ids.append(word_dict.get(word, word_dict[UNK]))
            char_ids.append([char_dict.get(c, char_dict[UNK]) for c in word])
        dataset.append({"vid": vid, "se_time": [record["stime"], record["etime"]],
                        "duration": record["duration"], "se_frac": [sfrac, efrac],
                        "sentence": record["sentence"], "words": record["words"],
                        "wids": word_ids, "cids": char_ids})
    return dataset


def generate_dataset(configs, cache_path: str, vfeat_lens: Optional[Dict[str, int]] = None):
    """Reads the annotation and GloVe files of ``configs.paths``, builds the
    dataset and writes it to ``cache_path``."""
    if vfeat_lens is None:
        vfeat_lens = scan_feature_lengths(configs.paths.feature_path)
    train_data = process_data(configs.paths.train_path)
    test_data = process_data(configs.paths.test_path)
    val_path = configs.paths.get("val_path", "")
    data_list = [train_data, test_data]
    val_data = None
    if val_path:
        val_data = process_data(val_path)
        data_list = [train_data, val_data, test_data]

    word_dict, char_dict, vectors = vocab_emb_gen(data_list, configs.paths.glove_path,
                                                  word_dim=configs.model.word_dim)
    tlen = configs.model.tlen
    train_set = dataset_gen(train_data, vfeat_lens, word_dict, char_dict, tlen, "train")
    test_set = dataset_gen(test_data, vfeat_lens, word_dict, char_dict, tlen, "test")
    val_set = (dataset_gen(val_data, vfeat_lens, word_dict, char_dict, tlen, "val")
               if val_data else None)
    dataset = {
        "train_set": train_set,
        "val_set": val_set,
        "test_set": test_set,
        "word_dict": word_dict,
        "char_dict": char_dict,
        "word_vector": vectors,
        "n_train": len(train_set),
        "n_val": len(val_set) if val_set else 0,
        "n_test": len(test_set),
        "n_words": len(word_dict),
        "n_chars": len(char_dict),
    }
    save_pickle(dataset, cache_path)
    return dataset


def npy_length(path: str) -> int:
    """The first dimension of a ``.npy`` file, from its header alone (numpy's
    public readers of format 1.0 and 2.0 headers; another format's file is
    mapped, which reads its header and no data)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read is not None:
            return read(f)[0][0]
    return np.load(path, mmap_mode="r").shape[0]


def scan_feature_lengths(feature_dir: str) -> Dict[str, int]:
    """vid -> frames, from the headers of ``feature_dir/*.npy``."""
    return {os.path.basename(path)[:-4]: npy_length(path)
            for path in glob.glob(os.path.join(feature_dir, "*.npy"))}


def cache_path(configs, derived) -> str:
    return os.path.join(configs.paths.cache_dir, "{}_{}.pkl".format(configs.task, derived.suffix))


def load_dataset(configs, derived, vfeat_lens: Optional[Dict[str, int]] = None):
    """The cached dataset of (task, suffix), built first if it is absent."""
    os.makedirs(configs.paths.cache_dir, exist_ok=True)
    path = cache_path(configs, derived)
    if not os.path.exists(path):
        return generate_dataset(configs, path, vfeat_lens=vfeat_lens)
    return load_pickle(path)
