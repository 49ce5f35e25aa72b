"""SimilarSentence augmentation of a training set (counterpart of
``vmrframe_tpu/tools/similar_sentence.py``; the reference's
``scripts/most_similar_sentence.py``).

For every annotation, the other training sentences whose embeddings have a
cosine similarity of at least ``--thresh`` (the reference's 0.98) are
appended with its (video, span): the augmented JSON that the reference's
``config/charades/SeqPAN_SimilarSentence.yaml`` names.  The sentences are
embedded by the port's ``get_sentence_encoder`` (the hashed bag-of-words
encoder, the JAX package's route wherever SBERT does not load).

    python -m vmrframe_tpu_torch.tools.similar_sentence --train data/charades_gt/train.json \\
        --out train_sim.json [--thresh 0.98]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from vmrframe_tpu_torch.data.sentence_encoder import get_sentence_encoder


def build_similar_sentence_dataset(records, thresh: float = 0.98, encoder=None):
    """records: [vid, duration, [s, e], sentence, (id)] each.  Returns them
    followed, for each record, by copies carrying the sentences of the other
    records whose embeddings are at least ``thresh`` similar."""
    encoder = encoder or get_sentence_encoder()
    sentences = [r[3] for r in records]
    embs = np.stack([encoder.encode(s) for s in sentences])
    embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-8)
    sim = embs @ embs.T
    np.fill_diagonal(sim, -1.0)
    out = list(records)
    next_id = len(records)
    for i, record in enumerate(records):
        for j in np.nonzero(sim[i] >= thresh)[0]:
            out.append([record[0], record[1], record[2], sentences[int(j)], next_id])
            next_id += 1
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--thresh", type=float, default=0.98)
    args = parser.parse_args(argv)
    with open(args.train, encoding="utf8") as f:
        records = json.load(f)
    out = build_similar_sentence_dataset(records, args.thresh)
    with open(args.out, "w", encoding="utf8") as f:
        json.dump(out, f)
    print(f"{len(records)} -> {len(out)} records ({args.out})")


if __name__ == "__main__":
    main()
