"""Word tokenization (counterpart of ``vmrframe_tpu/data/tokenize.py``).

NLTK's regex ``NLTKWordTokenizer`` when nltk is importable, else a small
regex re-implementation of the same Treebank rules, which is enough for the
lowercase single-sentence captions of Charades/ANet/TACoS.
"""

from __future__ import annotations

import re
from typing import List

try:
    from nltk.tokenize import NLTKWordTokenizer

    _NLTK_TOKENIZER = NLTKWordTokenizer()
except ImportError:
    _NLTK_TOKENIZER = None


_CONTRACTIONS2 = [
    re.compile(p)
    for p in (r"(?i)\b(can)(?#X)(not)\b", r"(?i)\b(d)(?#X)('ye)\b",
              r"(?i)\b(gim)(?#X)(me)\b", r"(?i)\b(gon)(?#X)(na)\b",
              r"(?i)\b(got)(?#X)(ta)\b", r"(?i)\b(lem)(?#X)(me)\b",
              r"(?i)\b(more)(?#X)('n)\b", r"(?i)\b(wan)(?#X)(na)(?=\s)")
]


def _fallback_tokenize(text: str) -> List[str]:
    text = f" {text} "
    # punctuation
    text = re.sub(r"([^\w\s\.\'\-\/,])", r" \1 ", text)
    text = re.sub(r"(,)(\D|$)", r" \1 \2", text)
    text = re.sub(r"(\.)([\]\)}>\"\']*)\s*$", r" \1\2 ", text)
    # contractions
    text = re.sub(r"([^' ])('s|'m|'d|'ll|'re|'ve|n't)\b", r"\1 \2 ", text, flags=re.I)
    for pat in _CONTRACTIONS2:
        text = pat.sub(r" \1 \2 ", text)
    return text.split()


def word_tokenize(sentence: str) -> List[str]:
    text = sentence.strip().lower()
    if _NLTK_TOKENIZER is not None:
        return _NLTK_TOKENIZER.tokenize(text)
    return _fallback_tokenize(text)
