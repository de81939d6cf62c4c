"""Deterministic hash tokenizer (offline stand-in for the paper's HF
tokenizers).  Stable across processes (no PYTHONHASHSEED dependence)."""
from __future__ import annotations

import hashlib

import numpy as np

PAD, BOS, EOS, SEP, MASK, QRY, CTX, ANS = 0, 1, 2, 3, 4, 5, 6, 7
N_SPECIAL = 8


class HashTokenizer:
    def __init__(self, vocab_size: int = 8192):
        assert vocab_size > N_SPECIAL
        self.vocab_size = vocab_size

    def token(self, word: str) -> int:
        h = hashlib.blake2s(word.lower().encode(), digest_size=4).digest()
        return int.from_bytes(h, "little") % (self.vocab_size - N_SPECIAL) + N_SPECIAL

    def encode(self, text: str, max_len: int | None = None, bos: bool = True) -> np.ndarray:
        ids = [BOS] if bos else []
        ids += [self.token(w) for w in text.split()]
        ids.append(EOS)
        if max_len is not None:
            ids = ids[:max_len] + [PAD] * max(0, max_len - len(ids))
        return np.asarray(ids, np.int32)

    def encode_pair(self, query: str, doc: str, max_len: int):
        """[BOS] query [SEP] doc [EOS] + type ids (cross-encoder input)."""
        q = [BOS] + [self.token(w) for w in query.split()] + [SEP]
        d = [self.token(w) for w in doc.split()] + [EOS]
        ids = (q + d)[:max_len]
        types = ([0] * len(q) + [1] * len(d))[:max_len]
        pad = max_len - len(ids)
        return (
            np.asarray(ids + [PAD] * pad, np.int32),
            np.asarray(types + [0] * pad, np.int32),
        )
