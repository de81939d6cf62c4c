"""The text side of C-FedRAG, written out plainly for the reference.

A frozen copy of what the served system does to text: the hash
tokenizer (a word's id is the blake2s hash of the lower-cased word,
folded into the vocabulary above the eight special ids), the prompt
grammar ``[BOS] CTX chunk SEP chunk SEP ... QRY query ANS`` with its
fixed query reserve, and the cross encoder's ``[query] SEP [chunk] EOS``
pair layout.  It imports nothing of the program: the reference works the
chunk tokens, the prompts and the rerank pairs out again from the raw
text that the benchmark generated.
"""
from __future__ import annotations

import hashlib

import numpy as np

PAD, BOS, EOS, SEP, MASK, QRY, CTX, ANS = 0, 1, 2, 3, 4, 5, 6, 7
N_SPECIAL = 8
QUERY_MAX_LEN = 24  # the orchestrator's query encoding for retrieval and rerank
QUERY_RESERVE = 32  # prompt positions kept for the query, whatever its length
PAIR_MAX_LEN = 64  # the cross encoder's packed pair


def word_id(word: str, vocab_size: int) -> int:
    h = hashlib.blake2s(word.lower().encode(), digest_size=4).digest()
    return int.from_bytes(h, "little") % (vocab_size - N_SPECIAL) + N_SPECIAL


def encode_ids(ids: list[int], max_len: int | None = None, bos: bool = True) -> np.ndarray:
    """Word ids -> ``[BOS] ids [EOS]``, cut or PAD-filled to ``max_len``."""
    out = ([BOS] if bos else []) + list(ids) + [EOS]
    if max_len is not None:
        out = out[:max_len] + [PAD] * max(0, max_len - len(out))
    return np.asarray(out, np.int32)


def build_prompt(chunk_rows, query_ids: list[int], max_len: int) -> np.ndarray:
    """The ranked chunks' tokens (PAD / BOS / EOS dropped), each followed by
    SEP while the chunk budget lasts, then QRY, the query cut at the tail,
    and ANS.  The budget keeps ``QUERY_RESERVE`` positions whatever the
    query, so prompts over one context agree up to QRY."""
    n_markers = 4
    reserve = min(QUERY_RESERVE, max(0, (max_len - n_markers) // 2))
    budget = max_len - n_markers - reserve
    ids = [BOS, CTX]
    for row in chunk_rows:
        chunk = [int(t) for t in row if t not in (PAD, BOS, EOS)]
        if len(chunk) + 1 > budget:
            break
        ids += chunk
        ids.append(SEP)
        budget -= len(chunk) + 1
    ids.append(QRY)
    ids += list(query_ids)[: max(0, max_len - len(ids) - 1)]
    ids.append(ANS)
    return np.asarray(ids, np.int32)


def pack_pairs(query_row: np.ndarray, chunk_rows: np.ndarray, max_len: int = PAIR_MAX_LEN):
    """(tokens, type ids), each (C, max_len): ``query SEP chunk EOS`` with
    the query's PAD and EOS and the chunk's PAD dropped; type 1 marks the
    chunk's part."""
    q = [int(t) for t in query_row if t != PAD and t != EOS]
    toks = np.full((len(chunk_rows), max_len), PAD, np.int32)
    types = np.zeros((len(chunk_rows), max_len), np.int32)
    for i, row in enumerate(chunk_rows):
        d = [int(t) for t in row if t != PAD]
        ids = (q + [SEP] + d + [EOS])[:max_len]
        toks[i, : len(ids)] = ids
        types[i, min(len(q) + 1, max_len) : len(ids)] = 1
    return toks, types
