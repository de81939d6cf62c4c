"""The one generator of the benchmark's inputs: corpus and questions.

Everything comes from a configuration file (the corpus: its sites,
their sub-corpora and shares, chunk lengths, the word pool) and a
traffic file (the question sets and their lengths, the answer budgets),
both plain data, and from the run's seed.  The seed chooses the content:
every word of the corpus and of the questions, which chunk sits where,
the order of the batch, and (in ``system``) the weights.  The *work*
does not move with it: chunk and question lengths and answer budgets
are stratified multisets, the same for every seed.

Texts are kept twice: as strings for the program and as word-index
arrays, from which the reference works out the tokens itself.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np


def rng(seed: int, tag: str) -> np.random.Generator:
    """An independent stream of the run's seed for one purpose."""
    h = int.from_bytes(hashlib.blake2s(tag.encode(), digest_size=8).digest(), "little")
    return np.random.default_rng([int(seed) % (1 << 64), h])


def torch_seed(seed: int, tag: str) -> int:
    return int(rng(seed, tag).integers(0, 1 << 62))


def stratified_uniform_ints(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)


def stratified_loguniform_ints(n: int, lo: int, hi: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))).astype(np.int64)


def largest_remainder(n: int, p: np.ndarray) -> np.ndarray:
    """Integer counts summing to n, as near to n * p as integers go."""
    raw = n * np.asarray(p, np.float64) / np.sum(p)
    counts = np.floor(raw).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(-(raw - counts), kind="stable")[:rest]] += 1
    return counts


@dataclasses.dataclass
class Texts:
    """Word-index rows (ragged, as a flat array and offsets) and their strings."""

    flat: np.ndarray
    offsets: np.ndarray
    strings: list[str]

    def words(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i] : self.offsets[i + 1]]

    def __len__(self) -> int:
        return len(self.strings)


def word_pool(n: int) -> list[str]:
    """The vocabulary the texts draw from: n distinct made-up words."""
    return [f"w{np.base_repr(i, 36).lower()}" for i in range(n)]


def _texts(pool: list[str], p: np.ndarray, lengths: np.ndarray, g: np.random.Generator) -> Texts:
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat = g.choice(len(pool), size=int(offsets[-1]), p=p).astype(np.int32)
    arr = np.asarray(pool, dtype=object)
    strings = [" ".join(arr[flat[offsets[i] : offsets[i + 1]]]) for i in range(len(lengths))]
    return Texts(flat, offsets, strings)


def _zipf(n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


@dataclasses.dataclass
class Corpus:
    texts: Texts
    site: np.ndarray  # (N,) site of each chunk
    sub: list[str]  # sub-corpus of each chunk
    pool: list[str]
    p: np.ndarray  # word frequencies


def make_corpus(corpus_cfg: dict, seed: int) -> Corpus:
    """Every site holds ``chunks_per_site`` chunks, split over its
    sub-corpora by their shares, each chunk ``words[0]``-``words[1]`` words
    long.  Chunk ``i`` is chunk id ``i``; sites follow one another."""
    pool = word_pool(corpus_cfg["word_pool"])
    p = _zipf(len(pool), corpus_cfg["word_zipf_s"])
    n_site = corpus_cfg["chunks_per_site"]
    lo, hi = corpus_cfg["words"]
    g = rng(seed, "corpus")
    sites, subs, lengths = [], [], []
    for s, members in enumerate(corpus_cfg["sites"]):
        counts = largest_remainder(n_site, np.asarray([m["share"] for m in members]))
        names = np.repeat([m["name"] for m in members], counts)
        ln = stratified_uniform_ints(n_site, lo, hi)
        order = g.permutation(n_site)
        sites.append(np.full(n_site, s))
        subs.extend(names[order].tolist())
        lengths.append(ln[g.permutation(n_site)])
    texts = _texts(pool, p, np.concatenate(lengths), g)
    return Corpus(texts, np.concatenate(sites), subs, pool, p)


@dataclasses.dataclass
class Schedule:
    """What the window is offered: every question ``qid[i]`` at once, with
    answer budget ``budget[i]``."""

    questions: Texts
    qid: np.ndarray
    budget: np.ndarray


def n_requests(traffic: dict) -> int:
    """How many requests a run offers: every question of the sets once."""
    return int(sum(s["count"] for s in traffic["question_sets"]))


def _question_lengths(traffic: dict, n: int, g: np.random.Generator) -> np.ndarray:
    sets = traffic["question_sets"]
    lengths = np.concatenate([stratified_uniform_ints(int(s["count"]), *s["words"]) for s in sets])
    return lengths[g.permutation(n)]


def _budgets(traffic: dict, n: int, g: np.random.Generator) -> np.ndarray:
    ans = traffic["answer_tokens"]
    if ans["dist"] == "fixed":
        return np.full(n, int(ans["tokens"]))
    if ans["dist"] == "loguniform":
        return stratified_loguniform_ints(n, ans["lo"], ans["hi"])[g.permutation(n)]
    raise ValueError(f"answer distribution {ans['dist']!r}")


def make_schedule(traffic: dict, corpus: Corpus, seed: int) -> Schedule:
    """An offline batch: every question of the sets once, its words, its
    place in the batch and its budget's place from the seed."""
    if traffic["loop"] != "offline" or traffic["popularity"]["kind"] != "unique":
        raise ValueError("the generator makes offline batches of unique questions")
    g = rng(seed, "traffic")
    n = n_requests(traffic)
    questions = _texts(corpus.pool, corpus.p, _question_lengths(traffic, n, g), g)
    return Schedule(questions, np.arange(n), _budgets(traffic, n, g).astype(np.int64))
