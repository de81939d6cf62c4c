"""Host data pipeline: a deterministic, checkpointable LM batch stream.

``LMBatchStream`` serves next-token-prediction batches as numpy arrays
(``tokens`` (B, S) and ``targets`` (B, S), -1 where unsupervised) from a
synthetic source; its state is just (seed, step), so a checkpoint restart
resumes the exact stream.  A copy of the reference's stream: the same
seed gives the same tokens.  The caller moves a batch to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer


@dataclasses.dataclass
class StreamState:
    seed: int
    step: int


class LMBatchStream:
    """Deterministic synthetic LM stream.  Mixes (a) random token spans and
    (b) retrieval-style "context + query -> answer copy" sequences so a small
    model trained on it learns the copy/grounding behaviour RAG needs."""

    def __init__(
        self,
        batch: int,
        seq_len: int,
        vocab_size: int,
        seed: int = 0,
        copy_task_frac: float = 0.5,
        markov: bool = True,
        tokenizer: HashTokenizer | None = None,
    ):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab_size
        self.state = StreamState(seed=seed, step=0)
        self.copy_frac = copy_task_frac
        self.markov = markov and vocab_size <= 8192  # table is vocab^2
        self._cum_p: np.ndarray | None = None
        self.tok = tokenizer or HashTokenizer(vocab_size)

    def _markov_row(self, rng: np.random.Generator) -> np.ndarray:
        """Sample from a fixed random bigram language (seed-determined
        256x256-ish transition table): learnable structure whose achievable
        CE is bounded by model capacity — the Table-2 ablation signal."""
        if self._cum_p is None:
            rng0 = np.random.default_rng(self.state.seed + 99991)
            logits = rng0.normal(size=(self.vocab, self.vocab)) * 2.0
            p = np.exp(logits - logits.max(1, keepdims=True))
            p /= p.sum(1, keepdims=True)
            self._cum_p = p.cumsum(1)
        toks = np.empty(self.seq_len + 1, np.int64)
        toks[0] = rng.integers(8, self.vocab)
        u = rng.random(self.seq_len)
        for t in range(self.seq_len):
            toks[t + 1] = min(np.searchsorted(self._cum_p[toks[t]], u[t]), self.vocab - 1)
        return toks.astype(np.int32)

    def _copy_example(self, rng: np.random.Generator) -> np.ndarray:
        """[CTX] w.. SEP val w.. [QRY] ANS -> val: fetch the token after the
        (fixed) SEP marker from context — the minimal retrieval-grounding
        behaviour (find the relevant span, extract the answer), learnable in
        a few hundred steps unlike full induction-copy."""
        from repro_torch.data.tokenizer import ANS, BOS, CTX, EOS, QRY, SEP

        s = self.seq_len + 1
        n_ctx = int(rng.integers(s // 4, s // 2))
        ctx = rng.integers(8, self.vocab, size=n_ctx)
        key_pos = int(rng.integers(1, n_ctx - 2))
        ctx[key_pos] = SEP  # fixed marker
        val_tok = int(ctx[key_pos + 1])
        seq = [BOS, CTX, *ctx.tolist(), QRY, ANS, val_tok, EOS]
        seq = seq[:s] + [0] * max(0, s - len(seq))
        return np.asarray(seq, np.int32)

    def next(self) -> dict[str, np.ndarray]:
        from repro_torch.data.tokenizer import QRY

        rng = np.random.default_rng((self.state.seed, self.state.step))
        self.state.step += 1
        rows, masks = [], []
        for i in range(self.batch):
            if rng.random() < self.copy_frac:
                from repro_torch.data.tokenizer import ANS

                row = self._copy_example(rng)
                # supervise exactly the grounded-answer position (the token
                # predicted at ANS): filler/PAD positions would otherwise
                # dominate the gradient and drown the copy signal
                m = np.zeros(self.seq_len, bool)
                apos = np.where(row[:-1] == ANS)[0]
                if len(apos):
                    m[apos[0]] = True
                masks.append(m)
                rows.append(row)
            elif self.markov:
                rows.append(self._markov_row(rng))
                masks.append(np.ones(self.seq_len, bool))
            else:
                rows.append(rng.integers(8, self.vocab, size=self.seq_len + 1).astype(np.int32))
                masks.append(np.ones(self.seq_len, bool))
        arr = np.stack(rows)
        targets = arr[:, 1:].copy()
        targets[~np.stack(masks)] = -1
        return {"tokens": arr[:, :-1], "targets": targets}

    # --- checkpointable iterator state ---
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict):
        self.state = StreamState(**d)
