"""RAG serving engine: continuous batching over a contiguous or paged KV
cache, and the lock-step baseline.

Serving modes (all share the slot-state contract):

  * **Lock-step** (``step_batch``): drain the queue in fixed ``max_batch``
    chunks, one packed prefill + one decode loop per chunk.  The
    deterministic baseline the continuous paths are held against.  Always
    contiguous.
  * **Continuous, contiguous** (``paged=False``, the default): a fixed
    pool of ``max_batch`` decode slots over per-slot cache stripes of
    ``max_prompt_len + max_new_tokens`` positions.  Finished rows (EOS or
    per-request budget) retire and free their slot; queued requests are
    admitted into free slots in power-of-2 groups, each group ONE packed
    prefill (``LM.prefill``, whose attention runs through
    ``kernels/flash_attention``) scattered into the groups' stripes, so
    ``k`` waiting requests cost ``O(log k)`` admit dispatches.  Decode runs
    in fused chunks of at most ``sched_chunk`` steps.
    ``admit_dispatches`` and ``decode_dispatches`` count the two.
  * **Continuous, paged** (``paged=True``): every engine step with a
    prompt chunk in flight is ONE ``mixed_step`` over per-row
    ``(q_start, q_len)`` descriptors: decode rows take one query lane
    each, and the prompts of admitted requests stream in FIFO through the
    remaining lanes of the ``token_budget``, so a long prompt never stalls
    the rows already decoding.  When no prompt is in flight, the loop runs
    a fused decode chunk of up to ``sched_chunk`` ``decode_step``s
    instead.  ``mixed_dispatches`` and ``decode_dispatches`` count the
    two.

Paged memory: attention K/V live in one pool of ``n_pool_blocks`` blocks
of ``block_size`` tokens (plus a trash block that unallocated table
entries and dead lanes point at), addressed through per-slot block
tables.  A request is admitted only while free blocks cover its prompt
and first decode token; tables grow at step boundaries; a row that cannot
grow is force-retired ``truncated`` with what it has emitted, and its
neighbours are unharmed.  ``AdmissionDeadlock`` is the typed stall of the
fill dependency resolver: the stuck rows retire empty and ``deadlocked``.
The pool, tables and device cache are resident: created on first use and
kept across ``serve`` calls until ``reset_cache``.  The contiguous cache
is made anew by each serve call.

Prefix cache (``prefix_cache=True``, paged only): a ``PrefixIndex`` over
``block_size``-token prompt chunks lets a request adopt the pool blocks
of a cached prefix by reference and prefill only its suffix.  A full hit
ending on a block boundary copies the boundary block first (copy on
write, ``LM.paged_copy_block``) so the last prompt token's K/V write
never mutates a shared block.  Chunks another in-flight fill has
registered but not yet written sit in ``pending_blocks``; a request that
shares them waits until the owner's dispatch has written them.  Retired
chains stay parked in the pool for the next serve.  With ``spill_bytes``
the parked chains that pool pressure evicts are demoted to a host tier
(``HostBlockStore``) and re-admitted by upload instead of re-prefill.

Speculative decoding (``draft_k > 0``, paged only): a drafter model (the
target itself by default, or ``draft_config`` / ``draft_params``) keeps
its own resident ``BlockPool``, tables and paged cache, of the target
pool's block geometry and with no prefix index, and re-prefills every
prompt through its own fill lanes.  A round is at most two dispatches: one
drafter dispatch (its fill chunks, then ``draft_k`` greedy q_len=1 mixed
steps and a trailing write-only step for the k-th proposal's K/V) and one
target ``verify_step`` whose verify rows ``(q_start = lengths + emitted -
1, q_len <= draft_k + 1)`` ride beside the fill chunks.  ``accept_prefix``
commits the longest run of drafts that match the target's per-lane
argmaxes plus one target token, so the tokens are plain greedy decode's.
A drafter-pool OOM drops the row's drafter chain; the row keeps verifying
(garbage drafts are accepted only where they match).  The gauges
``draft_dispatches``, ``draft_fill_dispatches``, ``spec_rounds`` and
``spec_tokens_{proposed,accepted,emitted}`` feed the scheduler's accept
rate, tokens per round and dispatches per round.

Both layouts give the same tokens for the same admission order.  An
all-Mamba2 model (``ssm`` family) serves on the contiguous path and the
lock-step baseline, whose admit prefills carry its conv and SSM state into
the slot; the paged path refuses it, as the reference's does.  The
sharded pool of the JAX package's engine is not ported yet and raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.models import lm as LM
from repro_torch.models.layers import torch_dtype
from repro_torch.serving.kv_cache import BlockPool, BlockTable, HostBlockStore, PrefixIndex, blocks_for
from repro_torch.serving.scheduler import Request, Scheduler


class AdmissionDeadlock(RuntimeError):
    """Admission dependency resolution stalled: some admitted rows wait on
    cached chunks that no in-flight fill is going to materialize.  The
    engine force-retires the stuck rows with an empty, ``deadlocked``
    result instead of wedging the serve loop."""

    def __init__(self, waves: list, stuck: list):
        super().__init__(
            f"admission dependency resolution stalled: {len(stuck)} row(s) wait "
            f"on cached chunks no in-flight fill writes (cyclic prefix deps?)"
        )
        self.waves = waves
        self.stuck = stuck


def accept_prefix(draft, target, *, q_len=None, rem=None, done=None, eos=EOS):
    """Greedy draft-k / verify-1 acceptance.  ``draft`` (B, k) holds the
    drafter's proposals, ``target`` (B, k + 1) the target's per-lane
    argmaxes (lane ``j`` is the target's next token after the row emitted
    ``target[:j]``).  Lane ``j`` commits iff every draft before it matched,
    no earlier lane was EOS, and the optional caps hold: ``j < q_len``
    (live verify lanes), ``j < rem`` (remaining budget), not ``done``.
    Every mask is prefix-monotone, so the committed lanes are the run
    ``target[:n_emit]``, what plain greedy decode emits one at a time.
    Integer tensors (or arrays) in; returns ``(n_emit (B,) int32, can
    (B, k + 1) bool)`` on the draft's device."""
    d = torch.as_tensor(draft)
    dev = d.device
    t = torch.as_tensor(target, device=dev)
    b, k = d.shape
    j = torch.arange(k + 1, device=dev)
    one = torch.ones((b, 1), dtype=torch.int32, device=dev)
    ok = torch.cumprod(torch.cat([one, (d == t[:, :k]).to(torch.int32)], dim=1), dim=1).bool()
    no_eos = torch.cumprod(torch.cat([one, (t[:, :k] != eos).to(torch.int32)], dim=1), dim=1).bool()
    can = ok & no_eos
    if q_len is not None:
        can = can & (j[None, :] < torch.as_tensor(q_len, device=dev)[:, None])
    if rem is not None:
        can = can & (j[None, :] < torch.as_tensor(rem, device=dev)[:, None])
    if done is not None:
        can = can & ~torch.as_tensor(done, device=dev)[:, None]
    return can.sum(dim=1).to(torch.int32), can


def resolve_fill_deps(fill_deps: dict[int, frozenset], pending) -> list[int]:
    """Runnable in-flight fills: those none of whose dependency blocks is
    still pending.  Raises :class:`AdmissionDeadlock` when fills exist but
    none can run."""
    pending = set(pending)
    runnable = [i for i, deps in sorted(fill_deps.items()) if not (deps & pending)]
    if fill_deps and not runnable:
        raise AdmissionDeadlock([], sorted(fill_deps))
    return runnable


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8  # decode slots (continuous) / chunk size (lock-step)
    max_prompt_len: int = 512
    max_new_tokens: int = 16  # hard cap; per-request budgets clamp to this
    sched_chunk: int = 8  # max fused decode steps between scheduler runs
    paged: bool = False  # paged KV cache (block pool) vs contiguous stripes
    block_size: int = 32  # tokens per KV block (paged mode)
    # pool size in blocks; None -> max_batch full-length requests
    n_pool_blocks: int | None = None
    prefix_cache: bool = False  # refcounted prefix cache (paged only)
    # query lanes per mixed step (paged only); None -> max_prompt_len (a
    # whole prompt may prefill in one step)
    token_budget: int | None = None
    # host spill tier for the prefix cache, in bytes (None -> no tier)
    spill_bytes: int | None = None
    # speculative decoding (paged only): drafter proposals per decode row
    # and round, verified in the target's one mixed dispatch; 0 is off
    draft_k: int = 0
    # the drafter's architecture and parameters; None -> the target's own
    # (self-speculation).  draft_config needs draft_params and the target's
    # vocabulary, and must be all-attention
    draft_config: ModelConfig | None = None
    draft_params: object | None = None
    shards: int | None = None  # sharded pool: not ported yet


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet; it comes with the "
        f"{slice_name} slice of the port"
    )


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine: device='cuda' asked for but no CUDA device is present")
        if scfg.prefix_cache and not scfg.paged:
            raise ValueError(
                "prefix_cache=True requires paged=True: block tables are "
                "what make prompt prefixes shareable"
            )
        if scfg.spill_bytes is not None:
            if not scfg.prefix_cache:
                raise ValueError(
                    "spill_bytes (host spill tier) requires prefix_cache=True: "
                    "only cached prefix chains are demotable"
                )
            if scfg.spill_bytes < 1:
                raise ValueError(f"spill_bytes={scfg.spill_bytes} must be >= 1")
        if scfg.shards is not None:
            raise _not_ported("the sharded KV pool (shards)", "multi-device")
        if scfg.paged and any(cfg.mixer_kind(i) != "attn" for i in range(cfg.n_layers)):
            raise ValueError(
                "paged serving runs the unified chunked-prefill path, which "
                "requires an all-attention model: SSM/conv state folds the "
                "whole sequence and cannot resume a chunked prompt"
            )
        if scfg.token_budget is not None:
            if scfg.token_budget < 1:
                raise ValueError(f"token_budget={scfg.token_budget} must be >= 1")
            if not scfg.paged:
                raise ValueError(
                    "token_budget (unified chunked prefill) requires paged=True: "
                    "mixed dispatches read and write K/V through the shared block pool"
                )
        self.cfg, self.scfg = cfg, scfg
        self.params = params.tree() if isinstance(params, torch.nn.Module) else params
        cache_len = scfg.max_prompt_len + scfg.max_new_tokens
        self._cache_len = cache_len
        bs = scfg.block_size
        self._blocks_per_slot = blocks_for(cache_len, bs)
        self._cache_len_padded = self._blocks_per_slot * bs
        if scfg.paged:
            n_pool = (
                scfg.n_pool_blocks if scfg.n_pool_blocks is not None
                else scfg.max_batch * self._blocks_per_slot
            )
            if n_pool < self._blocks_per_slot:
                raise ValueError(
                    f"n_pool_blocks={n_pool} cannot hold one max-size request "
                    f"({self._blocks_per_slot} blocks of {bs})"
                )
            self._n_pool_blocks = n_pool
            self._trash_block = n_pool  # extra pool index for masked writes
        self._token_budget = (
            scfg.token_budget if scfg.token_budget is not None else scfg.max_prompt_len
        )
        if scfg.draft_k < 0:
            raise ValueError(f"draft_k={scfg.draft_k} must be >= 0")
        if scfg.draft_k > 0:
            if not scfg.paged:
                raise ValueError(
                    "draft_k (speculative decoding) requires paged=True: the "
                    "verify dispatch reads and writes K/V through the shared "
                    "block pool"
                )
            if self._token_budget < scfg.draft_k + 1:
                raise ValueError(
                    f"token_budget={self._token_budget} cannot fit one verify "
                    f"descriptor of q_len={scfg.draft_k + 1} (draft_k + 1)"
                )
            if scfg.draft_config is not None and scfg.draft_params is None:
                raise ValueError(
                    "draft_config without draft_params: a drafter with its "
                    "own architecture needs its own weights"
                )
            dcfg = scfg.draft_config if scfg.draft_config is not None else cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"drafter vocab_size={dcfg.vocab_size} != target "
                    f"vocab_size={cfg.vocab_size}: greedy accept-prefix "
                    "compares token ids across the two models"
                )
            if any(dcfg.mixer_kind(i) != "attn" for i in range(dcfg.n_layers)):
                raise ValueError(
                    "draft_config must be all-attention: the drafter decodes "
                    "through its own paged pool"
                )
            dparams = scfg.draft_params if scfg.draft_params is not None else self.params
            self._draft_cfg = dcfg
            self._draft_params = dparams.tree() if isinstance(dparams, torch.nn.Module) else dparams
        # dispatch observability: fused admit prefills (contiguous), fused
        # decode chunks and unified mixed steps (paged)
        self.admit_dispatches = 0
        self.admit_rows_total = 0
        self.decode_dispatches = 0
        self.mixed_dispatches = 0
        # prefix-cache gauges (engine lifetime; each serve reports its
        # window's deltas and these totals to the scheduler)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_total = 0
        self.prefill_tokens_saved = 0
        self.prefix_shared_total = 0  # blocks adopted by reference
        # speculative-decoding gauges (engine lifetime): at most one drafter
        # dispatch and one verify dispatch per round; the accept rate and
        # tokens per round derive from the three token tallies
        self.draft_dispatches = 0
        self.draft_fill_dispatches = 0  # drafter prefill only (admission cost)
        self.spec_rounds = 0
        self.spec_tokens_proposed = 0
        self.spec_tokens_accepted = 0
        self.spec_tokens_emitted = 0
        self.queue: list[np.ndarray] = []  # lock-step requests (submit / step_batch)
        self._pool: BlockPool | None = None
        self._row_tables: list[BlockTable] | None = None
        self._tables_h: np.ndarray | None = None
        self._cache = None
        self._index: PrefixIndex | None = None
        self._spill_store: HostBlockStore | None = None
        # the drafter's resident pool, tables and paged cache (draft_k > 0)
        self._draft_pool: BlockPool | None = None
        self._draft_row_tables: list[BlockTable] | None = None
        self._draft_tables_h: np.ndarray | None = None
        self._draft_cache = None
        self._serving = False

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _mixed_rows(self, st, tok, q_start_h, q_len, is_decode, row_len, b_new, tables):
        """ONE unified engine step: every row (mid-prompt fill, fill
        completion, or 1-token decode) advances through a single
        ``mixed_step``.  Decode rows read their token from ``cur`` at
        position ``lengths + emitted - 1``; a fill row touches slot state
        only on the chunk that reaches ``row_len`` (``completes``), which
        seeds the slot with the chunk's last-lane argmax.  Rows with
        ``q_len == 0`` are inert."""
        cur, lengths, emitted, done, budget, out = st
        b, t_cap = self.scfg.max_batch, self.scfg.max_new_tokens
        rows = torch.arange(b, device=self.device)
        q_start = torch.where(is_decode, lengths + emitted - 1, q_start_h)
        tok[:, 0] = torch.where(is_decode, cur, tok[:, 0])
        logits = LM.mixed_step(
            self.cfg, self.params, tok, self._cache, tables, q_start, q_len, self.scfg.block_size
        )
        last = logits[rows, torch.clamp(q_len - 1, min=0).long()]
        nxt = torch.argmax(last, -1).to(torch.int32)
        completes = (~is_decode) & (q_len > 0) & (q_start + q_len >= row_len)
        emit_dec = is_decode & (q_len > 0) & ~done
        idx = torch.clamp(emitted, max=t_cap).long()
        out[rows, idx] = torch.where(emit_dec, nxt, out[rows, idx])
        seeded = torch.zeros_like(out)
        seeded[:, 0] = nxt
        out = torch.where(completes[:, None], seeded, out)
        cur = torch.where(completes | emit_dec, nxt, cur)
        lengths = torch.where(completes, row_len, lengths)
        budget = torch.where(completes, b_new, budget)
        emitted = torch.where(completes, torch.ones_like(emitted), emitted + emit_dec.to(torch.int32))
        done = torch.where(
            completes,
            (nxt == EOS) | (b_new <= 1),
            done | (emit_dec & ((nxt == EOS) | (emitted >= budget))),
        )
        return cur, lengths, emitted, done, budget, out

    def _spec_mixed_rows(self, st, tok, q_start_h, q_len, is_spec, drafts, row_len, b_new, tables):
        """ONE target step in speculative mode: fill chunks advance as in
        ``_mixed_rows``; each speculating row (``is_spec``) is a verify row
        from ``q_start = lengths + emitted - 1`` whose lane 0 carries
        ``cur`` and lanes 1..q_len-1 the drafts.  The per-lane argmaxes go
        through ``accept_prefix``, and the committed run lands at the row's
        own ``emitted`` offsets.  Rollback is positional: only ``emitted``
        advances, and the next window rewrites every rejected position
        before any lane reads it."""
        cur, lengths, emitted, done, budget, out = st
        b, t_cap, kd = self.scfg.max_batch, self.scfg.max_new_tokens, self.scfg.draft_k
        rows = torch.arange(b, device=self.device)
        q_start = torch.where(is_spec, lengths + emitted - 1, q_start_h)
        tok[:, 0] = torch.where(is_spec, cur, tok[:, 0])
        tok[:, 1 : kd + 1] = torch.where(is_spec[:, None], drafts, tok[:, 1 : kd + 1])
        logits = LM.verify_step(
            self.cfg, self.params, tok, self._cache, tables, q_start, q_len, self.scfg.block_size
        )
        # fill rows: the next token off the chunk's last live lane
        nxt = torch.argmax(logits[rows, torch.clamp(q_len - 1, min=0).long()], -1).to(torch.int32)
        completes = (~is_spec) & (q_len > 0) & (q_start + q_len >= row_len)
        # verify rows: per-lane targets, greedy accept-prefix
        tgt = torch.argmax(logits[:, : kd + 1, :], -1).to(torch.int32)
        n_emit, can = accept_prefix(drafts, tgt, q_len=q_len, rem=budget - emitted, done=done)
        n_emit = torch.where(is_spec, n_emit, torch.zeros_like(n_emit))
        can = can & is_spec[:, None]
        # a lane clamped to the spare column t_cap never commits (j < rem),
        # so every write there puts back the value it read
        j = torch.arange(kd + 1, device=self.device)
        idx = torch.clamp(emitted[:, None] + j[None, :], max=t_cap).long()
        keep = out[rows[:, None], idx]
        out[rows[:, None], idx] = torch.where(can, tgt, keep)
        seeded = torch.zeros_like(out)
        seeded[:, 0] = nxt
        out = torch.where(completes[:, None], seeded, out)
        last_emit = torch.gather(tgt, 1, torch.clamp(n_emit - 1, min=0).long()[:, None])[:, 0]
        cur = torch.where(n_emit > 0, last_emit, cur)
        cur = torch.where(completes, nxt, cur)
        lengths = torch.where(completes, row_len, lengths)
        budget = torch.where(completes, b_new, budget)
        emitted = torch.where(completes, torch.ones_like(emitted), emitted + n_emit)
        done = torch.where(
            completes,
            (nxt == EOS) | (b_new <= 1),
            done | ((n_emit > 0) & ((last_emit == EOS) | (emitted >= budget))),
        )
        return cur, lengths, emitted, done, budget, out

    def _draft_tokens(self, cur, dec_pos, d_dec_tables):
        """The drafter's ``draft_k`` greedy proposals per row (B, draft_k):
        q_len=1 mixed steps from ``dec_pos`` (each writes the fed token's
        K/V, then attends), then a trailing write-only step for the k-th
        proposal's K/V: a full accept moves the committed position past it,
        and a hole there would corrupt every later draft of the row.  Rows
        with an all-trash ``d_dec_tables`` row write into the trash block."""
        b, kd, bs = self.scfg.max_batch, self.scfg.draft_k, self.scfg.block_size
        dcfg, dparams, dcache = self._draft_cfg, self._draft_params, self._draft_cache
        one = torch.ones((b,), dtype=torch.int32, device=self.device)
        drafts = torch.zeros((b, max(kd, 1)), dtype=torch.int32, device=self.device)
        tok = cur
        for t in range(kd):
            logits = LM.mixed_step(dcfg, dparams, tok[:, None], dcache, d_dec_tables, dec_pos + t, one, bs)
            tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)
            drafts[:, t] = tok
        LM.mixed_step(dcfg, dparams, tok[:, None], dcache, d_dec_tables, dec_pos + kd, one, bs)
        return drafts

    def _draft_rows(self, d_tok, d_q_start, d_q_len, cur, dec_pos, d_tables, d_dec_tables):
        """The drafter's fill chunks (rows still streaming their prompt into
        the drafter pool; q_len == 0 rows are inert), then ``_draft_tokens``:
        one drafter dispatch."""
        LM.mixed_step(self._draft_cfg, self._draft_params, d_tok, self._draft_cache, d_tables,
                      d_q_start, d_q_len, self.scfg.block_size)
        return self._draft_tokens(cur, dec_pos, d_dec_tables)

    def _decode_chunk(self, st, n_steps: int, cache, tables=None):
        """Fused decode of up to ``n_steps`` tokens across all slots, until
        every row is done, over the contiguous ``cache`` or (with
        ``tables``) the paged pool.  Tokens go to a dense (B, sched_chunk)
        buffer by step; the ragged merge into each row's own ``[emitted0,
        emitted)`` output span happens once per chunk."""
        cur, lengths, emitted, done, budget, out = st
        b, t_cap, sc = self.scfg.max_batch, self.scfg.max_new_tokens, self.scfg.sched_chunk
        rows = torch.arange(b, device=self.device)
        chunk = torch.zeros((b, sc), dtype=torch.int32, device=self.device)
        emitted0 = emitted
        for t in range(n_steps):
            if bool(done.all()):
                break
            logits = LM.decode_step(
                self.cfg, self.params, cache, cur[:, None], lengths + emitted - 1,
                block_tables=tables, block_size=self.scfg.block_size,
            )
            nxt = torch.argmax(logits[:, -1, :], -1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, PAD), nxt)
            chunk[:, t] = nxt
            emitted = emitted + (~done).to(torch.int32)
            done = done | (nxt == EOS) | (emitted >= budget)
            cur = nxt
        j = torch.arange(sc, device=self.device)
        idx = torch.clamp(emitted0[:, None] + j[None, :], max=t_cap).long()
        valid = j[None, :] < (emitted - emitted0)[:, None]
        keep = out[rows[:, None], idx]
        out[rows[:, None], idx] = torch.where(valid, chunk, keep)
        return cur, lengths, emitted, done, budget, out

    def _prefill(self, tokens, lengths):
        """Packed prefill into a fresh contiguous cache of ``cache_len``
        positions per row; returns (each row's first token, taken at its
        own last prompt position, and the cache)."""
        logits, cache = LM.prefill(self.cfg, self.params, {"tokens": tokens}, cache_len=self._cache_len)
        last = logits[torch.arange(tokens.shape[0], device=self.device), (lengths - 1).long()]
        return torch.argmax(last, -1).to(torch.int32), cache

    def _admit_rows(self, st, cache, rows_tokens, slot_ids, row_lens, b_new):
        """Prefill ``g`` requests and scatter them into contiguous cache
        stripes ``slot_ids`` in one fused call (for a Mamba2 layer, its
        conv histories and SSM state)."""
        cur, lengths, emitted, done, budget, out = st
        first, row_cache = self._prefill(rows_tokens, row_lens)
        sl = slot_ids.long()
        for key, leaves in cache.items():
            for kk, leaf in leaves.items():
                # a Mamba2 layer's "conv" is a tuple of three leaves
                pairs = zip(leaf, row_cache[key][kk]) if isinstance(leaf, tuple) else [(leaf, row_cache[key][kk])]
                for dst, src in pairs:
                    dst[:, sl] = src
        cur[sl] = first
        lengths[sl] = row_lens
        emitted[sl] = 1
        budget[sl] = b_new
        out[sl] = 0
        out[sl, 0] = first
        done[sl] = (first == EOS) | (b_new <= 1)
        return cur, lengths, emitted, done, budget, out

    def _decode_loop(self, cache, first_tok, lengths):
        """Greedy decode of a prefilled batch until every row has emitted
        EOS or ``max_new_tokens``; rows already done emit PAD.  Returns
        (out (B, max_new_tokens), steps taken)."""
        t_max = self.scfg.max_new_tokens
        out = torch.zeros((first_tok.shape[0], t_max), dtype=torch.int32, device=self.device)
        out[:, 0] = first_tok
        cur, done, t = first_tok, first_tok == EOS, 1
        while t < t_max and not bool(done.all()):
            logits = LM.decode_step(self.cfg, self.params, cache, cur[:, None], lengths + t - 1)
            nxt = torch.argmax(logits[:, -1, :], -1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, PAD), nxt)  # finished rows stay PAD
            out[:, t] = nxt
            cur, done, t = nxt, done | (nxt == EOS), t + 1
        return out, t

    # ------------------------------------------------------------------ #
    # lock-step path (deterministic baseline)
    # ------------------------------------------------------------------ #
    def submit(self, prompt_tokens: np.ndarray):
        self.queue.append(np.asarray(prompt_tokens).ravel())

    def _pack(self, prompts: list[np.ndarray]) -> np.ndarray:
        """Left-aligned PAD-tail packing; each row decodes from its own
        length, so ragged rows never attend to PAD keys."""
        width = self.scfg.max_prompt_len
        out = np.zeros((len(prompts), width), np.int32)
        for i, p in enumerate(prompts):
            p = p[-width:]
            out[i, : len(p)] = p
        return out

    def step_batch(self) -> list[np.ndarray]:
        """Serve up to max_batch queued requests; returns answer token rows."""
        if not self.queue:
            return []
        batch, self.queue = self.queue[: self.scfg.max_batch], self.queue[self.scfg.max_batch :]
        lengths = self._dev([min(len(p), self.scfg.max_prompt_len) for p in batch])
        first, cache = self._prefill(self._dev(self._pack(batch)), lengths)
        out, n_steps = self._decode_loop(cache, first, lengths)
        return list(out[:, :n_steps].cpu().numpy())

    # ------------------------------------------------------------------ #
    # resident paged state
    # ------------------------------------------------------------------ #
    def _init_serve_cache(self, device):
        """The continuous path's device cache in the configured layout."""
        dtype = torch_dtype(self.cfg.dtype)
        if self.scfg.paged:
            return LM.init_paged_cache(
                self.cfg, self._n_pool_blocks + 1, self.scfg.block_size, dtype=dtype, device=device
            )
        return LM.init_cache(self.cfg, self.scfg.max_batch, self._cache_len, dtype=dtype, device=device)

    def cache_nbytes(self) -> int:
        """Device bytes of the continuous path's cache (either layout),
        from its shapes alone (built on the meta device)."""
        leaves, todo = [], [self._init_serve_cache("meta")]
        while todo:
            x = todo.pop()
            if isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, tuple):
                todo.extend(x)
            else:
                leaves.append(x)
        return sum(t.numel() * t.element_size() for t in leaves)

    def _pool_leaves(self) -> list[torch.Tensor]:
        """The pool's K/V tensors, ``(n_blocks, n_pool + 1, bs, kv, hd)``
        each, in the cache's key order."""
        return [leaf for sub in self._cache.values() for leaf in (sub["k"], sub["v"])]

    def _fetch_block(self, b: int):
        """Demotion callback of the spill tier: pool block ``b``'s K/V as
        host tensors (one per pool leaf, the pool's own dtype, so a bf16
        pool stays bf16) and their byte count.  The copy is always made (a
        CPU pool's block would otherwise be aliased, not copied); from the
        card it blocks until done and is ordered after every kernel already
        queued on the stream, so the payload holds what the last step wrote
        and the block may be overwritten once this returns."""
        payload = [leaf[:, b].to("cpu", copy=True) for leaf in self._pool_leaves()]
        return payload, int(sum(p.numel() * p.element_size() for p in payload))

    def _upload_block(self, payload, b: int) -> None:
        """Re-admission: a host payload from ``_fetch_block`` lands in pool
        block ``b``, bit for bit.  A ``copy_`` from host memory without
        ``non_blocking`` synchronizes its stream, so the block is written
        before any later dispatch reads it and the payload may be dropped
        on return."""
        for leaf, p in zip(self._pool_leaves(), payload, strict=True):
            if p.dtype != leaf.dtype:
                raise ValueError(f"spill payload of {p.dtype} for a {leaf.dtype} pool")
            leaf[:, b].copy_(p)

    def _ensure_paged_state(self):
        """Create the resident pool, tables, device cache and (with
        ``prefix_cache``) prefix index on first paged use; later serve
        calls reuse them (a warm prefix cache)."""
        if self._pool is not None:
            return
        scfg = self.scfg
        self._pool = BlockPool(self._n_pool_blocks, scfg.block_size)
        self._row_tables = [BlockTable(self._pool) for _ in range(scfg.max_batch)]
        # every unallocated (or free-slot) table entry points at the trash
        # block, so masked writes never land in live blocks
        self._tables_h = np.full(
            (scfg.max_batch, self._blocks_per_slot), self._trash_block, np.int32
        )
        self._cache = self._init_serve_cache(self.device)
        if scfg.draft_k > 0:
            # the drafter's pool: the target's block geometry, no prefix index
            self._draft_pool = BlockPool(self._n_pool_blocks, scfg.block_size)
            self._draft_row_tables = [BlockTable(self._draft_pool) for _ in range(scfg.max_batch)]
            self._draft_tables_h = np.full_like(self._tables_h, self._trash_block)
            self._draft_cache = LM.init_paged_cache(
                self._draft_cfg, self._n_pool_blocks + 1, scfg.block_size,
                dtype=torch_dtype(self._draft_cfg.dtype), device=self.device,
            )
        if scfg.prefix_cache:
            store = HostBlockStore(scfg.spill_bytes) if scfg.spill_bytes is not None else None
            self._spill_store = store
            self._index = PrefixIndex(self._pool, spill_store=store, fetch_block=self._fetch_block)

    def reset_cache(self):
        """Drop all resident paged state: device cache, block pool, prefix
        index, host spill tier and the drafter's pool.  The next serve
        starts cold."""
        if self._serving:
            raise RuntimeError("reset_cache() during an active serve loop")
        self._pool = self._row_tables = self._tables_h = self._cache = None
        self._index = self._spill_store = None
        self._draft_pool = self._draft_row_tables = self._draft_tables_h = self._draft_cache = None

    # ------------------------------------------------------------------ #
    # serving
    # ------------------------------------------------------------------ #
    def serve(self, scheduler: Scheduler) -> dict[int, np.ndarray]:
        """Drive the slot pool until the scheduler's queue drains and every
        slot has retired.  Returns {rid: answer tokens}; per-request
        timestamps land in ``scheduler.results``."""
        return dict(self.serve_stream(scheduler, drain=True))

    def serve_stream(self, scheduler: Scheduler, *, drain: bool = False):
        """Yield ``(rid, answer_tokens)`` as each slot retires.  With
        ``drain=False`` the stream waits for more submissions until the
        scheduler is closed."""
        if self.scfg.paged:
            yield from self._serve_unified(scheduler, drain)
        else:
            yield from self._serve_contiguous(scheduler, drain)

    def _serve_contiguous(self, scheduler: Scheduler, drain: bool):
        """Continuous batching over contiguous cache stripes: the same
        admission order and decode semantics as the paged path, with
        pow-2 bucketed admit prefills."""
        scfg = self.scfg
        B, t_cap, width = scfg.max_batch, scfg.max_new_tokens, scfg.max_prompt_len
        scheduler.begin_window()
        cache = LM.init_cache(self.cfg, B, self._cache_len, dtype=torch_dtype(self.cfg.dtype), device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        st = (
            torch.zeros((B,), **i32),  # cur
            torch.ones((B,), **i32),  # lengths
            torch.ones((B,), **i32),  # emitted
            torch.ones((B,), dtype=torch.bool, device=self.device),  # done: free slots read as done
            torch.ones((B,), **i32),  # budget
            torch.zeros((B, t_cap + 1), **i32),  # out
        )
        slots: list[Request | None] = [None] * B
        # host mirrors keep the loop at one device sync per chunk; a
        # just-admitted row's done flag is only known on the device (its
        # first token may be EOS), so it is mirrored as live
        em_h = np.ones((B,), np.int64)
        dn_h = np.ones((B,), bool)
        bu_h = np.ones((B,), np.int64)
        steps = 0
        a0, d0, m0 = self.admit_dispatches, self.decode_dispatches, self.mixed_dispatches

        while True:
            # ---- admit queued requests into free slots (bucketed) ----
            admits: list[tuple[int, np.ndarray, int, int]] = []
            for slot in range(B):
                if slots[slot] is not None:
                    continue
                req = scheduler.pop_ready()
                if req is None:
                    break
                p = req.tokens[-width:]
                length = len(p)
                # prefill always emits one token, so the budget floor is 1;
                # None means the engine cap
                b_new = t_cap if req.max_new_tokens is None else req.max_new_tokens
                b_new = max(1, min(int(b_new), t_cap))
                admits.append((slot, p, length, b_new))
                scheduler.record_tenant_admit(req.tenant, prefill_tokens=length)
                slots[slot] = req
                em_h[slot], dn_h[slot] = 1, b_new <= 1
                bu_h[slot] = b_new
            while admits:
                # power-of-2 groups: k waiting requests prefill in O(log k)
                # dispatches
                g = 1 << (len(admits).bit_length() - 1)
                group, admits = admits[:g], admits[g:]
                st = self._admit_rows(
                    st, cache, self._dev(self._pack([p for _, p, _, _ in group])),
                    self._dev([s for s, _, _, _ in group]),
                    self._dev([ln for _, _, ln, _ in group]), self._dev([bn for _, _, _, bn in group]),
                )
                self.admit_dispatches += 1
                self.admit_rows_total += g
            active = [i for i in range(B) if slots[i] is not None]
            scheduler.record_occupancy(free_slots=B - len(active))
            scheduler.record_dispatch_stats(
                admit_dispatches=self.admit_dispatches - a0,
                decode_dispatches=self.decode_dispatches - d0,
                mixed_dispatches=self.mixed_dispatches - m0,
                steps=steps,
                lifetime=self._dispatch_lifetime(),
            )
            if not active:
                if drain or scheduler.closed:
                    if scheduler.has_pending:
                        continue  # a submit raced the close / empty check
                    return
                scheduler.wait_for_work()
                continue

            remaining = [int(bu_h[i] - em_h[i]) for i in active if not dn_h[i]]
            if remaining:
                # budgets and EOS are enforced on the device, so the chunk
                # length is only a scheduling granularity
                n = max(1, min(max(remaining), scfg.sched_chunk))
                st = self._decode_chunk(st, n, cache)
                self.decode_dispatches += 1
                steps += 1
            em_h, dn_h = st[2].cpu().numpy().astype(np.int64), st[3].cpu().numpy().copy()

            retired = [i for i in active if dn_h[i]]
            if retired:
                out_h = st[5].cpu().numpy()
                for i in retired:
                    req = slots[i]
                    ans = out_h[i, : int(em_h[i])].copy()
                    scheduler.finish(req, ans)
                    slots[i] = None  # retire: the slot is free for the next admit
                    yield req.rid, ans

    def _dispatch_lifetime(self) -> dict:
        return {
            "admit_dispatches": self.admit_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "mixed_dispatches": self.mixed_dispatches,
            "draft_dispatches": self.draft_dispatches,
            "draft_fill_dispatches": self.draft_fill_dispatches,
            "spec_rounds": self.spec_rounds,
            "spec_tokens_proposed": self.spec_tokens_proposed,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "spec_tokens_emitted": self.spec_tokens_emitted,
        }

    def _grow(self, i: int, need_tok: int, oom: np.ndarray, dn_h, oom_slots: set) -> bool:
        """Extend row ``i``'s table to ``need_tok`` tokens; on pool OOM mark
        the row done (force-retired ``truncated``) and return False."""
        tb = self._row_tables[i]
        if tb.n_tokens_capacity >= need_tok:
            return True
        n0 = tb.n_blocks
        if tb.extend_to(int(need_tok)):
            self._tables_h[i, n0 : tb.n_blocks] = tb.ids[n0:]
            return True
        oom[i] = True
        dn_h[i] = True
        oom_slots.add(i)
        return False

    def _serve_unified(self, scheduler: Scheduler, drain: bool):
        if self._serving:
            raise RuntimeError(
                "engine is already inside a serve loop; a resident engine "
                "serves one stream at a time"
            )
        scfg = self.scfg
        B, t_cap, width = scfg.max_batch, scfg.max_new_tokens, scfg.max_prompt_len
        bs, W = scfg.block_size, self._token_budget
        scheduler.begin_window()
        self._ensure_paged_state()
        pool, row_tables, tables_h = self._pool, self._row_tables, self._tables_h
        index, store = self._index, self._spill_store
        if index is not None:
            lk0, ht0 = self.prefix_lookups, self.prefix_hits
            pt0, ps0 = self.prefill_tokens_total, self.prefill_tokens_saved
            sh0 = self.prefix_shared_total
            dm0, rm0 = index.n_demotions, index.n_readmits
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        st = (
            torch.zeros((B,), **i32),  # cur
            torch.ones((B,), **i32),  # lengths
            torch.ones((B,), **i32),  # emitted
            torch.ones((B,), dtype=torch.bool, device=dev),  # done: free slots read as done
            torch.ones((B,), **i32),  # budget
            torch.zeros((B, t_cap + 1), **i32),  # out
        )
        slots: list[Request | None] = [None] * B
        em_h = np.ones((B,), np.int64)
        dn_h = np.ones((B,), bool)
        bu_h = np.ones((B,), np.int64)
        ln_h = np.ones((B,), np.int64)
        oom_slots: set[int] = set()
        empty = np.zeros((0,), np.int32)
        steps = 0
        d0, m0 = self.decode_dispatches, self.mixed_dispatches
        # fills[slot]: in-flight prompt stream (p/length/b_new/pos/cow/deps);
        # None once the prompt has fully dispatched.  pending_blocks maps a
        # cached-chunk block an in-flight fill will write -> (owner slot,
        # token position at which its content exists on the device)
        fills: list[dict | None] = [None] * B
        pending_blocks: dict[int, tuple[int, int]] = {}
        planned: dict[int, object] = {}
        # speculative decoding: d_fills[slot] is the drafter's prompt stream
        # (always the whole prompt: the drafter has no prefix cache); a
        # decode row speculates once its drafter fill is done and sits out
        # meanwhile.  d_broken marks rows whose drafter ran out of blocks:
        # they keep verifying, so their tokens never depend on the drafter
        spec, kd = scfg.draft_k > 0, scfg.draft_k
        d_pool, d_row_tables, d_tables_h = self._draft_pool, self._draft_row_tables, self._draft_tables_h
        d_fills: list[dict | None] = [None] * B
        d_broken = np.zeros((B,), bool)
        dr0, sr0 = self.draft_dispatches, self.spec_rounds
        sp0, sa0 = self.spec_tokens_proposed, self.spec_tokens_accepted
        se0, df0 = self.spec_tokens_emitted, self.draft_fill_dispatches
        self._serving = True

        def admit_gate(req: Request) -> bool:
            # both pools: the drafter re-prefills the whole prompt, so it
            # needs blocks for the prompt and the first draft position
            # (checked first: a prefix plan is memoised only for requests
            # that clear both)
            if spec and not d_pool.can_alloc(blocks_for(min(len(req.tokens), width) + 1, bs)):
                return False
            if index is not None:
                plan = index.plan(req.tokens[-width:])
                if plan is not None:
                    planned[req.rid] = plan
                return plan is not None
            return pool.can_alloc(blocks_for(min(len(req.tokens), width) + 1, bs))

        def report_prefix():
            if index is None:
                return
            window = {
                "prefix_lookups": self.prefix_lookups - lk0,
                "prefix_hits": self.prefix_hits - ht0,
                "prefill_tokens": self.prefill_tokens_total - pt0,
                "prefill_tokens_saved": self.prefill_tokens_saved - ps0,
                "prefix_shared_blocks": self.prefix_shared_total - sh0,
                "prefix_cached_blocks": index.n_cached_blocks,
            }
            lifetime = {
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefill_tokens": self.prefill_tokens_total,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "prefix_shared_blocks": self.prefix_shared_total,
                "prefix_cached_blocks": index.n_cached_blocks,
            }
            if store is not None:
                tier = dict(spilled_blocks=index.n_spilled, spill_bytes_used=store.used_bytes)
                window.update(spill_demotions=index.n_demotions - dm0,
                              spill_readmits=index.n_readmits - rm0, **tier)
                lifetime.update(spill_demotions=index.n_demotions,
                                spill_readmits=index.n_readmits, **tier)
            scheduler.record_prefix_stats(window, lifetime)

        def mark_oom(st, oom):
            if not oom.any():
                return st
            cur, lengths, emitted, done, budget, out = st
            return cur, lengths, emitted, done | self._dev(oom, torch.bool), budget, out

        def drop_draft(i):
            if d_row_tables[i].ids:
                d_row_tables[i].release()
            d_tables_h[i, :] = self._trash_block
            d_fills[i] = None

        def take_fills(runnable, tok, q_start_h, q_len_h, row_len_h, b_new_h, lanes):
            """Fill chunks of the runnable rows, FIFO, into the lanes left;
            returns the lanes still free."""
            for i in runnable:
                if lanes <= 0:
                    break
                fl = fills[i]
                if fl["cow"] is not None:
                    # the boundary copy precedes this fill's first write on
                    # the stream; commit's pin on the source drops once the
                    # copy is queued
                    src, dst = fl["cow"]
                    LM.paged_copy_block(self.cfg, self._cache, src, dst)
                    pool.free([src])
                    fl["cow"] = None
                take = min(fl["length"] - fl["pos"], lanes)
                tok[i, :take] = fl["p"][fl["pos"] : fl["pos"] + take]
                q_start_h[i] = fl["pos"]
                q_len_h[i] = take
                row_len_h[i] = fl["length"]
                b_new_h[i] = fl["b_new"]
                lanes -= take
                fl["pos"] += take
                # chunks this dispatch writes become shareable: a waiting
                # fill runs in a later dispatch on the same stream, so it
                # reads them after they are written
                for b in [b for b, (s, e) in pending_blocks.items() if s == i and e <= fl["pos"]]:
                    del pending_blocks[b]
                if fl["pos"] >= fl["length"]:
                    fills[i] = None  # completes in this dispatch
            return lanes

        try:
            while True:
                # ---- admit queued requests into free slots ----
                # host bookkeeping only: prompt tokens reach the device
                # through the mixed step below.  The one exception is a
                # re-admitted (spilled) chunk, whose payload uploads here,
                # synchronously, so it is never pending
                for slot in range(B):
                    if slots[slot] is not None:
                        continue
                    req = scheduler.pop_ready(admit_if=admit_gate)
                    if req is None:
                        break
                    p = req.tokens[-width:]
                    length = len(p)
                    b_new = t_cap if req.max_new_tokens is None else req.max_new_tokens
                    b_new = max(1, min(int(b_new), t_cap))
                    start, cow, deps = 0, None, set()
                    if index is not None:
                        plan = planned.pop(req.rid, None) or index.plan(p)
                        if plan is None:
                            raise RuntimeError("prefix admit raced the block pool")
                        table_ids, cow_dst = index.commit(plan)
                        for payload, b in plan.uploads:
                            if payload:
                                self._upload_block(payload, b)
                        row_tables[slot].adopt(table_ids)
                        tables_h[slot, :] = self._trash_block
                        tables_h[slot, : len(table_ids)] = table_ids
                        self.prefix_lookups += 1
                        self.prefill_tokens_total += length
                        start = plan.start
                        if start:
                            self.prefix_hits += 1
                            self.prefill_tokens_saved += start
                            self.prefix_shared_total += len(plan.shared) + (cow_dst is not None)
                        if cow_dst is not None and plan.cow_src is not None:
                            # a device boundary copy is still to be made; a
                            # spilled boundary uploaded above
                            cow = (plan.cow_src, cow_dst)
                        # wait on shared or COW-source chunks that another
                        # in-flight fill has registered but not yet written
                        deps = {
                            b for b in (set(plan.shared) | ({plan.cow_src} if cow else set()))
                            if b in pending_blocks
                        }
                        for c in range(len(plan.nodes), length // bs):
                            pending_blocks[table_ids[c]] = (slot, (c + 1) * bs)
                    else:
                        tb = row_tables[slot]
                        if not tb.extend_to(length + 1):
                            raise RuntimeError("paged admit raced the block pool")
                        tables_h[slot, :] = self._trash_block
                        tables_h[slot, : tb.n_blocks] = tb.ids
                    scheduler.record_tenant_admit(
                        req.tenant, prefill_tokens=length, prefill_tokens_saved=start, hit=start > 0
                    )
                    slots[slot] = req
                    fills[slot] = dict(p=p, length=length, b_new=b_new, pos=start, cow=cow, deps=deps)
                    if spec:
                        d_tb = d_row_tables[slot]
                        if not d_tb.extend_to(length + 1):
                            raise RuntimeError("draft admit raced the draft pool")
                        d_tables_h[slot, :] = self._trash_block
                        d_tables_h[slot, : d_tb.n_blocks] = d_tb.ids
                        d_fills[slot] = dict(p=p, length=length, pos=0)
                        d_broken[slot] = False
                    # inert on device until the fill's last chunk seeds it
                    em_h[slot], dn_h[slot] = 0, True
                    bu_h[slot], ln_h[slot] = b_new, length

                active = [i for i in range(B) if slots[i] is not None]
                scheduler.record_occupancy(
                    free_slots=B - len(active),
                    free_blocks=pool.free_blocks,
                    reclaimable_blocks=pool.reclaimable_blocks if index is not None else None,
                    # without the drafter's headroom a drafter OOM would not
                    # show in the memory gauges
                    draft_free_blocks=d_pool.free_blocks if spec else None,
                )
                report_prefix()
                scheduler.record_dispatch_stats(
                    admit_dispatches=0,
                    decode_dispatches=self.decode_dispatches - d0,
                    mixed_dispatches=self.mixed_dispatches - m0,
                    steps=steps,
                    lifetime=self._dispatch_lifetime(),
                    draft_dispatches=self.draft_dispatches - dr0,
                    draft_fill_dispatches=self.draft_fill_dispatches - df0,
                    spec_rounds=self.spec_rounds - sr0,
                    spec_tokens_proposed=self.spec_tokens_proposed - sp0,
                    spec_tokens_accepted=self.spec_tokens_accepted - sa0,
                    spec_tokens_emitted=self.spec_tokens_emitted - se0,
                )
                if not active:
                    if drain or scheduler.closed:
                        if scheduler.has_pending:
                            continue
                        return
                    scheduler.wait_for_work()
                    continue

                fill_rows = [i for i in range(B) if fills[i] is not None]
                dec_rows = [i for i in active if fills[i] is None and not dn_h[i]]
                try:
                    runnable = resolve_fill_deps(
                        {i: frozenset(fills[i]["deps"]) for i in fill_rows},
                        pending_blocks.keys(),
                    )
                except AdmissionDeadlock as exc:
                    # every in-flight fill waits on a chunk nobody will
                    # write: roll back their chunk registrations (leaf
                    # first), drop COW pins, retire them empty
                    doomed = set(exc.stuck)
                    inv = [b for b, (s, _) in pending_blocks.items() if s in doomed]
                    if index is not None and inv:
                        index.invalidate(inv)
                    for b in inv:
                        del pending_blocks[b]
                    for i in sorted(doomed):
                        fl, req = fills[i], slots[i]
                        if fl["cow"] is not None:
                            pool.free([fl["cow"][0]])
                        row_tables[i].release()
                        tables_h[i, :] = self._trash_block
                        if spec:
                            drop_draft(i)
                        scheduler.finish(req, empty, deadlocked=True)
                        slots[i], fills[i] = None, None
                        em_h[i], dn_h[i] = 1, True
                        yield req.rid, empty
                    continue

                if spec:
                    # ---- a speculative round: at most two dispatches ----
                    # (1) one drafter dispatch: drafter prompt chunks of rows
                    #     still streaming, then k proposals for every
                    #     drafter-ready decode row;
                    # (2) one target dispatch: verify rows (q_len <= k + 1),
                    #     then target fill chunks in the lanes left
                    spec_rows = [i for i in dec_rows if d_fills[i] is None]
                    d_fill_rows = [i for i in range(B) if d_fills[i] is not None]
                    draft_ok: list[int] = []
                    for i in spec_rows:
                        if d_broken[i]:
                            continue
                        if int(bu_h[i] - em_h[i]) < 2 or int(self._cache_len_padded - (ln_h[i] + em_h[i] - 1)) < 2:
                            continue  # a 1-token tail cannot accept a draft
                        # +1: the k-loop writes K/V for every proposal,
                        # d_k included, at dec_pos + kd
                        need = int(ln_h[i] + em_h[i] + kd)
                        if need > self._cache_len_padded:
                            continue  # the cache's tail: no drafts this round
                        d_tb = d_row_tables[i]
                        if d_tb.n_tokens_capacity < need:
                            n0 = d_tb.n_blocks
                            if d_tb.extend_to(need):
                                d_tables_h[i, n0 : d_tb.n_blocks] = d_tb.ids[n0:]
                            else:
                                # drafter pool OOM: drop its chain, keep verifying
                                d_broken[i] = True
                                drop_draft(i)
                                continue
                        draft_ok.append(i)
                    # rows excluded from drafting write into the trash block
                    d_dec_tab = np.full_like(d_tables_h, self._trash_block)
                    d_dec_tab[draft_ok] = d_tables_h[draft_ok]
                    dec_pos = self._dev(ln_h + em_h - 1)
                    cur = st[0]
                    drafts = None
                    if d_fill_rows:
                        d_tok = np.zeros((B, W), np.int32)
                        d_qs = np.zeros((B,), np.int32)
                        d_ql = np.zeros((B,), np.int32)
                        d_lanes = W
                        for i in d_fill_rows:
                            if d_lanes <= 0:
                                break
                            fl = d_fills[i]
                            take = min(fl["length"] - fl["pos"], d_lanes)
                            d_tok[i, :take] = fl["p"][fl["pos"] : fl["pos"] + take]
                            d_qs[i], d_ql[i] = fl["pos"], take
                            d_lanes -= take
                            fl["pos"] += take
                            if fl["pos"] >= fl["length"]:
                                d_fills[i] = None
                        drafts = self._draft_rows(
                            self._dev(d_tok), self._dev(d_qs), self._dev(d_ql), cur, dec_pos,
                            self._dev(d_tables_h), self._dev(d_dec_tab),
                        )
                        # a dispatch that only streams drafter prompt chunks
                        # is admission cost (the drafter's prefill), not a round's
                        if draft_ok:
                            self.draft_dispatches += 1
                        else:
                            self.draft_fill_dispatches += 1
                    elif draft_ok:
                        drafts = self._draft_tokens(cur, dec_pos, self._dev(d_dec_tab))
                        self.draft_dispatches += 1
                    tok = np.zeros((B, W), np.int32)
                    q_start_h = np.zeros((B,), np.int32)
                    q_len_h = np.zeros((B,), np.int32)
                    is_spec = np.zeros((B,), bool)
                    row_len_h = np.zeros((B,), np.int32)
                    b_new_h = np.ones((B,), np.int32)
                    oom = np.zeros((B,), bool)
                    lanes = W
                    # verify lanes first (fills absorb the wait), drafted rows
                    # before the others: a round that paid for a k-loop always
                    # lands at least one verify row of q_len >= 2
                    for i in draft_ok + [r for r in spec_rows if r not in set(draft_ok)]:
                        if lanes <= 0:
                            break
                        v = min(kd + 1, int(bu_h[i] - em_h[i]), int(self._cache_len_padded - (ln_h[i] + em_h[i] - 1)),
                                lanes)
                        if v < 1:
                            continue
                        need = min(ln_h[i] + em_h[i] - 1 + v, self._cache_len_padded)
                        if not self._grow(i, need, oom, dn_h, oom_slots):
                            continue
                        is_spec[i] = True
                        q_len_h[i] = v
                        lanes -= v
                    take_fills(runnable, tok, q_start_h, q_len_h, row_len_h, b_new_h, lanes)
                    st = mark_oom(st, oom)
                    if is_spec.any() or q_len_h.any():
                        em_before = em_h.copy()
                        st = self._spec_mixed_rows(
                            st, self._dev(tok), self._dev(q_start_h), self._dev(q_len_h),
                            self._dev(is_spec, torch.bool),
                            drafts if drafts is not None else torch.zeros((B, kd), dtype=torch.int32, device=dev),
                            self._dev(row_len_h), self._dev(b_new_h), self._dev(tables_h),
                        )
                        self.mixed_dispatches += 1
                        steps += 1
                        em_h, dn_h = st[2].cpu().numpy().astype(np.int64), st[3].cpu().numpy().copy()
                        if is_spec.any():
                            committed = em_h[is_spec] - em_before[is_spec]
                            self.spec_tokens_emitted += int(committed.sum())
                            self.spec_tokens_proposed += int((q_len_h[is_spec] - 1).sum())
                            self.spec_tokens_accepted += int(np.maximum(committed - 1, 0).sum())
                            if (q_len_h[is_spec] > 1).any():
                                self.spec_rounds += 1
                elif runnable:
                    # ---- ONE mixed dispatch: decode lanes + fill chunks ----
                    tok = np.zeros((B, W), np.int32)
                    q_start_h = np.zeros((B,), np.int32)
                    q_len_h = np.zeros((B,), np.int32)
                    is_dec = np.zeros((B,), bool)
                    row_len_h = np.zeros((B,), np.int32)
                    b_new_h = np.ones((B,), np.int32)
                    oom = np.zeros((B,), bool)
                    lanes = W
                    for i in dec_rows:  # decode first: fills absorb the wait
                        if lanes <= 0:
                            break
                        need = min(ln_h[i] + min(em_h[i] + 1, bu_h[i]) - 1, self._cache_len_padded)
                        if not self._grow(i, need, oom, dn_h, oom_slots):
                            continue
                        is_dec[i] = True
                        q_len_h[i] = 1
                        lanes -= 1
                    take_fills(runnable, tok, q_start_h, q_len_h, row_len_h, b_new_h, lanes)
                    st = mark_oom(st, oom)
                    st = self._mixed_rows(
                        st, self._dev(tok), self._dev(q_start_h), self._dev(q_len_h),
                        self._dev(is_dec, torch.bool), self._dev(row_len_h),
                        self._dev(b_new_h), self._dev(tables_h),
                    )
                    self.mixed_dispatches += 1
                    steps += 1
                    em_h, dn_h = st[2].cpu().numpy().astype(np.int64), st[3].cpu().numpy().copy()
                elif dec_rows:
                    # no fill in flight: fused multi-step decode, one dispatch
                    remaining = [int(bu_h[i] - em_h[i]) for i in dec_rows]
                    n = max(1, min(max(remaining), scfg.sched_chunk))
                    oom = np.zeros((B,), bool)
                    for i in dec_rows:
                        need = min(ln_h[i] + min(em_h[i] + n, bu_h[i]) - 1, self._cache_len_padded)
                        self._grow(i, need, oom, dn_h, oom_slots)
                    st = mark_oom(st, oom)
                    st = self._decode_chunk(st, n, self._cache, self._dev(tables_h))
                    self.decode_dispatches += 1
                    steps += 1
                    em_h, dn_h = st[2].cpu().numpy().astype(np.int64), st[3].cpu().numpy().copy()

                retired = [i for i in active if dn_h[i] and fills[i] is None and slots[i] is not None]
                if retired:
                    out_h = st[5].cpu().numpy()
                    for i in retired:
                        req = slots[i]
                        ans = out_h[i, : int(em_h[i])].copy()
                        scheduler.finish(req, ans, truncated=i in oom_slots)
                        oom_slots.discard(i)
                        slots[i] = None
                        row_tables[i].release()
                        tables_h[i, :] = self._trash_block
                        if spec:
                            drop_draft(i)
                            d_broken[i] = False
                        yield req.rid, ans
        finally:
            # the pool and index outlive this call: an abandoned stream must
            # not leak owned blocks or unwritten chunk registrations into the
            # next serve (normal exit: a no-op)
            if index is not None and pending_blocks:
                index.invalidate(list(pending_blocks))
            pending_blocks.clear()
            for i in range(B):
                if fills[i] is not None and fills[i]["cow"] is not None:
                    pool.free([fills[i]["cow"][0]])
                fills[i] = None
                if slots[i] is not None and slots[i].status == "active":
                    scheduler.finish(slots[i], empty, deadlocked=True)
                slots[i] = None
                if row_tables[i].ids:
                    row_tables[i].release()
                tables_h[i, :] = self._trash_block
                if spec:
                    drop_draft(i)
            report_prefix()
            self._serving = False

    def serve_prompts(
        self,
        prompts: Sequence[np.ndarray],
        max_new_tokens: int | Sequence[int] | None = None,
        deadlines: Sequence[float | None] | None = None,
    ) -> list[np.ndarray]:
        """Schedule ``prompts`` and serve to completion, returning answers in
        prompt order (expired requests -> empty row)."""
        sched = Scheduler()
        rids = sched.submit_many(prompts, max_new_tokens, deadlines)
        res = self.serve(sched)
        empty = np.zeros((0,), np.int32)
        return [res.get(rid, empty) for rid in rids]


def engine_generator(engine: ServeEngine, mode: str = "continuous") -> Callable:
    """Adapt a ServeEngine to the orchestrator's generator contract:
    callable (1, S) -> (1, T) for a single prompt, plus ``generate_batch``
    (list of prompts -> list of answer rows).  ``mode="continuous"`` routes
    batches through the slot scheduler; ``mode="lockstep"`` runs the
    fixed-chunk baseline (``step_batch``)."""
    if mode not in ("continuous", "lockstep"):
        raise ValueError(f"engine_generator: mode={mode!r} is not 'continuous' or 'lockstep'")

    def generate_batch(prompts: list[np.ndarray]) -> list[np.ndarray]:
        if engine.queue:
            raise RuntimeError("engine_generator requires exclusive use of the engine queue")
        if mode == "continuous":
            return engine.serve_prompts([np.asarray(p) for p in prompts])
        for p in prompts:
            engine.submit(np.asarray(p))
        outs: list[np.ndarray] = []
        while engine.queue:
            outs.extend(engine.step_batch())
        return outs

    def generate(prompt_tokens: np.ndarray) -> np.ndarray:
        return generate_batch([np.asarray(prompt_tokens)])[0][None, :]

    generate.generate_batch = generate_batch
    generate.engine = engine
    generate.mode = mode
    # the engine's prompt window, so prompt builders truncate grammar-aware
    generate.max_prompt_len = engine.scfg.max_prompt_len
    return generate
