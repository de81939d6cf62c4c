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

Both layouts give the same tokens for the same admission order.  An
all-Mamba2 model (``ssm`` family) serves on the contiguous path and the
lock-step baseline, whose admit prefills carry its conv and SSM state into
the slot; the paged path refuses it, as the reference's does.  Options
of the JAX package's engine that this port does not run yet raise
``NotImplementedError``: speculative decoding and the sharded pool.
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
    draft_k: int = 0  # speculative decoding: not ported yet
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
        if scfg.draft_k < 0:
            raise ValueError(f"draft_k={scfg.draft_k} must be >= 0")
        if scfg.draft_k > 0:
            raise _not_ported("speculative decoding (draft_k > 0)", "speculative-decoding")
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
        self.queue: list[np.ndarray] = []  # lock-step requests (submit / step_batch)
        self._pool: BlockPool | None = None
        self._row_tables: list[BlockTable] | None = None
        self._tables_h: np.ndarray | None = None
        self._cache = None
        self._index: PrefixIndex | None = None
        self._spill_store: HostBlockStore | None = None
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
        if scfg.prefix_cache:
            store = HostBlockStore(scfg.spill_bytes) if scfg.spill_bytes is not None else None
            self._spill_store = store
            self._index = PrefixIndex(self._pool, spill_store=store, fetch_block=self._fetch_block)

    def reset_cache(self):
        """Drop all resident paged state: device cache, block pool, prefix
        index and host spill tier.  The next serve starts cold."""
        if self._serving:
            raise RuntimeError("reset_cache() during an active serve loop")
        self._pool = self._row_tables = self._tables_h = self._cache = None
        self._index = self._spill_store = None

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
        self._serving = True

        def admit_gate(req: Request) -> bool:
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
                    # inert on device until the fill's last chunk seeds it
                    em_h[slot], dn_h[slot] = 0, True
                    bu_h[slot], ln_h[slot] = b_new, length

                active = [i for i in range(B) if slots[i] is not None]
                scheduler.record_occupancy(
                    free_slots=B - len(active),
                    free_blocks=pool.free_blocks,
                    reclaimable_blocks=pool.reclaimable_blocks if index is not None else None,
                )
                report_prefix()
                scheduler.record_dispatch_stats(
                    admit_dispatches=0,
                    decode_dispatches=self.decode_dispatches - d0,
                    mixed_dispatches=self.mixed_dispatches - m0,
                    steps=steps,
                    lifetime=self._dispatch_lifetime(),
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
                        scheduler.finish(req, empty, deadlocked=True)
                        slots[i], fills[i] = None, None
                        em_h[i], dn_h[i] = 1, True
                        yield req.rid, empty
                    continue

                if runnable:
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
                    for i in runnable:
                        if lanes <= 0:
                            break
                        fl = fills[i]
                        if fl["cow"] is not None:
                            # the boundary copy precedes this fill's first
                            # write on the stream; commit's pin on the
                            # source drops once the copy is queued
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
                        # chunks this dispatch writes become shareable: a
                        # waiting fill runs in a later dispatch on the same
                        # stream, so it reads them after they are written
                        for b in [b for b, (s, e) in pending_blocks.items() if s == i and e <= fl["pos"]]:
                            del pending_blocks[b]
                        if fl["pos"] >= fl["length"]:
                            fills[i] = None  # completes in this dispatch
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
