"""RAG serving engine: continuous batching over a paged KV cache.

The paged unified path of the JAX package's engine, run eagerly.  Every
engine step with a prompt chunk in flight is ONE ``mixed_step`` over
per-row ``(q_start, q_len)`` descriptors: decode rows take one query
lane each, and the prompts of admitted requests stream in FIFO through
the remaining lanes of the ``token_budget``, so a long prompt never
stalls the rows already decoding.  When no prompt is in flight, the
loop runs a fused decode chunk of up to ``sched_chunk`` ``decode_step``s
instead.  ``mixed_dispatches`` and ``decode_dispatches`` count the two.

Memory: attention K/V live in one pool of ``n_pool_blocks`` blocks of
``block_size`` tokens (plus a trash block that unallocated table entries
and dead lanes point at), addressed through per-slot block tables.  A
request is admitted only while free blocks cover its prompt and first
decode token; tables grow at step boundaries; a row that cannot grow is
force-retired ``truncated`` with what it has emitted, and its neighbours
are unharmed.  ``AdmissionDeadlock`` is the typed stall of the fill
dependency resolver: the stuck rows retire empty and ``deadlocked``.

The pool, tables and device cache are resident: created on first use
and kept across ``serve`` calls until ``reset_cache``.

Options of the JAX package's engine that this port does not run yet
raise ``NotImplementedError``: the contiguous layout (``paged=False``),
the prefix cache and its host spill tier, speculative decoding and the
sharded pool.
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
from repro_torch.serving.kv_cache import BlockPool, BlockTable, blocks_for
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
    max_batch: int = 8  # decode slots
    max_prompt_len: int = 512
    max_new_tokens: int = 16  # hard cap; per-request budgets clamp to this
    sched_chunk: int = 8  # max fused decode steps between scheduler runs
    paged: bool = False  # must be True: the port runs the paged engine only
    block_size: int = 32  # tokens per KV block
    # pool size in blocks; None -> max_batch full-length requests
    n_pool_blocks: int | None = None
    prefix_cache: bool = False  # not ported yet
    # query lanes per mixed step; None -> max_prompt_len (a whole prompt
    # may prefill in one step)
    token_budget: int | None = None
    spill_bytes: int | None = None  # not ported yet
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
        if not scfg.paged:
            raise _not_ported("the contiguous cache layout (paged=False)", "contiguous and lock-step engine")
        if scfg.prefix_cache:
            raise _not_ported("the prefix cache (prefix_cache=True)", "prefix-cache")
        if scfg.spill_bytes is not None:
            raise _not_ported("the host spill tier (spill_bytes)", "prefix-cache")
        if scfg.draft_k < 0:
            raise ValueError(f"draft_k={scfg.draft_k} must be >= 0")
        if scfg.draft_k > 0:
            raise _not_ported("speculative decoding (draft_k > 0)", "speculative-decoding")
        if scfg.shards is not None:
            raise _not_ported("the sharded KV pool (shards)", "multi-device")
        if any(cfg.mixer_kind(i) != "attn" for i in range(cfg.n_layers)):
            raise ValueError(
                "paged serving runs the unified chunked-prefill path, which "
                "requires an all-attention model: SSM/conv state folds the "
                "whole sequence and cannot resume a chunked prompt"
            )
        if scfg.token_budget is not None and scfg.token_budget < 1:
            raise ValueError(f"token_budget={scfg.token_budget} must be >= 1")
        self.cfg, self.scfg = cfg, scfg
        self.params = params.tree() if isinstance(params, torch.nn.Module) else params
        cache_len = scfg.max_prompt_len + scfg.max_new_tokens
        bs = scfg.block_size
        self._blocks_per_slot = blocks_for(cache_len, bs)
        self._cache_len_padded = self._blocks_per_slot * bs
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
        # dispatch observability: the O(1)-dispatch-per-step gauges
        self.decode_dispatches = 0
        self.mixed_dispatches = 0
        self._pool: BlockPool | None = None
        self._row_tables: list[BlockTable] | None = None
        self._tables_h: np.ndarray | None = None
        self._cache = None
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

    def _decode_chunk(self, st, n_steps: int, tables):
        """Fused decode of up to ``n_steps`` tokens across all slots, until
        every row is done.  Tokens go to a dense (B, sched_chunk) buffer
        by step; the ragged merge into each row's own ``[emitted0,
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
                self.cfg, self.params, self._cache, cur[:, None], lengths + emitted - 1,
                tables, self.scfg.block_size,
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

    # ------------------------------------------------------------------ #
    # resident paged state
    # ------------------------------------------------------------------ #
    def _ensure_paged_state(self):
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
        self._cache = LM.init_paged_cache(
            self.cfg, self._n_pool_blocks + 1, scfg.block_size,
            dtype=torch_dtype(self.cfg.dtype), device=self.device,
        )

    def reset_cache(self):
        """Drop the resident pool, tables and device cache."""
        if self._serving:
            raise RuntimeError("reset_cache() during an active serve loop")
        self._pool = self._row_tables = self._tables_h = self._cache = None

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
        yield from self._serve_unified(scheduler, drain)

    def _dispatch_lifetime(self) -> dict:
        return {
            "admit_dispatches": 0,  # admission is host-only: prompts enter through mixed steps
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
        # fills[slot]: in-flight prompt stream (p/length/b_new/pos/deps); None
        # once the prompt has fully dispatched
        fills: list[dict | None] = [None] * B
        pending_blocks: dict[int, tuple[int, int]] = {}
        self._serving = True

        def admit_gate(req: Request) -> bool:
            return pool.can_alloc(blocks_for(min(len(req.tokens), width) + 1, bs))

        def mark_oom(st, oom):
            if not oom.any():
                return st
            cur, lengths, emitted, done, budget, out = st
            return cur, lengths, emitted, done | self._dev(oom, torch.bool), budget, out

        try:
            while True:
                # ---- admit queued requests into free slots (host only) ----
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
                    tb = row_tables[slot]
                    if not tb.extend_to(length + 1):
                        raise RuntimeError("paged admit raced the block pool")
                    tables_h[slot, :] = self._trash_block
                    tables_h[slot, : tb.n_blocks] = tb.ids
                    scheduler.record_tenant_admit(
                        req.tenant, prefill_tokens=length, prefill_tokens_saved=0, hit=False
                    )
                    slots[slot] = req
                    fills[slot] = dict(p=p, length=length, b_new=b_new, pos=0, deps=set())
                    # inert on device until the fill's last chunk seeds it
                    em_h[slot], dn_h[slot] = 0, True
                    bu_h[slot], ln_h[slot] = b_new, length

                active = [i for i in range(B) if slots[i] is not None]
                scheduler.record_occupancy(free_slots=B - len(active), free_blocks=pool.free_blocks)
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
                    for i in sorted(set(exc.stuck)):
                        req = slots[i]
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
                        take = min(fl["length"] - fl["pos"], lanes)
                        tok[i, :take] = fl["p"][fl["pos"] : fl["pos"] + take]
                        q_start_h[i] = fl["pos"]
                        q_len_h[i] = take
                        row_len_h[i] = fl["length"]
                        b_new_h[i] = fl["b_new"]
                        lanes -= take
                        fl["pos"] += take
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
                    st = self._decode_chunk(st, n, self._dev(tables_h))
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
            # the pool outlives this call: an abandoned stream must not leak
            # owned blocks into the next serve (normal exit: a no-op)
            pending_blocks.clear()
            for i in range(B):
                fills[i] = None
                if slots[i] is not None and slots[i].status == "active":
                    scheduler.finish(slots[i], empty, deadlocked=True)
                slots[i] = None
                if row_tables[i].ids:
                    row_tables[i].release()
                tables_h[i, :] = self._trash_block
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
    (list of prompts -> list of answer rows) through the slot scheduler."""
    if mode != "continuous":
        raise _not_ported(f"engine_generator mode={mode!r}", "contiguous and lock-step engine")

    def generate_batch(prompts: list[np.ndarray]) -> list[np.ndarray]:
        return engine.serve_prompts([np.asarray(p) for p in prompts])

    def generate(prompt_tokens: np.ndarray) -> np.ndarray:
        return generate_batch([np.asarray(prompt_tokens)])[0][None, :]

    generate.generate_batch = generate_batch
    generate.engine = engine
    generate.mode = mode
    # the engine's prompt window, so prompt builders truncate grammar-aware
    generate.max_prompt_len = engine.scfg.max_prompt_len
    return generate
