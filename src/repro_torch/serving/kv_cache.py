"""Paged KV-cache block pool: host-side memory manager for the serving engine.

The contiguous engine layout reserves one ``max_prompt_len +
max_new_tokens`` cache stripe per slot, so a 12-token query pays the same
HBM as the longest allowed prompt and the admitted batch size is pinned to
the number of physical stripes.  The paged layout chops the cache into
fixed-size **token blocks** (``block_size`` positions each) held in one
shared pool; each request owns an ordered **block table** mapping its
logical positions ``[i * block_size, (i + 1) * block_size)`` to pool block
``table[i]``.  Admission allocates just enough blocks to cover the prompt,
decode grows the table one block at a time at chunk boundaries, and retire
returns every block to the pool — so concurrency is bounded by *actual*
tokens resident, not by worst-case stripes.

Blocks are **refcounted** so prompt prefixes can be shared: ``alloc``
hands a block out at refcount 1, ``share`` increments (a second request's
table now points at the same physical block), and ``free`` decrements —
a block is recycled (or parked, see below) only when its count reaches
zero.  The C-FedRAG front door builds every prompt as ``[BOS] CTX
<aggregated chunks> QRY <query> ANS`` with the context preamble first, so
micro-batch siblings and retries repeat the expensive prefix verbatim;
two block tables pointing at one immutable prompt block de-duplicate both
the HBM and the prefill FLOPs that computed it.

``PrefixIndex`` is the lookup structure on top: a hash-chain trie over
``block_size``-token chunks of prompt token ids.  Each cached chunk is
one trie node keyed by ``(parent, chunk tokens)``.  On a resident engine
the index (and the pool) survive across serve calls, so the cache is
**tiered**:

  * **device tier**: the node holds a pool block (``node.block`` is an
    int) with the chunk's K/V in HBM.  Zero-ref device blocks **park**
    (contents preserved, reclaimable).
  * **host tier** (optional, ``HostBlockStore``): under pool pressure a
    parked chunk is *demoted* instead of discarded — its K/V payload is
    fetched to host RAM (``fetch_block`` callback, engine-provided) and
    the device block is recycled; the node stays in the trie with
    ``node.block is None``.  A later prefix hit **re-admits** the chunk:
    ``commit`` allocates a fresh device block, repoints the node, and
    returns the host payload for the engine to ``device_put`` — the
    chunk's K/V is never recomputed.  The store is byte-bounded; over
    budget it drops LRU spilled *leaves* (then the chunk really is gone
    and costs a re-prefill like a plain eviction).

**Leaf-first chain integrity across the tier boundary**: demotion (like
eviction) only takes a node whose children are all already spilled, and
host-side drops only take spilled nodes with no children — so along any
root-to-leaf chain the device-resident nodes form a prefix, the spilled
nodes a contiguous middle, and nothing cached is ever orphaned from the
root.  Re-admission restores whole matched chains in root-first order,
preserving the same shape.

This module is deliberately host-only and jax-free: the pool hands out
integer block ids and the store holds opaque payloads; the engine owns
the device arrays those ids index (``models/lm.init_paged_cache`` leaves
shaped ``(n_layers, n_pool, block_size, ...)``), performs the
device->host fetch at demotion and the host->device upload at
re-admission, and keeps the device copy of the block tables.

**Sharded pools** (``BlockPool(n_blocks, bs, n_shards=N)``): global
block ids partition into N contiguous per-shard ranges of ``n_blocks //
N`` each (``shard_of(b) = b // n_local``), matching device pool leaves
laid out ``(n_layers, n_shards, n_local + 1, block_size, kv, hd)`` and
sharded ``P(None, "data", ...)`` — each device holds exactly its own
shard's blocks plus a per-shard trash block at local index ``n_local``.
The allocator stays a single host-side global authority; allocation is
shard-local and **row-affine**: a ``BlockTable`` pins its shard on first
alloc, a ``PrefixIndex`` chain records its shard at insert and keeps it
across demotion, so every request's whole KV chain (and its cached
prefixes) lives on exactly one shard.  The spill tier stays keyed by
global block id / trie node; re-admission allocates on the recorded
owning shard so the engine's ``device_put`` lands the payload back on
the same device.  Row affinity is what lets the distributed mixed
dispatch mask non-owner shards to exact zeros and combine partials
bit-identically to a single-shard run (see ``serving/dist_decode.py``).

Contracts / invariants (property-tested in tests/test_kv_cache.py):
  * ``alloc(n)`` is all-or-nothing: it returns ``n`` block ids or raises
    ``BlockPoolOOM`` without allocating anything (``try_alloc`` returns
    ``None`` instead) — a half-admitted request can never leak blocks.
    Under pool pressure it first asks the registered evictor to demote
    (or, with no spill store, recycle) parked blocks, LRU-first.
  * Refcounts are never negative: ``free`` of a block that is not owned
    (refcount >= 1) raises loudly — a double-free means two requests
    believe they own the same block, which is cache corruption, not a
    recoverable condition.  ``share`` requires an owned block.
  * A device block is in exactly one state: free, owned (refcount >= 1),
    or parked (refcount == 0, cached contents preserved, reclaimable);
    a cached *chunk* is in exactly one tier: device-backed (its node
    holds a block in one of those states) or spilled (payload in the
    host store, ``node.block is None``).  The store's ``used_bytes``
    never exceeds ``max_bytes``.
  * Eviction/demotion never touches a block with refcount > 0, and only
    takes chunks whose children are already off-device (leaf-first), so
    every surviving chain stays reachable from the root.
  * Allocation order is deterministic (LIFO free list, FIFO
    eviction/demotion by LRU stamp) so paged serving replays are
    reproducible run to run.
  * Shared prompt blocks are immutable: the engine only writes positions
    ``>= start`` of a request whose blocks below ``start`` are shared,
    and copy-on-writes the boundary block when a full-prefix hit would
    otherwise write position ``L - 1`` into a block it does not own
    exclusively (see ``PrefixIndex.plan``).  A spilled boundary chunk
    needs no device copy at all: its payload uploads straight into the
    request's private block.
"""
from __future__ import annotations

from typing import Any, Callable


class BlockPoolOOM(RuntimeError):
    """Raised by ``alloc`` when the pool cannot satisfy a request."""


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``n_tokens`` positions (>= 1)."""
    return max(1, -(-int(n_tokens) // block_size))


class BlockPool:
    """Fixed pool of ``n_blocks`` refcounted token blocks.

    States: **free** (on the LIFO free list), **owned** (refcount >= 1,
    at least one block table points at it), **parked** (refcount == 0
    but contents preserved for prefix reuse; demoted or recycled by the
    registered ``evictor`` under pressure).  Without a registered
    evictor (plain paged serving, no prefix cache) blocks never park and
    the pool degenerates to a plain alloc/free manager.

    **Sharded pools** (``n_shards > 1``): global block ids partition into
    ``n_shards`` contiguous ranges of ``n_blocks // n_shards`` ids each;
    block ``b`` lives on shard ``b // (n_blocks // n_shards)``.  The
    allocator stays a single host-side authority, but every allocation is
    shard-local (one LIFO free list per shard) so a request's whole block
    table lands on ONE shard — the row-affinity contract the distributed
    mixed dispatch's exact-zero masking depends on.  ``alloc`` with no
    explicit shard picks the shard with the most headroom (ties break
    low), and ``can_alloc`` answers "could some single shard hold n".
    With ``n_shards == 1`` every path reduces bit-for-bit to the
    unsharded allocator (same LIFO order, same eviction order).
    """

    def __init__(self, n_blocks: int, block_size: int, n_shards: int = 1):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError(f"need positive pool dims, got {n_blocks}x{block_size}")
        if n_shards <= 0 or n_blocks % n_shards:
            raise ValueError(
                f"n_blocks={n_blocks} must divide evenly over n_shards={n_shards}"
            )
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.n_shards = int(n_shards)
        self._n_local = self.n_blocks // self.n_shards
        # LIFO per shard: the shard's lowest block id is handed out first,
        # and a just-freed block is the next one reused (cache-friendly
        # and deterministic); with one shard this is the classic flat list
        self._frees = [
            list(range((s + 1) * self._n_local - 1, s * self._n_local - 1, -1))
            for s in range(self.n_shards)
        ]
        self._ref: dict[int, int] = {}  # owned blocks -> refcount >= 1
        self._parked: set[int] = set()  # zero-ref cached blocks (reclaimable)
        self._cached: set[int] = set()  # blocks a PrefixIndex holds (owned or parked)
        self.evictor: Any = None  # PrefixIndex registers itself here

    @property
    def _free(self) -> list[int]:
        """Flat view of every free block id (read-only; shard lists are
        authoritative)."""
        return [b for fl in self._frees for b in fl]

    @property
    def free_blocks(self) -> int:
        return sum(len(fl) for fl in self._frees)

    @property
    def free_blocks_by_shard(self) -> list[int]:
        return [len(fl) for fl in self._frees]

    def shard_of(self, b: int) -> int:
        """Owning shard of block ``b`` (its global id's range)."""
        return int(b) // self._n_local

    def _parked_on(self, shard: int) -> int:
        return sum(1 for b in self._parked if b // self._n_local == shard)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    @property
    def reclaimable_blocks(self) -> int:
        """Parked blocks: zero-ref cached prefixes the evictor can recycle."""
        return len(self._parked)

    def refcount(self, b: int) -> int:
        return self._ref.get(b, 0)

    def is_parked(self, b: int) -> bool:
        return b in self._parked

    def _headroom(self, shard: int) -> int:
        return len(self._frees[shard]) + (
            self._parked_on(shard) if self.evictor is not None else 0
        )

    def pick_shard(self, n: int) -> int:
        """Shard with the most headroom (free + reclaimable-parked); ties
        break toward the lowest shard id for deterministic replays."""
        return max(range(self.n_shards), key=lambda s: (self._headroom(s), -s))

    def can_alloc(self, n: int, shard: int | None = None) -> bool:
        """Could ``alloc(n)`` succeed?  Counts parked blocks only when an
        evictor is registered to actually reclaim them.  All ``n`` blocks
        must come from ONE shard (row affinity); ``shard=None`` asks
        whether the best shard could hold them."""
        if shard is None:
            shard = self.pick_shard(n)
        return n <= self._headroom(shard)

    def _make_room(self, n: int, shard: int) -> None:
        while len(self._frees[shard]) < n and self.evictor is not None:
            if not self.evictor.evict_one(shard=shard):
                break

    def alloc(self, n: int, shard: int | None = None) -> list[int]:
        """Take ``n`` blocks at refcount 1 from one shard; all-or-nothing
        (raises BlockPoolOOM).  Under pressure, parked prefix blocks *on
        that shard* are demoted to the host tier (or evicted outright)
        LRU-first before giving up.  ``shard=None`` picks the shard with
        the most headroom."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if shard is None:
            shard = self.pick_shard(n)
        self._make_room(n, shard)
        fl = self._frees[shard]
        if n > len(fl):
            raise BlockPoolOOM(
                f"need {n} blocks on shard {shard}, {len(fl)} free "
                f"(+{self._parked_on(shard)} parked)"
            )
        ids = [fl.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def try_alloc(self, n: int, shard: int | None = None) -> list[int] | None:
        """Like ``alloc`` but returns None on OOM (the chunk-boundary grow
        path treats OOM as an early-retire signal, not an error)."""
        if shard is None and self.n_shards > 1:
            shard = self.pick_shard(n)
        return self.alloc(n, shard=shard) if self.can_alloc(n, shard=shard) else None

    def share(self, ids) -> None:
        """Increment the refcount of owned blocks: a second table now
        points at the same physical block.  Parked blocks must be
        ``reactivate``d instead (0 -> 1 is a state change, not a share)."""
        ids = list(ids)
        bad = [b for b in ids if b not in self._ref]
        if bad:
            raise ValueError(f"share of unowned block(s) {bad}")
        for b in ids:
            self._ref[b] += 1

    def reactivate(self, ids) -> None:
        """Parked -> owned at refcount 1: a prefix-cache hit on a block
        whose last owner already retired."""
        ids = list(ids)
        bad = [b for b in ids if b not in self._parked]
        if bad:
            raise ValueError(f"reactivate of non-parked block(s) {bad}")
        for b in ids:
            self._parked.remove(b)
            self._ref[b] = 1

    def free(self, ids) -> None:
        """Decrement refcounts; a block reaching zero is parked if a
        prefix index holds it (contents stay reclaimable) and recycled to
        the free list otherwise.  Unowned ids raise: a double-free means
        two requests think they own the same block."""
        ids = list(ids)
        bad = [b for b in ids if b not in self._ref]
        if bad:
            raise ValueError(f"free of unowned block(s) {bad}")
        counts: dict[int, int] = {}
        for b in ids:
            counts[b] = counts.get(b, 0) + 1
        over = [b for b, c in counts.items() if c > self._ref[b]]
        if over:
            raise ValueError(f"free decrements below zero for block(s) {over}")
        recycled = []
        for b in ids:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._cached:
                    self._parked.add(b)
                else:
                    recycled.append(b)
        # reversed: freeing [a, b] then allocating 2 returns [a, b] again;
        # each block returns to its owning shard's list
        for b in reversed(recycled):
            self._frees[self.shard_of(b)].append(b)

    # ---- prefix-index hooks ----
    def mark_cached(self, b: int) -> None:
        if b not in self._ref and b not in self._parked:
            raise ValueError(f"mark_cached of free block {b}")
        self._cached.add(b)

    def recycle_parked(self, b: int) -> None:
        """Eviction/demotion endpoint: a parked block's device contents
        are released and the block returns to the free list.  Refuses
        owned blocks — eviction must never touch refcount > 0."""
        if b not in self._parked:
            raise ValueError(f"recycle_parked of non-parked block {b}")
        self._parked.remove(b)
        self._cached.discard(b)
        self._frees[self.shard_of(b)].append(b)

    def unmark_cached(self, b: int) -> None:
        """Drop the prefix-index claim on a block whose cached chunk was
        never (or will never be) materialized — the rollback half of
        ``PrefixIndex.invalidate``.  An owned block simply loses its
        park-on-free destiny; a block already parked has no owner left to
        reach it, so it returns straight to the free list."""
        self._cached.discard(b)
        if b in self._parked:
            self._parked.remove(b)
            self._frees[self.shard_of(b)].append(b)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"BlockPool(n_blocks={self.n_blocks}, block_size={self.block_size}, "
            f"free={self.free_blocks}, parked={len(self._parked)})"
        )


class BlockTable:
    """Per-request ordered list of pool block ids.

    ``ids[i]`` backs logical token positions ``[i*bs, (i+1)*bs)``.  The
    table grows via ``extend`` at decode-chunk boundaries and releases
    everything via ``release`` at retire (a release is a refcount
    decrement: shared prefix blocks survive under their other owners or
    park in the prefix index); ``n_tokens_capacity`` is the highest
    position count the table can currently hold.

    On a sharded pool the first allocation pins the table's ``shard``
    (the pool's pick); every later grow allocates on the same shard, so
    a request's entire KV chain is resident on one shard — the
    row-affinity invariant behind the distributed dispatch's bit-parity.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.ids: list[int] = []
        self.shard: int | None = None

    @property
    def n_blocks(self) -> int:
        return len(self.ids)

    @property
    def n_tokens_capacity(self) -> int:
        return len(self.ids) * self.pool.block_size

    def extend_to(self, n_tokens: int) -> bool:
        """Grow to cover ``n_tokens`` positions.  Returns False on OOM
        (nothing allocated) — the caller's early-retire signal."""
        need = blocks_for(n_tokens, self.pool.block_size) - len(self.ids)
        if need <= 0:
            return True
        got = self.pool.try_alloc(need, shard=self.shard)
        if got is None:
            return False
        self.ids.extend(got)
        self.shard = self.pool.shard_of(self.ids[0])
        return True

    def adopt(self, ids) -> None:
        """Seed the table with already-accounted blocks (shared prefix
        chain + freshly alloc'd suffix blocks, in logical order)."""
        assert not self.ids, "adopt into a non-empty table"
        self.ids = list(ids)
        self.shard = self.pool.shard_of(self.ids[0]) if self.ids else None

    def release(self) -> None:
        if self.ids:
            self.pool.free(self.ids)
            self.ids = []
        self.shard = None


class HostBlockStore:
    """Bounded host-RAM tier for demoted prefix-cache chunks.

    Holds opaque per-chunk payloads (whatever the engine's
    ``fetch_block`` produced — this module never looks inside) under a
    hard ``max_bytes`` budget.  ``put`` makes room by asking its
    registered ``evictor`` (the ``PrefixIndex``) to drop LRU spilled
    leaves; if the budget still cannot fit the payload, ``put`` returns
    False and the caller falls back to a plain eviction.  Host-only and
    jax-free, like the pool.
    """

    def __init__(self, max_bytes: int):
        if max_bytes <= 0:
            raise ValueError(f"HostBlockStore needs a positive byte budget, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.used_bytes = 0
        self._entries: dict[Any, tuple[Any, int]] = {}
        self.evictor: Any = None  # PrefixIndex registers itself here
        # lifetime counters (observability)
        self.n_puts = 0
        self.n_drops = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def put(self, key, payload, nbytes: int) -> bool:
        """Store ``payload`` under ``key``; True on success.  Makes room
        by dropping LRU spilled leaves via the evictor; refuses (False,
        nothing stored) if the payload cannot fit the budget at all."""
        nbytes = int(nbytes)
        if key in self._entries:
            raise ValueError(f"duplicate spill key {key!r}")
        if nbytes > self.max_bytes:
            return False
        while self.used_bytes + nbytes > self.max_bytes:
            if self.evictor is None or not self.evictor.drop_one_spilled():
                return False
        self._entries[key] = (payload, nbytes)
        self.used_bytes += nbytes
        self.n_puts += 1
        return True

    def peek(self, key):
        """Payload for ``key`` without removing it (COW-from-host reads
        the chunk's content but leaves the spilled entry authoritative)."""
        return self._entries[key][0]

    def pop(self, key):
        """Remove and return the payload for ``key`` (re-admission moves
        the chunk back to the device tier)."""
        payload, nbytes = self._entries.pop(key)
        self.used_bytes -= nbytes
        return payload

    def drop(self, key) -> None:
        """Discard an entry (store-pressure eviction bookkeeping)."""
        self.pop(key)
        self.n_drops += 1

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"HostBlockStore(entries={len(self._entries)}, "
            f"used={self.used_bytes}/{self.max_bytes}B)"
        )


class _Node:
    """One cached chunk: trie node keyed by its chunk tokens under its
    parent.  Device-backed (``block`` is a pool id) or spilled
    (``block is None``; payload lives in the host store keyed by this
    node).  ``shard`` is the owning shard recorded when the chunk was
    first cached; it survives demotion (``block is None`` keeps the
    coordinate) so re-admission can ``device_put`` the payload back onto
    the same shard's pool slice."""

    __slots__ = ("chunk", "block", "parent", "children", "stamp", "shard")

    def __init__(self, chunk: tuple, block: int | None, parent: "_Node | None", stamp: int,
                 shard: int = 0):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.stamp = stamp
        self.shard = shard


class PrefixPlan:
    """Admission plan for one prompt: what to share, re-admit, copy, and
    allocate.

    ``shared``: cached device blocks adopted by reference (refcount +1
    each).
    ``readmit``: spilled chain nodes to bring back to the device tier —
    each gets a fresh block at ``commit`` and its host payload is
    returned for the engine to upload.
    ``cow_src``: cached device block to copy-on-write, or None.  Set
    exactly when the cache holds the *entire* prompt on device and the
    prompt ends on a block boundary: the suffix is then the single last
    prompt token (we still need its logits for the first decode token)
    and its K/V write at position ``L - 1`` would mutate the shared
    boundary block — so that block is duplicated into a private copy
    first.  When the boundary chunk is *spilled* instead
    (``host_cow``), no device copy exists or is needed: the host payload
    uploads straight into the request's private block and the spilled
    entry stays authoritative.
    ``n_fresh``: private blocks to allocate beyond shared + re-admitted +
    COW copy (suffix prompt blocks + the first decode block).
    ``start``: first prompt position the engine must actually prefill;
    positions ``< start`` ride in shared/re-admitted blocks.
    ``uploads``: filled by ``commit`` — ``(payload, block)`` pairs the
    engine must ``device_put`` before the row's first dispatch.
    """

    __slots__ = ("tokens", "nodes", "shared", "readmit", "cow_node", "cow_src",
                 "host_cow", "n_fresh", "start", "n_tokens", "uploads", "shard")

    def __init__(self, tokens, nodes, shared, readmit, cow_node, n_fresh, start, n_tokens,
                 shard: int = 0):
        self.tokens = tokens
        self.nodes = nodes  # matched trie nodes, root-first
        self.shared = shared  # device block ids shared by reference
        self.readmit = readmit  # spilled chain nodes needing fresh blocks
        self.cow_node = cow_node  # boundary node for a full-prefix hit, or None
        self.cow_src = None if cow_node is None else cow_node.block  # device id or None
        self.host_cow = cow_node is not None and cow_node.block is None
        self.n_fresh = n_fresh
        self.start = start
        self.n_tokens = n_tokens  # L (prompt length within the window)
        self.uploads: list[tuple[Any, int]] = []
        self.shard = shard  # every block in this plan lives here


class PrefixIndex:
    """Hash-chain trie over ``block_size``-token chunks of prompt ids.

    Registers itself as the pool's evictor: under allocation pressure the
    least-recently-used parked chunk whose children are already
    off-device is *demoted* to the host tier (``spill_store`` +
    ``fetch_block`` set) or evicted outright, its device block recycled.
    Lookup walks the trie chunk by chunk for the longest cached prefix
    across both tiers; ``plan`` turns a lookup into an admission plan
    (shared device chain, spilled chunks to re-admit, optional COW
    boundary copy, fresh-block count) and checks feasibility against the
    pool without mutating anything.  The index survives the serve loop
    that populated it — a resident engine re-uses it across calls.
    """

    def __init__(self, pool: BlockPool, spill_store: HostBlockStore | None = None,
                 fetch_block: Callable[[int], tuple[Any, int]] | None = None):
        self.pool = pool
        self.block_size = pool.block_size
        self._root = _Node((), -1, None, 0)
        self._node_of_block: dict[int, _Node] = {}
        self._spilled: set[_Node] = set()
        self._clock = 0
        pool.evictor = self
        self.spill_store = spill_store
        self.fetch_block = fetch_block
        if spill_store is not None:
            if fetch_block is None:
                raise ValueError("spill_store needs a fetch_block callback to demote")
            spill_store.evictor = self
        # commit-in-progress protection: chain nodes about to re-admit
        # must not be dropped by store pressure mid-commit
        self._pinned_spilled: set[_Node] = set()
        # lifetime tier-traffic counters (engine reports deltas per pass)
        self.n_demotions = 0
        self.n_readmits = 0

    # ---- observability ----
    @property
    def n_cached_blocks(self) -> int:
        """Device-tier cached chunks."""
        return len(self._node_of_block)

    @property
    def n_spilled(self) -> int:
        """Host-tier cached chunks."""
        return len(self._spilled)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _chunks(tokens, bs: int):
        L = len(tokens)
        for i in range(L // bs):
            yield tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])

    def lookup(self, tokens) -> list[_Node]:
        """Longest cached prefix: matched trie nodes, root-first.  The
        chain may cross the tier boundary — device-backed nodes first,
        then spilled ones (demotion is leaf-first, so device nodes always
        form a prefix of the chain)."""
        node, out = self._root, []
        for chunk in self._chunks(tokens, self.block_size):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            out.append(nxt)
            node = nxt
        return out

    def plan(self, tokens, n_reserve_tokens: int | None = None) -> PrefixPlan | None:
        """Admission plan for ``tokens`` (already window-truncated), or
        None when the pool cannot cover it even after evicting every
        parked block not needed by the plan itself.  Pure: nothing is
        shared, allocated, re-admitted, or evicted until ``commit``.

        ``n_reserve_tokens`` defaults to ``len(tokens) + 1`` — prompt
        plus the first decode token, exactly what the admission gate
        reserves so same-pass admits can never starve each other."""
        L = len(tokens)
        n_total = blocks_for(
            L + 1 if n_reserve_tokens is None else n_reserve_tokens, self.block_size
        )
        nodes = self.lookup(tokens)
        matched = len(nodes) * self.block_size
        if matched == L and nodes:
            # full-prefix hit ending on a block boundary: recompute only
            # the last prompt token (its logits seed decode) and COW the
            # boundary block its K/V write would otherwise mutate
            start, chain, cow = L - 1, nodes[:-1], nodes[-1]
        else:
            start, chain, cow = matched, nodes, None
        shared = [n.block for n in chain if n.block is not None]
        readmit = [n for n in chain if n.block is None]
        n_fresh = n_total - len(chain) - (1 if cow is not None else 0)
        need = n_fresh + len(readmit) + (1 if cow is not None else 0)
        # row affinity: a matched chain pins the plan to the chain's
        # recorded shard (re-admitted chunks go back where they lived);
        # a cold miss goes to the shard with the most headroom
        shard = nodes[0].shard if nodes else self.pool.pick_shard(need)
        # feasibility: fresh + re-admitted + COW copy must come from free
        # blocks plus parked blocks ON THE PLAN'S SHARD and OUTSIDE the
        # plan's own device chain (evicting a block we are about to
        # share/copy is self-defeating)
        pinned = {n.block for n in nodes if n.block is not None}
        reclaimable = sum(
            1 for b in self.pool._parked
            if b not in pinned and self.pool.shard_of(b) == shard
        )
        if need > self.pool.free_blocks_by_shard[shard] + reclaimable:
            return None
        return PrefixPlan(tokens, nodes, shared, readmit, cow, n_fresh, start, L,
                          shard=shard)

    def commit(self, plan: PrefixPlan) -> tuple[list[int], int | None]:
        """Execute a plan: acquire the shared device chain (share /
        reactivate), re-admit spilled chain chunks (fresh block each,
        host payload queued on ``plan.uploads`` for the engine's
        device_put), allocate the COW copy and fresh blocks (demoting or
        evicting parked blocks under pressure — the chain is pinned
        first, so eviction can never touch it), and register the prompt
        chunks this request will compute.  Returns ``(table_ids,
        cow_dst)``: the request's block table in logical order, and the
        private boundary-copy destination (None when no COW is needed).

        When ``cow_dst`` is not None AND ``plan.cow_src`` is a device
        block, the source is returned STILL PINNED (refcount +1): the
        caller must ``pool.free([cow_src])`` only after dispatching the
        device copy.  A *spilled* boundary chunk (``plan.host_cow``)
        needs no device copy — its payload rides ``plan.uploads`` into
        the private block directly and nothing stays pinned."""
        pool, stamp = self.pool, self._tick()
        for n in plan.nodes:
            n.stamp = stamp  # LRU touch on every matched chunk, both tiers
        # 1. pin the device chain before any allocation can evict it;
        #    pin the spilled chain against store-pressure drops mid-commit
        for b in plan.shared:
            if pool.is_parked(b):
                pool.reactivate([b])
            else:
                pool.share([b])
        cow = plan.cow_node is not None
        dev_cow = cow and not plan.host_cow
        if dev_cow:
            # pin the source so allocation pressure cannot evict it before
            # the engine's device copy reads it (eviction never touches
            # refcount >= 1).  The pin survives commit — the caller
            # releases it after dispatching the copy
            if pool.is_parked(plan.cow_src):
                pool.reactivate([plan.cow_src])
            else:
                pool.share([plan.cow_src])
        self._pinned_spilled = set(plan.readmit)
        if plan.host_cow:
            self._pinned_spilled.add(plan.cow_node)
        try:
            got = pool.alloc(
                plan.n_fresh + len(plan.readmit) + (1 if cow else 0),
                shard=plan.shard,
            )
        except BlockPoolOOM:
            # plan() said feasible and the consumer is single-threaded,
            # so this means the caller raced the pool — unwind loudly
            if dev_cow:
                pool.free([plan.cow_src])
            if plan.shared:
                pool.free(plan.shared)
            raise
        finally:
            self._pinned_spilled = set()
        k = 0
        plan.uploads = []
        # 2. re-admit spilled chain chunks in root-first order: fresh
        #    device block, table repoint, payload queued for upload.  The
        #    block is owned (refcount 1) by this request and cached — on
        #    retire it parks again like any device-tier chunk
        for node in plan.readmit:
            b = got[k]
            k += 1
            node.block = b
            self._spilled.discard(node)
            self._node_of_block[b] = node
            pool.mark_cached(b)
            plan.uploads.append((self.spill_store.pop(node), b))
            self.n_readmits += 1
        cow_dst = None
        if cow:
            cow_dst = got[k]
            k += 1
            if plan.host_cow:
                # boundary content comes from the host tier: upload into
                # the private block, spilled entry stays authoritative
                plan.uploads.append((self.spill_store.peek(plan.cow_node), cow_dst))
                self.n_readmits += 1
        fresh = got[k:]
        chain = plan.nodes[:-1] if cow else plan.nodes
        table = [n.block for n in chain] + ([cow_dst] if cow_dst is not None else []) + fresh
        # 3. register the full prompt chunks this request computes (the
        # COW copy stays private: its original chunk is already cached)
        node = plan.nodes[-1] if plan.nodes else self._root
        chunks = list(self._chunks(plan.tokens, self.block_size))
        for i in range(len(plan.nodes), len(chunks)):
            node = self._insert_child(node, chunks[i], table[i], stamp)
        return table, cow_dst

    def _insert_child(self, parent: _Node, chunk: tuple, block: int, stamp: int) -> _Node:
        assert chunk not in parent.children, "duplicate chunk insert"
        node = _Node(chunk, block, parent, stamp, shard=self.pool.shard_of(block))
        parent.children[chunk] = node
        self._node_of_block[block] = node
        self.pool.mark_cached(block)
        return node

    def invalidate(self, block_ids) -> None:
        """Unregister chunks that were committed but never materialized —
        the rollback path when an admission is force-done (dependency
        deadlock) or its serve loop is abandoned before its prefill ran.
        Leaf-first, like eviction, so every surviving chain stays
        root-reachable; a chunk whose children are NOT in the same
        invalidation set would orphan a live chain and raises instead
        (callers force-done whole dependent groups, so descendants of an
        invalidated chunk are always invalidated too).  Blocks stay owned
        by the caller's table — ``unmark_cached`` only removes the
        park-on-free claim, so the subsequent table release recycles them
        as plain blocks."""
        todo = [b for b in block_ids if b in self._node_of_block]
        while todo:
            progressed = False
            for b in list(todo):
                node = self._node_of_block[b]
                if node.children:
                    continue  # interior: wait for its chunks to go first
                del node.parent.children[node.chunk]
                del self._node_of_block[b]
                self.pool.unmark_cached(b)
                todo.remove(b)
                progressed = True
            if not progressed:
                raise ValueError(
                    f"invalidate of chunk(s) with live cached children: {todo}"
                )

    # ---- eviction / demotion (BlockPool.evictor protocol) ----
    def _demotable(self, node: _Node) -> bool:
        """Leaf-first across the tier boundary: a chunk may leave the
        device tier only once every child is already off-device."""
        return all(c.block is None for c in node.children.values())

    def _drop_spilled_subtree(self, node: _Node) -> None:
        """Remove every spilled descendant of ``node`` from the trie and
        the store (deepest-first) — the hard-eviction path when a chunk
        with spilled children must leave the trie entirely."""
        for child in list(node.children.values()):
            self._drop_spilled_subtree(child)
            self.spill_store.drop(child)
            self._spilled.discard(child)
            del node.children[child.chunk]

    def evict_one(self, shard: int | None = None) -> bool:
        """Free one device block from the cache, LRU-first among parked
        chunks whose children are already off-device.  With a spill
        store the chunk is *demoted* (payload fetched to host, node
        repointed off-device); without one — or when the store cannot fit
        it — the chunk (and any spilled subtree chaining on it) is
        dropped outright.  ``shard`` restricts victims to that shard's
        blocks (shard-local allocation pressure must free shard-local
        blocks).  Returns False when nothing is reclaimable."""
        cands: list[_Node] = []
        for b in self.pool._parked:
            if shard is not None and self.pool.shard_of(b) != shard:
                continue
            node = self._node_of_block.get(b)
            if node is None or not self._demotable(node):
                continue
            cands.append(node)
        cands.sort(key=lambda n: n.stamp)
        for victim in cands:
            b = victim.block
            if self.spill_store is not None:
                payload, nbytes = self.fetch_block(b)
                if self.spill_store.put(victim, payload, nbytes):
                    victim.block = None
                    self._spilled.add(victim)
                    del self._node_of_block[b]
                    self.pool.recycle_parked(b)
                    self.n_demotions += 1
                    return True
                # the store cannot hold this chunk: fall through to a
                # plain eviction (its spilled subtree must go with it)
            if victim.children:
                if self.spill_store is None:
                    continue  # interior chunk with off-device children: skip
                self._drop_spilled_subtree(victim)
            del victim.parent.children[victim.chunk]
            del self._node_of_block[b]
            self.pool.recycle_parked(b)
            return True
        return False

    # ---- host-store pressure (HostBlockStore.evictor protocol) ----
    def drop_one_spilled(self) -> bool:
        """Drop the LRU spilled *leaf* from the host tier (then the chunk
        is really gone and costs a re-prefill, like a plain eviction).
        Chunks pinned by an in-progress ``commit`` are never dropped."""
        victim: _Node | None = None
        for node in self._spilled:
            if node.children or node in self._pinned_spilled:
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        self.spill_store.drop(victim)
        self._spilled.discard(victim)
        del victim.parent.children[victim.chunk]
        return True
