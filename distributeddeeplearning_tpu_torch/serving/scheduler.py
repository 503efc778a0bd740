"""Host-side serving state: requests, the KV block pool, and the
continuous-batching scheduler.

A copy of the JAX package's ``serving/scheduler.py`` (pure Python, so it
runs unchanged here), less what only the replica router calls (the trie's
digest summary) and what only tests call (a subtree eviction, a flush);
``tests/test_torch_serving.py`` replays traces through both and requires
the same end state. The device half (the pool tensors these blocks index
into) lives in ``serving/engine.py``.

Design:

- **KVBlockPool** — a free-list allocator over ``num_blocks`` fixed-size
  blocks of the device-side KV pool. Block 0 is reserved as the NULL block
  (idle decode slots point their whole page table at it), so user blocks
  are ``1..num_blocks-1``. Allocation is all-or-nothing per request.
- **Prefix cache** (``prefix_cache=True``) — full KV blocks become
  immutable and content-addressed once *published* into a hash-chained
  prefix trie: block hash = ``H(parent_hash, block_token_ids)`` (blake2b,
  so a hash names the whole token prefix up to and including the block,
  and equal prefixes dedupe regardless of which request wrote them).
  Cached blocks carry a refcount (live requests mapping the block into
  their page table, or holding published descendants below it —
  ``publish`` pins the existing chain it continues through so a parent
  never drops to refcount 0 above a refcount>0 child) and a logical LRU
  tick; ``alloc`` evicts refcount-0 nodes leaf-first under pressure, so
  capacity = free list + evictable cache. A block is in exactly one of three states: free, request-owned
  (``_allocated``), or cached (``_cached``) — conservation over the three
  is a tested invariant.
- **Host spill tier** (``spill_blocks > 0``) — eviction demotes instead
  of destroys: the victim's trie node survives with a negative host id
  and no device block while the engine parks its KV in host RAM (the
  pool stays jax-free via ``spill_fn``/``drop_fn`` callbacks). Admission
  matches straight through spilled nodes; ``promote`` re-keys them onto
  fresh device blocks and the engine uploads the payload. The device
  conservation invariant is unchanged (``used + free + cached_device ==
  num_blocks - 1``); the host ledger is separate, capped by
  ``spill_blocks`` with its own LRU — the second eviction is final.
- **Scheduler** — FIFO admission into ``slots`` decode lanes. A queued
  request is admitted when a lane is free AND the pool can hold its whole
  worst-case sequence (prompt bucket + ``max_new_tokens``, rounded up to
  blocks). With the prefix cache on, the reservation counts only the
  *uncached suffix* blocks — trie-matched blocks are mapped at refcount+1
  instead of reallocated, so high-hit-rate traffic is not shed on phantom
  memory pressure. Reserving up front means a running request can never
  hit a mid-flight allocation failure — no preemption machinery in v1, at
  the cost of conservative occupancy (the tradeoff is documented and the
  high-water stats expose it).
- Requests join and leave **mid-flight**: every engine step first retires
  finished lanes (freeing their blocks), then admits from the queue into
  whatever lanes are open — the decode batch never drains to refill.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import pickle
from collections import deque


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV entries (ceil division)."""
    return -(-tokens // block_size)


def ngram_draft(tokens: list[int], k: int, *, max_ngram: int = 3,
                min_ngram: int = 1) -> list[int]:
    """Self-drafting by prompt/history lookup: propose up to ``k``
    continuation tokens for the stream ``tokens`` by finding an earlier
    occurrence of the stream's trailing n-gram and copying what followed
    it. Longest n first (``max_ngram`` down to ``min_ngram``) so a
    specific context beats a common bigram; among matches of that n, the
    most recent one with a FULL k-token continuation wins (recent context
    is the best predictor of what the stream does next) — and if no match
    has k tokens before end-of-history, the leftmost (longest-window)
    match is used. Without that fallback a greedy run of one repeated
    token — the single most draftable stream there is — would always
    match one position back and draft a single token, capping the whole
    speedup at 2x. Returns ``[]`` when no n-gram recurs — the engine then
    runs a plain one-token decode step, so drafting can only add
    coverage, never block it.

    This is the no-second-model draft source (prompt-lookup decoding):
    greedy LM output is locally repetitive — copied spans, code idioms,
    loops — and every correctly-drafted token is one decode step the
    verify forward amortizes away. Pure Python on purpose: it runs on the
    host scheduler tick and is unit-testable without a device."""
    if k < 1:
        raise ValueError(f"ngram_draft(k={k})")
    n_toks = len(tokens)
    for n in range(min(max_ngram, n_toks - 1), min_ngram - 1, -1):
        suffix = tokens[n_toks - n:]
        # Scan right-to-left; continuation width n_toks - (s + n) only
        # GROWS as s moves left, so the first full-window match is the
        # most recent one, and the last match seen is the widest fallback.
        # s + n <= n_toks - 1 guarantees >= 1 continuation token exists.
        best = None
        for s in range(n_toks - n - 1, -1, -1):
            if tokens[s:s + n] == suffix:
                best = s
                if n_toks - (s + n) >= k:
                    break
        if best is not None:
            return tokens[best + n:best + n + k]
    return []


_ROOT_HASH = b""  # chain hash of the empty prefix (the trie root)


def chain_digests(tokens, block_size: int) -> list[bytes]:
    """Chain hashes of every full block covering a strict prefix of
    ``tokens`` — the same cap as :meth:`KVBlockPool.match` (at least one
    token is always left to compute), so ``match_digests(chain_digests(
    t, bs))`` equals ``len(match(t))`` on any pool with that block size.

    Computed ONCE per request at the router and passed to every replica
    probe: O(prompt) hashing total instead of O(replicas x prompt) when
    each replica re-chains the prompt itself."""
    if not tokens:
        return []
    n_full = (len(tokens) - 1) // block_size
    out: list[bytes] = []
    parent = _ROOT_HASH
    for k in range(n_full):
        parent = _block_hash(
            parent, tokens[k * block_size:(k + 1) * block_size]
        )
        out.append(parent)
    return out


def _block_hash(parent_hash: bytes, tokens) -> bytes:
    """Chain hash of one full block: ``H(parent_hash, block_token_ids)``.

    blake2b over the parent digest + the block's token ids, so a hash
    names the entire token prefix ending at this block — two blocks
    collide only if their whole prefixes match, which is exactly when
    sharing their KV is correct. A real digest (not Python ``hash``):
    a silent integer-hash collision would alias one request's KV into
    another's attention window."""
    h = hashlib.blake2b(parent_hash, digest_size=16)
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


class _PrefixNode:
    """One cached (published) block in the prefix trie."""

    __slots__ = ("chain_hash", "parent", "children", "refs", "last_use",
                 "depth")

    def __init__(self, chain_hash: bytes, parent: int | None, refs: int,
                 last_use: int, depth: int):
        self.chain_hash = chain_hash
        self.parent = parent          # parent block id (None = trie root)
        self.children: set[int] = set()
        self.refs = refs              # live requests mapping this block
        self.last_use = last_use      # logical LRU tick
        self.depth = depth            # chain length in blocks (1-based)


class KVBlockPool:
    """Free-list allocator over the paged KV pool's physical blocks.

    ``alloc(n)`` returns a list of n block ids or ``None`` (never partial);
    ``free(ids)`` returns them. Double-free and freeing the null block are
    hard errors — a leak here silently corrupts another request's KV.

    With ``prefix_cache=True`` the pool additionally runs the
    content-addressed prefix trie (module docstring): ``match`` finds the
    longest cached chain for a prompt, ``acquire``/``release`` move its
    refcounts, ``publish`` turns request-owned full blocks immutable and
    shareable, and ``alloc`` reclaims refcount-0 cache nodes LRU-leaf-first
    when the free list alone cannot satisfy a reservation. The LRU clock is
    a logical tick (bumped on every acquire/publish), not wall time, so
    eviction order is deterministic and testable."""

    NULL_BLOCK = 0

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = False, spill_blocks: int = 0,
                 spill_fn=None, drop_fn=None):
        if num_blocks < 2:
            raise ValueError(
                f"KV pool needs >= 2 blocks (1 null + 1 usable), got "
                f"{num_blocks} — raise serving.hbm_budget_mb or shrink "
                "serving.block_size"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if spill_blocks < 0:
            raise ValueError(
                f"serving.spill_blocks must be >= 0, got {spill_blocks}"
            )
        if spill_blocks and not prefix_cache:
            raise ValueError(
                "spill_blocks > 0 with prefix_cache=False — the host tier "
                "stores evicted TRIE nodes; without the trie there is "
                "nothing to spill. Set serving.prefix_cache=True or "
                "spill_blocks=0."
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache)
        self.spill_blocks = int(spill_blocks)
        # Host-tier callbacks (the engine wires these; the pool stays
        # pure Python): ``spill_fn(pairs)`` receives
        # ``[(block_id, chain_hash), ...]`` BEFORE any spilled block can be
        # reused — the engine must capture the device KV then;
        # ``drop_fn(chain_hash)`` releases the host payload when a host
        # node leaves the trie (final eviction, promotion-by-adoption).
        self._spill_fn = spill_fn
        self._drop_fn = drop_fn
        # LIFO free list: recently-freed (cache-warm) blocks are reused
        # first, and page-table reuse after completion is deterministic.
        self._free = list(range(num_blocks - 1, 0, -1))
        self._allocated: set[int] = set()
        self.high_water = 0
        # Prefix trie state (empty and inert when prefix_cache is off).
        # Node ids span two tiers: POSITIVE ids are device blocks (they
        # index the paged pool); NEGATIVE ids are host-tier nodes whose KV
        # lives in the engine's spill store, keyed by chain hash. _by_hash
        # spans both tiers, so match() walks through spilled nodes for
        # free.
        self._cached: dict[int, _PrefixNode] = {}   # node id -> node
        self._by_hash: dict[bytes, int] = {}        # chain hash -> node id
        self._next_hid = -1                         # next host-tier id
        self._tick = 0
        self.evictions = 0
        self.published_total = 0
        self.spills = 0
        self.promotes = 0
        self.adoptions = 0
        self.final_evictions = 0
        self.chain_adoptions = 0  # blocks grafted from a wire handoff

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._allocated)

    @property
    def cached_blocks(self) -> int:
        """Device-tier cache nodes (each holds one physical block)."""
        return sum(1 for b in self._cached if b > 0)

    @property
    def spilled_blocks(self) -> int:
        """Host-tier cache nodes (KV in the engine's spill store, no
        device block) — the spilled ledger, capped by ``spill_blocks``."""
        return sum(1 for b in self._cached if b < 0)

    @property
    def evictable_blocks(self) -> int:
        """Device cache nodes no live request maps (refcount 0) —
        reclaimable by ``alloc`` (spilled to host when the budget allows,
        dropped otherwise). Host nodes never back a reservation."""
        return sum(
            1 for b, nd in self._cached.items() if b > 0 and nd.refs == 0
        )

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + self.evictable_blocks

    def alloc(self, n: int) -> list[int] | None:
        if n < 1:
            raise ValueError(f"alloc({n})")
        if not self.can_alloc(n):
            return None
        spill_batch: list[tuple[int, bytes]] = []
        while len(self._free) < n:
            self._evict_one(spill_batch)
        if spill_batch and self._spill_fn is not None:
            # One callback per eviction BATCH (the engine coalesces it
            # into a single device_get), before any freed block is popped
            # for reuse — the KV is still intact on device here.
            self._spill_fn(spill_batch)
        got = [self._free.pop() for _ in range(n)]
        self._allocated.update(got)
        self.high_water = max(self.high_water, len(self._allocated))
        return got

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == self.NULL_BLOCK:
                raise ValueError("freeing the null block")
            if b not in self._allocated:
                raise ValueError(f"double/foreign free of block {b}")
            self._allocated.remove(b)
            self._free.append(b)

    # -- prefix trie -------------------------------------------------------

    def match(self, tokens: list[int]) -> list[int]:
        """Longest cached chain of FULL blocks covering a strict prefix of
        ``tokens``: the hit is capped at ``(len(tokens) - 1) // block_size``
        blocks so at least one token is always left to compute (the model
        must run to sample the next token) and every KV write a request
        performs lands in its own freshly-allocated blocks — published
        blocks stay immutable. Read-only: no refcount or LRU effect, so
        the router can probe replicas' tries for free."""
        if not self.prefix_cache or not tokens:
            return []
        n_full = (len(tokens) - 1) // self.block_size
        blocks: list[int] = []
        parent = _ROOT_HASH
        for k in range(n_full):
            chunk = tokens[k * self.block_size:(k + 1) * self.block_size]
            parent = _block_hash(parent, chunk)
            b = self._by_hash.get(parent)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def match_len(self, tokens: list[int]) -> int:
        """Tokens of ``tokens`` whose KV is already cached (the replica
        trie digest ``prefix_affinity`` routing scores against)."""
        return len(self.match(tokens)) * self.block_size

    def match_digests(self, digests: list[bytes]) -> int:
        """Count of leading ``digests`` present in the trie (either tier)
        — the pre-hashed probe the router uses so chain hashing happens
        once per request instead of once per replica. Equals
        ``len(match(tokens))`` when ``digests = chain_digests(tokens,
        block_size)``. Read-only, like :meth:`match`."""
        if not self.prefix_cache:
            return 0
        n = 0
        for d in digests:
            if d not in self._by_hash:
                break
            n += 1
        return n

    def digest_summary(self, limit: int = 0) -> list[bytes]:
        """The trie's chain digests (both tiers), most-recently-used
        first, capped at ``limit`` (0 = all). This is the summary a
        fleet worker pushes in its heartbeat so the router's
        ``prefix_affinity`` probe runs on a local set instead of a
        cross-process round trip. A digest names its ENTIRE prefix
        chain (``_block_hash`` chains through the parent), so plain set
        membership router-side reproduces :meth:`match_digests` — no
        tree structure needs to travel."""
        if not self.prefix_cache or not self._cached:
            return []
        nodes = sorted(
            self._cached.values(), key=lambda nd: nd.last_use,
            reverse=True,
        )
        if limit:
            nodes = nodes[:limit]
        return [nd.chain_hash for nd in nodes]

    def acquire(self, blocks: list[int]) -> None:
        """Map cached blocks into a request: refcount+1 and LRU-touch the
        whole chain (one shared tick — a parent is never staler than its
        children, which is what makes plain LRU leaf-first)."""
        if not blocks:
            return
        self._tick += 1
        for b in blocks:
            nd = self._cached[b]
            nd.refs += 1
            nd.last_use = self._tick

    def release(self, blocks: list[int]) -> None:
        """Drop a request's refcounts. Refcount-0 nodes stay cached (warm)
        until eviction pressure reclaims them."""
        for b in blocks:
            nd = self._cached.get(b)
            if nd is None:
                raise ValueError(f"releasing uncached block {b}")
            if nd.refs < 1:
                raise ValueError(f"refcount underflow on cached block {b}")
            nd.refs -= 1

    def publish(self, tokens: list[int], blocks: list[int], *,
                refs: int) -> tuple[list[int], list[int]]:
        """Publish full blocks into the trie: ``blocks[k]`` holds the KV of
        ``tokens[k*bs:(k+1)*bs]``. Walks the chain from the root; blocks
        already in the trie are skipped, a block whose content hash is
        already cached under a DIFFERENT block id stays request-owned (the
        existing copy wins; ours is freed normally at completion), and
        newly published blocks move from ``_allocated`` to the cache at
        refcount ``refs`` (1 when the publishing request keeps using them,
        0 at completion). Returns ``(published, traversed)``: the newly
        published block ids and the already-cached ids the chain continued
        through. With ``refs > 0`` each traversed node's refcount is
        incremented — the publisher's new nodes hang below the traversed
        chain, and without the refcount the chain's original owner could
        release it to 0 while our refcount>0 children live, breaking the
        closed-under-descendants invariant leaf-first eviction relies on
        (``evictable_blocks`` would count pinned interior nodes that
        ``_evict_one`` can never reclaim). The caller must release
        ``traversed`` at completion, exactly like ``published``."""
        if not self.prefix_cache:
            return [], []
        if len(blocks) * self.block_size > len(tokens):
            raise ValueError("publish: blocks cover more tokens than given")
        self._tick += 1
        published: list[int] = []
        traversed: list[int] = []
        parent_hash = _ROOT_HASH
        parent_block: int | None = None
        for k, b in enumerate(blocks):
            chunk = tokens[k * self.block_size:(k + 1) * self.block_size]
            parent_hash = _block_hash(parent_hash, chunk)
            existing = self._by_hash.get(parent_hash)
            if existing is not None and existing < 0:
                # HOST-tier hit: the publisher holds a freshly-written
                # device copy of exactly this block's KV, so the node
                # ADOPTS it — re-keyed onto our block, a free promotion
                # with no host->device upload. The host payload is
                # redundant and dropped. Root-down walk order means a
                # parent is adopted (made device) before its child, so
                # the adopted node's parent is already device-tier.
                if b not in self._allocated:
                    raise ValueError(f"publishing unowned block {b}")
                self._allocated.remove(b)
                nd = self._cached.pop(existing)
                self._cached[b] = nd
                self._by_hash[parent_hash] = b
                if nd.parent is not None:
                    p = self._cached[nd.parent]
                    p.children.discard(existing)
                    p.children.add(b)
                for c in nd.children:
                    self._cached[c].parent = b
                nd.last_use = self._tick
                if refs > 0:
                    nd.refs += 1
                self.adoptions += 1
                if self._drop_fn is not None:
                    self._drop_fn(parent_hash)
                published.append(b)
                self.published_total += 1
                parent_block = b
                continue
            if existing is not None:
                # Already cached (possibly by us, possibly a duplicate in
                # another block) — the chain continues through the cached
                # copy either way.
                nd = self._cached[existing]
                nd.last_use = self._tick
                if refs > 0:
                    nd.refs += 1
                    traversed.append(existing)
                parent_block = existing
                continue
            if b not in self._allocated:
                raise ValueError(f"publishing unowned block {b}")
            self._allocated.remove(b)
            nd = _PrefixNode(parent_hash, parent_block, refs, self._tick,
                             depth=k + 1)
            self._cached[b] = nd
            self._by_hash[parent_hash] = b
            if parent_block is not None:
                self._cached[parent_block].children.add(b)
            published.append(b)
            self.published_total += 1
            parent_block = b
        return published, traversed

    def _drop_node(self, b: int) -> None:
        """Remove one childless cache node. Device nodes (b > 0) return
        their block to the free list; host nodes (b < 0) release their
        spill-store payload via ``drop_fn`` instead — no device block to
        return."""
        nd = self._cached.pop(b)
        if nd.children:
            raise ValueError(f"dropping cache node {b} with children")
        del self._by_hash[nd.chain_hash]
        if nd.parent is not None:
            self._cached[nd.parent].children.discard(b)
        if b > 0:
            self._free.append(b)
            self.evictions += 1
        elif self._drop_fn is not None:
            self._drop_fn(nd.chain_hash)

    def promote(self, host_ids: list[int],
                blocks: list[int]) -> list[tuple[int, bytes]]:
        """Re-key host-tier nodes onto freshly-allocated device blocks
        (``host_ids[k]`` -> ``blocks[k]``, chain order: a parent promotes
        before its child, keeping host subtrees strictly below device
        nodes). The caller owns ``blocks`` via ``alloc`` and must have
        ``acquire``d the matched chain first, so a promoted node carries
        refcount >= 1 and cannot be re-spilled before its KV upload lands.
        Returns ``[(block_id, chain_hash), ...]`` — the engine uploads the
        spill-store payload for each hash into its block, then drops the
        host copy."""
        out: list[tuple[int, bytes]] = []
        for h, b in zip(host_ids, blocks):
            if h >= 0:
                raise ValueError(f"promoting device-tier node {h}")
            if b not in self._allocated:
                raise ValueError(f"promoting onto unowned block {b}")
            self._allocated.remove(b)
            nd = self._cached.pop(h)
            self._cached[b] = nd
            self._by_hash[nd.chain_hash] = b
            if nd.parent is not None:
                p = self._cached[nd.parent]
                p.children.discard(h)
                p.children.add(b)
            for c in nd.children:
                self._cached[c].parent = b
            self.promotes += 1
            out.append((b, nd.chain_hash))
        return out

    def _evict_one(self, spill_batch: list | None = None) -> None:
        """Reclaim the LRU refcount-0 device node with no DEVICE children.
        One always exists when ``evictable_blocks > 0``: a request
        acquires/publishes whole chains from the root, so a refcount>0
        child implies a refcount>0 parent — the refcount-0 set is closed
        under descendants, and its deepest DEVICE member has only host
        children (if any). Ties break on block id, so the order is fully
        deterministic under the logical clock.

        With ``spill_blocks == 0`` the victim is dropped (no host
        tier). Otherwise it is SPILLED: the trie node survives,
        re-keyed onto a fresh negative host id, its device block returns
        to the free list, and ``(block, chain_hash)`` is appended to
        ``spill_batch`` (or ``spill_fn`` is called immediately when no
        batch is given) so the engine captures the KV before reuse. When
        the host ledger is at budget, the LRU refcount-0 host LEAF is
        final-evicted first — the second eviction is final; ties break on
        earliest-spilled (smallest ``-h``)."""
        best = None
        for b, nd in self._cached.items():
            if b > 0 and nd.refs == 0 and not any(
                c > 0 for c in nd.children
            ):
                key = (nd.last_use, b)
                if best is None or key < best:
                    best = key
        if best is None:
            raise RuntimeError(
                "eviction requested with no refcount-0 leaf — refcount "
                "chain invariant violated"
            )
        b = best[1]
        if not self.spill_blocks:
            self._drop_node(b)
            return
        if self.spilled_blocks >= self.spill_blocks:
            h_best = None
            for h, nd in self._cached.items():
                if h < 0 and nd.refs == 0 and not nd.children:
                    key = (nd.last_use, -h)
                    if h_best is None or key < h_best:
                        h_best = key
            if h_best is None:
                # Ledger full of pinned/interior nodes only — cannot
                # happen in steady state (host nodes carry refcount 0 and
                # host fringes always have a leaf), but drop the device
                # victim outright rather than wedge.
                self._drop_node(b)
                return
            hb = -h_best[1]
            nd_h = self._cached[hb]
            cancelled = False
            if spill_batch is not None:
                # The victim may have been spilled EARLIER IN THIS SAME
                # alloc: its KV capture is still pending in the batch.
                # Cancel the capture instead of dropping — calling
                # drop_fn before spill_fn ran would release a payload
                # that doesn't exist yet, and the deferred capture would
                # then park a stale orphan in the store.
                for i, (_, bh) in enumerate(spill_batch):
                    if bh == nd_h.chain_hash:
                        del spill_batch[i]
                        cancelled = True
                        break
            if cancelled:
                self._cached.pop(hb)
                del self._by_hash[nd_h.chain_hash]
                if nd_h.parent is not None:
                    self._cached[nd_h.parent].children.discard(hb)
            else:
                self._drop_node(hb)
            self.final_evictions += 1
        # Spill: the node survives on the host tier; the block is freed.
        nd = self._cached.pop(b)
        h = self._next_hid
        self._next_hid -= 1
        self._cached[h] = nd
        self._by_hash[nd.chain_hash] = h
        if nd.parent is not None:
            p = self._cached[nd.parent]
            p.children.discard(b)
            p.children.add(h)
        for c in nd.children:
            self._cached[c].parent = h
        self._free.append(b)
        self.evictions += 1
        self.spills += 1
        if spill_batch is not None:
            spill_batch.append((b, nd.chain_hash))
        elif self._spill_fn is not None:
            self._spill_fn([(b, nd.chain_hash)])

    # -- cross-process chain handoff (docs/SERVING.md disaggregation) ------

    def export_chain(self, tokens) -> tuple[list[bytes], list[int]]:
        """The handoff sender's view of a prompt's cached chain: the
        leading run of ``chain_digests(tokens)`` present in the trie,
        as ``(digests, node_ids)``. Digests go in the KV-frame meta (the
        router slices/dedupes against them), node ids tell the engine
        which pool rows to capture. Read-only, like :meth:`match` —
        the caller holds refcounts (or captures within the same step)
        so the ids cannot be evicted under it."""
        digests = chain_digests(tokens, self.block_size)
        ids: list[int] = []
        for d in digests:
            b = self._by_hash.get(d)
            if b is None:
                break
            ids.append(b)
        return digests[:len(ids)], ids

    def adopt_chain(self, tokens, blocks: list[int], *,
                    start: int = 0) -> list[int]:
        """Graft a TRANSFERRED chain into the trie at refcount 0 — the
        receiving half of a prefill→decode handoff. ``blocks[j]`` is a
        request-owned (``alloc``'d) device block into which the engine
        has already scattered the KV of token block ``start + j``; the
        leading ``start`` blocks were sliced off the wire because the
        sender believed this pool already holds them, and must resolve
        here (either tier) or the graft has no parent — a stale-summary
        slice raises ``ValueError`` and the caller falls back to a cold
        prefill (correctness never depends on adoption).

        Races with local traffic resolve like :meth:`publish`: a
        position that gained a DEVICE copy since the sender sliced keeps
        the existing copy (ours is freed back); a HOST-tier hit adopts
        our freshly-written block exactly like publish's adoption branch
        (we hold real device KV for it — the transfer doubles as a free
        promotion). Returns the node id now caching each adopted
        position, parent-first."""
        if not self.prefix_cache:
            raise ValueError("adopt_chain with prefix_cache=False — the "
                             "trie IS the handoff ledger")
        bs = self.block_size
        if (start + len(blocks)) * bs > len(tokens):
            raise ValueError("adopt_chain: blocks cover more tokens than "
                             "given")
        self._tick += 1
        parent_hash = _ROOT_HASH
        parent_block: int | None = None
        for k in range(start):
            parent_hash = _block_hash(
                parent_hash, tokens[k * bs:(k + 1) * bs]
            )
            existing = self._by_hash.get(parent_hash)
            if existing is None:
                raise ValueError(
                    f"adopt_chain: leading block {k} absent — sliced "
                    "against a stale digest summary"
                )
            parent_block = existing
        out: list[int] = []
        for j, b in enumerate(blocks):
            k = start + j
            parent_hash = _block_hash(
                parent_hash, tokens[k * bs:(k + 1) * bs]
            )
            existing = self._by_hash.get(parent_hash)
            if existing is not None and existing > 0:
                # Local traffic cached this position since the sender
                # sliced — the existing copy wins, ours goes back.
                self.free([b])
                nd = self._cached[existing]
                nd.last_use = self._tick
                parent_block = existing
                out.append(existing)
                continue
            if b not in self._allocated:
                raise ValueError(f"adopting unowned block {b}")
            self._allocated.remove(b)
            if existing is not None:
                # Host-tier node: re-key it onto our block (publish's
                # adoption branch) — the wire payload we scattered IS
                # this block's KV, so the host copy is redundant.
                nd = self._cached.pop(existing)
                self._cached[b] = nd
                self._by_hash[parent_hash] = b
                if nd.parent is not None:
                    p = self._cached[nd.parent]
                    p.children.discard(existing)
                    p.children.add(b)
                for c in nd.children:
                    self._cached[c].parent = b
                nd.last_use = self._tick
                self.adoptions += 1
                if self._drop_fn is not None:
                    self._drop_fn(parent_hash)
            else:
                nd = _PrefixNode(parent_hash, parent_block, 0, self._tick,
                                 depth=k + 1)
                self._cached[b] = nd
                self._by_hash[parent_hash] = b
                if parent_block is not None:
                    self._cached[parent_block].children.add(b)
            self.published_total += 1
            self.chain_adoptions += 1
            parent_block = b
            out.append(b)
        return out

    # -- host-tier persistence --------------------------------------------

    def save_host_store(self, path: str, payloads: dict,
                        meta: dict | None = None) -> int:
        """Persist the host spill tier: every host-tier (negative-id) node
        whose KV payload is present in ``payloads`` (the engine's spill
        store, chain hash -> payload) is written with its hash-chain
        metadata. The pool stays jax-free — payloads are opaque
        host-memory objects, serialized as-is. A node whose payload is
        missing (capture still pending mid-step) is skipped rather than
        persisted dangling. Returns the number of nodes written.

        The file is restart-durable warm state, NOT a consistency
        snapshot: device-tier cache and live requests are deliberately
        excluded (their blocks die with the process)."""
        records = []
        for h, nd in self._cached.items():
            if h >= 0 or nd.chain_hash not in payloads:
                continue
            parent_hash = (
                self._cached[nd.parent].chain_hash
                if nd.parent is not None else _ROOT_HASH
            )
            records.append({
                "chain_hash": nd.chain_hash,
                "parent_hash": parent_hash,
                "depth": nd.depth,
                "last_use": nd.last_use,
                "payload": payloads[nd.chain_hash],
            })
        blob = {
            "version": 1,
            "block_size": self.block_size,
            "meta": dict(meta) if meta else {},
            "records": records,
        }
        # Written aside, then renamed over the last file: a worker killed
        # mid-write (the fleet supervisor SIGKILLs a stalled or hung one)
        # leaves the previous file whole for its restart to re-warm from.
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        os.replace(tmp, path)
        return len(records)

    def load_host_store(self, path: str,
                        expect_meta: dict | None = None) -> dict:
        """Restore a :meth:`save_host_store` file into the host tier,
        depth-ascending so parents adopt before children. A record is
        taken only when its chain is ROOT-CONNECTED here — its parent hash
        already resolves in either tier (or it is a depth-1 root child) —
        because a dangling host node could never be matched or promoted,
        only leak. Records whose hash is already present are skipped
        (the live copy wins); loading stops at the ``spill_blocks``
        budget, keeping shallowest chains (most shareable prefixes).
        Loaded nodes enter at refcount 0 with a fresh LRU tick: saved
        ticks belong to the dead process's clock and must not outrank
        live traffic. Returns ``{chain_hash: payload}`` for the adopted
        nodes — the engine installs these into its spill store.

        Byte-layout-agnostic by construction: chain hashes key token
        CONTENT, and payloads round-trip opaquely, so a store saved under
        ``kv_quant='int8'`` restores into an int8 engine bitwise (loading
        it into a different pool layout is the caller's error — guard
        with the engine-level codec/layout check)."""
        if not self.prefix_cache or not self.spill_blocks:
            raise ValueError(
                "load_host_store needs prefix_cache=True and "
                "spill_blocks > 0 — there is no host tier to restore into"
            )
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob.get("version") != 1:
            raise ValueError(
                f"host-store version {blob.get('version')!r} != 1"
            )
        if blob["block_size"] != self.block_size:
            raise ValueError(
                f"host-store block_size {blob['block_size']} != pool "
                f"block_size {self.block_size} — chain hashes would name "
                "different token spans"
            )
        if expect_meta is not None and blob.get("meta") != expect_meta:
            raise ValueError(
                f"host-store layout {blob.get('meta')} != this engine's "
                f"{expect_meta} — payloads would scatter wrong bytes "
                "into the pool"
            )
        # Depth-ascending with chain_hash tiebreak: deterministic, and a
        # parent always precedes its children.
        records = sorted(
            blob["records"], key=lambda r: (r["depth"], r["chain_hash"])
        )
        self._tick += 1
        loaded: dict[bytes, object] = {}
        for r in records:
            if self.spilled_blocks >= self.spill_blocks:
                break
            if r["chain_hash"] in self._by_hash:
                continue
            if r["parent_hash"] == _ROOT_HASH:
                parent = None
            else:
                parent = self._by_hash.get(r["parent_hash"])
                if parent is None:
                    continue  # orphaned chain — unreachable, skip
            h = self._next_hid
            self._next_hid -= 1
            nd = _PrefixNode(r["chain_hash"], parent, 0, self._tick,
                             depth=r["depth"])
            self._cached[h] = nd
            self._by_hash[r["chain_hash"]] = h
            if parent is not None:
                self._cached[parent].children.add(h)
            loaded[r["chain_hash"]] = r["payload"]
        return loaded


@dataclasses.dataclass
class Request:
    """One generation request as submitted. ``temperature == 0`` is greedy;
    ``deadline_s`` (absolute engine-clock time) drops the request if it is
    still QUEUED past the deadline — an admitted request always runs to
    completion."""

    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    request_id: int | None = None
    deadline_s: float | None = None


@dataclasses.dataclass
class RequestState:
    """Scheduler-side lifecycle record for one request."""

    request: Request
    arrival_s: float
    bucket: int = 0  # prefill width chosen at admission (0 = decode route)
    blocks: list[int] = dataclasses.field(default_factory=list)
    # Prefix-cache bookkeeping (all empty/0 with the cache off): trie
    # blocks mapped at admission (refcount held, released at completion),
    # the token count they cover, blocks WE own that were published into
    # the trie mid-flight (released, not freed, at completion), cached
    # blocks our mid-flight publish chained THROUGH (one extra refcount
    # each, released at completion — they pin the chain our published
    # nodes hang below), and whether the hit covered all but the last
    # prompt token (no prefill — the first token comes from the plain
    # decode step).
    cached_blocks: list[int] = dataclasses.field(default_factory=list)
    cached_len: int = 0
    published: list[int] = dataclasses.field(default_factory=list)
    trie_refs: list[int] = dataclasses.field(default_factory=list)
    # Host-tier nodes promoted at admission: ``(device_block, chain_hash)``
    # pairs whose KV the engine must upload from its spill store before
    # this request's first forward pass (cleared once applied).
    promoted: list[tuple[int, bytes]] = dataclasses.field(
        default_factory=list
    )
    decode_route: bool = False
    slot: int = -1
    generated: list[int] = dataclasses.field(default_factory=list)
    admit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None
    token_times_s: list[float] = dataclasses.field(default_factory=list)
    dropped: bool = False

    @property
    def done(self) -> bool:
        return self.finish_s is not None

    def metrics(self) -> dict:
        """Per-request latency record (serve_bench aggregates these)."""
        itl = [
            b - a for a, b in zip(self.token_times_s, self.token_times_s[1:])
        ]
        return {
            "request_id": self.request.request_id,
            "prompt_len": len(self.request.prompt),
            "new_tokens": len(self.generated),
            "queue_s": (
                None if self.admit_s is None
                else round(self.admit_s - self.arrival_s, 6)
            ),
            "ttft_s": (
                None if self.first_token_s is None
                else round(self.first_token_s - self.arrival_s, 6)
            ),
            "e2e_s": (
                None if self.finish_s is None
                else round(self.finish_s - self.arrival_s, 6)
            ),
            "inter_token_s": [round(x, 6) for x in itl],
            "dropped": self.dropped,
        }


class Scheduler:
    """Continuous-batching admission over ``slots`` decode lanes.

    The engine drives it: ``submit()`` enqueues; ``admit(now)`` pops FIFO
    while a lane AND blocks are available, returning the newly-placed
    states (the engine then runs one prefill per placement); ``complete()``
    retires a lane and frees its blocks. No jax anywhere.
    """

    def __init__(self, slots: int, pool: KVBlockPool, max_seq_len: int, *,
                 kv_bytes_per_token: int | None = None,
                 kv_quant: str | None = None, role: str | None = None):
        if slots < 1:
            raise ValueError(f"serving.slots must be >= 1, got {slots}")
        self.slots: list[RequestState | None] = [None] * slots
        self.pool = pool
        self.max_seq_len = max_seq_len
        # Capacity labels (engine-provided, None = omit from gauges()):
        # the fleet gauge merge compares replicas' KV capacity in BYTES,
        # not blocks — with kv_quant='int8' a block holds the same tokens
        # in ~4x fewer bytes, so block counts alone mislead the router.
        self.kv_bytes_per_token = kv_bytes_per_token
        self.kv_quant = kv_quant
        # Disaggregation phase role (None = omit from gauges(), the
        # pre-role gauge shape). The engine keeps the two handoff
        # counters current: queue depth (export records not yet shipped)
        # and cumulative KV bytes moved over the wire, both directions.
        self.role = role
        self.handoff_queue_depth = 0
        self.handoff_bytes_total = 0
        self.pending: deque[RequestState] = deque()
        self.finished: list[RequestState] = []
        self.dropped: list[RequestState] = []
        # Prefill-role retirements: the lane is free and the prompt's
        # blocks live on in the trie (refcount 0 — the handoff ledger),
        # but the request is NOT finished serving work — no result is
        # delivered from this engine; the decode side owns delivery.
        self.handed_off: list[RequestState] = []
        self._ids = itertools.count()
        self.admitted_total = 0
        # Prefix-cache counters (stay 0 with the cache off): prompt tokens
        # served from the trie vs prefilled, and full-prefix admissions
        # that skipped prefill entirely.
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.prefix_hit_tokens_host = 0  # subset served via host promote
        self.decode_route_admits = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request, now: float) -> RequestState:
        if not request.prompt:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(request.prompt) + request.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(request.prompt)}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds serving.max_seq_len "
                f"{self.max_seq_len}"
            )
        if request.request_id is None:
            request.request_id = next(self._ids)
        state = RequestState(request=request, arrival_s=now)
        self.pending.append(state)
        return state

    # -- admission ---------------------------------------------------------

    def free_slot(self) -> int:
        try:
            return self.slots.index(None)
        except ValueError:
            return -1

    def admit(self, now: float, bucket_of, max_admit: int = 0,
              suffix_bucket_of=None,
              cover_tokens: int = 0) -> list[RequestState]:
        """FIFO-admit queued requests while a lane + blocks are available.
        ``bucket_of(prompt_len) -> P`` supplies the engine's prompt bucket
        (block reservation must cover the BUCKET: bulk prefill writes pad
        KV into the row's own pages — transformer.paged_decode_attention).
        Head-of-line blocking is deliberate: skipping ahead would starve
        large requests under load.

        ``max_admit`` (0 = unlimited) caps placements per call — the
        engine's prefill/decode priority knob (serving.
        max_prefills_per_step): every placement costs one prefill before
        the running batch's next decode step, so a queue burst at high
        occupancy would otherwise stall in-flight decodes behind
        back-to-back prefills. Capped admissions stay FIFO; the remainder
        is admitted on subsequent steps, interleaved between decodes.

        With the prefix cache on the engine passes
        ``suffix_bucket_of(suffix_len) -> P_s`` (the suffix prefill width)
        and ``cover_tokens`` (the page-table row's token capacity). The
        prompt is matched against the trie, matched blocks are acquired at
        refcount+1, and the reservation counts only the uncached suffix:
        ``blocks_for(max(cached_len + P_s, prompt + max_new)) - hit`` —
        always >= 1 because a hit never covers the last prompt token. The
        hit is trimmed while ``cached_len + P_s`` would overrun the row
        (a bucket-size overshoot past the last page writes pad KV through
        a CLAMPED table index — real corruption, not null-block spill).
        A full-prefix hit (suffix of one token) takes the decode route:
        no prefill width, first token from the next decode step."""
        placed = []
        bs = self.pool.block_size
        while self.pending:
            if max_admit and len(placed) >= max_admit:
                break
            state = self.pending[0]
            req = state.request
            if req.deadline_s is not None and now > req.deadline_s:
                self.pending.popleft()
                state.dropped = True
                state.finish_s = now
                self.dropped.append(state)
                continue
            slot = self.free_slot()
            if slot < 0:
                break
            plen = len(req.prompt)
            cached = (
                self.pool.match(req.prompt)
                if suffix_bucket_of is not None else []
            )
            cached_len = len(cached) * bs
            decode_route = False
            if cached and plen - cached_len == 1:
                decode_route = True
                bucket = 0
                cover = plen
            elif cached:
                bucket = suffix_bucket_of(plen - cached_len)
                while cached and cached_len + bucket > cover_tokens:
                    cached.pop()
                    cached_len -= bs
                    bucket = (bucket_of(plen) if not cached
                              else suffix_bucket_of(plen - cached_len))
                cover = cached_len + bucket
            else:
                bucket = bucket_of(plen)
                cover = bucket
            # Host-tier hits occupy no device block yet, so the
            # reservation must cover them too: they are promoted onto
            # fresh device blocks right after alloc. Host nodes are a
            # SUFFIX of the matched chain (a device node's parent is
            # never host), so counting trailing negatives is exact.
            n_host = sum(1 for c in cached if c < 0)
            need = blocks_for(
                max(cover, plen + req.max_new_tokens), bs
            ) - (len(cached) - n_host)
            # Acquire BEFORE alloc: alloc may evict refcount-0 trie nodes,
            # and the matched chain must survive it. Acquiring host nodes
            # also pins them (refcount > 0) against final eviction while
            # our own alloc squeezes the spill ledger.
            self.pool.acquire(cached)
            blocks = self.pool.alloc(need)
            if blocks is None:
                self.pool.release(cached)
                break
            promoted: list[tuple[int, bytes]] = []
            if n_host:
                host_ids = cached[len(cached) - n_host:]
                promoted = self.pool.promote(host_ids, blocks[:n_host])
                remap = dict(zip(host_ids, (b for b, _ in promoted)))
                cached = cached[:len(cached) - n_host] + [
                    remap[h] for h in host_ids
                ]
                blocks = blocks[n_host:]
            self.pending.popleft()
            state.bucket = bucket
            state.blocks = blocks
            state.cached_blocks = cached
            state.promoted = promoted
            state.cached_len = cached_len
            state.decode_route = decode_route
            state.slot = slot
            state.admit_s = now
            self.slots[slot] = state
            self.admitted_total += 1
            if self.pool.prefix_cache:
                self.prefix_hit_tokens += cached_len
                self.prefix_miss_tokens += plen - cached_len
                self.prefix_hit_tokens_host += n_host * bs
                self.decode_route_admits += int(decode_route)
            placed.append(state)
        return placed

    def publish_prefix(self, state: RequestState, n_tokens: int) -> int:
        """Publish ``state``'s first ``n_tokens // block_size`` full blocks
        into the trie at refcount 1 (the request keeps decoding over them)
        — the engine calls this right after prefill, when their KV is
        written and final, so later arrivals in the same wave already hit.
        Newly published blocks move to ``state.published``, and cached
        nodes the chain continued through (another same-wave request beat
        us to a shared block) move to ``state.trie_refs`` — both released,
        not freed, at completion. Returns the number published."""
        if not self.pool.prefix_cache:
            return 0
        bs = self.pool.block_size
        chain = state.cached_blocks + state.blocks
        n_full = min(n_tokens // bs, len(chain))
        if n_full <= 0:
            return 0
        got, traversed = self.pool.publish(
            state.request.prompt[:n_full * bs], chain[:n_full], refs=1
        )
        state.published.extend(got)
        state.trie_refs.extend(traversed)
        return len(got)

    # -- retirement --------------------------------------------------------

    def complete(self, slot: int, now: float) -> RequestState:
        state = self._retire(slot, now)
        self.finished.append(state)
        return state

    def complete_handoff(self, slot: int, now: float, *,
                         written: int | None = None) -> RequestState:
        """Prefill-role retirement: identical block accounting to
        :meth:`complete` — the prompt's full blocks end up published at
        refcount 0, i.e. resident in the trie as the handoff ledger
        entry — but the state lands in ``handed_off``, not ``finished``:
        this engine never delivers a result for it (the decode replica
        that adopts the chain does). ``written`` overrides the written-
        token count for the completion-time publish: a decode-route
        handoff never ran a forward at all, so its LAST prompt token's
        KV is unwritten and the default no-generated-tokens rule
        ("prefill wrote every prompt position") would publish a block
        holding one garbage position. The engine must capture the
        exported payload bytes in the SAME step, before another
        admission's eviction pressure can reclaim the refcount-0
        chain."""
        state = self._retire(slot, now, written=written)
        self.handed_off.append(state)
        return state

    def _retire(self, slot: int, now: float, *,
                written: int | None = None) -> RequestState:
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is empty")
        state.finish_s = now
        if self.pool.prefix_cache:
            # Publish the finished sequence's full WRITTEN blocks at
            # refcount 0 (prompt blocks are already in the trie and skip;
            # generated-region blocks are final now — speculative rewinds
            # and bucket pad only ever touched positions past/overwritten-
            # below the final cursor). The completing token itself was
            # sampled but never fed back through the model, so its KV slot
            # is UNWRITTEN — publishing its block would let a later prompt
            # extending this sequence attend to garbage KV. With no
            # generated tokens (direct scheduler-level completion) prefill
            # wrote every prompt position. Then drop our refcounts and
            # free what stayed private.
            seq = state.request.prompt + state.generated
            chain = state.cached_blocks + state.blocks
            if written is None:
                written = len(seq) - (1 if state.generated else 0)
            n_full = min(written // self.pool.block_size, len(chain))
            now_published = (
                self.pool.publish(seq[:n_full * self.pool.block_size],
                                  chain[:n_full], refs=0)[0]
                if n_full else []
            )
            in_trie = set(state.published) | set(now_published)
            self.pool.release(
                state.cached_blocks + state.published + state.trie_refs
            )
            leftover = [b for b in state.blocks if b not in in_trie]
            if leftover:
                self.pool.free(leftover)
            state.cached_blocks = []
            state.published = []
            state.trie_refs = []
        else:
            self.pool.free(state.blocks)
        state.blocks = []
        self.slots[slot] = None
        return state

    # -- introspection -----------------------------------------------------

    @property
    def active(self) -> list[RequestState]:
        return [s for s in self.slots if s is not None]

    @property
    def idle(self) -> bool:
        return not self.pending and not self.active

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the trie."""
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        return self.prefix_hit_tokens / total if total else 0.0

    def stats(self) -> dict:
        out = {
            "pending": len(self.pending),
            "active": len(self.active),
            "finished": len(self.finished),
            "dropped": len(self.dropped),
            "admitted_total": self.admitted_total,
            "free_blocks": self.pool.free_blocks,
            "used_blocks": self.pool.used_blocks,
            "block_high_water": self.pool.high_water,
        }
        if self.role is not None:
            out["role"] = self.role
            out["handed_off"] = len(self.handed_off)
            out["handoff_queue_depth"] = self.handoff_queue_depth
            out["handoff_bytes_total"] = self.handoff_bytes_total
            out["chain_adoptions"] = self.pool.chain_adoptions
        if self.pool.prefix_cache:
            out["prefix_cache"] = {
                "hit_tokens": self.prefix_hit_tokens,
                "miss_tokens": self.prefix_miss_tokens,
                "hit_tokens_host": self.prefix_hit_tokens_host,
                "hit_tokens_device": (
                    self.prefix_hit_tokens - self.prefix_hit_tokens_host
                ),
                "hit_rate": round(self.prefix_hit_rate(), 6),
                "decode_route_admits": self.decode_route_admits,
                "cached_blocks": self.pool.cached_blocks,
                "evictable_blocks": self.pool.evictable_blocks,
                "published_total": self.pool.published_total,
                "evictions": self.pool.evictions,
                "spill_budget": self.pool.spill_blocks,
                "spilled_blocks": self.pool.spilled_blocks,
                "spills": self.pool.spills,
                "promotes": self.pool.promotes,
                "adoptions": self.pool.adoptions,
                "final_evictions": self.pool.final_evictions,
            }
        return out

    def gauges(self, now: float | None = None) -> dict:
        """The instantaneous capacity gauges (``metrics.serving_gauges``
        kwargs): queue depth + pool occupancy, the subset of :meth:`stats`
        that changes every engine step and drives admission.

        With ``now`` (the engine clock), two queue-derived signals ride
        along so the replica router's shed decision reads gauges instead
        of walking another engine's queue:

        - ``oldest_queued_age_s`` — how long the HEAD of the FIFO queue
          has already waited (0.0 when empty). Under head-of-line
          blocking every later request waits at least this long, so it
          is a live lower bound on queue wait that leads the latency
          histograms (which only learn about a wedge after it clears).
        - ``queued_deadline_headroom_s`` — min over queued requests of
          ``deadline_s - now`` (None when nothing queued carries a
          deadline; negative = something is already doomed and will be
          dropped at the next admit pass).
        """
        g = {
            "pending": len(self.pending),
            "active": len(self.active),
            "free_blocks": self.pool.free_blocks,
            "used_blocks": self.pool.used_blocks,
        }
        if self.kv_bytes_per_token is not None:
            # Byte-denominated capacity: free_blocks is not comparable
            # across replicas with different kv_quant settings.
            g["kv_bytes_per_token"] = self.kv_bytes_per_token
        if self.kv_quant is not None:
            g["kv_quant"] = self.kv_quant
        if self.role is not None:
            # Phase-split visibility: which phase this engine serves and
            # how much handoff work is queued/has moved — cli report and
            # FLEET.json surface the split from heartbeats alone.
            g["role"] = self.role
            g["handoff_queue_depth"] = self.handoff_queue_depth
            g["handoff_bytes_total"] = self.handoff_bytes_total
        if self.pool.prefix_cache:
            g["prefix_hit_rate"] = round(self.prefix_hit_rate(), 6)
            # Cache-pressure gauges: least-loaded and prefix-affinity
            # scoring (and the fleet gauge merge) read these to see how
            # much of the pool is warm cache vs reclaimable vs spilled.
            g["cached_blocks"] = self.pool.cached_blocks
            g["evictable_blocks"] = self.pool.evictable_blocks
            g["spilled_blocks"] = self.pool.spilled_blocks
        if now is not None:
            # Completion counters ride with every clocked gauge push so a
            # fleet supervisor can account served-vs-lost work from
            # heartbeats alone (serving/fleet_supervisor.py) — a dead
            # worker's last heartbeat tells the router how much it had
            # finished. Clock-less calls keep the original four-gauge
            # shape (metrics.serving_gauges back-compat).
            g["finished"] = len(self.finished)
            g["dropped"] = len(self.dropped)
            g["oldest_queued_age_s"] = (
                now - self.pending[0].arrival_s if self.pending else 0.0
            )
            headrooms = [
                st.request.deadline_s - now
                for st in self.pending
                if st.request.deadline_s is not None
            ]
            g["queued_deadline_headroom_s"] = (
                min(headrooms) if headrooms else None
            )
        return g
