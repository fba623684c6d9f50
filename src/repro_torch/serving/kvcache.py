"""KV-cache pool: slot allocation, length tracking, prefix caching.

One engine owns one pool: prefill writes and decode reads the *same*
buffers, so a completed prefill's KV is visible to decode with no
transfer; slot lifetime is managed on the host, and ordering within a
step is the order of launches on the device's stream.

Prefix cache (slab layout, ``KVCachePool``): after a cold prefill of a
shared system prompt, the engine registers a *snapshot* of that slot's
cache rows (attention rows and recurrent states) at that length.  A
later cold prefill with an identical token prefix copies the snapshot
instead of recomputing.

Paged layout (``PagedKVCachePool``): the K/V leaves are a flat page arena
``[G, num_pages + 1, page_size, Hk, hd]`` addressed through per-slot
block tables.  Pages are refcounted, so a prefix hit or a park is
block-table surgery (no device copy), and the first divergent write to
a shared page copies that one page (copy-on-write).  The prefix index is
a radix trie over token ids (longest-prefix, partial hits) or the exact
whole-key store.  The slab pool remains the reference.

Recurrent (Mamba-2) state leaves are per-slot point summaries on both
layouts: a slot's state is zeroed when it is allocated, and a prefix
entry or a parked slot carries a copy of it taken at exactly its length
(``stats["state_copies"]`` counts the copies taken and restored).  The
radix index can therefore restore only at a node boundary that holds
such a snapshot.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import POSITIONAL_CACHE_KEYS, init_cache, num_kv_pages


class KVExhausted(RuntimeError):
    """Typed capacity fault: the pool has no free slot or page.

    A ``RuntimeError`` subclass so legacy catches keep working, but
    typed so the dispatcher can *degrade* (defer the op, shed at the
    admission watermark) instead of ending the serving loop."""

    def __init__(self, what: str, msg: str):
        super().__init__(msg)
        self.what = what          # "slot" | "page"
        self.session_id = -1      # annotated at the dispatch site


def _prefix_key(tokens: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(tokens, dtype=np.int32)
                        .tobytes()).hexdigest()


def _is_positional(layer: Dict[str, Any]) -> bool:
    return set(layer) <= POSITIONAL_CACHE_KEYS


def _snapshot(cache, slot: int, state_only: bool = False):
    """Copy of the cache leaves' rows for ``slot`` ([:, slot]): every leaf,
    or (``state_only``) the recurrent-state leaves alone."""
    return {name: {k: v[:, slot].clone() for k, v in layer.items()}
            for name, layer in cache.items()
            if not (state_only and _is_positional(layer))}


def _restore(cache, snapshot, slot: int) -> None:
    """Write a snapshot (of every leaf, or of the state leaves) back into
    ``slot``, in place."""
    for name, layer in snapshot.items():
        for k, v in layer.items():
            cache[name][k][:, slot].copy_(v)


@dataclasses.dataclass
class PrefixEntry:
    snapshot: Any          # each cache leaf's [:, slot] rows
    length: int
    refs: int = 0
    last_used: int = 0     # LRU tick (register / lookup-hit time)


class KVCachePool:
    """Fixed number of batch slots over one stacked cache."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_seq: int,
                 dtype=torch.float32, device="cuda",
                 max_prefix_entries: int = 8):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.cache = self._init_cache(cfg, num_slots, max_seq, dtype)
        self.lengths = np.zeros((num_slots,), np.int32)
        self._free = set(range(num_slots))
        self._prefix: Dict[str, PrefixEntry] = {}
        self.max_prefix_entries = max_prefix_entries
        self._tick = 0                      # LRU clock for prefix entries
        # the slab layout snapshots whole slots: longest-match degenerates
        # to the exact snapshot key
        self.prefix_mode = "exact"
        # bumped whenever the set of cached prefixes changes (register /
        # evict); the engine keys its per-session probe cache on this
        self.prefix_version = 0
        self.has_state_leaves = any(not _is_positional(layer)
                                    for layer in self.cache.values())
        self.stats = {"alloc": 0, "free": 0, "prefix_hits": 0,
                      "prefix_partial_hits": 0, "prefix_misses": 0,
                      "prefix_refreshes": 0, "evictions": 0,
                      "parks": 0, "unparks": 0, "state_copies": 0}

    def _init_cache(self, cfg, num_slots, max_seq, dtype):
        return init_cache(cfg, num_slots, max_seq, dtype, self.device)

    # ---- slot lifecycle -------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise KVExhausted("slot", "KV pool exhausted: no free slot")
        slot = min(self._free)
        self._free.discard(slot)
        self.lengths[slot] = 0
        if self.has_state_leaves:
            self.reset_slot_state(slot)
        self.stats["alloc"] += 1
        return slot

    def reset_slot_state(self, slot: int) -> None:
        """Zero the slot's recurrent-state leaves.  Attention rows are
        fenced by ``lengths``, but a state summarises everything before
        it: a freed session's state must not seed the next occupant."""
        for layer in self.cache.values():
            if not _is_positional(layer):
                for v in layer.values():
                    v[:, slot].zero_()

    def free(self, slot: int) -> None:
        self._check_allocated(slot)
        self._free.add(slot)
        self.lengths[slot] = 0
        self.stats["free"] += 1

    def _check_allocated(self, slot: int) -> None:
        """Freeing a slot that is not allocated must be loud: re-adding it
        to ``_free`` would hand the same slot to two sessions."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"free of invalid slot {slot}")
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def slots_in_use(self) -> int:
        return self.num_slots - len(self._free)

    # ---- prefix cache ---------------------------------------------------
    def register_prefix(self, slot: int, tokens: np.ndarray) -> None:
        """Snapshot ``slot``'s cache rows as a reusable prefix.  Must be
        called when exactly ``len(tokens)`` tokens are in the slot.
        Re-registering a cached key only refreshes its LRU stamp."""
        assert self.lengths[slot] == len(tokens), \
            (self.lengths[slot], len(tokens))
        key = _prefix_key(tokens)
        self._tick += 1
        entry = self._prefix.get(key)
        if entry is not None:
            entry.last_used = self._tick
            self.stats["prefix_refreshes"] += 1
            return
        if len(self._prefix) >= self.max_prefix_entries:
            self._evict_one()
        self._prefix[key] = PrefixEntry(
            snapshot=_snapshot(self.cache, slot), length=len(tokens),
            last_used=self._tick)
        self._count_state_copy()
        self.prefix_version += 1

    def _count_state_copy(self) -> None:
        if self.has_state_leaves:
            self.stats["state_copies"] += 1

    def peek_prefix(self, tokens: np.ndarray) -> int:
        """Non-mutating probe: length of the cached prefix for these
        tokens (0 = miss); no stats, no LRU refresh."""
        entry = self._prefix.get(_prefix_key(tokens))
        return entry.length if entry is not None else 0

    def lookup(self, tokens: np.ndarray) -> Optional[PrefixEntry]:
        entry = self._prefix.get(_prefix_key(tokens))
        if entry is not None:
            self.stats["prefix_hits"] += 1
            entry.refs += 1
            self._tick += 1
            entry.last_used = self._tick
        else:
            self.stats["prefix_misses"] += 1
        return entry

    def peek_longest(self, tokens: np.ndarray,
                     max_len: Optional[int] = None) -> int:
        """Non-mutating probe of how many leading positions of ``tokens``
        could be restored, at most ``max_len``.  Exact mode: the whole
        query matches or the answer is 0."""
        cap = len(tokens) if max_len is None else min(len(tokens), max_len)
        if cap <= 0:
            return 0
        hit = self.peek_prefix(np.asarray(tokens))
        return hit if 0 < hit <= cap else 0

    def lookup_longest(self, tokens: np.ndarray,
                       max_len: Optional[int] = None):
        """Mutating counterpart of ``peek_longest``: counts hit/miss,
        refreshes LRU recency, returns an entry for ``restore_prefix``
        (``None`` on miss)."""
        cap = len(tokens) if max_len is None else min(len(tokens), max_len)
        if cap <= 0:
            self.stats["prefix_misses"] += 1
            return None
        entry = self._prefix.get(_prefix_key(np.asarray(tokens)))
        if entry is None or entry.length > cap:
            self.stats["prefix_misses"] += 1
            return None
        self.stats["prefix_hits"] += 1
        entry.refs += 1
        self._tick += 1
        entry.last_used = self._tick
        return entry

    def restore_prefix(self, dst_slot: int, entry: PrefixEntry) -> None:
        """Copy a snapshot into ``dst_slot`` (one device copy per leaf)."""
        _restore(self.cache, entry.snapshot, dst_slot)
        self.lengths[dst_slot] = entry.length
        self._count_state_copy()

    def _evict_one(self) -> None:
        """Evict the least-recently-used entry."""
        if not self._prefix:
            return
        key = min(self._prefix, key=lambda k: self._prefix[k].last_used)
        self._drop_entry(self._prefix.pop(key))
        self.stats["evictions"] += 1
        self.prefix_version += 1

    def _drop_entry(self, entry) -> None:
        """Entry-release hook (the paged pool drops page references)."""

    def release_entry(self, entry) -> None:
        """Release a caller-owned (parked) entry without restoring it.
        Slab entries are plain snapshots: nothing to do; the paged pool
        drops the transferred page references."""
        self._drop_entry(entry)

    @property
    def prefix_page_refs(self) -> int:
        """Page references held by the prefix index itself (0 on the slab
        layout: snapshots own no pages)."""
        return 0

    # ---- tool-wait parking ----------------------------------------------
    def park(self, slot: int) -> PrefixEntry:
        """Snapshot a slot's full cache rows and free the slot.  The
        caller owns the returned snapshot (it is not in the evictable
        prefix store), so a parked session never loses its state."""
        entry = PrefixEntry(snapshot=_snapshot(self.cache, slot),
                            length=int(self.lengths[slot]))
        self._count_state_copy()
        self.free(slot)
        self.stats["parks"] += 1
        return entry

    def unpark(self, slot: int, entry: PrefixEntry) -> None:
        """Restore a parked snapshot into a freshly allocated slot, exact
        at the parked length."""
        self.restore_prefix(slot, entry)
        self.stats["unparks"] += 1

    # ---- rollback ---------------------------------------------------------
    def truncate(self, slot: int, new_length: int) -> None:
        """Rewind ``slot`` to ``new_length`` tokens.  On the slab layout a
        pure length rewind: rows at positions >= ``lengths[slot]`` are
        never read.  Idempotent."""
        self._check_allocated(slot)
        cur = int(self.lengths[slot])
        assert 0 <= new_length <= cur, (slot, new_length, cur)
        self.lengths[slot] = new_length

    # ---- step integration -------------------------------------------------
    def lengths_device(self) -> torch.Tensor:
        """A device copy of the host length mirror (never aliases it)."""
        return torch.tensor(self.lengths, device=self.device)

    def commit(self, new_cache, slot_mask: np.ndarray) -> None:
        """Accept updated cache rows for slots in ``slot_mask`` (bool
        [B]), keeping old rows elsewhere."""
        if slot_mask.all():
            self.cache = new_cache
            return
        m = torch.tensor(slot_mask, device=self.device)
        out = {}
        for name, layer in new_cache.items():
            out[name] = {}
            for k, new in layer.items():
                shape = [1, self.num_slots] + [1] * (new.dim() - 2)
                out[name][k] = torch.where(m.reshape(shape), new,
                                           self.cache[name][k])
        self.cache = out


# ---------------------------------------------------------------------------
# paged layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedEntry:
    """A paged prefix or park entry: shared physical page ids.  An
    *owning* entry (exact-mode prefix, parked slot) holds one reference on
    every listed page and is released via ``release_entry``; a radix
    ``lookup_longest`` result *borrows* the tree's references
    (``owns_refs=False``) and is valid only until the next cache
    mutation: ``restore_prefix`` it at once."""
    pages: np.ndarray      # int32 [n] physical page ids (no -1 entries)
    length: int
    state: Any = None      # recurrent-state snapshot, or None (dense)
    refs: int = 0
    last_used: int = 0
    owns_refs: bool = True


class _RadixNode:
    """One path-compressed radix-tree node: a run of token ids at
    absolute positions ``[start, end)`` plus the page run covering those
    positions, ``pages[j]`` backing logical page ``start // page_size + j``.

    A node whose run starts mid-page lists the *slot's own* boundary page
    at registration time: after a partial restore that page is the
    session's COW copy, which holds the ancestor rows (the copy is
    whole-page) plus this node's rows, so it is valid for the node's
    whole coverage.  Path assembly therefore writes pages deepest node
    first, and the deeper node wins at shared indices.  ``pin`` guards a
    node against eviction while an insert along its path is in flight.
    ``state`` is the recurrent-state snapshot at ``end`` (models with
    state leaves; None where no snapshot was taken)."""

    __slots__ = ("tokens", "start", "pages", "parent", "children",
                 "last_used", "pin", "state")

    def __init__(self, tokens: np.ndarray, start: int, pages: np.ndarray,
                 parent: Optional["_RadixNode"]):
        self.tokens = tokens
        self.start = start
        self.pages = pages
        self.parent = parent
        self.children: Dict[int, "_RadixNode"] = {}
        self.last_used = 0
        self.pin = 0
        self.state: Any = None

    @property
    def end(self) -> int:
        return self.start + len(self.tokens)


class PagedKVCachePool(KVCachePool):
    """Block-table pool over a flat page arena.

    Leaves: ``[G, num_pages + 1, page_size, Hk, hd]``; the last physical
    page is the write scratch page (never read, never allocated).
    Per-slot block tables map logical page index -> physical page; ``-1``
    marks unmapped entries (the scratch page in the device copy, so
    padded and inactive writes land there).  Pages are refcounted:

    * ``register_prefix`` / ``restore_prefix`` (a prefix hit) and
      ``park`` / ``unpark`` are block-table surgery with no device copy
      of attention rows (``stats["page_copies"]`` counts the exceptions);
      models with recurrent state copy that small per-slot state
      (``stats["state_copies"]``).
    * Writers call ``prepare_append(slot, start, n)`` before dispatching
      device work that writes positions ``[start, start + n)``: it maps
      missing pages and copies shared ones, so a write never touches a
      page another holder can read.

    State leaves stay per slot ([G, num_slots, ...]); a model without
    attention layers has no arena at all (no page is ever copied, and
    ``arena_bytes`` is 0)."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_seq: int,
                 dtype=torch.float32, device="cuda",
                 max_prefix_entries: int = 8, num_pages: int = 0,
                 prefix_cache: str = "radix"):
        if cfg.kv_layout != "paged":
            raise ValueError(f"PagedKVCachePool needs kv_layout='paged', "
                             f"got {cfg.kv_layout!r}")
        if prefix_cache not in ("radix", "exact"):
            raise ValueError(f"prefix_cache must be 'radix' or 'exact', "
                             f"got {prefix_cache!r}")
        self.page_size = cfg.kv_page_size
        if max_seq % self.page_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of the "
                             f"page size {self.page_size}")
        self.pages_per_slot = max_seq // self.page_size      # P_max
        self.num_pages = num_pages or num_kv_pages(cfg, num_slots, max_seq)
        self.scratch_page = self.num_pages    # last physical arena page
        super().__init__(cfg, num_slots, max_seq, dtype, device,
                         max_prefix_entries)
        self.prefix_mode = prefix_cache
        self.block_table = np.full((num_slots, self.pages_per_slot), -1,
                                   np.int32)
        self.refcount = np.zeros((self.num_pages,), np.int32)
        # LIFO free list popping low page ids first (deterministic)
        self._free_pages: List[int] = list(range(self.num_pages - 1, -1, -1))
        # the device copy of the tables; None after a table mutation
        self._bt_dev: Optional[torch.Tensor] = None
        self._radix_root = _RadixNode(np.zeros((0,), np.int32), 0,
                                      np.zeros((0,), np.int32), None)
        self._radix_nodes = 0           # node count (max_prefix_entries cap)
        self._radix_page_refs = 0       # page refs held by tree nodes
        self.pages_peak = 0             # most pages in use at once
        self.stats.update({"page_allocs": 0, "page_frees": 0,
                           "page_copies": 0, "shared_pages": 0})

    def _init_cache(self, cfg, num_slots, max_seq, dtype):
        return init_cache(cfg, num_slots, max_seq, dtype, self.device,
                          num_pages=self.num_pages)

    # ---- page accounting ------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_in_use(self) -> int:
        """Allocated arena pages (the page-occupancy gauge)."""
        return self.num_pages - len(self._free_pages)

    def _alloc_page(self) -> int:
        if not self._free_pages and self.prefix_mode == "radix":
            # tree-aware pressure relief: drop cold unpinned leaves until a
            # page frees.  Evicting a leaf frees only pages the tree held
            # last; pages still mapped by live slots survive under those.
            while not self._free_pages and self._radix_evict_one():
                pass
        if not self._free_pages:
            raise KVExhausted("page", "KV page pool exhausted: no free page")
        p = self._free_pages.pop()
        self.refcount[p] = 1
        self.stats["page_allocs"] += 1
        self.pages_peak = max(self.pages_peak, self.pages_in_use)
        return p

    def _incref(self, page: int) -> None:
        self.refcount[page] += 1

    def _decref(self, page: int) -> None:
        assert self.refcount[page] > 0, page
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free_pages.append(page)
            self.stats["page_frees"] += 1

    def _npages(self, length: int) -> int:
        return -(-length // self.page_size)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page of every arena leaf (all G layers in one
        op per leaf): the COW cost of a first divergent write, O(page).
        Enqueued on the current stream, so it runs after every step
        already dispatched and before the write that needs it."""
        for layer in self.cache.values():
            if _is_positional(layer):
                for leaf in layer.values():
                    leaf[:, dst].copy_(leaf[:, src])

    def _state_snapshot(self, slot: int):
        """The slot's recurrent-state snapshot (None without state
        leaves), counted in ``stats["state_copies"]``."""
        if not self.has_state_leaves:
            return None
        self.stats["state_copies"] += 1
        return _snapshot(self.cache, slot, state_only=True)

    def _state_restore(self, slot: int, state) -> None:
        if state is not None:
            _restore(self.cache, state, slot)
            self.stats["state_copies"] += 1

    # ---- slot lifecycle -------------------------------------------------
    def free(self, slot: int) -> None:
        self._check_allocated(slot)
        for p in self.block_table[slot]:
            if p >= 0:
                self._decref(int(p))
        self.block_table[slot] = -1
        self._bt_dev = None
        super().free(slot)

    def _release_slot(self, slot: int) -> None:
        """Return a slot whose page references moved to a parked entry:
        the table row is cleared without a decref."""
        self._check_allocated(slot)
        self.block_table[slot] = -1
        self._bt_dev = None
        self._free.add(slot)
        self.lengths[slot] = 0
        self.stats["free"] += 1

    def prepare_append(self, slot: int, start: int, n: int) -> None:
        """Make positions ``[start, start + n)`` of ``slot`` writable:
        map unmapped pages and copy-on-write shared ones.  Runs before any
        dispatch that writes those positions (prefill chunk, decode step,
        megastep of K).  Positions beyond the table are ignored: the
        model's scatter sends them to the scratch page (the engine counts
        such overruns)."""
        if n <= 0:
            return
        first = start // self.page_size
        last = self._npages(start + n)                # exclusive bound
        # an exhausted _alloc_page mid-call must not leak the pages this
        # call already claimed: record each change and unwind in reverse
        # before re-raising, so a failed append leaves the table row,
        # refcounts and free list exactly as found
        undo: List[tuple] = []            # (lp, old_page, fresh_page)
        try:
            for lp in range(first, min(last, self.pages_per_slot)):
                page = int(self.block_table[slot, lp])
                if page < 0:
                    fresh = self._alloc_page()
                    self.block_table[slot, lp] = fresh
                    self._bt_dev = None
                    undo.append((lp, -1, fresh))
                elif self.refcount[page] > 1:
                    fresh = self._alloc_page()
                    self._copy_page(page, fresh)
                    self._decref(page)
                    self.block_table[slot, lp] = fresh
                    self._bt_dev = None
                    self.stats["page_copies"] += 1
                    undo.append((lp, page, fresh))
        except KVExhausted:
            for lp, old, fresh in reversed(undo):
                if old >= 0:
                    # the COW source kept refcount >= 1 (another holder),
                    # so re-increfing cannot resurrect a freed page
                    self._incref(old)
                self._decref(fresh)       # refcount 1 -> 0: back to free
                self.block_table[slot, lp] = old
            self._bt_dev = None
            raise

    def truncate(self, slot: int, new_length: int) -> None:
        """Rewind the length and unmap every page wholly beyond
        ``new_length`` (a COW copy goes straight back to the free list; a
        still-shared original survives under its other holders).
        Idempotent: unmapped entries are skipped, so a second rollback
        cannot double-decref."""
        self._check_allocated(slot)
        cur = int(self.lengths[slot])
        assert 0 <= new_length <= cur, (slot, new_length, cur)
        self.lengths[slot] = new_length
        mutated = False
        for lp in range(self._npages(new_length), self.pages_per_slot):
            page = int(self.block_table[slot, lp])
            if page < 0:
                break       # table rows are mapped densely from 0
            self._decref(page)
            self.block_table[slot, lp] = -1
            mutated = True
        if mutated:
            self._bt_dev = None

    def block_tables_device(self) -> torch.Tensor:
        """The block tables on the device, ``-1`` entries mapped to the
        scratch page.  Rebuilt as a *new* tensor after any table change
        and never written in place: a step already dispatched (the double
        buffer) keeps reading the tables it was given."""
        if self._bt_dev is None:
            host = torch.from_numpy(np.where(
                self.block_table < 0, self.scratch_page,
                self.block_table).astype(np.int32))
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._bt_dev = host.to(self.device, non_blocking=True)
        return self._bt_dev

    # ---- prefix cache: zero-copy page sharing ---------------------------
    def register_prefix(self, slot: int, tokens: np.ndarray) -> None:
        """Share ``slot``'s prefix pages by reference: no device copy.
        Radix mode inserts along the matched path, splitting a node at a
        divergence; exact mode keeps the whole-key store."""
        assert self.lengths[slot] == len(tokens), \
            (self.lengths[slot], len(tokens))
        if self.prefix_mode != "radix":
            key = _prefix_key(tokens)
            self._tick += 1
            entry = self._prefix.get(key)
            if entry is not None:
                entry.last_used = self._tick
                self.stats["prefix_refreshes"] += 1
                return
            if len(self._prefix) >= self.max_prefix_entries:
                self._evict_one()
            pages = self.block_table[slot, :self._npages(len(tokens))].copy()
            assert (pages >= 0).all(), pages
            for p in pages:
                self._incref(int(p))
            self.stats["shared_pages"] += len(pages)
            self._prefix[key] = PagedEntry(
                pages=pages, length=len(tokens),
                state=self._state_snapshot(slot), last_used=self._tick)
            self.prefix_version += 1
            return
        toks = np.ascontiguousarray(tokens, np.int32).ravel()
        if len(toks) == 0:
            return
        self._tick += 1
        node, matched = self._radix_walk(toks)
        if matched == len(toks):
            # fully covered: refresh recency only, with one exception: a
            # stateful model ending where no state boundary exists yet
            # gets a split and a snapshot, so the boundary is restorable
            if self.has_state_leaves:
                if node.end > matched:
                    node = self._radix_split(node, matched)
                if node.state is None:
                    node.state = self._state_snapshot(slot)
                    self.prefix_version += 1
            self._radix_touch(node)
            self.stats["prefix_refreshes"] += 1
            return
        if node.end > matched:
            node = self._radix_split(node, matched)
        node.pin += 1         # the insert parent must survive eviction
        try:
            while (self._radix_nodes >= self.max_prefix_entries
                   and self._radix_evict_one()):
                pass
            child = self._radix_append(node, slot, toks, matched)
        finally:
            node.pin -= 1
        child.state = self._state_snapshot(slot)
        self._radix_touch(child)
        self.prefix_version += 1

    # ---- radix index ----------------------------------------------------
    @property
    def radix_nodes(self) -> int:
        """Live radix-tree node count (a telemetry gauge)."""
        return self._radix_nodes

    @property
    def prefix_page_refs(self) -> int:
        if self.prefix_mode == "radix":
            return self._radix_page_refs
        return sum(len(e.pages) for e in self._prefix.values())

    def _radix_walk(self, toks: np.ndarray):
        """Descend the tree along ``toks``; returns ``(node, matched)``:
        ``matched`` tokens are covered and the match stopped in ``node``
        (possibly mid-run, ``node.start < matched < node.end``)."""
        node, matched, n = self._radix_root, 0, len(toks)
        while matched < n:
            child = node.children.get(int(toks[matched]))
            if child is None:
                return node, matched
            run = child.tokens
            m = min(len(run), n - matched)
            neq = np.nonzero(run[:m] != toks[matched:matched + m])[0]
            d = int(neq[0]) if len(neq) else m
            matched += d
            node = child
            if d < len(run):
                return node, matched
        return node, matched

    def _radix_match(self, toks: np.ndarray, cap: int):
        """``(node, usable_len)``: the longest restorable prefix of
        ``toks``, at most ``cap``.  Attention K/V rows are pure functions
        of the token prefix, so without state leaves a match may end
        anywhere; a recurrent state is valid only at the length it was
        taken, so a stateful model's match ends at the deepest node
        boundary on the path that holds a snapshot."""
        node, matched = self._radix_walk(toks)
        usable = min(matched, cap)
        if usable <= 0:
            return None, 0
        if not self.has_state_leaves:
            return node, usable
        n = node
        while n is not None and n.parent is not None:
            if n.state is not None and n.end <= usable:
                return n, n.end
            n = n.parent
        return None, 0

    def _radix_assemble(self, node: "_RadixNode", length: int) -> np.ndarray:
        """The physical pages backing positions ``[0, length)`` along
        ``node``'s root path, deepest node first (at an index covered by
        a node and its ancestor, a mid-page boundary, the deeper node's
        page is the valid one: first write wins)."""
        need = self._npages(length)
        out = np.full((need,), -1, np.int32)
        n = node
        while n is not None and n.parent is not None:
            p0 = n.start // self.page_size
            for j in range(len(n.pages)):
                idx = p0 + j
                if idx >= need:
                    break
                if out[idx] < 0:
                    out[idx] = n.pages[j]
            n = n.parent
        assert (out >= 0).all(), (out, length)
        return out

    def _radix_touch(self, node: "_RadixNode") -> None:
        n = node
        while n is not None:
            n.last_used = self._tick
            n = n.parent

    def _radix_split(self, node: "_RadixNode", at: int) -> "_RadixNode":
        """Split ``node`` at absolute offset ``at`` (strictly inside its
        run); returns the new first half.  A mid-page cut lists the
        boundary page in both halves (one extra tree reference): the
        page's rows are valid through the original run, so each half
        reads only positions it covers."""
        ps = self.page_size
        d = at - node.start
        assert 0 < d < len(node.tokens), (at, node.start, len(node.tokens))
        cut = self._npages(at) - node.start // ps
        first = _RadixNode(node.tokens[:d].copy(), node.start,
                           node.pages[:cut].copy(), node.parent)
        first.last_used = node.last_used
        first.children[int(node.tokens[d])] = node
        node.parent.children[int(first.tokens[0])] = first
        tail = at // ps - node.start // ps
        if at % ps:
            self._incref(int(node.pages[tail]))
            self._radix_page_refs += 1
        node.pages = node.pages[tail:].copy()
        node.tokens = node.tokens[d:]
        node.start = at
        node.parent = first
        self._radix_nodes += 1
        return first

    def _radix_append(self, parent: "_RadixNode", slot: int,
                      toks: np.ndarray, matched: int) -> "_RadixNode":
        """Attach ``toks[matched:]`` as a new child of ``parent``, sharing
        the slot's pages for those positions by reference."""
        p0, p1 = matched // self.page_size, self._npages(len(toks))
        pages = self.block_table[slot, p0:p1].copy()
        assert (pages >= 0).all(), pages
        for p in pages:
            self._incref(int(p))
        self._radix_page_refs += len(pages)
        self.stats["shared_pages"] += len(pages)
        child = _RadixNode(toks[matched:].copy(), matched, pages, parent)
        child.last_used = self._tick
        parent.children[int(toks[matched])] = child
        self._radix_nodes += 1
        return child

    def _radix_evict_one(self) -> bool:
        """Evict the least-recently-used unpinned *leaf*: cold leaves go
        first, hot spines survive (every touch refreshes the whole path,
        so a spine is as recent as its most recent descendant).  False
        when nothing is evictable."""
        best = None
        stack = [self._radix_root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is self._radix_root or n.children or n.pin:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        if best is None:
            return False
        for p in best.pages:
            self._decref(int(p))
        self._radix_page_refs -= len(best.pages)
        del best.parent.children[int(best.tokens[0])]
        best.parent = None
        self._radix_nodes -= 1
        self.stats["evictions"] += 1
        self.prefix_version += 1
        return True

    def peek_prefix(self, tokens: np.ndarray) -> int:
        if self.prefix_mode == "radix":
            return self.peek_longest(tokens)
        return super().peek_prefix(tokens)

    def peek_longest(self, tokens: np.ndarray,
                     max_len: Optional[int] = None) -> int:
        if self.prefix_mode != "radix":
            return super().peek_longest(tokens, max_len)
        toks = np.ascontiguousarray(tokens, np.int32).ravel()
        cap = len(toks) if max_len is None else min(len(toks), max_len)
        if cap <= 0:
            return 0
        _, usable = self._radix_match(toks, cap)
        return usable

    def lookup(self, tokens: np.ndarray):
        if self.prefix_mode == "radix":
            return self.lookup_longest(tokens)
        return super().lookup(tokens)

    def lookup_longest(self, tokens: np.ndarray,
                       max_len: Optional[int] = None):
        if self.prefix_mode != "radix":
            return super().lookup_longest(tokens, max_len)
        toks = np.ascontiguousarray(tokens, np.int32).ravel()
        cap = len(toks) if max_len is None else min(len(toks), max_len)
        if cap <= 0:
            self.stats["prefix_misses"] += 1
            return None
        node, usable = self._radix_match(toks, cap)
        if usable <= 0:
            self.stats["prefix_misses"] += 1
            return None
        self._tick += 1
        self._radix_touch(node)
        self.stats["prefix_hits"] += 1
        if usable < cap:
            self.stats["prefix_partial_hits"] += 1
        # a borrowed view of the tree's pages: restore_prefix takes the
        # slot's own references
        return PagedEntry(pages=self._radix_assemble(node, usable),
                          length=usable, state=node.state,
                          last_used=self._tick, owns_refs=False)

    def restore_prefix(self, dst_slot: int, entry: PagedEntry) -> None:
        """A prefix hit: point ``dst_slot``'s table at the shared pages
        (refcount + 1) with no device copy.  The first write into the
        shared tail page copies it in ``prepare_append``."""
        for i, p in enumerate(entry.pages):
            self._incref(int(p))
            self.block_table[dst_slot, i] = int(p)
        self._bt_dev = None
        self.lengths[dst_slot] = entry.length
        self._state_restore(dst_slot, entry.state)

    def _drop_entry(self, entry: PagedEntry) -> None:
        if not entry.owns_refs:
            return                # borrowed radix view: the tree keeps them
        for p in entry.pages:
            self._decref(int(p))

    # ---- tool-wait parking: reference transfer --------------------------
    def park(self, slot: int) -> PagedEntry:
        """Move the slot's page references into the returned entry and
        free the slot: no device copy.  The caller owns the entry; it is
        not in the evictable prefix store."""
        pages = self.block_table[slot]
        pages = pages[pages >= 0].copy()
        entry = PagedEntry(pages=pages, length=int(self.lengths[slot]),
                           state=self._state_snapshot(slot))
        self._release_slot(slot)          # refs move with the entry
        self.stats["parks"] += 1
        return entry

    def unpark(self, slot: int, entry: PagedEntry) -> None:
        """Restore a parked entry into a freshly allocated slot: the page
        references move back (no incref, no copy)."""
        self.block_table[slot, :len(entry.pages)] = entry.pages
        self._bt_dev = None
        self.lengths[slot] = entry.length
        self._state_restore(slot, entry.state)
        self.stats["unparks"] += 1

    # ---- step integration ----------------------------------------------
    def commit(self, new_cache, slot_mask: np.ndarray) -> None:
        """Paged commit: every leaf is the shared arena and the writes
        already landed page-exactly (inactive lanes on the scratch page),
        so the new cache is taken as it is."""
        self.cache = new_cache

    def arena_bytes(self) -> int:
        """The positional arena's footprint in bytes (0 without attention
        layers; per-slot state leaves are not part of it)."""
        return sum(leaf.numel() * leaf.element_size()
                   for layer in self.cache.values() if _is_positional(layer)
                   for leaf in layer.values())


def make_pool(cfg: ModelConfig, num_slots: int, max_seq: int,
              dtype=torch.float32, device="cuda",
              max_prefix_entries: int = 8, num_pages: int = 0,
              prefix_cache: str = "radix") -> KVCachePool:
    """Layout-dispatching pool factory (``ModelConfig.kv_layout``).
    ``prefix_cache`` selects the paged pool's index ("radix" | "exact");
    the slab layout is always exact.  ``num_pages`` 0 sizes the paged
    arena at slab-capacity parity."""
    if cfg.kv_layout == "paged":
        return PagedKVCachePool(cfg, num_slots, max_seq, dtype, device,
                                max_prefix_entries, num_pages, prefix_cache)
    if cfg.kv_layout != "slab":
        raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
    return KVCachePool(cfg, num_slots, max_seq, dtype, device,
                       max_prefix_entries)
