"""KV-cache pool: slot allocation, length tracking, prefix caching.

One engine owns one pool: prefill writes and decode reads the *same*
buffers, so a completed prefill's KV is visible to decode with no
transfer; slot lifetime is managed on the host, and ordering within a
step is the order of launches on the device's stream.

Prefix cache: after a cold prefill of a shared system prompt, the engine
registers a *snapshot* of that slot's cache rows at that length.  A later
cold prefill with an identical token prefix copies the snapshot instead
of recomputing.  Only the slab layout is ported: the paged pool, its
block tables and the radix prefix index are a later slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_cache


class KVExhausted(RuntimeError):
    """Typed capacity fault: the pool has no free slot.

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


def _snapshot(cache, slot: int):
    """Copy of every cache leaf's rows for ``slot`` ([:, slot])."""
    return {name: {k: v[:, slot].clone() for k, v in layer.items()}
            for name, layer in cache.items()}


def _restore(cache, snapshot, slot: int) -> None:
    """Write a snapshot back into ``slot``, in place."""
    for name, layer in cache.items():
        for k, v in layer.items():
            v[:, slot].copy_(snapshot[name][k])


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
        self.cache = init_cache(cfg, num_slots, max_seq, dtype, device)
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
        self.stats = {"alloc": 0, "free": 0, "prefix_hits": 0,
                      "prefix_partial_hits": 0, "prefix_misses": 0,
                      "prefix_refreshes": 0, "evictions": 0,
                      "parks": 0, "unparks": 0}

    # ---- slot lifecycle -------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise KVExhausted("slot", "KV pool exhausted: no free slot")
        slot = min(self._free)
        self._free.discard(slot)
        self.lengths[slot] = 0
        self.stats["alloc"] += 1
        return slot

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
        self.prefix_version += 1

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

    def _evict_one(self) -> None:
        """Evict the least-recently-used entry."""
        if not self._prefix:
            return
        key = min(self._prefix, key=lambda k: self._prefix[k].last_used)
        del self._prefix[key]
        self.stats["evictions"] += 1
        self.prefix_version += 1

    def release_entry(self, entry) -> None:
        """Release a caller-owned (parked) entry without restoring it.
        Slab entries are plain snapshots: nothing to do."""

    # ---- tool-wait parking ----------------------------------------------
    def park(self, slot: int) -> PrefixEntry:
        """Snapshot a slot's full cache rows and free the slot.  The
        caller owns the returned snapshot (it is not in the evictable
        prefix store), so a parked session never loses its state."""
        entry = PrefixEntry(snapshot=_snapshot(self.cache, slot),
                            length=int(self.lengths[slot]))
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


def make_pool(cfg: ModelConfig, num_slots: int, max_seq: int,
              dtype=torch.float32, device="cuda",
              max_prefix_entries: int = 8) -> KVCachePool:
    """Layout-dispatching pool factory (``ModelConfig.kv_layout``)."""
    if cfg.kv_layout != "slab":
        raise NotImplementedError(
            f"kv_layout={cfg.kv_layout!r} is not ported yet (slab only)")
    return KVCachePool(cfg, num_slots, max_seq, dtype, device,
                       max_prefix_entries)
