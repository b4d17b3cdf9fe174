"""Rotation-key store: byte-capped device LRU with on-demand regeneration.

Copy of the JAX package's store.  A full-fidelity keyswitch key is
[dnum, 2, nq+ksp, 2^17] int32 (0.35-1.26 GB on the registry's chains at
ring 2^17), and pipelines like MEHP24 need ~20-40 distinct rotation
indices.  With a byte budget the store keeps at most `budget_bytes` of
keys resident and regenerates evicted keys on demand through a
deterministic per-index path (CkksContext._regen_rot_key ->
keys.gen_rotation_key_dev), so eviction is transparent.  An evicted key's
device memory returns to the allocator only when nothing else holds the
tensor: the context's ops take a key as an argument for one call and keep
no reference to it.

Iterating the store's values (`items()`, `values()`) materialises every
registered key, one after another; `len()`, `in`, `pinned()` and
`resident_bytes` make none.  An entry is anything with `nbytes`: on a
context placed on a mesh (parallel/mesh.py) the regeneration hook gives
a key's slot blocks, whose `nbytes` is the whole key's, so the store
keeps only the blocks and evicts in the same order as on one device.

Regeneration uses the client-side KeyGenerator, which this process also
holds, as in the reference's experimental setup (the sorting process
keeps the secret key, DirectSortTest.cpp:27-57).  An evaluation-only
context (serial.py) pins the keys it loads (budget or not) and makes
none.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import MutableMapping


class KeyStore(MutableMapping):
    """dict-like rotation-key map.

    budget None: every key set or generated stays resident (plain dict
    behavior — the default, bit-for-bit compatible with round-4 code).

    budget set: keys registered via `register(k)` materialize lazily via
    `regen(k)` on first access and live in a byte-capped LRU; directly
    assigned keys (``store[k] = arr``) are pinned and never evicted.
    """

    def __init__(self, budget_bytes: int | None = None, regen=None):
        self._pinned: dict[int, object] = {}
        self._lru: "OrderedDict[int, object]" = OrderedDict()
        self._registered: set[int] = set()
        self._budget = budget_bytes
        self._regen = regen
        self._bytes = 0
        self.regen_count = 0      # telemetry: lazy (re)generations

    # ------------------------------------------------------------- mapping
    def __setitem__(self, k: int, v):
        k = int(k)
        if k in self._lru:
            self._bytes -= self._lru.pop(k).nbytes
        self._pinned[k] = v

    def __getitem__(self, k: int):
        k = int(k)
        hit = self._pinned.get(k)
        if hit is not None:
            return hit
        hit = self._lru.get(k)
        if hit is not None:
            self._lru.move_to_end(k)
            return hit
        if k in self._registered and self._regen is not None:
            return self._materialize(k)
        raise KeyError(k)

    def __delitem__(self, k: int):
        k = int(k)
        if k in self._pinned:
            del self._pinned[k]
        elif k in self._lru:
            self._bytes -= self._lru.pop(k).nbytes
        elif k in self._registered:
            self._registered.discard(k)
        else:
            raise KeyError(k)
        self._registered.discard(k)

    def __contains__(self, k) -> bool:
        k = int(k)
        return (k in self._pinned or k in self._lru
                or k in self._registered)

    def __iter__(self):
        return iter(self._pinned.keys() | self._lru.keys()
                    | self._registered)

    def __len__(self) -> int:
        return len(self._pinned.keys() | self._lru.keys()
                   | self._registered)

    def clear(self):
        self._pinned.clear()
        self._lru.clear()
        self._registered.clear()
        self._bytes = 0

    # ------------------------------------------------------------ streaming
    def register(self, k: int):
        """Declare rotation index k available without materializing it."""
        self._registered.add(int(k))

    def _materialize(self, k: int):
        arr = self._regen(k)
        self.regen_count += 1
        if self._budget is None:
            self._pinned[k] = arr
            return arr
        self._lru[k] = arr
        self._bytes += arr.nbytes
        while self._bytes > self._budget and len(self._lru) > 1:
            _, old = self._lru.popitem(last=False)
            self._bytes -= old.nbytes
        return arr

    def evict(self, k: int):
        """Drop a cached (non-pinned) key; it stays registered and will
        regenerate on next access.  No-op if not cached."""
        arr = self._lru.pop(int(k), None)
        if arr is not None:
            self._bytes -= arr.nbytes

    def evict_all(self):
        """Drop every cached (non-pinned) key; each stays registered."""
        self._lru.clear()
        self._bytes = 0

    def is_pinned(self, k: int) -> bool:
        return int(k) in self._pinned

    def pinned(self) -> list:
        """The pinned keys' indices (makes no key)."""
        return list(self._pinned)

    @property
    def resident_bytes(self) -> int:
        return self._bytes + sum(v.nbytes for v in self._pinned.values())
