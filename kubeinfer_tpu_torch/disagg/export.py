"""Export-side staging: recently prefilled prefixes, addressed by
fingerprint, held as ready-to-serve wire blobs.

Divergence from the reference plane this mirrors (model_server.go:26-130
serves a static file listing once per rollout): prefills are produced
continuously and consumed at most a handful of times each (the decode
replica the router picked, plus retries), so the export side is a small
LRU keyed by the prefix's DEEPEST rolling fingerprint — the same value
the importer recomputes from its own prompt tokens, which is what makes
the lookup a content address rather than a session handle. Entries
store encoded wire bytes (wire.encode_payload), not arrays: the sha256
is paid once at put time on the captured pages, and the HTTP handler
serves byte blobs without touching engine state.

Capacity is entries AND (optionally) bytes. The entry cap alone was
enough for prefill exports, whose size is bounded by the engine's own
cache_len — but live-session migration parks CHUNKED blobs here (one
per chunk of a long session, wire v3), so 32 entries can be anywhere
from kilobytes to the whole pool's worth of pages. The bytes budget
(``--kv-export-budget-mb``) bounds the real resident cost; eviction
drops least-recently-PUT-or-GOT entries until both caps hold, but
never the entry being put — a blob larger than the whole budget must
still be servable at least once, or a big migration chunk could never
leave the source. A dropped export only costs the importer a fallback
to local (re-)prefill (token-identical by the determinism contract),
never correctness; the eviction counter is what tells an operator a
slow importer is losing blobs between chunks.

A copy of ``kubeinfer_tpu/disagg/export.py`` for the PyTorch port. Its
lock is a plain ``threading.Lock``: the reference's race-checker hooks
are no-ops outside an armed analysis run, and the race checker is not
ported.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

DEFAULT_EXPORT_CAPACITY = 32


class KVExportCache:
    """Bounded LRU of wire-encoded KV exports keyed by fingerprint."""

    def __init__(self, capacity: int = DEFAULT_EXPORT_CAPACITY,
                 max_bytes: int | None = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self._lock = threading.Lock()
        self._entries: OrderedDict[int, bytes] = OrderedDict()
        self._bytes = 0
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def put(self, fingerprint: int, blob: bytes) -> None:
        with self._lock:
            old = self._entries.pop(int(fingerprint), None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[int(fingerprint)] = blob
            self._bytes += len(blob)
            self.puts += 1
            # the len > 1 guard keeps the entry just put: a blob bigger
            # than the whole budget must still be servable once, else a
            # large migration chunk could never leave this replica
            while len(self._entries) > self.capacity or (
                self.max_bytes is not None
                and self._bytes > self.max_bytes
                and len(self._entries) > 1
            ):
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= len(dropped)
                self.evictions += 1

    def get(self, fingerprint: int) -> bytes | None:
        with self._lock:
            blob = self._entries.get(int(fingerprint))
            if blob is None:
                self.misses += 1
                return None
            self._entries.move_to_end(int(fingerprint))
            self.hits += 1
            return blob

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "puts": self.puts,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
