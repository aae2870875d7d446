"""Versioned, watchable object store — the API-server equivalent.

Semantics held to (what the reference code depends on in the real API server):

- **Create is atomic**: two racing creates of the same key — the exact race
  the reference's lease election leans on ("race-safe: create conflicts
  fail", election.go:72-104) — yield exactly one winner; the loser gets
  ``AlreadyExistsError``.
- **Update is optimistic CAS**: an update must carry the resourceVersion it
  read; a stale version raises ``ConflictError`` (election.go:133-134 relies
  on this for lease stealing).
- **Watches** deliver ordered ADDED/MODIFIED/DELETED events per key after the
  subscription point; the controller's reconcile triggering
  (SetupWithManager/Owns, llmservice_controller.go:316-321) is built on this.

Objects are stored and returned as plain dicts (the typed API's
``to_dict``/``from_dict`` round-trip) and deep-copied at the boundary, so no
caller can mutate the store's truth in place — the same isolation a real API
server's serialization boundary provides.

A copy of ``kubeinfer_tpu/controlplane/store.py`` for the PyTorch port.
The journal and snapshot formats are the reference's byte for byte, so a
data directory written by either package opens in the other. Its locks
are plain ``threading`` primitives: the reference's race-checker hooks
are no-ops outside an armed analysis run, and the race checker is not
ported.
"""

from __future__ import annotations

import copy
import json
import os
import queue
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator

# Journal entries between snapshot compactions. Control-plane mutation
# rates are a few per tick, so compaction is rare; the journal stays
# small enough that replay is never the startup bottleneck.
SNAPSHOT_EVERY = 512


class NotFoundError(KeyError):
    """Object does not exist (the IsNotFound branch, llmservice_controller.go:90)."""


class AlreadyExistsError(ValueError):
    """Create raced with an existing object (lease-creation race, election.go:95-103)."""


class ConflictError(ValueError):
    """Optimistic-concurrency failure: stale resourceVersion (election.go:133-134)."""


@dataclass(frozen=True)
class Key:
    kind: str
    namespace: str
    name: str


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    namespace: str
    name: str
    object: dict[str, Any]
    resource_version: int


@dataclass
class _Watcher:
    q: "queue.Queue[WatchEvent]"
    kind: str | None
    namespace: str | None
    closed: threading.Event = field(default_factory=threading.Event)


class Store:
    """Thread-safe versioned object store with watch streams.

    ``data_dir`` makes the store DURABLE — the etcd role the reference
    gets for free from the API server (SURVEY §1 coordination plane;
    every lease/CR semantic assumes objects outlive the process,
    election.go:72-141, llmservice_controller.go:84-164): every mutation
    appends one fsynced JSONL record to ``journal.jsonl``, compacted
    into an atomically-renamed ``snapshot.json`` every SNAPSHOT_EVERY
    records. On start, snapshot + journal replay restores both the
    objects AND the resourceVersion counter — CAS continuity across
    restarts is load-bearing (lease stealing compares the rv it read,
    election.go:133-134; a reset counter would let a stale holder win).
    Leases are replayed verbatim: the election's TTL check against
    renewTime already classifies a dead leader's lease as expired, so a
    restarted control plane converges without any special-casing.
    """

    def __init__(self, data_dir: str | os.PathLike | None = None) -> None:
        self._lock = threading.Lock()
        self._objects: dict[Key, dict[str, Any]] = {}
        self._rv = 0
        self._watchers: list[_Watcher] = []
        self._data_dir = Path(data_dir) if data_dir else None
        self._durable = self._data_dir is not None
        self._journal_f = None
        self._journal_n = 0
        if self._data_dir is not None:
            self._data_dir.mkdir(parents=True, exist_ok=True)
            self._replay()
            self._journal_f = open(
                self._data_dir / "journal.jsonl", "a", encoding="utf-8"
            )

    # -- durability ------------------------------------------------------

    def _replay(self) -> None:
        """Restore objects + rv from snapshot.json then journal.jsonl.

        Records at or below the snapshot's rv are skipped (a crash
        between snapshot rename and journal rotation leaves pre-snapshot
        records behind — rv makes replay idempotent). A torn final line
        (crash mid-append) stops the replay at the last durable record.
        """
        snap_path = self._data_dir / "snapshot.json"
        if snap_path.exists():
            snap = json.loads(snap_path.read_text(encoding="utf-8"))
            self._rv = int(snap["rv"])
            for kind, ns, name, obj in snap["objects"]:
                self._objects[Key(kind, ns, name)] = obj
        jpath = self._data_dir / "journal.jsonl"
        if not jpath.exists():
            return
        data = jpath.read_bytes()
        good_end = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail from a crash mid-append
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break
            good_end += len(line)
            if rec["rv"] <= self._rv:
                continue
            key = Key(rec["kind"], rec["ns"], rec["name"])
            if rec["op"] == "delete":
                self._objects.pop(key, None)
            else:
                self._objects[key] = rec["obj"]
            self._rv = rec["rv"]
            self._journal_n += 1
        if good_end < len(data):
            # Drop the torn/corrupt tail BEFORE reopening for append —
            # appending after it would weld the next record onto the
            # partial line and lose both on the following replay.
            with open(jpath, "r+b") as f:
                f.truncate(good_end)

    def _check_open(self) -> None:
        """Reject mutations on a closed durable store BEFORE any state
        changes: raising from _append after the in-memory write would
        leave memory diverged from the journal (object applied, rv
        consumed, nothing durable) — the review repro for this."""
        if self._durable and self._journal_f is None:
            raise RuntimeError(
                "durable store is closed; mutations would be lost on "
                "restart"
            )

    def _append(
        self, op: str, key: Key, rv: int, obj: dict[str, Any] | None
    ) -> None:
        """Journal one mutation (called under self._lock, AFTER the
        in-memory mutation succeeded). Write+flush only — the fsync
        happens in ``_sync`` AFTER the lock is released, so node
        heartbeats at fleet scale (one update per node per interval on a
        1k-node soak) pay their own disk latency without serializing
        every concurrent get/list/watch behind it. Record order on disk
        is still total (writes happen under the lock); the crash-loss
        window is the mutations whose fsync hadn't completed — each
        mutator only returns to ITS caller after its own fsync."""
        if self._journal_f is None:
            return  # in-memory store (closed-durable rejected up front)
        rec: dict[str, Any] = {
            "op": op, "kind": key.kind, "ns": key.namespace,
            "name": key.name, "rv": rv,
        }
        if obj is not None:
            rec["obj"] = obj
        self._journal_f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._journal_f.flush()
        self._journal_n += 1
        if self._journal_n >= SNAPSHOT_EVERY:
            self._compact()

    def _sync(self) -> None:
        """fsync the journal outside the store lock (see _append). The
        journal file can rotate (compaction) or close concurrently —
        both leave the records already flushed durable via their own
        fsync/close, so the raced handle is safely skipped."""
        f = self._journal_f
        if f is None:
            return
        try:
            os.fsync(f.fileno())
        except ValueError:  # rotated/closed between read and fsync
            pass

    def _compact(self) -> None:
        """Write snapshot atomically (tmp + fsync + rename), then rotate
        the journal. Crash-safe at every boundary: before the rename the
        old snapshot+journal replay; after it, duplicate journal records
        are skipped by rv."""
        snap = {
            "rv": self._rv,
            "objects": [
                [k.kind, k.namespace, k.name, o]
                for k, o in self._objects.items()
            ],
        }
        tmp = self._data_dir / "snapshot.json.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._data_dir / "snapshot.json")
        # The rename's dirent update must hit disk before the journal is
        # truncated: otherwise a crash can persist the truncate but lose the
        # rename, dropping journaled records and regressing rv (the CAS /
        # lease-stealing continuity this store exists to protect).
        dfd = os.open(self._data_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._journal_f.close()
        self._journal_f = open(
            self._data_dir / "journal.jsonl", "w", encoding="utf-8"
        )
        self._journal_n = 0

    # -- replication (follower surface) ----------------------------------
    #
    # The reference's control plane rides a REPLICATED etcd: a manager
    # (or its node) can vanish and every CR/lease survives with no
    # shared disk (election.go:72-141, llmservice_controller.go:84
    # assume the API server outlives any client). These three methods
    # are the follower half of that: a standby tails the primary's
    # watch stream and applies events VERBATIM — same objects, same
    # resourceVersion counter — into its own durable store, so a
    # promoted standby carries full state and CAS/lease-steal
    # continuity without shared disk.

    def dump(self) -> tuple[int, list]:
        """Consistent full-state copy for follower bootstrap/resync:
        (rv, [[kind, ns, name, obj], ...]) — the snapshot wire shape."""
        with self._lock:
            return self._rv, [
                [k.kind, k.namespace, k.name, copy.deepcopy(o)]
                for k, o in self._objects.items()
            ]

    def load_dump(self, rv: int, objects: list,
                  allow_regress: bool = False) -> None:
        """Replace local state with a primary's dump. Durability goes
        through _compact (atomic snapshot + journal rotation), so a
        crash mid-load replays either the old state or the new one,
        never a blend. rv normally only moves FORWARD; a follower
        adopting a new primary whose history is shorter than its own
        passes ``allow_regress=True`` — the serving primary's stream is
        the fleet's truth, and the snapshot rotation makes the lower
        counter consistent on disk (replay starts from the snapshot
        rv)."""
        with self._lock:
            self._check_open()
            if rv < self._rv and not allow_regress:
                raise ValueError(
                    f"dump rv {rv} behind local rv {self._rv}; refusing "
                    "to regress the CAS counter"
                )
            self._objects = {
                Key(kind, ns, name): copy.deepcopy(obj)
                for kind, ns, name, obj in objects
            }
            self._rv = rv
            if self._durable:
                self._compact()

    def apply_replicated(
        self, op: str, kind: str, namespace: str, name: str,
        obj: dict[str, Any] | None, rv: int,
    ) -> None:
        """Apply one replicated event verbatim (no new rv is minted —
        the primary already assigned it). Idempotent on replayed rvs,
        monotone by construction; journaled and fanned out to local
        watchers like any native mutation."""
        key = Key(kind, namespace, name)
        with self._lock:
            self._check_open()
            if rv <= self._rv:
                return  # replayed tail after a resync — already applied
            self._rv = rv
            if op == "DELETED":
                prev = self._objects.pop(key, None)
                self._append("delete", key, rv, None)
                if prev is not None:
                    self._notify("DELETED", kind, namespace, name, prev, rv)
            else:
                self._objects[key] = copy.deepcopy(obj)
                self._append(
                    "update" if op == "MODIFIED" else "create",
                    key, rv, self._objects[key],
                )
                self._notify(
                    "MODIFIED" if op == "MODIFIED" else "ADDED",
                    kind, namespace, name, self._objects[key], rv,
                )
        self._sync()

    def close(self) -> None:
        """Flush and close the journal. Further mutations on a durable
        store raise (RuntimeError from _append) rather than silently
        succeeding in memory only — an acknowledged-but-undurable write
        is exactly the CAS-continuity hole the journal exists to close.
        Call only at process shutdown, after all mutators stopped."""
        with self._lock:
            if self._journal_f is not None:
                self._journal_f.close()
                self._journal_f = None

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _meta(obj: dict[str, Any]) -> dict[str, Any]:
        return obj.setdefault("metadata", {})

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def _notify(
        self, type_: str, kind: str, namespace: str, name: str,
        obj: dict[str, Any], rv: int,
    ) -> None:
        """Fan out one event. ``obj`` is the store's own dict; each delivered
        watcher gets its own deep copy (consumers may normalize events in
        place and must not see each other's — or the store's — state), and
        nothing is copied when no watcher matches."""
        for w in self._watchers:
            if w.closed.is_set():
                continue
            if w.kind is not None and w.kind != kind:
                continue
            if w.namespace is not None and w.namespace != namespace:
                continue
            w.q.put(
                WatchEvent(type_, kind, namespace, name, copy.deepcopy(obj), rv)
            )

    # -- CRUD ------------------------------------------------------------

    def create(self, kind: str, obj: dict[str, Any]) -> dict[str, Any]:
        obj = copy.deepcopy(obj)
        meta = self._meta(obj)
        name = meta.get("name", "")
        namespace = meta.get("namespace", "default")
        if not name:
            raise ValueError("metadata.name is required")
        key = Key(kind, namespace, name)
        with self._lock:
            self._check_open()
            if key in self._objects:
                raise AlreadyExistsError(f"{kind} {namespace}/{name} already exists")
            rv = self._next_rv()
            meta["namespace"] = namespace
            meta["resourceVersion"] = rv
            meta.setdefault("generation", 1)
            self._objects[key] = obj
            self._append("create", key, rv, obj)
            self._notify("ADDED", kind, namespace, name, obj, rv)
            out = copy.deepcopy(obj)
        self._sync()
        return out

    def get(self, kind: str, name: str, namespace: str = "default") -> dict[str, Any]:
        key = Key(kind, namespace, name)
        with self._lock:
            obj = self._objects.get(key)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return copy.deepcopy(obj)

    def update(self, kind: str, obj: dict[str, Any]) -> dict[str, Any]:
        """CAS update: obj.metadata.resourceVersion must match the stored one."""
        obj = copy.deepcopy(obj)
        meta = self._meta(obj)
        name = meta.get("name", "")
        namespace = meta.get("namespace", "default")
        key = Key(kind, namespace, name)
        with self._lock:
            self._check_open()
            current = self._objects.get(key)
            if current is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            meta["namespace"] = namespace
            expected = current["metadata"].get("resourceVersion", 0)
            got = meta.get("resourceVersion", 0)
            if got != expected:
                raise ConflictError(
                    f"{kind} {namespace}/{name}: resourceVersion {got} != {expected}"
                )
            rv = self._next_rv()
            meta["resourceVersion"] = rv
            self._objects[key] = obj
            self._append("update", key, rv, obj)
            self._notify("MODIFIED", kind, namespace, name, obj, rv)
            out = copy.deepcopy(obj)
        self._sync()
        return out

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        key = Key(kind, namespace, name)
        with self._lock:
            self._check_open()
            obj = self._objects.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            rv = self._next_rv()
            self._append("delete", key, rv, None)
            self._notify("DELETED", kind, namespace, name, obj, rv)
        self._sync()

    def list(self, kind: str, namespace: str | None = None) -> list[dict[str, Any]]:
        with self._lock:
            out = [
                copy.deepcopy(o)
                for k, o in self._objects.items()
                if k.kind == kind and (namespace is None or k.namespace == namespace)
            ]
        out.sort(key=lambda o: (o["metadata"]["namespace"], o["metadata"]["name"]))
        return out

    # -- watch -----------------------------------------------------------

    def watch(
        self, kind: str | None = None, namespace: str | None = None
    ) -> "Watch":
        w = _Watcher(q=queue.Queue(), kind=kind, namespace=namespace)
        with self._lock:
            self._watchers.append(w)
        return Watch(self, w)

    def _close_watch(self, w: _Watcher) -> None:
        w.closed.set()
        with self._lock:
            if w in self._watchers:
                self._watchers.remove(w)


class Watch:
    """Handle on a watch stream. Iterate or poll with ``next_event``."""

    def __init__(self, store: Store, watcher: _Watcher):
        self._store = store
        self._w = watcher

    def next_event(self, timeout: float | None = None) -> WatchEvent | None:
        try:
            return self._w.q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list[WatchEvent]:
        out = []
        while True:
            try:
                out.append(self._w.q.get_nowait())
            except queue.Empty:
                return out

    def close(self) -> None:
        self._store._close_watch(self._w)

    def __iter__(self) -> Iterator[WatchEvent]:
        while not self._w.closed.is_set():
            ev = self.next_event(timeout=0.1)
            if ev is not None:
                yield ev


def retry_on_conflict(
    fn: Callable[[], Any], attempts: int = 5
) -> Any:
    """Run a read-modify-write closure, retrying on ConflictError.

    The standard client-side pattern for status updates under contention
    (the reference's Status().Update can fail the same way,
    llmservice_controller.go:164).
    """
    last: Exception | None = None
    for _ in range(attempts):
        try:
            return fn()
        except ConflictError as e:  # re-read inside fn on next attempt
            last = e
    assert last is not None
    raise last
