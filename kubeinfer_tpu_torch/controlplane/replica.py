"""Journal-streaming store standby — the etcd-replication role.

The reference control plane rests on a replicated, always-on etcd: the
API server (and with it every CR and lease) survives the loss of any one
node, and a standby manager sees full state instantly
(election.go:72-141; llmservice_controller.go:84 assumes the API server
answers). kubeinfer_tpu hosts its store inside the manager process, so
without replication the store host is a single point of failure even
though the journal makes it restart-durable (r4 verdict missing #1).

``StoreReplica`` closes that gap: a standby manager tails the primary's
watch stream over the existing HTTP transport and applies every event
VERBATIM — same objects, same resourceVersion counter — into its own
durable local store (Store.apply_replicated). When the primary dies, the
standby promotes: it binds the shared store frontend address and serves
its replica. rv continuity across promotion is the load-bearing part —
agents' watch cursors stay valid and lease CAS-stealing (the election
protocol, lease.py) works against the promoted store exactly as it did
against the dead primary's.

Promotion arbitration is the frontend BIND: only one process can own the
shared host:port (the VIP role a cluster load balancer plays for the
reference's API server). A standby that loses the bind race resumes
following — the address now answers again, served by whichever standby
won — after a full /dump resync if its tail cursor fell behind.

Gap handling: the primary's event ring is finite (EVENT_LOG_SIZE), so a
follower whose cursor predates ``oldestEvent`` cannot prove continuity
and full-resyncs via ``/dump`` (atomic snapshot swap, Store.load_dump).

A copy of ``kubeinfer_tpu/controlplane/replica.py`` for the PyTorch
port.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore
from kubeinfer_tpu_torch.controlplane.store import Store

log = logging.getLogger(__name__)


class StoreReplica:
    """Follow a primary store into a local durable replica; call back on
    sustained primary failure so the owner can attempt promotion.

    ``on_primary_dead`` returns True when promotion succeeded (this
    replica's store is now being served; the follow loop exits) or False
    when the bind was lost to a sibling standby (the loop resyncs and
    resumes following the new primary at the same address).
    """

    def __init__(
        self,
        remote: RemoteStore,
        data_dir: str,
        failover_grace_s: float = 5.0,
        poll_timeout_s: float | None = None,
    ) -> None:
        self.store = Store(data_dir=data_dir)
        self._remote = remote
        self._grace = failover_grace_s
        # Detection latency for a packet-blackhole failure is one
        # in-flight long-poll timeout, so the poll window derives from
        # the grace: worst-case promotion starts ~(poll + cushion +
        # grace) after the failure, the same order as the knob's
        # documented meaning, instead of a fixed window that could
        # triple it.
        self._poll = (
            poll_timeout_s if poll_timeout_s is not None
            else min(5.0, max(0.5, failover_grace_s / 2.0))
        )
        self._stop = threading.Event()
        self._synced = threading.Event()  # first successful sync/tail
        self._thread: threading.Thread | None = None
        self.promoted = threading.Event()

    # -- lifecycle --------------------------------------------------------

    def start(self, on_primary_dead: Callable[[], bool]) -> "StoreReplica":
        self._thread = threading.Thread(
            target=self._loop, args=(on_primary_dead,), daemon=True,
            name="store-replica",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        # the store is NOT closed here when promoted — ownership moved
        # to the serving manager, which closes it on shutdown
        if not self.promoted.is_set():
            self.store.close()

    def wait_synced(self, timeout: float) -> bool:
        return self._synced.wait(timeout)

    @property
    def synced(self) -> bool:
        """True after the first successful sync/tail (probe surface)."""
        return self._synced.is_set()

    # -- follow loop ------------------------------------------------------

    def _loop(self, on_primary_dead: Callable[[], bool]) -> None:
        last_ok: float | None = None
        need_resync_check = True
        while not self._stop.is_set():
            try:
                if need_resync_check:
                    self._maybe_resync()
                    need_resync_check = False
                page = self._remote.watch_page(self.store._rv, self._poll)
                oldest = page.get("oldestEvent", 0)
                tip = page["resourceVersion"]
                if page.get("storeRv", tip) < self.store._rv:
                    # the primary's ACTUAL counter is BEHIND our cursor
                    # (restarted with a shorter/fresh history inside the
                    # grace window; the watch cursor itself is clamped
                    # to `since` so `tip` can never show this): every
                    # page would no-op forever while we report synced —
                    # divergence repair via _maybe_resync
                    need_resync_check = True
                    continue
                if tip > self.store._rv and (
                    oldest == 0 or oldest > self.store._rv + 1
                ):
                    # the primary is ahead but the ring cannot prove
                    # continuity from our cursor (rolled over, or empty
                    # after a primary restart): events were lost
                    need_resync_check = True
                    continue
                for e in page["events"]:
                    self.store.apply_replicated(
                        e["type"], e["kind"], e["namespace"], e["name"],
                        e.get("object"), e["resourceVersion"],
                    )
                last_ok = None
                self._synced.set()
            except Exception as e:  # transport/primary failure
                import time

                # the journal tail is no longer live: /replicaz must
                # stop reporting synced or an operator could trust a
                # failover onto an arbitrarily stale replica during a
                # partition the bind-arbitrated promotion cannot win
                self._synced.clear()
                now = time.monotonic()
                if last_ok is None:
                    last_ok = now
                    log.warning("replica: primary unreachable: %s", e)
                if now - last_ok >= self._grace:
                    log.warning(
                        "replica: primary dead for %.1fs; attempting "
                        "promotion", now - last_ok,
                    )
                    if on_primary_dead():
                        self.promoted.set()
                        return
                    # lost the bind race: a sibling promoted. Resync
                    # against the address (now answering again) and
                    # resume following.
                    last_ok = None
                    need_resync_check = True
                if self._stop.wait(min(self._poll, 1.0)):
                    return

    def _maybe_resync(self) -> None:
        """Full /dump resync when the tail cursor cannot be proven
        continuous (bootstrap from empty, or the ring rolled over)."""
        rv, objects = self._remote.dump()
        if rv == self.store._rv:
            return  # already current (normal warm start)
        if rv < self.store._rv:
            # The remote is BEHIND us: a sibling standby with a shorter
            # replication tail won the bind race. The serving primary's
            # history is the fleet's truth now — our surplus records
            # were never acked to any client while WE were a standby, so
            # adopting the shorter history wholesale is divergence
            # repair, not data loss. (If we were once a primary, the
            # surplus is the async-replication loss window — gone the
            # moment the fleet moved on, whatever we keep locally.)
            # Keeping our longer state instead would silently diverge:
            # the primary's events at rvs we already passed would be
            # filtered out of our watch stream forever.
            log.warning(
                "replica: remote rv %d behind local %d; adopting the "
                "serving primary's state (divergence repair)",
                rv, self.store._rv,
            )
            self.store.load_dump(rv, objects, allow_regress=True)
            return
        self.store.load_dump(rv, objects)
        log.info(
            "replica: synced %d objects at rv %d", len(objects), rv
        )
