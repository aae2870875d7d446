"""Lease-based coordinator election with automatic failover.

Reference semantics reproduced (internal/agent/coordinator/election.go):

- Constants 15s lease duration / 10s renew interval / 2s retry
  (election.go:41-43). A dead coordinator is replaced within
  ``LEASE_DURATION_S`` + one retry tick.
- ``try_acquire_or_renew`` state machine (election.go:47-69): lease missing →
  create (create-conflict safe, :72-104); held by me → renew (:107-120);
  expired → steal via optimistic CAS (:123-141); held by live other → false.
- Expiry = renew_time + duration < now (:144-155).
- ``run`` loop fires ``on_elected``/``on_lost`` only on state *transitions*
  (:170-225), so role goroutine/thread churn happens exactly at flips.

Differences (deliberate):

- Time comes from a ``Clock``; the reference calls time.Now() inline, which
  is why its election logic has zero tests (SURVEY.md §4). With
  ``SimulatedClock`` the failover and split-brain paths are tested
  deterministically in milliseconds (tests/test_election.py).
- The ticker runs at the 2s retry period in both roles, renewing on every
  leader tick exactly like the reference (election.go:178). An earlier
  draft renewed only at half the renew interval to cut write QPS; under
  host CPU starvation that margin proved too thin (a delayed tick blows
  the TTL and the fleet thrashes through steal/flip cycles).

A copy of ``kubeinfer_tpu/coordination/lease.py`` for the PyTorch port.
Its locks are plain ``threading`` primitives: the reference's race-
checker hooks are no-ops outside an armed analysis run, and the race
checker is not ported.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable

from kubeinfer_tpu_torch.controlplane.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    Store,
)
from kubeinfer_tpu_torch.resilience import faultpoints
from kubeinfer_tpu_torch.utils.clock import Clock, RealClock

# Store failures a renew tick must survive (see node_agent.py
# STORE_TRANSIENT: OSError covers urllib errors and the breaker's
# fast-fail; JSONDecodeError is a torn payload past its retries).
_TRANSIENT = (OSError, json.JSONDecodeError)

log = logging.getLogger(__name__)

LEASE_DURATION_S = 15.0  # election.go:41
RENEW_INTERVAL_S = 10.0  # election.go:42
RETRY_INTERVAL_S = 2.0  # election.go:43

LEASE_KIND = "Lease"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease equivalent."""

    name: str
    namespace: str = "default"
    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    duration_s: float = LEASE_DURATION_S
    resource_version: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "resourceVersion": self.resource_version,
            },
            "spec": {
                "holderIdentity": self.holder,
                "acquireTime": self.acquire_time,
                "renewTime": self.renew_time,
                "leaseDurationSeconds": self.duration_s,
            },
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Lease":
        spec = d.get("spec") or {}
        meta = d.get("metadata") or {}
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            holder=spec.get("holderIdentity", ""),
            acquire_time=float(spec.get("acquireTime", 0.0)),
            renew_time=float(spec.get("renewTime", 0.0)),
            duration_s=float(spec.get("leaseDurationSeconds", LEASE_DURATION_S)),
            resource_version=int(meta.get("resourceVersion", 0)),
        )


class LeaseManager:
    """One participant in a named election.

    ``identity`` is the pod name in the reference (cmd/agent/main.go:74);
    the Lease's holderIdentity is how followers resolve the coordinator
    (main.go:175-201), so whatever is stored here must be resolvable to an
    endpoint by peers.
    """

    def __init__(
        self,
        store: Store,
        namespace: str,
        lease_name: str,
        identity: str,
        clock: Clock | None = None,
        duration_s: float = LEASE_DURATION_S,
        renew_interval_s: float = RENEW_INTERVAL_S,
        retry_interval_s: float = RETRY_INTERVAL_S,
    ) -> None:
        self._store = store
        self._namespace = namespace
        self._lease_name = lease_name
        self.identity = identity
        self._clock = clock or RealClock()
        self._duration = duration_s
        self._renew_interval = renew_interval_s
        self._retry = retry_interval_s
        self._mu = threading.Lock()  # guards _is_leader (election.go:26-27)
        self._is_leader = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- state machine (election.go:47-69) --------------------------------

    def try_acquire_or_renew(self) -> bool:
        """One election tick. Store-transport failures report NOT-held
        (never raise): a partitioned participant must degrade to
        follower — its lease TTL-expires and a reachable peer steals it,
        which IS the failover the protocol is built around. Retrying
        inside the tick is deliberately left to the store client
        (RemoteStore's policy); stacking another schedule here would
        stretch the tick past the retry interval and thin the renew
        margin the module docstring calls out.
        """
        now = self._clock.now()
        try:
            faultpoints.fire("lease.renew", key=self.identity)
            lease = Lease.from_dict(
                self._store.get(LEASE_KIND, self._lease_name, self._namespace)
            )
        except NotFoundError:
            return self._create_lease(now)
        except _TRANSIENT as e:
            log.warning(
                "%s: lease %s tick failed (store: %s); degrading to "
                "follower", self.identity, self._lease_name, e,
            )
            return False
        if lease.holder == self.identity:
            return self._renew_lease(lease, now)
        if self._expired(lease, now):
            return self._acquire_lease(lease, now)
        return False

    def _expired(self, lease: Lease, now: float) -> bool:
        # election.go:144-155
        return lease.renew_time + lease.duration_s < now

    def _create_lease(self, now: float) -> bool:
        # election.go:72-104 — atomic create; racing peers get AlreadyExists.
        lease = Lease(
            name=self._lease_name,
            namespace=self._namespace,
            holder=self.identity,
            acquire_time=now,
            renew_time=now,
            duration_s=self._duration,
        )
        try:
            self._store.create(LEASE_KIND, lease.to_dict())
            log.info("%s created lease %s", self.identity, self._lease_name)
            return True
        except AlreadyExistsError:
            return False
        except _TRANSIENT:
            # a create that LANDED before the failure is indistinguishable
            # from one that didn't; report not-held — if we do hold it,
            # the next tick's read sees our identity and renews
            return False

    def _renew_lease(self, lease: Lease, now: float) -> bool:
        # election.go:107-120. A failed CAS means someone stole it after our
        # read (we must have expired) — report loss, next tick re-evaluates.
        lease.renew_time = now
        try:
            self._store.update(LEASE_KIND, lease.to_dict())
            return True
        except (ConflictError, NotFoundError):
            return False
        except _TRANSIENT:
            # transport failure ≠ lost lease, but the safe report is
            # not-held: a leader that can't renew must stand down before
            # a peer steals the expired lease (split-brain otherwise)
            return False

    def _acquire_lease(self, lease: Lease, now: float) -> bool:
        # election.go:123-141 — steal with the read resourceVersion; exactly
        # one of N racing stealers passes the CAS.
        lease.holder = self.identity
        lease.acquire_time = now
        lease.renew_time = now
        lease.duration_s = self._duration
        try:
            self._store.update(LEASE_KIND, lease.to_dict())
            log.info("%s stole lease %s", self.identity, self._lease_name)
            return True
        except (ConflictError, NotFoundError, *_TRANSIENT):
            return False

    # -- public state ------------------------------------------------------

    def is_coordinator(self) -> bool:
        with self._mu:  # election.go:157-167
            return self._is_leader

    def get_holder(self) -> str:
        """Current holderIdentity, "" if no lease (cmd/agent/main.go:175-187)."""
        try:
            lease = Lease.from_dict(
                self._store.get(LEASE_KIND, self._lease_name, self._namespace)
            )
        except NotFoundError:
            return ""
        except _TRANSIENT:
            # unknown ≠ none, but callers treat "" as "retry later"
            # (follower sync loops re-resolve each attempt) — the honest
            # degraded answer during a store outage
            return ""
        return lease.holder

    # -- loop (election.go:170-225) ----------------------------------------

    def run(
        self,
        on_elected: Callable[[], None],
        on_lost: Callable[[], None],
    ) -> None:
        """Blocking election loop; call ``stop()`` from another thread.

        Ticks every retry interval in both roles; fires
        callbacks only on transitions — plus one initial ``on_lost`` when
        the first tick does NOT win, so a participant that never leads
        still learns it is a follower and can start the follower role
        (a flow the reference leaves implicit: its onLost only fires on
        C→F transitions, cmd/agent/main.go:136-159).
        """
        first = True
        while not self._stop.is_set():
            acquired = self.try_acquire_or_renew()
            with self._mu:
                was = self._is_leader
                self._is_leader = acquired
            if acquired and not was:
                on_elected()
            elif (was or first) and not acquired:
                on_lost()
            first = False
            # Tick at the retry interval in BOTH roles (election.go:178
            # ticks leaders every 2s too). Renewing only near the renew
            # deadline would cut write QPS, but it thins the starvation
            # margin: on a loaded host a delayed renew tick blows the TTL
            # and the fleet thrashes through steal/flip cycles.
            self._clock.wait(self._stop, self._retry)
        # On clean shutdown, surrender leadership state (the reference's
        # context-cancel path just exits; peers take over on expiry).
        with self._mu:
            was = self._is_leader
            self._is_leader = False
        if was:
            on_lost()

    def start(
        self,
        on_elected: Callable[[], None],
        on_lost: Callable[[], None],
    ) -> threading.Thread:
        """Run the loop in a daemon thread (agent main's `go lm.Run`)."""
        t = threading.Thread(
            target=self.run, args=(on_elected, on_lost), daemon=True,
            name=f"election-{self._lease_name}-{self.identity}",
        )
        self._thread = t
        t.start()
        return t

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
