"""``python -m kubeinfer_tpu_torch.manager`` — the manager binary.

Flag surface mirrors reference cmd/manager/main.go:65-86:
``--metrics-bind-address`` / ``--health-probe-bind-address`` /
``--leader-elect`` keep their names; ``--store-bind-address`` replaces the
kubeconfig (this manager *hosts* the control plane; see manager package
docstring); ``--auth-token-file`` is the static-token analogue of the
reference's authn/authz filters (main.go:126-138).

A copy of ``kubeinfer_tpu/manager/__main__.py`` for the PyTorch port,
with the same flags plus ``--device`` (default ``cuda``: the tick solves
on the card, and the manager exits with an error without one; ``cpu``
is for tests).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from kubeinfer_tpu_torch import distributed
from kubeinfer_tpu_torch.manager import Manager, ManagerConfig, load_token


def _split_hostport(s: str, default_host: str = "127.0.0.1") -> tuple[str, int]:
    if ":" not in s:
        return default_host, int(s)
    host, _, port = s.rpartition(":")
    return (host or default_host), int(port)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubeinfer-manager",
        description="kubeinfer_tpu control-plane manager",
    )
    p.add_argument("--store-bind-address", default="127.0.0.1:18080",
                   help="host:port the control-plane store listens on")
    p.add_argument("--store-connect", default="",
                   help="join an external store URL instead of hosting one "
                        "(HA standby topology; enables --leader-elect)")
    p.add_argument("--data-dir", default="",
                   help="directory for durable control-plane state "
                        "(journal + snapshots); empty = in-memory only. "
                        "The etcd role: services, workloads, nodes and "
                        "leases survive a manager restart. With "
                        "--store-connect this makes the manager a "
                        "REPLICA standby: it streams the primary's "
                        "journal here and promotes with full state when "
                        "the primary dies")
    p.add_argument("--replica-failover-s", type=float, default=5.0,
                   help="replica standby: seconds the primary must stay "
                        "unreachable before attempting promotion")
    p.add_argument("--lease-timings", default="",
                   help="manager election lease override as "
                        "'duration,renew,retry' seconds (tests/demos; "
                        "default: reference timings 15/10/2)")
    p.add_argument("--metrics-bind-address", default="127.0.0.1:18081",
                   help="host:port for the /metrics endpoint")
    p.add_argument("--health-probe-bind-address", default="127.0.0.1:18082",
                   help="host:port for /healthz and /readyz")
    p.add_argument("--auth-token-file", default="",
                   help="file holding the bearer token guarding store+metrics")
    p.add_argument("--tick-interval", type=float, default=1.0,
                   help="reconcile fallback tick period, seconds")
    p.add_argument("--node-ttl", type=float, default=30.0,
                   help="node heartbeat TTL before a node is unschedulable")
    p.add_argument("--leader-elect", action="store_true",
                   help="enable manager leader election (for HA managers "
                        "sharing one store)")
    p.add_argument("--identity", default="",
                   help="leader-election holder identity (default: "
                        "hostname-pid-nonce)")
    p.add_argument("--namespace", default="default")
    p.add_argument("--tls-cert-file", default="",
                   help="serve the store/metrics/health endpoints over "
                        "TLS with this certificate (PEM; key via "
                        "--tls-key-file) — the reference's secured-"
                        "endpoint posture (main.go:96-103,126-138)")
    p.add_argument("--tls-key-file", default="",
                   help="private key for --tls-cert-file (PEM)")
    p.add_argument("--store-ca-file", default="",
                   help="CA bundle verifying an https --store-connect")
    p.add_argument("--device", default="cuda",
                   help="where the tick's placement solves and POST /solve "
                        "run: cuda (the default; fails without a card) or "
                        "cpu (the plain PyTorch versions, for tests)")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    return p


def _parse_lease_timings(s: str) -> tuple[float, float, float] | None:
    if not s:
        return None
    parts = s.split(",")
    try:
        if len(parts) != 3:
            raise ValueError
        return tuple(float(x) for x in parts)
    except ValueError:
        raise SystemExit(
            "--lease-timings must be 'duration,renew,retry' seconds"
        ) from None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("manager")

    store_host, store_port = _split_hostport(args.store_bind_address)
    metrics_host, metrics_port = _split_hostport(args.metrics_bind_address)
    health_host, health_port = _split_hostport(args.health_probe_bind_address)
    token = load_token(args.auth_token_file) if args.auth_token_file else ""

    cfg = ManagerConfig(
        store_bind_host=store_host, store_bind_port=store_port,
        metrics_bind_host=metrics_host, metrics_bind_port=metrics_port,
        health_bind_host=health_host, health_bind_port=health_port,
        store_connect=args.store_connect,
        data_dir=args.data_dir,
        replica_failover_s=args.replica_failover_s,
        lease_timings=_parse_lease_timings(args.lease_timings),
        auth_token=token,
        tick_interval_s=args.tick_interval,
        node_ttl_s=args.node_ttl,
        leader_elect=args.leader_elect,
        identity=args.identity,
        namespace=args.namespace,
        tls_cert_file=args.tls_cert_file,
        tls_key_file=args.tls_key_file,
        store_ca_file=args.store_ca_file,
        device=args.device,
    )

    # Join the multi-process runtime when the fleet env is present (no-op
    # single-process; a partial env raises here, at start): before any
    # solve, so a sharded solve's mesh spans every process. See
    # kubeinfer_tpu_torch/distributed.py.
    distributed.initialize(device=args.device)

    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    try:
        mgr = Manager(cfg)
    except RuntimeError as e:  # the device is not there
        log.error("%s (--device %s)", e, args.device)
        return 1
    mgr.start()
    log.info("manager started (store %s)", mgr.store_address)
    try:
        mgr.run_forever(stop)
    finally:
        mgr.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
