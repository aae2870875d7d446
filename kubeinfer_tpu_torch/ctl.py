"""``python -m kubeinfer_tpu_torch.ctl`` — kubectl-style CLI for the control plane.

A copy of ``kubeinfer_tpu/ctl.py`` over the port's ``RemoteStore``; it
imports ``yaml``, as the reference does (a host-side CLI, off the
card's path).

The reference's operator surface is ``kubectl apply -f config/samples/...``
against the CRD (docs/QUICKSTART.md). This CLI gives kubeinfer_tpu the same
surface against its own store: apply/get/delete/describe on YAML manifests
(multi-document files supported, like kubectl).

    python -m kubeinfer_tpu_torch.ctl --store http://127.0.0.1:18080 \
        apply -f deploy/samples/llmservice_cache.yaml
    python -m kubeinfer_tpu_torch.ctl get llmservices
    python -m kubeinfer_tpu_torch.ctl get nodes
    python -m kubeinfer_tpu_torch.ctl delete llmservice llm-cache-demo
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import yaml

from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore, load_token
from kubeinfer_tpu_torch.controlplane.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
)

# kubectl-style aliases → store kinds
KIND_ALIASES = {
    "llmservice": "LLMService", "llmservices": "LLMService",
    "llmsvc": "LLMService",
    "workload": "Workload", "workloads": "Workload",
    "node": "Node", "nodes": "Node",
    "lease": "Lease", "leases": "Lease",
}


def resolve_kind(s: str) -> str:
    k = KIND_ALIASES.get(s.lower())
    if k is None:
        sys.exit(f"error: unknown resource kind {s!r} "
                 f"(one of: {sorted(set(KIND_ALIASES))})")
    return k


def load_manifests(path: str) -> list[dict]:
    with open(path, "r", encoding="utf-8") as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    for d in docs:
        if "kind" not in d:
            sys.exit(f"error: document in {path} has no 'kind'")
    return docs


def _apply_one(store: RemoteStore, doc: dict) -> str:
    """kubectl-apply semantics: create, or replace spec keeping live
    status. The CAS update retries on conflict with a fresh read (the
    controller continuously writes status to the same objects)."""
    kind = doc["kind"]
    meta = doc.get("metadata", {})
    name = meta.get("name", "?")
    ns = meta.get("namespace", "default")
    for _ in range(5):
        try:
            current = store.get(kind, name, ns)
        except NotFoundError:
            try:
                store.create(kind, doc)
                return "created"
            except AlreadyExistsError:
                continue  # raced another creator; re-read and update
        current["spec"] = doc.get("spec", {})
        if "labels" in meta:
            current["metadata"]["labels"] = meta["labels"]
        try:
            store.update(kind, current)
            return "configured"
        except ConflictError:
            continue
    raise ConflictError(f"{kind}/{name}: apply kept conflicting")


def cmd_apply(store: RemoteStore, args) -> int:
    rc = 0
    for doc in load_manifests(args.filename):
        kind = doc["kind"]
        name = doc.get("metadata", {}).get("name", "?")
        try:
            verb = _apply_one(store, doc)
            print(f"{kind.lower()}/{name} {verb}")
        except Exception as e:
            print(f"error applying {kind}/{name}: {e}", file=sys.stderr)
            rc = 1
    return rc


def _fmt_llmservice(o: dict) -> list[str]:
    spec, status = o.get("spec", {}), o.get("status", {})
    return [
        o["metadata"]["name"], spec.get("model", ""),
        str(spec.get("replicas", "")),
        f"{status.get('availableReplicas', 0)}/{spec.get('replicas', 0)}",
        status.get("phase", ""), spec.get("schedulerPolicy", ""),
    ]


def _fmt_node(o: dict) -> list[str]:
    return [
        o["metadata"]["name"], str(o.get("gpuCapacity", "")),
        str(o.get("gpuFree", "")), "Ready" if o.get("ready") else "NotReady",
        ",".join(str(t) for t in o.get("topology", [])),
    ]


def _fmt_workload(o: dict) -> list[str]:
    reps = o.get("replicas", [])
    ready = sum(1 for r in reps if r.get("phase") == "Ready")
    bound = sum(1 for r in reps if r.get("node"))
    return [
        o["metadata"]["name"], o.get("modelRepo", ""),
        f"{ready}/{len(reps)}", f"{bound}/{len(reps)}",
    ]


TABLE_HEADERS = {
    "LLMService": ["NAME", "MODEL", "REPLICAS", "READY", "PHASE", "POLICY"],
    "Node": ["NAME", "CHIPS", "FREE", "STATUS", "TOPOLOGY"],
    "Workload": ["NAME", "MODEL", "READY", "BOUND"],
}
TABLE_ROWS = {
    "LLMService": _fmt_llmservice, "Node": _fmt_node, "Workload": _fmt_workload,
}


def _print_table(headers: list[str], rows: list[list[str]]) -> None:
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    for line in [headers] + rows:
        print("  ".join(c.ljust(w) for c, w in zip(line, widths)).rstrip())


def cmd_get(store: RemoteStore, args) -> int:
    kind = resolve_kind(args.kind)
    if args.name:
        try:
            obj = store.get(kind, args.name, args.namespace)
        except NotFoundError:
            print(f"Error: {kind} {args.name!r} not found", file=sys.stderr)
            return 1
        objs = [obj]
    else:
        objs = store.list(kind, args.namespace if args.namespace != "" else None)
    if args.output == "json":
        print(json.dumps(objs if not args.name else objs[0], indent=2))
    elif args.output == "yaml":
        yaml.safe_dump(objs if not args.name else objs[0], sys.stdout,
                       sort_keys=False)
    else:
        fmt = TABLE_ROWS.get(kind)
        if fmt is None:
            print(json.dumps(objs, indent=2))
        else:
            _print_table(TABLE_HEADERS[kind], [fmt(o) for o in objs])
    return 0


def cmd_delete(store: RemoteStore, args) -> int:
    kind = resolve_kind(args.kind)
    try:
        store.delete(kind, args.name, args.namespace)
    except NotFoundError:
        print(f"Error: {kind} {args.name!r} not found", file=sys.stderr)
        return 1
    print(f"{kind.lower()}/{args.name} deleted")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubeinfer-ctl")
    p.add_argument("--store", default=os.environ.get(
        "STORE_ADDR", "http://127.0.0.1:18080"))
    p.add_argument("--token-file", default=os.environ.get(
        "STORE_TOKEN_FILE", ""))
    p.add_argument("--ca-file", default=os.environ.get(
        "STORE_CA_FILE", ""),
        help="CA bundle verifying an https store")
    p.add_argument("-n", "--namespace", default="default")
    sub = p.add_subparsers(dest="command", required=True)

    ap = sub.add_parser("apply", help="apply a manifest file")
    ap.add_argument("-f", "--filename", required=True)
    ap.set_defaults(fn=cmd_apply)

    gp = sub.add_parser("get", help="list or get resources")
    gp.add_argument("kind")
    gp.add_argument("name", nargs="?", default="")
    gp.add_argument("-o", "--output", default="table",
                    choices=["table", "json", "yaml"])
    gp.set_defaults(fn=cmd_get)

    dp = sub.add_parser("delete", help="delete a resource")
    dp.add_argument("kind")
    dp.add_argument("name")
    dp.set_defaults(fn=cmd_delete)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    token = load_token(args.token_file) if args.token_file else ""
    store = RemoteStore(args.store, token=token, ca_file=args.ca_file)
    return args.fn(store, args)


if __name__ == "__main__":
    sys.exit(main())
