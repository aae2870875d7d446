"""Resumable model-file transfer client (the follower's download path).

A copy of ``kubeinfer_tpu/agent/transfer.py`` in the port (its metrics,
tracing and resilience layers are the port's own copies).

Reference behavior (internal/agent/follower/follower.go:83-149): GET
/models for the list, then GET /models/<file> → os.Create → io.Copy, flat
paths, no retry, no resume. Both the nesting and resume gaps are fixed here:

- files download to ``<name>.part`` and rename into place on completion, so
  a crashed transfer is never mistaken for a cached file;
- an existing .part resumes via a Range request from its current size;
- nested relative paths are created with ``mkdir -p`` semantics;
- per-file retry with bounded attempts (coordinator may be mid-failover);
- completed sizes are validated against the server's Content-Length /
  Content-Range total, so a stale partial resumed against a changed file is
  rejected instead of silently appended;
- the listing carries per-file size + sha256 (model_server.py), and every
  completed download — including already-present files — is verified
  against it, so same-size content drift (a file changed across a
  coordinator failover) is detected and re-fetched instead of served.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import pathlib
import time
import urllib.parse
from dataclasses import dataclass

from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.resilience import RetryPolicy, faultpoints
from kubeinfer_tpu_torch.utils.httpbase import inject_traceparent

_TRACER = tracing.get_tracer("transfer")

# Written into the model dir after a FULLY verified sync; its presence is
# the only thing that distinguishes "complete local copy" from "partial
# sync that happens to contain whole files" (each file lands atomically,
# so a killed multi-file sync leaves a non-empty dir with no .part
# files). Dotfiles are excluded from listings/cache checks, so the
# marker never propagates through the distribution plane.
SYNC_MARKER = ".kubeinfer-sync-complete"


class TransferError(RuntimeError):
    pass


def sync_complete(dest_dir: str) -> bool:
    """True iff a previous sync_model finished verifying every file."""
    return (pathlib.Path(dest_dir) / SYNC_MARKER).exists()


@dataclass(frozen=True)
class FileEntry:
    """One line of the coordinator's /models listing."""

    path: str
    size: int = -1  # -1 = listing carried no metadata
    sha256: str = ""

    @classmethod
    def parse(cls, line: str) -> "FileEntry":
        parts = line.split("\t")
        if len(parts) >= 3:
            try:
                return cls(parts[0], int(parts[1]), parts[2])
            except ValueError:
                # malformed metadata (e.g. a tab inside a filename):
                # degrade to an unverified bare path rather than crashing
                # the sync with a non-TransferError
                return cls(line)
        return cls(parts[0])  # tolerate bare-path listings


def _local_sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _open(
    endpoint: str, ca_file: str = ""
) -> tuple[http.client.HTTPConnection, str]:
    u = urllib.parse.urlparse(endpoint)
    if u.scheme == "http":
        return (
            http.client.HTTPConnection(u.hostname, u.port, timeout=10),
            u.path.rstrip("/"),
        )
    if u.scheme == "https":
        from kubeinfer_tpu_torch.utils.httpbase import client_ssl_context

        ctx = client_ssl_context(ca_file)
        if ctx is None:
            import ssl

            ctx = ssl.create_default_context()
        return (
            http.client.HTTPSConnection(
                u.hostname, u.port, timeout=10, context=ctx
            ),
            u.path.rstrip("/"),
        )
    raise TransferError(f"unsupported scheme {u.scheme!r}")


def fetch_file_list(endpoint: str, ca_file: str = "") -> list[FileEntry]:
    """GET /models → FileEntry list (follower.go:83-110 parity + metadata)."""
    faultpoints.fire("transfer.fetch", key="/models")
    conn, base = _open(endpoint, ca_file)
    try:
        conn.request(
            "GET", base + "/models", headers=inject_traceparent({})
        )
        resp = conn.getresponse()
        if resp.status != 200:
            raise TransferError(f"/models returned {resp.status}")
        body = resp.read().decode()
    finally:
        conn.close()
    return [FileEntry.parse(line) for line in body.splitlines() if line.strip()]


def download_file(
    endpoint: str,
    rel_path: str,
    dest_dir: str,
    chunk_size: int = 1 << 20,
    ca_file: str = "",
) -> int:
    """Download one file with resume; returns bytes transferred this call."""
    dest = pathlib.Path(dest_dir) / rel_path
    dest.parent.mkdir(parents=True, exist_ok=True)
    part = dest.with_name(dest.name + ".part")

    offset = part.stat().st_size if part.exists() else 0
    faultpoints.fire("transfer.fetch", key=rel_path)
    conn, base = _open(endpoint, ca_file)
    transferred = 0
    expected_total = -1
    try:
        headers = {"Range": f"bytes={offset}-"} if offset else {}
        inject_traceparent(headers)
        conn.request("GET", base + "/models/" + urllib.parse.quote(rel_path), headers=headers)
        resp = conn.getresponse()
        if resp.status == 200:
            offset = 0  # server ignored the range; restart
            cl = resp.getheader("Content-Length")
            if cl is not None:
                expected_total = int(cl)
        elif resp.status == 206:
            # "bytes <start>-<end>/<total>": the total is the CURRENT
            # server's file size — a stale .part resumed against a changed
            # file (post-failover, or a re-released model) is detected below
            # instead of silently appending corrupt bytes.
            cr = resp.getheader("Content-Range", "")
            if "/" in cr:
                expected_total = int(cr.rsplit("/", 1)[1])
            if expected_total >= 0 and offset > expected_total:
                part.unlink(missing_ok=True)
                raise TransferError(
                    f"{rel_path}: stale partial ({offset}B) exceeds current "
                    f"file size ({expected_total}B); restarting"
                )
        else:
            raise TransferError(f"/models/{rel_path} returned {resp.status}")
        mode = "ab" if offset else "wb"
        with open(part, mode) as f:
            if offset:
                f.seek(offset)
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
                transferred += len(chunk)
    finally:
        conn.close()
    final_size = part.stat().st_size
    if expected_total >= 0 and final_size != expected_total:
        # short read (connection died) or size drift: keep the .part for
        # resume only when it is a prefix-consistent short read
        if final_size > expected_total:
            part.unlink(missing_ok=True)
        raise TransferError(
            f"{rel_path}: got {final_size}B, expected {expected_total}B"
        )
    os.replace(part, dest)  # atomic completion marker
    return transferred


# What one sync attempt may die of and the next attempt can heal:
# transfer protocol errors (bad status, size/checksum mismatch — possibly
# a mid-failover coordinator), connection-level OSErrors, and HTTP
# protocol breakage (short reads, torn chunked bodies).
_SYNC_TRANSIENT = (TransferError, OSError, http.client.HTTPException)


def sync_model(
    endpoint,
    dest_dir: str,
    attempts: int = 5,
    retry_delay_s: float = 0.5,
    sleep=time.sleep,
    ca_file: str = "",
) -> list[str]:
    """Full follower sync: list + download all, with per-attempt retry.

    ``endpoint`` is a URL or a zero-arg callable returning one — the
    callable form re-resolves the coordinator each attempt, so a
    mid-transfer coordinator death (connection error / short read) resumes
    against the NEW coordinator after failover, continuing from the .part
    file's size.

    Retry scheduling rides the shared ``RetryPolicy`` (resilience/) —
    formerly a bespoke fixed-delay loop here. ``retry_delay_s`` is now
    the backoff BASE (full jitter, exponential growth capped at 8×), so
    a fleet of followers re-syncing after a coordinator death no longer
    hammers the successor in lockstep. Attempt counting is unchanged:
    ``attempts`` total tries, ``sleep`` injectable for tests.
    """
    resolve = endpoint if callable(endpoint) else (lambda: endpoint)
    last_ep: list[str] = [""]

    def attempt_once() -> list[str]:
        ep = resolve()
        last_ep[0] = ep
        if not ep:
            raise TransferError("no coordinator endpoint available")
        entries = fetch_file_list(ep, ca_file=ca_file)
        # Invalidate the completion marker BEFORE any mutation: a
        # re-sync that dies halfway (file deleted on checksum
        # mismatch, download failed) must not leave a stale marker
        # vouching for a mixed-version dir.
        (pathlib.Path(dest_dir) / SYNC_MARKER).unlink(missing_ok=True)
        for entry in entries:
            dest = pathlib.Path(dest_dir) / entry.path
            if dest.exists():
                # rename is the completion marker, but the CONTENT may
                # still be stale (coordinator changed across failover,
                # possibly at the same size): trust only a checksum
                # match when the listing carries one.
                if not entry.sha256 or _local_sha256(dest) == entry.sha256:
                    continue
                dest.unlink()
            download_file(ep, entry.path, dest_dir, ca_file=ca_file)
            if entry.sha256:
                got = _local_sha256(dest)
                if got != entry.sha256:
                    dest.unlink(missing_ok=True)
                    raise TransferError(
                        f"{entry.path}: checksum mismatch after download "
                        f"(got {got[:12]}…, want {entry.sha256[:12]}…)"
                    )
        marker = pathlib.Path(dest_dir) / SYNC_MARKER
        marker.write_text(json.dumps({
            "files": [
                {"path": e.path, "size": e.size, "sha256": e.sha256}
                for e in entries
            ],
        }))
        return [e.path for e in entries]

    policy = RetryPolicy(
        max_attempts=max(1, attempts),
        base_delay_s=retry_delay_s,
        max_delay_s=retry_delay_s * 8,
        deadline_s=0,  # a model sync is minutes-long by nature; the
        # attempt budget, not wall time, bounds it
        classify=lambda e: isinstance(e, _SYNC_TRANSIENT),
    )
    # the span wraps the whole retry schedule, so per-attempt retry
    # events and fault-point activations land on it
    with _TRACER.span("transfer.sync", dest=dest_dir):
        try:
            return policy.call(
                attempt_once, edge="transfer.sync", sleep=sleep
            )
        except _SYNC_TRANSIENT as e:
            raise TransferError(
                f"sync from {last_ep[0] or endpoint} failed after "
                f"{attempts} attempts: {e}"
            ) from e
