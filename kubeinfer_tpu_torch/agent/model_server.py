"""Coordinator's HTTP model file server.

A copy of ``kubeinfer_tpu/agent/model_server.py`` in the port (its metrics,
tracing and resilience layers are the port's own copies).

Parity: reference internal/agent/coordinator/model_server.go:13-130 —
``GET /health`` → "OK"; ``GET /models`` → file listing; ``GET
/models/{relpath}`` → streamed file with a path-traversal guard.

Fixes over the reference (both SURVEY.md-documented gaps):

- Listing is **recursive** with relative paths (model_server.go:53-74 lists
  the top level only, and follower.go:135-137 would fail creating nested
  paths — real HF snapshots are nested).
- **Range requests** are honored (bytes=start-), enabling the resumable
  follower downloads the reference roadmap left as a TODO
  (PROJECT_ROADMAP.md:88-90).
- The listing carries **size + sha256** per file
  (``<relpath>\\t<size>\\t<sha256>`` lines), so followers detect
  same-size content drift — e.g. a file that changed across a
  coordinator failover — instead of trusting sizes alone
  (PROJECT_ROADMAP.md:88-90's integrity TODO). Checksums are cached by
  (size, mtime); files above ``INLINE_HASH_MAX`` are hashed by a
  background warmer rather than inside the request handler (a multi-GB
  weights dir hashed inline would stall /models past the follower's
  socket timeout), and until warmed their sha field is empty — clients
  treat an empty sha as "no verification available yet".
"""

from __future__ import annotations

import hashlib
import http.server
import os
import pathlib
import threading
import urllib.parse

# (abs path, size, mtime_ns) -> sha256 hex; shared across handler threads.
# Plain dict: CPython dict ops are atomic enough for a cache (worst case
# two threads hash the same file once each).
_CHECKSUM_CACHE: dict[tuple[str, int, int], str] = {}

# Files up to this size are hashed inline in the listing handler (64 MiB
# ~ tens of ms); larger ones only by the background warmer.
INLINE_HASH_MAX = 64 << 20


def file_sha256(path: pathlib.Path) -> str:
    st = path.stat()
    key = (str(path), st.st_size, st.st_mtime_ns)
    cached = _CHECKSUM_CACHE.get(key)
    if cached is None:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        cached = h.hexdigest()
        _CHECKSUM_CACHE[key] = cached
    return cached


def cached_sha256(
    path: pathlib.Path,
    st: os.stat_result | None = None,
    inline_max: int = INLINE_HASH_MAX,
) -> str:
    """sha256 if cheap ("" otherwise): cached, or small enough to hash now.

    Pass ``st`` when the caller already statted the file (the listing
    does) to avoid a second syscall per file on a hot endpoint.
    """
    if st is None:
        try:
            st = path.stat()
        except OSError:
            return ""
    hit = _CHECKSUM_CACHE.get((str(path), st.st_size, st.st_mtime_ns))
    if hit is not None:
        return hit
    if st.st_size <= inline_max:
        return file_sha256(path)
    return ""


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kubeinfer-model-server"
    root: pathlib.Path  # set by server factory
    daemon_threads = True

    def log_message(self, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        if self.path == "/health":
            self._send_text("OK")
        elif self.path == "/models":
            self._list_models()
        elif self.path.startswith("/models/"):
            # clients percent-encode (transfer.py); decode before resolving
            self._send_file(urllib.parse.unquote(self.path[len("/models/"):]))
        else:
            self.send_error(404)

    def _send_text(self, body: str, status: int = 200) -> None:
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Content-Type", "text/plain")
        self.end_headers()
        self.wfile.write(data)

    def _list_models(self) -> None:
        """Newline-separated ``relpath\\tsize\\tsha256`` lines, recursive.

        The sha field is empty for large files the background warmer
        hasn't reached — hashing them here would stall the listing past
        client socket timeouts.
        """
        entries = []
        for p in sorted(self.root.rglob("*")):
            # dot-prefixed paths (ANY component: .kubeinfer-sync-complete,
            # .cache/huggingface/...) are local bookkeeping and must not
            # propagate through the plane
            if not p.is_file() or p.name.endswith(".part"):
                continue
            if any(
                part.startswith(".")
                for part in p.relative_to(self.root).parts
            ):
                continue
            rel = str(p.relative_to(self.root))
            st = p.stat()
            entries.append(
                f"{rel}\t{st.st_size}\t{cached_sha256(p, st)}"
            )
        self._send_text("\n".join(entries) + ("\n" if entries else ""))

    def _resolve(self, rel: str) -> pathlib.Path | None:
        """Path traversal guard (model_server.go:88-100)."""
        if not rel or rel.startswith("/"):
            return None
        target = (self.root / rel).resolve()
        root = self.root.resolve()
        if root != target and root not in target.parents:
            return None
        return target if target.is_file() else None

    def _send_file(self, rel: str) -> None:
        target = self._resolve(rel)
        if target is None:
            self.send_error(404)
            return
        size = target.stat().st_size
        start = 0
        range_header = self.headers.get("Range", "")
        if range_header.startswith("bytes="):
            spec = range_header[len("bytes="):]
            lo = spec.split("-", 1)[0]
            if lo.isdigit():
                start = min(int(lo), size)
        length = size - start
        if start > 0:
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{size - 1}/{size}")
        else:
            self.send_response(200)
        self.send_header("Content-Length", str(length))
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        with open(target, "rb") as f:  # streamed copy (model_server.go:124)
            f.seek(start)
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                try:
                    self.wfile.write(chunk)
                except (BrokenPipeError, ConnectionResetError):
                    return  # client vanished mid-transfer; nothing to clean


class ModelServer:
    """HTTP server on the model-server port (:8080 in the reference)."""

    def __init__(self, model_dir: str, host: str = "127.0.0.1", port: int = 0):
        self._root = pathlib.Path(model_dir)
        handler = type("BoundHandler", (_Handler,), {"root": self._root})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        t = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"model-server-{self.port}",
        )
        self._thread = t
        t.start()
        # Pre-hash big files off the request path so listings gain their
        # checksums shortly after startup without ever blocking a client.
        warmer = threading.Thread(
            target=self._warm_checksums, daemon=True,
            name=f"checksum-warmer-{self.port}",
        )
        warmer.start()

    def _warm_checksums(self) -> None:
        try:
            for p in sorted(self._root.rglob("*")):
                if (
                    p.is_file()
                    and not p.name.endswith(".part")
                    and not any(
                        part.startswith(".")
                        for part in p.relative_to(self._root).parts
                    )
                ):
                    file_sha256(p)
        except OSError:
            pass  # dir vanished mid-walk; next listing reflects reality

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def ensure_model_dir(path: str) -> bool:
    """Cache-present check: directory exists and is non-empty
    (coordinator.go:62-80 semantics, including its known naivety — a partial
    download looks 'cached'; the transfer layer writes .part files and
    renames on completion so partials are never counted)."""
    try:
        entries = [
            p for p in os.listdir(path)
            if not p.endswith(".part") and not p.startswith(".")
        ]
    except FileNotFoundError:
        return False
    return len(entries) > 0
