"""Import-side client: pull an exported prefix and land it in a local
engine.

The fetch is an idempotent GET (same blob every time — content
addressed), so the retry policy classifies like transfer.py's model
pulls: transport failures and retryable HTTP codes replay, a 404 (the
export LRU already dropped the entry) fails fast into the caller's
local-prefill fallback. Verification is layered: wire.decode_payload
proves the bytes are what the exporter sent (sha256), then the
fingerprint chain is checked against ``prefix_fingerprints`` over OUR
tokens — that proves the exporter computed these pages for exactly
this prompt prefix, guarding against stale exports, fingerprint
collisions in the export LRU, and block-size drift across the fleet.

Nothing here holds engine locks: the fetch happens on the serving
HTTP thread, and ``ContinuousEngine.import_prefix`` stages the scatter
for the scheduler thread (the only writer of the engine's device
state).

A copy of ``kubeinfer_tpu/disagg/client.py`` for the PyTorch port, on
the port's own ``resilience`` and ``kv_blocks``.
"""

from __future__ import annotations

import random
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

from kubeinfer_tpu_torch.disagg.wire import KVBlockPayload, decode_payload
from kubeinfer_tpu_torch.inference.kv_blocks import prefix_fingerprints
from kubeinfer_tpu_torch.resilience import RetryPolicy, transient_http

# Two attempts: the export is hot right now (the router just created
# it); if the prefill replica cannot answer within one retry the right
# move is the local-prefill fallback, not a backoff schedule that eats
# the TTFT budget the disaggregation exists to protect.
_FETCH_POLICY = RetryPolicy(
    max_attempts=2, base_delay_s=0.05, max_delay_s=0.2,
    deadline_s=10.0, classify=transient_http,
)

# Chunked (migration) transfers: one blocking read on a stalled socket
# must never hold the HTTP thread for the policy's whole deadline — the
# per-ATTEMPT cap is what lets a stall surface as a retry (same blob,
# idempotent GET) and then as the 'timeout' fallback, while the overall
# budget still lives with RetryPolicy.deadline_s.
DEFAULT_ATTEMPT_TIMEOUT_S = 2.0


def _is_timeout(exc: BaseException) -> bool:
    """Did this fetch die waiting on the socket (vs. an answered
    error)? socket.timeout is TimeoutError since 3.10, but urllib may
    deliver it wrapped in URLError depending on which phase stalled."""
    if isinstance(exc, (TimeoutError, socket.timeout)):
        return True
    if isinstance(exc, urllib.error.URLError):
        return isinstance(exc.reason, (TimeoutError, socket.timeout))
    return False


class KVFetchError(RuntimeError):
    """KV pull failed after retries (transport or HTTP error).
    ``timed_out`` distinguishes a stalled socket from an answered
    failure so callers can count the right fallback reason."""

    def __init__(self, msg: str, timed_out: bool = False) -> None:
        super().__init__(msg)
        self.timed_out = timed_out


def fetch_kv_blocks(
    base_url: str,
    fingerprint: int,
    timeout_s: float = 10.0,
    rng: random.Random | None = None,
) -> KVBlockPayload:
    """GET ``/kv/blocks?fp=<fingerprint>`` from a prefill replica and
    decode. Raises KVFetchError (transport/HTTP) or WireError
    (corruption) — callers treat both as 'fall back to local
    prefill'. ``timeout_s`` is the PER-ATTEMPT socket timeout (connect
    and each blocking read), so a stalled peer costs one attempt, not
    the caller's whole serving thread."""
    url = (
        base_url.rstrip("/") + "/kv/blocks?"
        + urllib.parse.urlencode({"fp": int(fingerprint)})
    )

    def attempt() -> bytes:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read()

    try:
        blob = _FETCH_POLICY.call(attempt, edge="disagg.fetch", rng=rng)
    except Exception as e:  # noqa: BLE001 — any failure means fallback
        raise KVFetchError(
            f"kv fetch from {base_url} failed: {type(e).__name__}: {e}",
            timed_out=_is_timeout(e),
        ) from e
    return decode_payload(blob)


def import_remote_prefix(
    engine,
    tokens: list[int],
    base_url: str,
    timeout_s: float = 10.0,
    rng: random.Random | None = None,
) -> tuple[int, str | None, int]:
    """Fetch this prompt's exported prefix and import it into
    ``engine``'s pool + radix cache. Returns ``(blocks_imported,
    fallback_reason, wire_bytes)`` — reason is None on success, else a
    low-cardinality label for the fallback counter. Never raises: every
    failure mode degrades to local prefill, which is token-identical by
    the determinism contract."""
    bs = int(engine.block_size)
    fps = prefix_fingerprints(tokens, bs)
    if not fps:
        return 0, "no_full_block", 0
    try:
        payload = fetch_kv_blocks(
            base_url, fps[-1], timeout_s=timeout_s, rng=rng,
        )
    except KVFetchError as e:
        return 0, ("timeout" if e.timed_out else "fetch_error"), 0
    except Exception:  # noqa: BLE001 — WireError & friends
        return 0, "wire_error", 0
    # Content-address check: the FULL chain must match, not just the
    # deepest value we asked for — a same-depth collision in the export
    # LRU would otherwise scatter someone else's KV under our tokens.
    if payload.block_size != bs or list(payload.fingerprints) != fps:
        return 0, "fingerprint_mismatch", payload.byte_size
    # Dtype agreement is policy, not corruption: a v1 (bf16) blob from
    # a pre-quantization prefill replica is perfectly valid bytes that
    # an int8 pool cannot scatter — and vice versa. Declining here (not
    # in wire.py) keeps mixed fleets observable via the fallback
    # counter instead of masquerading as wire errors during rollout.
    if payload.kv_dtype != getattr(engine, "kv_dtype", "bf16"):
        return 0, "kv_dtype_mismatch", payload.byte_size
    imported, reason = engine.import_prefix(
        tokens[: len(fps) * bs],
        payload.pages_k, payload.pages_v,
        timeout_s=timeout_s,
        scales_k=payload.scales_k, scales_v=payload.scales_v,
        kv_dtype=payload.kv_dtype,
    )
    return imported, reason, payload.byte_size


def import_remote_chain(
    engine,
    tokens: list[int],
    base_url: str,
    chunk_blocks: int = 4,
    timeout_s: float = 10.0,
    attempt_timeout_s: float = DEFAULT_ATTEMPT_TIMEOUT_S,
    deadline_s: float = 30.0,
    rng: random.Random | None = None,
) -> tuple[int, str | None, int]:
    """Chunked import of a migrated session's KV chain: fetch blocks
    ``[i*N, (i+1)*N)`` per GET, each chunk keyed by ITS OWN deepest
    fingerprint and verified against the chain slice recomputed from
    our tokens, then landed incrementally via
    ``engine.import_prefix(start_block=...)`` — so a chunk only ever
    stacks on the exact prefix it continues, and a failure at chunk i
    still leaves chunks [0, i) warm in the radix cache (the resume
    re-prefills only from the last VERIFIED chunk, not token 0).
    Retries inside ``fetch_kv_blocks`` refetch only the failed chunk;
    ``deadline_s`` bounds the whole chain so a migration can never
    outlive the router's own failover clock. Returns
    ``(blocks_imported, fallback_reason, wire_bytes)`` like
    ``import_remote_prefix``; a non-None reason with imported > 0
    means a PARTIAL import (still pure win — the target's re-prefill
    starts warm)."""
    bs = int(engine.block_size)
    fps = prefix_fingerprints(tokens, bs)
    if not fps:
        return 0, "no_full_block", 0
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    want_dtype = getattr(engine, "kv_dtype", "bf16")
    t0 = time.monotonic()
    imported = 0
    wire_bytes = 0
    for start in range(0, len(fps), chunk_blocks):
        end = min(start + chunk_blocks, len(fps))
        if time.monotonic() - t0 > deadline_s:
            return imported, "timeout", wire_bytes
        try:
            payload = fetch_kv_blocks(
                base_url, fps[end - 1],
                timeout_s=attempt_timeout_s, rng=rng,
            )
        except KVFetchError as e:
            return imported, (
                "timeout" if e.timed_out else "fetch_error"
            ), wire_bytes
        except Exception:  # noqa: BLE001 — WireError & friends
            return imported, "wire_error", wire_bytes
        wire_bytes += payload.byte_size
        # the slice check covers offset AND content: every fingerprint
        # rolls over the whole prefix from token 0, so a chunk served
        # for a different session (or the right session at the wrong
        # offset) cannot match our recomputed chain
        if (
            payload.block_size != bs
            or payload.start_block != start
            or list(payload.fingerprints) != fps[start:end]
        ):
            return imported, "fingerprint_mismatch", wire_bytes
        if payload.kv_dtype != want_dtype:
            return imported, "kv_dtype_mismatch", wire_bytes
        n, reason = engine.import_prefix(
            tokens[: end * bs],
            payload.pages_k, payload.pages_v,
            timeout_s=timeout_s,
            scales_k=payload.scales_k, scales_v=payload.scales_v,
            kv_dtype=payload.kv_dtype, start_block=start,
        )
        if reason is not None:
            return imported, reason, wire_bytes
        imported += n
    return imported, None, wire_bytes
