"""Disaggregated prefill/decode: KV-block streaming over the transfer
plane.

The reference's distribution plane moves model files once at startup
(coordinator downloads, followers pull over the cluster network —
model_server.go:26-130, follower.go:47-150). This package generalizes
the same plane shape — HTTP pull, sha256 content verification, retry +
breaker resilience — to per-request KV: dedicated prefill replicas run
chunked prefill, a decode replica pulls the finished blocks and admits
the request warm exactly like a radix hit. Why it diverges from the
reference: model files are immutable and fetched once, KV blocks are
produced continuously and addressed by prefix fingerprint, so the
export side is a bounded LRU of recent prefills rather than a static
file listing.

Layout audit: everything on the wire is LOGICAL — per-layer pages
indexed by position in the prefix, fingerprints over token ids. The
wire format never learns about tensor parallelism; a sharded importer
scatters the same logical pages into its own shards.

A copy of ``kubeinfer_tpu/disagg`` for the PyTorch port: the same wire
bytes, so a replica of either package imports the other's exports.
"""

from kubeinfer_tpu_torch.disagg.client import (
    KVFetchError,
    fetch_kv_blocks,
    import_remote_prefix,
)
from kubeinfer_tpu_torch.disagg.export import KVExportCache
from kubeinfer_tpu_torch.disagg.wire import (
    KVBlockPayload,
    WireError,
    decode_payload,
    encode_payload,
)

__all__ = [
    "KVBlockPayload",
    "KVExportCache",
    "KVFetchError",
    "WireError",
    "decode_payload",
    "encode_payload",
    "fetch_kv_blocks",
    "import_remote_prefix",
]
