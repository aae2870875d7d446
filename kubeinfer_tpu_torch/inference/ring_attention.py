"""Ring attention: exact causal attention over a sequence split in blocks.

Counterpart of ``kubeinfer_tpu/inference/ring_attention.py``. Each
sequence-parallel rank holds a ``[B, T_loc, ...]`` block of Q, K and V;
the K/V blocks travel around the ring while every rank folds one block a
step into its f32 online-softmax state (running max ``m``, normalizer
``l``, accumulator ``o``, FlashAttention's outer-loop algebra):

    m' = max(m, rowmax(S));  a = exp(m - m');  b = exp(S - m')
    l' = a*l + rowsum(b);    o' = a*o + b @ V

After P steps every query block has seen every K/V block and ``o / l`` is
the exact softmax attention. Causality comes from GLOBAL positions (rank
r holds ``[r*T_loc, (r+1)*T_loc)``), so nothing ``[T, T]``-sized exists.

The reference runs this inside ``shard_map``: each device folds its own
block and ``lax.ppermute`` sends the K/V one rank to the right. One
process drives every rank here, so :func:`ring_attention` takes the
ranks' blocks as lists and runs the ring step by step: at step i rank r
folds the block that came from rank ``(r - i) mod P`` (the reference's
order, fully masked blocks included, so each rank's fold order is the
reference's), then each block is handed to the next rank's device
(``.to()``, the same tensor where the device repeats).

The fold is plain PyTorch on the card as on the CPU: the reference
computes it with ``jnp.einsum`` outside any Pallas kernel. Its scores
are f32 products of f32 copies of q and k (exact for bf16 inputs; TF32
stays off, PyTorch's default for matmul), divided by ``sqrt(D)`` held in
a tensor on the scores' device, as the reference divides (a CUDA division
by a Python scalar multiplies by the reciprocal).
"""

from __future__ import annotations

import torch


def _block_attention(q, k, v, mask, m, l, o):
    """Fold one K/V block into the state. ``q`` [B, Tq, n_kv, G, D], ``k``
    and ``v`` [B, Tk, n_kv, D], ``mask`` bool[Tq, Tk] (True attends),
    ``m``/``l`` f32[B, n_kv, G, Tq], ``o`` f32[B, Tq, n_kv, G, D].
    Returns the new (m, l, o)."""
    D = q.shape[-1]
    s = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())
    s = s / torch.sqrt(torch.full((), float(D), dtype=torch.float32,
                                  device=s.device))
    s = s.masked_fill(~mask, -1e30)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with nothing attendable yet keep l = o = 0: exp(-1e30 - m_new)
    # underflows to exactly 0
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = alpha * l + p.sum(dim=-1)
    o_new = o * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
        "bkgts,bskd->btkgd", p, v.float())
    return m_new, l_new, o_new


def ring_attention(q: list, k: list, v: list, causal: bool = True) -> list:
    """Exact attention of every rank's query block over the whole ring.

    ``q[r]`` [B, T_loc, n_heads, D] and ``k[r]``, ``v[r]`` [B, T_loc,
    n_kv, D] are rank r's blocks, each on rank r's device. Returns each
    rank's output block [B, T_loc, n_heads, D] in q's dtype, on its
    device. The reference's ``extra_vary`` declares the manual mesh axes
    of a ``shard_map`` carry for its type check; there are no such types
    here, and a tp rank rings its own head shard by passing its blocks.
    """
    P = len(q)
    B, T_loc, n_heads, D = q[0].shape
    n_kv = k[0].shape[2]
    G = n_heads // n_kv
    state = []
    for r in range(P):
        dev = q[r].device
        state.append((
            torch.full((B, n_kv, G, T_loc), float("-inf"),
                       dtype=torch.float32, device=dev),
            torch.zeros((B, n_kv, G, T_loc), dtype=torch.float32,
                        device=dev),
            torch.zeros((B, T_loc, n_kv, G, D), dtype=torch.float32,
                        device=dev),
        ))
    qg = [x.reshape(B, T_loc, n_kv, G, D) for x in q]
    kb, vb = list(k), list(v)
    for i in range(P):
        for r in range(P):
            dev = q[r].device
            # the block at rank r in step i came from rank (r - i) mod P
            src = (r - i) % P
            ar = torch.arange(T_loc, device=dev)
            if causal:
                mask = (r * T_loc + ar)[:, None] >= (src * T_loc + ar)[None, :]
            else:
                mask = torch.ones((T_loc, T_loc), dtype=torch.bool,
                                  device=dev)
            state[r] = _block_attention(qg[r], kb[r], vb[r], mask, *state[r])
        if i + 1 < P:
            # the hand-off: each block moves one rank to the right
            kb = [kb[(r - 1) % P].to(q[r].device) for r in range(P)]
            vb = [vb[(r - 1) % P].to(q[r].device) for r in range(P)]
    out = []
    for r in range(P):
        _, l, o = state[r]
        # a row with nothing attendable (never under the causal mask)
        # keeps l = 0: the clamp keeps such outputs finite
        l = torch.clamp(l, min=1e-30)
        o = o / l.permute(0, 3, 1, 2)[..., None]
        out.append(o.reshape(B, T_loc, n_heads, D).to(q[r].dtype))
    return out
