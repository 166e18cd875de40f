"""Plain PyTorch version of the paged-attention decode read.

Counterpart of ``repro/kernels/paged_attn/ref.py``: gather the block
table into a dense per-row view, then the plain decode attention math of
``models.layers.plain_attention`` -- float32 scores summed in the
reference's lane order, optional tanh softcap, -1e30 masking, softmax
in ``jax.nn.softmax``'s form (on the CPU with XLA's exp, tanh and
windowed sum), and P.V with p rounded to the values' dtype.  On the CPU
it is bit-identical to the reference's oracle; the CUDA kernel
(kernel.py) computes P.V in float32 and matches it to a tolerance.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import prng
from ...models import layers as L


def paged_gather_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather (n_blocks, bs, H, D) pool rows -> (B, n_tbl*bs, H, D).

    ``table`` is (B, n_tbl) int32 block ids; logical position p of row b
    lives at pool[table[b, p // bs], p % bs]."""
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.reshape(nb * bs, *pool.shape[2:])
    B, n_tbl = table.shape
    idx = (table.long()[:, :, None] * bs
           + torch.arange(bs, device=table.device)[None, None, :])
    return flat[idx.reshape(B, n_tbl * bs)]


def paged_attention_ref(
    q: torch.Tensor,              # (B, Hq, Dh)
    k_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh)
    v_pool: torch.Tensor,         # (n_blocks, bs, Hkv, Dh)
    table: torch.Tensor,          # (B, n_tbl) int32
    lengths: torch.Tensor,        # (B,) int32 valid kv rows (incl. current)
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    is_local: bool = False,
) -> torch.Tensor:
    """Decode attention over a paged KV cache -> (B, Hq, Dh) in v's dtype.
    Row b's query sits at position lengths[b]-1 and attends k_pos <
    lengths[b] (ANDed with the sliding window when ``is_local``)."""
    B, Hq, Dh = q.shape
    Hkv = k_pool.shape[2]
    G = Hq // Hkv
    k = paged_gather_kv(k_pool, table)          # (B, L, Hkv, Dh)
    v = paged_gather_kv(v_pool, table)
    n_pos = k.shape[1]
    qg = L._scale_q(q.reshape(B, 1, Hkv, G, Dh))
    s = L.softcap(L._lane_scores(qg, k.to(torch.float32),
                                 L.decode_order(G)), softcap)
    k_pos = torch.arange(n_pos, device=q.device)[None, :]
    q_pos = (lengths.long() - 1)[:, None]
    msk = k_pos <= q_pos
    if window is not None and is_local:
        msk = msk & (q_pos - k_pos < window)
    s = torch.where(msk[:, None, None, None, :], s, L._NEG)
    s = s - s.amax(dim=-1, keepdim=True)
    pf = lambda p: p.to(v.dtype).to(torch.float32)
    if q.is_cuda:
        e = torch.exp(s)
        p = e / e.sum(dim=-1, keepdim=True)      # jax.nn.softmax's form
        out = torch.einsum("bhgqk,bkhd->bqhgd", pf(p), v.to(torch.float32))
    else:
        # as the reference's compiled oracle: XLA's exp, its windowed sum
        # and its P.V order
        e = prng.exp(s)
        p = e / L._window_sum(e)[..., None]
        out = L.decode_pv(pf(p), v.to(torch.float32),
                          L.decode_order(G))
    return out.to(v.dtype).reshape(B, Hq, Dh)
