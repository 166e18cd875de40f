"""Paged KV-cache bookkeeping: geometry, host allocator, prefix planner.

Counterpart of ``repro/launch/paging.py`` (host-side numpy; the port
keeps its own copy).  The scheduler's paged mode (launch/scheduler.py)
keeps ONE global KV pool per layer -- ``(n_blocks, block_size, heads,
head_dim)`` -- and per-slot block tables instead of per-slot contiguous
``max_seq`` regions.  This module holds everything about paging that
does not run per step on the device:

  PagedLayout          static geometry (block size, table width, pool size)
                       shared by the scheduler, lm.init_paged_cache and the
                       resident-bytes accounting.

  BlockAllocator       host-side reference allocator: alloc / free /
                       refcounts / copy-on-write over the same invariants
                       the scheduler's device-side refcount vector
                       maintains (no double free, no leak, no aliasing of
                       live blocks).  The scheduler's admission/harvest
                       arithmetic is a restriction of this model (alloc at
                       admit, free at harvest, ref-pinned prefix sharing --
                       CoW degenerates to "recompute the partial tail
                       block", see plan_prefix_sharing).

  plan_prefix_sharing  the host side of prefix caching.  The workload is
                       staged up front and admitted in queue order, so the
                       hash -> block-chain map can be resolved BEFORE the
                       loop runs: each request gets (share_src,
                       n_shared_blocks) -- copy that many table entries
                       from the earlier request -- and every materializing
                       request gets per-block pin counts so a donor's
                       blocks survive the donor's own harvest until the
                       last sharer frees them.  The refcount algebra
                       closes: every block's refcount returns to zero when
                       the queue drains.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static paged-cache geometry.

    ``n_tbl`` is the per-slot block-table width: every slot can address at
    most ``n_tbl`` blocks, sized for the worst case prompt + decode budget
    + speculative headroom.  ``n_blocks`` is the global pool size; block 0
    is reserved as the TRASH block (harvested slots' tables point at it,
    so a dead slot's frozen-position decode writes land somewhere no live
    slot ever reads -- the paged analogue of dead rows writing into their
    own private region).
    """
    block_size: int
    n_tbl: int                    # per-slot table width (blocks)
    n_blocks: int                 # global pool size, incl. the trash block

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size {self.block_size} < 1")
        if self.n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is trash)")

    @property
    def tokens_per_slot(self) -> int:
        return self.n_tbl * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        return cdiv(n_tokens, self.block_size)

    def kv_bytes(self, cfg, n_blocks: Optional[int] = None,
                 dtype_bytes: int = 2) -> int:
        """Resident KV bytes for ``n_blocks`` pool blocks (default: the
        whole pool) under ``cfg``'s layer/head geometry -- the number the
        serve benchmark reports per row."""
        nb = self.n_blocks if n_blocks is None else n_blocks
        per_row = cfg.padded_kv_heads * cfg.head_dim * dtype_bytes
        n_kv_layers = 0
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            n_kv_layers += 2 * cfg.n_layers                  # k + v
        if cfg.family == "hybrid" and cfg.shared_attn_period:
            n_kv_layers += 2 * (cfg.n_layers // cfg.shared_attn_period)
        return nb * self.block_size * per_row * n_kv_layers


def contiguous_kv_bytes(cfg, slots: int, max_seq: int,
                        dtype_bytes: int = 2) -> int:
    """KV bytes of the contiguous per-slot layout (the baseline)."""
    layout = PagedLayout(block_size=max_seq, n_tbl=1, n_blocks=2)
    return layout.kv_bytes(cfg, n_blocks=slots, dtype_bytes=dtype_bytes)


# ---------------------------------------------------------------------------
# host-side reference allocator (property-tested invariants)
# ---------------------------------------------------------------------------


class BlockAllocator:
    """Refcounted free-list block allocator with copy-on-write.

    This is the HOST model of the device-side allocator: a free list over
    ``n_blocks`` blocks (block 0 reserved), integer refcounts, and the
    three operations the serving loop composes:

      alloc(n)            -> n fresh blocks, each at refcount 1
      share(blocks)       -> refcount += 1 on an existing chain (a prefix
                             hit: the new sequence references the donor's
                             blocks instead of recomputing them)
      free(blocks)        -> refcount -= 1; blocks return to the free
                             list at zero

    plus ``write(owner_blocks, i)`` modelling a write into block i of a
    chain: if the block is shared (refcount > 1) it is COPIED first
    (copy-on-write) so the writer gets a private block and the other
    referents keep the original.  The device loop never needs the copy --
    admission only shares FULL immutable prompt blocks and recomputes the
    partial tail (see plan_prefix_sharing) -- but the allocator supports
    it so the property tests cover the general contract the design
    depends on.

    Invariants (checked by ``check()`` and property-tested):
      * refcounts are never negative; free() on a free block raises
        (double free)
      * a block is on the free list iff its refcount is zero (no leak:
        freeing the last reference always returns the block)
      * alloc never returns a block with a live reference (no aliasing)
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.n_blocks = n_blocks
        self.ref = np.zeros(n_blocks, np.int64)
        self.ref[0] = 1                       # trash block: never allocated
        self._free = list(range(n_blocks - 1, 0, -1))   # pop() -> lowest id

    # -- core ops --------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"alloc({n}): only {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self.ref[b] == 0, f"free-list block {b} had refs"
            self.ref[b] = 1
        return out

    def share(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not (0 < b < self.n_blocks):
                raise ValueError(f"share: bad block id {b}")
            if self.ref[b] == 0:
                raise ValueError(f"share: block {b} is free (stale chain)")
            self.ref[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not (0 < b < self.n_blocks):
                raise ValueError(f"free: bad block id {b}")
            if self.ref[b] == 0:
                raise ValueError(f"double free of block {b}")
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(b)

    def write(self, chain: List[int], i: int) -> int:
        """Write into ``chain[i]``; copy-on-write if the block is shared.
        Returns the (possibly new) block id and updates ``chain`` in
        place."""
        b = chain[i]
        if self.ref[b] <= 1:
            return b                           # exclusive: write in place
        (nb,) = self.alloc(1)                  # copy: writer goes private
        self.ref[b] -= 1                       # drop the shared reference
        if self.ref[b] == 0:                   # (cannot happen: ref was >1)
            self._free.append(b)
        chain[i] = nb
        return nb

    # -- invariant check -------------------------------------------------

    def check(self) -> None:
        assert self.ref[0] >= 1, "trash block lost its pin"
        assert (self.ref >= 0).all(), "negative refcount"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate free-list entry"
        for b in range(1, self.n_blocks):
            on_free = b in free_set
            assert on_free == (self.ref[b] == 0), (
                f"block {b}: ref={self.ref[b]} on_free={on_free}")


# ---------------------------------------------------------------------------
# host-side prefix-sharing planner
# ---------------------------------------------------------------------------


def _block_hash(prev: bytes, tokens: np.ndarray) -> bytes:
    """Chain hash of one FULL block given the hash of the chain before it.

    Chaining makes the hash identify the whole prefix, not just the
    block's own tokens -- two requests share block j only if their first
    (j+1) blocks are identical, which is exactly the condition for the
    cached KV rows to be bit-identical (attention-family KV at position p
    depends on every token <= p).
    """
    h = hashlib.sha1()
    h.update(prev)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class PrefixPlan:
    """Per-request sharing decisions for one staged workload.

    share_src[i]        queue index of the request whose recorded block
                        table request i copies its shared chain from
                        (-1: no sharing).  Always < i, so the donor is
                        admitted -- and prefilled -- first; the device
                        loop additionally gates i's admission on the
                        donor's prefill being COMPLETE.
    n_shared_blocks[i]  how many leading table entries to copy.  Capped
                        at (prompt_len_i - 1) // block_size: only FULL
                        blocks are shared, and at least one prompt token
                        is always recomputed so admission produces the
                        request's first-token logits.  The partial tail
                        block is RECOMPUTED rather than copied -- the
                        degenerate (and bit-exact) form of copy-on-write:
                        the divergent block never aliases the donor's.
    pin_counts[i, j]    extra refcount to place on request i's j-th table
                        entry when i materializes it (the number of LATER
                        requests whose shared chain includes that block,
                        directly or transitively).  Pinning at
                        materialization time -- not at each sharer's admit
                        -- is what lets a donor be harvested before its
                        sharers finish without freeing the shared blocks.
    """
    share_src: np.ndarray          # (N,) int32
    n_shared_blocks: np.ndarray    # (N,) int32
    pin_counts: np.ndarray         # (N, n_tbl) int32

    @property
    def n_shared_tokens(self) -> int:
        return int(np.sum(self.n_shared_blocks))

    def stats(self) -> dict:
        """Plan-level sharing summary for telemetry / bench rows."""
        shared = self.share_src >= 0
        return dict(n_requests=int(self.share_src.shape[0]),
                    shared_requests=int(np.sum(shared)),
                    shared_blocks=int(np.sum(self.n_shared_blocks)),
                    pinned_blocks=int(np.sum(self.pin_counts > 0)),
                    max_chain_depth=int(self.n_shared_blocks.max(initial=0)))


def plan_prefix_sharing(prompts: Sequence[np.ndarray], block_size: int,
                        n_tbl: int, enable: bool = True) -> PrefixPlan:
    """Resolve block-granular prefix sharing for a staged request queue.

    One pass in admission order: hash each request's full prompt blocks
    as a chain, look up the longest previously-seen chain prefix, and
    record (donor, depth).  A second pass converts "how many chains pass
    through this block" into pin counts for whichever request materializes
    the block first.
    """
    n = len(prompts)
    share_src = np.full(n, -1, np.int32)
    n_shared = np.zeros(n, np.int32)
    pins = np.zeros((n, n_tbl), np.int32)
    if not enable:
        return PrefixPlan(share_src, n_shared, pins)

    first_holder: Dict[bytes, Tuple[int, int]] = {}  # hash -> (req, depth)
    refs: Dict[bytes, int] = {}                      # hash -> chains through
    chains: List[List[bytes]] = []
    for i, toks in enumerate(prompts):
        toks = np.asarray(toks)
        nb_cap = min((len(toks) - 1) // block_size, n_tbl)
        chain, h = [], b""
        for j in range(nb_cap):
            h = _block_hash(h, toks[j * block_size:(j + 1) * block_size])
            chain.append(h)
        chains.append(chain)
        depth = 0
        for j, hj in enumerate(chain):
            if hj in first_holder:
                depth = j + 1
            else:
                break
        if depth:
            src, _ = first_holder[chain[depth - 1]]
            share_src[i] = src
            n_shared[i] = depth
        for j, hj in enumerate(chain):
            refs[hj] = refs.get(hj, 0) + 1
            if hj not in first_holder:
                first_holder[hj] = (i, j)
    for h, (i, j) in first_holder.items():
        pins[i, j] = refs[h] - 1      # later sharers; own ref comes from alloc
    return PrefixPlan(share_src, n_shared, pins)
