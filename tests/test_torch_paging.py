"""Port parity: the paged-KV bookkeeping (launch/paging.py) and the plain
version of the paged-attention decode read (kernels/paged_attn) against
the reference package.

The host-side paging objects are numpy in both packages and must agree
exactly: the same bytes, the same block ids and refcounts after every
allocator operation, the same prefix plan.  The port's plain
``paged_attention_ref`` must equal the reference's oracle bit for bit
(``==``): it reproduces the reference's score order and softmax form.
The reference's Pallas kernel (interpret mode) is matched to a tolerance
instead -- see ``test_plain_matches_pallas_interpret``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.paged_attn import ref as jref
from repro.kernels.paged_attn.kernel import paged_attention_pallas
from repro.launch import paging as jpg
from repro_torch.configs import get_config as tget
from repro_torch.kernels.paged_attn import kernel as PK
from repro_torch.kernels.paged_attn import ops as tops
from repro_torch.kernels.paged_attn import ref as tref
from repro_torch.launch import paging as tpg

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("bs,n_tbl,n_blocks,used", [(4, 5, 12, None),
                                                    (16, 6, 64, 23),
                                                    (8, 3, 2, 1)])
def test_layout_bytes_match_reference(smoke, bs, n_tbl, n_blocks, used):
    jc, tc = jget("minicpm-2b", smoke), tget("minicpm-2b", smoke)
    jl = jpg.PagedLayout(block_size=bs, n_tbl=n_tbl, n_blocks=n_blocks)
    tl = tpg.PagedLayout(block_size=bs, n_tbl=n_tbl, n_blocks=n_blocks)
    assert tl.kv_bytes(tc, used) == jl.kv_bytes(jc, used)
    assert tl.tokens_per_slot == jl.tokens_per_slot
    assert tl.blocks_for(37) == jl.blocks_for(37)
    assert (tpg.contiguous_kv_bytes(tc, 8, 96)
            == jpg.contiguous_kv_bytes(jc, 8, 96))
    if not smoke:      # 40 layers x K and V x 48 heads x 64 x 2 B per token
        assert tl.kv_bytes(tc, 1) == bs * 491_520


def _apply(alloc, op, arg):
    """One allocator operation -> its result, or the exception's type."""
    try:
        if op == "alloc":
            return alloc.alloc(arg)
        if op == "share":
            return alloc.share(arg)
        if op == "free":
            return alloc.free(arg)
        chain, i = arg
        return alloc.write(chain, i), list(chain)
    except (MemoryError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_op_sequences_match_reference(seed):
    """Seeded sequences of alloc / share / free / copy-on-write, with bad
    calls mixed in (double frees, over-allocation): the same results and
    the same refcounts and free counts after every operation."""
    rng = np.random.default_rng(seed)
    ja, ta = jpg.BlockAllocator(16), tpg.BlockAllocator(16)
    chains = []
    for _ in range(120):
        kind = rng.integers(0, 5)
        if kind == 0 or not chains:
            op, arg = "alloc", int(rng.integers(1, 6))
        elif kind == 1:
            op, arg = "share", list(chains[rng.integers(len(chains))])
        elif kind == 2:
            op, arg = "free", chains.pop(rng.integers(len(chains)))
        elif kind == 3:
            op, arg = "free", [int(rng.integers(1, 16))]
        else:
            c = chains[rng.integers(len(chains))]
            op, arg = "write", (c, int(rng.integers(len(c))))
        jarg = (list(arg[0]), arg[1]) if op == "write" else arg
        targ = (list(arg[0]), arg[1]) if op == "write" else arg
        want, got = _apply(ja, op, jarg), _apply(ta, op, targ)
        assert got == want, (op, arg)
        if op == "alloc" and isinstance(want, list):
            chains.append(want)
        elif op == "share" and want is None:
            chains.append(arg)
        elif op == "write" and not isinstance(want, str):
            arg[0][:] = want[1]
        np.testing.assert_array_equal(ta.ref, ja.ref)
        assert ta.n_free == ja.n_free
        ta.check()


def _prompts(seed, n, prefix_len, vocab=97):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(1, 20)),
                            dtype=np.int32)
        if i % 3 == 2:
            out.append(tail)
        elif i % 3 == 1 and out:
            out.append(out[-1].copy())           # an exact repeat
        else:
            out.append(np.concatenate([pre, tail]))
    return out


@pytest.mark.parametrize("seed,bs,n_tbl,enable", [(0, 4, 8, True),
                                                  (1, 4, 3, True),
                                                  (2, 8, 6, True),
                                                  (3, 4, 8, False)])
def test_prefix_plan_matches_reference(seed, bs, n_tbl, enable):
    prompts = _prompts(seed, 9, 13)
    want = jpg.plan_prefix_sharing(prompts, bs, n_tbl, enable=enable)
    got = tpg.plan_prefix_sharing(prompts, bs, n_tbl, enable=enable)
    np.testing.assert_array_equal(got.share_src, want.share_src)
    np.testing.assert_array_equal(got.n_shared_blocks, want.n_shared_blocks)
    np.testing.assert_array_equal(got.pin_counts, want.pin_counts)
    assert got.stats() == want.stats()
    if enable:
        assert got.stats()["shared_blocks"] > 0     # not vacuous


def _attn_inputs(G, seed=0, Dh=32):
    """B 3, Dh 32 (or ``Dh``), bs 4, n_tbl 5; row 2's table is all trash
    block."""
    rng = np.random.default_rng(seed + G + (0 if Dh == 32 else Dh))
    B, Hkv, bs, NB = 3, 2, 4, 12
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    q = bf(rng.standard_normal((B, Hkv * G, Dh)) * 2)
    kp = bf(rng.standard_normal((NB, bs, Hkv, Dh)))
    vp = bf(rng.standard_normal((NB, bs, Hkv, Dh)))
    table = np.array([[3, 5, 1, 7, 9], [2, 4, 0, 0, 0], [0, 0, 0, 0, 0]],
                     np.int32)
    lengths = np.array([17, 6, 3], np.int32)
    return q, kp, vp, table, lengths


def _J(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _T(a):
    return torch.tensor(a).to(torch.bfloat16)


def _both(G, softcap, window, is_local, Dh=32):
    q, kp, vp, table, lengths = _attn_inputs(G, Dh=Dh)
    want = jax.jit(lambda a, b, c, d, e: jref.paged_attention_ref(
        a, b, c, d, e, softcap=softcap, window=window, is_local=is_local))(
        _J(q), _J(kp), _J(vp), jnp.asarray(table), jnp.asarray(lengths))
    got = tops.paged_attention_decode(
        _T(q), _T(kp), _T(vp), torch.tensor(table), torch.tensor(lengths),
        bool(is_local), softcap=softcap, window=window)
    return (q, kp, vp, table, lengths), np.asarray(
        want.astype(jnp.float32)), got.float().numpy()


CASES = [(G, sc, win, loc) for G in (1, 4) for sc in (None, 30.0)
         for win, loc in ((None, 0), (3, 0), (3, 1))]


# head dim 256 (gemma2-9b, paligemma-3b), the kernel's widest instance:
# MHA and GQA, with gemma2's attention softcap and a window
CASES_256 = [(G, sc, win, loc) for G in (1, 2, 8)
             for sc, win, loc in ((None, None, 0), (50.0, 3, 1))]


def _plain_equals_oracle(G, softcap, window, is_local, Dh):
    _, want, got = _both(G, softcap, window, is_local, Dh)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _plain_matches_pallas(G, softcap, window, is_local, Dh):
    (q, kp, vp, table, lengths), _, got = _both(G, softcap, window,
                                                is_local, Dh)
    pal = paged_attention_pallas(
        _J(q), _J(kp), _J(vp), jnp.asarray(table), jnp.asarray(lengths),
        is_local, softcap=softcap, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal.astype(jnp.float32)),
                               rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(vp).max()))


@pytest.mark.parametrize("G,softcap,window,is_local", CASES)
def test_plain_equals_reference_oracle(G, softcap, window, is_local):
    """The CPU dispatch takes the plain version, which equals the
    reference's ``paged_attention_ref`` bit for bit."""
    _plain_equals_oracle(G, softcap, window, is_local, 32)


@pytest.mark.parametrize("G,softcap,window,is_local", CASES_256)
def test_plain_equals_reference_oracle_dh256(G, softcap, window, is_local):
    _plain_equals_oracle(G, softcap, window, is_local, 256)


@pytest.mark.parametrize("G,softcap,window,is_local", CASES)
def test_plain_matches_pallas_interpret(G, softcap, window, is_local):
    """Against the reference's Pallas kernel in interpret mode.  The
    kernel computes P.V in float32 and scales q in float32; the plain
    version rounds the normalized p (and, at Dh 32, the scaled q) to bf16
    first, which costs up to 2^-9 of sum(p |v|) <= 2^-9 max|v| per
    output, and both outputs are rounded to bf16 once: rtol 2^-7, atol
    2^-7 max|v|."""
    _plain_matches_pallas(G, softcap, window, is_local, 32)


@pytest.mark.parametrize("G,softcap,window,is_local", CASES_256)
def test_plain_matches_pallas_interpret_dh256(G, softcap, window, is_local):
    _plain_matches_pallas(G, softcap, window, is_local, 256)


def _long_inputs(G):
    """B 2, Dh 64, bs 16, n_tbl 64 (up to 1,024 positions): lengths on a
    block boundary and off it; the yardstick of the card's long cases."""
    rng = np.random.default_rng(64 + G)
    B, Hkv, Dh, bs, n_tbl = 2, 2, 64, 16, 64
    nb = B * n_tbl + 1
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    q = bf(rng.standard_normal((B, Hkv * G, Dh)) * 2)
    kp = bf(rng.standard_normal((nb, bs, Hkv, Dh)))
    vp = bf(rng.standard_normal((nb, bs, Hkv, Dh)))
    table = rng.permutation(np.arange(1, nb))[:B * n_tbl].reshape(
        B, n_tbl).astype(np.int32)
    lengths = np.array([n_tbl * bs, 37 * bs + 5], np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("G,softcap,window", [(1, None, 7), (4, 30.0, 7),
                                              (1, 30.0, 300)])
def test_plain_long_local_matches_reference(G, softcap, window):
    """At 64 table entries with a local window: the port's plain version
    equals the reference's oracle bit for bit and the reference's Pallas
    kernel (interpret mode) to rtol 2^-7, atol 2^-7 max|v| (the kernel's
    float32 P.V against the oracle's bf16 p, as above)."""
    q, kp, vp, table, lengths = _long_inputs(G)
    args = (_J(q), _J(kp), _J(vp), jnp.asarray(table), jnp.asarray(lengths))
    want = jax.jit(lambda a, b, c, d, e: jref.paged_attention_ref(
        a, b, c, d, e, softcap=softcap, window=window, is_local=True))(*args)
    got = tops.paged_attention_decode(
        _T(q), _T(kp), _T(vp), torch.tensor(table), torch.tensor(lengths),
        True, softcap=softcap, window=window).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))
    pal = paged_attention_pallas(*args, True, softcap=softcap, window=window,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal.astype(jnp.float32)),
                               rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(vp).max()))


def test_gather_equals_reference():
    q, kp, vp, table, lengths = _attn_inputs(1)
    want = jref.paged_gather_kv(_J(kp), jnp.asarray(table))
    got = tref.paged_gather_kv(_T(kp), torch.tensor(table))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_kernel_takes_only_cuda_tensors():
    q, kp, vp, table, lengths = (torch.tensor(a) for a in _attn_inputs(1))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    with pytest.raises(ValueError, match="CUDA tensor"):
        PK.paged_attention_cuda(q, kp, vp, table, lengths)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.paged_attention_decode(q, kp, vp, table, lengths,
                                    use_kernel=True)
    assert PK.paged_attention_cuda.launches == 0


def test_kernel_source_names_what_it_replaces():
    text = (Path(PK.__file__).parent / "csrc"
            / "paged_attn_decode.cu").read_text()
    assert "Replaces:" in text and "paged_attention_pallas" in text
    assert "What bounds it" in text and "Design:" in text
