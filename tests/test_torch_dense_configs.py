"""Port parity: the dense family's three remaining configs -- qwen3-14b,
starcoder2-7b and gemma2-9b -- at smoke size against the reference, with
weights bridged from the reference ``lm.init`` through numpy.

They bring the dense layer's remaining features, each held here with
``==``:

- GELU (starcoder2, gemma2): ``layers._gelu`` reproduces the reference's
  compiled bf16 ``jax.nn.gelu`` on every bf16 input;
- the attention and logit softcaps (gemma2): ``layers.softcap`` on the
  CPU is XLA's float32 tanh (``prng.tanh``) after a multiply by the
  float32 reciprocal of the cap;
- local / global windows (gemma2's even layers are local), past the
  smoke window of 64;
- qk_norm (qwen3), GQA (two query heads a kv head) and GQA over
  TP-padded heads (``tp_head_pad`` 8: 8 query head slots over 2 kv heads);
- tied embeddings (gemma2: the head is ``embed.T``, no ``lm_head`` leaf).

The one-query decode reads sum their scores in the order the reference's
dot takes at GQA shapes on an AVX512-BF16 host (``layers.decode_order``;
the read's test skips on another host), and greedy tokens are
``==`` on every serving path (tests/test_torch_dense_configs_serve.py).
The prefill's flash attention and ``lm.forward`` carry a counted residue
(``RESIDUE``, ROADMAP Queue 3 item 8), on an AVX512-BF16 host one
entry, the flash's dots taking XLA-CPU's order by shape there and the
norms XLA-CPU's rsqrt.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.paged_attn.ref import paged_attention_ref as jpaged
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.kernels.paged_attn.ref import paged_attention_ref as tpaged
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCHS = ("qwen3-14b", "starcoder2-7b", "gemma2-9b")

# Entries one or more steps off the jitted reference, by (arch, CIM
# mode): the prefill's flash attention (4 x 80 tokens: k, v, the last
# logits) and ``lm.forward`` (2 x 80: hidden, logits).  XLA-CPU sums the
# flash's two bf16 dots (scores, P.V) in an order it picks by shape (a
# pair-wise bf16 dot or two-lane blocks of 32).  On an AVX512-BF16 host
# the port takes the same order by shape (``layers.flash_orders``,
# measured by ``tools/flash_dot_probe.py``; ROADMAP Queue 3 item 8) and
# none remains (a value of starcoder2-7b's float prefill was a norm's
# rsqrt: it goes where the norm takes XLA-CPU's rsqrt,
# ``layers.xla_rsqrt``, on an AVX-512 host; a logit of its CIM prefill
# was the lm_head's sum order, ``test_starcoder2_cim_logit_was_the_head_
# order``); elsewhere
# the port sums in its
# own order (8 lanes, torch's), XLA's choice there not measured, and the
# counts are those measured with that order on an AVX512-BF16 host.  In
# float mode a score one float32 ulp off moves an entry by one bf16 step
# (held below to one bf16 step of the entry's largest value); in CIM mode
# the int8 activation quantization absorbs most of it, and where it does
# not an ADC code flips downstream: each entry is then held within a
# quarter of its key's largest value (the flipped codes move it by up to
# 0.145 of it at these seeds) and the logits' argmax to the reference's
# on every row.
RESIDUE = ({
    ("qwen3-14b", False): {},
    ("qwen3-14b", True): {},
    ("starcoder2-7b", False): {} if tL.avx512f_host() else {"v": 1},
    ("starcoder2-7b", True): {},
    ("gemma2-9b", False): {},
    ("gemma2-9b", True): {},
} if tL.bf16_dot_host() else {
    ("qwen3-14b", False): {"fwd_hidden": 15, "fwd_logits": 252},
    ("qwen3-14b", True): {},
    ("starcoder2-7b", False): {"k": 46, "v": 44, "logits": 319},
    ("starcoder2-7b", True): {"logits": 1, "fwd_hidden": 29,
                              "fwd_logits": 494},
    ("gemma2-9b", False): {},
    ("gemma2-9b", True): {"k": 64, "v": 64, "logits": 508},
})


def _assert_residue(arch, cim, got, want):
    for key in got:
        n_diff = int((got[key] != want[key]).sum())
        assert n_diff <= RESIDUE[(arch, cim)].get(key, 0), (key, n_diff)
        atol = (2 ** -2 if cim else 2 ** -7) * np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
        if cim and "logits" in key:
            np.testing.assert_array_equal(got[key].argmax(-1),
                                          want[key].argmax(-1), err_msg=key)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _J(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _T(a):
    return torch.tensor(a).to(torch.bfloat16)


def _model(arch, cim, seed=0, **over):
    jcfg = dataclasses.replace(jget(arch, smoke=True), cim_mode=cim, **over)
    tcfg = dataclasses.replace(tget(arch, smoke=True), cim_mode=cim, **over)
    jp, _ = jlm.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    if cim:
        jp = jlm.pack_cim_params(jp, jcfg)
        tp = tlm.pack_cim_params(tp, tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def test_gelu_equals_reference_on_every_bf16():
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = bits[np.isfinite(bits)]
    want = _np(jax.jit(jax.nn.gelu)(_J(x)))
    got = tL._gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_tanh_and_softcap_equal_reference(cap):
    """XLA's float32 tanh, alone and as the softcap at gemma2's caps
    (logits 30, attention scores 50), on inputs that reach the clamp."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200_000) * s
                        for s in (1e-3, 0.3, 3.0, 40.0, 400.0)]
                       ).astype(np.float32)
    if cap is None:
        want = np.asarray(jax.jit(jnp.tanh)(x))
        got = prng.tanh(torch.from_numpy(x))
    else:
        want = np.asarray(jax.jit(lambda v: jL.softcap(v, cap))(x))
        got = tL.softcap(torch.from_numpy(x), cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.skipif(not tL.bf16_dot_host(),
                    reason="the decode reads' dot orders are those measured "
                           "on an AVX512-BF16 host; XLA-CPU's elsewhere are "
                           "not reproduced")
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_read_equals_reference(arch, local, paged):
    """One-query decode attention at the arch's smoke heads (G 2, Dh 32,
    gemma2's softcap 50 and window 64), keys past the window: the plain
    read and the paged oracle, each against its jitted reference."""
    cfg = tget(arch, smoke=True)
    B, L, Hkv, G, Dh = 3, 96, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    rng = np.random.default_rng(7)
    q = _bf(rng.standard_normal((B, Hkv * G, Dh)) * 2)
    k, v = (_bf(rng.standard_normal((B, L, Hkv, Dh))) for _ in range(2))
    lengths = np.array([96, 70, 9], np.int32)
    if paged:
        bs = 8
        table = np.arange(B * L // bs, dtype=np.int32).reshape(B, -1)
        pool = lambda a: a.reshape(B * L // bs, bs, Hkv, Dh)
        want = jax.jit(lambda *a: jpaged(
            *a, softcap=cfg.attn_softcap, window=cfg.sliding_window,
            is_local=local))(_J(q), _J(pool(k)), _J(pool(v)),
                             jnp.asarray(table), jnp.asarray(lengths))
        got = tpaged(_T(q), _T(pool(k)), _T(pool(v)), torch.tensor(table),
                     torch.tensor(lengths), softcap=cfg.attn_softcap,
                     window=cfg.sliding_window, is_local=local)
    else:
        q_pos = (lengths - 1)[:, None]
        k_pos = np.where(np.arange(L)[None] < lengths[:, None],
                         np.arange(L)[None], 10 ** 9)
        jcfg = jget(arch, smoke=True)
        want = jax.jit(lambda a, b, c: jL.plain_attention(
            a, b, c, jnp.asarray(q_pos), jnp.asarray(k_pos), jcfg,
            jnp.bool_(local)))(_J(q[:, None]), _J(k), _J(v))[:, 0]
        got = tL.plain_attention(_T(q[:, None]), _T(k), _T(v),
                                 torch.tensor(q_pos), torch.tensor(k_pos),
                                 cfg, local)[:, 0]
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.skipif(not tL.bf16_dot_host(),
                    reason="the flash's dot orders are those measured on an "
                           "AVX512-BF16 host; XLA-CPU's elsewhere are not "
                           "reproduced")
@pytest.mark.parametrize("G,Sq,blk,Sk", [(1, 16, 64, 107), (2, 80, 64, 96),
                                         (1, 8, 13, 13), (1, 24, 32, 64),
                                         (1, 64, 48, 90), (2, 144, 64, 150),
                                         (4, 8, 44, 44)])
def test_flash_dot_orders_equal_reference(G, Sq, blk, Sk):
    """The flash forward (``layers._flash_fwd``: out, running max and sum)
    with ``==`` against the jitted reference's at M = G * Sq query rows a
    kv head and key blocks of ``blk``, gemma2-9b's softcap on the scores:
    its two bf16 dots sum in XLA-CPU's order by shape
    (``layers.flash_orders``; the pair-wise dot, the two-lane blocks of 32
    at M 160 and 288 over 64, M 24 over 32 and M 64 over 48's scores),
    over one or more key blocks, the last one padded where Sk is not a
    multiple of blk."""
    jcfg = dataclasses.replace(jget("gemma2-9b", smoke=True),
                               flash_block=blk)
    tcfg = dataclasses.replace(tget("gemma2-9b", smoke=True),
                               flash_block=blk)
    rng = np.random.default_rng(G * Sq + blk)
    Hkv, Dh = 2, jcfg.head_dim
    q = _bf(rng.standard_normal((2, Sq, Hkv * G, Dh)) * 2)
    k, v = (_bf(rng.standard_normal((2, Sk, Hkv, Dh)) * 2) for _ in range(2))
    q_pos = np.broadcast_to(np.arange(Sk - Sq, Sk), (2, Sq)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(Sk), (2, Sk)).astype(np.int32)
    want = jax.jit(lambda a, b, c, d, e: jL._flash_fwd(
        jcfg, 0, a, b, c, d, e, True))(_J(q), _J(k), _J(v), jnp.asarray(q_pos),
                                       jnp.asarray(k_pos))
    got = tL._flash_fwd(tcfg, 0, _T(q), _T(k), _T(v),
                        torch.from_numpy(q_pos).long(),
                        torch.from_numpy(k_pos).long(), True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cim", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_logits_equal_reference(arch, cim):
    """80 prompt tokens (past gemma2's smoke window on its local layer):
    every cache entry and the last logits against the jitted reference,
    within the counted residue."""
    jcfg, tcfg, jp, tp = _model(arch, cim)
    toks = np.random.default_rng(1).integers(0, 512, (4, 80))
    jl, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, jnp.asarray(toks, jnp.int32), jlm.init_cache(jcfg, 4, 96))
    tl, tc = tlm.prefill(tp, tcfg, torch.tensor(toks),
                         tlm.init_cache(tcfg, 4, 96, device="cpu"))
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    _assert_residue(arch, cim,
                    {"k": tc["k"].float().numpy(),
                     "v": tc["v"].float().numpy(), "logits": tl.numpy()},
                    {"k": _np(jc["k"]), "v": _np(jc["v"]),
                     "logits": np.asarray(jl)})


@pytest.mark.skipif(not tL.bf16_dot_host(),
                    reason="the lm_head's order is the one measured on an "
                           "AVX512-BF16 host (layers.lm_head_order)")
def test_starcoder2_cim_logit_was_the_head_order():
    """The one logit of starcoder2-7b's CIM prefill that stayed one step
    off (ROADMAP Queue 3 item 8) is the lm_head's float32 sum order, item
    5's: with the head summed in XLA-CPU's order for its rows
    (``layers.lm_head_order``: the untied head's halves at M 4) every
    logit is ``==``; in torch's GEMM order that one logit parts, and the
    caches and every hidden state before the head are ``==`` either
    way."""
    jcfg, tcfg, jp, tp = _model("starcoder2-7b", True)
    toks = np.random.default_rng(1).integers(0, 512, (4, 80))
    jl, _ = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, jnp.asarray(toks, jnp.int32), jlm.init_cache(jcfg, 4, 96))
    want = np.asarray(jl)
    assert tL.lm_head_order(4, 128, 512, False) == "halves"

    def prefill():
        with torch.inference_mode():
            return tlm.prefill(tp, tcfg, torch.tensor(toks),
                               tlm.init_cache(tcfg, 4, 96, device="cpu"))
    got, cache = prefill()
    np.testing.assert_array_equal(got.numpy(), want)
    orig = tL.lm_head_order
    try:
        tL.lm_head_order = lambda *a: "torch"
        other, cache2 = prefill()
    finally:
        tL.lm_head_order = orig
    assert int((other.numpy() != want).sum()) == 1
    for k in ("k", "v"):
        assert torch.equal(cache[k], cache2[k])


@pytest.mark.parametrize("cim", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, cim):
    """``lm.forward`` (no cache; the planner's calibration forward)
    against the jitted reference, within the counted residue."""
    jcfg, tcfg, jp, tp = _model(arch, cim, seed=2)
    toks = np.random.default_rng(2).integers(0, 512, (2, 80)).astype(
        np.int32)
    jh = jax.jit(lambda p, t: jlm.hidden_states(p, jcfg, t, remat=False)[0])(
        jp, jnp.asarray(toks))
    jl = jax.jit(lambda p, t: jlm.forward(p, jcfg, t, remat=False)[0])(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        th, _ = tlm.hidden_states(tp, tcfg, torch.from_numpy(toks).long())
        tl, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (2, 80, 512) and tl.dtype == torch.float32
    _assert_residue(arch, cim,
                    {"fwd_hidden": th.float().numpy(),
                     "fwd_logits": tl.numpy()},
                    {"fwd_hidden": _np(jh), "fwd_logits": np.asarray(jl)})


def _greedy(prefill, decode, toks, n):
    logits, cache = prefill(toks)
    out = [np.asarray(logits[:, -1]).argmax(-1)]
    for _ in range(n - 1):
        logits, cache = decode(out[-1][:, None], cache)
        out.append(np.asarray(logits[:, -1]).argmax(-1))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_over_padded_heads_tokens_equal_reference(arch):
    """``tp_head_pad`` 8 pads the smoke config's 4 query heads to 8 slots
    over its 2 kv heads (zero-masked pad heads; G 4 in the reads): greedy
    lock-step tokens in CIM mode ``==`` the reference's, from a 72-token
    prompt so that decode reads cross gemma2's window of 64."""
    jcfg, tcfg, jp, tp = _model(arch, True, tp_head_pad=8)
    assert tcfg.padded_heads == 8 and tcfg.padded_kv_heads == 2
    toks = np.random.default_rng(3).integers(0, 512, (2, 72)).astype(
        np.int32)
    jpre = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))
    jdec = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    want = _greedy(
        lambda t: jpre(jp, jnp.asarray(t), jlm.init_cache(jcfg, 2, 80)),
        lambda t, c: jdec(jp, jnp.asarray(t, jnp.int32), c), toks, 8)
    with torch.inference_mode():
        got = _greedy(
            lambda t: tlm.prefill(tp, tcfg, torch.from_numpy(t).long(),
                                  tlm.init_cache(tcfg, 2, 80,
                                                 device="cpu")),
            lambda t, c: tlm.decode_step(tp, tcfg, torch.from_numpy(t),
                                         c), toks, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """qwen3's ``q_norm`` / ``k_norm`` leaves come across, and gemma2's
    tied tree (no ``lm_head``) stays tied; every leaf equal."""
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(t, path=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{path}['{k}']")
            else:
                tflat[f"{path}['{k}']"] = v
    walk(tp)
    assert sorted(tflat) == sorted(jflat)
    assert ("['layers']['attn']['q_norm']" in tflat) == tcfg.qk_norm
    assert ("['lm_head']" in tflat) != tcfg.tie_embeddings
    for k, v in tflat.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(), _np(jflat[k]),
                                      err_msg=k)


@pytest.mark.parametrize("fuse", [False, True])
def test_consuming_pack_equals_pack(fuse):
    """``pack_cim_params(consume=True)`` (a caller that owns the raw
    params: the serve functions' own init) packs bit for bit as the
    copying walk does, and leaves no raw projection behind in the tree
    it consumed; the stacked fused leaves are packed one layer at a
    time, equal to packing their whole concatenation layer by layer."""
    cfg = dataclasses.replace(tget("qwen3-14b", smoke=True), cim_mode=True,
                              cim_fuse=fuse)
    raw = tlm.init(0, cfg, device="cpu")
    want = tlm.pack_cim_params(raw, cfg, "cpu")
    got = tlm.pack_cim_params(raw, cfg, "cpu", consume=True)
    assert not set(raw["layers"]["attn"]) & set(tlm._CIM_PACKABLE)
    assert not set(raw["layers"]["mlp"]) & set(tlm._CIM_PACKABLE)
    assert "q_norm" in raw["layers"]["attn"] and "embed" in raw
    flat = lambda t: {p: v for p, v in _leaves(t)}
    w, g = flat(want), flat(got)
    assert sorted(w) == sorted(g)
    for k in w:
        assert torch.equal(w[k], g[k]), k
    if fuse:
        leaf = got["layers"]["mlp"]["w1+w3"].packed
        whole = tlm.CimEngine(cfg=leaf.cfg).pack(torch.cat(
            [tlm.init(0, cfg, device="cpu")["layers"]["mlp"][m]
             for m in ("w1", "w3")], -1))
        assert torch.equal(leaf.kernel_w, whole.kernel_w)
        assert torch.equal(leaf.kernel_planes, whole.kernel_planes)


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(t, torch.Tensor):
        yield path, t
    else:
        leaf = getattr(t, "packed", t)
        for f in ("scale", "kernel_w", "kernel_planes"):
            yield f"{path}.{f}", getattr(leaf, f)
