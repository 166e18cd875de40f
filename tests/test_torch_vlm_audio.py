"""Port parity: the vlm family (paligemma-3b) and the audio family
(musicgen-medium) at smoke size, with weights from the reference
``lm.init`` through ``convert.params_from_jax`` and frontend embeddings
from numpy seeds.

- The configs ``==`` the reference's, field for field (full and smoke),
  and the registry resolves all ten archs to the reference's configs.
- ``layers._mask`` with a prefix (the prefix-LM mask) ``==`` the
  reference's.
- ``lm.forward`` with ``frontend_embs``: paligemma's 8 frontend tokens go
  ahead of the text under the prefix-LM mask (they attend to each other
  both ways), musicgen's frame embeddings are concatenated with no mask.
  Hidden states and logits ``==`` the jitted reference's, in float and
  packed CIM mode; the lm_head sums in XLA-CPU's order on an AVX512-BF16
  host (``layers.lm_head_order``, ``LOGIT_RESIDUE`` elsewhere).
- ``prefill`` with frontend embeddings, then two ``decode_step``s: the
  caches, logits and greedy tokens ``==`` the jitted reference's.
- The pack: four macro sites a layer (fused QKV, ``wo``, fused w1+w3,
  ``w2``), paligemma's tied head left float; musicgen's MHA heads.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCHS = ("paligemma-3b", "musicgen-medium")
PORT_ONLY = ("cim_use_kernel", "paged_attn_use_kernel")
# logits more than 0 apart of ``lm.forward`` (2 x 24 x 512), by (arch,
# CIM): the lm_head's float32 sum order, XLA-CPU's on an AVX512-BF16
# host; elsewhere torch's (ROADMAP Queue 3 item 5; the counts measured
# with that order on an AVX512-BF16 host), held within one bf16 step of
# the largest logit
LOGIT_RESIDUE = {("paligemma-3b", False): 0, ("paligemma-3b", True): 0,
                 ("musicgen-medium", False): 0 if tL.bf16_dot_host() else 1,
                 ("musicgen-medium", True): 0 if tL.bf16_dot_host() else 2}


def _f32(tree):
    return jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), tree)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _model(arch, cim):
    jcfg = dataclasses.replace(jget(arch, smoke=True), cim_mode=cim)
    tcfg = dataclasses.replace(tget(arch, smoke=True), cim_mode=cim)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_f32(jp), tcfg, "cpu")
    if cim:
        jp = jlm.pack_cim_params(jp, jcfg)
        tp = tlm.pack_cim_params(tp, tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _frontend(cfg, B, seed):
    """Seeded frontend embeddings (B, F, D), bf16 values, F the config's
    frontend tokens."""
    rng = np.random.default_rng(seed)
    return _bf(rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)))


def _equal_config(t, j):
    for f in dataclasses.fields(t):
        if f.name not in PORT_ONLY:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


# ---------------------------------------------------------------------------
# configs, mask, params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for smoke in (False, True):
        _equal_config(tget(arch, smoke), jget(arch, smoke))
    full, smoke = tget("paligemma-3b"), tget("paligemma-3b", smoke=True)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.prefix_lm, full.n_frontend_tokens, full.tie_embeddings) == (
        "vlm", 18, 2048, 8, 1, 256, 16384, 257216, True, 256, True)
    assert (smoke.n_kv_heads, smoke.n_frontend_tokens) == (1, 8)
    mg = tget("musicgen-medium")
    assert (mg.family, mg.n_layers, mg.d_model, mg.n_heads, mg.padded_heads,
            mg.padded_kv_heads, mg.head_dim, mg.vocab_size) == (
        "audio", 48, 1536, 24, 32, 32, 64, 2048)


def test_registry_resolves_every_arch():
    assert TARCHS == tuple(JARCHS)
    assert set(tlm.PORTED_FAMILIES) == {tget(a).family for a in TARCHS}


@pytest.mark.parametrize("n_prefix", [0, 3, 8])
@pytest.mark.parametrize("local", [False, True])
def test_mask_with_prefix_equals_reference(n_prefix, local):
    """The prefix-LM mask: keys below ``n_prefix`` visible to every query,
    the rest causal (and windowed on a local layer)."""
    q_pos = np.broadcast_to(np.arange(2, 14), (2, 12)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    want = jL._mask(jnp.asarray(q_pos), jnp.asarray(k_pos), jnp.bool_(local),
                    5, n_prefix)
    got = tL._mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), local,
                   5, n_prefix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_prefix and not local:
        assert got[:, :, :n_prefix].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_pack_sites_equal_reference(arch):
    """The port's ``lm.init`` tree is the reference's (paligemma: tied, no
    ``lm_head``); the plan sees four projections a layer and the fused
    pack four macro sites (QKV, wo, w1+w3, w2), the head left float."""
    jcfg, tcfg, jp, tp = _model(arch, False)

    def shapes(t, path=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{path}{k}/"))
            else:
                out[path + k] = tuple(v.shape)
        return out
    assert shapes(tlm.init(0, tcfg, device="cpu")) == shapes(jp)
    assert ("lm_head" in tp) != tcfg.tie_embeddings
    sites = tlm.iter_packable_paths(tp)
    assert sites == jlm.iter_packable_paths(jp)
    assert sorted(sites) == ["attn/wk", "attn/wo", "attn/wq", "attn/wv",
                             "mlp/w1", "mlp/w2", "mlp/w3"]
    _, ccfg, _, packed = _model(arch, True)
    assert sorted(packed["layers"]["attn"]) == ["wo", "wq+wk+wv"]
    assert sorted(packed["layers"]["mlp"]) == ["w1+w3", "w2"]
    assert isinstance(packed["embed"], torch.Tensor)
    if arch == "musicgen-medium":   # MHA: kv heads padded with q
        assert tcfg.padded_kv_heads == tcfg.padded_heads == 4


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cim", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_frontend_equals_reference(arch, cim):
    """16 text tokens after 8 frontend embeddings: hidden states ``==``,
    logits ``==`` but for ``LOGIT_RESIDUE``."""
    jcfg, tcfg, jp, tp = _model(arch, cim)
    toks = np.random.default_rng(4).integers(0, 512, (2, 16)).astype(
        np.int32)
    fe = _frontend(tcfg, 2, 5)
    jfe = jnp.asarray(fe, jnp.bfloat16)
    jh = jax.jit(lambda p, t, f: jlm.hidden_states(
        p, jcfg, t, f, remat=False)[0])(jp, jnp.asarray(toks), jfe)
    jl = jax.jit(lambda p, t, f: jlm.forward(p, jcfg, t, f, remat=False)[0])(
        jp, jnp.asarray(toks), jfe)
    tt, tfe = torch.from_numpy(toks).long(), torch.from_numpy(fe)
    with torch.inference_mode():
        th, _ = tlm.hidden_states(tp, tcfg, tt, tfe)
        tl, _ = tlm.forward(tp, tcfg, tt, tfe)
    assert tl.shape == (2, 24, 512) and tl.dtype == torch.float32
    np.testing.assert_array_equal(th.float().numpy(), _np(jh))
    jl = np.asarray(jl)
    assert int((tl.numpy() != jl).sum()) <= LOGIT_RESIDUE[(arch, cim)]
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=2 ** -7 * np.abs(jl).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_mask_changes_the_frontend_rows(arch):
    """The prefix-LM mask is live: flipping ``prefix_lm`` (paligemma's
    frontend rows then attend causally, musicgen's both ways) changes the
    frontend rows' hidden states."""
    _, tcfg, _, tp = _model(arch, False)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512,
                                                              (1, 4)))
    fe = torch.from_numpy(_frontend(tcfg, 1, 6))
    flipped = dataclasses.replace(tcfg, prefix_lm=not tcfg.prefix_lm)
    with torch.inference_mode():
        a, _ = tlm.hidden_states(tp, tcfg, toks, fe)
        b, _ = tlm.hidden_states(tp, flipped, toks, fe)
    assert not torch.equal(a[:, :7], b[:, :7])
    assert tcfg.prefix_lm == (arch == "paligemma-3b")


@pytest.mark.parametrize("cim", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_frontend_then_decode_equals_reference(arch, cim):
    """Prefill of 8 frontend embeddings and 12 prompt tokens (the flash
    prefill under the prefix mask for paligemma), then two decode steps
    from the greedy tokens: every cache entry, the logits and the tokens
    ``==`` the jitted reference's."""
    jcfg, tcfg, jp, tp = _model(arch, cim)
    B, P, L = 2, 12, 24
    toks = np.random.default_rng(8).integers(0, 512, (B, P)).astype(np.int32)
    fe = _frontend(tcfg, B, 9)
    jpre = jax.jit(lambda p, t, c, f: jlm.prefill(p, jcfg, t, c, f))
    jdec = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    jl, jc = jpre(jp, jnp.asarray(toks), jlm.init_cache(jcfg, B, L),
                  jnp.asarray(fe, jnp.bfloat16))
    with torch.inference_mode():
        tl, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                             tlm.init_cache(tcfg, B, L, device="cpu"),
                             torch.from_numpy(fe))
        for step in range(3):
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                          err_msg=str(step))
            for key in ("k", "v", "pos"):
                np.testing.assert_array_equal(
                    tc[key].float().numpy(), _np(jc[key]),
                    err_msg=f"{key} {step}")
            if step == 2:
                break
            tok = np.asarray(jl[:, -1]).argmax(-1)[:, None].astype(np.int32)
            assert tl[:, -1].argmax(-1).tolist() == tok[:, 0].tolist()
            jl, jc = jdec(jp, jnp.asarray(tok), jc)
            tl, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                     tc)
    assert tc["pos"].tolist() == [8 + P + 2] * B
