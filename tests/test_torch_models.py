"""Port parity: the minicpm-2b smoke model and the lock-step serve driver
against the reference package, with weights bridged from the reference
``lm.init`` through numpy.

Greedy tokens must be equal.  The prefill logits are held to one bf16
rounding step (rtol 2^-7, one bf16 ulp): the reference and the port perform the same
bf16 roundings, but a float32 sum in a different order could still move
a logit across one bf16 rounding boundary.  The layer pieces below are
compared with ``==``: the port reproduces the reference's rounding
points and summation order (see the notes in models/layers.py),
rms_norm's windowed sum of squares included.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jget
from repro.data import DataConfig as JData
from repro.data import batch_at as jbatch
from repro.launch.serve import serve as jserve
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig as TData
from repro_torch.data import batch_at as tbatch
from repro_torch.launch.serve import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _bridge(jparams, cfg):
    return params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jparams),
        cfg, "cpu")


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["fp", "packed_fused", "packed_unfused"])
def test_greedy_tokens_equal_reference_serve(seed, mode):
    kw = {"fp": dict(cim=False), "packed_fused": dict(cim=True),
          "packed_unfused": dict(cim=True, fuse=False)}[mode]
    jparams, _ = jlm.init(jax.random.PRNGKey(seed),
                          jget("minicpm-2b", smoke=True))
    want = jserve("minicpm-2b", smoke=True, seed=seed, **kw)
    got = tserve("minicpm-2b", smoke=True, seed=seed, device="cpu",
                 params=_bridge(jparams, tget("minicpm-2b", smoke=True)),
                 **kw)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("cim", [False, True])
def test_prefill_logits_and_cache_match(cim):
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=cim)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=cim)
    jparams, _ = jlm.init(jax.random.PRNGKey(3), jcfg)
    tparams = _bridge(jparams, tcfg)
    if cim:
        jparams = jlm.pack_cim_params(jparams, jcfg)
        tparams = tlm.pack_cim_params(tparams, tcfg, "cpu")
    toks = jbatch(JData(vocab_size=512, seq_len=16, global_batch=2, seed=3),
                  0)["tokens"]
    jl, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jparams, jnp.asarray(toks), jlm.init_cache(jcfg, 2, 24))
    tl, tc = tlm.prefill(tparams, tcfg, torch.tensor(toks).long(),
                         tlm.init_cache(tcfg, 2, 24, device="cpu"))
    assert tl.shape == (2, 1, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2 ** -7,
                               atol=0)
    np.testing.assert_allclose(tc["k"].float().numpy(), _np(jc["k"]),
                               rtol=2 ** -7, atol=0)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


def test_layer_pieces_bit_identical():
    """rms_norm, rope, flash and plain attention on identical inputs."""
    jcfg, tcfg = jget("minicpm-2b", smoke=True), tget("minicpm-2b",
                                                      smoke=True)
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))
    B, S, H, D = 2, 20, 4, 32
    q, k, v = (bf(rng.standard_normal((B, S, H, D))) for _ in range(3))
    x, w = bf(rng.standard_normal((B, S, 128))), bf(rng.standard_normal(128))
    J = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    T = lambda a: torch.tensor(a).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    # rms_norm: the port sums the squares in the reference's window order
    np.testing.assert_array_equal(
        _np(jax.jit(lambda a, b: jL.rms_norm(a, b, 1e-6))(J(x), J(w))),
        tL.rms_norm(T(x), T(w), 1e-6).float().numpy())
    np.testing.assert_array_equal(
        _np(jax.jit(lambda a: jL.rope(a, jnp.asarray(pos), 1e4))(J(q))),
        tL.rope(T(q), torch.tensor(pos), 1e4, S).float().numpy())
    kpos = np.where(np.arange(S)[None] < S - 3, np.arange(S)[None], 10 ** 9)
    kpos = np.broadcast_to(kpos, (B, S))
    fj = jax.jit(lambda a, b, c: jL.flash_attention(
        jcfg, 0, a, b, c, jnp.asarray(pos), jnp.asarray(kpos),
        jnp.bool_(False)))(J(q), J(k), J(v))
    ft = tL.flash_attention(tcfg, 0, T(q), T(k), T(v), torch.tensor(pos),
                            torch.tensor(kpos), False)
    np.testing.assert_array_equal(_np(fj), ft.float().numpy())
    qpos = np.full((B, 1), S - 4)
    pj = jax.jit(lambda a, b, c: jL.plain_attention(
        a, b, c, jnp.asarray(qpos), jnp.asarray(kpos), jcfg,
        jnp.bool_(False)))(J(q[:, :1]), J(k), J(v))
    pt = tL.plain_attention(T(q[:, :1]), T(k), T(v), torch.tensor(qpos),
                            torch.tensor(kpos), tcfg, False)
    np.testing.assert_array_equal(_np(pj), pt.float().numpy())


def test_data_pipeline_matches():
    for seed, step in ((0, 0), (7, 3)):
        a = jbatch(JData(vocab_size=122753, seq_len=32, global_batch=4,
                         seed=seed), step)["tokens"]
        b = tbatch(TData(vocab_size=122753, seq_len=32, global_batch=4,
                         seed=seed), step)["tokens"]
        np.testing.assert_array_equal(a, b)


PORTED = ("minicpm-2b", "qwen3-14b", "starcoder2-7b", "gemma2-9b",
          "qwen2-moe-a2.7b", "arctic-480b", "mamba2-130m", "zamba2-1.2b",
          "paligemma-3b", "musicgen-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_and_others_raise(arch):
    """A ported arch's config equals the reference's field for field, at
    full and smoke size (every arch is ported; one not ported would
    raise)."""
    if arch not in PORTED:
        with pytest.raises(NotImplementedError):
            tget(arch)
        return
    for smoke in (False, True):
        j, t = jget(arch, smoke), tget(arch, smoke)
        for f in dataclasses.fields(t):
            if f.name not in ("cim_use_kernel", "paged_attn_use_kernel"):
                assert getattr(t, f.name) == getattr(j, f.name), (
                    arch, f.name)
        assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)
        assert (t.padded_heads, t.padded_kv_heads, t.q_per_kv) == (
            j.padded_heads, j.padded_kv_heads, j.q_per_kv)
    assert tget(arch, smoke=True).tp_head_pad == 1
    if arch == "minicpm-2b":
        assert tget(arch).padded_heads == 48


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve("minicpm-2b", smoke=True, cim=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init(0, tget("minicpm-2b", smoke=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()


def test_sampling_is_refused():
    """Sampling and analog noise are served (tests/test_torch_sampling.py,
    tests/test_torch_noise.py); noise without the macro is refused, as
    the reference refuses it."""
    with pytest.raises(ValueError, match="cim=True"):
        tserve("minicpm-2b", smoke=True, temperature=0.7, noise_seed=0,
               device="cpu")
