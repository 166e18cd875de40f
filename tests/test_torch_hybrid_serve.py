"""Port parity: serving the hybrid family (zamba2-1.2b smoke: 4 Mamba2
layers, the shared attn + mlp block after layers 2 and 4) against the
reference, with weights from the reference ``lm.init`` through
``convert.params_from_jax``; the model-level parity and the counted
residues are in ``test_torch_hybrid.py``.

Greedy tokens ``==`` the reference's ``serve`` in float, packed fused
and unfused, unpacked and noisy CIM mode, and sampled ones at T 0.7; the scheduler's refilled pool
``==`` solo runs and the reference's pool; the paged pool (the shared
block's KV paged, the recurrent state per slot) with chunked prefill
``==`` the contiguous pool at temperature 0.7; the recurrent families'
rules (no speculative decoding, paged prompts a whole number of chunks,
no prefix sharing) and the slot reset.  Each reference scheduler runs
once per module (a fixture).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.serve import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import serve as tserve

# the suite runs several workers at once: one torch thread each
torch.set_num_threads(1)

ARCH = "zamba2-1.2b"


def _f32(tree):
    return jax.tree.map(lambda v: np.asarray(v.astype(jax.numpy.float32)),
                        tree)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_f32(jp), tcfg, "cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["fp", "packed_fused", "packed_unfused",
                                  "unpacked"])
def test_greedy_tokens_equal_reference_serve(seed, mode):
    kw = {"fp": dict(cim=False), "packed_fused": dict(cim=True),
          "packed_unfused": dict(cim=True, fuse=False),
          "unpacked": dict(cim=True, pack=False)}[mode]
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp, _ = jlm.init(jax.random.PRNGKey(seed), jcfg)
    want = jserve(ARCH, smoke=True, seed=seed, **kw)
    got = tserve(ARCH, smoke=True, seed=seed, device="cpu",
                 params=params_from_jax(_f32(jp), tcfg, "cpu"), **kw)
    np.testing.assert_array_equal(want, got)


def test_noisy_serve_equals_reference(model):
    """Analog noise (seed 0): the shared block draws the streams keyed by
    its own paths, each invocation the same pattern, as the reference."""
    _, _, _, tp = model
    kw = dict(cim=True, noise_seed=0, batch=2, prompt_len=8, gen=4)
    np.testing.assert_array_equal(
        jserve(ARCH, smoke=True, **kw),
        tserve(ARCH, smoke=True, device="cpu", params=tp, **kw))


def test_sampled_serve_equals_reference(model):
    """Lock-step at temperature 0.7 on the packed macro: the sampled
    tokens equal the reference's (its sampling streams bit for bit)."""
    _, _, _, tp = model
    kw = dict(cim=True, temperature=0.7, batch=2, prompt_len=16, gen=6)
    np.testing.assert_array_equal(
        jserve(ARCH, smoke=True, **kw),
        tserve(ARCH, smoke=True, device="cpu", params=tp, **kw))
