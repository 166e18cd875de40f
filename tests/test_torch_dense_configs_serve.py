"""Port parity: lock-step greedy serving of qwen3-14b, starcoder2-7b and
gemma2-9b at smoke size against ``repro.launch.serve.serve``, with weights
bridged from the reference ``lm.init`` through numpy: tokens ``==`` in
float mode and with packed weights, fused and unfused, seeds 0 and 1.
"""
import jax
import jax.numpy as jnp
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

MODES = {"fp": dict(cim=False), "packed_fused": dict(cim=True),
         "packed_unfused": dict(cim=True, fuse=False)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-7b", "gemma2-9b"])
def test_greedy_tokens_equal_reference_serve(arch, mode, seed):
    kw = MODES[mode]
    jparams, _ = jlm.init(jax.random.PRNGKey(seed), jget(arch, smoke=True))
    want = jserve(arch, smoke=True, seed=seed, **kw)
    got = tserve(arch, smoke=True, seed=seed, device="cpu",
                 params=params_from_jax(
                     jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)),
                                  jparams),
                     tget(arch, smoke=True), "cpu"), **kw)
    np.testing.assert_array_equal(want, got)
