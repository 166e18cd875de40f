"""Port parity: checkpoints (``repro_torch.checkpoint``) -- atomic saves,
keep-last-k, resume-exactness through ``launch.train``, failure
injection, the corrupt-checkpoint cases and the ``--verify`` CLI, twins
of the reference's ``tests/test_checkpoint.py`` (all but its mesh
reshard, which waits for the port's multi-device work) -- and the
format both packages share: each restores the other's checkpoint with
``==``, packed projections included (stored under the reference pack's
field names and layouts).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config as tget
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core.engine import FusedPackedCimWeights, PackedCimWeights
from repro_torch.launch.train import train
from repro_torch.models import lm as tlm

torch.set_num_threads(1)


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}{k}/")
    elif isinstance(tree, FusedPackedCimWeights):
        yield from _flat(tree.packed, f"{path}packed/")
    elif isinstance(tree, PackedCimWeights):
        for f in ("scale", "kernel_w", "kernel_planes"):
            yield f"{path}{f}", getattr(tree, f)
    else:
        yield path[:-1], tree


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def _npz_path(d, step=0):
    return os.path.join(d, f"step_{step:010d}", "state.npz")


def _truncate(p):
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[: len(data) // 2])      # short write / torn disk


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    ckpt.save(d, 3, t, meta={"arch": "x"})
    assert ckpt.latest_step(d) == 3
    _assert_trees_equal(ckpt.restore(d, _zeros_like(t)), t)
    assert ckpt.load_meta(d)["arch"] == "x"


def test_keep_last_k(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(6):
        ckpt.save(d, s, _tree(), keep_last=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2 and ckpt.latest_step(d) == 5


def test_no_tmp_dirs_left(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _tree())
    assert not [x for x in os.listdir(d) if x.startswith("tmp")]


def test_background_save(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    ckpt.save(d, 2, t, background=True).join()
    _assert_trees_equal(ckpt.restore(d, _zeros_like(t)), t)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _tree())


def test_restore_onto_device_argument(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 0, _tree())
    r = ckpt.restore(d, _tree(), device="cpu")
    assert r["a"].device.type == "cpu"


def test_resume_is_bitwise_exact(tmp_path):
    """Train 6 straight vs 3 + crash + resume 3 through the port's driver
    with ``--cim``: the same losses."""
    d = str(tmp_path / "ck")
    kw = dict(smoke=True, steps=6, batch=2, seq=32, log_every=100,
              cim=True, device="cpu")
    _, _, losses_full = train("minicpm-2b", ckpt_dir="", **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        train("minicpm-2b", ckpt_dir=d, ckpt_every=3, fail_at=4, **kw)
    _, _, losses_resumed = train("minicpm-2b", ckpt_dir=d, resume=True,
                                 ckpt_every=3, **kw)
    np.testing.assert_allclose(losses_full[3:], losses_resumed,
                               rtol=1e-5, atol=1e-6)
    assert losses_full[3:] == losses_resumed        # and bit for bit


def test_restore_truncated_archive_raises_checkpoint_error(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 0, _tree())
    _truncate(_npz_path(d))
    with pytest.raises(ckpt.CheckpointError, match="truncated|corrupt"):
        ckpt.restore(d, _tree())
    with pytest.raises(ckpt.CheckpointError):
        ckpt.verify(d)


def test_restore_missing_leaf_names_it(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    ckpt.save(d, 0, t)
    bigger = dict(t, extra=torch.zeros((2,)))
    with pytest.raises(ckpt.CheckpointError, match="extra"):
        ckpt.restore(d, bigger)


def test_restore_shape_mismatch_names_leaf(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 0, _tree())
    wrong = dict(_tree(), a=torch.zeros((3, 3)))
    with pytest.raises(ckpt.CheckpointError, match="a.*shape|shape.*a"):
        ckpt.restore(d, wrong)


def test_verify_roundtrip_and_target_diff(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    ckpt.save(d, 2, t, meta={"arch": "x"})
    rep = ckpt.verify(d, target=t)
    assert rep["ok"] and rep["step"] == 2
    assert rep["target_leaves_matched"] == 3
    with pytest.raises(ckpt.CheckpointError, match="mismatch"):
        ckpt.verify(d, target=dict(t, extra=torch.zeros((1,))))


def test_verify_bad_meta_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 0, _tree())
    with open(os.path.join(d, "step_0000000000", "meta.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(ckpt.CheckpointError, match="meta"):
        ckpt.verify(d)


def test_verify_cli_exit_codes(tmp_path):
    from repro_torch.checkpoint.__main__ import main
    d = str(tmp_path / "ck")
    assert main([d, "--verify"]) == 2            # nothing there
    ckpt.save(d, 0, _tree())
    assert main([d, "--verify"]) == 0            # intact
    _truncate(_npz_path(d))
    assert main([d, "--verify"]) == 1            # corrupt


# ---------------------------------------------------------------------------
# the shared format
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """minicpm-2b smoke: the reference's params, optimizer state after
    init and its packed params (fused QKV and gate/up groups), and the
    port's copies of each through ``convert``."""
    jcfg = dataclasses.replace(jget("minicpm-2b", smoke=True), cim_mode=True)
    tcfg = dataclasses.replace(tget("minicpm-2b", smoke=True), cim_mode=True)
    jp, _ = jlm.init(jax.random.PRNGKey(0), jcfg)
    jpk = jlm.pack_cim_params(jp, jcfg)
    tp = params_from_jax(
        jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), jp),
        tcfg, "cpu")
    tpk = tlm.pack_cim_params(tp, tcfg, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jpk=jpk, tp=tp, tpk=tpk)


def test_port_pack_equals_reference_pack(models):
    """The port's pack of the same weights holds the reference pack's
    contents (so the cross-package restores below compare like with
    like)."""
    conv = jax.tree.map(np.asarray, models["jpk"]["layers"]["attn"]
                        ["wq+wk+wv"])
    _assert_trees_equal(packed_from_jax(conv, "cpu"),
                        models["tpk"]["layers"]["attn"]["wq+wk+wv"])


def test_reference_checkpoint_restores_into_port(tmp_path, models):
    """Float params and their packs, written by the reference: ``==``."""
    d = str(tmp_path / "ck")
    jckpt.save(d, 4, {"params": models["jp"], "packed": models["jpk"]},
               meta={"arch": "minicpm-2b"})
    target = {"params": _zeros_like(models["tp"]),
              "packed": models["tpk"]}
    r = ckpt.restore(d, target)
    _assert_trees_equal(r["params"], models["tp"])
    _assert_trees_equal(r["packed"], models["tpk"])
    assert ckpt.verify(d)["step"] == 4


def test_port_checkpoint_restores_into_reference(tmp_path, models):
    """Written by the port, restored by the reference into its own trees:
    every leaf ``==``, the packs' seven fields included."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, {"params": models["tp"], "packed": models["tpk"]})
    target = {"params": models["jp"], "packed": models["jpk"]}
    r = jckpt.restore(d, jax.tree.map(jnp.zeros_like, target))
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(r)[0],
                         jax.tree.leaves(target)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(
            np.asarray(a.astype(jnp.float32)),
            np.asarray(b.astype(jnp.float32)),
            err_msg=jax.tree_util.keystr(p))
    assert jckpt.verify(d, target=target)["ok"]


def test_optimizer_state_crosses_both_ways(tmp_path, models):
    """A train checkpoint's layout ({"params", "opt": {"step", "m", "v"}})
    written by either package restores into the other's."""
    from repro.optim import OptConfig as JOptConfig
    from repro.optim import init_opt_state as jinit
    from repro_torch.optim import OptConfig, init_opt_state
    js = jinit(models["jp"], JOptConfig())
    js = dict(js, step=jnp.int32(9),
              m=jax.tree.map(lambda v: jnp.full(v.shape, 0.25, v.dtype),
                             js["m"]))
    d = str(tmp_path / "ck")
    jckpt.save(d, 9, {"params": models["jp"], "opt": js})
    ts = init_opt_state(models["tp"], OptConfig())
    r = ckpt.restore(d, {"params": _zeros_like(models["tp"]), "opt": ts})
    assert int(r["opt"]["step"]) == 9 and r["opt"]["step"].dtype == \
        torch.int32
    assert all(bool((m == 0.25).all()) for m in
               jax.tree.leaves(r["opt"]["m"]))
    _assert_trees_equal(r["params"], models["tp"])
    d2 = str(tmp_path / "ck2")
    ckpt.save(d2, 9, r)
    back = jckpt.restore(d2, {"params": models["jp"], "opt": js})
    assert int(back["opt"]["step"]) == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": models["jp"], "opt": js})):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))
