"""Fault-tolerant checkpointing of torch state: atomic writes,
keep-last-k, resume, in the reference's format.

Counterpart of ``repro/checkpoint/manager.py``.  Format: one ``.npz`` of
the tree's leaves keyed by their path ("params/layers/attn/wq",
"opt/step"), bfloat16 staged as float32, and ``meta.json``.  A crashed
save never corrupts the latest checkpoint: it is written into
``<dir>/tmp.<step>`` and renamed.  With the same format either package
restores the other's checkpoint.  A packed projection
(``core.engine.PackedCimWeights``) is written under the reference
pack's field names ("scale", "sign", "mag", "gemm_w", "gemm_planes",
"pallas_w", "pallas_planes", in the reference's layouts; a fused group
under "packed/"), and restored from its scale and block-padded int8
weights and planes.  ``restore`` puts each leaf on ``device`` (default:
the target leaf's); resharding onto a device mesh waits for the port's
multi-device work.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.engine import FusedPackedCimWeights, PackedCimWeights

# the reference pack's stored fields, in its flatten order
PACK_FIELDS = ("scale", "sign", "mag", "gemm_w", "gemm_planes", "pallas_w",
               "pallas_planes")


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot be restored (truncated archive,
    missing/mismatched leaves, unreadable metadata).  Distinct from
    FileNotFoundError -- callers that fall back to cold start on *absent*
    checkpoints should NOT silently swallow a *corrupt* one."""


def _items(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) over a tree of dicts, tensors, packs and Python
    scalars; a pack is one leaf here."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, FusedPackedCimWeights):
        yield from _items(tree.packed, path + ("packed",))
    else:
        yield "/".join(path), tree


def _pad_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pick_block(dim: int, preferred: int) -> int:
    if dim >= preferred:
        return preferred
    return 1 << max(dim - 1, 0).bit_length()


def _ref_weight_blocks(K: int, N: int, acc_len: int) -> Tuple[int, int]:
    """(Np, Kp) of the reference pack's block-padded layout (its
    ``pick_weight_blocks``: N in blocks of up to 128, K in whole ADC
    conversions and then in a power-of-two count of them that wastes
    under a quarter)."""
    c = _pad_to(K, acc_len) // acc_len
    bk = _pick_block(c, 32)
    while bk > 1 and (-c % bk) * 4 > c:
        bk //= 2
    return (_pad_to(N, _pick_block(N, 128)),
            _pad_to(_pad_to(K, acc_len), bk * acc_len))


def _pack_fields(p: PackedCimWeights) -> Dict[str, np.ndarray]:
    """A port pack (any leading layer axes) in the reference's fields."""
    K, N, L = p.k_dim, p.n_dim, p.cfg.acc_len
    wq = p.kernel_w[..., :K].transpose(-1, -2).to(torch.int32).cpu()
    planes = p.kernel_planes[..., :K].transpose(-1, -2).cpu()  # (.., J, K, N)
    lead = tuple(wq.shape[:-2])
    C = _pad_to(K, L) // L

    def chunk(v):                       # (..., K, N) -> (..., C, L, N)
        v = torch.nn.functional.pad(v.to(torch.float32),
                                    (0, 0, 0, C * L - K))
        return v.reshape(*v.shape[:-2], C, L, N)
    Np, Kp = _ref_weight_blocks(K, N, L)
    block = lambda v: torch.nn.functional.pad(
        v, (0, Np - N, 0, Kp - K)).to(torch.int8)
    J = planes.shape[-3]
    gemm_planes = (torch.cat([chunk(planes[..., j, :, :]) for j in range(J)],
                             dim=-2) if J else
                   torch.zeros((*lead, C, 0, N), dtype=torch.float32))
    out = {"scale": p.scale.cpu(),
           "sign": torch.where(wq < 0, -1, 1).to(torch.int8),
           "mag": wq.abs().to(torch.int8),
           "gemm_w": chunk(wq), "gemm_planes": gemm_planes,
           "pallas_w": block(wq), "pallas_planes": block(planes)}
    return {k: out[k].numpy() for k in PACK_FIELDS}


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # npz round-trip safe staging
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(tree):
        if isinstance(leaf, PackedCimWeights):
            for f, arr in _pack_fields(leaf).items():
                flat[f"{key}/{f}"] = arr
        else:
            flat[key] = _array(leaf)
    return flat


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None,
         keep_last: int = 3, background: bool = False):
    """Atomic checkpoint of a tree (the leaves are copied to the host
    before a background save starts)."""
    flat = _flatten(tree)

    def _save():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"tmp.{step}")
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep_last)

    if background:
        t = threading.Thread(target=_save, daemon=False)
        t.start()
        return t
    _save()
    return None


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _open_npz(path: str):
    """Open a checkpoint archive, normalising every way a short write or
    disk corruption surfaces (bad zip directory, truncated member) into
    one clear CheckpointError."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint archive at {path}")
    try:
        return np.load(path)
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint archive {path} is truncated or corrupt "
            f"({type(e).__name__}: {e}); the save was interrupted after "
            "the atomic rename or the file was damaged on disk -- fall "
            "back to an earlier step") from e


def _read_leaf(data, path: str, key: str) -> np.ndarray:
    """Read one leaf array, converting a truncated member (zlib/zip error
    mid-decompress) into a CheckpointError naming the leaf."""
    try:
        return data[key]
    except KeyError:
        raise CheckpointError(
            f"checkpoint {path} is missing leaf {key!r}: the target pytree "
            "structure does not match what was saved (stale code, wrong "
            "arch, or a partially-written archive). "
            f"Archive holds {len(data.files)} leaves.") from None
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {path}: leaf {key!r} is unreadable "
            f"({type(e).__name__}: {e}) -- the archive is truncated or "
            "corrupt") from e


def _shape_checked(data, path: str, key: str, shape) -> np.ndarray:
    arr = _read_leaf(data, path, key)
    if arr.shape != tuple(shape):
        raise CheckpointError(
            f"checkpoint {path}: leaf {key!r} has shape {arr.shape} "
            f"but the restore target expects {tuple(shape)} -- "
            "the checkpoint was written for a different model/plan "
            "configuration")
    return arr


def _restore_pack(data, path: str, key: str, p: PackedCimWeights,
                  device) -> PackedCimWeights:
    """A pack from its stored scale and block-padded int8 weights and
    planes, cut to the target's logical K x N, in the port's layout."""
    K, N = p.k_dim, p.n_dim
    lead = tuple(p.scale.shape[:-2])
    Np, Kp = _ref_weight_blocks(K, N, p.cfg.acc_len)
    J = p.kernel_planes.shape[-3]
    scale = _shape_checked(data, path, f"{key}/scale", p.scale.shape)
    w = _shape_checked(data, path, f"{key}/pallas_w", (*lead, Kp, Np))
    planes = _shape_checked(data, path, f"{key}/pallas_planes",
                            (*lead, J, Kp, Np))
    kp = p.kernel_w.shape[-1]

    def lay(v):                         # (..., Kp_ref, Np) -> (..., N, Kp)
        t = torch.from_numpy(np.ascontiguousarray(v[..., :K, :N]))
        t = torch.nn.functional.pad(t.transpose(-1, -2), (0, kp - K))
        return t.to(device, torch.int8).contiguous()
    return PackedCimWeights(
        scale=torch.from_numpy(np.array(scale, np.float32)).to(device),
        kernel_w=lay(w), kernel_planes=lay(planes), k_dim=K, n_dim=N,
        cfg=p.cfg)


def _rebuild(tree, new: Dict[str, Any], path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, FusedPackedCimWeights):
        return FusedPackedCimWeights(
            packed=_rebuild(tree.packed, new, path + ("packed",)),
            seg_names=tree.seg_names, seg_dims=tree.seg_dims)
    return new["/".join(path)]


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            device=None) -> Any:
    """Restore into the structure of ``target``, each leaf in the target
    leaf's dtype on ``device`` (default: the target leaf's device).

    Raises ``CheckpointError`` (never a bare KeyError from deep inside)
    when the archive is truncated/corrupt, a target leaf is absent from
    it, or a leaf's stored shape disagrees with the target -- each error
    names the offending leaf path.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "state.npz")
    data = _open_npz(path)
    new = {}
    for key, leaf in _items(target):
        if isinstance(leaf, PackedCimWeights):
            dev = device if device is not None else leaf.scale.device
            new[key] = _restore_pack(data, path, key, leaf, dev)
        elif isinstance(leaf, torch.Tensor):
            arr = _shape_checked(data, path, key, leaf.shape)
            dev = device if device is not None else leaf.device
            new[key] = torch.from_numpy(np.array(arr)).to(dev, leaf.dtype)
        else:
            new[key] = type(leaf)(_shape_checked(data, path, key,
                                                 np.shape(leaf)))
    return _rebuild(target, new)


def verify(ckpt_dir: str, step: Optional[int] = None,
           target: Any = None) -> Dict[str, Any]:
    """Round-trip integrity check of one checkpoint, without restoring.

    Fully decompresses every stored leaf (catching truncation anywhere in
    the archive, not just a bad central directory), parses meta.json, and
    -- when ``target`` is given -- diffs the stored key set and shapes
    against the target tree.  Returns a summary dict; raises
    ``CheckpointError`` on the first problem found.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "state.npz")
    data = _open_npz(path)
    n_bytes = 0
    shapes: Dict[str, tuple] = {}
    for key in data.files:
        arr = _read_leaf(data, path, key)   # full decompress
        shapes[key] = arr.shape
        n_bytes += arr.nbytes
    try:
        meta = load_meta(ckpt_dir, step)
    except (FileNotFoundError, json.JSONDecodeError) as e:
        raise CheckpointError(
            f"checkpoint step {step} in {ckpt_dir}: meta.json is missing "
            f"or unparsable ({e})") from e
    if meta.get("step") != step:
        raise CheckpointError(
            f"checkpoint {path}: meta.json records step {meta.get('step')} "
            f"but the directory is step_{step:010d}")
    report = dict(step=step, n_leaves=len(shapes), n_bytes=n_bytes,
                  meta=meta, ok=True)
    if target is not None:
        want = {k: tuple(v.shape) for k, v in _flatten(target).items()}
        missing = sorted(set(want) - set(shapes))
        extra = sorted(set(shapes) - set(want))
        if missing or extra:
            raise CheckpointError(
                f"checkpoint {path}: pytree structure mismatch -- "
                f"missing leaves {missing[:5]}{'...' if len(missing) > 5 else ''}, "
                f"unexpected leaves {extra[:5]}{'...' if len(extra) > 5 else ''}")
        for key, shape in want.items():
            if shapes[key] != shape:
                raise CheckpointError(
                    f"checkpoint {path}: leaf {key!r} stored shape "
                    f"{shapes[key]} != target shape {shape}")
        report["target_leaves_matched"] = len(want)
    return report


def load_meta(ckpt_dir: str, step: Optional[int] = None) -> dict:
    step = step if step is not None else latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"step_{step:010d}", "meta.json")) as f:
        return json.load(f)
