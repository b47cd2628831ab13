"""Checkpointing: flat-key .npz store for params/opt-state + JSON metadata.

No orbax offline; this implements atomic-rename checkpoints with step
retention, which is what the training driver needs.

Every array file's sha256 + byte length is recorded in `meta.json` at
save time and verified on restore: a truncated or bit-flipped newest
checkpoint makes `restore()` fall back to the latest earlier step that
verifies (with a warning) instead of resuming from garbage. An
explicitly requested `step=` stays strict and raises. Checkpoints
written before digests existed carry no record and load as before.

The counterpart of `repro.checkpoint.store`, without jax. A tree is
nested dicts, lists and tuples whose leaves are numpy arrays or torch
tensors; its keys are the ones `jax.tree_util.tree_flatten_with_path`
gives (dict keys sorted, `.name` for the fields of a NamedTuple, `#i`
for the indices of other sequences, joined by "::"), and
bfloat16 is stored as its `uint16` bits, so the files of either package
restore through the other's store. `restore` follows the template: a
numpy leaf comes back as numpy of that leaf's dtype (no float64
truncation), a tensor leaf as a tensor of its dtype on its device.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import warnings

import numpy as np
import torch

_SEP = "::"


def _keys(seq) -> list[str]:
    """The path keys of a sequence's entries: `.field` for a NamedTuple's
    fields in declaration order (jax's `GetAttrKey`), else `#i`."""
    if hasattr(seq, "_fields"):
        return [f".{name}" for name in seq._fields]
    return [f"#{i}" for i in range(len(seq))]


def _leaves(tree, path=()):
    """(path, leaf) pairs in `tree_flatten_with_path`'s order: dict keys
    sorted, a NamedTuple's fields by name, other sequences by index, None
    holding no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for key, sub in zip(_keys(tree), tree):
            yield from _leaves(sub, path + (key,))
    elif tree is not None:
        yield _SEP.join(path), tree


def _is_bf16(dtype) -> bool:
    """torch.bfloat16, or a numpy bfloat16 (ml_dtypes) dtype."""
    return dtype == torch.bfloat16 or getattr(dtype, "name", "") == "bfloat16"


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            # npz has no bf16: store the raw bits; restore() re-views via
            # the template dtype.
            arr = (leaf.view(torch.int16).numpy().view(np.uint16)
                   if leaf.dtype == torch.bfloat16 else leaf.numpy())
        else:
            arr = np.asarray(leaf)
            if _is_bf16(arr.dtype):
                arr = arr.view(np.uint16)
        flat[key] = arr
    return flat


def _restore_leaf(leaf, arr: np.ndarray):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(dtype=leaf.dtype, device=leaf.device)
    dtype = np.asarray(leaf).dtype
    if _is_bf16(dtype) and arr.dtype == np.uint16:
        arr = arr.view(dtype)
    # numpy template leaf: restore as numpy, dtype preserved (float64
    # state stays float64, so a resume is bit-exact).
    return np.asarray(arr, dtype=dtype)


def _rebuild(template, data, path=()):
    """`template`'s structure with each leaf read from `data`."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], data, path + (str(k),))
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(sub, data, path + (key,))
               for key, sub in zip(_keys(template), template)]
        if isinstance(template, list):
            return out
        if hasattr(template, "_fields"):
            return type(template)(*out)
        return type(template)(out)
    if template is None:
        return None
    return _restore_leaf(template, data[_SEP.join(path)])


def save(directory: str, step: int, params, opt_state=None, extra: dict | None = None,
         keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory)
    files = ["params.npz"]
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
    if opt_state is not None:
        files.append("opt_state.npz")
        np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
    digests = {n: _digest(os.path.join(tmp, n)) for n in files}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {}), "digests": digests}, f)
    final = os.path.join(directory, f"step_{step:08d}")
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _digest(path: str) -> dict:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return {"sha256": h.hexdigest(), "bytes": os.path.getsize(path)}


def _verify(directory: str, step: int, name: str) -> str | None:
    """Check `name` in checkpoint `step` against its recorded digest.
    Returns a human-readable defect description, or None when the file
    passes (or predates digest records)."""
    stepdir = os.path.join(directory, f"step_{step:08d}")
    path = os.path.join(stepdir, name)
    if not os.path.isfile(path):
        return f"missing {name}"
    try:
        with open(os.path.join(stepdir, "meta.json")) as f:
            rec = json.load(f).get("digests", {}).get(name)
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable meta.json ({e})"
    if rec is None:
        return None
    size = os.path.getsize(path)
    if size != rec["bytes"]:
        return f"{name} is {size} bytes, expected {rec['bytes']}"
    if _digest(path)["sha256"] != rec["sha256"]:
        return f"{name} does not match its recorded sha256"
    return None


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if re.fullmatch(r"step_\d{8}", d))
    for d in ckpts[:-keep]:
        full = os.path.join(directory, d)
        for f in os.listdir(full):
            os.unlink(os.path.join(full, f))
        os.rmdir(full)


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d[5:]) for d in os.listdir(directory)
                  if re.fullmatch(r"step_\d{8}", d))


def latest_step(directory: str) -> int | None:
    ckpts = _steps(directory)
    return ckpts[-1] if ckpts else None


def restore(directory: str, template, step: int | None = None,
            name: str = "params.npz"):
    """Restore a pytree matching `template`'s structure.

    Without `step=`, the newest checkpoint is digest-verified first; if
    it is corrupt (truncated write, bit rot) the newest *earlier* step
    that verifies is restored instead, with a warning. An explicit
    `step=` is strict: a failed check raises `ValueError`.
    """
    explicit = step is not None
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    defect = _verify(directory, step, name)
    if defect is not None:
        if explicit:
            raise ValueError(f"checkpoint step {step} in {directory} "
                             f"failed verification: {defect}")
        for cand in reversed(_steps(directory)[:-1]):
            if _verify(directory, cand, name) is None:
                warnings.warn(
                    f"newest checkpoint (step {step}) in {directory} "
                    f"failed verification: {defect}; falling back to "
                    f"step {cand}", RuntimeWarning, stacklevel=2)
                step = cand
                break
        else:
            raise ValueError(
                f"checkpoint step {step} in {directory} failed "
                f"verification ({defect}) and no earlier step verifies")
    path = os.path.join(directory, f"step_{step:08d}", name)
    with np.load(path) as data:
        return _rebuild(template, data)


def meta(directory: str, step: int | None = None) -> dict:
    step = step if step is not None else latest_step(directory)
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
