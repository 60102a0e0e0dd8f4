"""Checkpoint save/restore: npz files and a JSON manifest, in the JAX
package's format, so a checkpoint either package writes, the other
restores.

* The npz keys are the ``::``-joined key paths of JAX's
  ``tree_flatten_with_path`` over the JAX package's ``TrainState``
  (``params::stages::0::trans::conv1::w``, ``opt::momentum::...``,
  ``swa::count``, ``step``, ``model_state::...``), with its shapes and
  dtypes; a port ``TrainState`` goes through ``convert.train_state_tree``
  and comes back through ``convert.load_train_state``, onto its devices.
  Any other tree of dicts, lists and arrays or tensors is saved as it is.
* Saves are atomic (tmp file + rename) and optionally async (a daemon
  thread writes; the device-to-host copy is the only part on the caller's
  path).
* The **manifest is the commit record**: written atomically after the npz
  landed, it carries a per-leaf CRC32 next to dtypes and shapes, so a
  checkpoint is *intact* only when the manifest exists, every manifest leaf
  is in the npz and every checksum matches.  A crash between the two
  renames leaves a detectable partial save.
* Restore verifies integrity and falls back to the newest intact step
  instead of loading a truncated or corrupted save.
* The writer retries with backoff and surfaces terminal failures:
  ``wait_for_saves`` raises :class:`CheckpointWriteError`, and a failed
  sync save raises it at once.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import (children, leaves, load_train_state, to_numpy,
                                 train_state_tree)

_SEP = "::"
_pending: Dict[str, threading.Thread] = {}
# path -> terminal exception of a failed (post-retry) async write; never
# dropped silently: wait_for_saves() turns these into CheckpointWriteError
_errors: Dict[str, BaseException] = {}
_errors_lock = threading.Lock()

# indirection so ft/faults.py can inject write failures (disk full, flaky
# storage) without patching numpy
_savez = np.savez

MANIFEST_SUFFIX = ".manifest.json"
WRITE_RETRIES = 3          # attempts per save (1 + 2 retries)
WRITE_BACKOFF_S = 0.05     # doubles per retry


class CheckpointWriteError(RuntimeError):
    """One or more checkpoint writes failed terminally (post-retry)."""

    def __init__(self, failures: Dict[str, BaseException]):
        self.failures = dict(failures)
        detail = "; ".join(f"{os.path.basename(p)}: {e!r}"
                           for p, e in sorted(self.failures.items()))
        super().__init__(f"{len(self.failures)} checkpoint write(s) failed: "
                         f"{detail}")


def _is_train_state(x: Any) -> bool:
    return hasattr(x, "model") and hasattr(x, "opt")


def _tree(state: Any) -> Any:
    return train_state_tree(state) if _is_train_state(state) else state


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    """The npz entries of ``tree``: ``::``-joined key paths, host arrays."""
    return {_SEP.join(path): to_numpy(leaf) for path, leaf in leaves(tree)}


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, (dict, list, tuple)):
        return {k: _skeleton(v) for k, v in children(tree)}
    return None if tree is None else "*"


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, state: Any, step: int,
                    async_save: bool = False) -> str:
    """Save ``state`` (a ``TrainState`` or a tree) as step ``step``;
    returns the npz path.  A failed sync save raises
    :class:`CheckpointWriteError`; a failed async one surfaces through
    :func:`wait_for_saves`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = _tree(state)
    flat = _flatten(tree)              # device-to-host copy happens here
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "crc32": _leaf_crc(v)}
                   for k, v in flat.items()},
        "treedef": json.dumps(_skeleton(tree)),
    }
    path = _ckpt_path(ckpt_dir, step)
    if path in _pending:           # same step already being written
        return path

    def _write_once():
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
        try:
            _savez(tmp, **flat)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        # the manifest rename COMMITS the checkpoint: readers treat a
        # manifest-less npz as an in-flight or partial save
        mtmp = path + ".manifest.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, path + MANIFEST_SUFFIX)

    def _write():
        delay = WRITE_BACKOFF_S
        for attempt in range(WRITE_RETRIES):
            try:
                _write_once()
                return
            except OSError as e:
                if attempt == WRITE_RETRIES - 1:
                    with _errors_lock:
                        _errors[path] = e
                    return
                time.sleep(delay)
                delay *= 2

    if async_save:
        th = threading.Thread(target=_write, daemon=True)
        th.start()
        _pending[path] = th
    else:
        _write()
        with _errors_lock:
            err = _errors.pop(path, None)
        if err is not None:
            raise CheckpointWriteError({path: err})
    return path


def _join_pending() -> None:
    for th in list(_pending.values()):
        th.join()
    _pending.clear()


def wait_for_saves(raise_on_error: bool = True) -> Dict[str, BaseException]:
    """Join every in-flight async write.

    A failed write (post-retry) is surfaced, never a silently dead daemon
    thread: by default this raises :class:`CheckpointWriteError` with every
    failure since the last call; with ``raise_on_error=False`` it returns
    and consumes the failures instead (the trainer's final save reports
    them rather than crash).
    """
    _join_pending()
    with _errors_lock:
        failures = dict(_errors)
        _errors.clear()
    if failures and raise_on_error:
        raise CheckpointWriteError(failures)
    return failures


def _steps(ckpt_dir: str) -> List[int]:
    # strict match: in-flight writes park as step_XXXXXXXX.npz.<pid>.<tid>
    # .tmp.npz (np.savez forces the suffix), which must not read as a step
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  for m in [re.fullmatch(r"step_(\d+)\.npz", f)] if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------


def verify_checkpoint(ckpt_dir: str, step: int) -> Tuple[bool, str]:
    """``(intact, reason)`` for one saved step.

    Checks, in order: npz present, manifest present (the commit record),
    npz readable (truncation shows here), every manifest leaf present with
    its shape and dtype, every per-leaf CRC32 matching.  ``reason`` names
    the first failure.
    """
    path = _ckpt_path(ckpt_dir, step)
    if not os.path.exists(path):
        return False, "missing npz"
    mpath = path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return False, "missing manifest (uncommitted/partial save)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e!r}"
    leaves = manifest.get("leaves", {})
    try:
        with np.load(path) as data:
            missing = set(leaves) - set(data.files)
            if missing:
                return False, f"missing leaves: {sorted(missing)[:5]}"
            for key, meta in leaves.items():
                arr = data[key]
                if list(arr.shape) != list(meta["shape"]) or \
                        str(arr.dtype) != meta["dtype"]:
                    return False, f"leaf {key}: shape/dtype mismatch"
                if "crc32" in meta and _leaf_crc(arr) != meta["crc32"]:
                    return False, f"leaf {key}: checksum mismatch"
    except (OSError, ValueError, zlib.error, zipfile.BadZipFile,
            EOFError, KeyError) as e:
        return False, f"unreadable npz (truncated/corrupt): {e!r}"
    return True, "ok"


def intact_steps(ckpt_dir: str) -> List[int]:
    """All verified-intact steps in ``ckpt_dir``, ascending."""
    return [s for s in _steps(ckpt_dir) if verify_checkpoint(ckpt_dir, s)[0]]


def latest_intact_step(ckpt_dir: str) -> Optional[int]:
    """Newest step that passes verification: the step a restart resumes
    from (``ft/supervisor.py``)."""
    steps = intact_steps(ckpt_dir)
    return steps[-1] if steps else None


def resume_chunk_start(ckpt_dir: str,
                       step: Optional[int] = None) -> Optional[int]:
    """First nominal step a resumed run executes: ``s + 1`` after a save at
    nominal step ``s`` (the JAX package's chunked loop saves on chunk
    boundaries and plans chunks from there).  ``None`` when the directory
    holds no checkpoint, so a fresh run is told apart from a resume at
    step 0."""
    s = step if step is not None else latest_step(ckpt_dir)
    return None if s is None else s + 1


def _unflatten(like: Any, data, prefix: str = "") -> Any:
    if like is None:
        return None
    if isinstance(like, (dict, list, tuple)):
        out = {k: _unflatten(v, data, f"{prefix}{_SEP}{k}" if prefix else k)
               for k, v in children(like)}
        if isinstance(like, dict):
            return {k: out[str(k)] for k in like}
        return type(like)(out[str(i)] for i in range(len(like)))
    arr = data[prefix]
    if tuple(arr.shape) != tuple(np.shape(like)):
        raise ValueError(f"{prefix}: shape {arr.shape} != {tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
    return arr.astype(np.asarray(like).dtype)


def restore_checkpoint(ckpt_dir: str, like: Any,
                       step: Optional[int] = None,
                       verify: bool = True) -> Tuple[Any, int]:
    """Restore into the structure of ``like``; returns ``(restored,
    step)``.

    A ``TrainState`` is restored in place (module, optimizer and SWA
    tensors on their devices) and returned; any other tree comes back as a
    new tree of ``like``'s leaf types and dtypes.  With ``verify=True``
    (default) a truncated, corrupt or partial save is detected by the
    manifest and restore falls back to the newest earlier intact step;
    ``FileNotFoundError`` only when no intact checkpoint exists at or
    before ``step``.  ``verify=False`` restores the raw requested or
    latest step (shapes still checked).
    """
    # join in-flight writes but keep their failure records: a failed save
    # is simply no intact candidate, and the failure still reaches the
    # next wait_for_saves() caller
    _join_pending()
    if verify:
        candidates = intact_steps(ckpt_dir)
        if step is not None:
            candidates = [s for s in candidates if s <= step]
        if not candidates:
            raise FileNotFoundError(
                f"no intact checkpoint in {ckpt_dir}"
                + (f" at or before step {step}" if step is not None else ""))
        step = candidates[-1]
    else:
        step = step if step is not None else latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    like_tree = _tree(like)
    with np.load(_ckpt_path(ckpt_dir, step)) as data:
        missing = set(_flatten(like_tree)) - set(data.files)
        if missing:
            raise ValueError(f"checkpoint missing leaves: "
                             f"{sorted(missing)[:5]}")
        tree = _unflatten(like_tree, data)
    if _is_train_state(like):
        return load_train_state(like, tree), step
    return tree, step
