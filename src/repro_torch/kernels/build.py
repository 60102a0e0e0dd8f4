"""Builds the hand-written CUDA sources under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>-<hash>.so`` at
the repository root (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``), keyed by the hash of the source and of the
shared headers ``csrc/*.cuh`` so that an edited source or header is
rebuilt, and is loaded with ``ctypes``.  The sources
include no PyTorch header, so a build takes seconds.  Nothing is built or
loaded at import time.

Each library also exports the kernel lint's launch notes (``csrc/lint.cuh``):
:func:`record_launches` turns them on and :func:`launch_notes` reads each
noted launch back with the kernel's attributes on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Union

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("conv", "psg_matmul", "flash_attn", "quant",    # csrc/<name>.cu
           "graph_cond")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compile every named source that has no current library, all ``nvcc``
    processes at once, and return the library paths.  Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(log, end="")
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {n}.cu:\n{log}")
            continue
        os.replace(tmp, paths[n])      # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build([name])[name]))


# the prefix of each library's LINT_EXPORTS (csrc/lint.cuh)
LINT_PREFIX = {"conv": "conv", "psg_matmul": "psg", "flash_attn": "flash",
               "quant": "quant", "graph_cond": "graph_cond"}
# lint::attrs's outputs, in order
NOTE_FIELDS = ("regs", "static_smem", "dynamic_smem", "max_dynamic_smem",
               "local_bytes", "max_threads", "blocks_per_sm", "threads",
               "variant")


def _lint_fn(name: str, fn: str):
    f = getattr(load(name), f"{LINT_PREFIX[name]}_lint_{fn}")
    f.restype = ctypes.c_char_p if fn == "name" else ctypes.c_int
    f.argtypes = {"record": [ctypes.c_int], "count": [],
                  "name": [ctypes.c_int],
                  "attrs": [ctypes.c_int, ctypes.c_void_p]}[fn]
    return f


def record_launches(name: str, on: bool) -> None:
    """Start (clearing the old notes) or stop noting the launches of
    library ``name``."""
    _lint_fn(name, "record")(int(on))


def launch_notes(name: str) -> List[Dict[str, Union[str, int]]]:
    """Every launch library ``name`` noted since :func:`record_launches`:
    the ``__global__`` function's name and :data:`NOTE_FIELDS`.  Raises
    when the notes overflowed or an attribute query failed."""
    n = _lint_fn(name, "count")()
    if n > 1024:
        raise RuntimeError(f"{name}: {n} launches noted, past the 1024 "
                           "lint.cuh keeps")
    attrs, get_name = _lint_fn(name, "attrs"), _lint_fn(name, "name")
    out = []
    for i in range(n):
        buf = (ctypes.c_longlong * len(NOTE_FIELDS))()
        err = attrs(i, ctypes.addressof(buf))
        if err:
            raise RuntimeError(f"{name}: attributes of launch {i}: CUDA "
                               f"error {err}")
        out.append({"global": get_name(i).decode(),
                    **dict(zip(NOTE_FIELDS, (int(v) for v in buf)))})
    return out
