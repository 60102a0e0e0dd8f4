"""Conditional nodes of CUDA graphs: SLU's keep decision on the card, and
the IF nodes that skip a gated block inside a captured train step.

The port's counterpart of ``lax.cond`` in the JAX package's chunked loop
(``src/repro/models/resnet.py``, ``src/repro/core/slu.py``).  One kernel
source, ``csrc/graph_cond.cu``:

==============  ==========================================================
wrapper         computes
==============  ==========================================================
slu_decide      ``flag = force | (u < p)`` in fp32, and with a handle sets
                the handle of an IF node from ``flag[0]`` on the device
                (``slu_decide(0, flag)`` sets it again from a saved flag)
==============  ==========================================================

Given CPU tensors the wrapper computes the plain version; given CUDA
tensors it launches its kernel or raises.  Each launch adds one to
``LAUNCHES["slu_decide"]``.  No TPU kernel is replaced: the decision is the port's
own, and it keeps a captured step from reading a keep probability back to
the host.

:class:`CondGraph` builds IF nodes into a graph while a step is captured
(``torch.cuda.graph``): ``handle()`` creates a conditional handle in the
graph being captured, ``if_node(handle)`` is a context in which the work
that PyTorch launches lands in the node's body.  The body is captured from
a second stream, made PyTorch's current stream for the body, and the
body's allocations go to a private memory pool of the ``CondGraph``
(``torch._C``'s allocate-to-pool hooks, the same the graph capture uses),
so no block of the body is ever handed to other work while the graph
lives.  Needs CUDA 12.4 or later; there is no fallback.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = {"slu_decide": 0}

_P, _I, _LL, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("graph_cond")
    lib.graph_cond_versions.argtypes = [ctypes.POINTER(_I)] * 2
    lib.slu_decide.argtypes = [_P, _P, _I, _P, _LL, _ULL, _P]
    lib.graph_cond_handle.argtypes = [_P, ctypes.POINTER(_ULL)]
    lib.graph_if_open.argtypes = [_P, _P, _ULL]
    lib.graph_if_close.argtypes = [_P]
    for fn in (lib.graph_cond_versions, lib.slu_decide, lib.graph_cond_handle,
               lib.graph_if_open, lib.graph_if_close):
        fn.restype = _I
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err} from {what}")


def cuda_versions() -> Dict[str, int]:
    """The CUDA runtime version the library was built against and the
    driver's, as CUDA encodes them (12040 is 12.4)."""
    rt, drv = _I(), _I()
    _check(_lib().graph_cond_versions(ctypes.byref(rt), ctypes.byref(drv)),
           "graph_cond_versions")
    return {"runtime": rt.value, "driver": drv.value}


def slu_decide_plain(u: torch.Tensor, p: torch.Tensor, force: bool = False
                     ) -> torch.Tensor:
    """``force | (u < p)`` as fp32 0/1, ``u`` and ``p`` fp32 of one shape."""
    keep = u < p
    if force:
        keep = torch.ones_like(keep)
    return keep.float()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def slu_decide(u: torch.Tensor, p: torch.Tensor, force: bool = False,
               handle: int = 0) -> torch.Tensor:
    """The keep flags of uniforms ``u`` against probabilities ``p`` (fp32,
    same shape).  On the card, ``handle`` (from :meth:`CondGraph.handle`)
    is set from the first flag."""
    if u.device.type == "cpu" and p.device.type == "cpu":
        return slu_decide_plain(u, p, force)
    if u.device != p.device or u.device.type != "cuda":
        raise ValueError(f"slu_decide: u on {u.device}, p on {p.device}")
    if u.dtype != torch.float32 or p.dtype != torch.float32 or \
            u.shape != p.shape:
        raise ValueError("slu_decide takes fp32 u and p of one shape, got "
                         f"{u.dtype} {tuple(u.shape)}, {p.dtype} "
                         f"{tuple(p.shape)}")
    uc, pc = u.contiguous(), p.contiguous()
    flag = torch.empty_like(uc)
    _check(_lib().slu_decide(uc.data_ptr(), pc.data_ptr(), int(force),
                             flag.data_ptr(), uc.numel(), handle,
                             _stream(uc)), "slu_decide")
    LAUNCHES["slu_decide"] += 1
    return flag


# ---------------------------------------------------------------------------
# IF nodes in a graph being captured
# ---------------------------------------------------------------------------

def _pool_hooks():
    """``(begin, end, release)`` of the allocator's allocate-to-pool
    routing for the calling thread.  The forward's bodies are captured on
    the main thread and the backward's on autograd's device thread, each
    inside its own begin/end."""
    C = torch._C
    return (C._cuda_beginAllocateCurrentThreadToPool, C._cuda_endAllocateToPool,
            C._cuda_releasePool)


class CondGraph:
    """IF nodes for the graphs captured by one owner (a trainer): a body
    stream, a private memory pool for the bodies, and the count of pool
    uses to give back in :meth:`release`."""

    def __init__(self, device=None):
        self.device = torch.device(device or "cuda")
        self.index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self.body_stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.nodes = 0              # IF nodes built
        self._uses = 0
        self._lib = _lib()          # built and loaded before any capture

    def handle(self) -> int:
        """A conditional handle in the graph being captured on the current
        stream."""
        h = _ULL()
        _check(self._lib.graph_cond_handle(
            torch.cuda.current_stream(self.device).cuda_stream,
            ctypes.byref(h)), "graph_cond_handle")
        return h.value

    @contextlib.contextmanager
    def if_node(self, handle: int):
        """Work launched inside this context lands in the body of an IF
        node on ``handle``, which runs at replay when the handle is
        nonzero."""
        outer = torch.cuda.current_stream(self.device)
        _check(self._lib.graph_if_open(outer.cuda_stream,
                                       self.body_stream.cuda_stream, handle),
               "graph_if_open")
        begin, end, _ = _pool_hooks()
        try:
            with torch.cuda.stream(self.body_stream):
                begin(self.index, self.pool)
                self._uses += 1
                try:
                    yield
                finally:
                    end(self.index, self.pool)
        finally:
            _check(self._lib.graph_if_close(self.body_stream.cuda_stream),
                   "graph_if_close")
        self.nodes += 1

    def release(self) -> None:
        """Give the bodies' pool back; call once the graphs are gone."""
        _, _, release = _pool_hooks()
        for _ in range(self._uses):
            release(self.index, self.pool)
        self._uses = 0


_active = threading.local()


def active() -> Optional[CondGraph]:
    """The :class:`CondGraph` of the step being captured on this thread."""
    return getattr(_active, "cg", None)


@contextlib.contextmanager
def capturing(cg: CondGraph):
    """Mark ``cg`` as the builder of IF nodes for a capture on this
    thread."""
    prev = active()
    _active.cg = cg
    try:
        yield cg
    finally:
        _active.cg = prev
