"""Repository convention linter over ``src/repro_torch`` (AST-based, no
imports executed).

The counterpart of the JAX package's ``analysis/repo_lint.py``, its four
rules re-read for the port:

* ``kernel-outside-kernels`` (the reference's ``pallas-outside-kernels``)
  — only modules under ``kernels/`` may call ``build.load``,
  ``ctypes.CDLL`` or ``triton.jit`` (or import ``load`` from
  ``kernels/build``).  Everything else goes through the wrappers and the
  dispatch layer, which keeps the launch counters and the linters'
  registry (``kernels/dispatch.shipped_kernels``) exhaustive.
* ``env-read`` — no module reads a ``REPRO_TORCH_*`` (or ``REPRO_*``)
  environment variable except the one import-time read of
  ``REPRO_TORCH_KERNEL_BACKEND`` in ``kernels/dispatch.py``.
* ``host-sync`` — device-to-host reads (``.item()``, ``.cpu()``,
  ``.tolist()``, ``torch.cuda.synchronize``, and ``float(...)`` /
  ``bool(...)`` of an expression that calls a tensor reduction or method
  such as ``.max()``, ``.all()`` or ``.float()``, or any ``torch.`` function)
  are confined to ``training/`` and ``launch/``.  The chunked loop's
  throughput rests on one sync per chunk; a stray read in a model or
  kernel module brings back the per-step stall.  An AST cannot type a
  value, so ``float(name)`` of a bare name passes: the rule catches the
  reads it can see.  Modules that are host-side by design are allowlisted
  with a justification.
* ``swallowed-exception`` — bare ``except:``, and ``except
  Exception/BaseException`` whose body only passes, are forbidden.

Run as a module (``python -m repro_torch.analysis.repo_lint``) it exits
nonzero on any finding.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PKG = "repro_torch"
_KERNELS_PREFIX = f"{PKG}/kernels/"
# the one sanctioned REPRO_* read: (file, variable)
_ENV_ALLOWED = {(f"{PKG}/kernels/dispatch.py", "REPRO_TORCH_KERNEL_BACKEND")}
_HOST_SYNC_ALLOWED_PREFIXES = (f"{PKG}/training/", f"{PKG}/launch/")
# file -> justification: modules that are host-side by design.  An entry
# REQUIRES a justification (enforced by lint_source).
_HOST_SYNC_ALLOWED: Dict[str, str] = {
    f"{PKG}/serving/engine.py":
        "the wave-batched engine reads its greedy tokens back once a wave, "
        "the reference's host decode",
    f"{PKG}/convert.py":
        "converting to and from the JAX package's trees and checkpoints is "
        "host numpy by definition",
    f"{PKG}/core/slu.py":
        "an eager gated block decides on the host (one read of p a gated "
        "block); inside a captured chunk the IF node decides on the card",
    f"{PKG}/kernels/conv.py":
        "the padded-grid emulation of kernels 3-4 checks each int32 "
        "partial on the host; a test helper, on no path",
    f"{PKG}/analysis/kernel_lint.py":
        "the kernel lint compares the card's outputs with the plain "
        "versions on the host, after a synchronize, outside any step",
    f"{PKG}/analysis/hotloop_lint.py":
        "the hot-loop lint waits for each chunk it checks at the chunk's "
        "boundary, where the chunked loop itself syncs",
}
# file -> justification: modules allowed to swallow exceptions broadly
_SWALLOW_ALLOWED: Dict[str, str] = {}

_SYNC_METHODS = ("item", "cpu", "tolist")
_TENSOR_METHODS = frozenset({
    "max", "min", "sum", "mean", "amax", "amin", "all", "any", "norm",
    "abs", "detach", "float", "double", "item", "prod", "std", "var",
    "argmax", "argmin", "count_nonzero"})
_HOST_MODULES = frozenset({"np", "numpy", "math", "os", "sys"})


@dataclass(frozen=True)
class RepoFinding:
    path: str          # src-root-relative, posix
    line: int
    rule: str          # "kernel-outside-kernels" | "env-read" | "host-sync"
                       # | "swallowed-exception"
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute/name chain (``os.environ.get``), or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _env_var_of(node: ast.AST) -> Optional[Tuple[str, int]]:
    """(REPRO_* name, lineno) if this node reads such an env var."""
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func) or ""
        if chain.endswith("os.getenv") or chain == "getenv" \
                or chain.endswith("environ.get"):
            if node.args:
                name = _const_str(node.args[0])
                if name and name.startswith("REPRO_"):
                    return name, node.lineno
    if isinstance(node, ast.Subscript):
        chain = _attr_chain(node.value) or ""
        if chain.endswith("os.environ") or chain == "environ":
            name = _const_str(node.slice)
            if name and name.startswith("REPRO_"):
                return name, node.lineno
    return None


def _tensorish(node: ast.AST) -> bool:
    """Whether an expression visibly computes on a tensor: a ``torch.``
    call, or a tensor method call on anything but a host module."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        chain = _attr_chain(sub.func) or ""
        if chain.startswith("torch."):
            return True
        if isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _TENSOR_METHODS \
                and _root(sub.func.value) not in _HOST_MODULES:
            return True
    return False


def _host_sync_of(node: ast.AST) -> Optional[Tuple[str, int]]:
    """(description, lineno) if this node is a device-to-host read."""
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS and not node.args:
        return f".{node.func.attr}()", node.lineno
    chain = _attr_chain(node.func) or ""
    if chain.endswith("cuda.synchronize"):
        return "torch.cuda.synchronize", node.lineno
    if isinstance(node.func, ast.Name) and node.func.id in ("float", "bool") \
            and len(node.args) == 1 and _tensorish(node.args[0]):
        return f"{node.func.id}(tensor)", node.lineno
    return None


def _kernel_call_of(node: ast.AST) -> Optional[Tuple[str, int]]:
    """(description, lineno) if this node builds, loads or jits a kernel."""
    if isinstance(node, ast.ImportFrom) and node.module == \
            f"{PKG}.kernels.build" and any(a.name == "load"
                                           for a in node.names):
        return "import of kernels.build.load", node.lineno
    if isinstance(node, (ast.Call, ast.Attribute)):
        target = node.func if isinstance(node, ast.Call) else node
        chain = _attr_chain(target) or ""
        for name in ("build.load", "ctypes.CDLL", "triton.jit"):
            if chain == name or chain.endswith("." + name):
                return name, node.lineno
    return None


def check_allowlist(allowed: Dict[str, str], what: str) -> None:
    """Every allowlist entry must carry a justification."""
    for path, why in allowed.items():
        if not (isinstance(why, str) and why.strip()):
            raise ValueError(f"{what} allowlist entry {path!r} has no "
                             "justification")


_BROAD_EXC = ("Exception", "BaseException")


def _swallow_of(node: ast.AST) -> Optional[Tuple[str, int]]:
    """(description, lineno) if this except handler swallows broadly: a
    bare ``except:``, or ``except Exception/BaseException`` whose body only
    passes."""
    if not isinstance(node, ast.ExceptHandler):
        return None
    if node.type is None:
        return "bare except:", node.lineno
    types = node.type.elts if isinstance(node.type, ast.Tuple) \
        else [node.type]
    names = [t.id if isinstance(t, ast.Name) else
             (t.attr if isinstance(t, ast.Attribute) else "")
             for t in types]
    broad = next((n for n in names if n in _BROAD_EXC), None)
    if broad is None:
        return None
    body_is_noop = all(
        isinstance(st, ast.Pass)
        or (isinstance(st, ast.Expr) and isinstance(st.value, ast.Constant))
        for st in node.body)
    if body_is_noop:
        return f"except {broad}: pass", node.lineno
    return None


def lint_source(src: str, relpath: str,
                host_sync_allowed: Optional[Dict[str, str]] = None,
                swallow_allowed: Optional[Dict[str, str]] = None
                ) -> List[RepoFinding]:
    """Lint one module's source text (``relpath`` is src-root-relative)."""
    host_al = _HOST_SYNC_ALLOWED if host_sync_allowed is None \
        else host_sync_allowed
    swallow_al = _SWALLOW_ALLOWED if swallow_allowed is None \
        else swallow_allowed
    check_allowlist(host_al, "host-sync")
    check_allowlist(swallow_al, "swallowed-exception")
    findings: List[RepoFinding] = []
    tree = ast.parse(src, filename=relpath)
    in_kernels = relpath.startswith(_KERNELS_PREFIX)
    host_ok = (relpath.startswith(_HOST_SYNC_ALLOWED_PREFIXES)
               or relpath in host_al)
    seen = set()
    for node in ast.walk(tree):
        kern = _kernel_call_of(node)
        if kern is not None and not in_kernels and kern not in seen:
            seen.add(kern)
            findings.append(RepoFinding(
                relpath, kern[1], "kernel-outside-kernels",
                f"{kern[0]} outside kernels/ — launch kernels through "
                "their wrappers and repro_torch.kernels.dispatch"))
        sync = _host_sync_of(node)
        if sync is not None and not host_ok:
            what, line = sync
            findings.append(RepoFinding(
                relpath, line, "host-sync",
                f"{what} outside training/ and launch/ — device-to-host "
                "reads belong to the loop boundary (one per chunk); "
                "host-side-by-design modules need a justified "
                "_HOST_SYNC_ALLOWED entry"))
        swallow = _swallow_of(node)
        if swallow is not None and relpath not in swallow_al:
            what, line = swallow
            findings.append(RepoFinding(
                relpath, line, "swallowed-exception",
                f"{what} — errors must surface; catch the specific "
                "exception or add a justified _SWALLOW_ALLOWED entry"))
        env = _env_var_of(node)
        if env is not None and (relpath, env[0]) not in _ENV_ALLOWED:
            findings.append(RepoFinding(
                relpath, env[1], "env-read",
                f"reads {env[0]} — environment selection belongs to the "
                "single import-time read in kernels/dispatch.py"))
    return findings


def _src_root() -> str:
    # .../src/repro_torch/analysis/repo_lint.py -> .../src
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def lint_repo(src_root: Optional[str] = None) -> List[RepoFinding]:
    """Lint every ``.py`` under ``<src_root>/repro_torch``; [] means clean."""
    root = src_root or _src_root()
    findings: List[RepoFinding] = []
    for dirpath, _dirnames, filenames in os.walk(os.path.join(root, PKG)):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                findings.extend(lint_source(f.read(), rel))
    return sorted(findings, key=lambda f: (f.path, f.line))


def repo_report() -> dict:
    """The bench record's ``repo_lint`` section."""
    findings = [str(f) for f in lint_repo()]
    return {"findings": findings, "passed": not findings}


def main() -> int:
    findings = lint_repo()
    for f in findings:
        print(f)
    print(f"repo lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
