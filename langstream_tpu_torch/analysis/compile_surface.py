"""LSA3xx — capture-surface lint: what the port's CUDA graphs capture.

The port serves every decode (and speculative verify) chunk as one replay
of a CUDA graph captured at ``start()`` (``serving/engine.py``). A replay
runs no host code: the captured body must never sync the host, never
build a tensor from a Python value on the card (a host-to-device copy the
capture refuses), and never rebind a buffer the graph holds by address.
On the CPU these chunks are never captured, so without this pass a host
sync on that path shows first as a failed capture on the card. The JAX
package's pass of this name lints ``jax.jit`` sites; this one keeps the
name (``--only compile_surface``) and is defined on the port's captures:

- LSA301  the capture registry (``CAPTURE_REGISTRY``): a module that
          calls ``torch.cuda.graph(``, ``torch.cuda.CUDAGraph(`` or
          ``torch.cuda.make_graphed_callables(`` and is not registered, a
          registered module whose site count drifted, or a stale row (a
          registered module with no site, or a captured body or buffer
          allocator it no longer defines)
- LSA302  host work inside a capture: in a captured body, or in any port
          function it reaches, ``.item()``, ``.tolist()``, ``.cpu()``,
          ``.numpy()``, ``torch.cuda.synchronize`` / ``.synchronize()``,
          or ``torch.tensor(`` / ``torch.as_tensor(`` of a host value
- LSA303  rebinding a captured buffer: inside a captured body (or a
          method of its class it reaches), ``self.<attr> = ...`` where the
          registry's allocator (``_alloc_decode_state``) binds ``<attr>``
          (augmented assignment is in place for a tensor and is not
          flagged)

"Reaches" is a call graph over names that resolve through the port's own
imports: a module-level function of the same module, a name imported from
a ``langstream_tpu_torch`` module (``from ... import f``, or ``m.f`` after
``from langstream_tpu_torch.x import m``), ``self.m(...)`` inside a
method (the same class), and a local bound to a conditional choice of
such names (``kernel = a_int8 if quantized else a; kernel(...)`` follows
both). It follows calls to ``REACH_DEPTH`` (10) below a body: the chunks'
deepest port call is 9 below (the decode step, the layer, the attention
dispatch and wrapper, the kernel launch, the library's build down to its
``nvcc`` lookup), so the walk is the whole closure today with one level
to spare. Method calls on other objects and calls through other
variables are not followed.

A host value for ``torch.tensor(`` is anything: its data is always copied
from the host. For ``torch.as_tensor(`` it is a literal, a display or
comprehension, or a call of ``np``/``numpy`` or a builtin (``int``,
``float``, ``bool``, ``list``, ``tuple``, ``range``, ``len``); a name is
not judged.

A branch that runs only off the card may be suppressed line by line with
``# lstpu: ignore[LSA302] — <why it never runs in a capture>``.
"""

from __future__ import annotations

import ast
from typing import Optional

from langstream_tpu_torch.analysis.core import (
    ANALYSIS_PREFIX,
    SOURCE_ROOT,
    Finding,
    ParsedFile,
    Repo,
    is_self_attr,
)

#: the capture registry: module -> the number of graph sites it owns, the
#: bodies its graphs capture (``Class.method``), and the method that binds
#: the buffers those graphs hold by address. Adding a capture site anywhere
#: means a row here, and that diff line is where a review asks what the
#: capture closes over.
CAPTURE_REGISTRY: dict[str, dict] = {
    SOURCE_ROOT + "/serving/engine.py": {
        # _CudaGraph: torch.cuda.CUDAGraph() and the torch.cuda.graph(...)
        # capture; _chunk_fn hands it one of the two bodies
        "sites": 2,
        "bodies": ("ServingEngine._decode_chunk", "ServingEngine._verify_chunk"),
        "buffers": "ServingEngine._alloc_decode_state",
    },
}

#: call depth below a captured body that LSA302 follows
REACH_DEPTH = 10

GRAPH_CALLS = ("graph", "CUDAGraph", "make_graphed_callables")
HOST_METHODS = ("item", "tolist", "cpu", "numpy")
HOST_BUILTINS = ("int", "float", "bool", "list", "tuple", "range", "len")
PACKAGE = SOURCE_ROOT.replace("/", ".")


def _torch_attr(node: ast.AST, *path: str) -> bool:
    """``node`` is ``torch.<path...>`` (``torch.cuda.graph``)."""
    for name in reversed(path):
        if not (isinstance(node, ast.Attribute) and node.attr == name):
            return False
        node = node.value
    return isinstance(node, ast.Name) and node.id == "torch"


def _graph_sites(pf: ParsedFile) -> list[ast.Call]:
    return [
        node
        for node in ast.walk(pf.tree)
        if isinstance(node, ast.Call)
        and any(_torch_attr(node.func, "cuda", name) for name in GRAPH_CALLS)
    ]


# ---------------------------------------------------------------------------
# The port's functions and what a call resolves to
# ---------------------------------------------------------------------------


def _module_name(rel: str) -> str:
    mod = rel[: -len(".py")].replace("/", ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


class _Index:
    """Every module's top-level functions and methods, and what the names
    it imports from the port refer to."""

    def __init__(self, repo: Repo) -> None:
        self.by_module: dict[str, ParsedFile] = {}
        # (module, qualname) -> def
        self.defs: dict[tuple[str, str], ast.AST] = {}
        # module -> local name -> ("mod", module) | ("def", module, name)
        self.names: dict[str, dict[str, tuple]] = {}
        for pf in repo.files:
            mod = _module_name(pf.rel)
            self.by_module[mod] = pf
            for stmt in pf.tree.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.defs[(mod, stmt.name)] = stmt
                elif isinstance(stmt, ast.ClassDef):
                    for sub in stmt.body:
                        if isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            self.defs[(mod, f"{stmt.name}.{sub.name}")] = sub
        for pf in repo.files:
            self.names[_module_name(pf.rel)] = self._imports(pf)
        self._choices: dict[tuple[str, str], dict[str, list[str]]] = {}

    def _imports(self, pf: ParsedFile) -> dict[str, tuple]:
        mod = _module_name(pf.rel)
        is_pkg = pf.rel.endswith("/__init__.py")
        out: dict[str, tuple] = {}
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = mod.split(".")
                    keep = len(parts) - node.level + (1 if is_pkg else 0)
                    base = ".".join(parts[:keep] + ([base] if base else []))
                if not base.startswith(PACKAGE):
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub = f"{base}.{alias.name}"
                    if sub in self.by_module:
                        out[local] = ("mod", sub)
                    else:
                        out[local] = ("def", base, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname and alias.name in self.by_module:
                        out[alias.asname] = ("mod", alias.name)
        return out

    def resolve(
        self, mod: str, qual: str, call: ast.Call
    ) -> list[tuple[str, str]]:
        """The (module, qualname) of each port function ``call`` may run:
        one, or each branch of a local bound to a choice of functions
        (``kernel = a if int8 else b; kernel(...)``)."""
        f = call.func
        if isinstance(f, ast.Name):
            hit = self._resolve_name(mod, f.id)
            if hit is not None:
                return [hit]
            out = []
            for name in self._locals(mod, qual).get(f.id, ()):
                hit = self._resolve_name(mod, name)
                if hit is not None:
                    out.append(hit)
            return out
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and "." in qual:
                key = (mod, f"{qual.split('.')[0]}.{f.attr}")
                return [key] if key in self.defs else []
            ref = self.names.get(mod, {}).get(f.value.id)
            if ref and ref[0] == "mod" and (ref[1], f.attr) in self.defs:
                return [(ref[1], f.attr)]
        return []

    def _resolve_name(self, mod: str, name: str) -> Optional[tuple[str, str]]:
        if (mod, name) in self.defs:
            return (mod, name)
        ref = self.names.get(mod, {}).get(name)
        if ref and ref[0] == "def" and (ref[1], ref[2]) in self.defs:
            return (ref[1], ref[2])
        return None

    def _locals(self, mod: str, qual: str) -> dict[str, list[str]]:
        """Locals of a function bound to a name or a conditional choice of
        names: ``{local: [name, ...]}``."""
        key = (mod, qual)
        if key not in self._choices:
            out: dict[str, list[str]] = {}
            for node in ast.walk(self.defs[key]):
                if isinstance(node, ast.Assign):
                    names = _choice_names(node.value)
                    for t in node.targets:
                        if names and isinstance(t, ast.Name):
                            out.setdefault(t.id, []).extend(names)
            self._choices[key] = out
        return self._choices[key]


def _choice_names(node: ast.AST) -> list[str]:
    """``a`` → [a]; ``a if c else b`` → [a, b] (nested choices too)."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.IfExp):
        body, orelse = _choice_names(node.body), _choice_names(node.orelse)
        return body + orelse if body and orelse else []
    return []


# ---------------------------------------------------------------------------
# LSA302: host work
# ---------------------------------------------------------------------------


def _host_value(node: ast.AST) -> bool:
    if isinstance(
        node,
        (ast.Constant, ast.List, ast.Tuple, ast.Set, ast.Dict, ast.ListComp,
         ast.SetComp, ast.DictComp, ast.GeneratorExp),
    ):
        return True
    if isinstance(node, ast.UnaryOp):
        return _host_value(node.operand)
    if isinstance(node, ast.BinOp):
        return _host_value(node.left) and _host_value(node.right)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            return f.id in HOST_BUILTINS
        while isinstance(f, ast.Attribute):
            f = f.value
        return isinstance(f, ast.Name) and f.id in ("np", "numpy")
    return False


def _host_work(call: ast.Call) -> Optional[str]:
    """What host work ``call`` is, or None."""
    f = call.func
    if _torch_attr(f, "cuda", "synchronize"):
        return "torch.cuda.synchronize() waits for the host"
    if isinstance(f, ast.Attribute):
        if f.attr in HOST_METHODS:
            return f".{f.attr}() copies to the host and syncs"
        if f.attr == "synchronize":
            return ".synchronize() waits for the host"
    if _torch_attr(f, "tensor"):
        return "torch.tensor(...) builds a tensor from host data"
    if _torch_attr(f, "as_tensor") and call.args and _host_value(call.args[0]):
        return "torch.as_tensor(...) of a host value copies it up"
    return None


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


def _registry_findings(
    repo: Repo, registry: dict, index: _Index, findings: list[Finding]
) -> None:
    for pf in repo.files:
        if pf.rel.startswith(ANALYSIS_PREFIX):
            continue
        sites = _graph_sites(pf)
        row = registry.get(pf.rel)
        if row is None:
            for site in sites:
                findings.append(Finding(
                    code="LSA301",
                    path=pf.rel,
                    line=site.lineno,
                    message=(
                        "CUDA-graph site in a module outside the capture "
                        "registry (analysis/compile_surface.CAPTURE_REGISTRY)"
                        " — register it with the bodies it captures"
                    ),
                ))
            continue
        if not sites:
            findings.append(Finding(
                code="LSA301",
                path=pf.rel,
                line=1,
                message=(
                    f"capture registry expects {row['sites']} CUDA-graph "
                    "site(s) here but the module owns none — drop the "
                    "stale registry row"
                ),
            ))
        elif len(sites) != row["sites"]:
            findings.append(Finding(
                code="LSA301",
                path=pf.rel,
                line=sites[0].lineno,
                message=(
                    f"module owns {len(sites)} CUDA-graph site(s) but the "
                    f"capture registry says {row['sites']} — update "
                    "CAPTURE_REGISTRY with what the new site captures"
                ),
            ))
        mod = _module_name(pf.rel)
        named = list(row["bodies"]) + [row["buffers"]]
        for qual in named:
            if (mod, qual) not in index.defs:
                findings.append(Finding(
                    code="LSA301",
                    path=pf.rel,
                    line=1,
                    message=(
                        f"capture registry names {qual} but the module "
                        "does not define it — a stale registry row"
                    ),
                ))


def _buffers(fn: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        targets: list = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                if is_self_attr(el):
                    out.add(el.attr)
    return out


def _rebinds(fn: ast.AST, buffers: set[str]) -> list[tuple[ast.AST, str]]:
    out = []
    for node in ast.walk(fn):
        targets: list = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                if is_self_attr(el) and el.attr in buffers:
                    out.append((node, el.attr))
    return out


def _capture_findings(
    registry: dict, index: _Index, findings: list[Finding]
) -> None:
    reported: set[tuple[str, int, str]] = set()
    for rel, row in registry.items():
        mod = _module_name(rel)
        if mod not in index.by_module:
            continue
        alloc = index.defs.get((mod, row["buffers"]))
        buffers = _buffers(alloc) if alloc is not None else set()
        cls = row["buffers"].split(".")[0] if "." in row["buffers"] else None
        for body in row["bodies"]:
            if (mod, body) not in index.defs:
                continue
            # breadth-first over the call graph, keeping each function's
            # first chain from the body
            chains = {(mod, body): [body]}
            frontier = [(mod, body)]
            for _depth in range(REACH_DEPTH):
                nxt = []
                for key in frontier:
                    for node in ast.walk(index.defs[key]):
                        if not isinstance(node, ast.Call):
                            continue
                        for target in index.resolve(key[0], key[1], node):
                            if target not in chains:
                                chains[target] = chains[key] + [target[1]]
                                nxt.append(target)
                frontier = nxt
            for key, chain in chains.items():
                fn = index.defs[key]
                pf = index.by_module[key[0]]
                via = " -> ".join(chain)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    what = _host_work(node)
                    if what is None:
                        continue
                    mark = (pf.rel, node.lineno, "LSA302")
                    if mark in reported:
                        continue
                    reported.add(mark)
                    findings.append(Finding(
                        code="LSA302",
                        path=pf.rel,
                        line=node.lineno,
                        message=(
                            f"host work inside a capture: {what} (reached "
                            f"from the captured body: {via})"
                        ),
                    ))
                same_class = (
                    key[0] == mod and cls is not None
                    and key[1].startswith(cls + ".")
                )
                if not same_class:
                    continue
                for node, attr in _rebinds(fn, buffers):
                    mark = (pf.rel, node.lineno, "LSA303")
                    if mark in reported:
                        continue
                    reported.add(mark)
                    findings.append(Finding(
                        code="LSA303",
                        path=pf.rel,
                        line=node.lineno,
                        message=(
                            f"self.{attr} is rebound inside a capture "
                            f"({via}); {row['buffers']} binds it and the "
                            "graphs hold its address — write it in place"
                        ),
                    ))


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    index = _Index(repo)
    _registry_findings(repo, CAPTURE_REGISTRY, index, findings)
    _capture_findings(CAPTURE_REGISTRY, index, findings)
    return findings
