"""The port's source rules: an AST lint over ``src/repro_torch/``,
``chip_smoke.py`` and ``tools/``.

Rules (IDs referenced from ROADMAP.md and ``allowlist.toml``):

R1   threefry draws have one home. A call of the port's threefry PRNG
     (``prng.fold_in``, ``prng.uniform``, ``prng.bits``,
     ``prng.threefry2x32``) may appear only in ``core/topology.py``'s
     ``survival_mask`` (links) and ``availability_mask`` (agents): those
     two define the fold-in convention that the host replays bill
     Eq. (11) from and that equals the JAX package's bits. ``core/prng.py``,
     which defines the draws, is exempt; a helper those two call is a
     finding, allowlisted by name.
R2'  no ``torch.compile`` in ``src/repro_torch/`` or ``chip_smoke.py``:
     compiled plain code never stands in for a kernel, and a kernel is
     held against its plain version, not against a compiled one. (The
     port's counterpart of the JAX package's R2, which asks that round
     programs go through ``scanloop.donating_jit``.)
R3   timing checks are median-of-N: in ``chip_smoke.py``, ``tools/``
     and the port's script twins (``launch/consensus_scale.py``,
     ``rl/fig4_tradeoff.py``), a check is an ``assert`` whose test reads
     a timing-named value, or an ``if`` whose test compares one and whose
     body raises or calls ``fail``/``exit``. Each timing-named value the
     check reads must come from a median: a ``median`` call, a function
     every ``return`` of which is one, or a name, attribute, string key
     or keyword argument every assignment of which in the module is one
     (followed to a fixed point). Any other is a single-shot flake. The
     data flow is per name and module-wide: a value passed in as a
     parameter is never median-derived.
R4   no unpriced transmissions: a module with a wire send
     (``Codec.transmit``, ``encode_leaf``, ``batch_isend_irecv``,
     ``isend``, ``send``, ``all_gather``, ``all_gather_into_tensor``;
     a send passed as a function, as to ``dist.P2POp``, counts too) must
     reach Eq.-(11) billing in the same module (``round_comm_joules``,
     ``delivered_comm_joules``, ``RoundRecorder``, ``recorder_for``,
     ``price_bits``, ``model_bits``, ``fl_comm_energy``).
     ``src/repro_torch/comms/``, the wire-format layer that defines the
     sends, is exempt.
R6   error paths name the offending input: every ``raise`` in the port's
     ``core/``, ``rl/`` and ``launch/`` interpolates a value (an
     f-string piece, a name, an attribute or a call) into its message.
     Bare re-raises and ``raise err`` of a caught variable are exempt.

The JAX package's R5 (donated carries are ``own()``ed) is not linted:
the port's drivers own a caller's pytree themselves before the first
round (``scanloop.own``). Its program rules JX1, JX3, JX4 and JX5 are
:mod:`.programs` over the captured round programs, its cost model C1–3 is
:mod:`.costmodel`; JX2 and H1–3 read a jaxpr or HLO the port does not
have.

Pure ``ast``: this module imports neither torch nor anything it lints.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Set

from repro_torch.analysis.findings import Finding

PORT = "src/repro_torch/"

#: identifiers / subscript-string keys that mark a value as a timing
_TIMING_RE = re.compile(
    r"(^|_)(us|ms|usec|msec|sec|secs|seconds|elapsed|wall|time|times|"
    r"dt|latency|duration)(_|$|s$)")

_DRAW_FNS = {"fold_in", "uniform", "bits", "threefry2x32"}
_R1_HOMES = ("survival_mask", "availability_mask")
_R1_EXEMPT = (PORT + "core/prng.py",)
_SEND_NAMES = {"transmit", "encode_leaf", "batch_isend_irecv", "isend",
               "send", "all_gather", "all_gather_into_tensor"}
_BILLING_NAMES = {"round_comm_joules", "delivered_comm_joules",
                  "RoundRecorder", "recorder_for", "price_bits",
                  "model_bits", "fl_comm_energy"}

_R2_SCOPES = (PORT, "chip_smoke.py")
_R3_SCOPES = ("chip_smoke.py", "tools/", PORT + "launch/consensus_scale.py",
              PORT + "rl/fig4_tradeoff.py")
_R4_EXEMPT_DIRS = (PORT + "comms/",)
_R6_SCOPES = (PORT + "core/", PORT + "rl/", PORT + "launch/")

#: what ``run_lint`` walks, relative to the repository root
LINT_PATHS = ("src/repro_torch", "chip_smoke.py", "tools")


def _names_offending_input(raise_node: ast.Raise) -> bool:
    """R6: does the raise's message interpolate any dynamic value? A
    message built from constants alone cannot name the caller's input."""
    exc = raise_node.exc
    if exc is None or isinstance(exc, ast.Name):
        return True                   # bare re-raise / `raise err`
    if not isinstance(exc, ast.Call) or not exc.args:
        return False                  # `raise TypeError` / no message
    return any(isinstance(sub, (ast.JoinedStr, ast.FormattedValue,
                                ast.Name, ast.Attribute, ast.Call))
               for arg in exc.args for sub in ast.walk(arg))


def _dotted(node) -> str:
    """Best-effort dotted name of an expression ("prng.fold_in")."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _ident(node):
    """The identifier a value expression reads as: a name, an
    attribute, or a subscript's string key; else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript) and isinstance(
            node.slice, ast.Constant) and isinstance(node.slice.value, str):
        return node.slice.value
    return None


def _call_leaf(node: ast.Call) -> str:
    return _dotted(node.func).rsplit(".", 1)[-1]


def _empty(v) -> bool:
    """An empty container literal (``out = {}`` before ``out[k] = ...``)."""
    return isinstance(v, (ast.Dict, ast.List, ast.Tuple, ast.Set)) and not (
        getattr(v, "keys", None) or getattr(v, "elts", None))


def _stops(body) -> bool:
    """R3: does an ``if`` body fail the run (a raise, or a call of
    ``fail``/``exit``)?"""
    return any(isinstance(n, ast.Raise) or (
        isinstance(n, ast.Call) and _call_leaf(n) in ("fail", "exit"))
        for stmt in body for n in ast.walk(stmt))


class _MedianFlow:
    """R3's data flow. A local name is keyed by its enclosing scope (a
    read resolves outward to the module); attributes, string keys and
    keyword arguments are keyed module-wide; functions by their name.
    ``solve`` finds the keys every assignment of which, and the functions
    every ``return`` of which, is median-derived."""

    def __init__(self):
        self.assigns: Dict[tuple, list] = {}     # key -> [(value, scope)]
        self.returns: Dict[str, list] = {}       # function -> [(value, scope)]
        self.names: Set[tuple] = set()
        self.fns: Set[str] = set()

    def key(self, node, scope: str, *, store: bool = False):
        if isinstance(node, ast.Name):
            if store:
                return ("name", scope, node.id)
            parts = [] if scope == "<module>" else scope.split(".")
            for i in range(len(parts), 0, -1):
                k = ("name", ".".join(parts[:i]), node.id)
                if k in self.assigns:
                    return k
            return ("name", "<module>", node.id)
        ident = _ident(node)
        return None if ident is None else ("key", ident)

    def add(self, key, value, scope: str):
        self.assigns.setdefault(key, []).append((value, scope))

    def underived(self, node, scope: str) -> Set[str]:
        """The timing-named values ``node`` reads that do not come from
        a median (under what ``solve`` has found so far)."""
        out: Set[str] = set()

        def walk(n):
            if isinstance(n, ast.Call):
                leaf = _call_leaf(n)
                if leaf == "median" or leaf in self.fns:
                    return
                if _TIMING_RE.search(leaf):
                    out.add(leaf)
                if isinstance(n.func, ast.Attribute):
                    walk(n.func.value)
                for sub in n.args + [k.value for k in n.keywords]:
                    walk(sub)
                return
            ident = _ident(n)
            if ident is not None and _TIMING_RE.search(ident) \
                    and self.key(n, scope) not in self.names:
                out.add(ident)
            if isinstance(n, (ast.Attribute, ast.Subscript)):
                walk(n.value)
                if isinstance(n, ast.Subscript) and ident is None:
                    walk(n.slice)
            elif not isinstance(n, ast.Name):
                for child in ast.iter_child_nodes(n):
                    walk(child)

        walk(node)
        return out

    def _derived(self, value, scope: str) -> bool:
        reads = any((isinstance(n, ast.Call)
                     and (_call_leaf(n) == "median"
                          or _call_leaf(n) in self.fns))
                    or (_ident(n) is not None
                        and self.key(n, scope) in self.names)
                    for n in ast.walk(value))
        return reads and not self.underived(value, scope)

    def solve(self):
        while True:
            fns = {f for f, vals in self.returns.items()
                   if vals and all(v is not None and self._derived(v, sc)
                                   for v, sc in vals)}
            names = {k for k, vals in self.assigns.items()
                     if any(not _empty(v) for v, _sc in vals)
                     and all(_empty(v) or self._derived(v, sc)
                             for v, sc in vals)}
            if fns == self.fns and names == self.names:
                return
            self.fns, self.names = fns, names


class _ModuleFacts(ast.NodeVisitor):
    """One pass collecting every rule's raw facts for a module. Every
    site carries its enclosing scope's qualified name."""

    def __init__(self):
        self.prng_modules: Set[str] = {"prng"}      # R1: module aliases
        self.prng_funcs: Dict[str, str] = {}        # R1: local -> draw
        self.draws: List[tuple] = []                # R1: (line, fn, func,
        #                                                  scope)
        self.compile_sites: List[tuple] = []        # R2': (line, scope)
        self.checks: List[tuple] = []               # R3: (line, scope, test)
        self.flow = _MedianFlow()                   # R3
        self.send_sites: List[tuple] = []           # R4: (line, name,
        #                                                  scope)
        self.has_billing = False                    # R4
        self.nameless_raises: List[tuple] = []      # R6: (line, scope)
        self._func_stack: List[str] = []
        self._scope_stack: List[str] = []

    @property
    def scope(self) -> str:
        return ".".join(self._scope_stack) or "<module>"

    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        self._scope_stack.append(node.name)
        self.flow.returns.setdefault(node.name, [])
        self.generic_visit(node)
        self._scope_stack.pop()
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._scope_stack.append(node.name)
        self.generic_visit(node)
        self._scope_stack.pop()

    def _assign(self, target, value):
        if isinstance(target, (ast.Tuple, ast.List)):
            same = isinstance(value, (ast.Tuple, ast.List)) \
                and len(value.elts) == len(target.elts)
            for i, elt in enumerate(target.elts):
                self._assign(elt, value.elts[i] if same else value)
            return
        if isinstance(target, ast.Starred):
            target = target.value
        key = self.flow.key(target, self.scope, store=True)
        if key is None and isinstance(target, ast.Subscript):
            key = self.flow.key(target.value, self.scope)  # `out[k] = v`
        if key is not None:
            self.flow.add(key, value, self.scope)

    def _assign_each(self, target, it):
        """A loop target takes each element of a literal sequence."""
        for value in (it.elts if isinstance(it, (ast.Tuple, ast.List))
                      else (it,)):
            self._assign(target, value)

    def visit_Assign(self, node):
        for target in node.targets:
            self._assign(target, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._assign(node.target, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._assign(node.target, node.value)
        self.generic_visit(node)

    def visit_For(self, node):
        self._assign_each(node.target, node.iter)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_comprehension(self, node):
        self._assign_each(node.target, node.iter)
        self.generic_visit(node)

    def visit_Dict(self, node):
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                self.flow.add(("key", k.value), v, self.scope)
        self.generic_visit(node)

    def visit_Return(self, node):
        if self._func_stack:
            self.flow.returns[self._func_stack[-1]].append(
                (node.value, self.scope))
        self.generic_visit(node)

    def visit_If(self, node):
        if any(isinstance(n, ast.Compare) for n in ast.walk(node.test)) \
                and _stops(node.body):
            self.checks.append((node.lineno, self.scope, node.test))
        self.generic_visit(node)

    def visit_Import(self, node):
        for a in node.names:
            if a.name.endswith(".prng") and a.asname:
                self.prng_modules.add(a.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        for a in node.names:
            local = a.asname or a.name
            if a.name == "prng":
                self.prng_modules.add(local)
            elif mod.endswith("prng") and a.name in _DRAW_FNS:
                self.prng_funcs[local] = a.name
            elif mod == "torch" and a.name == "compile":
                self.compile_sites.append((node.lineno, self.scope))
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if node.attr == "compile" and _dotted(node.value) == "torch":
            self.compile_sites.append((node.lineno, self.scope))  # call,
        self.generic_visit(node)                # decorator or reference

    def visit_Assert(self, node):
        self.checks.append((node.lineno, self.scope, node.test))
        self.generic_visit(node)

    def visit_Raise(self, node):
        if not _names_offending_input(node):
            self.nameless_raises.append((node.lineno, self.scope))
        self.generic_visit(node)

    def _draw(self, func) -> str:
        """The threefry function ``func`` names, or ''."""
        if isinstance(func, ast.Name):
            return self.prng_funcs.get(func.id, "")
        d = _dotted(func)
        head, _, leaf = d.rpartition(".")
        if leaf in _DRAW_FNS and (head in self.prng_modules
                                  or head.endswith(".prng")):
            return leaf
        return ""

    def visit_Call(self, node):
        leaf = _call_leaf(node)
        if leaf in _BILLING_NAMES:
            self.has_billing = True
        if leaf in _SEND_NAMES:
            self.send_sites.append((node.lineno, leaf, self.scope))
        for arg in node.args:                       # a send passed along
            name = _dotted(arg).rsplit(".", 1)[-1]
            if isinstance(arg, (ast.Name, ast.Attribute)) \
                    and name in _SEND_NAMES:
                self.send_sites.append((node.lineno, name, self.scope))
        for kw in node.keywords:                    # R3: dict(us=...)
            if kw.arg:
                self.flow.add(("key", kw.arg), kw.value, self.scope)
        draw = self._draw(node.func)
        if draw:
            self.draws.append((node.lineno, draw, self._func_stack[-1]
                               if self._func_stack else "<module>",
                               self.scope))
        self.generic_visit(node)


def _in(rel: str, scopes) -> bool:
    return any(rel == s or (s.endswith("/") and rel.startswith(s))
               for s in scopes)


def lint_file(path: str, rel: str) -> List[Finding]:
    """Every rule's findings for one file (``rel``: its path relative to
    the repository root, which decides the rules' scopes)."""
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    rel = rel.replace("\\", "/")
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("R0", rel, e.lineno or 0,
                        f"file does not parse: {e.msg}")]
    facts = _ModuleFacts()
    facts.visit(tree)
    out: List[Finding] = []

    if rel not in _R1_EXEMPT:                                         # R1
        home = rel == PORT + "core/topology.py"
        for line, fn, func, scope in facts.draws:
            if home and func in _R1_HOMES:
                continue
            out.append(Finding(
                "R1", rel, line,
                f"threefry draw prng.{fn}() in {func}() — draw link "
                "survival through topology.survival_mask and agent "
                "availability through topology.availability_mask, the one "
                "home of the fold-in convention the Eq.-(11) replay and "
                "the JAX bits share", scope=scope))

    if _in(rel, _R2_SCOPES):                                          # R2'
        for line, scope in facts.compile_sites:
            out.append(Finding(
                "R2'", rel, line,
                "torch.compile — compiled plain code never stands in for "
                "a kernel; launch the hand-written kernel through "
                "kernels/ops.py or call the plain version in "
                "kernels/ref.py", scope=scope))

    if _in(rel, _R3_SCOPES):                                          # R3
        flow = facts.flow
        timing = [c for c in facts.checks if flow.underived(c[2], c[1])]
        flow.solve()
        for line, scope, test in timing:
            single = flow.underived(test, scope)
            if single:
                out.append(Finding(
                    "R3", rel, line,
                    f"single-shot timing check on {', '.join(sorted(single))}"
                    " — check a median of N timed runs with a tolerance (a "
                    "median call, or a value every assignment of which is "
                    "one)", scope=scope))

    if not _in(rel, _R4_EXEMPT_DIRS) and facts.send_sites \
            and not facts.has_billing:                                # R4
        for line, name, scope in facts.send_sites:
            out.append(Finding(
                "R4", rel, line,
                f"wire send ({name}) with no Eq.-(11) billing call "
                "(round_comm_joules/delivered_comm_joules/RoundRecorder/"
                "price_bits/model_bits) in this module — unpriced "
                "transmission", scope=scope))

    if _in(rel, _R6_SCOPES):                                          # R6
        for line, scope in facts.nameless_raises:
            out.append(Finding(
                "R6", rel, line,
                "raise with a constant-only message — interpolate the "
                "offending input (an f-string with the bad value) and "
                "name a nearest alternative", scope=scope))
    return out


def run_lint(root: str, paths=LINT_PATHS) -> List[Finding]:
    """Lint every ``*.py`` at or under ``root``'s ``paths`` (files or
    directories; a missing one is skipped)."""
    findings: List[Finding] = []
    for sub in paths:
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            files = [base]
        else:
            files = [os.path.join(d, fn)
                     for d, _dirs, fns in sorted(os.walk(base))
                     for fn in sorted(fns) if fn.endswith(".py")]
        for path in files:
            findings.extend(lint_file(path, os.path.relpath(path, root)))
    return findings
