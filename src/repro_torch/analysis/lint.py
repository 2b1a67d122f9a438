"""Custom AST lint of the port: the reference's ``repro.analysis.lint`` bug
classes carried over to eager PyTorch.

Rules (suppress a line with ``# noqa: RPR0xx`` and a reason, or a bare
``# noqa``):

  RPR001  a draw from the global generator — ``torch.rand`` / ``randn`` /
          ``randint`` / ``randperm`` / ``bernoulli`` / ``multinomial`` /
          ``normal`` / ``poisson`` and their ``_like`` forms, or the
          in-place ``Tensor.uniform_`` / ``normal_`` / ``random_`` /
          ``bernoulli_`` / ``exponential_``, called without ``generator=``;
          and ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]``
          anywhere.  The port draws from explicit ``torch.Generator``s: a
          draw from the global stream depends on every draw before it, in
          any module, so a resumed run no longer draws the same bits (the
          reference's "two sites drawing identical bits breaks bit-exact
          resume").
  RPR002  host sync inside step-reachable code — ``float()`` / ``int()`` /
          ``bool()`` on a non-literal, ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``np.asarray`` /
          ``np.array``, ``torch.cuda.synchronize()``.  On a card tensor
          each waits for the device: the static side of
          ``repro_torch.analysis.sanitize.no_implicit_host_sync``.
  RPR003  Python ``if`` / ``while`` on a tensor inside step-reachable code
          — the test contains a ``torch.*`` call (or a local assigned from
          an expression with one): an implicit ``bool()``, so a host sync, and a break in any
          CUDA-graph capture of the step.
  RPR004  mutable default argument — ``[]`` / ``{}`` / ``set()`` defaults on
          function parameters or dataclass fields (the reference's rule,
          byte for byte).

Step-reachable code, the counterpart of the reference's jit-reachable
code: the functions passed to ``torch.compile``, ``torch.func.*``,
``torch.utils.checkpoint.checkpoint``, ``torch.cuda.make_graphed_callables``
or called inside ``with torch.cuda.graph(...)``, and the outer step's entry
points listed in :data:`STEP_ROOTS` (keyed by the file's path within the
package).  Reachability follows any Name reference from a root to other
functions defined in the same module, callbacks included, as in the
reference.  Pure ``ast``: imports neither torch nor the port.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from pathlib import PurePath
from typing import Iterable, Optional

RULES = {
    "RPR001": "draw from the global random generator",
    "RPR002": "host sync inside step-reachable code",
    "RPR003": "Python control flow on a tensor inside step-reachable code",
    "RPR004": "mutable default argument",
}

PACKAGE = "repro_torch"

# The outer step's entry points, by path within the package: each file's
# roots of step-reachable code (nested defs inherit reachability).
STEP_ROOTS = {
    "core/dsm.py": ("make_local_phase", "make_dsm_step", "outer_step", "local_phase",
                    "global_phase", "global_sign_momentum_step", "worker_grads"),
    # the base optimizers' factories, whose nested update functions the
    # local phase calls
    "core/base_opt.py": ("sgd", "momentum", "adamw", "lion", "sophia", "_over_groups",
                         "_plain_update"),
    "models/transformer.py": ("loss_fn", "hidden_states", "prefill", "decode_step"),
    "models/layers.py": ("causal_attention", "full_attention", "decode_attention", "attn_qkv",
                         "attn_proj_out", "mlp_apply", "moe_apply", "conv1d_apply",
                         "conv1d_step", "mamba2_apply", "mamba2_decode", "rglru_apply",
                         "rglru_decode"),
    "kernels/dsm_update.py": ("dsm_update", "dsm_update_plain"),
    "kernels/adamw_update.py": ("adamw_update", "adamw_update_plain"),
}

# draws of torch's global generator unless given generator=
_GLOBAL_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
                 "normal", "poisson", "rand_like", "randn_like", "randint_like"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_"}
_SEEDS = (["torch", "manual_seed"], ["torch", "cuda", "manual_seed"],
          ["torch", "cuda", "manual_seed_all"])

_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_SYNC_BUILTINS = {"float", "int", "bool"}
_NP_SYNC_FUNCS = {"asarray", "array"}

# wrappers whose first argument becomes step-reachable
_STEP_WRAPPERS = {"compile", "checkpoint", "make_graphed_callables"}
# torch calls that return host values: no tensor in an `if` on them
_HOST_VALUED = {"is_tensor", "is_floating_point", "is_complex", "is_grad_enabled",
                "is_inference_mode_enabled", "is_autocast_enabled", "finfo", "iinfo",
                "get_default_dtype", "device", "dtype", "Size", "promote_types",
                "result_type", "can_cast"}
_HOST_VALUED_MODULES = {"cuda", "backends", "distributed", "compiler", "jit", "profiler"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _attr_chain(node: ast.AST) -> list[str]:
    """['torch', 'cuda', 'synchronize'] for torch.cuda.synchronize; [] if
    not a chain of names."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _is_step_wrapper(chain: list[str]) -> bool:
    return bool(chain) and (chain[-1] in _STEP_WRAPPERS
                            or (len(chain) >= 3 and chain[:2] == ["torch", "func"])
                            or chain[:1] == ["func"])


def _is_tensor_call(call: ast.Call) -> bool:
    """A ``torch.*`` call that returns a tensor (not a host value)."""
    chain = _attr_chain(call.func)
    return (len(chain) >= 2 and chain[0] == "torch"
            and chain[1] not in _HOST_VALUED_MODULES and chain[-1] not in _HOST_VALUED)


def package_path(path: str) -> Optional[str]:
    """``core/dsm.py`` for ``.../repro_torch/core/dsm.py``: the path within
    the port's package, or None outside it."""
    parts = PurePath(path).parts
    if PACKAGE not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE)
    return "/".join(parts[i + 1:])


class _FunctionIndex(ast.NodeVisitor):
    """Module pass 1: every function def + the step-reachable root set."""

    def __init__(self, table_roots: Iterable[str] = ()):
        self.defs: dict[str, ast.AST] = {}
        self.roots: set[str] = set(table_roots)

    def visit_FunctionDef(self, node):
        self.defs.setdefault(node.name, node)
        for dec in node.decorator_list:
            chain = _attr_chain(dec.func if isinstance(dec, ast.Call) else dec)
            if _is_step_wrapper(chain):
                self.roots.add(node.name)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        if _is_step_wrapper(_attr_chain(node.func)):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name):
                    self.roots.add(arg.id)
        self.generic_visit(node)

    def visit_With(self, node):
        # everything called inside a CUDA-graph capture is step code
        if any(isinstance(item.context_expr, ast.Call)
               and _attr_chain(item.context_expr.func)[-1:] == ["graph"]
               for item in node.items):
            for sub in node.body:
                for n in ast.walk(sub):
                    if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                        self.roots.add(n.func.id)
        self.generic_visit(node)


def _reachable_functions(tree: ast.Module, table_roots: Iterable[str]) -> set[ast.AST]:
    """Function nodes reachable from the module's step roots."""
    index = _FunctionIndex(table_roots)
    index.visit(tree)
    seen: set[str] = set()
    work = [n for n in index.roots if n in index.defs]
    reachable: set[ast.AST] = set()
    while work:
        name = work.pop()
        if name in seen:
            continue
        seen.add(name)
        fn = index.defs[name]
        reachable.add(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                reachable.add(node)  # nested defs inherit reachability
            if isinstance(node, ast.Name) and node.id in index.defs:
                work.append(node.id)
    return reachable


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("list", "dict", "set")
    return False


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        chain = _attr_chain(dec if not isinstance(dec, ast.Call) else dec.func)
        if chain and chain[-1] == "dataclass":
            return True
    return False


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" or kw.arg is None for kw in call.keywords)


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` or ``x.to(device="cpu")``."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)


class _Linter:
    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.findings: list[Finding] = []

    # -- suppression ------------------------------------------------------
    def _suppressed(self, line: int, rule: str) -> bool:
        if not 1 <= line <= len(self.lines):
            return False
        text = self.lines[line - 1]
        if "# noqa" not in text:
            return False
        tail = text.split("# noqa", 1)[1]
        codes = tail.lstrip(": ").split()
        return not codes or rule in {c.strip(",") for c in codes}

    def _add(self, node: ast.AST, rule: str, message: str):
        if not self._suppressed(node.lineno, rule):
            self.findings.append(Finding(
                path=self.path, line=node.lineno, col=node.col_offset,
                rule=rule, message=message))

    # -- driver -----------------------------------------------------------
    def run(self) -> list[Finding]:
        try:
            tree = ast.parse(self.source, filename=self.path)
        except SyntaxError as e:
            self.findings.append(Finding(
                path=self.path, line=e.lineno or 1, col=e.offset or 0,
                rule="RPR000", message=f"syntax error: {e.msg}"))
            return self.findings
        roots = STEP_ROOTS.get(package_path(self.path) or "", ())
        self._check_global_draws(tree)
        self._check_mutable_defaults(tree)
        for fn in _reachable_functions(tree, roots):
            self._check_host_sync(fn)
            self._check_tensor_branch(fn)
        # a nested def is walked inside its parent and on its own
        return sorted(set(self.findings), key=lambda f: (f.line, f.col, f.rule))

    # -- RPR001 -----------------------------------------------------------
    def _check_global_draws(self, tree: ast.Module):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain in _SEEDS:
                self._add(node, "RPR001",
                          f"{'.'.join(chain)}() reseeds the global generator; draw from "
                          "an explicit torch.Generator")
            elif _has_generator(node):
                continue
            elif len(chain) == 2 and chain[0] == "torch" and chain[1] in _GLOBAL_DRAWS:
                self._add(node, "RPR001",
                          f"torch.{chain[1]}() draws from the global generator; pass "
                          "generator= (its bits depend on every earlier draw, so a "
                          "resumed run draws others)")
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS:
                self._add(node, "RPR001",
                          f".{node.func.attr}() draws from the global generator; pass "
                          "generator=")

    # -- RPR002 -----------------------------------------------------------
    def _check_host_sync(self, fn: ast.AST):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _HOST_SYNC_BUILTINS
                    and node.args
                    and not isinstance(node.args[0], ast.Constant)):
                self._add(node, "RPR002",
                          f"{node.func.id}() of a tensor waits for the device inside "
                          "step-reachable code (keep it a tensor, or read it once where "
                          "the host needs it)")
            elif (isinstance(node.func, ast.Attribute)
                    and (node.func.attr in _HOST_SYNC_METHODS
                         or (node.func.attr == "to" and _to_cpu(node)))):
                self._add(node, "RPR002",
                          f".{node.func.attr}() copies to the host inside "
                          "step-reachable code")
            elif (len(chain) == 2 and chain[0] in ("np", "numpy")
                    and chain[1] in _NP_SYNC_FUNCS):
                self._add(node, "RPR002",
                          f"{'.'.join(chain)}() materializes on the host inside "
                          "step-reachable code")
            elif chain == ["torch", "cuda", "synchronize"]:
                self._add(node, "RPR002",
                          "torch.cuda.synchronize() inside step-reachable code")

    # -- RPR003 -----------------------------------------------------------
    def _tensor_locals(self, fn: ast.AST) -> set[str]:
        tensors: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    isinstance(n, ast.Call) and _is_tensor_call(n) for n in ast.walk(node.value)):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            tensors.add(n.id)
        return tensors

    def _check_tensor_branch(self, fn: ast.AST):
        tensors = self._tensor_locals(fn)

        def is_tensor_expr(expr: ast.AST) -> bool:
            # an identity test (`x is None`) or isinstance() reads no value
            if isinstance(expr, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return False
            if isinstance(expr, ast.Call) and _attr_chain(expr.func) in (
                    ["isinstance"], ["hasattr"], ["callable"]):
                return False
            if isinstance(expr, ast.Call) and _is_tensor_call(expr):
                return True
            if isinstance(expr, ast.Name) and expr.id in tensors:
                return True
            return any(is_tensor_expr(c) for c in ast.iter_child_nodes(expr))

        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)) and is_tensor_expr(node.test):
                kw = "if" if isinstance(node, ast.If) else "while"
                self._add(node, "RPR003",
                          f"Python `{kw}` on a tensor inside step-reachable code — an "
                          "implicit bool(): a host sync, and a break in a CUDA-graph "
                          "capture (use torch.where)")

    # -- RPR004 -----------------------------------------------------------
    def _check_mutable_defaults(self, tree: ast.Module):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for default in list(args.defaults) + \
                        [d for d in args.kw_defaults if d is not None]:
                    if _is_mutable_default(default):
                        self._add(default, "RPR004",
                                  "mutable default argument in "
                                  f"{node.name}() — shared across calls")
            elif isinstance(node, ast.ClassDef) and _is_dataclass(node):
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                            and _is_mutable_default(stmt.value):
                        self._add(stmt.value, "RPR004",
                                  "mutable default on dataclass field of "
                                  f"{node.name} — shared across instances")


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """The findings in ``source``; ``path`` within ``repro_torch/`` picks the
    file's :data:`STEP_ROOTS`."""
    return _Linter(path, source).run()


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    """Lint every .py file under the given files/directories."""
    findings: list[Finding] = []
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        else:
            files.append(p)
    for f in files:
        with open(f, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), path=f))
    return findings
