"""Source rules: the port's AST-level hygiene pass as a rule registry.

Port of ``repro/analysis/source_rules.py`` for ``src/repro_torch``.  It
keeps the JAX package's rules that apply to the port and adds the port's
own:

* ``source.perf-counter-discipline`` — functions timing with raw
  ``perf_counter`` pairs and no synchronisation (CUDA launches are
  asynchronous: use ``obs.sync_elapsed`` / ``obs.timed`` or
  ``torch.cuda.synchronize``).
* ``source.assignment3d-construction`` — ``Assignment3D`` is built only
  by ``core/schedule.py`` (``assign_3d_lpt``), ``core/steal3d.py`` and
  ``runtime/replan.py``, so every assignment passes
  ``validate_assignment``.
* ``source.import.repro`` and ``source.import.jax`` — the port (and
  ``chip_smoke.py``) imports nothing of the JAX package and no ``jax``:
  it runs where neither is installed.
* ``source.import-time-build`` — no module imports ``triton`` or builds
  or loads a CUDA library at import time (at module level): the tests
  import every module on machines without ``nvcc`` or ``triton``, so a
  kernel is built inside the function that launches it.

Waivers: a violation is suppressed when the flagged line carries the
pragma ``# analysis: allow(<rule-id>)``.  Waivers are per-line and
per-rule; there is no file-level or wildcard form.

Standard library only.  Run as::

    python -m repro_torch.analysis.source_rules [ROOT] [--json] [--list-rules]
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PORT_DIRS = ("src/repro_torch",)
IMPORT_DIRS = PORT_DIRS + ("chip_smoke.py",)

# Raw-perf_counter timing ban: a CUDA launch returns before the card has
# done its work, so a perf_counter pair around it times the launch.  A
# function that reads perf_counter twice or more must reference one of
# the synchronising helpers in the same scope.  ``obs`` is their home.
PERF_COUNTER_ALLOW = ("src/repro_torch/obs",)
PERF_COUNTER_BLOCKERS = ("sync_elapsed", "timed", "synchronize")

# Direct Assignment3D construction ban (see the module docstring).
ASSIGNMENT3D_ALLOW = ("src/repro_torch/core/schedule.py",
                      "src/repro_torch/core/steal3d.py",
                      "src/repro_torch/runtime/replan.py")

# Calls that build or load a kernel library (kernels/loader.py and ctypes)
BUILD_CALLS = ("build", "load", "CDLL", "LoadLibrary", "nvcc_path")


# ---------------------------------------------------------------------------
# per-file hit functions
# ---------------------------------------------------------------------------
def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else None


def _perf_counter_hits(tree: ast.AST) -> List:
    """Functions timing with >= 2 raw perf_counter reads and no
    synchronising helper referenced."""
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        n_pc = 0
        blocked = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _call_name(sub) == "perf_counter":
                n_pc += 1
            ref = sub.attr if isinstance(sub, ast.Attribute) else \
                sub.id if isinstance(sub, ast.Name) else None
            if ref in PERF_COUNTER_BLOCKERS:
                blocked = True
        if n_pc >= 2 and not blocked:
            hits.append(
                (node.lineno,
                 f"function {node.name!r} times with raw perf_counter "
                 "pairs and never synchronises (use obs.sync_elapsed / "
                 "obs.timed / torch.cuda.synchronize)"))
    return hits


def _assignment3d_hits(tree: ast.AST) -> List:
    """Direct ``Assignment3D(...)`` calls (by name or attribute)."""
    return [(node.lineno,
             "constructs Assignment3D directly (build it with assign_3d_lpt "
             "or inject via plan_matmul(assignment=...) so "
             "validate_assignment gates it)")
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and _call_name(node) == "Assignment3D"]


def _import_hits(tree: ast.AST, tops: Tuple[str, ...]) -> List:
    """Absolute imports of a top-level package in ``tops``."""
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in tops:
                hits.append((node.lineno, f"imports {name}"))
    return hits


def _module_level(tree: ast.AST):
    """Nodes that run when the module is imported: everything outside
    function bodies (class bodies run at import too)."""
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _import_time_build_hits(tree: ast.AST) -> List:
    """``triton`` imported, or a kernel library built or loaded, at
    module level."""
    hits = []
    for node in _module_level(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            if any(n.split(".")[0] == "triton" for n in names):
                hits.append((node.lineno, "imports triton at import time "
                             "(import it inside the function that "
                             "launches the kernel)"))
        elif isinstance(node, ast.Call) and _call_name(node) in BUILD_CALLS:
            hits.append((node.lineno,
                         f"calls {_call_name(node)}() at import time (build "
                         "or load a kernel on first use, inside a "
                         "function)"))
    return sorted(hits)


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SourceRule:
    """One AST-level hygiene rule.

    ``scan(tree)`` returns ``[(lineno, description), ...]`` hits for one
    parsed file; ``dirs`` (directories or files, relative to the root)
    and ``allow`` (path prefixes) bound where the rule applies.
    """

    id: str
    description: str
    dirs: Tuple[str, ...]
    allow: Tuple[str, ...]
    scan: Callable[[ast.AST], List[Tuple[int, str]]]


RULES: Tuple[SourceRule, ...] = (
    SourceRule(
        id="source.import.repro",
        description="the port imports nothing of the JAX package (repro)",
        dirs=IMPORT_DIRS, allow=(),
        scan=lambda tree: _import_hits(tree, ("repro",))),
    SourceRule(
        id="source.import.jax",
        description="the port imports no jax (it runs where JAX is not "
                    "installed)",
        dirs=IMPORT_DIRS, allow=(),
        scan=lambda tree: _import_hits(tree, ("jax", "jaxlib"))),
    SourceRule(
        id="source.import-time-build",
        description="no triton import and no kernel build or load at "
                    "import time",
        dirs=PORT_DIRS, allow=(),
        scan=_import_time_build_hits),
    SourceRule(
        id="source.assignment3d-construction",
        description="Assignment3D is constructed only by core/schedule.py "
                    "(assign_3d_lpt), core/steal3d.py and runtime/"
                    "replan.py, so every assignment passes "
                    "validate_assignment",
        dirs=PORT_DIRS, allow=ASSIGNMENT3D_ALLOW,
        scan=_assignment3d_hits),
    SourceRule(
        id="source.perf-counter-discipline",
        description="no raw perf_counter timing pairs without a "
                    "synchronising helper (obs.sync_elapsed / obs.timed / "
                    "torch.cuda.synchronize)",
        dirs=PORT_DIRS, allow=PERF_COUNTER_ALLOW,
        scan=_perf_counter_hits),
)


def iter_rules() -> Tuple[SourceRule, ...]:
    return RULES


def _allowed(rel_posix: str, allow: Sequence[str]) -> bool:
    return any(rel_posix == pre or rel_posix.startswith(pre + "/")
               for pre in allow)


def _waived(lines: List[str], lineno: int, rule_id: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    return f"# analysis: allow({rule_id})" in lines[lineno - 1]


def _files(root: pathlib.Path, sub: str) -> List[pathlib.Path]:
    base = root / sub
    if base.is_file():
        return [base]
    return sorted(base.glob("**/*.py")) if base.is_dir() else []


def _scan(root: Optional[str] = None) -> List[dict]:
    """All hits as dicts {file, line, rule, desc}, waivers applied."""
    root_path = pathlib.Path(root) if root else \
        pathlib.Path(__file__).resolve().parents[3]
    cache: Dict[pathlib.Path, Tuple[ast.AST, List[str]]] = {}
    out = []
    for rule in RULES:
        for sub in rule.dirs:
            for path in _files(root_path, sub):
                rel = path.relative_to(root_path).as_posix()
                if _allowed(rel, rule.allow):
                    continue
                if path not in cache:
                    text = path.read_text()
                    cache[path] = (ast.parse(text, filename=str(path)),
                                   text.splitlines())
                tree, lines = cache[path]
                for lineno, desc in rule.scan(tree):
                    if _waived(lines, lineno, rule.id):
                        continue
                    out.append({"file": rel, "line": lineno,
                                "rule": rule.id, "desc": desc})
    return out


def violations(root: Optional[str] = None) -> List[str]:
    """Sorted unique ``file:line: rule: desc`` lines."""
    return sorted({f"{h['file']}:{h['line']}: {h['rule']}: {h['desc']}"
                   for h in _scan(root)})


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json = "--json" in argv
    list_rules = "--list-rules" in argv
    args = [a for a in argv if a not in ("--json", "--list-rules")]
    if list_rules:
        if as_json:
            print(json.dumps([{"rule": r.id, "description": r.description}
                              for r in RULES], indent=2))
        else:
            for r in RULES:
                print(f"{r.id}: {r.description}")
        return 0
    root = args[0] if args else None
    if as_json:
        hits = _scan(root)
        print(json.dumps({"ok": not hits, "violations": hits}, indent=2))
        return 1 if hits else 0
    found = violations(root)
    if found:
        print("source rule violations:")
        for v in found:
            print(f"  {v}")
        return 1
    print(f"source_rules: OK ({', '.join(IMPORT_DIRS)} clean under "
          f"{len(RULES)} rules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
