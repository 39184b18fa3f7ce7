"""Phase 3 — Algorithmic Synthesis (Fig. 3).

Takes raw LLM output text, extracts the Python code block, statically checks
it against the paper's <RULES> (Appendix A: single function named
`map_to_coordinates`, no hardcoded lookup chains over n, integer outputs),
and compiles it in a restricted namespace.  A candidate that fails any step is
classified (NC) — non-compiling — exactly as in the paper's tables.
"""
from __future__ import annotations

import ast
import dataclasses
import math
import re
from typing import Callable

_CODE_FENCE = re.compile(r"```(?:python)?\s*\n(.*?)```", re.DOTALL)

#: builtins the synthesized function may use (paper's candidates only ever
#: needed arithmetic + a handful of helpers).
_SAFE_BUILTINS = {
    "abs": abs, "int": int, "float": float, "round": round, "min": min,
    "max": max, "len": len, "range": range, "sum": sum, "divmod": divmod,
    "tuple": tuple, "list": list, "enumerate": enumerate, "pow": pow,
    "ValueError": ValueError, "TypeError": TypeError, "isinstance": isinstance,
    "bool": bool, "reversed": reversed, "zip": zip, "map": map, "set": set,
    "dict": dict, "sorted": sorted, "Exception": Exception,
}


def _restricted_import(name, globals=None, locals=None, fromlist=(), level=0):
    if name.split(".")[0] != "math":
        raise ImportError(f"import of {name!r} is not allowed in synthesized code")
    return math


_SAFE_BUILTINS["__import__"] = _restricted_import


class SynthesisError(Exception):
    pass


@dataclasses.dataclass
class SynthesizedMap:
    fn: Callable[[int], tuple]
    source: str
    rule_violations: list[str]

    def __call__(self, n: int) -> tuple:
        return self.fn(n)


def extract_code(text: str) -> str:
    """Pull the Python code out of an LLM response (fenced block or raw)."""
    m = _CODE_FENCE.search(text)
    code = m.group(1) if m else text
    return code.strip()


def check_rules(code: str) -> list[str]:
    """Static checks for the paper's Appendix-A <RULES>. Returns violations."""
    violations: list[str] = []
    try:
        tree = ast.parse(code)
    except SyntaxError as e:
        return [f"syntax error: {e}"]
    fns = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
    names = [f.name for f in fns]
    if "map_to_coordinates" not in names:
        violations.append("missing function map_to_coordinates(n)")
    # forbidden: long if/elif chains comparing n against integer constants
    # (hardcoded lookup) — count equality comparisons to literals.
    hardcoded = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            if (
                isinstance(node.left, ast.Name)
                and node.left.id == "n"
                and any(isinstance(op, ast.Eq) for op in node.ops)
                and any(isinstance(c, ast.Constant) for c in node.comparators)
            ):
                hardcoded += 1
        if isinstance(node, (ast.Dict, ast.List)) and len(
            getattr(node, "keys", getattr(node, "elts", []))
        ) > 30:
            violations.append("large literal lookup table")
            break
    if hardcoded > 3:
        violations.append(f"hardcoded if n == <const> chain ({hardcoded} arms)")
    # forbidden imports of anything beyond math
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = (
                [a.name for a in node.names]
                if isinstance(node, ast.Import)
                else [node.module or ""]
            )
            for mod in mods:
                if mod.split(".")[0] != "math":
                    violations.append(f"forbidden import: {mod}")
    return violations


def synthesize(text: str, max_nodes: int = 4000) -> SynthesizedMap:
    """LLM response text -> callable map, or raise SynthesisError (=> NC)."""
    code = extract_code(text)
    if not code:
        raise SynthesisError("empty response")
    violations = check_rules(code)
    fatal = [v for v in violations if "syntax error" in v or "missing function" in v
             or "forbidden import" in v]
    if fatal:
        raise SynthesisError("; ".join(fatal))
    tree = ast.parse(code)
    if sum(1 for _ in ast.walk(tree)) > max_nodes:
        raise SynthesisError("program too large")
    ns: dict = {"__builtins__": _SAFE_BUILTINS, "math": math}
    try:
        exec(compile(tree, "<synthesized>", "exec"), ns)  # noqa: S102 — restricted namespace
    except Exception as e:
        raise SynthesisError(f"exec failed: {e!r}") from e
    fn = ns.get("map_to_coordinates")
    if not callable(fn):
        raise SynthesisError("map_to_coordinates is not callable")
    # probe: must return an int tuple for a trivial input and reject negatives
    try:
        out = fn(0)
    except Exception as e:
        raise SynthesisError(f"probe call failed: {e!r}") from e
    if not isinstance(out, (tuple, list)) or not all(
        isinstance(v, (int,)) or (isinstance(v, float) and float(v).is_integer())
        for v in out
    ):
        raise SynthesisError(f"probe output not an integer tuple: {out!r}")
    return SynthesizedMap(fn=fn, source=code, rule_violations=violations)
