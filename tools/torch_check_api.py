"""Public-API gate of the PyTorch port (stdlib only, by AST): the names
and call signatures of ``repro_torch.serving``, the engine
(``repro_torch.core.agcn.engine``) and the distributed serving tier
(``repro_torch.distributed.serving``, ``repro_torch.distributed.router``)
are snapshotted into ``docs/torch_api_surface.txt``, and any drift fails.
The counterpart of ``tools/check_api.py``, with its rendering: each public
module-level function, class (with its annotated public fields) and
public method as ``module.qualname(signature)`` with defaults and
keyword-only markers, and each ``__all__`` entry.

    python tools/torch_check_api.py            # compare with the snapshot
    python tools/torch_check_api.py --update   # regenerate it

Exit code 0 = the surface matches.  On an intended API change, rerun with
``--update`` and commit the snapshot: its diff is the API review.
"""
from __future__ import annotations

import ast
import difflib
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
SNAPSHOT = REPO / "docs" / "torch_api_surface.txt"
COVERED = [
    REPO / "src/repro_torch/serving",
    REPO / "src/repro_torch/core/agcn/engine.py",
    REPO / "src/repro_torch/distributed/serving.py",
    REPO / "src/repro_torch/distributed/router.py",
]
FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def signature(node: ast.AST) -> str:
    """A def's signature ``(a, b=1, *, c=None)`` rendered from its AST."""
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    parts = [p.arg if d is None else f"{p.arg}={ast.unparse(d)}"
             for p, d in zip(pos, defaults)]
    if a.posonlyargs:
        parts.insert(len(a.posonlyargs), "/")
    if a.vararg:
        parts.append(f"*{a.vararg.arg}")
    elif a.kwonlyargs:
        parts.append("*")
    parts += [p.arg if d is None else f"{p.arg}={ast.unparse(d)}"
              for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        parts.append(f"**{a.kwarg.arg}")
    return "(" + ", ".join(parts) + ")"


def _class_lines(node: ast.ClassDef, prefix: str):
    yield f"{prefix}.{node.name}"
    for sub in node.body:
        if (isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name)
                and not sub.target.id.startswith("_")):
            yield f"{prefix}.{node.name}.{sub.target.id}"
        elif isinstance(sub, FUNCS) and not sub.name.startswith("_"):
            deco = [ast.unparse(d) for d in sub.decorator_list]
            tag = " [property]" if "property" in deco else ""
            yield f"{prefix}.{node.name}.{sub.name}{signature(sub)}{tag}"


def module_surface(py: pathlib.Path) -> list:
    """The sorted public-surface lines of one module file."""
    modname = (str(py.relative_to(REPO / "src")).removesuffix(".py")
               .replace("/", ".").removesuffix(".__init__"))
    lines = []
    for node in ast.parse(py.read_text()).body:
        if isinstance(node, FUNCS) and not node.name.startswith("_"):
            lines.append(f"{modname}.{node.name}{signature(node)}")
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            lines.extend(_class_lines(node, modname))
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            lines += [f"{modname}.__all__::{ast.literal_eval(el)}"
                      for el in node.value.elts]
    return sorted(lines)


def build_surface() -> str:
    """The whole snapshot text over every covered module."""
    files = []
    for root in COVERED:
        files += sorted(root.glob("**/*.py")) if root.is_dir() else [root]
    lines = ["# Public API surface of repro_torch.serving, "
             "repro_torch.core.agcn.engine and repro_torch.distributed's "
             "serving tier.",
             "# Generated by `python tools/torch_check_api.py --update`."]
    for py in files:
        lines += ["", f"## {py.relative_to(REPO)}", *module_surface(py)]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    """Compare with (default) or ``--update`` the checked-in snapshot."""
    argv = sys.argv[1:] if argv is None else argv
    surface = build_surface()
    rel = SNAPSHOT.relative_to(REPO)
    if "--update" in argv:
        SNAPSHOT.write_text(surface)
        print(f"api: wrote {rel} ({len(surface.splitlines())} lines)")
        return 0
    if not SNAPSHOT.exists():
        print(f"API   missing snapshot {rel}: run "
              "`python tools/torch_check_api.py --update`")
        return 1
    want = SNAPSHOT.read_text()
    if want == surface:
        print(f"api: surface matches {rel} ({len(surface.splitlines())} "
              "lines)")
        return 0
    for line in difflib.unified_diff(want.splitlines(), surface.splitlines(),
                                     fromfile=f"{rel} (checked in)",
                                     tofile="current source", lineterm=""):
        print(f"API   {line}")
    print("api: public surface drifted: if intended, run "
          "`python tools/torch_check_api.py --update` and commit the snapshot")
    return 1


if __name__ == "__main__":
    sys.exit(main())
