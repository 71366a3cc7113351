"""Docstring gate of the PyTorch port (stdlib only, by AST): every public
module, class, function and method under ``src/repro_torch/core``,
``src/repro_torch/kernels`` and ``src/repro_torch/serving`` carries a
docstring (names starting with ``_`` are exempt).  The counterpart of
``tools/check_docs.py``'s coverage check for the port's trees.

    python tools/torch_check_docs.py

Exit code 0 = 100% coverage; otherwise each missing name is printed.
"""
from __future__ import annotations

import ast
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
COVERED_TREES = [REPO / "src/repro_torch" / d
                 for d in ("core", "kernels", "serving")]
DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def public_defs(tree: ast.Module, modname: str):
    """Yield (qualname, node) for the module and every public top-level
    def or class, and every public method of those classes."""
    yield modname, tree
    for node in tree.body:
        if not isinstance(node, DEFS) or node.name.startswith("_"):
            continue
        yield f"{modname}.{node.name}", node
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, DEFS[:2]) and not sub.name.startswith("_"):
                    yield f"{modname}.{node.name}.{sub.name}", sub


def check_docstrings(trees=COVERED_TREES) -> tuple:
    """(missing qualnames, documented count, total count) over ``trees``."""
    missing, total = [], 0
    for root in trees:
        for py in sorted(root.glob("**/*.py")):
            modname = (str(py.relative_to(REPO / "src")).removesuffix(".py")
                       .replace("/", "."))
            for qual, node in public_defs(ast.parse(py.read_text()), modname):
                total += 1
                if not ast.get_docstring(node):
                    missing.append(qual)
    return missing, total - len(missing), total


def main() -> int:
    """Print the coverage line (and each missing name); 1 on a gap."""
    missing, have, total = check_docstrings()
    for m in missing:
        print(f"DOC   missing docstring: {m}")
    pct = 100.0 * have / total if total else 100.0
    print(f"docs: docstring coverage {have}/{total} ({pct:.1f}%) over "
          f"{', '.join(str(t.relative_to(REPO)) for t in COVERED_TREES)}")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
