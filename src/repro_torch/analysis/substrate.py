"""Import-graph reachability of the port (twin of
``repro/analysis/substrate.py``): which modules are live, which would be
seed substrate.

The reference's seed packages (``models``, ``configs``, ``optim``,
``train``, ``launch``) are reachable from no public entry point and are
reported as substrate.  The port's twins of them (ROADMAP queue 1, item
9: the dense decoder's serving path so far) are reported exactly so: the
port's substrate list is the reference's, mapped ``repro.`` ->
``repro_torch.``, restricted to the modules ported.  This module builds
the static import graph of ``src/repro_torch`` and walks it from the
port's public roots; whatever the walk cannot reach is reported as
substrate: an *informational* section of the analysis report, never a
failure.  ``repro_torch.convert``, the bridge that carries the
reference's trees into the port (its tests' way in), is tooling like the
analyzer: it imports the substrate's ``Transformer`` for the LM weights
without making it live.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set

#: subpackages and modules whose modules seed the walk: the reference's
#: roots (the API, the durable store, serving, the dataset generators)
#: plus the port's own entry points (the figure runners, ``python -m
#: repro_torch.quickstart``, the obs CLI, the rank backends' worlds)
ROOT_PACKAGES = ("repro_torch.api", "repro_torch.store",
                 "repro_torch.serve", "repro_torch.data",
                 "repro_torch.figures", "repro_torch.quickstart",
                 "repro_torch.obs", "repro_torch.dist")

#: the analyzer and the cross-package converter: in neither the live nor
#: the substrate set
TOOLING_PACKAGES = ("repro_torch.analysis", "repro_torch.convert")


def _module_name(pkg_dir: str, path: str) -> str:
    rel = os.path.relpath(path, os.path.dirname(pkg_dir))
    parts = rel[:-3].split(os.sep)          # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def import_graph(pkg_dir: Optional[str] = None) -> Dict[str, Set[str]]:
    """``module -> imported repro_torch modules`` over the package tree.

    Edges include every prefix package of a dotted import (importing
    ``repro_torch.a.b`` runs ``repro_torch.a``'s ``__init__`` too) and,
    for ``from repro_torch.a import b``, ``repro_torch.a.b`` when it is a
    module.  Imports inside functions count: the port imports lazily.
    """
    if pkg_dir is None:
        import repro_torch
        pkg_dir = os.path.dirname(os.path.abspath(repro_torch.__file__))
    files = {}
    for root, dirs, names in os.walk(pkg_dir):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                files[_module_name(pkg_dir, path)] = path
    known = set(files)

    def expand(dotted: str) -> Set[str]:
        out = set()
        parts = dotted.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            if prefix in known:
                out.add(prefix)
        return out

    graph: Dict[str, Set[str]] = {}
    for mod, path in files.items():
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        edges: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    edges |= expand(a.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:
                    continue      # the port uses no relative imports
                base = node.module
                edges |= expand(base)
                for a in node.names:
                    edges |= expand(f"{base}.{a.name}")
        graph[mod] = edges - {mod}
    return graph


def _walk(graph: Dict[str, Set[str]], seen: Set[str], start) -> None:
    work = list(start)
    while work:
        for dep in graph.get(work.pop(), ()):
            if dep not in seen:
                seen.add(dep)
                work.append(dep)


def substrate_report(pkg_dir: Optional[str] = None,
                     roots: Sequence[str] = ROOT_PACKAGES
                     ) -> Dict[str, List[str]]:
    """Reachability classification of every module in the package.

    Returns ``{"roots", "reachable", "substrate", "tooling"}``, sorted
    module-name lists.  ``substrate`` is everything the walk from
    ``roots`` (default :data:`ROOT_PACKAGES`) cannot reach;
    ``reachable`` includes the roots.
    """
    graph = import_graph(pkg_dir)
    root_packages = tuple(roots)
    tooling = sorted(m for m in graph if m.startswith(TOOLING_PACKAGES))
    roots = sorted(
        m for m in graph
        if m in root_packages or m.startswith(
            tuple(p + "." for p in root_packages)))
    seen: Set[str] = set(roots)
    _walk(graph, seen, roots)
    # a ``python -m`` entry point of a live package is itself live:
    # nothing imports a __main__, so the plain walk cannot see it
    mains = [m for m in graph
             if m.endswith(".__main__")
             and m.rsplit(".", 1)[0] in seen and m not in seen]
    seen.update(mains)
    _walk(graph, seen, mains)
    reachable = sorted(m for m in seen if m not in tooling)
    substrate = sorted(m for m in graph
                       if m not in seen and m not in tooling)
    return {"roots": roots, "reachable": reachable,
            "substrate": substrate, "tooling": tooling}
