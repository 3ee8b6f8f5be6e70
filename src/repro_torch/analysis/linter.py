"""The AST lint engine: file collection, suppression, rule running (twin
of ``repro/analysis/linter.py``).

Linting is pure ``ast`` work: it imports no torch and runs on a machine
with no card and no compiler.

Suppression policy
------------------
A finding is suppressed by a directive comment on the same line or the
line directly above::

    zl = torch.einsum("...n,...nd->...d", lam, Z)  # repro: noqa[raw-einsum-in-plan] — reason

The *reason is mandatory*: a ``noqa`` without one does not suppress and
instead raises a ``bare-noqa`` finding (a suppression is an attestation,
and an attestation without a reason says nothing).  A directive naming a
rule id that does not exist raises ``unknown-noqa``, and a ``# repro:``
comment that does not parse raises ``malformed-noqa``.  The rule id
``*`` suppresses every rule on that line (discouraged; it still needs a
reason).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the package directory that rule paths are relative to
PACKAGE = "repro_torch"

#: a noqa directive with an optional ``— reason`` tail.  The dash may be
#: an em or en dash or ASCII hyphen(s); the reason is whatever non-empty
#: text follows it.
_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa\[([A-Za-z0-9_*-]+)\]\s*(?:[—–-]+\s*(\S.*))?")
#: any directive-prefixed comment, to catch malformed ones
_DIRECTIVE_RE = re.compile(r"#\s*repro:")


@dataclasses.dataclass
class Finding:
    """One lint or audit finding.

    ``suppressed`` findings are still reported (in the JSON report's
    ``suppressed`` section, with their ``reason``) but do not fail the
    run.
    """
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def location(self) -> str:
        """``path:line``, the anchor used in text output."""
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        """Plain-dict form (the JSON report's rows)."""
        return dataclasses.asdict(self)


class SourceModule:
    """A parsed source file plus its suppression directives.

    ``path`` is used in findings (it need not exist on disk when
    ``source`` is given directly, see :func:`lint_source`).
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self.relpath = package_relpath(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> (rule id, reason); filled by _scan_noqa
        self.noqa: Dict[int, Tuple[str, str]] = {}
        self.directive_findings: List[Finding] = []
        self._scan_noqa()

    def _comments(self) -> Iterable[Tuple[int, str]]:
        """(line, text) of every real COMMENT token: tokenizing, not a
        raw line scan, keeps directive examples inside docstrings from
        counting as directives."""
        try:
            toks = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            return [(t.start[0], t.string) for t in toks
                    if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):
            return list(enumerate(self.lines, start=1))

    def _scan_noqa(self) -> None:
        from repro_torch.analysis import rules as rules_mod
        for i, text in self._comments():
            if not _DIRECTIVE_RE.search(text):
                continue
            m = _NOQA_RE.search(text)
            if m is None:
                self.directive_findings.append(Finding(
                    "malformed-noqa", self.path, i,
                    "unparseable '# repro:' directive (expected "
                    "'# repro: noqa[rule-id] — reason')"))
                continue
            rule_id, reason = m.group(1), m.group(2)
            if rule_id != "*" and not rules_mod.is_known(rule_id):
                self.directive_findings.append(Finding(
                    "unknown-noqa", self.path, i,
                    f"noqa names unknown rule {rule_id!r}"))
                continue
            if not (reason or "").strip():
                self.directive_findings.append(Finding(
                    "bare-noqa", self.path, i,
                    f"noqa[{rule_id}] has no reason: a suppression is an "
                    "attestation and must say why the site is safe"))
                continue  # a bare noqa does NOT suppress
            self.noqa[i] = (rule_id, reason.strip())

    def suppression_for(self, rule_id: str, line: int) -> Optional[str]:
        """The attested reason suppressing ``rule_id`` at ``line`` (same
        line or the line directly above), else ``None``."""
        for ln in (line, line - 1):
            entry = self.noqa.get(ln)
            if entry and entry[0] in (rule_id, "*"):
                return entry[1]
        return None


def package_relpath(path: str) -> str:
    """Path relative to the innermost ``repro_torch`` package directory
    (``.../src/repro_torch/engine/plan.py`` -> ``engine/plan.py``); files
    outside the package keep their basename.  Rules scope on this, so it
    must anchor on the port's own directory: anchored on ``repro``, every
    port file would fall back to its basename and every path-scoped rule
    would stop applying."""
    parts = os.path.abspath(path).split(os.sep)
    for i in range(len(parts) - 2, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i + 1:])
    return parts[-1]


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files and directories into a sorted list of ``.py`` files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                out.extend(os.path.join(root, f) for f in files
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(set(out))


def lint_module(mod: SourceModule, rules: Optional[Iterable] = None,
                all_paths: bool = False) -> List[Finding]:
    """Run ``rules`` (default: the whole registry) over one module.

    ``all_paths=True`` bypasses each rule's path scope: the fixture tests
    use it, whose files lie outside the package.
    """
    from repro_torch.analysis import rules as rules_mod
    active = list(rules) if rules is not None else rules_mod.all_rules()
    findings = list(mod.directive_findings)
    for rule in active:
        if not all_paths and not rule.applies(mod.relpath):
            continue
        for f in rule.check(mod):
            reason = mod.suppression_for(f.rule, f.line)
            if reason is not None:
                f.suppressed, f.reason = True, reason
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_paths(paths: Sequence[str], rules: Optional[Iterable] = None,
               all_paths: bool = False) -> List[Finding]:
    """Lint every ``.py`` file under ``paths``; returns ALL findings
    (suppressed ones carry ``suppressed=True`` and their reason)."""
    findings: List[Finding] = []
    for path in collect_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            mod = SourceModule(path, source)
        except SyntaxError as e:
            findings.append(Finding(
                "syntax-error", path, e.lineno or 1, str(e.msg)))
            continue
        findings.extend(lint_module(mod, rules, all_paths=all_paths))
    return findings


def lint_source(source: str, path: str = "<memory>",
                rules: Optional[Iterable] = None,
                all_paths: bool = True) -> List[Finding]:
    """Lint a source *string* (the tests use this)."""
    return lint_module(SourceModule(path, source), rules,
                       all_paths=all_paths)


def render_text(findings: Sequence[Finding],
                show_suppressed: bool = False) -> str:
    """Human-readable report, one ``path:line [rule] message`` a line."""
    out = []
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        tag = f" (suppressed: {f.reason})" if f.suppressed else ""
        out.append(f"{f.location()}: [{f.rule}] {f.message}{tag}")
    live = sum(1 for f in findings if not f.suppressed)
    out.append(f"{live} finding(s), {len(findings) - live} suppressed")
    return "\n".join(out)
