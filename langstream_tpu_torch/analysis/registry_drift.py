"""LSA4xx — registry drift: fault sites, dump reasons, knobs and
metric names must stay in sync with their chaos tests, docs sections
and Grafana panels.

Every subsystem since round 6 keeps a registry whose entries fan out
into other artifacts: ``faultinject.SITES`` entries get chaos drills
and a §9 docs row, ``DUMP_REASONS`` entries get schema tests,
``tpu-serving`` knobs get a docs knob-table row, and every metric a
dashboard panel queries must actually be registered somewhere. Those
cross-checks used to run piecemeal at test time
(``test_metrics_artifacts.py``); this pass is their single static
home:

- LSA401  a fault-site string consulted via ``fires("…")`` that
          ``faultinject.SITES`` does not register (the injector would
          raise at runtime — but only on the code path that consults
          it, which is exactly the path chaos never exercised)
- LSA402  a dump reason passed to ``FlightRecorder.dump("…")`` that
          ``DUMP_REASONS`` does not register (validate_flight_dump
          rejects the artifact at incident time)
- LSA403  a registered fault site or dump reason with no test
          coverage (string absent from the port's tests,
          ``tests/test_torch_*.py``) or no docs mention (absent from
          the docs below) — a failure story that has never executed is
          a comment, not a feature
- LSA404  a ``tpu-serving`` config knob read in the port's provider
          (``ai/torch_serving.py``: ``.get("knob")`` or ``["knob"]`` on
          its resource dict) that the docs never mention (an
          undocumented knob is an unsupported knob)
- LSA405  a Grafana dashboard ``__name__`` matcher whose metric suffix
          nothing in the source registers (a panel that can never show
          data)

The docs are ``docs/SERVING.md`` (the port's knobs keep the JAX
package's names) plus the README's section on the port, for what the port
alone adds.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Optional

from langstream_tpu_torch.analysis.core import (
    ANALYSIS_PREFIX,
    SOURCE_ROOT,
    Finding,
    Repo,
    call_name,
    literal_str,
)

FAULTINJECT_REL = SOURCE_ROOT + "/serving/faultinject.py"
OBSERVABILITY_REL = SOURCE_ROOT + "/serving/observability.py"
PROVIDER_REL = SOURCE_ROOT + "/ai/torch_serving.py"
DASHBOARD_REL = "docker/metrics/dashboards/serving.json"
DOCS_REL = "docs/SERVING.md"
README_REL = "README.md"
#: the README section on the port: from this heading to the next ``## ``
README_PORT_HEADING = "## PyTorch port"
#: the port's tests: the only coverage evidence
TESTS_DIR = "tests"
TESTS_PREFIX = "test_torch_"
#: the name the provider's resource dict is read through
RESOURCE_NAME = "resource"

_METRIC_REG_RE = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*\"([a-z0-9_]+)\""
)


def _tuple_entries(
    repo: Repo, rel: str, name: str
) -> Optional[list[tuple[str, int]]]:
    """Entries (value, line) of a module-level tuple-of-strings
    assignment like ``SITES = (…)``."""
    pf = repo.get(rel)
    if pf is None:
        return None
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            if isinstance(node.value, (ast.Tuple, ast.List)):
                out = []
                for el in node.value.elts:
                    s = literal_str(el)
                    if s is not None:
                        out.append((s, el.lineno))
                return out
    return None


def _read_corpus(
    root: str, sub: str, suffix: str = ".py", prefix: str = ""
) -> str:
    chunks = []
    base = os.path.join(root, sub)
    if not os.path.isdir(base):
        return ""
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.startswith(prefix) and fn.endswith(suffix):
                try:
                    with open(
                        os.path.join(dirpath, fn), encoding="utf-8"
                    ) as f:
                        chunks.append(f.read())
                except OSError:
                    pass
    return "\n".join(chunks)


def _read_file(root: str, rel: str) -> str:
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def _docs_text(root: str) -> str:
    """``docs/SERVING.md`` plus the README's section on the port."""
    readme = _read_file(root, README_REL)
    at = readme.find(README_PORT_HEADING)
    port = ""
    if at >= 0:
        end = readme.find("\n## ", at + len(README_PORT_HEADING))
        port = readme[at:] if end < 0 else readme[at:end]
    return _read_file(root, DOCS_REL) + "\n" + port


def _check_fires_literals(
    repo: Repo, sites: set[str], findings: list[Finding]
) -> None:
    for pf in repo.files:
        if pf.rel == FAULTINJECT_REL or pf.rel.startswith(ANALYSIS_PREFIX):
            continue
        for node in ast.walk(pf.tree):
            if not (
                isinstance(node, ast.Call) and call_name(node) == "fires"
            ):
                continue
            for arg in node.args[:1]:
                site = literal_str(arg)
                if site is not None and site not in sites:
                    findings.append(
                        Finding(
                            code="LSA401",
                            path=pf.rel,
                            line=node.lineno,
                            message=(
                                f"fault site {site!r} is consulted here "
                                "but faultinject.SITES does not register "
                                "it — the injector raises on the exact "
                                "path chaos never exercised"
                            ),
                        )
                    )


def _check_dump_reasons(
    repo: Repo, reasons: set[str], findings: list[Finding]
) -> None:
    for pf in repo.files:
        if pf.rel == OBSERVABILITY_REL or pf.rel.startswith(ANALYSIS_PREFIX):
            continue
        for node in ast.walk(pf.tree):
            if not (
                isinstance(node, ast.Call) and call_name(node) == "dump"
            ):
                continue
            reason = None
            if node.args:
                reason = literal_str(node.args[0])
            for kw in node.keywords:
                if kw.arg == "reason":
                    reason = literal_str(kw.value)
            # only flag calls that look like FlightRecorder.dump —
            # they carry reason/extra/counters kwargs or a known-style
            # reason string; json.dump(obj, fh) passes a non-literal
            if reason is not None and reason not in reasons:
                findings.append(
                    Finding(
                        code="LSA402",
                        path=pf.rel,
                        line=node.lineno,
                        message=(
                            f"dump reason {reason!r} is not in "
                            "observability.DUMP_REASONS — "
                            "validate_flight_dump rejects the artifact "
                            "at incident time"
                        ),
                    )
                )


def _check_coverage(
    entries: list[tuple[str, int]],
    rel: str,
    what: str,
    tests_corpus: str,
    docs_text: str,
    findings: list[Finding],
) -> None:
    for value, line in entries:
        # substring, not exact-quoted: chaos specs reference sites as
        # "migrate@1" / "weights:0.5" compounds, so the bare value is
        # the only stable token
        if value not in tests_corpus:
            findings.append(
                Finding(
                    code="LSA403",
                    path=rel,
                    line=line,
                    message=(
                        f"{what} {value!r} has no test coverage (the "
                        "string appears in no tests/test_torch_*.py) — "
                        "drills before registries"
                    ),
                )
            )
        if value not in docs_text:
            findings.append(
                Finding(
                    code="LSA403",
                    path=rel,
                    line=line,
                    message=(
                        f"{what} {value!r} is undocumented "
                        f"({DOCS_REL} and the README's port section "
                        "never mention it)"
                    ),
                )
            )


def _is_resource(node: ast.AST, aliases: set[str]) -> bool:
    """``self.resource`` / ``resource``, or a local bound to one of them
    (``r = self.resource``)."""
    if isinstance(node, ast.Attribute):
        return node.attr == RESOURCE_NAME
    if isinstance(node, ast.Name):
        return node.id == RESOURCE_NAME or node.id in aliases
    return False


def _knob_reads(repo: Repo) -> list[tuple[str, int]]:
    pf = repo.get(PROVIDER_REL)
    if pf is None:
        return []
    aliases: set[str] = set()
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Assign) and _is_resource(node.value, set()):
            aliases.update(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
    out = []
    seen = set()
    for node in ast.walk(pf.tree):
        knob = None
        if (
            isinstance(node, ast.Call)
            and call_name(node) == "get"
            and isinstance(node.func, ast.Attribute)
            and _is_resource(node.func.value, aliases)
            and node.args
        ):
            knob = literal_str(node.args[0])
        elif (
            isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            and _is_resource(node.value, aliases)
        ):
            knob = literal_str(node.slice)
        if knob is not None and knob not in seen:
            seen.add(knob)
            out.append((knob, node.lineno))
    out.sort(key=lambda kv: kv[1])
    return out


def _dashboard_suffixes(root: str) -> list[str]:
    text = _read_file(root, DASHBOARD_REL)
    if not text:
        return []
    try:
        doc = json.loads(text)
    except ValueError:
        return []
    exprs = [
        t["expr"]
        for panel in doc.get("panels", [])
        for t in panel.get("targets", [])
        if "expr" in t
    ]
    joined = "\n".join(exprs)
    return re.findall(r'__name__=~\\?"([^"\\]+)', joined)


def _registered_metric_names(repo: Repo) -> set[str]:
    names: set[str] = set()
    for pf in repo.files:
        names.update(_METRIC_REG_RE.findall(pf.source))
    for hist_name in ("ENGINE_HISTOGRAMS", "FLEET_HISTOGRAMS"):
        pf = repo.get(OBSERVABILITY_REL)
        if pf is None:
            continue
        for node in ast.walk(pf.tree):
            if (
                isinstance(node, (ast.Assign, ast.AnnAssign))
                and isinstance(node.value, ast.Dict)
            ):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if any(
                    isinstance(t, ast.Name) and t.id == hist_name
                    for t in targets
                ):
                    for k in node.value.keys:
                        h = literal_str(k) if k is not None else None
                        if h is not None:
                            names.add(h)
                            names.update(
                                {f"{h}_bucket", f"{h}_sum", f"{h}_count"}
                            )
    return names


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    root = repo.root

    sites = _tuple_entries(repo, FAULTINJECT_REL, "SITES") or []
    reasons = _tuple_entries(repo, OBSERVABILITY_REL, "DUMP_REASONS") or []
    tests_corpus = _read_corpus(root, TESTS_DIR, prefix=TESTS_PREFIX)
    docs_text = _docs_text(root)

    if sites:
        _check_fires_literals(repo, {s for s, _ in sites}, findings)
        _check_coverage(
            sites, FAULTINJECT_REL, "fault site", tests_corpus, docs_text,
            findings,
        )
    if reasons:
        _check_dump_reasons(repo, {r for r, _ in reasons}, findings)
        _check_coverage(
            reasons, OBSERVABILITY_REL, "dump reason", tests_corpus,
            docs_text, findings,
        )

    for knob, line in _knob_reads(repo):
        if knob not in docs_text:
            findings.append(
                Finding(
                    code="LSA404",
                    path=PROVIDER_REL,
                    line=line,
                    message=(
                        f"tpu-serving knob {knob!r} is read here but "
                        f"neither {DOCS_REL} nor the README's port "
                        "section documents it — an undocumented knob is "
                        "an unsupported knob"
                    ),
                )
            )

    registered = _registered_metric_names(repo)
    if registered:
        for regex in _dashboard_suffixes(root):
            suffix = regex.rsplit("_completions_", 1)[-1].rsplit(".+_", 1)[-1]
            if suffix not in registered:
                findings.append(
                    Finding(
                        code="LSA405",
                        path=DASHBOARD_REL,
                        line=1,
                        message=(
                            f"dashboard matcher {regex!r} references "
                            f"metric suffix {suffix!r} that nothing in "
                            "the source registers — the panel can never "
                            "show data"
                        ),
                    )
                )
    return findings
