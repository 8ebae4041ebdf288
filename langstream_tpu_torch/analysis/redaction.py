"""LSA2xx — redaction taint: the static twin of the runtime redaction
stance (``validate_flight_dump`` / ``validate_beacon`` / the wire frame
schemas).

Dumps, spans, beacons and wire frames travel to incident channels,
Prometheus and peer replicas — token CONTENT must never ride them. The
runtime validators enforce this on the artifacts tests happen to
produce; this pass enforces it on every construction site in the tree:

- LSA201  a dict literal (or a key-assignment to it) flowing into a
          flight-recorder ``dump(extra=…, counters=…)`` call carries a
          token-content key (``tokens``/``prompt``/``text``/… — the
          ``_FORBIDDEN_KEYS`` set is parsed from
          ``serving/observability.py``, so the runtime denylist and the
          static one cannot drift apart)
- LSA202  same, flowing into ``emit_request_spans`` attributes
- LSA203  the ``beacon_from_engine`` literal carries a forbidden key,
          or omits a field ``validate_beacon`` requires
- LSA204  a wire-frame literal (``"kind": "tokens"/"begin"/…``) carries
          a key outside that kind's schema allowlist — the static twin
          of the ``lstpu-frames-v2``/``lstpu-kvmig-v2`` codecs, which
          silently DROP unknown keys on the binary path (a key the
          codec drops is a protocol change that never happened)

The flow analysis is intra-function: literals at the call site, plus
``name = {...}`` and ``name["key"] = …`` assignments to the same local
in the enclosing function. That is exactly the depth at which the
historical bug shape ("one more debug key in a dump extra") appears.
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
    call_name,
    dict_literal_str_keys,
    enclosing_function,
    literal_str,
)

# fallback only: the live set is parsed out of serving/observability.py
FORBIDDEN_KEYS_FALLBACK = frozenset(
    {"tokens", "token", "prompt", "prompt_tokens", "generated", "text",
     "drafts", "value"}
)

# validate_beacon's required fields (serving/fleet.py) — kept in sync by
# the registry-drift pass reading both sides
BEACON_REQUIRED = (
    "schema", "id", "at", "load_score", "queue_wait_ema_s", "draining",
    "quarantined", "prefixes",
)
# beacons carry digests and counters, never token ids — the runtime
# validator's denylist, applied statically to the construction literal
BEACON_FORBIDDEN = frozenset({"tokens", "prompt", "text", "prompt_tokens"})

# per-kind frame schema allowlists (docs/SERVING.md §17/§18/§21 + the
# v2 codec in serving/wire.py). "prompt_tokens" in a begin/end frame is
# a token LIST by §18 design (migration re-prefill source) / a COUNT in
# an end frame — frames are the data plane; dumps and beacons are where
# token content is forbidden outright.
FRAME_KEYS: dict[str, frozenset] = {
    "tokens": frozenset(
        {"v", "seq", "kind", "tokens", "dfa_state", "replica"}
    ),
    "heartbeat": frozenset({"v", "seq", "kind", "replica"}),
    "end": frozenset(
        {"v", "seq", "kind", "finish_reason", "prompt_tokens",
         "completion_tokens", "ttft_s", "total_s", "engine_ttft_s",
         "usage", "replica", "tokens_per_sec", "failovers"}
    ),
    "error": frozenset(
        {"v", "seq", "kind", "error", "shed", "retry_after_s", "replica"}
    ),
    "route": frozenset(
        {"v", "seq", "kind", "replica", "url", "local", "resumed",
         "disagg", "decision"}
    ),
    "begin": frozenset(
        {"v", "seq", "kind", "length", "digest", "pages", "page_size",
         "bytes_per_page", "tier", "prompt_tokens"}
    ),
    "page": frozenset({"v", "seq", "kind", "i", "data", "raw", "checksum"}),
    "commit": frozenset({"v", "seq", "kind", "pages_sent", "state"}),
}

OBSERVABILITY_REL = SOURCE_ROOT + "/serving/observability.py"
FLEET_REL = SOURCE_ROOT + "/serving/fleet.py"
SERVING_PREFIX = SOURCE_ROOT + "/serving/"


def forbidden_keys(repo: Repo) -> frozenset:
    """Parse ``_FORBIDDEN_KEYS`` out of observability.py so the static
    denylist IS the runtime one."""
    pf = repo.get(OBSERVABILITY_REL)
    if pf is None:
        return FORBIDDEN_KEYS_FALLBACK
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_FORBIDDEN_KEYS"
            for t in node.targets
        ):
            call = node.value
            if (
                isinstance(call, ast.Call)
                and call.args
                and isinstance(call.args[0], (ast.Set, ast.Tuple, ast.List))
            ):
                keys = {
                    literal_str(el)
                    for el in call.args[0].elts
                    if literal_str(el) is not None
                }
                if keys:
                    return frozenset(keys)
    return FORBIDDEN_KEYS_FALLBACK


# ---------------------------------------------------------------------------
# Intra-function dataflow: dict literals + key-stores per local name
# ---------------------------------------------------------------------------


class _FnIndex:
    """Per-function map of local name -> (dict literals assigned to it,
    string keys stored into it)."""

    def __init__(self, fn: ast.AST) -> None:
        self.literals: dict[str, list[ast.Dict]] = {}
        self.stores: dict[str, list[tuple[str, int]]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Dict
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.literals.setdefault(t.id, []).append(node.value)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and literal_str(t.slice) is not None
                    ):
                        self.stores.setdefault(t.value.id, []).append(
                            (literal_str(t.slice), t.lineno)  # type: ignore[arg-type]
                        )


def _arg_keys(
    arg: ast.AST, index: Optional[_FnIndex]
) -> list[tuple[str, int]]:
    """Every statically-visible string key the argument may carry:
    literal keys, one level of ``**spread`` resolution, and key-stores
    on the same local."""
    out: list[tuple[str, int]] = []
    if isinstance(arg, ast.Dict):
        out.extend(dict_literal_str_keys(arg))
        for k, v in zip(arg.keys, arg.values):
            if k is None and isinstance(v, ast.Name) and index is not None:
                for lit in index.literals.get(v.id, ()):
                    out.extend(dict_literal_str_keys(lit))
                out.extend(index.stores.get(v.id, ()))
    elif isinstance(arg, ast.Name) and index is not None:
        for lit in index.literals.get(arg.id, ()):
            out.extend(dict_literal_str_keys(lit))
        out.extend(index.stores.get(arg.id, ()))
    elif isinstance(arg, ast.Call) and call_name(arg) == "dict":
        for kw in arg.keywords:
            if kw.arg is not None:
                out.append((kw.arg, kw.value.lineno))
            else:
                out.extend(_arg_keys(kw.value, index))
    return out


def _fn_index(call: ast.Call) -> Optional[_FnIndex]:
    fn = enclosing_function(call)
    return _FnIndex(fn) if fn is not None else None


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


def _check_dump_call(
    pf: ParsedFile, call: ast.Call, forbidden: frozenset,
    findings: list[Finding],
) -> None:
    if call_name(call) != "dump":
        return
    checked = [kw.value for kw in call.keywords if kw.arg in ("extra", "counters")]
    if not checked:
        return
    index = _fn_index(call)
    for arg in checked:
        for key, line in _arg_keys(arg, index):
            if key in forbidden:
                findings.append(
                    Finding(
                        code="LSA201",
                        path=pf.rel,
                        line=line,
                        message=(
                            f"flight-dump payload carries token-content "
                            f"key {key!r} (validate_flight_dump would "
                            "reject this at incident time)"
                        ),
                    )
                )


def _check_span_call(
    pf: ParsedFile, call: ast.Call, forbidden: frozenset,
    findings: list[Finding],
) -> None:
    if call_name(call) != "emit_request_spans":
        return
    args = []
    if len(call.args) >= 3:
        args.append(call.args[2])
    args.extend(kw.value for kw in call.keywords if kw.arg == "attributes")
    index = _fn_index(call)
    for arg in args:
        for key, line in _arg_keys(arg, index):
            if key in forbidden:
                findings.append(
                    Finding(
                        code="LSA202",
                        path=pf.rel,
                        line=line,
                        message=(
                            f"request-span attributes carry token-content "
                            f"key {key!r} (spans ride /traces to external "
                            "consumers)"
                        ),
                    )
                )


def _check_beacon(pf: ParsedFile, findings: list[Finding]) -> None:
    if pf.rel != FLEET_REL:
        return
    for node in ast.walk(pf.tree):
        if (
            isinstance(node, ast.FunctionDef)
            and node.name == "beacon_from_engine"
        ):
            for ret in ast.walk(node):
                if not (
                    isinstance(ret, ast.Return)
                    and isinstance(ret.value, ast.Dict)
                ):
                    continue
                keys = dict_literal_str_keys(ret.value)
                names = {k for k, _ in keys}
                for key, line in keys:
                    if key in BEACON_FORBIDDEN:
                        findings.append(
                            Finding(
                                code="LSA203",
                                path=pf.rel,
                                line=line,
                                message=(
                                    f"beacon carries token-content key "
                                    f"{key!r} (validate_beacon rejects it)"
                                ),
                            )
                        )
                for req in BEACON_REQUIRED:
                    if req not in names:
                        findings.append(
                            Finding(
                                code="LSA203",
                                path=pf.rel,
                                line=ret.value.lineno,
                                message=(
                                    f"beacon literal omits required "
                                    f"field {req!r} (validate_beacon "
                                    "rejects every beacon this builds)"
                                ),
                            )
                        )


def _frame_kind(d: ast.Dict) -> Optional[str]:
    for k, v in zip(d.keys, d.values):
        if k is not None and literal_str(k) == "kind":
            kind = literal_str(v)
            if kind in FRAME_KEYS:
                return kind
    return None


def _check_frames(pf: ParsedFile, findings: list[Finding]) -> None:
    if not pf.rel.startswith(SERVING_PREFIX):
        return
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Dict):
            continue
        kind = _frame_kind(node)
        if kind is None:
            continue
        allowed = FRAME_KEYS[kind]
        for key, line in dict_literal_str_keys(node):
            if key not in allowed:
                findings.append(
                    Finding(
                        code="LSA204",
                        path=pf.rel,
                        line=line,
                        message=(
                            f"{kind!r} frame carries key {key!r} outside "
                            "the wire schema allowlist (the v2 binary "
                            "codec drops it silently; add it to the "
                            "schema in analysis/redaction.py + "
                            "serving/wire.py or remove it)"
                        ),
                    )
                )
        # key-stores on the variable the literal was assigned to
        fn = enclosing_function(node)
        if fn is None:
            continue
        var: Optional[str] = None
        parent = getattr(node, "_lstpu_parent", None)
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                if isinstance(t, ast.Name):
                    var = t.id
        if var is None:
            continue
        for sub in ast.walk(fn):
            if (
                isinstance(sub, ast.Assign)
                and any(
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == var
                    and literal_str(t.slice) is not None
                    and literal_str(t.slice) not in allowed
                    for t in sub.targets
                )
            ):
                bad = next(
                    literal_str(t.slice)
                    for t in sub.targets
                    if isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == var
                    and literal_str(t.slice) is not None
                    and literal_str(t.slice) not in allowed
                )
                findings.append(
                    Finding(
                        code="LSA204",
                        path=pf.rel,
                        line=sub.lineno,
                        message=(
                            f"{kind!r} frame gains key {bad!r} outside "
                            "the wire schema allowlist"
                        ),
                    )
                )


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    forbidden = forbidden_keys(repo)
    for pf in repo.files:
        if pf.rel.startswith(ANALYSIS_PREFIX):
            continue
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call):
                _check_dump_call(pf, node, forbidden, findings)
                _check_span_call(pf, node, forbidden, findings)
        _check_beacon(pf, findings)
        _check_frames(pf, findings)
    return findings
