"""Safe expression language for steps, filters and templates (the port's
own copy of ``langstream_tpu/agents/genai/el.py``).

Parity: reference `langstream-agents-commons` JSTL engine
(`jstl/JstlEvaluator.java`, `JstlFunctions.java`) — the language used by
`compute` expressions, `when` conditions, gateway filters and prompt
templates. Rebuilt as a whitelisted-AST Python evaluator instead of JSTL:
same surface (record parts as variables, `fn:`-style helpers), no arbitrary
code execution.

Expressions see the record parts as variables: ``value``, ``key``,
``properties``, ``destinationTopic``, ``origin``, ``timestamp``; dotted
access works on dicts (``value.chunk_id``). Helper functions are available
both bare (``lowercase(x)``) and with the reference's ``fn:`` prefix
(``fn:lowercase(x)``). ``fn:``/``util:``-prefixed names ALWAYS resolve to
the function registry, even when a record binding shadows the bare name —
``fn:timestamp()`` calls the helper, bare ``timestamp`` is the record's
event time.
"""

from __future__ import annotations

import ast
import base64
import datetime
import functools
import json
import re
import time
import uuid
from typing import Any, Mapping, Optional

from langstream_tpu_torch.agents.genai.mutable import MutableRecord


class ExpressionError(ValueError):
    pass


# -- helper functions (JstlFunctions parity) --------------------------------


def _to_str(x: Any) -> str:
    if x is None:
        return ""
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    if isinstance(x, (dict, list)):
        return json.dumps(x)
    return str(x)


def _concat(*args: Any) -> str:
    return "".join(_to_str(a) for a in args)


def _coalesce(*args: Any) -> Any:
    for a in args:
        if a is not None:
            return a
    return None


def _timestamp_add(ts: Any, delta: Any, unit: str) -> float:
    base = float(ts)
    mult = {
        "millis": 1e-3, "seconds": 1.0, "minutes": 60.0, "hours": 3600.0,
        "days": 86400.0,
    }.get(unit)
    if mult is None:
        raise ExpressionError(f"unknown time unit {unit!r}")
    return base + float(delta) * mult


FUNCTIONS: dict[str, Any] = {
    # strings
    "uppercase": lambda s: _to_str(s).upper(),
    "lowercase": lambda s: _to_str(s).lower(),
    "trim": lambda s: _to_str(s).strip(),
    "concat": _concat,
    "concat3": _concat,
    "contains": lambda s, sub: _to_str(sub) in _to_str(s),
    "replace": lambda s, a, b: _to_str(s).replace(_to_str(a), _to_str(b)),
    "replaceRegex": lambda s, a, b: re.sub(_to_str(a), _to_str(b), _to_str(s)),
    "split": lambda s, sep: _to_str(s).split(_to_str(sep)),
    "str": _to_str,
    "toString": _to_str,
    "length": lambda x: len(x) if x is not None else 0,
    "len": lambda x: len(x) if x is not None else 0,
    # numbers
    "toInt": lambda x: int(float(x)) if x is not None else None,
    "toDouble": lambda x: float(x) if x is not None else None,
    "abs": abs,
    "min": min,
    "max": max,
    "round": round,
    # json
    "toJson": lambda x: json.dumps(x),
    "fromJson": lambda s: json.loads(_to_str(s)),
    # collections
    "emptyList": lambda: [],
    "emptyMap": lambda: {},
    "listAdd": lambda lst, x: (list(lst or []) + [x]),
    "listOf": lambda *xs: list(xs),
    "mapOf": lambda *kv: {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)},
    "mapPut": lambda m, k, v: {**(m or {}), k: v},
    "listToText": lambda lst, sep=" ": _to_str(sep).join(_to_str(x) for x in (lst or [])),
    "filter": lambda lst, pred: [x for x in (lst or []) if pred(x)],
    # misc
    "coalesce": _coalesce,
    "uuid": lambda: str(uuid.uuid4()),
    "randomUUID": lambda: str(uuid.uuid4()),
    "now": lambda: time.time(),
    "timestamp": lambda: time.time(),
    "currentTimeMillis": lambda: int(time.time() * 1000),
    "timestampAdd": _timestamp_add,
    "dateadd": _timestamp_add,
    "decimalFromUnscaled": lambda unscaled, scale: float(unscaled) / (10 ** int(scale)),
    "base64encode": lambda s: base64.b64encode(_to_str(s).encode()).decode(),
    "base64decode": lambda s: base64.b64decode(_to_str(s)).decode("utf-8", "replace"),
    "fromUnixMillis": lambda ms: datetime.datetime.fromtimestamp(
        float(ms) / 1000, tz=datetime.timezone.utc
    ).isoformat(),
}

_ALLOWED_NODES = (
    ast.Expression, ast.Constant, ast.Name, ast.Load, ast.Attribute,
    ast.Subscript, ast.Index, ast.Slice, ast.Tuple, ast.List, ast.Dict,
    ast.BoolOp, ast.And, ast.Or, ast.UnaryOp, ast.Not, ast.USub, ast.UAdd,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
    ast.Pow, ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt,
    ast.GtE, ast.In, ast.NotIn, ast.Is, ast.IsNot, ast.Call, ast.IfExp,
    ast.keyword,
)


class _Evaluator(ast.NodeVisitor):
    def __init__(self, scope: Mapping[str, Any]):
        self.scope = scope

    def visit(self, node: ast.AST) -> Any:
        if not isinstance(node, _ALLOWED_NODES):
            raise ExpressionError(f"disallowed syntax: {type(node).__name__}")
        return super().visit(node)

    def visit_Expression(self, node: ast.Expression) -> Any:
        return self.visit(node.body)

    def visit_Constant(self, node: ast.Constant) -> Any:
        return node.value

    def visit_Name(self, node: ast.Name) -> Any:
        if node.id.startswith("__fn__"):
            # explicit fn:/util: namespace — registry only, never record scope
            name = node.id[len("__fn__"):]
            if name in FUNCTIONS:
                return FUNCTIONS[name]
            raise ExpressionError(f"unknown function fn:{name}")
        if node.id in self.scope:
            return self.scope[node.id]
        if node.id in FUNCTIONS:
            return FUNCTIONS[node.id]
        if node.id == "true":
            return True
        if node.id == "false":
            return False
        if node.id == "null":
            return None
        raise ExpressionError(f"unknown name {node.id!r}")

    def visit_Attribute(self, node: ast.Attribute) -> Any:
        base = self.visit(node.value)
        if base is None:
            return None
        if isinstance(base, Mapping):
            return base.get(node.attr)
        if node.attr.startswith("_"):
            raise ExpressionError("private attribute access is not allowed")
        return getattr(base, node.attr, None)

    def visit_Subscript(self, node: ast.Subscript) -> Any:
        base = self.visit(node.value)
        if base is None:
            return None
        idx = self.visit(node.slice)
        try:
            return base[idx]
        except (KeyError, IndexError, TypeError):
            return None

    def visit_Slice(self, node: ast.Slice) -> Any:
        return slice(
            self.visit(node.lower) if node.lower else None,
            self.visit(node.upper) if node.upper else None,
            self.visit(node.step) if node.step else None,
        )

    def visit_Tuple(self, node: ast.Tuple) -> Any:
        return tuple(self.visit(e) for e in node.elts)

    def visit_List(self, node: ast.List) -> Any:
        return [self.visit(e) for e in node.elts]

    def visit_Dict(self, node: ast.Dict) -> Any:
        return {
            self.visit(k): self.visit(v)
            for k, v in zip(node.keys, node.values)
            if k is not None
        }

    def visit_BoolOp(self, node: ast.BoolOp) -> Any:
        if isinstance(node.op, ast.And):
            result: Any = True
            for v in node.values:
                result = self.visit(v)
                if not result:
                    return result
            return result
        for v in node.values:
            result = self.visit(v)
            if result:
                return result
        return result

    def visit_UnaryOp(self, node: ast.UnaryOp) -> Any:
        val = self.visit(node.operand)
        if isinstance(node.op, ast.Not):
            return not val
        if isinstance(node.op, ast.USub):
            return -val
        return +val

    def visit_BinOp(self, node: ast.BinOp) -> Any:
        left, right = self.visit(node.left), self.visit(node.right)
        op = type(node.op)
        if op is ast.Add:
            if isinstance(left, str) or isinstance(right, str):
                return _to_str(left) + _to_str(right)
            return left + right
        if op is ast.Sub:
            return left - right
        if op is ast.Mult:
            return left * right
        if op is ast.Div:
            return left / right
        if op is ast.FloorDiv:
            return left // right
        if op is ast.Mod:
            return left % right
        if op is ast.Pow:
            return left**right
        raise ExpressionError(f"disallowed operator {op.__name__}")

    def visit_Compare(self, node: ast.Compare) -> Any:
        left = self.visit(node.left)
        for op, comparator in zip(node.ops, node.comparators):
            right = self.visit(comparator)
            ok = {
                ast.Eq: lambda a, b: a == b,
                ast.NotEq: lambda a, b: a != b,
                ast.Lt: lambda a, b: a < b,
                ast.LtE: lambda a, b: a <= b,
                ast.Gt: lambda a, b: a > b,
                ast.GtE: lambda a, b: a >= b,
                ast.In: lambda a, b: a in b,
                ast.NotIn: lambda a, b: a not in b,
                ast.Is: lambda a, b: a is b,
                ast.IsNot: lambda a, b: a is not b,
            }[type(op)](left, right)
            if not ok:
                return False
            left = right
        return True

    def visit_Call(self, node: ast.Call) -> Any:
        fn = self.visit(node.func)
        if not callable(fn):
            raise ExpressionError("attempt to call a non-function")
        args = [self.visit(a) for a in node.args]
        kwargs = {kw.arg: self.visit(kw.value) for kw in node.keywords if kw.arg}
        return fn(*args, **kwargs)

    def visit_IfExp(self, node: ast.IfExp) -> Any:
        return self.visit(node.body) if self.visit(node.test) else self.visit(node.orelse)


_FN_PREFIX = re.compile(r"\bfn:([A-Za-z_][A-Za-z0-9_]*)")
_UTIL_PREFIX = re.compile(r"\butil:([A-Za-z_][A-Za-z0-9_]*)")


# split into string-literal and code spans so JSTL rewrites never touch
# quoted text ('it!' must stay 'it!', not 'it not ')
_SPANS = re.compile(r"('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")")


def _rewrite_prefixes(e: str) -> str:
    """fn:name / util:name → __fn__name, outside quoted spans. Must run
    BEFORE the ternary rewrite: otherwise the ':' in ``fn:name`` inside a
    ternary branch is mistaken for the ternary separator."""
    parts = _SPANS.split(e)
    return "".join(
        part
        if i % 2
        else _UTIL_PREFIX.sub(r"__fn__\1", _FN_PREFIX.sub(r"__fn__\1", part))
        for i, part in enumerate(parts)
    )


def _rewrite_code(e: str) -> str:
    e = re.sub(r"&&", " and ", e)
    e = re.sub(r"\|\|", " or ", e)
    e = re.sub(r"(?<![=!<>])!(?!=)", " not ", e)
    e = re.sub(r"\beq\b", "==", e)
    e = re.sub(r"\bne\b", "!=", e)
    return e


def _rewrite_ternary(e: str) -> str:
    """JSTL ``cond ? then : else`` → python conditional expression.

    First recurses into every top-level bracketed group (so parenthesized
    nested ternaries anywhere get rewritten), then splits this level on its
    first top-level '?' and the matching ':' — right-associative like JSTL.
    Quoted text is never touched; subscripts/slices keep their ':'."""
    # pass 1: rewrite inside (), [] groups
    out: list[str] = []
    i, n = 0, len(e)
    while i < n:
        ch = e[i]
        if ch in "'\"":
            j = i + 1
            while j < n and (e[j] != ch or e[j - 1] == "\\"):
                j += 1
            out.append(e[i : j + 1])
            i = j + 1
            continue
        if ch in "([":
            close = ")" if ch == "(" else "]"
            depth = 1
            j = i + 1
            while j < n and depth:
                c = e[j]
                if c in "'\"":
                    k = j + 1
                    while k < n and (e[k] != c or e[k - 1] == "\\"):
                        k += 1
                    j = k
                elif c == ch:
                    depth += 1
                elif c == close:
                    depth -= 1
                j += 1
            out.append(ch + _rewrite_ternary(e[i + 1 : j - 1]) + close)
            i = j
            continue
        out.append(ch)
        i += 1
    e = "".join(out)
    # pass 2: split this level's ternary
    depth = 0
    quote: Optional[str] = None
    q_pos = -1
    for i, ch in enumerate(e):
        if quote:
            if ch == quote and e[i - 1] != "\\":
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "?" and depth == 0 and q_pos < 0:
            q_pos = i
        elif ch == ":" and depth == 0 and q_pos >= 0:
            cond = e[:q_pos]
            then = _rewrite_ternary(e[q_pos + 1 : i])
            other = _rewrite_ternary(e[i + 1 :])
            return f"(({then}) if ({cond}) else ({other}))"
    return e


def _rewrite(expression: str) -> str:
    # JSTL artifacts: fn:/util: namespaces, && / || / ! operators, ${...}
    # shell, ternary ?:
    e = expression.strip()
    if e.startswith("${") and e.endswith("}"):
        e = e[2:-1]
    e = _rewrite_prefixes(e)
    e = _rewrite_ternary(e)
    parts = _SPANS.split(e)
    return "".join(
        part if i % 2 else _rewrite_code(part) for i, part in enumerate(parts)
    )


@functools.lru_cache(maxsize=4096)
def _compile(expression: str) -> ast.Expression:
    rewritten = _rewrite(expression)
    try:
        return ast.parse(rewritten, mode="eval")
    except SyntaxError as e:
        raise ExpressionError(f"cannot parse expression {expression!r}: {e}") from e


def scope_for(record: MutableRecord, extra: Optional[Mapping[str, Any]] = None) -> dict:
    scope: dict[str, Any] = {
        "value": record.value,
        "key": record.key,
        "properties": record.properties,
        "headers": record.properties,
        "destinationTopic": record.destination_topic,
        "origin": record.origin,
        "timestamp": record.timestamp,
        "eventTime": record.timestamp,
        "record": record,
    }
    if extra:
        scope.update(extra)
    return scope


def evaluate(expression: str, record: MutableRecord, extra: Optional[Mapping[str, Any]] = None) -> Any:
    """Evaluate an expression against a record's transform context."""
    return _Evaluator(scope_for(record, extra)).visit(_compile(expression))


def evaluate_bool(expression: str, record: MutableRecord, extra: Optional[Mapping[str, Any]] = None) -> bool:
    return bool(evaluate(expression, record, extra))


_MUSTACHE = re.compile(r"\{\{\{?\s*(.*?)\s*\}?\}\}")


def render_template(template: str, record: MutableRecord, extra: Optional[Mapping[str, Any]] = None) -> str:
    """Render ``{{ expr }}`` placeholders (the prompt-template surface of
    ChatCompletionsStep — reference renders Mustache over record fields)."""

    def repl(m: re.Match) -> str:
        return _to_str(evaluate(m.group(1), record, extra))

    return _MUSTACHE.sub(repl, template)
