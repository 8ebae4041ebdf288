"""Grammar-constrained decoding: JSON schema / regex → token-level DFA, and
the device-resident pool of packed grammars (port of
``langstream_tpu/serving/constrain.py``).

A tool-calling agent needs every completion to parse. A request's
``response_format`` (a JSON-schema subset, or a raw regex) compiles on the
host, in numpy, down to a token-level DFA:

    schema ──► regex ──► byte NFA (Thompson) ──► byte DFA (subset
    construction) ──► token DFA: ``next[state, token_id]`` = the DFA state
    after the token's UTF-8 bytes, or -1 when any byte dies.

The host compiler is the JAX package's own, copied: the same grammar gives
the same tables. The dense ``next`` table stays on the host (the mirror the
engine advances per delivered token: completion detection and the
per-position states a speculative verify masks its drafts with). The
device carries the packed twin (``pack_next_table``): a legality bitmask
``bits [S, ceil(V/32)]`` (token ``t`` → bit ``t % 32`` of word ``t //
32``), each state's modal successor ``defaults [S]`` and the sorted
composite-key exceptions ``exc_key [E]`` / ``exc_next [E]`` (``key = state ·
V + token`` for every legal token whose successor is not the default). The
engine masks with the bits (``sampling._expand_allowed``) and advances the
state on the card with a ``searchsorted`` probe of the exceptions, inside
its captured decode chunk and verify.

Invariants the compiler enforces: no reachable state is a dead end (a
constrained row never presents an all ``-inf`` row to the sampler, which
would read as a NaN fault); accepting states with no outgoing byte are
COMPLETE sinks (every token a self-loop; the engine finishes the request
with ``"stop"`` on entry); EOS is legal exactly at accepting states.

``GrammarRegistry`` keeps the four packed planes as torch tensors on the
engine's device — bits ``[G+1, S, W]``, defaults ``[G+1, S]``, exception
key and next ``[G+1, E]``, all int32 (the bits hold the JAX package's
uint32 pattern: torch has no shifts on uint32) — allocated once, row 0 all
legal with a self-loop at state 0 (every base slot rides it). A swap-in
writes one row of each plane in place, from pinned staging copies enqueued
on the caller's current stream (the engine thread's, behind every chunk
already in flight): the captured graphs hold the planes' addresses, so the
tensors are never rebound. Residency is an LRU over rows 1..G with
refcounts pinning the rows active requests read; it is lock-guarded, since
``release()`` runs from a request's finalize hook off the engine thread and
``compile()`` runs on the submitter's thread.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

DEAD = -1
MAX_DFA_STATES = 4096  # subset-construction blowup guard
BITS_PER_WORD = 32  # uint32 legality-bitmask packing width
DEFAULT_GRAMMAR_EXCEPTIONS = 65536  # per-row exception capacity default
# exception-key pad value: strictly greater than any composite key
# state·V+token the registry admits (it enforces S·V < 2**31 - 1), so a
# searchsorted probe can never false-hit a padded tail entry
_EXC_SENTINEL = 2**31 - 1


class GrammarError(ValueError):
    """The response_format cannot be compiled (unsupported construct,
    state blowup, or a dead-end grammar) — fail the REQUEST with this,
    never the engine."""


# ---------------------------------------------------------------------------
# Regex → byte NFA (Thompson construction)
# ---------------------------------------------------------------------------

_EPS = None  # epsilon edge marker


class _Nfa:
    """Mutable NFA under construction: state i's edges are (byteset, to)
    pairs; byteset None = epsilon."""

    def __init__(self) -> None:
        self.edges: list[list[tuple[Optional[frozenset], int]]] = []

    def state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def link(self, a: int, b: int, bytes_: Optional[frozenset] = _EPS) -> None:
        self.edges[a].append((bytes_, b))


_SPECIALS = set("()[]{}|*+?.\\")

_ESCAPES = {
    "d": frozenset(range(0x30, 0x3A)),
    "w": frozenset(
        list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
        + list(range(0x61, 0x7B)) + [0x5F]
    ),
    "s": frozenset([0x20, 0x09, 0x0A, 0x0D]),
    "n": frozenset([0x0A]),
    "t": frozenset([0x09]),
    "r": frozenset([0x0D]),
}

_ANY = frozenset(range(256))


def _parse_class(pattern: str, i: int) -> tuple[frozenset, int]:
    """``[...]`` character class starting at pattern[i] == '['."""
    i += 1
    negate = i < len(pattern) and pattern[i] == "^"
    if negate:
        i += 1
    members: set[int] = set()
    first = True
    while i < len(pattern) and (pattern[i] != "]" or first):
        first = False
        if pattern[i] == "\\" and i + 1 < len(pattern):
            esc = pattern[i + 1]
            if esc in _ESCAPES:
                members |= _ESCAPES[esc]
                i += 2
                continue
            lo = ord(esc)
            i += 2
        else:
            lo = ord(pattern[i])
            i += 1
        if i + 1 < len(pattern) and pattern[i] == "-" and pattern[i + 1] != "]":
            hi_ch = pattern[i + 1]
            hi = ord(hi_ch)
            i += 2
            if hi > 255:
                raise GrammarError(
                    "non-ASCII character in class range: classes operate on "
                    "BYTES (multi-byte UTF-8 cannot join a byte set) — use "
                    "the literal outside a class instead"
                )
            members |= set(range(lo, hi + 1))
        else:
            members.add(lo)
        if lo > 255:
            raise GrammarError(
                "non-ASCII character in class: classes operate on BYTES "
                "(multi-byte UTF-8 cannot join a byte set) — use the "
                "literal outside a class instead"
            )
    if i >= len(pattern):
        raise GrammarError(f"unterminated character class in {pattern!r}")
    i += 1  # closing ]
    byteset = frozenset(range(256)) - frozenset(members) if negate else frozenset(members)
    if not byteset:
        raise GrammarError("empty character class")
    return byteset, i


def _regex_to_nfa(pattern: str) -> tuple[_Nfa, int, int]:
    """Recursive-descent Thompson construction over UTF-8 BYTES (non-ASCII
    literals expand to their byte sequences). Supports literals, escapes,
    ``.``, classes, grouping, alternation, and ``* + ?``."""
    nfa = _Nfa()

    def parse_alt(i: int) -> tuple[int, int, int]:
        s0, a0, i = parse_concat(i)
        starts, accepts = [s0], [a0]
        while i < len(pattern) and pattern[i] == "|":
            s, a, i = parse_concat(i + 1)
            starts.append(s)
            accepts.append(a)
        if len(starts) == 1:
            return starts[0], accepts[0], i
        s, a = nfa.state(), nfa.state()
        for st, ac in zip(starts, accepts):
            nfa.link(s, st)
            nfa.link(ac, a)
        return s, a, i

    def parse_concat(i: int) -> tuple[int, int, int]:
        s = nfa.state()
        a = s
        while i < len(pattern) and pattern[i] not in "|)":
            fs, fa, i = parse_repeat(i)
            nfa.link(a, fs)
            a = fa
        return s, a, i

    def parse_repeat(i: int) -> tuple[int, int, int]:
        atom_start = i
        fs, fa, i = parse_atom(i)
        if i < len(pattern) and pattern[i] in "*+?":
            op = pattern[i]
            i += 1
            s, a = nfa.state(), nfa.state()
            nfa.link(s, fs)
            nfa.link(fa, a)
            if op in "*?":
                nfa.link(s, a)
            if op in "*+":
                nfa.link(fa, fs)
            return s, a, i
        if i < len(pattern) and pattern[i] == "{":
            # bounded repetition {m,n} by atom duplication (re-parse the
            # atom's span once per copy): m mandatory copies chained, then
            # n-m optional ones each epsilon-skippable to the exit. Bounded
            # grammars are what make constrained GENERATION terminate —
            # greedy decode on an unbounded star can legally emit the same
            # byte forever, but a {0,N} run's N+1'th position has only the
            # closing literal legal, so the DFA forces progress.
            end = pattern.find("}", i)
            if end < 0:
                raise GrammarError(f"unterminated {{m,n}} in {pattern!r}")
            spec = pattern[i + 1 : end]
            try:
                if "," in spec:
                    m_s, n_s = spec.split(",", 1)
                    m, n = int(m_s or 0), int(n_s)
                else:
                    m = n = int(spec)
            except ValueError as e:
                raise GrammarError(f"bad repetition {{{spec}}}") from e
            if n < m or m < 0 or n > 512:
                # n == 0 is legal: {0,0} is the epsilon repetition (a
                # maxItems: 1 array emits (,item){0,0} — zero tail items)
                raise GrammarError(f"bad repetition bounds {{{spec}}}")
            atom_src = pattern[atom_start:i]

            def copy_atom() -> tuple[int, int]:
                cs, ca, consumed = parse_atom(atom_start)
                assert consumed == i, (atom_src, consumed, i)
                return cs, ca

            s = nfa.state()
            exit_ = nfa.state()
            a = s
            for _ in range(m):
                cs, ca = copy_atom()
                nfa.link(a, cs)
                a = ca
            for _ in range(n - m):
                nfa.link(a, exit_)  # stopping here is legal
                cs, ca = copy_atom()
                nfa.link(a, cs)
                a = ca
            nfa.link(a, exit_)
            return s, exit_, end + 1
        return fs, fa, i

    def chain_bytes(bs: bytes) -> tuple[int, int]:
        s = nfa.state()
        a = s
        for byte in bs:
            nxt = nfa.state()
            nfa.link(a, nxt, frozenset([byte]))
            a = nxt
        return s, a

    def parse_atom(i: int) -> tuple[int, int, int]:
        ch = pattern[i]
        if ch == "(":
            s, a, i = parse_alt(i + 1)
            if i >= len(pattern) or pattern[i] != ")":
                raise GrammarError(f"unbalanced parens in {pattern!r}")
            return s, a, i + 1
        if ch == "[":
            byteset, i = _parse_class(pattern, i)
            s, a = nfa.state(), nfa.state()
            nfa.link(s, a, byteset)
            return s, a, i
        if ch == ".":
            s, a = nfa.state(), nfa.state()
            nfa.link(s, a, _ANY - frozenset([0x0A]))
            return s, a, i + 1
        if ch == "\\":
            if i + 1 >= len(pattern):
                raise GrammarError(f"trailing backslash in {pattern!r}")
            esc = pattern[i + 1]
            if esc in _ESCAPES:
                s, a = nfa.state(), nfa.state()
                nfa.link(s, a, _ESCAPES[esc])
                return s, a, i + 2
            s, a = chain_bytes(esc.encode("utf-8"))
            return s, a, i + 2
        if ch in "*+?|)":
            raise GrammarError(f"misplaced {ch!r} in {pattern!r}")
        s, a = chain_bytes(ch.encode("utf-8"))
        return s, a, i + 1

    start, accept, i = parse_alt(0)
    if i != len(pattern):
        raise GrammarError(f"unparsed tail {pattern[i:]!r} in {pattern!r}")
    return nfa, start, accept


def _nfa_to_byte_dfa(
    nfa: _Nfa, start: int, accept: int
) -> tuple[np.ndarray, set[int]]:
    """Subset construction → ``byte_next [S, 256]`` int32 (-1 dead) and the
    accepting-state set. State 0 is the start state."""

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for byteset, to in nfa.edges[s]:
                if byteset is _EPS and to not in seen:
                    seen.add(to)
                    stack.append(to)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    ids: dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    for state_set in order:
        row = np.full(256, DEAD, np.int32)
        # group the outgoing byte edges once, then move per byte
        by_byte: dict[int, set[int]] = {}
        for s in state_set:
            for byteset, to in nfa.edges[s]:
                if byteset is _EPS:
                    continue
                for byte in byteset:
                    by_byte.setdefault(byte, set()).add(to)
        for byte, targets in by_byte.items():
            target = closure(frozenset(targets))
            to_id = ids.get(target)
            if to_id is None:
                if len(ids) >= MAX_DFA_STATES:
                    raise GrammarError(
                        f"grammar explodes past {MAX_DFA_STATES} DFA states"
                    )
                to_id = len(ids)
                ids[target] = to_id
                order.append(target)
            row[byte] = to_id
        rows.append(row)
    accepting = {i for ss, i in ids.items() if accept in ss}
    return np.stack(rows), accepting


# ---------------------------------------------------------------------------
# JSON schema (subset) → regex
# ---------------------------------------------------------------------------

# JSON string body: any byte except the quote, the backslash (no escape
# sequences — keeps the DFA byte-local) and the control range JSON forbids
# raw. BOUNDED: every primitive carries a finite repetition so the whole
# grammar is finite — that is what guarantees a constrained generation
# TERMINATES (at the bound, only the closing literal is legal) instead of
# greedy-looping inside an unbounded star until max_new_tokens.
_STRING_CLASS = '[^"\\\\' + "".join(chr(c) for c in range(0x20)) + "]"
_DEFAULT_STRING_MAX = 24
_JSON_INT = r"-?(0|[1-9][0-9]{0,14})"
_JSON_NUMBER = r"-?(0|[1-9][0-9]{0,14})(\.[0-9]{1,6})?"


def _json_string_regex(schema: dict) -> str:
    n = int(schema.get("maxLength", _DEFAULT_STRING_MAX))
    n = max(1, min(n, 256))
    return f'"{_STRING_CLASS}{{0,{n}}}"'


def _regex_escape(text: str) -> str:
    return "".join(f"\\{c}" if c in _SPECIALS else c for c in text)


def schema_to_regex(schema: dict) -> str:
    """Compile a JSON-schema SUBSET to a regex over compact (no-whitespace)
    JSON. Supported: ``object`` with ``properties`` (all emitted, in
    declaration order — the deterministic layout is what makes the grammar
    regular), ``string`` (plus ``enum``/``pattern``), ``integer``,
    ``number``, ``boolean``, ``null``, ``array`` of a supported item type,
    and bare ``enum`` consts. Anything else raises GrammarError — an
    unsupported schema must fail the request loudly, not emit unvalidated
    output."""
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got {type(schema).__name__}")
    if "enum" in schema:
        opts = [
            _regex_escape(json.dumps(v, separators=(",", ":")))
            for v in schema["enum"]
        ]
        if not opts:
            raise GrammarError("empty enum")
        return "(" + "|".join(opts) + ")"
    stype = schema.get("type")
    if stype == "string":
        if "pattern" in schema:
            return '"' + str(schema["pattern"]) + '"'
        return _json_string_regex(schema)
    if stype == "integer":
        return _JSON_INT
    if stype == "number":
        return _JSON_NUMBER
    if stype == "boolean":
        return "(true|false)"
    if stype == "null":
        return "null"
    if stype == "array":
        item = schema_to_regex(schema.get("items", {"type": "string"}))
        max_items = max(1, min(int(schema.get("maxItems", 8)), 64))
        return r"\[(" + item + "(," + item + f"){{0,{max_items - 1}}}" + r")?\]"
    if stype == "object":
        props = schema.get("properties", {})
        if not props:
            raise GrammarError("object schema needs at least one property")
        parts = []
        for name, sub in props.items():
            key = _regex_escape(json.dumps(str(name)))
            parts.append(key + ":" + schema_to_regex(sub))
        return r"\{" + ",".join(parts) + r"\}"
    raise GrammarError(
        f"unsupported schema {json.dumps(schema)[:80]!r}; supported types: "
        "object, array, string, integer, number, boolean, null, enum"
    )


# ---------------------------------------------------------------------------
# Token-level DFA
# ---------------------------------------------------------------------------


@dataclass
class TokenDFA:
    """One compiled grammar, token-level. ``next[s, t] >= 0`` ⇔ token t is
    legal in state s (the device mask IS the sign bit); ``complete`` states
    are sink-accepts — the engine stops the request on entry."""

    next: np.ndarray  # [S, V] int32, -1 = illegal
    accepting: frozenset  # accepting DFA states (EOS legal here)
    complete: frozenset  # sink-accept states (host finishes on entry)
    key: str = ""  # canonical response_format (registry cache key)

    @property
    def n_states(self) -> int:
        return self.next.shape[0]

    def advance(self, state: int, token: int) -> int:
        """Host-mirror advance (engine: one per delivered token)."""
        if state in self.complete:
            return state
        if not (0 <= token < self.next.shape[1]):
            return DEAD
        return int(self.next[state, token])

    def is_complete(self, state: int) -> bool:
        return state in self.complete

    def packed(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The packed device product ``(bits, defaults, exc_key,
        exc_next)`` — computed once per compiled grammar and cached on
        the instance (packing is O(S·V), same order as building ``next``
        itself)."""
        cached = getattr(self, "_packed_cache", None)
        if cached is None:
            cached = pack_next_table(self.next)
            self._packed_cache = cached
        return cached

    @property
    def n_exceptions(self) -> int:
        """Exception rows this grammar needs in the pool (capacity check
        against the registry's ``max_exceptions``)."""
        return int(self.packed()[2].shape[0])


def pack_next_table(
    next_table: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``next [S, V]`` int32 → the packed device representation:

    - ``bits [S, ceil(V/32)]`` uint32 — legality bitmask, LSB-first
      (token ``t`` → bit ``t % 32`` of word ``t // 32``), matching the
      shift/AND expansion in ``sampling._expand_allowed``;
    - ``defaults [S]`` int32 — the state's MODAL successor over its legal
      tokens (0 for all-dead states: padded rows park at state 0);
    - ``exc_key [E]`` int64 / ``exc_next [E]`` int32 — SORTED composite
      keys ``s · V + t`` for every legal token whose successor differs
      from the state default, successor alongside (keys are int64 here;
      the registry casts to int32 after enforcing ``S · V < 2**31``).

    Legal tokens reproduce the dense table EXACTLY (default unless the
    key probe hits an exception). Illegal tokens also resolve to
    default/exception, but they are masked to -inf by the bitmask and
    never sampled, so that value is never delivered."""
    n_states, vocab = next_table.shape
    legal = next_table >= 0
    n_words = (vocab + BITS_PER_WORD - 1) // BITS_PER_WORD
    padded = np.zeros((n_states, n_words * BITS_PER_WORD), dtype=bool)
    padded[:, :vocab] = legal
    weights = np.uint64(1) << np.arange(BITS_PER_WORD, dtype=np.uint64)
    bits = (
        (padded.reshape(n_states, n_words, BITS_PER_WORD).astype(np.uint64)
         * weights).sum(axis=-1)
    ).astype(np.uint32)

    defaults = np.zeros(n_states, np.int32)
    exc_key_parts: list[np.ndarray] = []
    exc_next_parts: list[np.ndarray] = []
    for s in range(n_states):
        row = next_table[s]
        mask = legal[s]
        if not mask.any():
            continue  # unreachable dead state: park at 0, mask all -inf
        counts = np.bincount(row[mask])
        d = int(counts.argmax())
        defaults[s] = d
        toks = np.nonzero(mask & (row != d))[0]
        if toks.size:
            exc_key_parts.append(np.int64(s) * vocab + toks.astype(np.int64))
            exc_next_parts.append(row[toks].astype(np.int32))
    if exc_key_parts:
        # ascending state, ascending token within a state → already sorted
        exc_key = np.concatenate(exc_key_parts)
        exc_next = np.concatenate(exc_next_parts)
    else:
        exc_key = np.zeros(0, np.int64)
        exc_next = np.zeros(0, np.int32)
    return bits, defaults, exc_key, exc_next


def _token_byte_table(
    tokenizer: Any, vocab_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-token UTF-8 byte images, padded: ``bytes_ [V, Lmax]`` +
    ``lengths [V]``. Tokens that decode to nothing (specials, ids past the
    tokenizer's vocab) get length -1 = never legal under any grammar.

    Cached ON the tokenizer object: the table is grammar-INDEPENDENT —
    V decode() calls (seconds at a 256k vocab) must be paid once per
    tokenizer, not once per distinct response_format a client submits."""
    cache = getattr(tokenizer, "_lstpu_token_bytes", None)
    if cache is not None and vocab_size in cache:
        return cache[vocab_size]
    rows: list[bytes] = []
    for t in range(vocab_size):
        try:
            text = tokenizer.decode([t])
        except Exception:  # noqa: BLE001 — undecodable id = unusable token
            text = ""
        rows.append(text.encode("utf-8") if text else b"")
    lmax = max((len(r) for r in rows), default=1) or 1
    bytes_ = np.zeros((vocab_size, lmax), np.int32)
    lengths = np.full(vocab_size, -1, np.int32)
    for t, r in enumerate(rows):
        if not r or "�" in rows[t].decode("utf-8", "replace"):
            continue  # empty or lossy decode: unusable under a byte DFA
        lengths[t] = len(r)
        bytes_[t, : len(r)] = list(r)
    try:
        if cache is None:
            cache = {}
            tokenizer._lstpu_token_bytes = cache
        cache[vocab_size] = (bytes_, lengths)
    except (AttributeError, TypeError):
        pass  # slots-only tokenizer: recompute per grammar, still correct
    return bytes_, lengths


def compile_token_dfa(
    pattern: str,
    tokenizer: Any,
    vocab_size: int,
    eos_token_id: Optional[int] = None,
    key: str = "",
) -> TokenDFA:
    """regex → byte DFA → token DFA over the MODEL vocab (ids past the
    tokenizer's vocab are simply never legal — constrained decoding also
    fences off the padding ids random weights love to argmax into).

    The token table is built vectorized: one [V]-wide numpy advance per
    byte position per start state, not a V×S python loop — a 256k vocab
    compiles in seconds, and the registry caches the result anyway."""
    byte_next, accepting = _nfa_to_byte_dfa(*_regex_to_nfa(pattern))
    n_states = byte_next.shape[0]
    tok_bytes, tok_lens = _token_byte_table(tokenizer, vocab_size)
    lmax = tok_bytes.shape[1]

    # pad the byte table with a dead row so vectorized advance can index
    # state -1 safely (dead stays dead)
    padded = np.vstack([byte_next, np.full((1, 256), DEAD, np.int32)])

    next_table = np.full((n_states, vocab_size), DEAD, np.int32)
    usable = tok_lens > 0
    for s in range(n_states):
        states = np.full(vocab_size, s, np.int32)
        for p in range(lmax):
            active = usable & (tok_lens > p)
            if not active.any():
                break
            states = np.where(
                active, padded[states, tok_bytes[:, p]], states
            )
        states = np.where(usable, states, DEAD)
        next_table[s] = states

    # sink-accept states: accepting with NO outgoing byte transition —
    # generation is COMPLETE there. Self-loop every token so the device
    # row is never all -inf; the engine finishes the request on entry
    # before any self-loop token is delivered.
    complete = {
        s for s in accepting if not (byte_next[s] >= 0).any()
    }
    for s in complete:
        next_table[s, :] = s
    # EOS legal exactly at accepting states (stopping there leaves output
    # that matches the grammar)
    if eos_token_id is not None and 0 <= eos_token_id < vocab_size:
        for s in accepting:
            next_table[s, eos_token_id] = s
    # no-dead-end check: a state with zero legal tokens would hand the
    # sampler an all -inf row (reads as a NaN fault). Unreachable states
    # can be dead; reachable ones cannot.
    reachable = {0}
    frontier = [0]
    while frontier:
        s = frontier.pop()
        for t in set(next_table[s][next_table[s] >= 0].tolist()):
            if t not in reachable:
                reachable.add(t)
                frontier.append(t)
    for s in reachable:
        if not (next_table[s] >= 0).any():
            raise GrammarError(
                f"grammar has a dead end at DFA state {s}: no token in the "
                "vocabulary can continue it (tokenizer/grammar mismatch?)"
            )
    return TokenDFA(
        next=next_table,
        accepting=frozenset(accepting),
        complete=frozenset(complete),
        key=key,
    )


def compile_response_format(
    response_format: dict,
    tokenizer: Any,
    vocab_size: int,
    eos_token_id: Optional[int] = None,
) -> TokenDFA:
    """``response_format`` (the OpenAI-compatible request field) → TokenDFA.
    Supported: ``{"type": "json_schema", "json_schema": {"schema": {...}}}``
    (the nested ``{"schema": ...}`` and flat spellings both work) and
    ``{"type": "regex", "regex": "..."}``."""
    if not isinstance(response_format, dict):
        raise GrammarError("response_format must be an object")
    kind = str(response_format.get("type", ""))
    if kind == "regex":
        pattern = response_format.get("regex")
        if not pattern:
            raise GrammarError("response_format type=regex needs a 'regex' key")
        pattern = str(pattern)
    elif kind == "json_schema":
        schema = response_format.get("json_schema", response_format.get("schema"))
        if isinstance(schema, dict) and "schema" in schema:
            schema = schema["schema"]
        if not isinstance(schema, dict):
            raise GrammarError(
                "response_format type=json_schema needs a schema object"
            )
        pattern = schema_to_regex(schema)
    else:
        raise GrammarError(
            f"unsupported response_format type {kind!r}; "
            "supported: json_schema, regex"
        )
    key = json.dumps(response_format, sort_keys=True, separators=(",", ":"))
    return compile_token_dfa(
        pattern, tokenizer, vocab_size, eos_token_id, key=key
    )



# ---------------------------------------------------------------------------
# Device-resident grammar pool (the registry)
# ---------------------------------------------------------------------------


def grammar_pool_bytes(
    slots: int,
    states: int,
    vocab_size: int,
    exceptions: int = DEFAULT_GRAMMAR_EXCEPTIONS,
) -> int:
    """Bytes of the packed pool (the memory plan's term): bits ``[G+1, S,
    ceil(V/32)]`` + defaults ``[G+1, S]`` + exception key / next ``[G+1,
    E]``, 4 bytes an entry. ``slots <= 0`` is the disabled contract:
    constrained decoding off, 0 bytes, and the registry refuses
    construction."""
    if slots <= 0:
        return 0
    rows = slots + 1
    words = (vocab_size + BITS_PER_WORD - 1) // BITS_PER_WORD
    per_row = states * words * 4 + states * 4 + 2 * max(0, exceptions) * 4
    return rows * per_row


@dataclass
class _GrammarState:
    dfa: TokenDFA
    row: Optional[int] = None
    refs: int = 0
    last_used: int = 0


class GrammarRegistry:
    """Compile cache + device residency for token DFAs: row 0 unconstrained
    (all tokens legal, self-loop at state 0), rows 1..G swapped in LRU,
    refcounts pinning the rows active requests read."""

    _GUARDED = {
        "_lock": (
            "_by_key",
            "_row_owner",
            "_free_rows",
            "_tick",
            "compiled_total",
            "swaps_total",
        ),
    }

    def __init__(
        self,
        tokenizer: Any,
        vocab_size: int,
        eos_token_id: Optional[int],
        slots: int = 64,
        max_states: int = 128,
        max_exceptions: int = DEFAULT_GRAMMAR_EXCEPTIONS,
        device: DeviceLike = "cuda",
    ) -> None:
        if slots < 1:
            raise ValueError(
                "grammar-slots <= 0 disables constrained decoding "
                "(grammar_pool_bytes(slots<=0) == 0 is the same "
                "zero/disabled contract); the registry is only built "
                f"with slots >= 1, got slots={slots}"
            )
        if max_states < 2 or max_exceptions < 1:
            raise ValueError(
                f"grammar pool needs >= 2 states and >= 1 exception row; "
                f"got max_states={max_states} "
                f"max_exceptions={max_exceptions}"
            )
        if int(max_states) * int(vocab_size) > _EXC_SENTINEL:
            raise ValueError(
                "grammar-states × vocab_size must stay below 2**31 - 1: "
                "the device transition probe uses int32 composite keys "
                f"(state·V+token); got {max_states} × {vocab_size}"
            )
        self.tokenizer = tokenizer
        self.vocab_size = int(vocab_size)
        self.eos_token_id = eos_token_id
        self.slots = int(slots)
        self.max_states = int(max_states)
        self.max_exceptions = int(max_exceptions)
        self.n_words = (self.vocab_size + BITS_PER_WORD - 1) // BITS_PER_WORD
        self.device = resolve_device(device)
        rows = self.slots + 1
        dev = self.device
        # row 0: every token legal (all bits set: -1 as int32), self-loop at
        # state 0 (defaults 0, no exceptions). Rows 1..G start all-illegal
        # and park at state 0 until a swap-in.
        bits = torch.zeros((rows, self.max_states, self.n_words), dtype=torch.int32, device=dev)
        bits[0] = -1
        self.pool = (
            bits,
            torch.zeros((rows, self.max_states), dtype=torch.int32, device=dev),
            torch.full((rows, self.max_exceptions), _EXC_SENTINEL, dtype=torch.int32, device=dev),
            torch.zeros((rows, self.max_exceptions), dtype=torch.int32, device=dev),
        )
        self.pool_bytes = grammar_pool_bytes(
            self.slots, self.max_states, self.vocab_size, self.max_exceptions
        )
        self._by_key: dict[str, _GrammarState] = {}
        self._row_owner: dict[int, _GrammarState] = {}
        self._free_rows = list(range(self.slots, 0, -1))
        self._tick = 0
        self._lock = threading.Lock()
        # cumulative stats; swap_s_total is the host time of the swap-ins
        # (packing and staging; the copies themselves run on the stream)
        self.compiled_total = 0
        self.swaps_total = 0
        self.swap_s_total = 0.0

    # -- compile cache (any thread: submit() compiles on the caller's) ------

    def compile(self, response_format: dict) -> TokenDFA:
        key = json.dumps(response_format, sort_keys=True, separators=(",", ":"))
        with self._lock:
            state = self._by_key.get(key)
        if state is not None:
            return state.dfa
        dfa = compile_response_format(
            response_format, self.tokenizer, self.vocab_size, self.eos_token_id
        )
        if dfa.n_states > self.max_states:
            raise GrammarError(
                f"grammar needs {dfa.n_states} DFA states but the pool is "
                f"sized for {self.max_states}; raise grammar-states"
            )
        if dfa.n_exceptions > self.max_exceptions:
            raise GrammarError(
                f"grammar needs {dfa.n_exceptions} transition exceptions "
                f"but the pool is sized for {self.max_exceptions}; raise "
                "grammar-exceptions"
            )
        with self._lock:
            state = self._by_key.get(key)
            if state is None:
                state = _GrammarState(dfa=dfa)
                self._by_key[key] = state
                self.compiled_total += 1
        return state.dfa

    # -- residency (engine thread) ------------------------------------------

    def acquire(self, dfa: TokenDFA) -> int:
        """Pool row of a compiled grammar, swapped in when absent.
        Refcounted; ``release()`` when the request finishes."""
        with self._lock:
            state = self._by_key.get(dfa.key)
            if state is None:  # compiled outside the cache (tests)
                state = _GrammarState(dfa=dfa)
                self._by_key[dfa.key] = state
            self._tick += 1
            state.last_used = self._tick
            if state.row is None:
                self._swap_in_locked(state)
            state.refs += 1
            return state.row

    def release(self, dfa: TokenDFA) -> None:
        with self._lock:
            state = self._by_key.get(dfa.key)
            if state is None:
                return
            assert state.refs > 0
            state.refs -= 1

    def _swap_in_locked(self, state: _GrammarState) -> None:
        t0 = time.monotonic()
        if not self._free_rows:
            victims = [s for s in self._row_owner.values() if s.refs == 0]
            if not victims:
                raise GrammarError(
                    f"all {self.slots} grammar rows are pinned by active "
                    "requests; raise grammar-slots or retry"
                )
            victim = min(victims, key=lambda s: s.last_used)
            self._free_rows.append(victim.row)
            self._row_owner.pop(victim.row, None)
            victim.row = None
        bits, defaults, exc_key, exc_next = state.dfa.packed()
        n = state.dfa.n_states
        n_exc = exc_key.shape[0]
        if n_exc > self.max_exceptions:  # acquire() bypassing compile()
            raise GrammarError(
                f"grammar needs {n_exc} transition exceptions but the "
                f"pool is sized for {self.max_exceptions}; raise "
                "grammar-exceptions"
            )
        row = self._free_rows.pop()
        pb = np.zeros((self.max_states, self.n_words), np.uint32)
        pb[:n] = bits
        pd = np.zeros(self.max_states, np.int32)
        pd[:n] = defaults
        pk = np.full(self.max_exceptions, _EXC_SENTINEL, np.int32)
        # int32 is safe: __init__ enforces max_states·V < 2**31
        pk[:n_exc] = exc_key.astype(np.int32)
        pn = np.zeros(self.max_exceptions, np.int32)
        pn[:n_exc] = exc_next
        for plane, host in zip(self.pool, (pb.view(np.int32), pd, pk, pn)):
            plane[row].copy_(_staged(host, plane.device), non_blocking=True)
        state.row = row
        self._row_owner[row] = state
        self.swaps_total += 1
        self.swap_s_total += time.monotonic() - t0

    def warmup(self) -> None:
        """Nothing to warm: the JAX registry compiles its row-upload
        program here, and a swap-in of this one is four in-place row
        copies. Kept for the registry's interface. The tokenizer's byte
        table is built at the first compile, as in the JAX package (at
        start it would cost every engine V decodes, grammars or not)."""

    @property
    def resident(self) -> int:
        return len(self._row_owner)

    def stats(self) -> dict[str, Any]:
        return {
            "compiled": self.compiled_total,
            "resident": self.resident,
            "slots": self.slots,
            "states": self.max_states,
            "exceptions": self.max_exceptions,
            "swaps-total": self.swaps_total,
            "pool-bytes": self.pool_bytes,
        }


def _staged(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array ready for an asynchronous copy to ``device``: pinned on
    the card's host (the caching host allocator keeps the block until the
    copy ran), a copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    return t.pin_memory() if device.type == "cuda" else t.clone()


def verify_states(
    dfa: TokenDFA, state: int, drafts: Iterable[int]
) -> list[int]:
    """Per-position DFA states of a speculative verify: position j's state
    is reached after consuming drafts 0..j-1 from ``state``. An ILLEGAL
    draft's successors carry the last legal state forward — those
    positions are never consumed (the illegal draft is rejected at j by its
    -inf logit), but their mask rows must stay well-formed (≥1 legal
    token)."""
    out = [state]
    cur = state
    for d in drafts:
        nxt = dfa.advance(cur, int(d))
        cur = cur if nxt < 0 else nxt
        out.append(cur)
    return out
