"""The YAML reader of the port's application parser: the subset of YAML that
application files use, read into the values ``yaml.safe_load`` gives (the
card's machine has no PyYAML).

Read: one document (an optional ``---`` first), block mappings and
sequences (compact forms ``- key: v`` and ``- - x`` included), flow
collections ``[...]`` / ``{...}`` over one or more lines, plain,
single-quoted and double-quoted scalars (multi-line folding, every escape
of the double-quoted style), ``|`` / ``>`` block scalars with an
indentation indicator and chomping, and comments. Plain scalars are typed
as YAML 1.1 safe-load types them (PyYAML's implicit resolvers): null,
bool (yes/no/on/off/true/false), int (decimal, 0b, 0x, leading-0 octal,
sexagesimal), float (a dot required; .inf / .nan; sexagesimal), timestamp
(``datetime.date`` / ``datetime.datetime``); quoted scalars stay strings.

Refused with ``YamlError`` (its ``line``, 1-based): anchors, aliases,
tags, a second document, directives, complex ``?`` keys, merge keys and
anything else outside the subset. Nothing is read silently into something
else."""

from __future__ import annotations

import datetime
import re
from typing import Any, Optional


class YamlError(ValueError):
    """A document outside the subset, or malformed; ``line`` is 1-based."""

    def __init__(self, message: str, line: int) -> None:
        super().__init__(f"line {line}: {message}")
        self.line = line


_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_TIMESTAMP_PARTS = re.compile(
    r"""^(?P<year>[0-9]{4})-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)(?::(?P<tz_minute>[0-9][0-9]))?))?)?$""",
    re.X,
)
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
    "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "\\": "\\", "/": "/",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",]}"
# where a plain scalar in a flow collection ends (PyYAML's scan_plain)
_FLOW_STOP = ",?[]{}"


def _sexagesimal(value: str, cast) -> Any:
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _timestamp(value: str) -> Any:
    m = _TIMESTAMP_PARTS.match(value)
    assert m is not None
    v = m.groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tz = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tz)


def resolve_plain(value: str, line: int) -> Any:
    """A plain scalar's value, typed as YAML 1.1 safe-load types it."""
    if _NULL.match(value):
        return None
    if _BOOL.match(value):
        return value.lower() in _TRUE
    if _INT.match(value):
        return _int(value)
    if _FLOAT.match(value):
        return _float(value)
    if _TIMESTAMP.match(value):
        return _timestamp(value)
    if value in ("<<", "="):
        raise YamlError(f"{value!r} (a merge or value key) is not supported", line)
    return value


def _refuse_indicator(text: str, line: int) -> None:
    """A node may not start with an anchor, alias, tag, directive or a
    reserved indicator."""
    c = text[:1]
    names = {"&": "anchors", "*": "aliases", "!": "tags", "%": "directives",
             "@": "reserved indicators", "`": "reserved indicators"}
    if c in names:
        raise YamlError(f"{names[c]} are not supported ({text.split()[0]!r})", line)
    if c == "?" and (len(text) == 1 or text[1] in " \t"):
        raise YamlError("complex mapping keys ('? ') are not supported", line)


class _Reader:
    def __init__(self, text: str) -> None:
        self.lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.i = 0  # the current line
        # the current line's content is lines[i][col:] (a node may start
        # mid-line: after "- " or "key: ")
        self.col = 0

    # -- positions ---------------------------------------------------------

    def err(self, message: str, line: Optional[int] = None) -> YamlError:
        return YamlError(message, (self.i if line is None else line) + 1)

    @staticmethod
    def _indent(raw: str) -> int:
        return len(raw) - len(raw.lstrip(" "))

    @staticmethod
    def _blank(text: str) -> bool:
        s = text.strip()
        return not s or s.startswith("#")

    def _check_tabs(self, raw: str) -> None:
        lead = raw[: len(raw) - len(raw.lstrip(" \t"))]
        if "\t" in lead and raw.strip():
            raise self.err("tabs are not allowed in indentation")

    def next_content(self) -> Optional[int]:
        """Move to the next line holding content (skipping blank and
        comment lines); its indent, or None at the end."""
        while self.i < len(self.lines):
            raw = self.lines[self.i]
            if not self._blank(raw[self.col:]):
                self._check_tabs(raw)
                return self.col + self._indent(raw[self.col:])
            self.i += 1
            self.col = 0
        return None

    def rest(self) -> str:
        return self.lines[self.i][self.col:]

    def finish_line(self, text: str) -> None:
        """What follows a node on its line must be blank or a comment."""
        if text.strip() and not text.lstrip().startswith("#"):
            raise self.err(f"unexpected content after a node: {text.strip()!r}")
        if text and text[0] not in " \t" and text.lstrip().startswith("#"):
            raise self.err("a comment must be separated from its node by a space")
        self.i += 1
        self.col = 0

    # -- the document ------------------------------------------------------

    def document(self) -> Any:
        ind = self.next_content()
        if ind is None:
            return None
        if self.rest().startswith("%"):
            raise self.err("directives are not supported")
        if self.rest().rstrip() == "---" or self.rest().startswith("--- "):
            after = self.rest()[3:]
            if after.strip() and not after.lstrip().startswith("#"):
                self.col += 4
            else:
                self.i += 1
                self.col = 0
            if self.next_content() is None:
                return None
        value = self.node(-1)
        if self.next_content() is not None:
            text = self.rest().strip()
            if text.startswith("---") or text.startswith("..."):
                raise self.err("only one document is supported (a second '---' or '...')")
            raise self.err(f"unexpected content {text!r}")
        return value

    def node(self, parent: int) -> Any:
        """The block node on the next content line, which must sit deeper
        than ``parent`` (a sequence may sit AT a mapping key's indent:
        ``allow_seq_at``, handled by the caller)."""
        ind = self.next_content()
        if ind is None or ind <= parent:
            return None
        self.col = ind
        text = self.rest()
        if text == "-" or text.startswith("- ") or text.startswith("-\t"):
            return self.sequence(ind)
        if self._key_split(text) is not None:
            return self.mapping(ind)
        return self.scalar_node(parent, ind)

    # -- block collections -------------------------------------------------

    def _marker(self) -> bool:
        """A document marker ('---' or '...') opens the current line."""
        raw = self.lines[self.i]
        return self.col == 0 and raw[:3] in ("---", "...") and raw[3:4] in ("", " ", "\t")

    def sequence(self, ind: int) -> list:
        out: list = []
        while True:
            at = self.next_content()
            if at is None or at != ind or self._marker():
                if at is not None and at > ind:
                    raise self.err("bad indentation of a sequence entry")
                return out
            self.col = at
            text = self.rest()
            if not self._is_entry(text):
                # a sequence at a mapping key's indent ends at the next key
                return out
            after = text[1:]
            if self._blank(after):
                self.finish_line(after)
                out.append(self.node(ind))
                continue
            pad = len(after) - len(after.lstrip(" "))
            self.col = at + 1 + pad
            out.append(self.inline_node(ind, self.col, entry=True))

    def mapping(self, ind: int) -> dict:
        out: dict = {}
        while True:
            at = self.next_content()
            if at is None or at != ind or self._marker():
                if at is not None and at > ind:
                    raise self.err("bad indentation of a mapping entry")
                return out
            self.col = at
            text = self.rest()
            split = self._key_split(text)
            if split is None:
                if text.startswith("- ") or text == "-":
                    raise self.err("a sequence entry where a mapping key was expected")
                raise self.err(f"expected a mapping key, got {text.strip()!r}")
            key, after = split
            line = self.i
            self.col = len(self.lines[self.i]) - len(after)
            if self._blank(after):
                self.finish_line(after)
                nxt = self.next_content()
                if nxt is not None and nxt == ind and self._is_entry(self.lines[self.i][nxt:]):
                    self.col = nxt
                    value = self.sequence(ind)
                else:
                    value = self.node(ind)
            else:
                pad = len(after) - len(after.lstrip(" "))
                self.col += pad
                value = self.inline_node(ind, self.col, entry=False)
            try:
                out[key] = value
            except TypeError:
                raise self.err("an unhashable mapping key", line) from None

    @staticmethod
    def _is_entry(text: str) -> bool:
        return text == "-" or text.startswith("- ") or text.startswith("-\t")

    def _key_split(self, text: str) -> Optional[tuple[Any, str]]:
        """(key, the text after its ':') when ``text`` opens a block
        mapping entry on this line, else None."""
        _refuse_indicator(text, self.i + 1)
        if text[:1] in ("'", '"'):
            value, end = self._quoted_on_line(text)
            if end is None:
                return None
            tail = text[end:]
            stripped = tail.lstrip(" ")
            if stripped.startswith(":") and (len(stripped) == 1 or stripped[1] in " \t"):
                return value, stripped[1:]
            return None
        if text[:1] in "[{":
            return None
        j = 0
        n = len(text)
        while j < n:
            c = text[j]
            if c == "#" and j > 0 and text[j - 1] in " \t":
                return None
            if c == ":" and (j + 1 == n or text[j + 1] in " \t"):
                raw = text[:j].rstrip()
                if not raw:
                    raise self.err("an empty mapping key")
                return resolve_plain(raw, self.i + 1), text[j + 1:]
            j += 1
        return None

    def _quoted_on_line(self, text: str) -> tuple[Any, Optional[int]]:
        """A quoted scalar that closes on this line: (value, index past its
        closing quote), or (None, None) when it runs onto the next line."""
        q = text[0]
        j = 1
        while j < len(text):
            c = text[j]
            if q == "'" and c == "'":
                if j + 1 < len(text) and text[j + 1] == "'":
                    j += 2
                    continue
                return self._unquote(text[1:j], q, self.i), j + 1
            if q == '"' and c == "\\":
                j += 2
                continue
            if q == '"' and c == '"':
                return self._unquote(text[1:j], q, self.i), j + 1
            j += 1
        return None, None

    # -- inline nodes (after "- " or "key: ") --------------------------------

    def inline_node(self, parent: int, col: int, entry: bool) -> Any:
        """The node after "- " (``entry``) or after "key: " on this line. Only
        a sequence entry may open a mapping or a nested sequence there."""
        text = self.rest()
        if self._is_entry(text):
            if not entry:
                raise self.err("sequence entries are not allowed here")
            return self.sequence(col)  # "- - x"
        _refuse_indicator(text, self.i + 1)
        if text[:1] not in "|>[{" and self._key_split(text) is not None:
            if not entry:
                raise self.err("mapping values are not allowed here")
            return self.mapping(col)
        return self.scalar_node(parent, col)

    def scalar_node(self, parent: int, col: int) -> Any:
        text = self.rest()
        _refuse_indicator(text, self.i + 1)
        if text[:1] in "|>":
            return self.block_scalar(parent, text)
        if text[:1] in "[{":
            return self.flow_node()
        if text[:1] in ("'", '"'):
            return self.quoted_node(parent)
        return self.plain_node(parent)

    def plain_node(self, parent: int) -> Any:
        first = self.i
        raw_first = self.rest()
        text = self._plain_part(raw_first)
        parts = [text.strip()]
        self.i += 1
        self.col = 0
        # continuation lines: deeper than the parent, until a comment
        breaks = 0
        while text.strip() == raw_first.strip() and self.i < len(self.lines):
            raw = self.lines[self.i]
            if not raw.strip():
                breaks += 1
                self.i += 1
                continue
            if raw.lstrip().startswith("#") or self._indent(raw) <= parent:
                break
            if raw[:3] in ("---", "...") and raw[3:4] in ("", " ", "\t"):
                break  # a document marker
            self._check_tabs(raw)
            body = raw.strip()
            cont = self._plain_part(body)
            parts.append("\n" * breaks if breaks else " ")
            parts.append(cont.strip())
            breaks = 0
            self.i += 1
            if cont.strip() != body:
                break  # a comment ended the scalar
        # give back trailing blank lines (they may be followed by a sibling)
        while self.i > first + 1 and not self.lines[self.i - 1].strip():
            self.i -= 1
        return resolve_plain("".join(parts), first + 1)

    def _plain_part(self, text: str) -> str:
        """The plain scalar at the start of ``text`` (block context: up to
        a comment; a ': ' inside is an error, as PyYAML's)."""
        j = 0
        n = len(text)
        while j < n:
            c = text[j]
            if c == "#" and j > 0 and text[j - 1] in " \t":
                return text[:j]
            if c == ":" and (j + 1 == n or text[j + 1] in " \t"):
                raise self.err("mapping values are not allowed here")
            j += 1
        return text

    def quoted_node(self, parent: int) -> str:
        start = self.i
        q = self.rest()[0]
        chunks: list[str] = []
        text = self.rest()[1:]
        line = self.i
        while True:
            j = 0
            while j < len(text):
                c = text[j]
                if q == "'" and c == "'":
                    if j + 1 < len(text) and text[j + 1] == "'":
                        j += 2
                        continue
                    chunks.append(text[:j])
                    self.col = len(self.lines[line]) - len(text) + j + 1
                    self.i = line
                    value = self._fold(chunks, q, start)
                    self.finish_line(self.rest())
                    return value
                if q == '"' and c == "\\":
                    j += 2
                    continue
                if q == '"' and c == '"':
                    chunks.append(text[:j])
                    self.col = len(self.lines[line]) - len(text) + j + 1
                    self.i = line
                    value = self._fold(chunks, q, start)
                    self.finish_line(self.rest())
                    return value
                j += 1
            chunks.append(text)
            line += 1
            if line >= len(self.lines):
                raise self.err("unterminated quoted scalar", start)
            text = self.lines[line]

    def _fold(self, chunks: list[str], q: str, start: int) -> str:
        """Join a quoted scalar's lines with YAML's flow folding (a line
        break between text is a space, each empty line a newline; an escaped
        line break joins with nothing), then unescape each piece."""
        out: list[str] = []
        empties = 0
        joined = False  # the line before ended with an escaped line break
        for k, raw in enumerate(chunks):
            piece = raw if k == 0 else raw.lstrip(" \t")
            last = k == len(chunks) - 1
            escaped = (not last and q == '"'
                       and (len(piece) - len(piece.rstrip("\\"))) % 2 == 1)
            if not last and not escaped:
                piece = piece.rstrip(" \t")
            if k > 0 and not joined:
                if not piece and not last:
                    empties += 1
                    continue
                out.append("\n" * empties if empties else " ")
            empties = 0
            out.append(self._unquote(piece[:-1] if escaped else piece, q, start + k))
            joined = escaped
        return "".join(out)

    def _unquote(self, body: str, q: str, line: int) -> str:
        if q == "'":
            return body.replace("''", "'")
        out: list[str] = []
        j = 0
        while j < len(body):
            c = body[j]
            if c != "\\":
                out.append(c)
                j += 1
                continue
            if j + 1 >= len(body):
                raise self.err("a dangling escape in a double-quoted scalar", line)
            e = body[j + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _ESCAPE_CODES:
                width = _ESCAPE_CODES[e]
                digits = body[j + 2: j + 2 + width]
                if len(digits) != width or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise self.err(f"a bad escape \\{e}{digits}", line)
                out.append(chr(int(digits, 16)))
                j += 2 + width
            else:
                raise self.err(f"an unknown escape \\{e}", line)
        return "".join(out)

    # -- block scalars -------------------------------------------------------

    def block_scalar(self, parent: int, header: str) -> str:
        style = header[0]
        m = re.match(r"^[|>]([1-9]?)([+-]?)([1-9]?)(.*)$", header)
        if m is None or (m.group(1) and m.group(3)):
            raise self.err(f"a bad block scalar header {header.strip()!r}")
        digit = m.group(1) or m.group(3)
        chomp = m.group(2)
        tail = m.group(4)
        if tail.strip() and not (tail[:1] in " \t" and tail.lstrip().startswith("#")):
            raise self.err(f"a bad block scalar header {header.strip()!r}")
        self.i += 1
        self.col = 0
        min_indent = max(parent + 1, 1)
        if digit:
            indent = min_indent + int(digit) - 1
        else:
            # the deepest of the leading empty lines and the first content
            # line's indent (PyYAML's scan_block_scalar_indentation)
            indent = min_indent
            k = self.i
            while k < len(self.lines) and not self.lines[k].strip():
                indent = max(indent, len(self.lines[k]))
                k += 1
            if k < len(self.lines):
                indent = max(indent, self._indent(self.lines[k]))
        chunks: list[str] = []
        line_break = ""
        breaks = self._block_breaks(indent)
        while self.i < len(self.lines) and self._indent(self.lines[self.i]) >= indent:
            raw = self.lines[self.i]
            chunks.extend(breaks)
            leading_non_space = raw[indent:indent + 1] not in (" ", "\t")
            chunks.append(raw[indent:])
            self.i += 1
            line_break = "\n"
            breaks = self._block_breaks(indent)
            if self.i < len(self.lines) and self._indent(self.lines[self.i]) >= indent:
                nxt = self.lines[self.i][indent:indent + 1]
                if style == ">" and leading_non_space and nxt not in (" ", "\t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomp != "-":
            chunks.append(line_break)
        if chomp == "+":
            chunks.extend(breaks)
        # a following node's line was not consumed; give back the trailing
        # blank lines so the caller skips them itself
        self.col = 0
        return "".join(chunks)

    def _block_breaks(self, indent: int) -> list[str]:
        """The empty (or short, all-space) lines before the next line of a
        block scalar, each one line break; stops on a content line."""
        out = []
        while self.i < len(self.lines):
            raw = self.lines[self.i]
            if raw.strip() or len(raw) > indent:
                break
            out.append("\n")
            self.i += 1
        return out

    # -- flow collections ----------------------------------------------------

    def flow_node(self) -> Any:
        flow = _Flow(self, self.i, self.col)
        value = flow.node()
        self.i, self.col = flow.line, flow.col
        try:
            self.finish_line(self.rest())
        except YamlError:
            raise self.err("unexpected content after a flow collection", self.i) from None
        return value


class _Flow:
    """A flow collection read over one or more lines from (line, col)."""

    def __init__(self, reader: _Reader, line: int, col: int) -> None:
        self.r = reader
        self.line = line
        self.col = col

    def peek(self) -> str:
        lines = self.r.lines
        while True:
            if self.line >= len(lines):
                return ""
            text = lines[self.line]
            while self.col < len(text) and text[self.col] in " \t":
                self.col += 1
            if self.col >= len(text) or (
                text[self.col] == "#" and (self.col == 0 or text[self.col - 1] in " \t")
            ):
                self.line += 1
                self.col = 0
                continue
            return text[self.col]

    def node(self) -> Any:
        c = self.peek()
        if c == "":
            raise self.r.err("an unterminated flow collection", self.line)
        _refuse_indicator(self.r.lines[self.line][self.col:], self.line + 1)
        if c == "[":
            self.col += 1
            out: list = []
            while True:
                if self.peek() == "]":
                    self.col += 1
                    return out
                item = self.node()
                if self.peek() == ":":
                    raise self.r.err("single-pair mappings in a flow sequence are not supported",
                                     self.line)
                out.append(item)
                if self.peek() == ",":
                    self.col += 1
                elif self.peek() != "]":
                    raise self.r.err("expected ',' or ']' in a flow sequence", self.line)
        if c == "{":
            self.col += 1
            mapping: dict = {}
            while True:
                if self.peek() == "}":
                    self.col += 1
                    return mapping
                key = self.node()
                value = None
                if self.peek() == ":":
                    self.col += 1
                    if self.peek() in (",", "}"):
                        value = None
                    else:
                        value = self.node()
                try:
                    mapping[key] = value
                except TypeError:
                    raise self.r.err("an unhashable mapping key", self.line) from None
                if self.peek() == ",":
                    self.col += 1
                elif self.peek() != "}":
                    raise self.r.err("expected ',' or '}' in a flow mapping", self.line)
        if c in ("'", '"'):
            return self.quoted()
        return self.plain()

    def quoted(self) -> str:
        r = self.r
        r.i, r.col = self.line, self.col
        q = r.lines[r.i][r.col]
        start = r.i
        chunks: list[str] = []
        line = r.i
        text = r.lines[line][r.col + 1:]
        offset = r.col + 1
        while True:
            j = 0
            while j < len(text):
                c = text[j]
                if q == "'" and c == "'":
                    if j + 1 < len(text) and text[j + 1] == "'":
                        j += 2
                        continue
                    break
                if q == '"' and c == "\\":
                    j += 2
                    continue
                if q == '"' and c == '"':
                    break
                j += 1
            else:
                chunks.append(text)
                line += 1
                if line >= len(r.lines):
                    raise r.err("unterminated quoted scalar", start)
                text = r.lines[line]
                offset = 0
                continue
            chunks.append(text[:j])
            self.line, self.col = line, offset + j + 1
            return r._fold(chunks, q, start)

    def plain(self) -> Any:
        r = self.r
        first = self.line
        parts: list[str] = []
        while True:
            text = r.lines[self.line]
            j = self.col
            while j < len(text):
                c = text[j]
                if c in _FLOW_STOP:
                    break
                if c == ":" and (j + 1 == len(text) or text[j + 1] in " \t,[]{}"):
                    break
                if c == "#" and j > 0 and text[j - 1] in " \t":
                    break
                j += 1
            parts.append(text[self.col:j].strip())
            self.col = j
            if j < len(text) and text[j] != "#":
                break
            # the scalar may continue on the next line (folded with a space)
            self.col = len(text)
            nxt = self.peek()
            if nxt == "" or nxt in _FLOW_END or nxt == ":":
                break
        value = " ".join(p for p in parts if p)
        return resolve_plain(value, first + 1)


def safe_load(text: str) -> Any:
    """The value of a one-document YAML text, as ``yaml.safe_load`` reads
    it; ``YamlError`` (with its ``line``) for anything outside the subset."""
    return _Reader(text).document()


# characters a double-quoted scalar may hold as they are: YAML's printable
# set minus the line breaks it would fold (NEL, LS, PS) and the BOM
_DUMP_ESCAPES = {"\0": "\\0", "\x07": "\\a", "\x08": "\\b", "\t": "\\t", "\n": "\\n",
                 "\x0b": "\\v", "\x0c": "\\f", "\r": "\\r", "\x1b": "\\e", '"': '\\"',
                 "\\": "\\\\", "\x85": "\\N", "\xa0": "\\_", "\u2028": "\\L", "\u2029": "\\P"}


def _dump_char(c: str) -> str:
    if c in _DUMP_ESCAPES:
        return _DUMP_ESCAPES[c]
    o = ord(c)
    if 0x20 <= o < 0x7F or 0xA0 <= o <= 0xD7FF or (0xE000 <= o <= 0xFFFD and o != 0xFEFF) \
            or o >= 0x10000:
        return c
    return f"\\x{o:02x}" if o <= 0xFF else f"\\u{o:04x}"


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 reads a float only with a dot: 1e-05 would be a string
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, datetime.datetime):
        return value.isoformat(" ")
    if isinstance(value, datetime.date):
        return value.isoformat()
    if isinstance(value, str):
        return '"' + "".join(_dump_char(c) for c in value) + '"'
    raise TypeError(f"safe_dump cannot write a {type(value).__name__}")


def _dump_block(value: Any, indent: int, out: list[str]) -> None:
    """``value`` (a non-empty map or list) as block lines at ``indent``."""
    pad = " " * indent
    if isinstance(value, dict):
        for key in sorted(value, key=lambda k: (str(type(k)), k)):
            item = value[key]
            head = f"{pad}{_dump_scalar(key)}:"
            if isinstance(item, (dict, list)) and item:
                out.append(head)
                _dump_block(item, indent + 2, out)
            else:
                out.append(f"{head} {_dump_inline(item)}")
        return
    for item in value:
        if isinstance(item, (dict, list)) and item:
            # the compact forms "- key: v" and "- - x": the item's first
            # line goes after the dash, the rest at the dash's column + 2
            inner: list[str] = []
            _dump_block(item, indent + 2, inner)
            out.append(f"{pad}- {inner[0][indent + 2:]}")
            out.extend(inner[1:])
        else:
            out.append(f"{pad}- {_dump_inline(item)}")


def _dump_inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _dump_scalar(value)


def safe_dump(value: Any) -> str:
    """A YAML text that ``safe_load`` (and ``yaml.safe_load``) reads back as
    ``value``: null, bools, ints, floats, strings (always double-quoted),
    dates, and maps and lists of them in block style, map keys sorted as
    ``yaml.safe_dump`` sorts them. The control plane writes an archetype
    instance's globals with it."""
    if isinstance(value, (dict, list)) and value:
        lines: list[str] = []
        _dump_block(value, 0, lines)
        return "\n".join(lines) + "\n"
    return _dump_inline(value) + "\n"
