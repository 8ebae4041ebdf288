"""HTML reading on the stdlib ``html.parser``: the text of a page and the
links of its ``a[href]`` tags, as BeautifulSoup's ``html.parser`` builder
gives them to the JAX package's ``text-extractor`` and ``webcrawler-source``
(``_extract_html``, ``_extract_links``) — the card's machine has no bs4.

The parser is the stdlib's own, with the settings that builder gives it
(``convert_charrefs=False``: references come as events), and its events are
turned into strings by the builder's rules, without building a tree:

- a run of data between two events is one string; a run of ASCII
  whitespace alone folds to ``"\\n"`` (or ``" "`` without a newline)
  unless a ``pre`` or ``textarea`` is open;
- an end tag closes the most recent open tag of its name and every tag
  opened after it, and is ignored when no such tag is open; a void element
  (``br``, ``img``, ...) closes at once, and its own end tag right after is
  swallowed;
- named references decode through the HTML5 table (an unknown one stays
  ``&name``), numeric ones by the HTML5 rules (0x80-0x9F through
  windows-1252, 0 / surrogates / past U+10FFFF to U+FFFD);
- comments, the doctype, declarations and processing instructions are not
  text; CDATA is; data inside an open ``rt``, ``rp``, ``template``,
  ``script`` or ``style`` (the innermost of them) is not text either, as
  bs4's ``get_text`` leaves those string types out;
- ``script``, ``style`` and ``noscript`` are dropped with all they hold.

Bytes are decoded as bs4 decodes them, less its optional third-party
charset guess: a byte-order mark, else the encoding the document declares
(an XML declaration in its first 1024 bytes, a ``<meta charset>`` in its
first ``max(2048, 5%)``), else UTF-8, else windows-1252; then the same
list again with replacement characters.
"""

from __future__ import annotations

import codecs
import re
from html.entities import html5
from html.parser import HTMLParser
from urllib.parse import urldefrag, urljoin

# bs4's HTMLTreeBuilder.DEFAULT_EMPTY_ELEMENT_TAGS
_VOID = frozenset((
    "area", "base", "br", "col", "embed", "hr", "img", "input", "keygen", "link",
    "menuitem", "meta", "param", "source", "track", "wbr", "basefont", "bgsound",
    "command", "frame", "image", "isindex", "nextid", "spacer",
))
_PRESERVE_WHITESPACE = frozenset(("pre", "textarea"))
# tags whose strings get a string type of their own (not text)
_STRING_CONTAINERS = frozenset(("rt", "rp", "style", "script", "template"))
_DROPPED = frozenset(("script", "style", "noscript"))
_ASCII_SPACES = " \n\t\x0c\r"

# the HTML5 named references without their semicolons, the first of each
# name in sorted order winning (bs4's EntitySubstitution table)
_ENTITIES: dict[str, str] = {}
for _name, _char in sorted(html5.items()):
    _ENTITIES.setdefault(_name[:-1] if _name.endswith(";") else _name, _char)

# HTML5 noncharacters, resolved as they are
_NONCHARACTERS = frozenset(
    [*range(0xFDD0, 0xFDF0)] + [(p << 16) | low for p in range(17) for low in (0xFFFE, 0xFFFF)]
)
_UNDEFINED_1252 = frozenset((0x81, 0x8D, 0x8F, 0x90, 0x9D))

_DECIMAL_WITH_DATA = re.compile("^([0-9]+)(.*)")
_HEX_WITH_DATA = re.compile("^([0-9a-f]+)(.*)")

_XML_ENCODING = re.compile(b"^\\s*<\\?.*encoding=['\"](.*?)['\"].*\\?>", re.I)
_META_CHARSET = re.compile(b"<\\s*meta[^>]+charset\\s*=\\s*[\"']?([^>]*?)[ /;'\">]", re.I)
# byte-order marks in bs4's order (a UTF-16 mark needs 4 bytes, the next
# two not both zero: else it may open a UTF-32 mark)
_BOMS = (
    (b"\xfe\xff", "utf-16be"), (b"\xff\xfe", "utf-16le"), (b"\xef\xbb\xbf", "utf-8"),
    (b"\x00\x00\xfe\xff", "utf-32be"), (b"\xff\xfe\x00\x00", "utf-32le"),
)
_CHARSET_ALIASES = {"macintosh": "mac-roman", "x-sjis": "shift-jis"}


def _numeric_reference(name: str) -> tuple[str, str]:
    """``&#name;`` → (the character, data that followed the number)."""
    base, reg = 10, _DECIMAL_WITH_DATA
    if name.startswith(("x", "X")):
        name, base, reg = name[1:], 16, _HEX_WITH_DATA
    try:
        number, extra = int(name, base), ""
    except ValueError:
        m = reg.search(name)
        if m is None:
            return "", name
        number, extra = int(m.group(1), base), m.group(2)
    if number == 0 or number > 0x10FFFF or 0xD800 <= number <= 0xDFFF:
        return "\ufffd", extra
    if number in _NONCHARACTERS:
        return chr(number), extra
    if 0x80 <= number <= 0x9F and number not in _UNDEFINED_1252:
        return bytes([number]).decode("cp1252"), extra
    return chr(number), extra


def _codec(charset: str):
    for name in (_CHARSET_ALIASES.get(charset, charset), charset.replace("-", ""),
                 charset.replace("-", "_")):
        try:
            return codecs.lookup(name).name
        except (LookupError, ValueError):
            continue
    return None


def decode_markup(data: bytes | str) -> str:
    """The page as text, decoded as bs4 decodes bytes (see the module's
    docstring); a str is returned as it is."""
    if isinstance(data, str):
        return data
    data = bytes(data)
    charsets: list[str] = []
    for bom, encoding in _BOMS:
        if data.startswith(bom) and (len(bom) != 2 or (len(data) >= 4
                                                        and data[2:4] != b"\x00\x00")):
            charsets.append(encoding)
            data = data[len(bom):]
            break
    m = _XML_ENCODING.search(data, 0, 1024) or _META_CHARSET.search(
        data, 0, max(2048, int(len(data) * 0.05)))
    if m is not None and m.group(1):
        charsets.append(m.group(1).decode("ascii", "replace").lower())
    charsets += ["utf-8", "windows-1252"]
    tried: set = set()
    for errors in ("strict", "replace"):
        for charset in dict.fromkeys(charsets):
            codec = _codec(charset)
            if codec is None or (codec, errors) in tried or (errors, codec) == ("replace",
                                                                                "ascii"):
                continue
            tried.add((codec, errors))
            try:
                return str(data, codec, errors)
            except (UnicodeError, LookupError):
                continue
    raise ValueError("could not decode the page")


class _Reader(HTMLParser):
    """html.parser events → the page's strings (``texts``: what bs4's
    ``get_text`` keeps, in order, with script / style / noscript dropped)
    and its links (``hrefs``: each ``a`` tag's ``href``, in order)."""

    def __init__(self) -> None:
        super().__init__(convert_charrefs=False)
        self.texts: list[str] = []
        self.hrefs: list[str] = []
        self._stack: list[str] = []
        self._data: list[str] = []
        self._closed_void: list[str] = []

    # -- the tree builder's rules ---------------------------------------------

    def _end_data(self, kind: str = "text") -> None:
        """Close the current run of data as one string of ``kind`` (text,
        cdata, or anything else: not text)."""
        if not self._data:
            return
        data = "".join(self._data)
        self._data = []
        if not _PRESERVE_WHITESPACE.intersection(self._stack) and all(
                c in _ASCII_SPACES for c in data):
            data = "\n" if "\n" in data else " "
        if kind == "text":
            container = next((t for t in reversed(self._stack) if t in _STRING_CONTAINERS), None)
            if container is not None:
                kind = container
        if kind in ("text", "cdata") and not _DROPPED.intersection(self._stack):
            self.texts.append(data)

    def _open(self, tag: str, attrs, void_closes: bool) -> None:
        self._end_data()
        self._stack.append(tag)
        if tag == "a":
            href = None
            for key, value in attrs:
                if key == "href":
                    href = "" if value is None else value
            if href is not None:
                self.hrefs.append(href)
        if void_closes and tag in _VOID:
            self._close(tag)
            self._closed_void.append(tag)

    def _close(self, tag: str) -> None:
        self._end_data()
        if tag in self._stack:
            while self._stack.pop() != tag:
                pass

    def _special(self, data: str, kind: str) -> None:
        self._end_data()
        self._data.append(data)
        self._end_data(kind)

    # -- html.parser events ---------------------------------------------------

    def handle_starttag(self, tag, attrs):
        self._open(tag, attrs, void_closes=True)

    def handle_startendtag(self, tag, attrs):
        self._open(tag, attrs, void_closes=False)
        self._close(tag)

    def handle_endtag(self, tag):
        if tag in self._closed_void:
            self._closed_void.remove(tag)
        else:
            self._close(tag)

    def handle_data(self, data):
        self._data.append(data)

    def handle_charref(self, name):
        char, extra = _numeric_reference(name)
        self._data += [char, extra]

    def handle_entityref(self, name):
        self._data.append(_ENTITIES.get(name, f"&{name}"))

    def handle_comment(self, data):
        self._special(data, "comment")

    def handle_decl(self, decl):
        self._special(decl[len("DOCTYPE "):], "doctype")

    def unknown_decl(self, data):
        if data.upper().startswith("CDATA["):
            self._special(data[len("CDATA["):], "cdata")
        else:
            self._special(data, "declaration")

    def handle_pi(self, data):
        self._special(data, "pi")

    def finish(self) -> "_Reader":
        try:
            self.close()
        except AssertionError as e:
            raise ValueError(f"the page cannot be parsed: {e}") from e
        self._end_data()
        return self


def _read(data: bytes | str) -> _Reader:
    reader = _Reader()
    try:
        reader.feed(decode_markup(data))
    except AssertionError as e:
        raise ValueError(f"the page cannot be parsed: {e}") from e
    return reader.finish()


def html_text(data: bytes | str) -> str:
    """The page's text: its strings joined with newlines, runs of three or
    more newlines folded to one blank line, stripped."""
    return re.sub(r"\n{3,}", "\n\n", "\n".join(_read(data).texts)).strip()


def html_links(base: str, data: bytes | str) -> list[str]:
    """The page's ``a[href]`` links, in document order, each joined to
    ``base`` and without its fragment, ``http(s)`` only (``<base href>`` is
    not read). A page that cannot be read has no links."""
    try:
        hrefs = _read(data).hrefs
    except Exception:  # noqa: BLE001 - a malformed page: no links
        return []
    links = []
    for href in hrefs:
        link = urldefrag(urljoin(base, href))[0]
        if link.startswith(("http://", "https://")):
            links.append(link)
    return links
