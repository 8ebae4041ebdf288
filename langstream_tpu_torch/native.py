"""Pure-Python UTF-8 helpers of the port (own copy of the fallbacks in
``langstream_tpu/native.py``; the port builds no host extension)."""

from __future__ import annotations


def _utf8_seq_len(c: int) -> int:
    """Total bytes for a sequence with lead byte c; 0 = invalid lead.
    STRICT (matches CPython's codec): C0/C1 overlong and F5+ out-of-range
    leads are invalid."""
    if c < 0x80:
        return 1
    if 0xC2 <= c <= 0xDF:
        return 2
    if 0xE0 <= c <= 0xEF:
        return 3
    if 0xF0 <= c <= 0xF4:
        return 4
    return 0


def _utf8_second_ok(lead: int, c2: int) -> bool:
    if lead == 0xE0:
        return 0xA0 <= c2 <= 0xBF  # overlong 3-byte
    if lead == 0xED:
        return 0x80 <= c2 <= 0x9F  # surrogates
    if lead == 0xF0:
        return 0x90 <= c2 <= 0xBF  # overlong 4-byte
    if lead == 0xF4:
        return 0x80 <= c2 <= 0x8F  # > U+10FFFF
    return (c2 & 0xC0) == 0x80


def py_utf8_incomplete_tail_len(data: bytes) -> int:
    """Bytes of a trailing incomplete-but-plausible UTF-8 sequence (0 when
    the buffer ends on a boundary or in garbage that can never complete).
    Streaming decoders hold back exactly this tail and decode the rest with
    errors="replace" — never raising, never freezing on a bad byte."""
    b = bytes(data)
    n = len(b)
    for back in range(1, min(3, n) + 1):
        p = n - back
        length = _utf8_seq_len(b[p])
        if length == 1:
            return 0  # ascii boundary
        if length == 0:
            continue  # continuation/invalid byte: look further back
        if length > back:
            ok = True
            for j in range(1, back):
                c = b[p + j]
                bad = (not _utf8_second_ok(b[p], c)) if j == 1 else ((c & 0xC0) != 0x80)
                if bad:
                    ok = False
                    break
            return back if ok else 0
        return 0  # complete (or over-complete) sequence at the tail
    return 0
