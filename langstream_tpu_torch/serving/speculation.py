"""Prompt-lookup (n-gram) draft index for self-speculative decoding (the
port's own copy of ``langstream_tpu/serving/speculation.py``; stdlib only).

Decode emits one token per read of the weights; speculation spreads that
read over up to k+1 tokens: drafts are proposed on the host for free and
scored in one multi-token verify dispatch (``engine._verify_chunk``). This
module is the proposer: no draft model, no extra weights — a per-slot
n-gram index over prompt plus accepted tokens (chat, RAG and code traffic
re-emits spans of its own context, and greedy decode on fixed weights often
enters literal cycles) maps the current tail n-gram to the continuation
that followed its previous occurrence.

A wrong draft costs only its wasted verify column: acceptance is decided
against the model's own outputs on the device
(``sampling.speculative_verify``), so a bad proposal never changes what is
emitted.
"""

from __future__ import annotations


class NGramIndex:
    """Draft index for one slot's token stream.

    For each gram size n in [min_n, max_n] the index maps the n-gram to the
    continuation positions of its two most recent occurrences. ``propose``
    looks up the current tail gram (largest n first: a longer match is more
    specific) and returns the tokens that followed its previous occurrence.
    The latest occurrence of the tail gram is the tail itself, which has no
    continuation yet — hence the two-deep history.
    """

    __slots__ = ("max_n", "min_n", "tokens", "_maps")

    def __init__(self, max_n: int = 3, min_n: int = 1) -> None:
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n
        self.tokens: list[int] = []
        # gram -> (continuation position of the latest occurrence, of the one before)
        self._maps: dict[int, dict[tuple, tuple]] = {n: {} for n in range(min_n, max_n + 1)}

    def __len__(self) -> int:
        return len(self.tokens)

    def append(self, token: int) -> None:
        self.tokens.append(int(token))
        i = len(self.tokens)
        for n, m in self._maps.items():
            if i >= n:
                gram = tuple(self.tokens[i - n : i])
                prev = m.get(gram)
                m[gram] = (i, prev[0] if prev is not None else None)

    def extend(self, tokens) -> None:
        for t in tokens:
            self.append(t)

    def propose(self, k: int) -> list[int]:
        """``k`` draft tokens continuing the current tail, or [] when no
        tail gram occurred before. A continuation that runs into the tail
        extends periodically (period = the distance between the two
        occurrences), so a cycle fills all k columns instead of one period."""
        length = len(self.tokens)
        for n in range(self.max_n, self.min_n - 1, -1):
            if length < n:
                continue
            hit = self._maps[n].get(tuple(self.tokens[length - n :]))
            if hit is None:
                continue
            latest, prev = hit
            # the latest occurrence of the tail gram is the tail: use the one before
            pos = prev if latest >= length else latest
            if pos is None or pos >= length:
                continue
            period = length - pos
            return [self.tokens[pos + (i % period)] for i in range(k)]
        return []
