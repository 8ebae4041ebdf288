"""Tokenizers of the port (own copy of ``langstream_tpu/serving/tokenizer.py``).

``hf:<path>`` loads a Hugging Face tokenizer from a local directory
(``transformers`` is imported only when one is built; nothing is
downloaded). ``byte`` is the dependency-free byte-level tokenizer the
random-weight benches and tests use. The provider picks one through its
``tokenizer`` key.
"""

from __future__ import annotations

import abc
from typing import Optional

from langstream_tpu_torch.native import py_utf8_incomplete_tail_len


class Tokenizer(abc.ABC):
    eos_token_id: Optional[int] = None
    bos_token_id: Optional[int] = None

    @abc.abstractmethod
    def encode(self, text: str) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, tokens: list[int]) -> str: ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    def decode_stream_prefix(self, tokens: list[int]) -> str:
        """Decode for incremental streaming: only text that cannot change as
        more tokens arrive. Default: decode and strip a trailing replacement
        char (lossy for models that emit U+FFFD themselves)."""
        return self.decode(tokens).rstrip("\ufffd")


class ByteTokenizer(Tokenizer):
    """UTF-8 bytes + 2 specials: 256=BOS, 257=EOS."""

    bos_token_id = 256
    eos_token_id = 257

    def __init__(self, add_bos: bool = True) -> None:
        self.add_bos = add_bos

    @property
    def vocab_size(self) -> int:
        return 258

    def encode(self, text: str) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_token_id] + ids if self.add_bos else ids

    def decode(self, tokens: list[int]) -> str:
        data = bytes(t for t in tokens if 0 <= t < 256)
        return data.decode("utf-8", "replace")

    def decode_stream_prefix(self, tokens: list[int]) -> str:
        """Exact incremental decode: hold back only a trailing incomplete
        multibyte sequence; earlier garbage becomes U+FFFD."""
        data = bytes(t for t in tokens if 0 <= t < 256)
        tail = py_utf8_incomplete_tail_len(data)
        return data[: len(data) - tail].decode("utf-8", "replace")


class HFTokenizer(Tokenizer):
    """A Hugging Face tokenizer from a local directory. Without the
    ``transformers`` package this raises ImportError naming it; it never
    falls back to another tokenizer."""

    def __init__(self, name_or_path: str) -> None:
        try:
            from transformers import AutoTokenizer  # lazy; heavy import
        except ImportError as e:
            raise ImportError(
                f"tokenizer 'hf:{name_or_path}' needs the 'transformers' package: {e}"
            ) from e
        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, tokens: list[int]) -> str:
        return self._tok.decode(tokens, skip_special_tokens=True)


def get_tokenizer(spec: str) -> Tokenizer:
    if spec in ("byte", "bytes"):
        return ByteTokenizer()
    if spec.startswith("hf:"):
        return HFTokenizer(spec[3:])
    raise ValueError(f"unknown tokenizer spec {spec!r} (use 'byte' or 'hf:<path>')")
