"""Tokenizers of the port (own copy of ``langstream_tpu/serving/tokenizer.py``).

``byte`` is the dependency-free byte-level tokenizer the random-weight
benches and tests use. Hugging Face tokenizers wait for the loader slice.
"""

from __future__ import annotations

from langstream_tpu_torch.native import py_utf8_incomplete_tail_len


class ByteTokenizer:
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


def get_tokenizer(spec: str) -> ByteTokenizer:
    if spec in ("byte", "bytes"):
        return ByteTokenizer()
    raise ValueError(
        f"unknown tokenizer spec {spec!r}: the PyTorch port supports 'byte' "
        "(Hugging Face tokenizers wait for the loader slice)"
    )
