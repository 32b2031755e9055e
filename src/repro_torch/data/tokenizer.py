"""Byte-level tokenizer — the port's own copy of ``repro.data.tokenizer``.

Ids 0..255 are raw bytes, followed by the special tokens; every model
vocabulary is a strict superset of this id range.
"""
from __future__ import annotations

BYTE_VOCAB = 256


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids.insert(0, self.BOS)
        if add_eos:
            ids.append(self.EOS)
        return ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < BYTE_VOCAB).decode(
            "utf-8", errors="replace")
