"""Tokenizers for the entry points: the built-in byte tokenizer, or a
local Hugging Face tokenizer directory.

The port's copy of the tokenizers of tf_operator_tpu/data/tokenize.py
(`ByteTokenizer`, `HFTokenizer`, `load_tokenizer`; the shard-writing
CLI around them is not copied).  `transformers` is imported only when a
tokenizer directory is loaded, and only from local files: nothing is
downloaded.
"""
from __future__ import annotations

import os
from typing import Iterable, List


class ByteTokenizer:
    """Reversible byte-level tokenizer: token i is byte i.  NUL (0)
    doubles as EOS: it never occurs in text, so the vocabulary stays
    exactly 256 and fits every model vocabulary."""

    vocab_size = 256
    eos_id = 0

    def encode(self, text: str) -> List[int]:
        return [b or 32 for b in text.encode("utf-8")]  # NUL -> space

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if i > 0).decode("utf-8", "replace")


class HFTokenizer:
    """A local (no-download) Hugging Face tokenizer directory."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self.tok)
        self.eos_id = self.tok.eos_token_id
        if self.eos_id is None:
            raise SystemExit(
                f"tokenizer at {path} has no eos token — packing needs a "
                f"document separator")

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Iterable[int]) -> str:
        return self.tok.decode(list(ids))


def load_tokenizer(spec: str):
    """'byte', or the path of a local tokenizer directory."""
    if spec == "byte":
        return ByteTokenizer()
    if os.path.isdir(spec):
        return HFTokenizer(spec)
    raise SystemExit(
        f"--tokenizer must be 'byte' or a local tokenizer directory, "
        f"got {spec!r} (no-egress environment: remote hub names cannot "
        f"be downloaded)")
