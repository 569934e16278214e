"""Byte-level tokenizer: the port's own copy of
`lmrl_gym_tpu/text/tokenizer.py::ByteTokenizer` (token id == byte value,
specials appended after 255), so the two packages tokenize identically."""
from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    """Byte-level tokenizer: token = byte value; specials appended after 255."""

    def __init__(self, specials: Sequence[str] = ("<pad>", "<eos>", "<bos>")):
        self.specials = list(specials)
        self.pad_token_id = 256 + self.specials.index("<pad>") if "<pad>" in self.specials else None
        self.eos_token_id = 256 + self.specials.index("<eos>") if "<eos>" in self.specials else None
        self.bos_token_id = 256 + self.specials.index("<bos>") if "<bos>" in self.specials else None
        self.vocab_size = 256 + len(self.specials)
        self.pad_token = "<pad>"
        self.eos_token = "<eos>"
        self.newline_token_id = 10  # byte value of "\n"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        text = data.decode("utf-8", errors="replace")
        if not skip_special_tokens:
            for i in ids:
                if i >= 256:
                    text += self.specials[i - 256]
        return text

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def __call__(self, text, **kw):
        if isinstance(text, str):
            return {"input_ids": self.encode(text)}
        return {"input_ids": [self.encode(t) for t in text]}
