"""Tokenizers: the port's own copy of `lmrl_gym_tpu/text/tokenizer.py`.
`ByteTokenizer` (token id == byte value, specials appended after 255)
tokenizes as the JAX package's does; `load_tokenizer` resolves the same
specs, and `newline_id` gives the same stop token."""
from __future__ import annotations

from typing import List, Optional, Sequence


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


def newline_id(tokenizer) -> int:
    """Token id that ends an action line (generation stop condition)."""
    return getattr(tokenizer, "newline_token_id", ord("\n"))


def load_tokenizer(name_or_path: Optional[str] = None):
    """Resolve a tokenizer spec:

    - None / "byte" → ByteTokenizer
    - "bpe:<path>"  → saved in-repo BPE vocab (text/bpe.py)
    - anything else → locally cached HF tokenizer (`transformers`, imported
      here, local files only), ByteTokenizer fallback
    """
    if name_or_path is None or name_or_path == "byte":
        return ByteTokenizer()
    if name_or_path.startswith("bpe:"):
        from lmrl_gym_torch.text.bpe import BPETokenizer

        return BPETokenizer.load(name_or_path[len("bpe:"):])
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        if tok.pad_token is None:
            tok.pad_token = tok.eos_token
        return tok
    except Exception:
        return ByteTokenizer()
