"""Self-contained trainable byte-level BPE tokenizer: the port's copy of
`lmrl_gym_tpu/text/bpe.py`. Weights come from seeds and nothing is
downloaded, so the package trains its own BPE:

- same *construction* as GPT-2's tokenizer (byte-level alphabet via the
  printable bytes↔unicode bijection, regex pre-tokenization, ranked pair
  merges) so a locally cached HF GPT-2 tokenizer is a drop-in swap;
- trainable on in-repo generated text (each task's scripted data
  generators), giving dialog tasks ~3-4x fewer tokens/episode than the
  round-1 ByteTokenizer;
- pure-Python train/encode with a per-word LRU cache — tokenization is
  host-side prep, never on the device's hot path.

Token id layout: [0,256) byte alphabet, [256, V-S) learned merges,
last S ids special tokens (<pad>, <eos>, <bos>).
"""
from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# GPT-2's pre-tokenization pattern (splits contractions, letter runs,
# number runs, punctuation runs, and trailing whitespace), written for the
# standard library's `re`: GPT-2 writes it with the `regex` package's
# \p{L} / \p{N}, which `re` lacks. Letters are [^\W\d_], numbers \d.
# `re`'s \s also matches the separators \x1c-\x1f, which are not Unicode
# White_Space, so whitespace is [^\S\x1c-\x1f] and those four characters
# join the punctuation runs. The split is the same on every ASCII string;
# beyond ASCII, numeric characters that are not decimal digits (², ½, Ⅻ)
# count as letters here.
_WS = r"[^\S\x1c-\x1f]"
_PRETOKENIZE = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|[_\x1c-\x1f])+"""
    rf"""|{_WS}+(?![\S\x1c-\x1f])|{_WS}+"""
)

_SPECIALS = ("<pad>", "<eos>", "<bos>")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Bijection byte value → printable unicode char (GPT-2 convention):
    printable bytes map to themselves, the rest to 256+offset."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


class BPETokenizer:
    """Byte-level BPE with the ByteTokenizer interface contract
    (.encode/.decode/.batch_decode/.pad_token_id/.eos_token_id)."""

    def __init__(
        self,
        merges: Sequence[Tuple[str, str]],
        specials: Sequence[str] = _SPECIALS,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        alphabet = sorted(self.byte_encoder.values(), key=ord)
        # vocab: 256 alphabet chars, then one entry per merge
        self.encoder: Dict[str, int] = {c: i for i, c in enumerate(alphabet)}
        self.merge_ranks: Dict[Tuple[str, str], int] = {}
        for rank, (a, b) in enumerate(merges):
            self.merge_ranks[(a, b)] = rank
            self.encoder[a + b] = 256 + rank
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.merges = [tuple(m) for m in merges]

        self.specials = list(specials)
        base = len(self.encoder)
        self._special_ids = {s: base + i for i, s in enumerate(self.specials)}
        self.pad_token_id = self._special_ids.get("<pad>")
        self.eos_token_id = self._special_ids.get("<eos>")
        self.bos_token_id = self._special_ids.get("<bos>")
        self.vocab_size = base + len(self.specials)
        self.pad_token = "<pad>"
        self.eos_token = "<eos>"
        # env text protocols terminate actions with "\n" and generation
        # stops on it; train_bpe never merges the newline char so this is
        # always a single stable token id
        self.newline_token_id = self.encoder[self.byte_encoder[10]]
        self._bpe_cache: Dict[str, List[str]] = {}

    # ---- core BPE ----
    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        if len(word) == 1:
            self._bpe_cache[token] = [token]
            return [token]
        while len(word) > 1:
            pairs = _pairs(word)
            best = min(
                pairs, key=lambda p: self.merge_ranks.get(p, float("inf"))
            )
            if best not in self.merge_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        if len(self._bpe_cache) < 200_000:
            self._bpe_cache[token] = out
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special_tokens and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        for tok in _PRETOKENIZE.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i >= len(self.decoder):
                if not skip_special_tokens and i - len(self.decoder) < len(self.specials):
                    parts.append(self.specials[i - len(self.decoder)])
                continue
            parts.append(self.decoder[i])
        data = bytes(self.byte_decoder[c] for p in parts for c in p if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def __call__(self, text, **kw):
        if isinstance(text, str):
            return {"input_ids": self.encode(text)}
        return {"input_ids": [self.encode(t) for t in text]}

    # ---- persistence ----
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"merges": [list(m) for m in self.merges], "specials": self.specials},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(
            merges=[tuple(m) for m in d["merges"]], specials=d.get("specials", _SPECIALS)
        )


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 2048,
    specials: Sequence[str] = _SPECIALS,
    min_pair_count: int = 2,
) -> BPETokenizer:
    """Learn BPE merges by greedy highest-frequency pair merging over the
    pre-tokenized word-frequency table (the classic algorithm; counts are
    updated incrementally per merge so training a few-thousand-token vocab
    on megabyte corpora takes seconds)."""
    n_merges = vocab_size - 256 - len(specials)
    assert n_merges >= 0, f"vocab_size {vocab_size} below alphabet+specials"
    b2u = bytes_to_unicode()
    # keep "\n" a standalone token: the envs' action protocols and the
    # generation stop condition both key on the newline id
    never_merge = b2u[10]

    # word-frequency table over pre-tokens
    word_freq: Dict[Tuple[str, ...], int] = {}
    for text in texts:
        for tok in _PRETOKENIZE.findall(text):
            mapped = tuple(b2u[b] for b in tok.encode("utf-8"))
            if len(mapped) >= 1:
                word_freq[mapped] = word_freq.get(mapped, 0) + 1

    # pair counts + index of which words contain each pair
    pair_count: Dict[Tuple[str, str], int] = {}
    pair_words: Dict[Tuple[str, str], set] = {}
    words: List[Tuple[str, ...]] = list(word_freq)
    freqs: List[int] = [word_freq[w] for w in words]

    def add_word(idx: int, word: Tuple[str, ...], f: int):
        for p in zip(word[:-1], word[1:]):
            if never_merge in p[0] or never_merge in p[1]:
                continue
            pair_count[p] = pair_count.get(p, 0) + f
            pair_words.setdefault(p, set()).add(idx)

    def remove_word(idx: int, word: Tuple[str, ...], f: int):
        for p in zip(word[:-1], word[1:]):
            if p not in pair_count:
                continue
            pair_count[p] -= f
            if pair_count[p] <= 0:
                del pair_count[p]
                pair_words.pop(p, None)
            else:
                s = pair_words.get(p)
                if s is not None:
                    s.discard(idx)

    for i, (w, f) in enumerate(zip(words, freqs)):
        add_word(i, w, f)

    merges: List[Tuple[str, str]] = []
    while len(merges) < n_merges and pair_count:
        # deterministic tie-break: count desc, then lexicographic
        best = max(pair_count.items(), key=lambda kv: (kv[1], kv[0]))[0]
        if pair_count[best] < min_pair_count:
            break
        merges.append(best)
        a, b = best
        ab = a + b
        for idx in list(pair_words.get(best, ())):
            word, f = words[idx], freqs[idx]
            remove_word(idx, word, f)
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(ab)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            words[idx] = tuple(merged)
            add_word(idx, words[idx], f)

    return BPETokenizer(merges=merges, specials=specials)


def train_bpe_for_task(
    task_name: str,
    vocab_size: int = 2048,
    n_episodes: int = 200,
    seed: int = 0,
    save_path: Optional[str] = None,
) -> BPETokenizer:
    """Train a tokenizer on a task's own scripted-data distribution (an
    in-repo recipe; nothing is downloaded). `task_name` is a key of the
    port's `cli.tasks.TASKS`."""
    from lmrl_gym_torch.cli.tasks import TASKS

    task = TASKS[task_name]
    texts: List[str] = []
    for chain in task.generate_chains(n_episodes, seed):
        curr = chain
        while curr is not None:
            for t in curr.text_trajectory.text_history:
                texts.append(t.text)
            curr = curr.next
    tok = train_bpe(texts, vocab_size=vocab_size)
    if save_path:
        tok.save(save_path)
    return tok
