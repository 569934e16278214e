"""Training-data construction from token trajectory chains: the port of
`lmrl_gym_tpu/algos/data.py` (numpy only, as there). Each chain link
becomes one example; blocking pads input_ids to max_length and the shifted
per-token arrays to max_length-1. The datasets draw from the same numpy
RNG calls, so one seed gives the same batches in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from lmrl_gym_torch.core.blocking import BlockingStrategy, block_sequences
from lmrl_gym_torch.text.frames import TokenTrajectoryChain


class ILQLExample(NamedTuple):
    """One chain link. next_token_ids = next window's
    tokens up to (and excluding) its first action token — the bootstrap
    state for v_final."""

    input_ids: np.ndarray  # [t]
    should_take_action: np.ndarray  # [t-1]
    rewards: np.ndarray  # [t-1]
    done: np.ndarray  # []
    next_token_ids: Optional[np.ndarray]  # [t']
    next_done: Optional[np.ndarray]  # []

    @classmethod
    def from_chain(cls, chain: TokenTrajectoryChain) -> "ILQLExample":
        if chain.next is not None:
            nxt = chain.next.token_trajectory
            if nxt.is_action[1:].sum() > 0:
                first_action = int(np.argmax(nxt.is_action[1:])) + 1
                next_token_ids = nxt.tokens[:first_action]
                next_done = np.asarray(False)
            else:
                next_token_ids = nxt.tokens
                next_done = nxt.done
        else:
            next_token_ids, next_done = None, None
        tt = chain.token_trajectory
        return cls(
            input_ids=tt.tokens,
            should_take_action=tt.is_action[1:],
            rewards=tt.reward[1:],
            done=tt.done,
            next_token_ids=next_token_ids,
            next_done=next_done,
        )


def block_ilql_examples(
    examples: List[ILQLExample],
    strategy: BlockingStrategy,
    pad_token_id: int,
) -> Dict[str, Optional[np.ndarray]]:
    has_next = any(e.next_token_ids is not None for e in examples)
    if has_next:
        # chain-final windows have no successor: bootstrap with an empty
        # next window marked done (v_final multiplies by (1-next_done)=0,
        # so the pad forward contributes nothing)
        examples = [
            e
            if e.next_token_ids is not None
            else e._replace(
                next_token_ids=np.zeros((0,), np.int32),
                next_done=np.asarray(True),
            )
            for e in examples
        ]
    shifted = BlockingStrategy(
        strategy.padding, strategy.truncation, strategy.max_length - 1
    )
    return dict(
        input_ids=block_sequences(
            [e.input_ids for e in examples], pad_token_id, np.int32, strategy
        ),
        should_take_action=block_sequences(
            [e.should_take_action for e in examples], False, np.bool_, shifted
        ),
        rewards=block_sequences(
            [e.rewards for e in examples], 0.0, np.float32, shifted
        ),
        dones=np.asarray([e.done for e in examples], dtype=np.bool_),
        next_token_ids=block_sequences(
            [e.next_token_ids for e in examples], pad_token_id, np.int32, strategy
        )
        if has_next
        else None,
        next_dones=np.asarray([e.next_done for e in examples], dtype=np.bool_)
        if has_next
        else None,
    )


def reward_to_go_np(rewards: np.ndarray, gamma: float) -> np.ndarray:
    """Discounted reward-to-go over a 1-D action-reward sequence."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for i in reversed(range(len(rewards))):
        acc = rewards[i] + gamma * acc
        out[i] = acc
    return out


class MCExample(NamedTuple):
    """Reward-to-go example: the rtg sequence is
    computed over the *whole chain's* action tokens, then the first
    window's share is scattered back onto its action positions."""

    input_ids: np.ndarray  # [t]
    should_take_action: np.ndarray  # [t-1]
    returns: np.ndarray  # [t-1]

    @classmethod
    def from_chain(cls, chain: TokenTrajectoryChain, gamma: float) -> "MCExample":
        chain_rewards = []
        for tt in chain.to_list():
            chain_rewards.append(tt.reward[1:][tt.is_action[1:]])
        rtg = reward_to_go_np(np.concatenate(chain_rewards), gamma)

        tt = chain.token_trajectory
        should_take_action = tt.is_action[1:]
        returns = np.zeros_like(should_take_action, dtype=np.float32)
        returns[should_take_action] = rtg[: should_take_action.sum()]
        return cls(tt.tokens, should_take_action, returns)


def block_mc_examples(
    examples: List[MCExample],
    strategy: BlockingStrategy,
    pad_token_id: int,
) -> Dict[str, np.ndarray]:
    shifted = BlockingStrategy(
        strategy.padding, strategy.truncation, strategy.max_length - 1
    )
    return dict(
        input_ids=block_sequences(
            [e.input_ids for e in examples], pad_token_id, np.int32, strategy
        ),
        should_take_action=block_sequences(
            [e.should_take_action for e in examples], False, np.bool_, shifted
        ),
        returns=block_sequences(
            [e.returns for e in examples], 0.0, np.float32, shifted
        ),
    )


class BCExample(NamedTuple):
    """Masked-LM example: loss on action tokens."""

    input_ids: np.ndarray  # [t]
    training_mask: np.ndarray  # [t] float: 1 on action tokens

    @classmethod
    def from_segments(cls, tokens: np.ndarray, is_action: np.ndarray) -> "BCExample":
        return cls(tokens.astype(np.int32), is_action.astype(np.float32))


def block_bc_examples(
    examples: List[BCExample],
    strategy: BlockingStrategy,
    pad_token_id: int,
) -> Dict[str, np.ndarray]:
    return dict(
        input_ids=block_sequences(
            [e.input_ids for e in examples], pad_token_id, np.int32, strategy
        ),
        training_mask=block_sequences(
            [e.training_mask for e in examples], 0.0, np.float32, strategy
        ),
    )


def filter_items(
    score_fn,
    items: Sequence,
    take_top_fraction: float,
) -> List:
    """%BC filter: keep the top fraction by score (ties in descending index
    order, as `argsort(...)[::-1]`)."""
    scores = [score_fn(it) for it in items]
    order = np.argsort(scores)[::-1]
    keep = max(1, int(round(len(items) * take_top_fraction)))
    return [items[i] for i in order[:keep]]


@dataclass
class ArrayDataset:
    """Dict-of-arrays dataset with shuffled batch iteration."""

    arrays: Dict[str, Optional[np.ndarray]]

    def __post_init__(self):
        sizes = {v.shape[0] for v in self.arrays.values() if v is not None}
        assert len(sizes) == 1, "all arrays must share the batch dim"
        self.size = sizes.pop()

    def __len__(self) -> int:
        return self.size

    def batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = True,
    ) -> Iterator[Dict[str, Optional[np.ndarray]]]:
        idx = np.arange(self.size)
        if rng is not None:
            rng.shuffle(idx)
        end = self.size - (self.size % batch_size) if drop_last else self.size
        if end == 0:
            # dataset smaller than one batch: yield it rather than nothing
            end = self.size
        for start in range(0, end, batch_size):
            sel = idx[start : start + batch_size]
            yield {
                k: (v[sel] if v is not None else None)
                for k, v in self.arrays.items()
            }


class IterableDataset:
    """Streaming dataset: pulls examples from a re-openable source and
    collates fixed-size batches on the fly, with an optional bounded
    shuffle buffer, for corpora that don't fit in host memory.

    `example_factory()` must return a fresh iterator of row dicts
    (str → np.ndarray) each call, so every epoch re-streams the source.
    """

    def __init__(self, example_factory: Callable[[], Iterator[Dict[str, np.ndarray]]]):
        self.example_factory = example_factory

    def batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = True,
        shuffle_buffer: int = 1024,
    ) -> Iterator[Dict[str, np.ndarray]]:
        def collate(rows: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
            return {
                k: np.stack([r[k] for r in rows]) for k in rows[0]
            }

        buffer: List[Dict[str, np.ndarray]] = []
        pending: List[Dict[str, np.ndarray]] = []
        for row in self.example_factory():
            if rng is not None and shuffle_buffer > 1:
                buffer.append(row)
                if len(buffer) >= shuffle_buffer:
                    pending.append(buffer.pop(int(rng.integers(len(buffer)))))
            else:
                pending.append(row)
            if len(pending) >= batch_size:
                yield collate(pending[:batch_size])
                pending = pending[batch_size:]
        if rng is not None:
            rng.shuffle(buffer)
        pending.extend(buffer)
        for start in range(0, len(pending), batch_size):
            chunk = pending[start : start + batch_size]
            if len(chunk) == batch_size or (not drop_last and chunk):
                yield collate(chunk)


def bc_rows_from_segments_jsonl(
    path: str, tokenizer, strategy, pad_token_id: Optional[int] = None
) -> Callable[[], Iterator[Dict[str, np.ndarray]]]:
    """jsonl → streaming BC rows. Each line is a list of
    [text, is_action] segments (one conversation); LM loss is masked to
    action tokens."""
    from lmrl_gym_torch.core.blocking import block_sequences
    from lmrl_gym_torch.core.io import jsonl_stream

    pad = tokenizer.pad_token_id if pad_token_id is None else pad_token_id

    def factory() -> Iterator[Dict[str, np.ndarray]]:
        for segments in jsonl_stream(path):
            tokens: List[int] = []
            is_action: List[bool] = []
            for text, act in segments:
                ids = tokenizer.encode(text)
                tokens.extend(ids)
                is_action.extend([bool(act)] * len(ids))
            ex = BCExample(
                input_ids=np.asarray(tokens, np.int32),
                training_mask=np.asarray(is_action, bool),
            )
            blocked = block_bc_examples([ex], strategy, pad)
            yield {k: v[0] for k, v in blocked.items()}

    return factory


def dump_chains_to_segments_jsonl(chains, path: str) -> int:
    """TextTrajectoryChains → the segments-jsonl format above (one line
    per chain window). Returns the number of lines written."""
    from lmrl_gym_torch.core.io import jsonl_dump

    lines = []
    for chain in chains:
        curr = chain
        while curr is not None:
            lines.append(
                [[t.text, bool(t.is_action)] for t in curr.text_trajectory.text_history]
            )
            curr = curr.next
    jsonl_dump(lines, path)
    return len(lines)
