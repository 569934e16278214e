"""The port's data layer (`algos/data.py`, the jsonl helpers of
`core/io.py`) against the JAX package's, on maze chains both packages make
from the same seeds. Everything here is host numpy, so every array must be
equal exactly (tolerance 0)."""
import numpy as np
import pytest

from lmrl_gym_tpu.algos import data as jdata
from lmrl_gym_tpu.cli.tasks import generate_maze_chains as jchains
from lmrl_gym_tpu.core import io as jio
from lmrl_gym_tpu.core.blocking import BlockingStrategy as JStrategy, Padding as JPad, Truncation as JTrunc
from lmrl_gym_tpu.text.frames import TokenTrajectoryChain as JTokenChain
from lmrl_gym_tpu.text.tokenizer import ByteTokenizer as JByte
from lmrl_gym_torch.algos import data as tdata
from lmrl_gym_torch.cli.tasks import generate_maze_chains as tchains
from lmrl_gym_torch.core import io as tio
from lmrl_gym_torch.core.blocking import BlockingStrategy as TStrategy, Padding as TPad, Truncation as TTrunc
from lmrl_gym_torch.text.frames import TokenTrajectoryChain as TTokenChain
from lmrl_gym_torch.text.tokenizer import ByteTokenizer as TByte

PAD = JByte().pad_token_id
MAX_LEN = 64


@pytest.fixture(scope="module")
def chains():
    j = [JTokenChain.from_text_trajectory_chain(c, JByte()) for c in jchains(6, seed=3, p_optimal=0.35,
                                                                               wrong_bias=True)]
    t = [TTokenChain.from_text_trajectory_chain(c, TByte()) for c in tchains(6, seed=3, p_optimal=0.35,
                                                                               wrong_bias=True)]
    return j, t


def _links(chain):
    out, curr = [], chain
    while curr is not None:
        out.append(curr)
        curr = curr.next
    return out


def _strategies():
    return JStrategy(JPad.RIGHT, JTrunc.RIGHT, MAX_LEN), TStrategy(TPad.RIGHT, TTrunc.RIGHT, MAX_LEN)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_block_ilql_examples_match(chains):
    js, ts = _strategies()
    jex = [jdata.ILQLExample.from_chain(link) for c in chains[0] for link in _links(c)]
    tex = [tdata.ILQLExample.from_chain(link) for c in chains[1] for link in _links(c)]
    assert len(jex) == len(tex) > 6
    _assert_same(jdata.block_ilql_examples(jex, js, PAD), tdata.block_ilql_examples(tex, ts, PAD))
    # without any next window, the next-window arrays are None in both
    _assert_same(jdata.block_ilql_examples([e._replace(next_token_ids=None, next_done=None) for e in jex], js, PAD),
                 tdata.block_ilql_examples([e._replace(next_token_ids=None, next_done=None) for e in tex], ts, PAD))


@pytest.mark.parametrize("gamma", [0.99, 1.0])
def test_block_mc_examples_match(chains, gamma):
    js, ts = _strategies()
    jex = [jdata.MCExample.from_chain(link, gamma) for c in chains[0] for link in _links(c)]
    tex = [tdata.MCExample.from_chain(link, gamma) for c in chains[1] for link in _links(c)]
    _assert_same(jdata.block_mc_examples(jex, js, PAD), tdata.block_mc_examples(tex, ts, PAD))
    r = np.array([-1.0, 0.0, -4.0, -1.0], np.float32)
    np.testing.assert_array_equal(tdata.reward_to_go_np(r, gamma), jdata.reward_to_go_np(r, gamma))


def test_block_bc_examples_match(chains):
    js, ts = _strategies()
    jex = [jdata.BCExample.from_segments(tt.tokens, tt.is_action) for c in chains[0] for tt in c.to_list()]
    tex = [tdata.BCExample.from_segments(tt.tokens, tt.is_action) for c in chains[1] for tt in c.to_list()]
    _assert_same(jdata.block_bc_examples(jex, js, PAD), tdata.block_bc_examples(tex, ts, PAD))


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.01, 1.0])
def test_filter_items_matches(frac):
    items = list(range(11))
    scores = {i: s for i, s in enumerate([3, 1, 3, 0, 2, 3, 1, 1, 0, 2, 3])}  # ties fall as argsort(...)[::-1]
    assert tdata.filter_items(scores.get, items, frac) == jdata.filter_items(scores.get, items, frac)


@pytest.mark.parametrize("size,bsize,drop_last", [(10, 3, True), (10, 3, False), (2, 4, True), (8, 4, True)])
def test_array_dataset_batches_match(size, bsize, drop_last):
    arrays = dict(a=np.arange(size * 2).reshape(size, 2), b=np.arange(size).astype(np.float32), c=None)
    jb = list(jdata.ArrayDataset(arrays).batches(bsize, rng=np.random.default_rng(7), drop_last=drop_last))
    tb = list(tdata.ArrayDataset(arrays).batches(bsize, rng=np.random.default_rng(7), drop_last=drop_last))
    assert len(jb) == len(tb) > 0
    for x, y in zip(jb, tb):
        _assert_same(x, y)
    assert len(tdata.ArrayDataset(arrays)) == size


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
def test_iterable_dataset_batches_match(shuffle, drop_last):
    def factory():
        for i in range(23):
            yield dict(x=np.array([i, 2 * i]), y=np.array(i * 0.5, np.float32))

    kw = dict(rng=np.random.default_rng(11) if shuffle else None, drop_last=drop_last, shuffle_buffer=5)
    jb = list(jdata.IterableDataset(factory).batches(4, **kw))
    kw["rng"] = np.random.default_rng(11) if shuffle else None
    tb = list(tdata.IterableDataset(factory).batches(4, **kw))
    assert len(jb) == len(tb) > 0
    for x, y in zip(jb, tb):
        _assert_same(x, y)


def test_jsonl_round_trip_and_segment_rows_match(tmp_path):
    from lmrl_gym_tpu.cli.tasks import generate_maze_chains as jtext_chains

    items = [dict(a=1, b=[1.5, "x"]), [["hi", True]], "s"]
    path = str(tmp_path / "x.jsonl")
    tio.jsonl_dump(items, path)
    assert tio.jsonl_load(path) == jio.jsonl_load(path) == items
    assert list(tio.jsonl_stream(path)) == items

    text = jtext_chains(3, seed=1)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    assert jdata.dump_chains_to_segments_jsonl(text, jpath) == tdata.dump_chains_to_segments_jsonl(text, tpath)
    assert open(jpath).read() == open(tpath).read()
    js, ts = _strategies()
    jrows = list(jdata.bc_rows_from_segments_jsonl(jpath, JByte(), js)())
    trows = list(tdata.bc_rows_from_segments_jsonl(tpath, TByte(), ts)())
    assert len(jrows) == len(trows) > 3
    for x, y in zip(jrows, trows):
        _assert_same(x, y)
