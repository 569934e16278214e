"""The port's BPE (`text/bpe.py`, stdlib `re` in place of the `regex`
package) against the JAX package's: trained on the maze and Wordle
corpora, the same merges and the same ids (tolerance 0); a hypothesis test
over ASCII strings holds the two pre-tokenizers' splits equal."""
import string

import pytest
from hypothesis import given, settings, strategies as st

from lmrl_gym_tpu.cli.tasks import generate_wordle_chains
from lmrl_gym_tpu.text import bpe as jbpe
from lmrl_gym_torch.text import bpe as tbpe


def _texts(chains):
    out = []
    for chain in chains:
        curr = chain
        while curr is not None:
            out.extend(t.text for t in curr.text_trajectory.text_history)
            curr = curr.next
    return out


@pytest.fixture(scope="module")
def maze_pair():
    return (jbpe.train_bpe_for_task("maze", vocab_size=512, n_episodes=40, seed=0),
            tbpe.train_bpe_for_task("maze", vocab_size=512, n_episodes=40, seed=0))


@pytest.fixture(scope="module")
def wordle_pair():
    texts = _texts(generate_wordle_chains(40, seed=0))
    return jbpe.train_bpe(texts, vocab_size=600), tbpe.train_bpe(texts, vocab_size=600), texts


def test_maze_bpe_matches(maze_pair):
    j, t = maze_pair
    assert len(j.merges) > 50 and t.merges == j.merges
    assert (t.vocab_size, t.pad_token_id, t.eos_token_id, t.newline_token_id) == \
        (j.vocab_size, j.pad_token_id, j.eos_token_id, j.newline_token_id)
    from lmrl_gym_torch.cli.tasks import generate_maze_chains

    for text in _texts(generate_maze_chains(5, seed=9)):
        ids = t.encode(text)
        assert ids == j.encode(text) and t.decode(ids) == j.decode(ids) == text


def test_wordle_bpe_matches(wordle_pair):
    j, t, texts = wordle_pair
    # Wordle's frames spell words letter by letter: few pairs recur
    assert len(j.merges) > 20 and t.merges == j.merges
    for text in texts[:200]:
        assert t.encode(text, add_special_tokens=True) == j.encode(text, add_special_tokens=True)
    assert t.batch_decode([[1, 2, t.pad_token_id]], skip_special_tokens=False) == \
        j.batch_decode([[1, 2, j.pad_token_id]], skip_special_tokens=False)


def test_save_load_round_trip(maze_pair, tmp_path):
    j, t = maze_pair
    path = str(tmp_path / "bpe.json")
    t.save(path)
    assert jbpe.BPETokenizer.load(path).merges == tbpe.BPETokenizer.load(path).merges == j.merges


@settings(max_examples=400, deadline=None)
@given(st.text(alphabet=st.characters(min_codepoint=0, max_codepoint=127), max_size=40))
def test_pretokenizer_splits_agree_on_ascii(s):
    assert tbpe._PRETOKENIZE.findall(s) == jbpe._PRETOKENIZE.findall(s)


@pytest.mark.parametrize("s", ["don't stop\n\n  x", "a_b __c 12ab 3.4", "\x1c\x1dy \x1e", "\t \n", string.printable])
def test_pretokenizer_edge_cases(s):
    assert tbpe._PRETOKENIZE.findall(s) == jbpe._PRETOKENIZE.findall(s)
