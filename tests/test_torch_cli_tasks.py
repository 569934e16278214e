"""The port's task registry, tokenizer loading and CLI flags against the
JAX package's: `cli/tasks.py` (the Wordle and partially observed maze
builders and chain generators, and `TASKS`), `text/tokenizer.py`
(`load_tokenizer`, `newline_id`), and `parse_args` of `cli.train` and
`cli.evaluate`. Everything here is host-side text and must be identical.
"""
import pytest

import lmrl_gym_tpu.cli.evaluate as jeval
import lmrl_gym_tpu.cli.train as jtrain
from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.text import tokenizer as jtok
from lmrl_gym_torch.cli import evaluate as teval
from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.cli import train as ttrain
from lmrl_gym_torch.text import tokenizer as ttok
from lmrl_gym_torch.text.bpe import BPETokenizer, train_bpe
from lmrl_gym_torch.text.frames import Text


def _chain_items(chain):
    out = []
    while chain is not None:
        tt = chain.text_trajectory
        out.append(([(t.text, t.is_action) for t in tt.text_history], list(tt.reward), tt.done))
        chain = chain.next
    return out


def test_tasks_key_set_and_windows():
    assert sorted(ttasks.TASKS) == sorted(jtasks.TASKS)
    for name, task in jtasks.TASKS.items():
        assert ttasks.TASKS[name].max_length == task.max_length, name
        assert ttasks.TASKS[name].stop_token == task.stop_token, name
    assert ttasks.TASKS["wordle"].max_length == 160 and ttasks.TASKS["maze_partial"].max_length == 384


@pytest.mark.parametrize("task,n,seed", [("wordle", 12, 3), ("maze_partial", 4, 1), ("maze_partial", 3, 7)])
def test_chains_identical(task, n, seed):
    j = [_chain_items(c) for c in jtasks.TASKS[task].generate_chains(n, seed)]
    t = [_chain_items(c) for c in ttasks.TASKS[task].generate_chains(n, seed)]
    assert t == j and len(t) == n


@pytest.mark.parametrize("task,actions", [
    ("wordle", ["crane", "slate", "xxxxx", "money", "towel", "about", "crane"]),
    ("maze_partial", ["move up", "move left", "move down", "move right", "move up"] * 3),
])
def test_envs_identical(task, actions):
    for seed in (0, 5):
        jenv, tenv = jtasks.TASKS[task].build_env(), ttasks.TASKS[task].build_env()
        jh, th = jenv.reset(seed=seed), tenv.reset(seed=seed)
        assert [(x.text, x.is_action) for x in th] == [(x.text, x.is_action) for x in jh]
        for a in actions:
            if task == "wordle":
                a = " ".join(a) + "\n"
            jh, jr, jd = jenv.step(jh + (jtasks.Text(a, True),))
            th, tr, td = tenv.step(th + (Text(a, True),))
            assert [(x.text, x.is_action) for x in th] == [(x.text, x.is_action) for x in jh]
            assert (tr, td) == (jr, jd)
            if jd:
                break


def test_load_tokenizer_specs(tmp_path):
    for spec in (None, "byte"):
        tok = ttok.load_tokenizer(spec)
        assert isinstance(tok, ttok.ByteTokenizer)
        assert type(jtok.load_tokenizer(spec)).__name__ == "ByteTokenizer"
    text = "move up\nthe goal is at 8, 6.\n"
    bpe = train_bpe([text, "move down\n", "move left\n"] * 4, vocab_size=300)
    bpe.save(str(tmp_path / "bpe.json"))
    tok = ttok.load_tokenizer(f"bpe:{tmp_path / 'bpe.json'}")
    assert isinstance(tok, BPETokenizer)
    assert tok.encode(text) == jtok.load_tokenizer(f"bpe:{tmp_path / 'bpe.json'}").encode(text) == bpe.encode(text)
    # an HF tokenizer directory, built here: read from local files only
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    vocab = {"[UNK]": 0, "</s>": 1, "move": 2, "up": 3, "down": 4}
    core = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    core.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    hf_dir = tmp_path / "hf_tok"
    transformers.PreTrainedTokenizerFast(tokenizer_object=core, eos_token="</s>").save_pretrained(str(hf_dir))
    tok, jt = ttok.load_tokenizer(str(hf_dir)), jtok.load_tokenizer(str(hf_dir))
    assert type(tok).__name__ == type(jt).__name__ != "ByteTokenizer"
    assert tok.pad_token == tok.eos_token == "</s>"  # no pad token: eos stands in
    assert tok.encode("move up down") == jt.encode("move up down") == [2, 3, 4]
    # a name with no local files falls back to bytes, as in the JAX package
    missing = str(tmp_path / "no_such_tokenizer")
    assert isinstance(ttok.load_tokenizer(missing), ttok.ByteTokenizer)
    assert type(jtok.load_tokenizer(missing)).__name__ == "ByteTokenizer"


def test_newline_id():
    assert ttok.newline_id(ttok.ByteTokenizer()) == jtok.newline_id(jtok.ByteTokenizer()) == 10
    bpe = train_bpe(["a b\n", "c\n"], vocab_size=270)
    assert ttok.newline_id(bpe) == jtok.newline_id(bpe) == bpe.newline_token_id

    class Plain:  # no newline_token_id: the byte value of "\n"
        pass

    assert ttok.newline_id(Plain()) == jtok.newline_id(Plain()) == 10


@pytest.mark.parametrize("argv", [
    ["--task", "maze", "--algo", "bc"],
    ["--task", "wordle", "--algo", "ilql", "--model-size", "gpt2-small-real", "--tokenizer", "bpe", "--n-data",
     "64", "--epochs", "1", "--train-bsize", "16", "--eval-rollouts", "8", "--save-dir", "out"],
    ["--task", "twenty_questions", "--algo", "ppo", "--online-rounds", "4", "--oracle", "lm", "--oracle-arch", "t5",
     "--ppo-kl-target", "0.05", "--bc-loss-weight", "0.1", "--no-eval", "--mesh", "1,1,1"],
    ["--task", "car_dealer", "--algo", "filtered_bc", "--data-jsonl", "d.jsonl", "--dump-data-jsonl", "e.jsonl",
     "--filter-top-frac", "0.5", "--seed", "3", "--resume", "ckpt"],
])
def test_train_parse_args_match(argv):
    t = vars(ttrain.parse_args(argv + ["--device", "cpu"]))
    assert t.pop("device") == "cpu"
    assert t == vars(jtrain.parse_args(argv))
    assert vars(ttrain.parse_args(argv))["device"] == "cuda"


@pytest.mark.parametrize("argv", [
    ["--task", "maze", "--checkpoint", "ckpt"],
    ["--task", "wordle", "--algo", "ilql", "--checkpoint", "c", "--policy", "guided", "--tokenizer", "bpe:b.json",
     "--n-rollouts", "8", "--sample", "--beta", "4", "--out", "r.json"],
    ["--task", "chess", "--policy", "api", "--api-model", "m", "--chess-positions", "3", "--no-cell-accuracy"],
])
def test_evaluate_parse_args_match(argv):
    t = vars(teval.parse_args(argv + ["--device", "cpu"]))
    assert t.pop("device") == "cpu"
    assert t == vars(jeval.parse_args(argv))


def test_mesh_fits_one_device_or_raises():
    for mesh in ("1,-1,1", "1,1,1", "-1,1,1"):
        ttrain.check_mesh(mesh)
    for mesh in ("2,-1,1", "1,2,1", "1,1,4", "-1,-1,1"):
        with pytest.raises(NotImplementedError, match="item 10"):
            ttrain.check_mesh(mesh)


def test_wordle_filtered_vocab_matches_the_loop():
    """`WordleGame`'s filtered vocab, now vectorized (`game.filtered_mask`),
    against the per-word loop `word_satisfies` over random knowledge
    states (the Wordle chains above rest on it)."""
    import random

    import numpy as np

    from lmrl_gym_torch.envs.wordle.game import apply_guess, filtered_mask, word_satisfies
    from lmrl_gym_torch.envs.wordle.vector import ALPHA, N_CHARS, POSSIBLE, WordleVocab

    vocab, rng = WordleVocab.from_file(), random.Random(0)
    for _ in range(60):
        knowledge = np.full((ALPHA, N_CHARS), POSSIBLE, dtype=np.int8)
        for _ in range(rng.randint(0, 4)):
            knowledge = apply_guess(knowledge, rng.choice(vocab.words), rng.choice(vocab.words))
        assert list(filtered_mask(knowledge, vocab)) == [word_satisfies(knowledge, w) for w in vocab.words]
