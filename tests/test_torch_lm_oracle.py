"""The port's LM oracles (`lmrl_gym_torch/envs/lm_oracle.py` and the LM
oracle / buyer classes of the dialog envs) against the JAX package's, on
the CPU in f32.

- The collectors' supervised windows are identical (host Python).
- A few `train_oracle_lm` steps (the decoder oracle's BC on the port's
  `make_bc_train_step`) from the JAX function's own initial draw: the
  parameters within `test_torch_ilql.py`'s 2e-6 abs + 1e-4 rel, where an
  element apart must have had, on some step, a gradient below 1e-3 of its
  tensor's largest (the share `test_torch_ppo_gate_parity.py` takes across
  steps; Adam's first updates are ±lr whatever the gradient's size).
- Greedy oracle answers (normalized and raw) are identical as strings to
  the JAX package's on converted weights, for the decoder (`LMServer`)
  and the T5 (`Seq2SeqServer`) oracle alike, and the batched call (one
  padded generate per env turn) equals per-item calls; the Guess-My-City
  oracle and the Car-Dealer LM buyer likewise.
- An oracle saved by either package loads in the other with the same
  answers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.algos.value_policy import _encode_prompts
from lmrl_gym_torch.core.blocking import Padding
from lmrl_gym_torch.envs import lm_oracle as tlo
from lmrl_gym_torch.envs.car_dealer import data as tcd
from lmrl_gym_torch.envs.twenty_questions import oracle as tq_oracle
from lmrl_gym_torch.envs.twenty_questions.data import get_default_word_list as t_words
from lmrl_gym_torch.models import encdec as te
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.models.convert import encdec_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.text.frames import Text
from lmrl_gym_torch.text.tokenizer import ByteTokenizer
from lmrl_gym_tpu.envs import lm_oracle as jlo
from lmrl_gym_tpu.envs.car_dealer import data as jcd
from lmrl_gym_tpu.envs.twenty_questions.data import get_default_word_list as j_words
from lmrl_gym_tpu.models import encdec as je
from lmrl_gym_tpu.models import transformer as jtransformer
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.text.frames import Text as JText

PARAM_ATOL, PARAM_RTOL, NOISE = 2e-6, 1e-4, 1e-3
QUESTIONS = ["Is it an animal?", "Is it a cat?", "Is it a fruit?", "Does it fly?", "Is it a kitchen utensil?",
             "Is this a valid question?\n", "Is it a car?"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _text(history):
    return [(t.text, t.is_action) for t in history]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(tlo.COLLECTORS))
def test_collectors_match_jax(name):
    got = tlo.COLLECTORS[name](3, 5)
    want = jlo.COLLECTORS[name](3, 5)
    assert [(_text(w.text_history), list(w.reward), w.done) for w in got] == \
        [(_text(w.text_history), list(w.reward), w.done) for w in want]
    if name == "twenty_questions":
        got = tlo.collect_twenty_questions_qa_balanced(seed=2)
        want = jlo.collect_twenty_questions_qa_balanced(seed=2)
        assert [_text(w.text_history) for w in got] == [_text(w.text_history) for w in want]


def _trained_decoder(monkeypatch, windows, cfg):
    """The JAX and the port's `train_oracle_lm` on the same windows from
    the JAX draw; returns (jax core, params; port core, params, noise)."""
    tok = ByteTokenizer()
    jcore, _, jparams, jconfig = jlo.train_oracle_lm(windows[0], cfg[0], tokenizer=tok, log=lambda s: None)
    jinit = jtransformer.init_params(jconfig, jax.random.PRNGKey(cfg[0].seed))
    config = TransformerConfig.from_dict(jconfig.to_dict())
    init = Transformer(config, device="cpu")
    init.load_state_dict(params_from_jax(_np(jinit), config))
    noise = {}
    vag = tbc.value_and_grads

    def recorded(loss, modules):
        grads = vag(loss, modules)
        for k, g in grads[0].items():
            g = g.abs()
            noise[k] = noise.get(k, torch.zeros_like(g, dtype=torch.bool)) | (g <= NOISE * g.max())
        return grads

    monkeypatch.setattr(tbc, "value_and_grads", recorded)
    core, _, params, tconfig = tlo.train_oracle_lm(windows[1], cfg[1], tokenizer=tok, log=lambda s: None,
                                                   device="cpu", params=init)
    assert tconfig.to_dict() == jconfig.to_dict()
    return jcore, jparams, core, params, noise


def test_train_oracle_lm_matches_jax(monkeypatch):
    wins = (jlo.collect_twenty_questions_qa(2, seed=1)[:24], tlo.collect_twenty_questions_qa(2, seed=1)[:24])
    kw = dict(epochs=2, train_bsize=8, max_length=128, hidden_size=64, num_layers=2, num_heads=4, seed=4)
    jcore, jparams, core, params, noise = _trained_decoder(
        monkeypatch, wins, (jlo.OracleTrainConfig(**kw), tlo.OracleTrainConfig(**kw)))
    ref = params_from_jax(_np(jparams), core.config)
    n_apart = 0
    for k, t in params.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        bad = apart & ~noise[k].numpy()
        assert not bad.any(), f"{k}: {int(bad.sum())} elements apart where the gradient is not noise"
        n_apart += int(apart.sum())
    print(f"{n_apart} elements apart, all at noise-level gradients")


def _decoder_pair(seed=0, hidden=64):
    jcfg = jlo._oracle_model_config(jlo.OracleTrainConfig(hidden_size=hidden, num_layers=2), 259)
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(seed))
    config = TransformerConfig.from_dict(jcfg.to_dict())
    model = Transformer(config, device="cpu")
    model.load_state_dict(params_from_jax(_np(jparams), config))
    return JCore(jcfg), jparams, LMCore(config, device="cpu"), model


def _t5_pair(seed=0):
    jcfg = je.tiny_encdec_config(vocab_size=259, num_layers=1)
    jparams = je.init_encdec_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = te.EncDecConfig.from_dict(jcfg.to_dict())
    model = te.EncoderDecoder(tcfg, device="cpu")
    model.load_state_dict(encdec_params_from_jax(_np(jparams)))
    return je.EncDecCore(jcfg), jparams, te.EncDecCore(tcfg, device="cpu"), model


@pytest.mark.parametrize("arch", ["decoder", "t5"])
def test_oracle_answers_match_jax(arch):
    """The 20Q and Guess-My-City LM oracles, greedy, raw and normalized."""
    jcore, jparams, core, model = _decoder_pair(seed=2) if arch == "decoder" else _t5_pair(seed=2)
    tok = ByteTokenizer()
    tenv = tlo.build_lm_twenty_questions_env(core, tok, model, batched=True)
    jenv = jlo.build_lm_twenty_questions_env(jcore, tok, jparams, batched=True)
    words = t_words()[::15][: len(QUESTIONS)]
    jw = j_words()[::15][: len(QUESTIONS)]
    got = tenv.oracle.generate_answers(words, QUESTIONS, return_full=True)
    want = jenv.oracle.generate_answers(jw, QUESTIONS, return_full=True)
    assert got == want
    # token for token (random weights emit bytes that decode alike)
    prompts = [tq_oracle.oracle_prompt(w, q) for w, q in zip(words, QUESTIONS)]
    pad = Padding.RIGHT if arch == "t5" else Padding.LEFT
    ids, mask = _encode_prompts(tok, prompts, 256, "cpu", pad)
    sampling = tenv.oracle.sampling
    tt, tm = tenv.oracle.server.generate(model, ids, mask, sampling)
    jt, jm = jenv.oracle.server.generate(jparams, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
                                         jenv.oracle.sampling, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the batched call equals per-item calls
    singles = [tenv.oracle.generate_answers(w, q, return_full=True) for w, q in zip(words, QUESTIONS)]
    assert [s[0] for s in singles] == got[0] and [s[1] for s in singles] == got[1]

    t_city = tlo.build_lm_guess_city_env(core, tok, model)
    j_city = jlo.build_lm_guess_city_env(jcore, tok, jparams)
    for city, q in (("Paris,France", "Is it in Europe?"), ("Tokyo,Japan", "Is it a capital?")):
        assert t_city.oracle.generate_answer(city, q, True) == j_city.oracle.generate_answer(city, q, True)


def test_lm_buyer_matches_jax():
    """The Car-Dealer LM buyer's greedy lines on buyer views, and a whole
    LM-buyer episode against the scripted seller."""
    jcore, jparams, core, model = _decoder_pair(seed=3)
    tok = ByteTokenizer()
    tenv = tlo.build_lm_car_dealer_env(core, tok, model, max_conversation_length=4)
    jenv = jlo.build_lm_car_dealer_env(jcore, tok, jparams, max_conversation_length=4)
    th, jh = tenv.reset(5), jenv.reset(5)
    assert tenv.buyer_info == jenv.buyer_info
    done = False
    while not done:
        th = th + (Text("I can offer this one for $45,000. It's a great deal.\n", True),)
        jh = jh + (JText("I can offer this one for $45,000. It's a great deal.\n", True),)
        th, r, done = tenv.step(th)
        jh, jr, jdone = jenv.step(jh)
        assert _text(th) == _text(jh) and (r, done) == (jr, jdone)
    assert len(th) > 3
    view = tcd.create_trajectory_from_conversation(
        {"buyer_info": tenv.buyer_info, "lines": tcd.create_lines_from_text_history(th[:3])}, tcd.Role.BUYER)
    jview = jcd.create_trajectory_from_conversation(
        {"buyer_info": jenv.buyer_info, "lines": jcd.create_lines_from_text_history(jh[:3])}, jcd.Role.BUYER)
    assert _text(tenv.buyer.act(view.text_history)) == _text(jenv.buyer.act(jview.text_history))


@pytest.mark.parametrize("arch", ["decoder", "t5"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_oracle_loads_across_packages(tmp_path, arch, writer):
    cfg = dict(n_episodes=2, epochs=1, train_bsize=16, max_length=128, hidden_size=64, num_layers=2, num_heads=4,
               seed=1)
    tok = ByteTokenizer()
    if writer == "jax":
        jlo.train_and_save_oracle("twenty_questions", str(tmp_path), jlo.OracleTrainConfig(**cfg), tokenizer=tok,
                                  arch=arch)
    else:
        tlo.train_and_save_oracle("twenty_questions", str(tmp_path), tlo.OracleTrainConfig(**cfg), tokenizer=tok,
                                  arch=arch, device="cpu")
    jcore, _, jparams = jlo.load_oracle(str(tmp_path), tokenizer=tok)
    core, _, params = tlo.load_oracle(str(tmp_path), tokenizer=tok, device="cpu")
    assert isinstance(core, te.EncDecCore) == (arch == "t5")
    got = tlo.build_lm_twenty_questions_env(core, tok, params).oracle.generate_answers(
        t_words()[:4], QUESTIONS[:4], return_full=True)
    want = jlo.build_lm_twenty_questions_env(jcore, tok, jparams).oracle.generate_answers(
        j_words()[:4], QUESTIONS[:4], return_full=True)
    assert got == want
