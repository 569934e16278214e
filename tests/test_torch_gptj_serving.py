"""GPT-J-shaped value-guided serving against the JAX package: the fused
Wordle actor and `ValueGuidedServer.generate_from_strs`.

The card runs both at GPT-J-6B's full width (`chip_smoke.py` phase 3j:
`rollout_wordle` at B = 256 and a Text-Nav turn at B = 16); here the same
code runs on tests/test_torch_gptj_model.py's GPT-J-shaped config at
Dh = 256 (d 512, 2 heads, 2 layers, rotary_dim 64 interleaved, parallel
FFN, untied), f32, with two trunks, twin MLP Q heads and β = 32, on the
JAX package's weights and random draws: the JAX rollout's key splits and
the JAX sampler's per-step keys are replayed as Gumbel tensors. Token
streams, rewards, liveness and decoded strings must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import value_policy as jvp
from lmrl_gym_tpu.envs.wordle import vector as jvec
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.models import generation as jgen
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.text.tokenizer import ByteTokenizer as JTok
from lmrl_gym_torch.algos import value_policy as tvp
from lmrl_gym_torch.envs.wordle import vector as tvec
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.models import generation as tgen
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.text.tokenizer import ByteTokenizer as TTok
from test_torch_gptj_model import GPTJ_SMALL, gptj_pair

BETA = 32.0


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the decode's small ops crawl when split across
    a busy machine's cores (the test workers share them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gumbel(key, shape):
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape, jnp.float32)))


def _q_head(cfg, seed):
    kw = dict(input_dim=cfg.hidden_size, hidden_dim=2 * cfg.hidden_size, output_dim=cfg.padded_vocab_size)
    jhead = jheads.MLPHead(jheads.MLPHeadConfig(**kw))
    jp = jheads.init_head_params(jhead, cfg.hidden_size, jax.random.PRNGKey(seed))
    head = theads.MLPHead(theads.MLPHeadConfig(**kw), device="cpu")
    head.load_state_dict(head_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jhead, jp, head


@pytest.fixture(scope="module")
def guided():
    """Two GPT-J-shaped trunks (base, π_β) and twin Q heads, both packages."""
    jcfg, jbase, tcfg, tbase = gptj_pair(seed=0)
    _, jpi, _, tpi = gptj_pair(seed=1)
    jhead, jq1, tq1 = _q_head(tcfg, 2)
    _, jq2, tq2 = _q_head(tcfg, 3)
    return dict(jcfg=jcfg, tcfg=tcfg, jhead=jhead, j=(jpi, jbase, jq1, jq2), t=(tpi, tbase, tq1, tq2))


def _rollout_noise(key, B, V, V_words):
    """rollout_wordle's key splits (turn → (decode, env) → per slot) as Gumbel draws."""
    dec, env = [], []
    for turn_key in jax.random.split(key, jactor.N_TRIES):
        kd, ke = jax.random.split(turn_key)
        dec.append(torch.stack([_gumbel(k, (B, V)) for k in jax.random.split(kd, 2 * jactor.N_CHARS)]))
        env.append(_gumbel(ke, (B, V_words)))
    return tactor.WordleNoise(decode=torch.stack(dec), env=torch.stack(env))


@pytest.mark.parametrize("greedy,constrain_vocab", [(True, True), (False, True), (False, False)])
def test_rollout_wordle_two_trunks_twin_q_matches_jax(guided, greedy, constrain_vocab):
    """The slice's rollout: two trunks, twin Q, β = 32, on the constrained
    vocab (greedy and sampled) and unconstrained (sampled)."""
    B = 4
    jcfg = jtiny(**{**GPTJ_SMALL, "max_position_embeddings": jactor.EPISODE_LEN})
    tcfg = ttiny(**{**GPTJ_SMALL, "max_position_embeddings": tactor.EPISODE_LEN})
    jenv = jvec.WordleVectorEnv(jvec.WordleVocab.from_file())
    tenv = tvec.WordleVectorEnv(tvec.WordleVocab.from_file(), device="cpu")
    jpi, jbase, jq1, jq2 = guided["j"]
    tpi, tbase, tq1, tq2 = guided["t"]
    jstep, jcarry = jactor.make_value_guided_step_fn(JCore(jcfg), guided["jhead"], B, two_trunks=True, twin_q=True,
                                                     beta=BETA)
    tstep, tcarry = tactor.make_value_guided_step_fn(TCore(tcfg, device="cpu"), B, two_trunks=True, twin_q=True,
                                                     beta=BETA)
    key = jax.random.PRNGKey(11)
    temperature = 1.0 if greedy else 2.0
    ref = jactor.rollout_wordle(jenv, jstep, {"pi_beta": jpi, "base": jbase, "q1": jq1, "q2": jq2}, jcarry, key,
                                jnp.zeros((B,)), temperature, greedy, constrain_vocab=constrain_vocab)
    out = tactor.rollout_wordle(tenv, tstep, {"pi_beta": tpi, "base": tbase, "q1": tq1, "q2": tq2}, tcarry, B,
                                temperature, greedy, constrain_vocab,
                                noise=_rollout_noise(key, B, tcfg.padded_vocab_size, len(tenv.vocab)))
    for f in ("tokens", "turn_reward", "turn_live", "win", "n_turns"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    assert tcarry[0].k[0].shape[-1] == 256  # the caches hold GPT-J's head width


# Text-Nav-like prompts of different lengths: left-padded to the longest
PROMPTS = [
    "You are in the kitchen. There is a fridge here.\nAction:",
    "go west\nYou are in the hallway.\nAction:",
    "You see a locked door.\n",
    "take key\nYou take the key from the table. Exits: north, east.\nAction:",
]


@pytest.mark.parametrize("greedy", [True, False])
def test_generate_from_strs_left_padded_matches_jax(guided, greedy):
    """Two trunks, twin Q, β = 32, four left-padded prompts (a power of two,
    so the JAX server's batch bucketing adds no rows), 12 new tokens; the
    sampled case replays the JAX sampler's per-step keys."""
    jcfg, tcfg = guided["jcfg"], guided["tcfg"]
    jpi, jbase, jq1, jq2 = guided["j"]
    tpi, tbase, tq1, tq2 = guided["t"]
    n_new, max_len = 12, 80
    jserver = jvp.ValueGuidedServer(JCore(jcfg), guided["jhead"], None, JTok(), beta=BETA)
    tserver = tvp.ValueGuidedServer(TCore(tcfg, device="cpu"), TTok(), beta=BETA)
    cfg = dict(max_new_tokens=n_new, greedy=greedy, temperature=1.0 if greedy else 1.5, pad_token_id=256,
               eos_token_id=10)
    key = jax.random.PRNGKey(3)
    ref = jserver.generate_from_strs(jvp.ValueRLParams(jpi, jbase, jq1, jq2, None), PROMPTS, max_len,
                                     jgen.SamplingConfig(**cfg), key)
    gumbel = None
    if not greedy:
        gumbel = torch.stack([_gumbel(k, (len(PROMPTS), tcfg.padded_vocab_size))
                              for k in jax.random.split(key, n_new)])
    out = tserver.generate_from_strs(tvp.ValueRLParams(tpi, tbase, tq1, tq2, None), PROMPTS, max_len,
                                     tgen.SamplingConfig(**cfg), gumbel=gumbel)
    assert out == ref
    assert len({len(p) for p in PROMPTS}) == len(PROMPTS)  # every row left-padded differently
