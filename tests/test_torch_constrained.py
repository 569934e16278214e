"""The port's legal-set decoding, plain-LM server and text policy against the
JAX package, on the same weights (tiny config, f32, the JAX init carried
over by `models/convert.py`).

Greedy decoding must give identical tokens and strings. Sampled decoding
replays the JAX sampler's own Gumbel draws (`jax.random.categorical` is
argmax(logits + gumbel(key))), so its tokens must be identical too — also
where the legal-set mask has set logits to −inf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import value_policy as jvp
from lmrl_gym_tpu.models import generation as jgen
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtr
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.text.frames import Text as JText
from lmrl_gym_tpu.text.tokenizer import ByteTokenizer as JTok
from lmrl_gym_torch.algos import value_policy as tvp
from lmrl_gym_torch.models import generation as tgen
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.text.frames import Text as TText
from lmrl_gym_torch.text.tokenizer import ByteTokenizer as TTok
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

B, T_PROMPT, N_NEW, P, L = 4, 9, 6, 5, 5
PAD, EOS = 256, 10
PROMPTS = ["Wordle:\n", "Wordle:\nc r a n e\nb b y b g\n", "hello", "Wordle:\ns l a t e\ng b b b y\n"]
PROPOSALS = [["c r a n e\n", "s l a t e\n", "c r u s t\n"], ["m o i s t\n"], ["a b\n", "a c\n", "b\n"],
             ["s l a t e\n", "s h a r e\n"]]


def _trunk(seed):
    jcfg, tcfg = jtiny(), ttiny()
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttr.Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    return jcfg, tcfg, jp, model


def _q_head(cfg, seed):
    kw = dict(input_dim=cfg.hidden_size, hidden_dim=2 * cfg.hidden_size, output_dim=cfg.padded_vocab_size)
    jhead = jheads.MLPHead(jheads.MLPHeadConfig(**kw))
    jp = jheads.init_head_params(jhead, cfg.hidden_size, jax.random.PRNGKey(seed))
    head = theads.MLPHead(theads.MLPHeadConfig(**kw), device="cpu")
    head.load_state_dict(head_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jhead, jp, head


def _prompts():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 256, size=(B, T_PROMPT)).astype(np.int32)
    mask = (np.arange(T_PROMPT)[None, :] >= np.asarray([0, 2, 5, 1])[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, PAD), mask


def _candidates(V):
    """[B, P, L] proposals over a few letters, ended by EOS, pad-padded:
    row 0 shares prefixes (a trie), row 1 holds an id past the vocab (dropped)
    and a masked-out proposal, row 2 proposals shorter than the decode with
    no terminator (its set empties: the unmasked fallback), row 3 no valid
    proposal at all (unmasked from the first step)."""
    c = np.full((B, P, L), PAD, np.int32)
    c[0, 0, :4] = [97, 98, 99, EOS]
    c[0, 1, :4] = [97, 98, 100, EOS]
    c[0, 2, :3] = [101, 98, EOS]
    c[0, 3, :5] = [97, 102, 102, 103, EOS]
    c[1, 0, :3] = [V + 5, 98, EOS]
    c[1, 1, :3] = [104, 105, EOS]
    c[1, 2, :3] = [106, 107, EOS]
    c[2, 0, :2] = [97, 98]
    c[2, 1, :1] = [99]
    cmask = np.zeros((B, P), bool)
    cmask[0, :4] = True
    cmask[1, :2] = True  # [1, 2] is not a proposal
    cmask[2, :2] = True
    return c, cmask


def _gumbel(key, steps, shape):
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, shape, jnp.float32))
                                      for k in jax.random.split(key, steps)]))


@pytest.mark.parametrize("greedy,eos", [(True, EOS), (False, EOS), (True, None), (False, None)])
def test_generate_constrained_matches_jax(greedy, eos):
    jcfg, tcfg, jp, model = _trunk(0)
    ids, mask = _prompts()
    cands, cmask = _candidates(tcfg.padded_vocab_size)
    cfg = dict(max_new_tokens=N_NEW, greedy=greedy, temperature=1.5, eos_token_id=eos, pad_token_id=PAD)
    key = jax.random.PRNGKey(3)
    jtoks, jmask = jgen.generate_constrained(
        *JCore(jcfg).make_lm_logits_fn(jp, T_PROMPT + N_NEW, B), jnp.asarray(ids), jnp.asarray(mask), key,
        jgen.SamplingConfig(**cfg), jnp.asarray(cands), jnp.asarray(cmask),
    )
    ttoks, tmask = tgen.generate_constrained(
        *TCore(tcfg, device="cpu").make_lm_logits_fn(model, T_PROMPT + N_NEW, B),
        torch.from_numpy(ids).long(), torch.from_numpy(mask), tgen.SamplingConfig(**cfg),
        torch.from_numpy(cands), torch.from_numpy(cmask),
        gumbel=None if greedy else _gumbel(key, N_NEW, (B, tcfg.padded_vocab_size)),
    )
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    toks = ttoks.numpy()
    # rows 0 and 1 emit one of their live proposals, up to its terminator
    for row, props in ((0, cands[0, :4]), (1, cands[1, :2])):
        n = int(np.argmax(toks[row] == EOS)) + 1 if eos is not None else 3
        assert any(list(toks[row, :n]) == list(p[:n]) for p in props), (row, toks[row])
    assert toks[1, 0] != tcfg.padded_vocab_size + 5


def _servers():
    jcfg, tcfg, jbase, tbase = _trunk(1)
    _, _, jpi, tpi = _trunk(2)
    jhead, jq1, tq1 = _q_head(tcfg, 3)
    _, jq2, tq2 = _q_head(tcfg, 4)
    jserver = jvp.ValueGuidedServer(JCore(jcfg), jhead, None, JTok(), beta=8.0)
    tserver = tvp.ValueGuidedServer(TCore(tcfg, device="cpu"), TTok(), beta=8.0)
    return (jserver, jvp.ValueRLParams(jpi, jbase, jq1, jq2, None)), (tserver, tvp.ValueRLParams(tpi, tbase, tq1, tq2, None))


def test_generate_legal_sampled_matches_jax():
    (jserver, jparams), (tserver, tparams) = _servers()
    ids, mask = _prompts()
    cands, cmask = _candidates(ttiny().padded_vocab_size)
    cfg = dict(max_new_tokens=N_NEW, temperature=1.0, eos_token_id=EOS, pad_token_id=PAD)
    key = jax.random.PRNGKey(8)
    jtoks, jmask = jserver.generate_legal(jparams, jnp.asarray(ids), jnp.asarray(mask), jgen.SamplingConfig(**cfg),
                                          key, jnp.asarray(cands), jnp.asarray(cmask))
    ttoks, tmask = tserver.generate_legal(
        tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask), tgen.SamplingConfig(**cfg),
        torch.from_numpy(cands), torch.from_numpy(cmask), gumbel=_gumbel(key, N_NEW, (B, ttiny().padded_vocab_size)),
    )
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_generate_from_strs_legal_matches_jax():
    (jserver, jparams), (tserver, tparams) = _servers()
    sampling = dict(max_new_tokens=10, greedy=True, eos_token_id=EOS, pad_token_id=PAD)
    jouts = jserver.generate_from_strs_legal(jparams, PROMPTS, PROPOSALS, 48, jgen.SamplingConfig(**sampling),
                                             jax.random.PRNGKey(0))
    touts = tserver.generate_from_strs_legal(tparams, PROMPTS, PROPOSALS, 48, tgen.SamplingConfig(**sampling))
    assert touts == jouts
    for out, props in zip(touts, PROPOSALS):
        assert out in props
    # pinned (P, L) shapes decode the same
    assert tserver.generate_from_strs_legal(tparams, PROMPTS, PROPOSALS, 48, tgen.SamplingConfig(**sampling),
                                            max_proposals=8, max_proposal_len=12) == touts


def test_lm_server_matches_jax():
    jcfg, tcfg, jp, model = _trunk(5)
    jserver, tserver = jvp.LMServer(JCore(jcfg), JTok()), tvp.LMServer(TCore(tcfg, device="cpu"), TTok())
    greedy = dict(max_new_tokens=N_NEW, greedy=True, pad_token_id=PAD)
    jouts = jserver.generate_from_strs(jp, PROMPTS, 32, jgen.SamplingConfig(**greedy), jax.random.PRNGKey(0))
    assert tserver.generate_from_strs(model, PROMPTS, 32, tgen.SamplingConfig(**greedy)) == jouts
    ids, mask = _prompts()
    sampled = dict(max_new_tokens=N_NEW, temperature=0.8, eos_token_id=EOS, pad_token_id=PAD)
    key = jax.random.PRNGKey(6)
    jtoks, jmask = jserver.generate(jp, jnp.asarray(ids), jnp.asarray(mask), jgen.SamplingConfig(**sampled), key)
    ttoks, tmask = tserver.generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                    tgen.SamplingConfig(**sampled), gumbel=_gumbel(key, N_NEW, (B, tcfg.padded_vocab_size)))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_generation_policy_act_with_done_slots():
    (jserver, jparams), (tserver, tparams) = _servers()
    sampling = dict(max_new_tokens=10, greedy=True, eos_token_id=EOS, pad_token_id=PAD)
    words = ["c r a n e\n", "s l a t e\n", "m o i s t\n"]
    jpol = jvp.GenerationPolicy(
        generate_batch=lambda prompts, key: jserver.generate_from_strs_legal(
            jparams, prompts, [words] * len(prompts), 48, jgen.SamplingConfig(**sampling), key),
        key=jax.random.PRNGKey(0),
    )
    tpol = tvp.GenerationPolicy(
        generate_batch=lambda prompts, gen: tserver.generate_from_strs_legal(
            tparams, prompts, [words] * len(prompts), 48, tgen.SamplingConfig(**sampling), gen),
    )
    histories = [
        (JText("Wordle:\n", False),),
        (JText("Wordle:\n", False), JText("c r a n e\n", True), JText("b b y b g\n", False)),
        (JText("Wordle:\n", False), JText("s l a t e\n", True), JText("g b b b y\n", False)),
    ]
    thistories = [tuple(TText(t.text, t.is_action) for t in h) for h in histories]
    done = [False, True, False]
    jout = jpol.act(histories, done=done)
    tout = tpol.act(thistories, done=done)
    assert tout[1] is None and jout[1] is None
    for j, t in zip(jout, tout):
        if j is not None:
            assert [(x.text, x.is_action) for x in t] == [(x.text, x.is_action) for x in j]
            assert t[-1].is_action and t[-1].text in words
    assert tpol.act(thistories, done=[True] * 3) == [None] * 3
