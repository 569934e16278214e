"""The port's decoding and value-guided serving against the JAX package.

Greedy decoding must give identical tokens, and the per-step logits must
agree to 1e-4 (f32, 2 layers; see tests/test_torch_model.py). Sampled
decoding replays the JAX sampler's own Gumbel draws
(`jax.random.categorical` is argmax(logits + gumbel(key))), so sampled
tokens must be identical too.
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
from lmrl_gym_tpu.text.tokenizer import ByteTokenizer as JTok
from lmrl_gym_torch.algos import value_policy as tvp
from lmrl_gym_torch.models import generation as tgen
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.text.tokenizer import ByteTokenizer as TTok

TOL = dict(atol=1e-4, rtol=1e-4)
B, T_PROMPT, N_NEW = 3, 9, 6


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


def _prompts(vocab):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 256, size=(B, T_PROMPT)).astype(np.int32)
    mask = (np.arange(T_PROMPT)[None, :] >= np.asarray([0, 2, 5])[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 256)  # left pad with the pad id
    return ids, mask


def _gumbel(key, steps, shape):
    return np.stack([np.asarray(jax.random.gumbel(k, shape, jnp.float32)) for k in jax.random.split(key, steps)])


@pytest.mark.parametrize(
    "cfg",
    [
        tgen.SamplingConfig(greedy=True),
        tgen.SamplingConfig(temperature=0.7),
        tgen.SamplingConfig(top_k=5),
        tgen.SamplingConfig(top_p=0.9, temperature=1.3),
    ],
)
def test_sample_token_same_draws(cfg):
    logits = (3 * np.random.default_rng(0).standard_normal((8, 320))).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jcfg = jgen.SamplingConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    ref = np.asarray(jgen.sample_token(jnp.asarray(logits), key, jcfg))
    g = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape, jnp.float32)))
    out = tgen.sample_token(torch.from_numpy(logits), cfg, gumbel=g)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_greedy_generate_and_step_logits_match():
    jcfg, tcfg, jp, model = _trunk(0)
    ids, mask = _prompts(jcfg.vocab_size)
    cfg = dict(max_new_tokens=N_NEW, greedy=True, pad_token_id=256)
    jtoks, jmask = jgen.generate(
        *JCore(jcfg).make_lm_logits_fn(jp, T_PROMPT + N_NEW, B), jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(0), jgen.SamplingConfig(**cfg),
    )
    tcore = TCore(tcfg, device="cpu")
    ttoks, tmask = tgen.generate(
        *tcore.make_lm_logits_fn(model, T_PROMPT + N_NEW, B), torch.from_numpy(ids).long(),
        torch.from_numpy(mask), tgen.SamplingConfig(**cfg),
    )
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))

    # per-step logits of make_lm_logits_fn along the decoded stream
    jfn, jcarry = JCore(jcfg).make_lm_logits_fn(jp, T_PROMPT + N_NEW, B)
    tfn, tcarry = tcore.make_lm_logits_fn(model, T_PROMPT + N_NEW, B)
    full = np.zeros((B, T_PROMPT + N_NEW), np.int32)
    full[:, :T_PROMPT] = mask
    steps = [ids] + [np.array(jtoks)[:, t:t + 1] for t in range(N_NEW)]
    with torch.no_grad():
        for t, toks in enumerate(steps):
            if t > 0:
                full[:, T_PROMPT + t - 1] = 1
            jl, jcarry = jfn(jnp.asarray(toks), jnp.asarray(full), jcarry)
            tl, tcarry = tfn(torch.from_numpy(toks).long(), torch.from_numpy(full), tcarry)
            np.testing.assert_allclose(tl.numpy()[:, -1], np.asarray(jl)[:, -1], **TOL)


@pytest.mark.parametrize(
    "share_trunk,with_pi,greedy",
    [(False, True, True), (False, False, True), (True, True, True), (True, False, True), (False, True, False)],
)
def test_value_guided_server_matches(share_trunk, with_pi, greedy):
    jcfg, tcfg, jbase, tbase = _trunk(1)
    _, _, jpi, tpi = _trunk(2)
    jhead, jq1, tq1 = _q_head(tcfg, 3)
    _, jq2, tq2 = _q_head(tcfg, 4)
    ids, mask = _prompts(jcfg.vocab_size)
    beta = 8.0
    jserver = jvp.ValueGuidedServer(JCore(jcfg), jhead, None, JTok(), beta=beta, share_trunk=share_trunk)
    tserver = tvp.ValueGuidedServer(TCore(tcfg, device="cpu"), TTok(), beta=beta, share_trunk=share_trunk)
    jparams = jvp.ValueRLParams(jpi if with_pi else None, jbase, jq1, jq2, None)
    tparams = tvp.ValueRLParams(tpi if with_pi else None, tbase, tq1, tq2, None)

    # eos: a token the greedy decode emits mid-stream, so the post-eos masking runs
    probe, _ = tserver.generate(tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                tgen.SamplingConfig(max_new_tokens=N_NEW, greedy=True, pad_token_id=256))
    cfg = dict(max_new_tokens=N_NEW, greedy=greedy, pad_token_id=256, eos_token_id=int(probe[0, 2]))
    key = jax.random.PRNGKey(5)
    jtoks, jmask = jserver.generate(jparams, jnp.asarray(ids), jnp.asarray(mask), jgen.SamplingConfig(**cfg), key)
    gumbel = None if greedy else torch.from_numpy(_gumbel(key, N_NEW, (B, tcfg.padded_vocab_size)))
    ttoks, tmask = tserver.generate(
        tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask), tgen.SamplingConfig(**cfg), gumbel=gumbel
    )
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    if greedy:
        assert (tmask.numpy() == 0).any()  # the eos path ran


def test_generate_from_strs_left_pads():
    _, tcfg, _, tbase = _trunk(1)
    _, _, tq1 = _q_head(tcfg, 3)
    server = tvp.ValueGuidedServer(TCore(tcfg, device="cpu"), TTok(), beta=4.0, share_trunk=True)
    params = tvp.ValueRLParams(None, tbase, tq1, None, None)
    prompts = ["Wordle:\n", "Wordle:\nc r a n e\nb b y b g\n"]
    outs = server.generate_from_strs(params, prompts, 32, tgen.SamplingConfig(max_new_tokens=5, greedy=True, pad_token_id=256))
    assert len(outs) == 2 and all(isinstance(o, str) for o in outs)
    # row-wise: a prompt decodes the same alone as in a left-padded batch
    alone = server.generate_from_strs(params, prompts[:1], 32, tgen.SamplingConfig(max_new_tokens=5, greedy=True, pad_token_id=256))
    assert alone[0] == outs[0]
