"""The port's T5 (`lmrl_gym_torch/models/encdec.py`), its converters
(`models/convert.py::encdec_params_{from,to}_jax`), `Seq2SeqServer` and
the seq2seq oracle trainer against the JAX package's, on the CPU in f32
with dropout 0, weights carried across by the converters.

- The relative-position bucket table equals JAX's at every offset in
  [−1024, 1024], both directions (at n = 16, 32, 64 the real value is an
  exact integer: one ulp of `log` would move the bucket).
- The full forward, the cached decode (JAX's `decode_step` and the
  port's against its own full forward), tied/relu and untied/gated-gelu:
  logits within 1e-4 abs + 1e-5 rel (f32; the packages' matmuls sum in
  different orders, ~1e-6 relative measured).
- `Seq2SeqServer` greedy tokens identical, on right-padded prompts.
- The seq2seq BC loss and every gradient at 1e-5 / 1e-4, and the
  parameters after `train_t5_oracle_lm`'s steps at `test_torch_ilql.py`'s
  2e-6 abs + 1e-4 rel, where an element apart must have had, on some
  step, a gradient below 1e-3 of its tensor's largest (the share
  `test_torch_ppo_gate_parity.py` takes across steps): Adam's first
  updates are ±lr whatever the gradient's size, so a second-step gradient
  that small, summed in another order (or across a relu that one package
  puts at 0⁺ and the other at 0⁻), moves an element by a few percent of
  lr. Measured in a serial run: one element of 98,304 apart (6.2e-6, its
  second-step gradient 6.6e-4 of its tensor's largest).
- Attention-probability and residual dropout draw from the generator at
  the configured rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmrl_gym_torch.algos.value_policy import Seq2SeqServer
from lmrl_gym_torch.core.optimizer import value_and_grads
from lmrl_gym_torch.envs import lm_oracle as tlo
from lmrl_gym_torch.models import encdec as te
from lmrl_gym_torch.models.convert import encdec_params_from_jax, encdec_params_to_jax
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.text.tokenizer import ByteTokenizer
from lmrl_gym_tpu.algos.value_policy import Seq2SeqServer as JSeq2SeqServer
from lmrl_gym_tpu.envs import lm_oracle as jlo
from lmrl_gym_tpu.models import encdec as je
from lmrl_gym_tpu.models.generation import SamplingConfig as JSamplingConfig
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
LOSS_TOL, GRAD_TOL = dict(atol=1e-5, rtol=1e-5), dict(atol=1e-4, rtol=1e-4)
PARAM_ATOL, PARAM_RTOL, NOISE = 2e-6, 1e-4, 1e-3
CONFIGS = {
    "tied_relu": dict(),
    "untied_gated_gelu": dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(kind: str, seed: int = 0):
    """(JAX config, JAX params, port config, port model) on one draw."""
    jcfg = je.tiny_encdec_config(**CONFIGS[kind])
    jparams = je.init_encdec_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = te.EncDecConfig.from_dict(jcfg.to_dict())
    model = te.EncoderDecoder(tcfg, device="cpu")
    model.load_state_dict(encdec_params_from_jax(_np(jparams)))
    return jcfg, jparams, tcfg, model


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    enc = rng.integers(1, 259, (3, 20))
    enc[1, 15:] = 0  # right padding (pad_token_id 0)
    enc[2, 6:] = 0
    dec = rng.integers(1, 259, (3, 7))
    dec[:, 0] = 0  # decoder_start_token_id
    return enc, dec


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_table_matches_jax(bidirectional):
    rp = np.arange(-1024, 1025)
    want = np.asarray(je.relative_position_bucket(jnp.asarray(rp, jnp.int32), bidirectional, 32, 128))
    got = te.relative_position_bucket(torch.from_numpy(rp), bidirectional, 32, 128).numpy()
    np.testing.assert_array_equal(got, want)
    # the exact-integer points where one ulp of log decides the bucket
    for n in (16, 32, 64):
        assert got[1024 - n] == want[1024 - n]
    bias_j = np.asarray(je.compute_position_bias(jnp.arange(32 * 4, dtype=jnp.float32).reshape(32, 4),
                                                 jnp.arange(40), jnp.arange(300), bidirectional, 32, 128))
    bias_t = te.compute_position_bias(torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4), torch.arange(40),
                                      torch.arange(300), bidirectional, 32, 128).numpy()
    np.testing.assert_array_equal(bias_t, bias_j)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_converters_round_trip(kind):
    _, jparams, _, model = _pair(kind)
    back = encdec_params_to_jax(model.state_dict())
    want = dict(jax.tree_util.tree_flatten_with_path(_np(jparams))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), back))[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_forward_and_cached_decode_match_jax(kind):
    jcfg, jparams, tcfg, model = _pair(kind)
    enc, dec = _inputs()
    jl, _ = je.EncDecCore(jcfg).forward(jparams, jnp.asarray(enc), jnp.asarray(dec))
    tl, _ = te.EncDecCore(tcfg, device="cpu").forward(model, torch.from_numpy(enc), torch.from_numpy(dec))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)

    # cached decode, token by token, over a 9-slot cache
    T = dec.shape[1]
    jfn, jcarry = je.EncDecCore(jcfg).make_seq2seq_logits_fn(jparams, jnp.asarray(enc), jnp.asarray(enc != 0), T + 2)
    tfn, tcarry = te.EncDecCore(tcfg, device="cpu").make_seq2seq_logits_fn(
        model, torch.from_numpy(enc), torch.from_numpy((enc != 0).astype(np.int32)), T + 2)
    mask = np.zeros((3, T + 2), np.int32)
    for t in range(T):
        mask[:, t] = 1
        jlog, jcarry = jfn(jnp.asarray(dec[:, t:t + 1]), jnp.asarray(mask), jcarry)
        with torch.no_grad():
            tlog, tcarry = tfn(torch.from_numpy(dec[:, t:t + 1]), torch.from_numpy(mask), tcarry)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        # the cached step against the port's own full forward (pad columns masked)
        V = tcfg.vocab_size
        np.testing.assert_allclose(tlog[:, 0, :V].numpy(), tl[:, t, :V].numpy(), **LOGIT_TOL)
    assert tcarry.index == T


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_seq2seq_server_greedy_tokens_match_jax(kind):
    jcfg, jparams, tcfg, model = _pair(kind, seed=1)
    tok = ByteTokenizer()
    prompts = ["Answer the question about the object truthfully.\nobject: (Cat)\nquestion: Is it alive?\n",
               "short", "x" * 40, "Is it a dog?"]
    for n in (6, 12):
        jsc = JSamplingConfig(max_new_tokens=n, greedy=True, eos_token_id=10, pad_token_id=tok.pad_token_id)
        tsc = SamplingConfig(max_new_tokens=n, greedy=True, eos_token_id=10, pad_token_id=tok.pad_token_id)
        want = JSeq2SeqServer(je.EncDecCore(jcfg), tok).generate_from_strs(jparams, prompts, 32, jsc,
                                                                           jax.random.PRNGKey(0))
        got = Seq2SeqServer(te.EncDecCore(tcfg, device="cpu"), tok).generate_from_strs(model, prompts, 32, tsc)
        assert got == want
        # the encoder input is right-padded: a prompt's answer does not
        # depend on the batch it shares
        alone = Seq2SeqServer(te.EncDecCore(tcfg, device="cpu"), tok).generate_from_strs(model, prompts[1:2], 32, tsc)
        assert alone == got[1:2]


def _windows(n: int):
    return jlo.collect_twenty_questions_qa(2, seed=0)[:n], tlo.collect_twenty_questions_qa(2, seed=0)[:n]


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_seq2seq_loss_and_grads_match_jax(kind):
    jcfg, jparams, tcfg, model = _pair(kind)
    tok = ByteTokenizer()
    jwin, twin = _windows(6)
    rows = tlo.t5_oracle_batches(twin, tcfg, tok, 64)
    core = je.EncDecCore(jcfg)

    def loss_fn(p):
        logits, _ = core.forward(p, jnp.asarray(rows["enc"]), jnp.asarray(rows["dec_in"]), train=True,
                                 rng=jax.random.PRNGKey(0))
        lab = jnp.asarray(rows["labels"])
        mask = (lab != 0).astype(jnp.float32)
        xent = optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), lab)
        return (xent * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    tloss = tlo.t5_oracle_loss(te.EncDecCore(tcfg, device="cpu"), model, *(torch.from_numpy(rows[k]) for k in
                                                                          ("enc", "dec_in", "labels")))
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    (grads,) = value_and_grads(tloss, (model,))
    ref = encdec_params_from_jax(_np(jgrads))
    assert set(grads) == set(ref)
    for k in ref:
        np.testing.assert_allclose(grads[k].numpy(), ref[k].numpy(), err_msg=k, **GRAD_TOL)


def test_train_t5_oracle_lm_matches_jax(monkeypatch):
    """`train_t5_oracle_lm` (two steps of 8 windows, lr 3e-4, the JAX
    function's clip + AdamW) from the JAX function's own initial draw; the
    port's gradients of both steps are recorded to mark the noise-level
    elements."""
    tok = ByteTokenizer()
    jwin, twin = _windows(16)
    jcfg_train = jlo.OracleTrainConfig(epochs=1, train_bsize=8, max_length=64, hidden_size=64, num_layers=2,
                                       num_heads=4, seed=3)
    tcfg_train = tlo.OracleTrainConfig(**vars(jcfg_train))
    jcore, _, jfinal, jconfig = jlo.train_t5_oracle_lm(jwin, jcfg_train, tokenizer=tok, log=lambda s: None)
    jinit = je.init_encdec_params(jconfig, jax.random.PRNGKey(3))
    tconfig = te.EncDecConfig.from_dict(jconfig.to_dict())
    init = te.EncoderDecoder(tconfig, device="cpu")
    init.load_state_dict(encdec_params_from_jax(_np(jinit)))

    noise = {}

    def recorded(loss, modules):
        grads = value_and_grads(loss, modules)
        for k, g in grads[0].items():
            g = g.abs()
            noise[k] = noise.get(k, torch.zeros_like(g, dtype=torch.bool)) | (g <= NOISE * g.max())
        return grads

    monkeypatch.setattr(tlo, "value_and_grads", recorded)
    losses = []
    tcore, _, tfinal, tconf = tlo.train_t5_oracle_lm(twin, tcfg_train, tokenizer=tok, log=losses.append,
                                                     device="cpu", params=init)
    assert tconf.to_dict() == jconfig.to_dict() and len(losses) == 1
    ref = encdec_params_from_jax(_np(jfinal))
    n_apart = 0
    for k, t in tfinal.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        bad = apart & ~noise[k].numpy()
        assert not bad.any(), f"{k}: {int(bad.sum())} elements apart where the gradient is not noise"
        n_apart += int(apart.sum())
    print(f"{n_apart} elements apart, all at noise-level gradients")


def test_dropout_rates():
    """Training draws attention-probability, MLP and residual dropout masks
    from the generator at dropout_rate; inference draws none."""
    cfg = te.tiny_encdec_config(dropout_rate=0.25)
    attn = te.T5Attention(cfg, device="cpu")
    x = torch.randn(4, 64, cfg.d_model)
    mask = torch.ones(1, 1, 1, 64, dtype=torch.bool)
    captured = {}
    orig = te.dropout

    def spy(t, rate, generator):
        out = orig(t, rate, generator)
        captured.setdefault("rates", []).append(rate)
        captured.setdefault("zero_share", []).append(float((out == 0).float().mean()))
        return out

    te.dropout = spy
    try:
        gen = torch.Generator().manual_seed(0)
        attn(x, mask, None, generator=gen)
    finally:
        te.dropout = orig
    assert captured["rates"] == [0.25]
    assert abs(captured["zero_share"][0] - 0.25) < 0.01
    model = te.EncoderDecoder(cfg, device="cpu")
    enc, dec = _inputs()
    core = te.EncDecCore(cfg, device="cpu")
    a, _ = core.forward(model, torch.from_numpy(enc), torch.from_numpy(dec))
    b, _ = core.forward(model, torch.from_numpy(enc), torch.from_numpy(dec))
    c, _ = core.forward(model, torch.from_numpy(enc), torch.from_numpy(dec), train=True,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="generator"):
        core.forward(model, torch.from_numpy(enc), torch.from_numpy(dec), train=True)
