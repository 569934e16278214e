"""The port's word-level serving (`make_ilql_score_fn`, `make_mc_score_fn`,
`make_logprob_score_fn`, `ReRankerPolicy`, `tokenize_histories_for_scoring`)
against the JAX package's, on the same weights (`models/convert.py`) and the
maze's four move proposals. Scores within 1e-5 abs/rel (f32 forwards and
sums over at most ~12 action tokens); token arrays and the reranker's
choices identical."""
import jax
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import value_policy as jvp
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtr
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.text.frames import Text as JText
from lmrl_gym_torch.algos import value_policy as tvp
from lmrl_gym_torch.envs.maze.env import describe_observation_give_position
from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, double_t_maze
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.text.frames import Text as TText
from lmrl_gym_torch.text.tokenizer import ByteTokenizer

TOK = ByteTokenizer()
MAX_LEN = 160
TOL = dict(atol=1e-5, rtol=1e-5)
np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jtiny(max_position_embeddings=256), ttiny(max_position_embeddings=256)

    def trunk(seed):
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
        t = ttr.Transformer(tcfg, device="cpu")
        t.load_state_dict(params_from_jax(np_tree(jp), tcfg))
        return jp, t

    def head(out, seed):
        kw = dict(input_dim=jcfg.hidden_size, hidden_dim=2 * jcfg.hidden_size, output_dim=out,
                  layer2_bias_init=-1.0)
        jh = jheads.MLPHead(jheads.MLPHeadConfig(**kw))
        jp = jheads.init_head_params(jh, jcfg.hidden_size, jax.random.PRNGKey(seed))
        th = theads.MLPHead(theads.MLPHeadConfig(**kw), device="cpu")
        th.load_state_dict(head_params_from_jax(np_tree(jp)))
        return jh, jp, th

    return dict(jcfg=jcfg, tcfg=tcfg, base=trunk(0), pi=trunk(1), q1=head(jcfg.padded_vocab_size, 2),
                q2=head(jcfg.padded_vocab_size, 3), v=head(1, 4))


def _histories(Text, n_cells=5):
    maze = double_t_maze()
    cells = [tuple(c) for c in np.argwhere(maze == 0)[:n_cells]]
    out = []
    for cell in cells:
        h = (Text(describe_observation_give_position(maze, cell, (8, 6)), False),)
        out.extend(h + (Text(a, True),) for a in ACTION_STRS)
    return out


def test_tokenize_histories_matches():
    ji, ja = jvp.tokenize_histories_for_scoring(_histories(JText), TOK, MAX_LEN)
    ti, ta = tvp.tokenize_histories_for_scoring(_histories(TText), TOK, MAX_LEN, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # truncated from the left: the action tokens survive a short window
    ji, ja = jvp.tokenize_histories_for_scoring(_histories(JText), TOK, 40)
    ti, ta = tvp.tokenize_histories_for_scoring(_histories(TText), TOK, 40, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def _bundles(m, twin=True, with_v=True, with_pi=False):
    jb = jvp.ValueRLParams(pi_beta=m["pi"][0] if with_pi else None, base=m["base"][0], q1_head=m["q1"][1],
                           q2_head=m["q2"][1] if twin else None, v_head=m["v"][1] if with_v else None)
    tb = tvp.ValueRLParams(pi_beta=m["pi"][1] if with_pi else None, base=m["base"][1], q1_head=m["q1"][2],
                           q2_head=m["q2"][2] if twin else None, v_head=m["v"][2] if with_v else None)
    return jb, tb


def _inputs():
    ji, ja = jvp.tokenize_histories_for_scoring(_histories(JText), TOK, MAX_LEN)
    return (ji, ja), (torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(ja)))


@pytest.mark.parametrize("twin,logit_weight,length_normalize,value_weight",
                         [(True, None, False, 1.0), (False, None, True, 1.0), (True, 0.5, False, 2.0),
                          (True, 0.5, True, 1.0)])
def test_ilql_score_fn_matches(models, twin, logit_weight, length_normalize, value_weight):
    jb, tb = _bundles(models, twin=twin, with_pi=logit_weight is not None)
    kw = dict(value_weight=value_weight, logit_weight=logit_weight, length_normalize=length_normalize)
    jscore = jvp.make_ilql_score_fn(JCore(models["jcfg"]), models["q1"][0], models["v"][0], jb, TOK.pad_token_id, **kw)
    tscore = tvp.make_ilql_score_fn(TCore(models["tcfg"], device="cpu"), tb, TOK.pad_token_id, **kw)
    (ji, ja), (ti, ta) = _inputs()
    np.testing.assert_allclose(tscore(ti, ta).numpy(), np.asarray(jscore(ji, ja)), **TOL)


@pytest.mark.parametrize("twin,length_normalize", [(False, True), (True, True), (True, False)])
def test_mc_score_fn_matches(models, twin, length_normalize):
    jb, tb = _bundles(models, twin=twin, with_v=False)
    jscore = jvp.make_mc_score_fn(JCore(models["jcfg"]), models["q1"][0], jb, TOK.pad_token_id,
                                  length_normalize=length_normalize)
    tscore = tvp.make_mc_score_fn(TCore(models["tcfg"], device="cpu"), tb, TOK.pad_token_id,
                                  length_normalize=length_normalize)
    (ji, ja), (ti, ta) = _inputs()
    np.testing.assert_allclose(tscore(ti, ta).numpy(), np.asarray(jscore(ji, ja)), **TOL)


def test_logprob_score_fn_matches(models):
    jscore = jvp.make_logprob_score_fn(JCore(models["jcfg"]), models["pi"][0], TOK.pad_token_id)
    tscore = tvp.make_logprob_score_fn(TCore(models["tcfg"], device="cpu"), models["pi"][1], TOK.pad_token_id)
    (ji, ja), (ti, ta) = _inputs()
    np.testing.assert_allclose(tscore(ti, ta).numpy(), np.asarray(jscore(ji, ja)), **TOL)


@pytest.mark.parametrize("sample", [False, True])
def test_reranker_policy_matches(models, sample):
    jb, tb = _bundles(models)
    jscore = jvp.make_ilql_score_fn(JCore(models["jcfg"]), models["q1"][0], models["v"][0], jb, TOK.pad_token_id)
    tscore = tvp.make_ilql_score_fn(TCore(models["tcfg"], device="cpu"), tb, TOK.pad_token_id)

    def policy(vp, Text, score, device_kw):
        def score_batch(hs):
            ids, am = vp.tokenize_histories_for_scoring(hs, TOK, MAX_LEN, **device_kw)
            out = score(ids, am)
            return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)

        return vp.ReRankerPolicy(proposal_fn=lambda h: [h + (Text(a, True),) for a in ACTION_STRS],
                                 score_batch=score_batch, sample=sample, temperature=0.05,
                                 rng=np.random.default_rng(0))

    jp = policy(jvp, JText, jscore, {})
    tp = policy(tvp, TText, tscore, dict(device="cpu"))
    done = [False, True, False, False, False]
    jh = [h[:1] for h in _histories(JText)[::4]]
    th = [h[:1] for h in _histories(TText)[::4]]
    jout, tout = jp.act(jh, done), tp.act(th, done)
    assert [None if o is None else o[-1].text for o in tout] == [None if o is None else o[-1].text for o in jout]
    assert tout[1] is None and all(o[-1].text in ACTION_STRS for i, o in enumerate(tout) if i != 1)
    assert tp.act(th, [True] * len(th)) == [None] * len(th)
