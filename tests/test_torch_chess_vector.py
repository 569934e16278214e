"""The port's vectorized chess endgames (`envs/chess/vector.py`) against the
JAX package's, on the JAX draws (each key turned into the `randint`
squares or the Gumbel noise it gives). Tables, states, legal-move masks,
rewards and tokens must be identical (tolerance 0), in both observation
modes, and every FEN the port renders must pass the port's engine
binding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.envs.chess import vector as jvec
from lmrl_gym_torch.envs.chess import engine as tengine
from lmrl_gym_torch.envs.chess import vector as tvec
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

B = 64


def _np(x):
    return torch.from_numpy(np.array(x))


def _assert_state_equal(t, j, msg=""):
    for name in tvec.ChessVecState._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=f"{msg} {name}")


def _to_jax(state):
    return jvec.ChessVecState(**{k: jnp.asarray(v.numpy()) for k, v in state._asdict().items()})


def test_tables_match():
    t = tvec.build_tables()
    for name, ref in (("adj", jvec.ADJ), ("r_aligned", jvec.R_ALIGNED), ("q_aligned", jvec.Q_ALIGNED),
                      ("between", jvec.BETWEEN), ("king_tgt", jvec.KING_TGT)):
        np.testing.assert_array_equal(t[name], np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("piece", ["Q", "R"])
@pytest.mark.parametrize("obs_mode", ["fen", "grid"])
def test_random_playouts_match(piece, obs_mode):
    """Reset on replayed squares, then 12 plies of random legal moves (and
    malformed or illegal frames in a fifth of the rows) with replayed black
    replies: every state, reward, legal mask and observation identical."""
    jenv = jvec.ChessEndgameVectorEnv(piece=piece, max_steps=10, obs_mode=obs_mode)
    tenv = tvec.ChessEndgameVectorEnv(piece=piece, max_steps=10, obs_mode=obs_mode, device="cpu")
    assert tenv.OBS_LEN == jenv.OBS_LEN
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(17)
    key, rk = jax.random.split(key)
    js = jenv.reset(rk, B)
    ts = tenv.reset(B, squares=_np(jax.random.randint(rk, (3, 8, B), 0, 64)))
    _assert_state_equal(ts, js, "reset")
    saw_capture = saw_mate = False
    for ply in range(12):
        jk, jp = jenv.agent_legal_moves(js)
        tk, tp = tenv.agent_legal_moves(ts)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tenv.black_in_check(ts).numpy(), np.asarray(jenv.black_in_check(js)))
        np.testing.assert_array_equal(tenv.obs_tokens(ts).numpy(), np.asarray(jenv.obs_tokens(js)))
        key, ak, sk = jax.random.split(key, 3)
        jact = jenv.random_legal_action(js, ak)
        tact = tenv.random_legal_action(ts, gumbel=_np(jax.random.gumbel(ak, (B, 128), jnp.float32)))
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
        act = np.array(jact)
        bad = rng.random(B) < 0.2
        act[bad] = np.frombuffer(b"K a 9\n  ", np.uint8) if ply % 2 else rng.integers(0, 128, size=(int(bad.sum()), 8))
        js = jenv.step(js, jnp.asarray(act), sk)
        ts = tenv.step(ts, torch.from_numpy(act).long(), noise=_np(jax.random.gumbel(sk, (B, 8), jnp.float32)))
        _assert_state_equal(ts, js, f"ply {ply}")
        saw_capture |= bool((np.asarray(js.pc) < 0).any())
        saw_mate |= bool((np.asarray(js.reward) == 1.0).any())
    assert bool(np.asarray(js.done).all())
    assert saw_capture  # the clamped lookups at pc = -1 were exercised
    if obs_mode == "fen":
        for fen in tenv.fen_strings(ts):
            assert tengine.validate_fen(fen), fen
        assert tenv.fen_strings(ts) == jenv.fen_strings(js)


def test_fen_rendering_of_long_games_and_captured_pieces():
    """Half-move and full-move numbers of one to four digits (clamped to
    999), positions with the piece captured, and the reset fallback."""
    jenv = jvec.ChessEndgameVectorEnv()
    tenv = tvec.ChessEndgameVectorEnv(device="cpu")
    rng = np.random.default_rng(0)
    n = 48
    wk = rng.integers(0, 64, n)
    bk = (wk + rng.integers(2, 60, n)) % 64
    pc = np.where(rng.random(n) < 0.3, -1, (bk + rng.integers(1, 60, n)) % 64)
    pc = np.where(pc == wk, -1, pc)
    z = np.zeros(n, np.int32)
    state = tvec.ChessVecState(
        wk=torch.from_numpy(wk), pc=torch.from_numpy(pc), bk=torch.from_numpy(bk),
        halfmove=torch.from_numpy(rng.choice([0, 7, 10, 99, 100, 149, 1234], n).astype(np.int32)),
        fullmove=torch.from_numpy(rng.choice([1, 9, 42, 100, 999, 1000], n).astype(np.int32)),
        n_steps=torch.from_numpy(z), done=torch.zeros(n, dtype=torch.bool),
        reward=torch.zeros(n), illegal=torch.zeros(n, dtype=torch.bool),
    )
    js = _to_jax(state)
    np.testing.assert_array_equal(tenv.obs_tokens(state).numpy(), np.asarray(jenv.obs_tokens(js)))
    assert tenv.fen_strings(state) == jenv.fen_strings(js)
    genv_j = jvec.ChessEndgameVectorEnv(obs_mode="grid")
    genv_t = tvec.ChessEndgameVectorEnv(obs_mode="grid", device="cpu")
    np.testing.assert_array_equal(genv_t.obs_tokens(state).numpy(), np.asarray(genv_j.obs_tokens(js)))
    # every attempt invalid (all three pieces on one square): the fallback position
    same = torch.zeros((3, 8, 4), dtype=torch.int64)
    _assert_state_equal(tenv.reset(4, squares=same), jenv.reset(jax.random.PRNGKey(0), 4).replace(
        wk=jnp.zeros(4, jnp.int32), pc=jnp.full(4, 8, jnp.int32), bk=jnp.full(4, 63, jnp.int32)))


def _frames(strings):
    out = np.full((len(strings), tvec.ACT_LEN), 32, np.int64)
    for i, s in enumerate(strings):
        b = s.encode()[: tvec.ACT_LEN]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def test_parse_san_frames_match():
    """The malformed frames of the JAX package's own test, suffixes, and
    frames with no '\\n' at all (an argmax over an all-false row)."""
    good = ["Q f 7\n", "K e 4\n", "Q f 7 #\n", "K e 4 +\n", "R a 1\n"]
    bad = ["Q x f 7\n", "e 4\n", "Q f\n", "Qf7  \n", "Q f 9\n", "B f 7\n", "Q f 7 !\n",
           "Q f 7 + +", "QQQQQQQQ", "\n", "K  e 4\n"]
    frames = _frames(good + bad)
    for piece in ("Q", "R"):
        jp, jd, jok = jvec._parse_san_frame(jnp.asarray(frames), ord(piece))
        tp, td, tok = tvec._parse_san_frame(torch.from_numpy(frames), ord(piece))
        for a, b in ((tp, jp), (td, jd), (tok, jok)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, _, ok = tvec._parse_san_frame(torch.from_numpy(frames), ord("Q"))
    assert ok[:4].all() and not ok[4:].any()
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 128, size=(256, tvec.ACT_LEN))
    noise[:, 1::2] = np.where(rng.random((256, 4)) < 0.8, 32, noise[:, 1::2])
    noise[np.arange(256), rng.integers(1, 8, 256)] = 10
    jp, jd, jok = jvec._parse_san_frame(jnp.asarray(noise), ord("Q"))
    tp, td, tok = tvec._parse_san_frame(torch.from_numpy(noise), ord("Q"))
    for a, b in ((tp, jp), (td, jd), (tok, jok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_render_san_and_generator_draws():
    jenv, tenv = jvec.ChessEndgameVectorEnv(), tvec.ChessEndgameVectorEnv(device="cpu")
    is_king = np.asarray([True, False, True, False])
    dst = np.asarray([28, 61, 0, 63])
    np.testing.assert_array_equal(tenv.render_san(torch.from_numpy(is_king), torch.from_numpy(dst)).numpy(),
                                  np.asarray(jenv.render_san(jnp.asarray(is_king), jnp.asarray(dst))))
    # without draws: valid positions and legal moves from the generator
    gen = torch.Generator().manual_seed(0)
    s = tenv.reset(128, gen)
    assert all(tengine.validate_fen(f) for f in tenv.fen_strings(s))
    s2 = tenv.step(s, tenv.random_legal_action(s, gen), gen)
    assert not s2.illegal.any() and set(s2.reward.tolist()) <= {0.0, 1.0}
