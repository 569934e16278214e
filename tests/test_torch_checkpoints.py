"""Checkpoints across the packages: the port's msgpack codec
(`lmrl_gym_torch/core/checkpointing.py`) and checkpoint layout
(`lmrl_gym_torch/loops/checkpoints.py`) against the JAX package's
(`lmrl_gym_tpu/core/checkpointing.py`, `lmrl_gym_tpu/loops/checkpoints.py`).

Tolerance: none. A file either package writes is read by the other with
bit-identical arrays (compared as raw bits), the same tree gives the same
file bytes in both, and the port's train state resumes to the same next
step as the uninterrupted one.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lmrl_gym_torch.core import checkpointing as tckpt
from lmrl_gym_torch.core import io as tio
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.loops import checkpoints as tloops
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.config import tiny_test_config
from lmrl_gym_torch.models.convert import head_params_from_jax, head_params_to_jax, params_from_jax, params_to_jax
from lmrl_gym_tpu.core import checkpointing as jckpt
from lmrl_gym_tpu.loops import checkpoints as jloops

from test_torch_ilql import PAD, _batch, _setup

DTYPES = ["float32", "float64", "float16", "bfloat16", "int8", "int16", "int32", "int64", "uint8", "bool"]
ILQL_MODULES = ("base", "target_base", "q1_head", "q2_head", "v_head", "q1_target_head", "q2_target_head")


def _np_array(dtype: str, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype in ("float32", "float64", "float16", "bfloat16"):
        return (rng.standard_normal(shape) * 3).astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def _bits(x) -> np.ndarray:
    """Raw bits of a numpy array or tensor as unsigned ints, with shape."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return x.astype(np.uint8)
    return x.view(f"u{x.dtype.itemsize}")


def _assert_trees_bit_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_bit_equal(a[k], b[k], f"{path}/{k}")
        return
    ba, bb = _bits(a), _bits(b)
    assert ba.shape == bb.shape and ba.dtype == bb.dtype, (path, ba.shape, bb.shape, ba.dtype, bb.dtype)
    np.testing.assert_array_equal(ba, bb, err_msg=path)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_codec_both_ways_on_every_dtype(dtype, tmp_path):
    tree = {"a": {"x": _np_array(dtype, (3, 5)), "scalar": _np_array(dtype, ())},
            "b": [_np_array(dtype, (7,), 1), _np_array(dtype, (2, 1, 4), 2)], "empty": _np_array(dtype, (0, 3))}
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_pytree(tree, jpath)
    tckpt.save_pytree(jax.tree.map(lambda x: torch.from_numpy(_bits(x).copy()).view(
        torch.bfloat16) if x.dtype == jnp.bfloat16 else torch.from_numpy(np.array(x)), tree), tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()  # the same bytes
    ported = tckpt.load_pytree(jpath)
    back = jckpt.load_pytree(tpath)
    ref = {"a": tree["a"], "b": {"0": tree["b"][0], "1": tree["b"][1]}, "empty": tree["empty"]}
    _assert_trees_bit_equal(ported, ref)
    _assert_trees_bit_equal(back, ref)
    # one payload alone: flax's from_bytes and the port's decoder agree
    payload = serialization.to_bytes(tree["a"]["x"])
    assert b"".join(tckpt.array_to_bytes(ported["a"]["x"])) == payload
    _assert_trees_bit_equal(tckpt.array_from_bytes(payload), tree["a"]["x"])


@pytest.mark.parametrize("save_dtype", [None, "bfloat16"])
def test_transformer_and_heads_cross_both_ways(save_dtype, tmp_path):
    """A JAX trunk and head saved by JAX (`save_dtype` bf16 on save or f32)
    load into the port's modules, and the port's files of those modules
    load into JAX trees by `load_module_params(..., target=...)`, bits
    equal, and the two packages' files are the same bytes."""
    (jcfg, _, jq, _, jstate), (tcfg, _, tstate) = _setup()
    jparams = {"base": jstate.base.params, "q1_head": jstate.q1_head.params}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jloops.dump_modules(jdir, jparams, {"base": {"kind": "trunk"}},
                        save_dtype=None if save_dtype is None else jnp.bfloat16)
    tloops.dump_modules(tdir, {"base": tstate.base.params, "q1_head": tstate.q1_head.params},
                        {"base": {"kind": "trunk"}}, save_dtype=None if save_dtype is None else torch.bfloat16)
    for name in ("base", "q1_head"):
        with open(os.path.join(jdir, name, "params.msgpack"), "rb") as f, \
                open(os.path.join(tdir, name, "params.msgpack"), "rb") as g:
            assert f.read() == g.read(), name
        j_from_port = jloops.load_module_params(tdir, name, target=jparams[name])
        want = jax.tree.map(lambda x: np.asarray(x).astype(jnp.bfloat16) if save_dtype else np.asarray(x),
                            jparams[name])
        _assert_trees_bit_equal(_np_tree(j_from_port), _np_tree(want))
        _assert_trees_bit_equal(tloops.load_module_params(jdir, name), _np_tree(want))
    assert tloops.load_module_config(jdir, "base") == jloops.load_module_config(tdir, "base") == {"kind": "trunk"}
    # into fresh port modules: the JAX weights (rounded to bf16 when saved so)
    fresh = (type(tstate.base.params)(tcfg, device="cpu", seed=7), type(tstate.q1_head.params)(
        tstate.q1_head.params.config, device="cpu", seed=7))
    for name, module in zip(("base", "q1_head"), fresh):
        tloops.restore_module(jdir, name, module)
        want = tloops.module_tree(tstate.base.params if name == "base" else tstate.q1_head.params)
        got = tloops.module_tree(module)
        if save_dtype:
            want = jax.tree.map(lambda t: t.to(torch.bfloat16).float(), want)
        _assert_trees_bit_equal(got, want)


def test_params_to_jax_inverts_params_from_jax():
    (jcfg, _, _, _, jstate), (tcfg, _, tstate) = _setup()
    _assert_trees_bit_equal(params_to_jax(tstate.base.params.state_dict(), tcfg), _np_tree(jstate.base.params))
    _assert_trees_bit_equal(head_params_to_jax(tstate.v_head.params.state_dict()), _np_tree(jstate.v_head.params))
    sd = params_from_jax(params_to_jax(tstate.base.params.state_dict(), tcfg), tcfg)
    for k, v in tstate.base.params.state_dict().items():
        assert torch.equal(sd[k], v), k
    hd = head_params_from_jax(head_params_to_jax(tstate.q1_head.params.state_dict()))
    assert all(torch.equal(hd[k], v) for k, v in tstate.q1_head.params.state_dict().items())


def _ilql_modules(state):
    return {"base": state.base, "target_base": state.target_base_params, "q1_head": state.q1_head,
            "q2_head": state.q2_head, "v_head": state.v_head, "q1_target_head": state.q1_target_params,
            "q2_target_head": state.q2_target_params}


@pytest.mark.parametrize("save_train_state", [False, True])
def test_ilql_layout_both_ways(save_train_state, tmp_path):
    """The ILQL checkpoint layout (seven module dirs and loop_state.pkl)
    written by each package through `CheckpointManager` and read by the
    other: params bit-identical; from a JAX train_state.msgpack the port
    reads only the params subtree (optax's state is not the port's)."""
    (_, _, _, _, jstate), (_, _, tstate) = _setup()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jls, tls = jloops.LoopState(step=4, epoch=1), tloops.LoopState(step=4, epoch=1)
    jpath = jloops.CheckpointManager(jdir).save("step_4", jls, _ilql_modules(jstate),
                                                save_train_state=save_train_state)
    tpath = tloops.CheckpointManager(tdir).save("step_4", tls, _ilql_modules(tstate),
                                                save_train_state=save_train_state)
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath)) == sorted(ILQL_MODULES + ("loop_state.pkl",))
    for name in ILQL_MODULES:
        assert os.listdir(os.path.join(jpath, name)) == os.listdir(os.path.join(tpath, name))
        ref = _np_tree(jloops.load_module_params(jpath, name))
        _assert_trees_bit_equal(_np_tree(jloops.load_module_params(tpath, name)), ref)  # JAX reads the port's
        _assert_trees_bit_equal(tloops.load_module_params(jpath, name), ref)  # the port reads JAX's
    # loop_state.pkl both ways
    # (each written before its own path joins the queue)
    assert list(jls.saved_checkpoints) == [jpath] and list(tls.saved_checkpoints) == [tpath]
    for loops, path in ((jloops, tpath), (tloops, jpath)):
        got = loops.LoopState.load(os.path.join(path, "loop_state.pkl"))
        assert (got.step, got.epoch, got.round, got.best_perf, list(got.saved_checkpoints), got.wandb_id) == (
            4, 1, 0, float("-inf"), [], None)
    # a port state restored from the JAX files holds the JAX parameters
    (_, _, _, _, _), (_, _, fresh) = _setup()
    for p in fresh.base.params.parameters():
        torch.nn.init.zeros_(p)
    for name, module in _ilql_modules(fresh).items():
        tloops.restore_module(jpath, name, module.params if isinstance(module, topt.TrainState) else module)
    for name in ILQL_MODULES:
        a, b = (_ilql_modules(s)[name] for s in (fresh, tstate))
        a, b = (m.params if isinstance(m, topt.TrainState) else m for m in (a, b))
        _assert_trees_bit_equal(tloops.module_tree(a), tloops.module_tree(b))


def test_port_train_state_resumes_to_the_same_step(tmp_path):
    """A port ILQL state saved with its optimizer state after two steps and
    restored into a fresh state takes the third step to the same
    parameters, bit for bit, as the uninterrupted run."""
    from lmrl_gym_torch.algos import ilql as tilql
    from lmrl_gym_torch.core.logs import pull_logs

    (_, _, _, _, _), (_, tconf, state) = _setup()
    (_, _, _, _, _), (_, _, other) = _setup()
    step = tilql.make_ilql_train_step(LMCore(tiny_test_config(), device="cpu"), tconf, PAD)
    _, batch = _batch()
    for _ in range(2):
        step(state, batch)
    tloops.dump_modules(str(tmp_path), _ilql_modules(state), save_train_state=True)
    for name, module in _ilql_modules(other).items():
        tloops.restore_module(str(tmp_path), name, module)
    for a, b in ((state.base, other.base), (state.q1_head, other.q1_head), (state.v_head, other.v_head)):
        assert a.step == b.step == 2
        flat_a, flat_b = tckpt.flatten_with_paths(a.opt_state), tckpt.flatten_with_paths(b.opt_state)
        assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
        for (k, x), (_, y) in zip(flat_a, flat_b):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), k
    _, loss_a, logs_a = step(state, batch)
    _, loss_b, logs_b = step(other, batch)
    assert loss_a.item() == loss_b.item() and pull_logs(logs_a) == pull_logs(logs_b)
    for name in ILQL_MODULES:
        a, b = _ilql_modules(state)[name], _ilql_modules(other)[name]
        a, b = (m.params if isinstance(m, topt.TrainState) else m for m in (a, b))
        _assert_trees_bit_equal(tloops.module_tree(a), tloops.module_tree(b))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rolling_queue_and_best(pkg, tmp_path):
    loops = jloops if pkg == "jax" else tloops
    manager = loops.CheckpointManager(str(tmp_path), max_checkpoints=2)
    ls = loops.LoopState()
    for i in range(4):
        manager.save(f"step_{i}", ls, {"m": {"w": np.ones(3, np.float32) * i}})
    manager.save("best", ls, {"m": {"w": np.zeros(3, np.float32)}}, rolling=False)
    assert sorted(os.listdir(tmp_path)) == ["best", "step_2", "step_3"]
    assert [os.path.basename(p) for p in ls.saved_checkpoints] == ["step_2", "step_3"]
    got = tloops.load_module_params(str(tmp_path / "step_3"), "m")
    assert got["w"].tolist() == [3.0, 3.0, 3.0]
    with open(tmp_path / "step_3" / "loop_state.pkl", "rb") as f:
        assert isinstance(pickle.load(f), dict)  # a plain dict, readable without either package


def test_chunked_array_raises_and_bucket_paths(tmp_path, monkeypatch):
    """flax chunks arrays over MAX_CHUNK_SIZE bytes into a map; the port
    refuses such a leaf rather than misreading it. A gcs:// path without
    gcsfs raises ImportError."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / "chunked.msgpack")
    jckpt.save_pytree({"w": np.ones(100, np.float32)}, path)
    with pytest.raises(ValueError, match="chunked"):
        tckpt.load_pytree(path)
    assert tio.is_bucket_path("gcs://b/x") and tio.is_bucket_path("gs://b/x") and not tio.is_bucket_path("/b/x")
    monkeypatch.setitem(__import__("sys").modules, "gcsfs", None)
    with pytest.raises(ImportError, match="gcsfs"):
        tio.open_with_bucket("gcs://bucket/x", "rb")
    # local paths: create, exist, delete
    d = tio.makedirs_with_bucket(str(tmp_path / "a" / "b"))
    with tio.open_with_bucket(os.path.join(d, "c", "f.txt"), "w") as f:
        f.write("x")
    assert tio.exists_with_bucket(os.path.join(d, "c", "f.txt"))
    tio.delete_with_bucket(str(tmp_path / "a"), recursive=True)
    assert not tio.exists_with_bucket(str(tmp_path / "a"))
