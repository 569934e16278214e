"""Multi-rank dry runs of the port's sharded train steps: the analogue of
`__graft_entry__.py::dryrun_multichip`, and the per-algorithm runs the CPU
tests hold against the unsharded steps.

`dryrun_multichip(n, device)` spawns n ranks (`parallel/launch.py`) and
builds the JAX dry run's mesh over them: mp = 2 when n is even, dp = 2
when the rest is even, fsdp the remainder. On the JAX dry run's tiny
config and heads, it shards every module by its rule table and runs one
ILQL step on the JAX dry run's batch.

`run_algo(algo, mesh_shape, device)` builds one algorithm's state, step
and batch from fixed seeds (ILQL, BC, MC, CQL or PPO at the tiny config),
shards the state over the mesh when `mesh_shape` is given, runs two steps
and returns the losses and every module's whole parameters: run on the
ranks of a group (`run_ranks(run_algo, n, ...)`) and alone, the two must
agree. The rank functions live here, not in a test file, because a
`spawn` child imports them by module name.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
from lmrl_gym_torch.algos.cql import CQLConfig, init_cql_state, make_cql_train_step
from lmrl_gym_torch.algos.ilql import ILQLBatch, ILQLConfig, init_ilql_state, make_ilql_train_step
from lmrl_gym_torch.algos.mc import MCBatch, MCConfig, MCTrainState, make_mc_train_step
from lmrl_gym_torch.algos.ppo import PPOBatch, PPOConfig, PPOTrainState, make_ppo_train_step
from lmrl_gym_torch.core.io import is_main_process
from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, adam, make_optimizer
from lmrl_gym_torch.models.config import TransformerConfig, tiny_test_config
from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig, MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.parallel.launch import run_ranks
from lmrl_gym_torch.parallel.mesh import all_modules, full_state_dict, full_tensor, is_sharded, load_mesh, \
    load_state, shard_train_state

ALGOS = ("ilql", "bc", "mc", "cql", "ppo")
PAD = 256


def dryrun_config() -> TransformerConfig:
    """The JAX dry run's config."""
    return tiny_test_config(num_heads=4, hidden_size=64)


def dryrun_mesh_shape(n: int) -> Tuple[int, int, int]:
    """(dp, fsdp, mp) of the JAX dry run over n devices."""
    mp = 2 if n % 2 == 0 else 1
    rest = n // mp
    dp = 2 if rest % 2 == 0 else 1
    return dp, rest // dp, mp


def q_head_config(config: TransformerConfig, output_dim: Optional[int] = None, **kw) -> MLPHeadConfig:
    return MLPHeadConfig(input_dim=config.hidden_size, hidden_dim=2 * config.hidden_size,
                         output_dim=config.padded_vocab_size if output_dim is None else output_dim, **kw)


def dryrun_batch(config: TransformerConfig, b: int, t: int = 16, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX dry run's ILQL batch, drawn in its order from numpy."""
    rng = np.random.default_rng(seed)
    sta = np.zeros((b, t - 1), bool)
    sta[:, 1::2] = True
    return dict(
        input_ids=rng.integers(1, config.vocab_size, (b, t)).astype(np.int64),
        should_take_action=sta,
        rewards=(-1.0 * sta).astype(np.float32),
        dones=np.zeros((b,), bool),
        next_token_ids=rng.integers(1, config.vocab_size, (b, 8)).astype(np.int64),
        next_dones=np.ones((b,), bool),
    )


def _batch(algo: str, config: TransformerConfig, device, b: int = 8, t: int = 16):
    arrays = dryrun_batch(config, b, t)
    ids = torch.as_tensor(arrays["input_ids"], device=device)
    ids[:2, :3] = PAD  # left padding on two rows
    sta = torch.as_tensor(arrays["should_take_action"], device=device)
    rng = np.random.default_rng(1)

    def f32(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device)

    if algo in ("ilql", "cql"):
        return ILQLBatch(ids, sta, torch.as_tensor(arrays["rewards"], device=device),
                         torch.as_tensor(arrays["dones"], device=device),
                         torch.as_tensor(arrays["next_token_ids"], device=device),
                         torch.as_tensor(arrays["next_dones"], device=device))
    if algo == "bc":
        mask = torch.zeros_like(ids, dtype=torch.bool)
        mask[:, t // 2:] = True
        return BCBatch(ids, mask)
    if algo == "mc":
        return MCBatch(ids, sta, f32((b, t - 1)))
    if algo == "ppo":
        return PPOBatch(ids, sta, -f32((b, t - 1)).abs(), f32((b, t - 1)), f32((b, t - 1)), f32((b, t - 1)),
                        ids.flip(0), torch.ones_like(ids, dtype=torch.bool))
    raise ValueError(algo)


def build_algo(algo: str, config: TransformerConfig, device) -> Tuple[Any, Any]:
    """(unsharded state, step factory(core, mesh)) for an algorithm, from
    fixed seeds; the heads' second layers are drawn nonzero so every
    parameter group has a gradient on the first step."""
    base = Transformer(config, device, seed=0)
    tx = make_optimizer(OptimizerConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.01), base)
    qc = q_head_config(config)
    if algo == "ilql":
        state = init_ilql_state(base, MLPHead(qc, device, seed=1), MLPHead(qc, device, seed=2),
                                MLPHead(q_head_config(config, 1), device, seed=3),
                                tx, make_optimizer(OptimizerConfig(lr=1e-3), base), ILQLConfig())
        return state, lambda core, mesh: make_ilql_train_step(core, ILQLConfig(), PAD, mesh)
    if algo == "cql":
        state = init_cql_state(base, MLPHead(qc, device, seed=1), MLPHead(qc, device, seed=2), tx,
                               make_optimizer(OptimizerConfig(lr=1e-3), base), CQLConfig(hard_update_every=2))
        return state, lambda core, mesh: make_cql_train_step(core, CQLConfig(hard_update_every=2), PAD, mesh)
    if algo == "bc":
        # non-action weight 0: no left-pad query row (whose fully masked
        # attention is garbage that differs between kernels) enters the loss
        return BCTrainState(TrainState(base, tx)), lambda core, mesh: make_bc_train_step(core, BCConfig(), PAD, mesh)
    if algo == "mc":
        state = MCTrainState(TrainState(base, tx), TrainState(MLPHead(qc, device, seed=1), adam(1e-3)))
        return state, lambda core, mesh: make_mc_train_step(core, MCConfig(), PAD, mesh)
    if algo == "ppo":
        head = LinearHead(LinearHeadConfig(input_dim=config.hidden_size, output_dim=1, bias_init=-4.1), device, seed=4)
        state = PPOTrainState(TrainState(base, tx), TrainState(head, adam(1e-3)))
        return state, lambda core, mesh: make_ppo_train_step(core, PPOConfig(bc_loss_weight=0.5), PAD, mesh)
    raise ValueError(algo)


def flat_logs(logs: Any, prefix: str = "") -> Dict[str, float]:
    """Nested log dicts → {'a/b': float}."""
    if isinstance(logs, dict):
        out = {}
        for k, v in logs.items():
            out.update(flat_logs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: float(logs)}


def _whole_params(state) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    for f in state.__dataclass_fields__:
        value = getattr(state, f)
        module = value.params if isinstance(value, TrainState) else value
        if isinstance(module, torch.nn.Module):
            out[f] = {k: v.detach().cpu() for k, v in full_state_dict(module).items()}
    return out


def run_algo(algo: str, mesh_shape: Optional[Sequence[int]] = None, device: str = "cpu", steps: int = 2,
             config: Optional[TransformerConfig] = None, axis_names: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Two steps of `algo` (sharded over `mesh_shape` when given) → the
    losses, the last logs and the whole parameters of every module (the
    main process's result; None on the other ranks)."""
    config = config or dryrun_config()
    mesh = None
    if mesh_shape is not None:
        mesh = load_mesh(mesh_shape, axis_names or ("dp", "fsdp", "mp")[: len(mesh_shape)], device=device)
    state, factory = build_algo(algo, config, device)
    if mesh is not None:
        shard_train_state(state, mesh)
    step = factory(LMCore(config, device, mesh), mesh)
    batch = _batch(algo, config, device)
    losses, logs = [], None
    for i in range(steps):
        state, loss, logs = step(state, batch, torch.Generator(device=device).manual_seed(i))
        losses.append(float(loss))
    params = _whole_params(state)
    if not is_main_process():
        return None
    return dict(losses=losses, logs=flat_logs(logs), params=params)


def run_algos(algos: Sequence[str], mesh_shape: Optional[Sequence[int]] = None, device: str = "cpu",
              **kw) -> Optional[dict]:
    """{algo: run_algo(algo, ...)} for several algorithms in one group."""
    out = {algo: run_algo(algo, mesh_shape, device, **kw) for algo in algos}
    return out if is_main_process() else None


def _dryrun_rank(n: int, device: str, weights: Optional[Dict[str, Dict[str, torch.Tensor]]]) -> Optional[dict]:
    config = dryrun_config()
    dp, fsdp, mp = dryrun_mesh_shape(n)
    mesh = load_mesh((dp, fsdp, mp), device=device)
    base = Transformer(config, device, seed=0)
    q_cfg = q_head_config(config, layer2_initializer_range=0.0)
    v_cfg = q_head_config(config, 1, layer2_initializer_range=0.0)
    q1, q2, v = MLPHead(q_cfg, device, seed=1), MLPHead(q_cfg, device, seed=2), MLPHead(v_cfg, device, seed=3)
    for name, module in (("base", base), ("q1", q1), ("q2", q2), ("v", v)):
        if weights is not None:
            load_state(module, weights[name])
    ilql_config = ILQLConfig()
    state = init_ilql_state(base, q1, q2, v, adam(1e-4), adam(1e-3), ilql_config)
    shard_train_state(state, mesh)
    step = make_ilql_train_step(LMCore(config, device, mesh), ilql_config, PAD, mesh)
    arrays = dryrun_batch(config, max(4, dp * fsdp * 2))
    batch = ILQLBatch(*(torch.as_tensor(arrays[k], device=device) for k in ILQLBatch._fields))
    state, loss, logs = step(state, batch, torch.Generator(device=device).manual_seed(1))
    if not np.isfinite(float(loss)):
        raise FloatingPointError(f"non-finite loss: {float(loss)}")
    params = _whole_params(state)
    wrapped = sum(is_sharded(m) for m in all_modules(state))
    if not is_main_process():
        return None
    return dict(mesh=(dp, fsdp, mp), loss=float(loss), logs=flat_logs(logs),
                params=params, sharded_modules=wrapped)


def dryrun_multichip(n_devices: int, device: str = "cuda", weights=None, timeout_s: float = 300.0) -> dict:
    """One sharded ILQL step over n ranks (one process and one device each)
    → rank 0's result: mesh, loss, logs, whole parameters. `weights`
    ({base, q1, q2, v} → whole state dicts) replaces the seeded init."""
    out = run_ranks(_dryrun_rank, n_devices, (n_devices, device, weights), device=device, timeout_s=timeout_s)[0]
    print(f"dryrun_multichip OK: mesh={out['mesh']} ILQL step loss={out['loss']:.4f}")
    return out


def ring_attention_ranks(cases: dict, sp: int) -> Optional[dict]:
    """Ring attention over an sp mesh of every rank, for each case (q, k, v
    [B,H,T,D] global, bias [B,T] or None, causal) with each rank cutting
    its sequence slice → per case the whole output and the gradients of
    sum(out²) for q, k and v (rank 0; None elsewhere)."""
    from lmrl_gym_torch.parallel.mesh import MESH_AXES_SP, Spec, gather_shards, local_shard
    from lmrl_gym_torch.parallel.ring_attention import make_ring_attention

    mesh = load_mesh((-1, 1, 1, sp), MESH_AXES_SP, device="cpu")
    seq4, seq2 = Spec(None, None, "sp", None), Spec(None, "sp")
    out = {}
    for name, (q, k, v, bias, causal) in cases.items():
        ql, kl, vl = (local_shard(x, mesh, seq4).clone().requires_grad_(True) for x in (q, k, v))
        o = make_ring_attention(mesh, causal=causal)(ql, kl, vl, None if bias is None else local_shard(bias, mesh, seq2))
        (o ** 2).sum().backward()
        whole = [gather_shards(x.detach(), mesh, seq4) for x in (o, ql.grad, kl.grad, vl.grad)]
        out[name] = dict(zip(("out", "dq", "dk", "dv"), whole))
    return out if is_main_process() else None


def sp_logits_ranks(config: TransformerConfig, ids, mesh_shape: Sequence[int]) -> Optional[torch.Tensor]:
    """The trunk's logits on a batch under an (dp, fsdp, mp, sp) mesh: rows
    over the batch ranks, the sequence over sp (ring attention)."""
    from lmrl_gym_torch.parallel.mesh import MESH_AXES_SP, gather_batch, local_batch, shard_module

    mesh = load_mesh(mesh_shape, MESH_AXES_SP, device="cpu")
    trunk = shard_module(Transformer(config, "cpu", seed=0), mesh)
    logits, _ = LMCore(config, "cpu", mesh).forward(trunk, local_batch(ids, mesh), pad_token_id=PAD)
    (logits,) = gather_batch(mesh, logits)
    return logits if is_main_process() else None


def mesh_round_trip(shape: Sequence[int], axis_names: Sequence[str]) -> dict:
    """On every rank: the mesh's sizes and this rank's coordinates; a trunk
    sharded by its rules (FSDP2) gathered whole again against its unsharded
    state; and each rank's rows of a batch put on the mesh
    (`host_local_device_put`) and gathered whole."""
    from torch.distributed.tensor import DTensor

    from lmrl_gym_torch.parallel.mesh import Spec, batch_spec, fully_replicated, host_local_device_put, local_batch, \
        shard_module, with_sharding_constraint

    mesh = load_mesh(shape, axis_names, device="cpu")
    config = dryrun_config()
    whole = {k: v.clone() for k, v in Transformer(config, "cpu", seed=0).state_dict().items()}
    trunk = shard_module(Transformer(config, "cpu", seed=0), mesh)
    sharded = all(isinstance(p, DTensor) for p in trunk.parameters())
    gathered = full_state_dict(trunk)
    params_equal = all(torch.equal(gathered[k], whole[k]) for k in whole)
    local_sizes = {k: tuple(v.to_local().shape) for k, v in trunk.state_dict().items()}
    rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    put = host_local_device_put(local_batch(rows, mesh), mesh, batch_spec(1))
    whole = with_sharding_constraint(put, mesh, Spec())
    return dict(shape=mesh.shape, coords={a: mesh.coord(a) for a in mesh.axis_names}, sharded=sharded,
                params_equal=params_equal, local_sizes=local_sizes,
                batch_equal=torch.equal(put.full_tensor(), rows), batch_local=tuple(put.to_local().shape),
                constrained=list(whole.placements) == fully_replicated(mesh) and torch.equal(whole.to_local(), rows))


def checkpoint_ranks(mesh_shape: Sequence[int], out_dir: str, params_dir: Optional[str] = None) -> Optional[dict]:
    """An ILQL state one unsharded step in (the same on every rank), then
    sharded over the mesh and saved with its optimizer state to `out_dir`
    (`loops/checkpoints.py::dump_modules`). With `params_dir`, its base and
    q1 head params are then restored from there (a JAX checkpoint) through
    the sharded read; returns them gathered whole, and whether every base
    parameter was sharded."""
    from torch.distributed.tensor import DTensor

    from lmrl_gym_torch.loops.checkpoints import dump_modules, restore_module

    config = dryrun_config()
    state, factory = build_algo("ilql", config, "cpu")
    step = factory(LMCore(config, "cpu"), None)
    step(state, _batch("ilql", config, "cpu"), torch.Generator().manual_seed(0))
    mesh = load_mesh(mesh_shape, device="cpu")
    shard_train_state(state, mesh)
    dump_modules(out_dir, {"base": state.base, "q1_head": state.q1_head, "q1_target": state.q1_target_params},
                 save_train_state=True)
    if params_dir is None:
        return None
    restore_module(params_dir, "base", state.base.params)
    restore_module(params_dir, "q1_head", state.q1_head.params)
    out = dict(base=full_state_dict(state.base.params), q1_head=full_state_dict(state.q1_head.params),
               sharded=all(isinstance(p, DTensor) for p in state.base.params.parameters()))
    return out if is_main_process() else None


def unsharded_checkpoint(out_dir: str) -> None:
    """`checkpoint_ranks`'s state and save without a mesh."""
    from lmrl_gym_torch.loops.checkpoints import dump_modules

    config = dryrun_config()
    state, factory = build_algo("ilql", config, "cpu")
    factory(LMCore(config, "cpu"), None)(state, _batch("ilql", config, "cpu"), torch.Generator().manual_seed(0))
    dump_modules(out_dir, {"base": state.base, "q1_head": state.q1_head, "q1_target": state.q1_target_params},
                 save_train_state=True)


def rollout_ranks(env_kind: str, batch: int, mesh_shape: Optional[Sequence[int]], seed: int = 1) -> Optional[dict]:
    """A sampled rollout of a seeded tiny trunk (temperature 1) on `batch`
    Wordle games or chess endgames (3 turns), its games sharded over the
    batch ranks of the mesh when given → the whole tokens and rewards, and
    whether the sharded results came back batch-sharded."""
    from torch.distributed.tensor import DTensor

    from lmrl_gym_torch.envs.chess.vector import ChessEndgameVectorEnv
    from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv, WordleVocab
    from lmrl_gym_torch.loops import actor
    from lmrl_gym_torch.parallel.mesh import Spec, batch_rows, gather_tree, local_shard

    mesh = load_mesh(mesh_shape, device="cpu") if mesh_shape is not None else None
    rows = batch_rows(mesh, batch)
    gen = torch.Generator().manual_seed(seed)
    if env_kind == "wordle":
        env = WordleVectorEnv(WordleVocab.from_file(), device="cpu")
        config = tiny_test_config(max_position_embeddings=actor.EPISODE_LEN)
        step_fn, carry = actor.make_lm_step_fn(LMCore(config, "cpu"), rows)
        out = actor.rollout_wordle(env, step_fn, Transformer(config, "cpu", seed=0), carry, rows, 1.0, False,
                                   generator=gen, mesh=mesh)
        tokens, reward = out.tokens, out.turn_reward
    else:
        env = ChessEndgameVectorEnv(max_steps=3, device="cpu")
        config = tiny_test_config(max_position_embeddings=env.OBS_LEN + env.ACT_LEN)
        step_fn, carry = actor.make_lm_step_fn(LMCore(config, "cpu"), rows, total_len=env.OBS_LEN + env.ACT_LEN)
        state0 = local_shard(env.reset(batch, gen), mesh, Spec(("dp", "fsdp")))
        out, _ = actor.rollout_markov(env, 3, step_fn, Transformer(config, "cpu", seed=0), carry, state0, 1.0,
                                      False, generator=gen, mesh=mesh)
        tokens, reward = out.act_tokens, out.turn_reward
    sharded = isinstance(tokens, DTensor)
    tokens, reward = gather_tree((tokens, reward))
    return dict(tokens=tokens, reward=reward, sharded=sharded) if is_main_process() else None


def cli_main_ranks(which: str, argv: Sequence[str], replay=None) -> Optional[dict]:
    """`lmrl_gym_torch.cli.<which>.main(argv)` on every rank of the group
    (`train` takes a `Replay`); → evaluate's results on the main process."""
    if which == "train":
        from lmrl_gym_torch.cli.train import main

        main(list(argv), replay=replay)
        return None
    from lmrl_gym_torch.cli.evaluate import main

    out = main(list(argv))
    return out if is_main_process() else None


def oracle_ranks(mesh_shape: Optional[Sequence[int]], n_episodes: int = 6, epochs: int = 2) -> Optional[dict]:
    """The decoder 20Q oracle (`envs/lm_oracle.py::train_oracle_lm`) at a
    tiny width, its model sharded over the mesh when given → the logged
    losses, every step's gradients (on the main process: the noise masks of
    a parity test) and the whole trained parameters."""
    from lmrl_gym_torch.core import optimizer as opt
    from lmrl_gym_torch.envs.lm_oracle import COLLECTORS, OracleTrainConfig, train_oracle_lm

    mesh = load_mesh(mesh_shape, device="cpu") if mesh_shape is not None else None
    cfg = OracleTrainConfig(n_episodes=n_episodes, epochs=epochs, train_bsize=8, max_length=128, hidden_size=64,
                            num_layers=2, num_heads=4)
    grads, logs = [], []
    orig = opt.TrainState.apply_gradients

    def record(self, g):
        grads.append({k: full_tensor(v).detach().clone() for k, v in g.items()})
        return orig(self, g)

    opt.TrainState.apply_gradients = record
    try:
        _, _, params, _ = train_oracle_lm(COLLECTORS["twenty_questions"](n_episodes, 0), cfg, log=logs.append,
                                          device="cpu", mesh=mesh)
    finally:
        opt.TrainState.apply_gradients = orig
    whole = {k: v.detach().clone() for k, v in full_state_dict(params).items()}
    return dict(logs=logs, grads=grads, params=whole) if is_main_process() else None


def online_ranks(mesh_shape: Optional[Sequence[int]], rounds: int = 1) -> Optional[list]:
    """`loops/online_device.py::online_ilql_wordle` at the tiny config (B=8
    games a round, minibatches of 4), its state sharded and its games
    sharded over the batch ranks of the mesh when given → the per-round
    metrics."""
    from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv, WordleVocab
    from lmrl_gym_torch.loops import actor
    from lmrl_gym_torch.loops.online_device import OnlineDeviceConfig, online_ilql_wordle

    mesh = load_mesh(mesh_shape, device="cpu") if mesh_shape is not None else None
    config = tiny_test_config(max_position_embeddings=actor.EPISODE_LEN)
    base = Transformer(config, "cpu", seed=0)
    qc = q_head_config(config)
    state = init_ilql_state(base, MLPHead(qc, "cpu", seed=1), MLPHead(qc, "cpu", seed=2),
                            MLPHead(q_head_config(config, 1), "cpu", seed=3), adam(1e-3), adam(1e-3), ILQLConfig())
    if mesh is not None:
        shard_train_state(state, mesh)
    env = WordleVectorEnv(WordleVocab.from_file(), device="cpu")
    _, history = online_ilql_wordle(LMCore(config, "cpu", mesh), state, env, ILQLConfig(),
                                    OnlineDeviceConfig(n_rounds=rounds, rollout_batch=8, train_bsize=4),
                                    generator=torch.Generator().manual_seed(3), mesh=mesh)
    return history if is_main_process() else None
