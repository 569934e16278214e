"""The port stands alone: it imports with jax, flax, lmrl_gym_tpu and the
`regex` package (absent on the card's machine) blocked,
no port file (nor chip_smoke.py) imports them, and its entry points refuse
to run without CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lmrl_gym_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lmrl_gym_tpu", "regex")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _python_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_with_jax_blocked():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + f"sys.path.insert(0, {ROOT!r})\n"
        + "import importlib\n"
        + f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        + "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _python_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from lmrl_gym_torch.algos.bc import BCConfig, make_bc_train_step
    from lmrl_gym_torch.algos.cql import CQLConfig, make_cql_train_step
    from lmrl_gym_torch.algos.ilql import ILQLConfig, init_ilql_state, make_ilql_train_step
    from lmrl_gym_torch.algos.mc import MCConfig, make_mc_train_step
    from lmrl_gym_torch.algos.ppo import PPOConfig, make_ppo_train_step
    from lmrl_gym_torch.algos.value_policy import LMServer, tokenize_histories_for_scoring
    from lmrl_gym_torch.core.optimizer import adam
    from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv, WordleVocab
    from lmrl_gym_torch.loops.actor import rollout_wordle_scripted
    from lmrl_gym_torch.loops.online_device import OnlineDeviceConfig, online_ilql_wordle
    from lmrl_gym_torch.models.config import tiny_test_config
    from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
    from lmrl_gym_torch.models.interface import LMCore
    from lmrl_gym_torch.models.transformer import KVCache, Transformer
    from lmrl_gym_torch.scripts import maze_ilql_gate, wordle_ilql_gate
    from lmrl_gym_torch.text.frames import Text
    from lmrl_gym_torch.text.tokenizer import ByteTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    for make in (
        lambda: Transformer(cfg),
        lambda: LMCore(cfg),
        lambda: KVCache.init(cfg, 2, 8),
        lambda: MLPHead(MLPHeadConfig(64, 128, 320)),
        lambda: WordleVectorEnv(WordleVocab.from_file()),
        lambda: Transformer(cfg, device="cuda"),
        lambda: make_ilql_train_step(LMCore(cfg), ILQLConfig(), 256),
        lambda: make_bc_train_step(LMCore(cfg), BCConfig(), 256),
        lambda: init_ilql_state(Transformer(cfg), *(MLPHead(MLPHeadConfig(64, 128, n)) for n in (320, 320, 1)),
                                adam(1e-4), adam(1e-3), ILQLConfig()),
        lambda: rollout_wordle_scripted(WordleVectorEnv(WordleVocab.from_file()), 4),
        lambda: online_ilql_wordle(LMCore(cfg), None, WordleVectorEnv(WordleVocab.from_file()), ILQLConfig(),
                                   OnlineDeviceConfig()),
        lambda: LMServer(LMCore(cfg), ByteTokenizer()),
        lambda: wordle_ilql_gate.main(["--bc-steps", "1", "--pbc-steps", "1", "--ilql-steps", "1"]),
        lambda: make_mc_train_step(LMCore(cfg), MCConfig(), 256),
        lambda: make_cql_train_step(LMCore(cfg), CQLConfig(), 256),
        lambda: make_ppo_train_step(LMCore(cfg), PPOConfig(), 256),
        lambda: tokenize_histories_for_scoring([(Text("a", False),)], ByteTokenizer(), 8),
        lambda: maze_ilql_gate.main(["--n-chains", "1", "--bc-epochs", "1", "--ilql-epochs", "1"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the explicit CPU request runs
    assert Transformer(cfg, device="cpu").wte.weight.device.type == "cpu"
    assert LMCore(cfg, device="cpu").device.type == "cpu"
