"""In-repo LM oracle/simulator training + serving for the dialog envs: the
port of `lmrl_gym_tpu/envs/lm_oracle.py`.

The reference drives Twenty-Questions and Guess-My-City with a finetuned
flan-t5-xl answering on the accelerator
(llm_rl_scripts/twenty_questions/env/oracle.py:20-147,
guess_city/env/oracle.py:20-68) and Car-Dealer with a trained GPT-2 buyer
policy (car_dealer/env/buyer.py:12-83). Those checkpoints are not in the
repo, so this module *creates* the oracle the way the reference team did —
supervised training on Q/A behavior — from in-repo scripted teachers:

1. collect (prompt → answer) supervised windows from the scripted
   oracle/buyer under the real question/conversation distribution;
2. BC-train a small decoder LM on them (answers are the action tokens),
   or a small T5 (`train_t5_oracle_lm`);
3. serve it through LMServer / Seq2SeqServer, batched: one padded
   generate per env turn (the reference's
   BatchedTwentyQuestionsPolicyEnvironment, twenty_questions/env/env.py:66-141).

`train_and_save_oracle` / `load_oracle` write and read the JAX package's
checkpoint layout, so an oracle saved by either package loads in the
other. Entry points run on the card unless the caller passes
device="cpu". Given a `mesh` (`parallel/mesh.py`), the trainers shard the
model by its rule table and each rank trains on its rows of every batch,
and `load_oracle` shards the loaded model, as the JAX package's mesh
arguments do.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from lmrl_gym_torch.algos import data as algo_data
from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
from lmrl_gym_torch.algos.value_policy import LMServer, Seq2SeqServer
from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation, block_sequences
from lmrl_gym_torch.core.device import DeviceLike
from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer, value_and_grads
from lmrl_gym_torch.loops.checkpoints import dump_modules, load_module_config, load_module_params
from lmrl_gym_torch.models.config import TransformerConfig, tiny_test_config
from lmrl_gym_torch.models.convert import encdec_params_from_jax, params_from_jax
from lmrl_gym_torch.models.encdec import (
    EncDecConfig,
    EncDecCore,
    EncoderDecoder,
    init_encdec_params,
    tiny_encdec_config,
)
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import Transformer, init_params
from lmrl_gym_torch.parallel.mesh import Mesh, gather_batch, shard_module, shard_train_state, sharded_step
from lmrl_gym_torch.text.frames import Text, TextTrajectory, TokenTrajectory
from lmrl_gym_torch.text.tokenizer import ByteTokenizer


# ---------------------------------------------------------------------------
# supervised window collection from the scripted teachers
# ---------------------------------------------------------------------------


def collect_twenty_questions_qa_balanced(
    n_neg_per_word: int = 4, seed: int = 0
) -> List[TextTrajectory]:
    """Balanced synthetic QA windows labeled by the scripted oracle: for
    every word — its direct-mention question (Yes), its category
    question (Yes), and sampled other-object / other-category questions
    (No). Rollout-only QA measurably collapses the oracle to the
    majority 'No.' class (the direct-mention Yes for any given word
    appears ~once in hundreds of episodes); the reference likewise
    finetunes its flan-t5-xl oracle on a curated QA dataset rather than
    raw rollouts (twenty_questions/env/oracle.py:20-34 loads a finetuned
    checkpoint)."""
    from lmrl_gym_torch.cli.tasks import HeuristicAskerPolicy
    from lmrl_gym_torch.envs.twenty_questions.data import get_default_word_list
    from lmrl_gym_torch.envs.twenty_questions.oracle import (
        ScriptedOracle,
        oracle_prompt,
    )

    rng = random.Random(seed)
    words = get_default_word_list()
    oracle = ScriptedOracle()
    cat_questions = list(HeuristicAskerPolicy(rng).category_questions.values())

    def question_for(word) -> str:
        w = word.words[0].lower()
        article = "an" if w[0] in "aeiou" else "a"
        return f"Is it {article} {w}?"

    windows: List[TextTrajectory] = []

    def add(word, question):
        answer = oracle.generate_answers(word, question)
        windows.append(
            TextTrajectory(
                (
                    Text(oracle_prompt(word, question), False),
                    Text(answer + "\n", True),
                ),
                (0.0, 0.0),
                True,
            )
        )

    for word in words:
        add(word, question_for(word))  # direct mention → Yes
        for cq in cat_questions:  # its own category Yes + two others No
            if oracle.generate_answers(word, cq) == "Yes.":
                add(word, cq)
        for cq in rng.sample(cat_questions, 2):
            add(word, cq)
        for _ in range(n_neg_per_word):  # other-object mentions → No
            other = rng.choice(words)
            add(word, question_for(other))
    rng.shuffle(windows)
    return windows


def collect_twenty_questions_qa(n_episodes: int, seed: int) -> List[TextTrajectory]:
    """(oracle_prompt, Yes./No.) windows under the asker's question
    distribution (prompt text = reference oracle.py:21-28 verbatim)."""
    from lmrl_gym_torch.cli.tasks import HeuristicAskerPolicy, build_twenty_questions_env
    from lmrl_gym_torch.envs.twenty_questions.oracle import oracle_prompt

    env = build_twenty_questions_env()
    rng = random.Random(seed)
    windows: List[TextTrajectory] = []
    for i in range(n_episodes):
        policy = HeuristicAskerPolicy(rng=rng)
        history = env.reset(seed=seed * 104729 + i)
        word = env.curr_word
        done = False
        while not done:
            acted = policy.act(history)
            question = acted[-1].text.strip()
            history, _, done = env.step(acted)
            answer = history[-1].text.strip()
            windows.append(
                TextTrajectory(
                    (
                        Text(oracle_prompt(word, question), False),
                        Text(answer + "\n", True),
                    ),
                    (0.0, 0.0),
                    True,
                )
            )
    return windows


def collect_guess_city_qa(n_episodes: int, seed: int) -> List[TextTrajectory]:
    from lmrl_gym_torch.cli.tasks import HeuristicCityAskerPolicy, build_guess_city_env
    from lmrl_gym_torch.envs.guess_city.env import oracle_prompt

    env = build_guess_city_env()
    rng = random.Random(seed)
    windows: List[TextTrajectory] = []
    for i in range(n_episodes):
        policy = HeuristicCityAskerPolicy(rng=rng)
        history = env.reset(seed=seed * 15485863 + i)
        word = env.curr_word
        done = False
        while not done:
            acted = policy.act(history)
            question = acted[-1].text.strip()
            history, _, done = env.step(acted)
            answer = history[-1].text.strip()
            windows.append(
                TextTrajectory(
                    (
                        Text(oracle_prompt(word, question), False),
                        Text(answer + "\n", True),
                    ),
                    (0.0, 0.0),
                    True,
                )
            )
    return windows


def collect_buyer_conversations(
    n_episodes: int, seed: int, seller_factory=None
) -> List[TextTrajectory]:
    """Buyer-view conversations with buyer lines as action tokens (the
    reference trains its buyer sim the same way: BC on buyer-role views,
    car_dealer/env/data.py:206-263).

    seller_factory(rng) -> TextPolicy overrides the data-gen seller —
    pass a wider-priced seller when the buyer LM must cover a larger
    (budget, price) grid than the default ladder visits."""
    from lmrl_gym_torch.cli.tasks import ScriptedSellerPolicy, build_car_dealer_env
    from lmrl_gym_torch.envs.car_dealer.data import (
        Role,
        create_lines_from_text_history,
        create_trajectory_from_conversation,
    )

    if seller_factory is None:
        seller_factory = lambda rng: ScriptedSellerPolicy(rng=rng)  # noqa: E731
    env = build_car_dealer_env()
    rng = random.Random(seed)
    windows: List[TextTrajectory] = []
    for i in range(n_episodes):
        seller = seller_factory(rng)
        history = env.reset(seed=seed * 32452843 + i)
        done = False
        buyer_info = env.buyer_info
        while not done:
            history, _, done = env.step(seller.act(history))
        conversation = {
            "buyer_info": buyer_info,
            "lines": create_lines_from_text_history(history),
        }
        if env.output is not None:
            conversation["output"] = env.output
        windows.append(
            create_trajectory_from_conversation(conversation, Role.BUYER)
        )
    return windows


COLLECTORS: dict = {
    "twenty_questions": collect_twenty_questions_qa,
    "guess_city": collect_guess_city_qa,
    "car_dealer": collect_buyer_conversations,
}


# ---------------------------------------------------------------------------
# BC training recipe
# ---------------------------------------------------------------------------


@dataclass
class OracleTrainConfig:
    n_episodes: int = 200
    epochs: int = 4
    train_bsize: int = 16
    lr: float = 3e-4
    max_length: int = 256
    seed: int = 0
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 4


def _oracle_model_config(cfg: OracleTrainConfig, vocab_size: int) -> TransformerConfig:
    return tiny_test_config(
        vocab_size=vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        max_position_embeddings=max(128, cfg.max_length),
    )


def train_oracle_lm(
    windows: List[TextTrajectory],
    cfg: OracleTrainConfig,
    tokenizer=None,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
    params: Optional[Transformer] = None,
    mesh: Optional[Mesh] = None,
):
    """BC on the supervised windows → (core, tokenizer, params, config).

    The decoder oracle trains through `make_bc_train_step` (K1 forward, K2
    and K3 backward on the card). `params` is the initial model (trained in
    place); None draws it from cfg.seed. Batches are ordered by
    `np.random.default_rng(cfg.seed)`, as in the JAX package."""
    tokenizer = tokenizer or ByteTokenizer()
    config = _oracle_model_config(cfg, tokenizer.vocab_size)
    core = LMCore(config, device=device, mesh=mesh)

    examples = []
    for w in windows:
        tt = TokenTrajectory.from_text_trajectory(w, tokenizer)
        examples.append(algo_data.BCExample.from_segments(tt.tokens, tt.is_action))
    strategy = BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, cfg.max_length)
    dataset = algo_data.ArrayDataset(
        algo_data.block_bc_examples(examples, strategy, tokenizer.pad_token_id)
    )

    if params is None:
        params = init_params(config, seed=cfg.seed, device=core.device)
    state = BCTrainState(model=TrainState(params, make_optimizer(OptimizerConfig(lr=cfg.lr), params)))
    if mesh is not None:
        shard_train_state(state, mesh)
    step = make_bc_train_step(core, BCConfig(), tokenizer.pad_token_id, mesh)

    rng = np.random.default_rng(cfg.seed)
    n_steps, last_loss = 0, float("nan")
    for epoch in range(cfg.epochs):
        for b in dataset.batches(cfg.train_bsize, rng=rng, drop_last=False):
            batch = BCBatch(
                torch.from_numpy(np.asarray(b["input_ids"])).to(core.device, torch.long),
                torch.from_numpy(np.asarray(b["training_mask"])).to(core.device, torch.float32),
            )
            state, loss, _ = step(state, batch)
            n_steps += 1
            last_loss = float(loss)
        log(f"oracle BC epoch {epoch}: loss={last_loss:.4f} ({n_steps} steps)")
    return core, tokenizer, state.model.params, config


T5_MAX_ANSWER = 16  # decoder rows of the seq2seq oracle: the answer's first 15 tokens and eos


def t5_oracle_batches(windows: List[TextTrajectory], config: EncDecConfig, tokenizer, max_length: int) -> dict:
    """Seq2seq BC rows: the encoder takes the oracle prompt (right-padded,
    truncated left), the decoder teacher-forces the answer (at most
    T5_MAX_ANSWER − 1 tokens and eos) from decoder_start_token_id. Rows are
    padded with config.pad_token_id, as the JAX package pads them."""
    max_ans = T5_MAX_ANSWER
    enc_rows, dec_rows, label_rows = [], [], []
    for w in windows:
        prompt = "".join(t.text for t in w.text_history if not t.is_action)
        answer = "".join(t.text for t in w.text_history if t.is_action)
        ans_ids = tokenizer.encode(answer)[: max_ans - 1] + [tokenizer.eos_token_id]
        enc_rows.append(tokenizer.encode(prompt))
        dec_rows.append([config.decoder_start_token_id] + ans_ids[:-1])
        label_rows.append(ans_ids)
    pad = config.pad_token_id
    right = lambda n, trunc: BlockingStrategy(Padding.RIGHT, trunc, n)  # noqa: E731
    return dict(
        enc=block_sequences(enc_rows, pad, np.int64, right(max_length, Truncation.LEFT)),
        dec_in=block_sequences(dec_rows, pad, np.int64, right(max_ans, Truncation.RIGHT)),
        labels=block_sequences(label_rows, pad, np.int64, right(max_ans, Truncation.RIGHT)),
    )


def t5_oracle_loss(core: EncDecCore, params: EncoderDecoder, enc: torch.Tensor, dec_in: torch.Tensor,
                   labels: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean token cross-entropy over the non-pad labels (optax's
    softmax_cross_entropy_with_integer_labels on the f32 logits, pad
    columns included)."""
    logits, _ = core.forward(params, enc, dec_in, train=True, generator=generator)
    return _t5_xent(logits, labels, core.config.pad_token_id)


def _t5_xent(logits: torch.Tensor, labels: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    mask = (labels != pad_token_id).float()
    xent = F.cross_entropy(logits.float().flatten(0, 1), labels.flatten(), reduction="none").view_as(mask)
    return (xent * mask).sum() / mask.sum().clamp(min=1.0)


def train_t5_oracle_lm(
    windows: List[TextTrajectory],
    cfg: OracleTrainConfig,
    tokenizer=None,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
    params: Optional[EncoderDecoder] = None,
    mesh: Optional[Mesh] = None,
):
    """Seq2seq BC with plain autograd: the encoder takes the oracle prompt,
    the decoder teacher-forces the answer — the reference's oracle
    architecture (finetuned flan-t5, twenty_questions/env/oracle.py:8-9,
    20-147). For the Q/A oracles; the Car-Dealer buyer stays decoder-only
    like the reference's GPT-2 buyer. → (core, tokenizer, params, config)."""
    tokenizer = tokenizer or ByteTokenizer()
    config = tiny_encdec_config(
        vocab_size=tokenizer.vocab_size,
        d_model=cfg.hidden_size,
        num_layers=max(1, cfg.num_layers // 2),
        num_heads=cfg.num_heads,
    )
    core = EncDecCore(config, device=device)
    dataset = algo_data.ArrayDataset(t5_oracle_batches(windows, config, tokenizer, cfg.max_length))
    if params is None:
        params = init_encdec_params(config, seed=cfg.seed, device=core.device)
    state = BCTrainState(model=TrainState(params, make_optimizer(OptimizerConfig(lr=cfg.lr), params)))
    if mesh is not None:
        shard_train_state(state, mesh)
    generator = torch.Generator(device=core.device).manual_seed(cfg.seed)

    def step(state, batch, generator):
        enc, dec_in, labels = batch
        logits, _ = core.forward(state.model.params, enc, dec_in, train=True, generator=generator)
        loss = _t5_xent(*gather_batch(mesh, logits, labels), config.pad_token_id)
        (grads,) = value_and_grads(loss, (state.model.params,))
        state.model.apply_gradients(grads)
        return state, loss.detach()

    step = sharded_step(step, mesh)
    rng = np.random.default_rng(cfg.seed)
    last_loss = float("nan")
    for epoch in range(cfg.epochs):
        for b in dataset.batches(cfg.train_bsize, rng=rng, drop_last=False):
            batch = tuple(torch.from_numpy(np.asarray(b[k])).to(core.device) for k in ("enc", "dec_in", "labels"))
            state, loss = step(state, batch, generator)
            last_loss = float(loss)
        log(f"t5 oracle epoch {epoch}: loss={last_loss:.4f}")
    return core, tokenizer, state.model.params, config


def train_and_save_oracle(
    task_name: str,
    save_dir: str,
    cfg: Optional[OracleTrainConfig] = None,
    tokenizer=None,
    arch: str = "decoder",
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
):
    """End-to-end: collect windows from the scripted teacher, BC-train,
    save under <save_dir>/oracle/{config.json,params.msgpack} in the JAX
    package's layout. arch='t5' trains the seq2seq oracle (Q/A tasks only,
    matching the reference's T5-oracle / GPT-2-buyer split)."""
    cfg = cfg or OracleTrainConfig()
    windows = COLLECTORS[task_name](cfg.n_episodes, cfg.seed)
    if arch == "t5":
        assert task_name != "car_dealer", "buyer sim is decoder-only (reference GPT-2 buyer)"
        train = train_t5_oracle_lm
    else:
        train = train_oracle_lm
    core, tokenizer, params, config = train(windows, cfg, tokenizer=tokenizer, device=device, mesh=mesh)
    dump_modules(
        save_dir,
        {"oracle": params},
        configs={"oracle": {**config.to_dict(), "task": task_name, "arch": arch}},
    )
    return core, tokenizer, params


def load_oracle(save_dir: str, tokenizer=None, device: DeviceLike = None, mesh: Optional[Mesh] = None):
    """Load a saved oracle LM (decoder or t5, written by either package) →
    (core, tokenizer, params), the params sharded by their rules over
    `mesh` when given."""
    tokenizer = tokenizer or ByteTokenizer()
    d = load_module_config(save_dir, "oracle")
    d.pop("task", None)
    arch = d.pop("arch", "decoder")
    tree = load_module_params(save_dir, "oracle")
    if arch == "t5":
        config = EncDecConfig.from_dict(d)
        core = EncDecCore(config, device=device)
        params = init_encdec_params(config, device=core.device)
        params.load_state_dict(encdec_params_from_jax(tree))
    else:
        config = TransformerConfig.from_dict(d)
        core = LMCore(config, device=device, mesh=mesh)
        params = init_params(config, device=core.device)
        params.load_state_dict(params_from_jax(tree, config))
    if mesh is not None:
        shard_module(params, mesh)
    return core, tokenizer, params


# ---------------------------------------------------------------------------
# env builders with the LM in the loop
# ---------------------------------------------------------------------------


def _server_for(core, tokenizer):
    """LMServer for decoder oracles, Seq2SeqServer for T5 oracles — both
    expose the same generate_from_strs surface."""
    if isinstance(core, EncDecCore):
        return Seq2SeqServer(core, tokenizer)
    return LMServer(core, tokenizer)


def _oracle_sampling(tokenizer, max_new_tokens: int) -> SamplingConfig:
    return SamplingConfig(
        max_new_tokens=max_new_tokens,
        greedy=True,
        eos_token_id=getattr(tokenizer, "newline_token_id", ord("\n")),
        pad_token_id=tokenizer.pad_token_id,
    )


def build_lm_twenty_questions_env(
    core, tokenizer, params, max_conversation_length: int = 20, batched: bool = True
):
    """20Q env whose oracle answers come from the LM on the card; batched
    stepping issues ONE padded generate per env turn (reference
    BatchedTwentyQuestionsPolicyEnvironment, env.py:66-141)."""
    from lmrl_gym_torch.envs.twenty_questions.data import get_default_word_list
    from lmrl_gym_torch.envs.twenty_questions.env import (
        BatchedTwentyQuestionsEnv,
        TwentyQuestionsEnv,
    )
    from lmrl_gym_torch.envs.twenty_questions.oracle import LMOracle

    server = _server_for(core, tokenizer)
    oracle = LMOracle(
        server, params, _oracle_sampling(tokenizer, 8), max_input_length=256
    )
    cls = BatchedTwentyQuestionsEnv if batched else TwentyQuestionsEnv
    return cls(oracle, get_default_word_list(), max_conversation_length)


def build_lm_guess_city_env(core, tokenizer, params, max_conversation_length: int = 20):
    from lmrl_gym_torch.envs.guess_city.data import get_default_word_list
    from lmrl_gym_torch.envs.guess_city.env import GuessCityEnv, LMGuessCityOracle

    server = _server_for(core, tokenizer)
    oracle = LMGuessCityOracle(
        server, params, _oracle_sampling(tokenizer, 16), max_input_length=256
    )
    return GuessCityEnv(oracle, get_default_word_list(), max_conversation_length)


def build_lm_car_dealer_env(core, tokenizer, params, max_conversation_length: int = 50):
    from lmrl_gym_torch.envs.car_dealer.env import CarDealerEnv, LMBuyerPolicy

    server = _server_for(core, tokenizer)

    def buyer_factory(info):
        return LMBuyerPolicy(
            server, params, _oracle_sampling(tokenizer, 64), max_input_length=768
        )

    return CarDealerEnv(
        buyer_factory=buyer_factory,
        max_conversation_length=max_conversation_length,
    )


LM_ENV_BUILDERS: dict = {
    "twenty_questions": build_lm_twenty_questions_env,
    "guess_city": build_lm_guess_city_env,
    "car_dealer": build_lm_car_dealer_env,
}
