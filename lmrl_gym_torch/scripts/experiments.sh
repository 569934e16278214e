#!/bin/bash
# The canonical config invocations of scripts/experiments.sh on the port
# (`lmrl_gym_torch.cli.train`, on the card; add --device cpu for the plain
# path). Scale model-size/n-data up for real runs.

# 1. Maze fully-observed BC + eval rollouts
python -m lmrl_gym_torch.cli.train --task maze --algo bc \
    --n-data 200 --epochs 4 --model-size small --train-bsize 16

# 2. Wordle ILQL
python -m lmrl_gym_torch.cli.train --task wordle --algo ilql \
    --n-data 500 --epochs 4 --model-size small --train-bsize 16 --beta 8.0

# 3. Text-Nav PPO (offline chains; history-conditioned obs)
python -m lmrl_gym_torch.cli.train --task text_nav --algo ppo \
    --n-data 64 --epochs 4 --model-size small --train-bsize 8

# 4. Chess endgames (kQK) ILQL
python -m lmrl_gym_torch.cli.train --task chess_endgames --algo ilql \
    --n-data 128 --epochs 4 --model-size small --train-bsize 16

# 5. Twenty-Questions / Car-Dealer PPO
python -m lmrl_gym_torch.cli.train --task twenty_questions --algo ppo \
    --n-data 64 --epochs 2 --model-size small --train-bsize 4
python -m lmrl_gym_torch.cli.train --task car_dealer --algo bc \
    --n-data 128 --epochs 2 --model-size small --train-bsize 4

# 5b. Twenty-Questions ONLINE PPO with the trained LM oracle in the loop
# (the reference's flan-t5-oracle configuration: --oracle-arch t5) and
# a task-trained BPE tokenizer
python -m lmrl_gym_torch.cli.train --task twenty_questions --algo ppo \
    --online-rounds 4 --rollouts-per-round 16 --oracle lm --oracle-arch t5 \
    --tokenizer bpe --n-data 64 --epochs 2 --model-size small \
    --train-bsize 4 --ppo-kl-target 0.05 --bc-loss-weight 0.1

# 5c. Car-Dealer with the trained LM buyer, streaming BC data from jsonl
mkdir -p outputs
python -m lmrl_gym_torch.cli.train --task car_dealer --algo bc \
    --n-data 128 --epochs 2 --model-size small --train-bsize 4 \
    --oracle lm --dump-data-jsonl outputs/car_dealer.jsonl \
    --data-jsonl outputs/car_dealer.jsonl

# 6. Multi-device meshes (--mesh 2,2,2) raise on the port until its
# parallelism lands; every run above takes the default one-device mesh.
