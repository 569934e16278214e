"""Train ppo on wordle — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.wordle.train_ppo [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "wordle", "--algo", "ppo"] + sys.argv[1:])
