"""Train mc on wordle — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.wordle.train_mc [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "wordle", "--algo", "mc"] + sys.argv[1:])
