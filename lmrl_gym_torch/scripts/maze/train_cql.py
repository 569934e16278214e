"""Train cql on maze — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.maze.train_cql [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "maze", "--algo", "cql"] + sys.argv[1:])
