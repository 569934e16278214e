"""Train ilql on chess — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.chess.train_ilql [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "chess", "--algo", "ilql"] + sys.argv[1:])
