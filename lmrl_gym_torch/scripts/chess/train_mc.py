"""Train mc on chess — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.chess.train_mc [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "chess", "--algo", "mc"] + sys.argv[1:])
