"""Train ilql on guess_city — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.guess_city.train_ilql [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "guess_city", "--algo", "ilql"] + sys.argv[1:])
