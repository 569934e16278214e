"""Train ppo on guess_city — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.guess_city.train_ppo [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "guess_city", "--algo", "ppo"] + sys.argv[1:])
