"""Train ppo on text_nav — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.text_nav.train_ppo [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "text_nav", "--algo", "ppo"] + sys.argv[1:])
