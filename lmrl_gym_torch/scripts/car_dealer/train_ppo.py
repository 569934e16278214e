"""Train ppo on car_dealer — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.car_dealer.train_ppo [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "car_dealer", "--algo", "ppo"] + sys.argv[1:])
