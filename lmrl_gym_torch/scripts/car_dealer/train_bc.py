"""Train bc on car_dealer — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.car_dealer.train_bc [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "car_dealer", "--algo", "bc"] + sys.argv[1:])
