"""Train bc on twenty_questions — wrapper over the port's unified CLI
(`python -m lmrl_gym_torch.scripts.twenty_questions.train_bc [flags]`)."""
import sys

from lmrl_gym_torch.cli.train import main

if __name__ == "__main__":
    main(["--task", "twenty_questions", "--algo", "bc"] + sys.argv[1:])
