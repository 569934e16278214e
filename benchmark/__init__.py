"""The benchmark of lmrl_gym_torch: see harness.py."""
