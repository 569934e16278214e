"""The plain references the program is compared with: plain PyTorch, float32, no kernel of the program."""
