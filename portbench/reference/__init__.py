"""The plain reference of the benchmark (plain PyTorch; nothing of the
program)."""
