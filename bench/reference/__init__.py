"""The plain reference the benchmark judges the program's answers by:
plain PyTorch and numpy, importing nothing of the program."""
