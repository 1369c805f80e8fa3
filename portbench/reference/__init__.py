"""Plain references of the model families: PyTorch only, one module a
family, importing nothing of the program under test."""
