"""Plain float32 PyTorch references of what the cells time; they import
nothing of the program."""
