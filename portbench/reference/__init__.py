"""The plain reference the benchmark judges the program's fits against:
numpy and plain PyTorch only, computed in float64 (the controls in a
lower precision). It imports nothing of the program and takes nothing
the program made but the outputs it judges."""
