"""The benchmark's plain reference: a frozen copy of the port's plain paths.

Each module here is the port's module of the same path as it stood when
the benchmark was written, with one change: `ops/_build.py` is a
stand-in whose `on_cuda` answers False, so every op runs its plain
PyTorch version on the card as on the CPU (no hand-written kernel, and
PyTorch's own backward of the reflect pad and the bilinear resize). It
imports nothing of the program, so a later change to the program leaves
it as it is. Run it in float32 with TF32 off (`reference.numerics`).
"""
