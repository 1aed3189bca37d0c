"""PyTorch + CUDA port of the depth-model hardening system (see README).

Imports torch and numpy only, never jax: the card machine has no jax.
"""
