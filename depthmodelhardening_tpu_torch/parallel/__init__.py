"""Data parallelism over torch.distributed (JAX `parallel/`)."""
