"""Plain PyTorch reference of the benchmarked models and their training step."""
