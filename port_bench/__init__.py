"""The benchmark of the PyTorch/CUDA port (``python3 port_bench/run.py``)."""
