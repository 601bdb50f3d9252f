"""Numerical kernels of the port: gamma rates, P(t), pruning (plain
PyTorch) and the CUDA pruning walk with its build."""
