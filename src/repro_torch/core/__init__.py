"""Core of the port: the numpy host control plane (channel, delay/energy,
convergence gap, Bayesian optimization, Algorithm 1) and the tensor
stages of the round step (pruning, quantization, compression,
aggregation)."""
