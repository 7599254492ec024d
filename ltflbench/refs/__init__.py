"""Plain references for the output check, in plain PyTorch (NumPy for
the host's Algorithm 1).

Nothing here imports ``jax``, the JAX package or the port
(``repro_torch``), and nothing takes a tensor the port made: the
benchmark makes the weights, the data and the step's controls and hands
the same to both sides; the random draws are re-made from the same
seeds and generators. ``ltfl`` is the LTFL step (Eq. 8-20 of the
paper), ``lm`` the dense decoder LM, ``resnet`` the paper's
pre-activation ResNet, ``algorithm1`` Algorithm 1 (Section 5) and the
host's draws of an edge round.
"""
