"""SmartSAGE in PyTorch for an NVIDIA H100: GraphSAGE minibatch training
whose data preparation (k-hop neighbour sampling and feature gathering)
runs in hand-written CUDA kernels.

A second package beside the JAX one, ``repro``, which stays the
reference: this package imports neither ``jax`` nor ``repro``, and its
tests hold it against the reference at equal seeds.  Entry points run on
``cuda`` unless the caller asks for the CPU.
"""
