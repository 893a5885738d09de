"""The benchmark of the PyTorch and CUDA port (``plade_tpu_torch``):
``python3 -m regbench.run`` (see ``run.py``).  It imports neither ``jax``
nor the JAX package."""
