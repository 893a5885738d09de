"""The plain reference the benchmark holds the program's outputs to.

Plain PyTorch (float64 where it decides) that imports neither ``jax``,
nor ``plade_tpu``, nor anything of ``plade_tpu_torch``: the nearest
neighbours of K1 and K2 (``nn.py``), the average spacing of a cloud
(``spacing.py``) and the pose errors against the generator's truth
(``pose.py``).  Each module also has the control's version: the same
arithmetic in TF32, the precision below the float32 the configuration
runs in.
"""
