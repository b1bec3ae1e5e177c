"""Benchmark of ``zhpe_ompi_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA GPUs.

One run trains one cell (a model configuration under a training job) through
the port's ``models/transformer.make_train_step_optax`` and prints one JSON
line.  ``python -m gpubench.run --help`` gives the command; ``README.md``
gives the layout.  Nothing here imports JAX or the JAX package.
"""
