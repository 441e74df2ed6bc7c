"""pq3d_tpu_torch: the PyTorch/CUDA port of pq3d_tpu for NVIDIA Hopper.

The package mirrors ``pq3d_tpu``'s layout (``ops/``, ``models/``, ``data/``,
``eval/``, ``optim/``, ``train/``, ``serve.py``, ``run.py``) so each
counterpart sits at the same path.  It imports ``torch``, ``numpy`` and
``scipy`` only, never JAX and nothing of the JAX package.  Importing the
package itself imports nothing: the data loaders' spawned workers, which
run numpy host code, import only the modules their jobs need.
"""
