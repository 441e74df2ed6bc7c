"""pq3d_tpu_torch: the PyTorch/CUDA port of pq3d_tpu for NVIDIA Hopper.

The package mirrors ``pq3d_tpu``'s layout (``ops/``, ``models/``, ``data/``,
``eval/``, ``serve.py``) so each counterpart sits at the same path.  It
imports ``torch`` and ``numpy`` only, never JAX and nothing of the JAX
package.  The first slice serves stage-1 instance segmentation
(``serve.InstSegServer``); the stride-1 3^3 sparse convs it routes run a
hand-written CUDA kernel (``ops/zrun_conv.py``, ``csrc/zrun_conv.cu``).
"""
from pq3d_tpu_torch.device import resolve_device  # noqa: F401
