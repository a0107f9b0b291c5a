"""pcgnn_tpu_torch — PC-GNN in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

A port of the JAX package ``pcgnn_tpu`` that keeps its module names, so each
module here has a counterpart there.  Tensors live on an explicit ``device``;
entry points (``train.trainer.Trainer``, ``cli``) default to ``cuda`` and
raise when no GPU is present.  Kernel sources are under ``csrc/`` and are
compiled with ``nvcc`` at first use (``ops.kernels``).

Importing this package imports no submodule: import what you use, e.g.
``from pcgnn_tpu_torch.train.trainer import Trainer``.
"""

__version__ = "0.1.0"
