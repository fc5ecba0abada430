"""PyTorch/CUDA port of the Confidence Bootstrapping score-model sampler.

The JAX package ``confidence_bootstrapping_tpu`` stays the reference; this
package mirrors its module paths (``config``, ``ops/irreps``,
``models/layers``, ``sampler/sampling``, ...) and never imports it, JAX, flax
or yaml. The TP-conv kernels that the JAX package writes in Pallas for the TPU
are CUDA C++ kernels for Hopper here (``csrc/``, bound in ``ops/cuda``).

Numerics: float32 end to end. TF32 is switched off for matmuls and cuDNN so
that coordinates and spherical harmonics keep full float32 precision (rounded
positions corrupt the harmonics of short edges and of masked self-edges).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
