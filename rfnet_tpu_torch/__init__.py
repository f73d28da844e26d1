"""rfnet_tpu_torch — RFNet point-cloud completion in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``rfnet_tpu`` (kept beside it as the reference).
Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
for the TPU on the ported path is a CUDA C++ kernel under ``csrc/``, built
with ``nvcc`` at first use (``kernels.py``). Each kernel's wrapper runs the
kernel for CUDA tensors and its plain PyTorch version for CPU tensors.

fp32 means fp32 here: TF32 is switched off for matmuls and convolutions, so
the card and the CPU reference compute the feature MLPs in full float32.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
