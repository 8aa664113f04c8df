"""isdf_tpu_torch — the PyTorch/CUDA port of isdf_tpu for one NVIDIA H100.

The package mirrors isdf_tpu's layout (ops/, models/, engine/, data/,
train/, utils/) and imports nothing of it. Plain tensor code is eager
PyTorch; the fused train kernel is CUDA C++ for sm_90a (csrc/), built with
nvcc at first use and bound through ctypes (models/cuda_mlp.py).

Float32 matrix products run in IEEE float32 everywhere in the port: the PE,
batch-distance scores and tangent contractions are phase- and argmin-
sensitive, and TF32 would corrupt them.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 products (tpu.compute_dtype: "bfloat16") sum in float32 throughout
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
