"""vector_quantization_tpu_torch: the PyTorch + CUDA port of
``vector_quantization_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module paths and public layouts, so each
module can be held against its counterpart. Its kernels are hand-written
CUDA C++ (``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use; on
CPU tensors every kernel wrapper runs its plain PyTorch version. The port
imports neither ``jax`` nor ``vector_quantization_tpu``.

Covered so far: the INT8-weight, INT8-paged-KV, CFG continuous-batching
server (``tasks.serving.ARServer`` with ``paged=True``) over the Llama
decoder, and the two kernels on its path (``ops.int8_matmul``,
``ops.paged_attention``).
"""

__version__ = "0.1.0"

from . import registries  # noqa: F401
from .models.transformers import llama as _llama  # noqa: F401  (registers LlamaTransformer)
