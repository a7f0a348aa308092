"""vector_quantization_tpu_torch: the PyTorch + CUDA port of
``vector_quantization_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module paths and public layouts, so each
module can be held against its counterpart. Its kernels are hand-written
CUDA C++ (``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use; on
CPU tensors every kernel wrapper runs its plain PyTorch version. The port
imports neither ``jax`` nor ``vector_quantization_tpu``.

Covered so far:
- the INT8-weight, INT8-paged-KV, CFG continuous-batching server
  (``tasks.serving.ARServer`` with ``paged=True``) over the Llama decoder,
  with its two kernels (``ops.int8_matmul``, ``ops.paged_attention``);
- the VQGAN tokenizer's inference path (``tasks.image_reconstruction
  .AutoencoderModel``: encode, nearest-code lookup, decode), built from the
  files under ``configs/`` (``utils.config``, the registries), with the
  nearest-code kernel (``ops.vq_lookup``);
- AR training of the class-conditional prior (``algorithms.ar.ARAlgorithm``:
  tokenize, the Llama training forward with per-block remat, the
  logits-free fused CE, optax-equivalent AdamW), with the flash attention
  kernels, forward and backward (``ops.flash_attention``);
- VQGAN tokenizer training (``algorithms.vqgan.VQGANAlgorithm``,
  ``algorithms.base.ReconstructionAlgorithm``: recon losses with LPIPS,
  the PatchGAN discriminator, the adaptive GAN weight, R1, the codebook
  re-normalisation, EMA), with the validation metrics
  (``training.metrics``) and ``data.datasets.SyntheticDataset``;
- VQ-KD and Cluster tokenizer training (``algorithms.vqkd``: the ViT
  encoder and decoder, the CLIP/ViT teachers, ``ClusterEncoder``, the EMA
  k-means with its lazy init and CVQ in ``ops.codebook``, the optimizer's
  ``exclude`` mask over flax paths, ``utils.filters``);
- the entry points: ``training.runner`` (``Trainer``, ``Validator``,
  ``build_runner``), ``training.checkpoints`` (torch files in the JAX
  state's layout; the three load modes), ``training.callbacks``, the data
  plane (``data.loader.DataLoader``, ``data.datasets``, ``data.native``),
  ``parallel`` for one device, and ``python -m
  vector_quantization_tpu_torch.cli.{train,test,tokenize,demo}`` over the
  same config files as the JAX package;
- the rest of the tokenizer zoo and GPT-2: FSQ and SQ (``ops.fsq``,
  ``models.quantizers.fsq``), the teachers' bicubic resize and the
  ConvNeXt teacher, CVQ-VAE's multinomial, random and cached anchors, the
  StyleGAN2 discriminator (``ops.upfirdn``), ``models.transformers.gpt2``
  (training, the dense-cache decode, ``generate`` and the dense server),
  and ``AccuracyMetric``;
- the paper's evaluations: FID and IS with the Inception network
  (``models.metrics``, ``training.metrics.FIDMetric``), ``python -m
  vector_quantization_tpu_torch.cli.{fid,val}``, the domain datasets
  (``data.domains``) and the linear probe (``algorithms.classification``)
  with the LARS optimizer;
- the VQGAN + VQ-KD hybrid (``algorithms.exp_vqgan_vqkd``), the weight
  converters of ``utils.converters`` (taming VQGAN, LPIPS's VGG16, CLIP's
  visual tower, GPT-2, HF Llama, BEiT-v2 VQ-KD; LPIPS loads from
  ``$PRETRAINED/lpips``), the Llama's ``quantize_mode="w8a8"``
  (``ops.int8_matmul.int8_matmul_w8a8``) and ``remat_policy="dots"``;
- parallelism over ``torch.distributed`` (``parallel``: the mesh, data,
  FSDP and tensor parallelism, the collectives), the global-batch
  statistics under them (BatchNorm, the codebook updates, the metrics),
  tensor-parallel serving and ``utils.debug``'s sync assert.
"""

__version__ = "0.8.0"

from . import registries  # noqa: F401
# importing these registers their classes under the configs' type names
from .algorithms import ar as _ar  # noqa: F401
from .algorithms import classification as _classification  # noqa: F401
from .algorithms import exp_vqgan_vqkd as _exp_vqgan_vqkd  # noqa: F401
from .algorithms import vqgan as _vqgan_algorithm  # noqa: F401
from .algorithms import vqkd as _vqkd  # noqa: F401
from .data import datasets as _datasets  # noqa: F401
from .data import domains as _domains  # noqa: F401
from .models import connectors as _connectors  # noqa: F401
from .models.autoencoders import vqgan as _vqgan  # noqa: F401
from .models.autoencoders import vit as _vit  # noqa: F401
from .models.quantizers import fsq as _fsq  # noqa: F401
from .models.quantizers import vq as _vq  # noqa: F401
from .models.transformers import gpt2 as _gpt2  # noqa: F401
from .models.transformers import llama as _llama  # noqa: F401
from .parallel import sharding as _sharding  # noqa: F401
from .tasks import image_reconstruction as _image_reconstruction  # noqa: F401
from .training import callbacks as _callbacks  # noqa: F401
from .training import metrics as _metrics  # noqa: F401
from .training import runner as _runner  # noqa: F401
