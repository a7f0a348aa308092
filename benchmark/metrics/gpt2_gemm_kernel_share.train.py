"""gpt2_gemm_kernel_share.train: 100 x the device time inside the range
``gpt2.gemm`` launched under none of the PyTorch matrix-product operators
(``readers.MATMUL_OPS``), over the device time inside the range: 100 when
every GPT-2 product of the step took the hand-written kernel, less where
``torch.matmul`` computed some. A program without the range leaves it out."""

from benchmark import readers

RANGE = ("gpt2.gemm",)


def read(run):
    total = readers.device_ms(run, RANGE)
    if not total:
        return None
    kernel = readers.device_ms(run, RANGE, exclude=readers.MATMUL_OPS) or 0.0
    return 100.0 * kernel / total
