"""moe_expert_kernel_share.moe: 100 x the device time inside the range
``moe.expert.gemm`` (each routed expert's three products, forward and
backward) launched under none of the PyTorch matrix-product operators
(``readers.MATMUL_OPS``), over the device time inside the range: 100 when
every group of rows took the f32 GEMM, less where ``torch.matmul``
computed a group under ``MIN_ROWS``. A program without the range leaves
it out."""

from benchmark import readers

RANGE = ("moe.expert.gemm",)


def read(run):
    total = readers.device_ms(run, RANGE)
    if not total:
        return None
    kernel = readers.device_ms(run, RANGE, exclude=readers.MATMUL_OPS) or 0.0
    return 100.0 * kernel / total
