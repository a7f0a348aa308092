"""k1_roofline.export: the nearest-code lookup's least time (2·N·K·D
operations at 989 TFLOP/s or x, the codebook and the codes at 3.35 TB/s,
whichever is larger) over the device time of everything launched inside
its entry, ``ops/vq_lookup.py`` ``nearest_codes``, which traced runs wrap
in the range ``k1``, in %."""

from benchmark import flops, readers

RANGES = {"k1": ("vector_quantization_tpu_torch.ops.vq_lookup", "nearest_codes")}


def read(run):
    calls = run.cell.calls.get("k1", [])
    ms = readers.device_ms(run, ("k1",))
    if not calls or ms is None:
        return None
    least = 0.0
    for (n, d), (k, _) in calls:
        least += flops.least_s(*flops.k1(n, k, d))
    return 100.0 * least / (ms * 1e-3)
