"""The repo's tools on the port (counterparts of the scripts under
``tools/``), each run as ``python -m vector_quantization_tpu_torch.tools.<name>``
with the JAX tool's arguments, outputs and exit codes, on CUDA unless
``--device cpu``:

- ``tokenize_llamagen``: ten-crop token grids per image in LlamaGen's
  dataset format;
- ``visualize_patches``: a collage of the image patches that map to chosen
  codes;
- ``golden_eval``: convert an upstream checkpoint, graft it, validate and
  diff against a golden metric dict (exit 1 on a miss);
- ``record_published``: record or check the quality anchors of
  ``BASELINE.json["published"]``;
- ``fid`` and ``fidelity``: FID and Inception Score of folders of images;
- ``model_ema``: a checkpoint's EMA shadow as a weights-only checkpoint;
- ``convert_weights`` and ``prepare_checkpoints``: pretrained torch
  checkpoints as state dicts of the port's modules.

``--publish`` (``golden_eval``) and ``--record`` (``record_published``)
write under the work directory, never into ``BASELINE.json``.
"""
