#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Usage: python3 chip_smoke.py [--seed 0] [--requests 48]

Builds the port's CUDA kernels from ``vector_quantization_tpu_torch/csrc``
(one ``nvcc`` per source, all at once; the ``build`` line gives each
source's ptxas register counts; for the flash forward, dK/dV and dQ
kernels at each head dim, their registers, spill bytes, shared memory and
resident blocks per SM at T = 257; for the paged attention's split kernel
per (query, pool, head dim) type, its registers and spills, and at the
serving shape its plan and resident blocks per SM; for the INT8 matmul's
split-K and wide kernels, their registers, spills and static shared
memory, for its ragged kernel per column tile, and at the decode lm head
its plan, dynamic shared memory and blocks per SM; for the lookup kernel per operand types and D variant, and its
prologue, their registers, spills and static shared memory, with the
lookup's dynamic shared memory and resident blocks per SM at the path
shape), then runs these phases, each printing one JSON line; any failure
exits non-zero:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN convolutions
   for the whole run.
2. ``int8_matmul``: the wrapper, under the plan ``ops/int8_matmul.plan``
   picks per shape (printed with the source that ran and, for the wide and
   ragged designs, its dynamic shared memory, blocks per SM and, wide,
   clusters at once), against its plain version at the serving shapes (B =
   64; qkv, o, gate+up, down, lm head of Llama-medium: the lm head on the
   ragged design, its rows not 16-byte aligned), B in {1, 7}, a ragged F
   and x's rows unaligned (D = 100: split-K); max relative error <= 1e-3
   (bf16 inputs, f32 sums in another order). Device times per call (CUDA
   graph replay, weights rotated through enough copies to exceed the 50 MB
   L2) for the kernel, the plain version and a yardstick ``library_ms`` =
   ``torch.matmul(x, w_bf16) * scale`` over a pre-dequantised bf16 weight
   (twice the weight bytes: not the same work); at the lm head also the
   split-K design forced (``split_k_ms``, checked against the plain version
   too); then ``decode_step_mean``, each time's mean per launch over the
   decode step's 97 launches.
3. ``paged_decode_attention``: kernel against its plain version at B = 64,
   H = 16, Dh = 64, ps = 64, L = 24 with random page tables and ragged
   lengths (0 and 1 included), int8 pools (limit 1e-4) and bf16 pools
   (limit 2e-3), abs error over max(1, max|ref|). Device times with the
   layer rotated over all 24, at those lengths and at the decode step's own
   (phase 4's positions + 1), each with its bound; ``library_ms`` =
   ``F.scaled_dot_product_attention`` over an already gathered, dequantised
   bf16 dense cache.
4. ``decode_step``: one full-width Llama-medium decode step (24 layers, 16
   heads, hidden 1024, ffn 2816, vocab 17385; bf16, INT8 weights, fused
   qkv, INT8 paged pool, B = 64) on the same inputs twice, through the
   kernels and through the plain versions. Each block, fed the kernel
   path's own input, agrees within max|diff| <= 1e-2 * max|out| (a couple
   of bf16 steps); the logits, after 24 layers of bf16 rounding that
   amplify the kernels' ~3e-7 summation-order differences, within
   max|diff| <= 5e-2 * max|ref|, with >= 90% of rows' argmax equal.
5. ``serving``: ``ARServer`` at that width (weights made from ``--seed``
   with numpy), INT8 KV, page size 64, 64 batch rows (32 CFG streams),
   ``steps_per_sync`` 64, alpha 1.75, top-k 600, top-p 0.92, 256 image
   tokens; ``--requests`` requests so slots turn over. Every request must
   finish with 256 codes in [0, 16384), every page must be freed, K3 and
   each K2 kernel that a serving shape's plan names must have launched (the
   lm head's on the ragged design, split-K not at all), and no plain
   version may have run on a CUDA tensor.
6. ``dense_vs_paged``: the model of phase 4 fed the same 127 prior steps of
   the same tokens (B = 64) through the dense INT8 cache (scalar offset,
   einsum attention) and the paged INT8 pool (K3); the 128th step's logits
   within 5e-2 * max|ref| of the pool's, >= 90% of rows' argmax equal, 24
   K3 launches a step, no plain version on the card. Then K2 against its
   plain version (max relative error <= 1e-3) and timed as in phase 2 at
   the dense path's new shapes: generate()'s gate/up (64, 1024, 2816), and
   the INT8 prefill's and cache-free forward's 8256 rows (64 x 129) at the
   fused model's five widths (qkv, o, gate+up, down, lm head: the tiled
   design) and the unfused gate/up's (8256, 1024, 2816), each also timed
   under the split-K design (``split_k_ms``); then ``int8_prefill_k2``, the
   five shapes' times summed over a fused prefill's 97 launches against
   the sum of their bounds.
6a. ``int8_prefill``: generate()'s prefill, ``transformer(prefix,
   cache)``, of a (64, 129) prefix (random tokens from ``--seed``) on
   phase 4's model into an INT8 dense cache, through the kernels and
   through the plain versions: the logits within 5e-2 * max|ref|, >= 90%
   of rows' argmax equal, exactly 97 K2 launches, all of the tiled design,
   no plain version on the card. Then K2's device time in the prefill
   (torch.profiler) under the shipped plans and with every call forced to
   split-K, each beside the 97 launches' bound.
7. ``serving_dense``: ``ARServer()`` with its default engine (dense cache,
   shared column) at bench.py's serving recipe: phase 4's model, 64 rows =
   32 CFG streams, alpha 1.75, top-k 600, top-p 0.92, INT8 KV,
   ``steps_per_sync`` 128 in ``sync_chunk``s of 64, 256 image tokens. Two
   arrival patterns on one server: ``--requests`` up front (aligned), and
   16 up front then 16 more after each sync (staggered). Every request
   finishes with 256 codes in range, the shared column stays within its
   cap, each K2 kernel of phase 5 launches (split-K not), no plain version on the card;
   effective tokens/s, images/min and the efficiency report per pattern.
7a. ``serving_w8a8``: Llama-medium INT8 (phase 4's weights, fused) with
   ``quantize_mode="w8a8"``: activations quantised per row to int8 and
   every projection and the head an int8 x int8 -> int32 ``torch._int_mm``
   (cuBLASLt; JAX computes this product with XLA, no Pallas kernel), the
   weight padded to a multiple of 16 and laid out column-major once. Each
   product exact against its int32 plain version at the fused projections'
   shapes, the head's F = 17385 (padded to 17392) and 7 rows (padded to
   17), timed beside K2 at the same shape; one decode step on phase 4's
   inputs against the same step through the plain versions (each block
   1e-2 of max|out| as in decode_step; the logits 1e-1 of max|ref|, twice
   decode_step's: the activations' int8 rounding amplifies K3's bf16
   summation-order differences; argmax 0.9) and
   against the weight-only model's step (the quantisation's error:
   relative L2 <= 0.25, argmax >= 0.5; and block 0's update alone); then
   ``ARServer(paged=True)`` serving 16 requests: K3 24 and ``_int_mm`` 97
   a decode step, **K2 0**, every request 256 codes in range, every page
   freed, no plain version on the card.
8. ``generate``: ``generate()`` as bench.py's ar section runs it: Llama-
   medium bf16 with INT8 weights, unfused (7 K2 launches a layer and the
   head: 169 a forward), B = 64 rows of class 0, 256 tokens, INT8 dense
   cache grown 32 columns a segment, top-k 600, top-p 0.92. Codes (64,
   256) in range, K2 launched 257 x 169 = 43,433 times in one call (the
   prefill and 256 steps; the head's 257 on the ragged design, none on
   split-K), no plain version on the card; tokens/s over the
   median of 3 timed calls after the first.
9. ``vq_lookup``: the nearest-code kernel (TF32 wgmma, an f32 operand
   split in two) against its plain version at the tokenizer's shape N = K
   = 16384, D = 8 (f32 and bf16, Gaussian rows; f32 unit rows, what the
   LlamaGen quantizer feeds), the VQGAN train step's 3072 x 16384 x 8 (f32
   unit rows), VQ-KD's 12544 x 8192 x 32 (cosine, and l2 as its lazy
   k-means init looks up; unit rows), Cluster's 12544 x 8192 x 768 (f32,
   x streamed through the ring), the flagship D = 256, the StyleGAN2
   VQGAN's and CVQ-VAE's 3072 x 8192 x 256 (l2 and cosine), the linear
   probe's 16384 x 8192 x 256 (l2), a ragged
   1000 x 777 x 40 (cosine), N = 1, and planted exact ties (duplicated codebook rows,
   f32 and bf16). Codes may differ only as near-ties (both codes' plain
   scores within 1e-5 * max|score| of the row's best: TF32 parts and f32
   sums in another order); planted ties go to the lowest index exactly.
   Each row carries the launch plan ``ops/vq_lookup.plan`` picked. Device
   times (CUDA graph, each case with its metric) at the path shapes and
   the flagship, each beside its two bounds (``bound_ms``: this design's on the TF32 tensor cores;
   ``bound_f32_cuda_cores_ms``: the same products on the f32 pipes), the
   kernels one call launches (torch.profiler) and ``library_ms`` =
   ``argmin(addmm(esq/2, x, e^T, alpha=-1))``, which writes and reads the
   N x K matrix (not the same work).
10. ``tokenizer``: the LlamaGen VQGAN (configs/llamagen/vqgan_imagenet_ddp.py,
   built through the port's config loader and registry; 69,593,227
   parameters, weights made from ``--seed`` with numpy in the flax layout
   and loaded through the bridge), f32. 64 images of 256 px: encode_to_quant
   -> (64, 16, 16) codes through the kernel, the same features again
   through the plain lookup (codes agree, near-ties aside),
   decode_from_quant -> (64, 256, 256, 3), and the full forward on 8 images.
   Encode and decode images/s on the host clock (after a warm-up pass of
   the same batch), and the convolutions' and Linears' FLOPs per image.
11. ``class_to_image``: the code grids of the requests that phase 5 served
   -> decode_from_quant -> pixel_decode -> uint8 (requests, 256, 256, 3).
12. ``vqgan_train``: ``VQGANAlgorithm`` from configs/llamagen/vqgan_imagenet_ddp.py
   through the port's config loader and registry, at full width, f32
   (cuDNN's TF32 off, as for the whole run): the 69,593,227-parameter
   generator (weights made from ``--seed`` in the flax layout), the
   16384 x 8 spherical codebook re-normalised after each update, the
   PatchGAN discriminator (width 64, depth 3) and LPIPS at random init (no
   weights are in the repository), recon ``l1`` + ``lpips``, Adam (0.5,
   0.9) at 1e-4 for both, ``aglw_gain`` 0.8, ``discriminator_start``
   20,000. Batch 12 (the config's 96 over its 8-way data parallelism) of
   random 256 px images from ``--seed``: 3 steps from step 0 (recon +
   quantizer only) and 3 with the state's step set to 20,000 (the GAN
   term, the adaptive weight and the discriminator's phase on). Gates:
   losses and ``aglw`` finite; every generator tensor moved in both
   parts; the discriminator's weights and BatchNorm statistics unchanged
   in the first part and all moved in the second; codebook rows of unit
   norm after each step (within 1e-5 + 1e-12 / 2n², n the smallest row
   norm before the step: normalize's epsilon; the random init's rows have
   n² ~ 1e-8); K1 launched once per step and no
   plain version on the card; then the step's features looked up by the
   kernel and by the plain version (codes equal except near-ties). Median
   step ms on the host clock per part, images/s, peak GiB.
12a. ``hybrid_train``: ``VQGANVQKDAlgorithm`` at full width (no shipped
   config names it; ``hybrid_config()``): phase 12's trainer with the model
   a ``VQGANVQKDModel`` whose branch is configs/vqkd's ``ViTDecoder``
   (depth 3, 32 -> 512 features) on the 16 x 16 code grid behind a 1x1
   ``ConvConnector`` (22,470,944 parameters), distilling the frozen CLIP
   ViT-B/16 teacher (projection 512, random init) at 224 px, its 14 x 14
   map resized to 16 x 16; the codebook update is the config's own
   ``normalize``. Batch 12 of random 256 px images: 3 steps gates off, 3
   from ``discriminator_start``. Gates: finite losses, ``loss_distill`` >
   0; every generator tensor and every branch tensor moved; the
   discriminator only with the GAN on; the teacher bit-identical; K1 once
   a step and its codes against the plain lookup at (3072, 16384, 8); no
   plain version on the card. Step ms per part, peak GiB.
13. ``vqgan_anchor``: configs/regression/train_anchor.py as it defines it:
   2000 steps at batch 16 on the port's ``SyntheticDataset`` (128 images of
   32 px, shuffled each epoch), seed 3407, the discriminator from step
   1500; then the validator's six metrics on its 32-image split, beside
   BASELINE.json's ``self_trained_2k``. Gate: PSNR >= 15 (the anchor's own
   bar; the RNG and data order differ from the JAX run's, so a band, not
   bits). The phase's wall time.
14. ``vqkd_train``: ``VQKDAlgorithm`` from configs/vqkd/clip_8192_imagenet_ddp.py
   through the port's config loader and registry, at full width, f32
   (TF32 off): the ViT-B/16 encoder (768 wide, 12 blocks, 224 px ->
   (B, 14, 14, 32)), the 8192 x 32 cosine codebook (normalised inputs,
   commitment loss), the 1x1 conv connector, the 3-block ViT decoder to
   512 features, and the frozen CLIP ViT-B/16 teacher (quick-GELU,
   ``ln_pre``, 512 projection), all at their own random init under
   ``--seed`` (no weights are in the repository); AdamW 2e-4 with the
   config's cosine warm-up and weight decay 1e-4, the codebook excluded;
   EMA k-means (decay 0.99) after each step and the lazy k-means init (10
   iterations) on the first. Batch 64 (bench.py's vqkd_224px per chip) of
   random uint8 images from ``--seed``: 1 + 3 steps, then one
   ``eval_step`` with the validator's metrics (usage, PPL, ``LossMetric``
   on ``loss_cosine``). Gates: K1 launched 11 times on the first step (the
   init's 10 lookups, l2 on unit rows, and the step's) and once on each
   other step and on eval; no plain version on the card; the teacher's
   tensors bit-identical after the steps; every codebook row of unit norm
   (within 1e-5) after each step; the codebook moved; finite losses and
   metrics; the step's features looked up by the kernel and by the plain
   version (codes equal except near-ties). Median step ms on the host
   clock (steps 2-4; the first, with the init, apart), images/s, the
   step's GFLOP per image (``torch.utils.flop_counter`` on the forwards)
   and the rate it implies, peak GiB.
15. ``cluster_train``: ``ClusterAlgorithm`` from
   configs/cluster/clip_8192_imagenet_ddp.py likewise: the CLIP ViT-B/16
   teacher without projection (``ln_post`` on) as ``ClusterEncoder``,
   excluded from Adam (1e-4), the 8192 x 768 l2 codebook with the codebook
   loss, CVQ with the nearest anchors after each step (the squared l2
   distances over the updated codebook, (12544, 8192) f32). Batch 64: 1 +
   3 steps. Gates: K1 once a step, no plain version on the card, the
   encoder's tensors bit-identical, the codebook moved, finite losses, and
   codes against the plain lookup at (12544, 8192, 768).
16. ``flash_attention``: K4-fwd, K4-dkv and K4-dq against their plain
   versions (both backward versions fed the kernel's o and lse), bf16, at
   the path shape (B, T, H, Dh) = (64, 257, 16, 64), ragged T in {1, 63,
   64, 65, 129, 256, 300} (the partial first tile at each length), 705
   (the dK/dV kernel's q/dO tiles stream through its ring), B x H = 1, Dh
   32 and 128; o within 2e-3 of max(1, max|ref|)
   beyond one bf16 step of each element (each version rounds its f32 result
   to bf16 once), lse within 1e-4, dq/dk/dv within 1e-2 of max(1, max|ref|) (at T = 1
   dq and dk are 0 up to rounding), the dQ kernel's di = sum(o dO) within
   1e-5 of max(1, max|ref|) of the plain ``_di`` (f32 sums in another
   order); an f32
   input must be refused. Device times at the path shape, all by CUDA-graph
   replay: the kernels, K4's whole backward (dq, which writes di, then dkv),
   the plain versions, and as ``library_ms`` PyTorch's causal flash
   attention (SDPA pinned to its FLASH_ATTENTION backend): its forward, and
   its backward alone (the aten flash backward on residuals made outside
   the graph); ``sdpa_fwd_bwd_ms`` both together.
16a. ``f32_gemm``: F1 (``ops/f32_gemm.matmul``, the split-TF32 ``wgmma``
   GEMM) at GPT-2 medium's 15 products of a train step at 64 x 257 rows
   (c_attn 1024 -> 3072, c_proj 1024 -> 1024, mlp_fc 1024 -> 4096,
   mlp_proj 4096 -> 1024: forward ``x @ w``, input gradient ``gy @ w.T``,
   weight gradient ``x.T @ gy``; the tied head 1024 -> 17384: ``h @
   wte.T``, ``gy @ wte``, ``gy.T @ h``), each in the layout
   ``Product`` passes, one launch a product. Its error against a float64
   product (max|got - ref| / max|ref|) at most 4x the plain version's
   (``matmul_reference``: ``torch.matmul``, cuBLAS f32) and under 1/50 of
   TF32's (``allow_tf32``). Device times by CUDA-graph replay (the
   prologue and split-K sums included) of the kernel and the plain
   version, beside the bound (3 TF32 products at 495 TFLOP/s), per product
   and summed over the step's 291.
16b. ``deepseek_v3``: F1 on the DeepSeek-V3 prior's path at Moonlight-16B-A3B's
   widths (``benchmark/configs/moonlight_16b_a3b_c2i.json``). Its products
   through ``ops/f32_gemm.matmul`` in the layouts ``Product`` passes for a
   weight used transposed (``x @ w.T``, ``gy @ w``, ``gy.T @ x``): the four
   MLA projections, the router (N 64), the dense layer's and the shared
   experts' stacked gate+up (N 22528, 5632) and down (K 11264, 2816) and the
   head without bias at 16,448 rows, a routed expert's (N 2816, K 1408) at
   groups of 520, 1542 and 3000 rows, and both gradient products of an
   expert fed an expanded gradient (strides 0, 1542 rows: the padded copy);
   each against the plain version and float64 at 16a's gates, one launch
   each. Then a two-layer prior (the dense layer, one MoE layer holding 8 of
   64 experts) forward and backward over 12 x 250 tokens, the held experts'
   groups routed by hand to 3000, 1542, 300, 520, 511, 0, 0 and 0 rows,
   against ``benchmark/reference/deepseek_v3.py`` on the same weights and
   routes: logits and every leaf's gradient within 16a's gates of float64
   (a leaf whose float64 gradient is 0 must read 0), each group's rows
   counted, F1 launched 60 times (20 products, 3 launches each; the counts
   zeroed just before), the two groups under ``MIN_ROWS`` on
   ``torch.matmul`` (4 plain products).
17. ``ar_train``: ``ARAlgorithm`` from configs/llamagen/c2i_medium_imagenet_ddp.py
   with ``transformer.flash=True`` through the port's config loader and
   registry (Llama-medium, bf16 over f32 params, full per-block remat, fused
   CE, AdamW with the config's warm-up schedule, weight decay 0.05, grad
   clip 1.0), weights made from ``--seed`` (non-zero lm head), the tokenizer
   of phase 10: 3 steps on 64 random 256 px images (K1 -> pack -> K4 -> fused
   CE -> AdamW), then 5 on a batch of 128 code grids (median step time,
   tokens/s, model FLOPs from the config over 989 TFLOP/s). Losses finite,
   every transformer parameter changed and no tokenizer parameter, launches
   per step K4-fwd 48 (24 + 24 remat re-runs), dkv 24, dq 24, K1 once per
   image step, no plain version on the card.
17a. ``ar_train_remat_dots``: phase 17's model under ``remat_policy="dots"``
   (selective checkpointing: the projections' ``aten.mm`` outputs kept,
   the rest re-run), full remat and no remat, on the codes batch: the loss
   and every gradient of one pass each (dots against full: losses equal,
   gradients within 1e-6 relative L2), ``aten.mm`` calls in each backward
   (dots equal to no remat's, fewer than full remat's: the backward re-runs
   no product), the peak memory above the resting state (full < dots <
   none); then 3 train steps under each on the host clock. K4-fwd 48,
   dkv 24, dq 24 a dots step.
18. ``ar_flash_vs_einsum``: one step's loss and gradients on 64 rows of the
   codes batch with the same weights through flash and through the einsum
   attention (``flash=False``): loss within 1e-2 relative, every
   parameter's gradient within 5e-2 relative L2 (bf16 attention rounds P at
   other places in the two: before and after normalising). Then the train
   step on those 64 rows with each attention (einsum is what the shipped
   configs/ar/transformers/llama.py runs), median of 3 steps on the host
   clock after a warm-up.
19. ``ar_generate``: class -> image through ``ARAlgorithm.generate_step``
   on phase 17's model and state (CFG as the config sets it, alpha 1.75,
   its top-k 600 / top-p 0.92 sampler), 8 classes, then phase 10's VQGAN
   decoder: images (8, 256, 256, 3), finite; seconds per image.
19a. ``parallel_two_ranks``: two processes spawned on the one card (the
   kernels built above, loaded, not rebuilt), a ``gloo`` group over a file
   store carrying CUDA tensors (all-reduce, broadcast), each rank half of
   every global batch under ``DataParallelStrategy``: a reduced-depth
   LlamaGen VQGAN (one block a level, GAN on: PatchGAN's BatchNorm and the
   adaptive weight over both ranks; 4 images of 256 px) and Llama-medium's
   width at 4 layers with flash (16 code grids), SGD, TF32 off, 2 steps;
   against one process with the whole batches: the update's relative L2
   <= 2e-6 for the f32 VQGAN and <= 3e-2 for the Llama (bf16 activations
   round differently per split), the two ranks' weights bit-equal; K1 once a step, K4
   launched, no plain version on the card.
19b. ``parallel_dp``: under a one-rank NCCL group (torchrun's variables set
   in this process, ``parallel.mesh.init_distributed``; destroyed after),
   ``build_runner`` on overlays of the LlamaGen VQGAN config (batch 12) and
   the VQ-KD config (batch 64 of 224 px) with their ``DataParallelStrategy``,
   2 steps each (host ms per step, synchronised), against the same overlays
   with ``SingleDeviceStrategy`` from the same seed: the first step's loss
   and every gradient the optimizer gets within 1e-5 (of the loss, of the
   model's largest gradient), each step's reported, VQ-KD's k-means
   codebook within 1e-6 after both steps; K1 once a step (VQ-KD: 11 on the
   first, the lazy init's 10 iterations); one more step under
   torch.profiler shows NCCL's all-reduce; no plain version on the card.
19c. ``parallel_fsdp``: phase 17's model and config, its step at 128 x 257
   with flash under ``FSDPStrategy`` over ``{"dp": 1, "fsdp": 1}`` (one-rank
   NCCL group): the loss and every gradient the optimizer gets equal the
   unwrapped step's (limit 1e-5 of max|ref|), K4 48/24/24 a step, the
   profile shows the reduce-scatter and the all-gathers; step ms (median
   of steps 2-3) and peak GiB beside ``ar_train``'s.
19d. ``parallel_tp``: configs/ar/c2i_llama_medium_tp_imagenet.py with tp=1
   (its mesh and ``TPStrategy``), Llama-medium with flash and this script's
   weights: one step's loss and gradients equal the unwrapped step's
   (1e-5), K4 48/24/24, the profile's all-reduce; then
   ``ARServer(strategy=TPStrategy, paged=True)`` at Llama-medium width with
   INT8 weights and KV serving 16 requests against the server without a
   strategy from the same seed: the same tokens, 256 codes in range each,
   every page freed, K2 (the lm head on the ragged design, split-K not) and
   K3 launched, no plain version on the card.
20. ``cli_vqgan``: ``python -m vector_quantization_tpu_torch.cli.train``'s
   ``main`` in this process on an overlay of
   configs/llamagen/vqgan_imagenet_ddp.py written to a temporary directory:
   the full-width LlamaGen VQGAN trainer as phase 12 runs it, its dataset
   replaced by ``SyntheticDataset`` (48 images of 256 px, 1000 classes),
   ``batch_size_in_total`` 12, 4 iterations, checkpoints every 2; then
   ``--auto-resume`` with ``max_iters`` 6. Weights at the config's own
   random init under the runner's seed. Gates: the second run starts at
   step 4 and runs 2; K1 launched once a step in each run; no plain version
   on the card; finite losses; ``checkpoints/iter_{2,4,6}`` written. The
   host ms per step of each run (synchronised at its ends, with and
   without the checkpoint saves, reported beside phase 12's hand-driven
   step, not gated), each save's seconds and each checkpoint's size.
21. ``cli_test_tokenize`` (after ``cli_ar`` and ``cli_fid``): ``cli.test``'s
   ``main`` with ``--load-model-from iter_6`` over the overlay's validator
   (64 synthetic images, 4 batches of 16) with the config's own metrics, FID
   included (random-init Inception, ``fid_path`` = ``cli_fid``'s cache):
   finite metrics, the ``fid_random_init`` tag, K1 once per eval batch; a
   second ``FIDMetric`` whose prediction is the originals themselves gives
   |FID| < 1e-2 against their cache (the JAX package's own test's bound),
   and its statistics (``n``, ``sum``, ``sum_outer``) equal the cache's
   within 1e-5 of max|cache|; the FID summary's host seconds. Then ``cli.tokenize``'s ``main`` over
   the same split: its ``.npz`` codes against the plain lookup's on the same
   images and the checkpoint's weights (equal but near-ties,
   ``codes_vs_plain``'s rule), K1 once per batch, no plain version on the
   card in either run.
22. ``cli_ar``: ``build_runner`` on an overlay of
   configs/llamagen/c2i_medium_imagenet_ddp.py (Llama-medium,
   ``transformer.flash=True``, synthetic 256 px images, batch 64, 3
   iterations, a constant lr of 1e-4 in place of the 10,000-step warm-up,
   whose first lrs of 0, 1e-8, 2e-8 leave the steps near no-ops), then
   ``cli/train.py``'s sequence: ``init_state``, random Llama-medium
   weights made from the seed (non-zero lm head; in place of
   ``--load-model-from``), ``ARAlgorithm.load_ir_from(state, <phase 20's
   iter_6>)``, ``run``. Gates: K4-fwd 48, dkv 24, dq 24 and K1 1 launches
   a step; finite losses, the last below the first; every transformer
   tensor moved; the batches the steps took equal the loader's own for
   the run's epoch; the same three ``train_step``s driven by hand from the
   run's starting weights, fresh moments and the runner's seed, on those
   batches, give the runner's losses within ``CLI_AR_REPLAY_TOL``; no
   plain version on the card; the tokenizer unchanged by ``load_ir_from``
   (the JAX package's merge ignores a VQGAN checkpoint's
   ``generator``/``discriminator`` keys). Host ms per step, and one
   checkpoint's save time and size.
22a. ``cli_fid``: ``cli.fid``'s ``main`` over the CLI validation set
   (``fid_batch_size`` 16: 4 batches), random-init Inception on the card.
   Gates: ``n`` 64, mean and covariance finite, the covariance symmetric
   (1e-12 of its largest entry), the file read back by
   ``FIDStatistics.load``. Inception images/s on the card (64 images of
   256 px after a warm-up), the host seconds of the float64 accumulation.
22b. ``cli_val``: ``cli.val``'s ``main`` over ``cli_vqgan``'s checkpoints
   with ``--max-idle-rounds 1`` (its sleep swapped for a recorder). Gates:
   ``iter_2``, ``iter_4``, ``iter_6`` validated once each, oldest first;
   K1 launched 4 x 3 times; ``iter_6``'s metrics equal ``cli.test``'s
   within 1e-5 relative (1e-3 for FID); every FID finite and tagged; no
   sleep; no plain version on the card. Each summary's host seconds.
22c. ``ar_generation_eval``: configs/ar/generation_eval.py's validator
   (``eval_generate``, ``FIDMetric(pred="generated_image")`` against
   ``cli_fid``'s cache, ``AccuracyMetric``; its visual dumps left out)
   composed over ``cli_ar``'s C2I config with flash, through ``cli.test``
   on ``cli_ar``'s checkpoint: one batch of 8 classes generated and decoded
   to (8, 256, 256, 3). Gates: the images finite, FID finite and tagged,
   accuracy in [0, 1], launches exactly K1 1 (the batch's tokens), K4-fwd
   24 (one forward), K4-dkv, K4-dq, K2 and K3 0; no plain version on the
   card.
22d. ``linear_probe_train``: configs/ic/imagenet_ddp.py (the frozen VQGAN at
   width 128 with an 8192 x 256 codebook, BatchNorm + Linear head, LARS at
   0.1) with ``SyntheticDataset`` (1000 classes, 256 px), batch 64 (the
   config's 512 over 8-way DP): 3 steps through ``cli.train``, then
   ``cli.test`` on ``iter_3``. Gates: K1 once a step and once per eval
   batch, every call at (16384, 8192, 256) l2; the IR bit-identical to its
   initial weights; every head tensor and BatchNorm statistic moved; finite
   losses; accuracy in [0, 1]; no plain version on the card. Host ms a
   step, peak GiB.
22e. ``tools_tokenize_llamagen`` (the tools run as children through
   ``runpy.run_module``, as ``python -m`` runs them, TF32 off as in this
   process, with a wrapper that reports the child's kernel launches, its
   plain versions on the card and the times of its ``encode_to_quant``
   calls): ``tools.tokenize_llamagen``
   on the LlamaGen VQGAN config at full width (the seed's weights) over 8
   synthetic images of 288 px, ``--crop-size 256``. Gates: exit 0 and its
   closing line; ``imagenet256_codes/{i}.npy`` int32 (10, 16, 16) in range
   and ``imagenet256_labels/{i}.npy`` int64 [category] for each image; K1
   once an image, each at (2560, 16384, 8); every image's codes against the
   plain lookup of the same features (the same weights built here), near-
   ties aside; no plain version on the card. Seconds per image in the
   tool's process.
22f. ``tools_fid_folder``: ``tools.fid`` (``--gt``) and ``tools.fidelity``
   (2 splits) over two folders of 256 px PNGs: the export's centre crops and
   their reconstructions from the exported codes. Gates: exit 0, finite
   FID and IS >= 1, each line tagged ``fid_random_init``, ``fid.txt``
   holding the line.
22g. ``tools_golden_eval``: ``tools.golden_eval taming_vqgan`` on a seeded
   synthetic checkpoint in taming's layout at
   configs/vqgan/16384_imagenet_ddp.py's width (``tools/_taming.py``:
   width 128, mults (1, 1, 2, 2, 4), 256-dim, 16384 codes), the config's
   validator on 16 synthetic images in batches of 8. Gates: exit 1 against
   the built-in table (``lpips`` missing, NaN), exit 0 against a
   ``--golden`` of its own measured numbers; the graft ignores exactly
   taming's two connectors (the config's model has none); K1 twice in each
   run; no plain version on the card.
22h. ``tools_record_check``: ``tools.record_published --check`` on
   ``synthetic_taming_vqgan``, ``self_trained_smoke`` and
   ``self_trained_ar`` (``self_trained_2k`` is phase 13's) against
   BASELINE.json: every metric beside its record, delta and tolerance.
   Gates: every row within ``CHECK_TOL`` except ``RECORD_OWN_DRAWS`` (rows
   the port's own weight and CFG draws miss on the CPU as well; printed,
   held by the CPU tests); the exit code agreeing with the rows; K1 825
   (1 + 20 + 2 + 800 + 2), K4 0; no plain version on the card. Its child
   starts after 22e and runs beside 22f, 22g and 22i.
22i. ``tools_model_ema``: ``cli.train`` on the ``cli_vqgan`` overlay with
   ``ema_decay`` 0.999, batch 4, 2 steps; ``tools.model_ema`` on
   ``iter_2``; ``--load-model-from`` the result into a fresh validator.
   Gates: every generator tensor equal to the checkpoint's
   ``extra["ema_params"]`` (which differs from its ``params``); K1 once a
   step; no plain version on the card. Then ``tools``: the five phases'
   wall seconds.
23. ``fsq_train``: ``ReconstructionAlgorithm`` from
   configs/fsq/8000_imagenet_ddp.py (VQGAN width 128, levels (8, 8, 5, 5,
   5), 8000 codes, L1 + MSE, Adam 1e-4), f32, the weights made from
   ``--seed``: 3 steps at batch 12 of random 256 px images, then encode and
   decode the batch. Gates: finite losses; every tensor moved; codes
   (12, 16, 16) in [0, 8000); ``decode_from_quant(codes)`` equal to the
   decoder on the forward's ``z`` (within 1e-5 of max|ref|); **K1 launched
   0 times** (FSQ rounds, it looks nothing up); no plain version on the
   card. Step ms, images/s, encode and decode images/s.
24. ``vqgan_stylegan2_train``: configs/vqgan/8192_stylegan2_imagenet_ddp.py
   (the VQGAN with an 8192 x 256 l2 codebook, LPIPS, the StyleGAN2
   discriminator at 256 px, 28,864,129 parameters; ``discriminator_start``
   0, so the GAN, the adaptive weight and the discriminator's phase run
   from the first step): 3 steps at batch 12. Gates: finite losses, K1
   once a step and its codes against the plain lookup at (3072, 8192,
   256); every generator tensor moved, and every discriminator tensor but
   at most ``fc2.bias`` (the hinge loss gives the logit's bias (#fake −
   #real logits inside (−1, 1)) / B, exactly 0 while every logit lies
   inside); ``d_batch_stats`` empty (no BatchNorm); no plain version on
   the card.
25. ``cvq_anchors_train``: configs/cvqvae/8192_dd2_aglwg075_imagenet_ddp.py
   (the VQGAN recipe with a cosine 8192 x 256 codebook, PatchGAN depth 2,
   CVQ after each step) with ``anchor="cached"``: 3 steps at batch 12,
   then one with ``"multinomial"`` and one with ``"random"``. Each step's
   anchors are read as the update draws them: every row a row of its pool
   (the 3072 features and, for ``cached``, the 8192 previous anchors; for
   ``random``, short of K features, the features in order and then noise
   in [0, 1)); the cache equals the step's anchors and changes every
   step. K1 once a step (cosine), its codes against the plain lookup;
   finite losses; no plain version on the card.
26. ``vqkd_convnext_train``: phase 14 on configs/vqkd/
   convnext_8192_imagenet_ddp.py: the ConvNeXt-B teacher (depths 3/3/27/3,
   widths 128-1024, 87,564,416 parameters) whose 7 x 7 map the bicubic
   resize takes to 14 x 14, the decoder to 1024 features; the same gates
   (K1 11, 1, 1, 1 and once at eval), and the teacher's features (64,
   196, 1024) finite.
27. ``ar_gpt2``: ``ARAlgorithm`` from configs/ar/c2i_gpt2_medium_imagenet_ddp.py
   (GPT-2 medium: 24 x 1024, 16 heads, f32, no remat, vocab 17384, the
   dense head and next-token CE, AdamW; a constant lr of 1e-4 in place of
   the warm-up), the transformer at its own init under ``--seed``, the
   tokenizer of phase 10: 3 steps on 64 random 256 px images; the cached
   decode (f32 cache, a 1-token prefill and 32 steps) against the full
   forward's logits (within 1e-4 of max|ref|); ``generate_step`` for 8
   classes -> (8, 256, 256, 3) finite; a dense ``ARServer`` (the per-row
   scatter: learned positions) serving 16 requests, each 256 codes in
   range. Gates also: K1 once a step, **K4 launched 0 times** (JAX's GPT-2
   reaches no Pallas kernel), the f32 GEMM 291 times a step (its products;
   as many prologue launches, and none outside the train steps: the decode,
   generate and serving rows stay on torch.matmul), every tensor moved, no
   plain version on the card. Step ms, tokens/s, generate and serving
   tokens/s.
28. ``decode_profile``: the decode step of phase 4 on the host clock and,
   under torch.profiler, its device time; their ratio gives the device's
   idle share (run last: the profiler slows later host dispatch); also its
   device time with the lm head launched under split-K, in the same call,
   and from the same traces the head's own device time per step: the
   ragged kernel's, and split-K's kernel plus the zero fill it adds (gate:
   each of the two runs once a step, split-K not in the shipped step).
29. ``generate_profile``: one decode step of phase 8 at its midpoint (a
   129-column INT8 cache) on the host clock and under torch.profiler:
   device ms, idle share, K2's share.
30. ``tokenizer_profile``: one encode + decode of the 64 images of phase 10
   under torch.profiler: device time by kernel and the idle share.
31. ``ar_train_profile``: one codes train step under torch.profiler:
   device time by kernel and the idle share.
32. ``vqgan_train_profile``: one GAN-on step of phase 12 under
   torch.profiler: device ms (the kernels' sum), busy ms (the union of
   their intervals: cuDNN's FFT convolutions overlap), the idle share of
   the host clock from the busy time, and the shares of cuDNN's
   convolutions, the elementwise passes, the GEMMs and K1.
33. ``vqkd_train_profile``, 34. ``cluster_train_profile``: one step of
   phases 14 and 15 under torch.profiler, as phase 32 (their kernels by
   family: K1, SDPA's attention kernels, cuBLAS's GEMMs, elementwise,
   reductions).
35. ``fsq_train_profile``, ``vqgan_stylegan2_train_profile``,
   ``vqkd_convnext_train_profile``, ``ar_gpt2_profile``: one step of
   phases 23, 24, 26 and 27 under torch.profiler, as phase 32.
35a. ``hybrid_train_profile``: one GAN-on step of phase 12a, as phase 32.
36. ``kernels``: per kernel, launches in its path's run (phase 5 for the
   server's: K2's kernels that the serving shapes' plans name, and K3;
   phase 10 for the lookup (and its launches in phases 12, 14, 15, 17,
   20-22d and 23-27, and its times at the train shapes, the zoo's
   (3072, 8192, 256) l2 and cosine and the probe's (16384, 8192, 256) l2),
   phase 17 for the three flash kernels (and their launches in phases 22
   and 22c), and K1 in phase 12a, K3 (and K2's 0) in phase 7a and K4 in
   phase 17a, and their launches in phases 19a-19d and K1's in 22e-22i; K2's
   rows also give their launches in phases 7, 8 and 22c, and phase 6's times
   at the dense path's shapes; the ragged kernel's also ``split_k_ms``, and
   split-K's row, which no path's plan names, is split-K forced at the lm
   head, launches 0), device time per call, the bound, the plain
   version's and the yardstick's time; F1's row (phase 16a) gives its
   times summed over a GPT-2 step's 291 products and its launches in phase
   27 and, under ``deepseek_v3``, in phase 16b.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # float32 outside the tensor cores
INT8_OPS = 1979e12  # dense tensor-core int8
CSRC = "vector_quantization_tpu_torch/csrc"  # the kernels' sources, from the repo's root

# Llama-medium C2I (configs/ar/transformers/llama.py, bench.py serving recipe)
NUM_CATEGORIES, CODEBOOK = 1000, 16384
MEDIUM = dict(hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=2816)
VOCAB = NUM_CATEGORIES + 1 + CODEBOOK
SLOTS, IMAGE_TOKENS, STEPS_PER_SYNC, PAGE_SIZE = 64, 256, 64, 64
P_SLOT = -(-(IMAGE_TOKENS + STEPS_PER_SYNC) // PAGE_SIZE)  # 5 pages per row
# the dense server's recipe (bench.py serving_bench): 128 steps a sync in chunks of 64
DENSE_STEPS_PER_SYNC, SYNC_CHUNK = 128, 64
MEDIUM_MAX_LENGTH = 1 + IMAGE_TOKENS + DENSE_STEPS_PER_SYNC
SAMPLER = {"temperature": 1.0, "top_k": 600, "top_p": 0.92}
# generate() as bench.py's ar section runs it: Llama-medium INT8, unfused, B = 64
GEN_BATCH, GEN_SEGMENT = 64, 32
PREFILL_ROWS = GEN_BATCH * 129  # half_generate_step's prefix: 32 CFG pairs x (class + 128 codes)
GEN_K2_PER_FORWARD = 7 * MEDIUM["num_layers"] + 1  # q, k, v, o, gate, up, down per layer + head
# the LlamaGen VQGAN tokenizer: f16 at 256 px, 16384 x 8 codebook
VQGAN_CONFIG = "configs/llamagen/vqgan_imagenet_ddp.py"
VQGAN_PARAMS, IMAGE_SIZE, GRID, TOKENIZER_BATCH = 69_593_227, 256, 16, 64
# its training: batch_size_in_total 96 over the config's 8-way data parallelism
VQGAN_TRAIN_BATCH, VQGAN_TRAIN_STEPS, VQGAN_D_START = 12, 3, 20_000
CODEBOOK_NORM_LIMIT = 1e-5  # |row norm - n / sqrt(n² + 1e-12)|, n its norm before normalize
# the 2k-step regression anchor (BASELINE.json "self_trained_2k")
ANCHOR_CONFIG, ANCHOR_SEED, ANCHOR_PSNR_BAR = "configs/regression/train_anchor.py", 3407, 15.0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# K2's kernels by their sources' names: split-K and the design that took
# the decode lm head (rows not 16-byte aligned) from it
K2_SPLIT_K, K2_HEAD = "int8_matmul", "int8_matmul_ragged"


def zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0 (before a path's run)."""
    from vector_quantization_tpu_torch.ops import flash_attention as fa
    from vector_quantization_tpu_torch.ops.f32_gemm import matmul
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul, int8_mm
    from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention
    from vector_quantization_tpu_torch.ops.vq_lookup import nearest_codes

    int8_matmul.launches = paged_decode_attention.launches = nearest_codes.launches = int8_mm.calls = 0
    matmul.launches = matmul.split_launches = 0
    int8_matmul.design_launches = dict.fromkeys(int8_matmul.design_launches, 0)
    fa.flash_attention_fwd.launches = fa.flash_bwd_dkv.launches = fa.flash_bwd_dq.launches = 0


def read_launches() -> tuple[dict, int]:
    """Every kernel's launch count (``int8_matmul`` is K2's split-K kernel,
    ``int8_matmul_wide``, ``int8_matmul_tiled`` and ``int8_matmul_ragged``
    its other kernels, all behind one wrapper; ``f32_gemm`` the f32 GEMM's
    product kernel, ``f32_gemm_split`` its prologue), the
    w8a8 path's ``torch._int_mm`` calls (``int8_mm``: a library call, no
    kernel of the repo), and the number of times any plain version ran on a
    CUDA tensor so far."""
    from vector_quantization_tpu_torch.ops import flash_attention as fa
    from vector_quantization_tpu_torch.ops.f32_gemm import matmul
    from vector_quantization_tpu_torch.ops.int8_matmul import (
        DESIGNS, int8_matmul, int8_matmul_reference, int8_mm, int8_mm_reference,
    )
    from vector_quantization_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
    )
    from vector_quantization_tpu_torch.ops.vq_lookup import nearest_codes, nearest_codes_reference

    launches = {**{source: int8_matmul.design_launches[design]
                   for design, (source, _) in DESIGNS.items()},
                "paged_decode_attention": paged_decode_attention.launches,
                "nearest_codes": nearest_codes.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "f32_gemm": matmul.launches,
                "f32_gemm_split": matmul.split_launches,
                "int8_mm": int8_mm.calls}
    plain = (int8_matmul_reference.cuda_calls + int8_mm_reference.cuda_calls
             + paged_decode_attention_reference.cuda_calls
             + nearest_codes_reference.cuda_calls + fa.flash_attention_reference.cuda_calls
             + fa.flash_attention_bwd_reference.cuda_calls)
    return launches, plain


def graph_ms(calls, replays: int = 10) -> float:
    """Device milliseconds per call: ``calls`` (a list of thunks) captured
    once into a CUDA graph, replayed ``replays`` times between CUDA
    events. Host overhead of the Python wrappers is out of the number."""
    for c in calls:  # eager warm-up: builds, allocations
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (replays * len(calls))


def phase_device() -> tuple[str, dict]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })
    return smi, {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": torch.cuda.device_count()}


_MANGLED_TYPES = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}


def ptxas_entries(log: str, kernel: str, params: tuple[str, ...] = ("dh",)) -> dict:
    """Registers, static shared memory and spill bytes that ``nvcc -Xptxas -v``
    reports for each instantiation of ``kernel``, keyed by its template
    arguments named by ``params`` ("dh64" for the flash kernels' head dim;
    "qbf16_kvint8_dh64" for the paged attention's query type, pool type and
    head dim; the kernel's own name when ``params`` is empty, for a kernel
    that is not a template)."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(kernel + r"I(.*?)EEv", m.group(1))
            key = kernel if kernel in m.group(1) and not params else None
            if k and params:
                vals = []  # a repeated type is a back-reference (S_, S0_, ...) to the last one
                for n, t, _ in re.findall(r"L[ib](\d+)E|(13__nv_bfloat16|[fa])(?=L|13|S|[fa]|E)|(S\d*_)",
                                            k.group(1) + "E"):
                    vals.append(n or (_MANGLED_TYPES[t] if t else vals[-1]))
                key = "_".join(f"{p}{v}" for p, v in zip(params, vals))
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.setdefault(key, {}).update(registers=int(m.group(1)),
                                           static_smem=int(smem.group(1)) if smem else 0)
    return out


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Resident blocks per SM of an H100 for a kernel's registers per thread,
    threads per block and shared memory per block (65,536 registers
    allocated 256 to a warp, 2,048 threads, 32 blocks, 233,472 bytes of
    shared memory with 1,024 reserved per block)."""
    warp_regs = -(-registers * 32 // 256) * 256
    by_regs = 65536 // warp_regs // (threads // 32)
    return min(32, 2048 // threads, by_regs, 233472 // (smem + 1024))


def phase_build() -> None:
    from vector_quantization_tpu_torch.ops import _build
    from vector_quantization_tpu_torch.ops import flash_attention as fa
    from vector_quantization_tpu_torch.ops import int8_matmul as im
    from vector_quantization_tpu_torch.ops import paged_attention as pa
    from vector_quantization_tpu_torch.ops import vq_lookup as vqk

    t0 = time.perf_counter()
    logs = _build.build_all()
    regs = {
        name: sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln})
        for name, log in logs.items()
    }
    fwd = ptxas_entries(logs["flash_attention"], "flash_fwd_kernel")
    for dh, entry in fwd.items():
        entry.update(fa.flash_fwd_plan(SEQ, int(dh[2:])))
    dkv = ptxas_entries(logs["flash_attention"], "flash_bwd_dkv_kernel")
    for dh, entry in dkv.items():
        entry.update(fa.flash_bwd_dkv_plan(SEQ, int(dh[2:])))
    dq = ptxas_entries(logs["flash_attention"], "flash_bwd_dq_kernel")
    for dh, entry in dq.items():
        entry.update(fa.flash_bwd_dq_plan(SEQ, int(dh[2:])))
    paged = ptxas_entries(logs["paged_attention"], "paged_split_kernel", ("q", "kv", "dh"))
    plan = pa.decode_plan(SLOTS, MEDIUM["num_heads"], 64, P_SLOT, PAGE_SIZE, torch.int8,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    paged_path = {**paged.get("qbf16_kvint8_dh64", {}), **plan._asdict(),
                  "blocks_per_sm": pa.decode_occupancy(plan, torch.bfloat16, torch.int8, 64)}
    mm = {kernel: entry for source, kernel in im.DESIGNS.values()
          for entry in ptxas_entries(logs[source], kernel, ()).values()}
    vq = ptxas_entries(logs["vq_lookup"], "nearest_tc_kernel", ("x", "e", "reg"))
    vq_prep = ptxas_entries(logs["vq_lookup"], "prep_kernel", ("x", "e"))
    gpu = im.card(torch.device("cuda", 0))
    for key, entry in vq.items():  # the plan and resident blocks at the path shape, this key's types
        x_bf16, e_bf16, reg = key.startswith("xbf16"), "_ebf16" in key, key.endswith("reg1")
        d = 8 if reg else 256
        p = vqk.plan(TOKENIZER_BATCH * GRID * GRID, CODEBOOK, d, x_bf16, e_bf16, gpu)
        entry.update(at_d=d, smem_bytes=p.smem_bytes, blocks_per_sm=vqk.blocks_per_sm(p, x_bf16, e_bf16))
    if "w8a16_kernel" in mm:
        split = mm["w8a16_kernel"]
        split["blocks_per_sm"] = blocks_per_sm(split["registers"], 256, split["static_smem"])
    if "w8a16_tiled_kernel" in mm:
        mm["w8a16_tiled_kernel"].update(im.occupancy(im.tiled_plan(PREFILL_ROWS, 1024, 1024), 0, 0, 0))
    # the ragged kernel per column tile (U = 8, 9: 128 and 144 columns), and
    # its plan at the decode lm head with its shared memory and blocks per SM
    ragged = ptxas_entries(logs["int8_matmul_ragged"], "w8a16_ragged_kernel", ("u",))
    head = im.plan(SLOTS, MEDIUM["hidden_size"], VOCAB, gpu, True, VOCAB % 16 == 0)
    mm["w8a16_ragged_kernel"] = {**{f"n{16 * int(k[1:])}": e for k, e in ragged.items()},
                                 "at_lm_head": {**head._asdict(), **(im.occupancy(head, 0, 0, 0)
                                                                     if head.design == "ragged" else {})}}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": sorted(logs), "ptxas": regs, "flash_fwd_at_t257": fwd,
          "flash_bwd_dkv_at_t257": dkv, "flash_bwd_dq_at_t257": dq, "paged_attention": paged,
          "paged_attention_at_path": paged_path, "int8_matmul": mm,
          "vq_lookup": vq, "vq_lookup_prologue": vq_prep})
    if (not fwd or not dkv or not dq or "registers" not in paged_path or len(vq) != 8
            or len(vq_prep) != 4 or len(ragged) != 2
            or {kernel for _, kernel in im.DESIGNS.values()} - set(mm)):
        raise SystemExit("build: a kernel's entry is missing from the ptxas log")


def serving_matmuls() -> list[tuple[str, int, int, int, int]]:
    """The decode step's INT8 matmuls: (name, B, D, F, launches per step)."""
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
    return [("qkv", SLOTS, d, 3 * d, 24), ("o", SLOTS, d, d, 24),
            ("gateup", SLOTS, d, 2 * f, 24), ("down", SLOTS, f, d, 24),
            ("lm_head", SLOTS, d, VOCAB, 1)]


def phase_int8_matmul(dev, gen) -> list[dict]:
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    d = MEDIUM["hidden_size"]
    extra = [("b1_qkv", 1, d, 3 * d, 0), ("b7_lm_head", 7, d, VOCAB, 0),
             ("ragged", 5, 1000, 777, 0), ("x_unaligned", 5, 100, 37, 0)]
    rows = []
    for name, b, dd, ff, per_step in serving_matmuls() + extra:
        x = torch.randn((b, dd), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (dd, ff), generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand((ff,), generator=gen, device=dev) * 0.02 + 1e-3
        p = im.plan_for(x, w)
        got = im.int8_matmul(x, w, s)
        want = im.int8_matmul_reference(x, w, s)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        row = {"phase": "int8_matmul", "shape": name, "B": b, "D": dd, "F": ff,
               "plan": p._asdict(), "source": f"{CSRC}/{p.source}.cu",
               **(im.occupancy(p, b, dd, ff) if p.design in ("wide", "ragged") else {}),
               "max_abs_err": abs_err, "max_rel_err": rel_err, "limit": 1e-3}
        if rel_err > 1e-3 or not torch.isfinite(got).all():
            emit(row)
            raise SystemExit(f"int8_matmul {name}: max_rel_err {rel_err} > 1e-3")
        if per_step:
            copies = -(-150_000_000 // (dd * ff))  # > 50 MB L2 per rotation
            ws = [w] + [torch.randint(-127, 128, (dd, ff), generator=gen, device=dev,
                                      dtype=torch.int8) for _ in range(copies - 1)]
            wb = [wi.to(torch.bfloat16) for wi in ws]
            byts = dd * ff + b * dd * 2 + ff * 4 + b * ff * 4
            ops = 2 * b * dd * ff
            row.update({
                "launches_per_step": per_step, "weight_copies": copies,
                "ms": graph_ms([lambda wi=wi: im.int8_matmul(x, wi, s) for wi in ws]),
                "plain_ms": graph_ms([lambda wi=wi: im.int8_matmul_reference(x, wi, s)
                                      for wi in ws]),
                "library_ms": graph_ms([lambda wi=wi: torch.matmul(x, wi) * s for wi in wb]),
                "bytes": byts, "ops": ops,
                "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, ops / BF16_FLOPS),
            })
            if name == "lm_head":  # the split-K design forced at the head, in this call
                t_sk = time.perf_counter()
                sk = im.split_k_plan(b, dd, ff, im.card(dev).sms)
                got = im._launch(x, w, s, sk)
                torch.cuda.synchronize()
                row["split_k_max_abs_err"] = float((got - want).abs().max())
                if row["split_k_max_abs_err"] > 1e-3 * float(want.abs().max()):
                    emit(row)
                    raise SystemExit("int8_matmul lm_head: split-K disagrees with the plain version")
                row["split_k_ms"] = graph_ms([lambda wi=wi: im._launch(x, wi, s, sk) for wi in ws])
                row["split_k_seconds"] = time.perf_counter() - t_sk
            rows.append(row)
            del ws, wb
        emit(row)

    def per_launch(rs, key):
        return sum(r[key] * r["launches_per_step"] for r in rs) / sum(
            r["launches_per_step"] for r in rs)

    # K2 as a whole: one decode step's 97 launches, each shape under its plan
    emit({"phase": "int8_matmul", "shape": "decode_step_mean",
          "launches_per_step": sum(r["launches_per_step"] for r in rows),
          **{k: per_launch(rows, k) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}})
    kernels = []
    for design, (source, _) in im.DESIGNS.items():
        mine = [r for r in rows if r["plan"]["design"] == design]
        if not mine:
            continue
        kernels.append({
            "name": source, "design": design, "route": "cuda", "source": f"{CSRC}/{source}.cu",
            "replaces": "vector_quantization_tpu/ops/int8_matmul.py:54",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_launch(mine, "ms"), "plain_ms": per_launch(mine, "plain_ms"),
            "bound_ms": per_launch(mine, "bound_ms"), "bound_by": "bytes",
            "library_ms": per_launch(mine, "library_ms"),
            **({"split_k_ms": per_launch(mine, "split_k_ms")}
               if all("split_k_ms" in r for r in mine) else {}),
            "note": "mean per launch over the decode step's launches of this kernel: "
                    + ", ".join(f"{r['launches_per_step']}x {r['shape']}" for r in mine),
        })
    # no serving shape is planned on split-K since the ragged design took the
    # head: its entry is split-K forced at the head in this call (launches 0
    # on every path: plan() sends it only an x whose rows are not 16-byte
    # aligned)
    head = next(r for r in rows if r["shape"] == "lm_head")
    if all(k["design"] != "split_k" for k in kernels) and "split_k_ms" in head:
        kernels.append({
            "name": K2_SPLIT_K, "design": "split_k", "route": "cuda",
            "source": f"{CSRC}/{K2_SPLIT_K}.cu", "replaces": "vector_quantization_tpu/ops/int8_matmul.py:54",
            "max_abs_err": head["split_k_max_abs_err"], "ms": head["split_k_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"], "on_main_path": False,
            "note": "split-K forced at the decode lm head (64, 1024, 17385); no path's plan names it",
        })
    return kernels


def tiled_kernel_entry(prefill_rows: list[dict]) -> dict:
    """K2's tiled kernel for the ``kernels`` line: each time the mean per
    launch over a fused prefill's 97 launches, from phase
    ``dense_vs_paged``'s rows at the five prefill shapes."""
    def per_launch(key):
        return sum(r[key] * r["launches_per_prefill"] for r in prefill_rows) / sum(
            r["launches_per_prefill"] for r in prefill_rows)

    if {r["plan"]["design"] for r in prefill_rows} != {"tiled"}:
        raise SystemExit("int8_prefill: a prefill shape is not planned on the tiled design")
    return {"name": "int8_matmul_tiled", "design": "tiled", "route": "cuda",
            "source": f"{CSRC}/int8_matmul_tiled.cu",
            "replaces": "vector_quantization_tpu/ops/int8_matmul.py:54",
            "max_abs_err": max(r["max_abs_err"] for r in prefill_rows),
            **{k: per_launch(k) for k in ("ms", "plain_ms", "bound_ms", "library_ms", "split_k_ms")},
            "bound_by": "operations",
            "note": "mean per launch over a fused prefill's launches: "
                    + ", ".join(f"{r['launches_per_prefill']}x {r['shape']}" for r in prefill_rows),
            "prefill_shapes": [{key: r[key] for key in ("shape", "B", "D", "F", "ms", "plain_ms", "library_ms",
                                                       "split_k_ms", "bound_ms", "max_abs_err")}
                               for r in prefill_rows]}


def phase_paged_attention(dev, gen) -> dict:
    import torch.nn.functional as F

    from vector_quantization_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
    )
    from vector_quantization_tpu_torch.ops.paged_kv import PagedKVCache, paged_gather

    b, h, dh, ps, n_layers = SLOTS, MEDIUM["num_heads"], 64, PAGE_SIZE, MEDIUM["num_layers"]
    p_slot = P_SLOT
    num_pages = 1 + b * p_slot
    rng = np.random.default_rng(0)
    table_np = np.resize(rng.permutation(np.arange(1, num_pages)), (b, p_slot + 1)).astype(np.int32)
    len_np = rng.integers(0, p_slot * ps + 1, b).astype(np.int32)
    len_np[:4] = [0, 1, ps, ps + 1]
    table = torch.from_numpy(table_np).to(dev)[:, :p_slot]  # sliced: rows strided
    lengths = torch.from_numpy(len_np).to(dev)
    live = int(np.minimum(len_np, p_slot * ps).sum())
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    shape = (n_layers, num_pages, ps, h, dh)
    kernel_row = None
    for pool in ("int8", "bf16"):
        if pool == "int8":
            k = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            ksc = torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3
            vsc = torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 1e-3
            tol, elt = 1e-4, 1
        else:
            k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            ksc = vsc = None
            tol, elt = 2e-3, 2
        kw = dict(k_scale_pool=ksc, v_scale_pool=vsc)
        err = 0.0
        for layer in (0, 13, n_layers - 1):
            got = paged_decode_attention(q, k, v, table, lengths, layer, **kw)
            want = paged_decode_attention_reference(q, k, v, table, lengths, layer, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or bool((got[0] != 0).any()):
                raise SystemExit(f"paged_decode_attention {pool}: non-finite or length-0 row not 0")
            err = max(err, float((got - want).abs().max()) / max(1.0, float(want.abs().max())))
        row = {"phase": "paged_decode_attention", "pool": pool, "B": b, "H": h, "Dh": dh,
               "ps": ps, "L": n_layers, "P": num_pages, "P_cap": p_slot,
               "mean_length": float(len_np.mean()), "max_err": err, "limit": tol}
        if err > tol:
            emit(row)
            raise SystemExit(f"paged_decode_attention {pool}: max_err {err} > {tol}")
        layers = range(n_layers)
        byts = live * h * (2 * dh * elt + (8 if pool == "int8" else 0)) \
            + b * h * dh * (2 + 4) + table.numel() * 4 + b * 4
        ops = live * h * 4 * dh
        # yardstick: SDPA over an already gathered, dequantised dense cache
        dense = []
        for layer in range(4):
            kg, vg, ks, vs = paged_gather(PagedKVCache(k, v, table, ksc, vsc), layer)
            kg, vg = kg.float(), vg.float()
            if ks is not None:
                kg, vg = kg * ks[..., None], vg * vs[..., None]
            dense.append((kg.to(torch.bfloat16).transpose(1, 2).contiguous(),
                          vg.to(torch.bfloat16).transpose(1, 2).contiguous()))
        mask = (torch.arange(p_slot * ps, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        # the decode step's own lengths (phase decode_step: positions + 1)
        step_len = torch.from_numpy(decode_positions()[1] + 1).to(dev)
        step_live = int(step_len.sum())
        step_bytes = byts + (step_live - live) * h * (2 * dh * elt + (8 if pool == "int8" else 0))
        row.update({
            "ms": graph_ms([lambda i=i: paged_decode_attention(q, k, v, table, lengths, i, **kw)
                            for i in layers]),
            "decode_lengths_mean": step_live / b,
            "decode_lengths_ms": graph_ms([lambda i=i: paged_decode_attention(
                q, k, v, table, step_len, i, **kw) for i in layers]),
            "decode_lengths_bound_ms": 1e3 * max(step_bytes / HBM_BYTES_PER_S,
                                                 step_live * h * 4 * dh / F32_FLOPS),
            "plain_ms": graph_ms([lambda i=i: paged_decode_attention_reference(
                q, k, v, table, lengths, i, **kw) for i in layers], replays=3),
            "library_ms": graph_ms([lambda kv=kv: F.scaled_dot_product_attention(
                q4, kv[0], kv[1], attn_mask=mask) for kv in dense]),
            "bytes": byts, "ops": ops,
            "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, ops / F32_FLOPS),
        })
        emit(row)
        if pool == "int8":
            kernel_row = row
        del k, v, ksc, vsc, dense
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": f"{CSRC}/paged_attention.cu",
        "replaces": "vector_quantization_tpu/ops/paged_attention.py:110",
        "max_abs_err": kernel_row["max_err"], "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"], "bound_ms": kernel_row["bound_ms"],
        "bound_by": "bytes", "library_ms": kernel_row["library_ms"],
        "note": f"int8 pool, B=64, mean live length {kernel_row['mean_length']}",
    }


def medium_flax_params(seed: int) -> dict:
    """Float Llama-medium params in the flax layout, made from ``seed`` with
    numpy: N(0, 0.02) embedding, projections and (non-zero) lm head; norm
    scales 1."""
    rng = np.random.default_rng(seed)
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    params = {"embedding": normal(VOCAB, d), "final_norm": {"scale": np.ones(d, np.float32)},
              "lm_head": normal(d, VOCAB)}
    for i in range(MEDIUM["num_layers"]):
        params[f"layer{i}"] = {
            "input_norm": {"scale": np.ones(d, np.float32)},
            "post_norm": {"scale": np.ones(d, np.float32)},
            **{p: {"kernel": normal(d, d)} for p in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "gate_proj": {"kernel": normal(d, f)}, "up_proj": {"kernel": normal(d, f)},
            "down_proj": {"kernel": normal(f, d)},
        }
    return params


@functools.lru_cache(maxsize=None)
def medium_int8_params(seed: int) -> dict:
    """:func:`medium_flax_params` with INT8 projections and head, unfused."""
    from vector_quantization_tpu_torch.models.transformers.llama import quantize_params_int8

    return quantize_params_int8(medium_flax_params(seed))


def make_medium(seed: int, dev, fused: bool = True, max_length: int = MEDIUM_MAX_LENGTH,
                quantize_mode: str = "auto"):
    """Llama-medium bf16 with INT8 weights (fused projections unless
    ``fused=False``; activations quantised too under ``quantize_mode``
    "w8a8"), weights made from ``seed`` with numpy in the flax layout and
    loaded via the bridge."""
    from vector_quantization_tpu_torch.models.transformers.llama import (
        LlamaTransformer, fuse_llama_params,
    )
    from vector_quantization_tpu_torch.utils.bridge import llama_params_from_flax

    params = medium_int8_params(seed)
    if fused:
        params = fuse_llama_params(params)
    model = LlamaTransformer(vocabulary_size=VOCAB, max_length=max_length, dtype="bfloat16",
                             quantize=True, quantize_mode=quantize_mode, fused_qkv=fused, **MEDIUM)
    model.load_state_dict(llama_params_from_flax(params))
    return model.to(dev).eval()


def step_wall(model, tokens, cache, positions, steps: int = 3) -> float:
    """Seconds per eager decode step on the host clock, each ending in a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model(tokens, cache, slot_positions=positions)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def step_device(model, tokens, cache, positions, steps: int = 3) -> tuple[float, dict]:
    """Device seconds per decode step: the sum of the kernels' device time
    that torch.profiler records over ``steps`` steps; and each kernel's
    device us and calls per step, by its profiler key. Run last: the
    profiler's tracing slows later host dispatch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model(tokens, cache, slot_positions=positions)
        torch.cuda.synchronize()
    kernels = {e.key: (e.self_device_time_total / steps, e.count / steps)
               for e in prof.key_averages()}
    device_us = sum(us for us, _ in kernels.values())
    if device_us <= 0:
        raise SystemExit("decode_profile: the profiler recorded no device time")
    return device_us / 1e6, kernels


def kernel_us(kernels: dict, *names: str) -> tuple[float, float]:
    """Device us and calls per step of the kernels whose profiler key holds
    any of ``names`` (:func:`step_device`'s ``kernels``)."""
    hits = [v for key, v in kernels.items() if any(n in key for n in names)]
    return sum(us for us, _ in hits), sum(calls for _, calls in hits)


def decode_positions() -> tuple[np.random.Generator, np.ndarray]:
    """The decode step's slot positions (rows 0 and 1 at position 0), and
    the generator that goes on to make its page table and tokens."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, IMAGE_TOKENS, SLOTS).astype(np.int32)
    pos[:2] = 0
    return rng, pos


def decode_inputs(model, dev, gen):
    """One decode step's inputs at the serving shape: an INT8 paged pool
    of random codes and scales (``gen``), each row's pages under its
    position (:func:`decode_positions`), tokens; and ``clone()``, a fresh
    copy of the pool for each run of the step."""
    b, ps, p_slot = SLOTS, PAGE_SIZE, P_SLOT
    num_pages = 1 + b * p_slot
    cache = model.init_paged_cache(b, num_pages, ps, p_slot, dtype=torch.int8, device=dev)
    rng, pos_np = decode_positions()
    table = np.zeros((b, p_slot), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for r in range(b):
        for p in range(pos_np[r] // ps + 1):
            table[r, p] = free.pop()
    cache.page_table.copy_(torch.from_numpy(table))
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02)
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (b, 1)).astype(np.int32)).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)

    def clone():
        return cache._replace(**{f: getattr(cache, f).clone()
                                 for f in ("k", "v", "k_scale", "v_scale")})

    return tokens, positions, clone


def phase_decode_step(model, dev, gen):
    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul_reference
    from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention_reference

    b = SLOTS
    tokens, positions, clone = decode_inputs(model, dev, gen)
    blocks = model.blocks()
    ins, outs = [], []
    hooks = [blk.register_forward_pre_hook(lambda m, a: ins.append(a[0].clone()))
             for blk in blocks]
    hooks += [blk.register_forward_hook(lambda m, a, o: outs.append(o.clone()))
              for blk in blocks]
    with torch.inference_mode():
        got, _ = model(tokens, clone(), slot_positions=positions)
        for hk in hooks:
            hk.remove()
        step_s = step_wall(model, tokens, clone(), positions)
        saved = llama_mod.int8_matmul, llama_mod.paged_decode_attention
        llama_mod.int8_matmul = int8_matmul_reference
        llama_mod.paged_decode_attention = paged_decode_attention_reference
        try:
            want, _ = model(tokens, clone(), slot_positions=positions)
            # each block alone on the kernel path's own input: no cascade
            c = clone()
            layer_err = max(
                float((blk(ins[i], positions[:, None], c, i, positions) - outs[i]).abs().max())
                / float(outs[i].abs().max())
                for i, blk in enumerate(blocks)
            )
        finally:
            llama_mod.int8_matmul, llama_mod.paged_decode_attention = saved
        torch.cuda.synchronize()
    err = float((got - want).abs().max()) / float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    row = {"phase": "decode_step", "B": b, "vocab": VOCAB, **MEDIUM, "dtype": "bfloat16",
           "logits_shape": list(got.shape), "max_abs_err_over_max_ref": err, "limit": 5e-2,
           "mean_abs_diff": float((got - want).abs().mean()),
           "mean_abs_ref": float(want.abs().mean()), "argmax_agree_frac": agree,
           "per_block_max_err_over_max_ref": layer_err, "per_block_limit": 1e-2,
           "eager_step_ms_host_clock": 1e3 * step_s}
    emit(row)
    if (got.shape != (b, 1, VOCAB) or not torch.isfinite(got).all() or err > 5e-2
            or layer_err > 1e-2 or agree < 0.9):
        raise SystemExit("decode_step: kernel and plain paths disagree (see the decode_step line)")

    def profile_step() -> None:
        from vector_quantization_tpu_torch.ops.int8_matmul import DESIGNS

        with torch.inference_mode():
            wall = step_wall(model, tokens, clone(), positions)
            device, kernels = step_device(model, tokens, clone(), positions)
            t0 = time.perf_counter()
            with head_on_split_k():  # the parent's plan at the lm head, in this call
                device_split_k, kernels_split_k = step_device(model, tokens, clone(), positions)
            split_k_s = time.perf_counter() - t0
        # the lm head's own device time in each trace: K2-ragged's kernel in
        # the shipped step; split-K's kernel (only the head runs it) and the
        # zero fill its atomics need (the fills' time over the shipped
        # step's) with the head on split-K
        head_us, head_calls = kernel_us(kernels, DESIGNS["ragged"][1])
        split_us, split_calls = kernel_us(kernels_split_k, DESIGNS["split_k"][1])
        fills = [kernel_us(k, "FillFunctor", "Memset") for k in (kernels, kernels_split_k)]
        row = {"phase": "decode_profile", "eager_step_ms_host_clock": 1e3 * wall,
               "device_ms_per_step_profiler": 1e3 * device,
               "device_ms_per_step_head_on_split_k": 1e3 * device_split_k,
               "device_idle_frac": 1.0 - device / wall,
               "head_ragged_us_per_step": head_us, "head_ragged_calls_per_step": head_calls,
               "head_split_k_us_per_step": split_us, "head_split_k_calls_per_step": split_calls,
               "fill_us_per_step": fills[0][0], "fill_us_per_step_head_on_split_k": fills[1][0],
               "head_on_split_k_us_per_step": split_us + fills[1][0] - fills[0][0],
               "head_on_split_k_seconds": split_k_s}
        emit(row)
        if head_calls != 1 or split_calls != 1 or kernel_us(kernels, DESIGNS["split_k"][1])[1]:
            raise SystemExit("decode_profile: the lm head's kernel did not run once a step "
                             "(see the decode_profile line)")

    return profile_step


@contextlib.contextmanager
def head_on_split_k():
    """The model's INT8 matmuls as shipped, but the lm head's (F = VOCAB)
    launched under the split-K design, the plan it had before the ragged
    design took it."""
    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    def launch(x, w, s):
        if w.shape[1] != VOCAB:
            return im.int8_matmul(x, w, s)
        x2 = x.reshape(-1, x.shape[-1])
        p = im.split_k_plan(x2.shape[0], x2.shape[1], w.shape[1], im.card(x.device).sms)
        return im._launch(x2, w, s, p).reshape(*x.shape[:-1], -1)

    saved = llama_mod.int8_matmul
    llama_mod.int8_matmul = launch
    try:
        yield
    finally:
        llama_mod.int8_matmul = saved


def phase_serving(model, dev, seed: int, n_requests: int,
                  k2_kernels: list[str]) -> tuple[dict, dict]:
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    server = ARServer(
        model, None, TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK),
        image_tokens=IMAGE_TOKENS, batch_slots=SLOTS,
        sampler={"temperature": 1.0, "top_k": 600, "top_p": 0.92},
        cfg_alpha=1.75, uncond_token=NUM_CATEGORIES, steps_per_sync=STEPS_PER_SYNC,
        cache_dtype=torch.int8, paged=True, page_size=PAGE_SIZE, seed=seed, device=dev,
    )
    rids = [server.submit(category=i % NUM_CATEGORIES) for i in range(n_requests)]
    zero_launches()
    _, plain0 = read_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = dict(server.run_until_drained())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_launches()
    plain_runs = plain - plain0
    rep = server.efficiency_report()
    row = {"phase": "serving", "requests": n_requests, "finished": len(done),
           "image_tokens": IMAGE_TOKENS, "batch_slots": SLOTS, "steps_per_sync": STEPS_PER_SYNC,
           "wall_s": wall, "effective_tokens_per_s": n_requests * IMAGE_TOKENS / wall,
           "images_per_min": n_requests / wall * 60.0, "launches": launches,
           "plain_runs_on_cuda": plain_runs,
           "pages_free": len(server._free_pages), "pages_total": server._total_pages,
           "efficiency_report": rep}
    emit(row)
    ok = (sorted(done) == rids
          and all(c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all()
                  for c in done.values())
          and len(server._free_pages) == server._total_pages and server._pages_reserved == 0
          and all(launches[k] > 0 for k in k2_kernels) and launches[K2_SPLIT_K] == 0
          and launches[K2_HEAD] > 0
          and launches["paged_decode_attention"] > 0
          and plain_runs == 0)
    if not ok:
        raise SystemExit("serving: a check failed (see the serving line)")
    return launches, done


def k2_launches(launches: dict) -> int:
    """K2's launches over all of its kernels."""
    from vector_quantization_tpu_torch.ops.int8_matmul import DESIGNS

    return sum(launches[source] for source, _ in DESIGNS.values())


def int8_matmul_row(dev, gen, name: str, b: int, d: int, f: int, split_k: bool = False) -> dict:
    """K2 through ``int8_matmul`` (the plan's kernel) against its plain
    version at one shape, and the three device times of phase
    ``int8_matmul`` (weights rotated past the L2); with ``split_k``, also
    the split-K design's time at the shape (``split_k_ms``)."""
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    ws = [torch.randint(-127, 128, (d, f), generator=gen, device=dev, dtype=torch.int8)
          for _ in range(-(-150_000_000 // (d * f)))]
    s = torch.rand((f,), generator=gen, device=dev) * 0.02 + 1e-3
    got, want = im.int8_matmul(x, ws[0], s), im.int8_matmul_reference(x, ws[0], s)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    p = im.plan_for(x, ws[0])
    byts, ops = d * f + b * d * 2 + f * 4 + b * f * 4, 2 * b * d * f
    row = {"phase": "int8_matmul", "shape": name, "B": b, "D": d, "F": f, "plan": p._asdict(),
           "source": f"{CSRC}/{p.source}.cu", "max_abs_err": abs_err,
           "max_rel_err": abs_err / float(want.abs().max()), "limit": 1e-3,
           "weight_copies": len(ws), "bytes": byts, "ops": ops,
           "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, ops / BF16_FLOPS),
           "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= ops / BF16_FLOPS else "operations"}
    if row["max_rel_err"] > 1e-3 or not torch.isfinite(got).all():
        emit(row)
        raise SystemExit(f"int8_matmul {name}: max_rel_err {row['max_rel_err']} > 1e-3")
    wb = [w.to(torch.bfloat16) for w in ws]
    row.update({
        "ms": graph_ms([lambda w=w: im.int8_matmul(x, w, s) for w in ws]),
        "plain_ms": graph_ms([lambda w=w: im.int8_matmul_reference(x, w, s) for w in ws], replays=3),
        "library_ms": graph_ms([lambda w=w: torch.matmul(x, w) * s for w in wb], replays=3),
    })
    if split_k:
        sk = im.split_k_plan(b, d, f, im.card(dev).sms)
        row["split_k_ms"] = graph_ms([lambda w=w: im._launch(x, w, s, sk) for w in ws], replays=3)
    emit(row)
    return row


def prefill_matmuls() -> list[tuple[str, int, int, int]]:
    """The fused INT8 Llama-medium's products in a prefill of 64 x 129
    rows: (name, D, F, launches per prefill)."""
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
    layers = MEDIUM["num_layers"]
    return [("qkv", d, 3 * d, layers), ("o", d, d, layers), ("gate_up", d, 2 * f, layers),
            ("down", f, d, layers), ("lm_head", d, VOCAB, 1)]


def phase_dense_vs_paged(model, dev, gen, seed: int) -> list[dict]:
    """One decode step at full width (the fused INT8 model) over the dense
    INT8 cache (einsum attention) and over the paged INT8 pool (K3), both
    filled by the same 127 prior steps of the same tokens; then K2 at the
    dense path's new shapes."""
    b, n = SLOTS, 128
    p_slot = -(-n // PAGE_SIZE)
    toks = torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, VOCAB, (n, b, 1)).astype(np.int32)).to(dev)
    dense = model.init_cache(b, dtype=torch.int8, rows=n)
    paged = model.init_paged_cache(b, 1 + b * p_slot, PAGE_SIZE, p_slot, dtype=torch.int8,
                                   device=dev)
    paged.page_table.copy_(torch.arange(1, 1 + b * p_slot, device=dev).reshape(b, p_slot))
    zero_launches()
    _, plain0 = read_launches()
    with torch.inference_mode():
        for i in range(n):
            got, dense = model(toks[i], dense)
            want, paged = model(toks[i], paged, slot_positions=torch.full(
                (b,), i, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    launches, plain = read_launches()
    err = float((got - want).abs().max()) / float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    row = {"phase": "dense_vs_paged", "B": b, "steps": n, "vocab": VOCAB, **MEDIUM,
           "dense_cache_columns": dense.window, "paged_pages_per_row": p_slot,
           "max_abs_err_over_max_ref": err, "limit": 5e-2, "argmax_agree_frac": agree,
           "argmax_limit": 0.9, "ref": "paged pool through K3", "launches": launches,
           "plain_runs_on_cuda": plain - plain0}
    emit(row)
    if (got.shape != (b, 1, VOCAB) or not torch.isfinite(got).all() or err > 5e-2 or agree < 0.9
            or plain != plain0 or launches["paged_decode_attention"] != n * MEDIUM["num_layers"]):
        raise SystemExit("dense_vs_paged: the dense and paged decode disagree (see its line)")
    del dense, paged
    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
    rows = [int8_matmul_row(dev, gen, "generate_gate_up", GEN_BATCH, d, f)]
    prefill = []
    for name, dd, ff, per_prefill in prefill_matmuls():
        row = int8_matmul_row(dev, gen, f"int8_prefill_{name}", PREFILL_ROWS, dd, ff, split_k=True)
        prefill.append({**row, "launches_per_prefill": per_prefill})
    rows += prefill + [int8_matmul_row(dev, gen, "int8_prefill_gate_up_unfused", PREFILL_ROWS, d, f,
                                       split_k=True)]
    total = {k: sum(r[k] * r["launches_per_prefill"] for r in prefill)
             for k in ("ms", "split_k_ms", "plain_ms", "library_ms", "bound_ms")}
    emit({"phase": "int8_matmul", "shape": "int8_prefill_k2", "B": PREFILL_ROWS,
          "launches": sum(r["launches_per_prefill"] for r in prefill),
          "designs": sorted({r["plan"]["design"] for r in prefill}), **total,
          "note": "sums over a fused prefill's launches of each shape's time (weights rotated past the L2)"})
    return rows


def prefill_k2_device_ms(model, prefill, forced=None) -> float:
    """K2's device milliseconds in one prefill (torch.profiler, after a
    warm-up), under the shipped plans or with every call launched under
    ``forced(b, d, f)``'s plan."""
    from torch.profiler import ProfilerActivity, profile

    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    def launch(x, w, s):
        x2 = x.reshape(-1, x.shape[-1])
        p = forced(x2.shape[0], x2.shape[1], w.shape[1])
        return im._launch(x2, w, s, p).reshape(*x.shape[:-1], -1)

    saved = llama_mod.int8_matmul
    if forced is not None:
        llama_mod.int8_matmul = launch
    try:
        prefill()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prefill()
            torch.cuda.synchronize()
    finally:
        llama_mod.int8_matmul = saved
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if any(kernel in e.key for _, kernel in im.DESIGNS.values()))
    if us <= 0:
        raise SystemExit("int8_prefill: the profiler recorded no K2 device time")
    return us / 1e3


def phase_int8_prefill(model, dev, seed: int, k2_rows: list[dict]) -> dict:
    """generate()'s prefill of a (64, 129) prefix on phase 4's model, the
    ``transformer(prefix, cache)`` call, through the kernels and through
    the plain versions; then K2's device time in it under the shipped plans
    and under split-K."""
    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod
    from vector_quantization_tpu_torch.ops import int8_matmul as im

    b, t = GEN_BATCH, PREFILL_ROWS // GEN_BATCH
    prefix = torch.from_numpy(np.random.default_rng(seed + 7).integers(
        0, VOCAB, (b, t)).astype(np.int32)).to(dev)

    def prefill():
        cache = model.init_cache(b, dtype=torch.int8, device=dev, rows=t + GEN_SEGMENT)
        with torch.inference_mode():
            return model(prefix, cache)[0]

    zero_launches()
    _, plain0 = read_launches()
    t0 = time.perf_counter()
    got = prefill()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_launches()
    saved = llama_mod.int8_matmul
    llama_mod.int8_matmul = im.int8_matmul_reference
    try:
        want = prefill()
        torch.cuda.synchronize()
    finally:
        llama_mod.int8_matmul = saved
    err = float((got - want).abs().max()) / float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    want_k2 = sum(n for *_, n in prefill_matmuls())
    bound = sum(r["bound_ms"] * r["launches_per_prefill"] for r in k2_rows)
    del want
    row = {"phase": "int8_prefill", "B": b, "T": t, "rows": b * t, "cache": "int8", **MEDIUM,
           "vocab": VOCAB, "logits_shape": list(got.shape), "first_call_s": wall,
           "max_abs_err_over_max_ref": err, "limit": 5e-2, "argmax_agree_frac": agree,
           "argmax_limit": 0.9, "launches": launches, "k2_launches": k2_launches(launches),
           "k2_launches_expected": want_k2, "plain_runs_on_cuda": plain - plain0,
           "k2_device_ms": prefill_k2_device_ms(model, prefill),
           "k2_device_ms_split_k": prefill_k2_device_ms(
               model, prefill, lambda bb, d, f: im.split_k_plan(bb, d, f, im.card(dev).sms)),
           "k2_bound_ms": bound}
    emit(row)
    if (got.shape != (b, t, VOCAB) or not torch.isfinite(got).all() or err > 5e-2 or agree < 0.9
            or row["k2_launches"] != want_k2 or launches["int8_matmul_tiled"] != want_k2
            or plain != plain0):
        raise SystemExit("int8_prefill: a check failed (see the int8_prefill line)")
    return launches


def phase_serving_dense(model, dev, seed: int, n_requests: int, k2_kernels: list[str]):
    """``ARServer()`` with its default engine (dense, shared column) at the
    bench recipe; two arrival patterns on one server: aligned (every
    request up front) and staggered (16 up front, 16 more after each
    sync)."""
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    server = ARServer(
        model, None, TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK), image_tokens=IMAGE_TOKENS,
        batch_slots=SLOTS, sampler=SAMPLER, cfg_alpha=1.75, uncond_token=NUM_CATEGORIES,
        steps_per_sync=DENSE_STEPS_PER_SYNC, sync_chunk=SYNC_CHUNK, cache_dtype=torch.int8,
        seed=seed, device=dev,
    )
    max_col = 0

    def serve(staggered: bool):
        nonlocal max_col
        submitted = 0
        for _ in range(min(16, n_requests) if staggered else n_requests):
            server.submit(category=submitted % NUM_CATEGORIES)
            submitted += 1
        done = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while server.pending or submitted < n_requests:
            done.extend(server.step())
            max_col = max(max_col, server.col)
            for _ in range(min(16, n_requests - submitted) if staggered else 0):
                server.submit(category=submitted % NUM_CATEGORIES)
                submitted += 1
        torch.cuda.synchronize()
        return dict(done), time.perf_counter() - t0

    zero_launches()
    _, plain0 = read_launches()
    rows, ok = {}, server._shared_col
    for pattern in ("aligned", "staggered"):
        for key in server.stats:  # count each pattern's run alone
            server.stats[key] = 0 if isinstance(server.stats[key], int) else 0.0
        first = server._next_id
        done, wall = serve(pattern == "staggered")
        rows[pattern] = {"requests": n_requests, "finished": len(done), "wall_s": wall,
                         "effective_tokens_per_s": n_requests * IMAGE_TOKENS / wall,
                         "images_per_min": n_requests / wall * 60.0,
                         "efficiency_report": server.efficiency_report()}
        ok = ok and sorted(done) == list(range(first, first + n_requests)) and all(
            c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all()
            for c in done.values())
    launches, plain = read_launches()
    row = {"phase": "serving_dense", "engine": "shared_column" if server._shared_col else "scatter",
           "image_tokens": IMAGE_TOKENS, "batch_slots": SLOTS,
           "steps_per_sync": DENSE_STEPS_PER_SYNC, "sync_chunk": SYNC_CHUNK, **rows,
           "staggered_over_aligned": rows["staggered"]["effective_tokens_per_s"]
           / rows["aligned"]["effective_tokens_per_s"],
           "max_col": max_col, "sc_cap": server._sc_cap, "launches": launches,
           "plain_runs_on_cuda": plain - plain0}
    emit(row)
    if not (ok and max_col <= server._sc_cap and all(launches[k] > 0 for k in k2_kernels)
            and launches[K2_SPLIT_K] == 0 and launches[K2_HEAD] > 0 and plain == plain0):
        raise SystemExit("serving_dense: a check failed (see the serving_dense line)")
    return launches


def phase_generate(dev, seed: int):
    """``generate()`` as bench.py's ar section runs it, through the port:
    Llama-medium INT8 unfused, B = 64 rows of class 0, 256 tokens, INT8
    dense cache grown 32 columns a segment, top-k 600 / top-p 0.92."""
    from vector_quantization_tpu_torch.ops.int8_matmul import DESIGNS
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook, generate

    model = make_medium(seed, dev, fused=False, max_length=1 + IMAGE_TOKENS)
    codebook = TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK)
    prefix = torch.zeros((GEN_BATCH, 1), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run():
        return generate(model, prefix, IMAGE_TOKENS, codebook, gen, sampler=SAMPLER,
                        cache_dtype=torch.int8, kv_segment=GEN_SEGMENT)

    zero_launches()
    _, plain0 = read_launches()
    codes, first_s = _timed(run)
    launches, plain = read_launches()
    times = [_timed(run)[1] for _ in range(3)]
    wall = float(np.median(times))
    want_k2 = (1 + IMAGE_TOKENS) * GEN_K2_PER_FORWARD
    row = {"phase": "generate", "B": GEN_BATCH, "tokens": IMAGE_TOKENS, "kv_segment": GEN_SEGMENT,
           "cache": "int8", "weights": "int8, unfused", **MEDIUM, "sampler": SAMPLER,
           "codes_shape": list(codes.shape), "first_call_s": first_s, "timed_calls_s": times,
           "tokens_per_s": GEN_BATCH * IMAGE_TOKENS / wall,
           "ms_per_token": 1e3 * wall / IMAGE_TOKENS, "launches": launches,
           "k2_launches": k2_launches(launches), "k2_launches_expected": want_k2,
           "plain_runs_on_cuda": plain - plain0}
    emit(row)
    if (codes.shape != (GEN_BATCH, IMAGE_TOKENS) or codes.dtype != torch.int32
            or bool((codes < 0).any()) or bool((codes >= CODEBOOK).any())
            or row["k2_launches"] != want_k2 or plain != plain0
            or launches[K2_HEAD] != 1 + IMAGE_TOKENS or launches[K2_SPLIT_K] != 0):
        raise SystemExit("generate: a check failed (see the generate line)")

    def profile_generate_step() -> None:
        """One decode step of generate() at its midpoint (token 128: the
        cache of 129 columns, the segment that holds it), on the host clock
        and under torch.profiler: device ms, idle share, K2's share."""
        from torch.profiler import ProfilerActivity, profile

        rows, length = 1 + 128, 128
        cache = model.init_cache(GEN_BATCH, dtype=torch.int8, rows=rows)
        g = torch.Generator(device=dev).manual_seed(seed)
        for t in (*cache.k, *cache.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=dev, dtype=torch.int8))
        for t in (*cache.k_scale, *cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device=dev) * 0.02)
        cache = cache._replace(length=length)
        tok = torch.randint(0, VOCAB, (GEN_BATCH, 1), generator=g, device=dev, dtype=torch.int32)
        with torch.inference_mode():
            model(tok, cache)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                model(tok, cache)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / 3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    model(tok, cache)
                torch.cuda.synchronize()
        events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in events) / 3
        if device_us <= 0:
            raise SystemExit("generate_profile: the profiler recorded no device time")
        k2_us = sum(e.self_device_time_total for e in events
                    if any(kernel in e.key for _, kernel in DESIGNS.values())) / 3
        emit({"phase": "generate_profile", "B": GEN_BATCH, "cache_columns": rows,
              "step_ms_host_clock": 1e3 * host, "device_ms_per_step_profiler": device_us / 1e3,
              "device_idle_frac": 1.0 - device_us / 1e6 / host, "k2_device_ms": k2_us / 1e3,
              "k2_share_of_device": k2_us / device_us,
              "top_kernels": [{"name": e.key[:90], "calls": e.count / 3,
                               "ms_per_step": e.self_device_time_total / 3e3}
                              for e in events[:10]]})

    return launches, profile_generate_step


def phase_ar_generate(algo, state, dev, seed: int) -> None:
    """Class -> image through ``ARAlgorithm.generate_step``: the LlamaGen
    C2I model of phase ``ar_train`` with CFG as its config sets it, 8
    classes, the VQGAN decoder of phase ``tokenizer``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    category = torch.arange(0, NUM_CATEGORIES, NUM_CATEGORIES // 8, device=dev)[:8]
    zero_launches()
    images, wall = _timed(lambda: algo.generate_step(state, category, gen))
    launches, _ = read_launches()
    row = {"phase": "ar_generate", "classes": int(category.numel()), "cfg": algo.cfg,
           "cfg_alpha": algo.cfg_alpha, "sampler": algo.sampler,
           "transformer_dtype": str(algo.model.dtype).removeprefix("torch."),
           "images_shape": list(images.shape), "wall_s": wall,
           "s_per_image": wall / category.numel(), "launches": launches}
    emit(row)
    if images.shape != (8, IMAGE_SIZE, IMAGE_SIZE, 3) or not torch.isfinite(images).all():
        raise SystemExit("ar_generate: the generated images are not (8, 256, 256, 3) and finite")


TF32_FLOPS = 495e12  # dense tensor-core TF32
ZOO_N = 12 * 16 * 16  # the batch-12 VQGAN steps' rows at 256 px, /16: 3072


def lookup_bounds(n: int, k: int, d: int, x_dtype, e_dtype) -> dict:
    """K1's two bounds in ms. ``bound_ms``: this design's, the largest of the
    bytes (x and the codebook read once, the codes written once) over the
    card's memory rate, the TF32 passes (3 for f32 x f32, 2 for a mixed pair,
    1 for bf16 x bf16) x 2NKD over the tensor cores' TF32 rate, and one
    compare per score (NK) at the f32 rate. ``bound_f32_cuda_cores_ms``: the
    products and compares (2NKD + 2NK) at the f32 rate outside the tensor
    cores."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    byts = n * d * size[x_dtype] + k * d * size[e_dtype] + n * 4
    passes = 1 + (x_dtype == torch.float32) + (e_dtype == torch.float32)
    terms = {"bytes": byts / HBM_BYTES_PER_S, "tensor_core_passes": passes * 2 * n * k * d / TF32_FLOPS,
             "compares": n * k / F32_FLOPS}
    return {"bytes": byts, "tf32_passes": passes, "bound_ms": 1e3 * max(terms.values()),
            "bound_term": max(terms, key=terms.get),
            "bound_f32_cuda_cores_ms": 1e3 * (2 * n * k * d + 2 * n * k) / F32_FLOPS}


def kernels_per_call(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:60] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


SHAPE_KEYS = ("N", "K", "D", "ms", "plain_ms", "library_ms", "bound_ms", "bound_f32_cuda_cores_ms",
              "max_score_gap", "plan")


def phase_vq_lookup(dev, gen) -> dict:
    from vector_quantization_tpu_torch.ops.device import card
    from vector_quantization_tpu_torch.ops.vq_lookup import (
        NEAR_TIE_REL_TOL, compare_codes, nearest_codes, nearest_codes_reference, plan,
    )

    n_path = TOKENIZER_BATCH * GRID * GRID
    cases = [  # (name, N, K, D, dtype, metric, rows, timed)
        ("path_f32", n_path, CODEBOOK, 8, torch.float32, "l2", "gaussian", True),
        ("path_bf16", n_path, CODEBOOK, 8, torch.bfloat16, "l2", "gaussian", True),
        ("path_normalized", n_path, CODEBOOK, 8, torch.float32, "l2", "unit", True),
        ("vqgan_train_f32", VQGAN_TRAIN_BATCH * GRID * GRID, CODEBOOK, 8, torch.float32, "l2", "unit",
         True),
        ("flagship_d256", 16384, 16384, 256, torch.float32, "l2", "gaussian", True),
        # VQ-KD's step (cosine, unit rows) and its lazy k-means init (l2 on
        # unit rows); Cluster's step at D = 768 (x streamed through the ring)
        ("vqkd_cosine", TEACHER_N, 8192, 32, torch.float32, "cosine", "unit", True),
        ("vqkd_init_l2", TEACHER_N, 8192, 32, torch.float32, "l2", "unit", True),
        ("cluster_d768", TEACHER_N, 8192, 768, torch.float32, "l2", "gaussian", True),
        # the 8192 x 256 codebooks of the StyleGAN2 VQGAN (l2) and CVQ-VAE
        # (cosine) steps at batch 12
        ("zoo_d256_l2", ZOO_N, 8192, 256, torch.float32, "l2", "gaussian", True),
        ("zoo_d256_cosine", ZOO_N, 8192, 256, torch.float32, "cosine", "gaussian", True),
        # the linear probe's IR (configs/ic: width 128, 8192 x 256) at batch 64
        ("probe_d256_l2", *PROBE_SHAPE[:3], torch.float32, "l2", "gaussian", True),
        ("ragged_cosine", 1000, 777, 40, torch.float32, "cosine", "gaussian", False),
        ("n1", 1, CODEBOOK, 8, torch.float32, "l2", "gaussian", False),
        ("planted_ties", 4096, 1000, 8, torch.float32, "l2", "ties", False),
        ("planted_ties_bf16", 4096, 1000, 8, torch.bfloat16, "l2", "ties", False),
    ]
    kernel_row = train_row = probe_row = None
    teacher_rows, zoo_rows = {}, {}
    for name, n, k, d, dtype, metric, rows, timed in cases:
        x = torch.randn((n, d), generator=gen, device=dev)
        e = torch.randn((k, d), generator=gen, device=dev)
        if rows == "unit":  # the LlamaGen quantizer looks up l2-normalised rows
            x, e = x / x.norm(dim=1, keepdim=True), e / e.norm(dim=1, keepdim=True)
        if rows == "ties":  # odd codes repeat the even ones; every third row sits on one
            e[1::2] = e[0::2][: k // 2]
            x[::3] = e[torch.randint(0, k // 2, (x[::3].shape[0],), generator=gen, device=dev) * 2]
        x, e = x.to(dtype), e.to(dtype)
        got = nearest_codes(x, e, metric)
        want = nearest_codes_reference(x, e, metric)
        torch.cuda.synchronize()
        rep = compare_codes(x, e, got, want, metric)
        row = {"phase": "vq_lookup", "shape": name, "N": n, "K": k, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "metric": metric, "rows": rows,
               "plan": plan(n, k, d, dtype == torch.bfloat16, dtype == torch.bfloat16, card(dev))._asdict(),
               "rows_differing": rep["differ"], "rows_excused_as_near_ties": rep["excused"],
               "near_tie_rows": rep["near_tie_rows"], "near_tie_abs_tol": rep["tol"],
               "near_tie_rel_tol": NEAR_TIE_REL_TOL, "max_score_gap": rep["max_score_gap"]}
        ok = rep["ok"] and got.dtype == torch.int32 and got.shape == (n,)
        if rows == "ties":
            planted = torch.arange(0, n, 3, device=dev)
            row["planted_ties_exact"] = bool(torch.equal(got[planted], want[planted])
                                             and (got[planted] % 2 == 0).all())
            ok = ok and row["planted_ties_exact"]
        if not ok:
            emit(row)
            raise SystemExit(f"vq_lookup {name}: kernel and plain codes disagree beyond near-ties")
        if timed:
            xf, ef = x.float(), e.float()
            esq_half = 0.5 * (ef * ef).sum(dim=1)
            launched = kernels_per_call(lambda: nearest_codes(x, e, metric))
            row.update({
                "ms": graph_ms([lambda: nearest_codes(x, e, metric)]),
                "plain_ms": graph_ms([lambda: nearest_codes_reference(x, e, metric)], replays=3),
                "library_ms": graph_ms([lambda: torch.argmin(
                    torch.addmm(esq_half, xf, ef.T, alpha=-1), dim=1)], replays=3),
                "launches_per_call": len(launched), "kernels_per_call": launched,
                **lookup_bounds(n, k, d, dtype, dtype),
            })
            if name == "path_f32":
                kernel_row = row
            if name == "vqgan_train_f32":
                train_row = row
            if name in ("vqkd_cosine", "vqkd_init_l2", "cluster_d768"):
                teacher_rows[name] = row
            if name.startswith("zoo_"):
                zoo_rows[name] = row
            if name == "probe_d256_l2":
                probe_row = row
            del xf, ef, esq_half
        emit(row)
        del x, e, got, want
    return {
        "name": "nearest_codes", "route": "cuda",
        "source": f"{CSRC}/vq_lookup.cu",
        "replaces": "vector_quantization_tpu/ops/vq_lookup.py:94",
        "max_abs_err": kernel_row["max_score_gap"], "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"], "bound_ms": kernel_row["bound_ms"],
        "bound_by": "operations", "library_ms": kernel_row["library_ms"],
        "bound_f32_cuda_cores_ms": kernel_row["bound_f32_cuda_cores_ms"],
        "note": (f"N = K = 16384, D = 8, f32; bound_ms is the tensor-core bound (3 TF32 passes); "
                 f"max_abs_err is the largest plain-score gap "
                 f"between the kernel's code and the row's best ({kernel_row['rows_differing']} "
                 f"rows differ, all near-ties); library_ms writes the N x K matrix; train_shape: "
                 f"the VQGAN train step's lookup (unit rows)"),
        "train_shape": {key: train_row[key] for key in SHAPE_KEYS},
        "teacher_shapes": {name: {key: r[key] for key in (*SHAPE_KEYS, "metric")}
                           for name, r in teacher_rows.items()},
        "zoo_shapes": {name: {key: r[key] for key in (*SHAPE_KEYS, "metric")}
                       for name, r in zoo_rows.items()},
        "probe_shape": {key: probe_row[key] for key in (*SHAPE_KEYS, "metric")},
    }


def make_vqgan(seed: int, dev):
    """The LlamaGen VQGAN through the port's config loader and registry,
    with :func:`load_random_flax_weights` from ``seed``."""
    from vector_quantization_tpu_torch.registries import ModelRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    path = Path(__file__).resolve().parent / VQGAN_CONFIG
    cfg = Config.load(str(path))["trainer"]["algorithm"]["model"]
    model = ModelRegistry.build(cfg, device=dev)
    load_random_flax_weights(model, seed)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VQGAN_PARAMS:
        raise SystemExit(f"tokenizer: {n_params} parameters, the config gives {VQGAN_PARAMS}")
    return model.eval(), cfg


def load_random_flax_weights(model, seed: int) -> None:
    """Weights made from ``seed`` with numpy in the flax layout (conv and
    Dense kernels N(0, 1/fan_in), GroupNorm scale 1 and bias 0, the
    codebook uniform(-1/K, 1/K)), loaded into ``model`` through the bridge."""
    from vector_quantization_tpu_torch.utils.bridge import flax_param_shapes, state_dict_from_flax

    rng = np.random.default_rng(seed)

    def make(tree, leaf=None):
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        if leaf == "kernel":
            fan_in = int(np.prod(tree[:-1]))
            return rng.standard_normal(tree, dtype=np.float32) / np.float32(np.sqrt(fan_in))
        if leaf == "codebook":
            return rng.uniform(-1.0 / tree[0], 1.0 / tree[0], tree).astype(np.float32)
        return (np.ones if leaf == "scale" else np.zeros)(tree, np.float32)

    model.load_state_dict(state_dict_from_flax(model, make(flax_param_shapes(model))))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def conv_linear_flops(model, fn) -> int:
    """2 x the multiply-adds of every Conv2d and Linear that ``fn`` runs
    (the attention block's two matmuls, the norms and the lookup are not
    counted)."""
    total = 0

    def count(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        else:
            total += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total


def codes_vs_plain(model, images, codes=None) -> dict:
    """``images``' lookup by the kernel (or ``codes``, the kernel's codes
    from elsewhere) and by its plain version (swapped in) on the same
    features, held against each other by ``compare_codes``."""
    from vector_quantization_tpu_torch.ops import vq_lookup
    from vector_quantization_tpu_torch.ops.distances import normalize

    q = model.quantizer
    with torch.no_grad():
        feat = model.encode(images).reshape(-1, q.embedding_dim)
        codes = q.encode(feat) if codes is None else codes
        saved = vq_lookup.nearest_codes
        vq_lookup.nearest_codes = vq_lookup.nearest_codes_reference
        try:
            plain_codes = q.encode(feat)
        finally:
            vq_lookup.nearest_codes = saved
        x = normalize(feat) if q.normalize_inputs else feat
        rep = vq_lookup.compare_codes(x, q.effective_codebook(), codes, plain_codes, q.distance)
    rep["shape"] = [*x.shape[:1], q.effective_codebook().shape[0], x.shape[1]]
    return rep


def phase_tokenizer(model, cfg, dev, seed: int):
    from vector_quantization_tpu_torch.data.base import pixel_encode

    rng = np.random.default_rng(seed + 1)
    u8 = rng.integers(0, 256, (TOKENIZER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    x = pixel_encode(torch.from_numpy(u8).to(dev))
    with torch.inference_mode():
        enc_flops = conv_linear_flops(model, lambda: model.encode_to_quant(x[:1]))
        dec_flops = conv_linear_flops(model, lambda: model.decode_from_quant(
            torch.zeros((1, GRID, GRID), dtype=torch.int32, device=dev)))
        model.decode_from_quant(model.encode_to_quant(x))  # warm-up: cuDNN plans, allocator
        zero_launches()
        _, plain0 = read_launches()
        codes, enc_s = _timed(lambda: model.encode_to_quant(x))
        pixels, dec_s = _timed(lambda: model.decode_from_quant(codes))
        launches, plain = read_launches()
        plain_runs = plain - plain0
        rep = codes_vs_plain(model, x)
        out = model(x[:8])
    torch.cuda.synchronize()
    q = out["quantizer"]
    row = {"phase": "tokenizer", "config": VQGAN_CONFIG,
           "params": sum(p.numel() for p in model.parameters()), "dtype": "float32",
           "images": TOKENIZER_BATCH, "image_size": IMAGE_SIZE, "codes_shape": list(codes.shape),
           "pixels_shape": list(pixels.shape), "encode_s": enc_s, "decode_s": dec_s,
           "encode_images_per_s": TOKENIZER_BATCH / enc_s,
           "decode_images_per_s": TOKENIZER_BATCH / dec_s,
           "encode_gflop_per_image": enc_flops / 1e9, "decode_gflop_per_image": dec_flops / 1e9,
           "encode_tflop_per_s": enc_flops * TOKENIZER_BATCH / enc_s / 1e12,
           "decode_tflop_per_s": dec_flops * TOKENIZER_BATCH / dec_s / 1e12,
           "launches": launches, "plain_runs_on_cuda": plain_runs,
           "codes_vs_plain": {k: rep[k] for k in ("differ", "excused", "near_tie_rows", "tol")},
           "distinct_codes": int(torch.unique(codes).numel()),
           "forward_loss_vqgan": float(q.losses["loss_vqgan"]),
           "forward_codes_equal_encode_to_quant": bool(torch.equal(q.codes, codes[:8]))}
    emit(row)
    ok = (codes.shape == (TOKENIZER_BATCH, GRID, GRID) and bool((codes >= 0).all())
          and bool((codes < CODEBOOK).all()) and rep["ok"]
          and pixels.shape == (TOKENIZER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
          and bool(torch.isfinite(pixels).all()) and launches["nearest_codes"] > 0
          and plain_runs == 0
          and out["pred"].shape == (8, IMAGE_SIZE, IMAGE_SIZE, 3)
          and bool(torch.isfinite(out["pred"]).all()) and bool(torch.isfinite(q.loss))
          and row["forward_codes_equal_encode_to_quant"])
    if not ok:
        raise SystemExit("tokenizer: a check failed (see the tokenizer line)")

    def profile_tokenizer() -> None:
        """Device time of one encode + decode of the batch by kernel, and
        the device's idle share against the host clock (under the
        profiler, so the host side is slower than in the timed run)."""
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = _timed(lambda: model.decode_from_quant(model.encode_to_quant(x)))
        events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in events)
        if device_us <= 0:
            raise SystemExit("tokenizer_profile: the profiler recorded no device time")
        emit({"phase": "tokenizer_profile", "images": TOKENIZER_BATCH,
              "host_ms": 1e3 * wall, "device_ms": device_us / 1e3,
              "device_idle_frac": 1.0 - device_us / 1e6 / wall,
              "top_kernels": [{"name": e.key[:90], "calls": e.count,
                               "ms": e.self_device_time_total / 1e3,
                               "share": e.self_device_time_total / device_us}
                              for e in events[:8]]})

    return launches, profile_tokenizer


def phase_class_to_image(model, done: dict, dev) -> None:
    from vector_quantization_tpu_torch.data.base import pixel_decode

    grids = torch.stack([torch.as_tensor(done[r]).reshape(GRID, GRID) for r in sorted(done)]).to(dev)
    zero_launches()
    with torch.inference_mode():
        images, wall = _timed(lambda: pixel_decode(model.decode_from_quant(grids)))
    launches, _ = read_launches()  # decode runs the gather and convolutions: no ported kernel
    row = {"phase": "class_to_image", "requests": len(done), "images_shape": list(images.shape),
           "launches": launches,
           "dtype": str(images.dtype).removeprefix("torch."), "decode_s": wall,
           "decode_images_per_s": len(done) / wall}
    emit(row)
    if images.dtype != torch.uint8 or images.shape != (len(done), IMAGE_SIZE, IMAGE_SIZE, 3):
        raise SystemExit("class_to_image: the served codes did not become uint8 images")


# VQGAN training (configs/llamagen/vqgan_imagenet_ddp.py; configs/regression/train_anchor.py)
PROFILE_GROUPS = {  # kernel name fragments -> group, first match wins
    "k1": ("nearest_tc_kernel", "prep_kernel"),
    "sdpa": ("fmha", "attention"),  # F.scaled_dot_product_attention's kernels (the ViTs)
    "cudnn_conv": ("cudnn", "conv", "implicit_gemm", "fft", "winograd", "dgrad", "wgrad", "fprop",
                   "cf32"),  # cf32: the complex GEMM of cuDNN's FFT convolution
    "gemm": ("gemm", "nvjet", "cutlass"),  # cuBLAS (its sm80_xmma_gemm_* too)
    "elementwise": ("elementwise", "foreach"),
    "reduce": ("reduce",),
}


def profile_group(kernel: str) -> str:
    name = kernel.lower()
    return next((g for g, marks in PROFILE_GROUPS.items() if any(m in name for m in marks)), "other")


def profile_train_step(phase: str, run, **fields) -> None:
    """``run()`` (one train step) under torch.profiler: device time by
    group and kernel, and the device's idle share against the host clock.
    Busy time is the union of the kernels' intervals (the sum of their
    times counts kernels that run at once twice, as cuDNN's FFT
    convolutions do)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(run)
    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise SystemExit(f"{phase}: the profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_group = dict.fromkeys([*PROFILE_GROUPS, "other"], 0.0)
    for e in events:
        by_group[profile_group(e.key)] += e.self_device_time_total / 1e3
    emit({"phase": phase, **fields,
          "host_ms": 1e3 * wall, "device_ms": device_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_idle_frac": 1.0 - busy_us / 1e6 / wall,
          "device_ms_by_group": by_group,
          "share_by_group": {g: ms * 1e3 / device_us for g, ms in by_group.items()},
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share": e.self_device_time_total / device_us,
                           "group": profile_group(e.key)}
                          for e in events[:12]]})


def make_vqgan_algorithm(cfg_path: str, seed: int, dev):
    """``VQGANAlgorithm`` from ``cfg_path`` through the port's config loader
    and registry; the generator's weights from :func:`load_random_flax_weights`,
    the discriminator's and LPIPS's from their own init under
    ``torch.manual_seed(seed)``."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / cfg_path))
    torch.manual_seed(seed)
    algo = AlgorithmRegistry.build(cfg["trainer"]["algorithm"], device=dev)
    load_random_flax_weights(algo.model, seed)
    return algo, cfg


def snapshot(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def moved(module, before: dict) -> list[str]:
    """Names of ``module``'s tensors (parameters and buffers) that differ
    from ``before``."""
    return [k for k, v in module.state_dict().items() if not torch.equal(v, before[k])]


def phase_vqgan_train(algo, dev, seed: int):
    from vector_quantization_tpu_torch.data.base import pixel_encode

    model, disc = algo.model, algo.discriminator
    # the codebook's row norms as the step's normalize finds them (after the
    # generator's update): normalize's e·rsqrt(‖e‖² + 1e-12) leaves a row of
    # norm n at n / sqrt(n² + 1e-12), short of 1 where n is small (the
    # random init's rows have n² ~ 1e-8)
    pre_normalize = {}
    codebook_update = algo._codebook_update

    def spied_codebook_update(state, qout=None):
        pre_normalize["n"] = torch.linalg.vector_norm(model.quantizer.codebook.detach().double(), dim=1)
        codebook_update(state, qout)

    algo._codebook_update = spied_codebook_update
    rng = np.random.default_rng(seed + 4)
    u8 = rng.integers(0, 256, (VQGAN_TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    batch = {"image": pixel_encode(torch.from_numpy(u8).to(dev))}
    state = algo.init_state(seed)
    n_g, n_d = len(model.state_dict()), len(disc.state_dict())
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    parts, ok = {}, True
    for part, start in (("gates_off", 0), ("gan_on", VQGAN_D_START)):
        state.step = start
        g_before, d_before = snapshot(model), snapshot(disc)
        rows = []
        for _ in range(VQGAN_TRAIN_STEPS):
            k1_before = read_launches()[0]["nearest_codes"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = algo.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
            seconds = time.perf_counter() - t0
            norms = torch.linalg.vector_norm(model.quantizer.codebook.detach().double(), dim=1)
            n = pre_normalize.pop("n")
            rows.append({"step": state.step - 1, "ms": 1e3 * seconds, "metrics": metrics,
                         "k1_launches": read_launches()[0]["nearest_codes"] - k1_before,
                         "codebook_norm_max_dev_from_1": float((norms - 1).abs().max()),
                         "codebook_norm_max_dev": float((norms - n * torch.rsqrt(n**2 + 1e-12))
                                                        .abs().max())})
        g_moved, d_moved = moved(model, g_before), moved(disc, d_before)
        del g_before, d_before
        step_ms = float(np.median([r["ms"] for r in rows]))
        parts[part] = {"start_step": start, "steps": rows, "step_ms_median": step_ms,
                       "images_per_s": VQGAN_TRAIN_BATCH / step_ms * 1e3,
                       "generator_tensors_moved": len(g_moved), "generator_tensors": n_g,
                       "discriminator_tensors_moved": len(d_moved), "discriminator_tensors": n_d}
        gan = part == "gan_on"
        ok = ok and all(np.isfinite(list(r["metrics"].values())).all() and r["k1_launches"] == 1
                        and r["codebook_norm_max_dev"] <= CODEBOOK_NORM_LIMIT for r in rows)
        ok = ok and len(g_moved) == n_g and len(d_moved) == (n_d if gan else 0)
        ok = ok and all((r["metrics"]["g_loss"] != 0) == gan and (r["metrics"]["d_loss"] != 0) == gan
                        and (abs(r["metrics"]["aglw"] - algo.aglw_gain) > 1e-6) == gan for r in rows)
    algo._codebook_update = codebook_update
    launches, plain = read_launches()
    plain_runs = plain - plain0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rep = codes_vs_plain(model, batch["image"])  # the step's lookup, on the same features
    ok = (ok and plain_runs == 0 and launches["nearest_codes"] == 2 * VQGAN_TRAIN_STEPS and rep["ok"]
          and sum(p.numel() for p in model.parameters()) == VQGAN_PARAMS)
    row = {"phase": "vqgan_train", "config": VQGAN_CONFIG, "dtype": "float32",
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "generator_params": sum(p.numel() for p in model.parameters()),
           "discriminator_params": sum(p.numel() for p in disc.parameters()),
           "lpips_params": sum(p.numel() for p in algo.lpips_module.parameters()),
           "batch": VQGAN_TRAIN_BATCH, "image_size": IMAGE_SIZE, "parts": parts,
           "peak_memory_gib": peak_gib, "launches": launches, "plain_runs_on_cuda": plain_runs,
           "codebook_norm_limit": CODEBOOK_NORM_LIMIT,
           "codes_vs_plain": {k: rep[k] for k in ("shape", "rows", "differ", "excused", "near_tie_rows",
                                                  "tol")}}
    emit(row)
    if not ok:
        raise SystemExit("vqgan_train: a check failed (see the vqgan_train line)")

    def profile_vqgan_step() -> None:
        """One GAN-on step under torch.profiler."""
        profile_train_step("vqgan_train_profile", lambda: algo.train_step(state, batch),
                           batch=VQGAN_TRAIN_BATCH, step=state.step)

    return launches, profile_vqgan_step, parts["gates_off"]["step_ms_median"]


def phase_vqgan_anchor(dev) -> None:
    """configs/regression/train_anchor.py: its trainer's steps on its
    dataset (all 128 images on the card, a permutation per epoch from the
    seed), then its validator's metrics on its split."""
    from vector_quantization_tpu_torch.data.datasets import collate
    from vector_quantization_tpu_torch.registries import DatasetRegistry, MetricRegistry

    t_start = time.perf_counter()
    algo, cfg = make_vqgan_algorithm(ANCHOR_CONFIG, ANCHOR_SEED, dev)
    trainer, validator = cfg["trainer"], cfg["validator"]
    train = DatasetRegistry.build(trainer["dataset"])
    images = torch.from_numpy(collate([train[i] for i in range(len(train))])["image"]).to(dev)
    batch_size, steps = trainer["dataloader"]["batch_size"], trainer["max_iters"]
    per_epoch = len(train) // batch_size
    rng = np.random.default_rng(ANCHOR_SEED)
    state = algo.init_state(ANCHOR_SEED)
    zero_launches()
    _, plain0 = read_launches()
    logged = {}
    t_train = time.perf_counter()
    for it in range(steps):
        if it % per_epoch == 0:
            order = torch.from_numpy(rng.permutation(len(train))).to(dev)
        idx = order[(it % per_epoch) * batch_size:(it % per_epoch + 1) * batch_size]
        state, metrics = algo.train_step(state, {"image": images[idx]})
        if (it + 1) % 500 == 0:
            logged[it + 1] = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    train_launches = read_launches()[0]["nearest_codes"]
    val = DatasetRegistry.build(validator["dataset"])
    metrics = {name: MetricRegistry.build(m) for name, m in validator["metrics"].items()}
    vb = validator["dataloader"]["batch_size"]
    eval_batches = -(-len(val) // vb)
    for lo in range(0, len(val), vb):
        batch = collate([val[i] for i in range(lo, min(lo + vb, len(val)))])
        memo = algo.eval_step(state, {"image": torch.from_numpy(batch["image"]).to(dev)})
        memo["batch"] = batch
        for m in metrics.values():
            m.update(memo)
    got = {name: m.summary(name)[name] for name, m in metrics.items()}
    launches, plain = read_launches()
    rep = codes_vs_plain(state.model, images[:batch_size])  # the step's lookup, its shape
    recorded = json.loads((Path(__file__).resolve().parent / "BASELINE.json").read_text())
    want = recorded["published"]["self_trained_2k"]["metrics"]
    row = {"phase": "vqgan_anchor", "config": ANCHOR_CONFIG, "seed": ANCHOR_SEED, "steps": steps,
           "batch": batch_size, "train_images": len(train), "val_images": len(val),
           "discriminator_start": algo.d_start, "losses_every_500": logged,
           "metrics": got, "baseline_self_trained_2k": want, "psnr_bar": ANCHOR_PSNR_BAR,
           "k1_launches_train": train_launches, "eval_batches": eval_batches,
           "k1_launches_eval": launches["nearest_codes"] - train_launches,
           "plain_runs_on_cuda": plain - plain0,
           "codes_vs_plain": {k: rep[k] for k in ("shape", "rows", "differ", "excused", "near_tie_rows",
                                                  "tol")},
           "train_s": train_s, "ms_per_step": 1e3 * train_s / steps,
           "wall_s": time.perf_counter() - t_start}
    emit(row)
    if not (got["psnr"] >= ANCHOR_PSNR_BAR and row["plain_runs_on_cuda"] == 0
            and train_launches == steps and row["k1_launches_eval"] == eval_batches and rep["ok"]
            and all(np.isfinite(list(got.values())))):
        raise SystemExit("vqgan_anchor: below the anchor's PSNR bar or a check failed")


# VQ-KD and Cluster training (configs/vqkd/clip_8192_imagenet_ddp.py,
# configs/cluster/clip_8192_imagenet_ddp.py): batch 64 a card, as bench.py's
# vqkd_224px times the step (the configs' 512 is the global batch)
VQKD_CONFIG = "configs/vqkd/clip_8192_imagenet_ddp.py"
CLUSTER_CONFIG = "configs/cluster/clip_8192_imagenet_ddp.py"
TEACHER_BATCH, TEACHER_IMAGE, TEACHER_STEPS = 64, 224, 3  # 1 + 3 steps
TEACHER_GRID = TEACHER_IMAGE // 16
VQKD_PARAMS, CLUSTER_PARAMS = 109_092_416, 92_090_880
TEACHER_N = TEACHER_BATCH * TEACHER_GRID**2  # 12544 rows a lookup
UNIT_NORM_LIMIT = 1e-5  # |row norm - 1| after VQ-KD's k-means update (it ends in normalize)


def make_teacher_algorithm(cfg_path: str, seed: int, dev):
    """``VQKDAlgorithm`` or ``ClusterAlgorithm`` from ``cfg_path`` through
    the port's config loader and registry, every module (the teacher too)
    at its own random init under ``torch.manual_seed(seed)``: no teacher
    weights are in the repository."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / cfg_path))
    torch.manual_seed(seed)
    return AlgorithmRegistry.build(cfg["trainer"]["algorithm"], device=dev), cfg


def step_flops(algo, batch) -> dict:
    """GFLOP per image, counted by ``torch.utils.flop_counter`` on forwards
    under ``no_grad`` (matmuls, convolutions and the attention's products;
    the norms, elementwise passes and the lookup's kernel not counted): the
    trained model's forward, the frozen part's (VQ-KD's teacher; Cluster's
    encoder, which is its teacher), and the step's estimate: VQ-KD's
    trained forward 3x (forward and backward) plus the teacher's forward;
    Cluster's teacher forward plus 2·N·K·D twice, the lookup's products and
    CVQ's distance matrix."""
    from torch.utils.flop_counter import FlopCounterMode

    def counted(fn) -> int:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops()

    model = algo.model
    n = batch["image"].shape[0]
    if hasattr(algo, "teacher"):
        trained = counted(lambda: model(batch["image"]))
        frozen = counted(lambda: algo.teacher(batch["original_image"]))
        step = 3 * trained + frozen
    else:
        trained, frozen = 0, counted(lambda: model.encode(batch["image"]))
        k, d = model.quantizer.codebook.shape
        step = frozen + 2 * (2 * n * TEACHER_GRID**2 * k * d)
    return {"trained_fwd_gflop_per_image": trained / n / 1e9, "frozen_fwd_gflop_per_image": frozen / n / 1e9,
            "step_gflop_per_image": step / n / 1e9}


def phase_teacher_train(phase: str, algo, cfg, dev, seed: int, config: str = VQKD_CONFIG,
                        params: int = VQKD_PARAMS):
    """``phase`` is ``vqkd_train``, ``vqkd_convnext_train`` (VQ-KD from
    ``config``, ``params`` trained-model parameters) or ``cluster_train``:
    1 + 3 train steps at full width on one batch, then (VQ-KD) one
    ``eval_step`` with the validator's metrics."""
    from vector_quantization_tpu_torch.data.base import pixel_encode
    from vector_quantization_tpu_torch.registries import MetricRegistry

    vqkd = hasattr(algo, "teacher")
    if not vqkd:
        config, params = CLUSTER_CONFIG, CLUSTER_PARAMS
    model = algo.model
    teacher = algo.teacher if vqkd else model.encoder
    rng = np.random.default_rng(seed + 5)
    u8 = torch.from_numpy(rng.integers(0, 256, (TEACHER_BATCH, TEACHER_IMAGE, TEACHER_IMAGE, 3),
                                       dtype=np.uint8)).to(dev)
    batch = {"image": pixel_encode(u8), "original_image": u8}
    n_params = sum(p.numel() for p in model.parameters())
    flops = step_flops(algo, batch)
    state = algo.init_state(seed)
    teacher_before = snapshot(teacher)
    codebook_before = model.quantizer.codebook.detach().clone()
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    trained_before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    rows = []
    for _ in range(1 + TEACHER_STEPS):
        k1_before = read_launches()[0]["nearest_codes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = algo.train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
        seconds = time.perf_counter() - t0
        rows.append({"step": state.step - 1, "ms": 1e3 * seconds, "metrics": metrics,
                     "k1_launches": read_launches()[0]["nearest_codes"] - k1_before})
        if vqkd:  # a spherical codebook: unit rows after every step
            norms = torch.linalg.vector_norm(model.quantizer.codebook.detach().double(), dim=1)
            rows[-1]["codebook_norm_max_dev_from_1"] = float((norms - 1).abs().max())
    train_launches = read_launches()[0]["nearest_codes"]
    evaluated = {}
    if vqkd:
        metrics = {name: MetricRegistry.build(m) for name, m in cfg["validator"]["metrics"].items()}
        memo = algo.eval_step(state, batch)
        for m in metrics.values():
            m.update(memo)
        evaluated = {name: m.summary(name)[name] for name, m in metrics.items()}
    launches, plain = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    rep = codes_vs_plain(model, batch["image"])  # the step's lookup, on the same features
    want_k1 = [1 + algo.lazy_kmeans_init["iters"] if vqkd else 1] + [1] * TEACHER_STEPS
    teacher_moved = moved(teacher, teacher_before)
    trained_moved = [n for n, p in model.named_parameters() if n in trained_before
                     and not torch.equal(p.detach(), trained_before[n])]
    teacher_feats = {}
    if vqkd:  # the recon target: the teacher's features of the batch
        with torch.no_grad():
            feats = algo.teacher(u8)
        teacher_feats = {"teacher_features_shape": list(feats.shape),
                         "teacher_features_finite": bool(torch.isfinite(feats).all())}
        del feats
    row = {"phase": phase, "config": config, "dtype": "float32",
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "model_params": n_params, "trained_params": sum(p.numel() for p in trained_before.values()),
           "teacher_params": sum(p.numel() for p in teacher.parameters()),
           "batch": TEACHER_BATCH, "image_size": TEACHER_IMAGE, "steps": rows,
           "first_step_ms": rows[0]["ms"], "step_ms_median": step_ms,
           "images_per_s": TEACHER_BATCH / step_ms * 1e3, **flops,
           "achieved_tflop_per_s": flops["step_gflop_per_image"] * TEACHER_BATCH / step_ms,
           "peak_memory_gib": peak_gib, "k1_launches_per_step": [r["k1_launches"] for r in rows],
           "k1_launches_expected": want_k1, "k1_launches_eval": launches["nearest_codes"] - train_launches,
           "plain_runs_on_cuda": plain - plain0, "teacher_tensors_moved": len(teacher_moved),
           "trained_tensors_moved": len(trained_moved), "trained_tensors": len(trained),
           "eval_metrics": evaluated, "teacher": type(teacher).__name__, **teacher_feats,
           "codes_vs_plain": {k: rep[k] for k in ("shape", "rows", "differ", "excused", "near_tie_rows",
                                                  "tol")}}
    emit(row)
    # the codebook moves in both (k-means or CVQ); VQ-KD's other weights move
    # by the warm-up's lr (0 at the first step, 8e-9 at the second), which
    # a LayerNorm scale of 1 does not resolve in f32: reported, not gated
    ok = (row["k1_launches_per_step"] == want_k1 and row["plain_runs_on_cuda"] == 0 and rep["ok"]
          and not teacher_moved and not torch.equal(model.quantizer.codebook.detach(), codebook_before)
          and all(np.isfinite(list(r["metrics"].values())).all() for r in rows)
          and n_params == params)
    if vqkd:
        ok = ok and row["k1_launches_eval"] == 1 and np.isfinite(list(evaluated.values())).all()
        ok = ok and teacher_feats["teacher_features_finite"] and teacher_feats["teacher_features_shape"] == [
            TEACHER_BATCH, TEACHER_GRID**2, algo.teacher.out_channels]
        ok = ok and all(r["codebook_norm_max_dev_from_1"] <= UNIT_NORM_LIMIT for r in rows)
        ok = ok and state.extra["initialized"] is True
    if not ok:
        raise SystemExit(f"{phase}: a check failed (see the {phase} line)")

    def profile_step() -> None:
        profile_train_step(f"{phase}_profile", lambda: algo.train_step(state, batch),
                           batch=TEACHER_BATCH, step=state.step)

    return launches, profile_step


# AR training (configs/llamagen/c2i_medium_imagenet_ddp.py with flash on)
AR_CONFIG = "configs/llamagen/c2i_medium_imagenet_ddp.py"
SEQ = 1 + IMAGE_TOKENS  # [class | 256 codes]
AR_IMAGE_BATCH, AR_CODES_BATCH, AR_IMAGE_STEPS, AR_CODES_STEPS = 64, 128, 3, 5
FLASH_O_LIMIT, FLASH_GRAD_LIMIT, FLASH_LSE_LIMIT, FLASH_DI_LIMIT = 2e-3, 1e-2, 1e-4, 1e-5
EINSUM_LOSS_LIMIT, EINSUM_GRAD_LIMIT = 1e-2, 5e-2


def sdpa_flash_ms(q, k, v, do) -> dict:
    """The yardstick of K4: PyTorch's causal flash attention (SDPA pinned to
    its FLASH_ATTENTION backend) on K4's inputs, (B, T, H, Dh) viewed as
    SDPA's (B, H, T, Dh), each part timed by CUDA-graph replay as the
    kernels are: the forward; the backward alone (the aten flash backward
    on residuals that one forward call made outside the graph); forward and
    backward together."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt, dot = [x.transpose(1, 2) for x in (q, k, v, do)]
    fwd_op = torch.ops.aten._scaled_dot_product_flash_attention
    bwd_op = torch.ops.aten._scaled_dot_product_flash_attention_backward

    def backward(res):
        # res: (out, logsumexp, cum_seq_q, cum_seq_k, max_q, max_k, rng_state, unused, ...)
        return bwd_op(dot, qt, kt, vt, res[0], res[1], res[2], res[3], res[4], res[5],
                      0.0, True, res[6], res[7])

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd_ms = graph_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)])
    res = fwd_op(qt, kt, vt, 0.0, True)
    return {"backend": "FLASH_ATTENTION", "fwd_ms": fwd_ms,
            "bwd_ms": graph_ms([lambda: backward(res)]),
            "fwd_bwd_ms": graph_ms([lambda: backward(fwd_op(qt, kt, vt, 0.0, True))]),
            "bwd_schema": str(bwd_op.default._schema)}


def flash_cost(b: int, t: int, h: int, dh: int) -> dict:
    """Bytes (each input read once, each output written once) and tensor-core
    operations of the three kernels at (B, T, H, Dh), causal."""
    pairs = b * h * t * (t + 1) // 2  # (query, key) pairs at or below the diagonal
    x, row = b * t * h * dh * 2, b * h * t * 4  # one bf16 (B, T, H, Dh); one f32 (B, H, T)
    return {"fwd": (3 * x + x + row, 4 * dh * pairs),       # q, k, v -> o, lse
            "dkv": (4 * x + 2 * row + 2 * x, 8 * dh * pairs),  # q, k, v, dO, lse, di -> dk, dv
            "dq": (5 * x + row + x + row, 6 * dh * pairs)}    # q, k, v, o, dO, lse -> dq, di


def phase_flash_attention(dev, gen) -> list[dict]:
    from vector_quantization_tpu_torch.ops import flash_attention as fa

    path = (AR_IMAGE_BATCH, SEQ, MEDIUM["num_heads"], 64)
    cases = [("path", path), ("t1", (4, 1, 8, 64)), ("t63", (4, 63, 8, 64)),
             ("t64", (4, 64, 8, 64)), ("t65", (4, 65, 8, 64)), ("t129", (4, 129, 8, 64)),
             ("t256", (4, 256, 8, 64)), ("t300", (4, 300, 8, 64)), ("t705", (2, 705, 4, 64)),
             ("bh1", (1, SEQ, 1, 64)),
             ("dh32", (4, 200, 8, 32)), ("dh128", (4, 200, 8, 128))]
    timing = None
    for name, shape in cases:
        q, k, v, do = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4)]
        o, lse = fa.flash_attention_fwd(q, k, v)
        ro, rl = fa.flash_attention_reference(q, k, v)
        # both backward versions take the same residuals (the kernel's o, lse)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
        rq, rk, rv = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
        _, di = fa.flash_bwd_dq(q, k, v, o, do, lse)  # the di the backward's dkv took
        rdi = fa._di(o, do)
        torch.cuda.synchronize()
        # over max(1, max|ref|): at T = 1 dq and dk are 0 up to rounding
        grad_err = {n: float((g.float() - r.float()).abs().max())
                    / max(1.0, float(r.float().abs().max()))
                    for n, g, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        row = {"phase": "flash_attention", "case": name, "B": shape[0], "T": shape[1],
               "H": shape[2], "Dh": shape[3], "dtype": "bfloat16",
               "o_max_abs_err": float((o.float() - ro.float()).abs().max()),
               "o_err_beyond_one_bf16_step": fa.excess_over_bf16_step(o, ro), "o_limit": FLASH_O_LIMIT,
               "lse_max_abs_err": float((lse - rl).abs().max()), "lse_limit": FLASH_LSE_LIMIT,
               "grad_max_err_over_max_ref": grad_err, "grad_limit": FLASH_GRAD_LIMIT,
               "di_max_err_over_max_ref": float((di - rdi).abs().max())
               / max(1.0, float(rdi.abs().max())), "di_limit": FLASH_DI_LIMIT}
        finite = all(bool(torch.isfinite(x).all()) for x in (o, lse, dq, dk, dv, di))
        if (not finite or row["o_err_beyond_one_bf16_step"] > FLASH_O_LIMIT
                or row["lse_max_abs_err"] > FLASH_LSE_LIMIT
                or max(grad_err.values()) > FLASH_GRAD_LIMIT
                or row["di_max_err_over_max_ref"] > FLASH_DI_LIMIT):
            emit(row)
            raise SystemExit(f"flash_attention {name}: kernels and plain versions disagree")
        if name == "path":
            sdpa = sdpa_flash_ms(q, k, v, do)
            plain_bwd = graph_ms([lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do)],
                                 replays=3)
            timing = {
                "fwd": (graph_ms([lambda: fa.flash_attention_fwd(q, k, v)]),
                        graph_ms([lambda: fa.flash_attention_reference(q, k, v)], replays=3),
                        sdpa["fwd_ms"]),
                "dkv": (graph_ms([lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di)]), plain_bwd,
                        sdpa["bwd_ms"]),
                "dq": (graph_ms([lambda: fa.flash_bwd_dq(q, k, v, o, do, lse)]), plain_bwd,
                       sdpa["bwd_ms"]),
                # K4's whole backward: dq (which writes di), then dkv
                "bwd": (graph_ms([lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)]), plain_bwd,
                        sdpa["bwd_ms"]),
            }
            row.update({f"{k}_{m}": val for k, (ms, plain, lib) in timing.items()
                        for m, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib))})
            row.update({"sdpa_backend": sdpa["backend"], "sdpa_fwd_bwd_ms": sdpa["fwd_bwd_ms"],
                        "sdpa_bwd_schema": sdpa["bwd_schema"],
                        "bwd_faster": "K4" if timing["bwd"][0] < sdpa["bwd_ms"] else "SDPA"})
            errs = (row["o_err_beyond_one_bf16_step"], grad_err)
        emit(row)
        del q, k, v, do, o, lse, ro, rl, dq, dk, dv, rq, rk, rv, di, rdi
    # f32 is refused on the card, never cast
    x = torch.zeros((1, 4, 2, 64), device=dev)
    try:
        fa.flash_attention_fwd(x, x, x)
    except ValueError as e:
        if "float32" not in str(e):
            raise
    else:
        raise SystemExit("flash_attention: an f32 CUDA input was not refused")
    cost = flash_cost(*path)
    entries = []
    for key, name, line, err in (
        ("fwd", "flash_attention_fwd", "flash_attention.py:758 (kernel :331)", errs[0]),
        ("dkv", "flash_bwd_dkv", "flash_attention.py:1121 (kernel :796)",
         max(errs[1]["dk"], errs[1]["dv"])),
        ("dq", "flash_bwd_dq", "flash_attention.py:1456 (kernel :1146)", errs[1]["dq"]),
    ):
        byts, ops = cost[key]
        ms, plain, lib = timing[key]
        bound_bytes, bound_ops = byts / HBM_BYTES_PER_S, ops / BF16_FLOPS
        entries.append({
            "name": name, "route": "cuda",
            "source": f"{CSRC}/flash_attention.cu",
            "replaces": ("vector_quantization_tpu/models/transformers/llama.py:232 -> "
                         "jax/experimental/pallas/ops/tpu/" + line),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": 1e3 * max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": lib, "bytes": byts, "ops": ops,
            "note": (f"(B, T, H, Dh) = {path} bf16; max_abs_err: "
                     + ("o beyond one bf16 step over max(1, max|ref|)" if key == "fwd"
                        else "max|diff| over max(1, max|ref|)")
                     + ("; library_ms = SDPA(is_causal) forward, FLASH_ATTENTION backend"
                        if key == "fwd" else
                        "; plain_ms = the whole plain backward (dq, dk, dv); library_ms = "
                        "the whole SDPA flash backward (dq, dk, dv), graph-timed")
                     + ("; the dq kernel also writes di = sum(o dO) for dkv" if key == "dq"
                        else "")),
        })
    return entries


def make_ar_algorithm(seed: int, dev, vqgan):
    """ARAlgorithm from the LlamaGen C2I medium config with flash on,
    through the port's config loader and registry; Llama-medium weights
    made from ``seed`` (non-zero lm head) and loaded through the bridge;
    the tokenizer is phase ``tokenizer``'s VQGAN."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / AR_CONFIG))["trainer"]["algorithm"]
    cfg["transformer"]["flash"] = True
    cfg["ir"] = vqgan
    algo = AlgorithmRegistry.build(cfg, device=dev)
    load_ar_from_flax(algo, medium_flax_params(seed + 2))
    return algo, cfg


def ar_model_flops(cfg: dict, batch: int) -> tuple[float, float]:
    """(model FLOPs of one train step, FLOPs with the full-remat re-run of
    the blocks' forward), from the config's widths: the projections
    (6 x tokens x weights), causal attention (4 x Dh per (query, key) pair
    and head, x3 for forward and backward) and the head over B x (T-1)
    positions (6 x D x V)."""
    t = cfg["transformer"]
    d, f, n_layers, h = t["hidden_size"], t["ffn_dim"], t["num_layers"], t["num_heads"]
    tokens, pairs = batch * SEQ, batch * h * SEQ * (SEQ + 1) // 2
    proj = 2 * tokens * n_layers * (4 * d * d + 3 * d * f)
    attn = 4 * (d // h) * pairs * n_layers
    head = 2 * batch * (SEQ - 1) * d * VOCAB
    return 3 * (proj + attn + head), 3 * (proj + attn + head) + proj + attn


def phase_ar_train(algo, cfg, dev, seed: int):
    from vector_quantization_tpu_torch.data.base import pixel_encode

    model = algo.model
    n_layers = cfg["transformer"]["num_layers"]
    rng = np.random.default_rng(seed + 3)
    u8 = rng.integers(0, 256, (AR_IMAGE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    image_batch = {"image": pixel_encode(torch.from_numpy(u8).to(dev)),
                   "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, AR_IMAGE_BATCH)).to(dev)}
    codes_batch = {"codes": torch.from_numpy(rng.integers(0, CODEBOOK, (AR_CODES_BATCH, GRID, GRID))).to(dev),
                   "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, AR_CODES_BATCH)).to(dev)}
    n_params = sum(p.numel() for p in model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    ir_before = [p.detach().clone() for p in algo.ir_model.parameters()]
    state = algo.init_state(seed)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    losses, times, lrs = [], [], []
    for i in range(AR_IMAGE_STEPS + AR_CODES_STEPS):
        batch = image_batch if i < AR_IMAGE_STEPS else codes_batch
        lrs.append(algo.tx().schedule(state.opt_state["count"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = algo.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
    launches, plain = read_launches()
    plain_runs = plain - plain0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    changed = [not torch.equal(p, b) for p, b in zip(model.parameters(), before)]
    ir_same = all(torch.equal(p, b) for p, b in zip(algo.ir_model.parameters(), ir_before))
    del before, ir_before
    steps = AR_IMAGE_STEPS + AR_CODES_STEPS
    step_s = float(np.median(times[AR_IMAGE_STEPS:]))
    model_flops, remat_flops = ar_model_flops(cfg, AR_CODES_BATCH)
    want = {"flash_attention_fwd": 2 * n_layers * steps, "flash_bwd_dkv": n_layers * steps,
            "flash_bwd_dq": n_layers * steps, "nearest_codes": AR_IMAGE_STEPS}
    row = {"phase": "ar_train", "config": AR_CONFIG, "flash": True, "params": n_params,
           "dtype": str(model.dtype).removeprefix("torch."), "remat": model.remat,
           "image_batch": AR_IMAGE_BATCH, "image_steps": AR_IMAGE_STEPS,
           "codes_batch": AR_CODES_BATCH, "codes_steps": AR_CODES_STEPS, "seq": SEQ,
           "losses": losses, "lr_per_step": lrs, "step_s_host_clock": times,
           "codes_step_ms_median": 1e3 * step_s,
           "codes_tokens_per_s": AR_CODES_BATCH * SEQ / step_s,
           "model_tflop_per_step": model_flops / 1e12,
           "with_remat_tflop_per_step": remat_flops / 1e12,
           "mfu_vs_989_tflops": model_flops / step_s / BF16_FLOPS,
           "peak_memory_gib": peak_gb, "launches": launches, "expected_launches": want,
           "plain_runs_on_cuda": plain_runs,
           "params_changed": int(sum(changed)), "param_tensors": len(changed),
           "tokenizer_unchanged": ir_same}
    emit(row)
    ok = (all(np.isfinite(losses)) and all(changed) and ir_same and plain_runs == 0
          and all(launches[k] == v for k, v in want.items()))
    if not ok:
        raise SystemExit("ar_train: a check failed (see the ar_train line)")
    return launches, state, codes_batch, row



# the entry points (cli.train / cli.test / cli.tokenize and build_runner)
# over overlays of the shipped LlamaGen configs, synthetic images at 256 px
CLI_VQGAN_STEPS, CLI_RESUME_STEPS = 4, 6
CLI_VAL_IMAGES, CLI_VAL_BATCH = 64, 16  # the FID phases' images: more than one batch each
CLI_AR_BATCH, CLI_AR_STEPS = 64, 3
# runner vs hand-driven losses on the same batches and starting weights: the
# path's kernels are deterministic (K4 has no atomics), so the two should
# agree exactly; 1e-5 relative leaves room for a reordered reduction in a
# library kernel and is far below one step's change of the loss at lr 1e-4
CLI_AR_REPLAY_TOL = 1e-5
CLI_METRICS = ("codebook_usage", "codebook_ppl", "l1", "mse", "psnr", "ssim", "fid")  # the config's validator
FID_SELF_BOUND = 1e-2  # |FID(originals, their own cache)|: the JAX package's own test's bound
# the originals' statistics in FIDMetric against cli.fid's cache of them, as
# a fraction of max|cache|: the same images through the same network in
# batches of the same size, so at most another cuDNN algorithm's rounding may
# differ; tests/test_torch_fid.py holds an align-corners resize in place of
# JAX's to moving them by more than 1e-4, where the FID cannot see it
FID_CACHE_TOL = 1e-5
# cli.val against cli.test on one checkpoint: the same weights on the same
# images; FID's 2048 x 2048 eigvals leave it a looser bound
CLI_VAL_LOSS_TOL, CLI_VAL_FID_TOL = 1e-5, 1e-3
GEN_EVAL_BATCH = 8  # ar_generation_eval: one batch of 8 classes
PROBE_CONFIG = "configs/ic/imagenet_ddp.py"
PROBE_BATCH, PROBE_STEPS = 64, 3  # the config's 512 over its 8-way data parallelism
PROBE_SHAPE = (PROBE_BATCH * GRID * GRID, 8192, 256, "l2")  # the probe's IR: width 128, 8192 x 256


class StepRecorder:
    """A runner callback (registered as ``SmokeStepRecorder``): each step's
    metrics as the step left them (tensors: no read, no synchronisation),
    the host clock at each step's end (unsynchronised: the pace at which
    steps are enqueued), each checkpoint save's seconds, and the run's host
    seconds between synchronisations at its ends."""

    def bind(self, runner) -> None:
        self.runner = runner
        save = runner.save_checkpoint

        def timed_save(step: int) -> None:
            t0 = time.perf_counter()
            save(step)
            self.saves.append(time.perf_counter() - t0)

        runner.save_checkpoint = timed_save

    def before_run(self) -> None:
        self.steps, self.metrics, self.ends, self.saves = [], [], [], []
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def after_run_iter(self, step: int, metrics) -> None:
        self.steps.append(step)
        self.metrics.append(metrics)
        self.ends.append(time.perf_counter())

    def after_run(self) -> None:
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0

    def report(self) -> dict:
        losses = [{k: float(v) for k, v in m.items()} for m in self.metrics]
        n = max(len(self.steps), 1)
        ends = [self.t0, *self.ends]
        return {"steps": self.steps, "host_s": self.seconds, "host_ms_per_step": 1e3 * self.seconds / n,
                "save_s": list(self.saves),
                "host_ms_per_step_without_saves": 1e3 * (self.seconds - sum(self.saves)) / n,
                "step_end_host_ms_unsynchronised": [1e3 * (b - a) for a, b in zip(ends, ends[1:])],
                "losses_finite": all(np.isfinite(list(m.values())).all() for m in losses),
                "loss_per_step": [m["loss"] for m in losses]}


def register_recorder() -> None:
    from vector_quantization_tpu_torch.registries import CallbackRegistry

    if "SmokeStepRecorder" not in CallbackRegistry.keys():
        CallbackRegistry.register("SmokeStepRecorder")(StepRecorder)


def recorder_of(runner) -> StepRecorder:
    return next(cb for cb in runner.callbacks if isinstance(cb, StepRecorder))


def write_overlay(tmp: Path, name: str, base: str, body: str) -> str:
    path = tmp / f"{name}.py"
    path.write_text(f"_base_ = [{str(Path(__file__).resolve().parent / base)!r}]\n{body}")
    return str(path)


def synthetic(size: int, fid_path: Path | None = None) -> str:
    fid = f", fid_path={str(fid_path)!r}" if fid_path else ""
    return (f"dict(_delete_=True, type='SyntheticDataset', size={size}, image_size={IMAGE_SIZE}, "
            f"num_categories=1000{fid})")


@contextlib.contextmanager
def timing(owner, name: str):
    """``owner.name`` wrapped to append each call's host seconds to the
    yielded list, for the block."""
    original, seconds = getattr(owner, name), []

    @functools.wraps(original)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        setattr(owner, name, original)


def cli_fid_path(tmp: Path) -> Path:
    """Where ``cli_fid`` writes the CLI validation set's cache (the
    overlay's ``validator.dataset.fid_path``)."""
    return tmp / "cli_fid" / "synthetic_fid.npz"


def cli_vqgan_config(tmp: Path) -> str:
    """The overlay ``cli_vqgan`` trains: the LlamaGen VQGAN config with
    synthetic 256 px images, batch 12."""
    return write_overlay(tmp, "cli_vqgan", VQGAN_CONFIG, f"""
trainer = dict(
    dataset={synthetic(4 * VQGAN_TRAIN_BATCH)},
    dataloader=dict(_delete_=True, batch_size_in_total={VQGAN_TRAIN_BATCH}, shuffle=True, num_workers=4),
    max_iters={CLI_VQGAN_STEPS},
    callbacks=[dict(type="LogCallback", interval=2), dict(type="TensorBoardCallback", interval=2),
               dict(type="CheckpointCallback", interval=2), dict(type="SmokeStepRecorder")],
)
validator = dict(
    dataset={synthetic(CLI_VAL_IMAGES, cli_fid_path(tmp))},
    dataloader=dict(_delete_=True, batch_size_in_total={CLI_VAL_BATCH}, num_workers=4),
)
""")


def phase_cli_vqgan(tmp: Path, hand_step_ms: float):
    """cli.train twice in this process: 4 iterations, then --auto-resume to 6."""
    from vector_quantization_tpu_torch.cli import train

    register_recorder()
    config = cli_vqgan_config(tmp)
    work = tmp / "cli_vqgan"
    zero_launches()
    _, plain0 = read_launches()
    runs, ok = [], True
    for argv, start, stop in ((["--override", f"trainer.max_iters={CLI_VQGAN_STEPS}"], 0, CLI_VQGAN_STEPS),
                              (["--auto-resume", "--override", f"trainer.max_iters={CLI_RESUME_STEPS}"],
                               CLI_VQGAN_STEPS, CLI_RESUME_STEPS)):
        k1_before = read_launches()[0]["nearest_codes"]
        t0 = time.perf_counter()
        trainer = train.main(["cli_vqgan", config, "--work-dir", str(work), *argv])
        rec = recorder_of(trainer).report()
        run = {"argv": argv, "start_step": trainer.start_step, "end_step": trainer.state.step,
               "k1_launches": read_launches()[0]["nearest_codes"] - k1_before,
               "main_s": time.perf_counter() - t0, **rec}
        runs.append(run)
        ok = ok and (run["start_step"], run["end_step"], run["steps"]) == (start, stop, list(range(start + 1, stop + 1)))
        ok = ok and run["k1_launches"] == stop - start and rec["losses_finite"]
        del trainer
    launches, plain = read_launches()
    ckpts = sorted(p.name for p in (work / "checkpoints").iterdir())
    sizes = {p.parent.name: p.stat().st_size for p in (work / "checkpoints").glob("iter_*/state.pt")}
    row = {"phase": "cli_vqgan", "config": VQGAN_CONFIG, "batch": VQGAN_TRAIN_BATCH, "runs": runs,
           "checkpoints": ckpts, "checkpoint_bytes": sizes, "plain_runs_on_cuda": plain - plain0,
           "vqgan_train_hand_driven_step_ms": hand_step_ms,
           "note": "host ms per step: the run between synchronisations at its ends, first step and "
                   "checkpoint saves included; not gated"}
    emit(row)
    torch.cuda.empty_cache()
    if not (ok and row["plain_runs_on_cuda"] == 0 and {"iter_2", "iter_4", "iter_6"} <= set(ckpts)):
        raise SystemExit("cli_vqgan: a check failed (see the cli_vqgan line)")
    return config, work / "checkpoints" / f"iter_{CLI_RESUME_STEPS}", launches


def phase_cli_fid(config: str, tmp: Path) -> Path:
    """cli.fid over the CLI validation set (64 images in batches of 16):
    the cache ``cli_test``, ``cli_val`` and ``ar_generation_eval`` read."""
    from vector_quantization_tpu_torch.cli import fid
    from vector_quantization_tpu_torch.models.metrics.fid import FIDStatistics
    from vector_quantization_tpu_torch.models.metrics.inception import load_inception

    with timing(FIDStatistics, "update") as update_s:
        path, wall = _timed(lambda: fid.main(["cli_vqgan", config, "--work-dir", str(tmp / "cli_fid"),
                                              "--override", f"validator.fid_batch_size={CLI_VAL_BATCH}"]))
    stats = FIDStatistics.load(path)
    mean, cov = stats.mean, stats.cov
    asym = float(np.abs(cov - cov.T).max())
    # Inception alone on the card: 64 random 256 px images, after a warm-up
    model, random_init = load_inception(None, "cuda")
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (CLI_VAL_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3),
                                                            dtype=np.uint8)).cuda()
    with torch.inference_mode():
        model(u8)
        _, inception_s = _timed(lambda: model(u8))
    del model, u8
    row = {"phase": "cli_fid", "path": Path(path).name, "n": stats.n, "dim": int(mean.shape[0]),
           "batch": CLI_VAL_BATCH, "batches": len(update_s), "main_s": wall,
           "accumulation_host_s": sum(update_s), "mean_finite": bool(np.isfinite(mean).all()),
           "cov_finite": bool(np.isfinite(cov).all()), "cov_max_asymmetry": asym,
           "cov_max_abs": float(np.abs(cov).max()), "inception_random_init": random_init,
           "inception_images_per_s": CLI_VAL_IMAGES / inception_s}
    emit(row)
    torch.cuda.empty_cache()
    if not (Path(path) == cli_fid_path(tmp) and stats.n == CLI_VAL_IMAGES and row["batches"] > 1
            and row["mean_finite"] and row["cov_finite"] and asym <= 1e-12 * row["cov_max_abs"]
            and random_init):
        raise SystemExit("cli_fid: a check failed (see the cli_fid line)")
    return Path(path)


def self_fid(fid_path: Path) -> tuple[float, dict]:
    """A second ``FIDMetric``, its prediction the CLI validation set's own
    originals (their [-1, 1] encoding), against their cache: the FID, and
    the metric's statistics against the cache's (``n`` and the largest
    differences of ``sum`` and ``sum_outer``, each over max|cache|)."""
    from vector_quantization_tpu_torch.data.datasets import SyntheticDataset, collate
    from vector_quantization_tpu_torch.models.metrics.fid import FIDStatistics
    from vector_quantization_tpu_torch.training.metrics import FIDMetric

    metric = FIDMetric(pred="original_image", fid_path=str(fid_path))
    data = SyntheticDataset(size=CLI_VAL_IMAGES, image_size=IMAGE_SIZE, num_categories=1000)
    for start in range(0, CLI_VAL_IMAGES, CLI_VAL_BATCH):
        batch = collate([data[j] for j in range(start, start + CLI_VAL_BATCH)])
        metric.update({"original_image": torch.from_numpy(batch["image"]).cuda(), "batch": batch})
    cache, got = FIDStatistics.load(str(fid_path)), metric.pred_stats
    against = {"n": got.n, "cache_n": cache.n}
    for key in ("sum", "sum_outer"):
        want = getattr(cache, key)
        against[f"{key}_err"] = float(np.abs(getattr(got, key) - want).max() / np.abs(want).max())
    return metric.summary("fid")["fid"], against


def phase_cli_test_tokenize(config: str, ckpt: Path, tmp: Path, fid_path: Path):
    from vector_quantization_tpu_torch.cli import test, tokenize
    from vector_quantization_tpu_torch.data.datasets import SyntheticDataset, collate
    from vector_quantization_tpu_torch.training.metrics import FIDMetric
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.config import load_config

    work = tmp / "cli_test"
    batches = CLI_VAL_IMAGES // CLI_VAL_BATCH
    zero_launches()
    _, plain0 = read_launches()
    with timing(FIDMetric, "summary") as summary_s:
        results = test.main(["cli_vqgan", config, "--work-dir", str(work), "--load-model-from", str(ckpt)])
        fid_self, against_cache = self_fid(fid_path)
    k1_test = read_launches()[0]["nearest_codes"]
    out = Path(tokenize.main(["cli_vqgan", config, "--work-dir", str(work), "--load-model-from", str(ckpt)]))
    launches, plain = read_launches()
    k1_tokenize = launches["nearest_codes"] - k1_test
    # the plain lookup on the tokenized images, the checkpoint's weights
    runner = build_runner(load_config(config), "validator", work_dir=str(work))
    runner.init_state()
    runner.load_model_from(str(ckpt))
    model, data = runner.state.model.eval(), SyntheticDataset(size=CLI_VAL_IMAGES, image_size=IMAGE_SIZE,
                                                              num_categories=1000)
    reps, ids_ok = [], True
    for i in range(batches):
        npz = np.load(out / f"{i}_0.npz")
        items = [data[j] for j in range(i * CLI_VAL_BATCH, (i + 1) * CLI_VAL_BATCH)]
        ids_ok = ids_ok and list(npz["id_"]) == [it.id_ for it in items] and npz["tokens"].shape == (
            CLI_VAL_BATCH, GRID, GRID) and npz["tokens"].dtype == np.int32
        dev = runner.strategy.device
        images = torch.from_numpy(collate(items)["image"]).to(dev)
        reps.append(codes_vs_plain(model, images, torch.from_numpy(npz["tokens"]).to(dev)))
    del runner, model
    torch.cuda.empty_cache()
    row = {"phase": "cli_test_tokenize", "checkpoint": ckpt.name, "metrics": results, "eval_batches": batches,
           "fid_summary_host_s": summary_s[0], "fid_of_originals_against_their_cache": fid_self,
           "fid_of_originals_bound": FID_SELF_BOUND, "originals_stats_vs_cache": against_cache,
           "originals_stats_tol": FID_CACHE_TOL,
           "k1_launches_test": k1_test, "k1_launches_tokenize": k1_tokenize,
           "plain_runs_on_cuda": plain - plain0, "token_files": sorted(p.name for p in out.iterdir()),
           "codes_vs_plain": [{k: r[k] for k in ("rows", "differ", "excused", "near_tie_rows", "tol")}
                              for r in reps]}
    emit(row)
    if not (set(results) == {*CLI_METRICS, "fid_random_init"} and all(np.isfinite(list(results.values())))
            and results["fid_random_init"] == 1.0 and abs(fid_self) < FID_SELF_BOUND
            and against_cache["n"] == against_cache["cache_n"] == CLI_VAL_IMAGES
            and max(against_cache["sum_err"], against_cache["sum_outer_err"]) <= FID_CACHE_TOL
            and k1_test == batches and k1_tokenize == batches and row["plain_runs_on_cuda"] == 0
            and ids_ok and all(r["ok"] for r in reps)):
        raise SystemExit("cli_test_tokenize: a check failed (see the cli_test_tokenize line)")
    return {"cli_test": k1_test, "cli_tokenize": k1_tokenize}, results


def phase_cli_val(config: str, work: Path, test_results: dict) -> int:
    """cli.val over cli_vqgan's three checkpoints, one empty scan allowed;
    iter_6's metrics against cli.test's on it."""
    from vector_quantization_tpu_torch.cli import val
    from vector_quantization_tpu_torch.training.metrics import FIDMetric

    sleeps = []
    saved_time, val.time = val.time, types.SimpleNamespace(sleep=sleeps.append)
    zero_launches()
    _, plain0 = read_launches()
    try:
        with timing(FIDMetric, "summary") as summary_s:
            results, wall = _timed(lambda: val.main(["cli_vqgan", config, "--work-dir", str(work),
                                                     "--max-idle-rounds", "1"]))
    finally:
        val.time = saved_time
    launches, plain = read_launches()
    last = results.get(f"iter_{CLI_RESUME_STEPS}", {})
    rel = {k: abs(last[k] - v) / max(abs(v), 1e-30) for k, v in test_results.items() if k in last}
    batches = CLI_VAL_IMAGES // CLI_VAL_BATCH
    row = {"phase": "cli_val", "validated": list(results), "metrics": results, "main_s": wall,
           "fid_summary_host_s": summary_s, "sleeps": sleeps, "k1_launches": launches["nearest_codes"],
           "expected_k1_launches": batches * 3, "plain_runs_on_cuda": plain - plain0,
           "iter_6_vs_cli_test_rel": rel, "loss_tol": CLI_VAL_LOSS_TOL, "fid_tol": CLI_VAL_FID_TOL}
    emit(row)
    torch.cuda.empty_cache()
    if not (list(results) == ["iter_2", "iter_4", f"iter_{CLI_RESUME_STEPS}"] and not sleeps
            and launches["nearest_codes"] == batches * 3 and row["plain_runs_on_cuda"] == 0
            and set(rel) == set(test_results) and rel["fid"] <= CLI_VAL_FID_TOL
            and all(r <= CLI_VAL_LOSS_TOL for k, r in rel.items() if k != "fid")
            and all(r["fid_random_init"] == 1.0 and np.isfinite(r["fid"]) for r in results.values())):
        raise SystemExit("cli_val: a check failed (see the cli_val line)")
    return launches["nearest_codes"]


def phase_cli_ar(ir_ckpt: Path, tmp: Path, seed: int):
    """build_runner, init_state, the weights, load_ir_from, run:
    cli/train.py's sequence (random Llama-medium weights from ``seed`` stand
    in for ``--load-model-from``; a constant lr of 1e-4 stands in for the
    10,000-step warm-up, whose first lrs of 0, 1e-8 and 2e-8 would leave the
    steps near no-ops). Then the runner is held to hand-driven steps:
    its batches against the loader's order, and its losses against
    ``train_step`` replayed from the same weights on those batches."""
    from vector_quantization_tpu_torch.data.loader import DataLoader
    from vector_quantization_tpu_torch.registries import DatasetRegistry
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax
    from vector_quantization_tpu_torch.utils.config import load_config

    register_recorder()
    config = write_overlay(tmp, "cli_ar", AR_CONFIG, f"""
trainer = dict(
    dataset={synthetic(CLI_AR_BATCH * CLI_AR_STEPS)},
    dataloader=dict(_delete_=True, batch_size_in_total={CLI_AR_BATCH}, shuffle=True, num_workers=4),
    max_iters={CLI_AR_STEPS},
    algorithm=dict(transformer=dict(flash=True), optimizer=dict(schedule=dict(_delete_=True, type="constant"))),
    callbacks=[dict(type="LogCallback", interval={CLI_AR_STEPS}), dict(type="SmokeStepRecorder")],
)
""")
    cfg = load_config(config)
    trainer = build_runner(cfg, "trainer", work_dir=str(tmp / "cli_ar"))
    algo = trainer.algorithm
    n_layers = algo.model.num_layers
    state = trainer.init_state()
    load_ar_from_flax(algo, medium_flax_params(seed + 4))
    ir_before = [p.detach().clone() for p in algo.ir_model.parameters()]
    trainer.state = algo.load_ir_from(state, str(ir_ckpt))
    ir_same = all(torch.equal(p, b) for p, b in zip(algo.ir_model.parameters(), ir_before))
    del ir_before
    before = [p.detach().clone() for p in algo.model.parameters()]
    seen, step = [], algo.train_step

    def recording_step(state, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(state, batch)

    algo.train_step = recording_step
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    trainer.run()
    launches, plain = read_launches()
    algo.train_step = step
    rec = recorder_of(trainer).report()
    unmoved = [n for (n, p), b in zip(algo.model.named_parameters(), before) if torch.equal(p, b)]
    want = {"flash_attention_fwd": 2 * n_layers * CLI_AR_STEPS, "flash_bwd_dkv": n_layers * CLI_AR_STEPS,
            "flash_bwd_dq": n_layers * CLI_AR_STEPS, "nearest_codes": CLI_AR_STEPS}
    t0 = time.perf_counter()
    trainer.save_checkpoint(CLI_AR_STEPS)
    save_s = time.perf_counter() - t0
    saved = tmp / "cli_ar" / "checkpoints" / f"iter_{CLI_AR_STEPS}" / "state.pt"
    # the loader's own batches for the run's epoch, host side
    loader = DataLoader(DatasetRegistry.build(cfg["trainer"]["dataset"]), **cfg["trainer"]["dataloader"])
    loader.seek(trainer._first_epoch, 0)
    expected = list(itertools.islice(iter(loader), CLI_AR_STEPS))
    batches_ok = len(seen) == len(expected) and all(
        set(b) == set(e) - {"id_"} and all(torch.equal(b[k].cpu(), torch.as_tensor(e[k])) for k in b)
        for b, e in zip(seen, expected))
    # the same steps driven by hand: the run's starting weights, fresh
    # moments and the runner's seed (CFG dropout draws), on the run's batches
    with torch.no_grad():
        for p, b in zip(algo.model.parameters(), before):
            p.copy_(b)
    del before
    replay, hand = algo.init_state(trainer.seed), []
    for batch in seen:
        replay, metrics = algo.train_step(replay, batch)
        hand.append(float(metrics["loss"]))
    runner_losses = rec["loss_per_step"]
    replay_rel = max(abs(a - b) / abs(b) for a, b in zip(runner_losses, hand))
    row = {"phase": "cli_ar", "config": AR_CONFIG, "flash": True, "batch": CLI_AR_BATCH,
           "params": sum(p.numel() for p in algo.model.parameters()), **rec,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "expected_launches": want, "plain_runs_on_cuda": plain - plain0,
           "param_tensors": len(list(algo.model.parameters())), "param_tensors_unmoved": unmoved,
           "lr_per_step": [algo.tx().schedule(c) for c in range(CLI_AR_STEPS)],
           "batches_match_loader": batches_ok, "hand_driven_loss_per_step": hand,
           "runner_vs_hand_loss_max_rel": replay_rel, "runner_vs_hand_loss_tol": CLI_AR_REPLAY_TOL,
           "ir_unchanged_by_load_ir_from": ir_same, "ir_unchanged_expected_from_jax": True,
           "checkpoint_save_s": save_s, "checkpoint_bytes": saved.stat().st_size}
    emit(row)
    del trainer, algo, state, replay, seen
    torch.cuda.empty_cache()
    if not (rec["losses_finite"] and rec["steps"] == list(range(1, CLI_AR_STEPS + 1)) and ir_same
            and not unmoved and runner_losses[-1] < runner_losses[0] and batches_ok
            and replay_rel <= CLI_AR_REPLAY_TOL
            and row["plain_runs_on_cuda"] == 0 and all(launches[k] == v for k, v in want.items())):
        raise SystemExit("cli_ar: a check failed (see the cli_ar line)")
    return launches, config, saved.parent


class GeneratedImages:
    """A metric (registered as ``SmokeGeneratedImages``) that records the
    shape of each batch's ``generated_image`` and whether it is finite."""

    def __init__(self, **kwargs) -> None:
        self.shapes, self.finite = [], True

    def update(self, memo) -> None:
        images = memo["generated_image"]
        self.shapes.append(list(images.shape))
        self.finite = self.finite and bool(torch.isfinite(images).all())

    def summary(self, name: str) -> dict[str, float]:
        GeneratedImages.last = self
        return {f"{name}_finite": float(self.finite)}


def phase_ar_generation_eval(ar_config: str, ar_ckpt: Path, fid_path: Path, tmp: Path) -> dict:
    """configs/ar/generation_eval.py's validator (``eval_generate``, its
    FID of ``generated_image`` and accuracy) over cli_ar's config, through
    cli.test on cli_ar's checkpoint: one batch of 8 classes."""
    from vector_quantization_tpu_torch.cli import test
    from vector_quantization_tpu_torch.registries import MetricRegistry
    from vector_quantization_tpu_torch.utils.config import load_config

    if "SmokeGeneratedImages" not in MetricRegistry.keys():
        MetricRegistry.register("SmokeGeneratedImages")(GeneratedImages)
    evaluation = load_config(str(Path(__file__).resolve().parent / "configs/ar/generation_eval.py"))["validator"]
    metrics = {**evaluation["metrics"], "images": {"type": "SmokeGeneratedImages"}}
    config = write_overlay(tmp, "ar_generation_eval", ar_config, f"""
validator = dict(
    dataset={synthetic(GEN_EVAL_BATCH, fid_path)},
    dataloader=dict(_delete_=True, batch_size_in_total={GEN_EVAL_BATCH}, num_workers=4),
    algorithm=dict(eval_generate={evaluation["algorithm"]["eval_generate"]!r}, transformer=dict(flash=True)),
    metrics=dict(_delete_=True, **{metrics!r}),
)
""")
    zero_launches()
    _, plain0 = read_launches()
    results, wall = _timed(lambda: test.main(["cli_ar", config, "--work-dir", str(tmp / "ar_eval"),
                                              "--load-model-from", str(ar_ckpt)]))
    launches, plain = read_launches()
    n_layers = MEDIUM["num_layers"]
    want = {**dict.fromkeys(launches, 0), "nearest_codes": 1, "flash_attention_fwd": n_layers}
    images = GeneratedImages.last
    row = {"phase": "ar_generation_eval", "config": "configs/ar/generation_eval.py over " + AR_CONFIG,
           "checkpoint": ar_ckpt.name, "metrics": results, "main_s": wall, "generated_shapes": images.shapes,
           "launches": launches, "expected_launches": want, "plain_runs_on_cuda": plain - plain0,
           "note": "visual dumps left out (Pillow may be missing on the card's host); the tokenizer is the "
                   "config's own at the runner's seed (the AR checkpoint's params hold the transformer)"}
    emit(row)
    torch.cuda.empty_cache()
    if not (images.shapes == [[GEN_EVAL_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3]] and images.finite
            and np.isfinite(results["fid"]) and results["fid_random_init"] == 1.0
            and 0.0 <= results["accuracy"] <= 1.0 and launches == want and row["plain_runs_on_cuda"] == 0):
        raise SystemExit("ar_generation_eval: a check failed (see the ar_generation_eval line)")
    return launches


def phase_linear_probe(tmp: Path) -> dict:
    """configs/ic/imagenet_ddp.py through cli.train (3 steps, batch 64 of
    synthetic 256 px images, 1000 classes), then cli.test on its checkpoint;
    every K1 call's shape recorded."""
    from vector_quantization_tpu_torch.cli import test, train
    from vector_quantization_tpu_torch.models.quantizers import vq
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.config import load_config

    register_recorder()
    config = write_overlay(tmp, "linear_probe", PROBE_CONFIG, f"""
trainer = dict(
    dataset={synthetic(PROBE_BATCH * PROBE_STEPS)},
    dataloader=dict(_delete_=True, batch_size_in_total={PROBE_BATCH}, shuffle=True, num_workers=4),
    max_iters={PROBE_STEPS},
    callbacks=[dict(type="LogCallback", interval=1), dict(type="CheckpointCallback", interval={PROBE_STEPS}),
               dict(type="SmokeStepRecorder")],
)
validator = dict(
    dataset={synthetic(PROBE_BATCH)},
    dataloader=dict(_delete_=True, batch_size_in_total={PROBE_BATCH}, num_workers=4),
)
""")
    work = tmp / "linear_probe"
    shapes, lookup = [], vq.vq_quantize  # the quantizer's call of K1's wrapper

    def recording(x, codebook, metric="l2"):
        shapes.append((x.shape[0], codebook.shape[0], x.shape[1], metric))
        return lookup(x, codebook, metric)

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    vq.vq_quantize = recording
    try:
        trainer = train.main(["linear_probe", config, "--work-dir", str(work)])
        peak = torch.cuda.max_memory_allocated() / 2**30
        k1_train = len(shapes)
        results = test.main(["linear_probe", config, "--work-dir", str(tmp / "probe_test"), "--load-model-from",
                             str(work / "checkpoints" / f"iter_{PROBE_STEPS}")])
    finally:
        vq.vq_quantize = lookup
    launches, plain = read_launches()
    rec = recorder_of(trainer).report()
    fresh = build_runner(load_config(config), "trainer", work_dir=str(tmp / "probe_fresh")).algorithm
    algo = trainer.algorithm
    ir_same = all(torch.equal(a, b) for a, b in zip(algo.ir_model.state_dict().values(),
                                                    fresh.ir_model.state_dict().values()))
    unmoved = [n for (n, a), b in zip(algo.model.state_dict().items(), fresh.model.state_dict().values())
               if torch.equal(a, b)]
    row = {"phase": "linear_probe_train", "config": PROBE_CONFIG, "batch": PROBE_BATCH, **rec,
           "peak_memory_gib": peak, "metrics": results, "k1_shapes": sorted(set(shapes)),
           "k1_launches_train": k1_train, "k1_launches_test": len(shapes) - k1_train,
           "k1_launches": launches["nearest_codes"], "plain_runs_on_cuda": plain - plain0,
           "ir_unchanged": ir_same, "head_tensors_unmoved": unmoved,
           "ir_params": sum(p.numel() for p in algo.ir_model.parameters()),
           "head_params": sum(p.numel() for p in algo.model.parameters())}
    emit(row)
    del trainer, algo, fresh
    torch.cuda.empty_cache()
    if not (rec["losses_finite"] and rec["steps"] == list(range(1, PROBE_STEPS + 1)) and ir_same and not unmoved
            and set(shapes) == {PROBE_SHAPE} and k1_train == PROBE_STEPS and len(shapes) == PROBE_STEPS + 1
            and launches["nearest_codes"] == PROBE_STEPS + 1 and row["plain_runs_on_cuda"] == 0
            and 0.0 <= results["accuracy"] <= 1.0):
        raise SystemExit("linear_probe_train: a check failed (see the linear_probe_train line)")
    return {"linear_probe_train": k1_train, "linear_probe_test": len(shapes) - k1_train}


def set_flash(model, flash: bool) -> None:
    for blk in model.blocks():
        blk.flash = flash


def phase_ar_flash_vs_einsum(algo, state, batch) -> None:
    """One step's loss and gradients, same weights and tokens (the first
    64 rows of the codes batch), through the flash kernels and through the
    einsum attention (flash=False, what the shipped config runs); then the
    train step on those 64 rows with each, timed on the host clock (median
    of 3 after one warm-up)."""
    from vector_quantization_tpu_torch.tasks.sequence_modeling import pack_c2i_tokens

    model = algo.model
    tokens = pack_c2i_tokens(batch["category"][:AR_IMAGE_BATCH], batch["codes"][:AR_IMAGE_BATCH],
                             algo.image_codebook)
    params = list(model.parameters())
    out = {}
    for flash in (True, False):
        set_flash(model, flash)
        loss = model(tokens, fused_ce_targets=tokens)
        out[flash] = (float(loss.detach()), torch.autograd.grad(loss, params))
    del loss
    sub = {k: x[:AR_IMAGE_BATCH] for k, x in batch.items()}
    step_ms = {}
    for flash in (True, False):
        set_flash(model, flash)
        times = []
        for _ in range(4):  # a warm-up, then 3 timed steps (train_step updates state in place)
            _, seconds = _timed(lambda: algo.train_step(state, sub))
            times.append(1e3 * seconds)
        step_ms["flash" if flash else "einsum"] = float(np.median(times[1:]))
    set_flash(model, True)
    (lf, gf), (le, ge) = out[True], out[False]
    loss_rel = abs(lf - le) / abs(le)
    grad_rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))
                for a, b in zip(gf, ge)]
    names = [n for n, _ in model.named_parameters()]
    worst = int(np.argmax(grad_rel))
    row = {"phase": "ar_flash_vs_einsum", "batch": AR_IMAGE_BATCH, "loss_flash": lf,
           "loss_einsum": le, "loss_rel_diff": loss_rel, "loss_limit": EINSUM_LOSS_LIMIT,
           "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_max_param": names[worst],
           "grad_rel_l2_median": float(np.median(grad_rel)), "grad_limit": EINSUM_GRAD_LIMIT,
           "train_step_ms_host_clock_median_of_3": step_ms,
           "einsum_over_flash_step": step_ms["einsum"] / step_ms["flash"]}
    emit(row)
    if loss_rel > EINSUM_LOSS_LIMIT or grad_rel[worst] > EINSUM_GRAD_LIMIT:
        raise SystemExit("ar_flash_vs_einsum: the flash and einsum steps disagree")


def profile_ar_step(algo, state, batch) -> None:
    """One codes step under torch.profiler: device time by kernel and the
    device's idle share against the host clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(lambda: algo.train_step(state, batch))
    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise SystemExit("ar_train_profile: the profiler recorded no device time")
    groups = {"flash_attention_kernels": ("flash_",), "matmul_library": ("nvjet", "gemm", "cutlass")}
    by_group = {g: sum(e.self_device_time_total for e in events
                       if any(m in e.key for m in marks)) / 1e3 for g, marks in groups.items()}
    by_group["other"] = device_us / 1e3 - sum(by_group.values())
    emit({"phase": "ar_train_profile", "batch": AR_CODES_BATCH, "host_ms": 1e3 * wall,
          "device_ms": device_us / 1e3, "device_idle_frac": 1.0 - device_us / 1e6 / wall,
          "device_ms_by_group": by_group,
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share": e.self_device_time_total / device_us}
                          for e in events[:12]]})


# the rest of the tokenizer zoo and GPT-2, each at its config's full width,
# f32, batch 12 of 256 px for the VQGAN-family steps (the configs' 96 over
# their 8-way data parallelism)
FSQ_CONFIG = "configs/fsq/8000_imagenet_ddp.py"
STYLEGAN2_CONFIG = "configs/vqgan/8192_stylegan2_imagenet_ddp.py"
CVQ_CONFIG = "configs/cvqvae/8192_dd2_aglwg075_imagenet_ddp.py"
CONVNEXT_CONFIG = "configs/vqkd/convnext_8192_imagenet_ddp.py"
GPT2_CONFIG = "configs/ar/c2i_gpt2_medium_imagenet_ddp.py"
ZOO_BATCH, ZOO_STEPS = 12, 3
FSQ_PARAMS, ZOO_VQGAN_PARAMS, STYLEGAN2_PARAMS = 71_750_792, 73_845_123, 28_864_129
CONVNEXT_VQKD_PARAMS, GPT2_PARAMS = 109_486_144, 320_375_808
GPT2_BATCH, GPT2_STEPS, GPT2_GEN_CLASSES, GPT2_REQUESTS, GPT2_DECODE_STEPS = 64, 3, 8, 16, 32
# the f32 GEMM's products a train step (ops/f32_gemm.py): 24 layers x 4 dense and the tied head,
# each forward, input gradient and weight gradient
GPT2_PRODUCTS = (24 * 4 + 1) * 3
# GPT-2 medium's dense layers (name, in, out), width and vocabulary: F1's shapes
GPT2_DENSE = (("c_attn", 1024, 3072), ("c_proj", 1024, 1024), ("mlp_fc", 1024, 4096), ("mlp_proj", 4096, 1024))
GPT2_WIDTH, GPT2_VOCAB = 1024, 17384
# F1's error against a float64 product (max|got - ref| / max|ref|): at most F32_GEMM_CUBLAS_X times the
# plain f32 product's (cuBLAS on the CUDA cores), and under 1 / F32_GEMM_TF32_DIV of TF32's
# (allow_tf32): the limits of tests/test_torch_cuda.py
F32_GEMM_CUBLAS_X, F32_GEMM_TF32_DIV = 4, 50
GPT2_DECODE_LIMIT = 1e-4  # cached decode vs the full forward, of max|ref| (f32, TF32 off)


def zoo_batch(seed: int, dev) -> dict:
    from vector_quantization_tpu_torch.data.base import pixel_encode

    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (ZOO_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    return {"image": pixel_encode(torch.from_numpy(u8).to(dev))}


def zoo_algorithm(cfg_path: str, seed: int, dev, codebook_update: dict | None = None):
    """:func:`make_vqgan_algorithm`'s build (the generator's weights from
    :func:`load_random_flax_weights`, any discriminator at its own init
    under ``seed``), with ``codebook_update`` merged over the config's."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / cfg_path))["trainer"]["algorithm"]
    if codebook_update:
        cfg["codebook_update"] = {**cfg["codebook_update"], **codebook_update}
    torch.manual_seed(seed)
    algo = AlgorithmRegistry.build(cfg, device=dev)
    load_random_flax_weights(algo.model, seed)
    return algo


def zoo_steps(algo, state, batch, steps: int, check=None) -> list[dict]:
    """``steps`` train steps on ``batch``: host ms, metrics, K1's launches
    per step and whatever ``check(state)`` reports after each."""
    rows = []
    for _ in range(steps):
        k1_before = read_launches()[0]["nearest_codes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = algo.train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
        rows.append({"step": state.step - 1, "ms": 1e3 * (time.perf_counter() - t0), "metrics": metrics,
                     "k1_launches": read_launches()[0]["nearest_codes"] - k1_before,
                     **(check(state) if check else {})})
    return rows


def finite(rows) -> bool:
    return all(np.isfinite(list(r["metrics"].values())).all() for r in rows)


def phase_fsq_train(dev, seed: int):
    """FSQ (configs/fsq/8000_imagenet_ddp.py: VQGAN width 128, levels (8, 8,
    5, 5, 5), no codebook): 3 ReconstructionAlgorithm steps, then encode and
    decode the batch. No nearest-code lookup on this path: K1 must not
    launch."""
    algo = zoo_algorithm(FSQ_CONFIG, seed, dev)
    model = algo.model
    batch = zoo_batch(seed + 20, dev)
    state = algo.init_state(seed)
    before = snapshot(model)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    rows = zoo_steps(algo, state, batch, ZOO_STEPS)
    tensors_moved = moved(model, before)
    del before
    with torch.no_grad():
        codes, enc_s = _timed(lambda: model.encode_to_quant(batch["image"]))
        images, dec_s = _timed(lambda: model.decode_from_quant(codes))
        z = model(batch["image"])["quantizer"].z
        direct = model.decode(z)
    launches, plain = read_launches()
    step_ms = float(np.median([r["ms"] for r in rows]))
    decode_gap = float((images - direct).abs().max() / direct.abs().max())
    row = {"phase": "fsq_train", "config": FSQ_CONFIG, "dtype": "float32", "levels": list(model.quantizer.levels),
           "params": sum(p.numel() for p in model.parameters()), "batch": ZOO_BATCH, "image_size": IMAGE_SIZE,
           "steps": rows, "step_ms_median": step_ms, "images_per_s": ZOO_BATCH / step_ms * 1e3,
           "encode_images_per_s": ZOO_BATCH / enc_s, "decode_images_per_s": ZOO_BATCH / dec_s,
           "codes_shape": list(codes.shape), "codes_min": int(codes.min()), "codes_max": int(codes.max()),
           "decode_from_quant_vs_decoder_on_z": decode_gap,
           "tensors_moved": len(tensors_moved), "tensors": len(model.state_dict()),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "plain_runs_on_cuda": plain - plain0}
    emit(row)
    ok = (finite(rows) and row["tensors_moved"] == row["tensors"] and launches["nearest_codes"] == 0
          and plain == plain0 and 0 <= row["codes_min"] and row["codes_max"] < 8000
          and codes.shape == (ZOO_BATCH, GRID, GRID) and decode_gap <= 1e-5
          and images.shape == (ZOO_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) and row["params"] == FSQ_PARAMS)
    if not ok:
        raise SystemExit("fsq_train: a check failed (see the fsq_train line)")
    return launches, lambda: profile_train_step("fsq_train_profile", lambda: algo.train_step(state, batch),
                                                batch=ZOO_BATCH, step=state.step)


def phase_vqgan_stylegan2_train(dev, seed: int):
    """configs/vqgan/8192_stylegan2_imagenet_ddp.py: the VQGAN (width 128,
    8192 x 256 l2 codebook) against the StyleGAN2 discriminator at 256 px,
    the GAN on from step 0 (the config's ``discriminator_start``)."""
    algo = zoo_algorithm(STYLEGAN2_CONFIG, seed, dev)
    model, disc = algo.model, algo.discriminator
    batch = zoo_batch(seed + 21, dev)
    state = algo.init_state(seed)
    g_before, d_before = snapshot(model), snapshot(disc)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    rows = zoo_steps(algo, state, batch, ZOO_STEPS)
    g_moved, d_moved = moved(model, g_before), moved(disc, d_before)
    del g_before, d_before
    launches, plain = read_launches()
    rep = codes_vs_plain(model, batch["image"])
    step_ms = float(np.median([r["ms"] for r in rows]))
    row = {"phase": "vqgan_stylegan2_train", "config": STYLEGAN2_CONFIG, "dtype": "float32",
           "generator_params": sum(p.numel() for p in model.parameters()),
           "discriminator_params": sum(p.numel() for p in disc.parameters()),
           "discriminator_start": algo.d_start, "r1_weight": algo.r1_weight, "batch": ZOO_BATCH,
           "steps": rows, "step_ms_median": step_ms, "images_per_s": ZOO_BATCH / step_ms * 1e3,
           "generator_tensors_moved": len(g_moved), "generator_tensors": len(model.state_dict()),
           "discriminator_tensors_moved": len(d_moved), "discriminator_tensors": len(disc.state_dict()),
           "discriminator_tensors_unmoved": sorted(set(disc.state_dict()) - set(d_moved)),
           "d_batch_stats": sorted(state.extra["d_batch_stats"]),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "plain_runs_on_cuda": plain - plain0,
           "codes_vs_plain": {k: rep[k] for k in ("shape", "rows", "differ", "excused", "near_tie_rows", "tol")}}
    emit(row)
    # the hinge loss gives the logit's bias the gradient (#fake − #real logits
    # inside the margin (−1, 1)) / B: exactly 0 while every logit lies inside,
    # so ``fc2.bias`` may stay; every other tensor must move
    ok = (finite(rows) and all(r["k1_launches"] == 1 and r["metrics"]["d_loss"] != 0 for r in rows)
          and len(g_moved) == row["generator_tensors"] and set(disc.state_dict()) - set(d_moved) <= {"fc2.bias"}
          and not state.extra["d_batch_stats"] and plain == plain0 and rep["ok"]
          and rep["shape"] == [ZOO_N, 8192, 256] and row["discriminator_params"] == STYLEGAN2_PARAMS
          and row["generator_params"] == ZOO_VQGAN_PARAMS)
    if not ok:
        raise SystemExit("vqgan_stylegan2_train: a check failed (see the vqgan_stylegan2_train line)")
    return launches, lambda: profile_train_step("vqgan_stylegan2_train_profile",
                                                lambda: algo.train_step(state, batch), batch=ZOO_BATCH,
                                                step=state.step)


def rows_in(anchors: torch.Tensor, pool: torch.Tensor) -> bool:
    """Whether every row of ``anchors`` is a row of ``pool``, bit for bit:
    each anchor's hash (a random f64 projection) found among the pool's,
    then the matched rows compared whole."""
    r = torch.randn(pool.shape[1], dtype=torch.float64, device=pool.device)
    hp, ha = pool.double() @ r, anchors.double() @ r
    order = torch.argsort(hp)
    at = torch.searchsorted(hp[order], ha).clamp(max=len(hp) - 1)
    return bool(torch.equal(pool[order[at]], anchors))


def phase_cvq_anchors_train(dev, seed: int):
    """CVQ-VAE (configs/cvqvae/8192_dd2_aglwg075_imagenet_ddp.py: the
    VQGAN recipe, cosine 8192 x 256 codebook, PatchGAN depth 2, CVQ after
    each step): 3 steps with ``anchor="cached"``, then one step each with
    ``"multinomial"`` and ``"random"``. Each step's anchors are read as the
    update draws them, with the features and the cache they came from."""
    from vector_quantization_tpu_torch.ops import codebook as cb_ops

    algo = zoo_algorithm(CVQ_CONFIG, seed, dev, {"anchor": "cached"})
    model = algo.model
    batch = zoo_batch(seed + 22, dev)
    state = algo.init_state(seed)
    drawn = {}
    draw = cb_ops.cvq_anchors

    def spied(x, d, anchor="nearest", generator=None, cache=None):
        anchors = draw(x, d, anchor, generator, cache)
        n, k = x.shape[0], d.shape[1]
        if anchor == "random" and n < k:  # the N features in order, then K − N rows of noise
            pool, ok = x, torch.equal(anchors[:n], x) and bool(((anchors[n:] >= 0) & (anchors[n:] < 1)).all())
        else:  # cached: drawn from the features and the previous anchors
            pool = torch.cat([x, cache]) if anchor == "cached" and n < k else x
            ok = rows_in(anchors, pool)
        drawn.update(anchor=anchor, rows_in_pool=ok, pool_rows=pool.shape[0], anchors=anchors)
        return anchors

    def check(state) -> dict:
        anchors = drawn.pop("anchors")
        out = dict(drawn, probability_sum=float(state.extra["probability"].sum()))
        if drawn["anchor"] == "cached":
            out["cache_is_anchors"] = bool(torch.equal(state.extra["anchor_cache"], anchors))
            out["cache_changed"] = not torch.equal(state.extra["anchor_cache"], cache_before.pop())
        return out

    cb_ops.cvq_anchors = spied
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    rows = []
    try:
        for anchor, steps in (("cached", ZOO_STEPS), ("multinomial", 1), ("random", 1)):
            algo.codebook_update["anchor"] = anchor
            for _ in range(steps):
                cache_before = [state.extra["anchor_cache"].clone()]
                rows += zoo_steps(algo, state, batch, 1, check)
    finally:
        cb_ops.cvq_anchors = draw
    launches, plain = read_launches()
    rep = codes_vs_plain(model, batch["image"])
    row = {"phase": "cvq_anchors_train", "config": CVQ_CONFIG, "dtype": "float32",
           "distance": model.quantizer.distance, "batch": ZOO_BATCH, "steps": rows,
           "step_ms_median": float(np.median([r["ms"] for r in rows])),
           "anchor_cache_shape": list(state.extra["anchor_cache"].shape),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "plain_runs_on_cuda": plain - plain0,
           "codes_vs_plain": {k: rep[k] for k in ("shape", "rows", "differ", "excused", "near_tie_rows", "tol")}}
    emit(row)
    ok = (finite(rows) and all(r["k1_launches"] == 1 and r["rows_in_pool"] for r in rows)
          and [r["anchor"] for r in rows] == ["cached"] * ZOO_STEPS + ["multinomial", "random"]
          and all(r["cache_is_anchors"] and r["cache_changed"] for r in rows[:ZOO_STEPS])
          and plain == plain0 and rep["ok"] and rep["shape"] == [ZOO_N, 8192, 256]
          and model.quantizer.distance == "cosine" and row["anchor_cache_shape"] == [8192, 256])
    if not ok:
        raise SystemExit("cvq_anchors_train: a check failed (see the cvq_anchors_train line)")
    return launches


def make_gpt2_algorithm(seed: int, dev, vqgan):
    """ARAlgorithm from configs/ar/c2i_gpt2_medium_imagenet_ddp.py (GPT-2
    medium, f32, no remat, no CFG) through the port's config loader and
    registry, at the transformer's own random init under ``seed``; the
    tokenizer is phase ``tokenizer``'s VQGAN. A constant lr of 1e-4 in place
    of the config's 10,000-step warm-up (whose first lrs, 0 and 1e-8, leave
    a LayerNorm scale of 1 unmoved in f32)."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / GPT2_CONFIG))["trainer"]["algorithm"]
    cfg["transformer"]["seed"] = seed
    cfg["optimizer"]["schedule"] = {"type": "constant"}
    cfg["ir"] = vqgan
    return AlgorithmRegistry.build(cfg, device=dev), cfg


def gpt2_products(rows: int) -> list[tuple[str, tuple, tuple, str]]:
    """(name, a's shape, b's shape, layout) of GPT-2 medium's 15 products of
    a train step at ``rows`` rows, as ``ops/f32_gemm.Product`` passes them
    to the kernel: each dense layer's forward ``x @ w``, input gradient
    ``gy @ w.T`` and weight gradient ``x.T @ gy``, the tied head's
    ``h @ wte.T``, ``gy @ wte`` and ``gy.T @ h``. ``a.T`` / ``b.T``: that
    operand is the transpose of a contiguous tensor of the shape given."""
    out = []
    for name, k, n in GPT2_DENSE:
        out += [(f"{name}.fwd", (rows, k), (k, n), ""), (f"{name}.dx", (rows, n), (k, n), "b.T"),
                (f"{name}.dw", (rows, k), (rows, n), "a.T")]
    out += [("head.fwd", (rows, GPT2_WIDTH), (GPT2_VOCAB, GPT2_WIDTH), "b.T"),
            ("head.dh", (rows, GPT2_VOCAB), (GPT2_VOCAB, GPT2_WIDTH), ""),
            ("head.dwte", (rows, GPT2_VOCAB), (rows, GPT2_WIDTH), "a.T")]
    return out


def gpt2_operands(spec, gen, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """N(0, 1) operands (a, b) of one of ``gpt2_products``, laid out as it says."""
    _, sa, sb, how = spec
    a = torch.randn(sa, generator=gen, device=dev)
    b = torch.randn(sb, generator=gen, device=dev)
    return (a.t() if how == "a.T" else a), (b.t() if how == "b.T" else b)


def phase_f32_gemm(dev, gen) -> dict:
    """F1 (``ops/f32_gemm.matmul``) at GPT-2 medium's 15 products of a train
    step, 64 x 257 rows, in the layouts ``Product`` passes: against its plain
    version and a float64 product (errors within the limits of
    ``F32_GEMM_CUBLAS_X`` and ``F32_GEMM_TF32_DIV``), one launch a product,
    and timed beside its bound and the plain version."""
    from vector_quantization_tpu_torch.ops import f32_gemm as fg
    from vector_quantization_tpu_torch.ops.device import card

    def rel(got, ref) -> float:
        return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())

    rows, step = [], dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0)
    for spec in gpt2_products(GPT2_BATCH * SEQ):
        a, b = gpt2_operands(spec, gen, dev)
        (m, k), n = a.shape, b.shape[1]
        ref = a.double() @ b.double()
        before = fg.matmul.launches
        got, want = fg.matmul(a, b), fg.matmul_reference(a, b)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = torch.mm(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        ops, byts = 3 * 2 * m * k * n, 4 * (m * k + k * n + m * n)
        row = {"phase": "f32_gemm", "product": spec[0], "M": m, "K": k, "N": n, "layout": spec[3] or "a @ b",
               "plan": fg.plan(m, k, n, card(dev).sms)._asdict(), "launches": fg.matmul.launches - before,
               "err_kernel": rel(got, ref), "err_plain": rel(want, ref), "err_tf32": rel(tf32, ref),
               "kernel_vs_plain": rel(got, want)}
        del ref, got, want, tf32
        if not (row["launches"] == 1 and row["err_kernel"] <= F32_GEMM_CUBLAS_X * row["err_plain"]
                and row["err_kernel"] < row["err_tf32"] / F32_GEMM_TF32_DIV):
            emit(row)
            raise SystemExit(f"f32_gemm {spec[0]}: a launch count or an error against float64 is out of bounds")
        row.update({"ms": graph_ms([lambda: fg.matmul(a, b)]),
                    "plain_ms": graph_ms([lambda: fg.matmul_reference(a, b)], replays=3),
                    "bound_ms": 1e3 * max(ops / TF32_FLOPS, byts / HBM_BYTES_PER_S), "ops": ops, "bytes": byts})
        each = 1 if spec[0].startswith("head.") else 24  # GPT-2 medium's 24 layers
        for key in step:
            step[key] += each * row[key]
        emit(row)
        rows.append(row)
        del a, b
        torch.cuda.empty_cache()
    return {
        "name": "f32_gemm", "route": "cuda", "source": f"{CSRC}/f32_gemm.cu",
        "replaces": "none: the JAX package leaves GPT-2's products (nn.Dense, the tied head) to XLA",
        "max_abs_err": max(r["err_kernel"] for r in rows), **step,
        "bound_by": "operations", "library_ms": step["plain_ms"],
        "note": ("ms, plain_ms, bound_ms: GPT-2 medium's 291 products of one train step at 16,448 rows "
                 "(the dense layers' 12 x 24, the head's 3), the prologue and split-K sums included; bound_ms: "
                 "3 TF32 products (hi.hi + hi.lo + lo.hi) at 495 TFLOP/s; max_abs_err: the largest "
                 "max|got - ref| / max|ref| against float64; the plain version is the library's f32 "
                 "product (torch.matmul, cuBLAS), so library_ms = plain_ms"),
        "shapes": [{key: r[key] for key in ("product", "M", "K", "N", "layout", "ms", "plain_ms", "bound_ms",
                                              "err_kernel", "err_plain", "err_tf32")} for r in rows],
    }


# the DeepSeek-V3 prior (models/transformers/deepseek_v3.py) at Moonlight-16B-A3B's widths
MOONLIGHT_CONFIG = "benchmark/configs/moonlight_16b_a3b_c2i.json"
# its products through F1 (name, K, N: x (M, K) @ w.T for w (N, K)) at a step's 64 x 257 rows: the four
# MLA projections, the router, the dense layer's and the shared experts' stacked gate+up and down, the head
MOONLIGHT_DENSE = (("q_proj", 2048, 3072), ("kv_a_proj", 2048, 576), ("kv_b_proj", 512, 4096),
                   ("o_proj", 2048, 2048), ("router", 2048, 64), ("ffn.gate_up", 2048, 22528),
                   ("ffn.down", 11264, 2048), ("shared.gate_up", 2048, 5632), ("shared.down", 2816, 2048),
                   ("head", 2048, 17384))
# a routed expert's (the same layouts) at its groups' rows: just above MIN_ROWS, the deployment's mean
# (64 x 257 x 6 / 64), about twice it
MOONLIGHT_EXPERT = (("expert.gate_up", 2048, 2816), ("expert.down", 1408, 2048))
MOONLIGHT_GROUPS = (520, 1542, 3000)
# the layer run's groups of held experts 0-7 (rows), routed by hand over 3000 tokens: 300 and 511 fall to
# torch.matmul, 5-7 take none; each token's other choices go to experts held elsewhere
MOONLIGHT_RUN_GROUPS = (3000, 1542, 300, 520, 511, 0, 0, 0)
MOONLIGHT_RUN_SHAPE = (12, 250)


def moonlight_products() -> list[tuple[str, tuple, tuple, str]]:
    """(name, a's shape, b's shape, layout) of the DeepSeek prior's products
    as ``ops/f32_gemm.Product`` passes them for a weight ``w`` (N, K) used
    transposed: forward ``x @ w.T``, input gradient ``gy @ w``, weight
    gradient ``gy.T @ x``; the experts' at each of ``MOONLIGHT_GROUPS``; and
    both gradient products of an expert's down projection at 1542 rows fed
    an expanded gradient (strides 0, ``a.0``: a ``sum()``'s)."""
    def three(name, m, k, n):
        return [(f"{name}.fwd", (m, k), (n, k), "b.T"), (f"{name}.dx", (m, n), (n, k), ""),
                (f"{name}.dw", (m, n), (m, k), "a.T")]

    out = [p for name, k, n in MOONLIGHT_DENSE for p in three(name, GPT2_BATCH * SEQ, k, n)]
    out += [p for m in MOONLIGHT_GROUPS for name, k, n in MOONLIGHT_EXPERT for p in three(f"{name}@{m}", m, k, n)]
    out += [("expert.down@1542.dx_expanded", (1542, 2048), (2048, 1408), "a.0"),
            ("expert.down@1542.dw_expanded", (1542, 2048), (1542, 1408), "a.0.T")]
    return out


def moonlight_operands(spec, gen, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """N(0, 1) operands (a, b) of one of ``moonlight_products``; ``a.0``: a
    is one N(0, 1) number expanded to a's shape (``a.0.T``: then
    transposed)."""
    _, sa, sb, how = spec
    if how.startswith("a.0"):
        a = torch.randn((), generator=gen, device=dev).expand(sa)
        a = a.t() if how == "a.0.T" else a
        return a, torch.randn(sb, generator=gen, device=dev)
    return gpt2_operands(spec, gen, dev)


def _rel(got, ref) -> float:
    """max|got - ref| / max|ref| (0 where both are 0)."""
    got, ref = got.detach().double(), ref.detach().double()
    den, num = float(ref.abs().max()), float((got - ref).abs().max())
    return num / den if den else num


def _tf32(fn):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _within(err: float, plain: float, tf32: float) -> bool:
    """16a's gates: at most F32_GEMM_CUBLAS_X times the plain f32 error and
    under 1 / F32_GEMM_TF32_DIV of TF32's."""
    return err <= F32_GEMM_CUBLAS_X * plain and err < tf32 / F32_GEMM_TF32_DIV


def phase_deepseek_v3(dev, gen, seed: int) -> dict:
    """F1 on the DeepSeek prior's path at Moonlight's widths. (1) Its products
    (``moonlight_products``) through ``ops/f32_gemm.matmul`` against the
    plain version and float64, at 16a's gates, one launch each. (2) A
    two-layer prior (the dense layer, one MoE layer; no bias anywhere, the
    head untied) forward and backward over 12 x 250 tokens, its held
    experts' groups routed by hand (``MOONLIGHT_RUN_GROUPS``), against
    ``benchmark/reference/deepseek_v3.py`` on the same weights and routes:
    logits and every leaf's gradient within 16a's gates of float64; every
    group's rows counted, F1 launched 3 times a product that takes it,
    groups under MIN_ROWS on torch.matmul. Returns F1's launches on (2)."""
    import copy

    from vector_quantization_tpu_torch.models.transformers.deepseek_v3 import DeepseekV3Transformer
    from vector_quantization_tpu_torch.ops import f32_gemm as fg
    from vector_quantization_tpu_torch.tasks.sequence_modeling import next_token_ce

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from benchmark.reference import deepseek_v3 as ref

    bad = []
    for spec in moonlight_products():
        a, b = moonlight_operands(spec, gen, dev)
        ref64 = a.double() @ b.double()
        before = fg.matmul.launches
        got, want = fg.matmul(a, b), fg.matmul_reference(a, b)
        tf32 = _tf32(lambda: torch.mm(a, b))
        torch.cuda.synchronize()
        row = {"phase": "deepseek_v3_products", "product": spec[0], "M": a.shape[0], "K": a.shape[1],
               "N": b.shape[1], "layout": spec[3] or "a @ b", "launches": fg.matmul.launches - before,
               "err_kernel": _rel(got, ref64), "err_plain": _rel(want, ref64), "err_tf32": _rel(tf32, ref64)}
        emit(row)
        if not (row["launches"] == 1 and _within(row["err_kernel"], row["err_plain"], row["err_tf32"])):
            bad.append(spec[0])
        del a, b, ref64, got, want, tf32
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"deepseek_v3_products: a launch count or an error against float64 is out of bounds: {bad}")

    cfg = json.loads((Path(__file__).resolve().parent / MOONLIGHT_CONFIG).read_text())
    t_cfg = {k: v for k, v in cfg["algorithm"]["transformer"].items() if k != "type"}
    t_cfg.update(num_layers=2, seed=seed, device=dev)
    model = DeepseekV3Transformer(cfg["vocab_size"], cfg["max_position_embeddings"], **t_cfg)
    c = dict(cfg, num_hidden_layers=2)
    with torch.device("meta"):
        reference = ref.DeepseekV3(c)
    reference = reference.to_empty(device=dev)
    reference.load_state_dict(model.state_dict())
    ref64 = copy.deepcopy(reference).double()
    moe = model.moe_layers()[0]

    b, t = MOONLIGHT_RUN_SHAPE
    n, k = b * t, moe.top_k
    rng = np.random.default_rng(seed + 31)
    idx = np.zeros((n, k), dtype=np.int64)
    start = 0
    for e, rows in enumerate(MOONLIGHT_RUN_GROUPS[1:], start=1):  # expert 0 takes every token first
        idx[start:start + rows, 1] = e
        start += rows
    idx[start:, 1] = len(MOONLIGHT_RUN_GROUPS)  # the first expert held elsewhere
    idx[:, 0] = 0
    for r in range(n):  # the other choices: distinct experts held elsewhere
        idx[r, 2:] = rng.choice(np.arange(len(MOONLIGHT_RUN_GROUPS) + 1, moe.num_experts), k - 2, replace=False)
    idx = torch.from_numpy(idx).to(dev)

    def forced(x, _route=moe.route):
        _, _, s = _route(x)
        return idx, moe.weigh(s, idx), s

    moe.route = forced
    tokens = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (b, t))).to(dev)
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]

    def grads_of(module, loss):
        return torch.autograd.grad(loss, list(module.parameters()), allow_unused=True, materialize_grads=True)

    rows0 = list(model.counters["expert_rows"][0])
    plain0 = model.counters["plain_products"]
    zero_launches()
    logits, aux = model(tokens, return_aux=True)
    got = grads_of(model, next_token_ce(logits, tokens) + aux["balance"])
    torch.cuda.synchronize()
    launches, _ = read_launches()
    rows = [a - b for a, b in zip(model.counters["expert_rows"][0], rows0)]
    plain = model.counters["plain_products"] - plain0

    def reference_side(module, tf32: bool = False):
        def run():
            lg, raux = module(tokens, [idx], 0.0, True)
            return lg, grads_of(module, ref.next_token_ce(lg, tokens) + raux["balance"])
        with ref.precision(tf32):
            return run()

    want_logits, want = reference_side(reference)
    tf32_logits, tf32 = reference_side(reference, tf32=True)
    truth_logits, truth = reference_side(ref64)
    errs = {"logits": (_rel(logits, truth_logits), _rel(want_logits, truth_logits), _rel(tf32_logits, truth_logits))}
    zero = []  # leaves whose float64 gradient is 0 (the experts no token chose) and the program's is not
    for name, g, w_, t_, r in zip(names, got, want, tf32, truth):
        if float(r.abs().max()):
            errs[name] = (_rel(g, r), _rel(w_, r), _rel(t_, r))
        elif float(g.abs().max()):
            zero.append(name)
    failing = sorted(name for name, (e, p, t_) in errs.items() if not _within(e, p, t_))
    kernel_groups = sum(r >= fg.MIN_ROWS for r in MOONLIGHT_RUN_GROUPS)
    # Product calls: 4 MLA projections a layer, the dense layer's 2, the router, the shared experts' 2,
    # 2 a group of at least MIN_ROWS rows, the head; each launches its forward and two gradients
    want_launches = 3 * (2 * 4 + 2 + 1 + 2 + 2 * kernel_groups + 1)
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
    row = {"phase": "deepseek_v3", "config": MOONLIGHT_CONFIG, "layers": 2, "tokens": [b, t],
           "params": sum(p.numel() for p in params), "group_rows": rows, "group_rows_planned": list(MOONLIGHT_RUN_GROUPS),
           "f32_gemm_launches": launches["f32_gemm"], "f32_gemm_split_launches": launches["f32_gemm_split"],
           "f32_gemm_launches_expected": want_launches, "plain_products": plain,
           "plain_products_expected": 2 * sum(0 < r < fg.MIN_ROWS for r in MOONLIGHT_RUN_GROUPS),
           "err_logits": errs["logits"], "worst_leaf": {worst: errs[worst]},
           "max_err_kernel": max(e for e, _, _ in errs.values()), "max_err_plain": max(p for _, p, _ in errs.values()),
           "min_err_tf32": min(t_ for _, _, t_ in errs.values() if t_), "failing": failing,
           "nonzero_where_zero": zero}
    emit(row)
    if not (rows == list(MOONLIGHT_RUN_GROUPS) and launches["f32_gemm"] == want_launches
            and plain == row["plain_products_expected"] and not failing and not zero):
        raise SystemExit("deepseek_v3: a check failed (see the deepseek_v3 line)")
    del model, reference, ref64, got, want, tf32, truth
    torch.cuda.empty_cache()
    return launches


def phase_ar_gpt2(vqgan, dev, seed: int):
    """GPT-2 medium C2I: 3 train steps on 64 random images (K1 -> the dense
    head -> next-token CE -> AdamW); the cached decode's logits against the
    full forward's; ``generate_step`` for 8 classes through the VQGAN
    decoder; a dense ``ARServer`` (the per-row scatter engine) over 16
    requests. JAX's GPT-2 reaches no Pallas kernel: K4 must not launch."""
    from vector_quantization_tpu_torch.data.base import pixel_encode
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    algo, cfg = make_gpt2_algorithm(seed, dev, vqgan)
    model = algo.model
    rng = np.random.default_rng(seed + 23)
    u8 = rng.integers(0, 256, (GPT2_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    batch = {"image": pixel_encode(torch.from_numpy(u8).to(dev)),
             "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, GPT2_BATCH)).to(dev)}
    before = [p.detach().clone() for p in model.parameters()]
    state = algo.init_state(seed)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    rows = zoo_steps(algo, state, batch, GPT2_STEPS)
    changed = [not torch.equal(p, b) for p, b in zip(model.parameters(), before)]
    del before
    train_launches = read_launches()[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median([r["ms"] for r in rows]))

    # the cached decode (a 1-token prefill, then single steps) against the full forward
    tokens = torch.from_numpy(rng.integers(0, model.vocabulary_size, (8, 1 + GPT2_DECODE_STEPS))).to(dev)
    with torch.no_grad():
        full = model(tokens)
        cache = model.init_cache(8, dtype=torch.float32)
        steps = []
        for t in range(1 + GPT2_DECODE_STEPS):
            logits, cache = model(tokens[:, t:t + 1], cache)
            steps.append(logits[:, 0])
        decode_gap = float((torch.stack(steps, 1) - full).abs().max() / full.abs().max())
    del full, cache, steps

    gen = torch.Generator(device=dev).manual_seed(seed)
    category = torch.arange(0, NUM_CATEGORIES, NUM_CATEGORIES // GPT2_GEN_CLASSES, device=dev)[:GPT2_GEN_CLASSES]
    images, gen_s = _timed(lambda: algo.generate_step(state, category, gen))

    server = ARServer(model, None, algo.image_codebook, image_tokens=IMAGE_TOKENS, batch_slots=GPT2_REQUESTS,
                      sampler=algo.sampler, steps_per_sync=1, cache_dtype=torch.float32, seed=seed, device=dev)
    for i in range(GPT2_REQUESTS):
        server.submit(category=i)
    done, serve_s = _timed(lambda: dict(server.run_until_drained()))
    launches, plain = read_launches()
    k1_train, k1_all = train_launches["nearest_codes"], launches["nearest_codes"]
    k4 = sum(launches[k] for k in ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    row = {"phase": "ar_gpt2", "config": GPT2_CONFIG, "params": sum(p.numel() for p in model.parameters()),
           "dtype": str(model.dtype).removeprefix("torch."), "vocabulary_size": model.vocabulary_size,
           "max_length": model.max_length, "fused_ce": algo._use_fused(), "batch": GPT2_BATCH, "seq": SEQ,
           "steps": rows, "step_ms_median": step_ms, "tokens_per_s": GPT2_BATCH * SEQ / step_ms * 1e3,
           "peak_memory_gib": peak_gib, "param_tensors_changed": int(sum(changed)), "param_tensors": len(changed),
           "decode_steps": GPT2_DECODE_STEPS, "cached_vs_full_rel": decode_gap,
           "cached_vs_full_limit": GPT2_DECODE_LIMIT,
           "generate_classes": GPT2_GEN_CLASSES, "generate_s": gen_s,
           "generate_tokens_per_s": GPT2_GEN_CLASSES * IMAGE_TOKENS / gen_s,
           "images_shape": list(images.shape), "images_finite": bool(torch.isfinite(images).all()),
           "serving_engine": "shared_column" if server._shared_col else "scatter",
           "served": len(done), "serve_s": serve_s, "serve_tokens_per_s": len(done) * IMAGE_TOKENS / serve_s,
           "k1_launches_train": k1_train, "k1_launches_per_step": [r["k1_launches"] for r in rows],
           "f32_gemm_launches_per_step": train_launches["f32_gemm"] / GPT2_STEPS,
           "f32_gemm_split_launches_per_step": train_launches["f32_gemm_split"] / GPT2_STEPS,
           "f32_gemm_launches_expected_per_step": GPT2_PRODUCTS,
           "k4_launches": k4, "launches": launches, "plain_runs_on_cuda": plain - plain0}
    emit(row)
    ok = (finite(rows) and all(r["k1_launches"] == 1 for r in rows) and k4 == 0 and all(changed)
          and launches["f32_gemm"] == train_launches["f32_gemm"] == GPT2_PRODUCTS * GPT2_STEPS
          and plain == plain0 and decode_gap <= GPT2_DECODE_LIMIT and row["images_finite"]
          and images.shape == (GPT2_GEN_CLASSES, IMAGE_SIZE, IMAGE_SIZE, 3) and not algo._use_fused()
          and sorted(done) == list(range(GPT2_REQUESTS)) and not server._shared_col
          and all(c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all() for c in done.values())
          and row["params"] == GPT2_PARAMS)
    if not ok:
        raise SystemExit("ar_gpt2: a check failed (see the ar_gpt2 line)")
    del server, images
    return launches, lambda: profile_train_step("ar_gpt2_profile", lambda: algo.train_step(state, batch),
                                                batch=GPT2_BATCH, step=state.step)


# the last single-device slice: the VQGAN + VQ-KD hybrid, w8a8 serving and
# selective checkpointing
HYBRID_TEACHER_IMAGE = 224  # CLIP ViT-B/16's own input: a 14 x 14 map, resized to the 16 x 16 grid
HYBRID_BRANCH_PARAMS = 22_470_944  # the branch: the 8 -> 32 connector and the 3-block decoder to 512
W8A8_REQUESTS = 16
# one w8a8 decode step's logits against the weight-only step's (the same
# weights, pool and tokens): the activations' per-row int8 rounding (JAX's
# docstring: ~0.5% relative a product) compounded over 24 bf16 layers of
# random weights, which amplify any perturbation (decode_step's bf16
# summation order alone moves the logits by 2.7e-2-3.0e-2 of max|ref|); a
# relative L2 error and a share of equal argmaxes, set at about twice the
# first measurement (0.120, 0.766; NVIDIA H100 80GB HBM3, 700 W)
W8A8_REL_L2_LIMIT, W8A8_ARGMAX_MIN = 0.25, 0.5
# the w8a8 step through the card's kernels against the same step through the
# plain versions: each block alone within decode_step's 1e-2 of max|out|;
# the logits after 24 layers within 1e-1 of max|ref| (decode_step's 5e-2
# doubled: the activation quantisation turns K3's bf16 summation-order
# differences into whole int8 steps, which the random weights amplify;
# measured 2.4e-2 and 4.3e-2 in two runs, argmax agreement 0.98 and 1.0)
W8A8_PLAIN_LIMIT = 1e-1
DOTS_GRAD_REL_LIMIT = 1e-6  # remat_policy="dots" against full remat: the same kernels, expected exact


def hybrid_config() -> dict:
    """The hybrid's algorithm config (no shipped config names it): the
    LlamaGen VQGAN trainer of ``VQGAN_CONFIG`` (16384 x 8 unit codebook,
    PatchGAN, LPIPS, its own ``normalize`` update) with the model made a
    ``VQGANVQKDModel`` whose branch is ``configs/vqkd``'s decoder (a
    ``ViTDecoder`` of depth 3 to 512 features, ``in_channels`` 32) on the
    16 x 16 code grid behind a ``ConvConnector``, and the VQ-KD config's
    teacher (``CLIPTeacher``, projection 512) at 224 px, its 14 x 14 map
    resized to 16 x 16."""
    from vector_quantization_tpu_torch.utils.config import Config

    root = Path(__file__).resolve().parent
    cfg = Config.load(str(root / VQGAN_CONFIG))["trainer"]["algorithm"]
    vqkd = Config.load(str(root / VQKD_CONFIG))["trainer"]["algorithm"]
    cfg["type"] = "VQGANVQKDAlgorithm"
    cfg["model"] = dict(cfg["model"], type="VQGANVQKDModel", vqkd_pre_decode=dict(type="ConvConnector"),
                        vqkd_decoder=dict(vqkd["model"]["decoder"], img_size=GRID))
    cfg["teacher"] = dict(vqkd["teacher"], image_size=HYBRID_TEACHER_IMAGE, output_size=GRID)
    return cfg


def phase_hybrid_train(dev, seed: int):
    """``VQGANVQKDAlgorithm`` at :func:`hybrid_config`'s full width, f32:
    the VQGAN's weights from :func:`load_random_flax_weights`, the branch,
    the teacher, the discriminator and LPIPS at their own init under
    ``torch.manual_seed(seed)``; batch 12 of random 256 px images, 3 steps
    with the GAN gates off and 3 from ``discriminator_start``."""
    from vector_quantization_tpu_torch.data.base import pixel_encode
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry

    torch.manual_seed(seed)
    algo = AlgorithmRegistry.build(hybrid_config(), device=dev)
    model, disc, teacher = algo.model, algo.discriminator, algo.teacher
    branch = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("vqkd_")}
    load_random_flax_weights(model, seed)
    model.load_state_dict(branch, strict=False)  # the branch keeps its own init
    del branch
    rng = np.random.default_rng(seed + 9)
    u8 = torch.from_numpy(rng.integers(0, 256, (VQGAN_TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8))
    batch = {"image": pixel_encode(u8.to(dev)), "original_image": u8.to(dev)}
    state = algo.init_state(seed)
    teacher_before = snapshot(teacher)
    n_branch = sum(p.numel() for n, p in model.named_parameters() if n.startswith("vqkd_"))
    branch_names = [k for k in model.state_dict() if k.startswith("vqkd_")]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    _, plain0 = read_launches()
    parts, ok = {}, True
    for part, start in (("gates_off", 0), ("gan_on", algo.d_start)):
        state.step = start
        g_before, d_before = snapshot(model), snapshot(disc)
        rows = []
        for _ in range(VQGAN_TRAIN_STEPS):
            k1_before = read_launches()[0]["nearest_codes"]
            (state, metrics), seconds = _timed(lambda: algo.train_step(state, batch))
            metrics = {k: float(v) for k, v in metrics.items()}
            rows.append({"step": state.step - 1, "ms": 1e3 * seconds, "metrics": metrics,
                         "k1_launches": read_launches()[0]["nearest_codes"] - k1_before})
        g_moved, d_moved = moved(model, g_before), moved(disc, d_before)
        del g_before, d_before
        step_ms = float(np.median([r["ms"] for r in rows]))
        gan = part == "gan_on"
        parts[part] = {"start_step": start, "steps": rows, "step_ms_median": step_ms,
                       "images_per_s": VQGAN_TRAIN_BATCH / step_ms * 1e3,
                       "generator_tensors_moved": len(g_moved), "generator_tensors": len(model.state_dict()),
                       "branch_tensors_moved": sum(k in g_moved for k in branch_names),
                       "branch_tensors": len(branch_names),
                       "discriminator_tensors_moved": len(d_moved)}
        ok = ok and all(np.isfinite(list(r["metrics"].values())).all() and r["k1_launches"] == 1
                        and r["metrics"]["loss_distill"] > 0 for r in rows)
        ok = ok and all(k in g_moved for k in branch_names) and (len(d_moved) > 0) == gan
        ok = ok and all((r["metrics"]["g_loss"] != 0) == gan for r in rows)
    launches, plain = read_launches()
    plain_runs = plain - plain0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    teacher_same = not moved(teacher, teacher_before)
    rep = codes_vs_plain(model, batch["image"])
    ok = (ok and teacher_same and plain_runs == 0 and rep["ok"] and n_branch == HYBRID_BRANCH_PARAMS
          and launches["nearest_codes"] == 2 * VQGAN_TRAIN_STEPS
          and sum(p.numel() for n, p in model.named_parameters() if not n.startswith("vqkd_")) == VQGAN_PARAMS)
    emit({"phase": "hybrid_train", "config": f"{VQGAN_CONFIG} + configs/vqkd decoder and CLIP teacher",
          "dtype": "float32", "generator_params": sum(p.numel() for p in model.parameters()),
          "branch_params": n_branch, "teacher_params": sum(p.numel() for p in teacher.parameters()),
          "teacher_grid": [teacher.image_size, teacher.output_size], "codebook_update": algo.codebook_update,
          "batch": VQGAN_TRAIN_BATCH, "image_size": IMAGE_SIZE, "parts": parts, "peak_memory_gib": peak_gib,
          "launches": launches, "plain_runs_on_cuda": plain_runs, "teacher_unchanged": teacher_same,
          "codes_vs_plain": {k: rep[k] for k in ("shape", "rows", "differ", "excused", "near_tie_rows", "tol")}})
    if not ok:
        raise SystemExit("hybrid_train: a check failed (see the hybrid_train line)")

    def profile_hybrid_step() -> None:
        profile_train_step("hybrid_train_profile", lambda: algo.train_step(state, batch),
                           batch=VQGAN_TRAIN_BATCH, step=state.step)

    return launches, profile_hybrid_step


def int_mm_row(dev, gen, name: str, b: int, d: int, f: int) -> dict:
    """``int8_mm`` (``torch._int_mm``) against its plain version (exact
    int32 sums) at (b, d) x (d, f), with the weight padded as
    ``prepare_w8a8`` pads it; device times per call by CUDA graph (the
    weight rotated through enough copies to exceed the L2), beside K2's
    weight-only call at the same shape."""
    from vector_quantization_tpu_torch.ops.int8_matmul import int8_matmul, int8_mm, int8_mm_reference, prepare_w8a8

    a = torch.randint(-127, 128, (b, d), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (d, f), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand(f, generator=gen, device=dev) * 0.02
    wp, sp = prepare_w8a8(w, scale)
    got, want = int8_mm(a, wp), int8_mm_reference(a, wp)
    int8_mm_reference.cuda_calls -= 1  # a comparison, not the path
    copies = max(1, -(-64 * 2**20 // (d * wp.shape[1])))
    ws = [wp.clone() for _ in range(copies)]
    x = torch.randn(b, d, generator=gen, device=dev).to(torch.bfloat16)
    ms = graph_ms([functools.partial(int8_mm, a, wi) for wi in ws])
    plain_ms = graph_ms([functools.partial(int8_mm_reference, a, ws[0])], replays=3)
    k2_ms = graph_ms([functools.partial(int8_matmul, x, w, scale)])
    int8_mm.calls = 0
    int8_mm_reference.cuda_calls -= 2  # graph_ms's eager warm-up and its capture
    bound_ms = 1e3 * max((b * d + d * f + 4 * b * f) / HBM_BYTES_PER_S, 2 * b * d * f / INT8_OPS)
    return {"shape": name, "B": b, "D": d, "F": f, "F_padded": wp.shape[1], "exact": bool(torch.equal(got, want)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "k2_weight_only_ms": k2_ms}


def phase_serving_w8a8(dev, gen, seed: int):
    """Llama-medium INT8 with ``quantize_mode="w8a8"`` (fused projections,
    the INT8 head, paged INT8 pool): each projection's int8 product against
    its plain version; one decode step through ``torch._int_mm`` and K3
    against the same step through their plain versions (decode_step's
    limits), and against the weight-only model's step (the activations'
    quantisation error); then ``ARServer(paged=True)`` serving 16
    requests."""
    from vector_quantization_tpu_torch.models.transformers import llama as llama_mod
    from vector_quantization_tpu_torch.ops import int8_matmul as im
    from vector_quantization_tpu_torch.ops.paged_attention import paged_decode_attention_reference
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer

    d, f = MEDIUM["hidden_size"], MEDIUM["ffn_dim"]
    rows = [int_mm_row(dev, gen, name, b, din, fout) for name, b, din, fout in (
        ("qkv", SLOTS, d, 3 * d), ("o", SLOTS, d, d), ("gate_up", SLOTS, d, 2 * f), ("down", SLOTS, f, d),
        ("lm_head", SLOTS, d, VOCAB), ("lm_head_7_rows", 7, d, VOCAB))]
    model = make_medium(seed, dev, quantize_mode="w8a8")
    ref = make_medium(seed, dev)
    tokens, positions, clone = decode_inputs(model, dev, gen)
    blocks = model.blocks()
    ins, outs = [], []
    hooks = [blk.register_forward_pre_hook(lambda m, a: ins.append(a[0].clone())) for blk in blocks]
    hooks += [blk.register_forward_hook(lambda m, a, o: outs.append(o.clone())) for blk in blocks]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    zero_launches()
    with torch.inference_mode():
        got, _ = model(tokens, clone(), slot_positions=positions)
        step_launches, _ = read_launches()
        for hk in hooks:
            hk.remove()
        saved = im.int8_mm, llama_mod.paged_decode_attention
        im.int8_mm, llama_mod.paged_decode_attention = im.int8_mm_reference, paged_decode_attention_reference
        try:
            plain, _ = model(tokens, clone(), slot_positions=positions)
            c = clone()  # each block alone on the kernel path's own input
            block_err = max(rel(blk(ins[i], positions[:, None], c, i, positions), outs[i])
                            for i, blk in enumerate(blocks))
        finally:
            im.int8_mm, llama_mod.paged_decode_attention = saved
        want, _ = ref(tokens, clone(), slot_positions=positions)
        # the first block's own quantisation error: one input through both
        # models' block 0, its update (output - input) compared
        x0 = ins[0]
        d_w8a8 = blocks[0](x0, positions[:, None], clone(), 0, positions).float() - x0.float()
        d_ref = ref.blocks()[0](x0, positions[:, None], clone(), 0, positions).float() - x0.float()
        first_block_rel_l2 = float(torch.linalg.vector_norm(d_w8a8 - d_ref) / torch.linalg.vector_norm(d_ref))
        wall = {"w8a8": step_wall(model, tokens, clone(), positions),
                "weight_only": step_wall(ref, tokens, clone(), positions)}
        device = {"w8a8": step_device(model, tokens, clone(), positions)[0],
                  "weight_only": step_device(ref, tokens, clone(), positions)[0]}
    del ref, ins, outs
    plain_err = rel(got, plain)
    plain_agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    g, w = got.float().flatten(1), want.float().flatten(1)
    rel_l2 = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    max_rel = float((g - w).abs().max() / w.abs().max())
    agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    server = ARServer(
        model, None, TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK), image_tokens=IMAGE_TOKENS,
        batch_slots=SLOTS, sampler=SAMPLER, cfg_alpha=1.75, uncond_token=NUM_CATEGORIES,
        steps_per_sync=STEPS_PER_SYNC, cache_dtype=torch.int8, paged=True, page_size=PAGE_SIZE, seed=seed,
        device=dev,
    )
    rids = [server.submit(category=i % NUM_CATEGORIES) for i in range(W8A8_REQUESTS)]
    steps = []
    hook = model.register_forward_pre_hook(lambda *a: steps.append(1))
    zero_launches()
    _, plain0 = read_launches()
    done, seconds = _timed(lambda: dict(server.run_until_drained()))
    hook.remove()
    launches, plain = read_launches()
    n = len(steps)
    per_step = {k: v / n for k, v in launches.items()}
    ok = (all(r["exact"] for r in rows) and rel_l2 <= W8A8_REL_L2_LIMIT and agree >= W8A8_ARGMAX_MIN
          and plain_err <= W8A8_PLAIN_LIMIT and block_err <= 1e-2 and plain_agree >= 0.9
          and step_launches["paged_decode_attention"] == MEDIUM["num_layers"]
          and step_launches["int8_mm"] == 4 * MEDIUM["num_layers"] + 1
          and sorted(done) == rids and len(server._free_pages) == server._total_pages
          and all(c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all() for c in done.values())
          and launches["paged_decode_attention"] == MEDIUM["num_layers"] * n
          and launches["int8_mm"] == (4 * MEDIUM["num_layers"] + 1) * n
          and k2_launches(launches) == 0 and plain == plain0)
    emit({"phase": "serving_w8a8", "quantize_mode": "w8a8", "B": SLOTS, "vocab": VOCAB, **MEDIUM,
          "int_mm": rows, "decode_step": {
              "max_abs_err_over_max_ref_vs_plain": plain_err, "limit": W8A8_PLAIN_LIMIT,
              "argmax_agree_frac_vs_plain": plain_agree, "per_block_max_err_over_max_ref": block_err,
              "per_block_limit": 1e-2, "first_block_update_rel_l2_vs_weight_only": first_block_rel_l2,
              "rel_l2_vs_weight_only": rel_l2, "rel_l2_limit": W8A8_REL_L2_LIMIT,
              "max_abs_err_over_max_ref": max_rel, "argmax_agree_frac": agree, "argmax_min": W8A8_ARGMAX_MIN,
              "launches": step_launches, "eager_step_ms_host_clock": {k: 1e3 * v for k, v in wall.items()},
              "device_ms_per_step_profiler": {k: 1e3 * v for k, v in device.items()}},
          "requests": W8A8_REQUESTS, "finished": len(done), "decode_steps": n, "wall_s": seconds,
          "effective_tokens_per_s": W8A8_REQUESTS * IMAGE_TOKENS / seconds, "launches": launches,
          "launches_per_step": per_step, "plain_runs_on_cuda": plain - plain0,
          "pages_free": len(server._free_pages), "pages_total": server._total_pages})
    if not ok:
        raise SystemExit("serving_w8a8: a check failed (see the serving_w8a8 line)")
    return launches


def phase_ar_train_remat_dots(algo, batch) -> dict:
    """The ``ar_train`` model (flash on) under ``remat_policy="dots"``,
    against full remat and no remat on the same weights and tokens (the
    codes batch, its categories as given): the loss and every gradient;
    ``aten.mm`` calls in each backward (a dispatch mode); the peak memory
    above the resting state; then 3 train steps under each, timed on the
    host clock, with the kernels' launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from vector_quantization_tpu_torch.tasks.sequence_modeling import pack_c2i_tokens

    class MMs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    model = algo.model
    tokens = pack_c2i_tokens(batch["category"], batch["codes"], algo.image_codebook)
    params = list(model.parameters())
    policies = {"full": (True, None), "dots": (True, "dots"), "none": (False, None)}
    grads, out = {}, {}
    for name, (remat, policy) in policies.items():
        model.remat, model.remat_policy = remat, policy
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = model(tokens, fused_ce_targets=tokens)
        with MMs() as mms:
            g = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[name] = {"loss": float(loss.detach()), "backward_mm_calls": mms.n,
                     "peak_gib_above_resting": (torch.cuda.max_memory_allocated() - base) / 2**30}
        grads[name] = g
        del loss
    rel = max(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))
              for a, b in zip(grads["dots"], grads["full"]))
    del grads
    n_layers = model.num_layers
    for name, (remat, policy) in policies.items():
        model.remat, model.remat_policy = remat, policy
        zero_launches()
        state = algo.init_state(0)
        times = [1e3 * _timed(lambda: algo.train_step(state, batch))[1] for _ in range(3)]
        launches, _ = read_launches()
        out[name].update(step_ms_host_clock=times, step_ms_median=float(np.median(times)),
                         launches_per_step={k: launches[k] / 3 for k in
                                            ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
        if name == "dots":
            dots_launches = launches
    model.remat, model.remat_policy = True, None
    want = {"flash_attention_fwd": 2 * n_layers, "flash_bwd_dkv": n_layers, "flash_bwd_dq": n_layers}
    peaks = [out[k]["peak_gib_above_resting"] for k in ("full", "dots", "none")]
    ok = (out["dots"]["loss"] == out["full"]["loss"] == out["none"]["loss"] and rel <= DOTS_GRAD_REL_LIMIT
          and out["dots"]["backward_mm_calls"] == out["none"]["backward_mm_calls"]
          < out["full"]["backward_mm_calls"]
          and peaks[0] < peaks[1] < peaks[2] and out["dots"]["launches_per_step"] == want)
    emit({"phase": "ar_train_remat_dots", "config": AR_CONFIG, "flash": True, "batch": AR_CODES_BATCH,
          "seq": SEQ, "policies": out, "grad_rel_l2_max_dots_vs_full": rel, "grad_limit": DOTS_GRAD_REL_LIMIT,
          "expected_launches_per_step": want})
    if not ok:
        raise SystemExit("ar_train_remat_dots: a check failed (see the ar_train_remat_dots line)")
    return dots_launches


def phase_zoo(vqgan, dev, seed: int) -> tuple[dict, list, dict]:
    """The five phases of the tokenizer zoo and GPT-2: their K1 launches by
    phase, one-step profiles of four of them (run after the others'
    profiles; CVQ-VAE's step is the VQGAN recipe's, and its models are
    freed here), and every kernel's launches in the GPT-2 phase."""
    out, profiles = {}, []
    for name, run in (("fsq_train", lambda: phase_fsq_train(dev, seed)),
                      ("vqgan_stylegan2_train", lambda: phase_vqgan_stylegan2_train(dev, seed))):
        launches, profile = run()
        out[name] = launches["nearest_codes"]
        profiles.append(profile)
        torch.cuda.empty_cache()
    out["cvq_anchors_train"] = phase_cvq_anchors_train(dev, seed)["nearest_codes"]
    torch.cuda.empty_cache()
    algo, cfg = make_teacher_algorithm(CONVNEXT_CONFIG, seed, dev)
    launches, profile = phase_teacher_train("vqkd_convnext_train", algo, cfg, dev, seed, CONVNEXT_CONFIG,
                                            CONVNEXT_VQKD_PARAMS)
    out["vqkd_convnext_train"] = launches["nearest_codes"]
    profiles.append(profile)
    torch.cuda.empty_cache()
    gpt2_launches, profile = phase_ar_gpt2(vqgan, dev, seed)
    out["ar_gpt2"] = gpt2_launches["nearest_codes"]
    profiles.append(profile)
    torch.cuda.empty_cache()
    return out, profiles, gpt2_launches

# -- parallelism: the strategies under torch.distributed ---------------------
# One card: each strategy runs under a one-rank NCCL group at full width
# (its collectives over one rank), and the data-parallel path also runs in
# two processes sharing the card over gloo (CUDA tensors through gloo's
# all-reduce and broadcast). The cross-rank meaning is held by the CPU tests
# (tests/test_torch_parallel.py).
TP_CONFIG = "configs/ar/c2i_llama_medium_tp_imagenet.py"
# VQ-KD at vqkd_train's batch 64: 12,544 features >= 8192 codes, so the
# lazy init runs its k-means (at 32 it copies the 6,272 features instead)
PAR_STEPS, PAR_VQKD_BATCH, PAR_SERVE_REQUESTS = 2, 64, 16
PAR_AR_STEPS = 3  # timed AR steps; the first warms up (the gathers' first allocations)
# one-rank strategy step vs the unwrapped (or SingleDeviceStrategy) step: the
# loss, and each gradient the optimizer gets, relative to its max|ref| (the
# Llama's) or to the model's largest gradient (the tokenizers': a conv bias
# that GroupNorm cancels has a true gradient of 0 and holds rounding noise,
# which cuDNN's summation order changes from run to run)
PAR_GRAD_REL = 1e-5
# VQ-KD's EMA k-means codebook (unit rows) after the lazy init and 2 steps,
# DP vs SingleDeviceStrategy: read 6.0e-8-1.2e-7 on an H100 (f32 rounding of
# the step-2 features, whose weights Adam moved by +-lr where a gradient is
# rounding noise); the limit is ~8x that
PAR_CODEBOOK_ABS = 1e-6
# two ranks x half the batch vs one rank x the whole batch (SGD, TF32 off):
# the update over all tensors, relative L2, each model's limit ~3x its
# reading on an H100. The f32 VQGAN read 5.5e-7. The Llama computes in
# bf16: its activations and their gradients round to 8 bits differently on
# each split of the batch (9.8e-3)
TWO_RANK_UPDATE_REL = {"vqgan": 2e-6, "ar": 3e-2}
TWO_RANK_BATCH, TWO_RANK_AR_BATCH, TWO_RANK_AR_LAYERS = 4, 16, 4
# SGD: the VQGAN's updates reach ~1 at lr 1e-3; the Llama's gradients are
# ~1e-2, so its lr is 0.5, lifting its updates well above f32 rounding of
# the weights (~1e-7), which at lr 1e-3 was 2% of the largest update
TWO_RANK_LR = {"vqgan": 1e-3, "ar": 0.5}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group():
    """The default process group from torchrun's variables, set here: one
    rank, NCCL (``parallel.mesh.init_distributed``); destroyed on exit."""
    import os

    import torch.distributed as dist
    from vector_quantization_tpu_torch.parallel.mesh import init_distributed

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not init_distributed("cuda") or dist.get_backend() != "nccl":
            raise SystemExit("parallel: no one-rank NCCL group")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def profiled(fn):
    """``fn()`` under torch.profiler (CPU and CUDA): (its result, the names
    of its collectives' events (``c10d::`` ops and NCCL's own), host
    seconds)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    names = {e.key for e in prof.key_averages()}
    return out, sorted(n for n in names if "nccl" in n.lower() or n.startswith("c10d::")), seconds


def has_collective(names: list[str], op: str) -> bool:
    return any(op in n.lower().replace("_", "") for n in names)


def overlay_runner(tmp: Path, name: str, base: str, body: str, dev):
    """``build_runner``'s trainer on an overlay of ``base``."""
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.config import Config

    return build_runner(Config.load(write_overlay(tmp, name, base, body)), "trainer", device=dev,
                        work_dir=str(tmp / name))


def phase_parallel_dp(tmp: Path, dev) -> dict:
    """Two steps of the LlamaGen VQGAN and two of VQ-KD through
    ``build_runner`` with the configs' ``DataParallelStrategy`` under a
    one-rank NCCL group (each step's host ms, synchronised), against the
    same steps under ``SingleDeviceStrategy`` from the same seed: each
    step's loss and the gradients the optimizer gets, the first step's
    held to ``PAR_GRAD_REL`` of the model's largest gradient (Adam then
    moves rounding-noise elements by +-lr, so step 2 starts from weights
    that differ), VQ-KD's codebook to ``PAR_CODEBOOK_ABS``; then one more DP step under torch.profiler for
    the all-reduce."""
    from vector_quantization_tpu_torch.parallel.sharding import DataParallelStrategy, SingleDeviceStrategy

    runs = {"vqgan": (VQGAN_CONFIG, VQGAN_TRAIN_BATCH, IMAGE_SIZE, PAR_STEPS),
            "vqkd": (VQKD_CONFIG, PAR_VQKD_BATCH, TEACHER_IMAGE, 11 + PAR_STEPS - 1)}  # the lazy init: 10 + 1
    rows, total, ok = {}, {"nearest_codes": 0}, True

    def recorded_run(runner, times: list | None = None):
        """``runner.run()``; each step's loss and optimizer gradients (and
        its host ms into ``times``)."""
        step, losses = runner.algorithm.train_step, []

        def traced(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))  # synchronises
            if times is not None:
                times.append(1e3 * (time.perf_counter() - t0))
            return state, metrics

        runner.algorithm.train_step = traced
        with recorded_steps(runner.algorithm.tx(), apply=True) as grads:
            runner.run()
        del runner.algorithm.train_step
        return losses, grads

    for name, (base, batch, size, want_k1) in runs.items():
        body = f"""
trainer = dict(
    dataset=dict(_delete_=True, type='SyntheticDataset', size={2 * batch}, image_size={size}, num_categories=1000),
    dataloader=dict(_delete_=True, batch_size_in_total={batch}, num_workers=2),
    max_iters={PAR_STEPS}, callbacks=[],
)
"""
        with one_rank_group():
            dp = overlay_runner(tmp, f"dp_{name}", base, body, dev)
            times = []
            zero_launches()
            _, plain0 = read_launches()
            dp_losses, dp_grads = recorded_run(dp, times)
            launches, plain = read_launches()
            strategy = dp.strategy
            group_ok = type(strategy) is DataParallelStrategy and strategy.data_group is not None
            single = overlay_runner(tmp, f"single_{name}", base, body + (
                "trainer.update(mesh={'dp': 1}, strategy=dict(type='SingleDeviceStrategy'))\n"), dev)
            losses, grads = recorded_run(single)
            codebook = None
            if name == "vqkd":
                codebook = float((dp.algorithm.model.quantizer.codebook
                                  - single.algorithm.model.quantizer.codebook).abs().max())
            # one more step under torch.profiler: the gradients' all-reduce over NCCL
            host = {k: v for k, v in next(iter(dp.dataloader)).items() if k != "id_"}
            batch_dev = strategy.shard_batch(host)
            _, nccl, _ = profiled(lambda: strategy.train_step(dp.algorithm, dp.state, batch_dev))
        loss_err = [abs(a - b) / abs(b) for a, b in zip(dp_losses, losses)]
        grad_err = [grads_err_of_largest(a, b) for a, b in zip(dp_grads, grads)]
        row = {"config": base, "strategy": type(strategy).__name__, "mesh": strategy.mesh.shape,
               "batch": batch, "steps": PAR_STEPS, "step_ms_host_clock": times, "launches": launches,
               "plain_runs_on_cuda": plain - plain0, "collectives": nccl, "single": type(single.strategy).__name__,
               "losses": dp_losses, "single_losses": losses, "loss_rel_err": loss_err, "grads_max_err_of_largest": grad_err,
               "grads_max_rel_err_per_tensor": [grads_rel_err(a, b) for a, b in zip(dp_grads, grads)],
               "limit_step1": PAR_GRAD_REL}
        ok = (ok and group_ok and isinstance(single.strategy, SingleDeviceStrategy) and single.state.step == PAR_STEPS
              and len(times) == PAR_STEPS and len(dp_grads) == len(grads) == PAR_STEPS
              and launches["nearest_codes"] == want_k1 and plain == plain0 and has_collective(nccl, "allreduce")
              and all(np.isfinite(dp_losses)) and loss_err[0] <= PAR_GRAD_REL and grad_err[0] <= PAR_GRAD_REL)
        if codebook is not None:
            row.update(codebook_max_abs_diff=codebook, codebook_limit=PAR_CODEBOOK_ABS)
            ok = ok and codebook <= PAR_CODEBOOK_ABS
        rows[name] = row
        total["nearest_codes"] += launches["nearest_codes"]
        del dp, single, dp_grads, grads
        torch.cuda.empty_cache()
    emit({"phase": "parallel_dp", **rows})
    if not ok:
        raise SystemExit("parallel_dp: a check failed (see the parallel_dp line)")
    return total


@contextlib.contextmanager
def recorded_steps(tx, apply: bool):
    """``tx.step`` recording each call's gradients (as the optimizer gets
    them, before the clip); ``apply=False`` leaves the parameters as they
    are (the unwrapped reference)."""
    seen: list = []
    step = tx.step

    def spy(params, grads, state, **kw):
        seen.append([g.detach().clone() for g in grads])
        if apply:
            step(params, grads, state, **kw)

    tx.step = spy
    try:
        yield seen
    finally:
        del tx.step


def grads_rel_err(got: list, want: list) -> float:
    return max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30)) for g, w in zip(got, want))


def grads_err_of_largest(got: list, want: list) -> float:
    """The largest gradient difference over the model's largest gradient."""
    return (max(float((g - w).abs().max()) for g, w in zip(got, want))
            / max(float(w.abs().max()) for w in want))


def strategy_ar_step(algo, strategy, batch, seed: int) -> dict:
    """The AR step unwrapped (loss and gradients, no update), then the same
    step through ``strategy`` (bound, attached, sharded) from a state of
    the same seed (the same CFG draw): ``PAR_AR_STEPS`` steps on the host
    clock (ms, the median of all but the first; peak memory), then one
    under torch.profiler for the collectives; K4's launches per step, and
    the first step's loss and gradients against the unwrapped ones."""
    ref_state = algo.init_state(seed)
    with recorded_steps(algo.tx(), apply=False) as ref:
        _, ref_metrics = algo.train_step(ref_state, batch)
    ref_loss = float(ref_metrics["loss"])
    del ref_state
    torch.cuda.empty_cache()
    strategy.bind(algo)
    state = algo.init_state(seed)
    strategy.attach(algo, state)
    strategy.shard_state(algo, state)
    zero_launches()
    _, plain0 = read_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []

    def step():
        nonlocal state
        before = read_launches()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = strategy.train_step(algo, state, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
        after = read_launches()[0]
        per_step.append({k: after[k] - before[k] for k in ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq")})

    with recorded_steps(algo.tx(), apply=True) as got:
        step()
        first = got.pop()
        for _ in range(PAR_AR_STEPS - 1):
            step()
            got.clear()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, nccl, _ = profiled(step)
        got.clear()
    launches, plain = read_launches()
    err = grads_rel_err(first, ref[0])
    strategy.unshard_state(algo, state)
    algo.strategy = None
    del ref, first, state
    torch.cuda.empty_cache()
    return {"losses": losses, "unwrapped_loss": ref_loss, "loss_rel_err": abs(losses[0] - ref_loss) / abs(ref_loss),
            "grads_max_rel_err": err, "limit": PAR_GRAD_REL, "k4_per_step": per_step,
            "step_ms_host_clock": [1e3 * t for t in times[:PAR_AR_STEPS]],
            "step_ms_median": 1e3 * float(np.median(times[1:PAR_AR_STEPS])),
            "peak_memory_gib": peak, "launches": launches, "plain_runs_on_cuda": plain - plain0,
            "nccl_events": nccl}


def ar_step_ok(row: dict, n_layers: int) -> bool:
    want = {"flash_attention_fwd": 2 * n_layers, "flash_bwd_dkv": n_layers, "flash_bwd_dq": n_layers}
    return (row["loss_rel_err"] <= PAR_GRAD_REL and row["grads_max_rel_err"] <= PAR_GRAD_REL
            and all(s == want for s in row["k4_per_step"]) and row["plain_runs_on_cuda"] == 0
            and all(np.isfinite(row["losses"])))


def phase_parallel_fsdp(algo, cfg, dev, seed: int, ar_row: dict) -> dict:
    """Phase 17's Llama-medium C2I step at 128 x 257 with flash under
    ``FSDPStrategy`` over ``fsdp=1`` (the shards whole, their collectives
    over one rank): K4 48/24/24 a step, loss and gradients equal the
    unwrapped step's; step ms and peak memory beside ``ar_train``'s."""
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.parallel.sharding import FSDPStrategy

    rng = np.random.default_rng(seed + 3)
    batch = {"codes": torch.from_numpy(rng.integers(0, CODEBOOK, (AR_CODES_BATCH, GRID, GRID))).to(dev),
             "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, AR_CODES_BATCH)).to(dev)}
    with one_rank_group():
        strategy = FSDPStrategy(make_mesh({"dp": -1, "fsdp": 1}, device_type="cuda"), device=dev)
        row = strategy_ar_step(algo, strategy, batch, seed)
    nccl = row["nccl_events"]
    n_layers = cfg["transformer"]["num_layers"]
    row.update(phase="parallel_fsdp", strategy="FSDPStrategy", mesh=strategy.mesh.shape,
               sharded_params=len(strategy._param_entries), params=len(list(algo.model.parameters())),
               batch=AR_CODES_BATCH, seq=SEQ,
               ar_train_codes_step_ms_median=ar_row["codes_step_ms_median"],
               ar_train_peak_memory_gib=ar_row["peak_memory_gib"])
    emit(row)
    if not (ar_step_ok(row, n_layers) and row["sharded_params"] > 0
            and has_collective(nccl, "reducescatter") and has_collective(nccl, "allgather")):
        raise SystemExit("parallel_fsdp: a check failed (see the parallel_fsdp line)")
    return row["launches"]


def phase_parallel_tp(vqgan, dev, seed: int) -> dict:
    """configs/ar/c2i_llama_medium_tp_imagenet.py with tp=1: its strategy
    and mesh, one Llama-medium step with flash equal to the unwrapped step;
    then ``ARServer(strategy=TPStrategy, paged=True)`` at Llama-medium
    width with INT8 weights and KV serving 16 requests against the server
    without a strategy, same seed: equal tokens."""
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry, StrategyRegistry
    from vector_quantization_tpu_torch.tasks.sequence_modeling import TokenCodebook
    from vector_quantization_tpu_torch.tasks.serving import ARServer
    from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax
    from vector_quantization_tpu_torch.utils.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / TP_CONFIG))
    trainer = cfg["trainer"]
    acfg = trainer["algorithm"]
    acfg["transformer"]["flash"] = True
    acfg["ir"] = vqgan
    algo = AlgorithmRegistry.build(acfg, device=dev)
    vocab = algo.model.vocabulary_size  # no CFG token in this config: 17384
    params = medium_flax_params(seed + 2)
    params.update(embedding=params["embedding"][:vocab], lm_head=params["lm_head"][:, :vocab])
    load_ar_from_flax(algo, params)
    rng = np.random.default_rng(seed + 5)
    batch = {"codes": torch.from_numpy(rng.integers(0, CODEBOOK, (AR_CODES_BATCH, GRID, GRID))).to(dev),
             "category": torch.from_numpy(rng.integers(0, NUM_CATEGORIES, AR_CODES_BATCH)).to(dev)}
    serve = dict(image_tokens=IMAGE_TOKENS, batch_slots=SLOTS, sampler=SAMPLER, cfg_alpha=1.75,
                 uncond_token=NUM_CATEGORIES, steps_per_sync=STEPS_PER_SYNC, cache_dtype=torch.int8, paged=True,
                 page_size=PAGE_SIZE, seed=seed, device=dev)

    def serve_all(strategy=None):
        server = ARServer(make_medium(seed, dev), None, TokenCodebook(NUM_CATEGORIES + 1, CODEBOOK),
                          strategy=strategy, **serve)
        for i in range(PAR_SERVE_REQUESTS):
            server.submit(category=(7 * i) % NUM_CATEGORIES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = dict(server.run_until_drained())
        torch.cuda.synchronize()
        return server, done, time.perf_counter() - t0

    _, want, plain_wall = serve_all()
    torch.cuda.empty_cache()
    with one_rank_group():
        mesh = make_mesh({**trainer["mesh"], "tp": 1}, device_type="cuda")
        strategy = StrategyRegistry.build(trainer["strategy"], mesh=mesh, device=dev)
        row = strategy_ar_step(algo, strategy, batch, seed)
        nccl = row["nccl_events"]
        del algo
        torch.cuda.empty_cache()
        zero_launches()
        _, plain0 = read_launches()
        server_strategy = StrategyRegistry.build(trainer["strategy"], mesh=mesh, device=dev)
        server, done, wall = serve_all(server_strategy)
        launches, plain = read_launches()
    same = sorted(done) == sorted(want) and all(np.array_equal(done[r], want[r]) for r in want)
    serving = {"requests": PAR_SERVE_REQUESTS, "wall_s": wall, "tokens_per_s": PAR_SERVE_REQUESTS * IMAGE_TOKENS / wall,
               "unsharded_wall_s": plain_wall, "tokens_equal_unsharded": same, "launches": launches,
               "plain_runs_on_cuda": plain - plain0, "cache_heads": int(server.cache.k.shape[-2]),
               "pages_free": len(server._free_pages), "pages_total": server._total_pages}
    n_layers = acfg["transformer"]["num_layers"]
    row.update(phase="parallel_tp", config=TP_CONFIG, strategy=type(strategy).__name__, mesh=mesh.shape,
               sharded_tensors=len(strategy._param_entries), batch=AR_CODES_BATCH, server=serving)
    emit(row)
    ok = (ar_step_ok(row, n_layers) and row["sharded_tensors"] > 0 and has_collective(nccl, "allreduce")
          and same and len(done) == PAR_SERVE_REQUESTS
          and all(c.shape == (IMAGE_TOKENS,) and (c >= 0).all() and (c < CODEBOOK).all() for c in done.values())
          and len(server._free_pages) == server._total_pages and server._pages_reserved == 0
          and k2_launches(launches) > 0 and launches[K2_HEAD] > 0 and launches[K2_SPLIT_K] == 0
          and launches["paged_decode_attention"] > 0 and plain == plain0)
    if not ok:
        raise SystemExit("parallel_tp: a check failed (see the parallel_tp line)")
    return {"train": row["launches"], "serving": launches}


def two_rank_models(dev, seed: int):
    """The reduced-depth models of ``parallel_two_ranks``, alike in every
    process: the LlamaGen VQGAN at full width with one block per level (its
    PatchGAN and LPIPS as configured), and Llama-medium's width at 4 layers
    with flash (fed codes), SGD, made from ``seed``."""
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry
    from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax
    from vector_quantization_tpu_torch.utils.config import Config

    root = Path(__file__).resolve().parent
    sgd = {"type": "sgd", "lr": TWO_RANK_LR["vqgan"]}
    vcfg = Config.load(str(root / VQGAN_CONFIG))["trainer"]["algorithm"]
    for part in ("encoder", "decoder"):
        vcfg["model"][part]["depth_mult"] = 1
    vcfg.update(optimizer=sgd, d_optimizer=sgd)
    torch.manual_seed(seed)
    vqgan = AlgorithmRegistry.build(vcfg, device=dev)
    load_random_flax_weights(vqgan.model, seed)
    acfg = Config.load(str(root / AR_CONFIG))["trainer"]["algorithm"]
    acfg["transformer"].update(flash=True, num_layers=TWO_RANK_AR_LAYERS)
    acfg["optimizer"] = {"type": "sgd", "lr": TWO_RANK_LR["ar"]}
    ar = AlgorithmRegistry.build(acfg, device=dev)
    params = {k: v for k, v in medium_flax_params(seed + 2).items()
              if not k.startswith("layer") or int(k[5:]) < TWO_RANK_AR_LAYERS}
    load_ar_from_flax(ar, params)
    return vqgan, ar


def two_rank_train(rank: int, world: int, dev, seed: int) -> dict:
    """Both models' two steps on this rank's rows of each global batch
    under ``DataParallelStrategy`` (over the group's ranks; one process: no
    group), the VQGAN's with the GAN on; the starting and the updated
    weights on the host, and the launches."""
    from vector_quantization_tpu_torch.parallel.mesh import make_mesh
    from vector_quantization_tpu_torch.parallel.sharding import DataParallelStrategy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vqgan, ar = two_rank_models(dev, seed)
    rng = np.random.default_rng(seed + 9)
    images = [{"image": rng.uniform(-1, 1, (TWO_RANK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)}
              for _ in range(2)]
    codes = [{"codes": rng.integers(0, CODEBOOK, (TWO_RANK_AR_BATCH, GRID, GRID)),
              "category": rng.integers(0, NUM_CATEGORIES, TWO_RANK_AR_BATCH)} for _ in range(2)]
    out = {}
    zero_launches()
    _, plain0 = read_launches()
    for name, algo, batches in (("vqgan", vqgan, images), ("ar", ar, codes)):
        out[f"{name}_start"] = {k: v.detach().cpu().clone() for k, v in algo.model.state_dict().items()}
        strategy = DataParallelStrategy(make_mesh(device_type="cuda"), device=dev)
        strategy.bind(algo)
        state = algo.init_state(seed)
        if name == "vqgan":
            state.step = VQGAN_D_START  # the GAN on: PatchGAN's BatchNorm, the adaptive weight
        strategy.attach(algo, state)
        strategy.shard_state(algo, state)
        for b in batches:
            n = next(iter(b.values())).shape[0] // world
            local = {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n])).to(dev)
                     for k, v in b.items()}
            state, _ = strategy.train_step(algo, state, local)
        strategy.unshard_state(algo, state)
        out[name] = {k: v.detach().cpu() for k, v in algo.model.state_dict().items()}
        del state
    launches, plain = read_launches()
    out["launches"], out["plain_runs_on_cuda"] = launches, plain - plain0
    return out


def two_rank_child(rank: int, tmp: str, seed: int) -> None:
    """A spawned rank of ``parallel_two_ranks``: gloo over a file store,
    the one card, the kernels the parent built (loaded, not rebuilt)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "store"), 2), rank=rank, world_size=2)
    try:
        torch.save(two_rank_train(rank, 2, torch.device("cuda", 0), seed), str(Path(tmp) / f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_parallel_two_ranks(tmp: Path, dev, seed: int) -> dict:
    """Two processes on the one card (spawned after the build), each with
    half of every global batch, through gloo's all-reduce on CUDA tensors:
    the updated weights of a reduced-depth VQGAN (GAN on: PatchGAN's
    BatchNorm over both ranks, the adaptive weight) and Llama (K4) against
    one process with the whole batch."""
    import torch.multiprocessing as mp

    work = tmp / "two_ranks"
    work.mkdir()
    t0 = time.perf_counter()
    ctx = mp.start_processes(two_rank_child, args=(str(work), seed), nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 300:
                raise SystemExit("parallel_two_ranks: the ranks did not finish within 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    got = [torch.load(str(work / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    one = two_rank_train(0, 1, dev, seed)
    torch.cuda.empty_cache()
    rows, ok = {}, True
    for name in ("vqgan", "ar"):
        start = one[f"{name}_start"]
        keys = [k for k in start if start[k].is_floating_point()]
        want = torch.cat([(one[name][k] - start[k]).reshape(-1) for k in keys])
        diff = torch.cat([(got[0][name][k] - one[name][k]).reshape(-1) for k in keys])
        rel = float(diff.norm() / want.norm().clamp(min=1e-30))
        replicas = all(torch.equal(got[0][name][k], got[1][name][k]) for k in start)
        same_start = all(torch.equal(got[0][f"{name}_start"][k], start[k]) for k in start)
        rows[name] = {"update_norm": float(want.norm()), "max_update": float(want.abs().max()),
                      "max_abs_diff_two_vs_one": float(diff.abs().max()), "rel_l2": rel,
                      "limit": TWO_RANK_UPDATE_REL[name], "replicas_equal": replicas, "same_start": same_start}
        ok = ok and float(want.norm()) > 0 and rel <= TWO_RANK_UPDATE_REL[name] and replicas and same_start
    launches = got[0]["launches"]
    row = {"phase": "parallel_two_ranks", "ranks": 2, "backend": "gloo", "tensors_on": "cuda",
           "global_batch": {"vqgan": TWO_RANK_BATCH, "ar": TWO_RANK_AR_BATCH}, "ar_layers": TWO_RANK_AR_LAYERS,
           "optimizer": {k: f"sgd lr {v}" for k, v in TWO_RANK_LR.items()}, "tf32": False, "ranks_s": ranks_s, **rows,
           "launches_rank0": launches, "launches_one_process": one["launches"],
           "plain_runs_on_cuda": [g["plain_runs_on_cuda"] for g in got] + [one["plain_runs_on_cuda"]]}
    emit(row)
    ok = (ok and launches["nearest_codes"] == 2 and launches["flash_attention_fwd"] > 0
          and not any(row["plain_runs_on_cuda"]))
    if not ok:
        raise SystemExit("parallel_two_ranks: a check failed (see the parallel_two_ranks line)")
    return launches



# -- the repo's tools on the port (vector_quantization_tpu_torch/tools), each
# run as a subprocess through its ``-m`` entry point
TOOLS_IMAGES, TOOLS_SOURCE_SIZE = 8, 288  # the export: 8 synthetic images of 288 px, 10 crops of 256 each
TOOLS_N = 10 * GRID * GRID  # K1's rows per image at 256 px, f16: 2560
GOLDEN_CONFIG = "configs/vqgan/16384_imagenet_ddp.py"
GOLDEN_LAYOUT = dict(width=128, mults=(1, 1, 2, 2, 4), enc_depth=2, dec_depth=3, zdim=256, codes=16384)
GOLDEN_IMAGES, GOLDEN_BATCH = 16, 8
# connectors taming's layout has and the 16384 config's model does not: the graft ignores them
GOLDEN_IGNORED = ["post_encode.conv.weight", "post_encode.conv.bias", "pre_decode.conv.weight",
                  "pre_decode.conv.bias"]
RECORD_FAMILIES = ("synthetic_taming_vqgan", "self_trained_smoke", "self_trained_ar")  # 2k: phase 13
# rows of --check that miss BASELINE.json with the port's own draws on the CPU as well
# (PERF.md, open questions): printed with their deltas, held by tests/test_torch_golden_eval.py
RECORD_OWN_DRAWS = {("self_trained_smoke", "psnr"), ("self_trained_ar", "decode_hash"),
                    ("self_trained_ar", "decode_mean")}
EMA_BATCH, EMA_STEPS, EMA_DECAY = 4, 2, 0.999

TOOL_CHILD = """
import json, runpy, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as in the whole script
import chip_smoke
from vector_quantization_tpu_torch.tasks.image_tokenization import TokenizerModel
starts, encode = [], TokenizerModel.encode_to_quant
def timed(self, x):
    starts.append(time.perf_counter())
    return encode(self, x)
TokenizerModel.encode_to_quant = timed
name, sys.argv = sys.argv[1], ["vector_quantization_tpu_torch.tools." + sys.argv[1], *sys.argv[2:]]
chip_smoke.zero_launches()
code = 0
try:
    runpy.run_module("vector_quantization_tpu_torch.tools." + name, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
launches, plain = chip_smoke.read_launches()
print("TOOL_REPORT " + json.dumps({"launches": launches, "plain_runs_on_cuda": plain,
                                    "encode_starts": starts}), flush=True)
sys.exit(code)
"""


def start_tool(name: str, *argv) -> tuple:
    """``python -m vector_quantization_tpu_torch.tools.<name> argv`` started
    in a child process (a wrapper around ``runpy.run_module``, as ``-m``
    runs it, with TF32 off as in this process, that reports the child's
    kernel launches, plain versions on the card and ``encode_to_quant``
    call times)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")  # no pipe to fill while it runs
    proc = subprocess.Popen([sys.executable, "-c", TOOL_CHILD, name, *map(str, argv)],
                            cwd=Path(__file__).resolve().parent, stdout=out, stderr=err, text=True)
    return name, proc, out, err, time.perf_counter()


def finish_tool(started: tuple, timeout: int = 900) -> dict:
    """The started child's exit code, stdout, report and wall seconds."""
    name, proc, out, err, t0 = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit(f"tools: {name} ran over {timeout} s")
    wall = time.perf_counter() - t0
    stdout, stderr = (f.seek(0) or f.read() for f in (out, err))
    out.close()
    err.close()
    lines = stdout.splitlines()
    report = next((json.loads(ln.split(" ", 1)[1]) for ln in lines if ln.startswith("TOOL_REPORT ")), None)
    if report is None:
        print(stdout[-3000:], stderr[-3000:], sep="\n", file=sys.stderr)
        raise SystemExit(f"tools: {name} gave no report (exit {proc.returncode})")
    return {"rc": proc.returncode, "stdout": "\n".join(ln for ln in lines if not ln.startswith("TOOL_REPORT ")),
            "stderr_tail": stderr[-2000:], "wall_s": wall, **report}


def run_tool(name: str, *argv) -> dict:
    return finish_tool(start_tool(name, *argv))


def start_record_check(tmp: Path) -> tuple:
    """``tools_record_check``'s child, started first: the other tools
    phases run beside it."""
    return start_tool("record_published", "--check", "--families", *RECORD_FAMILIES, "--work-dir",
                      tmp / "published")


def tools_config(tmp: Path) -> str:
    """The LlamaGen VQGAN config with the export's dataset: 8 synthetic
    images of 288 px (1000 classes), so the ten 256 px crops differ."""
    return write_overlay(tmp, "tools_llamagen", VQGAN_CONFIG, f"""
validator = dict(
    dataset=dict(_delete_=True, type="SyntheticDataset", size={TOOLS_IMAGES}, image_size={TOOLS_SOURCE_SIZE},
                 num_categories=1000),
)
""")


def phase_tools_tokenize_llamagen(tmp: Path):
    """tools.tokenize_llamagen at full LlamaGen VQGAN width: the files, K1
    once an image at (2560, 16384, 8), every image's codes against the
    plain lookup of the same features (the same seed's weights, built here)."""
    from vector_quantization_tpu_torch.ops.vq_lookup import compare_codes, nearest_codes_reference
    from vector_quantization_tpu_torch.ops.distances import normalize
    from vector_quantization_tpu_torch.tools.tokenize_llamagen import ten_crop
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.config import load_config

    t_start = time.perf_counter()
    config, out = tools_config(tmp), tmp / "llamagen"
    run = run_tool("tokenize_llamagen", "tools", config, "--out", out, "--crop-size", IMAGE_SIZE,
                   "--work-dir", tmp / "tools_work")
    codes_dir, labels_dir = out / f"imagenet{IMAGE_SIZE}_codes", out / f"imagenet{IMAGE_SIZE}_labels"
    layout_ok = (sorted(p.name for p in codes_dir.iterdir()) == sorted(f"{i}.npy" for i in range(TOOLS_IMAGES))
                 and sorted(p.name for p in labels_dir.iterdir()) == sorted(f"{i}.npy" for i in range(TOOLS_IMAGES)))
    runner = build_runner(load_config(config), "validator", work_dir=str(tmp / "tools_work_plain"))
    runner.init_state()
    model, data = runner.state.model, runner.dataloader.dataset
    q = model.quantizer
    reps, files_ok, centre = [], layout_ok, []
    for i in range(TOOLS_IMAGES if layout_ok else 0):
        codes, label = np.load(codes_dir / f"{i}.npy"), np.load(labels_dir / f"{i}.npy")
        files_ok = files_ok and codes.shape == (10, GRID, GRID) and codes.dtype == np.int32 and (
            0 <= codes.min() and codes.max() < CODEBOOK) and label.dtype == np.int64 and label.tolist() == [
            data[i].category]
        crops = ten_crop(data[i].image, IMAGE_SIZE)
        centre.append(crops[4])
        with torch.no_grad():
            x = model.encode(torch.from_numpy(np.ascontiguousarray(crops)).cuda()).reshape(-1, q.embedding_dim)
            x = normalize(x) if q.normalize_inputs else x
            e = q.effective_codebook()
            plain = nearest_codes_reference(x, e, q.distance)
            reps.append(compare_codes(x, e, torch.from_numpy(codes).cuda(), plain, q.distance))
    starts = run["encode_starts"]
    per_image = np.diff(starts).tolist() if len(starts) > 1 else []
    row = {"phase": "tools_tokenize_llamagen", "config": VQGAN_CONFIG, "images": TOOLS_IMAGES,
           "source_px": TOOLS_SOURCE_SIZE, "crop_px": IMAGE_SIZE, "rc": run["rc"],
           "stdout_last": run["stdout"].splitlines()[-1:], "files_ok": files_ok,
           "k1_launches": run["launches"]["nearest_codes"], "k1_shape": [TOOLS_N, CODEBOOK, 8],
           "plain_runs_on_cuda": run["plain_runs_on_cuda"],
           "codes_vs_plain": [{k: r[k] for k in ("rows", "differ", "excused", "near_tie_rows", "tol")} for r in reps],
           "s_per_image": per_image, "s_per_image_after_first": float(np.mean(per_image[1:])) if per_image[1:] else None,
           "images_per_s_after_first": 1 / float(np.mean(per_image[1:])) if per_image[1:] else None,
           "tool_wall_s": run["wall_s"], "wall_s": time.perf_counter() - t_start,
           "note": "s_per_image: between consecutive encode_to_quant calls in the tool's process (the item, "
                   "its ten crops, the copy, the encode, the codes' copy back and both np.save)"}
    emit(row)
    if not (run["rc"] == 0 and f"exported {TOOLS_IMAGES} items" in run["stdout"] and files_ok
            and row["k1_launches"] == TOOLS_IMAGES and run["plain_runs_on_cuda"] == 0
            and len(reps) == TOOLS_IMAGES and all(r["ok"] and r["rows"] == TOOLS_N for r in reps)):
        raise SystemExit("tools_tokenize_llamagen: a check failed (see its line)")
    return runner, out, centre, row["k1_launches"]


def phase_tools_fid_folder(tmp: Path, runner, export: Path, centre: list) -> dict:
    """tools.fid and tools.fidelity over two folders the export's tokenizer
    wrote: the centre crops, and their reconstructions from the exported
    codes (random-init Inception: relative numbers, tagged)."""
    from PIL import Image

    from vector_quantization_tpu_torch.data.base import pixel_decode

    t_start = time.perf_counter()
    originals, recon = tmp / "fid_originals", tmp / "fid_reconstructions"
    originals.mkdir()
    recon.mkdir()
    model = runner.state.model
    for i, crop in enumerate(centre):
        codes = torch.from_numpy(np.load(export / f"imagenet{IMAGE_SIZE}_codes/{i}.npy")[4:5]).cuda()
        with torch.no_grad():
            img = pixel_decode(model.decode_from_quant(codes))[0].cpu().numpy()
        Image.fromarray(img).save(recon / f"{i}.png")
        Image.fromarray(np.asarray(pixel_decode(crop))).save(originals / f"{i}.png")
    common = ["--pred", recon, "--batch-size", 4, "--image-size", IMAGE_SIZE]
    fid = run_tool("fid", *common, "--gt", originals, "--out", tmp / "fid.txt")
    fidelity = run_tool("fidelity", *common, "--splits", 2)
    fid_line = next((ln for ln in fid["stdout"].splitlines() if "FID=" in ln), "")
    is_line = next((ln for ln in fidelity["stdout"].splitlines() if ln.startswith("IS: ")), "")
    fid_value = float(fid_line.split("FID=")[1].split()[0]) if fid_line else float("nan")
    is_value = float(is_line.split()[1]) if is_line else float("nan")
    written = (tmp / "fid.txt").read_text().splitlines() if (tmp / "fid.txt").exists() else []
    row = {"phase": "tools_fid_folder", "images": len(centre), "fid_line": fid_line, "is_line": is_line,
           "fid": fid_value, "inception_score": is_value, "fid_txt": written, "rc": [fid["rc"], fidelity["rc"]],
           "plain_runs_on_cuda": fid["plain_runs_on_cuda"] + fidelity["plain_runs_on_cuda"],
           "tool_wall_s": [fid["wall_s"], fidelity["wall_s"]], "wall_s": time.perf_counter() - t_start}
    emit(row)
    if not (fid["rc"] == fidelity["rc"] == 0 and fid_line.endswith("fid_random_init")
            and is_line.endswith("fid_random_init") and f"(n={len(centre)})" in fid_line
            and np.isfinite(fid_value) and np.isfinite(is_value) and is_value >= 1.0 and written == [fid_line]
            and row["plain_runs_on_cuda"] == 0):
        raise SystemExit("tools_fid_folder: a check failed (see its line)")
    return row


def phase_tools_golden_eval(tmp: Path) -> int:
    """tools.golden_eval on a seeded synthetic checkpoint in taming's layout
    at configs/vqgan/16384_imagenet_ddp.py's width: exit 1 against the
    built-in table, 0 against its own measured numbers; K1 once an eval
    batch in each run."""
    from vector_quantization_tpu_torch.tools import _taming

    t_start = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        ckpt = _taming.synthetic_checkpoint(str(tmp / "taming_full.pth"), **GOLDEN_LAYOUT)
    config = write_overlay(tmp, "tools_golden", GOLDEN_CONFIG, f"""
validator = dict(
    dataset=dict(_delete_=True, type="SyntheticDataset", size={GOLDEN_IMAGES}, image_size={IMAGE_SIZE},
                 num_categories=1000),
    dataloader=dict(_delete_=True, batch_size_in_total={GOLDEN_BATCH}),
)
""")
    args = ["taming_vqgan", "--checkpoint", ckpt, "--config", config, "--converter-options",
            f"width={GOLDEN_LAYOUT['width']}"]
    first = run_tool("golden_eval", *args, "--work-dir", tmp / "golden_1")
    out = first["stdout"]
    measured = json.loads(out[out.index("{"): out.index("}") + 1]) if "{" in out else {}
    golden = {k: v for k, v in measured.items() if k in ("fid", "l1", "mse", "psnr", "ssim", "codebook_usage",
                                                         "codebook_ppl")}
    (tmp / "golden.json").write_text(json.dumps(golden))
    second = run_tool("golden_eval", *args, "--work-dir", tmp / "golden_2", "--golden", tmp / "golden.json")
    table = [ln for ln in out.splitlines() if ln.endswith(("PASS", "FAIL"))]
    ignored = [ln.split("'")[1] for ln in out.splitlines() if ln.startswith("[load_model_from] ignoring")]
    batches = -(-GOLDEN_IMAGES // GOLDEN_BATCH)
    row = {"phase": "tools_golden_eval", "config": GOLDEN_CONFIG, "layout": GOLDEN_LAYOUT, "images": GOLDEN_IMAGES,
           "measured": measured, "table_against_built_in": table, "rc_built_in": first["rc"],
           "rc_own_numbers": second["rc"], "own_numbers_table": [ln for ln in second["stdout"].splitlines()
                                                                 if ln.endswith(("PASS", "FAIL"))],
           "ignored_keys": ignored, "k1_launches": [first["launches"]["nearest_codes"],
                                                    second["launches"]["nearest_codes"]],
           "k1_shape": [GOLDEN_BATCH * GRID * GRID, GOLDEN_LAYOUT["codes"], GOLDEN_LAYOUT["zdim"]],
           "plain_runs_on_cuda": first["plain_runs_on_cuda"] + second["plain_runs_on_cuda"],
           "tool_wall_s": [first["wall_s"], second["wall_s"]], "wall_s": time.perf_counter() - t_start}
    emit(row)
    if not (first["rc"] == 1 and second["rc"] == 0 and len(table) == 8 and any("FAIL" in t for t in table)
            and "lpips" in " ".join(t for t in table if "nan" in t) and ignored == GOLDEN_IGNORED
            and set(golden) == {"fid", "l1", "mse", "psnr", "ssim", "codebook_usage", "codebook_ppl"}
            and all(np.isfinite(list(golden.values()))) and measured.get("fid_random_init") == 1.0
            and row["k1_launches"] == [batches, batches] and row["plain_runs_on_cuda"] == 0):
        raise SystemExit("tools_golden_eval: a check failed (see its line)")
    return sum(row["k1_launches"])


def phase_tools_record_check(started: tuple) -> int:
    """tools.record_published --check on three anchors against
    BASELINE.json (the child ``start_record_check`` started): each metric
    beside its record, delta and tolerance; gated on CHECK_TOL but for
    ``RECORD_OWN_DRAWS``."""
    from vector_quantization_tpu_torch.tools.record_published import CHECK_TOL
    from vector_quantization_tpu_torch.utils.config import load_config

    run = finish_tool(started)
    rows = []
    for ln in run["stdout"].splitlines():
        m = re.match(r"\[check\] (\w+)\.(\w+): recorded (\S+) measured (\S+) delta (\S+) \(tol (\S+)\) (ok|FAIL)$", ln)
        if m:
            fam, key, rec, got, delta, tol, verdict = m.groups()
            rows.append({"family": fam, "metric": key, "recorded": float(rec), "measured": float(got),
                         "delta": float(delta), "tol": float(tol), "ok": verdict == "ok",
                         "gated": (fam, key) not in RECORD_OWN_DRAWS})
    recorded = json.loads((Path(__file__).resolve().parent / "BASELINE.json").read_text())["published"]
    want_rows = sum(len(recorded[f]["metrics"]) for f in RECORD_FAMILIES)
    cfgs = {f: load_config(str(Path(__file__).resolve().parent / "configs/regression" / n))
            for f, n in (("synthetic_taming_vqgan", "golden_synthetic.py"), ("self_trained_smoke", "smoke_anchor.py"),
                         ("self_trained_ar", "ar_anchor.py"))}

    def eval_batches(cfg):
        v = cfg["validator"]
        return -(-v["dataset"]["size"] // v["dataloader"]["batch_size"])

    k1_want = (eval_batches(cfgs["synthetic_taming_vqgan"])
               + sum(cfgs[f]["trainer"]["max_iters"] + eval_batches(cfgs[f])
                     for f in ("self_trained_smoke", "self_trained_ar")))
    row = {"phase": "tools_record_check", "families": list(RECORD_FAMILIES), "rc": run["rc"], "rows": rows,
           "check_tol": CHECK_TOL, "ungated_own_draws": sorted(map(list, RECORD_OWN_DRAWS)),
           "k1_launches": run["launches"]["nearest_codes"], "k1_expected": k1_want,
           "k4_launches": sum(run["launches"][k] for k in ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
           "plain_runs_on_cuda": run["plain_runs_on_cuda"], "tool_wall_s": run["wall_s"],
           "note": "tool_wall_s: beside the other tools phases, which ran meanwhile"}
    emit(row)
    if not (len(rows) == want_rows and all(r["ok"] for r in rows if r["gated"])
            and run["rc"] == (0 if all(r["ok"] for r in rows) else 1)
            and all(r["ok"] for r in rows if r["family"] == "synthetic_taming_vqgan")
            and row["k1_launches"] == k1_want and row["k4_launches"] == 0 and row["plain_runs_on_cuda"] == 0):
        raise SystemExit("tools_record_check: a check failed (see its line)")
    return row["k1_launches"]


def phase_tools_model_ema(tmp: Path, cli_config: str) -> int:
    """cli.train with EMA on over the cli_vqgan overlay (full width, 2 steps
    at batch 4), tools.model_ema on its checkpoint, and the result loaded
    by ``--load-model-from``: the generator equal to ``extra["ema_params"]``."""
    from vector_quantization_tpu_torch.cli import train
    from vector_quantization_tpu_torch.training.checkpoints import checkpoint_file
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.bridge import flax_param_paths
    from vector_quantization_tpu_torch.utils.config import load_config

    t_start = time.perf_counter()
    config = write_overlay(tmp, "tools_ema", cli_config, f"""
trainer = dict(
    dataloader=dict(_delete_=True, batch_size_in_total={EMA_BATCH}, shuffle=True, num_workers=4),
    max_iters={EMA_STEPS},
    callbacks=[dict(type="CheckpointCallback", interval={EMA_STEPS})],
    algorithm=dict(ema_decay={EMA_DECAY}),
)
""")
    zero_launches()
    _, plain0 = read_launches()
    work = tmp / "tools_ema"
    trainer = train.main(["tools_ema", config, "--work-dir", str(work)])
    k1 = read_launches()[0]["nearest_codes"]
    del trainer
    torch.cuda.empty_cache()
    ckpt = work / "checkpoints" / f"iter_{EMA_STEPS}"
    run = run_tool("model_ema", ckpt, tmp / "ema_out")
    saved = torch.load(checkpoint_file(str(ckpt)), map_location="cpu", weights_only=True)
    ema = saved["extra"]["ema_params"]
    runner = build_runner(load_config(config), "validator", work_dir=str(tmp / "tools_ema_val"))
    runner.init_state()
    runner.load_model_from([str(tmp / "ema_out")])
    model, paths = runner.state.model, flax_param_paths(runner.state.model)

    def leaf(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    differ = [n for n, p in model.named_parameters() if not torch.equal(p.detach().cpu(), leaf(ema, paths[n]))]
    moved_from_params = sum(not torch.equal(leaf(ema, paths[n]), leaf(saved["params"]["generator"], paths[n]))
                            for n in paths)
    plain = read_launches()[1] - plain0
    row = {"phase": "tools_model_ema", "config": VQGAN_CONFIG, "batch": EMA_BATCH, "steps": EMA_STEPS,
           "ema_decay": EMA_DECAY, "rc": run["rc"], "stdout": run["stdout"][-200:], "params": len(paths),
           "differ_from_ema": differ[:5], "ema_tensors_not_equal_to_params": moved_from_params,
           "k1_launches_train": k1, "plain_runs_on_cuda": plain + run["plain_runs_on_cuda"],
           "ema_file_bytes": (tmp / "ema_out" / "state.pt").stat().st_size if (tmp / "ema_out").exists() else 0,
           "tool_wall_s": run["wall_s"], "wall_s": time.perf_counter() - t_start}
    del runner, model, saved, ema
    torch.cuda.empty_cache()
    emit(row)
    if not (run["rc"] == 0 and "saved EMA params" in run["stdout"] and not differ and moved_from_params > 0
            and k1 == EMA_STEPS and row["plain_runs_on_cuda"] == 0):
        raise SystemExit("tools_model_ema: a check failed (see its line)")
    return k1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=48)
    args = p.parse_args()
    import vector_quantization_tpu_torch  # noqa: F401  (the port must sit beside this script)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi, device = phase_device()
    phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k_int8 = phase_int8_matmul(dev, gen)
    k_attn = phase_paged_attention(dev, gen)
    torch.cuda.empty_cache()
    model = make_medium(args.seed, dev)
    profile_step = phase_decode_step(model, dev, gen)
    k2_kernels = [k["name"] for k in k_int8 if k.get("on_main_path", True)]
    launches, done = phase_serving(model, dev, args.seed, args.requests, k2_kernels)
    k2_dense_rows = phase_dense_vs_paged(model, dev, gen, args.seed)
    prefill_rows = [r for r in k2_dense_rows if "launches_per_prefill" in r]
    prefill_launches = phase_int8_prefill(model, dev, args.seed, prefill_rows)
    dense_launches = phase_serving_dense(model, dev, args.seed, args.requests, k2_kernels)
    del model
    torch.cuda.empty_cache()
    w8a8_launches = phase_serving_w8a8(dev, gen, args.seed)
    torch.cuda.empty_cache()
    gen_launches, profile_generate = phase_generate(dev, args.seed)
    k_vq = phase_vq_lookup(dev, gen)
    torch.cuda.empty_cache()
    vqgan, vqgan_cfg = make_vqgan(args.seed, dev)
    tok_launches, profile_tokenizer = phase_tokenizer(vqgan, vqgan_cfg, dev, args.seed)
    phase_class_to_image(vqgan, done, dev)
    torch.cuda.empty_cache()
    vqgan_algo, _ = make_vqgan_algorithm(VQGAN_CONFIG, args.seed, dev)
    vqgan_launches, profile_vqgan, vqgan_step_ms = phase_vqgan_train(vqgan_algo, dev, args.seed)
    torch.cuda.empty_cache()
    hybrid_launches, profile_hybrid = phase_hybrid_train(dev, args.seed)
    torch.cuda.empty_cache()
    phase_vqgan_anchor(dev)
    torch.cuda.empty_cache()
    vqkd_algo, vqkd_cfg = make_teacher_algorithm(VQKD_CONFIG, args.seed, dev)
    vqkd_launches, profile_vqkd = phase_teacher_train("vqkd_train", vqkd_algo, vqkd_cfg, dev, args.seed)
    torch.cuda.empty_cache()
    cluster_algo, cluster_cfg = make_teacher_algorithm(CLUSTER_CONFIG, args.seed, dev)
    cluster_launches, profile_cluster = phase_teacher_train("cluster_train", cluster_algo, cluster_cfg, dev,
                                                            args.seed)
    torch.cuda.empty_cache()
    k_flash = phase_flash_attention(dev, gen)
    torch.cuda.empty_cache()
    k_f32 = phase_f32_gemm(dev, gen)
    torch.cuda.empty_cache()
    deepseek_launches = phase_deepseek_v3(dev, gen, args.seed)
    algo, ar_cfg = make_ar_algorithm(args.seed, dev, vqgan)
    ar_launches, ar_state, codes_batch, ar_row = phase_ar_train(algo, ar_cfg, dev, args.seed)
    dots_launches = phase_ar_train_remat_dots(algo, codes_batch)
    torch.cuda.empty_cache()
    phase_ar_flash_vs_einsum(algo, ar_state, codes_batch)
    phase_ar_generate(algo, ar_state, dev, args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        two_rank_launches = phase_parallel_two_ranks(Path(tmp), dev, args.seed)
        torch.cuda.empty_cache()
        par_dp_launches = phase_parallel_dp(Path(tmp), dev)
    torch.cuda.empty_cache()
    fsdp_launches = phase_parallel_fsdp(algo, ar_cfg, dev, args.seed, ar_row)
    torch.cuda.empty_cache()
    tp_launches = phase_parallel_tp(vqgan, dev, args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        cli_config, cli_ckpt, cli_vqgan_launches = phase_cli_vqgan(tmp, vqgan_step_ms)
        cli_ar_launches, ar_config, ar_ckpt = phase_cli_ar(cli_ckpt, tmp, args.seed)
        fid_path = phase_cli_fid(cli_config, tmp)
        cli_eval_launches, cli_test_results = phase_cli_test_tokenize(cli_config, cli_ckpt, tmp, fid_path)
        cli_val_launches = phase_cli_val(cli_config, cli_ckpt.parent.parent, cli_test_results)
        gen_eval_launches = phase_ar_generation_eval(ar_config, ar_ckpt, fid_path, tmp)
        probe_launches = phase_linear_probe(tmp)
        torch.cuda.empty_cache()
        tools_t0 = time.perf_counter()
        tool_runner, export, centre, tools_launches = phase_tools_tokenize_llamagen(tmp)
        record = start_record_check(tmp)
        phase_tools_fid_folder(tmp, tool_runner, export, centre)
        del tool_runner
        torch.cuda.empty_cache()
        golden_launches = phase_tools_golden_eval(tmp)
        ema_launches = phase_tools_model_ema(tmp, cli_config)
        record_launches = phase_tools_record_check(record)
        emit({"phase": "tools", "wall_s": time.perf_counter() - tools_t0})
    torch.cuda.empty_cache()
    zoo_launches, zoo_profiles, gpt2_launches = phase_zoo(vqgan, dev, args.seed)
    profile_step()
    profile_generate()
    profile_tokenizer()
    profile_ar_step(algo, ar_state, codes_batch)
    profile_vqgan()
    profile_hybrid()
    profile_vqkd()
    profile_cluster()
    for profile in zoo_profiles:
        torch.cuda.empty_cache()
        profile()
    for k in k_int8:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {"serving": launches[k["name"]],
                                 "int8_prefill": prefill_launches[k["name"]],
                                 "generate": gen_launches[k["name"]],
                                 "serving_dense": dense_launches[k["name"]],
                                 "ar_generation_eval": gen_eval_launches[k["name"]],
                                 "serving_w8a8": w8a8_launches[k["name"]],
                                 "parallel_tp_serving": tp_launches["serving"][k["name"]]}
        k["dense_path_shapes"] = [{key: r[key] for key in ("shape", "B", "D", "F", "ms", "plain_ms",
                                                           "library_ms", "bound_ms", "max_abs_err")}
                                  for r in k2_dense_rows if r["plan"]["design"] == k["design"]]
    k_tiled = tiled_kernel_entry(prefill_rows)
    k_tiled["launches"] = prefill_launches[k_tiled["name"]]
    k_tiled["launches_by_path"] = {"int8_prefill": prefill_launches[k_tiled["name"]],
                                   "serving": launches[k_tiled["name"]],
                                   "generate": gen_launches[k_tiled["name"]],
                                   "serving_dense": dense_launches[k_tiled["name"]],
                                   "ar_generation_eval": gen_eval_launches[k_tiled["name"]],
                                   "serving_w8a8": w8a8_launches[k_tiled["name"]],
                                   "parallel_tp_serving": tp_launches["serving"][k_tiled["name"]]}
    k_attn["launches"] = launches[k_attn["name"]]
    k_attn["launches_by_path"] = {"serving": launches[k_attn["name"]],
                                  "serving_w8a8": w8a8_launches[k_attn["name"]],
                                  "parallel_tp_serving": tp_launches["serving"][k_attn["name"]]}
    k_vq["launches"] = tok_launches["nearest_codes"]
    k_vq["launches_by_path"] = {"tokenizer": tok_launches["nearest_codes"],
                                "vqgan_train": vqgan_launches["nearest_codes"],
                                "hybrid_train": hybrid_launches["nearest_codes"],
                                "vqkd_train": vqkd_launches["nearest_codes"],
                                "cluster_train": cluster_launches["nearest_codes"],
                                "ar_train": ar_launches["nearest_codes"],
                                "cli_vqgan_train": cli_vqgan_launches["nearest_codes"],
                                **cli_eval_launches,
                                "cli_ar": cli_ar_launches["nearest_codes"], "cli_val": cli_val_launches,
                                "ar_generation_eval": gen_eval_launches["nearest_codes"], **probe_launches,
                                **zoo_launches, "parallel_dp": par_dp_launches["nearest_codes"],
                                "parallel_two_ranks_rank0": two_rank_launches["nearest_codes"],
                                "tools_tokenize_llamagen": tools_launches, "tools_golden_eval": golden_launches,
                                "tools_record_check": record_launches, "tools_model_ema": ema_launches}
    for k in k_flash:
        k["launches"] = ar_launches[k["name"]]
        k["launches_by_path"] = {"ar_train": ar_launches[k["name"]], "cli_ar": cli_ar_launches[k["name"]],
                                 "ar_generation_eval": gen_eval_launches[k["name"]],
                                 "ar_train_remat_dots": dots_launches[k["name"]],
                                 "parallel_fsdp": fsdp_launches[k["name"]],
                                 "parallel_tp": tp_launches["train"][k["name"]],
                                 "parallel_two_ranks_rank0": two_rank_launches[k["name"]]}
    k_f32["launches"] = gpt2_launches["f32_gemm"]
    k_f32["launches_by_path"] = {"ar_gpt2": gpt2_launches["f32_gemm"],
                                 "ar_gpt2_prologue": gpt2_launches["f32_gemm_split"],
                                 "deepseek_v3": deepseek_launches["f32_gemm"],
                                 "deepseek_v3_prologue": deepseek_launches["f32_gemm_split"]}
    emit({"kernels": [*k_int8, k_tiled, k_attn, k_vq, *k_flash, k_f32]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
