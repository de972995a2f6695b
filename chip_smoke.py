#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. require a CUDA device; print the card (``nvidia-smi``), the torch, CUDA
   and nvcc versions, and whether ``import triton`` works;
2. build the kernels from ``edgevisiontransformer_tpu_torch/csrc`` into
   ``build/torch_kernels/`` (every source twice: its bf16 and its fp16
   instance) and print the build time, ptxas's registers and spills (no
   kernel of either instance may spill but ``vit_full``, whose lines are
   printed apart) and the ``vit_full`` blocks one SM holds at each head dim
   for both instances;
3. check each kernel against its plain PyTorch twin at deit_tiny shapes
   (b1 and b128), deit_base shapes (b8) and t2t_vit_14 shapes (b1 and b32,
   reference style: residual h, no qkv bias), and time both: the bf16 kernels
   within a tolerance; ``quant_rows`` (dynamic and static) and the non-GELU
   ``linear_i8`` epilogues bit for bit, its GELU epilogue within the
   tolerance; ``stage1_kqv`` (the T2T stage-1 tokenizer) at b1 and b4 on
   random-normal and constant images, within the tolerance, with image 2's
   output the same bits alone and in b4; ``vit_full``
   (the whole DeiT forward, K7a/K7b) at depth 2 (b1, b8 and b128, both
   residual forms, no final norm, head_dim 16, 32 and 128), and
   ``performer_reduce`` /
   ``performer_rows`` (the T2T TokenPerformer, K16) at the tokenizer's two
   stage shapes (b1, b4, b32) and ragged token counts, within the
   tolerance, with image 0's output the same bits alone and in b32 and a
   CUDA graph of both replayed twice equal to the eager call; and the
   widened kernels at the head dims and widths they took no instance for
   before: ``attention_rows`` and ``sdpa`` at ViT-H/14's head_dim 80 (257
   tokens, b1 and b8), 88, 48 / 96 and 104 / 112, ``sdpa``'s
   csrc/sdpa_long.cu (every ``SDPA_SHAPES`` entry past ``res_keys``: deit_base
   at 384, ViT-H/14, head_dims 88 and 112) in bf16 and fp16, one launch a
   call and the same bits twice, ``mlp``'s wide form
   (csrc/mlp_wide.cu) at dim 1280 (b1, b8), 1536, 2048 and 2304 in bf16 and
   fp16, ``vit_full`` at head_dim 48 and 88 and at ViT-H/14's widths with
   patch 14 (b1, b8);
4. run the slices: ``build_model("deit_tiny")`` at full width and depth with
   seeded random weights through ``fused_vit_apply`` on the kernels — three
   b1 requests and one b128 in standard style, one b1 in reference style,
   then one deit_base b8 request — and through ``fused_vit_apply_int8`` —
   static int8 (calibrated on 8 representative batches) three b1 and one
   b128, dynamic int8 one b1, reference-style static one b1, deit_base
   static one b8 — then ``build_model("t2t_vit_14")`` (reference style, full
   width and depth) through ``fused_t2t_apply`` and, static int8 calibrated
   on 8 representative batches, ``fused_t2t_apply_int8``, b1 (the stage-1
   kernel) and b32 (the plain-unfold tokenizer) each, then
   ``build_model("swin_tiny")`` (full width and depth, bf16) through
   ``fused_swin_apply`` at b1 and b32, in bf16 and with int8 stages 1-3
   (``int8_prepared``: static, calibrated on 8 representative batches, and
   dynamic), and the swin_tiny module forward with ``kernel_mode="pallas"``
   (window attention on ``window_sdpa``) at b1 and b32, then the ViT module
   path with ``kernel_mode="pallas"`` (``sdpa`` and ``mlp``): deit_tiny at
   b1 and b128 and one t2t_vit_14 b1 forward, and the pruned models:
   ``pruned_deit_tiny@all_head1_ffn0.3`` through ``fused_vit_apply`` and
   static ``fused_vit_apply_int8`` at b1 and b128, the two-segment layerwise
   encoding through ``fused_vit_apply`` (segmented and packed) and the
   module at b1, and ``fully_fused_vit_apply`` (one ``vit_full`` launch per
   forward, and one device kernel in a profiler trace) on deit_tiny b1 and
   b128 and deit_base b8, also held against ``fused_vit_apply`` — checking
   for each the logits against the plain twins on the card, the exact kernel
   launch counts, and finiteness;
5. time ``fully_fused_vit_apply`` at deit_tiny b1 and b128 and deit_base b1
   beside ``fused_vit_apply`` (eager and device p50, idle share) and the cost
   of one grid barrier; t2t_vit_14 b1 and b32, bf16, int8 static and int8
   static with the int8 stem (eager p50, device p50, device time by kernel
   with K16's share at b1 and at bf16 b32) and its two tokenizer forms at b1,
   b8 and b32, each with K16 and with the eager performer chain;
   swin_tiny b1 and b32, bf16, int8 static and dynamic, and the
   ``kernel_mode="pallas"`` module (eager p50, device p50, peak memory,
   device time by kernel at b1, and at b32 bf16's with
   ``window_attention``'s share and the module's with ``window_sdpa``'s);
   the deit_tiny ``kernel_mode="pallas"``
   module and the uniform pruned model (bf16 and int8 static) at b1 and b128;
   deit_base b1, int8 static against bf16 device p50; then the
   deit_tiny slices (kernel path and plain path) at b1 and b128, bf16 and
   int8 static and dynamic: eager p50, device p50 (CUDA-graph replay), peak
   memory, and device time by kernel from ``torch.profiler``;
6. the yardsticks of every kernel's row: its bound (the larger of the bytes
   its launches must move over 3.35 TB/s and their operations over the peak
   rate for their type) and, where one PyTorch call computes the same
   function, that call's device time at the same shapes; K16's rows at one
   t2t_vit_14 tokenizer at b1 and at b32, beside the eager performer chain;
   ``stage1_kqv``'s rows at t2t_vit_14 b1 and b4; ``attention_rows``,
   ``sdpa`` and ``mlp`` at one ViT-H/14 layer at b1 and b8 (SDPA at head_dim
   80; ``addmm`` + ``gelu`` + ``addmm`` at dim 1280), and ``sdpa`` at one
   deit_base 384 b8 layer (577 keys: csrc/sdpa_long.cu, beside SDPA);
7. finetuning on the card and its result served on the kernels:
   deit_tiny (standard, full width and depth, fp32, seeded random weights)
   trained by SGD at b32 through ``parallel/train.make_train_step`` (plain
   PyTorch autograd, as the JAX package trains through XLA): the loss
   finite and falling on the repeated batch, every gradient finite and
   non-zero, ``remat`` against the plain backward, two steps against the
   same two on the CPU, a checkpoint resumed in a fresh model against the
   uninterrupted steps; two static-aware QAT steps, whose forward is held
   against the fp32 static-int8 oracle on the same weights and scales, its
   logits and each of its matmuls (an unquantized matmul must fail that
   bound), and the int8 kernels on the QAT weights against their twins;
   ``smooth_vit`` (the function kept) and the smoothed model in static int8
   at b1 and b32, ``cast_params(bf16)`` through ``fused_vit_apply`` and
   ``make_eval_step`` over it; ``smooth_t2t`` on t2t_vit_14 in static int8
   at b1 (K8, K16): logits against the twins, exact launch counts; the
   train and QAT steps' times and the phase's peak memory;
8. head and movement pruning on the card (``edgevisiontransformer_tpu_torch/
   pruning``, plain PyTorch autograd), the pruned models served on the
   kernels: deit_tiny (standard, full width and depth, fp32, seeded random
   weights, synthetic b32 images): ``calculate_head_importance`` over four
   batches against the CPU's (1e-4), ``iterative_head_prune`` to 9 and 18
   heads (a 2-step finetune as retrain, checkpoints and accuracy markers)
   with each level's heads against the CPU's (a pair within 1e-4 printed
   where they part); ``run_sparse_finetune`` on the
   ``topk-hybrid-struct-layerwise-tiny`` preset (12 steps, the dense model as
   teacher), its first two steps against the CPU's (params and scores within
   one spacing + 1e-3 of the largest update, the key bias aside; masks at the
   final thresholds parting only within that of their cut), the compiled
   model's per-layer heads and widths; every level and the compiled model
   through ``fused_vit_apply`` (the compiled one segmented and packed) and
   static ``fused_vit_apply_int8`` at b1 and b32; a 4-step run with the
   LayerNorm and GELU transitions compiled to NoNorm / ReLU, refused by
   ``fused_vit_apply`` and served by the ``kernel_mode="pallas"`` module at
   b1 (``sdpa``): logits against the twins, exact launch counts; the times of
   one importance batch and of the sparse step (eager, traced kernels,
   idle), each served model's device p50 at b1 and b32 beside dense
   deit_tiny's, and the phase's seconds and peak memory;
9. float16: every kernel's fp16 instance against its fp16 twin at the shape
   of its row in the kernels line, with phase 3's bounds (``quant_rows`` and
   the non-GELU ``linear_i8`` epilogues bit for bit), timed beside its twin;
   the rows' bounds and fp16 library calls; the fp16 models on the card at
   b1 and b32 -- deit_tiny through ``fused_vit_apply``, static
   ``fused_vit_apply_int8``, ``fully_fused_vit_apply`` and the
   ``kernel_mode="pallas"`` module, t2t_vit_14 through ``fused_t2t_apply`` and
   static ``fused_t2t_apply_int8``, swin_tiny through ``fused_swin_apply``
   (float and static int8) and its module -- each request's launch counts
   read from zero and held to the bf16 path's, its logits within
   ``LOGIT_REL`` of the twins; then device p50 (CUDA-graph replay) of the
   ``F16_TIMES`` cells in bf16 and in fp16, one after the other, and the
   ``linear``, ``attention_rows``, ``vit_full`` and ``window_attention`` rows
   at fp16 beside bf16.  The kernels line carries a ``<kernel> fp16`` row for
   each kernel's fp16 instance;
10. published checkpoints, evaluation and the CNN zoo: state dicts built from
   a seed under the published key names (the machine has no transformers):
   ViT-B/16 (transformers' ``ViTForImageClassification``, eps 1e-12) through
   ``utils/hf_import.vit_config_from_hf`` / ``import_hf_vit`` and
   ``load_jax_params``, served by ``fused_vit_apply`` at b1 and b32 and static
   int8 at b1, its b1 device p50 beside phase 5's deit_base b1; Swin-T
   (``SwinForImageClassification``) through ``import_hf_swin`` at b1 and b32;
   T2T-ViT-14 saved as an official ``.pth.tar`` (``state_dict_ema``) and read
   by ``load_t2t_checkpoint`` (exact GELU, no qkv bias, eps 1e-5) through
   ``fused_t2t_apply`` at b1 and b32 -- logits against the twins, exact launch
   counts; ``utils/imagenet.evaluate`` (native preprocessing built from
   ``native/preprocess.cpp``, ``native=True``, b32 with a padded tail) over 70
   BMPs in 4 classes with ViT-B/16 on the kernels and on the twins (each
   image's logits within ``LOGIT_REL``, top-1 equal up to near-ties) and
   with a one-hot head (top-1 exactly class 2's
   share), images/s of evaluate and of the forward; the 15 CNNs of
   ``models/cnn`` from the registry at 224, fp32 on the card (TF32 off)
   against their CPU forward at b1 and b8 (and b1 with TF32 on, printed), a
   bf16 cast, eager p50 at b1 and b32; the phase's seconds and peak memory;
   then ViT-H/14 (google/vit-huge-patch14-224-in21k's shapes: dim 1280, 32
   layers, 16 heads of 80, MLP 5120, patch 14) from a seeded state dict under
   transformers' names, served at full width and depth through
   ``fused_vit_apply``, ``fully_fused_vit_apply`` and the
   ``kernel_mode="pallas"`` module at b1 and b8 and static
   ``fused_vit_apply_int8`` at b1 (logits against the twins, exact launch
   counts), each path's b1 device p50 beside deit_base's, its seconds and
   peak memory;
11. distributed training and evaluation: 4 gloo ranks sharing the card
   (``parallel/launch.spawn``; NCCL takes one device per rank), each opening
   the library phase 2 built, fp32 with TF32 off: the ``jit_sharded_train_step``
   at deit_small b32 (SGD) on (dp, tp) meshes (2, 1), (1, 2) and (2, 2) with
   ``grad_accum=2``, the GPipe forward and train step on deit_tiny's 12-layer
   stack at pp 2 and 4 (4 microbatches, b32) and the sp forward over 2 and 4
   ranks (197 tokens, 3 heads), each held to the same computation in one
   process (rank 0 alone: losses within 1e-4 relative, params within one
   fp32 spacing + 1e-3 of the largest update, activations within 1e-4 of
   max|.|); ``evaluate_sharded`` at dp 2 and 4 over phase 10's BMP folder on
   ``fused_vit_apply`` and static ``fused_vit_apply_int8`` (top-1 equal to one
   process's ``evaluate``, each rank's logits per image within ``LOGIT_REL``
   of the twins, exact launch counts per rank, a one-hot head's top-1
   exactly its class's share); the head importance (2 x b32) over dp 2 and 4
   against one process's (1e-4, the same heads pruned at 9 and 18); the
   dryrun on 4 ranks; each mesh's step eager p50 beside one process's,
   ``evaluate_sharded``'s img/s beside ``evaluate``'s, each rank's seconds and
   peak memory;
12. the CLI (``edgevisiontransformer_tpu_torch/cli.py``) run in this process
   through ``cli.main`` at full width, each command's launches read from zero
   and held to exactly its kernels: ``benchmark`` on deit_tiny b1 and b128
   for every ``--kernel-mode`` (xla, pallas, fused, int8, int8_static), on
   t2t_vit_14 b1 fused and static int8 with ``--stem-int8``, swin_tiny b1
   fused, static int8 and pallas, deit_base b1 fused, each JSON line with
   ``--device-time`` (the device p50 of a CUDA-graph replay of the same
   call) and its p50 > 0; ``benchmark_train --mode both`` (deit_tiny b32);
   ``profile --mode trace --kernel-mode fused`` at deit_tiny b1 and b32 (the
   trace must show ``ln_rows``, ``linear`` and ``attention_rows`` and its
   per-op sum over the end-to-end time must lie in (0, 1.05]) with
   ``analyse_op`` and ``analyse_attn_ffn`` on its CSV, ``profile --mode
   micro``; ``experiments`` fusion_ab, quant_sweep and micro; ``convert
   --quantization int8`` then ``benchmark`` and ``eval`` of the artifact over
   phase 10's kind of BMP folder (each b32 batch's logits within
   ``LOGIT_REL`` of its max|logit| of the twins, as phase 4 holds a request;
   the worst image's own ratio printed), ``eval --impl xla`` against
   ``--impl fused`` (the same
   top-1 up to near-ties); ``export --format torch_export`` loaded and held
   to the plain forward; ``latency_model`` collect (3 encodings, b1 fused),
   fit and predict (where scikit-learn is installed: the GPU machine has
   none, and the line says so); the loop-delta timer against the CUDA-event timer at
   deit_tiny b128 (within 15%); the phase's seconds and peak memory.

Phase 3 also holds ``window_attention`` and ``window_sdpa`` (swin_tiny's
four stage shapes at b1, shifted and unshifted where a stage has several
windows; stages 0 and 2 at b32; both also at window 12, Swin-B at 384's
first stage, shifted and not, and image 0's windows give each the same bits
alone and in b32, at stage 0 and at window 12), ``swin_merge`` (its three
merges, b1 and b32), ``ln_rows`` / ``linear`` at Swin's widths, ``quant_rows`` /
``linear_i8`` at the int8 stages' shapes (stages 1-3, b1 and b32, bf16
biases), ``sdpa`` (K13) and ``mlp`` (K14) at the module path's shapes,
``layer_norm`` (K15, on ``ln_rows``), ``linear`` / ``quant_rows`` /
``linear_i8`` at a pruned model's hidden widths 230 and 537, and
``attention_rows`` at one head, head_dim 16 and 128, padded and masked keys
and 577 tokens to their twins; it also checks that the 197 rows of an image
give ``attention_rows`` the same bits alone and in b128 under every plan.

The t2t_vit_14 slices of phase 4 run K16 (two launches per performer) and,
once at b1 and b32, the static int8 stem (``prepare_t2t_stem_int8_static``,
calibrated on 8 representative batches) through ``quant_rows`` /
``linear_i8``.

The line before last is the card's name and power limit; the one before it
a JSON object with every kernel's launches, error, times and yardsticks; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

# |kernel - twin| <= ATOL + RTOL * |twin| for one kernel's bf16 output: both
# sides round the same fp32 values at the same points, so they differ only
# where fp32 summation order, erff/exp2f/tanhf against torch's, or the
# two-step rounding of CAST_THEN_BIAS moves a value across a bf16 rounding
# boundary: at most ~2 bf16 ulps (2^-6 relative).
KERNEL_RTOL = 2.0 ** -6
KERNEL_ATOL = 1e-2
# Logits of the whole model, kernels against twins: single-ulp flips of the
# kernels compound through 12 layers of random weights (in int8, a flip
# before a quantization moves a value into the next bucket); bound the
# largest deviation by 5% of the largest logit.
LOGIT_REL = 0.05
DEVICE = "cuda"
PALLAS = "edgevisiontransformer_tpu/ops/pallas"
TPU = f"{PALLAS}/fused_encoder.py"
# The kernels: the source of each, the TPU code it replaces.
KERNELS = {"ln_rows": ("ln_rows.cu", f"{TPU}:54"),
           "linear": ("linear.cu", f"{TPU}:202"),
           "attention_rows": ("attention_rows.cu", f"{TPU}:101"),
           "quant_rows": ("quant_rows.cu", f"{TPU}:844"),
           "linear_i8": ("linear_i8.cu", f"{TPU}:856"),
           "stage1_kqv": ("t2t_stage1.cu", f"{PALLAS}/t2t_stage1.py:82"),
           "window_attention": ("window_attention.cu", f"{PALLAS}/swin_block.py:334"),
           "swin_merge": ("swin_merge.cu", f"{PALLAS}/swin_merge.py:73"),
           "window_sdpa": ("window_sdpa.cu", f"{PALLAS}/window_attention.py:102"),
           "sdpa": ("sdpa.cu", f"{PALLAS}/fused_attention.py:56"),
           "mlp": ("mlp.cu", f"{PALLAS}/fused_mlp.py:60"),
           "vit_full": ("vit_full.cu", f"{PALLAS}/fused_vit_full.py:177"),
           "performer_reduce": ("performer.cu", f"{PALLAS}/performer.py:148"),
           "performer_rows": ("performer.cu", f"{PALLAS}/performer.py:148")}
# The GEMMs of one standard-style encoder layer, as phase 3 labels them
LINEAR_GEMMS = ("qkv", "out", "fc1 erf", "fc2")
# The launches one encoder layer makes; stage1_kqv launches once per forward
# that takes the stage-1 tokenizer (a T2T-ViT batch below 8).
BF16_LAUNCHES = {"ln_rows": 2, "linear": 4, "attention_rows": 1, "quant_rows": 0, "linear_i8": 0}
INT8_LAUNCHES = {"ln_rows": 2, "linear": 0, "attention_rows": 1, "quant_rows": 4, "linear_i8": 4}
# swin_tiny at 224: per stage (resolution, dim, heads, depth), window 7,
# head_dim 32, mlp 4 dim; a block launches ln_rows 2, linear 4 and
# window_attention 1, a merge swin_merge 1 and linear 1
SWIN_STAGES = ((56, 96, 3, 2), (28, 192, 6, 2), (14, 384, 12, 6), (7, 768, 24, 2))
SWIN_WINDOW = 7
# window_attention and window_sdpa at window 12: Swin-B at 384's first
# stage (resolution 96, 4 heads of 32; 64 windows of 144 tokens)
WINDOW12_STAGE = (96, 4, 32)
SWIN_BATCHES = (1, 32)
SWIN_BLOCK_LAUNCHES = {"ln_rows": 2, "linear": 4, "window_attention": 1}
SWIN_INT8_BLOCK_LAUNCHES = {"ln_rows": 2, "quant_rows": 4, "linear_i8": 4, "window_attention": 1}
SWIN_MERGE_LAUNCHES = {"swin_merge": 1, "linear": 1}
# the stages prepare_swin_int8[_static] makes int8 at swin_tiny (the JAX
# package's choice: width >= 128 and K9's VMEM gate at int8 weights)
SWIN_INT8_STAGES = (1, 2, 3)
# quant_rows / linear_i8 at the int8 stages' shapes: (rows, dim, mlp, heads,
# reference style), as SHAPES
SWIN_INT8_SHAPES = {f"swin_tiny b{b} s{si}": (b * res * res, dim, 4 * dim, heads, False)
                    for b in SWIN_BATCHES for si, (res, dim, heads, _) in enumerate(SWIN_STAGES)
                    if si in SWIN_INT8_STAGES}
# The H100 SXM's published peaks (PERF.md section 3) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "fp32": 67e12}
LOG2E = 1.4426950408889634
# t2t_vit_14 batches: the stage-1 kernel path (b1) and the plain-unfold
# tokenizer (b32) in phases 4 and 5; the tokenizer forms are timed at b1,
# b8 and b32
T2T_BATCHES = (1, 32)
TOKENIZER_BATCHES = (1, 8, 32)
# The encoder kernels' shapes on the main path: (rows, dim, mlp, heads,
# reference style).  In the reference style (t2t_vit_14) the out / fc2
# residual is the LayerNorm output h and the qkv projection has no bias.
# The pruned models of phase 4: the uniform one the reference measured
# (hidden int(0.3 * 768) = 230, one head of 64) and BENCHMARKS.md's
# two-segment layerwise encoding (h1 / hidden 230 for six layers, then h2 /
# hidden 384)
PRUNED_UNIFORM = "pruned_deit_tiny@all_head1_ffn0.3"
PRUNED_LAYERWISE = ("pruned_deit_tiny@layerwise_" + "_".join(["h1-d0.3"] * 6 + ["h2-d0.5"] * 6))
# The module path's kernels per encoder layer (kernel_mode="pallas")
MODULE_LAUNCHES = {"sdpa": 1, "mlp": 1}
# vit_full at depth 2 in phase 3: (name, batch, config overrides); the
# reference-residual config keeps the linear head (the whole-model path
# refuses the two-layer one); b128 takes the serving plan (128-row tiles,
# 8-warp strips), b1 and b8 the small tiles; head_dim 16, 32 and 128 at
# uniform narrow widths (128 runs the one-block-an-SM instance); head_dim
# 48 and 88 (ViT-g/14's) and ViT-H/14's widths at patch 14 (head_dim 80;
# the embedding's K = 588), each on that instance's 128-wide strip
FULL_CHECKS = (("deit_tiny", 1, {}), ("deit_tiny", 8, {}), ("deit_tiny", 128, {}),
               ("deit_tiny res=h tanh", 1, dict(reference_residual=True, gelu_approx=True)),
               ("deit_tiny no final norm", 8, dict(final_norm=False)),
               ("head_dim 16", 1, dict(dim=64, heads=4, mlp_dim=256)),
               ("head_dim 32", 8, dict(dim=128, heads=4, mlp_dim=512)),
               ("head_dim 128", 2, dict(dim=256, heads=2, mlp_dim=1024)),
               ("head_dim 48", 2, dict(dim=192, heads=4, mlp_dim=768)),
               ("head_dim 88", 8, dict(dim=176, heads=2, mlp_dim=704)),
               ("ViT-H/14 p14", 1, dict(dim=1280, heads=16, mlp_dim=5120, patch_size=14)),
               ("ViT-H/14 p14", 8, dict(dim=1280, heads=16, mlp_dim=5120, patch_size=14)))
# fully_fused_vit_apply in phase 4 (on phase_slice's models) and phase 5
FULL_REQUESTS = (("deit_tiny", 1, 2000), ("deit_tiny", 128, 2010), ("deit_base", 8, 2020))
FULL_TIMES = (("deit_tiny", 1), ("deit_tiny", 128), ("deit_base", 1))
# K16 at (batch, tokens): stage 1 (56 x 56) and stage 2 (28 x 28) of a
# 224 x 224 image at b1, b4 and b32, and token counts off the 64-row tile
PERFORMER_SHAPES = ((1, 3136), (4, 3136), (1, 784), (4, 784), (32, 3136), (32, 784), (2, 300),
                    (1, 50))
# sdpa at the module path's shapes, [b, h, n, d]: deit_tiny b1 and b128,
# t2t_vit_14 b1, pruned h1 b1 and b128, head_dim 32 (csrc/sdpa.cu's resident
# form), deit_base at 384 (n = 577: csrc/sdpa_long.cu), ViT-H/14 (head_dim
# 80, 257 keys: sdpa_long.cu) at b1 and b8, head_dim 88 (sdpa_long.cu at 257
# keys), 96 (resident at 197 keys) and 112 (sdpa_long.cu at 197 keys); every
# sdpa_long.cu entry is checked in bf16 and fp16
SDPA_SHAPES = {"deit_tiny b1": (1, 3, 197, 64), "deit_tiny b128": (128, 3, 197, 64),
               "t2t_vit_14 b1": (1, 6, 197, 64), "pruned h1 b1": (1, 1, 197, 64),
               "pruned h1 b128": (128, 1, 197, 64), "head_dim 32 b8": (8, 6, 197, 32),
               "deit_base 384 b8": (8, 12, 577, 64),
               "ViT-H/14 b1": (1, 16, 257, 80), "ViT-H/14 b8": (8, 16, 257, 80),
               "head_dim 88 b2": (2, 16, 257, 88), "head_dim 96 b2": (2, 4, 197, 96),
               "head_dim 112 b2": (2, 4, 197, 112)}
# mlp at (rows, dim, hidden): deit_tiny b1 and b128, deit_base b8,
# t2t_vit_14 b1, the pruned widths 230 (ffn0.3) and 537 (ffn0.7), ViT-H/14
# (dim 1280, hidden 5120) at b1 and b8, dims 1536, 2048 and 2304 at b1; up
# to dim 1152 every b1 entry takes mlp.cu's cluster split of the hidden
# width (fused_mlp.plan); every wider dim runs csrc/mlp_wide.cu
# (fused_mlp.wide_plan), in bf16 and fp16
MLP_SHAPES = {"deit_tiny b1": (197, 192, 768), "deit_tiny b128": (128 * 197, 192, 768),
              "deit_base b8": (8 * 197, 768, 3072), "t2t_vit_14 b1": (197, 384, 1152),
              "hidden 230 b1": (197, 192, 230), "hidden 230 b128": (128 * 197, 192, 230),
              "hidden 537 b1": (197, 192, 537),
              "ViT-H/14 b1": (257, 1280, 5120), "ViT-H/14 b8": (8 * 257, 1280, 5120),
              "dim 1536 b1": (257, 1536, 6144), "dim 2048 b1": (257, 2048, 8192),
              "dim 2304 b1": (257, 2304, 9216)}
# attention_rows at (batch, tokens, seq_len, heads, head_dim) beyond SHAPES:
# the pruned model's one head at b1 and b128, head_dim 16 (the layerwise
# pruned config's 5 tokens at 2 and 3 heads, and 197 tokens), head_dim 128,
# padded and fully masked keys, deit_base at 384 (ten 64-key tiles), and
# the head dims of the widened instances: ViT-H/14 (80, 257 tokens) at b1
# and b8, 88 (ViT-g/14, on the 96 instance), 48, and 104 with padded keys
ATTENTION_SHAPES = {"pruned h1 b1": (1, 197, 197, 1, 64),
                    "pruned h1 b128": (128, 197, 197, 1, 64),
                    "layerwise h2 d16": (1, 5, 5, 2, 16), "layerwise h3 d16": (1, 5, 5, 3, 16),
                    "head_dim 16 b8": (8, 197, 197, 4, 16),
                    "head_dim 128 b8": (8, 197, 197, 2, 128),
                    "padded 200/197 b2": (2, 200, 197, 3, 64), "masked 70/0 b1": (1, 70, 0, 2, 64),
                    "deit_base 384 b8": (8, 577, 577, 12, 64),
                    "ViT-H/14 b1": (1, 257, 257, 16, 80), "ViT-H/14 b8": (8, 257, 257, 16, 80),
                    "head_dim 88 b2": (2, 257, 257, 16, 88),
                    "head_dim 48 b2": (2, 197, 197, 4, 48),
                    "head_dim 104 padded 200/197 b2": (2, 200, 197, 2, 104)}
# The shapes of phase 6's ViT-H/14 rows: attention_rows, sdpa and mlp at one
# ViT-H/14 layer (257 tokens, 16 heads of 80, dim 1280, MLP 5120)
VIT_H_ROWS = {"ViT-H/14 b1": 1, "ViT-H/14 b8": 8}
SHAPES = {
    "deit_tiny b1": (197, 192, 768, 3, False),
    "deit_tiny b128": (128 * 197, 192, 768, 3, False),
    "deit_base b8": (8 * 197, 768, 3072, 12, False),
    "t2t_vit_14 b1": (197, 384, 1152, 6, True),
    "t2t_vit_14 b32": (32 * 197, 384, 1152, 6, True),
}


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only the end of one still sees why
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_env(torch, build) -> str:
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc}: {ver[-1] if ver else 'no version output'}")
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    return card


def phase_build(torch, build, vf) -> float:
    """Build the library (a fresh checkout has none), print ptxas's registers
    and spills for each kernel and the blocks of ``vit_full`` one SM holds at
    each head dim, load it; returns the build time."""
    t0 = time.perf_counter()
    path = build.library_path()
    report = build.compile_library(path) if not path.exists() else {}
    build.load()
    dt = time.perf_counter() - t0
    print(f"kernels built and loaded in {dt:.2f} s: {path}")
    for src, lines in report.items():
        for line in lines:
            print(f"  ptxas {src}: {line}")
    # Every kernel of every object, bf16 and fp16 (the _f16 objects), serves
    # the main path: none may spill, but vit_full's: its head_dim <= 64
    # instance spills a few words of its layer loop's state (PERF.md section
    # 6), and its lines (both dtypes') are printed apart, not held to none
    spill = re.compile(r"[1-9]\d* bytes spill (stores|loads)")
    spills = [f"{src}: {line}" for src, lines in report.items()
              if src not in ("vit_full", f"vit_full{build.F16_SUFFIX}")
              for line in lines if spill.search(line)]
    if spills:
        fail(f"a kernel other than vit_full spills registers: {spills}")
    for src in ("vit_full", f"vit_full{build.F16_SUFFIX}"):
        for line in report.get(src, []):
            if "spill" in line:
                print(f"  {src} instance: {line}")
    for dtype in (torch.bfloat16, torch.float16):
        # the strips of deit_tiny b128's and b1's plans, and ViT-H/14's 80 (on 128's)
        for hd in (*vf.VIT_FULL_STRIP_HEAD_DIMS, 80):
            dim, heads = 192, max(1, 192 // hd)
            for b in (128, 1):
                plan = vf.vit_full_plan(b, 197, dim, heads, hd, 768, 1000, 132)
                per_sm = vf.resident_blocks_per_sm(hd, plan.blocks,
                                                   vf.vit_full_smem_bytes(plan, hd, dim), dtype)
                print(f"  vit_full {str(dtype)[6:]} head_dim {hd}, deit_tiny b{b}'s plan: "
                      f"{per_sm} blocks an SM (the instance built for {plan.blocks})")
    return dt


def within(got, ref, rtol, atol):
    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    return float(err.max()), bool((err <= bound).all())


class Launches:
    """The launch counts of every kernel wrapper module, read and reset as one."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def read(self) -> dict:
        return {k: v for m in self.modules for k, v in m.LAUNCHES.items()}


def want_launches(per_layer: dict, depth: int, stage1: int = 0, performers: int = 0,
                  stem: int = 0) -> dict:
    """The launches of one forward: ``per_layer`` times ``depth``, the stage-1
    kernel, K16's two kernels once per performer, and one ``quant_rows`` and
    one ``linear_i8`` per int8 stem matmul."""
    want = {**{k: 0 for k in KERNELS}, **{k: v * depth for k, v in per_layer.items()},
            "stage1_kqv": stage1, "performer_reduce": performers, "performer_rows": performers}
    want["quant_rows"] += stem
    want["linear_i8"] += stem
    return want


def want_swin_launches(cfg, int8_stages=()) -> dict:
    """The launches of one ``fused_swin_apply`` of a Swin model of config
    ``cfg`` whose ``int8_stages`` run the int8 chain."""
    int8_blocks = sum(d for si, d in enumerate(cfg.depths) if si in int8_stages)
    want = {k: 0 for k in KERNELS}
    for per, count in ((SWIN_BLOCK_LAUNCHES, sum(cfg.depths) - int8_blocks),
                       (SWIN_INT8_BLOCK_LAUNCHES, int8_blocks),
                       (SWIN_MERGE_LAUNCHES, len(cfg.depths) - 1)):
        for k, v in per.items():
            want[k] += v * count
    return want


def check_logits(tag, logits, ref, batch, classes):
    """Shape, finiteness and max |kernels - twins| <= LOGIT_REL * max|twins|;
    returns (deviation / max|twins|, max deviation, max|twins|, top-1
    agreement)."""
    import torch

    if tuple(logits.shape) != (batch, classes):
        fail(f"{tag}: logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        fail(f"{tag}: non-finite logits")
    err = float((logits.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if err > LOGIT_REL * scale:
        fail(f"{tag}: max |kernels - twins| {err:.4g} > {LOGIT_REL} * {scale:.4g}")
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    return err / scale, err, scale, agree


def phase_kernels(torch, fe, harness):
    """Each kernel against its twin at the main path's shapes; returns
    ({kernel: max_abs_err}, {kernel: (ms, plain_ms)} for one deit_tiny b128
    layer)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    errs = {"ln_rows": 0.0, "linear": 0.0, "attention_rows": 0.0}
    layer_ms = {}
    for shape_name, (m, dim, mlp, heads, reference) in SHAPES.items():
        x = rnd(m, dim, scale=2.0)
        g, b = rnd(dim, scale=0.5) + 1, rnd(dim, scale=0.5)
        calls = {"ln_rows": [(fe.ln_rows, fe.ln_rows_plain, (x, g, b, 1e-6), {})]}
        res = fe.ln_rows_plain(x, g, b, 1e-6) if reference else x
        lin = []
        for name, k, n, epi, approx, r in (
                ("qkv", dim, 3 * dim, fe.CAST_THEN_BIAS, False, None),
                ("out", dim, dim, fe.BIAS_RESIDUAL, False, res),
                ("fc1 erf", dim, mlp, fe.CAST_THEN_BIAS_GELU, False, None),
                ("fc1 tanh", dim, mlp, fe.CAST_THEN_BIAS_GELU, True, None),
                ("fc2", mlp, dim, fe.BIAS_RESIDUAL, False, res)):
            a = rnd(m, k)
            w, bias = rnd(k, n, scale=k ** -0.5), rnd(n, scale=0.5)
            if reference and name == "qkv":
                bias = torch.zeros_like(bias)
            lin.append((fe.linear, fe.linear_plain, (a, w, bias),
                        dict(epilogue=epi, res=r, approx_gelu=approx), name))
        calls["linear"] = [c[:4] for c in lin]
        qkv = rnd(m, 3 * dim)
        calls["attention_rows"] = [(fe.attention_rows, fe.attention_rows_plain, (qkv,),
                                    dict(heads=heads, head_dim=dim // heads, tokens=197))]
        for kname, entries in calls.items():
            for idx, (kern, plain, args, kw) in enumerate(entries):
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                ref = plain(*args, **kw)
                err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
                label = kname + (f" {lin[idx][4]}" if kname == "linear" else "")
                if not ok or not torch.isfinite(got.float()).all():
                    fail(f"{label} at {shape_name}: max |kernel - twin| {err:.4g} "
                         f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
                errs[kname] = max(errs[kname], err)
                t_k, t_p = time_pair(harness, shape_name, label, err,
                                     lambda: kern(*args, **kw), lambda: plain(*args, **kw))
                if shape_name == "deit_tiny b128" and label != "linear fc1 tanh":
                    # one standard-style layer: ln x2, qkv/out/fc1 erf/fc2, attention x1
                    reps = 2 if kname == "ln_rows" else 1
                    tk, tp = layer_ms.get(kname, (0.0, 0.0))
                    layer_ms[kname] = (tk + reps * t_k, tp + reps * t_p)
                if kname == "attention_rows" and shape_name == "deit_tiny b1":
                    layer_ms["attention_rows b1"] = (t_k, t_p)  # phase 6's b1 row
                if (kname == "linear" and label != "linear fc1 tanh"
                        and shape_name in ("deit_tiny b1", "deit_tiny b128")):
                    # phase 6 prints each GEMM of a deit_tiny layer, and their sum at b1
                    layer_ms[f"{label} {shape_name}"] = (t_k, t_p)
                    if shape_name == "deit_tiny b1":
                        tk, tp = layer_ms.get("linear b1", (0.0, 0.0))
                        layer_ms["linear b1"] = (tk + t_k, tp + t_p)
    return errs, layer_ms


def time_pair(harness, shape_name, label, err, call_k, call_p):
    """Print device (graph replay) and eager p50 of a kernel call and its
    twin; return the two device times."""
    t_k = harness.measure_graph_time(call_k)["p50_ms"]
    t_p = harness.measure_graph_time(call_p)["p50_ms"]
    e_k = harness.measure_call_time(call_k, ())["p50_ms"]
    e_p = harness.measure_call_time(call_p, ())["p50_ms"]
    print(f"  {shape_name:15s} {label:26s} device: kernel {t_k:.4f} ms plain "
          f"{t_p:.4f} ms | eager: kernel {e_k:.4f} ms plain {e_p:.4f} ms | "
          f"max|err| {err:.3g}")
    return t_k, t_p


def phase_kernels_int8(torch, fe, harness, shapes=SHAPES, bias_dtype=None, seed=1):
    """``quant_rows`` and ``linear_i8`` against their twins at ``shapes``
    (the encoders' by default; with ``bias_dtype`` bf16 the Swin int8
    stages', whose stacks keep bf16 biases): bit for bit, except the GELU
    epilogue (tolerance).  Returns the same as :func:`phase_kernels`; the
    layer times are those of one static-int8 deit_tiny b128 layer, and of
    one b1 layer's linear_i8 launches (``"linear_i8 b1"``, phase 6's b1
    row)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(seed)
    bias_dtype = bias_dtype or torch.float32

    def uniform(*shape, lo=0.5, hi=1.5):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    act_inv = (127.0 / (4.0 * uniform(12, 4))).contiguous()
    errs = {"quant_rows": 0.0, "linear_i8": 0.0}
    layer_ms = {"quant_rows": (0.0, 0.0), "linear_i8": (0.0, 0.0)}
    for shape_name, (m, dim, mlp, _, reference) in shapes.items():
        b128 = shape_name == "deit_tiny b128"
        for k, reps in ((dim, 3), (mlp, 1)):  # a layer quantizes 3 dim-wide, 1 mlp-wide input
            h = (torch.randn(m, k, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
            h[1] = 0  # absmax 0: the s = 1 fallback
            for mode, ai in (("dynamic", None), ("static", act_inv)):
                args = (h, ai, 5)
                (q, sc), (q_p, s_p) = fe.quant_rows(*args), fe.quant_rows_plain(*args)
                torch.cuda.synchronize()
                label = f"quant_rows {mode} K={k}"
                if not torch.equal(q, q_p) or (sc is not None and not torch.equal(sc, s_p)):
                    n_q = int((q != q_p).sum())
                    fail(f"{label} at {shape_name}: {n_q} of {q.numel()} int8 values differ "
                         "from the twin (must be bit for bit)")
                t_k, t_p = time_pair(harness, shape_name, label, 0.0,
                                     lambda: fe.quant_rows(*args),
                                     lambda: fe.quant_rows_plain(*args))
                if b128 and mode == "static":
                    tk, tp = layer_ms["quant_rows"]
                    layer_ms["quant_rows"] = (tk + reps * t_k, tp + reps * t_p)
        res = (torch.randn(m, dim, generator=gen, device=dev)).to(torch.bfloat16)
        if reference:  # the residual is h, a LayerNorm output
            res = fe.ln_rows_plain(res * 2.0, uniform(dim), uniform(dim, lo=-0.5, hi=0.5),
                                   1e-6)
        for name, k, n, epi, approx, r in (
                ("qkv", dim, 3 * dim, fe.BIAS, False, None),
                ("out", dim, dim, fe.BIAS_RESIDUAL, False, res),
                ("fc1 erf", dim, mlp, fe.BIAS_GELU, False, None),
                ("fc1 tanh", dim, mlp, fe.BIAS_GELU, True, None),
                ("fc2", mlp, dim, fe.BIAS_RESIDUAL, False, res)):
            unit = 1.0 / (73.0 * 73.0 * k ** 0.5)  # a dequantized sum of order 1
            q, w_q = int8(m, k), int8(k, n)
            bias = (torch.randn(n, generator=gen, device=dev) * 0.5).to(bias_dtype)
            if reference and name == "qkv":
                bias = torch.zeros_like(bias)
            for mode in ("dynamic", "static"):
                s_row = uniform(m) * 0.05 if mode == "dynamic" else None
                w_s = uniform(n) * (unit / 0.05 if mode == "dynamic" else unit)
                args = (q, s_row, w_q, w_s, bias)
                kw = dict(epilogue=epi, out_dtype=torch.bfloat16, res=r, approx_gelu=approx)
                got, ref = fe.linear_i8(*args, **kw), fe.linear_i8_plain(*args, **kw)
                torch.cuda.synchronize()
                label = f"linear_i8 {name} {mode}"
                err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
                if not torch.isfinite(got.float()).all():
                    fail(f"{label} at {shape_name}: non-finite output")
                if epi != fe.BIAS_GELU and not torch.equal(got, ref):
                    fail(f"{label} at {shape_name}: {int((got != ref).sum())} values differ "
                         f"from the twin, max {err:.4g} (must be bit for bit)")
                if not ok:
                    fail(f"{label} at {shape_name}: max |kernel - twin| {err:.4g} "
                         f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
                errs["linear_i8"] = max(errs["linear_i8"], err)
                t_k, t_p = time_pair(harness, shape_name, label, err,
                                     lambda: fe.linear_i8(*args, **kw),
                                     lambda: fe.linear_i8_plain(*args, **kw))
                if mode == "static" and name != "fc1 tanh" and (
                        b128 or shape_name == "deit_tiny b1"):
                    key = "linear_i8" if b128 else "linear_i8 b1"
                    tk, tp = layer_ms.get(key, (0.0, 0.0))
                    layer_ms[key] = (tk + t_k, tp + t_p)
    return errs, layer_ms


def phase_kernel_stage1(torch, ts, harness):
    """``stage1_kqv`` against its twin at t2t_vit_14's shapes (d = 192) on
    random-normal and all-ones images, b1 and b4, and image 2's bits alone
    and in b4; returns (max_abs_err, {"stage1_kqv": (ms, plain_ms) at b1,
    "stage1_kqv b4": at b4})."""
    import numpy as np

    from edgevisiontransformer_tpu_torch.models.t2t_vit import build_stage1_weights

    dev = DEVICE
    rng = np.random.RandomState(3)
    d = 192
    w = build_stage1_weights(rng.randn(147, d) * 147 ** -0.5, rng.randn(d) * 0.1,
                             1.0 + 0.1 * rng.randn(147), 0.1 * rng.randn(147))
    w = (w[0].to(dev, torch.bfloat16), w[1].to(dev), w[2].to(dev), w[3].to(dev))
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, ms = 0.0, {}
    for batch in (1, 4):
        for kind in ("normal", "ones"):
            img = (torch.randn(batch, 3, 224, 224, generator=gen, device=dev)
                   if kind == "normal" else torch.ones(batch, 3, 224, 224, device=dev))
            img = img.to(torch.bfloat16)
            got = ts.stage1_kqv(img, *w)
            torch.cuda.synchronize()
            ref = ts.stage1_kqv_plain(img, *w)
            err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
            label = f"stage1_kqv {kind} image"
            if not ok or not torch.isfinite(got.float()).all():
                fail(f"{label} at t2t_vit_14 b{batch}: max |kernel - twin| {err:.4g} "
                     f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
            worst = max(worst, err)
            times = time_pair(harness, f"t2t_vit_14 b{batch}", label, err,
                              lambda: ts.stage1_kqv(img, *w), lambda: ts.stage1_kqv_plain(img, *w))
            if kind == "normal":
                ms["stage1_kqv" + ("" if batch == 1 else f" b{batch}")] = times
            if batch == 4 and kind == "normal":  # an image's bits alone and in the batch
                alone = ts.stage1_kqv(img[2:3].contiguous(), *w)
                torch.cuda.synchronize()
                if not torch.equal(alone, got[2:3]):
                    fail("stage1_kqv: image 2 differs alone and in b4")
                print("  t2t_vit_14 b4      stage1_kqv: image 2 gives the same bits alone and "
                      "in b4")
    return worst, ms


def phase_kernels_swin(torch, fe, sb, sm, ws, harness):
    """``window_attention``, ``window_sdpa`` and ``swin_merge`` against their
    twins at swin_tiny's shapes, and ``ln_rows`` / ``linear`` at Swin's
    widths (dim -> 3 dim, dim -> dim, dim -> 4 dim, 4 dim -> dim, 4 dim -> 2
    dim) with the fp32 LayerNorm affine the Swin stages pass; returns
    ({kernel: max_abs_err}, {kernel: (ms, plain_ms)} summed over the launches
    of one swin_tiny b1 forward, for window_attention, window_sdpa and
    swin_merge)."""
    from edgevisiontransformer_tpu_torch.models.swin import shifted_window_mask

    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def f32(*shape, scale=1.0, base=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + base

    errs = {}
    b1_ms = {"window_attention": (0.0, 0.0), "window_sdpa": (0.0, 0.0), "swin_merge": (0.0, 0.0)}

    def check(kname, label, shape_name, kern, plain, reps=0):
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
        if not ok or not torch.isfinite(got.float()).all():
            fail(f"{label} at {shape_name}: max |kernel - twin| {err:.4g} "
                 f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
        errs[kname] = max(errs.get(kname, 0.0), err)
        t_k, t_p = time_pair(harness, shape_name, label, err, kern, plain)
        if reps:
            tk, tp = b1_ms[kname]
            b1_ms[kname] = (tk + reps * t_k, tp + reps * t_p)

    def wa_bits(qkv, bias, mask, res, w, heads, hd, tag):
        # image 0's windows through window_attention alone and in the batch
        kw = dict(res=res, window=w, shift=w // 2, heads=heads, head_dim=hd)
        alone = sb.window_attention(qkv[:res * res], bias, mask, **kw)
        full = sb.window_attention(qkv, bias, mask, **kw)
        torch.cuda.synchronize()
        if not torch.equal(alone, full[:res * res]):
            fail(f"window_attention at {tag}: image 0's windows differ alone and in the batch")
        print(f"  {tag:22s} window_attention shifted: image 0's {(res // w) ** 2} windows give "
              f"the same bits alone and in b{qkv.shape[0] // (res * res)}")

    w = SWIN_WINDOW
    n = w * w
    for batch in SWIN_BATCHES:
        for si, (res, dim, heads, depth) in enumerate(SWIN_STAGES):
            tag = f"swin_tiny b{batch} s{si}"
            m, nwin, last = batch * res * res, (res // w) ** 2, si == len(SWIN_STAGES) - 1
            x = rnd(m, dim, scale=2.0)
            if not last:
                g4, b4 = f32(4 * dim, scale=0.5, base=1.0), f32(4 * dim, scale=0.5)
                check("swin_merge", "swin_merge", tag,
                      lambda: sm.swin_merge(x, g4, b4, res=res, eps=1e-5),
                      lambda: sm.swin_merge_plain(x, g4, b4, res=res, eps=1e-5),
                      int(batch == 1))
            if batch > 1 and si not in (0, 2):  # b32: the merges, stages 0 and 2
                continue
            qkv = rnd(m, 3 * dim)
            bias = f32(heads, n, n, scale=0.5 * LOG2E)
            mask = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).to(dev) * LOG2E
                    if nwin > 1 else None)
            for shifted in ((False, True) if nwin > 1 else (False,)):
                kw = dict(res=res, window=w, shift=w // 2 if shifted else 0, heads=heads,
                          head_dim=dim // heads)
                mk = mask if shifted else None
                # a stage's odd blocks shift where it has several windows
                odd = depth // 2 if nwin > 1 else 0
                reps = (odd if shifted else depth - odd) if batch == 1 else 0
                check("window_attention",
                      f"window_attention {'shifted' if shifted else 'unshifted'}",
                      tag, lambda: sb.window_attention(qkv, bias, mk, **kw),
                      lambda: sb.window_attention_plain(qkv, bias, mk, **kw), reps)
            # window_sdpa, as the kernel_mode="pallas" module calls it: window-major
            # qkv, a bf16 bias, the fp32 mask (raw, tiled over the images)
            qkv_w = rnd(batch * nwin, n, 3 * dim)
            bias16 = rnd(heads, n, n, scale=0.5)
            mask32 = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).to(dev)
                      if nwin > 1 else None)
            for shifted in ((False, True) if nwin > 1 else (False,)):
                kw = dict(heads=heads, head_dim=dim // heads)
                mk = mask32 if shifted else None
                odd = depth // 2 if nwin > 1 else 0
                reps = (odd if shifted else depth - odd) if batch == 1 else 0
                check("window_sdpa", f"window_sdpa {'shifted' if shifted else 'unshifted'}", tag,
                      lambda: ws.window_sdpa(qkv_w, bias16, mk, **kw),
                      lambda: ws.window_sdpa_plain(qkv_w, bias16, mk, **kw), reps)
            if batch > 1 and si == 0:  # a window's bits alone and in the batch
                wa_bits(qkv, bias, mask, res, w, heads, dim // heads, tag)
                alone = ws.window_sdpa(qkv_w[:nwin], bias16, mask32, heads=heads,
                                       head_dim=dim // heads)
                full = ws.window_sdpa(qkv_w, bias16, mask32, heads=heads, head_dim=dim // heads)
                torch.cuda.synchronize()
                if not torch.equal(alone, full[:nwin]):
                    fail(f"window_sdpa at {tag}: image 0's windows differ alone and in the batch")
                print(f"  {tag:22s} window_sdpa shifted: image 0's {nwin} windows give the same "
                      f"bits alone and in b{batch}")
            g, b = f32(dim, scale=0.5, base=1.0), f32(dim, scale=0.5)
            check("ln_rows", "ln_rows (fp32 affine)", tag, lambda: fe.ln_rows(x, g, b, 1e-5),
                  lambda: fe.ln_rows_plain(x, g, b, 1e-5))
            gemms = [("qkv", dim, 3 * dim, fe.CAST_THEN_BIAS), ("proj", dim, dim, fe.BIAS_RESIDUAL),
                     ("fc1 erf", dim, 4 * dim, fe.CAST_THEN_BIAS_GELU),
                     ("fc2", 4 * dim, dim, fe.BIAS_RESIDUAL)]
            if not last:
                gemms.append(("reduction", 4 * dim, 2 * dim, None))
            for name, k, nn_, epi in gemms:
                rows = m // 4 if epi is None else m  # the reduction runs on merged tokens
                a, wt = rnd(rows, k), rnd(k, nn_, scale=k ** -0.5)
                bvec = rnd(nn_, scale=0.5) if epi is not None else torch.zeros(
                    nn_, dtype=torch.bfloat16, device=dev)
                r = rnd(rows, nn_) if epi == fe.BIAS_RESIDUAL else None
                kwl = dict(epilogue=epi or fe.CAST_THEN_BIAS, res=r)
                check("linear", f"linear {name}", tag, lambda: fe.linear(a, wt, bvec, **kwl),
                      lambda: fe.linear_plain(a, wt, bvec, **kwl))
    # window_attention and window_sdpa at window 12 (n = 144): Swin-B at
    # 384's first stage, b1 (and b32 for window_attention's bits)
    res, heads, hd = WINDOW12_STAGE
    nwin, n12 = (res // 12) ** 2, 144
    qkv = rnd(max(SWIN_BATCHES) * res * res, 3 * heads * hd)
    bias = f32(heads, n12, n12, scale=0.5 * LOG2E)
    mask = torch.from_numpy(shifted_window_mask(res, res, 12, 6)).to(dev) * LOG2E
    q1 = qkv[:res * res]
    for mk in (None, mask):
        kw = dict(res=res, window=12, shift=6 if mk is not None else 0, heads=heads, head_dim=hd)
        check("window_attention",
              f"window_attention w12 {'shifted' if mk is not None else 'unshifted'}",
              "swin_b 384 b1 s0", lambda: sb.window_attention(q1, bias, mk, **kw),
              lambda: sb.window_attention_plain(q1, bias, mk, **kw))
    wa_bits(qkv, bias, mask, res, 12, heads, hd, "swin_b 384 s0")
    qkv_w = rnd(nwin, n12, 3 * heads * hd)
    bias16 = rnd(heads, n12, n12, scale=0.5)
    mask32 = torch.from_numpy(shifted_window_mask(res, res, 12, 6)).to(dev)
    for mk in (None, mask32):
        check("window_sdpa", f"window_sdpa w12 {'shifted' if mk is not None else 'unshifted'}",
              "swin_b 384 b1 s0", lambda: ws.window_sdpa(qkv_w, bias16, mk, heads=heads,
                                                         head_dim=hd),
              lambda: ws.window_sdpa_plain(qkv_w, bias16, mk, heads=heads, head_dim=hd))
    return errs, b1_ms


def phase_kernels_pallas(torch, fe, fa, fm, ln, harness):
    """``sdpa`` (K13) and ``mlp`` (K14) against their twins at the module
    path's shapes (``SDPA_SHAPES``, q, k, v as views of a fused qkv, as
    ``attention`` passes them; ``MLP_SHAPES``, both GELU forms, the wide
    form (dim above 1152, csrc/mlp_wide.cu) in bf16 and fp16) and
    ``layer_norm`` (K15, one ``ln_rows`` launch) at ``[b, 197, 192]``;
    ``mlp`` gives the same bits twice at deit_tiny b1 and b128 and at every
    wide entry, ``sdpa`` at every entry past ``res_keys`` (csrc/sdpa_long.cu,
    also held in fp16, one launch a call); returns ({kernel: max_abs_err}
    (the wide form's bf16 under ``"mlp wide"``, sdpa_long.cu's under ``"sdpa
    long"``), {kernel: (ms, plain_ms)} of one deit_tiny b128 layer's launch,
    and under ``"mlp b1"`` one deit_tiny b1 layer's, under ``"sdpa ViT-H/14
    b1"`` etc. one ViT-H/14 layer's at ``VIT_H_ROWS`` and under ``"sdpa
    deit_base 384 b8"`` one such layer's)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    errs, layer_ms = {"sdpa": 0.0, "mlp": 0.0}, {}

    def check(kname, label, shape_name, kern, plain, row=None, timed=True):
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
        if not ok or not torch.isfinite(got.float()).all() or got.dtype != ref.dtype:
            fail(f"{label} at {shape_name}: max |kernel - twin| {err:.4g} "
                 f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
        errs[kname] = max(errs.get(kname, 0.0), err)
        if not timed:
            print(f"  {shape_name:15s} {label:26s} max|err| {err:.3g}")
            return
        times = time_pair(harness, shape_name, label, err, kern, plain)
        if row:
            layer_ms[row] = times

    for shape_name, (b, h, n, d) in SDPA_SHAPES.items():
        qkv = rnd(b, n, 3 * h * d)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        long = n > fa.res_keys(d)
        check("sdpa long" if long else "sdpa", "sdpa", shape_name, lambda: fa.sdpa(q, k, v),
              lambda: fa.sdpa_plain(q, k, v),
              row="sdpa" if shape_name == "deit_tiny b128" else (
                  f"sdpa {shape_name}" if shape_name in (*VIT_H_ROWS, "deit_base 384 b8")
                  else None))
        if not long:
            continue
        q16, k16, v16 = (t.to(torch.float16) for t in (q, k, v))
        check("sdpa long fp16", "sdpa fp16", shape_name, lambda: fa.sdpa(q16, k16, v16),
              lambda: fa.sdpa_plain(q16, k16, v16), timed=False)
        plan = fa.long_plan(b, h, n, d, fa._sm_count(0))
        for ops in ((q, k, v), (q16, k16, v16)):
            fa.reset_launches()
            first, second = fa.sdpa(*ops), fa.sdpa(*ops)
            torch.cuda.synchronize()
            if fa.LAUNCHES["sdpa"] != 2:
                fail(f"sdpa at {shape_name}: {fa.LAUNCHES['sdpa']} launches for two calls")
            if not torch.equal(first, second):
                fail(f"sdpa at {shape_name} ({ops[0].dtype}): two calls on the same inputs "
                     f"differ")
        print(f"  {shape_name:15s} sdpa (csrc/sdpa_long.cu): one launch a call, two calls give "
              f"the same bits (bf16 and fp16; plan {plan.rows} rows, {plan.stages} stages"
              f"{', K and V resident' if plan.resident else ''}, grid {plan.grid})")
    for shape_name, (m, dim, hid) in MLP_SHAPES.items():
        x = rnd(m, dim, scale=2.0)
        w1, b1 = rnd(dim, hid, scale=dim ** -0.5), rnd(hid)
        w2, b2 = rnd(hid, dim, scale=hid ** -0.5), rnd(dim)
        wide = dim > fm.MID_ROWS_DIM
        for approx in (False, True):  # a wide entry's tanh form is checked, not timed
            check("mlp wide" if wide else "mlp", f"mlp {'tanh' if approx else 'erf'}",
                  shape_name, lambda: fm.mlp(x, w1, b1, w2, b2, approx_gelu=approx),
                  lambda: fm.mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx),
                  row=None if approx else {"deit_tiny b128": "mlp", "deit_tiny b1": "mlp b1",
                                           **{s: f"mlp {s}" for s in VIT_H_ROWS}}.get(shape_name),
                  timed=not (wide and approx))
        ops16 = [t.to(torch.float16) for t in (x, w1, b1, w2, b2)] if wide else []
        for approx in ((False, True) if wide else ()):  # the wide form's fp16 instance
            check("mlp wide fp16", f"mlp {'tanh' if approx else 'erf'} fp16", shape_name,
                  lambda: fm.mlp(*ops16, approx_gelu=approx),
                  lambda: fm.mlp_plain(*ops16, approx_gelu=approx), timed=False)
        if shape_name in ("deit_tiny b1", "deit_tiny b128") or wide:
            sms = fm._sm_count(0)
            for ops in ((x, w1, b1, w2, b2), *([ops16] if wide else [])):
                first, second = fm.mlp(*ops), fm.mlp(*ops)
                torch.cuda.synchronize()
                if not torch.equal(first, second):
                    fail(f"mlp at {shape_name} ({ops[0].dtype}): two calls on the same inputs "
                         f"differ")
            wp = fm.wide_plan(m, dim, hid, sms) if wide else None
            plan = (f"wide plan: split {wp.split}, grid {wp.grid}" if wide
                    else f"plan {tuple(fm.plan(m, dim, hid, sms))}")
            print(f"  {shape_name:15s} mlp: two calls give the same bits "
                  f"({'bf16 and fp16, ' if wide else ''}{plan})")
    for b in (1, 128):
        x = rnd(b, 197, 192, scale=3.0)
        g, bb = rnd(192, scale=0.5) + 1, rnd(192, scale=0.5)
        check("ln_rows", "layer_norm (ln_rows)", f"[{b}, 197, 192]",
              lambda: ln.layer_norm(x, g, bb, 1e-6), lambda: ln.layer_norm_plain(x, g, bb, 1e-6))
    return errs, layer_ms


def phase_kernel_attention(torch, fe, harness):
    """``attention_rows`` against its twin at ``ATTENTION_SHAPES``, and a
    query row's bits alone and as image 0 of deit_tiny b128, under every
    plan; returns (max_abs_err, {"attention_rows ViT-H/14 b1": (ms,
    plain_ms), ...} at ``VIT_H_ROWS``)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(17)
    worst, rows = 0.0, {}
    for tag, (b, n, seq, h, d) in ATTENTION_SHAPES.items():
        qkv = torch.randn(b * n, 3 * h * d, generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(heads=h, head_dim=d, tokens=n, seq_len=seq)
        got, ref = fe.attention_rows(qkv, **kw), fe.attention_rows_plain(qkv, **kw)
        torch.cuda.synchronize()
        err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
        if not ok or not torch.isfinite(got.float()).all() or (seq == 0 and got.float().any()):
            fail(f"attention_rows at {tag}: max |kernel - twin| {err:.4g} "
                 f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
        worst = max(worst, err)
        times = time_pair(harness, tag, "attention_rows", err,
                          lambda: fe.attention_rows(qkv, **kw),
                          lambda: fe.attention_rows_plain(qkv, **kw))
        if tag in VIT_H_ROWS:
            rows[f"attention_rows {tag}"] = times
    qkv = torch.randn(128 * 197, 576, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(heads=3, head_dim=64, tokens=197)
    plan, outs = fe.attention_plan, []
    try:
        for warps in fe.ATTENTION_WARPS:
            fe.attention_plan = lambda *a, w=warps: w
            outs += [fe.attention_rows(qkv, **kw)[:197], fe.attention_rows(qkv[:197], **kw)]
    finally:
        fe.attention_plan = plan
    torch.cuda.synchronize()
    if not all(torch.equal(o, outs[0]) for o in outs):
        fail("attention_rows: a row's bits differ alone and in b128, or between plans")
    print(f"  attention_rows held at {len(ATTENTION_SHAPES)} more shapes (worst {worst:.3g}); "
          f"the 197 rows of an image give the same bits alone and in b128 under "
          f"{len(fe.ATTENTION_WARPS)} plans (deit_tiny b1 / b128 plan "
          f"{fe.attention_plan(1, 3, 197, fe._sm_count(0))} / "
          f"{fe.attention_plan(128, 3, 197, fe._sm_count(0))} warps)")
    return worst, rows


def phase_kernels_ragged(torch, fe, harness):
    """``linear``, ``quant_rows`` and ``linear_i8`` where K or N is a pruned
    model's hidden width (230 at ffn0.3, 537 at ffn0.7; rows and weights off
    16-byte boundaries): bf16 within the tolerance, ``quant_rows`` and the
    non-GELU ``linear_i8`` epilogues bit for bit; returns {kernel:
    max_abs_err}."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, device=dev) + 0.5

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    errs = {"linear": 0.0, "quant_rows": 0.0, "linear_i8": 0.0}
    act_inv = (127.0 / (4.0 * uniform(12, 4))).contiguous()
    for hid in (230, 537):
        for m in (197, 128 * 197):
            tag = f"hidden {hid} M={m}"
            for name, k, n, epi in (("fc1 erf", 192, hid, fe.CAST_THEN_BIAS_GELU),
                                    ("fc2", hid, 192, fe.BIAS_RESIDUAL)):
                a, w, bias = rnd(m, k), rnd(k, n, scale=k ** -0.5), rnd(n, scale=0.5)
                kw = dict(epilogue=epi, res=rnd(m, n) if epi == fe.BIAS_RESIDUAL else None)
                got, ref = fe.linear(a, w, bias, **kw), fe.linear_plain(a, w, bias, **kw)
                torch.cuda.synchronize()
                err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
                if not ok or not torch.isfinite(got.float()).all():
                    fail(f"linear {name} at {tag}: max |kernel - twin| {err:.4g}")
                errs["linear"] = max(errs["linear"], err)
                time_pair(harness, tag, f"linear {name}", err, lambda: fe.linear(a, w, bias, **kw),
                          lambda: fe.linear_plain(a, w, bias, **kw))
            h = rnd(m, hid, scale=2.0)
            for mode, ai in (("dynamic", None), ("static", act_inv)):
                (q, sc), (q_p, s_p) = fe.quant_rows(h, ai, 5), fe.quant_rows_plain(h, ai, 5)
                torch.cuda.synchronize()
                if not torch.equal(q, q_p) or (sc is not None and not torch.equal(sc, s_p)):
                    fail(f"quant_rows {mode} at {tag}: {int((q != q_p).sum())} int8 values "
                         "differ from the twin (must be bit for bit)")
            for name, k, n, epi in (("fc1 erf", 192, hid, fe.BIAS_GELU),
                                    ("fc2", hid, 192, fe.BIAS_RESIDUAL)):
                q, w_q = int8(m, k), int8(k, n)
                bias = torch.randn(n, generator=gen, device=dev) * 0.5
                w_s = uniform(n) / (73.0 * 73.0 * k ** 0.5)
                kw = dict(epilogue=epi, out_dtype=torch.bfloat16,
                          res=rnd(m, n) if epi == fe.BIAS_RESIDUAL else None)
                got = fe.linear_i8(q, None, w_q, w_s, bias, **kw)
                ref = fe.linear_i8_plain(q, None, w_q, w_s, bias, **kw)
                torch.cuda.synchronize()
                err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
                if not ok or (epi != fe.BIAS_GELU and not torch.equal(got, ref)):
                    fail(f"linear_i8 {name} at {tag}: max |kernel - twin| {err:.4g} (bit for "
                         f"bit unless GELU)")
                errs["linear_i8"] = max(errs["linear_i8"], err)
                time_pair(harness, tag, f"linear_i8 {name} static", err,
                          lambda: fe.linear_i8(q, None, w_q, w_s, bias, **kw),
                          lambda: fe.linear_i8_plain(q, None, w_q, w_s, bias, **kw))
    print(f"  ragged widths: linear, quant_rows (bit for bit) and linear_i8 (non-GELU bit for "
          f"bit) held; worst {errs}")
    return errs


def phase_kernel_vit_full(torch, vf, harness):
    """``vit_full`` against its twin at depth 2 (``FULL_CHECKS``: deit_tiny
    widths at b1 and b8, the reference residual with tanh GELU, no final
    norm), fp32 images, within ``KERNEL_ATOL + KERNEL_RTOL * max|twin|``;
    returns max_abs_err."""
    from edgevisiontransformer_tpu_torch.models.vit import ViT, deit_config, prepare_vit_full

    worst = 0.0
    for label, batch, kw in FULL_CHECKS:
        cfg = deit_config("tiny", depth=2, dtype=torch.bfloat16, **kw)
        model = ViT(cfg, device=DEVICE, generator=torch.Generator().manual_seed(21))
        prep = prepare_vit_full(model)
        img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(22))
        img = img.to(DEVICE)
        args = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                    reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx,
                    final_norm=cfg.final_norm)
        with torch.no_grad():
            got = vf.vit_full_forward(img, prep, **args)
            torch.cuda.synchronize()
            ref = vf.vit_full_forward_plain(img, prep, **args)
        # a whole forward's logits: a one-spacing flip anywhere upstream moves
        # every logit alike, so the bound scales with the largest logit
        err = float((got.float() - ref.float()).abs().max())
        bound = KERNEL_ATOL + KERNEL_RTOL * float(ref.float().abs().max())
        if err > bound or not torch.isfinite(got.float()).all():
            fail(f"vit_full at {label} depth 2 b{batch}: max |kernel - twin| {err:.4g} over "
                 f"{KERNEL_ATOL} + {KERNEL_RTOL:.4g} max|twin| = {bound:.4g}")
        worst = max(worst, err)
        with torch.no_grad():
            time_pair(harness, f"{label} d2 b{batch}", "vit_full", err,
                      lambda: vf.vit_full_forward(img, prep, **args),
                      lambda: vf.vit_full_forward_plain(img, prep, **args))
    return worst


def performer_params(torch, gen):
    """Random TokenPerformer params (fp32, the model's param dtype) and its
    random-feature matrix ``w [32, 64]`` on the card."""
    def r(*shape, scale=0.1, base=0.0):
        return torch.randn(*shape, generator=gen, device=DEVICE) * scale + base
    p = {"attn_output": {"kernel": r(64, 64), "bias": r(64)}, "norm2_scale": r(64, base=1.0),
         "norm2_bias": r(64), "mlp_fc1_kernel": r(64, 64), "mlp_fc1_bias": r(64),
         "mlp_fc2_kernel": r(64, 64), "mlp_fc2_bias": r(64)}
    return p, r(32, 64, scale=0.3)


def phase_kernel_performer(torch, pf, harness):
    """``performer_reduce`` (an image's sums) and ``performer_rows`` (on the
    twin's sums) against their twins at ``PERFORMER_SHAPES``, both GELU
    forms; at b32 image 0's output the same bits alone and in the batch; a
    CUDA graph of ``performer_rest`` replayed twice equal to the eager call;
    returns ({kernel: max_abs_err}, {row: (ms, plain_ms)}: each kernel's
    launches in one t2t_vit_14 tokenizer's two performers at b1 and, as
    ``"<kernel> b32"``, at b32)."""
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    p, w = performer_params(torch, gen)
    ops = pf.performer_operands(p, w)
    errs = {"performer_reduce": 0.0, "performer_rows": 0.0}
    ms = {f"{k}{tag}": (0.0, 0.0) for k in errs for tag in ("", " b32")}

    def check(kname, label, tag, kern, plain, row):
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
        if not ok or not torch.isfinite(got.float()).all():
            fail(f"{label} at {tag}: max |kernel - twin| {err:.4g} over {KERNEL_ATOL} + "
                 f"{KERNEL_RTOL:.4g}|twin|")
        errs[kname] = max(errs[kname], err)
        t_k, t_p = time_pair(harness, tag, label, err, kern, plain)
        if row is not None:
            tk, tp = ms[row]
            ms[row] = (tk + t_k, tp + t_p)

    for batch, n in PERFORMER_SHAPES:
        x = (torch.randn(batch, n, 192, generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        tag = f"performer b{batch} n{n}"
        # the launches of a t2t_vit_14 tokenizer (n = 3136 and 784) at b1 and b32
        tok = n in (3136, 784) and batch in (1, 32)
        row = ("" if batch == 1 else " b32") if tok else None
        check("performer_reduce", "performer_reduce", tag,
              lambda: pf.performer_reduce(x, w, operands=ops),
              lambda: pf.performer_reduce_plain(x, w),
              f"performer_reduce{row}" if tok else None)
        sums = pf.performer_reduce_plain(x, w)
        for approx in (True, False):
            kw = dict(eps_ln=1e-5, approx_gelu=approx)
            check("performer_rows", f"performer_rows {'tanh' if approx else 'erf'}", tag,
                  lambda: pf.performer_rows(x, sums, p, w, operands=ops, **kw),
                  lambda: pf.performer_rows_plain(x, sums, p, w, **kw),
                  f"performer_rows{row}" if tok and approx else None)
            got = pf.performer_rest(x, p, w, operands=ops, **kw)
            torch.cuda.synchronize()
            err, ok = within(got, pf.performer_rest_plain(x, p, w, **kw), KERNEL_RTOL, KERNEL_ATOL)
            if not ok:
                fail(f"performer_rest at {tag}: max |kernels - twins| {err:.4g}")
        if batch == 32:
            kw = dict(eps_ln=1e-5, approx_gelu=True, operands=ops)
            together = pf.performer_rest(x, p, w, **kw)
            alone = pf.performer_rest(x[:1].contiguous(), p, w, **kw)
            torch.cuda.synchronize()
            if not torch.equal(alone[0], together[0]):
                fail(f"performer_rest at {tag}: image 0's output differs alone and in the batch")
            print(f"  {tag}: image 0's output the same bits alone and in b{batch}")
    # a CUDA graph replayed twice: the counters are zeroed inside the graph
    x = (torch.randn(4, 784, 192, generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
    kw = dict(eps_ln=1e-5, approx_gelu=True, operands=ops)
    eager = pf.performer_rest(x, p, w, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pf.performer_rest(x, p, w, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pf.performer_rest(x, p, w, **kw)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            fail("performer_rest: a CUDA graph replay differs from the eager call")
    print("  performer b4 n784: two CUDA graph replays equal the eager call bit for bit")
    del graph
    return errs, ms


def phase_slice_t2t(torch, counter):
    """t2t_vit_14 (reference style, full width and depth) through
    ``fused_t2t_apply`` and, with a static stack calibrated on 8
    representative batches, ``fused_t2t_apply_int8``, at b1 (the stage-1
    kernel) and b32 (the plain-unfold tokenizer), both performers on K16;
    then ``fused_t2t_apply_int8`` with the static int8 stem
    (``prepare_t2t_stem_int8_static``, 8 representative batches) at b1 and
    b32; returns (launches, worst deviation, the model state for phase 5)."""
    from edgevisiontransformer_tpu_torch.models import t2t_vit as t2t
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import prepare_vit_fused
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

    model, shape = build_model("t2t_vit_14", style="reference", dtype=torch.bfloat16,
                               device=DEVICE, generator=torch.Generator().manual_seed(0))
    cfg = model.config
    t0 = time.perf_counter()
    with torch.no_grad():
        prepared, stacked = t2t.prepare_t2t_fused(model), prepare_vit_fused(model)
        sq = t2t.prepare_t2t_int8_static(model,
                                         calib_batches=representative_batches(n=8, shape=shape))
        stem = t2t.prepare_t2t_stem_int8_static(model,
                                                batches=representative_batches(n=8, shape=shape))
    torch.cuda.synchronize()
    print(f"  t2t_vit_14 (dim {cfg.dim}, depth {cfg.depth}, heads {cfg.heads}, mlp "
          f"{cfg.mlp_dim}): stage-1 weights, bf16 stack, static int8 stack and int8 stem "
          f"prepared in {time.perf_counter() - t0:.2f} s; stem act scales "
          f"{ {k: round(float(e['act_scale']), 6) for k, e in stem.items()} }")
    slices = {
        "bf16": (BF16_LAUNCHES, False, lambda img, plain: t2t.fused_t2t_apply(
            model, img, prepared=prepared, stacked=stacked, plain=plain)),
        "int8 static": (INT8_LAUNCHES, False, lambda img, plain: t2t.fused_t2t_apply_int8(
            model, img, stacked_q=sq, prepared=prepared, plain=plain)),
        "int8 static + stem": (INT8_LAUNCHES, True, lambda img, plain: t2t.fused_t2t_apply_int8(
            model, img, stacked_q=sq, prepared=prepared, stem_q=stem, plain=plain)),
    }
    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    for slice_name, (per_layer, with_stem, apply) in slices.items():
        for batch, seed in zip(T2T_BATCHES, (1000, 1100)):
            tag = f"t2t_vit_14 {slice_name} b{batch}"
            img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed))
            img = img.to(DEVICE)
            with torch.no_grad():
                counter.reset()
                logits = apply(img, False)
                torch.cuda.synchronize()
                counts = counter.read()
                ref = apply(img, True)
            # the stem's kqv1 is int8 only in the plain-unfold form (batch >= 8)
            stem_mm = (2 if batch < 8 else 3) if with_stem else 0
            want = want_launches(per_layer, cfg.depth, stage1=int(batch < 8), performers=2,
                                 stem=stem_mm)
            if counts != want:
                fail(f"{tag}: launch counts {counts}, expected {want}")
            for k, v in counts.items():
                launches[k] += v
            rel, err, scale, agree = check_logits(tag, logits, ref, batch, cfg.num_classes)
            worst = max(worst, rel)
            print(f"  {tag:32s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
                  f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
    return launches, worst, (model, shape, prepared, stacked, sq, stem)


def phase_time_t2t(torch, harness, state):
    """t2t_vit_14 b1 and b32, bf16, int8 static and int8 static with the int8
    stem: eager and device p50 (device time by kernel, with K16's share, at
    b1 and at bf16 b32); then the two tokenizer forms at b1, b8 and b32,
    with K16 and with the eager chain."""
    from edgevisiontransformer_tpu_torch.models import t2t_vit as t2t

    model, shape, prepared, stacked, sq, stem = state
    slices = {
        "bf16": lambda img: t2t.fused_t2t_apply(model, img, prepared=prepared, stacked=stacked),
        "int8 static": lambda img: t2t.fused_t2t_apply_int8(model, img, stacked_q=sq,
                                                             prepared=prepared),
        "int8 static + stem": lambda img: t2t.fused_t2t_apply_int8(
            model, img, stacked_q=sq, prepared=prepared, stem_q=stem),
    }
    with torch.no_grad():
        for slice_name, apply in slices.items():
            for batch in T2T_BATCHES:
                img = torch.randn(batch, *shape,
                                  generator=torch.Generator().manual_seed(batch)).to(DEVICE)
                fn = lambda: apply(img)  # noqa: E731
                e = harness.measure_call_time(fn, (), iters=10, repeats=5)
                d = harness.measure_graph_time(fn, iters=10, repeats=5)
                print(f"  t2t_vit_14 {slice_name} b{batch}: eager p50 {e['p50_ms']:.4f} ms "
                      f"(std {e['std_ms']:.4f}, {batch * 1e3 / e['p50_ms']:.1f} img/s), device "
                      f"p50 {d['p50_ms']:.4f} ms (std {d['std_ms']:.4f})")
                if batch == 1 or slice_name == "bf16":
                    prof = harness.device_time_by_kernel(fn)
                    busy = sum(r[2] for r in prof)
                    k16 = sum(r[2] for r in prof if "performer_" in r[0])
                    print(f"      traced kernel time {busy:.4f} ms (device idle "
                          f"{max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager call); K16 "
                          f"(performer_reduce + performer_rows) {k16:.4f} ms, "
                          f"{k16 / max(busy, 1e-9):.1%} of it")
                    for name, calls, ms in prof[:8]:
                        print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")
        forms = {
            "stage-1 kernel": lambda img: t2t.t2t_tokenize(model, img, prepared=prepared,
                                                            fast=True, stage1_impl="kernel"),
            "plain unfold": lambda img: t2t.t2t_tokenize(model, img, fast=False),
        }
        k16 = t2t.performer_rest

        def eager_chain(x, p, w, **_):  # the JAX package's XLA chain, as ops
            return t2t._performer_rest(x, p, w, model.config)

        for batch in TOKENIZER_BATCHES:
            img = torch.randn(batch, *shape,
                              generator=torch.Generator().manual_seed(batch)).to(DEVICE)
            for form, tokenize in forms.items():
                for perf_name, perf in (("K16", k16), ("eager chain", eager_chain)):
                    t2t.performer_rest = perf
                    try:
                        fn = lambda: tokenize(img)  # noqa: E731
                        e = harness.measure_call_time(fn, (), iters=10, repeats=5)
                        d = harness.measure_graph_time(fn, iters=10, repeats=5)
                    finally:
                        t2t.performer_rest = k16
                    print(f"  t2t_vit_14 tokenizer b{batch} {form:14s} performers "
                          f"{perf_name:11s}: device p50 {d['p50_ms']:.4f} ms (std "
                          f"{d['std_ms']:.4f}), eager p50 {e['p50_ms']:.4f} ms")


def phase_slice_swin(torch, counter):
    """swin_tiny (full width and depth, bf16, seeded random weights) through
    ``fused_swin_apply`` at b1 and b32 with constants prepared once; returns
    (launches, worst deviation, the model state for phase 5)."""
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.swin import fused_swin_apply, prepare_swin_fused

    model, shape = build_model("swin_tiny", dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    cfg = model.config
    t0 = time.perf_counter()
    prepared = prepare_swin_fused(model)
    torch.cuda.synchronize()
    print(f"  swin_tiny (embed {cfg.embed_dim}, depths {cfg.depths}, heads {cfg.num_heads}, "
          f"window {cfg.window_size}): constants prepared in {time.perf_counter() - t0:.2f} s")
    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    want = want_swin_launches(cfg)
    for batch, seed in zip(SWIN_BATCHES, (1200, 1300)):
        tag = f"swin_tiny b{batch}"
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed)).to(DEVICE)
        with torch.no_grad():
            counter.reset()
            logits = fused_swin_apply(model, img, prepared=prepared)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = fused_swin_apply(model, img, prepared=prepared, plain=True)
            eager = model(img)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, cfg.num_classes)
        worst = max(worst, rel)
        e_err = float((logits.float() - eager.float()).abs().max())
        print(f"  {tag:28s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
              f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}, "
              f"max|kern-eager model| {e_err:.4g}, launches {counts}")
    return launches, worst, (model, shape, prepared)


def phase_slice_swin_int8(torch, counter, state):
    """The bf16 slice's swin_tiny through ``fused_swin_apply`` with int8
    stacks for stages 1-3: static (``prepare_swin_int8_static``, calibrated
    on 8 representative batches) and dynamic (``prepare_swin_int8``), at b1
    and b32, against ``plain=True``; returns (launches, worst deviation,
    {mode: stack})."""
    from edgevisiontransformer_tpu_torch.models.swin import (fused_swin_apply, prepare_swin_int8,
                                                              prepare_swin_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

    model, shape, prepared = state
    cfg = model.config
    t0 = time.perf_counter()
    stacks = {"static": prepare_swin_int8_static(model, batches=representative_batches(
        n=8, shape=shape)), "dynamic": prepare_swin_int8(model)}
    torch.cuda.synchronize()
    print(f"  swin_tiny int8 stacks (static: calibrated on 8 representative batches) prepared in "
          f"{time.perf_counter() - t0:.2f} s; int8 stages {[list(q) for q in stacks.values()]}")
    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    for mode, sq in stacks.items():
        if tuple(sq) != SWIN_INT8_STAGES:
            fail(f"swin_tiny int8 {mode}: stages {list(sq)} are int8, expected "
                 f"{list(SWIN_INT8_STAGES)}")
        want = want_swin_launches(cfg, SWIN_INT8_STAGES)
        for batch, seed in zip(SWIN_BATCHES, (1400, 1500)):
            tag = f"swin_tiny int8 {mode} b{batch}"
            img = torch.randn(batch, *shape,
                              generator=torch.Generator().manual_seed(seed)).to(DEVICE)
            with torch.no_grad():
                counter.reset()
                logits = fused_swin_apply(model, img, prepared=prepared, int8_prepared=sq)
                torch.cuda.synchronize()
                counts = counter.read()
                ref = fused_swin_apply(model, img, prepared=prepared, int8_prepared=sq, plain=True)
                bf16 = fused_swin_apply(model, img, prepared=prepared)
            if counts != want:
                fail(f"{tag}: launch counts {counts}, expected {want}")
            for k, v in counts.items():
                launches[k] += v
            rel, err, scale, agree = check_logits(tag, logits, ref, batch, cfg.num_classes)
            worst = max(worst, rel)
            d16 = float((logits.float() - bf16.float()).abs().max())
            agree16 = float((logits.argmax(-1) == bf16.argmax(-1)).float().mean())
            print(f"  {tag:30s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
                  f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}; against the bf16 "
                  f"path max {d16:.4g}, top-1 {agree16:.3f}; launches {counts}")
    return launches, worst, stacks


def phase_slice_swin_module(torch, counter, ws):
    """``build_model("swin_tiny", kernel_mode="pallas")`` (full width and
    depth, bf16, the bf16 slice's seed) forward at b1 and b32: every window
    attention on ``window_sdpa``, held against the same forward on its twin;
    returns (launches, worst deviation, the model for phase 5)."""
    from edgevisiontransformer_tpu_torch.models.registry import build_model

    model, shape = build_model("swin_tiny", kernel_mode="pallas", dtype=torch.bfloat16,
                               device=DEVICE, generator=torch.Generator().manual_seed(0))
    cfg = model.config
    want = {**{k: 0 for k in KERNELS}, "window_sdpa": sum(cfg.depths)}
    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    for batch, seed in zip(SWIN_BATCHES, (1600, 1700)):
        tag = f"swin_tiny module pallas b{batch}"
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed)).to(DEVICE)
        with torch.no_grad():
            counter.reset()
            logits = model(img)
            torch.cuda.synchronize()
            counts = counter.read()
            kernel, ws.window_sdpa = ws.window_sdpa, ws.window_sdpa_plain
            try:
                ref = model(img)
            finally:
                ws.window_sdpa = kernel
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, cfg.num_classes)
        worst = max(worst, rel)
        print(f"  {tag:30s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
              f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}, launches {counts}")
    return launches, worst, (model, shape)


def module_twins(fa, fm):
    """A context in which the module path's kernel wrappers are their twins:
    the reference the ``kernel_mode="pallas"`` modules are held to."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        kernels = fa.sdpa, fm.mlp
        fa.sdpa, fm.mlp = fa.sdpa_plain, fm.mlp_plain
        try:
            yield
        finally:
            fa.sdpa, fm.mlp = kernels

    return swapped()


def phase_slice_vit_module(torch, counter, fa, fm):
    """The ViT module path with ``kernel_mode="pallas"``: deit_tiny (full
    width and depth, bf16) at b1 and b128 and one t2t_vit_14 b1 forward,
    every attention on ``sdpa`` and every MLP on ``mlp``, held against the
    same forward on the twins; returns (launches, worst deviation, the
    deit_tiny model for phase 5)."""
    from edgevisiontransformer_tpu_torch.models.registry import build_model

    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    deit = None
    for name, style, batches in (("deit_tiny", "standard", (1, 128)),
                                 ("t2t_vit_14", "reference", (1,))):
        model, shape = build_model(name, style=style, kernel_mode="pallas", dtype=torch.bfloat16,
                                   device=DEVICE, generator=torch.Generator().manual_seed(0))
        cfg = model.config
        want = want_launches(MODULE_LAUNCHES, cfg.depth)
        for batch in batches:
            tag = f"{name} module pallas b{batch}"
            img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(
                1800 + batch)).to(DEVICE)
            with torch.no_grad():
                counter.reset()
                logits = model(img)
                torch.cuda.synchronize()
                counts = counter.read()
                with module_twins(fa, fm):
                    ref = model(img)
            if counts != want:
                fail(f"{tag}: launch counts {counts}, expected {want}")
            for k, v in counts.items():
                launches[k] += v
            rel, err, scale, agree = check_logits(tag, logits, ref, batch, cfg.num_classes)
            worst = max(worst, rel)
            print(f"  {tag:30s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
                  f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
        if name == "deit_tiny":
            deit = (model, shape)
        else:
            del model
    return launches, worst, deit


def phase_slice_pruned(torch, counter, fa, fm):
    """The pruned models: ``PRUNED_UNIFORM`` (hidden 230 on the ragged
    kernel paths) through ``fused_vit_apply`` and, static int8 calibrated on
    8 representative batches, ``fused_vit_apply_int8``, at b1 and b128; the
    two-segment ``PRUNED_LAYERWISE`` through ``fused_vit_apply`` (segmented
    and ``pack_layers=True``) and the ``kernel_mode="pallas"`` module at
    b1.  Returns (launches, worst deviation, the uniform model's state for
    phase 5)."""
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply,
                                                             fused_vit_apply_int8,
                                                             prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

    launches = {k: 0 for k in counter.read()}
    worst = 0.0

    def request(tag, batch, seed, run, ref_run, want, classes):
        nonlocal worst
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed)).to(DEVICE)
        with torch.no_grad():
            counter.reset()
            logits = run(img)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = ref_run(img)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, classes)
        worst = max(worst, rel)
        print(f"  {tag:44s} max|kern-twin| {err:.4g} (max|logit| {scale:.4g}), top-1 "
              f"agreement {agree:.3f}, launches { {k: v for k, v in counts.items() if v} }")

    model, shape = build_model(PRUNED_UNIFORM, dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    cfg = model.config
    t0 = time.perf_counter()
    with torch.no_grad():
        stacked = prepare_vit_fused(model)
        sq = prepare_vit_int8_static(model, calib_batches=representative_batches(n=8,
                                                                                 shape=shape))
    torch.cuda.synchronize()
    print(f"  {PRUNED_UNIFORM} (heads {cfg.layer_heads(0)}, head_dim {cfg.resolved_head_dim}, "
          f"hidden {cfg.layer_mlp_dim(0)}): bf16 and static int8 stacks prepared in "
          f"{time.perf_counter() - t0:.2f} s")
    for batch, seed in ((1, 1900), (128, 1910)):
        request(f"pruned ffn0.3 bf16 b{batch}", batch, seed,
                lambda img: fused_vit_apply(model, img, stacked=stacked),
                lambda img: fused_vit_apply(model, img, stacked=stacked, plain=True),
                want_launches(BF16_LAUNCHES, cfg.depth), cfg.num_classes)
        request(f"pruned ffn0.3 int8 static b{batch}", batch, seed + 1,
                lambda img: fused_vit_apply_int8(model, img, stacked_q=sq),
                lambda img: fused_vit_apply_int8(model, img, stacked_q=sq, plain=True),
                want_launches(INT8_LAUNCHES, cfg.depth), cfg.num_classes)
    state = (model, shape, stacked, sq)

    lw, shape = build_model(PRUNED_LAYERWISE, dtype=torch.bfloat16, device=DEVICE,
                            generator=torch.Generator().manual_seed(0))
    lw_module, _ = build_model(PRUNED_LAYERWISE, kernel_mode="pallas", dtype=torch.bfloat16,
                               device=DEVICE, generator=torch.Generator().manual_seed(0))
    segs = prepare_vit_fused(lw)
    packed = prepare_vit_fused(lw, pack_layers=True)
    print(f"  {PRUNED_LAYERWISE}: {len(segs['segments'])} segments, packed to heads "
          f"{packed['qkv_w'].shape[2] // (3 * lw.config.resolved_head_dim)}, hidden "
          f"{packed['fc1_w'].shape[2]}")
    for pack, st in ((False, segs), (True, packed)):
        request(f"pruned layerwise {'packed' if pack else 'segmented'} b1", 1, 1920,
                lambda img: fused_vit_apply(lw, img, stacked=st, pack_layers=pack),
                lambda img: fused_vit_apply(lw, img, stacked=st, pack_layers=pack, plain=True),
                want_launches(BF16_LAUNCHES, lw.config.depth), lw.config.num_classes)

    def module_ref(img):
        with module_twins(fa, fm):
            return lw_module(img)

    request("pruned layerwise module pallas b1", 1, 1930, lw_module, module_ref,
            want_launches(MODULE_LAUNCHES, lw.config.depth), lw.config.num_classes)
    return launches, worst, state


def phase_time_swin(torch, harness, state, stacks, module_state):
    """swin_tiny b1 and b32, bf16, int8 static and dynamic through
    ``fused_swin_apply`` and the ``kernel_mode="pallas"`` module: eager and
    device p50, peak memory (the script's other resident models included)
    and the device time by kernel at b1 (bf16's and the module's at b32 too,
    with ``window_attention``'s and ``window_sdpa``'s share)."""
    from edgevisiontransformer_tpu_torch.models.swin import fused_swin_apply

    model, shape, prepared = state
    module, _ = module_state
    slices = {
        "bf16": lambda img: fused_swin_apply(model, img, prepared=prepared),
        "int8 static": lambda img: fused_swin_apply(model, img, prepared=prepared,
                                                     int8_prepared=stacks["static"]),
        "int8 dynamic": lambda img: fused_swin_apply(model, img, prepared=prepared,
                                                      int8_prepared=stacks["dynamic"]),
        "module pallas": lambda img: module(img),
    }
    # the slices traced at b32 too, and the window attention kernel whose
    # share of the traced time each prints
    attention = {"bf16": "window_attention", "module pallas": "window_sdpa"}
    with torch.no_grad():
        for slice_name, apply in slices.items():
            for batch in SWIN_BATCHES:
                img = torch.randn(batch, *shape,
                                  generator=torch.Generator().manual_seed(batch)).to(DEVICE)
                fn = lambda: apply(img)  # noqa: E731
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                e = harness.measure_call_time(fn, (), iters=10, repeats=5)
                peak = harness.device_peak_mb()
                d = harness.measure_graph_time(fn, iters=10, repeats=5)
                print(f"  swin_tiny {slice_name} b{batch}: eager p50 {e['p50_ms']:.4f} ms (std "
                      f"{e['std_ms']:.4f}, {batch * 1e3 / e['p50_ms']:.1f} img/s), device p50 "
                      f"{d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}), peak mem {peak:.1f} MiB")
                if batch == 1 or slice_name in attention:
                    prof = harness.device_time_by_kernel(fn)
                    busy = sum(r[2] for r in prof)
                    print(f"      traced kernel time {busy:.4f} ms (device idle "
                          f"{max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager call)")
                    if slice_name in attention:
                        kname = attention[slice_name]
                        sd = [r for r in prof if kname in r[0]]
                        sd_ms = sum(r[2] for r in sd)
                        print(f"      {kname} {sd_ms:.4f} ms in {sum(r[1] for r in sd)} "
                              f"launches, {sd_ms / busy if busy else 0.0:.1%} of the traced time")
                    for name, calls, ms in prof[:8]:
                        print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")


def phase_time_pallas(torch, harness, module_state, pruned_state):
    """The deit_tiny ``kernel_mode="pallas"`` module and ``PRUNED_UNIFORM``
    through ``fused_vit_apply`` (bf16) and ``fused_vit_apply_int8`` (static),
    at b1 and b128: eager and device p50, the device's idle share of the
    eager call and the device time by kernel at b1."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, fused_vit_apply_int8

    module, shape = module_state
    pruned, _, stacked, sq = pruned_state
    slices = {
        "deit_tiny module pallas": lambda img: module(img),
        "pruned ffn0.3 bf16": lambda img: fused_vit_apply(pruned, img, stacked=stacked),
        "pruned ffn0.3 int8 static": lambda img: fused_vit_apply_int8(pruned, img, stacked_q=sq),
    }
    with torch.no_grad():
        for slice_name, apply in slices.items():
            for batch in (1, 128):
                img = torch.randn(batch, *shape,
                                  generator=torch.Generator().manual_seed(batch)).to(DEVICE)
                fn = lambda: apply(img)  # noqa: E731
                e = harness.measure_call_time(fn, (), iters=10, repeats=5)
                d = harness.measure_graph_time(fn, iters=10, repeats=5)
                prof = harness.device_time_by_kernel(fn)
                busy = sum(r[2] for r in prof)
                print(f"  {slice_name} b{batch}: eager p50 {e['p50_ms']:.4f} ms (std "
                      f"{e['std_ms']:.4f}, {batch * 1e3 / e['p50_ms']:.1f} img/s), device p50 "
                      f"{d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}), traced kernel time "
                      f"{busy:.4f} ms (device idle {max(0.0, 1 - busy / e['p50_ms']):.1%} of the "
                      f"eager call)")
                if batch == 1:
                    for name, calls, ms in prof[:8]:
                        print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")


def _bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the HBM rate and
    the operations ``{type: count}`` over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(c / PEAK_OPS_PER_S[k] for k, c in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_yardsticks(torch, harness, dt=None):
    """Each kernel's bound and library yardstick over the launches its JSON
    row times: one deit_tiny b128 layer (ln_rows, linear, attention_rows;
    quant_rows and linear_i8 static; sdpa and mlp: the kernel_mode="pallas"
    module's), one t2t_vit_14 b1 stage1_kqv call (and one at b4, as
    ``"stage1_kqv b4"``), one swin_tiny b1 forward (window_attention,
    swin_merge; window_sdpa: the kernel_mode="pallas" module's), one
    deit_tiny b128 and one b1 forward (vit_full), one t2t_vit_14 b1
    tokenizer's two performers (performer_reduce, performer_rows; and at b32,
    as ``"<kernel> b32"``).  Bytes count each
    input read once and each output written once; operations are the
    tensor-core products for the GEMMs and attention (bf16 or int8), ~8
    fp32 operations per element for a LayerNorm, 3 for a quantization.  The
    library call is one PyTorch call of the same function at the same shapes
    (device p50, CUDA-graph replay; the GEMM calls leave out the epilogue);
    None where no one call computes it.  Returns ({kernel: (bound_ms,
    bound_by, library_ms)}, {"": K16's yardstick at b1, " b32": at b32}: the
    eager performer chain's device p50 over one tokenizer's two performers).
    ``dt``: the activations' dtype, bf16 (the default) or fp16 (phase 9's
    rows): the same bytes, the products at the same peak, the library calls
    on fp16 operands."""
    import torch.nn.functional as F

    from edgevisiontransformer_tpu_torch.models.swin import shifted_window_mask
    from edgevisiontransformer_tpu_torch.ops.cuda.swin_block import window_rows

    dev = DEVICE
    dt = dt or torch.bfloat16
    tc = "fp16" if dt == torch.float16 else "bf16"  # the tensor-core products' peak
    gen = torch.Generator(device=dev).manual_seed(9)

    def rnd(*shape, dtype=dt):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def lib(calls):
        return sum(reps * harness.measure_graph_time(fn)["p50_ms"] for fn, reps in calls)

    out = {}
    m, dim, mlp, heads, n = 128 * 197, 192, 768, 3, 197
    x, g, b = rnd(m, dim), rnd(dim), rnd(dim)
    out["ln_rows"] = (*_bound(2 * (4 * m * dim + 4 * dim), {"fp32": 2 * 8 * m * dim}),
                      lib([(lambda: F.layer_norm(x, (dim,), g, b, 1e-6), 2)]))
    gemms = ((dim, 3 * dim, False), (dim, dim, True), (dim, mlp, False), (mlp, dim, True))
    for rows, tag in ((m, ""), (n, " b1")):
        # the layer's four GEMMs at b128 (the kernels line) and at b1, and
        # each GEMM's own bound and torch.addmm time (phase 6 prints them)
        nbytes = ops = lib_ms = 0.0
        for name, (k, nn_, r) in zip(LINEAR_GEMMS, gemms):
            a, w, bb = rnd(rows, k), rnd(k, nn_), rnd(nn_)
            gb = 2 * (rows * k + k * nn_ + rows * nn_ * (2 if r else 1) + nn_)
            go = 2 * rows * k * nn_
            gl = lib([(lambda a=a, w=w, bb=bb: torch.addmm(bb, a, w), 1)])
            out[f"linear {name}{tag}"] = (*_bound(gb, {tc: go}), gl)
            nbytes, ops, lib_ms = nbytes + gb, ops + go, lib_ms + gl
        out[f"linear{tag}"] = (*_bound(nbytes, {tc: ops}), lib_ms)
    qkv = rnd(128, n, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
    key_mask = torch.zeros(1, 1, 1, n, dtype=dt, device=dev)
    out["attention_rows"] = (
        *_bound(2 * 4 * m * dim, {tc: 4 * 128 * heads * n * n * (dim // heads)}),
        lib([(lambda: F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                                     attn_mask=key_mask), 1)]))
    # and one deit_tiny b1 layer's call (phase 6's b1 row)
    qkv1 = rnd(1, n, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
    out["attention_rows b1"] = (
        *_bound(2 * 4 * n * dim, {tc: 4 * heads * n * n * (dim // heads)}),
        lib([(lambda: F.scaled_dot_product_attention(qkv1[0], qkv1[1], qkv1[2],
                                                     attn_mask=key_mask), 1)]))
    widths = (dim, dim, dim, mlp)  # the static layer quantizes qkv, out, fc1, fc2 inputs
    out["quant_rows"] = (*_bound(sum(3 * m * k for k in widths),
                                 {"fp32": sum(3 * m * k for k in widths)}), None)
    for rows, tag in ((m, ""), (n, " b1")):
        # a static-int8 layer's four GEMMs at b128 (the kernels line) and at
        # b1 (phase 6's b1 row); torch._int_mm leaves out the dequant and epilogue
        nbytes = sum(rows * k + k * nn_ + 2 * rows * nn_ * (2 if r else 1) + 8 * nn_
                     for k, nn_, r in gemms)
        mats8 = [(int8(rows, k), int8(k, nn_)) for k, nn_, _ in gemms]
        out[f"linear_i8{tag}"] = (
            *_bound(nbytes, {"int8": sum(2 * rows * k * nn_ for k, nn_, _ in gemms)}),
            lib([((lambda q=q, w=w: torch._int_mm(q, w)), 1) for q, w in mats8]))
    tok, feat, d = 3136, 147, 192
    for b, tag in ((1, ""), (4, " b4")):
        out[f"stage1_kqv{tag}"] = (
            *_bound(b * 2 * 3 * 224 * 224 + 2 * 432 * d + 4 * 432 + 8 * d + b * 2 * tok * d,
                    {tc: b * 2 * tok * feat * d, "fp32": b * 4 * tok * feat}), None)

    w, nw_ops, wa_bytes, wa_calls, sd_bytes, sd_calls = SWIN_WINDOW, 0, 0, [], 0, []
    nt = w * w
    merge_bytes, merge_ops = 0, 0
    for si, (res, sdim, sheads, depth) in enumerate(SWIN_STAGES):
        rows, nwin, hd = res * res, (res // w) ** 2, sdim // sheads
        idx = window_rows(res, w, 0, dev)
        win = rnd(rows, 3, sheads, hd)[idx].reshape(nwin, nt, 3, sheads, hd)
        q, k, v = win.permute(2, 0, 3, 1, 4).contiguous()
        bias = rnd(sheads, nt, nt, dtype=torch.float32)
        odd = depth // 2 if nwin > 1 else 0
        for shifted, reps in ((False, depth - odd), (True, odd)):
            if reps == 0:
                continue
            mask_b = 0
            am = bias[None] / LOG2E
            if shifted:
                mk = torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).to(dev) * LOG2E
                am, mask_b = (bias[None] + mk[:, None]) / LOG2E, 4 * nwin * nt * nt
            am = am.to(dt).expand(nwin, sheads, nt, nt).contiguous()
            wa_bytes += reps * (2 * 4 * rows * sdim + 4 * sheads * nt * nt + mask_b)
            nw_ops += reps * 4 * nwin * sheads * nt * nt * hd
            wa_calls.append(((lambda q=q, k=k, v=v, am=am:
                              F.scaled_dot_product_attention(q, k, v, attn_mask=am)), reps))
            # window_sdpa (the module path): a bf16 bias [H, n, n] and the raw fp32
            # mask [nW, n, n]; SDPA on the same window-major q, k, v with their sum
            sm_ = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).to(dev)[:, None]
                   if shifted else 0.0)
            am16 = (bias.to(dt).float()[None] + sm_).to(dt)
            am16 = am16.expand(nwin, sheads, nt, nt).contiguous()
            sd_bytes += reps * (2 * 4 * rows * sdim + 2 * sheads * nt * nt + mask_b)
            sd_calls.append(((lambda q=q, k=k, v=v, am=am16:
                              F.scaled_dot_product_attention(q, k, v, attn_mask=am)), reps))
        if si < len(SWIN_STAGES) - 1:
            merge_bytes += 2 * rows * sdim + 2 * rows * sdim + 2 * 4 * 4 * sdim
            merge_ops += 8 * rows * sdim
    out["window_attention"] = (*_bound(wa_bytes, {tc: nw_ops}), lib(wa_calls))
    out["swin_merge"] = (*_bound(merge_bytes, {"fp32": merge_ops}), None)
    out["window_sdpa"] = (*_bound(sd_bytes, {tc: nw_ops}), lib(sd_calls))

    # sdpa: one deit_tiny b128 layer's call, q, k, v as views of the fused qkv;
    # the library call is SDPA on the same views (no mask: n is not padded)
    b, hd = 128, dim // heads
    qkv5 = rnd(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    out["sdpa"] = (*_bound(2 * 4 * b * heads * n * hd, {tc: 4 * b * heads * n * n * hd}),
                   lib([(lambda: F.scaled_dot_product_attention(qkv5[0], qkv5[1], qkv5[2]), 1)]))
    # mlp: one deit_tiny b128 layer (erf GELU); the library yardstick is
    # torch.addmm + F.gelu + torch.addmm timed as one sum
    xm, w1, b1, w2, b2 = rnd(m, dim), rnd(dim, mlp), rnd(mlp), rnd(mlp, dim), rnd(dim)
    out["mlp"] = (*_bound(2 * (2 * m * dim + 2 * dim * mlp + mlp + dim),
                          {tc: 4 * m * dim * mlp}),
                  lib([(lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, xm, w1)), w2), 1)]))
    # and one deit_tiny b1 layer, where the module loses its time
    x1 = xm[:n]
    out["mlp b1"] = (*_bound(2 * (2 * n * dim + 2 * dim * mlp + mlp + dim),
                             {tc: 4 * n * dim * mlp}),
                     lib([(lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, x1, w1)), w2), 1)]))
    # vit_full: one deit_tiny b128 forward and one b1 (12 layers, fp32 image
    # in, bf16 logits out); inputs are the image and every weight, read once
    depth, pin, classes = 12, 768, 1000
    wbytes = 2 * (pin * dim + n * dim + 2 * dim + dim * classes + classes + depth * (
        3 * dim * dim + 3 * dim + dim * dim + dim + 4 * dim + 2 * dim * mlp + mlp + dim))
    for b, key in ((128, "vit_full"), (1, "vit_full b1")):
        flops = 2 * b * ((n - 1) * pin * dim + dim * classes
                         + depth * (n * (4 * dim * dim + 2 * dim * mlp) + 2 * n * n * dim))
        out[key] = (*_bound(wbytes + 4 * b * 3 * 224 * 224 + 2 * b * classes,
                            {tc: flops}), None)
    # K16 at one t2t_vit_14 tokenizer (both performers, n = 3136 and 784) at
    # b1 (the kernels line) and at b32, K16's own work whatever the kernels'
    # design: each kernel reads its thirds of x_kqv (k, v; q, v) and its
    # weights once, performer_reduce writes an image's sums [m + ts m] in
    # fp32 once and performer_rows reads them once and writes the output;
    # products of bf16 operands (t w^T, the three ts x ts products) at the
    # bf16 rate, the rest in fp32: |t|^2 2 ts, the exponent 2 m, kp_sum m,
    # v^T kp and y 2 ts m each, d 2 m, the division ts, the bias adds and
    # skips 5 ts, the LayerNorm 8 ts, GELU 8 ts
    from edgevisiontransformer_tpu_torch.config import ViTConfig
    from edgevisiontransformer_tpu_torch.models.t2t_vit import _performer_rest

    ts, mf = 64, 32
    sums_bytes, weight_bytes = 4 * mf * (1 + ts), 2 * (mf * ts + 3 * ts * ts) + 4 * 5 * ts
    pp, pw = performer_params(torch, gen)
    cfg = ViTConfig(dtype=dt, gelu_approx=True)
    chains = {}
    for b, tag in ((1, ""), (32, " b32")):
        rb = rbf = rf = wb = wbf = wf = 0
        chain = 0.0
        for nt in (3136, 784):
            tok = b * nt
            rb += 2 * tok * 2 * ts + 2 * mf * ts + b * sums_bytes
            rbf += 2 * tok * mf * ts
            rf += tok * (2 * ts + 2 * mf + mf + 2 * ts * mf)
            wb += 2 * tok * 2 * ts + weight_bytes + b * sums_bytes + 2 * tok * ts
            wbf += tok * (2 * mf * ts + 3 * 2 * ts * ts)
            wf += tok * (2 * ts + 2 * mf + 2 * mf + 2 * ts * mf + ts + 5 * ts + 8 * ts + 8 * ts)
            xk = rnd(b, nt, 192)
            chain += harness.measure_graph_time(
                lambda: _performer_rest(xk, pp, pw, cfg))["p50_ms"]
            del xk
        out[f"performer_reduce{tag}"] = (*_bound(rb, {tc: rbf, "fp32": rf}), None)
        out[f"performer_rows{tag}"] = (*_bound(wb, {tc: wbf, "fp32": wf}), None)
        chains[tag] = chain
        print(f"  K16's yardstick, the eager performer chain (_performer_rest, ~40 torch ops) at "
              f"one t2t_vit_14 b{b} tokenizer's two performers: {chain:.4f} ms")
    for k, (bnd, by, lib_ms) in out.items():
        print(f"  {k:16s} bound {bnd:.4f} ms ({by}), library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    return out, chains


def vit_huge_yardsticks(torch, harness) -> dict:
    """The bound and library call of phase 6's ViT-H/14 rows, one layer at
    ``VIT_H_ROWS``' batches: ``attention_rows`` (16 heads of 80 over the
    fused qkv rows; library: SDPA with a key mask, as the deit_tiny row's),
    ``sdpa`` (library: SDPA on the same q, k, v views) and ``mlp`` (dim 1280,
    hidden 5120, exact GELU; library: ``torch.addmm`` + ``F.gelu`` +
    ``torch.addmm`` timed as one sum); bytes and operations counted as
    :func:`phase_yardsticks` counts them; and ``sdpa`` at one deit_base 384
    b8 layer (12 heads of 64, 577 keys).  Returns {"<kernel> ViT-H/14 b<n>":
    (bound_ms, bound_by, library_ms), "sdpa deit_base 384 b8": ...}."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(19)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    def lib(fn):
        return harness.measure_graph_time(fn)["p50_ms"]

    n, heads, hd, dim, hid = 257, 16, 80, 1280, 5120
    out = {}
    for tag, b in VIT_H_ROWS.items():
        qkv = rnd(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        key_mask = torch.zeros(1, 1, 1, n, dtype=torch.bfloat16, device=DEVICE)
        bound = _bound(2 * 4 * b * n * heads * hd, {"bf16": 4 * b * heads * n * n * hd})
        out[f"attention_rows {tag}"] = (*bound, lib(
            lambda: F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=key_mask)))
        out[f"sdpa {tag}"] = (*bound, lib(
            lambda: F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])))
        m = b * n
        x, w1, b1, w2, b2 = rnd(m, dim), rnd(dim, hid), rnd(hid), rnd(hid, dim), rnd(dim)
        out[f"mlp {tag}"] = (
            *_bound(2 * (2 * m * dim + 2 * dim * hid + hid + dim), {"bf16": 4 * m * dim * hid}),
            lib(lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, x, w1)), w2)))
        del qkv, x, w1, w2
    b, heads, n, hd = SDPA_SHAPES["deit_base 384 b8"]
    qkv = rnd(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    out["sdpa deit_base 384 b8"] = (
        *_bound(2 * 4 * b * n * heads * hd, {"bf16": 4 * b * heads * n * n * hd}),
        lib(lambda: F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])))
    return out


def first_parting_layer(torch, fe, model, img, sq):
    """Run the int8 encoder one layer at a time, kernels and twins on the
    twins' input, and print each layer's largest relative deviation."""
    from edgevisiontransformer_tpu_torch.models.vit import _fused_embed

    cfg = model.config
    kw = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
              reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx)
    x = _fused_embed(cfg, model.params(), img)
    for i in range(cfg.depth):
        layer = {k: v[i:i + 1] for k, v in sq.items() if k != "act_inv"}
        if "act_inv" in sq:
            layer["act_inv"] = sq["act_inv"][i:i + 1].contiguous()
        got = fe.encoder_forward_int8(x, layer, **kw)
        ref = fe.encoder_forward_int8_plain(x, layer, **kw)
        rel = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        print(f"    layer {i}: max |kernels - twins| / max|twins| {rel:.4g}")
        x = ref


def phase_slice(torch, counter):
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply,
                                                             prepare_vit_fused)

    dev = DEVICE
    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    models = {}

    def request(tag, name, style, batch, seed):
        nonlocal worst
        key = (name, style)
        if key not in models:
            model, shape = build_model(name, style=style, dtype=torch.bfloat16, device=dev,
                                       generator=torch.Generator().manual_seed(0))
            models[key] = (model, shape, prepare_vit_fused(model))
        model, shape, stacked = models[key]
        depth = model.config.depth
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed))
        img = img.to(dev)
        with torch.no_grad():
            counter.reset()
            logits = fused_vit_apply(model, img, stacked=stacked)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = fused_vit_apply(model, img, stacked=stacked, plain=True)
            eager = model(img)
        want = want_launches(BF16_LAUNCHES, depth)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, model.config.num_classes)
        worst = max(worst, rel)
        e_err = float((logits.float() - eager.float()).abs().max())
        print(f"  {tag:28s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
              f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}, "
              f"max|kern-eager model| {e_err:.4g}, launches {counts}")
        return model, stacked, img

    for i in range(3):
        request(f"deit_tiny b1 #{i + 1}", "deit_tiny", "standard", 1, 100 + i)
    request("deit_tiny b128", "deit_tiny", "standard", 128, 200)
    request("deit_tiny b1 reference-style", "deit_tiny", "reference", 1, 300)
    request("deit_base b8", "deit_base", "standard", 8, 400)
    return launches, worst, models


def phase_slice_int8(torch, fe, counter, models):
    """The int8 slice through ``fused_vit_apply_int8`` on the bf16 slice's
    models; returns (launches, worst deviation, {(name, style, mode): stack})."""
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply,
                                                             fused_vit_apply_int8,
                                                             prepare_vit_int8,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    stacks = {}

    def request(tag, name, style, mode, batch, seed):
        nonlocal worst
        model, shape, stacked = models[(name, style)]
        key = (name, style, mode)
        if key not in stacks:
            t0 = time.perf_counter()
            with torch.no_grad():
                stacks[key] = (prepare_vit_int8_static(
                    model, calib_batches=representative_batches(n=8, shape=shape))
                    if mode == "static" else prepare_vit_int8(model))
            torch.cuda.synchronize()
            print(f"  {name} {style} {mode} int8 stack prepared in "
                  f"{time.perf_counter() - t0:.2f} s")
        sq = stacks[key]
        depth = model.config.depth
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed))
        img = img.to(DEVICE)
        with torch.no_grad():
            counter.reset()
            logits = fused_vit_apply_int8(model, img, stacked_q=sq)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = fused_vit_apply_int8(model, img, stacked_q=sq, plain=True)
            bf16 = fused_vit_apply(model, img, stacked=stacked)
        want = want_launches(INT8_LAUNCHES, depth)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        err = float((logits.float() - ref.float()).abs().max())
        if err > LOGIT_REL * float(ref.float().abs().max()):
            print(f"  {tag}: kernels and twins part; per layer:")
            with torch.no_grad():
                first_parting_layer(torch, fe, model, img, sq)
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, model.config.num_classes)
        worst = max(worst, rel)
        agree_bf16 = float((logits.argmax(-1) == bf16.argmax(-1)).float().mean())
        print(f"  {tag:34s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
              f"(max|logit| {scale:.4g}), top-1 agreement with twins {agree:.3f}, "
              f"with the bf16 path {agree_bf16:.3f}, launches {counts}")

    for i in range(3):
        request(f"deit_tiny int8 static b1 #{i + 1}", "deit_tiny", "standard", "static", 1,
                500 + i)
    request("deit_tiny int8 static b128", "deit_tiny", "standard", "static", 128, 600)
    request("deit_tiny int8 dynamic b1", "deit_tiny", "standard", "dynamic", 1, 700)
    request("deit_tiny int8 static b1 reference-style", "deit_tiny", "reference", "static", 1,
            800)
    request("deit_base int8 static b8", "deit_base", "standard", "static", 8, 900)
    return launches, worst, stacks


def phase_time_slice(torch, harness, models, stacks):
    """Eager p50 (what a caller gets: host launch work included), device
    p50 (CUDA-graph replay of the same calls), peak memory and the device
    time by kernel, for the kernel path and the plain path: bf16, then int8
    static and dynamic."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, fused_vit_apply_int8

    model, shape, stacked = models[("deit_tiny", "standard")]
    slices = {
        "bf16": lambda img, plain: fused_vit_apply(model, img, stacked=stacked, plain=plain),
        "int8 static": lambda img, plain: fused_vit_apply_int8(
            model, img, stacked_q=stacks[("deit_tiny", "standard", "static")], plain=plain),
        "int8 dynamic": lambda img, plain: fused_vit_apply_int8(
            model, img, stacked_q=stacks[("deit_tiny", "standard", "dynamic")], plain=plain),
    }
    for slice_name, apply in slices.items():
        for batch in (1, 128):
            img = torch.randn(batch, *shape,
                              generator=torch.Generator().manual_seed(batch)).to(DEVICE)
            with torch.no_grad():
                for path, plain in (("kernels", False), ("plain", True)):
                    fn = lambda: apply(img, plain)  # noqa: E731
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    e = harness.measure_call_time(fn, (), iters=10, repeats=5)
                    peak = harness.device_peak_mb()
                    d = harness.measure_graph_time(fn, iters=10, repeats=5)
                    prof = harness.device_time_by_kernel(fn)
                    busy = sum(r[2] for r in prof)
                    print(f"  deit_tiny {slice_name} b{batch} {path:7s}: eager p50 "
                          f"{e['p50_ms']:.4f} ms (std {e['std_ms']:.4f}, "
                          f"{batch * 1e3 / e['p50_ms']:.1f} img/s), device p50 "
                          f"{d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}), peak mem "
                          f"{peak:.1f} MiB, traced kernel time {busy:.4f} ms (device idle "
                          f"{max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager call)")
                    for name, calls, ms in prof[:6]:
                        print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")


def phase_slice_full(torch, counter, vf, models):
    """``fully_fused_vit_apply`` (full width and depth, phase_slice's models)
    at ``FULL_REQUESTS``: one ``vit_full`` launch per forward and no other,
    logits against ``plain=True`` and against ``fused_vit_apply``, and one
    device kernel in a profiler trace of a forward on a bf16 image.  Returns
    (launches, worst deviation, {name: prepared})."""
    from edgevisiontransformer_tpu_torch.bench import harness
    from edgevisiontransformer_tpu_torch.models.vit import (fully_fused_vit_apply,
                                                             fused_vit_apply, prepare_vit_full)

    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    preps = {}
    want = {**{k: 0 for k in KERNELS}, "vit_full": 1}
    for name, batch, seed in FULL_REQUESTS:
        model, shape, stacked = models[(name, "standard")]
        if name not in preps:
            with torch.no_grad():
                preps[name] = prepare_vit_full(model)
        prep = preps[name]
        tag = f"{name} fully fused b{batch}"
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed)).to(DEVICE)
        with torch.no_grad():
            counter.reset()
            logits = fully_fused_vit_apply(model, img, prepared=prep)
            torch.cuda.synchronize()
            counts = counter.read()
            grid = vf.LAST_GRID["blocks"]
            ref = fully_fused_vit_apply(model, img, prepared=prep, plain=True)
            chain = fused_vit_apply(model, img, stacked=stacked)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, model.config.num_classes)
        rel2, err2, _, agree2 = check_logits(f"{tag} against fused_vit_apply", logits, chain,
                                             batch, model.config.num_classes)
        worst = max(worst, rel, rel2)
        img16 = img.bfloat16()
        with torch.no_grad():
            rows = harness.device_time_by_kernel(
                lambda: fully_fused_vit_apply(model, img16, prepared=prep))
        if len(rows) != 1 or rows[0][1] != 1 or "vit_full" not in rows[0][0]:
            fail(f"{tag}: a traced forward ran {[(r[0][:60], r[1]) for r in rows]}, expected "
                 "one vit_full kernel")
        print(f"  {tag:30s} grid {grid} blocks, max|kern-twin| {err:.4g} (max|logit| "
              f"{scale:.4g}), top-1 agreement {agree:.3f}; against fused_vit_apply max "
              f"{err2:.4g}, top-1 {agree2:.3f}; launches {counts['vit_full']} vit_full, trace: "
              f"one kernel, {rows[0][2]:.4f} ms")
    return launches, worst, preps


def phase_time_full(torch, harness, vf, models, preps):
    """``fully_fused_vit_apply`` beside ``fused_vit_apply`` at ``FULL_TIMES``:
    eager p50, device p50 (CUDA-graph replay), the device's idle share of the
    eager call; the cost of one grid barrier at the forward's block count.
    Returns {"vit_full": (ms, plain_ms), "vit_full b1": (ms, plain_ms)}:
    device p50 of one deit_tiny b128 and one b1 forward on the kernel and on
    its twin."""
    from edgevisiontransformer_tpu_torch.models.vit import (fully_fused_vit_apply,
                                                             fused_vit_apply, prepare_vit_full)

    rows = {}
    with torch.no_grad():
        for name, batch in FULL_TIMES:
            model, shape, stacked = models[(name, "standard")]
            prep = preps.get(name) or prepare_vit_full(model)
            img = torch.randn(batch, *shape,
                              generator=torch.Generator().manual_seed(batch)).to(DEVICE)
            paths = {"fully_fused_vit_apply": lambda: fully_fused_vit_apply(model, img,
                                                                            prepared=prep),
                     "fused_vit_apply": lambda: fused_vit_apply(model, img, stacked=stacked)}
            device = {}
            for label, fn in paths.items():
                e = harness.measure_call_time(fn, (), iters=10, repeats=5)
                d = harness.measure_graph_time(fn, iters=10, repeats=5)
                prof = harness.device_time_by_kernel(fn)
                busy = sum(r[2] for r in prof)
                device[label] = d["p50_ms"]
                print(f"  {name} b{batch} {label:21s}: eager p50 {e['p50_ms']:.4f} ms (std "
                      f"{e['std_ms']:.4f}, {batch * 1e3 / e['p50_ms']:.1f} img/s), device p50 "
                      f"{d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}), traced kernel time "
                      f"{busy:.4f} ms in {sum(r[1] for r in prof)} kernels (device idle "
                      f"{max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager call)")
            fully_fused_vit_apply(model, img, prepared=prep)
            grid = vf.LAST_GRID["blocks"]
            vf.barrier_probe(img.device, grid, 10)
            t = harness.measure_call_time(lambda: vf.barrier_probe(img.device, grid, 1000), (),
                                        iters=3, repeats=5)["p50_ms"]
            n_bar = vf.barriers(model.config.depth)
            print(f"  {name} b{batch}: one grid barrier at {grid} blocks {t:.4f} us (1000 in one "
                  f"launch); {n_bar} per forward, {n_bar * t / 1e3:.4f} ms, "
                  f"{n_bar * t / 1e3 / device['fully_fused_vit_apply']:.1%} of its device p50")
            if name == "deit_tiny":
                plain = harness.measure_graph_time(
                    lambda: fully_fused_vit_apply(model, img, prepared=prep, plain=True),
                    iters=5, repeats=3)["p50_ms"]
                rows["vit_full" if batch == 128 else f"vit_full b{batch}"] = (
                    device["fully_fused_vit_apply"], plain)
    return rows


def phase_time_base(torch, harness, models, stacks):
    """deit_base b1 device p50, bf16 against int8 static: the weight-bytes
    case the TPU int8 kernel was written for; returns the bf16 p50."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, fused_vit_apply_int8

    model, shape, stacked = models[("deit_base", "standard")]
    sq = stacks[("deit_base", "standard", "static")]
    img = torch.randn(1, *shape, generator=torch.Generator().manual_seed(1)).to(DEVICE)
    with torch.no_grad():
        d16 = harness.measure_graph_time(lambda: fused_vit_apply(model, img, stacked=stacked),
                                         iters=10, repeats=5)
        d8 = harness.measure_graph_time(
            lambda: fused_vit_apply_int8(model, img, stacked_q=sq), iters=10, repeats=5)
    print(f"  deit_base b1 device p50: bf16 {d16['p50_ms']:.4f} ms (std {d16['std_ms']:.4f}), "
          f"int8 static {d8['p50_ms']:.4f} ms (std {d8['std_ms']:.4f}), "
          f"int8 / bf16 {d8['p50_ms'] / d16['p50_ms']:.3f}")
    return d16["p50_ms"]


# Phase 7: training on the card.  deit_tiny standard, fp32 parameters and
# compute, SGD with momentum; the batch of the step timings and checks.
TRAIN_BATCH = 32
TRAIN_LR = 0.01
TRAIN_STEPS = 4
# two train steps on the card against the same two on the CPU (TF32 off):
# losses within 1e-4 relative, every param within one fp32 spacing plus
# 1e-3 of the largest update (cuBLAS and the CPU's BLAS sum in other orders
# through 12 layers, forward and backward)
CPU_LOSS_RTOL = 1e-4
CPU_STEP_REL = 1e-3
# remat's gradients against the plain backward's: the recompute runs the
# same kernels on the same inputs, so equal; the bound leaves 1e-6 of the
# leaf's largest gradient for a reduction the library might reorder
REMAT_REL = 1e-6
# The static-aware QAT forward (fp32, as it trains) against the fp32
# static-int8 oracle (int8_vit_apply_static) on the same weights and scales,
# logits at b32: the JAX package's bound, 2e-2 of max|logit|
# (tests/test_quant.py:419-421).  Through 12 layers the logits part by
# chance as much as by quantization (PERF.md section 6), so the check that
# tells a quantizing forward from one that does not is made per matmul:
# each encoder matmul's input in the oracle's forward, through the QAT
# forward's product fq(x) @ fq(w), against the oracle's int8 product, within
# QAT_MM_REL of that product's max|.|; the unquantized x @ w must part by
# more.  The QAT forward divides by the scale (as JAX's does) where the
# deployment multiplies by its reciprocal, so a few inputs a matmul that sit
# on a rounding tie take the other integer: each moves its row by one
# quantum times a weight row.
QAT_REL = 2e-2
QAT_MM_REL = 5e-3
# the smoothed fp32 forward against the unsmoothed one: the same function
# re-parameterized, the folded scales rounded once each
SMOOTH_REL = 1e-3


def _step_dev(torch, got, want, start, keep=None):
    """max |got - want| less one fp32 spacing of ``want``, and the largest
    update |want - start|; ``keep(name, t)``, where given, picks the
    elements of each leaf that count."""
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import flatten_tree

    w, s = flatten_tree(want), flatten_tree(start)
    pick = keep or (lambda name, t: t)
    dev = upd = 0.0
    for k, g in flatten_tree(got).items():
        ref = w[k].float().cpu()
        spacing = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))) - ref.abs()
        dev = max(dev, float(pick(k, ((g.float().cpu() - ref).abs() - spacing).clamp(min=0))
                             .max()))
        upd = max(upd, float((ref - s[k].float().cpu()).abs().max()))
    return dev, upd


def phase_train(torch, harness, counter, card):
    """Finetuning, QAT and SmoothQuant on the card, then the trained model
    served on the kernels: (a) SGD steps at b32 on deit_tiny (standard, full
    width and depth, fp32), the loss finite and falling on the repeated
    batch, every parameter's gradient finite and non-zero, two steps against
    the same two on the CPU, ``remat`` against the plain backward; (b) a
    checkpoint and a resume into a fresh model against the uninterrupted
    steps; (c) two static-aware QAT steps on ``calibrate_vit``'s scales,
    whose forward is then held against the fp32 static-int8 oracle (logits,
    and each matmul on the oracle's input:
    ``bench/qat_oracle.matmul_deviation``), and the int8 kernels on the QAT
    weights against their twins; (d)
    ``smooth_vit`` (n = 8), the smoothed forward against the unsmoothed one,
    then the smoothed model calibrated, prepared and served in static int8
    at b1 and b32, and ``cast_params(bf16)`` served by ``fused_vit_apply``;
    (e) ``smooth_t2t`` on t2t_vit_14 (reference style), served in static
    int8 at b1 (K8, K16); (f) ``make_eval_step`` over ``fused_vit_apply``.
    Prints each request's launch counts, the train and QAT steps' times and
    the phase's peak memory; returns the worst logit deviation."""
    from edgevisiontransformer_tpu_torch.bench.qat_oracle import matmul_deviation
    from edgevisiontransformer_tpu_torch.models import t2t_vit as t2t
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (ViT, apply_params,
                                                             fused_vit_apply,
                                                             fused_vit_apply_int8, load_params,
                                                             prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops import quant
    from edgevisiontransformer_tpu_torch.parallel.train import (cross_entropy, make_eval_step,
                                                                make_train_step)
    from edgevisiontransformer_tpu_torch.utils.checkpoint import (load_checkpoint, load_meta,
                                                                  save_checkpoint)
    from edgevisiontransformer_tpu_torch.utils.finetune import FinetuneConfig, build_optimizer
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import flatten_tree, tree_map

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model, shape = build_model("deit_tiny", style="standard", device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    cfg = model.config
    classes = cfg.num_classes
    data = torch.Generator().manual_seed(2100)
    batches = [(torch.randn(TRAIN_BATCH, *shape, generator=data).to(DEVICE),
                torch.randint(0, classes, (TRAIN_BATCH,), generator=data).to(DEVICE))
               for _ in range(TRAIN_STEPS)]
    img, labels = batches[0]
    apply = lambda p, x: apply_params(model, p, x)  # noqa: E731
    opt = build_optimizer(FinetuneConfig(lr=TRAIN_LR, optimizer="sgd"))
    step = make_train_step(apply, opt)
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)  # noqa: E731
    init = clone(model.params())

    # (a) every parameter's gradient, with and without remat
    def grads_of(m, tree):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(), tree)
        loss = cross_entropy(apply_params(m, live, img), labels)
        flat = flatten_tree(live)
        return dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))

    g = grads_of(model, init)
    bad = [k for k, v in g.items() if not torch.isfinite(v).all() or not bool(v.any())]
    if bad:
        fail(f"train: non-finite or all-zero gradients in {bad}")
    remat = ViT(cfg.replace(remat=True), device=DEVICE,
                generator=torch.Generator().manual_seed(1))
    g_r = grads_of(remat, init)
    remat_dev = max(float((g_r[k] - v).abs().max() / v.abs().max()) for k, v in g.items())
    remat_same = all(torch.equal(g_r[k], v) for k, v in g.items())
    if remat_dev > REMAT_REL:
        fail(f"train: remat's gradients part from the plain backward's by {remat_dev:.3g} "
             f"of a leaf's largest gradient (> {REMAT_REL})")
    del remat, g_r

    # (a) SGD steps on the repeated batch: finite, falling, the first two
    # against the CPU's
    params, state = model.params(), opt.init(model.params())
    losses = []
    for i in range(TRAIN_STEPS):
        params, state, m = step(params, state, img, labels)
        losses.append(float(m["loss"]))
        if i == 1:
            after_two = clone(params)
    with torch.no_grad():
        final = float(cross_entropy(apply(params, img), labels))
    if not all(math.isfinite(v) for v in losses + [final]) or not final < losses[0]:
        fail(f"train: losses {losses}, then {final} on the repeated batch: not finite and "
             f"falling")
    cpu_model = ViT(cfg, device="cpu")
    cpu_params = tree_map(lambda t: t.to("cpu", copy=True), init)
    cpu_state = opt.init(cpu_params)
    cpu_step = make_train_step(lambda p, x: apply_params(cpu_model, p, x), opt)
    t0 = time.perf_counter()
    cpu_losses = []
    for _ in range(2):
        cpu_params, cpu_state, m = cpu_step(cpu_params, cpu_state, img.cpu(), labels.cpu())
        cpu_losses.append(float(m["loss"]))
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:2], cpu_losses))
    dev, upd = _step_dev(torch, after_two, cpu_params, init)
    print(f"  deit_tiny SGD b{TRAIN_BATCH} (lr {TRAIN_LR}, momentum 0.9), {TRAIN_STEPS} steps on "
          f"one batch: losses {[round(v, 4) for v in losses]}, then {final:.4f}; every "
          f"gradient finite and non-zero; remat's gradients "
          f"{'bit for bit' if remat_same else f'within {remat_dev:.3g}'} the plain "
          f"backward's")
    print(f"  two steps card / CPU ({cpu_s:.1f} s on the CPU): losses "
          f"{[round(v, 6) for v in losses[:2]]} / {[round(v, 6) for v in cpu_losses]} (max "
          f"rel {loss_rel:.3g}), params max |card - CPU| {dev:.3g} beyond one spacing, the "
          f"largest update {upd:.3g}")
    if loss_rel > CPU_LOSS_RTOL or not dev <= CPU_STEP_REL * upd:
        fail(f"train: two steps on the card part from the CPU's (losses rel {loss_rel:.3g} > "
             f"{CPU_LOSS_RTOL}, or params {dev:.3g} > {CPU_STEP_REL} x {upd:.3g})")
    del cpu_model, cpu_params, cpu_state, after_two

    # (b) checkpoint and resume: 2 + 2 steps against 4
    ref, ref_state = clone(init), opt.init(init)
    for x, y in batches:
        ref, ref_state, _ = step(ref, ref_state, x, y)
    p2, s2 = clone(init), opt.init(init)
    for x, y in batches[:2]:
        p2, s2, _ = step(p2, s2, x, y)
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    save_checkpoint(ck, {"params": p2, "opt_state": s2}, meta={"step": 2})
    fresh = ViT(cfg, device=DEVICE, generator=torch.Generator().manual_seed(3))
    loaded = load_checkpoint(ck, {"params": fresh.params(), "opt_state": opt.init(init)})
    load_params(fresh, loaded["params"])
    p4, s4 = fresh.params(), loaded["opt_state"]
    fresh_step = make_train_step(lambda p, x: apply_params(fresh, p, x), opt)
    for x, y in batches[2:]:
        p4, s4, _ = fresh_step(p4, s4, x, y)
    ref_flat = flatten_tree(ref)
    resume_dev = max(float((v - ref_flat[k]).abs().max()) for k, v in flatten_tree(p4).items())
    print(f"  checkpoint at step {load_meta(ck)['step']}, resumed in a fresh model: 2 + 2 "
          f"steps against 4, max |dp| {resume_dev:.3g}")
    if resume_dev != 0.0:
        fail(f"train: the resumed run parts from the uninterrupted one by {resume_dev:.3g}")
    del fresh, loaded, p2, s2, p4, s4, ref, ref_state

    # timing of the train step (on a copy: the steps update it)
    def timed(tag, step_fn):
        tp = clone(params)
        ts = opt.init(tp)
        fn = lambda: step_fn(tp, ts, img, labels)  # noqa: E731
        e = harness.measure_call_time(fn, (), iters=5, repeats=5, warmup=2)
        prof = harness.device_time_by_kernel(fn)
        busy = sum(r[2] for r in prof)
        # the host time of binding a torch.optim object, as every step does
        leaves = {k: v.detach().requires_grad_() for k, v in flatten_tree(tp).items()}
        t0 = time.perf_counter()
        for _ in range(20):
            opt.bind(leaves, ts)
        bind_ms = (time.perf_counter() - t0) * 1e3 / 20
        print(f"  {tag} step b{TRAIN_BATCH}: eager p50 {e['p50_ms']:.4f} ms (std "
              f"{e['std_ms']:.4f}, {TRAIN_BATCH * 1e3 / e['p50_ms']:.1f} img/s), traced kernel "
              f"time {busy:.4f} ms (device idle {max(0.0, 1 - busy / e['p50_ms']):.1%} of the "
              f"eager step), binding the optimizer {bind_ms:.4f} ms of host time "
              f"({bind_ms / e['p50_ms']:.1%} of the eager step), on {card}")
        for name, calls, ms in prof[:4]:
            print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")

    timed("train (SGD, fp32)", step)
    trained = model.params()

    worst = 0.0

    def served(tag, fn, batch, want):
        """One request on the kernels, its launch counts checked, against
        the twins; returns the logits."""
        nonlocal worst
        with torch.no_grad():
            counter.reset()
            logits = fn(False)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = fn(True)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, classes)
        worst = max(worst, rel)
        print(f"  {tag:40s} max|kern-twin| {err:.4g} (max|logit| {scale:.4g}), top-1 "
              f"agreement {agree:.3f}, launches { {k: v for k, v in counts.items() if v} }")
        return logits

    calib = lambda: quant.representative_batches(n=8, shape=shape)  # noqa: E731
    bf16_cfg = cfg.replace(dtype=torch.bfloat16)
    int8_want = want_launches(INT8_LAUNCHES, cfg.depth)

    # (c) static-aware QAT on calibrate_vit's scales, then its forward against
    # the int8 kernels on the same weights and scales
    with torch.no_grad():
        scales = quant.calibrate_vit(model, trained, batches=calib())
    qat_params = clone(trained)
    qat_apply = lambda p, x: quant.fake_quant_vit_apply_static(model, p, scales, x)  # noqa: E731
    qat_step = make_train_step(qat_apply, opt)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), qat_params)
    flat = flatten_tree(live)
    q_grads = dict(zip(flat, torch.autograd.grad(cross_entropy(qat_apply(live, img), labels),
                                                 list(flat.values()))))
    if not all(torch.isfinite(v).all() for v in q_grads.values()) or not bool(
            q_grads["block_0.attn.qkv_kernel"].any()):
        fail("QAT: non-finite gradients, or none through the weight STE")
    q_state = opt.init(qat_params)
    q_losses = []
    for _ in range(2):
        qat_params, q_state, m = qat_step(qat_params, q_state, img, labels)
        q_losses.append(float(m["loss"]))
    if not all(math.isfinite(v) for v in q_losses):
        fail(f"QAT: losses {q_losses}")
    serve = ViT(bf16_cfg, device=DEVICE)
    load_params(serve, qat_params)
    sq = prepare_vit_int8_static(serve, act_scales=scales)
    kern = served(f"QAT deit_tiny int8 static b{TRAIN_BATCH}", lambda plain: fused_vit_apply_int8(
        serve, img, stacked_q=sq, plain=plain), TRAIN_BATCH, int8_want)
    with torch.no_grad():
        fq32 = qat_apply(qat_params, img)
        fq16 = quant.fake_quant_vit_apply_static(serve, qat_params, scales, img).float()
        qparams = quant.quantize_vit_params_int8_static(qat_params, scales)
        oracle = quant.int8_vit_apply_static(model, qparams, img)
        unquantized = apply(qat_params, img)
    rel = lambda a, b: float((a.float() - b).abs().max() / b.abs().max())  # noqa: E731
    qat_rel, plain_rel = rel(fq32, oracle), rel(unquantized, oracle)
    agree = float((fq32.argmax(-1) == oracle.argmax(-1)).float().mean())
    mm = matmul_deviation(cfg, qat_params, qparams, scales, img)
    mm_qat, mm_plain = mm["qat_max"], mm["plain_max"]
    print(f"  QAT: losses {[round(v, 4) for v in q_losses]}; against the fp32 static-int8 "
          f"oracle on the same weights and scales, max |err| / max|logit|: its fp32 forward "
          f"{qat_rel:.4g} (bound {QAT_REL}, top-1 agreement {agree:.3f}), the unquantized "
          f"forward {plain_rel:.4g}; each of the {4 * cfg.depth} matmuls on the oracle's input, "
          f"max |err| / max|product|: the QAT product {mm_qat:.4g} (bound {QAT_MM_REL}), the "
          f"unquantized {mm_plain:.4g} (must exceed it); against the int8 kernels (not held): "
          f"its fp32 forward {rel(fq32, kern.float()):.4g}, its bf16 forward "
          f"{rel(fq16, kern.float()):.4g}")
    if qat_rel > QAT_REL:
        fail(f"QAT: its forward parts from the static-int8 oracle by {qat_rel:.4g} of "
             f"max|logit| (> {QAT_REL})")
    if mm_qat > QAT_MM_REL or mm_plain <= QAT_MM_REL:
        fail(f"QAT: a matmul of its forward parts from the oracle's int8 product by "
             f"{mm_qat:.4g} (> {QAT_MM_REL}), or an unquantized one by only {mm_plain:.4g}")
    timed("QAT (static-aware, fp32)", qat_step)
    del qat_params, q_state, live, flat, q_grads

    # (d) SmoothQuant on the trained model, served in static int8; the cast
    # to bf16 served by fused_vit_apply
    with torch.no_grad():
        sm = quant.smooth_vit(model, trained, n=8)
        ref = apply(trained, img)
        out = apply(sm, img)
    sm_rel = float((out - ref).abs().max() / ref.abs().max())
    print(f"  smooth_vit (n = 8): the smoothed fp32 forward against the unsmoothed one, max "
          f"|err| / max|logit| {sm_rel:.3g} (bound {SMOOTH_REL})")
    if sm_rel > SMOOTH_REL:
        fail(f"smooth_vit changed the function: {sm_rel:.3g} of max|logit|")
    load_params(serve, sm)
    with torch.no_grad():
        act = quant.calibrate_vit(serve, batches=calib())
    sq = prepare_vit_int8_static(serve, act_scales=act)
    img1 = torch.randn(1, *shape, generator=torch.Generator().manual_seed(2200)).to(DEVICE)
    for x in (img1, img):
        k = served(f"smoothed deit_tiny int8 static b{x.shape[0]}",
                   lambda plain, x=x: fused_vit_apply_int8(serve, x, stacked_q=sq, plain=plain),
                   x.shape[0], int8_want)
    # what smoothing does to static int8 here: the kernels' logits against the
    # fp32 model, smoothed and not
    load_params(serve, trained)
    with torch.no_grad():
        k0 = fused_vit_apply_int8(serve, img, stacked_q=prepare_vit_int8_static(
            serve, act_scales=quant.calibrate_vit(serve, batches=calib())))
    print(f"  static int8 against the fp32 model at b{TRAIN_BATCH}, max |err| / max|logit|: "
          f"smoothed {float((k.float() - ref).abs().max() / ref.abs().max()):.4g}, unsmoothed "
          f"{float((k0.float() - ref).abs().max() / ref.abs().max()):.4g}")
    del serve, sq, sm
    bfm = ViT(cfg.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16), device=DEVICE)
    load_params(bfm, quant.cast_params(trained, torch.bfloat16))
    stacked = prepare_vit_fused(bfm)
    bf16_want = want_launches(BF16_LAUNCHES, cfg.depth)
    served(f"cast_params(bf16) deit_tiny b{TRAIN_BATCH}", lambda plain: fused_vit_apply(
        bfm, img, stacked=stacked, plain=plain), TRAIN_BATCH, bf16_want)

    # (f) the eval step over fused_vit_apply counts what its logits' argmax gives
    seen = []

    def eval_apply(_, x):
        seen.append(fused_vit_apply(bfm, x, stacked=stacked))
        return seen[-1]

    counter.reset()
    n_correct, n_total = make_eval_step(eval_apply)(None, img, labels)
    torch.cuda.synchronize()
    counts = counter.read()
    if counts != bf16_want:
        fail(f"eval: launch counts {counts}, expected {bf16_want}")
    want_correct = int((seen[-1].argmax(-1) == labels).sum())
    print(f"  make_eval_step over fused_vit_apply b{TRAIN_BATCH}: {int(n_correct)} of {n_total} "
          f"(the argmax of its logits: {want_correct}), launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if int(n_correct) != want_correct or n_total != TRAIN_BATCH:
        fail(f"eval: counted {int(n_correct)} of {n_total}, the logits give {want_correct}")
    del bfm, stacked, seen, model, params, state, trained

    # (e) T2T: smooth_t2t, then static int8 on the kernels at b1 (K8, K16)
    tmodel, tshape = build_model("t2t_vit_14", style="reference", dtype=torch.bfloat16,
                                 device=DEVICE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        load_params(tmodel, quant.smooth_t2t(tmodel, n=8))
        act = quant.calibrate_t2t(tmodel, batches=quant.representative_batches(n=8,
                                                                               shape=tshape))
        tsq = t2t.prepare_t2t_int8_static(tmodel, act_scales=act)
        prepared = t2t.prepare_t2t_fused(tmodel)
    timg = torch.randn(1, *tshape, generator=torch.Generator().manual_seed(2300)).to(DEVICE)
    served("smoothed t2t_vit_14 int8 static b1", lambda plain: t2t.fused_t2t_apply_int8(
        tmodel, timg, stacked_q=tsq, prepared=prepared, plain=plain), 1,
        want_launches(INT8_LAUNCHES, tmodel.config.depth, stage1=1, performers=2))
    del tmodel, tsq, prepared
    torch.cuda.synchronize()
    print(f"  phase 7: {time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{harness.device_peak_mb():.1f} MiB, on {card}")
    return worst


# Phase 8: head and movement pruning on the card (deit_tiny standard, full
# width and depth, fp32 with TF32 off, seeded random weights, synthetic
# images and labels), the pruned models served on the kernels.
PRUNE_BATCH = 32
IMPORTANCE_BATCHES = 4
# The layer-normalized head importance, card against CPU: the same fp32
# gradient summed in other orders through 12 layers, forward and backward
IMPORTANCE_ATOL = 1e-4
PRUNE_NUMBERS = (9, 18)
SPARSE_PRESET = "topk-hybrid-struct-layerwise-tiny"
# 2 of 3 heads (ceil(0.34 * 3)) in the first six layers, 1 in the last six
SPARSE_LAYERWISE = "-".join(["h_0.34_d_0.3"] * 6 + ["h_0.3_d_0.5"] * 6)
SPARSE_STEPS = 12
# graph replays of 10 calls each behind a served model's device p50: at 5 the
# spread of one b32 figure reached 13% in one run
PRUNE_TIME_REPEATS = 15
SPARSE_WARMUP = 2
TRANSITION_STEPS = 4
# Adam divides each gradient by its own size, g / (|g| + 1e-8): where a
# gradient is near zero (the key bias, exactly zero in exact arithmetic: the
# softmax ignores a per-query constant) the card's and the CPU's rounding
# noise become steps of up to lr of either sign.  The two sparse steps are
# compared where the card's or the CPU's root-mean-square gradient over them
# is above this floor, as tests/test_torch_train.py compares AdamW with
# optax; the leaves whose elements it leaves out are printed
ADAM_GRAD_FLOOR = 1e-5


def _above_floor(states, name, steps):
    """The elements of leaf ``name`` whose root-mean-square gradient over
    ``steps`` Adam steps, from the second moment of any of the Adam states
    ``states`` (the card's and the CPU's), is above ``ADAM_GRAD_FLOOR``."""
    keep = None
    for st in states:
        rms = (st[name]["exp_avg_sq"].float().cpu() / (1 - 0.999 ** steps)).sqrt()
        keep = rms > ADAM_GRAD_FLOOR if keep is None else keep | (rms > ADAM_GRAD_FLOOR)
    return keep


def _floor_report(states, steps, top=4) -> str:
    """The share of elements ``_above_floor`` keeps, and the ``top`` leaves
    it leaves the most elements out of (left out / size)."""
    n = m = 0
    out = []
    for name in states[0]:
        keep = _above_floor(states, name, steps)
        n, m = n + int(keep.sum()), m + keep.numel()
        if not keep.all():
            out.append((int((~keep).sum()), keep.numel(), name))
    out.sort(reverse=True)
    leaves = ", ".join(f"{name} {k}/{size}" for k, size, name in out[:top])
    return f"{n / m:.2%} ({len(out)} leaves cut{': ' + leaves if leaves else ''})"


def phase_prune(torch, harness, counter, fa, fm, card):
    """Head pruning and movement pruning on the card, their models served on
    the kernels.  (a) ``calculate_head_importance`` over 4 batches of b32,
    card against CPU; ``iterative_head_prune`` to 9 and 18 heads (at least
    one a layer, structural, a 2-step SGD ``finetune`` as retrain,
    ``make_eval_step`` as eval, checkpoints and accuracy markers under
    ``build/``), each level's heads against the CPU's; each level served
    by ``fused_vit_apply`` (bf16) and static ``fused_vit_apply_int8`` at b1
    and b32.  (b) ``run_sparse_finetune`` on ``SPARSE_PRESET`` with
    ``SPARSE_LAYERWISE``, 12 steps at b32 with the dense model as teacher;
    its first two steps repeated on the CPU (params, scores, and the masks
    at the final thresholds); the compiled model served segmented, packed
    and in static int8 at b1 and b32.  (c) a 4-step run with the LayerNorm
    and GELU transitions, compiled to NoNorm / ReLU: the fused path refuses
    it and the ``kernel_mode="pallas"`` module serves it at b1 (``sdpa``).
    Each request's launch counts are checked and its logits held to the
    twins; prints the times and the phase's seconds and peak memory;
    returns the worst logit deviation."""
    import shutil

    import numpy as np

    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (ViT, apply_params,
                                                             fused_vit_apply,
                                                             fused_vit_apply_int8, load_params,
                                                             prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches
    from edgevisiontransformer_tpu_torch.parallel.train import make_eval_step
    from edgevisiontransformer_tpu_torch.pruning.head_importance import (
        calculate_head_importance, head_importance_batch)
    from edgevisiontransformer_tpu_torch.pruning.iterative import (IterativePruneConfig,
                                                                    iterative_head_prune)
    from edgevisiontransformer_tpu_torch.pruning.movement import (init_mask_scores,
                                                                   parse_layerwise_thresholds,
                                                                   quantile_linear,
                                                                   schedule_thresholds,
                                                                   topk_mask)
    from edgevisiontransformer_tpu_torch.pruning.policy import parse_head_pruning_descriptors
    from edgevisiontransformer_tpu_torch.pruning.sparse_driver import (run_sparse_finetune,
                                                                        sparse_config_from_preset,
                                                                        sparse_optimizers)
    from edgevisiontransformer_tpu_torch.pruning.sparse_train import make_sparse_train_step
    from edgevisiontransformer_tpu_torch.utils.checkpoint import load_meta
    from edgevisiontransformer_tpu_torch.utils.finetune import FinetuneConfig, finetune
    from edgevisiontransformer_tpu_torch.utils.imagenet import has_accuracy_marker
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import tree_map

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model, shape = build_model("deit_tiny", style="standard", device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    cfg = model.config
    classes = cfg.num_classes
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)  # noqa: E731
    to_cpu = lambda tree: tree_map(lambda t: t.detach().to("cpu", copy=True), tree)  # noqa: E731
    init = clone(model.params())
    data = torch.Generator().manual_seed(2400)
    imp_batches = [torch.randn(PRUNE_BATCH, *shape, generator=data)
                   for _ in range(IMPORTANCE_BATCHES)]
    train = [(torch.randn(PRUNE_BATCH, *shape, generator=data),
              torch.randint(0, classes, (PRUNE_BATCH,), generator=data)) for _ in range(2)]
    val_x = torch.randn(PRUNE_BATCH, *shape, generator=data)
    val_y = torch.randint(0, classes, (PRUNE_BATCH,), generator=data)
    img1 = torch.randn(1, *shape, generator=torch.Generator().manual_seed(2410)).to(DEVICE)
    img32 = torch.randn(PRUNE_BATCH, *shape,
                        generator=torch.Generator().manual_seed(2420)).to(DEVICE)
    calib = lambda: representative_batches(n=8, shape=shape)  # noqa: E731
    bf16_want = want_launches(BF16_LAUNCHES, cfg.depth)
    int8_want = want_launches(INT8_LAUNCHES, cfg.depth)
    worst = 0.0
    served_models = {}

    def served(tag, fn, batch, want):
        """One request on the kernels, its launch counts checked, against
        the twins."""
        nonlocal worst
        with torch.no_grad():
            counter.reset()
            logits = fn(False)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = fn(True)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, classes)
        worst = max(worst, rel)
        print(f"  {tag:44s} max|kern-twin| {err:.4g} (max|logit| {scale:.4g}), top-1 "
              f"agreement {agree:.3f}, launches { {k: v for k, v in counts.items() if v} }")

    def serve(tag, c, p, pack=False):
        """``(c, p)`` in bf16 through ``fused_vit_apply`` (segmented, and
        packed with ``pack``) and static ``fused_vit_apply_int8`` at b1 and
        b32; keeps the model and its stacks for the timing below."""
        m = ViT(c.replace(dtype=torch.bfloat16), device=DEVICE)
        load_params(m, p)
        with torch.no_grad():
            stacks = {"bf16": prepare_vit_fused(m)}
            if pack:
                stacks["packed"] = prepare_vit_fused(m, pack_layers=True)
            stacks["int8"] = prepare_vit_int8_static(m, calib_batches=calib())
        for img in (img1, img32):
            b = img.shape[0]
            served(f"{tag} bf16 segmented b{b}", lambda plain: fused_vit_apply(
                m, img, stacked=stacks["bf16"], plain=plain), b, bf16_want)
            if pack:
                served(f"{tag} bf16 packed b{b}", lambda plain: fused_vit_apply(
                    m, img, stacked=stacks["packed"], pack_layers=True, plain=plain), b, bf16_want)
            served(f"{tag} int8 static b{b}", lambda plain: fused_vit_apply_int8(
                m, img, stacked_q=stacks["int8"], plain=plain), b, int8_want)
        served_models[tag] = (m, stacks)

    # (a) head importance, card against CPU
    cpu_init = to_cpu(init)
    t0 = time.perf_counter()
    imp = calculate_head_importance(cfg, init, imp_batches)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_imp = calculate_head_importance(cfg, cpu_init, imp_batches)
    cpu_s = time.perf_counter() - t0
    imp_dev = float(np.abs(imp - cpu_imp).max())
    x0 = imp_batches[0].to(DEVICE)
    e = harness.measure_call_time(lambda: head_importance_batch(cfg, init, x0), (), iters=3,
                                repeats=5, warmup=1)
    print(f"  head importance, {IMPORTANCE_BATCHES} batches of b{PRUNE_BATCH}: card {card_s:.2f} "
          f"s, CPU {cpu_s:.2f} s; layer-normalized, max |card - CPU| {imp_dev:.3g} (bound "
          f"{IMPORTANCE_ATOL}); one batch's importance (forward and backward) eager p50 "
          f"{e['p50_ms']:.4f} ms (std {e['std_ms']:.4f}), on {card}")
    if not np.isfinite(imp).all() or imp_dev > IMPORTANCE_ATOL:
        fail(f"head importance: card and CPU part by {imp_dev:.3g} (> {IMPORTANCE_ATOL})")

    # (a) iterative head pruning, card and CPU
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_pruned"
    shutil.rmtree(out_dir, ignore_errors=True)

    def retrain(device):
        def fn(c, p):
            m = ViT(c, device=device)
            return finetune(lambda q, x: apply_params(m, q, x), p, lambda: iter(train),
                            FinetuneConfig(lr=TRAIN_LR, optimizer="sgd", max_steps=2),
                            log=lambda s: None)
        return fn

    def evaluate(c, p):
        m = ViT(c, device=DEVICE)
        n, total = make_eval_step(lambda q, x: apply_params(m, q, x))(p, val_x.to(DEVICE),
                                                                       val_y.to(DEVICE))
        return int(n) / total

    prune_kw = dict(prune_numbers=PRUNE_NUMBERS, at_least_x_heads_per_layer=1,
                    actually_prune=True, output_dir=str(out_dir), model_tag="deit_tiny")
    t0 = time.perf_counter()
    levels = list(iterative_head_prune(cfg, init, IterativePruneConfig(**prune_kw),
                                       importance_batches=lambda: iter(imp_batches),
                                       eval_fn=evaluate, retrain_fn=retrain(DEVICE), save=True))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_levels = list(iterative_head_prune(cfg, cpu_init, IterativePruneConfig(**prune_kw),
                                           importance_batches=lambda: iter(imp_batches),
                                           retrain_fn=retrain("cpu")))
    cpu_s = time.perf_counter() - t0
    print(f"  iterative_head_prune {PRUNE_NUMBERS}: card {card_s:.2f} s, CPU {cpu_s:.2f} s")
    diverged = False
    for lv, cl in zip(levels, cpu_levels):
        heads = parse_head_pruning_descriptors(lv.descriptor.split())
        cpu_heads = parse_head_pruning_descriptors(cl.descriptor.split())
        flat = lambda d: {(layer, h) for layer, hs in d.items() for h in hs}  # noqa: E731
        only_card, only_cpu = sorted(flat(heads) - flat(cpu_heads)), sorted(
            flat(cpu_heads) - flat(heads))
        pairs = [(a, b, abs(lv.importance[a] - lv.importance[b]))
                 for a, b in zip(only_card, only_cpu)]
        meta = load_meta(lv.save_dir)
        print(f"  level {lv.level}: {lv.n_pruned_total} heads pruned, heads per layer "
              f"{lv.cfg.heads_per_layer}, accuracy marker {has_accuracy_marker(lv.save_dir)} "
              f"(eval {lv.accuracy}), checkpoint meta {meta['descriptor'] == lv.descriptor}; "
              f"the CPU's heads {'the same' if not only_card else f'differ: {pairs}'}")
        if meta["descriptor"] != lv.descriptor or has_accuracy_marker(lv.save_dir) is None:
            fail(f"iterative_head_prune level {lv.level}: checkpoint or marker missing")
        if diverged:
            continue  # the CPU pruned from other heads at an earlier level
        if len(only_card) != len(only_cpu) or any(d > IMPORTANCE_ATOL for _, _, d in pairs):
            fail(f"iterative_head_prune level {lv.level}: card {lv.descriptor!r}, CPU "
                 f"{cl.descriptor!r}, not a near-tie (pairs {pairs})")
        diverged = bool(only_card)
    for lv in levels:
        serve(f"prune{lv.n_pruned_total}", lv.cfg, lv.params)
    del cpu_levels, cpu_init

    # (b) movement pruning: run_sparse_finetune's first two steps, each repeated on the
    # CPU from the card's state before it
    sparse = sparse_config_from_preset(SPARSE_PRESET, warmup_steps=SPARSE_WARMUP,
                                       layerwise_thresholds=SPARSE_LAYERWISE)
    teach = lambda tp, x: apply_params(model, tp, x)  # noqa: E731
    opt_p, opt_s = sparse_optimizers()
    scores0 = init_mask_scores(cfg, sparse, torch.Generator().manual_seed(0), device=DEVICE)
    step = make_sparse_train_step(teach, cfg, sparse, opt_p, opt_s, teach,
                                  with_teacher_params=True)
    cpu_model = ViT(cfg, device="cpu")
    cpu_apply = lambda tp, x: apply_params(cpu_model, tp, x)  # noqa: E731
    cpu_step = make_sparse_train_step(cpu_apply, cfg, sparse, opt_p, opt_s, cpu_apply,
                                      with_teacher_params=True)
    cpu_teacher = to_cpu(init)

    def on(device, state):
        """A copy of (params, scores, their optimizer states) on ``device``;
        Adam's step counts stay on the CPU, where torch.optim keeps them."""
        return [tree_map(lambda t: t.detach().clone() if t.dim() == 0
                          else t.detach().to(device, copy=True), tree) for tree in state]

    state = [clone(init), scores0, opt_p.init(init), opt_s.init(scores0)]
    cpu_s, rows = 0.0, []
    for i in range(2):
        thr, mul = schedule_thresholds(i, SPARSE_STEPS, cfg, sparse)
        x, y = train[i]
        *card_st, m = step(*on(DEVICE, state), x.to(DEVICE), y.to(DEVICE),
                        torch.tensor(thr, device=DEVICE), torch.tensor(mul, device=DEVICE), init)
        t0 = time.perf_counter()
        *cpu_st, cm = cpu_step(*on("cpu", state), x, y, torch.tensor(thr), torch.tensor(mul),
                            cpu_teacher)
        cpu_s += time.perf_counter() - t0
        opt_states = [(card_st[2], cpu_st[2]), (card_st[3], cpu_st[3])]
        dev_p, upd_p = _step_dev(torch, card_st[0], cpu_st[0], state[0],
                                 keep=lambda k, t: t[_above_floor(opt_states[0], k, i + 1)])
        dev_s, upd_s = _step_dev(torch, card_st[1], cpu_st[1], state[1],
                                 keep=lambda k, t: t[_above_floor(opt_states[1], k, i + 1)])
        rows.append(f"step {i}: loss {float(m['loss']):.6f} / {float(cm['loss']):.6f}, params "
                    f"{dev_p:.3g} (update {upd_p:.3g}), scores {dev_s:.3g} (update {upd_s:.3g}); "
                    f"params compared {_floor_report(opt_states[0], i + 1)}; scores compared "
                    f"{_floor_report(opt_states[1], i + 1)}")
        if not dev_p <= CPU_STEP_REL * upd_p or not dev_s <= CPU_STEP_REL * upd_s:
            fail(f"sparse step {i}: card and CPU part from the same state (params {dev_p:.3g} > "
                 f"{CPU_STEP_REL} x {upd_p:.3g}, or scores {dev_s:.3g} > {CPU_STEP_REL} x "
                 f"{upd_s:.3g})")
        state = card_st
    final, _ = schedule_thresholds(10**9, 10**9, cfg, sparse)
    flips = 0
    for i in range(cfg.depth):
        for name in ("q", "k", "v", "out", "fc1", "fc2"):
            thr = final[i][0 if name in ("q", "k", "v", "out") else 1]
            card_s_, cpu_s_ = card_st[1][f"block_{i}"][name].cpu(), cpu_st[1][f"block_{i}"][name]
            differ = topk_mask(card_s_, thr) != topk_mask(cpu_s_, thr)
            if differ.any():
                # a score and the cut (two scores interpolated) each part by
                # at most the step bound beyond a spacing: a mask may part
                # only where the score lies within twice that of the cut
                flat_ = cpu_s_.reshape(-1)
                cut = quantile_linear(flat_, torch.tensor(min(max(1.0 - thr, 0.0),
                                                              1.0 - 1.0 / flat_.numel())))
                far = float((cpu_s_[differ] - cut).abs().max())
                near = 2 * (CPU_STEP_REL * upd_s
                            + float(torch.nextafter(cut.abs(), cut.abs() + 1) - cut.abs()))
                if far > near:
                    fail(f"sparse steps: block {i} {name}'s mask parts card / CPU at a score "
                         f"{far:.3g} from its cut (bound {near:.3g})")
                flips += int(differ.sum())
    print(f"  sparse step (AdamW lr 5e-5, Adam on the scores lr 1e-2, teacher), "
          f"run_sparse_finetune's first two steps, each on the card and on the CPU "
          f"({cpu_s:.1f} s) from the card's state before it; max |card - CPU| beyond one "
          f"spacing where the card's or the CPU's RMS gradient is above {ADAM_GRAD_FLOOR} "
          f"(the share compared, and the leaves the floor cuts most, left out / size):")
    for row in rows:
        print(f"    {row}")
    print(f"    masks at the final thresholds: {flips} elements part, each within the bound of "
          f"its cut")
    p2, s2, sp2, ss2 = card_st
    del cpu_st, cpu_model, cpu_teacher, state

    # the sparse step's time, on a copy of the state (the step updates it)
    xs, ys = train[0][0].to(DEVICE), train[0][1].to(DEVICE)
    thr_t = torch.tensor(final, device=DEVICE)
    mul_t = torch.tensor(1.0, device=DEVICE)
    fn = lambda: step(p2, s2, sp2, ss2, xs, ys, thr_t, mul_t, init)  # noqa: E731
    e = harness.measure_call_time(fn, (), iters=3, repeats=5, warmup=1)
    prof = harness.device_time_by_kernel(fn)
    busy = sum(r[2] for r in prof)
    print(f"  sparse step with teacher b{PRUNE_BATCH} (fp32): eager p50 {e['p50_ms']:.4f} ms (std "
          f"{e['std_ms']:.4f}, {PRUNE_BATCH * 1e3 / e['p50_ms']:.1f} img/s), traced kernel time "
          f"{busy:.4f} ms (device idle {max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager step), "
          f"on {card}")
    for name, calls, ms in prof[:4]:
        print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")
    del p2, s2, sp2, ss2, step

    # (b) run_sparse_finetune end to end, then its compiled model served
    t0 = time.perf_counter()
    res = run_sparse_finetune(teach, cfg, clone(init), sparse, lambda: iter(train),
                              total_steps=SPARSE_STEPS, teacher_apply=teach, teacher_params=init,
                              log=lambda s: print(f"    {s}"))
    torch.cuda.synchronize()
    ccfg = res.compiled_cfg
    print(f"  run_sparse_finetune {SPARSE_PRESET}, {SPARSE_STEPS} steps b{PRUNE_BATCH}: "
          f"{time.perf_counter() - t0:.2f} s; compiled heads_per_layer {ccfg.heads_per_layer}, "
          f"mlp_dim_per_layer {ccfg.mlp_dim_per_layer}, zeros {res.sparsity['__overall__']:.4f}")
    heads = tuple(max(1, math.ceil(h * cfg.heads))
                  for h, _ in parse_layerwise_thresholds(SPARSE_LAYERWISE, cfg.depth))
    if ccfg.heads_per_layer != heads or not all(ccfg.mlp_dim_per_layer):
        fail(f"compile_sparse_model: heads {ccfg.heads_per_layer}, hidden "
             f"{ccfg.mlp_dim_per_layer}")
    serve("movement", ccfg, res.compiled_params, pack=True)
    del res

    # (c) the transitions, compiled to NoNorm / ReLU
    sparse_t = sparse_config_from_preset(
        SPARSE_PRESET, warmup_steps=SPARSE_WARMUP, layerwise_thresholds=SPARSE_LAYERWISE,
        layer_norm_patch=True, gelu_patch=True, layer_norm_patch_steps=TRANSITION_STEPS,
        gelu_patch_steps=TRANSITION_STEPS)
    res = run_sparse_finetune(None, cfg, clone(init), sparse_t, lambda: iter(train),
                              total_steps=TRANSITION_STEPS, log=lambda s: None)
    tcfg = res.compiled_cfg
    tm = ViT(tcfg.replace(dtype=torch.bfloat16), device=DEVICE)
    load_params(tm, res.compiled_params)
    try:
        fused_vit_apply(tm, img1)
        fail("fused_vit_apply took a NoNorm / ReLU model")
    except ValueError as err:
        refusal = str(err)
    module = ViT(tcfg.replace(dtype=torch.bfloat16, kernel_mode="pallas"), device=DEVICE)
    load_params(module, res.compiled_params)

    def module_run(plain):
        if not plain:
            return module(img1)
        with module_twins(fa, fm):
            return module(img1)

    print(f"  transitions ({TRANSITION_STEPS} steps): norm_mode {tcfg.norm_mode!r}, act "
          f"{tcfg.act!r}, heads {tcfg.heads_per_layer}; fused_vit_apply refuses it: "
          f"{refusal[:70]}...")
    served("transitions module pallas b1", module_run, 1,
           want_launches({"sdpa": 1}, tcfg.depth))
    del res, tm

    # device times: dense deit_tiny beside every served pruned model
    dense = ViT(cfg.replace(dtype=torch.bfloat16), device=DEVICE)
    load_params(dense, init)
    with torch.no_grad():
        served_models["dense"] = (dense, {"bf16": prepare_vit_fused(dense),
                                          "int8": prepare_vit_int8_static(
                                              dense, calib_batches=calib())})
    runs = {"bf16": lambda m, st, x: fused_vit_apply(m, x, stacked=st),
            "packed": lambda m, st, x: fused_vit_apply(m, x, stacked=st, pack_layers=True),
            "int8": lambda m, st, x: fused_vit_apply_int8(m, x, stacked_q=st)}
    with torch.no_grad():
        for tag in ["dense"] + [t for t in served_models if t != "dense"]:
            m, stacks = served_models[tag]
            for kind, st in stacks.items():
                times = []
                for img in (img1, img32):
                    d = harness.measure_graph_time(lambda: runs[kind](m, st, img), iters=10,
                                                   repeats=PRUNE_TIME_REPEATS)
                    times.append(f"b{img.shape[0]} {d['p50_ms']:.4f} ms (std {d['std_ms']:.4f})")
                print(f"  device p50 {tag} {kind}: {', '.join(times)}")
        d = harness.measure_graph_time(lambda: module(img1), iters=10,
                                       repeats=PRUNE_TIME_REPEATS)
        print(f"  device p50 transitions module pallas: b1 {d['p50_ms']:.4f} ms (std "
              f"{d['std_ms']:.4f})")
    del served_models, module, dense, model, init
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    print(f"  phase 8: {time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{harness.device_peak_mb():.1f} MiB, on {card}")
    return worst


# ---------------------------------------------------------------------------
# Phase 9: float16
# ---------------------------------------------------------------------------

# the fp16 cells timed beside bf16: (model, path, batch)
F16_BATCHES = (1, 32)
F16_TIMES = (("deit_tiny", "chain", 1), ("deit_tiny", "chain", 128),
             ("deit_tiny", "int8 static", 1), ("deit_tiny", "int8 static", 128),
             ("deit_tiny", "fully fused", 1), ("deit_tiny", "fully fused", 128),
             ("deit_tiny", "module", 128),
             ("t2t_vit_14", "chain", 1), ("t2t_vit_14", "chain", 32),
             ("swin_tiny", "chain", 1), ("swin_tiny", "chain", 32))


def phase_kernels_f16(torch, mods, harness):
    """Each kernel's fp16 instance against its fp16 twin, at the shape of
    its row in the kernels line (phase 3's rows: one deit_tiny b128 layer,
    one swin_tiny b1 forward, ...), with phase 3's bounds; ``quant_rows``
    and the non-GELU ``linear_i8`` epilogues bit for bit, and every output
    fp16.  Returns ({kernel: max_abs_err}, {kernel: (ms, plain_ms)}: device
    p50 of CUDA-graph replay summed over the row's launches)."""
    import numpy as np

    from edgevisiontransformer_tpu_torch.models.swin import shifted_window_mask
    from edgevisiontransformer_tpu_torch.models.t2t_vit import build_stage1_weights
    from edgevisiontransformer_tpu_torch.models.vit import ViT, deit_config, prepare_vit_full

    fe, sb, sm, ws, fa, fm, ts, vf, pf = (mods[k] for k in (
        "fe", "sb", "sm", "ws", "fa", "fm", "ts", "vf", "pf"))
    dev, f16 = DEVICE, torch.float16
    gen = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(f16)

    def f32(*shape, scale=1.0, base=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + base

    def uniform(*shape, lo=0.5, hi=1.5):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    errs, ms = {}, {}

    def check(kname, label, kern, plain, reps=1, exact=False, bound=None):
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        outs = got if isinstance(got, tuple) else (got,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        want = {"quant_rows": torch.int8, "performer_reduce": torch.float32}.get(kname, f16)
        if outs[0].dtype != want:
            fail(f"{label}: the fp16 instance returned {outs[0].dtype}, not {want}")
        if exact:
            for o, r in zip(outs, refs):
                if (o is None) != (r is None) or (o is not None and not torch.equal(o, r)):
                    fail(f"{label} (fp16): differs from the twin (must be bit for bit)")
            err = 0.0
        elif bound is None:
            err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
        else:  # a whole forward's logits, bounded as a whole
            err = float((got.float() - ref.float()).abs().max())
            ok = err <= bound
        if not exact and (not ok or not torch.isfinite(got.float()).all()):
            fail(f"{label} (fp16): max |kernel - twin| {err:.4g} over phase 3's bound")
        errs[kname] = max(errs.get(kname, 0.0), err)
        if reps:
            t_k = harness.measure_graph_time(kern)["p50_ms"]
            t_p = harness.measure_graph_time(plain)["p50_ms"]
            tk, tp = ms.get(kname, (0.0, 0.0))
            ms[kname] = (tk + reps * t_k, tp + reps * t_p)
            print(f"  fp16 {label:36s} device: kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                  f"(x{reps} in the row) | max|err| {err:.3g}")
        else:
            print(f"  fp16 {label:36s} max|err| {err:.3g}")

    # one deit_tiny b128 layer: ln_rows x2, the four GEMMs, attention_rows,
    # and its static int8 form (quant_rows x4, linear_i8 x4)
    m, dim, mlp, heads = SHAPES["deit_tiny b128"][:4]
    x = rnd(m, dim, scale=2.0)
    g, b = rnd(dim, scale=0.5) + 1, rnd(dim, scale=0.5)
    check("ln_rows", "ln_rows deit_tiny b128", lambda: fe.ln_rows(x, g, b, 1e-6),
          lambda: fe.ln_rows_plain(x, g, b, 1e-6), reps=2)
    for name, k, n, epi, approx in (("qkv", dim, 3 * dim, fe.CAST_THEN_BIAS, False),
                                    ("out", dim, dim, fe.BIAS_RESIDUAL, False),
                                    ("fc1 erf", dim, mlp, fe.CAST_THEN_BIAS_GELU, False),
                                    ("fc1 tanh", dim, mlp, fe.CAST_THEN_BIAS_GELU, True),
                                    ("fc2", mlp, dim, fe.BIAS_RESIDUAL, False)):
        a, w, bias = rnd(m, k), rnd(k, n, scale=k ** -0.5), rnd(n, scale=0.5)
        kw = dict(epilogue=epi, res=x if epi == fe.BIAS_RESIDUAL else None, approx_gelu=approx)
        check("linear", f"linear {name} deit_tiny b128",
              lambda: fe.linear(a, w, bias, **kw), lambda: fe.linear_plain(a, w, bias, **kw),
              reps=int(name != "fc1 tanh"))
    qkv = rnd(m, 3 * dim)
    akw = dict(heads=heads, head_dim=dim // heads, tokens=197)
    check("attention_rows", "attention_rows deit_tiny b128",
          lambda: fe.attention_rows(qkv, **akw), lambda: fe.attention_rows_plain(qkv, **akw))
    qkv_m = rnd(2 * 200, 3 * 2 * 64)  # padded and masked keys: seq_len 197 of 200
    pkw = dict(heads=2, head_dim=64, tokens=200, seq_len=197)
    check("attention_rows", "attention_rows padded 200/197 b2",
          lambda: fe.attention_rows(qkv_m, **pkw), lambda: fe.attention_rows_plain(qkv_m, **pkw),
          reps=0)
    act_inv = (127.0 / (4.0 * uniform(12, 4))).contiguous()
    for k, reps in ((dim, 3), (mlp, 1)):
        h = rnd(m, k, scale=2.0)
        h[1] = 0
        check("quant_rows", f"quant_rows static K={k}", lambda: fe.quant_rows(h, act_inv, 5),
              lambda: fe.quant_rows_plain(h, act_inv, 5), reps=reps, exact=True)
        check("quant_rows", f"quant_rows dynamic K={k}", lambda: fe.quant_rows(h),
              lambda: fe.quant_rows_plain(h), reps=0, exact=True)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    for name, k, n, epi, approx in (("qkv", dim, 3 * dim, fe.BIAS, False),
                                    ("out", dim, dim, fe.BIAS_RESIDUAL, False),
                                    ("fc1 erf", dim, mlp, fe.BIAS_GELU, False),
                                    ("fc1 tanh", dim, mlp, fe.BIAS_GELU, True),
                                    ("fc2", mlp, dim, fe.BIAS_RESIDUAL, False)):
        unit = 1.0 / (73.0 * 73.0 * k ** 0.5)
        q, w_q = int8(m, k), int8(k, n)
        for bias_dt in (torch.float32, f16):  # the encoder stacks' fp32, Swin's compute dtype
            bias = (torch.randn(n, generator=gen, device=dev) * 0.5).to(bias_dt)
            for mode in ("static", "dynamic"):
                s_row = uniform(m) * 0.05 if mode == "dynamic" else None
                w_s = uniform(n) * (unit / 0.05 if mode == "dynamic" else unit)
                args = (q, s_row, w_q, w_s, bias)
                kw = dict(epilogue=epi, out_dtype=f16,
                          res=x if epi == fe.BIAS_RESIDUAL else None, approx_gelu=approx)
                row = mode == "static" and bias_dt == torch.float32 and name != "fc1 tanh"
                check("linear_i8", f"linear_i8 {name} {mode} {str(bias_dt)[6:]} bias",
                      lambda: fe.linear_i8(*args, **kw), lambda: fe.linear_i8_plain(*args, **kw),
                      reps=int(row), exact=epi != fe.BIAS_GELU)

    # one t2t_vit_14 b1 stage-1 call
    rng = np.random.RandomState(3)
    w9 = build_stage1_weights(rng.randn(147, 192) * 147 ** -0.5, rng.randn(192) * 0.1,
                              1.0 + 0.1 * rng.randn(147), 0.1 * rng.randn(147))
    w9 = (w9[0].to(dev, f16), w9[1].to(dev), w9[2].to(dev), w9[3].to(dev))
    img = rnd(1, 3, 224, 224)
    check("stage1_kqv", "stage1_kqv t2t_vit_14 b1", lambda: ts.stage1_kqv(img, *w9),
          lambda: ts.stage1_kqv_plain(img, *w9))

    # one swin_tiny b1 forward's window_attention and swin_merge launches,
    # and one kernel_mode="pallas" module forward's window_sdpa launches
    w, n = SWIN_WINDOW, SWIN_WINDOW ** 2
    for si, (res, sdim, sheads, depth) in enumerate(SWIN_STAGES):
        nwin, hd = (res // w) ** 2, sdim // sheads
        if si < len(SWIN_STAGES) - 1:
            xs = rnd(res * res, sdim, scale=2.0)
            g4, b4 = f32(4 * sdim, scale=0.5, base=1.0), f32(4 * sdim, scale=0.5)
            check("swin_merge", f"swin_merge swin_tiny b1 s{si}",
                  lambda: sm.swin_merge(xs, g4, b4, res=res, eps=1e-5),
                  lambda: sm.swin_merge_plain(xs, g4, b4, res=res, eps=1e-5))
        qkv_s = rnd(res * res, 3 * sdim)
        bias = f32(sheads, n, n, scale=0.5 * LOG2E)
        qkv_w = rnd(nwin, n, 3 * sdim)
        bias16 = rnd(sheads, n, n, scale=0.5)
        odd = depth // 2 if nwin > 1 else 0
        for shifted, reps in ((False, depth - odd), (True, odd)):
            if reps == 0:
                continue
            mk = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).to(dev)
                  if shifted else None)
            wkw = dict(res=res, window=w, shift=w // 2 if shifted else 0, heads=sheads,
                       head_dim=hd)
            mk2 = mk * LOG2E if shifted else None
            tag = f"swin_tiny b1 s{si} {'shifted' if shifted else 'unshifted'}"
            check("window_attention", f"window_attention {tag}",
                  lambda: sb.window_attention(qkv_s, bias, mk2, **wkw),
                  lambda: sb.window_attention_plain(qkv_s, bias, mk2, **wkw), reps=reps)
            skw = dict(heads=sheads, head_dim=hd)
            check("window_sdpa", f"window_sdpa {tag}",
                  lambda: ws.window_sdpa(qkv_w, bias16, mk, **skw),
                  lambda: ws.window_sdpa_plain(qkv_w, bias16, mk, **skw), reps=reps)
    res, sheads, hd = WINDOW12_STAGE  # window 12, Swin-B at 384's first stage
    q12 = rnd(res * res, 3 * sheads * hd)
    bias12 = f32(sheads, 144, 144, scale=0.5 * LOG2E)
    mask12 = torch.from_numpy(shifted_window_mask(res, res, 12, 6)).to(dev) * LOG2E
    wkw = dict(res=res, window=12, shift=6, heads=sheads, head_dim=hd)
    check("window_attention", "window_attention w12 shifted",
          lambda: sb.window_attention(q12, bias12, mask12, **wkw),
          lambda: sb.window_attention_plain(q12, bias12, mask12, **wkw), reps=0)

    # the module path's sdpa and mlp, one deit_tiny b128 layer
    qkv5 = rnd(128, 197, 3 * dim)
    q, k, v = qkv5.view(128, 197, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
    check("sdpa", "sdpa deit_tiny b128", lambda: fa.sdpa(q, k, v), lambda: fa.sdpa_plain(q, k, v))
    qkv6 = rnd(8, 577, 3 * 12 * 64)  # deit_base at 384: the streamed form
    q6, k6, v6 = qkv6.view(8, 577, 3, 12, 64).permute(2, 0, 3, 1, 4)
    check("sdpa", "sdpa deit_base 384 b8", lambda: fa.sdpa(q6, k6, v6),
          lambda: fa.sdpa_plain(q6, k6, v6), reps=0)
    w1, b1 = rnd(dim, mlp, scale=dim ** -0.5), rnd(mlp)
    w2, b2 = rnd(mlp, dim, scale=mlp ** -0.5), rnd(dim)
    for approx in (False, True):
        check("mlp", f"mlp {'tanh' if approx else 'erf'} deit_tiny b128",
              lambda: fm.mlp(x, w1, b1, w2, b2, approx_gelu=approx),
              lambda: fm.mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx), reps=int(not approx))

    # vit_full: held at depth 2 (phase 3's bound on the logits), timed on one
    # deit_tiny b128 forward at full depth
    for batch, depth in ((8, 2), (128, 12)):
        cfg = deit_config("tiny", depth=depth, dtype=f16)
        model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(21))
        prep = prepare_vit_full(model)
        img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(22))
        img = img.to(dev)
        args = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                    reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx,
                    final_norm=cfg.final_norm)
        with torch.no_grad():
            ref = vf.vit_full_forward_plain(img, prep, **args)
        scale = float(ref.float().abs().max())
        bound = (KERNEL_ATOL + KERNEL_RTOL * scale) if depth == 2 else LOGIT_REL * scale
        with torch.no_grad():
            check("vit_full", f"vit_full deit_tiny d{depth} b{batch}",
                  lambda: vf.vit_full_forward(img, prep, **args),
                  lambda: vf.vit_full_forward_plain(img, prep, **args),
                  reps=int(batch == 128), bound=bound)
        del model, prep

    # K16 at one t2t_vit_14 b1 tokenizer (n = 3136 and 784), on fp16 operands
    p, wr = performer_params(torch, gen)
    ops = pf.performer_operands(p, wr, f16)
    for n_tok in (3136, 784):
        xk = (torch.randn(1, n_tok, 192, generator=gen, device=dev) * 0.5).to(f16)
        check("performer_reduce", f"performer_reduce t2t_vit_14 b1 n{n_tok}",
              lambda: pf.performer_reduce(xk, wr, operands=ops),
              lambda: pf.performer_reduce_plain(xk, wr))
        sums = pf.performer_reduce_plain(xk, wr)
        pkw = dict(eps_ln=1e-5, approx_gelu=True)
        check("performer_rows", f"performer_rows t2t_vit_14 b1 n{n_tok}",
              lambda: pf.performer_rows(xk, sums, p, wr, operands=ops, **pkw),
              lambda: pf.performer_rows_plain(xk, sums, p, wr, **pkw))
    missing = [k for k in KERNELS if k not in ms]
    if missing:
        fail(f"fp16: no row for {missing}")
    return errs, ms


def f16_paths(torch, dt, mods, with_twins=True):
    """The served paths of phase 9 at the dtype ``dt`` (bf16 or fp16), on the
    models of phase 4's seeds: ``{(model, path): (apply(img, plain), want
    launches at batch b (a function of b), image shape, classes)}``, and
    what they hold."""
    from edgevisiontransformer_tpu_torch.models import t2t_vit as t2t
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.swin import (fused_swin_apply,
                                                              prepare_swin_fused,
                                                              prepare_swin_int8_static)
    from edgevisiontransformer_tpu_torch.models.vit import (fully_fused_vit_apply,
                                                             fused_vit_apply,
                                                             fused_vit_apply_int8,
                                                             prepare_vit_full,
                                                             prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

    fa, fm, ws = mods["fa"], mods["fm"], mods["ws"]
    dev = DEVICE

    def seeded(name, **kw):
        return build_model(name, dtype=dt, device=dev, generator=torch.Generator().manual_seed(0),
                           **kw)

    paths = {}
    with torch.no_grad():
        deit, dshape = seeded("deit_tiny", style="standard")
        stacked = prepare_vit_fused(deit)
        sq = prepare_vit_int8_static(deit, calib_batches=representative_batches(n=8,
                                                                                shape=dshape))
        full = prepare_vit_full(deit)
        dmod, _ = seeded("deit_tiny", style="standard", kernel_mode="pallas")
        tt, tshape = seeded("t2t_vit_14", style="reference")
        tprep, tstack = t2t.prepare_t2t_fused(tt), prepare_vit_fused(tt)
        tsq = (t2t.prepare_t2t_int8_static(tt, calib_batches=representative_batches(
            n=8, shape=tshape)) if with_twins else None)
        sw, sshape = seeded("swin_tiny")
        sprep = prepare_swin_fused(sw)
        ssq = (prepare_swin_int8_static(sw, batches=representative_batches(n=8, shape=sshape))
               if with_twins else None)
        smod, _ = seeded("swin_tiny", kernel_mode="pallas")
    torch.cuda.synchronize()
    dcls, dd = deit.config.num_classes, deit.config.depth

    def module_apply(model, img, plain):
        if not plain:
            return model(img)
        with module_twins(fa, fm):
            return model(img)

    def swin_module_apply(img, plain):
        if not plain:
            return smod(img)
        kernel, ws.window_sdpa = ws.window_sdpa, ws.window_sdpa_plain
        try:
            return smod(img)
        finally:
            ws.window_sdpa = kernel

    tdepth = tt.config.depth
    paths[("deit_tiny", "chain")] = (
        lambda img, plain: fused_vit_apply(deit, img, stacked=stacked, plain=plain),
        lambda b: want_launches(BF16_LAUNCHES, dd), dshape, dcls)
    paths[("deit_tiny", "int8 static")] = (
        lambda img, plain: fused_vit_apply_int8(deit, img, stacked_q=sq, plain=plain),
        lambda b: want_launches(INT8_LAUNCHES, dd), dshape, dcls)
    paths[("deit_tiny", "fully fused")] = (
        lambda img, plain: fully_fused_vit_apply(deit, img, prepared=full, plain=plain),
        lambda b: {**{k: 0 for k in KERNELS}, "vit_full": 1}, dshape, dcls)
    paths[("deit_tiny", "module")] = (
        lambda img, plain: module_apply(dmod, img, plain),
        lambda b: want_launches(MODULE_LAUNCHES, dd), dshape, dcls)
    paths[("t2t_vit_14", "chain")] = (
        lambda img, plain: t2t.fused_t2t_apply(tt, img, prepared=tprep, stacked=tstack,
                                               plain=plain),
        lambda b: want_launches(BF16_LAUNCHES, tdepth, stage1=int(b < 8), performers=2),
        tshape, tt.config.num_classes)
    if with_twins:
        paths[("t2t_vit_14", "int8 static")] = (
            lambda img, plain: t2t.fused_t2t_apply_int8(tt, img, stacked_q=tsq, prepared=tprep,
                                                        plain=plain),
            lambda b: want_launches(INT8_LAUNCHES, tdepth, stage1=int(b < 8), performers=2),
            tshape, tt.config.num_classes)
    paths[("swin_tiny", "chain")] = (
        lambda img, plain: fused_swin_apply(sw, img, prepared=sprep, plain=plain),
        lambda b: want_swin_launches(sw.config), sshape, sw.config.num_classes)
    if with_twins:
        if tuple(ssq) != SWIN_INT8_STAGES:
            fail(f"swin_tiny fp16 int8: stages {list(ssq)} are int8, expected "
                 f"{list(SWIN_INT8_STAGES)}")
        paths[("swin_tiny", "int8 static")] = (
            lambda img, plain: fused_swin_apply(sw, img, prepared=sprep, int8_prepared=ssq,
                                                plain=plain),
            lambda b: want_swin_launches(sw.config, SWIN_INT8_STAGES), sshape,
            sw.config.num_classes)
        paths[("swin_tiny", "module")] = (
            swin_module_apply, lambda b: {**{k: 0 for k in KERNELS},
                                          "window_sdpa": sum(smod.config.depths)},
            sshape, smod.config.num_classes)
    return paths


def phase_slice_f16(torch, counter, mods):
    """The fp16 models on the card: deit_tiny (the chain, static int8,
    ``fully_fused_vit_apply`` and the ``kernel_mode="pallas"`` module),
    t2t_vit_14 (the chain and static int8) and swin_tiny (the chain, static
    int8 stages 1-3 and the module) at b1 and b32, each request's launch
    counts read from zero and held to the bf16 path's, its logits against
    the same forward on the twins (``LOGIT_REL``); returns (launches of the
    fp16 instances on these requests, worst deviation)."""
    paths = f16_paths(torch, torch.float16, mods)
    launches = {k: 0 for k in counter.read()}
    worst = 0.0
    for (name, path), (apply, want, shape, classes) in paths.items():
        for batch in F16_BATCHES:
            tag = f"fp16 {name} {path} b{batch}"
            img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(
                2100 + batch)).to(DEVICE)
            with torch.no_grad():
                counter.reset()
                logits = apply(img, False)
                torch.cuda.synchronize()
                counts = counter.read()
                ref = apply(img, True)
            if counts != want(batch):
                fail(f"{tag}: launch counts {counts}, expected {want(batch)}")
            if logits.dtype != torch.float16:
                fail(f"{tag}: logits in {logits.dtype}")
            for k, v in counts.items():
                launches[k] += v
            rel, err, scale, agree = check_logits(tag, logits, ref, batch, classes)
            worst = max(worst, rel)
            print(f"  {tag:36s} max|kern-twin| {err:.4g} (max|logit| {scale:.4g}, "
                  f"{rel:.4%}), top-1 agreement {agree:.3f}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
    del paths
    return launches, worst


def phase_time_f16(torch, harness, mods):
    """Device p50 (CUDA-graph replay) of the ``F16_TIMES`` cells in bf16 and
    in fp16, the two dtypes' models built from one seed and timed one after
    the other; prints fp16 / bf16."""
    both = {dt: f16_paths(torch, dt, mods, with_twins=False)
            for dt in (torch.bfloat16, torch.float16)}
    for name, path, batch in F16_TIMES:
        shape = both[torch.float16][(name, path)][2]
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(batch)).to(
            DEVICE)
        d = {}
        with torch.no_grad():
            for dt in (torch.bfloat16, torch.float16):
                apply = both[dt][(name, path)][0]
                d[dt] = harness.measure_graph_time(lambda: apply(img, False), iters=10,
                                                   repeats=5)
        b16, f16 = d[torch.bfloat16], d[torch.float16]
        print(f"  {name} {path} b{batch}: device p50 bf16 {b16['p50_ms']:.4f} ms (std "
              f"{b16['std_ms']:.4f}), fp16 {f16['p50_ms']:.4f} ms (std {f16['std_ms']:.4f}), "
              f"fp16 / bf16 {f16['p50_ms'] / b16['p50_ms']:.3f}")
    del both


# Phase 10: published checkpoints imported under their key names, evaluation
# on an image folder, the CNN zoo.  The GPU machine has no transformers and
# no network, so each state dict is built from a seed under the published
# names and shapes (tests/test_torch_hf_import.py holds these builders'
# names and shapes to transformers' own models and to the JAX importers).
# google/vit-base-patch16-224's shapes: transformers' ViTConfig defaults
# (layer_norm_eps 1e-12) with ImageNet's 1000 labels
HF_VIT_B16 = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                  intermediate_size=3072, image_size=224, patch_size=16, num_channels=3,
                  qkv_bias=True, layer_norm_eps=1e-12, num_labels=1000)
# google/vit-huge-patch14-224-in21k's shapes: hidden 1280, 32 layers, 16
# heads of 80, MLP 5120, patch 14 (257 tokens at 224^2), qkv bias, eps 1e-12,
# here with ImageNet's 1000 labels
HF_VIT_H14 = dict(hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
                  intermediate_size=5120, image_size=224, patch_size=14, num_channels=3,
                  qkv_bias=True, layer_norm_eps=1e-12, num_labels=1000)
# microsoft/swin-tiny-patch4-window7-224's shapes: SwinConfig's defaults
HF_SWIN_T = dict(image_size=224, patch_size=4, num_channels=3, embed_dim=96,
                 depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24], window_size=7, mlp_ratio=4.0,
                 qkv_bias=True, layer_norm_eps=1e-5, num_labels=1000)
# The official T2T-ViT-14 checkpoint (81.5_T2T_ViT_14.pth.tar)
T2T_VARIANT = 14
IMPORT_BATCHES = (1, 32)
# The image folder: 70 uncompressed 24-bit BMPs in 4 classes, sizes not
# square, (width, height) alternating; evaluate at b32 pads its last batch
# (6 images) to 32
EVAL_CLASS_SIZES = (21, 16, 19, 14)
EVAL_IMAGE_SIZES = ((300, 260), (256, 384))
EVAL_BATCH = 32
ONE_HOT_CLASS = 2
# The CNN zoo on the card against the same module's CPU forward: both fp32,
# TF32 off; cuDNN's and the CPU's convolutions sum in other orders.  The
# bound the CPU tests hold the port to JAX with; each model's b1 is also read
# with TF32 on and printed, the fault this bound is there to catch
CNN_REL = 1e-5
CNN_BATCHES = (1, 8)
CNN_TIME_BATCHES = (1, 32)


def hf_vit_state_dict(torch, c, gen) -> dict:
    """A ``ViTForImageClassification`` state dict for the transformers-style
    config ``c`` (any object with ViTConfig's fields), values from ``gen``:
    N(0, 0.02) weights and biases (transformers' ``initializer_range``),
    LayerNorm affines near (1, 0)."""
    d, mlp, p = c.hidden_size, c.intermediate_size, c.patch_size
    w = lambda *s: torch.randn(*s, generator=gen) * 0.02  # noqa: E731
    sd = {"vit.embeddings.cls_token": w(1, 1, d),
          "vit.embeddings.position_embeddings": w(1, (c.image_size // p) ** 2 + 1, d),
          "vit.embeddings.patch_embeddings.projection.weight": w(d, c.num_channels, p, p),
          "vit.embeddings.patch_embeddings.projection.bias": w(d)}

    def ln(name, n):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(n, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(n, generator=gen)

    for i in range(c.num_hidden_layers):
        lp = f"vit.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[f"{lp}attention.attention.{name}.weight"] = w(d, d)
            if c.qkv_bias:
                sd[f"{lp}attention.attention.{name}.bias"] = w(d)
        for name, shape in (("attention.output.dense", (d, d)), ("intermediate.dense", (mlp, d)),
                            ("output.dense", (d, mlp))):
            sd[f"{lp}{name}.weight"], sd[f"{lp}{name}.bias"] = w(*shape), w(shape[0])
        ln(f"{lp}layernorm_before", d)
        ln(f"{lp}layernorm_after", d)
    ln("vit.layernorm", d)
    sd["classifier.weight"], sd["classifier.bias"] = w(c.num_labels, d), w(c.num_labels)
    return sd


def hf_swin_state_dict(torch, c, gen) -> dict:
    """A ``SwinForImageClassification`` state dict for the transformers-style
    config ``c``, values as :func:`hf_vit_state_dict`'s; each block's
    ``relative_position_index`` buffer is transformers' (the importer
    reads the table only), both sized by ``c.window_size``."""
    w = lambda *s: torch.randn(*s, generator=gen) * 0.02  # noqa: E731
    p, dim, res = c.patch_size, c.embed_dim, c.image_size // c.patch_size
    sd = {"swin.embeddings.patch_embeddings.projection.weight": w(dim, c.num_channels, p, p),
          "swin.embeddings.patch_embeddings.projection.bias": w(dim)}

    def ln(name, n):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(n, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(n, generator=gen)

    ln("swin.embeddings.norm", dim)
    for si, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
        win = c.window_size  # the table's size, whatever window the stage runs
        coords = torch.stack(torch.meshgrid(torch.arange(win), torch.arange(win),
                                            indexing="ij")).flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (win - 1)
        index = rel[:, :, 0] * (2 * win - 1) + rel[:, :, 1]
        hidden = int(c.mlp_ratio * dim)
        for bi in range(depth):
            lp = f"swin.encoder.layers.{si}.blocks.{bi}."
            ln(f"{lp}layernorm_before", dim)
            sd[f"{lp}attention.self.relative_position_bias_table"] = w((2 * win - 1) ** 2, heads)
            sd[f"{lp}attention.self.relative_position_index"] = index.clone()
            for name in ("query", "key", "value"):
                sd[f"{lp}attention.self.{name}.weight"] = w(dim, dim)
                sd[f"{lp}attention.self.{name}.bias"] = w(dim)
            for name, shape in (("attention.output.dense", (dim, dim)),
                                ("intermediate.dense", (hidden, dim)),
                                ("output.dense", (dim, hidden))):
                sd[f"{lp}{name}.weight"], sd[f"{lp}{name}.bias"] = w(*shape), w(shape[0])
            ln(f"{lp}layernorm_after", dim)
        if si < len(c.depths) - 1:
            dp = f"swin.encoder.layers.{si}.downsample."
            sd[f"{dp}reduction.weight"] = w(2 * dim, 4 * dim)
            ln(f"{dp}norm", 4 * dim)
            dim, res = 2 * dim, res // 2
    ln("swin.layernorm", dim)
    sd["classifier.weight"], sd["classifier.bias"] = w(c.num_labels, dim), w(c.num_labels)
    return sd


def t2t_state_dict(torch, cfg, gen, token_size: int = 64) -> dict:
    """An official T2T-ViT state dict (yitu-opensource ``models/t2t_vit.py``
    and ``token_performer.py`` names) for the port's config ``cfg``: Linear
    weights and biases N(0, 0.02), each performer's frozen ``w`` orthogonal
    x sqrt(m), the sinusoid ``pos_embed``, no qkv bias (``qkv_bias=False``)."""
    from edgevisiontransformer_tpu_torch.models.t2t_vit import sinusoid_encoding

    w = lambda *s: torch.randn(*s, generator=gen) * 0.02  # noqa: E731
    sd = {}

    def lin(name, n_out, n_in, bias=True):
        sd[f"{name}.weight"] = w(n_out, n_in)
        if bias:
            sd[f"{name}.bias"] = w(n_out)

    def ln(name, n):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(n, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(n, generator=gen)

    m = token_size // 2  # kernel_ratio 0.5
    for tag, in_dim in (("attention1", 3 * 7 * 7), ("attention2", token_size * 3 * 3)):
        pre = f"tokens_to_token.{tag}"
        lin(f"{pre}.kqv", 3 * token_size, in_dim)
        lin(f"{pre}.proj", token_size, token_size)
        ln(f"{pre}.norm1", in_dim)
        ln(f"{pre}.norm2", token_size)
        lin(f"{pre}.mlp.0", token_size, token_size)
        lin(f"{pre}.mlp.2", token_size, token_size)
        rf = torch.empty(m, token_size)
        torch.nn.init.orthogonal_(rf, generator=gen)
        sd[f"{pre}.w"] = rf * math.sqrt(m)
    lin("tokens_to_token.project", cfg.dim, token_size * 3 * 3)
    n = (cfg.image_size // 16) ** 2 + 1
    sd["cls_token"] = w(1, 1, cfg.dim)
    sd["pos_embed"] = torch.from_numpy(sinusoid_encoding(n, cfg.dim))[None]
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        ln(f"{pre}.norm1", cfg.dim)
        lin(f"{pre}.attn.qkv", 3 * cfg.dim, cfg.dim, bias=cfg.qkv_bias)
        lin(f"{pre}.attn.proj", cfg.dim, cfg.dim)
        ln(f"{pre}.norm2", cfg.dim)
        lin(f"{pre}.mlp.fc1", cfg.mlp_dim, cfg.dim)
        lin(f"{pre}.mlp.fc2", cfg.dim, cfg.mlp_dim)
    ln("norm", cfg.dim)
    lin("head", cfg.num_classes, cfg.dim)
    return sd


def write_image_folder(root: Path, seed: int) -> list:
    """``EVAL_CLASS_SIZES`` images per class under ``root/class_<k>/``, smooth
    random colour fields plus noise from ``seed``; returns the labels in
    ``list_image_folder``'s order."""
    import numpy as np

    from edgevisiontransformer_tpu_torch.utils.imagenet import write_bmp

    rng = np.random.RandomState(seed)
    labels, i = [], 0
    for k, count in enumerate(EVAL_CLASS_SIZES):
        (root / f"class_{k}").mkdir(parents=True)
        for j in range(count):
            w, h = EVAL_IMAGE_SIZES[i % len(EVAL_IMAGE_SIZES)]
            yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
            base = np.stack([np.sin(rng.uniform(1, 9) * xx + rng.uniform(0, 6) * yy
                                    + rng.uniform(0, 6)) for _ in range(3)], axis=-1)
            img = np.clip(127.5 + 100 * base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)
            write_bmp(root / f"class_{k}" / f"img_{j:03d}.bmp", img)
            labels.append(k)
            i += 1
    return labels


def phase_imports(torch, counter, harness, base_b1_ms):
    """ViT-B/16 (transformers' layout) through ``vit_config_from_hf`` /
    ``import_hf_vit`` / ``load_jax_params``, served bf16 at b1 and b32 and
    static int8 (8 representative batches) at b1; Swin-T through
    ``import_hf_swin`` at b1 and b32; T2T-ViT-14 from an official-layout
    ``.pth.tar`` (``{"state_dict_ema": ...}``) through ``load_t2t_checkpoint``
    at b1 and b32 (the official config: exact GELU, no qkv bias, eps 1e-5).
    Returns (launches, worst deviation, the ViT-B/16 state for evaluation)."""
    import tempfile
    from types import SimpleNamespace

    from edgevisiontransformer_tpu_torch.models.swin import (SwinTransformer, fused_swin_apply,
                                                              prepare_swin_fused)
    from edgevisiontransformer_tpu_torch.models.t2t_vit import (T2TViT, fused_t2t_apply,
                                                                 prepare_t2t_fused)
    from edgevisiontransformer_tpu_torch.models.vit import (ViT, fused_vit_apply,
                                                             fused_vit_apply_int8,
                                                             prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches
    from edgevisiontransformer_tpu_torch.utils import hf_import as hi
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import (load_jax_params,
                                                                  load_jax_variables)

    bf16 = torch.bfloat16
    launches = {k: 0 for k in counter.read()}
    worst = 0.0

    def request(tag, apply, batch, seed, want, classes):
        nonlocal worst
        img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(seed))
        img = img.to(DEVICE)
        with torch.no_grad():
            counter.reset()
            logits = apply(img, False)
            torch.cuda.synchronize()
            counts = counter.read()
            ref = apply(img, True)
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        rel, err, scale, agree = check_logits(tag, logits, ref, batch, classes)
        worst = max(worst, rel)
        print(f"  {tag:34s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} (max|logit| "
              f"{scale:.4g}), top-1 agreement {agree:.3f}, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        return img

    t0 = time.perf_counter()
    hf = SimpleNamespace(**HF_VIT_B16)
    cfg = hi.vit_config_from_hf(hf)
    if (cfg.layernorm_eps, cfg.num_classes, cfg.dim, cfg.qkv_bias) != (1e-12, 1000, 768, True):
        fail(f"vit_config_from_hf: {cfg}")
    tree = hi.import_hf_vit(hf_vit_state_dict(torch, hf, torch.Generator().manual_seed(10)), cfg)
    vit = load_jax_params(ViT(cfg.replace(dtype=bf16), device=DEVICE), tree["params"])
    with torch.no_grad():
        stacked = prepare_vit_fused(vit)
        sq = prepare_vit_int8_static(vit, calib_batches=representative_batches(
            n=8, shape=(3, 224, 224)))
    torch.cuda.synchronize()
    print(f"  ViT-B/16 (transformers' names, eps {cfg.layernorm_eps:g}): imported, bf16 stack "
          f"and static int8 stack prepared in {time.perf_counter() - t0:.2f} s")
    vit_apply = lambda img, plain: fused_vit_apply(vit, img, stacked=stacked, plain=plain)  # noqa
    for batch, seed in zip(IMPORT_BATCHES, (3000, 3010)):
        img = request(f"ViT-B/16 bf16 b{batch}", vit_apply, batch, seed,
                      want_launches(BF16_LAUNCHES, cfg.depth), cfg.num_classes)
        if batch == 1:
            img1 = img
    request("ViT-B/16 int8 static b1", lambda img, plain: fused_vit_apply_int8(
        vit, img, stacked_q=sq, plain=plain), 1, 3020, want_launches(INT8_LAUNCHES, cfg.depth),
        cfg.num_classes)
    with torch.no_grad():
        d = harness.measure_graph_time(lambda: vit_apply(img1, False), iters=10, repeats=5)
    print(f"  ViT-B/16 bf16 b1 device p50 {d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}); phase 5's "
          f"deit_base b1, the same shapes: {base_b1_ms:.4f} ms; ratio "
          f"{d['p50_ms'] / base_b1_ms:.3f}")

    t0 = time.perf_counter()
    hf = SimpleNamespace(**HF_SWIN_T)
    scfg = hi.swin_config_from_hf(hf).replace(dtype=bf16)
    tree = hi.import_hf_swin(hf_swin_state_dict(torch, hf, torch.Generator().manual_seed(11)),
                             scfg)
    swin = load_jax_params(SwinTransformer(scfg, device=DEVICE), tree["params"])
    prepared = prepare_swin_fused(swin)
    torch.cuda.synchronize()
    print(f"  Swin-T (transformers' names): imported and prepared in "
          f"{time.perf_counter() - t0:.2f} s")
    for batch, seed in zip(IMPORT_BATCHES, (3100, 3110)):
        request(f"Swin-T bf16 b{batch}", lambda img, plain: fused_swin_apply(
            swin, img, prepared=prepared, plain=plain), batch, seed, want_swin_launches(scfg),
            scfg.num_classes)
    del swin, prepared

    t0 = time.perf_counter()
    tcfg = hi.t2t_config_from_variant(T2T_VARIANT)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "81.5_T2T_ViT_14.pth.tar"
        torch.save({"state_dict_ema": t2t_state_dict(torch, tcfg, torch.Generator().manual_seed(
            12))}, path)
        tcfg, variables = hi.load_t2t_checkpoint(str(path), T2T_VARIANT)
    if (tcfg.gelu_approx, tcfg.qkv_bias, tcfg.layernorm_eps, tcfg.reference_residual) != (
            False, False, 1e-5, False):
        fail(f"t2t_config_from_variant: {tcfg}")
    t2t = load_jax_variables(T2TViT(tcfg.replace(dtype=bf16), device=DEVICE), variables)
    with torch.no_grad():
        t_prepared, t_stacked = prepare_t2t_fused(t2t), prepare_vit_fused(t2t)
    torch.cuda.synchronize()
    print(f"  T2T-ViT-14 (the official .pth.tar layout; exact GELU, no qkv bias, eps "
          f"{tcfg.layernorm_eps:g}): loaded and prepared in {time.perf_counter() - t0:.2f} s")
    for batch, seed in zip(IMPORT_BATCHES, (3200, 3210)):
        request(f"T2T-ViT-14 official bf16 b{batch}", lambda img, plain: fused_t2t_apply(
            t2t, img, prepared=t_prepared, stacked=t_stacked, plain=plain), batch, seed,
            want_launches(BF16_LAUNCHES, tcfg.depth, stage1=int(batch < 8), performers=2),
            tcfg.num_classes)
    return launches, worst, (vit, stacked)


def phase_vit_huge(torch, counter, harness, base_b1_ms, fa, fm):
    """ViT-H/14 (``HF_VIT_H14``: transformers' names, weights N(0, 0.02) from
    a seed) through ``vit_config_from_hf`` / ``import_hf_vit`` /
    ``load_jax_params`` at full width and depth 32, 224^2: bf16 b1 and b8
    through ``fused_vit_apply``, ``fully_fused_vit_apply`` and the
    ``kernel_mode="pallas"`` module, static int8 (8 representative batches)
    b1 through ``fused_vit_apply_int8``; logits against the twins, exact
    launch counts; each path's b1 device p50 beside deit_base's, the peak
    device memory and the seconds.  Returns (launches, worst deviation)."""
    from types import SimpleNamespace

    from edgevisiontransformer_tpu_torch.models.vit import (ViT, fully_fused_vit_apply,
                                                             fused_vit_apply,
                                                             fused_vit_apply_int8,
                                                             prepare_vit_full, prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches
    from edgevisiontransformer_tpu_torch.utils import hf_import as hi
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hf = SimpleNamespace(**HF_VIT_H14)
    cfg = hi.vit_config_from_hf(hf)
    if (cfg.dim, cfg.depth, cfg.resolved_head_dim, cfg.mlp_dim, cfg.patch_size) != (
            hf.hidden_size, hf.num_hidden_layers, hf.hidden_size // hf.num_attention_heads,
            hf.intermediate_size, hf.patch_size):
        fail(f"vit_config_from_hf at ViT-H/14: {cfg}")
    params = hi.import_hf_vit(hf_vit_state_dict(torch, hf, torch.Generator().manual_seed(13)),
                              cfg)["params"]
    t_import = time.perf_counter() - t0
    vit = load_jax_params(ViT(cfg.replace(dtype=bf16), device=DEVICE), params)
    module = load_jax_params(ViT(cfg.replace(dtype=bf16, kernel_mode="pallas"), device=DEVICE),
                             params)
    del params
    with torch.no_grad():
        stacked, prep = prepare_vit_fused(vit), prepare_vit_full(vit)
        sq = prepare_vit_int8_static(vit, calib_batches=representative_batches(
            n=8, shape=(3, 224, 224)))
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0 - t_import
    print(f"  ViT-H/14 (transformers' names, {sum(p.numel() for p in vit.parameters()) / 1e6:.1f}"
          f"M parameters, head_dim {cfg.resolved_head_dim}, {(224 // 14) ** 2 + 1} tokens): state "
          f"dict built and imported in {t_import:.2f} s; on the card with its bf16, whole-model "
          f"and static int8 stacks in {t_prep:.2f} s")
    paths = {
        "fused_vit_apply": (lambda img, plain: fused_vit_apply(vit, img, stacked=stacked,
                                                               plain=plain),
                            want_launches(BF16_LAUNCHES, cfg.depth)),
        "fully_fused_vit_apply": (lambda img, plain: fully_fused_vit_apply(
            vit, img, prepared=prep, plain=plain), {**{k: 0 for k in KERNELS}, "vit_full": 1}),
        "module pallas": (None, want_launches(MODULE_LAUNCHES, cfg.depth)),
        "int8 static": (lambda img, plain: fused_vit_apply_int8(vit, img, stacked_q=sq,
                                                                plain=plain),
                        want_launches(INT8_LAUNCHES, cfg.depth))}
    launches = {k: 0 for k in counter.read()}
    worst, images = 0.0, {}
    for label, (apply, want) in paths.items():
        for batch in ((1,) if label == "int8 static" else (1, 8)):
            tag = f"ViT-H/14 {label} b{batch}"
            img = torch.randn(batch, 3, 224, 224,
                              generator=torch.Generator().manual_seed(3300 + batch)).to(DEVICE)
            images[batch] = img
            with torch.no_grad():
                counter.reset()
                logits = module(img) if apply is None else apply(img, False)
                torch.cuda.synchronize()
                counts = counter.read()
                if apply is None:
                    with module_twins(fa, fm):
                        ref = module(img)
                else:
                    ref = apply(img, True)
            if counts != want:
                fail(f"{tag}: launch counts {counts}, expected {want}")
            for k, v in counts.items():
                launches[k] += v
            rel, err, scale, agree = check_logits(tag, logits, ref, batch, cfg.num_classes)
            worst = max(worst, rel)
            print(f"  {tag:36s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} (max|logit| "
                  f"{scale:.4g}), top-1 agreement {agree:.3f}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
    img1 = images[1]
    with torch.no_grad():
        for label, (apply, _) in paths.items():
            fn = (lambda: module(img1)) if apply is None else (lambda a=apply: a(img1, False))
            d = harness.measure_graph_time(fn, iters=5, repeats=5)
            print(f"  ViT-H/14 {label} b1 device p50 {d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}); "
                  f"phase 5's deit_base fused_vit_apply b1 {base_b1_ms:.4f} ms; ratio "
                  f"{d['p50_ms'] / base_b1_ms:.3f}")
        # the module at b8 too: its mlp (csrc/mlp_wide.cu) at 2056 rows
        d = harness.measure_graph_time(lambda: module(images[8]), iters=5, repeats=5)
        print(f"  ViT-H/14 module pallas b8 device p50 {d['p50_ms']:.4f} ms (std "
              f"{d['std_ms']:.4f})")
    torch.cuda.synchronize()
    print(f"  ViT-H/14: {time.perf_counter() - t0:.1f} s, peak device memory "
          f"{harness.device_peak_mb():.1f} MiB (two models' fp32 parameters, the bf16, "
          f"whole-model and int8 stacks)")
    del vit, module, stacked, prep, sq
    torch.cuda.empty_cache()
    return launches, worst


def phase_eval(torch, harness, state):
    """``utils/imagenet.evaluate`` over an image folder of BMPs (the native
    preprocessing built from ``native/preprocess.cpp``, ``native=True``, b32
    with a padded tail) with the imported ViT-B/16 on the kernels and on the
    twins (each image's logits within ``LOGIT_REL``, top-1 equal up to
    near-ties), and with a zero head whose bias is one-hot on
    ``ONE_HOT_CLASS``; images/s of ``evaluate`` and of the forward alone."""
    import tempfile

    import numpy as np

    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply
    from edgevisiontransformer_tpu_torch.utils import native_preprocess as npre
    from edgevisiontransformer_tpu_torch.utils.imagenet import (evaluate, iterate_batches,
                                                                 list_image_folder)

    vit, stacked = state
    kernels = lambda x: fused_vit_apply(vit, x, stacked=stacked)  # noqa: E731
    twins = lambda x: fused_vit_apply(vit, x, stacked=stacked, plain=True)  # noqa: E731
    t0 = time.perf_counter()
    if not npre.available():
        fail(f"native preprocessing did not build from {npre.SOURCE}")
    print(f"  native preprocessing built from the repo's source in "
          f"{time.perf_counter() - t0:.2f} s: {npre.library_path()}")
    n = sum(EVAL_CLASS_SIZES)
    with tempfile.TemporaryDirectory() as tmp:
        labels = write_image_folder(Path(tmp), seed=4000)
        samples, classes = list_image_folder(tmp)
        if [lab for _, lab in samples] != labels or len(classes) != len(EVAL_CLASS_SIZES):
            fail(f"list_image_folder: {len(samples)} images in {classes}")
        kw = dict(batch_size=EVAL_BATCH, native=True, device=DEVICE)
        t0 = time.perf_counter()
        acc_k = evaluate(kernels, tmp, **kw)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        acc_t = evaluate(twins, tmp, **kw)
        # per image: the same batches, padded as evaluate pads them
        got, ref = [], []
        with torch.no_grad():
            for x, _ in iterate_batches(samples, EVAL_BATCH, native=True):
                m = x.shape[0]
                x = np.concatenate([x, np.zeros((EVAL_BATCH - m,) + x.shape[1:], x.dtype)])
                xd = torch.from_numpy(x).to(DEVICE)
                got.append(kernels(xd)[:m].float().cpu())
                ref.append(twins(xd)[:m].float().cpu())
        got, ref = torch.cat(got), torch.cat(ref)
        y = torch.tensor(labels)
        for tag, acc, logits in (("kernels", acc_k, got), ("twins", acc_t, ref)):
            if acc != float((logits.argmax(-1) == y).sum()) / n:
                fail(f"evaluate ({tag}) top-1 {acc} is not that of its per-image predictions")
        # each image's logits within the logit bound of its twins'
        rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
        if not bool(torch.isfinite(got).all()) or bool((rel > LOGIT_REL).any()):
            fail(f"evaluate: kernels' logits part from the twins' by more than {LOGIT_REL} x "
                 f"max|logit| on images {(rel > LOGIT_REL).nonzero().flatten().tolist()} "
                 f"(worst {float(rel.max()):.4g}), or are not finite")
        top2 = ref.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        near = gap <= LOGIT_REL * float(ref.abs().max())
        parted = got.argmax(-1) != ref.argmax(-1)
        if bool((parted & ~near).any()):
            fail(f"evaluate: kernels' and twins' top-1 part on images whose twin top-2 gap is "
                 f"above the logit bound: {parted.nonzero().flatten().tolist()}")
        head = {k: v.detach().clone() for k, v in vit.head.named_parameters()}
        with torch.no_grad():
            vit.head.kernel.zero_()
            vit.head.bias.zero_()
            vit.head.bias[ONE_HOT_CLASS] = 1.0
        try:
            acc_1 = evaluate(kernels, tmp, **kw)
        finally:
            with torch.no_grad():
                for k, v in vit.head.named_parameters():
                    v.copy_(head[k])
        want = EVAL_CLASS_SIZES[ONE_HOT_CLASS] / n
        if acc_1 != want:
            fail(f"evaluate with a one-hot head: top-1 {acc_1}, expected {want}")
        x32 = torch.randn(EVAL_BATCH, 3, 224, 224,
                          generator=torch.Generator().manual_seed(4100)).to(DEVICE)
        with torch.no_grad():
            e = harness.measure_call_time(kernels, (x32,), iters=5, repeats=5)
    print(f"  evaluate over {n} BMPs ({len(classes)} classes, b{EVAL_BATCH}, native, padded "
          f"tail): top-1 kernels {acc_k:.4f}, twins {acc_t:.4f} (random weights); "
          f"{int(parted.sum())} image(s) part, {int(near.sum())} near-tie image(s) (twin top-2 "
          f"within {LOGIT_REL} x max|logit|); per image max|kernels - twins| <= "
          f"{float(rel.max()):.4g} x its max|logit|; one-hot head on class {ONE_HOT_CLASS}: "
          f"{acc_1:.4f} = {EVAL_CLASS_SIZES[ONE_HOT_CLASS]}/{n}")
    print(f"  evaluate (kernels): {eval_s:.3f} s, {n / eval_s:.1f} img/s with host decode and "
          f"preprocessing; the forward alone at b{EVAL_BATCH}: eager p50 {e['p50_ms']:.4f} ms, "
          f"{EVAL_BATCH * 1e3 / e['p50_ms']:.1f} img/s")


def phase_cnn(torch, harness):
    """Every CNN of the zoo from the registry at 224: fp32 on the card (TF32
    off) against the same module's CPU forward at ``CNN_BATCHES``, b1 with
    TF32 on (printed), a bf16 cast (finite), and eager p50 at
    ``CNN_TIME_BATCHES``."""
    import copy

    from edgevisiontransformer_tpu_torch.models.cnn.zoo import CNN_ZOO
    from edgevisiontransformer_tpu_torch.models.registry import build_model

    worst = 0.0
    for name in sorted(CNN_ZOO):
        cpu, shape = build_model(name, device="cpu", generator=torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to(DEVICE)
        errs = []
        for batch in CNN_BATCHES:
            img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(batch))
            with torch.no_grad():
                ref = cpu(img)
                got = card(img.to(DEVICE)).cpu()
            if (tuple(got.shape) != (batch, 1000) or not torch.isfinite(got).all()
                    or not float(ref.abs().max()) > 0):
                fail(f"{name} b{batch}: logits {tuple(got.shape)}, finite "
                     f"{bool(torch.isfinite(got).all())}, CPU max|logit| "
                     f"{float(ref.abs().max()):.3g}")
            rel = float((got - ref).abs().max() / ref.abs().max())
            if rel > CNN_REL:
                fail(f"{name} b{batch}: card vs CPU {rel:.3g} of max|logit| > {CNN_REL}")
            errs.append(rel)
        worst = max(worst, *errs)
        img = torch.randn(CNN_BATCHES[0], *shape,
                          generator=torch.Generator().manual_seed(CNN_BATCHES[0]))
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.no_grad():
                ref = cpu(img)
                rel_tf32 = float((card(img.to(DEVICE)).cpu() - ref).abs().max() / ref.abs().max())
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        half = copy.deepcopy(card).to(torch.bfloat16)
        with torch.no_grad():
            y16 = half(img.to(DEVICE))
        if not torch.isfinite(y16.float()).all():
            fail(f"{name} bf16: non-finite logits")
        times = []
        with torch.no_grad():
            for batch in CNN_TIME_BATCHES:
                x = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(7))
                x = x.to(DEVICE)
                times.append(harness.measure_call_time(card, (x,), iters=10, repeats=5)["p50_ms"])
        print(f"  {name:20s} params {sum(p.numel() for p in cpu.parameters()) / 1e6:6.2f} M, card "
              f"vs CPU (fp32) b{CNN_BATCHES[0]} {errs[0]:.3g}, b{CNN_BATCHES[1]} {errs[1]:.3g} of "
              f"max|logit| ({float(ref.abs().max()):.3g}), b{CNN_BATCHES[0]} with TF32 on "
              f"{rel_tf32:.3g}; bf16 finite; eager p50 " + ", ".join(
                  f"b{b} {t:.4f} ms" for b, t in zip(CNN_TIME_BATCHES, times)))
        del cpu, card, half
    return worst


# ---------------------------------------------------------------------------
# Phase 11: distributed training and evaluation, ranks sharing the card
# ---------------------------------------------------------------------------

# The ranks of phase 11: gloo processes on the one card (NCCL takes one
# device per rank), started by parallel/launch.spawn with a deadline
PAR_WORLD = 4
PAR_DEADLINE_S = 300.0
PAR_BATCH = 32
# (dp, tp, grad_accum) of the deit_small train step meshes
PAR_MESHES = ((2, 1, 1), (1, 2, 1), (2, 2, 2))
PAR_CHECKED, PAR_TIMED = 2, 3
# (pp, microbatches) of the GPipe cases, and the sp group sizes, on
# deit_tiny's 12-layer stack at 197 tokens
PAR_PP = ((2, 4), (4, 4))
PAR_SP = (2, 4)
PAR_EVAL_DP = (2, 4)
PAR_IMPORTANCE_BATCHES = 2
# a forward's activations (pp, sp) against one process's: within 1e-4 of
# their max|.|, phase 7's loss bound; the losses and updated params as
# phase 7 holds the card against the CPU (CPU_LOSS_RTOL, CPU_STEP_REL)
PAR_REL = 1e-4


def _rank_fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke phase 11: {msg}")


def _par_eval(torch, fe, mesh, folder, model, stacks):
    """``evaluate_sharded`` on this rank's dp share, bf16 (K1/K2) and static
    int8 (K4/K5): a checked run (each forward's logits against the twins,
    per image within ``LOGIT_REL`` of its max|logit|), then a timed one
    (kernels only); the launches of both counted against the forwards."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, fused_vit_apply_int8
    from edgevisiontransformer_tpu_torch.utils.imagenet import evaluate_sharded

    paths = {"bf16": (lambda x, plain: fused_vit_apply(model, x, stacked=stacks["bf16"],
                                                        plain=plain), BF16_LAUNCHES),
             "int8": (lambda x, plain: fused_vit_apply_int8(model, x, stacked_q=stacks["int8"],
                                                             plain=plain), INT8_LAUNCHES)}
    out = {}
    depth = model.config.depth
    for mode, (fn, per_layer) in paths.items():
        calls, worst, tally = [0], [0.0], {k: 0 for k in fe.LAUNCHES}

        def kernels(x, check):
            before = dict(fe.LAUNCHES)
            logits = fn(x, False)
            torch.cuda.synchronize()
            for k, v in fe.LAUNCHES.items():
                tally[k] += v - before[k]
            calls[0] += 1
            if check:
                ref = fn(x, True).float()
                rel = (logits.float() - ref).abs().amax(-1) / ref.abs().amax(-1)
                if not bool(torch.isfinite(logits.float()).all()):
                    _rank_fail(f"evaluate_sharded {mode}: non-finite logits")
                worst[0] = max(worst[0], float(rel.max()))
            return logits

        kw = dict(batch_size=PAR_BATCH, native=True, device=DEVICE)
        acc = evaluate_sharded(lambda x: kernels(x, True), folder, mesh, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc_t = evaluate_sharded(lambda x: kernels(x, False), folder, mesh, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = {k: per_layer.get(k, 0) * depth * calls[0] for k in tally}
        if tally != want:
            _rank_fail(f"evaluate_sharded {mode} at dp={mesh.shape['dp']}: launches {tally} over "
                       f"{calls[0]} forwards, expected {want}")
        if worst[0] > LOGIT_REL or acc_t != acc:
            _rank_fail(f"evaluate_sharded {mode}: logits part from the twins by {worst[0]:.4g} "
                       f"of max|logit| (> {LOGIT_REL}), or the timed run's accuracy {acc_t} is "
                       f"not the checked run's {acc}")
        out[mode] = dict(acc=acc, worst=worst[0], launches=tally, forwards=calls[0], secs=secs)
    # a head whose bias is one-hot on ONE_HOT_CLASS: top-1 exactly that class's share, so
    # the sum over dp counts every image once, the padded rows none
    head = {k: v.detach().clone() for k, v in model.head.named_parameters()}
    with torch.no_grad():
        model.head.kernel.zero_()
        model.head.bias.zero_()
        model.head.bias[ONE_HOT_CLASS] = 1.0
        out["one_hot"] = {mode: evaluate_sharded(lambda x: fn(x, False), folder, mesh,
                                                 batch_size=PAR_BATCH, native=True,
                                                 device=DEVICE)
                          for mode, (fn, _) in paths.items()}
        for k, v in model.head.named_parameters():
            v.copy_(head[k])
    return out


def par_rank(rank, world, folder, act_scales, imp_batches):
    """Phase 11 on one of ``PAR_WORLD`` ranks sharing the card (gloo): the
    deit_small dp x tp steps, the deit_tiny GPipe forward and train step and
    the sp forward, ``evaluate_sharded`` on the kernels and the head
    importance on dp meshes; rank 0 then runs each computation in one
    process and holds the meshes' results to it.  Returns the rank's
    timings, checks and peak memory."""
    import numpy as np
    import torch

    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (apply_params, prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as fe
    from edgevisiontransformer_tpu_torch.ops.cuda.fused_encoder import stack_vit_layer_params
    from edgevisiontransformer_tpu_torch.parallel.mesh import (Mesh, gather_params, make_mesh,
                                                               shard_params)
    from edgevisiontransformer_tpu_torch.parallel.pipeline import (make_pipeline_train_step,
                                                                   pipeline_encoder_apply,
                                                                   sequence_sharded_encoder_apply,
                                                                   vit_block_apply)
    from edgevisiontransformer_tpu_torch.parallel.train import (jit_sharded_train_step,
                                                                make_train_step)
    from edgevisiontransformer_tpu_torch.pruning.head_importance import calculate_head_importance
    from edgevisiontransformer_tpu_torch.utils.finetune import FinetuneConfig, build_optimizer
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t_rank = time.perf_counter()
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)  # noqa: E731
    sync = torch.cuda.synchronize
    out = {"rank": rank, "steps": {}, "pp": {}, "sp": {}, "eval": {}, "importance": {}}
    keep = {}  # rank 0: the meshes' results, held to one process's at the end

    # (a) the dp x tp train step at deit_small, fp32, SGD
    small, shape = build_model("deit_small", style="standard", device=DEVICE,
                               generator=torch.Generator().manual_seed(1100))
    cfg = small.config
    data = torch.Generator().manual_seed(1110)
    x = torch.randn(PAR_BATCH, *shape, generator=data).to(DEVICE)
    y = torch.randint(0, cfg.num_classes, (PAR_BATCH,), generator=data).to(DEVICE)
    init = clone(small.params())
    opt = build_optimizer(FinetuneConfig(lr=TRAIN_LR, optimizer="sgd"))
    apply = lambda p, xx: apply_params(small, p, xx)  # noqa: E731
    for dp, tp, accum in PAR_MESHES:
        mesh = Mesh(np.arange(dp * tp).reshape(dp, tp), ("dp", "tp"))
        if rank not in mesh:
            continue
        step = jit_sharded_train_step(make_train_step(apply, opt, grad_accum=accum), mesh, init,
                                      config=cfg)
        p = shard_params(init, mesh)
        state = opt.init(p)
        losses, times = [], []
        for i in range(PAR_CHECKED + PAR_TIMED):
            sync()
            t0 = time.perf_counter()
            p, state, metrics = step(p, state, x, y)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            if i == PAR_CHECKED - 1:
                whole = gather_params(p, mesh)
                if rank == 0:
                    keep[("step", dp, tp, accum)] = (losses[:PAR_CHECKED], whole)
                del whole
        out["steps"][(dp, tp, accum)] = (float(np.median(times[1:])), losses)
        del p, state, step
    torch.cuda.empty_cache()

    # (b) GPipe and sp on deit_tiny's 12-layer stack, fp32, 197 tokens
    tiny, _ = build_model("deit_tiny", style="standard", device=DEVICE,
                          generator=torch.Generator().manual_seed(1200))
    tcfg = tiny.config
    kw = dict(heads=tcfg.heads, eps=tcfg.layernorm_eps, approx_gelu=tcfg.gelu_approx,
              reference_residual=tcfg.reference_residual)
    stacked = stack_vit_layer_params(clone(tiny.params()), tcfg.depth, tcfg.qkv_bias)
    data = torch.Generator().manual_seed(1210)
    h = torch.randn(PAR_BATCH, tcfg.num_patches + 1, tcfg.dim, generator=data).to(DEVICE)
    head_w = (torch.randn(tcfg.dim, tcfg.num_classes, generator=data) * 0.02).to(DEVICE)
    labels = torch.randint(0, tcfg.num_classes, (PAR_BATCH,), generator=data).to(DEVICE)
    for pp, m in PAR_PP:
        mesh = Mesh(np.arange(pp), ("pp",))
        if rank not in mesh:
            continue
        with torch.no_grad():
            pipeline_encoder_apply(stacked, h, mesh, microbatches=m, **kw)  # warm-up
            sync()
            t0 = time.perf_counter()
            y_pp = pipeline_encoder_apply(stacked, h, mesh, microbatches=m, **kw)
            sync()
            fwd_ms = (time.perf_counter() - t0) * 1e3
        pstep = make_pipeline_train_step(mesh, microbatches=m, learning_rate=TRAIN_LR, **kw)
        pstep(stacked, head_w, h, labels)  # warm-up: the step returns new tensors
        sync()
        t0 = time.perf_counter()
        new, new_head, loss = pstep(stacked, head_w, h, labels)
        sync()
        out["pp"][(pp, m)] = (fwd_ms, (time.perf_counter() - t0) * 1e3, float(loss))
        if rank == 0:
            keep[("pp", pp, m)] = (y_pp, new, new_head, float(loss))
    for g in PAR_SP:
        mesh = make_mesh(dp=world // g, tp=g)
        with torch.no_grad():
            sequence_sharded_encoder_apply(stacked, h, mesh, **kw)  # warm-up
            sync()
            t0 = time.perf_counter()
            y_sp = sequence_sharded_encoder_apply(stacked, h, mesh, **kw)
            sync()
        out["sp"][g] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            keep[("sp", g)] = y_sp

    # (c) evaluate_sharded on the kernels, bf16 and static int8, deit_tiny
    model, _ = build_model("deit_tiny", style="standard", dtype=torch.bfloat16, device=DEVICE,
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        stacks = {"bf16": prepare_vit_fused(model),
                  "int8": prepare_vit_int8_static(model, act_scales=act_scales)}
    for dp in PAR_EVAL_DP:
        mesh = Mesh(np.arange(dp).reshape(dp, 1), ("dp", "tp"))
        if rank in mesh:
            out["eval"][dp] = _par_eval(torch, fe, mesh, folder, model, stacks)

    # (d) head importance over dp, fp32 deit_tiny
    for dp in PAR_EVAL_DP:
        mesh = Mesh(np.arange(dp).reshape(dp, 1), ("dp", "tp"))
        if rank in mesh:
            sync()
            t0 = time.perf_counter()
            imp = calculate_head_importance(tcfg, tiny.params(), imp_batches, mesh=mesh)
            out["importance"][dp] = (imp, time.perf_counter() - t0)
    out["rank_s"] = time.perf_counter() - t_rank
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    if rank != 0:
        return out

    # rank 0, alone now: every computation in one process, and the meshes' results held to it
    for accum in sorted({a for _, _, a in PAR_MESHES}):
        step = make_train_step(apply, opt, grad_accum=accum)
        p = clone(init)
        state = opt.init(p)
        losses, times = [], []
        for i in range(PAR_CHECKED + PAR_TIMED):
            sync()
            t0 = time.perf_counter()
            p, state, metrics = step(p, state, x, y)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            if i == PAR_CHECKED - 1:
                ref = clone(p)
        out["steps"][("one", accum)] = (float(np.median(times[1:])), losses)
        for (kind, *key), (got_losses, whole) in [(k, v) for k, v in keep.items()
                                                  if k[0] == "step" and k[3] == accum]:
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses))
            dev, upd = _step_dev(torch, whole, ref, init)
            out["steps"][("check",) + tuple(key)] = (loss_rel, dev, upd)
            if loss_rel > CPU_LOSS_RTOL or dev > CPU_STEP_REL * upd:
                _rank_fail(f"dp x tp step {key}: losses {got_losses} against one process's "
                           f"{losses[:PAR_CHECKED]} ({loss_rel:.3g} > {CPU_LOSS_RTOL}), or params "
                           f"{dev:.3g} beyond one spacing (> {CPU_STEP_REL} x the largest update "
                           f"{upd:.3g})")
        del step, p, state, ref
    with torch.no_grad():
        ref_h = h
        for i in range(tcfg.depth):
            ref_h = vit_block_apply({k: v[i] for k, v in stacked.items()}, ref_h, **kw)
    scale = float(ref_h.abs().max())
    local = {k: v.detach().clone().requires_grad_() for k, v in stacked.items()}
    hw = head_w.detach().clone().requires_grad_()
    hh = h
    for i in range(tcfg.depth):
        hh = vit_block_apply({k: v[i] for k, v in local.items()}, hh, **kw)
    logp = torch.log_softmax((hh.mean(dim=1) @ hw).float(), dim=-1)
    ref_loss = -logp.gather(-1, labels[:, None]).mean()
    *g_local, g_head = torch.autograd.grad(ref_loss, [*local.values(), hw])
    with torch.no_grad():
        ref_new = {k: p - TRAIN_LR * g for (k, p), g in zip(local.items(), g_local)}
        ref_new["head"] = hw - TRAIN_LR * g_head
    start = {**stacked, "head": head_w}
    for (kind, *key), val in keep.items():
        if kind == "pp":
            y_pp, new, new_head, loss = val
            fwd = float((y_pp - ref_h).abs().max()) / scale
            dev, upd = _step_dev(torch, {**new, "head": new_head}, ref_new, start)
            loss_rel = abs(loss - float(ref_loss.detach())) / abs(float(ref_loss.detach()))
            out["pp"][("check",) + tuple(key)] = (fwd, loss_rel, dev, upd)
            if fwd > PAR_REL or loss_rel > CPU_LOSS_RTOL or dev > CPU_STEP_REL * upd:
                _rank_fail(f"GPipe at (pp, M) = {tuple(key)}: forward {fwd:.3g} of max|.| "
                           f"(> {PAR_REL}), loss {loss_rel:.3g} (> {CPU_LOSS_RTOL}) or params "
                           f"{dev:.3g} (> {CPU_STEP_REL} x {upd:.3g}) from one process's")
        elif kind == "sp":
            fwd = float((val - ref_h).abs().max()) / scale
            out["sp"][("check", key[0])] = fwd
            if fwd > PAR_REL:
                _rank_fail(f"sp over {key[0]} ranks: {fwd:.3g} of max|.| from one process's "
                           f"(> {PAR_REL})")
    return out


def phase_parallel(torch, harness, card):
    """Phase 11: ``PAR_WORLD`` gloo ranks on the card (``parallel/launch.spawn``
    after the parent built and loaded the library), each mesh against one
    process on the card; ``evaluate_sharded`` against the parent's
    ``evaluate``; the head importance against the parent's and the heads
    it prunes at 9 and 18; then the dryrun on 4 ranks."""
    import tempfile

    import numpy as np

    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply, fused_vit_apply_int8,
                                                             prepare_vit_fused,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import calibrate_vit, representative_batches
    from edgevisiontransformer_tpu_torch.parallel import dryrun
    from edgevisiontransformer_tpu_torch.parallel.launch import spawn
    from edgevisiontransformer_tpu_torch.parallel.pipeline import head_split
    from edgevisiontransformer_tpu_torch.pruning.head_importance import calculate_head_importance
    from edgevisiontransformer_tpu_torch.pruning.policy import what_to_prune
    from edgevisiontransformer_tpu_torch.utils import native_preprocess as npre
    from edgevisiontransformer_tpu_torch.utils.imagenet import evaluate

    t_phase = time.perf_counter()
    if not npre.available():  # built here once; the ranks load it
        fail(f"native preprocessing did not build from {npre.SOURCE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, shape = build_model("deit_tiny", style="standard", dtype=torch.bfloat16, device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        act_scales = calibrate_vit(model, batches=representative_batches(n=8, shape=shape))
        stacks = {"bf16": prepare_vit_fused(model),
                  "int8": prepare_vit_int8_static(model, act_scales=act_scales)}
    forwards = {"bf16": lambda x: fused_vit_apply(model, x, stacked=stacks["bf16"]),
                "int8": lambda x: fused_vit_apply_int8(model, x, stacked_q=stacks["int8"])}
    tiny, _ = build_model("deit_tiny", style="standard", device=DEVICE,
                          generator=torch.Generator().manual_seed(1200))
    data = torch.Generator().manual_seed(1300)
    imp_batches = [torch.randn(PAR_BATCH, *shape, generator=data)
                   for _ in range(PAR_IMPORTANCE_BATCHES)]
    imp_one = calculate_head_importance(tiny.config, tiny.params(), imp_batches)
    del tiny
    with tempfile.TemporaryDirectory() as tmp:
        write_image_folder(Path(tmp), seed=4000)
        n_images = sum(EVAL_CLASS_SIZES)
        one = {}
        with torch.no_grad():
            for mode, fwd in forwards.items():
                evaluate(fwd, tmp, batch_size=PAR_BATCH, native=True, device=DEVICE)  # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                acc = evaluate(fwd, tmp, batch_size=PAR_BATCH, native=True, device=DEVICE)
                torch.cuda.synchronize()
                one[mode] = (acc, time.perf_counter() - t0)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            ranks = spawn(par_rank, PAR_WORLD, backend="gloo", device=DEVICE,
                          deadline_s=PAR_DEADLINE_S, args=(tmp, act_scales, imp_batches))
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 11 ranks: {e}")
        world_s = time.perf_counter() - t0
    r0 = ranks[0]
    for dp, tp, accum in PAR_MESHES:
        ms, losses = r0["steps"][(dp, tp, accum)]
        one_ms = r0["steps"][("one", accum)][0]
        loss_rel, dev, upd = r0["steps"][("check", dp, tp, accum)]
        print(f"  deit_small b{PAR_BATCH} SGD step, dp {dp} x tp {tp}, grad_accum {accum}: eager "
              f"p50 {ms:.2f} ms (one process {one_ms:.2f} ms); {PAR_CHECKED} steps against one "
              f"process: losses {loss_rel:.3g} relative, params {dev:.3g} beyond one spacing "
              f"(largest update {upd:.3g})")
    for pp, m in PAR_PP:
        fwd_ms, step_ms, loss = r0["pp"][(pp, m)]
        fwd, loss_rel, dev, upd = r0["pp"][("check", pp, m)]
        print(f"  GPipe deit_tiny stack b{PAR_BATCH}, pp {pp}, {m} microbatches: forward "
              f"{fwd_ms:.2f} ms, {fwd:.3g} of max|.| from one process; train step {step_ms:.2f} "
              f"ms, loss {loss:.6f} ({loss_rel:.3g} relative), params {dev:.3g} beyond one "
              f"spacing (largest update {upd:.3g})")
    for g in PAR_SP:
        print(f"  sp deit_tiny stack b{PAR_BATCH}, 197 tokens over {g} ranks (heads per rank "
              f"{head_split(3, g)}): {r0['sp'][g]:.2f} ms, {r0['sp'][('check', g)]:.3g} of "
              f"max|.| from one process")
    for mode in ("bf16", "int8"):
        acc_one, secs_one = one[mode]
        for dp in PAR_EVAL_DP:
            got = [r["eval"][dp][mode] for r in ranks if dp in r["eval"]]
            accs = {g["acc"] for g in got}
            if accs != {acc_one}:
                fail(f"evaluate_sharded {mode} dp={dp}: accuracies {accs}, one process's "
                     f"evaluate {acc_one}")
            launched = {k for g in got for k, v in g["launches"].items() if v}
            want = {k for k, v in (BF16_LAUNCHES if mode == "bf16" else INT8_LAUNCHES).items()
                    if v}
            if launched != want:
                fail(f"evaluate_sharded {mode} dp={dp}: kernels launched {sorted(launched)}, "
                     f"expected {sorted(want)}")
            one_hot = {r["eval"][dp]["one_hot"][mode] for r in ranks if dp in r["eval"]}
            if one_hot != {EVAL_CLASS_SIZES[ONE_HOT_CLASS] / n_images}:
                fail(f"evaluate_sharded {mode} dp={dp} with a one-hot head: top-1 {one_hot}, "
                     f"expected {EVAL_CLASS_SIZES[ONE_HOT_CLASS]}/{n_images}")
            secs = max(g["secs"] for g in got)
            print(f"  evaluate_sharded {mode} dp {dp}, {n_images} BMPs b{PAR_BATCH}: top-1 "
                  f"{got[0]['acc']:.4f} = one process's (random weights), with a one-hot head "
                  f"on class {ONE_HOT_CLASS} {EVAL_CLASS_SIZES[ONE_HOT_CLASS]}/{n_images}; worst "
                  f"per-image |kernels - twins| "
                  f"{max(g['worst'] for g in got):.4g} of max|logit|; {n_images / secs:.1f} img/s "
                  f"(one process {n_images / secs_one:.1f}); launches per rank "
                  + "; ".join(f"{g['forwards']} forwards "
                              f"{ {k: v for k, v in g['launches'].items() if v} }" for g in got))
    for dp in PAR_EVAL_DP:
        imp, secs = r0["importance"][dp]
        err = float(np.abs(imp - imp_one).max())
        if not np.isfinite(imp).all() or err > IMPORTANCE_ATOL:
            fail(f"head importance over dp={dp}: {err:.3g} from one process's "
                 f"(> {IMPORTANCE_ATOL})")
        flat = lambda d: {(layer, h) for layer, hs in d.items() for h in hs}  # noqa: E731
        ties = []
        for n in PRUNE_NUMBERS:
            got = flat(what_to_prune(imp, n, at_least_x_heads_per_layer=1))
            ref = flat(what_to_prune(imp_one, n, at_least_x_heads_per_layer=1))
            pairs = [(a, b, abs(imp_one[a] - imp_one[b]))
                     for a, b in zip(sorted(got - ref), sorted(ref - got))]
            if len(got - ref) != len(ref - got) or any(d > IMPORTANCE_ATOL for _, _, d in pairs):
                fail(f"head importance over dp={dp}: prunes other heads at {n} "
                     f"(pairs {pairs})")
            ties += pairs
        print(f"  head importance, deit_tiny {PAR_IMPORTANCE_BATCHES} x b{PAR_BATCH} over dp {dp}: "
              f"{secs:.2f} s, {err:.3g} from one process's; the heads pruned at "
              f"{PRUNE_NUMBERS} the same" + (f" up to near-ties {ties}" if ties else ""))
    for r in ranks:
        print(f"  rank {r['rank']}: {r['rank_s']:.1f} s, peak device memory "
              f"{r['peak_mib']:.1f} MiB")
    t0 = time.perf_counter()
    tail = dryrun.run(PAR_WORLD, DEVICE, deadline_s=PAR_DEADLINE_S)
    print(f"  dryrun {PAR_WORLD} --device {DEVICE} ({time.perf_counter() - t0:.1f} s): {tail}")
    torch.cuda.synchronize()
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s (the ranks' world {world_s:.1f} s), "
          f"the parent's peak device memory {harness.device_peak_mb():.1f} MiB; {PAR_WORLD} ranks "
          f"sharing one card over gloo, on {card}")


# ---------------------------------------------------------------------------
# Phase 12: the CLI on the card
# ---------------------------------------------------------------------------

_DEIT_FUSED = ("ln_rows", "linear", "attention_rows")
_INT8 = ("ln_rows", "attention_rows", "quant_rows", "linear_i8")
_T2T_TOKENIZER = ("stage1_kqv", "performer_reduce", "performer_rows")
_SWIN = ("ln_rows", "linear", "window_attention", "swin_merge")
# benchmark requests: (model, batch, --kernel-mode, more flags, the kernels
# the command launches: exactly these, every other kernel none)
CLI_BENCHMARKS = tuple(
    ("deit_tiny", b, mode, (), kernels) for b in (1, 128) for mode, kernels in (
        ("xla", ()), ("pallas", ("sdpa", "mlp")), ("fused", _DEIT_FUSED), ("int8", _INT8),
        ("int8_static", _INT8))
) + (
    ("t2t_vit_14", 1, "fused", (), _T2T_TOKENIZER + _DEIT_FUSED),
    ("t2t_vit_14", 1, "int8_static", ("--stem-int8",), _T2T_TOKENIZER + _INT8),
    ("swin_tiny", 1, "fused", (), _SWIN),
    ("swin_tiny", 1, "int8_static", (), _SWIN + ("quant_rows", "linear_i8")),
    ("swin_tiny", 1, "pallas", (), ("window_sdpa",)),
    ("deit_base", 1, "fused", (), _DEIT_FUSED),
)
CLI_ITERS, CLI_REPEATS = 20, 3
CLI_TRAIN_BATCH = 32
CLI_PROFILE_BATCHES = (1, 32)
# the traced fused DeiT must show these kernels, and its per-op sum must not
# exceed the end-to-end loop-delta time by more than the profiler's own cost
CLI_TRACE_KERNELS = ("ln_rows_kernel", "linear_kernel", "attention_rows_kernel")
CLI_TRACE_RATIO_MAX = 1.05
CLI_LATENCY_ENCODINGS = 3
CLI_TIMER_BATCH = 128
# the loop-delta timer against the CUDA-event timer: both time a call with
# the host in it; they run in turn, CLI_TIMER_ROUNDS times each, and their
# medians are compared, because the host's speed drifts (a deit_tiny b128
# call took 5.50-7.45 ms in three runs on the H100)
TIMER_AGREE = 0.15
CLI_TIMER_ROUNDS = 3
# the torch.export program against the plain forward it was traced from
EXPORT_REL = 1e-5


def run_cli(cli, argv) -> str:
    """``cli.main(argv)`` in this process, its standard output captured,
    echoed indented and returned; fails on a refusal or a non-zero code."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    except SystemExit as e:
        fail(f"cli {' '.join(argv)}: exited ({e}) after {buf.getvalue()!r}")
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    | {line}")
    if rc != 0:
        fail(f"cli {' '.join(argv)}: exit code {rc}")
    return out


def last_json(out: str):
    for line in reversed(out.splitlines()):
        if line.startswith(("{", "[")):
            return json.loads(line)
    fail(f"no JSON line in {out!r}")


def check_cli_launches(tag, counter, kernels) -> dict:
    got = counter.read()
    ran = {k for k, v in got.items() if v}
    if ran != set(kernels):
        fail(f"{tag}: launched {sorted(ran)}, expected exactly {sorted(kernels)} "
             f"({ {k: v for k, v in got.items() if v} })")
    return {k: v for k, v in got.items() if v}


def _top1_line(out: str, tag: str) -> float:
    m = re.search(r"top1 ([\d.]+)", out)
    if m is None:
        fail(f"{tag}: no top1 line in {out!r}")
    return float(m[1])


def phase_cli(torch, harness, counter, card):
    """Phase 12: the port's commands run in this process through
    ``cli.main`` at full width: ``benchmark`` per kernel mode (its JSON line
    beside the device p50 of a CUDA-graph replay of the same call, the
    launches exactly the mode's kernels), ``benchmark_train``, ``profile``
    (trace and micro) with ``analyse_op`` / ``analyse_attn_ffn`` on its CSV,
    ``experiments``, ``convert`` -> ``benchmark`` / ``eval`` of the int8
    artifact (logits against the twins), ``eval --impl xla`` against
    ``--impl fused``, ``export --format torch_export`` against the plain
    forward, ``latency_model`` collect / fit / predict, and the loop-delta
    timer against the CUDA-event timer."""
    import importlib.util
    import statistics
    import tempfile

    import numpy as np

    from edgevisiontransformer_tpu_torch import cli
    from edgevisiontransformer_tpu_torch.bench import looptimer
    from edgevisiontransformer_tpu_torch.bench.analyse import find_op_wise_range, read_rows
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, prepare_vit_fused
    from edgevisiontransformer_tpu_torch.utils.export import load_exported
    from edgevisiontransformer_tpu_torch.utils.imagenet import iterate_batches, list_image_folder

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev = ["--device", DEVICE]
    no_kernels = ()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, batch, mode, extra, kernels in CLI_BENCHMARKS:
            tag = f"benchmark {name} b{batch} --kernel-mode {mode}{''.join(' ' + e for e in extra)}"
            counter.reset()
            t0 = time.perf_counter()
            r = last_json(run_cli(cli, ["benchmark", "--model", name, "--batch", str(batch),
                                        "--kernel-mode", mode, "--iters", str(CLI_ITERS),
                                        "--repeats", str(CLI_REPEATS), "--device-time",
                                        *extra, *dev]))
            got = check_cli_launches(tag, counter, kernels)
            if not (r["p50_ms"] > 0 and r["device_p50_ms"] > 0):
                fail(f"{tag}: p50 {r['p50_ms']}, device p50 {r['device_p50_ms']}")
            print(f"  {tag}: eager p50 {r['p50_ms']:.4f} ms (std {r['std_ms']:.4f}, iters "
                  f"{r['iters']}), device p50 {r['device_p50_ms']:.4f} ms, device idle "
                  f"{1 - r['device_p50_ms'] / r['p50_ms']:.1%}, {r['throughput_per_s']:.1f} img/s; "
                  f"{time.perf_counter() - t0:.1f} s; launches {got}")
            torch.cuda.empty_cache()

        counter.reset()
        r = last_json(run_cli(cli, ["benchmark_train", "--mode", "both", "--batch",
                                    str(CLI_TRAIN_BATCH), "--iters", "3", "--repeats", "2",
                                    *dev]))
        check_cli_launches("benchmark_train", counter, no_kernels)
        if not (r["finetune"]["p50_ms"] > 0 and r["sparse"]["p50_ms"] > 0):
            fail(f"benchmark_train: step times {r}")
        torch.cuda.empty_cache()

        for batch in CLI_PROFILE_BATCHES:
            path = tmp / f"trace_b{batch}.csv"
            tag = f"profile --mode trace --kernel-mode fused deit_tiny b{batch}"
            counter.reset()
            out = run_cli(cli, ["profile", "--mode", "trace", "--kernel-mode", "fused",
                                "--batch", str(batch), "--output", str(path), *dev])
            check_cli_launches(tag, counter, _DEIT_FUSED)
            m = re.search(r"trace per-op sum ([\d.]+) ms vs end-to-end ([\d.]+) ms", out)
            if m is None:
                fail(f"{tag}: no per-op sum line")
            total, e2e = float(m[1]), float(m[2])
            rows = read_rows(str(path))
            begin, end, schema = find_op_wise_range(rows)
            names = [row[schema["name"]] for row in rows[begin:end]]
            missing = [k for k in CLI_TRACE_KERNELS if not any(k in n for n in names)]
            if missing:
                fail(f"{tag}: the trace holds no {missing} ({len(names)} rows)")
            ratio = total / e2e if e2e > 0 else float("nan")
            if not 0 < ratio <= CLI_TRACE_RATIO_MAX:
                fail(f"{tag}: per-op sum {total} ms against end-to-end {e2e} ms (ratio {ratio})")
            run_cli(cli, ["analyse_op", "--file", str(path)])
            split = last_json(run_cli(cli, ["analyse_attn_ffn", "--file", str(path)]))
            if not (split["attention_ms"] > 0 and split["ffn_ms"] > 0):
                fail(f"{tag}: analyse_attn_ffn did not split the trace: {split}")
            print(f"  {tag}: {len(names)} kernel rows, per-op sum {total:.4f} ms against "
                  f"end-to-end {e2e:.4f} ms, ratio {ratio:.4f} (1 - ratio: the device's idle "
                  f"share of a call); attention {split['attention_ms']:.4f} ms, ffn "
                  f"{split['ffn_ms']:.4f} ms, other {split['other_ms']:.4f} ms")
        counter.reset()
        t0 = time.perf_counter()
        run_cli(cli, ["profile", "--mode", "micro", "--output", str(tmp / "micro.csv"), *dev])
        check_cli_launches("profile --mode micro", counter, no_kernels)
        split = last_json(run_cli(cli, ["analyse_attn_ffn", "--file", str(tmp / "micro.csv")]))
        print(f"  profile --mode micro deit_tiny b1: {time.perf_counter() - t0:.1f} s; {split}")

        counter.reset()
        fab = last_json(run_cli(cli, ["experiments", "fusion_ab", *dev]))
        check_cli_launches("experiments fusion_ab", counter, ("ln_rows", "linear"))
        counter.reset()
        sweep = last_json(run_cli(cli, ["experiments", "quant_sweep", "--sizes", "256", "1024",
                                        *dev]))
        micro = last_json(run_cli(cli, ["experiments", "micro", *dev]))
        check_cli_launches("experiments quant_sweep, micro", counter, no_kernels)
        if not (fab["fused_ms"] > 0 and fab["unfused_ms"] > 0 and min(micro.values()) > 0
                and all(v > 0 for row in sweep for k, v in row.items() if k != "size")):
            fail(f"experiments: {fab} {sweep} {micro}")

        art = tmp / "deit_tiny_int8"
        run_cli(cli, ["convert", "--model", "deit_tiny", "--quantization", "int8",
                      "--calib-batches", "4", "--output", str(art), *dev])
        counter.reset()
        r = last_json(run_cli(cli, ["benchmark", "--quantized-checkpoint", str(art),
                                    "--iters", str(CLI_ITERS), "--repeats", str(CLI_REPEATS),
                                    "--device-time", *dev]))
        got = check_cli_launches("benchmark --quantized-checkpoint", counter, _INT8)
        if not (r["p50_ms"] > 0 and r["device_p50_ms"] > 0):
            fail(f"benchmark --quantized-checkpoint: {r}")
        print(f"  benchmark --quantized-checkpoint (convert --quantization int8, deit_tiny) b1: "
              f"eager p50 {r['p50_ms']:.4f} ms, device p50 {r['device_p50_ms']:.4f} ms; "
              f"launches {got}")
        folder = tmp / "images"
        labels = torch.tensor(write_image_folder(folder, seed=4000))
        samples, _ = list_image_folder(str(folder))
        _, _, qfn = cli._load_quantized_artifact(str(art), "bfloat16", DEVICE)
        model32, _ = cli._build_model("deit_tiny", device=DEVICE)
        model16, _ = cli._build_model("deit_tiny", dtype="bfloat16", device=DEVICE)
        stacked = prepare_vit_fused(model16)
        fused = lambda x: fused_vit_apply(model16, x, stacked=stacked)  # noqa: E731
        logits = {"int8": [], "int8 twins": [], "xla": [], "fused": []}
        worst_art = 0.0
        with torch.no_grad():
            for x, _ in iterate_batches(samples, EVAL_BATCH):
                m = x.shape[0]
                x = np.concatenate([x, np.zeros((EVAL_BATCH - m,) + x.shape[1:], x.dtype)])
                xd = torch.from_numpy(x).to(DEVICE)
                for k, fn in (("int8", qfn), ("int8 twins", lambda t: qfn(t, plain=True)),
                              ("xla", model32), ("fused", fused)):
                    logits[k].append(fn(xd)[:m].float().cpu())
                # each batch as evaluate runs it, held as phase 4 holds a request
                worst_art = max(worst_art, check_logits(
                    "the int8 artifact (convert --quantization int8) over the BMPs",
                    logits["int8"][-1], logits["int8 twins"][-1], m, 1000)[0])
        logits = {k: torch.cat(v) for k, v in logits.items()}
        got, ref = logits["int8"], logits["int8 twins"]
        rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
        counter.reset()
        top1 = _top1_line(run_cli(cli, ["eval", "--quantized-checkpoint", str(art), "--data-dir",
                                        str(folder), "--batch", str(EVAL_BATCH), *dev]),
                          "eval --quantized-checkpoint")
        check_cli_launches("eval --quantized-checkpoint", counter, _INT8)
        acc = {k: float((v.argmax(-1) == labels).float().mean()) for k, v in logits.items()}
        if abs(top1 - acc["int8"]) > 5e-5:
            fail(f"eval --quantized-checkpoint: top1 {top1}, its per-image predictions "
                 f"{acc['int8']}")
        top1s = {}
        for impl, kernels in (("xla", no_kernels), ("fused", _DEIT_FUSED)):
            counter.reset()
            top1s[impl] = _top1_line(run_cli(cli, ["eval", "--model", "deit_tiny", "--impl", impl,
                                                   "--data-dir", str(folder), "--batch",
                                                   str(EVAL_BATCH), *dev]), f"eval --impl {impl}")
            check_cli_launches(f"eval --impl {impl}", counter, kernels)
            if abs(top1s[impl] - acc[impl]) > 5e-5:
                fail(f"eval --impl {impl}: top1 {top1s[impl]}, its per-image predictions "
                     f"{acc[impl]}")
        xla = logits["xla"]
        top2 = xla.topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= LOGIT_REL * float(xla.abs().max())
        parted = xla.argmax(-1) != logits["fused"].argmax(-1)
        if bool((parted & ~near).any()):
            fail(f"eval --impl xla and --impl fused part on images whose xla top-2 gap is above "
                 f"the logit bound: {parted.nonzero().flatten().tolist()}")
        print(f"  eval over {len(samples)} BMPs, b{EVAL_BATCH}: --quantized-checkpoint top1 "
              f"{top1:.4f} (each batch within {worst_art:.4g} x its max|logit| of the twins, "
              f"the worst image {float(rel.max()):.4g} x its own), "
              f"--impl xla {top1s['xla']:.4f}, --impl fused {top1s['fused']:.4f}; "
              f"{int(parted.sum())} image(s) part, {int(near.sum())} near-tie image(s) (random "
              f"weights)")

        path = tmp / "deit_tiny.pt2"
        run_cli(cli, ["export", "--model", "deit_tiny", "--format", "torch_export", "--output",
                      str(path), *dev])
        side = json.loads(Path(str(path) + ".json").read_text())
        if set(side) != {"input_shape", "dtype", "baked_params", "model", "style"}:
            fail(f"export sidecar keys {sorted(side)}")
        x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(4200)).to(DEVICE)
        with torch.no_grad():
            a, b = load_exported(str(path))(x), model32(x)
        torch.cuda.synchronize()
        err = float((a - b).abs().max()) / float(b.abs().max())
        if not err <= EXPORT_REL:
            fail(f"the exported program parts from the plain forward by {err:.3g} x max|logit|")
        print(f"  export --format torch_export: the loaded program against the plain forward "
              f"on the card {err:.3g} x max|logit| ({'the same bits' if torch.equal(a, b) else 'not the same bits'})")

        lat = tmp / "latency.csv"
        counter.reset()
        t0 = time.perf_counter()
        run_cli(cli, ["latency_model", "collect", "--n", str(CLI_LATENCY_ENCODINGS), "--impl",
                      "fused", "--output", str(lat), *dev])
        check_cli_launches("latency_model collect --impl fused", counter, _DEIT_FUSED)
        collect_s = time.perf_counter() - t0
        lines = lat.read_text().splitlines()[1:]
        if len(lines) != CLI_LATENCY_ENCODINGS or not all(float(r.split(",")[1]) > 0
                                                          for r in lines):
            fail(f"latency_model collect wrote {lines}")
        print(f"  latency_model collect ({CLI_LATENCY_ENCODINGS} encodings, b1, fused): "
              f"{collect_s:.1f} s")
        # fit and predict are scikit-learn on the host (the JAX package's
        # RandomForest), which this machine may lack: say so rather than fail
        if importlib.util.find_spec("sklearn") is None:
            print("  latency_model fit / predict: not run, scikit-learn is not installed here "
                  "(tests/test_torch_cli.py runs them on the CPU against the JAX CLI's fit)")
        else:
            pkl = tmp / "latency.pkl"
            run_cli(cli, ["latency_model", "fit", "--data", str(lat), "--output", str(pkl)])
            out = run_cli(cli, ["latency_model", "predict", "--predictor", str(pkl),
                                "--encoding", lines[0].split(",")[0]])
            if not float(out.split()[0]) > 0:
                fail(f"latency_model predict: {out!r}")

        x = torch.ones(CLI_TIMER_BATCH, 3, 224, 224, dtype=torch.bfloat16, device=DEVICE)
        loops, events = [], []
        with torch.no_grad():
            for _ in range(CLI_TIMER_ROUNDS):
                loops.append(looptimer.measure_op_time(fused, (x,), iters=CLI_ITERS,
                                                       repeats=CLI_REPEATS)["p50_ms"])
                events.append(harness.measure_call_time(fused, (x,), iters=CLI_ITERS,
                                                        repeats=5)["p50_ms"])
        loop, event = statistics.median(loops), statistics.median(events)
        part = abs(loop - event) / event
        print(f"  deit_tiny b{CLI_TIMER_BATCH} fused_vit_apply, {CLI_TIMER_ROUNDS} rounds in turn: "
              f"looptimer.measure_op_time p50 {', '.join(f'{v:.4f}' for v in loops)} ms, "
              f"harness.measure_call_time p50 {', '.join(f'{v:.4f}' for v in events)} ms; "
              f"medians {loop:.4f} and {event:.4f} ms, {part:.1%} apart")
        if part > TIMER_AGREE:
            fail(f"the loop-delta and CUDA-event timers part by {part:.1%} (> {TIMER_AGREE:.0%})")
        del model32, model16, stacked
    torch.cuda.synchronize()
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{harness.device_peak_mb():.1f} MiB, on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from edgevisiontransformer_tpu_torch.bench import harness
    from edgevisiontransformer_tpu_torch.ops.cuda import build
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as fa
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as fe
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as fm
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_vit_full as vf
    from edgevisiontransformer_tpu_torch.ops.cuda import layernorm as ln
    from edgevisiontransformer_tpu_torch.ops.cuda import performer as pf
    from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as sb
    from edgevisiontransformer_tpu_torch.ops.cuda import swin_merge as sm
    from edgevisiontransformer_tpu_torch.ops.cuda import t2t_stage1 as ts
    from edgevisiontransformer_tpu_torch.ops.cuda import window_sdpa as ws

    counter = Launches(fe, ts, sb, sm, ws, fa, fm, vf, pf)
    print("== phase 1: environment")
    card = phase_env(torch, build)
    print("== phase 2: build")
    build_s = phase_build(torch, build, vf)
    print(f"== phase 3: kernels against twins (bf16 kernels, stage1_kqv and the int8 GELU "
          f"epilogue: |err| <= {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|; quant_rows and the "
          f"other linear_i8 epilogues bit for bit); times on {card}")
    errs, layer_ms = phase_kernels(torch, fe, harness)
    errs8, layer_ms8 = phase_kernels_int8(torch, fe, harness)
    errs.update(errs8)
    layer_ms.update(layer_ms8)
    errs["stage1_kqv"], stage1_ms = phase_kernel_stage1(torch, ts, harness)
    layer_ms.update(stage1_ms)
    errs_swin, swin_ms = phase_kernels_swin(torch, fe, sb, sm, ws, harness)
    errs_swin8, _ = phase_kernels_int8(torch, fe, harness, shapes=SWIN_INT8_SHAPES,
                                       bias_dtype=torch.bfloat16, seed=7)
    for more in (errs_swin, errs_swin8):
        for k, v in more.items():
            errs[k] = max(errs.get(k, 0.0), v)
    layer_ms.update(swin_ms)
    errs_pallas, pallas_ms = phase_kernels_pallas(torch, fe, fa, fm, ln, harness)
    errs_ragged = phase_kernels_ragged(torch, fe, harness)
    errs_ragged["attention_rows"], attention_ms = phase_kernel_attention(torch, fe, harness)
    layer_ms.update(attention_ms)
    for more in (errs_pallas, errs_ragged):
        for k, v in more.items():
            errs[k] = max(errs.get(k, 0.0), v)
    layer_ms.update(pallas_ms)
    errs["vit_full"] = phase_kernel_vit_full(torch, vf, harness)
    errs_perf, perf_ms = phase_kernel_performer(torch, pf, harness)
    errs.update(errs_perf)
    layer_ms.update(perf_ms)
    print(f"== phase 4: slices through fused_vit_apply[_int8], fused_t2t_apply[_int8] (K16, the "
          f"int8 stem), fused_swin_apply (bf16 and int8), the kernel_mode='pallas' Swin, ViT and "
          f"T2T modules, the pruned DeiT models and fully_fused_vit_apply (logits within "
          f"{LOGIT_REL} x max|logit| of the twins)")
    launches, worst, models = phase_slice(torch, counter)
    launches8, worst8, stacks = phase_slice_int8(torch, fe, counter, models)
    launches_t2t, worst_t2t, t2t_state = phase_slice_t2t(torch, counter)
    launches_swin, worst_swin, swin_state = phase_slice_swin(torch, counter)
    launches_swin8, worst_swin8, swin_stacks = phase_slice_swin_int8(torch, counter, swin_state)
    launches_mod, worst_mod, module_state = phase_slice_swin_module(torch, counter, ws)
    launches_vm, worst_vm, vit_module_state = phase_slice_vit_module(torch, counter, fa, fm)
    launches_pr, worst_pr, pruned_state = phase_slice_pruned(torch, counter, fa, fm)
    launches_full, worst_full, full_preps = phase_slice_full(torch, counter, vf, models)
    for more in (launches8, launches_t2t, launches_swin, launches_swin8, launches_mod,
                 launches_vm, launches_pr, launches_full):
        for k, v in more.items():
            launches[k] += v
    for k, v in launches.items():
        if v == 0:
            fail(f"kernel {k} was never launched on the main path")
    print(f"== phase 5: slice timing, t2t_vit_14, swin_tiny, the deit_tiny kernel_mode='pallas' "
          f"module and {PRUNED_UNIFORM}, fully_fused_vit_apply, deit_base b1 and deit_tiny "
          f"standard bf16 and int8, on {card}")
    phase_time_t2t(torch, harness, t2t_state)
    del t2t_state
    phase_time_swin(torch, harness, swin_state, swin_stacks, module_state)
    del swin_state, swin_stacks, module_state
    torch.cuda.empty_cache()
    phase_time_pallas(torch, harness, vit_module_state, pruned_state)
    del vit_module_state, pruned_state
    torch.cuda.empty_cache()
    layer_ms.update(phase_time_full(torch, harness, vf, models, full_preps))
    del full_preps
    base_b1_ms = phase_time_base(torch, harness, models, stacks)
    # deit_tiny's peak memory is read with deit_base's weights freed
    models.pop(("deit_base", "standard"))
    stacks.pop(("deit_base", "standard", "static"))
    torch.cuda.empty_cache()
    phase_time_slice(torch, harness, models, stacks)
    del models, stacks
    torch.cuda.empty_cache()
    print(f"== phase 6: bounds and library yardsticks, on {card}")
    yard, chains = phase_yardsticks(torch, harness)
    (k1, p1), (bnd1, by1, lib1) = layer_ms["mlp b1"], yard["mlp b1"]
    print(f"  mlp, one deit_tiny b1 module layer: kernel {k1:.4f} ms, twin {p1:.4f} ms, bound "
          f"{bnd1:.4f} ms ({by1}), library (torch.addmm + F.gelu + torch.addmm) {lib1:.4f} ms")
    (k1, p1), (bnd1, by1, lib1) = layer_ms["attention_rows b1"], yard["attention_rows b1"]
    print(f"  attention_rows, one deit_tiny b1 layer: kernel {k1:.4f} ms, twin {p1:.4f} ms, "
          f"bound {bnd1:.4g} ms ({by1}), library (SDPA with a key mask) {lib1:.4f} ms")
    (k1, p1), (bnd1, by1, lib1) = layer_ms["linear b1"], yard["linear b1"]
    print(f"  linear, one deit_tiny b1 layer (qkv, out, fc1 erf, fc2): kernel {k1:.4f} ms, twin "
          f"{p1:.4f} ms, bound {bnd1:.4f} ms ({by1}), library (torch.addmm x4) {lib1:.4f} ms")
    (k1, p1), (bnd1, by1, _) = layer_ms["vit_full b1"], yard["vit_full b1"]
    print(f"  vit_full, one deit_tiny b1 forward: kernel {k1:.4f} ms, twin {p1:.4f} ms, bound "
          f"{bnd1:.4g} ms ({by1}), library none")
    (k1, p1), (bnd1, by1, lib1) = layer_ms["linear_i8 b1"], yard["linear_i8 b1"]
    print(f"  linear_i8, one static-int8 deit_tiny b1 layer (qkv, out, fc1 erf, fc2): kernel "
          f"{k1:.4f} ms, twin {p1:.4f} ms, bound {bnd1:.4g} ms ({by1}), library "
          f"(torch._int_mm x4 at 197 rows) {lib1:.4f} ms")
    for tag in ("", " b4"):
        (k1, p1), (bnd1, by1, _) = layer_ms["stage1_kqv" + tag], yard["stage1_kqv" + tag]
        print(f"  stage1_kqv, one t2t_vit_14 b{tag.strip(' b') or 1} call: kernel {k1:.4f} ms, "
              f"twin {p1:.4f} ms, bound {bnd1:.4g} ms ({by1}), kernel / bound {k1 / bnd1:.1f}")
    for tag, batch in (("", 1), (" b32", 32)):
        both = 0.0
        for k in ("performer_reduce", "performer_rows"):
            (kk, pk), (bk, byk, _) = layer_ms[k + tag], yard[k + tag]
            both += kk
            print(f"  {k}, one t2t_vit_14 b{batch} tokenizer's two performers: kernel {kk:.4f} "
                  f"ms, twin {pk:.4f} ms, bound {bk:.4g} ms ({byk}), kernel / bound "
                  f"{kk / bk:.1f}")
        print(f"  K16, one t2t_vit_14 b{batch} tokenizer: both kernels {both:.4f} ms, the eager "
              f"performer chain {chains[tag]:.4f} ms")
    vit_h_yard = vit_huge_yardsticks(torch, harness)
    for key, (bnd1, by1, lib1) in vit_h_yard.items():
        k1, p1 = layer_ms[key]
        what = {"attention_rows": "SDPA with a key mask", "sdpa": "SDPA",
                "mlp": "torch.addmm + F.gelu + torch.addmm"}[key.split()[0]]
        layer = ("12 heads of 64, 577 keys" if "deit_base" in key
                 else "16 heads of 80, dim 1280, MLP 5120")
        print(f"  {key}, one layer ({layer}): kernel {k1:.4f} ms, "
              f"twin {p1:.4f} ms, bound {bnd1:.4g} ms ({by1}), kernel / bound "
              f"{k1 / bnd1:.1f}, library ({what}) {lib1:.4f} ms")
    for tag, yt in (("deit_tiny b128", ""), ("deit_tiny b1", " b1")):
        for name in LINEAR_GEMMS:
            (kg, pg), (bg, byg, lg) = layer_ms[f"linear {name} {tag}"], yard[f"linear {name}{yt}"]
            print(f"  linear {name:7s} {tag:14s} kernel {kg:.4f} ms, twin {pg:.4f} ms, bound "
                  f"{bg:.4f} ms ({byg}), torch.addmm {lg:.4f} ms")
    print(f"== phase 7: finetune, QAT and SmoothQuant on the card, the results served on the "
          f"kernels, on {card}")
    worst_train = phase_train(torch, harness, counter, card)
    torch.cuda.empty_cache()
    print(f"== phase 8: head and movement pruning on the card, the pruned models served on the "
          f"kernels, on {card}")
    worst_prune = phase_prune(torch, harness, counter, fa, fm, card)
    torch.cuda.empty_cache()
    print(f"== phase 9: float16: every kernel's fp16 instance against its fp16 twin (phase 3's "
          f"bounds), the fp16 models on the card (logits within {LOGIT_REL} x max|logit|, "
          f"launch counts as bf16's), fp16 beside bf16 device p50, on {card}")
    mods = dict(fe=fe, sb=sb, sm=sm, ws=ws, fa=fa, fm=fm, ts=ts, vf=vf, pf=pf)
    errs16, ms16 = phase_kernels_f16(torch, mods, harness)
    yard16, _ = phase_yardsticks(torch, harness, torch.float16)
    launches16, worst16 = phase_slice_f16(torch, counter, mods)
    for k, v in launches16.items():
        if v == 0:
            fail(f"the fp16 instance of kernel {k} was never launched on the fp16 requests")
    torch.cuda.empty_cache()
    phase_time_f16(torch, harness, mods)
    for k, lib_name in (("linear", "torch.addmm x4"), ("attention_rows", "SDPA with a key mask"),
                        ("vit_full", "none"),
                        ("window_attention", "SDPA on gathered windows, bias + mask")):
        (kb, pb), (k16, p16) = layer_ms[k], ms16[k]
        (bb, byb, lb), (b16, by16, l16) = yard[k], yard16[k]
        print(f"  {k} row: bf16 kernel {kb:.4f} ms (twin {pb:.4f}, bound {bb:.4g} {byb}, "
              f"library {'none' if lb is None else f'{lb:.4f}'}); fp16 kernel {k16:.4f} ms "
              f"(twin {p16:.4f}, bound {b16:.4g} {by16}, library ({lib_name}) "
              f"{'none' if l16 is None else f'{l16:.4f}'}); fp16 / bf16 {k16 / kb:.3f}")
    print(f"== phase 10: ViT-B/16, Swin-T and T2T-ViT-14 imported under their published key "
          f"names and served on the kernels (logits within {LOGIT_REL} x max|logit| of the "
          f"twins), evaluate on an image folder, the CNN zoo (card vs CPU within {CNN_REL} x "
          f"max|logit|), on {card}")
    t10 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches10, worst10, vit_state = phase_imports(torch, counter, harness, base_b1_ms)
    for k in ("ln_rows", "linear", "attention_rows", "quant_rows", "linear_i8", "stage1_kqv",
              "window_attention", "swin_merge", "performer_reduce", "performer_rows"):
        if launches10[k] == 0:
            fail(f"kernel {k} was never launched on phase 10's requests")
    phase_eval(torch, harness, vit_state)
    del vit_state
    torch.cuda.empty_cache()
    worst_cnn = phase_cnn(torch, harness)
    torch.cuda.synchronize()
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s, peak device memory "
          f"{harness.device_peak_mb():.1f} MiB, worst logit deviation {worst10:.4g} of max|logit| "
          f"(imports), CNN card vs CPU {worst_cnn:.3g}; launches "
          f"{ {k: v for k, v in launches10.items() if v} }; on {card}")
    torch.cuda.empty_cache()
    launches_h, worst_h = phase_vit_huge(torch, counter, harness, base_b1_ms, fa, fm)
    for k in ("ln_rows", "linear", "attention_rows", "quant_rows", "linear_i8", "sdpa", "mlp",
              "vit_full"):
        if launches_h[k] == 0:
            fail(f"kernel {k} was never launched on ViT-H/14's requests")
    print(f"  ViT-H/14: worst logit deviation {worst_h:.4g} of max|logit|; launches "
          f"{ {k: v for k, v in launches_h.items() if v} }; on {card}")
    print(f"== phase 11: distributed training and evaluation, {PAR_WORLD} gloo ranks sharing the "
          f"card: dp x tp, GPipe and sp against one process (losses within {CPU_LOSS_RTOL} "
          f"relative, params within one fp32 spacing + {CPU_STEP_REL} of the largest update, "
          f"activations within {PAR_REL} of max|.|), evaluate_sharded on K1/K2 and K4/K5, head "
          f"importance over dp, the dryrun, on {card}")
    phase_parallel(torch, harness, card)
    torch.cuda.empty_cache()
    print(f"== phase 12: the CLI on the card (python -m edgevisiontransformer_tpu_torch.cli, run "
          f"in this process): benchmark per kernel mode beside its device p50, benchmark_train, "
          f"profile, experiments, convert / eval, export, latency_model, the loop-delta timer "
          f"against the CUDA-event timer (within {TIMER_AGREE:.0%}), on {card}")
    phase_cli(torch, harness, counter, card)
    worsts = (worst, worst8, worst_t2t, worst_swin, worst_swin8, worst_mod, worst_vm, worst_pr,
              worst_full, worst_train, worst_prune, worst16)
    print(f"build {build_s:.2f} s; worst logit deviation {max(worsts):.4g} of max|logit| (deit "
          f"bf16 {worst:.4g}, deit int8 {worst8:.4g}, t2t_vit_14 {worst_t2t:.4g}, swin_tiny bf16 "
          f"{worst_swin:.4g}, int8 {worst_swin8:.4g}, swin module pallas {worst_mod:.4g}, ViT / T2T "
          f"module pallas {worst_vm:.4g}, pruned {worst_pr:.4g}, fully fused {worst_full:.4g}, "
          f"trained and smoothed {worst_train:.4g}, pruned on the card "
          f"{worst_prune:.4g}, fp16 {worst16:.4g})")

    src = "edgevisiontransformer_tpu_torch/csrc/"
    print("kernel ms / plain_ms / bound_ms / library_ms: device time (CUDA-graph replay) of "
          "one deit_tiny b128 layer's launches of that kernel (int8 kernels: a static-int8 "
          "layer; sdpa and mlp: a kernel_mode='pallas' module layer, mlp's library call being "
          "torch.addmm + F.gelu + torch.addmm timed as one sum; stage1_kqv: one t2t_vit_14 b1 "
          "call; window_attention and swin_merge: one swin_tiny b1 forward; window_sdpa: one "
          "swin_tiny b1 kernel_mode='pallas' module forward; vit_full: one deit_tiny b128 "
          "forward; performer_reduce and performer_rows: one t2t_vit_14 b1 tokenizer's two "
          "performers); launches: the requests of phase 4; '<kernel> fp16': the kernel's fp16 "
          "instance (build.py's -DEVT_F16 object) on the same row's launches at fp16, its "
          "launches those of phase 9's fp16 requests; 'mlp wide': mlp's wide form "
          "(csrc/mlp_wide.cu, every dim above 1152) on one ViT-H/14 b1 module layer (dim "
          "1280, exact GELU), max_abs_err its phase 3 bf16 entries', launches phase 10's "
          "ViT-H/14 requests' (every mlp launch there is at dim 1280); 'sdpa long': sdpa's "
          "csrc/sdpa_long.cu (every n past res_keys) on one ViT-H/14 b1 module layer (16 "
          "heads of 80, 257 keys), max_abs_err its phase 3 bf16 entries', launches phase 10's "
          "ViT-H/14 requests' (every sdpa launch there is at 257 keys)")
    rows = [
        {"name": k, "route": "cuda", "source": f"{src}{source}", "replaces": replaces,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": layer_ms[k][0], "plain_ms": layer_ms[k][1], "bound_ms": yard[k][0],
         "bound_by": yard[k][1], "library_ms": yard[k][2]}
        for k, (source, replaces) in KERNELS.items()]
    (k1, p1), (bnd1, by1, lib1) = layer_ms["mlp ViT-H/14 b1"], vit_h_yard["mlp ViT-H/14 b1"]
    rows.append({"name": "mlp wide", "route": "cuda", "source": f"{src}mlp_wide.cu",
                 "replaces": KERNELS["mlp"][1], "launches": launches_h["mlp"],
                 "max_abs_err": errs["mlp wide"], "ms": k1, "plain_ms": p1, "bound_ms": bnd1,
                 "bound_by": by1, "library_ms": lib1})
    (k1, p1), (bnd1, by1, lib1) = layer_ms["sdpa ViT-H/14 b1"], vit_h_yard["sdpa ViT-H/14 b1"]
    rows.append({"name": "sdpa long", "route": "cuda", "source": f"{src}sdpa_long.cu",
                 "replaces": KERNELS["sdpa"][1], "launches": launches_h["sdpa"],
                 "max_abs_err": errs["sdpa long"], "ms": k1, "plain_ms": p1, "bound_ms": bnd1,
                 "bound_by": by1, "library_ms": lib1})
    rows += [
        {"name": f"{k} fp16", "route": "cuda", "source": f"{src}{source}", "replaces": replaces,
         "launches": launches16[k], "max_abs_err": errs16[k],
         "ms": ms16[k][0], "plain_ms": ms16[k][1], "bound_ms": yard16[k][0],
         "bound_by": yard16[k][1], "library_ms": yard16[k][2]}
        for k, (source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
