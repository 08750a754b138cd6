"""Smoke run of the cse_tpu_torch serving, training and trainer paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of cse_tpu_torch/csrc from the checkout; the
     ptxas report of the three wgmma kernels (the GEMM, the weight gradient,
     the int8 GEMM): no spills, no serialised wgmma; and of the two
     LayerNorm kernels redesigned last (the LN backward, the tool's staged
     LN): registers and spills of every instantiation, no spills;
  3. hold each kernel (LayerNorm, GEMM with its three epilogues, attention)
     and the whole fused stack against its plain PyTorch version at the
     serving shapes (intra G=2016 L=251, inter G=4000 L=127) in fp32 and bf16;
  4. the slice: ServingEngine, variant 'context', full width (D 256, 8 heads,
     FFN 1024, 8 layers, 2 blocks, llm_dim 4096), B=16, T=aligned_bucket(128000),
     seeded random weights, in fp32 and in bf16, held against the plain
     layer-by-layer Sepformer on the card; the launch counts of the bf16 run;
     the median forward time and realtime factor;
  5. each kernel's time beside its plain version, a library call that computes
     the same function (timed only; the port never calls it) and its bound;
     the 8-layer stack beside nn.TransformerEncoder (8 pre-LN layers and the
     final LN, bf16, its residual bf16) under inference_mode, and one
     TransformerEncoderLayer's training forward;
     each GEMM product's TB/s and TFLOP/s beside torch.matmul and the
     like-for-like torch.addmm (bias or residual in, fp32 out, where the card's
     torch takes out_dtype); the attention's launch (route, registers, local
     memory, blocks per SM; every strip instantiation must have no local
     memory); the times before this slice's redesigns, in the log only;
  6. the training kernels (attention with row stats, attention backward, weight
     gradient, ReLU-gradient GEMM, LayerNorm backward) and the whole 8-layer
     fused_stack_train forward and backward against their plain versions at
     the training shapes (intra, inter, and L=300 for the attention backward's
     two-kernel route) in fp32 and bf16; the attention backward, the
     weight gradient and the LayerNorm backward also give the same bits on a
     repeat;
  7. the training path: (a) loss and every gradient of make_loss_fn(fused=True)
     against the plain Sepformer under autograd, fp32, full width, B=2,
     T=125000; (b) 20 bf16 steps on one batch, fused against plain; (c) the
     bench recipe, make_train_step(fused=True), B=16, bf16: launch counts of
     one step against the formula, median step time, mixtures/s, peak memory,
     one step split into forward, backward and optimizer, and one step under
     torch.profiler (device time by kernel, the device's busy share); (d) each
     training kernel's time beside its plain version, a library call and its
     bound; each weight-gradient product's time and TB/s beside
     torch.matmul(a.t(), dy); the attention backward beside PyTorch's flash
     backward alone (and forward plus backward), with its launch (route,
     registers, local memory, blocks per SM; every L <= 256 instantiation must
     have no local memory); the LayerNorm backward against its bytes bound
     and F.layer_norm's backward, with g_in bf16 and fp32, its launch (path,
     grid, blocks per SM, rows a warp, registers, local memory) and every
     instantiation's registers and local memory (none may use local memory);
     the times before this slice's redesigns;
  8. the flash path (use_flash_attention=True, remat='layer'): (a) the flash
     forward and backward kernels against their plain versions at intra,
     inter (the backward's one-pass strip), L=300 and L=600 (its three
     kernels), fp32 and bf16, the bf16 backward also for the same bits on a
     repeat; (b) fp32 loss and every gradient
     of make_loss_fn(fused=False), full width, B=2, against the same model
     without flash; (c) make_train_step(fused=False), bf16, B=16: launches
     against the formula, median step time, mixtures/s, peak memory, one
     profiled step; make_eval_step(fused=False): forward time, output against
     the fused serving engine on the same weights; (d) kernel times beside
     the plain versions, SDPA (the backward beside PyTorch's flash backward
     alone, on contiguous [G, H, L, hd] tensors and on [G, L, H, hd] ones
     seen as [G, H, L, hd], and SDPA forward + backward) and the bounds, both
     kernels' times before their redesigns, and both launches' route,
     registers, local memory and resident blocks per SM (every L <= 256
     instantiation of either must have no local memory);
  9. w8a8 serving: (a) the row quantizer (bit-exact), the int8 GEMM's three
     epilogues, layer_norm_quant and ffn_w8a8 (the bits of the kernel chains
     they replace; ffn_w8a8 also against its plain version, and at the w8a8
     serving cell's six stack shapes too) and the whole
     w8a8 stack against their plain versions; (b)
     ServingEngine(quant="w8a8"), bf16, B=16, T=125000, against the plain fp32
     Sepformer: launches (228 a forward), median forward time, realtime
     factor; (c) kernel times beside the plain versions, torch._int_mm or
     SDPA, and the bounds, the int8 GEMM's time before its redesign, and
     layer_norm_quant and ffn_w8a8 beside the chains they replace, timed in
     the same run (ffn_w8a8 also at the serving cell's shapes: 10 mixtures
     of 2, 9.5 and 15.5 s, intra and inter);
 10. the kernel-parts dev tool: (a) its LayerNorm and attention kernels in
     every mode (bf16 also on the multi-pass route, at L=300; the LayerNorm
     also for the same bits on a repeat) and the whole
     stripped forward in all 8 modes against the plain
     versions, and its three products on the GEMM kernel, at the shapes of the
     tool's own run, G=1008, Lp=D=256, 2 layers, 8 heads, fp32 twin and bf16;
     (b) that run (python -m cse_tpu_torch.scripts.bench_kernel_parts at its
     defaults): launches, ms and TFLOP/s of all 8 modes, the plain version's
     time, the kernels' times beside a library call and the bounds, the
     attention's time before its redesign, and each mode's launch: route,
     registers, local memory and resident blocks per SM (every L <= 256
     instantiation must have no local memory); the LayerNorm in each mode
     against its bytes bound and its time before the redesign, with its
     launch (route, grid, registers, local memory, blocks per SM; no staged
     instantiation may use local memory);
 11. the trainer: train_net through parse_train_args, variant 'context', full
     width, --synthetic_smoke --bf16 --batch_size 16 --max_sp_len 16
     --flash_attention --remat layer with the whole augmentation chain, 9
     updates with validation and checkpoints at 4 and 8, once on the fused
     step (the card's default) and once with --no_fused_train: finite losses,
     launch counts against the formulas, checkpoint files, the loop's sustained
     mixtures/s, host-to-device bytes per batch, validation ms per batch, peak
     memory; then for each a resume from the saved step, two iterations of
     which run under the loop's own torch.profiler window (busy share, longest
     idle gap, device time of the step and of the next batch's synthesis);
 12. the tiny model (--debug_tiny_model: d_model 32, head width 8): (a) every
     kernel its trainer runs (the attention with bf16 or fp32 out and stats,
     its backward, flash forward and backward, the GEMM's epilogues at K 32,
     64, 96, the ReLU-gradient GEMM, the weight gradients) against its plain
     version at the model's own shapes, including inter L 1282 (the two-pass
     route), the attention backward, the flash backward and the weight
     gradients also for the same bits on a repeat; (b) its trainer at 16 s in fp32 on the default
     fused step, layer by layer with --flash_attention --remat layer, and
     layer by layer without either (the reference): losses before the first update and
     after each of three (lr 1e-3), held against the reference's; (c) both
     kernel paths in bf16: finite losses, the kernels launched.
 13. the eval entry point at full width (seeded random weights, every entry
     off its init value): (a) a released-form .ckpt written by
     save_torch_checkpoint and read back by restore_checkpoint and
     sepformer_from_state_dict: every state_dict entry and the bf16 fused
     forward (B=16, T=125000, cuDNN's deterministic algorithms: the decoder's
     default conv_transpose1d is not) give the same bits; (b) python -m
     cse_tpu_torch.test's main on that checkpoint over the synthetic corpus
     (--synthetic_smoke --test_model ContExt --bf16 --max_sp_len 16, batch 16,
     utterances of 8-16 s), once with --fused_eval and once with
     --flash_attention layer by layer, and once ContSep --fused_eval from random
     init: result files, n (the test set's size), finite metrics, the stack
     kernels' and the flash kernels' launches against their formulas times
     the batches, each fused batch's output against the plain fp32 model (rel
     L2 <= 5e-2); the fused run scores 256 mixtures (16 batches), the other
     two the default 6; for each, the seconds of evaluate alone (corpus, model
     and loader set-up outside), its mixtures/s, and the card's busy share of
     that window (each step's span between CUDA events, summed);
 14. python -m cse_tpu_torch.bench in subprocesses: the default, --variant
     contsep, --infer and --infer --serving_quant w8a8: one JSON line each,
     the expected metric name, a finite value > 0, printed beside [7c]'s
     mixtures/s, [4]'s and [9b]'s realtime factors of this run; the launch
     report on its standard error against the wrappers' formula times the
     steps or forwards it ran.
 15. the frozen Llama-3 context encoder (models/llama.py; no kernel of the
     port, kernels #3 and #4 beside it in the step): (a) one tiny checkout
     written here (vocab 320, hidden 64, 2 layers, 4 / 2 heads) loaded on
     the card and on the CPU: fp32, bf16, int8 and w8a8 hidden states (and
     logits) card against CPU, left-padded rows finite, a 16-row w8a8 call;
     (b) the 32-layer 8B shape on random weights in bf16, int8 and w8a8:
     weight bytes, peak memory, the bare prefill's median at B=8 x 512
     tokens beside its bound; (c) python -m cse_tpu_torch.bench --with_llm
     (int8), --llama_quant w8a8 and --ctx_sim: one JSON line each, a value
     > 0, the launch report against the formula; (d) train_net ContExt at
     paper width, B=16, on a Llama checkout at the real width (4096, 32 / 8
     heads, intermediate 14336, 2 layers) with --llama_int8: the banner says
     llm=real, finite losses, launches per update as in [7c], the sustained
     mixtures/s beside [11]'s; the native WAV decoder is in use.
 16. H-ContExt (models/ecapa.py, models/speaker_encoder.py: no kernel of the
     port; #1, #3 and #4 beside it): (a) the ECAPA-TDNN at full width (1024
     channels, 80 mels, 192-d, random weights), card against CPU with TF32
     off on B=4 rows of 1-5 s: the fbank and the embedding, the spectral
     stand-in, and crop_enrollment on the same draws (the same bits); (b) the
     ECAPA forward at the trainer's shape (B=16 x 80000, fp32), median of 5
     beside its bound, one profiled forward split by kernel kind; (c) python
     -m cse_tpu_torch.bench --variant hcontext in a subprocess beside [14]'s
     context form, its launch report against the formula; (d) train_net(...,
     'hcontext') at full width, B=16, with --ecapa_path on a speechbrain-layout
     .ckpt of random weights written here: 6 updates and a validation by the
     eval enrollment rules, finite losses, launches per update as in [7c], se
     [16, 1, 192] on the card; (e) cse_tpu_torch.test_HContExt.main
     --fused_eval for --cue joint, history and voice on DailyTalk, and on
     TEDLIUM with and without --one_sec, 16 synthetic mixtures each: files,
     n, 228 launches a batch, each batch within rel L2 5e-2 of the plain fp32
     model, the three cues three outputs, --one_sec other embeddings.
 17. the cascaded path (models/whisper.py, eval/cascaded.py, test_cascaded.py:
     no kernel of the port; #1 in the bench's separator): (a) Whisper card
     against CPU with TF32 off, on random weights at the stub widths (64, 4
     heads, 2 + 2 layers, B=2) and at base width (one 30 s window): the
     log-mel (rel L2 1e-5), the encoder and 15 teacher-forced decoder steps
     (1e-4), greedy 64-token decodes timestamped and not (the same tokens and
     lengths, sum_logprob 1e-3, no_speech_prob 1e-5), the detected language;
     (b) Whisper-base, B=2 x one 30 s window, fp32: the log-mel, the encoder
     beside its operations bound, the cross K/V, a timestamped 224-token
     decode (steps taken, ms a window and a step beside the step's bytes
     bound, launches a step from a profiled 32-token decode, the device's busy
     time), peak memory; (c) the bench's separator (ServingEngine base, bf16,
     B=1 x 128000: #1's launches by formula, rel L2 5e-2 against plain fp32),
     then python -m cse_tpu_torch.bench --cascaded and --cascaded
     --cascaded_llm in subprocesses (5 timed mixtures; one JSON line each,
     the launch report by formula); (d) cse_tpu_torch.test_cascaded.main on 4 mixtures of 4-8
     s: --synthetic_smoke (stub Whisper, stand-in scorer), and a released
     base .ckpt written here with a tiny Llama checkout's scorer: the
     results file, n, finite metrics, the stages the banner names.
 18. data parallel and the Llama's tensor parallelism (core/mesh.py, the
     sharded train step, --mesh_data, llama_shardings; no kernel of the
     port, #3 and #4 in the step), each leg in processes of its own
     (python3 chip_smoke.py --leg NAME DIR) started by tests/torch_ranks.py's
     launcher, with its own rendezvous on a free localhost port and one
     deadline for the group (a report of every rank if it fails): (a) one
     NCCL rank, ContExt bf16 at full width, B=16: three fused steps with
     make_mesh(1) against three unsharded steps on the same weights and
     batch under cuDNN's deterministic algorithms (losses and parameters
     the same bits), #3 / #4 launches a step by formula, the step timed in
     turns with the unsharded one (four each) beside [7c], the all-reduce
     alone (CUDA events) and its bytes a step; (b) two gloo ranks sharing
     the card (NCCL takes one rank a card), fp32 with TF32 off on
     [7a]'s setup, 8 rows each of one batch of 16, rank 1 built from other
     weights: three fused steps with the same losses and parameters on both
     ranks, step 1's reduced gradients against one process's B=16
     gradients (rel L2 5e-3); (c) python -m torch.distributed.run
     --nproc_per_node 1 of train_ContExt --mesh_data 1 with [11]'s flags (9
     updates at full width: validations, checkpoints, no skipped update, the
     sustained rate beside [11]'s fused run) and of bench --mesh_data 1 (its
     line beside [14]'s
     default, the launch report by formula); (d) the tiny Llama on a model
     axis of 2 (two gloo ranks) in fp32, int8 and w8a8 against the
     single-rank forward on the card (rtol = atol = 1e-4).
 19. every width: at --debug_tiny_model's widths (d_model 32, 4 heads of
     width 8, FFN 64) and the JAX suite's (d_model 16, 4 heads of width 4,
     FFN 32), B=2, T=4000, seeded weights: (a) the bf16 and w8a8 engines,
     context and contsep, against the plain fp32 model (rel L2 5e-2; launches
     by formula, the w8a8 stack on the route its widths choose: the chain of
     LN, quantizer and int8 GEMM launches) and the w8a8 stack alone against
     its plain version (rel L2 1e-3); (b) the fused step's fp32 loss and
     gradients against the plain model (5e-3), #3 / #4 launches by formula;
     (c) the flash step's the same, #5 / #6 launched; (d) the kernels at head
     width 4 (attention with bf16 and fp32 out and stats, its backward, flash
     forward and backward; strip and multi-pass routes) and the LayerNorm
     backward at D 16 and 48 against their plain versions ([12a]'s bars);
     (e) num_spks=3 at the paper's width: a contsep (ce) ServingEngine bf16
     forward at B=16 against plain fp32 (5e-2) and one fused ContSep step's
     fp32 gradients on B=2 (5e-3). Its own clock is printed.
The second-to-last lines are the kernels' JSON line and the card; the last line
is {"ok": true, "device": {...}}.

Imports nothing of JAX or of cse_tpu; needs CUDA (exits 1 without it).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# Tolerances, with their reasons.
# fp32: kernel and plain version compute the same fp32 arithmetic; only the
# summation order differs -> max|err| / max|ref| <= 1e-4.
TOL_FP32 = 1e-4
# bf16: the same values are rounded to bf16 at the same places; a different
# fp32 accumulation order flips a few roundings -> relative L2 <= 1e-2.
TOL_BF16 = 1e-2
# Serving in fp32 against the plain fp32 Sepformer: the same model, only the
# summation order differs, through 32 transformer layers -> relative L2 <= 1e-4.
TOL_SERVE_FP32 = 1e-4
# Serving in bf16 against the plain fp32 Sepformer: bf16 rounding of
# activations and weights through 32 layers; the bar is the repo's bf16-order
# serving bar (tests/test_serving.py::test_w8a8_engine_close_to_exact) ->
# relative L2 <= 5e-2.
TOL_SERVE_BF16 = 5e-2
# [13]'s fused eval scores this many synthetic mixtures (16 batches of 16): a
# test set's size, so that its mixtures/s is evaluate's rate, not its start-up
EVAL_MIXTURES = 256
# The whole 8-layer training stack, kernels against plain. Its output keeps
# the per-kernel bars. Its gradients do not: a ReLU whose input lies within
# a rounding of 0 flips its mask between two summation orders, a jump of the
# full gradient on that element, so max_rel is no measure; in fp32 the
# gradients are held at relative L2 <= 5e-3 (the training-parity bar below).
# In bf16 such flips are common, so both bf16 versions are held against the
# plain fp32 run of the same stack, and the kernels' error may exceed the
# plain version's by at most 25% (+1e-3).
TOL_STACK_GRAD_FP32 = 5e-3
STACK_GRAD_BF16_RATIO = 1.25
# Training parity, fp32, fused against the plain Sepformer (TF32 off): the
# JAX suite's fused-vs-XLA bar (tests/test_fused_train.py) -> relative L2
# <= 5e-3 for the loss and each parameter's gradient.
TOL_TRAIN_FP32 = 5e-3
# The bf16 trajectory: the JAX suite's bar -> max |fused - plain| / (1 + |plain|)
# < 5e-2 over the steps, and both curves descend.
TOL_TRAJ = 5e-2
# The int8 GEMM against its plain version on the same int8 inputs: integer
# sums are exact and the epilogue rounds step by step as the plain version
# does -> max_rel <= 1e-6.
TOL_W8A8_GEMM = 1e-6
# The whole w8a8 stack. One layer keeps the bf16 bar against the plain
# version. Through 8 layers it cannot: an LN output one ulp apart flips an
# int8 rounding by a whole step (1/127 of the row's max), attention spreads
# that to every row of the sequence, and the flips compound to about the
# bf16 bar itself. So the 8-layer kernels and plain version are both held
# against the plain stack with fp32 operands, and the kernels' error may
# exceed the plain version's by at most 25% (+1e-3), as for the bf16
# training stack.
TOL_W8A8_STACK_RATIO = 1.25
# The tiny trainer in fp32, the kernels' paths against the reference path
# (no kernel of the port): the same model, data and updates, only the
# summation order differs; four losses, before the first of three Adam
# updates and after each -> max relative difference <= 1e-3.
TOL_TINY_LOSS = 1e-3

# NVIDIA H100 SXM data sheet (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12  # int8 tensor cores, dense
HBM_BYTES_S = 3.35e12

INTRA = (2016, 251)  # B*S sequences of K + 1 tokens at B=16, T=125000
INTER = (4000, 127)  # B*K sequences of S + 1 tokens
# the w8a8 serving cell's stacks (perfbench contsep3.serve_w8a8): 10 mixtures a request, at its shortest,
# middle and longest lengths (seconds at 8 kHz)
CELL_BATCH, CELL_SECONDS = 10, (2.0, 9.5, 15.5)


def cell_shapes() -> list[tuple[str, tuple[int, int]]]:
    """(name, (G, L)) of the intra and inter stacks at CELL_SECONDS."""
    from cse_tpu_torch.ops.buckets import frames_for_samples
    from cse_tpu_torch.ops.segmentation import segment_shapes

    out = []
    for sec in CELL_SECONDS:
        S = segment_shapes(frames_for_samples(int(sec * 8000)), 250)[1]
        out += [(f"{sec:g}s intra", (CELL_BATCH * S, 251)), (f"{sec:g}s inter", (CELL_BATCH * 250, S + 1))]
    return out
# the multi-pass kernels' times before the one-pass redesign, printed beside the new ones
# (PERF.md section 6, rows 5 and 7b; NVIDIA H100 80GB HBM3, 700 W)
FLASH_FWD_EARLIER_MS = {"intra": 4.238, "inter": 1.626}
KP_ATTENTION_EARLIER_MS = 1.750
# the mma.sync GEMM and the two-pass attention before their redesign, printed beside the new
# ones (PERF.md section 6, rows 1b, 4b, 4c, 7c and 1c, 2c, 4f; NVIDIA H100 80GB HBM3, 700 W)
LINEAR_EARLIER_MS = {"linear": (4.563, 4.578), "linear_relu_grad": (2.047, 2.095), "linear[dgrad]": (2.389, 2.419),
                     "linear[kernel_parts]": 2.023}
ATTENTION_EARLIER_MS = {"attention": (1.789, 1.110), "attention[w8a8]": (1.658, 1.068),
                        "attention[train]": (1.679, 1.106)}
# the weight gradient, the attention backward and the LayerNorm backward before their redesign
# (PERF.md section 6, rows 4a, 4e and 4d; NVIDIA H100 80GB HBM3, 700 W)
TRAIN_EARLIER_MS = {"weight_grad": (2.614, 2.618), "attention_backward": (6.161, 3.789),
                    "layer_norm_backward": (1.088, 1.096)}
# flash_bwd's three kernels and the mma.sync int8 GEMM before their redesign (PERF.md section 6,
# rows 6 and 2b; NVIDIA H100 80GB HBM3, 700 W)
FLASH_BWD_EARLIER_MS = {"intra": 4.984, "inter": 2.797}
LINEAR_W8A8_EARLIER_MS = {"intra": 3.276, "inter": 3.316}
# the tool's LayerNorm by mode before its redesign (PERF.md section 6, row 7a; NVIDIA H100 80GB
# HBM3, 700 W)
KP_LN_EARLIER_MS = {"none": 0.1341, "centred": 0.1333, "cd": 0.3522, "exact": 0.2988, "x2": 0.2848}
# the kernels' symbols in the kernels line
GEMM_SYMBOL = "linear_bf16_kernel<EPI> (wgmma + TMA, persistent, warp-specialised)"
ATTENTION_SYMBOL = ("attention_strip_bf16_kernel<{}, 32, 16 or 8> (L <= 256); "
                    "attention_bf16_kernel<{}, 32> (L > 256)")
WGRAD_SYMBOL = "wgrad_bf16_kernel<NG> (wgmma + TMA, persistent, warp-specialised) + sum_rows_kernel"
FLASH_BWD_SYMBOL = ("flash_bwd_strip_bf16_kernel<32, 16 or 8> (L <= 256); flash_delta_kernel + "
                    "flash_bwd_dq_bf16_kernel<32> + flash_bwd_dkdv_bf16_kernel<32> (L > 256)")
W8A8_SYMBOL = "linear_w8a8_kernel<EPI, NG> (wgmma s8 + TMA, persistent, warp-specialised)"
ATTENTION_BWD_SYMBOL = ("attention_bwd_strip_bf16_kernel<32, 16 or 8> (L <= 256); attention_bwd_dq_bf16_kernel<32> + "
                        "attention_bwd_dkdv_bf16_kernel<32> (L > 256); + sum_rows_kernel")
LN_BWD_SYMBOL = ("layer_norm_bwd_kernel<2, TG, TO> (persistent, tiles of 8 rows through a ring of bulk copies) + "
                 "sum_rows_kernel")
KP_LN_SYMBOL = ("kp_ln_rows_kernel (modes none, centred); kp_ln_staged_kernel<mode, 16> (bf16 cd, exact, x2: "
                "persistent, tiles of 32 rows staged by bulk copies)")
REPLACES = "cse_tpu/ops/fused_stack.py:79"  # _stack_kernel
SOURCE = "cse_tpu_torch/csrc/fused_stack.cu"
REPLACES_FWD = "cse_tpu/ops/fused_train.py:157"  # _fwd_kernel
REPLACES_BWD = "cse_tpu/ops/fused_train.py:168"  # _bwd_kernel
SOURCE_TRAIN = "cse_tpu_torch/csrc/fused_train.cu"
REPLACES_FLASH_FWD = "cse_tpu/ops/attention.py:38"  # _fwd_kernel
REPLACES_FLASH_BWD = "cse_tpu/ops/attention.py:59"  # _bwd_kernel
SOURCE_FLASH = "cse_tpu_torch/csrc/attention.cu"
REPLACES_W8A8 = "cse_tpu/ops/fused_stack.py:130"  # _stack_kernel_w8a8
SOURCE_W8A8 = "cse_tpu_torch/csrc/fused_stack_w8a8.cu"
REPLACES_PARTS = "scripts/bench_kernel_parts.py:25"  # make_kernel
SOURCE_PARTS = "cse_tpu_torch/csrc/kernel_parts.cu"
# the kernel-parts modes whose softmax sum goes through jmat = 1/D: their
# output is D x the softmax's, so they are held by relative L2 in fp32 too
PARTS_QUIRK = ("softmax_matmul", "combined", "combined_x2")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def errs(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(max abs err, max abs err / max |ref|, relative L2)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs().max().item()
    return d, d / max(r.abs().max().item(), 1e-30), (
        torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r).clamp_min(1e-30)
    ).item()


def check(name: str, got: torch.Tensor, ref: torch.Tensor, cd: torch.dtype, failures: list,
          tol_bf16: float = TOL_BF16) -> float:
    if not torch.isfinite(got.float()).all():
        failures.append(f"{name}: non-finite output")
    mx, rmax, rl2 = errs(got, ref)
    ok = rmax <= TOL_FP32 if cd == torch.float32 else rl2 <= tol_bf16
    log(f"  {name:<44s} max_abs {mx:.3e}  max_rel {rmax:.3e}  rel_l2 {rl2:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return mx


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def addmm_like(a, w, bias, epi, res=None):
    """One PyTorch call for the same GEMM with its bias or residual, the
    like-for-like yardstick beside torch.matmul: torch.addmm with an fp32
    output (bias, or the residual, as its input) for the fp32 epilogues, bf16
    addmm (without the ReLU) for the ReLU one."""
    if epi == "relu":
        return lambda: torch.addmm(bias.to(a.dtype), a, w)
    inp = res if epi == "residual" else bias
    return lambda: torch.addmm(inp, a, w, out_dtype=torch.float32)


def time_like(fn):
    """fn's time, or None where the card's torch refuses the call (an older
    addmm has no out_dtype)."""
    try:
        fn()
        torch.cuda.synchronize()
    except (TypeError, RuntimeError):
        return None
    return time_ms(fn)


def sdpa_backward_ms(q, k, v, do):
    """PyTorch's flash-attention backward alone, the like-for-like yardstick of
    a backward kernel: o and logsumexp from one forward made outside the timed
    region, on the same bf16 q, k, v [G, H, L, hd] and dO; None where the
    card's torch refuses the call."""
    try:
        o, lse, cq, ck, mq, mk, seed, off = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)[:8]
    except (TypeError, RuntimeError):
        return None
    return time_like(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, False, seed, off))


def sum_or_none(xs):
    return None if any(x is None for x in xs) else sum(xs)


def fmt_ms(x):
    return "n/a" if x is None else f"{x:.4f} ms"


def attention_launches():
    """The bf16 attention's launch at every strip instantiation (L 128, 256)
    and head width, both outputs: local-memory bytes a thread (must be 0)."""
    from cse_tpu_torch.ops import fused_stack as fs

    return {f"L={L} hd={h} {'bf16' if od == torch.bfloat16 else 'fp32'} out":
            fs.attention_info(L, h, od)["local_bytes"]
            for L in (128, 256) for h in fs.HEAD_WIDTHS for od in (torch.bfloat16, torch.float32)}


def attention_backward_launches():
    """The bf16 attention backward's strip launch at every instantiation (L 128,
    256) and head width: local-memory bytes a thread (must be 0)."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft

    return {f"L={L} hd={h}": ft.attention_backward_info(L, h)["local_bytes"] for L in (128, 256) for h in fs.HEAD_WIDTHS}


def flash_backward_launches():
    """The bf16 flash backward's strip launch at every instantiation (L 128,
    256) and head width: local-memory bytes a thread (must be 0)."""
    from cse_tpu_torch.ops import attention as at

    return {f"L={L} dh={dh}": at.flash_bwd_info(L, dh)["local_bytes"] for L in (128, 256) for dh in at.HEAD_WIDTHS}


def ptxas_of(report: str, kernel: str) -> dict:
    """Each instantiation of ``kernel`` in an ``-Xptxas -v`` report: its
    registers, spill bytes and any warning ptxas gave for it (such as wgmma
    serialised)."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?$", line.strip())
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                out.setdefault(cur, {"registers": None, "spill_bytes": 0, "warnings": []})
            continue
        if cur is None:
            continue
        if "warning" in line.lower():
            out[cur]["warnings"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def random_stack(D, F_, n_layers, cd, gen):
    """Stacked weights as ``stack_weights`` makes them, from ``gen``."""
    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=gen) * scale
    mats = {"qkv_w": (D, 3 * D), "out_w": (D, D), "f1_w": (D, F_), "f2_w": (F_, D)}
    w = {k: r(n_layers, *s, scale=1 / math.sqrt(s[0])).to(cd).contiguous() for k, s in mats.items()}
    for k, n in (("qkv_b", 3 * D), ("out_b", D), ("f1_b", F_), ("f2_b", D), ("ln1_b", D), ("ln2_b", D)):
        w[k] = (0.1 * r(n_layers, n)).to(cd).float().contiguous()
    for k in ("ln1_s", "ln2_s"):
        w[k] = (1 + 0.1 * r(n_layers, D)).to(cd).float().contiguous()
    w["fn_s"] = (1 + 0.1 * r(D)).to(cd).float().contiguous()
    w["fn_b"] = (0.1 * r(D)).to(cd).float().contiguous()
    return w


def stack_module(n_layers, gen):
    """A full-width TransformerStack on the card with seeded random weights,
    biases and LN parameters (none at their init values)."""
    from cse_tpu_torch.models.sepformer import SepformerConfig, TransformerStack

    stack = TransformerStack(SepformerConfig(num_tf_layers=n_layers)).cuda()
    with torch.no_grad():
        for name, p in stack.named_parameters():
            if p.ndim == 2:
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) / math.sqrt(p.shape[1]))
            else:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, device="cuda", generator=gen))
    return stack


def stack_grads(stack, x, gy, cd, ops):
    """y and the gradients (x and every parameter) of fused_stack_train."""
    from cse_tpu_torch.ops import fused_train as ft

    stack.zero_grad(set_to_none=True)
    xg = x.detach().clone().requires_grad_(True)
    y = ft.fused_stack_train(xg, stack, nhead=8, compute_dtype=cd, ops=ops)
    y.backward(gy)
    grads = {"x": xg.grad}
    for k, p in stack.named_parameters():
        grads[k] = ft.qv_part(p.grad) if k.endswith("in_proj.bias") else p.grad
    return y.detach(), grads


def same_bits(name, first, again, failures):
    """A repeat call's outputs against the first call's: fixed-order sums give the same bits."""
    ok = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"  {name + ' repeat':<44s} {'same bits' if ok else 'FAIL: other bits'}")
    if not ok:
        failures.append(f"{name}: a repeat gives other bits")


def phase6(gen, failures, H, F_, NL):
    """Training kernels and the whole training stack against their plain versions."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft

    D = 256
    log("[6] training kernels vs plain versions (fp32: max_rel <= %.0e; bf16: rel_l2 <= %.0e; whole-stack "
        "gradients: fp32 rel_l2 <= %.0e, bf16 error vs fp32 <= %.2fx plain's + 1e-3)"
        % (TOL_FP32, TOL_BF16, TOL_STACK_GRAD_FP32, STACK_GRAD_BF16_RATIO))
    err = dict.fromkeys(("attention_stats", "attention_backward", "weight_grad", "linear_relu_grad",
                         "layer_norm_backward", "fused_stack_train"), 0.0)
    for cd in (torch.float32, torch.bfloat16):
        tag = "fp32" if cd == torch.float32 else "bf16"
        for shape_name, (G, L) in (("intra", INTRA), ("inter", INTER), ("L=300", (64, 300))):
            M = G * L
            qkv = 2 * torch.randn(M, 3 * D, device="cuda", generator=gen)
            sk, sp = (torch.empty(2, M, H, device="cuda") for _ in range(2))
            e = check(f"attention+stats {tag} {shape_name} out", fs.attention(qkv, L, H, cd, sk),
                      fs.attention_plain(qkv, L, H, cd, sp), cd, failures)
            e = max(e, check(f"attention+stats {tag} {shape_name} stats", sk, sp, torch.float32, failures))
            err["attention_stats"] = max(err["attention_stats"], e)
            dattn = torch.randn(M, D, device="cuda", generator=gen)
            got, gb = ft.attention_backward(qkv, dattn, sp, L, H, cd)
            want, wb = ft.attention_backward_plain(qkv, dattn, sp, L, H, cd)
            e = check(f"attention_backward {tag} {shape_name} G={G} L={L} dqkv", got, want, cd, failures)
            e = max(e, check(f"attention_backward {tag} {shape_name} dbias (q, v)", ft.qv_part(gb),
                             ft.qv_part(wb), cd, failures))
            same_bits(f"attention_backward {tag} {shape_name}", (got, gb),
                      ft.attention_backward(qkv, dattn, sp, L, H, cd), failures)
            err["attention_backward"] = max(err["attention_backward"], e)
            del qkv, sk, sp, dattn, got, want
            if shape_name == "L=300":
                continue
            for K, N in ((D, 3 * D), (D, D), (D, F_), (F_, D)):
                a = torch.randn(M, K, device="cuda", generator=gen).to(cd)
                dy = torch.randn(M, N, device="cuda", generator=gen).to(cd)
                got = ft.weight_grad(a, dy)
                e = check(f"weight_grad {tag} {shape_name} [{M},{K}]^T x [{M},{N}]", got,
                          ft.weight_grad_plain(a, dy), cd, failures)
                same_bits(f"weight_grad {tag} {shape_name} [{M},{K}]^T x [{M},{N}]", (got,),
                          (ft.weight_grad(a, dy),), failures)
                err["weight_grad"] = max(err["weight_grad"], e)
                del a, dy, got
            dy = torch.randn(M, D, device="cuda", generator=gen).to(cd)
            wt = (torch.randn(D, F_, device="cuda", generator=gen) / math.sqrt(D)).to(cd)
            mask = torch.relu(torch.randn(M, F_, device="cuda", generator=gen)).to(cd)
            (o, cs), (ro, rcs) = ft.linear_relu_grad(dy, wt, mask), ft.linear_relu_grad_plain(dy, wt, mask)
            e = check(f"linear_relu_grad {tag} {shape_name} [{M},{D}]x[{D},{F_}]", o, ro, cd, failures)
            e = max(e, check(f"linear_relu_grad {tag} {shape_name} colsum", cs, rcs, cd, failures))
            err["linear_relu_grad"] = max(err["linear_relu_grad"], e)
            del dy, wt, mask, o, ro
            x = 3 * torch.randn(M, D, device="cuda", generator=gen)
            dh = torch.randn(M, D, device="cuda", generator=gen)
            sc = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
            g = torch.randn(M, D, device="cuda", generator=gen).to(cd)
            k32, kcd, ks = ft.layer_norm_backward(dh, x, sc, g, torch.empty(M, D, device="cuda"), cd)
            p32, pcd, ps = ft.layer_norm_backward_plain(dh, x, sc, g, torch.empty(M, D, device="cuda"), cd)
            e = max(check(f"layer_norm_backward {tag} {shape_name} g_out fp32", k32, p32, torch.float32, failures),
                    check(f"layer_norm_backward {tag} {shape_name} g_out {tag}", kcd, pcd, cd, failures),
                    check(f"layer_norm_backward {tag} {shape_name} sums", ks, ps, torch.float32, failures))
            err["layer_norm_backward"] = max(err["layer_norm_backward"], e)
            same_bits(f"layer_norm_backward {tag} {shape_name}", (k32, kcd, ks),
                      ft.layer_norm_backward(dh, x, sc, g, torch.empty(M, D, device="cuda"), cd), failures)
            del x, dh, g, k32, kcd, p32, pcd
            stack = stack_module(NL, gen)
            xs = torch.randn(G, L, D, device="cuda", generator=gen)
            gy = torch.randn(G, L, D, device="cuda", generator=gen)
            yk, gk = stack_grads(stack, xs, gy, cd, None)
            yp, gp = stack_grads(stack, xs, gy, cd, ft.PLAIN_OPS)
            e = check(f"fused_stack_train {tag} {shape_name} {NL} layers: y", yk, yp, cd, failures)
            name = f"fused_stack_train {tag} {shape_name} grads"
            if cd == torch.float32:
                rl = {k: errs(gk[k], gp[k])[2] for k in gp}
                worst = max(rl, key=rl.get)
                bad = [k for k, v in rl.items() if not v <= TOL_STACK_GRAD_FP32]
                log(f"  {name}: {len(rl)} tensors, dx rel_l2 {rl['x']:.3e}, worst {worst} {rl[worst]:.3e}  "
                    f"{'ok' if not bad else 'FAIL'}")
            else:
                _, gr = stack_grads(stack, xs, gy, torch.float32, ft.PLAIN_OPS)
                ek = {k: errs(gk[k], gr[k])[2] for k in gr}
                ep = {k: errs(gp[k], gr[k])[2] for k in gr}
                bad = [k for k in gr if not ek[k] <= STACK_GRAD_BF16_RATIO * ep[k] + 1e-3]
                worst = max(gr, key=lambda k: ek[k] / max(ep[k], 1e-30))
                log(f"  {name} vs the plain fp32 run: dx kernels {ek['x']:.3e} plain {ep['x']:.3e}; worst ratio "
                    f"{worst} kernels {ek[worst]:.3e} plain {ep[worst]:.3e}; kernels vs plain bf16 dx rel_l2 "
                    f"{errs(gk['x'], gp['x'])[2]:.3e}  {'ok' if not bad else 'FAIL'}")
                del gr
            failures.extend(f"{name}: {k}" for k in bad)
            err["fused_stack_train"] = max(err["fused_stack_train"], e, errs(gk["x"], gp["x"])[0])
            del stack, xs, gy, yk, gk, yp, gp
            torch.cuda.empty_cache()
    if failures:
        fail(f"training kernel checks failed: {failures}")
    return err


def phase7_parity(gen, failures):
    """(a) fp32 loss and gradients, fused against the plain Sepformer; (b) the
    bf16 trajectory."""
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_loss_fn, make_train_step

    B, T = 2, aligned_bucket(128000)
    log(f"[7a] training parity, fp32, full width, B={B}, T={T}: make_loss_fn(fused=True) vs the plain "
        f"Sepformer under autograd (rel_l2 <= {TOL_TRAIN_FP32:.0e})")
    mix = torch.randn(B, T, device="cuda", generator=gen)
    ctx = torch.randn(B, 1, 4096, device="cuda", generator=gen)
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.float32)
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        est0 = model(mix, ctx)[:, :, 0]
    # gt = the model's own estimate plus noise: SI-SNR near +6 dB, so the loss
    # is not a near-cancellation that magnifies summation-order differences
    gt = est0 + 0.5 * est0.std() * torch.randn(B, T, device="cuda", generator=gen)
    batch = {"mixed": mix, "gt": gt, "ctx_feat": ctx}
    res = {}
    for fused in (True, False):
        model.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(model, TrainConfig(variant="context"), fused=fused)(batch)
        loss.backward()
        grads = {k: (ft.qv_part(p.grad) if k.endswith("in_proj.bias") else p.grad).clone()
                 for k, p in model.named_parameters()}
        res[fused] = (loss.item(), grads)
        torch.cuda.empty_cache()
    (lf, gf), (lp, gp) = res[True], res[False]
    rl = abs(lf - lp) / abs(lp)
    log(f"  loss fused {lf:.6f} plain {lp:.6f} rel {rl:.3e}")
    if rl > TOL_TRAIN_FP32:
        failures.append("train parity loss")
    worst = sorted(((errs(gf[k], gp[k])[2], k) for k in gp), reverse=True)
    for r, k in worst[:5]:
        log(f"  grad {k:<62s} rel_l2 {r:.3e}")
    bad = [k for r, k in worst if not r <= TOL_TRAIN_FP32]
    log(f"  {len(gp)} gradients, worst rel_l2 {worst[0][0]:.3e}: {'ok' if not bad else 'FAIL ' + str(bad)}")
    failures.extend(f"train parity grad {k}" for k in bad)
    del model, res, gf, gp, est0
    torch.cuda.empty_cache()

    n_steps = 20
    log(f"[7b] bf16 trajectory, {n_steps} steps on one batch (B={B}), fused vs plain "
        f"(max dev < {TOL_TRAJ:.0e}, both descend)")
    # gt again from the initial model's own fp32 estimate: against a random gt
    # at T=125000 the SI-SNR sits near -50 dB, where bf16 roundings alone move
    # the loss by tenths of a dB
    with torch.no_grad():
        est0 = Sepformer(cfg, generator=torch.Generator().manual_seed(2)).cuda()(mix, ctx)[:, :, 0]
    gt = est0 + 0.5 * est0.std() * torch.randn(B, T, device="cuda", generator=gen)
    batch = {"mixed": mix, "gt": gt, "ctx_feat": ctx}
    del est0
    curves = {}
    for fused in (True, False):
        cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16)
        model = Sepformer(cfg, generator=torch.Generator().manual_seed(2))
        step = make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 1000, 5)),
                               TrainConfig(variant="context"), fused=fused)
        curves[fused] = [step(batch)["loss"] for _ in range(n_steps)]
        del model, step
        torch.cuda.empty_cache()
    fus, pla = curves[True], curves[False]
    dev = max(abs(f - p) / (1 + abs(p)) for f, p in zip(fus, pla))
    desc = all(sum(c[-5:]) < sum(c[:5]) for c in (fus, pla))
    log(f"  fused {[round(v, 4) for v in fus]}")
    log(f"  plain {[round(v, 4) for v in pla]}")
    log(f"  max dev {dev:.3e}; both descend: {desc}  {'ok' if dev < TOL_TRAJ and desc else 'FAIL'}")
    if not (dev < TOL_TRAJ and desc):
        failures.append("bf16 trajectory")
    if failures:
        fail(f"training checks failed: {failures}")


def profile_step(step, batch):
    """One train step under torch.profiler: device time by kernel name, and
    the kernels' summed time over the step's wall time (the busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - h0)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            agg = by_name.setdefault(e.name, [0, 0.0])
            agg[0] += 1
            agg[1] += us
    busy = sum(v[1] for v in by_name.values())
    log(f"  profiled step: wall {wall_us / 1e3:.3f} ms, kernels {busy / 1e3:.3f} ms, busy share "
        f"{busy / wall_us:.4f}; device time by kernel:")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:30]:
        log(f"    {us / 1e3:10.3f} ms {n:6d}x  {name[:110]}")
    return {"wall_ms": wall_us / 1e3, "kernel_ms": busy / 1e3,
            "by_kernel_ms": {k: v[1] / 1e3 for k, v in by_name.items()}}


def phase7_bench(gen, card):
    """(c) the bench recipe through make_train_step: launches, step time, memory."""
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_loss_fn, make_train_step

    B, T = 16, aligned_bucket(128000)
    log(f"[7c] bench recipe: make_train_step(fused=True), ContExt full width, bf16, B={B}, T={T} [{card}]")
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16)
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(0))
    opt = build_optimizer(cosine_warmup_schedule(1.5e-4, 500000, 10000))
    step = make_train_step(model, opt, TrainConfig(variant="context"), fused=True)
    batch = {"mixed": torch.randn(B, T, device="cuda", generator=gen),
             "gt": torch.randn(B, T, device="cuda", generator=gen),
             "ctx_feat": torch.randn(B, 1, 4096, device="cuda", generator=gen)}
    ft.reset_launches()
    m = step(batch)
    torch.cuda.synchronize()
    counts = ft.launch_counts()
    per_stack = ft.launches_per_train_stack(cfg.num_tf_layers)
    want = {k: v * 2 * cfg.num_dp_layers for k, v in per_stack.items()}
    log(f"  launches in one step: {counts} (want {want}, total {sum(want.values())})")
    if counts != want:
        fail(f"train launch counts {counts} != {want}")
    if not math.isfinite(m["loss"]):
        fail(f"non-finite loss {m}")
    step(batch)  # second warmup
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(5):
        t_s, t_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        t_s.record()
        m = step(batch)
        t_e.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - h0))
        times.append(t_s.elapsed_time(t_e))
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    log(f"  step: median {step_ms:.3f} ms over 5 ({[round(t, 3) for t in times]}; host clock "
        f"{[round(t, 3) for t in host]}); {B / (step_ms / 1e3):.3f} mixtures/s; peak memory "
        f"{peak / 2**30:.3f} GiB; loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f}  [{card}]")
    # one step split into forward (loss), backward and optimizer, by CUDA events
    loss_fn = make_loss_fn(model, TrainConfig(variant="context"), fused=True)
    params = list(model.parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in params:
        p.grad = None
    ev[0].record()
    loss, _ = loss_fn(batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step(params, [p.grad for p in params], step.opt_state)
    ev[3].record()
    torch.cuda.synchronize()
    split = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(("forward", "backward", "optimizer"))}
    log(f"  one step split: " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    prof = profile_step(step, batch)
    del model, step, batch, loss, loss_fn, params
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_times_ms": times, "host_ms": host, "mixtures_per_s": B / (step_ms / 1e3),
            "peak_bytes": peak, "split_ms": split, "launches": counts, "profile": prof}


def phase7_times(gen, card, H, F_, NL, ln_ptxas):
    """(d) each training kernel's time, plain time, library time and bound (bf16)."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft

    D, cd, hd = 256, torch.bfloat16, 32
    log(f"[7d] training kernel times, bf16 [{card}]")

    def bound(nbytes, flops):
        tb, to = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / PEAK_BF16
        return dict(bound_ms=max(tb, to), bound_by="operations" if to >= tb else "bytes")

    times = {}
    for shape_name, (G, L) in (("intra", INTRA), ("inter", INTER)):
        M = G * L
        t = {}
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        stats = torch.empty(2, M, H, device="cuda")
        att_flops = 4 * G * H * L * L * hd
        dattn = torch.randn(M, D, device="cuda", generator=gen)
        q, k, v = (x.to(cd).detach().requires_grad_(True)
                   for x in qkv.reshape(G, L, 3, H, hd).permute(2, 0, 3, 1, 4))
        # the library call that also returns each row's softmax statistics (o and logsumexp), on
        # bf16 q, k, v already split by head; None where the card's torch refuses it
        t["attention[train]"] = dict(
            ms=time_ms(lambda: fs.attention(qkv, L, H, cd, stats)),
            plain_ms=time_ms(lambda: fs.attention_plain(qkv, L, H, cd, stats), reps=3),
            library_ms=time_like(lambda: torch.ops.aten._scaled_dot_product_flash_attention(q.detach(), k.detach(),
                                                                                             v.detach())),
            launch=fs.attention_info(L, hd),
            **bound(M * 3 * D * 4 + M * D * 2 + 2 * M * H * 4, att_flops))
        do = dattn.reshape(G, L, H, hd).transpose(1, 2).to(cd)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(q, k, v)
                torch.autograd.grad(o, (q, k, v), do)

        # library_ms: PyTorch's flash backward alone; library_fwd_bwd_ms: SDPA forward + backward
        t["attention_backward"] = dict(
            ms=time_ms(lambda: ft.attention_backward(qkv, dattn, stats, L, H, cd)),
            plain_ms=time_ms(lambda: ft.attention_backward_plain(qkv, dattn, stats, L, H, cd), reps=3),
            library_ms=sdpa_backward_ms(q.detach(), k.detach(), v.detach(), do),
            library_fwd_bwd_ms=time_ms(sdpa_fwd_bwd), launch=ft.attention_backward_info(L, hd),
            **bound(M * 3 * D * 4 + M * D * 4 + 2 * M * H * 4 + M * 3 * D * 2 + 3 * D * 4,
                    5 * 2 * G * H * L * L * hd))
        del qkv, stats, dattn, q, k, v, do
        wshapes = ((D, 3 * D), (D, D), (D, F_), (F_, D))
        ops_ = [(torch.randn(M, K, device="cuda", generator=gen).to(cd),
                 torch.randn(M, N, device="cuda", generator=gen).to(cd)) for K, N in wshapes]
        part_ms = [time_ms(lambda o=o: ft.weight_grad(*o)) for o in ops_]
        for (K, N), ms, o in zip(wshapes, part_ms, ops_):
            nbytes = M * K * 2 + M * N * 2 + K * N * 4
            log(f"  {shape_name} weight_grad [{M},{K}]^T x [{M},{N}] kernel {ms:.4f} ms  {nbytes / ms / 1e9:.3f} TB/s  "
                f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s  bytes bound {1e3 * nbytes / HBM_BYTES_S:.4f} ms  "
                f"torch.matmul(a.t(), dy) {time_ms(lambda o=o: torch.matmul(o[0].t(), o[1])):.4f} ms")
        t["weight_grad"] = dict(
            ms=sum(part_ms),
            plain_ms=time_ms(lambda: [ft.weight_grad_plain(*o) for o in ops_], reps=3),
            library_ms=time_ms(lambda: [torch.matmul(a.t(), dy) for a, dy in ops_]),
            **bound(sum(M * K * 2 + M * N * 2 + K * N * 4 for K, N in wshapes),
                    sum(2 * M * K * N for K, N in wshapes)))
        del ops_
        # the backward's three bias-free dX GEMMs on the serving GEMM kernel (fp32 out)
        dshapes = ((D, D), (F_, D), (3 * D, D))
        ops_ = [(torch.randn(M, K, device="cuda", generator=gen).to(cd),
                 (torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)).to(cd),
                 torch.zeros(N, device="cuda")) for K, N in dshapes]
        part_ms = [time_ms(lambda o=o: fs.linear(*o, "bias")) for o in ops_]
        like_ms = [time_like(addmm_like(*o, "bias")) for o in ops_]
        for (K, N), ms, like, o in zip(dshapes, part_ms, like_ms, ops_):
            nbytes = M * K * 2 + K * N * 2 + N * 4 + M * N * 4
            log(f"  {shape_name} linear[dgrad] [{M},{K}]x[{K},{N}] kernel {ms:.4f} ms  {nbytes / ms / 1e9:.3f} TB/s  "
                f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s  bytes bound {1e3 * nbytes / HBM_BYTES_S:.4f} ms  "
                f"torch.matmul {time_ms(lambda o=o: torch.matmul(o[0], o[1])):.4f} ms  addmm {fmt_ms(like)}")
        t["linear[dgrad]"] = dict(
            ms=sum(part_ms), library_like_ms=sum_or_none(like_ms),
            plain_ms=time_ms(lambda: [fs.linear_plain(*o, "bias") for o in ops_], reps=3),
            library_ms=time_ms(lambda: [torch.matmul(a, w) for a, w, _ in ops_]),
            **bound(sum(M * K * 2 + K * N * 2 + N * 4 + M * N * 4 for K, N in dshapes),
                    sum(2 * M * K * N for K, N in dshapes)))
        del ops_
        dy = torch.randn(M, D, device="cuda", generator=gen).to(cd)
        wt = (torch.randn(D, F_, device="cuda", generator=gen) / math.sqrt(D)).to(cd)
        mask = torch.relu(torch.randn(M, F_, device="cuda", generator=gen)).to(cd)
        nbytes = M * D * 2 + D * F_ * 2 + 2 * M * F_ * 2 + F_ * 4
        t["linear_relu_grad"] = dict(
            ms=time_ms(lambda: ft.linear_relu_grad(dy, wt, mask)),
            plain_ms=time_ms(lambda: ft.linear_relu_grad_plain(dy, wt, mask), reps=3),
            library_ms=time_ms(lambda: torch.matmul(dy, wt)),
            **bound(M * D * 2 + D * F_ * 2 + 2 * M * F_ * 2 + F_ * 4, 2 * M * D * F_))
        del dy, wt, mask
        x = torch.randn(M, D, device="cuda", generator=gen)
        dh = torch.randn(M, D, device="cuda", generator=gen)
        sc, g = torch.ones(D, device="cuda"), torch.randn(M, D, device="cuda", generator=gen).to(cd)
        out32 = torch.empty(M, D, device="cuda")
        xr, wr, br = (x.clone().requires_grad_(True), torch.ones(D, device="cuda", requires_grad=True),
                      torch.zeros(D, device="cuda", requires_grad=True))
        with torch.enable_grad():
            y_ln = F.layer_norm(xr, (D,), wr, br, 1e-6)
        # g_in bf16 in, g_out fp32 and bf16 out: 16 bytes an element (the last layer's LN2 call)
        t["layer_norm_backward"] = dict(
            ms=time_ms(lambda: ft.layer_norm_backward(dh, x, sc, g, out32, cd)),
            plain_ms=time_ms(lambda: ft.layer_norm_backward_plain(dh, x, sc, g, out32, cd), reps=3),
            library_ms=time_ms(lambda: torch.autograd.grad(y_ln, (xr, wr, br), dh, retain_graph=True)),
            launch=ft.layer_norm_backward_info(M, D, g.dtype, cd),
            **bound(M * D * (4 + 4 + 2 + 4 + 2) + D * 4 + 4 * D * 4, 0))
        # the other layers' LN2 call: g_in fp32, 18 bytes an element
        g32 = g.float()
        ln18 = dict(ms=time_ms(lambda: ft.layer_norm_backward(dh, x, sc, g32, out32, cd)),
                    **bound(M * D * (4 + 4 + 4 + 4 + 2) + D * 4 + 4 * D * 4, 0))
        t["layer_norm_backward"]["g_in_fp32"] = ln18
        lb = t["layer_norm_backward"]
        log(f"  {shape_name} layer_norm_backward kernel {lb['ms']:.4f} ms ({lb['bound_ms'] / lb['ms']:.1%} of its "
            f"bytes bound {lb['bound_ms']:.4f} ms), F.layer_norm backward {lb['library_ms']:.4f} ms; g_in fp32 "
            f"{ln18['ms']:.4f} ms (bound {ln18['bound_ms']:.4f} ms)")
        ln_launch = lb["launch"]
        log(f"  {shape_name} layer_norm_backward launch: path {ln_launch['path']}, grid {ln_launch['grid']} = "
            f"{ln_launch['blocks_per_sm']} blocks of {ln_launch['threads']} threads per SM, at most "
            f"{ln_launch['rows_per_warp']} rows a warp, {ln_launch['smem_bytes']} B shared, "
            f"{ln_launch['registers']} registers and {ln_launch['local_bytes']} B local memory a thread")
        del x, dh, g, g32, out32, xr, y_ln
        stack = stack_module(NL, gen)
        xs = torch.randn(G, L, D, device="cuda", generator=gen)
        gy = torch.randn(G, L, D, device="cuda", generator=gen)
        lin_flops = 2 * M * D * (3 * D + D + 2 * F_)
        t["fused_stack_train"] = dict(
            ms=time_ms(lambda: stack_grads(stack, xs, gy, cd, None), reps=3, warmup=1),
            plain_ms=time_ms(lambda: stack_grads(stack, xs, gy, cd, ft.PLAIN_OPS), reps=2, warmup=1),
            library_ms=None, **bound(0, NL * (4 * lin_flops + 4 * att_flops)))
        del stack, xs, gy
        torch.cuda.empty_cache()
        times[shape_name] = t
        for kname, v in t.items():
            lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
            log(f"  {shape_name} G={G} L={L} {kname:<20s} kernel {v['ms']:.4f} ms  plain {v['plain_ms']:.4f} ms  "
                f"library {lib}  bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
                + (f"  addmm {fmt_ms(v['library_like_ms'])}" if "library_like_ms" in v else ""))
        rg = t["linear_relu_grad"]
        log(f"  {shape_name} linear_relu_grad {nbytes / rg['ms'] / 1e9:.3f} TB/s  "
            f"{2 * M * D * F_ / rg['ms'] / 1e9:.1f} TFLOP/s")
        ab = t["attention_backward"]
        log(f"  {shape_name} attention_backward kernel {ab['ms']:.4f} ms  PyTorch flash backward alone "
            f"{fmt_ms(ab['library_ms'])}  SDPA forward + backward {ab['library_fwd_bwd_ms']:.4f} ms")
        for kname in ("linear_relu_grad", "linear[dgrad]", "attention[train]", "weight_grad", "attention_backward",
                      "layer_norm_backward"):
            earlier = (LINEAR_EARLIER_MS.get(kname) or ATTENTION_EARLIER_MS.get(kname)
                       or TRAIN_EARLIER_MS[kname])[shape_name == "inter"]
            log(f"  {shape_name} {kname} {t[kname]['ms']:.4f} ms; before the redesign {earlier} ms "
                "(PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        show_info(f"{shape_name} attention[train] launch", t["attention[train]"]["launch"])
        show_info(f"{shape_name} attention_backward launch", ab["launch"])
    spills = attention_backward_launches()
    log(f"  attention backward strip instantiations, local-memory bytes a thread: {spills}")
    if any(spills.values()):
        fail(f"a strip instantiation of the attention backward spills to local memory: {spills}")
    times["strip_local_bytes"] = spills
    # every instantiation of the LayerNorm backward (both paths, four dtype pairings)
    ln_inst = {f"D={d} g_in {gn} g_out {on}": {k: v for k, v in ft.layer_norm_backward_info(INTRA[0] * INTRA[1], d, gd, od)
                                              .items() if k in ("path", "registers", "local_bytes", "blocks_per_sm")}
               for d in (256, 128, 64) for gn, gd in (("fp32", torch.float32), ("bf16", cd))
               for on, od in (("fp32", torch.float32), ("bf16", cd))}
    log(f"  layer_norm_backward instantiations: {ln_inst}")
    log(f"  layer_norm_backward ptxas by instantiation: {ln_ptxas}")
    if any(v["local_bytes"] for v in ln_inst.values()):
        fail(f"an instantiation of the LayerNorm backward uses local memory: {ln_inst}")
    times["layer_norm_backward_instantiations"] = ln_inst
    return times


# ---------------------------------------------------------------- 8. the flash path


def bound_of(nbytes, flops, peak=PEAK_BF16):
    tb, to = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / peak
    return dict(bound_ms=max(tb, to), bound_by="operations" if to >= tb else "bytes")


def phase8_kernels(gen, failures, H=8, hd=32):
    """(a) each flash kernel against its plain version."""
    from cse_tpu_torch.ops import attention as at

    log("[8a] flash attention kernels vs plain versions (fp32: max_rel <= %.0e; bf16: rel_l2 <= %.0e)"
        % (TOL_FP32, TOL_BF16))
    err = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for cd in (torch.float32, torch.bfloat16):
        tag = "fp32" if cd == torch.float32 else "bf16"
        for name, (G, L) in (("intra", INTRA), ("inter", INTER), ("L=300", (64, 300)), ("L=600", (32, 600))):
            q, k, v, do = (torch.randn(G, H, L, hd, device="cuda", generator=gen).to(cd) for _ in range(4))
            (o, lse), (po, plse) = at.flash_fwd(q, k, v), at.flash_fwd_plain(q, k, v)
            route = at.flash_fwd_info(L, hd)["route"] if cd == torch.bfloat16 else "fp32"
            e = check(f"flash_fwd {tag} {name} G={G} L={L} ({route}) o", o, po, cd, failures)
            e = max(e, check(f"flash_fwd {tag} {name} lse", lse, plse, torch.float32, failures))
            err["flash_fwd"] = max(err["flash_fwd"], e)
            del o, lse
            got, want = at.flash_bwd(q, k, v, po, plse, do), at.flash_bwd_plain(q, k, v, po, plse, do)
            route = at.flash_bwd_info(L, hd)["route"] if cd == torch.bfloat16 else "fp32"
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                err["flash_bwd"] = max(err["flash_bwd"], check(f"flash_bwd {tag} {name} ({route}) {gname}", g, w, cd,
                                                               failures))
            if cd == torch.bfloat16:
                same_bits(f"flash_bwd {tag} {name}", got, at.flash_bwd(q, k, v, po, plse, do), failures)
            del q, k, v, do, po, plse, got, want
            torch.cuda.empty_cache()
    if failures:
        fail(f"flash kernel checks failed: {failures}")
    return err


def phase8_parity(gen, failures):
    """(b) fp32 loss and gradients: flash + remat='layer' against the same
    model without flash."""
    import dataclasses

    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.train.step import TrainConfig, make_loss_fn

    B, T = 2, aligned_bucket(128000)
    log(f"[8b] flash parity, fp32, full width, B={B}, T={T}: make_loss_fn(fused=False) with flash + remat='layer' "
        f"vs the model without flash (rel_l2 <= {TOL_TRAIN_FP32:.0e})")
    plain = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.float32)
    flash = dataclasses.replace(plain, use_flash_attention=True, remat="layer")
    mix = torch.randn(B, T, device="cuda", generator=gen)
    ctx = torch.randn(B, 1, 4096, device="cuda", generator=gen)
    with torch.no_grad():
        est0 = Sepformer(plain, generator=torch.Generator().manual_seed(3)).cuda()(mix, ctx)[:, :, 0]
    gt = est0 + 0.5 * est0.std() * torch.randn(B, T, device="cuda", generator=gen)
    batch = {"mixed": mix, "gt": gt, "ctx_feat": ctx}
    del est0
    res = {}
    for name, cfg in (("flash", flash), ("plain", plain)):
        model = Sepformer(cfg, generator=torch.Generator().manual_seed(3)).cuda()
        loss, _ = make_loss_fn(model, TrainConfig(variant="context"))(batch)
        loss.backward()
        res[name] = (loss.item(), {k: (ft.qv_part(p.grad) if k.endswith("in_proj.bias") else p.grad).clone()
                                   for k, p in model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    (lf, gf), (lp, gp) = res["flash"], res["plain"]
    rl = abs(lf - lp) / abs(lp)
    log(f"  loss flash {lf:.6f} plain {lp:.6f} rel {rl:.3e}")
    if not rl <= TOL_TRAIN_FP32:
        failures.append("flash parity loss")
    worst = sorted(((errs(gf[k], gp[k])[2], k) for k in gp), reverse=True)
    for r, k in worst[:5]:
        log(f"  grad {k:<62s} rel_l2 {r:.3e}")
    bad = [k for r, k in worst if not r <= TOL_TRAIN_FP32]
    log(f"  {len(gp)} gradients, worst rel_l2 {worst[0][0]:.3e}: {'ok' if not bad else 'FAIL ' + str(bad)}")
    failures.extend(f"flash parity grad {k}" for k in bad)
    if failures:
        fail(f"flash parity checks failed: {failures}")
    return {"loss_rel": rl, "worst_grad_rel_l2": worst[0][0]}


def cuda_ms(fn, n=5, warmup=2):
    """Device times of n calls after warmups (CUDA events, each call synchronised)."""
    times = []
    for i in range(warmup + n):
        t_s, t_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_s.record()
        fn()
        t_e.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(t_s.elapsed_time(t_e))
    return times


def phase8_bench(gen, card, failures):
    """(c) the trainer's layer-by-layer path with flash + remat='layer', and
    the eval step."""
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.serving import ServingEngine
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_eval_step, make_train_step

    B, T = 16, aligned_bucket(128000)
    log(f"[8c] trainer path: make_train_step(fused=False), flash + remat='layer', ContExt full width, bf16, "
        f"B={B}, T={T} [{card}]")
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16, use_flash_attention=True,
                          remat="layer")
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 500000, 10000)),
                           TrainConfig(variant="context"))
    batch = {"mixed": torch.randn(B, T, device="cuda", generator=gen),
             "gt": torch.randn(B, T, device="cuda", generator=gen),
             "ctx_feat": torch.randn(B, 1, 4096, device="cuda", generator=gen)}
    n_att = 2 * cfg.num_dp_layers * cfg.num_tf_layers
    at.reset_launches()
    ft.reset_launches()
    m = step(batch)
    torch.cuda.synchronize()
    counts, others = at.launch_counts(), {k: v for k, v in ft.launch_counts().items() if v}
    want = at.launches_per_step(n_att, cfg.remat_layers)
    log(f"  launches in one step: {counts} (want {want}); fused-stack kernels {others or 'none'}")
    if counts != want or others:
        fail(f"flash train launch counts {counts} != {want} or fused kernels launched {others}")
    if not math.isfinite(m["loss"]):
        fail(f"non-finite loss {m}")
    step(batch)  # second warmup
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(5):
        t_s, t_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        t_s.record()
        m = step(batch)
        t_e.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - h0))
        times.append(t_s.elapsed_time(t_e))
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    log(f"  step: median {step_ms:.3f} ms over 5 ({[round(t, 3) for t in times]}; host clock "
        f"{[round(t, 3) for t in host]}); {B / (step_ms / 1e3):.3f} mixtures/s; peak memory "
        f"{peak / 2**30:.3f} GiB; loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f}  [{card}]")
    prof = profile_step(step, batch)
    del step
    torch.cuda.empty_cache()

    tc = TrainConfig(variant="context")
    eval_step = make_eval_step(model, tc)
    at.reset_launches()
    with torch.no_grad():
        out, _ = eval_step(batch)
    torch.cuda.synchronize()
    eval_counts = at.launch_counts()
    want = at.launches_per_step(n_att, cfg.remat_layers, train=False)
    eval_times = cuda_ms(lambda: eval_step(batch))
    eval_ms = statistics.median(eval_times)
    serve = ServingEngine(cfg, model)(batch["mixed"], batch["ctx_feat"])[:, :, 0]
    mx, _, rl2 = errs(out, serve)
    ok = eval_counts == want and rl2 <= TOL_SERVE_BF16 and tuple(out.shape) == (B, T)
    log(f"  eval step (fused=False): launches {eval_counts} (want {want}); forward median {eval_ms:.3f} ms over 5 "
        f"({[round(t, 3) for t in eval_times]}); vs the fused serving engine on the same weights: max_abs "
        f"{mx:.3e} rel_l2 {rl2:.3e} (tol {TOL_SERVE_BF16:.0e}) {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        failures.append("flash eval step")
        fail(f"flash eval checks failed: {failures}")
    peak_peak = peak
    del model, batch, out, serve, eval_step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_times_ms": times, "host_ms": host, "mixtures_per_s": B / (step_ms / 1e3),
            "peak_bytes": peak_peak, "launches": counts, "profile": prof, "eval_ms": eval_ms,
            "eval_times_ms": eval_times, "eval_launches": eval_counts, "eval_vs_serving_rel_l2": rl2}


def show_info(what, info):
    log(f"  {what}: route {info['route']}, {info['key_blocks']} key blocks in registers, {info['threads']} threads "
        f"and {info['rows_per_block']} query rows a block, {info['smem_bytes']} B shared, {info['registers']} "
        f"registers and {info['local_bytes']} B local memory a thread, {info['blocks_per_sm']} blocks per SM")


def phase8_times(gen, card, H=8, hd=32):
    """(d) the flash kernels' times, plain times, SDPA and bounds (bf16), and
    the forward launch's route, registers, local memory and resident blocks."""
    from cse_tpu_torch.ops import attention as at

    log(f"[8d] flash kernel times, bf16 [{card}]")
    cd, times = torch.bfloat16, {}
    for name, (G, L) in (("intra", INTRA), ("inter", INTER)):
        q, k, v, do = (torch.randn(G, H, L, hd, device="cuda", generator=gen).to(cd) for _ in range(4))
        o, lse = at.flash_fwd(q, k, v)
        X = G * H * L * hd * 2  # one bf16 operand
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                out = F.scaled_dot_product_attention(qg, kg, vg)
                torch.autograd.grad(out, (qg, kg, vg), do)

        # PyTorch's flash kernels keep [G, L, H, hd] in memory: the same values laid out so
        ql, kl, vl, dol = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v, do))
        t = {
            "flash_fwd": dict(ms=time_ms(lambda: at.flash_fwd(q, k, v)),
                              plain_ms=time_ms(lambda: at.flash_fwd_plain(q, k, v), reps=3),
                              library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                              launch=at.flash_fwd_info(L, hd),
                              **bound_of(4 * X + G * H * L * 4, 4 * G * H * L * L * hd)),
            "flash_bwd": dict(ms=time_ms(lambda: at.flash_bwd(q, k, v, o, lse, do)),
                              plain_ms=time_ms(lambda: at.flash_bwd_plain(q, k, v, o, lse, do), reps=3),
                              library_ms=sdpa_backward_ms(q, k, v, do), library_fwd_bwd_ms=time_ms(sdpa_fwd_bwd),
                              library_glhd_ms=sdpa_backward_ms(ql, kl, vl, dol), launch=at.flash_bwd_info(L, hd),
                              **bound_of(8 * X + G * H * L * 4, 10 * G * H * L * L * hd)),
        }
        del q, k, v, do, o, lse, qg, kg, vg, ql, kl, vl, dol
        torch.cuda.empty_cache()
        times[name] = t
        for kname, x in t.items():
            log(f"  {name} G={G} L={L} {kname:<10s} kernel {x['ms']:.4f} ms  plain {x['plain_ms']:.4f} ms  "
                f"SDPA {fmt_ms(x['library_ms'])}  bound {x['bound_ms']:.4f} ms ({x['bound_by']})"
                + (f"  SDPA forward + backward {x['library_fwd_bwd_ms']:.4f} ms" if "library_fwd_bwd_ms" in x else ""))
        log(f"  {name} flash_bwd PyTorch flash backward alone on [G, L, H, hd] in memory "
            f"{fmt_ms(t['flash_bwd']['library_glhd_ms'])} (on contiguous [G, H, L, hd]: "
            f"{fmt_ms(t['flash_bwd']['library_ms'])})")
        log(f"  {name} flash_fwd {t['flash_fwd']['ms']:.4f} ms; before the redesign "
            f"{FLASH_FWD_EARLIER_MS[name]} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        log(f"  {name} flash_bwd {t['flash_bwd']['ms']:.4f} ms; before the redesign "
            f"{FLASH_BWD_EARLIER_MS[name]} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        show_info(f"{name} flash_fwd launch", t["flash_fwd"]["launch"])
        show_info(f"{name} flash_bwd launch", t["flash_bwd"]["launch"])
    spills = {f"L={L} dh={dh}": at.flash_fwd_info(L, dh)["local_bytes"] for L in (128, 256) for dh in at.HEAD_WIDTHS}
    log(f"  forward strip instantiations, local-memory bytes a thread: {spills}")
    if any(spills.values()):
        fail(f"a strip instantiation of flash_fwd spills to local memory: {spills}")
    bspills = flash_backward_launches()
    log(f"  backward strip instantiations, local-memory bytes a thread: {bspills}")
    if any(bspills.values()):
        fail(f"a strip instantiation of flash_bwd spills to local memory: {bspills}")
    times["strip_local_bytes"] = spills
    times["bwd_strip_local_bytes"] = bspills
    return times


# ---------------------------------------------------------------- 9. w8a8 serving


def phase9_kernels(gen, failures, H, F_, NL):
    """(a) quantizer, int8 GEMM and the whole w8a8 stack against their plain versions."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    D, cd = 256, torch.bfloat16
    log(f"[9a] w8a8 kernels vs plain versions (quantizer bit-exact; int8 GEMM max_rel <= {TOL_W8A8_GEMM:.0e}; "
        f"layer_norm_quant and ffn_w8a8 the bits of the kernel chains they replace, ffn_w8a8 max_rel <= "
        f"{TOL_W8A8_GEMM:.0e} against its plain chain; 1-layer stack rel_l2 <= {TOL_BF16:.0e}; {NL}-layer stack "
        f"error vs fp32 <= {TOL_W8A8_STACK_RATIO:.2f}x plain's + 1e-3)")
    err = dict.fromkeys(("quantize_rows", "linear_w8a8", "attention[w8a8]", "fused_stack_w8a8", "layer_norm_quant",
                         "ffn_w8a8"), 0.0)
    shapes = ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual"))
    for name, (G, L) in (("intra", INTRA), ("inter", INTER)):
        M = G * L
        for K in (D, F_):
            h = 3 * torch.randn(M, K, device="cuda", generator=gen)
            h[0] = 0
            (q, sa), (pq, psa) = w8.quantize_rows(h), w8.quantize_rows_plain(h)
            diff = int((q != pq).sum()) + int((sa != psa).sum())
            err["quantize_rows"] = max(err["quantize_rows"], float((q.int() - pq.int()).abs().max()),
                                       float((sa - psa).abs().max()))
            log(f"  quantize_rows {name} [{M},{K}]: {diff} elements differ  {'ok' if diff == 0 else 'FAIL'}")
            if diff:
                failures.append(f"quantize_rows {name} K={K}")
            del h, q, sa, pq, psa
        for K, N, epi in shapes:
            hq, sa = w8.quantize_rows(torch.randn(M, K, device="cuda", generator=gen))
            wq, s = fs.quantize_stacked(torch.randn(1, K, N, device="cuda", generator=gen))
            wq = fs.k_major(wq)  # as stack_weights keeps it
            b = 0.1 * torch.randn(N, device="cuda", generator=gen)
            res = torch.randn(M, N, device="cuda", generator=gen) if epi == "residual" else None
            got = w8.linear_w8a8(hq, sa, wq[0], s[0], b, epi, None if res is None else res.clone())
            want = w8.linear_w8a8_plain(hq, sa, wq[0], s[0], b, epi, res)
            mx, rmax, rl2 = errs(got, want)
            ok = rmax <= TOL_W8A8_GEMM
            log(f"  linear_w8a8 {name} [{M},{K}]x[{K},{N}] {epi:<8s} max_abs {mx:.3e} max_rel {rmax:.3e}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"linear_w8a8 {name} {epi} K={K}")
            err["linear_w8a8"] = max(err["linear_w8a8"], mx)
            del hq, sa, wq, s, got, want, res
        x = 3 * torch.randn(M, D, device="cuda", generator=gen) + 0.5
        x[0] = 2.5  # under the zero bias an all-zero LN row: the 1e-12 floor
        sc = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
        for bias in (0.1 * torch.randn(D, device="cuda", generator=gen), torch.zeros(D, device="cuda")):
            (q, sa), (cq, csa) = w8.layer_norm_quant(x, sc, bias), w8.quantize_rows(fs.layer_norm(x, sc, bias,
                                                                                                 torch.float32))
            pq, psa = w8.layer_norm_quant_plain(x, sc, bias)
            diff = int((q != cq).sum()) + int((sa != csa).sum())
            flips = int((q != pq).sum())
            err["layer_norm_quant"] = max(err["layer_norm_quant"], float((q.int() - pq.int()).abs().max()))
            log(f"  layer_norm_quant {name} [{M},{D}]: {diff} elements differ from layer_norm (fp32) + quantize_rows; "
                f"{flips} int8 flips against the plain version  {'ok' if diff == 0 else 'FAIL'}")
            if diff:
                failures.append(f"layer_norm_quant {name}")
        del x, q, sa, cq, csa, pq, psa
        err["ffn_w8a8"] = max(err["ffn_w8a8"], ffn_w8a8_check(gen, name, M, F_, failures))
        qkv = 2 * torch.randn(M, 3 * D, device="cuda", generator=gen)
        err["attention[w8a8]"] = max(err["attention[w8a8]"], check(
            f"attention bf16 operands, fp32 out {name}", fs.attention(qkv, L, H, torch.float32, operand_dtype=cd),
            fs.attention_plain(qkv, L, H, torch.float32, operand_dtype=cd), cd, failures))
        del qkv
        for nl in (1, NL):
            w = fs.stack_weights(stack_module(nl, gen), cd, quant="w8a8")
            xs = torch.randn(G, L, D, device="cuda", generator=gen).to(cd)
            got, want = fs.fused_stack_apply(xs, w, H, cd, quant="w8a8"), fs.fused_stack_reference(xs, w, H, cd, "w8a8")
            if nl == 1:
                e = check(f"fused stack w8a8 bf16 {name} [{G},{L},{D}] 1 layer", got, want, cd, failures)
            else:  # see TOL_W8A8_STACK_RATIO
                ref = fs.fused_stack_reference(xs.float(), w, H, torch.float32, "w8a8")
                (e, _, rl2), ek, ep = errs(got, want), errs(got, ref)[2], errs(want, ref)[2]
                ok = ek <= TOL_W8A8_STACK_RATIO * ep + 1e-3
                log(f"  fused stack w8a8 bf16 {name} {nl} layers: rel_l2 vs plain {rl2:.3e}; vs the plain fp32 run: "
                    f"kernels {ek:.3e} plain {ep:.3e}  {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"fused stack w8a8 {name} {nl} layers")
                del ref
            err["fused_stack_w8a8"] = max(err["fused_stack_w8a8"], e)
            del w, xs, got, want
            torch.cuda.empty_cache()
    for name, (G, L) in cell_shapes():
        err["ffn_w8a8"] = max(err["ffn_w8a8"], ffn_w8a8_check(gen, name, G * L, F_, failures))
    if failures:
        fail(f"w8a8 kernel checks failed: {failures}")
    return err


def ffn_w8a8_check(gen, name, M, F_, failures) -> float:
    """ffn_w8a8 at M rows: the bits of linear_w8a8 (relu) + quantize_rows + linear_w8a8 (residual), and
    max_rel <= TOL_W8A8_GEMM against its plain version; the max_abs of the latter."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    D = 256
    hq, sa = w8.quantize_rows(torch.randn(M, D, device="cuda", generator=gen))
    (w1, s1), (w2, s2) = (fs.quantize_stacked(torch.randn(1, k, n, device="cuda", generator=gen))
                          for k, n in ((D, F_), (F_, D)))
    w1, w2, s1, s2 = fs.k_major(w1)[0], fs.k_major(w2)[0], s1[0], s2[0]  # as stack_weights keeps them
    b1, b2 = (0.1 * torch.randn(n, device="cuda", generator=gen) for n in (F_, D))
    res = torch.randn(M, D, device="cuda", generator=gen)
    got = w8.ffn_w8a8(hq, sa, w1, s1, b1, w2, s2, b2, res.clone())
    fq, fsa = w8.quantize_rows(w8.linear_w8a8(hq, sa, w1, s1, b1, "relu"))
    diff = int((got != w8.linear_w8a8(fq, fsa, w2, s2, b2, "residual", res.clone())).sum())
    del fq, fsa
    mx, rmax, _ = errs(got, w8.ffn_w8a8_plain(hq, sa, w1, s1, b1, w2, s2, b2, res))
    ok = diff == 0 and rmax <= TOL_W8A8_GEMM
    log(f"  ffn_w8a8 {name} [{M},{D}]x[{D},{F_}]x[{F_},{D}]: {diff} elements differ from linear_w8a8 + "
        f"quantize_rows + linear_w8a8; vs plain max_abs {mx:.3e} max_rel {rmax:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"ffn_w8a8 {name}")
    del hq, sa, w1, w2, got, res
    torch.cuda.empty_cache()
    return mx


def phase9_serve(gen, card, failures):
    """(b) ServingEngine(quant="w8a8") at full width."""
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.serving import ServingEngine

    B, T = 16, aligned_bucket(128000)
    log(f"[9b] ServingEngine(quant='w8a8') variant=context full width, bf16, B={B}, T={T}")
    mix = torch.randn(B, T, device="cuda", generator=gen)
    ctx = torch.randn(B, 1, 4096, device="cuda", generator=gen)
    ref = Sepformer(SepformerConfig(variant="context", num_spks=2), generator=torch.Generator().manual_seed(0))
    ref = ref.cuda().eval()(mix, ctx)
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16)
    engine = ServingEngine(cfg, Sepformer(cfg, generator=torch.Generator().manual_seed(0)), quant="w8a8")
    w8.reset_launches()
    out = engine(mix, ctx)
    torch.cuda.synchronize()
    counts = w8.launch_counts()
    want = {k: v * 2 * cfg.num_dp_layers
            for k, v in fs.launches_per_stack(cfg.num_tf_layers, "w8a8", cfg.d_model, cfg.d_ffn).items()}
    log(f"  launches in one w8a8 forward: {counts} (want {want}, total {sum(want.values())})")
    if counts != want:
        fail(f"w8a8 launch counts {counts} != {want}")
    mx, _, rl2 = errs(out, ref)
    ok = tuple(out.shape) == (B, T, 1) and bool(torch.isfinite(out).all()) and rl2 <= TOL_SERVE_BF16
    log(f"  w8a8 bf16 vs plain fp32 Sepformer: max_abs {mx:.3e} rel_l2 {rl2:.3e} (tol {TOL_SERVE_BF16:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("w8a8 serving")
        fail(f"w8a8 serving checks failed: {failures}")
    fwd_times = cuda_ms(lambda: engine(mix, ctx))
    fwd_ms = statistics.median(fwd_times)
    audio_s = B * T / 8000
    log(f"  w8a8 forward: median {fwd_ms:.3f} ms over 5 ({[round(t, 3) for t in fwd_times]}); {audio_s:.1f} s of "
        f"audio -> realtime factor {audio_s / (fwd_ms / 1e3):.1f}x  [{card}]")
    del engine, ref, out
    torch.cuda.empty_cache()
    return {"forward_ms": fwd_ms, "forward_times_ms": fwd_times, "realtime_factor": audio_s / (fwd_ms / 1e3),
            "launches": counts, "rel_l2_vs_fp32": rl2}


def phase9_times(gen, card, H, F_, NL):
    """(c) the w8a8 kernels' times, plain times, library calls and bounds."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    D, cd, hd = 256, torch.bfloat16, 32
    log(f"[9c] w8a8 kernel times [{card}]")
    shapes = ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual"))
    times = {}
    for name, (G, L) in (("intra", INTRA), ("inter", INTER)):
        M = G * L
        t = {}
        h = torch.randn(M, D, device="cuda", generator=gen)
        t["quantize_rows"] = dict(ms=time_ms(lambda: w8.quantize_rows(h)),
                                  plain_ms=time_ms(lambda: w8.quantize_rows_plain(h), reps=3), library_ms=None,
                                  **bound_of(M * D * 5 + M * 4, 0))
        h4 = torch.randn(M, F_, device="cuda", generator=gen)  # the FFN1 output's quantizer
        t["quantize_rows[1024]"] = dict(ms=time_ms(lambda: w8.quantize_rows(h4)),
                                        plain_ms=time_ms(lambda: w8.quantize_rows_plain(h4), reps=3),
                                        library_ms=None, **bound_of(M * F_ * 5 + M * 4, 0))
        del h4
        s1, b1 = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
        t["layer_norm[w8a8]"] = dict(ms=time_ms(lambda: fs.layer_norm(h, s1, b1, torch.float32)),
                                     plain_ms=time_ms(lambda: fs.layer_norm_plain(h, s1, b1, torch.float32)),
                                     library_ms=time_ms(lambda: F.layer_norm(h, (D,), s1, b1, 1e-6)),
                                     **bound_of(M * D * 8 + 2 * D * 4, 0))
        # 2e, beside the two launches it replaces at each LN site (2d then 2a), timed in this run
        t["layer_norm_quant"] = dict(
            ms=time_ms(lambda: w8.layer_norm_quant(h, s1, b1)),
            plain_ms=time_ms(lambda: w8.layer_norm_quant_plain(h, s1, b1), reps=3), library_ms=None,
            before_ms=time_ms(lambda: w8.quantize_rows(fs.layer_norm(h, s1, b1, torch.float32))),
            launch=w8.kernel_info("layer_norm_quant"), **bound_of(M * D * 5 + M * 4 + 2 * D * 4, 0))
        del h
        # 2f, beside the three launches it replaces (FFN1 relu, the [M, 1024] quantizer, FFN2), timed in this run
        t["ffn_w8a8"] = ffn_w8a8_times(gen, M, F_)
        log(f"  {name} layer_norm_quant {t['layer_norm_quant']['ms']:.4f} ms (before: layer_norm + quantize_rows "
            f"{t['layer_norm_quant']['before_ms']:.4f} ms); ffn_w8a8 {t['ffn_w8a8']['ms']:.4f} ms (before: "
            f"linear_w8a8 + quantize_rows + linear_w8a8 {t['ffn_w8a8']['before_ms']:.4f} ms), this run  [{card}]")
        for k in ("layer_norm_quant", "ffn_w8a8"):
            log(f"  {name} {k} launch: {t[k]['launch']['registers']} registers and {t[k]['launch']['local_bytes']} B "
                f"local memory a thread, {t[k]['launch']['blocks_per_sm']} blocks per SM")
        ops_, lib_ = [], []
        for K, N, epi in shapes:
            hq, sa = w8.quantize_rows(torch.randn(M, K, device="cuda", generator=gen))
            wq, s = fs.quantize_stacked(torch.randn(1, K, N, device="cuda", generator=gen))
            wq = fs.k_major(wq)  # as stack_weights keeps it; torch._int_mm takes it as it is
            res = torch.zeros(M, N, device="cuda") if epi == "residual" else None
            ops_.append((hq, sa, wq[0], s[0], torch.zeros(N, device="cuda"), epi, res))
            lib_.append((hq, wq[0]))
        gemm_ops = sum(2 * M * K * N for K, N, _ in shapes)
        gemm_bytes = [M * K + K * N + M * 4 + 2 * N * 4 + M * N * (8 if e == "residual" else 4) for K, N, e in shapes]
        each = [time_ms(lambda o=o: w8.linear_w8a8(*o)) for o in ops_]
        # the main path runs the first two (QKV, out-proj); FFN1 and FFN2 are ffn_w8a8's now
        t["linear_w8a8"] = dict(ms=sum(each[:2]), four_gemms_ms=sum(each),
                                plain_ms=time_ms(lambda: [w8.linear_w8a8_plain(*o) for o in ops_[:2]], reps=3),
                                library_ms=time_ms(lambda: [torch._int_mm(a, b) for a, b in lib_[:2]]),
                                **bound_of(sum(gemm_bytes[:2]), sum(2 * M * K * N for K, N, _ in shapes[:2]),
                                           PEAK_INT8))
        del ops_, lib_
        log(f"  {name} linear_w8a8: QKV + out-proj {t['linear_w8a8']['ms']:.4f} ms; the 4 shapes {sum(each):.4f} ms, "
            f"before the redesign {LINEAR_W8A8_EARLIER_MS[name]} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        q, k, v = (x.to(cd) for x in qkv.reshape(G, L, 3, H, hd).permute(2, 0, 3, 1, 4))
        att_flops = 4 * G * H * L * L * hd
        t["attention[w8a8]"] = dict(
            ms=time_ms(lambda: fs.attention(qkv, L, H, torch.float32, operand_dtype=cd)),
            plain_ms=time_ms(lambda: fs.attention_plain(qkv, L, H, torch.float32, operand_dtype=cd), reps=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            launch=fs.attention_info(L, hd, torch.float32),
            **bound_of(M * 3 * D * 4 + M * D * 4, att_flops))
        log(f"  {name} attention[w8a8] {t['attention[w8a8]']['ms']:.4f} ms; before the redesign "
            f"{ATTENTION_EARLIER_MS['attention[w8a8]'][name == 'inter']} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        show_info(f"{name} attention[w8a8] launch", t["attention[w8a8]"]["launch"])
        del qkv, q, k, v
        w = fs.stack_weights(stack_module(NL, gen), cd, quant="w8a8")
        xs = torch.randn(G, L, D, device="cuda", generator=gen).to(cd)
        stk_ms = NL * (1e3 * gemm_ops / PEAK_INT8 + 1e3 * att_flops / PEAK_BF16)
        t["fused_stack_w8a8"] = dict(ms=time_ms(lambda: fs.fused_stack_apply(xs, w, H, cd, quant="w8a8"), reps=5),
                                     plain_ms=time_ms(lambda: fs.fused_stack_reference(xs, w, H, cd, quant="w8a8"),
                                                      reps=2, warmup=1),
                                     library_ms=None, bound_ms=stk_ms, bound_by="operations")
        del w, xs
        torch.cuda.empty_cache()
        times[name] = t
        for kname, x in t.items():
            lib = "none" if x["library_ms"] is None else f"{x['library_ms']:.4f} ms"
            log(f"  {name} G={G} L={L} {kname:<19s} kernel {x['ms']:.4f} ms  plain {x['plain_ms']:.4f} ms  "
                f"library {lib}  bound {x['bound_ms']:.4f} ms ({x['bound_by']})")
    for name, (G, L) in cell_shapes():  # 2f at the serving cell's shapes, beside the chain it replaces
        times[name] = {"ffn_w8a8": ffn_w8a8_times(gen, G * L, F_)}
        x = times[name]["ffn_w8a8"]
        log(f"  {name} G={G} L={L} ffn_w8a8 kernel {x['ms']:.4f} ms (linear_w8a8 + quantize_rows + linear_w8a8 "
            f"{x['before_ms']:.4f} ms, this run)  bound {x['bound_ms']:.4f} ms ({x['bound_by']})  [{card}]")
    return times


def ffn_w8a8_times(gen, M, F_) -> dict:
    """ffn_w8a8's time at M rows, the chain it replaces (FFN1 relu, the [M, F] quantizer, FFN2) in the same
    run, and its bound (bytes read once and written once, or its products at the int8 peak)."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    D = 256
    hq, sa = w8.quantize_rows(torch.randn(M, D, device="cuda", generator=gen))
    (w1, sw1), (w2, sw2) = (fs.quantize_stacked(torch.randn(1, k, n, device="cuda", generator=gen))
                            for k, n in ((D, F_), (F_, D)))
    ffn = (hq, sa, fs.k_major(w1)[0], sw1[0], torch.zeros(F_, device="cuda"), fs.k_major(w2)[0], sw2[0],
           torch.zeros(D, device="cuda"), torch.zeros(M, D, device="cuda"))

    def chain():
        fq, fsa = w8.quantize_rows(w8.linear_w8a8(*ffn[:5], "relu"))
        w8.linear_w8a8(fq, fsa, *ffn[5:8], "residual", ffn[8])
    out = dict(ms=time_ms(lambda: w8.ffn_w8a8(*ffn)), plain_ms=time_ms(lambda: w8.ffn_w8a8_plain(*ffn), reps=3),
               library_ms=None, before_ms=time_ms(chain), launch=w8.kernel_info("ffn_w8a8"),
               **bound_of(M * (D + 4 + 8 * D) + 2 * D * F_ + 4 * (2 * F_ + 2 * D), 4 * M * D * F_, PEAK_INT8))
    del ffn, hq, sa, w1, w2
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- 10. the kernel-parts tool


def phase10_kernels(gen, failures):
    """(a) the tool's kernels and its whole forward against the plain versions,
    at the shapes the tool's own run gives them."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import kernel_parts as kp
    from cse_tpu_torch.scripts.bench_kernel_parts import make_inputs

    G, Lp, D, NL, H = 1008, 256, 256, 2, 8
    M = G * Lp
    log(f"[10a] kernel-parts kernels vs plain versions at the tool's shapes, G={G} Lp=D={D}, {NL} layers, {H} heads "
        f"(fp32: max_rel <= {TOL_FP32:.0e}, rel_l2 for the D x softmax modes; bf16: rel_l2 <= {TOL_BF16:.0e}, the "
        "plain version rounding the score operands to bf16 as the kernel does)")
    err = dict.fromkeys(("kp_layer_norm", "kp_attention", "linear", "kernel_parts"), 0.0)
    for cd in (torch.float32, torch.bfloat16):
        tag = "fp32" if cd == torch.float32 else "bf16"
        qk = None if cd == torch.float32 else cd
        x, w, f1, f2, jmat = make_inputs(G, Lp, D, NL, cd)
        r = (3 * torch.randn(M, D, device="cuda", generator=gen) + 0.5).contiguous()
        for ln_mode in kp.LN_MODES:
            got = kp.kp_layer_norm(r, jmat, ln_mode, cd)
            e = check(f"kp_layer_norm {tag} {ln_mode}", got, kp.kp_layer_norm_plain(r, jmat, ln_mode, cd), cd, failures)
            same_bits(f"kp_layer_norm {tag} {ln_mode}", (got,), (kp.kp_layer_norm(r, jmat, ln_mode, cd),), failures)
            err["kp_layer_norm"] = max(err["kp_layer_norm"], e)
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        for sm_mode in kp.SOFTMAX_MODES:
            got = kp.kp_attention(qkv, jmat, r.clone(), Lp, H, sm_mode, cd) - r
            ref = kp.kp_attention_plain(qkv, jmat, r.clone(), Lp, H, sm_mode, cd, qk_dtype=qk) - r
            e = check(f"kp_attention {tag} {sm_mode} (added part)", got, ref, cd, failures)
            err["kp_attention"] = max(err["kp_attention"], e)
            del got, ref
        del qkv
        if cd == torch.bfloat16:  # the multi-pass route of L > 256, in the modes free of jmat
            G2, L2 = 64, 300
            qkv, r2 = (torch.randn(G2 * L2, n * D, device="cuda", generator=gen) for n in (3, 1))
            for sm_mode in ("skip", "sum"):
                got = kp.kp_attention(qkv, jmat, r2.clone(), L2, H, sm_mode, cd) - r2
                ref = kp.kp_attention_plain(qkv, jmat, r2.clone(), L2, H, sm_mode, cd, qk_dtype=qk) - r2
                check(f"kp_attention {tag} {sm_mode} G={G2} L={L2} ({kp.kp_attention_info(L2, sm_mode)['route']})",
                      got, ref, cd, failures)
            del qkv, r2, got, ref
        # the tool's three products on the port's GEMM: zero bias, as kernel_parts_apply calls it
        for wt, epi in ((w[0], "bias"), (f1[0], "relu"), (f2[0], "residual")):
            K, N = wt.shape
            a = torch.randn(M, K, device="cuda", generator=gen).to(cd)
            bias = torch.zeros(N, device="cuda")
            res = r if epi == "residual" else None
            got = fs.linear(a, wt, bias, epi, None if res is None else res.clone())
            e = check(f"linear {tag} [{M},{K}]x[{K},{N}] {epi}", got, fs.linear_plain(a, wt, bias, epi, res), cd, failures)
            err["linear"] = max(err["linear"], e)
            del a, got
        for mode in kp.MODES:
            got = kp.kernel_parts_apply(x, w, f1, f2, jmat, mode, H)
            ref = kp.kernel_parts_plain(x, w, f1, f2, jmat, mode, H, qk_dtype=qk)
            if cd == torch.float32 and mode in PARTS_QUIRK:
                mx, rmax, rl2 = errs(got, ref)
                ok = rl2 <= TOL_FP32 and bool(torch.isfinite(got).all())
                log(f"  {'kernel_parts fp32 ' + mode + ' (rel_l2)':<44s} max_abs {mx:.3e}  max_rel {rmax:.3e}  "
                    f"rel_l2 {rl2:.3e}  {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"kernel_parts fp32 {mode}")
            else:
                mx = check(f"kernel_parts {tag} {mode}", got, ref, cd, failures)
            err["kernel_parts"] = max(err["kernel_parts"], mx)
            del got, ref
        if cd == torch.float32:  # the tool's own arithmetic: D x softmax in three modes
            full = kp.kernel_parts_apply(x, w, f1, f2, jmat, "full", H)
            d_hp = errs(kp.kernel_parts_apply(x, w, f1, f2, jmat, "combined_hp", H), full)[0]
            d_x2 = errs(kp.kernel_parts_apply(x, w, f1, f2, jmat, "combined_x2", H), full)[0]
            log(f"  fp32: |combined_hp - full| max {d_hp:.3e}; |combined_x2 - full| max {d_x2:.3e} (D x softmax)")
            if not (d_hp <= 1e-4 and d_x2 > 1.0):
                failures.append("kernel_parts: combined_hp must agree with full, combined_x2 must not")
            del full
        del x, w, f1, f2, jmat, r
        torch.cuda.empty_cache()
    if failures:
        fail(f"kernel-parts checks failed: {failures}")
    return err


def phase10_tool(gen, card):
    """(b) the tool's own run at its defaults, and the kernels' times."""
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import kernel_parts as kp
    from cse_tpu_torch.scripts import bench_kernel_parts as tool

    G, Lp, D, NL, H, hd, cd = 1008, 256, 256, 2, 8, 32, torch.bfloat16
    M = G * Lp
    # TF/s below uses the tool's own count (12 D^2 per token: it counts an out-projection that its
    # kernel does not have); the bound uses what the function computes: qkv 3 D^2, FFN1 4 D^2 and
    # FFN2 4 D^2 multiply-adds per token, and the two attention products
    flops = tool.flop_count(G, Lp, D, NL)
    work = G * NL * (2 * 11 * D * D * Lp + 4 * Lp * Lp * D)
    nbytes = 2 * G * Lp * D * 4 + NL * (3 * D * D + 8 * D * D) * 2 + D * 128 * 2
    bound = bound_of(nbytes, work)
    log(f"[10b] the kernel-parts tool at its defaults, G={G} Lp=D={D}, {NL} layers, bf16: {work / 1e12:.4f} TFLOP "
        f"computed ({flops / 1e12:.4f} by the tool's count), {nbytes / 1e6:.1f} MB in and out -> bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})  [{card}]")
    kp.reset_launches()
    tool.main([])  # the main path: combined_x2 and full, 2 warm-ups + 10 timed calls each
    torch.cuda.synchronize()
    counts = kp.launch_counts()
    calls = 2 * (2 + 10)
    want = {k: v * calls for k, v in kp.launches_per_call(NL).items()}
    log(f"  launches in the tool's run ({calls} calls): {counts} (want {want})")
    if counts != want:
        fail(f"kernel-parts launch counts {counts} != {want}")
    args = tool.make_inputs(G, Lp, D, NL)
    by_mode = {m: tool.bench(m, G, Lp, D, NL, H, 10, args) for m in kp.MODES}
    for m, ms in by_mode.items():
        log(f"  {m:16s}: {ms:7.3f} ms   ({flops / ms / 1e9:6.1f} TF/s)")
    plain_ms = time_ms(lambda: kp.kernel_parts_plain(*args, "full", H, qk_dtype=cd), reps=2, warmup=1)
    log(f"  plain version, full: {plain_ms:.3f} ms; library: none (no single PyTorch call computes it)")
    x, w, f1, f2, jmat = args
    r = x.reshape(M, D).clone()
    t = {"kernel_parts": dict(ms=by_mode["full"], plain_ms=plain_ms, library_ms=None, by_mode_ms=by_mode, **bound)}
    ln_ms = {m: time_ms(lambda m=m: kp.kp_layer_norm(r, jmat, m, cd)) for m in kp.LN_MODES}
    t["kp_layer_norm"] = dict(
        ms=ln_ms["centred"], by_mode_ms=ln_ms,
        plain_ms=time_ms(lambda: kp.kp_layer_norm_plain(r, jmat, "centred", cd), reps=3),
        library_ms=time_ms(lambda: F.layer_norm(r, (D,), None, None, 1e-6)),
        launch={m: kp.kp_layer_norm_info(M, D, m, cd) for m in kp.LN_MODES},
        **bound_of(M * D * (4 + 2), 0))
    ln_bound = t["kp_layer_norm"]["bound_ms"]
    for m, ms in ln_ms.items():  # every mode moves the same bytes: x fp32 in, bf16 out
        li = t["kp_layer_norm"]["launch"][m]
        log(f"  kp_layer_norm {m:<8s} {ms:.4f} ms ({ln_bound / ms:.1%} of its bytes bound {ln_bound:.4f} ms; before "
            f"the redesign {KP_LN_EARLIER_MS[m]} ms, PERF.md, NVIDIA H100 80GB HBM3, 700 W): route {li['route']}, "
            f"grid {li['grid']}, {li['threads']} threads and {li['rows_per_block']} rows a block at a time, "
            f"{li['smem_bytes']} B shared, {li['registers']} registers and {li['local_bytes']} B local memory a "
            f"thread, {li['blocks_per_sm']} blocks per SM")
    staged_local = {f"{m} D={d}": kp.kp_layer_norm_info(M, d, m, cd)["local_bytes"]
                    for m in ("cd", "exact", "x2") for d in (64, 256, 512, 1024)}
    log(f"  kp_layer_norm staged instantiations, local-memory bytes a thread: {staged_local}")
    if any(staged_local.values()):
        fail(f"a staged instantiation of kp_layer_norm uses local memory: {staged_local}")
    qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
    # SDPA's yardstick takes bf16 q, k, v already split by head: no fp32 read, no residual add
    q, k, v = (a.to(cd) for a in qkv.reshape(G, Lp, 3, H, hd).permute(2, 0, 3, 1, 4))
    sm_ms = {m: time_ms(lambda m=m: kp.kp_attention(qkv, jmat, r, Lp, H, m, cd)) for m in kp.SOFTMAX_MODES}
    t["kp_attention"] = dict(
        ms=sm_ms["sum"], by_mode_ms=sm_ms,
        plain_ms=time_ms(lambda: kp.kp_attention_plain(qkv, jmat, r, Lp, H, "sum", cd, qk_dtype=cd), reps=2, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        launch={m: kp.kp_attention_info(Lp, m) for m in kp.SOFTMAX_MODES},
        **bound_of(M * 3 * D * 4 + 2 * M * D * 4, 4 * G * H * Lp * Lp * hd))
    log(f"  kp_attention by mode {({m: round(x, 4) for m, x in sm_ms.items()})}; before the redesign, mode 'sum': "
        f"{KP_ATTENTION_EARLIER_MS} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
    for m, info in t["kp_attention"]["launch"].items():
        show_info(f"kp_attention launch, mode {m!r}", info)
    spills = {f"{m} L={L}": kp.kp_attention_info(L, m)["local_bytes"] for m in kp.SOFTMAX_MODES for L in (128, 256)}
    log(f"  one-pass instantiations, local-memory bytes a thread: {spills}")
    if any(spills.values()):
        fail(f"a one-pass instantiation of kp_attention spills to local memory: {spills}")
    del qkv, q, k, v
    h = torch.randn(M, D, device="cuda", generator=gen).to(cd)
    hf = torch.randn(M, 4 * D, device="cuda", generator=gen).to(cd)
    ops_ = [(h, w[0], torch.zeros(3 * D, device="cuda"), "bias", None),
            (h, f1[0], torch.zeros(4 * D, device="cuda"), "relu", None),
            (hf, f2[0], torch.zeros(D, device="cuda"), "residual", torch.zeros(M, D, device="cuda"))]
    shapes = ((D, 3 * D, "bias"), (D, 4 * D, "relu"), (4 * D, D, "residual"))
    t["linear[kernel_parts]"] = dict(
        ms=sum(time_ms(lambda o=o: fs.linear(*o)) for o in ops_),
        library_like_ms=sum_or_none([time_like(addmm_like(*o)) for o in ops_]),
        plain_ms=time_ms(lambda: [fs.linear_plain(*o) for o in ops_], reps=3),
        library_ms=time_ms(lambda: [torch.matmul(o[0], o[1]) for o in ops_]),
        **bound_of(sum(M * K * 2 + K * N * 2 + N * 4 + M * N * (8 if e == "residual" else 4 if e == "bias" else 2)
                       for K, N, e in shapes), sum(2 * M * K * N for K, N, _ in shapes)))
    del ops_, h, hf, r
    torch.cuda.empty_cache()
    log(f"  linear[kernel_parts] {t['linear[kernel_parts]']['ms']:.4f} ms, addmm "
        f"{fmt_ms(t['linear[kernel_parts]']['library_like_ms'])}; before the redesign "
        f"{LINEAR_EARLIER_MS['linear[kernel_parts]']} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
    for kname, v in t.items():
        lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
        log(f"  G={G} Lp={Lp} {kname:<22s} kernel {v['ms']:.4f} ms  plain {v['plain_ms']:.4f} ms  library {lib}  "
            f"bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
            + (f"  by mode {({m: round(x, 4) for m, x in v['by_mode_ms'].items()})}" if "by_mode_ms" in v else ""))
    return {"launches": counts, "times": t, "flops": work, "tool_flop_count": flops}


# ---------------------------------------------------------------- 11. the trainer


# [11]'s trainer flags ([18c] runs the same under torch.distributed.run)
TRAINER_ARGS = ["--synthetic_smoke", "--bf16", "--batch_size", "16", "--max_sp_len", "16", "--flash_attention",
                "--remat", "layer", "--augmentation", "--noise_add", "--synthetic_seconds", "8", "16",
                "--synthetic_dialogs", "24", "--log_every", "2", "--eval_step", "4", "--tot_iters", "8",
                "--workers", "8"]


def phase11(card, failures):
    """The trainer entry point at full width, fused and layer by layer."""
    import glob
    import os
    import tempfile

    from cse_tpu_torch.core.flags import parse_train_args
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.train import checkpoint as ckpt_lib
    from cse_tpu_torch.train.loop import train_net

    base = TRAINER_ARGS
    log(f"[11] trainer: train_net(parse_train_args({' '.join(base)}), 'context'), full width  [{card}]")
    out = {}
    for name, extra in (("fused", []), ("layer_by_layer", ["--no_fused_train"])):
        ck = tempfile.mkdtemp(prefix=f"cse_ckpt_{name}_")
        args = parse_train_args(base + extra + ["--checkpoint_dir", ck])
        ft.reset_launches()
        at.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        stats, t0 = {}, time.time()
        model = train_net(args, "context", stats=stats)
        torch.cuda.synchronize()
        took, peak = time.time() - t0, torch.cuda.max_memory_allocated()
        counts, fcounts = ft.launch_counts(), at.launch_counts()
        cfg = model.cfg
        steps, n_val = stats["final_step"] - stats["start_step"], len(stats["val_ms"])
        n_att = 2 * cfg.num_dp_layers * cfg.num_tf_layers
        per_eval = at.launches_per_step(n_att, cfg.remat_layers, train=False)
        if name == "fused":
            per_step = {k: v * 2 * cfg.num_dp_layers for k, v in ft.launches_per_train_stack(cfg.num_tf_layers).items()}
            want = {k: v * steps for k, v in per_step.items()}
            fwant = {k: v * n_val for k, v in per_eval.items()}
        else:
            per_step = at.launches_per_step(n_att, cfg.remat_layers)
            want = dict.fromkeys(counts, 0)
            fwant = {k: per_step[k] * steps + per_eval.get(k, 0) * n_val for k in per_step}
        files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ck, "*.ckpt")))
        losses = stats["loss_reads"]
        ok = (counts == want and fcounts == fwant and steps == 9 and losses and all(math.isfinite(v) for v in losses)
              and [f[:16] for f in files if f.startswith("Epoch")] == ["Epoch_0000_00004", "Epoch_0000_00008"]
              and all(torch.isfinite(p).all() for p in model.parameters()))
        log(f"  {name}: {steps} updates, {n_val} validation batches in {took:.1f} s; losses read {[round(v, 4) for v in losses]}; "
            f"launches per update {per_step}; fused-stack kernels {counts} (want {want}); flash kernels {fcounts} "
            f"(want {fwant}); checkpoints {files}; metric writers {stats['metric_writers'] or 'none'}  "
            f"{'ok' if ok else 'FAIL'}")
        # the reference's rule, kept: a Best file is written when a validation reaches best_val,
        # which starts at 0.0 dB
        best = [f for f in files if f.startswith("Best")]
        saved = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(ck))
        log(f"  {name}: Best file {best or 'none'} (best_val {saved['best_val']:.2f} dB; one is written only when a "
            "validation SI-SNR reaches best_val, initially 0.0, as in the reference loop)")
        if bool(best) != any(float(f.split('_')[3][:-5]) >= 0 for f in files if f.startswith("Epoch")):
            ok = False
        if not ok:
            failures.append(f"trainer {name}")
            fail(f"trainer checks failed: {failures}")
        rate = stats.get("sustained_mixtures_per_s", float("nan"))
        val_ms = statistics.median(stats["val_ms"][1:]) if n_val > 1 else stats["val_ms"][0]
        log(f"  {name}: sustained {rate:.3f} mixtures/s (the loop's own line: validation and checkpoints inside); "
            f"validation {val_ms:.1f} ms per batch (median, host clock; first {stats['val_ms'][0]:.1f}); "
            f"host->device {stats['h2d_bytes'] / 1e6:.2f} MB per batch; peak memory {peak / 2**30:.3f} GiB  [{card}]")
        out[name] = {"updates": steps, "seconds": took, "losses": losses, "launches": counts, "flash_launches": fcounts,
                     "sustained_mixtures_per_s": rate, "val_ms": stats["val_ms"], "h2d_bytes": stats["h2d_bytes"],
                     "peak_bytes": peak, "checkpoints": files}
        del model
        torch.cuda.empty_cache()
        # a second call resumes from the saved step; its steps 9 and 10 (each with the next batch's
        # preparation, and the loss read between them) run under the loop's own profiler window
        stats = {"profile_steps": (9, 11)}
        train_net(parse_train_args(base + extra + ["--checkpoint_dir", ck, "--resume", "--from_ckpt",
                                                   "--tot_iters", "10"]), "context", stats=stats)
        prof = stats["profile"]
        synth = prof.get("range_ms", {}).get("prepare_batch", [])
        ok = (stats["start_step"] == 8 and stats["final_step"] == 11 and all(math.isfinite(v) for v in stats["loss_reads"])
              and len(synth) == 2 and min(synth) > 0 and 0 < prof["busy_share"] <= 1)
        log(f"  {name}: resume --from_ckpt --tot_iters 10: started at step {stats['start_step']} (saved 8), ended at "
            f"{stats['final_step']}, losses {[round(v, 4) for v in stats['loss_reads']]}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trainer resume {name}")
            fail(f"trainer checks failed: {failures}; profile {prof}")
        log(f"  {name}: two loop iterations of that run under torch.profiler: device wall {prof['wall_ms']:.1f} ms, "
            f"kernels {prof['kernel_ms']:.1f} ms, busy share {prof['busy_share']:.4f}, longest idle gap "
            f"{prof['longest_idle_gap_ms']:.3f} ms; device time of the work launched by the next batch's preparation "
            f"(copies + synthesize_batch, kernels summed) {[round(v, 3) for v in synth]} ms  [{card}]")
        out[name].update(profile=prof, synthesize_ms=synth,
                         resume={"start_step": stats["start_step"], "final_step": stats["final_step"]})
        torch.cuda.empty_cache()
    return out


TINY_ARGS = ["--synthetic_smoke", "--debug_tiny_model", "--train_data", "dailytalk", "--tot_iters", "3",
             "--batch_size", "2", "--eval_step", "2", "--max_ctx_tokens", "16", "--workers", "2", "--log_every", "1",
             "--lr", "1e-3", "--warmup_iteration", "1"]


def phase12_kernels(gen, failures):
    """(a) each kernel the tiny trainer runs, against its plain version at the
    tiny model's own shapes (d_model 32, 4 heads of width 8, FFN 64; B=2 of
    16 s and of 2 s: intra L 50 over 2564 chunks, inter L 1282 (the two-pass
    route) and 162)."""
    from cse_tpu_torch.core.flags import parse_train_args
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.segmentation import segment_shapes
    from cse_tpu_torch.train.loop import build_model

    cfg = build_model(parse_train_args(TINY_ARGS), "base")[0].cfg
    D, H, F_, K = cfg.d_model, cfg.nhead, cfg.d_ffn, cfg.chunk_size
    hd, B = D // H, 2
    shapes = {}
    for sec in (16, 2):
        _, S = segment_shapes((sec * 8000 - cfg.enc_kernel) // cfg.enc_stride + 1, K)
        shapes[f"{sec} s intra"], shapes[f"{sec} s inter"] = (B * S, K), (B * K, S)
    del shapes["2 s intra"]  # the same L as at 16 s
    log(f"[12a] tiny-model kernels vs plain versions at D={D}, {H} heads of width {hd}, FFN {F_}, B={B}: "
        f"{', '.join(f'{k} G={g} L={l}' for k, (g, l) in shapes.items())} (fp32: max_rel <= {TOL_FP32:.0e}; "
        f"bf16: rel_l2 <= {TOL_BF16:.0e})")
    err = {}

    def held(key, e):
        err[key] = max(err.get(key, 0.0), e)

    for cd in (torch.float32, torch.bfloat16):
        tag = "fp32" if cd == torch.float32 else "bf16"
        for shape_name, (G, L) in shapes.items():
            M = G * L
            qkv = 2 * torch.randn(M, 3 * D, device="cuda", generator=gen)
            held("attention", check(f"attention {tag} {shape_name} L={L}", fs.attention(qkv, L, H, cd),
                                    fs.attention_plain(qkv, L, H, cd), cd, failures))
            if cd == torch.bfloat16:
                held("attention[w8a8]", check(
                    f"attention bf16 -> fp32 out {shape_name}", fs.attention(qkv, L, H, torch.float32, None, cd),
                    fs.attention_plain(qkv, L, H, torch.float32, None, cd), cd, failures))
            sk, sp = (torch.empty(2, M, H, device="cuda") for _ in range(2))
            held("attention_stats", check(f"attention+stats {tag} {shape_name} out", fs.attention(qkv, L, H, cd, sk),
                                          fs.attention_plain(qkv, L, H, cd, sp), cd, failures))
            held("attention_stats", check(f"attention+stats {tag} {shape_name} stats", sk, sp, torch.float32,
                                          failures))
            dattn = torch.randn(M, D, device="cuda", generator=gen)
            (got, gb), (want, wb) = (ft.attention_backward(qkv, dattn, sp, L, H, cd),
                                     ft.attention_backward_plain(qkv, dattn, sp, L, H, cd))
            held("attention_backward", check(f"attention_backward {tag} {shape_name} dqkv", got, want, cd, failures))
            held("attention_backward", check(f"attention_backward {tag} {shape_name} dbias (q, v)", ft.qv_part(gb),
                                             ft.qv_part(wb), cd, failures))
            same_bits(f"attention_backward {tag} {shape_name}", (got, gb),
                      ft.attention_backward(qkv, dattn, sp, L, H, cd), failures)
            del qkv, sk, sp, dattn, got, want
            q, k, v, do = (torch.randn(G, H, L, hd, device="cuda", generator=gen).to(cd) for _ in range(4))
            (o, lse), (po, plse) = at.flash_fwd(q, k, v), at.flash_fwd_plain(q, k, v)
            held("flash_fwd", check(f"flash_fwd {tag} {shape_name} o", o, po, cd, failures))
            held("flash_fwd", check(f"flash_fwd {tag} {shape_name} lse", lse, plse, torch.float32, failures))
            got, want = at.flash_bwd(q, k, v, po, plse, do), at.flash_bwd_plain(q, k, v, po, plse, do)
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                held("flash_bwd", check(f"flash_bwd {tag} {shape_name} {gname}", g, w, cd, failures))
            if cd == torch.bfloat16:
                same_bits(f"flash_bwd {tag} {shape_name} ({at.flash_bwd_info(L, hd)['route']})", got,
                          at.flash_bwd(q, k, v, po, plse, do), failures)
            del q, k, v, do, o, lse, po, plse, got, want
            # the LayerNorms: the forward, and the backward as the fused step calls it (ln2: g_in in cd or
            # fp32 into a fresh fp32 g_out; ln1: fp32 g_in updated in place)
            x = 3 * torch.randn(M, D, device="cuda", generator=gen)
            sc, bs = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen) for _ in range(2))
            got = fs.layer_norm(x, sc, bs, cd)
            held("layer_norm", check(f"layer_norm {tag} {shape_name} [{M},{D}]", got,
                                     fs.layer_norm_plain(x, sc, bs, cd), cd, failures))
            same_bits(f"layer_norm {tag} {shape_name}", (got,), (fs.layer_norm(x, sc, bs, cd),), failures)
            dh = torch.randn(M, D, device="cuda", generator=gen)
            g32 = torch.randn(M, D, device="cuda", generator=gen)
            for gname, g, in_place in (("g_in bf16", g32.bfloat16(), False), ("g_in fp32", g32, False),
                                       ("g_in fp32 in place", g32, True)):
                name = f"layer_norm_backward {tag} {shape_name} [{M},{D}] {gname}"
                out_cd = None if in_place and cd == torch.float32 else cd  # ln1 of the fp32 step: no cd copy

                def run(kernel, g=g, in_place=in_place, out_cd=out_cd):
                    gi = g.clone()
                    return kernel(dh, x, sc, gi, gi if in_place else torch.empty(M, D, device="cuda"), out_cd)

                (k32, kcd, ks), (p32, pcd, ps) = run(ft.layer_norm_backward), run(ft.layer_norm_backward_plain)
                held("layer_norm_backward", check(f"{name} g_out fp32", k32, p32, torch.float32, failures))
                if out_cd is not None:
                    held("layer_norm_backward", check(f"{name} g_out cd ({tag})", kcd, pcd, cd, failures))
                held("layer_norm_backward", check(f"{name} sums", ks, ps, torch.float32, failures))
                same_bits(name, [t for t in (k32, kcd, ks) if t is not None],
                          [t for t in run(ft.layer_norm_backward) if t is not None], failures)
            del x, got, dh, g32, k32, kcd, ks, p32, pcd, ps
            if shape_name == "2 s inter":
                continue
            # the forward's four products and the backward's three dX products
            for Kd, N, epi in ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual"),
                               (F_, D, "bias"), (D, D, "bias"), (3 * D, D, "bias")):
                a = torch.randn(M, Kd, device="cuda", generator=gen).to(cd)
                w = (torch.randn(Kd, N, device="cuda", generator=gen) / math.sqrt(Kd)).to(cd)
                bias = 0.1 * torch.randn(N, device="cuda", generator=gen)
                res = torch.randn(M, N, device="cuda", generator=gen) if epi == "residual" else None
                held("linear", check(f"linear {tag} {shape_name} [{M},{Kd}]x[{Kd},{N}] {epi}",
                                     fs.linear(a, w, bias, epi, None if res is None else res.clone()),
                                     fs.linear_plain(a, w, bias, epi, res), cd, failures))
                dy = torch.randn(M, N, device="cuda", generator=gen).to(cd)
                dw = ft.weight_grad(a, dy)
                held("weight_grad", check(f"weight_grad {tag} {shape_name} [{M},{Kd}]^T x [{M},{N}]",
                                          dw, ft.weight_grad_plain(a, dy), cd, failures))
                same_bits(f"weight_grad {tag} {shape_name} [{M},{Kd}]^T x [{M},{N}]", (dw,),
                          (ft.weight_grad(a, dy),), failures)
                del a, w, res, dy
            dy = torch.randn(M, D, device="cuda", generator=gen).to(cd)
            wt = (torch.randn(D, F_, device="cuda", generator=gen) / math.sqrt(D)).to(cd)
            mask = torch.relu(torch.randn(M, F_, device="cuda", generator=gen)).to(cd)
            (o, cs), (ro, rcs) = ft.linear_relu_grad(dy, wt, mask), ft.linear_relu_grad_plain(dy, wt, mask)
            held("linear_relu_grad", check(f"linear_relu_grad {tag} {shape_name} [{M},{D}]x[{D},{F_}]", o, ro, cd,
                                           failures))
            held("linear_relu_grad", check(f"linear_relu_grad {tag} {shape_name} colsum", cs, rcs, cd, failures))
            del dy, wt, mask, o, ro
            torch.cuda.empty_cache()
    if failures:
        fail(f"tiny-model kernel checks failed: {failures}")
    return {"shapes": shapes, "max_abs_err": err}


def phase12(card, failures):
    """The tiny trainer (--debug_tiny_model: d_model 32, 4 heads, head width
    8, 16 s of audio, so the inter-chunk attention takes L > 256) on the card:
    (b) fp32 on its default fused step, layer by layer with the flash kernels
    and remat='layer', and layer by layer without either (no kernel of the
    port: the reference); the kernels' runs must read the reference's losses,
    before the first update and after each of three (lr 1e-3 from the first
    step), within TOL_TINY_LOSS; (c) bf16 on both kernel paths: finite losses."""
    import tempfile

    from cse_tpu_torch.core.flags import parse_train_args
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.train.loop import train_net

    log(f"[12b] tiny trainer: train_net(parse_train_args({' '.join(TINY_ARGS)}), 'base')  [{card}]")
    runs = (("fp32 fused", []), ("fp32 flash", ["--no_fused_train", "--flash_attention", "--remat", "layer"]),
            ("fp32 reference", ["--no_fused_train"]), ("bf16 fused", ["--bf16"]),
            ("bf16 flash", ["--bf16", "--no_fused_train", "--flash_attention", "--remat", "layer"]))
    out = {}
    for name, extra in runs:
        fs.reset_launches()
        ft.reset_launches()
        at.reset_launches()
        stats, t0 = {}, time.time()
        model = train_net(parse_train_args(TINY_ARGS + extra + ["--checkpoint_dir", tempfile.mkdtemp(prefix="cse_tiny_")]),
                          "base", stats=stats)
        torch.cuda.synchronize()
        counts, fcounts, scounts = ft.launch_counts(), at.launch_counts(), fs.launch_counts()
        cfg = model.cfg
        hd = cfg.d_model // cfg.nhead
        losses = stats["loss_reads"]
        if name.endswith("fused"):
            ran = all(counts[k] > 0 for k in ("attention", "attention_backward", "linear", "linear_relu_grad"))
        elif name.endswith("flash"):
            ran = fcounts["flash_fwd"] > 0 and fcounts["flash_bwd"] > 0
        else:  # the reference launches no kernel of the port
            ran = not any(counts.values()) and not any(fcounts.values()) and not any(scounts.values())
        ok = (hd == 8 and ran and stats["final_step"] == 4 and len(losses) == 4
              and all(math.isfinite(v) for v in losses) and all(torch.isfinite(p).all() for p in model.parameters()))
        log(f"  {name}: head width {hd}, {stats['final_step']} steps in {time.time() - t0:.1f} s, losses "
            f"{losses}; fused-step kernels {counts}; flash kernels {fcounts}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"tiny trainer {name}")
        out[name] = {"head_width": hd, "losses": losses, "launches": counts, "flash_launches": fcounts}
        del model
        torch.cuda.empty_cache()
    ref = out["fp32 reference"]["losses"]
    for name in ("fp32 fused", "fp32 flash"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(out[name]["losses"], ref))
        ok = rel <= TOL_TINY_LOSS
        log(f"  {name} vs fp32 reference: max relative loss difference {rel:.3e} (<= {TOL_TINY_LOSS:.0e})  "
            f"{'ok' if ok else 'FAIL'}")
        out[name]["max_rel_loss_diff"] = rel
        if not ok:
            failures.append(f"tiny trainer {name} vs reference")
    if failures:
        fail(f"tiny trainer checks failed: {failures}")
    return out


def _recording_eval_steps(step_lib, recorded):
    """Wrap make_eval_step so that each step the CLI builds keeps every batch's
    model inputs and enhanced output (for holding them against plain fp32) and
    a pair of CUDA events around the step's work."""
    orig = step_lib.make_eval_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recording(batch):
            t_s, t_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t_s.record()
            out = step(batch)
            t_e.record()
            recorded.append((batch, out[0], t_s, t_e))
            return out
        return recording
    return orig, make


def _timed_evaluate(ev_lib, seconds):
    """Wrap evaluate so that its host seconds alone (no corpus, model or loader
    set-up) land in ``seconds``."""
    orig = ev_lib.evaluate

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            seconds.append(time.perf_counter() - t0)
    return orig, timed


def phase13(card, failures):
    """The eval entry point at full width: a released checkpoint's round trip,
    then python -m cse_tpu_torch.test on it (fused and flash) and on ContSep."""
    import os
    import tempfile

    from cse_tpu_torch import test as eval_cli
    from cse_tpu_torch.compat.torch_export import save_torch_checkpoint
    from cse_tpu_torch.compat.torch_import import sepformer_from_state_dict
    from cse_tpu_torch.eval import evaluator as ev_lib
    from cse_tpu_torch.models.context_encoder import build_context_encoder
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.serving import sepformer_fused_forward
    from cse_tpu_torch.train import checkpoint as ckpt_lib
    from cse_tpu_torch.train import step as step_lib

    root = tempfile.mkdtemp(prefix="cse_eval_")
    gen = torch.Generator().manual_seed(13)
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16)
    model = Sepformer(cfg, generator=gen)
    with torch.no_grad():  # no parameter at its init value (biases 0, norms 1)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    ckpt = os.path.join(root, "ckpts", "released.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    save_torch_checkpoint(ckpt, model)
    log(f"[13] eval entry point, full width: released checkpoint {os.path.getsize(ckpt) / 2**20:.1f} MiB  [{card}]")

    # (a) the round trip: the same bits in every entry and through the bf16 fused forward
    restored = ckpt_lib.restore_checkpoint(ckpt)
    back = Sepformer(cfg)
    back.load_state_dict(sepformer_from_state_dict(restored["state_dict"], cfg.num_dp_layers, cfg.num_tf_layers))
    a_sd, b_sd = model.state_dict(), back.state_dict()
    differ = [k for k in a_sd if not torch.equal(a_sd[k], b_sd[k])]
    B, T = 16, aligned_bucket(128000)
    mix = torch.randn(B, T, device="cuda", generator=torch.Generator(device="cuda").manual_seed(13))
    ctx = torch.randn(B, 1, 4096, device="cuda", generator=torch.Generator(device="cuda").manual_seed(14))
    fs.reset_launches()
    # the decoder's cuDNN conv_transpose1d picks a non-deterministic algorithm by
    # default (two calls differ by ~1e-3 in bf16); the bits are compared under
    # cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    try:
        o1 = sepformer_fused_forward(model.cuda().eval(), mix, ctx)
        o2 = sepformer_fused_forward(back.cuda().eval(), mix, ctx)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    same = torch.equal(o1, o2) and bool(torch.isfinite(o1).all())
    log(f"  (a) {len(a_sd)} state_dict entries, {len(differ)} with other bits; bf16 fused forward B={B} T={T} "
        f"(cuDNN deterministic): {'same bits' if same else 'OTHER BITS'}; launches {fs.launch_counts()}")
    if differ or set(a_sd) != set(b_sd) or not same or not fs.launch_counts()["attention"]:
        fail(f"released checkpoint round trip: entries {differ[:5]}, forward same bits {same}")
    plain_model = Sepformer(SepformerConfig(variant="context", num_spks=2))  # fp32: the fused eval's reference
    plain_model.load_state_dict(model.state_dict())
    del back, o1, o2, mix, ctx, restored, model
    torch.cuda.empty_cache()

    # (b) the CLI; the fused run scores EVAL_MIXTURES for its throughput
    base = ["--synthetic_smoke", "--train_data", "dailytalk", "--bf16", "--max_sp_len", "16",
            "--batch_size", "16", "--synthetic_seconds", "8", "16"]
    runs = (("ContExt --fused_eval", EVAL_MIXTURES, ["--test_model", "ContExt", "--checkpoint", ckpt, "--fused_eval"]),
            ("ContExt --flash_attention", 6, ["--test_model", "ContExt", "--checkpoint", ckpt, "--flash_attention"]),
            ("ContSep --fused_eval", 6, ["--test_model", "ContSep", "--fused_eval"]))
    out = {}
    for name, n_mix, extra in runs:
        save = os.path.join(root, name.split()[0] + ("_fused" if "fused" in name else "_flash"))
        argv = base + extra + ["--save_dir", save, "--synthetic_eval", str(n_mix)]
        recorded, eval_s = [], []
        orig, make = _recording_eval_steps(step_lib, recorded)
        orig_eval, timed = _timed_evaluate(ev_lib, eval_s)
        step_lib.make_eval_step, ev_lib.evaluate = make, timed
        fs.reset_launches()
        at.reset_launches()
        t0 = time.time()
        try:
            res = eval_cli.main(argv)
        finally:
            step_lib.make_eval_step, ev_lib.evaluate = orig, orig_eval
        whole = time.time() - t0
        torch.cuda.synchronize()
        took = eval_s[0]
        step_ms = sum(t_s.elapsed_time(t_e) for _, _, t_s, t_e in recorded)
        busy = step_ms / 1e3 / took
        counts, fcounts = fs.launch_counts(), at.launch_counts()
        n_fwd = len(recorded)
        n_att = 2 * cfg.num_dp_layers * cfg.num_tf_layers
        if "fused" in name:
            want = {k: v * 2 * cfg.num_dp_layers * n_fwd
                    for k, v in fs.launches_per_stack(cfg.num_tf_layers, None, cfg.d_model, cfg.d_ffn).items()}
            fwant = {k: 0 for k in fcounts}
        else:
            want = {k: 0 for k in counts}
            fwant = {k: v * n_fwd for k, v in at.launches_per_step(n_att, False, train=False).items()}
        tag = "ckpts/released" if "--checkpoint" in extra else "random_init"
        files = [os.path.join(save, tag, "2_speaker_0_ctx", f"{f}_dailytalk.txt") for f in ("test_results", "acc")]
        finite = all(math.isfinite(res[k]) for k in ("si_snr", "sdr", "si_snr_i", "sdr_i", "pesq", "pesq_i"))
        lens = sorted({b["mixed"].shape[1] for b, *_ in recorded})
        log(f"  (b) {name}: n {res['n']} in {n_fwd} batches (T {lens[0]}-{lens[-1]}, {len(lens)} lengths); "
            f"evaluate {took:.3f} s -> {res['n'] / took:.3f} mixtures/s (the whole main() {whole:.3f} s); "
            f"eval steps {step_ms:.1f} ms on the card = busy {100 * busy:.2f}%, idle {100 * (1 - busy):.2f}%; "
            f"SI-SNR {res['si_snr']:.4f} SDR {res['sdr']:.4f} SI-SNR-i {res['si_snr_i']:.4f} PESQ "
            f"{res['pesq']:.4f} acc {res['acc']:.4f}; stack launches {counts} (want {want}), flash {fcounts} "
            f"(want {fwant})  [{card}]")
        if not (finite and all(os.path.exists(f) for f in files) and res["n"] == n_mix):
            failures.append(f"eval {name}: files, metrics or n {res['n']} != {n_mix}")
        if counts != want or fcounts != fwant:
            failures.append(f"eval {name}: launches {counts} / {fcounts} != {want} / {fwant}")
        entry = {"n": res["n"], "batches": n_fwd, "seconds": took, "main_seconds": whole,
                 "mixtures_per_s": res["n"] / took, "step_ms": step_ms, "busy_share": busy,
                 "launches": {**counts, **fcounts}, "metrics": {k: res[k] for k in res if k != "n"}}
        if name == "ContExt --fused_eval":
            # every batch's bf16 fused output against the plain fp32 model on the same inputs
            llm_fn, llm_ps = build_context_encoder("__none__", ctx_length=1, device="cuda").pure()
            plain = orig(plain_model, step_lib.TrainConfig(variant="context"), device="cuda", llm_apply=llm_fn,
                         llm_params=llm_ps)
            rl2s = []
            for batch, enhanced, *_ in recorded:
                _, _, rl2 = errs(enhanced, plain(batch)[0])
                rl2s.append(rl2)
            ok = max(rl2s) <= TOL_SERVE_BF16
            log(f"      each batch's output vs the plain fp32 model: rel_l2 {min(rl2s):.3e}-{max(rl2s):.3e} over "
                f"{len(rl2s)} batches (tol {TOL_SERVE_BF16:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("fused eval vs plain fp32")
            entry["rel_l2_vs_fp32"] = rl2s
        out[name] = entry
        del recorded
        torch.cuda.empty_cache()
    if failures:
        fail(f"eval entry point checks failed: {failures}")
    del plain_model
    torch.cuda.empty_cache()
    return out


def phase14(card, references):
    """python -m cse_tpu_torch.bench in subprocesses, in four forms; each value
    beside the in-process number it should match (for reading, not a gate)."""
    from cse_tpu_torch.models.sepformer import SepformerConfig
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft

    cfg = SepformerConfig(variant="context")
    n_stacks = 2 * cfg.num_dp_layers
    train = {k: v * n_stacks for k, v in ft.launches_per_train_stack(cfg.num_tf_layers).items()}
    infer = {k: v * n_stacks for k, v in fs.launches_per_stack(cfg.num_tf_layers, None, cfg.d_model, cfg.d_ffn).items()}
    w8a8 = {k: v * n_stacks
            for k, v in fs.launches_per_stack(cfg.num_tf_layers, "w8a8", cfg.d_model, cfg.d_ffn).items()}
    # (name, flags, metric, the phase to read it beside, launches per step or forward)
    forms = (("default", [], "train_throughput_contextual_extraction", "[7c] mixtures/s", train),
             ("--variant contsep", ["--variant", "contsep"], "train_throughput_contsep", "[7c] mixtures/s", train),
             ("--infer", ["--infer"], "inference_rtf_contextual_extraction", "[4] realtime factor", infer),
             ("--infer --serving_quant w8a8", ["--infer", "--serving_quant", "w8a8"],
              "inference_rtf_contextual_extraction", "[9b] realtime factor", w8a8))
    log(f"[14] python -m cse_tpu_torch.bench, four forms  [{card}]")
    return {name: bench_form(name, extra, metric, ref, references[ref], per_call)
            for name, extra, metric, ref, per_call in forms}


def bench_form(name, extra, metric, ref, ref_value, per_call) -> dict:
    """python -m cse_tpu_torch.bench with ``extra`` in a subprocess: one JSON
    line with ``metric`` and a value > 0, printed beside ``ref`` (this run's
    in-process number), and its launch report (the last line of standard
    error) equal to ``per_call`` times the calls it reports."""
    import os

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "cse_tpu_torch.bench", *extra], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    took = time.time() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if proc.returncode == 0 and len(lines) == 1 else None
    except json.JSONDecodeError:
        line = None
    if line is None:
        fail(f"bench {name}: rc {proc.returncode}, stdout {proc.stdout[-2000:]!r}, stderr {proc.stderr[-3000:]!r}")
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    want = {k: v * report["calls"] for k, v in per_call.items()}
    ok = line["metric"] == metric and math.isfinite(line["value"]) and line["value"] > 0
    launched = report["launches"] == want
    log(f"  {name:<30s} {line['metric']} = {line['value']:.3f} ({line['unit']}); {ref} in this run "
        f"{ref_value:.3f}; {took:.1f} s  {'ok' if ok else 'FAIL'}")
    log(f"  {'':<30s} launches over {report['calls']} calls: {report['launches']} (want {want})  "
        f"{'ok' if launched else 'FAIL'}")
    if not (ok and launched):
        fail(f"bench {name}: {line}, launches {report}")
    return {**line, "seconds": took, "reference": {ref: ref_value}, "launches": report["launches"],
            "calls": report["calls"]}


# [15]'s bars. The same Llama weights on the card and on the CPU: fp32 differs
# only in summation order -> relative L2 <= 1e-4; bf16 on the card against
# fp32 -> <= 2e-2 (the bf16 bar of [3], over 2 layers); int8 weight-only,
# fp32 activations, card against CPU -> <= 1e-3; w8a8 -> <= 1e-2 (a one-ulp
# difference in h / sa flips an activation's int8 rounding by a whole step,
# as in [9a]).
TOL_LLAMA = {"fp32": 1e-4, "bf16": 2e-2, "int8": 1e-3, "w8a8": 1e-2}
HF_MATRICES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
               "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}


def write_safetensors(path, tensors: dict):
    """A safetensors file (u64 header length, JSON header, raw bytes) of CPU
    tensors in fp32 or bf16, written without the safetensors package."""
    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
    header, blobs, off = {}, [], 0
    for k, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)


def write_llama_dir(path, vocab, hidden, inter, layers, heads, kv_heads, dtype, gen, lm_head=True):
    """A Llama checkout (config.json + model.safetensors, HF names and
    [dout, din] layout) of random weights drawn on the card from ``gen``."""
    import os

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": vocab, "hidden_size": hidden, "intermediate_size": inter,
                   "num_hidden_layers": layers, "num_attention_heads": heads, "num_key_value_heads": kv_heads,
                   "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "tie_word_embeddings": False}, f)
    dh = hidden // heads
    dims = {"q": (heads * dh, hidden), "k": (kv_heads * dh, hidden), "v": (kv_heads * dh, hidden),
            "o": (hidden, heads * dh), "gate": (inter, hidden), "up": (inter, hidden), "down": (hidden, inter)}

    def rnd(*shape, scale=1.0, mean=0.0):
        return (mean + scale * torch.randn(*shape, device=gen.device, generator=gen)).to(dtype).cpu()

    t = {"model.embed_tokens.weight": rnd(vocab, hidden, scale=0.02), "model.norm.weight": rnd(hidden, scale=0.1, mean=1.0)}
    if lm_head:
        t["lm_head.weight"] = rnd(vocab, hidden, scale=hidden ** -0.5)
    for i in range(layers):
        t[f"model.layers.{i}.input_layernorm.weight"] = rnd(hidden, scale=0.1, mean=1.0)
        t[f"model.layers.{i}.post_attention_layernorm.weight"] = rnd(hidden, scale=0.1, mean=1.0)
        for name, (dout, din) in dims.items():
            t[f"model.layers.{i}.{HF_MATRICES[name]}.weight"] = rnd(dout, din, scale=din ** -0.5)
    write_safetensors(os.path.join(path, "model.safetensors"), t)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested dict) weight tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def llama_bound(cfg, B, T, quant):
    """The least time of the prefill's work (ms): the layer products' and the
    attention's operations over their peak, or the bytes (weights once, the
    embedded rows and the hidden states out), the larger; and for int8
    weight-only the extra traffic of the bf16 copy each product makes of its
    weight (int8 read + bf16 written + bf16 read), which runs beside it."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, KV, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    weights = L * (D * H * dh + 2 * D * KV * dh + H * dh * D + 3 * D * I)
    tokens = B * T
    mm_ops = 2 * weights * tokens
    att_ops = L * 4 * B * H * T * T * dh
    ops_ms = 1e3 * (mm_ops / (PEAK_INT8 if quant == "w8a8" else PEAK_BF16) + att_ops / PEAK_BF16)
    scales = 0 if quant == "bf16" else 4 * L * (H * dh + 2 * KV * dh + 2 * D + 2 * I)
    norms = 2 * (2 * L + 1) * D
    # weights, scales and norms once; the embedded rows and the ids and mask in; the hidden states out
    nbytes = weights * (2 if quant == "bf16" else 1) + scales + norms + tokens * (2 * D + 8) + tokens * 2 * D
    bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    copy_ms = 1e3 * weights * (1 + 2 + 2) / HBM_BYTES_S if quant == "int8" else 0.0
    return {"weights": weights, "ops": mm_ops + att_ops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "dequant_copy_ms": copy_ms}


# cuBLAS 12.8's Hopper GEMMs are named nvjet_*; its int8 ones carry s8 / imma
PREFILL_KINDS = (("int8 gemm", ("imma", "int8", "s8")),
                 ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")), ("softmax", ("softmax",)),
                 ("reduce", ("reduce",)), ("copy and cast", ("copy", "cat", "index")),
                 ("elementwise", ("elementwise", "vectorized")))


def prefill_split(fn, kinds=PREFILL_KINDS) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of its
    kernels summed by kind (``kinds``: (kind, name fragments), the first that
    matches; by default the library's GEMMs, the int8 GEMMs, softmax,
    reductions, copies and casts, other elementwise), in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            name = e.name.lower()
            kind = next((k for k, keys in kinds if any(x in name for x in keys)), "other")
            out[kind] = out.get(kind, 0.0) + us / 1e3
    return out


def phase15(card, failures, references):
    """The frozen Llama-3 context encoder (cse_tpu_torch/models/llama.py): (a)
    the same tiny checkout loaded on the card and on the CPU in fp32, bf16,
    int8 and w8a8; (b) the 32-layer 8B shape on random weights in bf16, int8
    and w8a8: weight bytes, peak memory, the bare prefill at B=8 x 512 tokens
    beside its bound; (c) the bench's --with_llm forms in subprocesses; (d)
    train_net on a Llama checkout at the real width (2 layers), int8."""
    import os
    import tempfile

    from cse_tpu_torch.models import llama as tl

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(15)
    # ---- (a) parity on the card
    root = tempfile.mkdtemp(prefix="cse_llama_tiny_")
    write_llama_dir(root, vocab=320, hidden=64, inter=128, layers=2, heads=4, kv_heads=2, dtype=torch.float32,
                    gen=gen)
    log(f"[15a] Llama parity, card against CPU: vocab 320, hidden 64, 2 layers, 4 query / 2 key-value heads, "
        f"B=3 x T=24 left-padded by 0 / 7 / 23  [{card}]")
    B, T = 3, 24
    ids = torch.randint(1, 320, (B, T), generator=torch.Generator().manual_seed(0))
    mask = torch.ones(B, T, dtype=torch.int32)
    for b, pad in enumerate((0, 7, T - 1)):
        ids[b, :pad] = 0
        mask[b, :pad] = 0
    small_ids, small_mask = ids[:2, -8:].contiguous(), mask[:2, -8:].contiguous()  # 16 rows: _int_mm's padding
    parity = {}
    for form, dtype, quant in (("fp32", torch.float32, None), ("bf16", torch.bfloat16, None),
                               ("int8", torch.float32, "int8"), ("w8a8", torch.float32, "w8a8")):
        # the CPU form: fp32 activations, the same quantization (bf16 is held against fp32)
        pc, cfg = tl.load_llama_params(root, dtype=torch.float32, quant=quant, device="cpu")
        pg, _ = tl.load_llama_params(root, dtype=dtype, quant=quant, device="cuda")
        rows = {"hidden": (tl.llama_forward(pg, ids, mask, cfg).float().cpu(), tl.llama_forward(pc, ids, mask, cfg))}
        if form in ("fp32", "w8a8"):
            rows["logits"] = (tl.llama_forward(pg, ids, mask, cfg, return_logits=True).cpu(),
                              tl.llama_forward(pc, ids, mask, cfg, return_logits=True))
        if form == "w8a8":
            rows["16 rows"] = (tl.llama_forward(pg, small_ids, small_mask, cfg).cpu(),
                               tl.llama_forward(pc, small_ids, small_mask, cfg))
        parity[form] = {}
        for what, (g, w) in rows.items():
            mx, _, rl2 = errs(g, w)
            ok = rl2 <= TOL_LLAMA[form] and bool(torch.isfinite(g).all())
            log(f"  {form:<5s} {what:<7s} card vs {'CPU fp32' if form == 'bf16' else 'CPU'}: max_abs {mx:.3e} "
                f"rel_l2 {rl2:.3e} (tol {TOL_LLAMA[form]:.0e}); finite at every position  {'ok' if ok else 'FAIL'}")
            parity[form][what] = {"max_abs": mx, "rel_l2": rl2}
            if not ok:
                failures.append(f"llama {form} {what}")
        del pc, pg
    out["parity"] = parity
    if failures:
        fail(f"Llama parity failed: {failures}")

    # ---- (b) the 8B shape, random weights on the card
    cfg = tl.LlamaConfig()
    B, T = 8, 512
    log(f"[15b] Llama-3-8B shape (32 layers, 4096 / 14336, 32 query / 8 key-value heads, vocab 128256), random "
        f"weights, no LM head; bare prefill at B={B} x {T} tokens, median of 5 after 2 warmups  [{card}]")
    ids = torch.randint(0, cfg.vocab_size, (B, T), device="cuda", generator=gen)
    mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    prefill = {}
    for form in ("bf16", "int8", "w8a8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = tl.random_llama_params(cfg, dtype=torch.bfloat16, quant=None if form == "bf16" else form,
                                        with_lm_head=False, device="cuda")
        torch.cuda.synchronize()
        built_s = time.time() - t0
        h = tl.llama_forward(params, ids, mask, cfg)
        finite = bool(torch.isfinite(h).all())
        del h
        times = cuda_ms(lambda: tl.llama_forward(params, ids, mask, cfg))
        ms = statistics.median(times)
        b = llama_bound(cfg, B, T, form)
        split = prefill_split(lambda: tl.llama_forward(params, ids, mask, cfg))
        r = {"weight_bytes": tree_bytes(params), "peak_bytes": torch.cuda.max_memory_allocated(), "ms": ms,
             "times_ms": times, "built_s": built_s, "finite": finite, "split_ms": split, **b}
        prefill[form] = r
        extra = f", + {b['dequant_copy_ms']:.2f} ms of bf16 weight copies" if form == "int8" else ""
        log(f"  {form:<5s} weights {r['weight_bytes'] / 1e9:.3f} GB, peak {r['peak_bytes'] / 2**30:.3f} GiB, drawn "
            f"in {built_s:.1f} s; prefill {ms:.3f} ms ({[round(t, 3) for t in times]}); bound {b['bound_ms']:.2f} ms "
            f"({b['bound_by']}: {b['ops'] / 1e12:.1f} TOP{extra}); {b['bound_ms'] / ms:.1%} of the bound; hidden "
            f"states finite {finite}  {'ok' if finite else 'FAIL'}")
        log(f"  {form:<5s} one profiled prefill, device ms by kind: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
        del params
        if not finite:
            fail(f"Llama 8B {form} prefill gave non-finite hidden states")
    out["prefill"] = prefill
    torch.cuda.empty_cache()

    # ---- (c) the bench with the prefill in the step
    from cse_tpu_torch.models.sepformer import SepformerConfig
    from cse_tpu_torch.ops import fused_train as ft

    scfg = SepformerConfig(variant="context")
    train = {k: v * 2 * scfg.num_dp_layers for k, v in ft.launches_per_train_stack(scfg.num_tf_layers).items()}
    log(f"[15c] python -m cse_tpu_torch.bench --with_llm, three forms (B=8, 8B shape, prefill in the step)  [{card}]")
    benches = {}
    for name, extra in (("--with_llm", []), ("--with_llm --llama_quant w8a8", ["--llama_quant", "w8a8"]),
                        ("--with_llm --ctx_sim", ["--ctx_sim"])):
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "cse_tpu_torch.bench", "--with_llm", *extra], capture_output=True,
                              text=True, timeout=400, cwd=os.path.dirname(os.path.abspath(__file__)))
        took = time.time() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if proc.returncode == 0 and len(lines) == 1 else None
        except json.JSONDecodeError:
            line = None
        if line is None:
            fail(f"bench {name}: rc {proc.returncode}, stdout {proc.stdout[-2000:]!r}, stderr {proc.stderr[-3000:]!r}")
        err = proc.stderr.strip().splitlines()
        report, decomposition = json.loads(err[-1]), err[-2]
        want = {k: v * report["calls"] for k, v in train.items()}
        ok = (line["metric"] == "train_throughput_contextual_extraction_with_llm" and math.isfinite(line["value"])
              and line["value"] > 0 and decomposition.startswith("bench decomposition: bare"))
        launched = report["launches"] == want
        log(f"  {name:<30s} {line['metric']} = {line['value']:.3f} ({line['unit']}); {took:.1f} s  "
            f"{'ok' if ok else 'FAIL'}")
        log(f"  {'':<30s} {decomposition}; [7c] without the Llama at B=16: {references['[7c] mixtures/s']:.3f}")
        log(f"  {'':<30s} launches over {report['calls']} calls: {report['launches']} (want {want})  "
            f"{'ok' if launched else 'FAIL'}")
        if not (ok and launched):
            fail(f"bench {name}: {line}, launches {report}")
        benches[name] = {**line, "seconds": took, "decomposition": decomposition, "launches": report["launches"],
                         "calls": report["calls"]}
    out["bench"] = benches

    # ---- (d) the trainer on a Llama checkout at the real width
    from cse_tpu_torch.core.flags import parse_train_args
    from cse_tpu_torch.data.audio_io import native
    from cse_tpu_torch.data.synthetic import make_synthetic_corpus
    from cse_tpu_torch.train.loop import train_net

    if native() is None:
        fail("the native WAV decoder (cse_tpu_torch/native) did not build or load on this machine")
    t0 = time.time()
    ldir = tempfile.mkdtemp(prefix="cse_llama_4096_")
    write_llama_dir(ldir, vocab=128256, hidden=4096, inter=14336, layers=2, heads=32, kv_heads=8,
                    dtype=torch.bfloat16, gen=gen, lm_head=False)
    write_s = time.time() - t0
    info = make_synthetic_corpus(tempfile.mkdtemp(prefix="cse_corpus_"), n_dialogs=24, turns_per_dialog=8,
                                 seconds=(8.0, 16.0))
    argv = ["--train_data", "dailytalk", "--dailytalk_data_path", info["dailytalk_data_path"],
            "--acoustic_noise_path", info["acoustic_noise_path"], "--lists_root", info["lists_root"],
            "--llama_path", ldir, "--llama_int8", "--allow_stub_nets", "--bf16", "--batch_size", "16",
            "--max_sp_len", "16", "--augmentation", "--noise_add", "--log_every", "2", "--eval_step", "100",
            "--tot_iters", "8", "--workers", "8", "--checkpoint_dir", tempfile.mkdtemp(prefix="cse_ckpt_llama_")]
    log(f"[15d] trainer with a Llama checkout (hidden 4096, 32 / 8 heads, intermediate 14336, 2 layers, vocab "
        f"128256, bf16 on disk, written in {write_s:.1f} s; no tokenizer files: ByteTokenizer): train_net("
        f"parse_train_args({' '.join(a if not a.startswith('/') else '<dir>' for a in argv)}), 'context')  [{card}]")
    ft.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stats, text = {}, io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(text), torch.enable_grad():
        model = train_net(parse_train_args(argv), "context", stats=stats)
    torch.cuda.synchronize()
    took = time.time() - t0
    banner = [ln for ln in text.getvalue().splitlines() if "external nets:" in ln]
    for ln in text.getvalue().splitlines():
        if any(k in ln for k in ("external nets:", "train path:", "sustained", "Total Iteration")):
            log(f"  | {ln}")
    steps = stats["final_step"] - stats["start_step"]
    per_step = {k: v * 2 * model.cfg.num_dp_layers for k, v in ft.launches_per_train_stack(model.cfg.num_tf_layers).items()}
    counts, want = ft.launch_counts(), {k: v * steps for k, v in per_step.items()}
    losses = stats["loss_reads"]
    rate = stats.get("sustained_mixtures_per_s", float("nan"))
    ok = (bool(banner) and "llm=real" in banner[0] and counts == want and steps == 9 and bool(losses)
          and all(math.isfinite(v) for v in losses) and math.isfinite(rate))
    log(f"  banner: {banner}; {steps} updates in {took:.1f} s; losses read {[round(v, 4) for v in losses]}; "
        f"launches {counts} (want {want}, per update {per_step})  {'ok' if ok else 'FAIL'}")
    log(f"  sustained {rate:.3f} mixtures/s (the loop's own line) beside [11]'s fused {references['[11] fused']:.3f} "
        f"(the stub encoder); peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    if not ok:
        failures.append("llama trainer")
        fail(f"Llama trainer checks failed: {text.getvalue()[-3000:]}")
    out["trainer"] = {"updates": steps, "seconds": took, "losses": losses, "launches": counts,
                      "sustained_mixtures_per_s": rate, "banner": banner, "write_s": write_s,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    del model
    torch.cuda.empty_cache()
    return out


# [16]'s bars. ECAPA on the card against the CPU in fp32 with TF32 off: the
# same arithmetic in another summation order -> relative L2 <= 1e-4 for the
# fbank, the embedding and the spectral stand-in; the enrollment crop is a
# gather and a mask -> the same bits.
TOL_ECAPA = 1e-4
# the ECAPA forward's kernels by kind: cuDNN's convolutions and the GEMMs of
# its k=1 convolutions, the FFT of the fbank, the rest
ECAPA_KINDS = (("fft", ("fft",)),
               ("convolution", ("conv", "implicit", "winograd", "gemm", "nvjet", "xmma", "cutlass", "sm90_", "cudnn")),
               ("reduce and softmax", ("reduce", "softmax")), ("copy and cat", ("copy", "cat", "index")),
               ("elementwise", ("elementwise", "vectorized")))


def ecapa_work(module, wav, lengths) -> dict:
    """What one ECAPA forward on these inputs must do: the operations of its
    products (2 · outputs · cin · k for each convolution, counted by hooks on
    this forward, and the mel product; the FFT and the elementwise passes
    left out, so the bound stays a lower one), the bytes it must move (the
    waveform and lengths read, the weights read, the embedding written) and,
    for reading, the bytes of the convolutions' outputs."""
    B, T = wav.shape
    ops = [2.0 * B * (1 + T // 160) * 201 * module.n_mels]
    acts = [0]

    def hook(m, inp, out):
        ops.append(2.0 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0])
        acts[0] += out.numel() * out.element_size()

    convs = [m for m in module.modules() if isinstance(m, torch.nn.Conv1d)]
    handles = [m.register_forward_hook(hook) for m in convs]
    try:
        with torch.no_grad():
            emb = module(wav, lengths)
    finally:
        for h in handles:
            h.remove()
    weights = sum(t.numel() * t.element_size() for t in module.state_dict().values())
    nbytes = wav.numel() * wav.element_size() + lengths.numel() * lengths.element_size() + weights \
        + emb.numel() * emb.element_size()
    return {"ops": sum(ops), "bytes": nbytes, "weight_bytes": weights, "activation_bytes": acts[0]}


def phase16(card, failures, references):
    """H-ContExt (cse_tpu_torch/models/ecapa.py, speaker_encoder.py: no kernel
    of the port; #1, #3 and #4 beside it): (a) ECAPA at full width, the
    stand-in and the enrollment crop, card against CPU; (b) the ECAPA forward
    at the trainer's shape beside its bound, split by kernel kind; (c) the
    bench's hcontext recipe in a subprocess; (d) train_net(..., 'hcontext') at
    full width on a speechbrain-layout .ckpt written here; (e)
    cse_tpu_torch.test_HContExt.main --fused_eval for each cue, and --one_sec."""
    import copy
    import dataclasses
    import os
    import tempfile

    from cse_tpu_torch import test_HContExt as hc_cli
    from cse_tpu_torch.core.flags import parse_train_args
    from cse_tpu_torch.data.pipeline import crop_enrollment, draw_enrollment
    from cse_tpu_torch.models.context_encoder import build_context_encoder
    from cse_tpu_torch.models.ecapa import EcapaEncoder, EcapaTDNN, log_mel_fbank
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.models.speaker_encoder import SpectralSpeakerEncoder
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.train import loop as loop_lib
    from cse_tpu_torch.train import step as step_lib

    out = {}
    # ---- (a) card against CPU on one module (random weights, BatchNorm off its identity)
    gen = torch.Generator().manual_seed(16)
    module = EcapaTDNN(generator=gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 0.5 * torch.rand(c, generator=gen))
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
    B = 4
    lens = torch.randint(16000, 80001, (B,), generator=gen)  # 1-5 s rows in 5 s buffers
    wav = 0.3 * torch.randn(B, 80000, generator=gen) * (torch.arange(80000)[None, :] < lens[:, None])
    log(f"[16a] ECAPA-TDNN at full width (1024 channels, 80 mels, 192-d; random weights), card against CPU, "
        f"TF32 off, B={B} rows of {lens.tolist()} samples in 80000  [{card}]")
    cpu_enc = EcapaEncoder(module=copy.deepcopy(module), device="cpu")
    gpu_enc = EcapaEncoder(module=module, device="cuda")
    stand = SpectralSpeakerEncoder()
    rows = {"fbank": (log_mel_fbank(wav.cuda(), lengths=lens.cuda()).cpu(), log_mel_fbank(wav, lengths=lens)),
            "embedding": (gpu_enc(wav, lens).cpu(), cpu_enc(wav, lens)),
            "stand-in": (copy.deepcopy(stand).cuda()(wav, lens).cpu(), stand(wav, lens))}
    parity = {}
    for name, (got, ref) in rows.items():
        mx, _, rl2 = errs(got, ref)
        ok = rl2 <= TOL_ECAPA and bool(torch.isfinite(got).all())
        log(f"  {name:<10s} {tuple(got.shape)} max_abs {mx:.3e} rel_l2 {rl2:.3e} (tol {TOL_ECAPA:.0e})  "
            f"{'ok' if ok else 'FAIL'}")
        parity[name] = rl2
        if not ok:
            failures.append(f"ecapa {name}")
    gt16k = torch.randn(B, 256000, generator=gen)
    glen = torch.tensor([256000, 100000, 12000, 0], dtype=torch.int32)
    seconds, u = draw_enrollment(B, torch.Generator().manual_seed(17))
    c_cpu = crop_enrollment(gt16k, glen, seconds, u)
    c_gpu = crop_enrollment(gt16k.cuda(), glen.cuda(), seconds.cuda(), u.cuda())
    s_gpu, u_gpu = draw_enrollment(64, torch.Generator(device="cuda").manual_seed(17))
    same = torch.equal(c_gpu[0].cpu(), c_cpu[0]) and torch.equal(c_gpu[1].cpu(), c_cpu[1])
    drawn = s_gpu.device.type == "cuda" and 1 <= int(s_gpu.min()) and int(s_gpu.max()) <= 5 and 0 <= float(u_gpu.min()) \
        and float(u_gpu.max()) < 1
    log(f"  crop_enrollment, the same draws (seconds {seconds.tolist()}), lengths {glen.tolist()}: card and CPU "
        f"{'the same bits' if same else 'OTHER BITS'} (valid {c_cpu[1].tolist()}); 64 draws on the card in range: "
        f"{drawn}  {'ok' if same and drawn else 'FAIL'}")
    if not (same and drawn):
        failures.append("crop_enrollment")
    if failures:
        fail(f"ECAPA checks failed: {failures}")
    out["parity"] = parity
    del cpu_enc

    # ---- (b) the ECAPA forward at the trainer's shape: B=16 crops of 1-5 s in 5 s buffers
    B = 16
    g2 = torch.Generator(device="cuda").manual_seed(18)
    src = torch.randn(B, 256000, device="cuda", generator=g2)
    src_len = torch.full((B,), 256000, dtype=torch.int32, device="cuda")
    draws = draw_enrollment(B, g2)
    crop_ms = statistics.median(cuda_ms(lambda: crop_enrollment(src, src_len, *draws)))
    wav, lens = crop_enrollment(src, src_len, *draws)
    work = ecapa_work(gpu_enc.module, wav, lens)
    ob, bb = 1e3 * work["ops"] / PEAK_FP32, 1e3 * work["bytes"] / HBM_BYTES_S
    torch.cuda.reset_peak_memory_stats()
    times = cuda_ms(lambda: gpu_enc(wav, lens), n=5, warmup=2)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    split = prefill_split(lambda: gpu_enc(wav, lens), ECAPA_KINDS)
    step_ms = references["[7c] step ms"]
    log(f"[16b] ECAPA forward, B={B} x 80000 (501 frames), fp32, TF32 off, median of 5 after 2 warmups (CUDA "
        f"events): {ms:.3f} ms ({[round(t, 3) for t in times]}); bound {max(ob, bb):.3f} ms "
        f"({'operations' if ob >= bb else 'bytes'}: {work['ops'] / 1e12:.4f} TFLOP at 67 TFLOP/s = {ob:.3f} ms, "
        f"{work['bytes'] / 1e6:.1f} MB = {bb:.4f} ms) -> {100 * max(ob, bb) / ms:.1f}% of the bound; "
        f"{work['ops'] / ms / 1e9:.2f} TFLOP/s; convolution outputs {work['activation_bytes'] / 1e9:.3f} GB "
        f"({1e3 * work['activation_bytes'] / HBM_BYTES_S:.3f} ms at 3.35 TB/s); peak {peak / 2**30:.3f} GiB; "
        f"the crop {crop_ms:.4f} ms; ECAPA + crop = {100 * (ms + crop_ms) / step_ms:.2f}% of [7c]'s "
        f"{step_ms:.3f} ms step  [{card}]")
    log(f"  one profiled forward by kernel kind (ms): {({k: round(v, 3) for k, v in split.items()})}")
    out["forward"] = {"ms": ms, "times": times, "bound_ms": max(ob, bb), "bound_by": "operations" if ob >= bb else "bytes",
                      "crop_ms": crop_ms, "peak_bytes": peak, "split_ms": split, **work}
    del src, wav, lens, module, gpu_enc
    torch.cuda.empty_cache()

    # ---- (c) the bench's hcontext recipe
    cfg = SepformerConfig(variant="context")
    n_stacks = 2 * cfg.num_dp_layers
    per_step = {k: v * n_stacks for k, v in ft.launches_per_train_stack(cfg.num_tf_layers).items()}
    log(f"[16c] python -m cse_tpu_torch.bench --variant hcontext  [{card}]")
    out["bench"] = bench_form("--variant hcontext", ["--variant", "hcontext"], "train_throughput_hcontext",
                              "[14] default (context)", references["[14] default (context)"], per_step)

    # ---- (d) the trainer, on a speechbrain-layout .ckpt of random weights written here
    ecapa_ckpt = os.path.join(tempfile.mkdtemp(prefix="cse_ecapa_"), "embedding_model.ckpt")
    torch.save(EcapaTDNN(generator=torch.Generator().manual_seed(19)).state_dict(), ecapa_ckpt)
    ck = tempfile.mkdtemp(prefix="cse_ckpt_hcontext_")
    argv = ["--synthetic_smoke", "--bf16", "--batch_size", "16", "--max_sp_len", "16", "--flash_attention",
            "--remat", "layer", "--augmentation", "--noise_add", "--synthetic_seconds", "8", "16",
            "--synthetic_dialogs", "24", "--log_every", "2", "--eval_step", "6", "--tot_iters", "5", "--workers", "8",
            "--ecapa_path", ecapa_ckpt, "--checkpoint_dir", ck]
    log(f"[16d] trainer: train_net(parse_train_args({' '.join(a if not a.startswith('/') else '<path>' for a in argv)}), "
        f"'hcontext'), full width  [{card}]")
    seen = []
    orig_encode = loop_lib.encode_speaker

    def recording(encoder, wav, lengths=None):
        se = orig_encode(encoder, wav, lengths)
        seen.append((tuple(se.shape), se.device.type, type(encoder).__name__))
        return se

    ft.reset_launches()
    at.reset_launches()
    stats, text = {}, io.StringIO()
    loop_lib.encode_speaker = recording
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(text), torch.enable_grad():
            model = loop_lib.train_net(parse_train_args(argv), "hcontext", stats=stats)
        torch.cuda.synchronize()
    finally:
        loop_lib.encode_speaker = orig_encode
    took = time.time() - t0
    counts, fcounts = ft.launch_counts(), at.launch_counts()
    steps, n_val = stats["final_step"] - stats["start_step"], len(stats["val_ms"])
    n_att = 2 * model.cfg.num_dp_layers * model.cfg.num_tf_layers
    want = {k: v * steps for k, v in per_step.items()}
    fwant = {k: v * n_val for k, v in at.launches_per_step(n_att, model.cfg.remat_layers, train=False).items()}
    banner = [ln for ln in text.getvalue().splitlines() if "external nets:" in ln]
    losses = stats["loss_reads"]
    se_ok = bool(seen) and all(x == ((16, 1, 192), "cuda", "EcapaEncoder") for x in seen)
    ok = (counts == want and fcounts == fwant and steps == 6 and bool(losses) and all(math.isfinite(v) for v in losses)
          and se_ok and bool(banner) and "ecapa=real" in banner[0] and model.cfg.add_se)
    log(f"  banner {banner}; {steps} updates, {n_val} validation batches in {took:.1f} s; losses read "
        f"{[round(v, 4) for v in losses]}; se of {len(seen)} batches {sorted(set(seen))}; launches per update "
        f"{per_step}; fused-stack kernels {counts} (want {want}); flash kernels {fcounts} (want {fwant}); sustained "
        f"{stats.get('sustained_mixtures_per_s', float('nan')):.3f} mixtures/s  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("hcontext trainer")
        fail(f"H-ContExt trainer checks failed: {text.getvalue()[-3000:]}")
    out["trainer"] = {"updates": steps, "seconds": took, "losses": losses, "launches": counts, "flash_launches": fcounts,
                      "se": sorted(set(seen)), "sustained_mixtures_per_s": stats.get("sustained_mixtures_per_s")}
    del model
    torch.cuda.empty_cache()

    # ---- (e) the eval entry point for each cue on DailyTalk (no register wavs in the synthetic
    # corpus: 1 s crops of the gt), then TEDLIUM (the speaker's first gt) with and without
    # --one_sec; 16 synthetic mixtures of 4-8 s in 2 batches each
    base = ["--synthetic_smoke", "--bf16", "--max_sp_len", "8", "--batch_size", "8", "--synthetic_seconds", "4", "8",
            "--synthetic_eval", "16", "--fused_eval", "--metric_workers", "2", "--ecapa_path", ecapa_ckpt]
    root = tempfile.mkdtemp(prefix="cse_eval_hcontext_")
    log(f"[16e] cse_tpu_torch.test_HContExt.main({' '.join(a if not a.startswith('/') else '<path>' for a in base)} "
        f"--cue ...)  [{card}]")
    llm_fn, llm_ps = build_context_encoder("__none__", ctx_length=1, device="cuda").pure()
    evals, firsts, enrolled = {}, {}, {}
    for name, corpus, extra in (("joint", "dailytalk", []), ("history", "dailytalk", []), ("voice", "dailytalk", []),
                                ("tedlium joint", "tedlium", []), ("tedlium joint --one_sec", "tedlium", ["--one_sec"])):
        cue = "joint" if corpus == "tedlium" else name
        save = os.path.join(root, name.replace(" --", "_").replace(" ", "_"))
        recorded, models = [], []
        orig, rec_make = _recording_eval_steps(step_lib, recorded)

        def make(*a, **k):
            models.append(a[0])
            return rec_make(*a, **k)

        step_lib.make_eval_step = make
        fs.reset_launches()
        t0 = time.time()
        try:
            res = hc_cli.main(base + extra + ["--train_data", corpus, "--cue", cue, "--save_dir", save])
        finally:
            step_lib.make_eval_step = orig
        torch.cuda.synchronize()
        took = time.time() - t0
        counts, n_fwd = fs.launch_counts(), len(recorded)
        want = {k: v * n_stacks * n_fwd
                for k, v in fs.launches_per_stack(cfg.num_tf_layers, None, cfg.d_model, cfg.d_ffn).items()}
        files = [os.path.join(save, "random_init", f"2_speaker_0_ctx_{cue}", f"{f}_{corpus}.txt")
                 for f in ("test_results", "acc")]
        finite = all(math.isfinite(res[k]) for k in ("si_snr", "sdr", "si_snr_i", "sdr_i", "pesq", "pesq_i"))
        model = models[0]
        plain_model = Sepformer(dataclasses.replace(model.cfg, compute_dtype=torch.float32))
        plain_model.load_state_dict(model.state_dict())
        plain = orig(plain_model, step_lib.TrainConfig(variant="hcontext"), cue=cue, device="cuda", llm_apply=llm_fn,
                     llm_params=llm_ps)
        rl2s = [errs(enhanced, plain(batch)[0])[2] for batch, enhanced, *_ in recorded]
        se_shapes = sorted({tuple(batch["se"].shape) for batch, *_ in recorded})
        ok = (finite and all(os.path.exists(f) for f in files) and res["n"] == 16 and counts == want
              and max(rl2s) <= TOL_SERVE_BF16)
        log(f"  --cue {name}: n {res['n']} in {n_fwd} batches, se {se_shapes}, {took:.1f} s; SI-SNR "
            f"{res['si_snr']:.4f} SDR {res['sdr']:.4f} PESQ {res['pesq']:.4f}; stack launches {counts} (want {want}, "
            f"228 a batch); fused vs plain fp32 rel_l2 {[f'{v:.3e}' for v in rl2s]} (tol {TOL_SERVE_BF16:.0e})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"test_HContExt {name}")
        firsts[name] = recorded[0][1].float()
        enrolled[name] = recorded[0][0]["se"].float()
        evals[name] = {"n": res["n"], "batches": n_fwd, "seconds": took, "launches": counts, "rel_l2_vs_fp32": rl2s,
                       "metrics": {k: res[k] for k in res if k != "n"}}
        del recorded, models, model, plain_model, plain
        torch.cuda.empty_cache()
    apart = {f"{a}/{b}": errs(firsts[a], firsts[b])[2] for a, b in (("joint", "history"), ("joint", "voice"),
                                                                   ("history", "voice"))}
    one_sec = errs(enrolled["tedlium joint --one_sec"], enrolled["tedlium joint"])[2]
    ok = all(v > 1e-2 for v in apart.values()) and one_sec > 1e-2
    log(f"  the first batch's outputs of the three cues apart by rel_l2 {({k: f'{v:.3e}' for k, v in apart.items()})}; "
        f"TEDLIUM's embeddings with --one_sec apart from the register rule's by {one_sec:.3e} (want > 1e-2)  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("the three cues give the same output, or --one_sec the register's embedding")
    if failures:
        fail(f"H-ContExt checks failed: {failures}")
    out["eval"] = {**evals, "cues_apart_rel_l2": apart, "one_sec_se_apart_rel_l2": one_sec}
    return out


# [17]'s bars. Whisper on the card against the CPU in fp32 with TF32 off: the
# log-mel (an FFT and one product) -> relative L2 <= 1e-5; the encoder and the
# decoder's logits differ only in summation order -> max|err| / max|ref| <=
# 1e-4 (the fp32 bar of [3]); greedy decodes give the same tokens and lengths,
# sum_logprob within 1e-3 (a sum of up to 64 log-probabilities) and
# no_speech_prob within 1e-5; the detected language is the same.
TOL_MEL = 1e-5
TOL_WHISPER = 1e-4
TOL_SUM_LOGPROB = 1e-3
TOL_NO_SPEECH = 1e-5
# the cascade's stub Whisper (eval/cascaded.py::build_cascaded): the real vocabulary and window
WHISPER_STUB = dict(n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_text_state=64, n_text_head=4,
                    n_text_layer=2)


def whisper_work(cfg, B) -> dict:
    """Whisper's least work at B windows, reckoned from models/whisper.py: the
    encoder's operations (the two convolutions; per layer the four
    projections, the MLP and the attention's two products) and bytes (the
    mel in, the weights, the features out); and the bytes one decode step
    must move: the decoder layers' per-step weights (self-attention 4 D²,
    the cross query and out 2 D², the MLP 8 D²), the tied embedding read for
    the logits, the cross K/V, the whole self-attention cache (every step
    attends over all n_text_ctx slots), the logits written."""
    D, Ta, Fr = cfg.n_audio_state, cfg.n_audio_ctx, 2 * cfg.n_audio_ctx
    conv = 2 * Fr * D * cfg.n_mels * 3 + 2 * Ta * D * D * 3
    layer = 2 * Ta * D * D * 4 + 2 * 2 * Ta * D * 4 * D + 2 * 2 * Ta * Ta * D
    enc_weights = D * cfg.n_mels * 3 + D * D * 3 + cfg.n_audio_layer * 12 * D * D
    enc_bytes = 4 * (B * Fr * cfg.n_mels + enc_weights + B * Ta * D)
    Dt = cfg.n_text_state
    step_weights = cfg.n_text_layer * 14 * Dt * Dt + cfg.n_vocab * Dt
    step_bytes = 4 * (step_weights + cfg.n_text_layer * 2 * B * (Ta + cfg.n_text_ctx) * Dt + B * cfg.n_vocab)
    return {"encoder_ops": B * (conv + cfg.n_audio_layer * layer), "encoder_bytes": enc_bytes,
            "step_weights": step_weights, "step_bytes": step_bytes}


def phase17(card, failures):
    """The cascaded path (models/whisper.py, eval/cascaded.py,
    test_cascaded.py: no kernel of the port; #1 in the bench's separator):
    (a) Whisper card against CPU at the stub widths and at base width, TF32
    off; (b) Whisper-base on the card, B=2 x one 30 s window: the log-mel,
    the encoder, the cross K/V and the decode, each beside its bound, the
    launches of a decode step; (c) the bench's base separator (#1) against
    the plain fp32 port, then python -m cse_tpu_torch.bench --cascaded and
    --cascaded --cascaded_llm; (d) cse_tpu_torch.test_cascaded.main on the
    card: --synthetic_smoke, and a released base .ckpt with a tiny Llama
    checkout's scorer."""
    import dataclasses
    import os
    import tempfile

    from cse_tpu_torch import test_cascaded as casc_cli
    from cse_tpu_torch.compat.torch_export import save_torch_checkpoint
    from cse_tpu_torch.data.synthetic import make_synthetic_corpus
    from cse_tpu_torch.models import whisper as tw
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.serving import ServingEngine

    out = {}
    # ---- (a) card against CPU: the same random checkout on both, TF32 off (set in main)
    wav = 0.2 * torch.randn(2, 480000, generator=torch.Generator().manual_seed(17))
    log(f"[17a] Whisper card against CPU, TF32 off, random weights (seed 17): stub widths (64, 4 heads, 2 + 2 "
        f"layers) on B=2 and base (512, 8 heads, 6 + 6 layers) on one 30 s window; vocabulary 51865  [{card}]")
    parity, models = {}, {}
    for name, cfg in (("stub", tw.WhisperConfig(**WHISPER_STUB)), ("base", tw.WhisperConfig())):
        t0 = time.time()
        sd = tw.random_whisper_params(cfg, seed=17)
        cpu = tw.whisper_from_state_dict(sd, cfg, device="cpu")
        gpu = tw.whisper_from_state_dict(sd, cfg, device="cuda")
        x = wav if name == "stub" else wav[:1]
        B = x.shape[0]
        mel = tw.whisper_log_mel(x)
        mel_rl2 = errs(tw.whisper_log_mel(x.cuda()).cpu(), mel)[2]
        audio = tw.whisper_encode(cpu, mel)
        audio_g = tw.whisper_encode(gpu, mel.cuda())
        enc_rel = errs(audio_g.cpu(), audio)[1]
        # teacher-forced: the prompt, then 12 fixed tokens (text and timestamps), position by position
        toks = [cfg.sot, cfg.token_lang_en, cfg.token_transcribe, 50364, 11, 2113, 15919, 50389, 50390, 220, 33623,
                51000, 17, 4242, cfg.eot]
        kv_c, kv_g = tw.new_kv_cache(cpu, B, "cpu"), tw.new_kv_cache(gpu, B, "cuda")
        akv_c, akv_g = tw._cross_kv(cpu, audio), tw._cross_kv(gpu, audio.cuda())
        step_rel = 0.0
        for pos, t in enumerate(toks):
            tt = torch.full((B,), t)
            step_rel = max(step_rel, errs(tw._decoder_step(gpu, tt.cuda(), pos, kv_g, akv_g).cpu(),
                                          tw._decoder_step(cpu, tt, pos, kv_c, akv_c))[1])
        lang = torch.full((B,), cfg.token_lang_en)
        decodes = {}
        for ts in (False, True):
            g = [v.cpu() for v in tw.whisper_decode_audio(gpu, audio.cuda(), lang, max_tokens=64, timestamps=ts)]
            c = tw.whisper_decode_audio(cpu, audio, lang, max_tokens=64, timestamps=ts)
            decodes["timestamps" if ts else "notimestamps"] = {
                "tokens_equal": torch.equal(g[0], c[0]), "lengths": g[1].tolist(), "lengths_equal": torch.equal(g[1], c[1]),
                "sum_logprob_err": float((g[2] - c[2]).abs().max()), "no_speech_err": float((g[3] - c[3]).abs().max())}
        lang_same = torch.equal(tw.whisper_detect_language_audio(gpu, audio.cuda())[0].cpu(),
                                tw.whisper_detect_language_audio(cpu, audio)[0])
        ok = (mel_rl2 <= TOL_MEL and enc_rel <= TOL_WHISPER and step_rel <= TOL_WHISPER and lang_same
              and all(d["tokens_equal"] and d["lengths_equal"] and d["sum_logprob_err"] <= TOL_SUM_LOGPROB
                      and d["no_speech_err"] <= TOL_NO_SPEECH for d in decodes.values()))
        log(f"  {name}: log-mel rel_l2 {mel_rl2:.3e} (tol {TOL_MEL:.0e}); encoder max_rel {enc_rel:.3e}, "
            f"{len(toks)} teacher-forced steps max_rel {step_rel:.3e} (tol {TOL_WHISPER:.0e}); greedy 64-token "
            f"decodes {decodes} (sum_logprob tol {TOL_SUM_LOGPROB:.0e}, no_speech tol {TOL_NO_SPEECH:.0e}); "
            f"language the same: {lang_same}; {time.time() - t0:.1f} s  {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"whisper {name} card vs CPU")
        parity[name] = {"log_mel_rel_l2": mel_rl2, "encoder_max_rel": enc_rel, "step_max_rel": step_rel,
                        "decodes": decodes, "language_same": lang_same}
        models[name] = gpu
        del cpu, sd, audio, audio_g, kv_c, kv_g, akv_c, akv_g
    if failures:
        fail(f"Whisper checks failed: {failures}")
    out["parity"] = parity

    # ---- (b) Whisper-base on the card: B=2 streams x one 30 s window, fp32
    t0 = time.time()
    model, cfg, B = models["base"], tw.WhisperConfig(), 2
    work = whisper_work(cfg, B)
    x = 0.2 * torch.randn(B, 480000, device="cuda", generator=torch.Generator(device="cuda").manual_seed(18))
    lang = torch.full((B,), cfg.token_lang_en, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    mel_ms = statistics.median(cuda_ms(lambda: tw.whisper_log_mel(x)))
    mel = tw.whisper_log_mel(x)
    enc_times = cuda_ms(lambda: tw.whisper_encode(model, mel))
    audio = tw.whisper_encode(model, mel)
    kv_ms = statistics.median(cuda_ms(lambda: tw._cross_kv(model, audio)))
    def decode(max_tokens):
        """One timestamped decode; returns (its outputs, the decoder steps it took)."""
        steps = [0]
        orig_step = tw._decoder_step

        def counting(*a, **k):
            steps[0] += 1
            return orig_step(*a, **k)

        tw._decoder_step = counting
        try:
            res = tw.whisper_decode_audio(model, audio, lang, max_tokens=max_tokens, timestamps=True)
        finally:
            tw._decoder_step = orig_step
        return res, steps[0]

    res, n_steps = decode(224)
    dec_times = cuda_ms(lambda: tw.whisper_decode_audio(model, audio, lang, max_tokens=224, timestamps=True))
    peak = torch.cuda.max_memory_allocated()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # launches a step from a shorter decode under the profiler (every step launches the same kernels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_steps = decode(32)[1]
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total for e in dev_events)
    enc_ms, dec_ms = statistics.median(enc_times), statistics.median(dec_times)
    eo, eb = 1e3 * work["encoder_ops"] / PEAK_FP32, 1e3 * work["encoder_bytes"] / HBM_BYTES_S
    step_bound = 1e3 * work["step_bytes"] / HBM_BYTES_S
    per_step = dec_ms / n_steps
    log(f"[17b] Whisper-base on the card, B={B} x one 30 s window, fp32, TF32 off, median of 5 after 2 warmups (CUDA "
        f"events)  [{card}]")
    log(f"  log-mel {mel_ms:.3f} ms; encoder {enc_ms:.3f} ms ({[round(t, 3) for t in enc_times]}), bound "
        f"{max(eo, eb):.3f} ms ({'operations' if eo >= eb else 'bytes'}: {work['encoder_ops'] / 1e9:.1f} GFLOP at 67 "
        f"TFLOP/s = {eo:.3f} ms, {work['encoder_bytes'] / 1e6:.1f} MB = {eb:.4f} ms) -> {100 * max(eo, eb) / enc_ms:.1f}% "
        f"of it, {work['encoder_ops'] / enc_ms / 1e9:.2f} TFLOP/s; cross K/V {kv_ms:.3f} ms")
    log(f"  decode (timestamped, 224-token budget): {n_steps} steps, lengths {res[1].tolist()}: {dec_ms:.2f} ms a window "
        f"({[round(t, 1) for t in dec_times]}), {per_step:.4f} ms a step; bound a step {step_bound:.4f} ms "
        f"({work['step_bytes'] / 1e6:.1f} MB: {work['step_weights'] / 1e6:.1f} M weights, the cross and self K/V) = "
        f"{step_bound * n_steps:.2f} ms a window -> {100 * step_bound / per_step:.2f}% of it; a profiled {prof_steps}-step "
        f"decode (32 tokens): {len(dev_events)} device events = {len(dev_events) / prof_steps:.1f} launches a step, "
        f"device busy {dev_us / 1e3:.2f} ms ({dev_us / 1e3 / prof_steps:.4f} ms a step); peak {peak / 2**30:.3f} GiB; {time.time() - t0:.1f} s")
    out["base"] = {"B": B, "log_mel_ms": mel_ms, "encoder_ms": enc_ms, "encoder_times": enc_times,
                   "encoder_bound_ms": max(eo, eb), "encoder_bound_by": "operations" if eo >= eb else "bytes",
                   "cross_kv_ms": kv_ms, "decode_ms": dec_ms, "decode_times": dec_times, "decode_steps": n_steps,
                   "decode_step_ms": per_step, "decode_step_bound_ms": step_bound,
                   "launches_per_step": len(dev_events) / prof_steps, "device_ms_per_step": dev_us / 1e3 / prof_steps,
                   "peak_bytes": peak, **work}
    del models, model, audio, mel, x
    torch.cuda.empty_cache()

    # ---- (c) the bench's separator (#1), then the bench itself
    scfg = SepformerConfig(variant="base", num_spks=2, compute_dtype=torch.bfloat16)
    sep = Sepformer(scfg, generator=torch.Generator().manual_seed(17)).to("cuda").eval()
    plain = Sepformer(dataclasses.replace(scfg, compute_dtype=torch.float32)).to("cuda").eval()
    plain.load_state_dict(sep.state_dict())
    mix = torch.randn(1, 128000, device="cuda", generator=torch.Generator(device="cuda").manual_seed(19))
    engine = ServingEngine(scfg, sep)
    fs.reset_launches()
    est = engine(mix)
    torch.cuda.synchronize()
    counts = fs.launch_counts()
    n_stacks = 2 * scfg.num_dp_layers
    per_fwd = {k: v * n_stacks for k, v in fs.launches_per_stack(scfg.num_tf_layers, None, scfg.d_model, scfg.d_ffn).items()}
    rl2 = errs(est, plain(mix))[2]
    sep_ms = statistics.median(cuda_ms(lambda: engine(mix)))
    ok = counts == per_fwd and rl2 <= TOL_SERVE_BF16 and tuple(est.shape) == (1, 128000, 2)
    log(f"[17c] the bench's separator: ServingEngine base, 2 streams, bf16, B=1 x 128000: {tuple(est.shape)}, launches "
        f"{counts} (want {per_fwd}), vs plain fp32 rel_l2 {rl2:.3e} (tol {TOL_SERVE_BF16:.0e}), {sep_ms:.3f} ms  "
        f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        fail(f"the cascaded bench's separator: launches {counts} (want {per_fwd}), rel_l2 {rl2}")
    del sep, plain, engine, est
    torch.cuda.empty_cache()
    ref = "[17b] encode + decode ms (B=2 window)"
    out["separator"] = {"launches": counts, "rel_l2_vs_fp32": rl2, "ms": sep_ms}
    # 5 timed mixtures after the warm one (the bench's default is 10): each takes about a second
    out["bench"] = {name: bench_form(name, extra + ["--steps", "5"], "cascaded_pipeline_rtf", ref, enc_ms + dec_ms,
                                     per_fwd)
                    for name, extra in (("--cascaded", ["--cascaded"]),
                                        ("--cascaded --cascaded_llm", ["--cascaded", "--cascaded_llm"]))}

    # ---- (d) the entry point on the card: the synthetic corpus with the stand-ins, then a
    # released base checkpoint with a tiny Llama checkout's scorer
    root = tempfile.mkdtemp(prefix="cse_cascaded_")
    ckpt = os.path.join(root, "ckpts", "base_released.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    gen = torch.Generator().manual_seed(20)
    base_model = Sepformer(SepformerConfig(variant="base", num_spks=2), generator=gen)
    with torch.no_grad():
        for p in base_model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    save_torch_checkpoint(ckpt, base_model)
    ldir = os.path.join(root, "llama")
    write_llama_dir(ldir, vocab=320, hidden=64, inter=128, layers=2, heads=4, kv_heads=2, dtype=torch.float32,
                    gen=torch.Generator(device="cuda").manual_seed(21))
    info = make_synthetic_corpus(os.path.join(root, "corpus"), n_eval=4, seconds=(4.0, 8.0))
    common = ["--batch_size", "1", "--max_sp_len", "8", "--workers", "4"]
    runs = (("--synthetic_smoke", ["--synthetic_smoke", "--synthetic_seconds", "4", "8", "--synthetic_eval", "4"],
             "random_init", "spokenwoz", "llm=stub"),
            ("released base .ckpt + tiny Llama scorer",
             ["--checkpoint", ckpt, "--llama_path", ldir, "--test_dataset", "dailytalk",
              "--dailytalk_data_path", info["dailytalk_data_path"], "--acoustic_noise_path", info["acoustic_noise_path"],
              "--lists_root", info["lists_root"]], os.path.join("ckpts", "base_released"), "dailytalk", "llm=real"))
    evals = {}
    for name, extra, tag, ds, llm in runs:
        save = os.path.join(root, f"out_{len(evals)}")
        text = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(text):
            res = casc_cli.main(common + extra + ["--save_dir", save])
        took = time.time() - t0
        stages = [ln for ln in text.getvalue().splitlines() if "cascaded stages:" in ln]
        path = os.path.join(save, tag, f"Cascaded_2_speaker_0_ctx_{ds}", f"test_results_{ds}.txt")
        finite = all(math.isfinite(res[k]) for k in ("si_snr", "sdr", "si_snr_i", "sdr_i", "pesq"))
        ok = os.path.exists(path) and res["n"] == 4 and finite and bool(stages) and "whisper=stub" in stages[0] \
            and llm in stages[0]
        log(f"[17d] cse_tpu_torch.test_cascaded.main, {name}: {stages}; n {res['n']} in {took:.1f} s; SI-SNR "
            f"{res['si_snr']:.4f} SDR {res['sdr']:.4f} SI-SNR-i {res['si_snr_i']:.4f} PESQ {res['pesq']:.4f}; results "
            f"file {os.path.exists(path)}  {'ok' if ok else 'FAIL'}  [{card}]")
        if not ok:
            failures.append(f"test_cascaded {name}")
        evals[name] = {"n": res["n"], "seconds": took, "metrics": {k: res[k] for k in res if k != "n"}}
    if failures:
        fail(f"cascaded checks failed: {failures}")
    out["eval"] = evals
    return out


# [18]'s bars. (a) one NCCL rank against the unsharded step on the same
# weights and batch, under cuDNN's deterministic algorithms: a one-rank
# all-reduce and the division by 1 change no bit, and each gradient's slot in
# the buffer is aligned as its own tensor would be -> losses and parameters
# bit-equal. (b) two ranks take the same update from the same reduced
# gradients -> bit-equal losses and parameters; their reduced fp32 gradients
# (TF32 off, [7a]'s setup) against one process's B=16 gradients: the mean of
# two B=8 means against the mean of 16 rows, the same kernels in another
# summation order -> relative L2 <= TOL_TRAIN_FP32 (5e-3). (d) the TP Llama
# against the single-rank forward on the card, fp32 (TF32 off):
# tests/test_llama.py's TP bar, rtol 1e-4 / atol 1e-4 on the unmasked rows.
TOL_TP = 1e-4
DP_B = 16  # [18a]'s batch and [18b]'s global batch (8 rows a rank)
LEG_TIMEOUT = 300  # s, each leg of [18]


def ranks_launcher():
    """tests/torch_ranks.py, the rank launcher the port's multi-process tests
    use: one deadline for the whole group, every rank's output drained while
    it runs, the first rank that exits non-zero ends the group, and a report
    of every rank on failure. Loaded from its file: a ``tests`` package
    elsewhere on the path cannot shadow it."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_ranks.py")
    spec = importlib.util.spec_from_file_location("torch_ranks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_ranks(name, argv, n, env=None, timeout=LEG_TIMEOUT) -> list[str]:
    """``argv`` in ``n`` processes that rendezvous on JAX's variables, through
    ``ranks_launcher().run_group``; fails the run with its report (the
    address, the seconds, each rank's return code or that it was killed, and
    the tail of its output) if a rank exits non-zero or the group outlives
    ``timeout``. Returns their outputs."""
    import os

    ranks = ranks_launcher()
    try:
        return ranks.run_group(argv, n, dict(os.environ, **(env or {})), os.path.dirname(os.path.abspath(__file__)),
                               timeout)
    except ranks.RanksFailed as e:
        fail(f"[{name}] {e}")


def leg_results(name, outs) -> list[dict]:
    """Each rank's ``LEG {...}`` line."""
    res = [[json.loads(line[4:]) for line in out.splitlines() if line.startswith("LEG {")] for out in outs]
    if any(len(r) != 1 for r in res):
        fail(f"[{name}] a rank printed no result:\n" + "\n---\n".join(o[-3000:] for o in outs))
    return [r[0] for r in res]


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def leg_18a(work):
    """One NCCL rank: three fused bf16 steps at full width with a one-rank
    mesh against three unsharded steps on the same weights and batch; the
    launches, both steps timed in turns, and the all-reduce alone."""
    import torch.distributed as dist

    from cse_tpu_torch.core.mesh import distributed_init_if_needed, make_mesh
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_train_step

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    distributed_init_if_needed()
    mesh = make_mesh(1)
    B, T = DP_B, aligned_bucket(128000)
    gen = torch.Generator(device="cuda").manual_seed(18)
    batch = {"mixed": torch.randn(B, T, device="cuda", generator=gen),
             "gt": torch.randn(B, T, device="cuda", generator=gen),
             "ctx_feat": torch.randn(B, 1, 4096, device="cuda", generator=gen)}
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16)

    def run(m):
        model = Sepformer(cfg, generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 500000, 10000)),
                               TrainConfig(variant="context"), fused=True, mesh=m)
        losses, counts = [], []
        for _ in range(3):
            ft.reset_launches()
            losses.append(step(batch))
            counts.append(ft.launch_counts())
        return model, step, losses, counts

    ref_model, ref_step, ref_losses, _ = run(None)
    model, step, losses, counts = run(mesh)
    same = losses == ref_losses and all(torch.equal(p, q) for p, q in zip(model.parameters(), ref_model.parameters()))
    repeats = None
    if not same:  # does the unsharded step repeat its own bits?
        again, _, again_losses, _ = run(None)
        repeats = again_losses == ref_losses and all(
            torch.equal(p, q) for p, q in zip(again.parameters(), ref_model.parameters()))
        del again
    # timed under the default algorithms, as [7c] is, the two steps in turns (U S S U, twice)
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    times = {"sharded": [], "unsharded": []}
    for name in ["unsharded", "sharded", "sharded", "unsharded"] * 2:
        fn = step if name == "sharded" else ref_step
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(batch)
        e1.record()
        torch.cuda.synchronize()
        times[name].append(e0.elapsed_time(e1))
    buf = torch.zeros(step.reduced_bytes // 4, device="cuda")
    for _ in range(3):
        dist.all_reduce(buf, group=mesh.data_group)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        dist.all_reduce(buf, group=mesh.data_group)
    e1.record()
    torch.cuda.synchronize()
    print("LEG " + json.dumps({
        "backend": dist.get_backend(), "world": dist.get_world_size(), "losses": [m["loss"] for m in losses],
        "ref_losses": [m["loss"] for m in ref_losses], "bit_equal": same, "ref_repeats": repeats,
        "launches": counts, "step_ms": statistics.median(times["sharded"]),
        "unsharded_step_ms": statistics.median(times["unsharded"]), "step_times_ms": times,
        "reduced_bytes": step.reduced_bytes, "all_reduce_ms": e0.elapsed_time(e1) / 20,
        "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)


def leg_18b(work):
    """Two gloo ranks sharing the card: three fused fp32 steps, each rank on
    its half of the batch (rank 1 built from other weights: the broadcast);
    the losses, a digest of the parameters, and rank 0's reduced gradients of
    step 1."""
    import hashlib
    import os

    import torch.distributed as dist

    import cse_tpu_torch.train.step as step_lib
    from cse_tpu_torch.core.mesh import distributed_init_if_needed, make_mesh
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed_init_if_needed(backend="gloo")
    mesh = make_mesh(2)
    r = mesh.data_index
    data = torch.load(os.path.join(work, "batch18b.pt"))
    B = data["mixed"].shape[0] // 2
    local = {k: v[r * B:(r + 1) * B].cuda() for k, v in data.items()}
    model = Sepformer(SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.float32),
                      generator=torch.Generator().manual_seed(1 + r))
    names = [k for k, _ in model.named_parameters()]
    first = []
    reduce = step_lib.all_reduce_mean

    def recording(*a, **k):
        out = reduce(*a, **k)
        if not first:
            first.append({n: g.detach().cpu() for n, g in zip(names, out[0]) if g is not None})
        return out

    step_lib.all_reduce_mean = recording
    step = step_lib.make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 1000, 5)),
                                    step_lib.TrainConfig(variant="context"), fused=True, mesh=mesh)
    t0 = time.time()
    losses = [step(local)["loss"] for _ in range(3)]
    took = time.time() - t0
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    if r == 0:
        torch.save(first[0], os.path.join(work, "grads18b.pt"))
    print("LEG " + json.dumps({"backend": dist.get_backend(), "rank": r, "rows": B, "losses": [v.hex() for v in losses],
                               "params_sha256": digest.hexdigest(), "seconds": took,
                               "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)


def leg_18d(work):
    """Two gloo ranks sharing the card, a model axis of 2: the tiny Llama
    checkout in fp32, int8 and w8a8, sharded against the single-rank forward
    on the card (hidden states and logits)."""
    import os

    import torch.distributed as dist

    from cse_tpu_torch.core.mesh import distributed_init_if_needed, make_mesh
    from cse_tpu_torch.models import llama as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed_init_if_needed(backend="gloo")
    mesh = make_mesh(n_data=1, n_model=2)
    root = os.path.join(work, "llama")
    ids, mask = torch.load(os.path.join(work, "llama_inputs.pt"))
    keep = mask.bool()
    out = {"backend": dist.get_backend(), "rank": mesh.model_index}
    for form, quant in (("fp32", None), ("int8", "int8"), ("w8a8", "w8a8")):
        full, cfg = tl.load_llama_params(root, dtype=torch.float32, quant=quant, device="cuda")
        shard, _ = tl.load_llama_params(root, dtype=torch.float32, quant=quant, device="cuda", mesh=mesh)
        for kind, logits in (("hidden", False), ("logits", True)):
            want = tl.llama_forward(full, ids, mask, cfg, return_logits=logits).cpu()[keep]
            got = tl.llama_forward(shard, ids, mask, cfg, return_logits=logits, mesh=mesh).cpu()[keep]
            worst = float(((got - want).abs() / (TOL_TP + TOL_TP * want.abs())).max())  # <= 1: within the bar
            out[f"{form} {kind}"] = {"max_abs_err": float((got - want).abs().max()), "bar_ratio": worst,
                                     "same_bits": bool(torch.equal(got, want))}
        if quant == "int8":
            out["layout"] = {k: {kk: list(v.shape) for kk, v in shard["layers"][k].items()} for k in ("q", "k", "o")}
    print("LEG " + json.dumps(out), flush=True)


LEGS = {"18a": leg_18a, "18b": leg_18b, "18d": leg_18d}


def phase18(card, failures, references):
    """Data parallel and the Llama's tensor parallelism (core/mesh.py, the
    sharded train step, --mesh_data, llama_shardings): (a) one NCCL rank;
    (b) two gloo ranks sharing the card; (c) the trainer and the bench under
    torch.distributed.run; (d) the TP Llama on two gloo ranks. Each leg runs
    in processes of its own, with its own rendezvous and time limit."""
    import glob
    import os
    import tempfile

    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.train import checkpoint as ckpt_lib
    from cse_tpu_torch.train.step import TrainConfig, make_loss_fn

    work = tempfile.mkdtemp(prefix="cse_dp_")
    leg = [sys.executable, os.path.abspath(__file__), "--leg"]
    cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.bfloat16)
    per_stack = ft.launches_per_train_stack(cfg.num_tf_layers)
    want = {k: v * 2 * cfg.num_dp_layers for k, v in per_stack.items()}
    fwd = (per_stack["layer_norm"] // 2 + per_stack["attention"] // 2 + 4 * cfg.num_tf_layers) * 2 * cfg.num_dp_layers
    out = {}

    # ---- (a) NCCL, one rank, full width
    T = aligned_bucket(128000)
    log(f"[18a] make_train_step(fused=True, mesh=make_mesh(1)) on one NCCL rank, ContExt full width, bf16, "
        f"B={DP_B}, T={T}, 3 steps against the unsharded step (cudnn.deterministic)  [{card}]")
    t0 = time.time()
    a = leg_results("18a", run_ranks("18a", leg + ["18a", work], 1,
                                     env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}))[0]
    ok = (a["backend"] == "nccl" and a["world"] == 1 and a["bit_equal"] and all(c == want for c in a["launches"])
          and all(math.isfinite(v) for v in a["losses"]))
    log(f"  backend {a['backend']}, world {a['world']}; losses {a['losses']} (unsharded {a['ref_losses']}); "
        f"losses and parameters bit-equal: {a['bit_equal']}"
        + ("" if a["ref_repeats"] is None else f" (the unsharded step repeats its own bits: {a['ref_repeats']})")
        + f"; launches a step {a['launches'][0]} (want {want}: #3 {fwd}, #4 {sum(want.values()) - fwd})  "
        f"{'ok' if ok else 'FAIL'}")
    log(f"  step, in turns with the unsharded step (U S S U, twice): median {a['step_ms']:.3f} ms "
        f"({[round(t, 3) for t in a['step_times_ms']['sharded']]}), {DP_B / (a['step_ms'] / 1e3):.3f} mixtures/s; "
        f"unsharded {a['unsharded_step_ms']:.3f} ms ({[round(t, 3) for t in a['step_times_ms']['unsharded']]}); "
        f"[7c] in this run {references['[7c] step ms']:.3f} ms; "
        f"the all-reduce alone {a['all_reduce_ms']:.4f} ms for {a['reduced_bytes'] / 1e6:.3f} MB a step "
        f"(one rank: a copy); peak {a['peak_bytes'] / 2**30:.3f} GiB; {time.time() - t0:.1f} s  [{card}]")
    if not ok:
        failures.append("[18a]")
        fail(f"data-parallel checks failed: {failures}")
    out["nccl_one_rank"] = dict(a, seconds=time.time() - t0, launches_fwd=fwd,
                                launches_bwd=sum(want.values()) - fwd)

    # ---- (b) gloo, two ranks sharing the card, fp32 ([7a]'s setup)
    half = DP_B // 2
    log(f"[18b] two gloo ranks on cuda:0, {half} rows each of the same {DP_B}, fp32 (TF32 off), 3 fused steps; "
        f"step 1's reduced gradients against one process's B={DP_B} gradients (rel_l2 <= {TOL_TRAIN_FP32:.0e})")
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(181)
    fcfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=torch.float32)  # TF32 is off (main)
    mix = torch.randn(DP_B, T, device="cuda", generator=gen)
    ctx = torch.randn(DP_B, 1, 4096, device="cuda", generator=gen)
    model = Sepformer(fcfg, generator=torch.Generator().manual_seed(1)).cuda()
    est0 = model(mix, ctx)[:, :, 0]
    gt = est0 + 0.5 * est0.std() * torch.randn(DP_B, T, device="cuda", generator=gen)
    batch = {"mixed": mix, "gt": gt, "ctx_feat": ctx}
    torch.save({k: v.cpu() for k, v in batch.items()}, os.path.join(work, "batch18b.pt"))
    with torch.enable_grad():
        loss, _ = make_loss_fn(model, TrainConfig(variant="context"), fused=True)(batch)
        loss.backward()
    ref = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    del model, est0, gt, batch, loss, mix, ctx
    torch.cuda.empty_cache()
    b = leg_results("18b", run_ranks("18b", leg + ["18b", work], 2))
    grads = torch.load(os.path.join(work, "grads18b.pt"))
    worst = sorted(((rel_l2(ft.qv_part(grads[k]) if k.endswith("in_proj.bias") else grads[k],
                            ft.qv_part(ref[k]) if k.endswith("in_proj.bias") else ref[k]), k) for k in ref),
                   reverse=True)
    ok = (all(x["backend"] == "gloo" for x in b) and b[0]["losses"] == b[1]["losses"]
          and b[0]["params_sha256"] == b[1]["params_sha256"] and set(grads) == set(ref)
          and worst[0][0] <= TOL_TRAIN_FP32)
    log(f"  losses rank 0 {[float.fromhex(v) for v in b[0]['losses']]}, rank 1 "
        f"{[float.fromhex(v) for v in b[1]['losses']]}: bit-equal {b[0]['losses'] == b[1]['losses']}; parameters "
        f"after 3 steps bit-equal {b[0]['params_sha256'] == b[1]['params_sha256']}")
    log(f"  reduced gradients of step 1 against one process's: {len(ref)} tensors, worst rel_l2 "
        f"{worst[0][0]:.3e} ({worst[0][1]}); 3 steps {b[0]['seconds']:.1f} s; peak a rank "
        f"{max(x['peak_bytes'] for x in b) / 2**30:.3f} GiB; {time.time() - t0:.1f} s  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[18b]")
        fail(f"data-parallel checks failed: {failures}")
    out["gloo_two_ranks"] = {"ranks": b, "grad_rel_l2_worst": worst[0][0], "grad_rel_l2_worst_name": worst[0][1],
                             "seconds": time.time() - t0}

    # ---- (c) the entry points under torch.distributed.run (NCCL)
    run = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1"]
    ck = tempfile.mkdtemp(prefix="cse_dp_ckpt_")
    flags = TRAINER_ARGS + ["--mesh_data", "1", "--checkpoint_dir", ck]
    log(f"[18c] python -m torch.distributed.run --nproc_per_node 1 -m cse_tpu_torch.train_ContExt {' '.join(flags)}")
    t0 = time.time()
    port = str(ranks_launcher().free_port())
    proc = subprocess.run(run + ["--master_port", port, "-m", "cse_tpu_torch.train_ContExt"] + flags,
                          capture_output=True, text=True, timeout=LEG_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    took = time.time() - t0
    text = proc.stdout + proc.stderr
    vals = [float(x) for x in re.findall(r"## VALIDATION SI-SNR \(\w+\): (\S+)", text)]
    rate = re.search(r"sustained end-to-end throughput: (\S+) mixtures/s", text)
    files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ck, "Epoch_*.ckpt")))
    saved = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(ck)) if files else None
    ok = (proc.returncode == 0 and "Total Iteration Reached" in text and len(vals) == 3
          and all(math.isfinite(v) for v in vals) and [f[:16] for f in files] == ["Epoch_0000_00004", "Epoch_0000_00008"]
          and saved is not None and saved["opt_state"]["total_notfinite"] == 0
          and all(torch.isfinite(v).all() for v in saved["model"].values()) and rate is not None)
    rate = float(rate.group(1)) if rate else float("nan")
    log(f"  rc {proc.returncode} in {took:.1f} s; validation SI-SNR {vals}; checkpoints {files}; non-finite updates "
        f"skipped {None if saved is None else saved['opt_state']['total_notfinite']}; sustained {rate:.3f} mixtures/s "
        f"([11] fused in this run {references['[11] fused']:.3f})  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[18c] trainer")
        fail(f"data-parallel checks failed: {failures}\n{text[-6000:]}")
    out["trainer"] = {"seconds": took, "val_sisnr": vals, "checkpoints": files, "sustained_mixtures_per_s": rate}
    log(f"[18c] python -m torch.distributed.run --nproc_per_node 1 -m cse_tpu_torch.bench --mesh_data 1")
    t0 = time.time()
    port = str(ranks_launcher().free_port())
    proc = subprocess.run(run + ["--master_port", port, "-m", "cse_tpu_torch.bench", "--mesh_data", "1"],
                          capture_output=True, text=True, timeout=LEG_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    took = time.time() - t0
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    reports = [json.loads(x) for x in proc.stderr.splitlines() if x.startswith('{"launches"')]
    line = lines[-1] if proc.returncode == 0 and len(lines) == 1 else None
    report = reports[-1] if reports else None
    ok = (line is not None and report is not None and line["metric"] == "train_throughput_contextual_extraction"
          and line["value"] > 0 and f"DP x1 (global batch {DP_B})" in line["unit"]
          and report["launches"] == {k: v * report["calls"] for k, v in want.items()})
    log(f"  {line}; [14] default in this run {references['[14] default']:.3f}; launches over "
        f"{None if report is None else report['calls']} steps {None if report is None else report['launches']}; "
        f"{took:.1f} s  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[18c] bench")
        fail(f"data-parallel checks failed: {failures}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out["bench"] = dict(line, seconds=took, launches=report["launches"], calls=report["calls"])

    # ---- (d) the Llama's tensor parallelism on two gloo ranks
    log("[18d] Llama TP over a model axis of 2 (two gloo ranks on cuda:0): vocab 320, hidden 64, 2 layers, 4 / 2 "
        f"heads, fp32 / int8 / w8a8 against the single-rank forward on the card (rtol = atol = {TOL_TP:.0e})")
    t0 = time.time()
    write_llama_dir(os.path.join(work, "llama"), vocab=320, hidden=64, inter=128, layers=2, heads=4, kv_heads=2,
                    dtype=torch.float32, gen=torch.Generator(device="cuda").manual_seed(184))
    ids = torch.randint(1, 320, (3, 24), generator=torch.Generator().manual_seed(0))
    mask = torch.ones(3, 24, dtype=torch.int32)
    for row, pad in enumerate((0, 7, 23)):
        ids[row, :pad] = 0
        mask[row, :pad] = 0
    torch.save((ids, mask), os.path.join(work, "llama_inputs.pt"))
    d = leg_results("18d", run_ranks("18d", leg + ["18d", work], 2))
    forms = [k for k in d[0] if " " in k]
    ok = all(x["backend"] == "gloo" and all(x[k]["bar_ratio"] <= 1 for k in forms) for x in d)
    for k in forms:
        log(f"  {k:<13s} " + "; ".join(f"rank {x['rank']}: max_abs_err {x[k]['max_abs_err']:.3e}, "
                                        f"same bits {x[k]['same_bits']}" for x in d))
    log(f"  rank 0's int8 shards {d[0]['layout']}; {time.time() - t0:.1f} s  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[18d]")
        fail(f"data-parallel checks failed: {failures}")
    out["llama_tp"] = {"ranks": d, "seconds": time.time() - t0}
    return out


# [19]: the JAX suite's model widths (tests/test_serving.py's TINY: d_model 16, 4 heads of width 4, FFN
# 32), run beside --debug_tiny_model's (core/cli.py's TINY_MODEL: head width 8) and the paper's
JAX_TINY = dict(enc_channels=16, enc_kernel=8, enc_stride=4, d_model=16, nhead=4, d_ffn=32, num_tf_layers=2,
                num_dp_layers=2, chunk_size=10, llm_dim=24, se_dim=12, pe_max_len=256)
# The whole w8a8 stack against its plain version on the card, at the tiny widths, 2 layers: the JAX
# suite's stack bar (tests/test_torch_w8a8.py) -> relative L2 <= 1e-3.
TOL_W8A8_TINY_STACK = 1e-3


def loss_grads(model, batch, tcfg, fused):
    """The loss and every parameter's gradient (the key-bias third of a
    qkv-bias gradient left out) of make_loss_fn on one batch."""
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.train.step import make_loss_fn

    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, _ = make_loss_fn(model, tcfg, fused=fused)(batch)
        loss.backward()
    torch.cuda.synchronize()
    grads = {k: (ft.qv_part(p.grad) if k.endswith("in_proj.bias") else p.grad).clone()
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def held_grads(name, got, want, failures) -> dict:
    """Loss and gradients of one run against another's, at the training-parity bar."""
    (lf, gf), (lp, gp) = got, want
    rl = abs(lf - lp) / abs(lp)
    worst = sorted(((errs(gf[k], gp[k])[2], k) for k in gp), reverse=True)
    bad = [k for r, k in worst if not r <= TOL_TRAIN_FP32]
    ok = rl <= TOL_TRAIN_FP32 and not bad
    log(f"  {name}: loss {lf:.6f} vs {lp:.6f} (rel {rl:.3e}); {len(gp)} gradients, worst rel_l2 {worst[0][0]:.3e} "
        f"({worst[0][1]}) (<= {TOL_TRAIN_FP32:.0e})  {'ok' if ok else 'FAIL ' + str(bad)}")
    if not ok:
        failures.append(name)
    return {"loss_rel": rl, "worst_grad_rel_l2": worst[0][0]}


def target_batch(model, mix, ctx, gen, n_spks=None):
    """A batch whose SI-SNR targets are the model's own fp32 estimates plus
    noise (SI-SNR near +6 dB: no near-cancellation that magnifies summation
    order): gt from stream 0 and, for n_spks, noises from streams 1 .. n - 1."""
    with torch.no_grad():
        out = model(mix, ctx)
    est = out[0] if isinstance(out, tuple) else out

    def near(e):
        return e + 0.5 * e.std() * torch.randn(e.shape, device="cuda", generator=gen)

    batch = {"mixed": mix, "gt": near(est[:, :, 0]), "ctx_feat": ctx}
    if n_spks:
        batch["noises"] = torch.stack([near(est[:, :, i]) for i in range(1, n_spks)], dim=-1)
    return batch


def phase19(gen, card, failures):
    """[19] every width: (a)-(d) at --debug_tiny_model's widths and the JAX
    suite's, B=2, T=4000, seeded weights: the bf16 and w8a8 engines (the w8a8
    stack's route by shape) against the plain fp32 model, the w8a8 stack
    against its plain version, the fused step's and the flash step's fp32
    gradients, and the kernels new at these widths alone (head width 4, the
    LayerNorm backward at D 16 and 48); (e) the three-speaker forms at the
    paper's width: a contsep (ce) engine forward at B=16 and one fused
    ContSep step's gradients on B=2."""
    import dataclasses

    from cse_tpu_torch.core.cli import TINY_MODEL
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.serving import ServingEngine
    from cse_tpu_torch.train.step import TrainConfig

    t_start = time.time()
    out = {}
    B, T = 2, 4000
    for wname, widths in (("cli-tiny", dict(TINY_MODEL)), ("jax-tiny", dict(JAX_TINY))):
        D, H, F_, NL = widths["d_model"], widths["nhead"], widths["d_ffn"], widths["num_tf_layers"]
        route = w8.stack_route(D, F_)
        res = out[wname] = {"d_model": D, "head_width": D // H, "d_ffn": F_, "w8a8_route": route}
        log(f"[19a] {wname}: d_model {D}, {H} heads of width {D // H}, FFN {F_}, {NL} layers; w8a8 route {route}; "
            f"B={B}, T={T} (serving vs plain fp32: rel_l2 <= {TOL_SERVE_BF16:.0e})  [{card}]")
        mix = torch.randn(B, T, device="cuda", generator=gen)
        for variant in ("context", "contsep"):
            cfg32 = SepformerConfig(variant=variant, num_spks=2, **widths)
            ctx = torch.randn(B, 1, cfg32.llm_dim, device="cuda", generator=gen)
            plain = Sepformer(cfg32, generator=torch.Generator().manual_seed(7)).cuda().eval()(mix, ctx)
            plain = plain[0] if isinstance(plain, tuple) else plain
            cfg = dataclasses.replace(cfg32, compute_dtype=torch.bfloat16)
            n_stacks = 2 * cfg.num_dp_layers
            for quant in (None, "w8a8"):
                engine = ServingEngine(cfg, Sepformer(cfg, generator=torch.Generator().manual_seed(7)), quant=quant)
                w8.reset_launches()
                est = engine(mix, ctx)
                torch.cuda.synchronize()
                est = est[0] if isinstance(est, tuple) else est
                counts = w8.launch_counts()
                want = {k: v * n_stacks for k, v in fs.launches_per_stack(NL, quant, D, F_).items()}
                rl2 = errs(est, plain)[2]
                ok = (counts == want and tuple(est.shape) == tuple(plain.shape) and bool(torch.isfinite(est).all())
                      and rl2 <= TOL_SERVE_BF16)
                tag = f"{variant} {'w8a8' if quant else 'bf16'}"
                log(f"  {tag:<13s} engine: rel_l2 {rl2:.3e} vs plain fp32; launches {counts} (want {want})  "
                    f"{'ok' if ok else 'FAIL'}")
                res[f"{tag} rel_l2"], res[f"{tag} launches"] = rl2, counts
                if not ok:
                    failures.append(f"[19a] {wname} {tag} engine")
                if quant and variant == "context":
                    # the w8a8 stack alone at the engine's intra shape, kernels against the plain version
                    K = cfg.chunk_size
                    x = torch.randn(B * (T // cfg.enc_stride // (K // 2)), K, D, device="cuda",
                                    generator=gen).to(torch.bfloat16)
                    wst = engine.stacks["0.intra"]
                    w8.reset_launches()
                    got = fs.fused_stack_apply(x, wst, H, torch.bfloat16, quant="w8a8")
                    torch.cuda.synchronize()
                    scounts = w8.launch_counts()
                    srl2 = errs(got, fs.fused_stack_reference(x, wst, H, torch.bfloat16, quant="w8a8"))[2]
                    sok = srl2 <= TOL_W8A8_TINY_STACK and scounts == fs.launches_per_stack(NL, "w8a8", D, F_)
                    log(f"  w8a8 stack {tuple(x.shape)} ({route}) vs its plain version: rel_l2 {srl2:.3e} "
                        f"(<= {TOL_W8A8_TINY_STACK:.0e}); launches {scounts}  {'ok' if sok else 'FAIL'}")
                    res["w8a8 stack rel_l2"] = srl2
                    if not sok:
                        failures.append(f"[19a] {wname} w8a8 stack")
                del engine, est
            torch.cuda.empty_cache()

        # (b) the fused step, (c) the flash step: fp32 gradients against the plain model
        log(f"[19b] {wname}: make_loss_fn(fused=True) vs the plain model, fp32, B={B}; [19c] flash "
            f"(use_flash_attention) vs the plain model")
        cfg = SepformerConfig(variant="context", num_spks=2, **widths)
        ctx = torch.randn(B, 1, cfg.llm_dim, device="cuda", generator=gen)
        model = Sepformer(cfg, generator=torch.Generator().manual_seed(8)).cuda()
        batch = target_batch(model, mix, ctx, gen)
        n_stacks = 2 * cfg.num_dp_layers
        tcfg = TrainConfig(variant="context")
        plain_lg = loss_grads(model, batch, tcfg, False)
        ft.reset_launches()
        at.reset_launches()
        fused_lg = loss_grads(model, batch, tcfg, True)
        counts, want = ft.launch_counts(), {k: v * n_stacks for k, v in ft.launches_per_train_stack(NL).items()}
        res["fused step"] = held_grads(f"[19b] {wname} fused step", fused_lg, plain_lg, failures)
        res["fused step"]["launches"] = counts
        log(f"  fused step launches {counts} (want {want})  {'ok' if counts == want else 'FAIL'}")
        if counts != want:
            failures.append(f"[19b] {wname} fused step launches")
        flash = Sepformer(dataclasses.replace(cfg, use_flash_attention=True), generator=torch.Generator().manual_seed(8))
        flash = flash.cuda()
        ft.reset_launches()
        at.reset_launches()
        flash_lg = loss_grads(flash, batch, tcfg, False)
        fcounts = at.launch_counts()
        fwant = at.launches_per_step(n_stacks * NL, False)
        res["flash step"] = held_grads(f"[19c] {wname} flash step", flash_lg, plain_lg, failures)
        res["flash step"]["launches"] = fcounts
        log(f"  flash step launches {fcounts} (want {fwant})  {'ok' if fcounts == fwant else 'FAIL'}")
        if fcounts != fwant:
            failures.append(f"[19c] {wname} flash step launches")
        del model, flash, batch, plain_lg, fused_lg, flash_lg
        torch.cuda.empty_cache()

    # (d) the kernels new at these widths, alone against their plain versions ([12a]'s bars)
    log(f"[19d] head width 4 and the LayerNorm backward below 32 columns vs plain (fp32: max_rel <= {TOL_FP32:.0e}; "
        f"bf16: rel_l2 <= {TOL_BF16:.0e})")
    kerr = out["kernels"] = {}

    def held(key, e):
        kerr[key] = max(kerr.get(key, 0.0), e)

    H = 4
    D = 4 * H
    for G, L in ((400, 10), (20, 201), (4, 300)):  # jax-tiny's intra and inter shapes, and L > 256
        M = G * L
        for cd in (torch.float32, torch.bfloat16):
            tag = f"{'fp32' if cd == torch.float32 else 'bf16'} G={G} L={L}"
            qkv = 2 * torch.randn(M, 3 * D, device="cuda", generator=gen)
            held("attention", check(f"attention hd 4 {tag}", fs.attention(qkv, L, H, cd),
                                    fs.attention_plain(qkv, L, H, cd), cd, failures))
            if cd == torch.bfloat16:
                held("attention", check(f"attention hd 4 bf16 -> fp32 out G={G} L={L}",
                                        fs.attention(qkv, L, H, torch.float32, None, cd),
                                        fs.attention_plain(qkv, L, H, torch.float32, None, cd), cd, failures))
            sk, sp = (torch.empty(2, M, H, device="cuda") for _ in range(2))
            held("attention", check(f"attention+stats hd 4 {tag}", fs.attention(qkv, L, H, cd, sk),
                                    fs.attention_plain(qkv, L, H, cd, sp), cd, failures))
            held("attention", check(f"attention+stats hd 4 {tag} stats", sk, sp, torch.float32, failures))
            dattn = torch.randn(M, D, device="cuda", generator=gen)
            (got, gb), (want, wb) = (ft.attention_backward(qkv, dattn, sp, L, H, cd),
                                     ft.attention_backward_plain(qkv, dattn, sp, L, H, cd))
            held("attention_backward", check(f"attention_backward hd 4 {tag}", got, want, cd, failures))
            held("attention_backward", check(f"attention_backward hd 4 {tag} dbias (q, v)", ft.qv_part(gb),
                                             ft.qv_part(wb), cd, failures))
            q, k, v, do = (torch.randn(G, H, L, 4, device="cuda", generator=gen).to(cd) for _ in range(4))
            (o, lse), (po, plse) = at.flash_fwd(q, k, v), at.flash_fwd_plain(q, k, v)
            held("flash_fwd", check(f"flash_fwd hd 4 {tag} o", o, po, cd, failures))
            held("flash_fwd", check(f"flash_fwd hd 4 {tag} lse", lse, plse, torch.float32, failures))
            for gname, g, w in zip(("dq", "dk", "dv"), at.flash_bwd(q, k, v, po, plse, do),
                                   at.flash_bwd_plain(q, k, v, po, plse, do)):
                held("flash_bwd", check(f"flash_bwd hd 4 {tag} {gname}", g, w, cd, failures))
    routes = {f"L={L}": {"attention": fs.attention_info(L, 4)["route"],
                         "attention_backward": ft.attention_backward_info(L, 4)["route"],
                         "flash_fwd": at.flash_fwd_info(L, 4)["route"], "flash_bwd": at.flash_bwd_info(L, 4)["route"]}
              for L in (10, 201, 300)}
    log(f"  head width 4 routes: {routes}")
    out["hd4_routes"] = routes
    for Dn in (16, 48):
        M = 20000
        x = 3 * torch.randn(M, Dn, device="cuda", generator=gen) + 0.5
        dh = torch.randn(M, Dn, device="cuda", generator=gen)
        sc = 1 + 0.1 * torch.randn(Dn, device="cuda", generator=gen)
        g32 = torch.randn(M, Dn, device="cuda", generator=gen)
        for cd in (torch.float32, torch.bfloat16):
            name = f"layer_norm_backward D={Dn} {'fp32' if cd == torch.float32 else 'bf16'} out"
            (k32, kcd, ks), (p32, pcd, ps) = (fn(dh, x, sc, g32.clone(), torch.empty(M, Dn, device="cuda"), cd)
                                              for fn in (ft.layer_norm_backward, ft.layer_norm_backward_plain))
            held("layer_norm_backward", check(f"{name} g_out fp32", k32, p32, torch.float32, failures))
            held("layer_norm_backward", check(f"{name} g_out cd", kcd, pcd, cd, failures))
            held("layer_norm_backward", check(f"{name} sums", ks, ps, torch.float32, failures))
        info = ft.layer_norm_backward_info(M, Dn)
        log(f"  layer_norm_backward D={Dn}: path {info['path']}, grid {info['grid']}, {info['registers']} registers, "
            f"{info['local_bytes']} local bytes")
        out[f"ln_bwd D={Dn} path"] = info["path"]
    torch.cuda.empty_cache()

    # (e) the three-speaker forms at the paper's width
    B3, T3 = 16, aligned_bucket(128000)
    log(f"[19e] num_spks=3, paper width: contsep (ce) ServingEngine bf16, B={B3}, T={T3}, vs plain fp32 "
        f"(rel_l2 <= {TOL_SERVE_BF16:.0e}); one fused ContSep step's fp32 gradients on B=2 (<= {TOL_TRAIN_FP32:.0e})")
    cfg32 = SepformerConfig(variant="contsep", num_spks=3, ce=True)
    mix = torch.randn(B3, T3, device="cuda", generator=gen)
    ctx = torch.randn(B3, 1, cfg32.llm_dim, device="cuda", generator=gen)
    plain_est, plain_logits = Sepformer(cfg32, generator=torch.Generator().manual_seed(9)).cuda().eval()(mix, ctx)
    cfg = dataclasses.replace(cfg32, compute_dtype=torch.bfloat16)
    engine = ServingEngine(cfg, Sepformer(cfg, generator=torch.Generator().manual_seed(9)))
    fs.reset_launches()
    est, logits = engine(mix, ctx)
    torch.cuda.synchronize()
    counts = fs.launch_counts()
    want = {k: v * 2 * cfg.num_dp_layers for k, v in fs.launches_per_stack(cfg.num_tf_layers, None, cfg.d_model,
                                                                           cfg.d_ffn).items()}
    rl2, lrl2 = errs(est, plain_est)[2], errs(logits, plain_logits)[2]
    ok = (tuple(est.shape) == (B3, T3, 3) and bool(torch.isfinite(est).all()) and rl2 <= TOL_SERVE_BF16
          and counts == want)
    log(f"  contsep 3 speakers: est {tuple(est.shape)} rel_l2 {rl2:.3e}, logits {tuple(logits.shape)} rel_l2 "
        f"{lrl2:.3e}; launches {counts} (want {want})  {'ok' if ok else 'FAIL'}")
    out["3spk serving"] = {"rel_l2": rl2, "logits_rel_l2": lrl2, "launches": counts}
    if not ok:
        failures.append("[19e] three-speaker serving")
    del engine, est, logits, plain_est, plain_logits, mix, ctx
    torch.cuda.empty_cache()
    B2 = 2
    mix = torch.randn(B2, T3, device="cuda", generator=gen)
    ctx = torch.randn(B2, 1, cfg32.llm_dim, device="cuda", generator=gen)
    model = Sepformer(cfg32, generator=torch.Generator().manual_seed(10)).cuda()
    batch = target_batch(model, mix, ctx, gen, n_spks=3)
    tcfg = TrainConfig(variant="contsep", use_ce=True)
    plain_lg = loss_grads(model, batch, tcfg, False)
    ft.reset_launches()
    fused_lg = loss_grads(model, batch, tcfg, True)
    counts = ft.launch_counts()
    want = {k: v * 2 * cfg32.num_dp_layers for k, v in ft.launches_per_train_stack(cfg32.num_tf_layers).items()}
    out["3spk fused step"] = held_grads("[19e] contsep 3 speakers fused step", fused_lg, plain_lg, failures)
    log(f"  fused step launches {counts} (want {want})  {'ok' if counts == want else 'FAIL'}")
    if counts != want:
        failures.append("[19e] three-speaker step launches")
    del model, batch, plain_lg, fused_lg
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_start
    log(f"  [19] took {out['seconds']:.1f} s")
    if failures:
        fail(f"[19] every width failed: {failures}")
    return out


# ---------------------------------------------------------------- 20. the MLA prefill kernel (K16a)


def mla_work(first: list[int], T: int, H: int, widths) -> dict:
    """The least work of one MLA attention call: the real causal pairs'
    products (each row's real tokens n, n (n + 1) / 2 pairs a head, 2
    operations a width of q.k and p.v) and q, kv, k_pe and o read or written
    once, bf16."""
    dn, dr, dv = widths
    pairs = sum((T - f) * (T - f + 1) // 2 for f in first)
    B = len(first)
    nbytes = 2 * (B * T * H * (dn + dr) + B * T * H * (dn + dv) + B * T * dr + B * T * H * dv)
    return {"flops": 2.0 * pairs * H * (dn + dr + dv), "bytes": nbytes}


def phase20(gen, card, failures, B=10, T=2048, H=16):
    """The MLA prefill kernel (``ops/mla.py``, ``csrc/mla.cu``) at the
    history cell's shape, T 2048 with 24% (each row's first 492 tokens) and
    0% left padding: against its plain twin on real rows (bf16 rel L2 1e-2;
    pad rows exactly 0), then timed beside its bound, the twin and, as
    ``library_ms`` only, SDPA (``is_causal`` without padding, the fp32
    bias as its mask with it; the port never calls it)."""
    from cse_tpu_torch.models.deepseek_v2 import DeepseekV2Config, softmax_scale
    from cse_tpu_torch.ops import mla as M

    widths = (128, 64, 128)
    dn, dr, dv = widths
    scale = softmax_scale(DeepseekV2Config())  # DeepSeek-V2-Lite's
    info = M.mla_attention_info(widths)
    log(f"[20] MLA prefill kernel at B={B} T={T} H={H} {widths}: launch {info}")
    if info["local_bytes"]:
        failures.append(f"mla_prefill_bf16_kernel uses local memory: {info}")
    out = {"launch": info, "card": card}
    for name, pad in (("pad24", round(0.24 * T)), ("pad0", 0)):
        q = torch.randn(B, T, H * (dn + dr), device="cuda", generator=gen).to(torch.bfloat16)
        kv = torch.randn(B, T, H * (dn + dv), device="cuda", generator=gen).to(torch.bfloat16)
        k_pe = torch.randn(B, T, dr, device="cuda", generator=gen).to(torch.bfloat16)
        first = torch.full((B,), pad, dtype=torch.int32, device="cuda")
        mask = M.mask_of_first(first, T)
        bias = M.attention_bias(mask)
        got = M.mla_attention(q, kv, k_pe, first, scale, widths)
        twin = M.mla_attention_plain(q, kv, k_pe, bias, scale, widths)
        err = float((got[mask].float() - twin[mask].float()).norm() / twin[mask].float().norm())
        pads_zero = bool((got[~mask] == 0).all())
        if err > TOL_BF16 or not pads_zero or not torch.isfinite(got).all():
            failures.append(f"mla_prefill {name}: rel L2 {err:.3e} (bar {TOL_BF16}), pad rows zero {pads_zero}")
        del twin
        work = mla_work([pad] * B, T, H, widths)
        ms = statistics.median(cuda_ms(lambda: M.mla_attention(q, kv, k_pe, first, scale, widths), n=20))
        plain_ms = statistics.median(cuda_ms(lambda: M.mla_attention_plain(q, kv, k_pe, bias, scale, widths), n=5))
        q4 = q.view(B, T, H, dn + dr).transpose(1, 2).contiguous()
        k4 = torch.cat([kv.view(B, T, H, dn + dv)[..., :dn], k_pe[:, :, None].expand(B, T, H, dr)], -1)
        k4 = k4.transpose(1, 2).contiguous()
        v4 = kv.view(B, T, H, dn + dv)[..., dn:].transpose(1, 2).contiguous()
        if pad:
            mb = bias.to(torch.bfloat16)
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mb, scale=scale)  # noqa: E731
        else:
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, scale=scale)  # noqa: E731
        library_ms = statistics.median(cuda_ms(sdpa, n=10))
        run, skipped = M.tile_counts(first, T)
        res = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "rel_l2_vs_plain": err,
               **bound_of(work["bytes"], work["flops"]), "tflops": work["flops"] / ms / 1e9,
               "tiles_skipped_share": float(skipped) / float(run + skipped)}
        res["roofline"] = res["bound_ms"] / ms
        out[name] = res
        log(f"  {name}: kernel {ms:.4f} ms ({res['tflops']:.0f} TFLOP/s, {100 * res['roofline']:.1f}% of its "
            f"{res['bound_by']} bound {res['bound_ms']:.4f} ms), plain {plain_ms:.3f} ms, SDPA {library_ms:.4f} ms, "
            f"rel L2 {err:.2e}, tiles skipped {100 * res['tiles_skipped_share']:.1f}%")
        del q, kv, k_pe, bias, q4, k4, v4
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    t_start = time.time()
    torch.set_grad_enabled(False)
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import _build
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.serving import ServingEngine

    # the plain versions are the oracle: full fp32 everywhere, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.time()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        _build.build(verbose=True)
    print(report.getvalue(), flush=True)
    _build.library()
    log(f"[2] kernels built in {time.time() - t0:.1f} s -> {_build.library_path().name}")
    for kname in ("linear_bf16_kernel", "wgrad_bf16_kernel", "linear_w8a8_kernel", "ffn_w8a8_kernel"):
        gemm = ptxas_of(report.getvalue(), kname)
        log(f"  {kname} (wgmma + TMA), ptxas: {gemm}")
        if not gemm or any(g["spill_bytes"] or g["warnings"] for g in gemm.values()):
            fail(f"{kname} spills, is serialised or is missing from the ptxas report: {gemm}")

    mla_ptxas = ptxas_of(report.getvalue(), "mla_prefill_bf16_kernel")
    log(f"  mla_prefill_bf16_kernel (wgmma + TMA), ptxas by instantiation: {mla_ptxas}")
    if len(mla_ptxas) != 2 or any(g["spill_bytes"] or g["warnings"] for g in mla_ptxas.values()):
        fail(f"mla_prefill_bf16_kernel spills, is serialised or is missing from the ptxas report: {mla_ptxas}")

    ln_ptxas = {k: ptxas_of(report.getvalue(), k) for k in ("layer_norm_bwd", "kp_ln_staged_kernel",
                                                            "layer_norm_quant_kernel")}
    for kname, inst in ln_ptxas.items():
        log(f"  {kname}, ptxas by instantiation: {inst}")
        if not inst or any(g["spill_bytes"] for g in inst.values()):
            fail(f"{kname} spills or is missing from the ptxas report: {inst}")

    failures: list[str] = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    D, H, F_, NL = 256, 8, 1024, 8

    # ---- 3. each kernel and the whole stack against the plain versions
    log("[3] kernels vs plain versions (fp32: max_rel <= %.0e; bf16: rel_l2 <= %.0e)" % (TOL_FP32, TOL_BF16))
    max_err = {"layer_norm": 0.0, "linear": 0.0, "attention": 0.0}
    for cd in (torch.float32, torch.bfloat16):
        tag = "fp32" if cd == torch.float32 else "bf16"
        for shape_name, (G, L) in (("intra", INTRA), ("inter", INTER)):
            M = G * L
            x = 3 * torch.randn(M, D, device="cuda", generator=gen)
            s = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
            b = 0.1 * torch.randn(D, device="cuda", generator=gen)
            e = check(f"layer_norm {tag} {shape_name} [{M},{D}]",
                      fs.layer_norm(x, s, b, cd), fs.layer_norm_plain(x, s, b, cd), cd, failures)
            max_err["layer_norm"] = max(max_err["layer_norm"], e)
            del x
            for K, N, epi in ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual")):
                a = torch.randn(M, K, device="cuda", generator=gen).to(cd)
                w = (torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)).to(cd)
                bias = 0.1 * torch.randn(N, device="cuda", generator=gen)
                res = torch.randn(M, N, device="cuda", generator=gen) if epi == "residual" else None
                got = fs.linear(a, w, bias, epi, None if res is None else res.clone())
                ref = fs.linear_plain(a, w, bias, epi, res)
                e = check(f"linear {tag} {shape_name} [{M},{K}]x[{K},{N}] {epi}", got, ref, cd, failures)
                max_err["linear"] = max(max_err["linear"], e)
                del a, got, ref, res
            qkv = 2 * torch.randn(M, 3 * D, device="cuda", generator=gen)
            e = check(f"attention {tag} {shape_name} G={G} L={L}",
                      fs.attention(qkv, L, H, cd), fs.attention_plain(qkv, L, H, cd), cd, failures)
            max_err["attention"] = max(max_err["attention"], e)
            del qkv
            if shape_name == "intra":  # L > 256: the attention's two-tile path
                qkv = 2 * torch.randn(64 * 300, 3 * D, device="cuda", generator=gen)
                e = check(f"attention {tag} G=64 L=300 (two key tiles)",
                          fs.attention(qkv, 300, H, cd), fs.attention_plain(qkv, 300, H, cd), cd, failures)
                max_err["attention"] = max(max_err["attention"], e)
                del qkv
            w = random_stack(D, F_, NL, cd, gen)
            xs = torch.randn(G, L, D, device="cuda", generator=gen).to(cd)
            check(f"fused stack {tag} {shape_name} [{G},{L},{D}]",
                  fs.fused_stack_apply(xs, w, H, cd), fs.fused_stack_reference(xs, w, H, cd), cd, failures)
            del w, xs
            torch.cuda.empty_cache()
    if failures:
        fail(f"kernel checks failed: {failures}")

    # ---- 4. the slice: ServingEngine, ContExt, full width
    B, T = 16, aligned_bucket(128000)
    log(f"[4] ServingEngine variant=context full width, B={B}, T={T}")
    outs = {}
    mix = torch.randn(B, T, device="cuda", generator=gen)
    ctx = torch.randn(B, 1, 4096, device="cuda", generator=gen)
    for cd in (torch.float32, torch.bfloat16):
        cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=cd)
        model = Sepformer(cfg, generator=torch.Generator().manual_seed(0)).to("cuda").eval()
        engine = ServingEngine(cfg, model)
        outs["plain_" + ("fp32" if cd == torch.float32 else "bf16")] = model(mix, ctx)
        fs.reset_launches()
        out = engine(mix, ctx)
        torch.cuda.synchronize()
        counts = fs.launch_counts()
        outs["serve_" + ("fp32" if cd == torch.float32 else "bf16")] = out
        if tuple(out.shape) != (B, T, 1) or not torch.isfinite(out).all():
            fail(f"serving output {tuple(out.shape)} (want {(B, T, 1)}) or non-finite")
        if cd == torch.bfloat16:
            main_counts = counts
            per_stack = fs.launches_per_stack(cfg.num_tf_layers, None, cfg.d_model, cfg.d_ffn)
            n_stacks = 2 * cfg.num_dp_layers
            want = {k: v * n_stacks for k, v in per_stack.items()}
            log(f"  launches in one bf16 forward: {counts} (want {want}, total {sum(want.values())})")
            if counts != want:
                fail(f"launch counts {counts} != {want}")
            fwd_times = []
            for i in range(7):
                t_s, t_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t_s.record()
                engine(mix, ctx)
                t_e.record()
                torch.cuda.synchronize()
                if i >= 2:  # two warmups
                    fwd_times.append(t_s.elapsed_time(t_e))
            fwd_ms = statistics.median(fwd_times)
            plain_fwd_ms = time_ms(lambda: model(mix, ctx), reps=3, warmup=1)
        del engine, model
        torch.cuda.empty_cache()
    for name, tol in (("serve_fp32", TOL_SERVE_FP32), ("serve_bf16", TOL_SERVE_BF16), ("plain_bf16", None)):
        mx, _, rl2 = errs(outs[name], outs["plain_fp32"])
        ok = tol is None or rl2 <= tol
        log(f"  {name} vs plain fp32 Sepformer: max_abs {mx:.3e} rel_l2 {rl2:.3e}"
            + ("" if tol is None else f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}"))
        if not ok:
            failures.append(name)
    if failures:
        fail(f"serving checks failed: {failures}")
    audio_s = B * T / 8000
    log(f"  bf16 forward: median {fwd_ms:.3f} ms over {len(fwd_times)} runs ({fwd_times}); "
        f"plain bf16 Sepformer {plain_fwd_ms:.3f} ms; {audio_s:.1f} s of audio -> "
        f"realtime factor {audio_s / (fwd_ms / 1e3):.1f}x  [{card}]")
    del outs

    # ---- 5. per-kernel times (bf16, the serving dtype)
    log(f"[5] kernel times, bf16 [{card}]")
    cd = torch.bfloat16
    times = {}
    for shape_name, (G, L) in (("intra", INTRA), ("inter", INTER)):
        M = G * L
        x = torch.randn(M, D, device="cuda", generator=gen)
        s, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
        ln = dict(
            ms=time_ms(lambda: fs.layer_norm(x, s, b, cd)),
            plain_ms=time_ms(lambda: fs.layer_norm_plain(x, s, b, cd)),
            library_ms=time_ms(lambda: F.layer_norm(x, (D,), s, b, 1e-6)),
            bound_ms=1e3 * (M * D * (4 + 2) + 2 * D * 4) / HBM_BYTES_S, bound_by="bytes",
        )
        del x
        shapes = ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual"))
        ops_ = []
        for K, N, epi in shapes:
            a = torch.randn(M, K, device="cuda", generator=gen).to(cd)
            w = (torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)).to(cd)
            bias = torch.zeros(N, device="cuda")
            res = torch.zeros(M, N, device="cuda") if epi == "residual" else None
            ops_.append((a, w, bias, epi, res))
        lin_flops = sum(2 * M * K * N for K, N, _ in shapes)
        lin_bytes = sum(M * K * 2 + K * N * 2 + N * 4 + M * N * (8 if e == "residual" else 4 if e == "bias" else 2)
                        for K, N, e in shapes)
        part_ms = [time_ms(lambda o=o: fs.linear(*o)) for o in ops_]
        like_ms = [time_like(addmm_like(*o)) for o in ops_]
        for (K, N, epi), ms, like, o in zip(shapes, part_ms, like_ms, ops_):
            nbytes = M * K * 2 + K * N * 2 + N * 4 + M * N * (8 if epi == "residual" else 4 if epi == "bias" else 2)
            log(f"  {shape_name} linear [{M},{K}]x[{K},{N}] {epi:<8s} kernel {ms:.4f} ms  "
                f"{nbytes / ms / 1e9:.3f} TB/s  {2 * M * K * N / ms / 1e9:.1f} TFLOP/s  "
                f"bytes bound {1e3 * nbytes / HBM_BYTES_S:.4f} ms  "
                f"torch.matmul {time_ms(lambda o=o: torch.matmul(o[0], o[1])):.4f} ms  addmm {fmt_ms(like)}")
        lin = dict(
            ms=sum(part_ms),
            plain_ms=time_ms(lambda: [fs.linear_plain(*o) for o in ops_], reps=3),
            library_ms=time_ms(lambda: [torch.matmul(o[0], o[1]) for o in ops_]),
            library_like_ms=sum_or_none(like_ms),
        )
        log(f"  {shape_name} linear, one layer's 4 GEMMs: {lin['ms']:.4f} ms; before the redesign "
            f"{LINEAR_EARLIER_MS['linear'][shape_name == 'inter']} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        tb, to = 1e3 * lin_bytes / HBM_BYTES_S, 1e3 * lin_flops / PEAK_BF16
        lin.update(bound_ms=max(tb, to), bound_by="operations" if to >= tb else "bytes")
        del ops_
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        q, k, v = (t.to(cd) for t in qkv.reshape(G, L, 3, H, D // H).permute(2, 0, 3, 1, 4))
        att_flops = 4 * G * H * L * L * (D // H)
        ab, ao = 1e3 * (M * 3 * D * 4 + M * D * 2) / HBM_BYTES_S, 1e3 * att_flops / PEAK_BF16
        att = dict(
            ms=time_ms(lambda: fs.attention(qkv, L, H, cd)),
            plain_ms=time_ms(lambda: fs.attention_plain(qkv, L, H, cd), reps=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=max(ab, ao), bound_by="operations" if ao >= ab else "bytes",
            launch=fs.attention_info(L, D // H),
        )
        log(f"  {shape_name} attention {att['ms']:.4f} ms; before the redesign "
            f"{ATTENTION_EARLIER_MS['attention'][shape_name == 'inter']} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        show_info(f"{shape_name} attention launch", att["launch"])
        del qkv, q, k, v
        w = random_stack(D, F_, NL, cd, gen)
        xs = torch.randn(G, L, D, device="cuda", generator=gen).to(cd)
        stk_flops = NL * (lin_flops + att_flops)
        stk = dict(
            ms=time_ms(lambda: fs.fused_stack_apply(xs, w, H, cd), reps=5),
            plain_ms=time_ms(lambda: fs.fused_stack_reference(xs, w, H, cd), reps=2, warmup=1),
            bound_ms=1e3 * stk_flops / PEAK_BF16, bound_by="operations",
        )
        # one PyTorch call for the same 8 pre-LN layers and final LN (its residual bf16, not fp32), timed only:
        # inference under inference_mode (its fused fast path; #1's yardstick), and one layer's training
        # forward with autograd recording (#3's)
        enc = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(D, H, F_, dropout=0.0, batch_first=True, norm_first=True,
                                             layer_norm_eps=fs.LN_EPS),
            NL, norm=torch.nn.LayerNorm(D, eps=fs.LN_EPS), enable_nested_tensor=False).to("cuda", cd)
        with torch.inference_mode():
            stk["library_ms"] = time_ms(lambda: enc.eval()(xs), reps=5)
        layer = enc.layers[0].train()
        with torch.enable_grad():
            xg = xs.detach().clone().requires_grad_(True)
            stk["library_train_layer_ms"] = time_ms(lambda: layer(xg), reps=5)
        log(f"  {shape_name} nn.TransformerEncoder (8 layers + LN, bf16 residual) under inference_mode "
            f"{stk['library_ms']:.4f} ms; one TransformerEncoderLayer training forward "
            f"{stk['library_train_layer_ms']:.4f} ms  [{card}]")
        del w, xs, enc, layer, xg
        torch.cuda.empty_cache()
        times[shape_name] = {"layer_norm": ln, "linear": lin, "attention": att, "fused_stack": stk}
        for kname, t in times[shape_name].items():
            log(f"  {shape_name} G={G} L={L} {kname:<11s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
                f"library {t.get('library_ms', float('nan')):.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
                + (f"  addmm {fmt_ms(t['library_like_ms'])}" if "library_like_ms" in t else ""))
    spills = attention_launches()
    log(f"  attention strip instantiations, local-memory bytes a thread: {spills}")
    if any(spills.values()):
        fail(f"a strip instantiation of the attention spills to local memory: {spills}")

    with torch.enable_grad():
        train_err = phase6(gen, failures, H, F_, NL)
        phase7_parity(gen, failures)
        bench = phase7_bench(gen, card)
        ttimes = phase7_times(gen, card, H, F_, NL, ln_ptxas["layer_norm_bwd"])
        t0 = time.time()
        flash_err = phase8_kernels(gen, failures)
        flash_parity = phase8_parity(gen, failures)
        flash_bench = phase8_bench(gen, card, failures)
        ftimes = phase8_times(gen, card)
        log(f"  [8] took {time.time() - t0:.1f} s")
    t0 = time.time()
    w8_err = phase9_kernels(gen, failures, H, F_, NL)
    w8_serve = phase9_serve(gen, card, failures)
    wtimes = phase9_times(gen, card, H, F_, NL)
    log(f"  [9] took {time.time() - t0:.1f} s")
    t0 = time.time()
    parts_err = phase10_kernels(gen, failures)
    parts = phase10_tool(gen, card)
    log(f"  [10] took {time.time() - t0:.1f} s")
    t0 = time.time()
    with torch.enable_grad():
        trainer = phase11(card, failures)
    log(f"  [11] took {time.time() - t0:.1f} s")
    t0 = time.time()
    tiny_err = phase12_kernels(gen, failures)
    with torch.enable_grad():
        tiny = phase12(card, failures)
    tiny.update(kernels=tiny_err)
    log(f"  [12] took {time.time() - t0:.1f} s")
    t0 = time.time()
    evals = phase13(card, failures)
    log(f"  [13] took {time.time() - t0:.1f} s")
    t0 = time.time()
    benches = phase14(card, {"[7c] mixtures/s": bench["mixtures_per_s"],
                             "[4] realtime factor": audio_s / (fwd_ms / 1e3),
                             "[9b] realtime factor": w8_serve["realtime_factor"]})
    log(f"  [14] took {time.time() - t0:.1f} s")
    t0 = time.time()
    llama = phase15(card, failures, {"[7c] mixtures/s": bench["mixtures_per_s"],
                                     "[11] fused": trainer["fused"]["sustained_mixtures_per_s"]})
    log(f"  [15] took {time.time() - t0:.1f} s")
    t0 = time.time()
    hcontext = phase16(card, failures, {"[7c] step ms": bench["step_ms"],
                                        "[14] default (context)": benches["default"]["value"]})
    log(f"  [16] took {time.time() - t0:.1f} s")
    t0 = time.time()
    cascaded = phase17(card, failures)
    log(f"  [17] took {time.time() - t0:.1f} s")
    t0 = time.time()
    torch.cuda.empty_cache()
    dp = phase18(card, failures, {"[7c] step ms": bench["step_ms"], "[11] fused": trainer["fused"]["sustained_mixtures_per_s"],
                                  "[14] default": benches["default"]["value"]})
    log(f"  [18] took {time.time() - t0:.1f} s")
    widths = phase19(gen, card, failures)
    mla_times = phase20(gen, card, failures)

    serve_parts = {"layer_norm": ("_ln (:33), one launch", "layer_norm_kernel"),
                   "linear": ("the four projections (:92-110), one layer's 4 launches", GEMM_SYMBOL),
                   "attention": ("_attention (:39), one launch", ATTENTION_SYMBOL.format("bf16", "bf16"))}
    kernels = []
    for kname, (part, symbol) in serve_parts.items():
        ti, tn = times["intra"][kname], times["inter"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "symbol": symbol, "replaces": REPLACES,
            "launches": main_counts[kname], "max_abs_err": max_err[kname],
            "ms": ti["ms"], "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
            "bound_by": ti["bound_by"], "library_ms": ti["library_ms"],
            "work": f"intra G={INTRA[0]} L={INTRA[1]} bf16, {part}",
            "inter": {k: tn[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    # the training path (launches of one bench step): the serving kernels in the
    # forward, replay and dX GEMMs, and the backward's own kernels
    train_parts = (
        ("layer_norm[train]", "layer_norm", SOURCE, REPLACES_FWD, "layer_norm_kernel",
         times, "layer_norm", "layer_norm", "forward and replay LNs; one launch"),
        ("linear[train]", "linear", SOURCE, REPLACES_FWD, GEMM_SYMBOL,
         times, "linear", "linear", "forward and replay projections (one layer's 4 launches); "
         "the backward's 3 dX GEMMs per layer are linear[dgrad] in 'train_times'"),
        ("attention[train]", "attention", SOURCE, REPLACES_FWD,
         ATTENTION_SYMBOL.format("bf16", "bf16") + ", with stats",
         ttimes, "attention[train]", "attention_stats", "attention writing row max and 1/z; one launch"),
        ("weight_grad", "weight_grad", SOURCE_TRAIN, REPLACES_BWD, WGRAD_SYMBOL,
         ttimes, "weight_grad", "weight_grad", "one layer's 4 weight gradients"),
        ("linear_relu_grad", "linear_relu_grad", SOURCE, REPLACES_BWD,
         "linear_bf16_kernel<EPI_RELU_GRAD> (wgmma + TMA) + sum_rows_kernel", ttimes, "linear_relu_grad",
         "linear_relu_grad",
         "dpre = relu'(h) * (dy W2^T) and its column sums; one call"),
        ("layer_norm_backward", "layer_norm_backward", SOURCE_TRAIN, REPLACES_BWD,
         LN_BWD_SYMBOL, ttimes, "layer_norm_backward", "layer_norm_backward",
         "one LN backward with its dscale, dbias and bias sums; one call"),
        ("attention_backward", "attention_backward", SOURCE_TRAIN, REPLACES_BWD, ATTENTION_BWD_SYMBOL,
         ttimes, "attention_backward", "attention_backward",
         "dq | dk | dv and their column sums; one call; library_ms: PyTorch's flash backward alone"),
    )
    all_err = {**max_err, **train_err}
    for name, counter, source, replaces, symbol, tset, tkey, ekey, part in train_parts:
        ti, tn = tset["intra"][tkey], tset["inter"][tkey]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "symbol": symbol, "replaces": replaces,
            "launches": bench["launches"][counter], "max_abs_err": all_err[ekey],
            "ms": ti["ms"], "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
            "bound_by": ti["bound_by"], "library_ms": ti["library_ms"],
            "work": f"intra G={INTRA[0]} L={INTRA[1]} bf16, {part}; launches per bf16 train step",
            "inter": {k: tn[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    # the flash path (launches of one bf16 train step, [8c]) and w8a8 serving
    # (launches of one w8a8 forward, [9b])
    slice3 = (
        ("flash_fwd", SOURCE_FLASH, REPLACES_FLASH_FWD,
         "flash_fwd_strip_bf16_kernel<32, 16 or 8> (L <= 256); flash_fwd_bf16_kernel<32> (L > 256)", ftimes,
         flash_bench["launches"],
         flash_err, "q/k/v [G, 8, L, 32] -> o, lse; one launch; launches per bf16 train step (remat='layer')"),
        ("flash_bwd", SOURCE_FLASH, REPLACES_FLASH_BWD, FLASH_BWD_SYMBOL, ftimes,
         flash_bench["launches"], flash_err,
         "dq, dk, dv; one call; launches per bf16 train step; library_ms: PyTorch's flash backward alone"),
        ("quantize_rows", SOURCE_W8A8, REPLACES_W8A8, "quantize_rows_kernel", wtimes, w8_serve["launches"], w8_err,
         "fp32 [M, 256] -> int8 + row scales (_qdot :115-123), the attention output's; one launch; launches per "
         "w8a8 forward"),
        ("linear_w8a8", SOURCE_W8A8, REPLACES_W8A8, W8A8_SYMBOL, wtimes, w8_serve["launches"], w8_err,
         "the QKV and out-proj int8 projections (:149-151), one layer's 2 launches (all four shapes in "
         "'four_gemms_ms'); launches per w8a8 forward"),
        ("layer_norm_quant", SOURCE_W8A8, REPLACES_W8A8, "layer_norm_quant_kernel (persistent, a warp a row)", wtimes,
         w8_serve["launches"], w8_err,
         "_ln (:148, :152) and _qdot's row quantizer (:122-123) in one pass, fp32 [M, 256] -> int8 + row scales; "
         "one launch; 'before_ms': layer_norm (fp32) + quantize_rows in this run; launches per w8a8 forward"),
        ("ffn_w8a8", SOURCE_W8A8, REPLACES_W8A8,
         "ffn_w8a8_kernel (wgmma s8 + TMA, persistent, warp-specialised; hq in registers, half-tile pipeline a "
         "warpgroup; the int8 hidden in shared memory)", wtimes,
         w8_serve["launches"], w8_err,
         "FFN1, ReLU, the hidden's quantizer and FFN2 into the residual (:153-154); one launch; 'before_ms': "
         "linear_w8a8 (relu) + quantize_rows [M, 1024] + linear_w8a8 (residual) in this run; launches per w8a8 "
         "forward"),
        ("attention[w8a8]", SOURCE, REPLACES_W8A8, ATTENTION_SYMBOL.format("float", "float"), wtimes,
         {"attention[w8a8]": w8_serve["launches"]["attention"]}, w8_err,
         "_attention (:150) with bf16 operands and an fp32 output; one launch; launches per w8a8 forward"),
        ("layer_norm[w8a8]", SOURCE, REPLACES_W8A8, "layer_norm_kernel<float>", wtimes,
         {"layer_norm[w8a8]": w8_serve["launches"]["layer_norm"]}, {"layer_norm[w8a8]": max_err["layer_norm"]},
         "_ln (:148-155) with an fp32 output, one launch; launches per w8a8 forward: the final LN of each stack "
         "(:156, bf16 out), the layers' LNs being layer_norm_quant"),
    )
    for name, source, replaces, symbol, tset, counts, errset, part in slice3:
        ti, tn = tset["intra"][name], tset["inter"][name]
        extra = ("before_ms", "four_gemms_ms", "launch")  # 2e and 2f's chains, the 4 int8 shapes, the kernel's launch
        kernels.append({
            "name": name, "route": "cuda", "source": source, "symbol": symbol, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errset[name],
            "ms": ti["ms"], "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
            "bound_by": ti["bound_by"], "library_ms": ti["library_ms"],
            "work": f"intra G={INTRA[0]} L={INTRA[1]} bf16, {part}",
            **{k: ti[k] for k in extra if k in ti},
            "inter": {k: tn[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", *extra) if k in tn},
        })
    # the kernel-parts tool (launches of the tool's own run, [10b])
    tool_parts = (
        ("kp_layer_norm", "kp_layer_norm", SOURCE_PARTS, KP_LN_SYMBOL, "kp_layer_norm",
         "ln (:29-55) in mode 'centred', one launch; every mode in 'by_mode_ms'"),
        ("kp_attention", "kp_attention", SOURCE_PARTS,
         "kp_attention_strip_bf16_kernel<mode, 16 or 8> (L <= 256); kp_attention_bf16_kernel (L > 256)",
         "kp_attention",
         "scores, softmax, PV and the residual add (:68-107) in mode 'sum', one launch; every mode in 'by_mode_ms'"),
        ("linear[kernel_parts]", "linear", SOURCE, GEMM_SYMBOL, "linear",
         "the qkv, FFN1 and FFN2 products (:67, :112, :114), one layer's 3 launches"),
    )
    for name, counter, source, symbol, ekey, part in tool_parts:
        ti = parts["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "symbol": symbol, "replaces": REPLACES_PARTS,
            "launches": parts["launches"][counter], "max_abs_err": parts_err[ekey],
            "ms": ti["ms"], "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
            "bound_by": ti["bound_by"], "library_ms": ti["library_ms"],
            "work": f"G=1008 Lp=D=256 bf16, {part}; launches of the tool's default run (24 calls)",
            **({"by_mode_ms": ti["by_mode_ms"]} if "by_mode_ms" in ti else {}),
        })
    # the one-pass attentions carry their launch: route, registers, local memory, blocks per SM
    # ([5], [7d], [8d], [9c], [10b]); the GEMMs their like-for-like yardstick, torch.addmm ([5], [7d], [10b])
    launch_of = {"flash_fwd": (ftimes, "flash_fwd"), "flash_bwd": (ftimes, "flash_bwd"),
                 "attention": (times, "attention"), "layer_norm_backward": (ttimes, "layer_norm_backward"),
                 "attention[train]": (ttimes, "attention[train]"), "attention[w8a8]": (wtimes, "attention[w8a8]"),
                 "attention_backward": (ttimes, "attention_backward")}
    fwd_bwd_of = {"attention_backward": ttimes, "flash_bwd": ftimes}  # SDPA forward + backward, the second yardstick
    like_of = {"linear": (times, "linear"), "linear[train]": (times, "linear")}
    for entry in kernels:
        name = entry["name"]
        if name in launch_of:
            tset, key = launch_of[name]
            entry["launch"] = tset["intra"][key]["launch"]
            entry["inter"]["launch"] = tset["inter"][key]["launch"]
        elif name in ("kp_attention", "kp_layer_norm"):
            entry["launch"] = parts["times"][name]["launch"]
        if name in fwd_bwd_of:
            entry["library_fwd_bwd_ms"] = fwd_bwd_of[name]["intra"][name]["library_fwd_bwd_ms"]
            entry["inter"]["library_fwd_bwd_ms"] = fwd_bwd_of[name]["inter"][name]["library_fwd_bwd_ms"]
        if name == "flash_bwd":  # PyTorch's flash backward on its own [G, L, H, hd] layout
            entry["library_glhd_ms"] = ftimes["intra"][name]["library_glhd_ms"]
            entry["inter"]["library_glhd_ms"] = ftimes["inter"][name]["library_glhd_ms"]
        if name in like_of:
            tset, key = like_of[name]
            entry["library_like_ms"] = tset["intra"][key]["library_like_ms"]
            entry["inter"]["library_like_ms"] = tset["inter"][key]["library_like_ms"]
        elif name == "linear[kernel_parts]":
            entry["library_like_ms"] = parts["times"]["linear[kernel_parts]"]["library_like_ms"]
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel of the path was not launched: {[k['name'] for k in kernels if k['launches'] <= 0]}")
    log(f"  whole run {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels,
                      "fused_stack": {k: {kk: vv for kk, vv in v["fused_stack"].items()} for k, v in times.items()},
                      "forward_ms": fwd_ms, "realtime_factor": audio_s / (fwd_ms / 1e3),
                      "train_step": bench, "train_times": ttimes, "flash_parity": flash_parity,
                      "flash_train_step": flash_bench, "flash_times": ftimes, "w8a8_serving": w8_serve,
                      "w8a8_times": wtimes, "kernel_parts": parts, "trainer": trainer, "tiny_trainer": tiny,
                      "eval": evals, "bench": benches, "llama": llama, "hcontext": hcontext,
                      "cascaded": cascaded, "data_parallel": dp, "every_width": widths, "mla_prefill": mla_times}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--leg"]:  # one rank of a leg of [18], started by phase18
        LEGS[sys.argv[2]](sys.argv[3])
        sys.exit(0)
    sys.exit(main())
