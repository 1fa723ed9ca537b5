#!/usr/bin/env python3
"""Drive the PyTorch port (``diff_vits_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

``--out DIR`` also writes the kernel rows, the serving numbers (the
command lines' and the samplers' under ``cli``, the sampler library's
under ``samplers``), the training numbers
(flash route off and on), the variant's serving and training numbers, the training command
line's, the checkpoint bridge's, bv2's, rematerialisation's, the MoE
model's and data parallelism's numbers as ``DIR/kernels.json``,
``DIR/path.json``, ``DIR/train.json``, ``DIR/variant.json``,
``DIR/train_cli.json``, ``DIR/ckpt_bridge.json``, ``DIR/bv2.json``,
``DIR/remat.json``, ``DIR/moe.json``, ``DIR/dp.json``,
``DIR/shard.json``, ``DIR/seq_parallel.json``, ``DIR/pipeline.json``,
``DIR/offpath.json`` and ``DIR/walls.json``.

Phases, each of which fails the run:

1. card: name and power limit (nvidia-smi);
2. build: nvcc compiles ``diff_vits_tpu_torch/csrc`` into ``build/``;
3. kernels: each of K1-K4 (the four UNet kernels) runs at the main path's
   shapes in float32 and bfloat16 and is held against its plain PyTorch
   version (max |kernel - plain| / max |plain| <= 1e-3 in float32, 3e-2 in
   bfloat16), with its weights in the layout the UNet modules hand over
   (strided views of nn.Linear / nn.Conv1d parameters, vectors in the
   compute dtype), K1-K4 also at B=1 (denoiser L0 and L3 / mid, the
   grid-starved shapes of b=1 serving), and the attention core of K2 and
   K3 alone (csrc/attention.cu through ``_cuda.attention``) at each K2/K3
   case, self and cross, against ``attention_plain``; kernel, plain and
   library-composition times (CUDA events, warmed, mean of many
   back-to-back calls, the wrapper's host work included; the core's
   library call is ``F.scaled_dot_product_attention``), the kernel
   route's and the library composition's device times (torch.profiler,
   summed device activity per call), for K2, K3 and the core the core's
   own device time by kernel name (bf16 must run only
   ``attention_mma_kernel``, float32 only ``attention_fma_kernel``), and
   the roofline bound are printed;
   then K5 (rel-pos attention) at B=8, C=256, 2 heads of 128, window 4:
   T=128 and 601 with ragged lengths (kept rows compared) and T=400
   unmasked, float32 and bfloat16, same gates, its core's own device time
   (bf16 must run only ``rel_attention_mma_kernel``, float32 only the FMA
   ``rel_attention_kernel``) and a bound that counts what the lengths
   need (kept rows against kept keys, masked rows against all); and K7 (RQ spline) at
   N=4808 (8 x 601), inverse and forward in float32 (outputs atol/rtol
   1e-5, log|det| 1e-4) and inverse in bfloat16 (outputs rtol 1e-2, one
   bf16 rounding); K5 against its plain route at B=1 and 8, T=128 and
   601 in bfloat16 (the route decision); and K8 (flash attention) at the
   training step's gated sites, B=32, 8 heads: the DP UNet's level-0
   self (T=S=601, d=8, no mask) and cross attention (T=601, S=400, d=8),
   the denoiser's level-0 cross attention (T=400, S=267, d=16) and the
   prompt encoder layer of ``o_proj`` (T=S=400, d=32), the last three with
   ragged keep masks, in float32 and bfloat16: forward output and
   log-sum-exp against ``sdpa_plain``, dq/dk/dv against autograd of it and
   against ``sdpa_backward_plain`` on the kernel's own o and lse, each
   gradient in its input view's layout; same gates; bfloat16 must run
   only the tensor-core kernels (``flash_*_mma_kernel``), float32 only the
   FMA ones (route counters; the profiler's kernel names are printed); the
   forward, the
   backward and forward + backward timed for the kernel, the plain version
   and the library (``F.scaled_dot_product_attention``; the backward alone
   as the ATen backward op of the backend it takes, on its own forward),
   and, once the route-on training has run, each site's launches a model3
   step beside its device ms, library device ms and bound;
4. mas: K6 (MAS) against its plain version at the training shape (B=32,
   Ty=400, Tx=601; ragged lengths, t_x == t_y, t_x == 1) on random and on
   tied integer scores: identical paths (0 mismatched cells); its times,
   device time, bound and serial depth;
5. grad: gradients of sum(out * r) through each of K1-K4's kernel route
   (the autograd Function) at denoiser level 0, B=8, float32, against
   plain autograd, for x and every weight and vector passed as the UNet
   passes them: every leaf gets one, max rel error <= 1e-3; then flash
   gradient parity: model3 at ``reference_parity`` widths, B=8, float32,
   eval mode with the UNet's fused route off, injected t and noise,
   ``DiffVits.forward`` and backward with the flash route off and on: loss
   within rel 1e-4, every parameter gradient within 1e-3 of its leaf's
   scale by its norm, and by its largest entry on every leaf that no ReLU,
   clamp, abs or max separates from the loss; K8 counters equal to the
   calls through the flash gate, every launch on the FMA kernels (route
   counters and profiler names); then the route off with every ReLU on
   the branches the route-on run took: every gradient within 1e-3 of its
   leaf's largest entry (a ReLU input within rounding of 0 may flip between
   the routes; this shows the flips explain what the kink-free gate
   leaves out);
6. vocoder: ``Vocos`` at the published widths (100 mels, dim 512,
   intermediate 1536, 8 layers, n_fft 1024, hop 256), random weights from
   a seed written as a published-layout (charactr/vocos-mel-24khz) state
   dict and loaded on the card by ``load_vocoder``; a b=8, 400-frame mel
   decoded in float32 against the same module on the CPU (finite, 399 x
   256 samples, max |diff| <= 1e-3 x max(1, max |wav|)); the decode's
   device ms, wall ms and peak memory;
7. path (serving): ``BatchSynthesizer`` (bf16 weights, batch 8, mel
   buckets 400 and 800, 30-step UniPC, the vocoder of phase 6) answers 10
   requests at the widths of ``configs/reference_parity.json`` with
   random weights from a seed, each with a finite waveform of n x hop
   samples (or the bucket's (T - 1) x hop where that is shorter);
   every kernel counter must rise by exactly 22/16/16/16 per UNet call
   (the attention core's by 32), K5's by one per layer of each encoder
   call (6 per TextEncoder call), all on the tensor-core K5 kernel (its
   route counters), and MAS's and K7's by 0, and no call may reach the
   core's plain version ``attention_plain``;
8. parity: one fixed batch in float32 through the kernels and through the
   plain path on the card (same weights, injected initial noise, zero prior
   noise), max |mel difference| <= 5e-3, the kernel run's attention core
   only ``attention_fma_kernel`` (profiler);
9. serving numbers: per-request latency at batch 1 and 8, real-time factor,
   peak device memory, each run's mel also decoded by the vocoder (its
   wall time apart, the real-time factor with it); then one more warmed
   ``synthesize`` at each batch under torch.profiler: the device's busy
   share, device time by kernel and the GEMM kernels' launches and time;
   bf16 serving must show only the tensor-core GEMM (``gemm_mma_kernel``),
   no FMA mainloop, and only the tensor-core attention core
   (``attention_mma_kernel``);
10. cli (serving from text and wav): random ``reference_parity`` weights
   from seed 3 written as a port checkpoint, a seeded ~3 s 24 kHz prompt
   wav and a manifest of 10 English rows (5 short, 5 long);
   ``infer.tts_infer.main`` (one row, 30-step UniPC, bf16, the vocoder
   phase's published-layout Vocos file) and ``infer.serve.main`` (batch
   8, mel buckets 400 and 800, both used, the same vocoder) run in
   process: every mel [n, 100] finite and every wav of (n - 1) x hop or
   n x hop samples written; then DPM-Solver++ and DDIM (30 steps, b=8,
   mel bucket 400) and DDPM (b=1, 1000 steps) on the same weights; every
   run's counters exactly 22/16/16/16 per UNet call (the core 32; the UNet
   calls counted by hooks, the duration predictor's included) and one K5
   launch an encoder layer, all on the tensor-core K5 kernel, bf16 weights
   (the tensor-core GEMM and attention routes), no ``attention_plain``
   call, K6, K7 and K8 at 0; DPM-Solver++ and DDIM also in float32,
   kernels against the plain route on the card with injected initial
   noise and zero prior noise (max |mel difference| <= 5e-3), and their
   latency and real-time factor at batch 1 and 8 (median of 3 warmed
   runs); DDPM's one run timed;
11. train (the training path): ``Trainer`` at ``reference_parity`` widths
   (EMA on, random weights from seed 0, bf16 autocast) takes 2 warm-up
   and 5 timed steps on batches of 32 shaped like the loader's (text 601,
   mel 400, prompts 267 cut by ``random_slice``): finite losses, every
   parameter and the EMA changed, the EMA no alias of the parameters, one
   K6 launch and no other kernel launch a step; median step time, steps/s,
   peak memory, and under torch.profiler (the second warm-up step) K6's
   device time and share of the step, the busy share and the top kernels;
   then the same with the flash route on (``set_use_flash``):
   each step also exactly one K8 forward and one K8 backward launch for
   each attention call through the flash gate (counted by hooks on the
   modules, from their own gate; 40 + 40 for model3), every one of them on
   the tensor-core kernels (the route counters each step, and in the
   profiled step the profiler's names: the three ``flash_*_mma_kernel``s
   and no FMA kernel);
12. eval parity: ``Trainer.eval_fixed_t_loss`` (eval mode, float32, TF32
   off) through the kernels and through the plain route on the card:
   every value within rel 1e-4, the MAS paths equal, the counters
   22/16/16/16 per UNet call, 6 K5 launches per TextEncoder call and 1 per
   MAS call;
13. variant serving: the same ``BatchSynthesizer`` run for the VITS variant
   of ``reference_parity`` with the stochastic duration predictor and the
   residual-coupling spec flow (``duration_predictor="sdp"``,
   ``use_flow=True``; random weights from seed 0, bf16, batch 8, mel
   buckets 400 and 800, the K5 route on): counters exactly 22/16/16/16
   per UNet call, 6 K5 launches per TextEncoder call (all on the
   tensor-core kernel) and 3 K7 launches per stochastic-duration reverse
   (its three ConvFlow reverses); the same run again under
   torch.profiler, every K7 launch on ``spline_group_kernel``; then the
   variant in float32, kernels against the plain route on the card with
   injected duration and initial noise (equal frame counts, max |mel
   difference| <= 5e-3), and its latency at batch 1 and 8, real-time
   factor and peak memory;
14. variant training: the variant trained by the same ``Trainer`` (B=32,
   bf16, 2 warm-up and 3 timed steps) with the flash route off and on, with
   the checks of phase 11 (no K5 or K7 launch: both are inference-only);
15. train_cli (training from a dataset on disk): 80 seeded 24 kHz
   utterances of 1.5-6.0 s with cleaned EN transcripts, preprocessed by
   ``data.preprocess.main(--cleaned)``; ``train.cli.main`` at
   ``reference_parity`` widths (B=32, bf16) for 6 steps (checkpoint and
   ``eval_sample`` every 3, samples decoded by the vocoder phase's Vocos
   file), then ``--resume auto`` to step 8: the native loader, finite
   logged losses, checkpoints 3 and 6, the resume line, both samples' mel
   and wav, the eval metrics, and each run's launches equal to its calls
   counted by hooks (K1-K4 and the core 22/16/16/16 and 32 a UNet call of
   ``eval_sample``, K5 one an encoder layer, K6 one a training forward,
   K8 forward and backward one a gated call, forward only when autograd
   is off) and those calls equal to the ones derived from the code (40
   gated calls a step, 41 UNet calls an ``eval_sample``); then, not gated,
   both loaders' batches/s at B=32, the step with the prefetch on and off
   in turns (2 runs a side of 2 warm-up and 5 timed steps), one
   ``eval_sample``'s and one save's wall time and the peak memory;
16. ckpt_bridge (checkpoints between the reference, JAX and the port):
   a seeded model3 at ``reference_parity`` widths written in the
   reference's torch layout (``reference_state_dict``: ``module.``
   prefixes, weight-normed WN layers), converted by ``utils.convert.main``
   (bitwise but the WN leaves, 1e-6), served by ``BatchSynthesizer``
   (K1-K5 counts, mels within 1e-6 of the seeded model's), trained 3
   steps from it with the flash route on (K6 and K8 counts derived from
   the code), exported by ``Trainer.save_flax`` and reloaded bitwise,
   stepped on beside the original (deterministic algorithms) within the
   original's own run-to-run gap, and resumed once through
   ``train.cli --resume``;
17. bv2 (the phoneme VAE on the sdp + flow variant): serving with the
   variant phase's checks and the fp32 kernels-vs-plain parity, latency
   at b=1 and 8, one training forward from the plain random weights (its
   phoneme KL read, not gated: it overflows, the warm-up gap of ROADMAP
   Queue 3), and 5 training steps with the flash route on from those
   weights with the phoneme posterior's std at 1: K6 one a step, K8
   ``bv2_flash_sites`` a step forward and backward (derived from the
   code), ``loss/kl_ph`` finite and non-zero;
18. remat (``train.remat_policy``): model3 at the training phase's
   configuration (B=32, bf16, flash route on) under "none", "dots" and
   "full": 2 steps under deterministic algorithms, whose losses, clipped
   gradients and parameters equal "none"'s (rel 1e-5, 1e-5 of each
   leaf's largest gradient, 1e-6), K6 one a step and K8 forward twice
   (once under "none") and backward once for each call through the flash
   gate, then 3 timed steps: median step time and peak memory, "full"'s
   peak below "none"'s;
19. moe: model3 with the MoE feed-forward in the denoiser (4 experts, top
   2): serving (bf16, batch 8, mel bucket 400) with K1 22 a UNet call of
   either UNet, K2-K4 16 and the core 32 a duration-predictor call and
   none in the denoiser, K5 6 a TextEncoder call; fp32 kernels against
   the plain route at b=1 and 8 (5e-3 on the items routed alike); latency
   at b=1 and 8; 3 training steps (K6 1, K8 40 + 40 a step); beside dense
   model3's numbers of this run, with no claim;
20. dp (data parallelism over ``torch.distributed``): one NCCL rank
   spawned as torchrun would start it runs ``train.cli`` at
   ``configs/multi_chip_dp.json`` (2 steps, ``--resume auto`` to 3) and
   ``serve --dp``; then two gloo ranks on the one card: one training step
   against one process's on the whole batch (float32, deterministic
   algorithms, losses within rel 1e-5, params within 1e-4, the ranks
   equal) and
   ``BatchSynthesizer(dp=True)`` against one process (mels within 5e-3).
   Multi-GPU speed is not measured (one card);
21. samplers (the sampler library): model3 at ``reference_parity``
   widths (random weights from seed 4), b=8, mel bucket 400, content and
   prompt keys taken once, every solver driven from one injected x_T with
   a 2-argument callback over ``DiffusionEncoder.denoise``: 30-step UniPC
   bh2 (the serving default) and 20-step DPM-Solver++ multistep order 3,
   singlestep order 3 on the logSNR grid, singlestep_fixed order 2 on the
   quadratic grid, DPM-Solver (noise prediction) order 2 taylor, order 2
   with dynamic thresholding and ``denoise_to_zero``, UniPC bh1 order 3,
   vary_coeff order 2 on the quadratic grid and bh2 noise prediction: the
   bf16 run's denoiser calls equal the setting's model evaluations, its
   launches 22/16/16/16 a call (the core 32) and no K5-K8, the float32
   kernel route against the plain route within 5e-3 (gated); ms a
   request and a denoiser call (median of 3 warmed bf16 runs) and the
   distance to a 100-step DPM-Solver++ solve (printed); the adaptive
   solver (order 2, JAX's controls) at b=1, its launches matching its
   evaluations and its mel finite (gated), its evaluations and wall time
   printed; an ``inverse_dpmpp`` round trip of one mel (printed);
22. shard (the state sharded as JAX's ``state_sharding_rules`` shard it):
   two gloo ranks on the card, model3 B=16 (32 until PR 16: cut for the
   time limit), one step each on the meshes
   (1 data, 2 model), (1 data, 2 fsdp) and (1 data, 2 expert; 4 experts)
   against one process's float32 step (losses rel 1e-5, params 1e-4),
   a bfloat16 step's loss finite, each rank's held parameters, moments
   and EMA against the rules' shapes and bytes, one K6 and as many K8
   backward as forward launches a rank, K8 at the local 4 heads on the
   ``model`` mesh's split sites and there against ``sdpa_plain``;
23. seq_parallel (``parallel.activations``, ``parallel.ring_attention``):
   two gloo ranks on the card on a ``seq`` axis, model3 at
   ``reference_parity`` widths: the denoiser UNet (eval mode) at B=8 and
   a long mel, T=800 (400 frames a rank), in float32 and bfloat16, each
   rank's frames gathered against one process's forward (gates ``TOL``),
   each rank's launches K1 22, K2 16 (the ring core), K3 16, K4 16, the
   core 16 and K8 2 x 16 forward (the ring's blocks); one ``Trainer`` step
   (B=8, T=800, ZeRO-3 over ``seq``) in float32 against one process's
   (loss rel 1e-4, params 1e-4) with 2 x 16 ring K8 forward and backward
   launches, a bfloat16 step's loss finite; K8 at the ring's block shapes
   against ``sdpa_plain``; each rank's peak memory and time;
24. pipeline (``parallel.pipeline``): two gloo ranks on the card, a
   ``stage`` each, ``o_proj``'s six EncSALayers (C=256, 8 heads, flash
   route on, float32), batch 8 of 400 frames in 4 micro-batches, against
   the sequential stack in one process on the same micro-batches (output
   and gradients within ``TOL``) and on the whole batch (output), K8 12
   forward and 12 backward launches a stage;
25. offpath (the modules off the main path, ``offpath_cases``): every
   type ``get_down_block`` and ``get_up_block`` build (11 + 11) at a level
   of model3's diffusion UNet (256 -> 384, 8 GN groups, 8 heads, temb 512,
   a 267-frame context of 128), ``DualTransformer1D``, the adaptive
   norms, the general VITS ``MultiHeadAttention`` and the ``Decoder`` at
   the TextEncoder's widths over 128 tokens, ``OPERATIONS_ENCODER`` 1-15
   at hidden 256, ``ConvAttentionLayer``, ``ReferenceEncoder`` (100 mels,
   gin 256), ``SpeakerEncoder`` 2 x 256, LoRA around a 512-wide Linear
   and Conv1d, the functional SDPA, the resamplers and the sequence
   helpers, at B=8 and 400 frames: each module in float32 against the
   same module and weights on the CPU on its first 2 items (TF32 off;
   max |card - CPU| / max |CPU| <= 1e-4), in bfloat16 finite; the
   ``DownBlock`` / ``UpBlock`` / ``CrossAttn*Block`` types and
   ``DualTransformer1D`` through K1-K4, the counters zeroed before and
   read after each fused forward (one K1 a resnet; one K2, K3, K4 and two
   cores a transformer block), within ``TOL`` of their plain route in
   both dtypes; every other module launches no kernel.

Every phase's wall time is printed (``DIR/walls.json`` with ``--out``).

The launch counts in the kernel table are those of each kernel's own path:
serving for K1-K4 and the attention core, training for K6, the variant's
serving for K5 and K7,
training with the flash route on for K8 (forward and backward); the
ckpt_bridge, bv2, remat, moe, shard, seq_parallel, pipeline and offpath
phases gate their own counts and print them.
The last line of standard output is one JSON object with the device; the
line before it the kernel table. Exits non-zero, printing no result, when
there is no CUDA device or the port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # FP32 FMA / bf16 TC
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
REPLACES = {
    "fused_resnet_block": "diff_vits_tpu/ops/fused_resnet.py:133",
    "fused_self_attention": "diff_vits_tpu/ops/fused_transformer.py:139",
    "fused_cross_attention": "diff_vits_tpu/ops/fused_transformer.py:173",
    "fused_geglu_ff": "diff_vits_tpu/ops/fused_transformer.py:246",
    # the score/softmax/PV core of K2 and K3 (_mha, inside their kernels)
    "attention": "diff_vits_tpu/ops/fused_transformer.py:41",
    "maximum_path": "diff_vits_tpu/ops/mas_pallas.py:89",
    "fused_rel_self_attention": "diff_vits_tpu/ops/rel_attention.py:90",
    "unconstrained_rqs": "diff_vits_tpu/ops/spline_pallas.py:132",
    "flash_attention_forward": "diff_vits_tpu/ops/flash_attention.py:81",
    "flash_attention_backward": "diff_vits_tpu/ops/flash_attention.py:81",
}
SOURCE = {
    "fused_resnet_block": "diff_vits_tpu_torch/csrc/gemm.cu",
    "fused_self_attention": "diff_vits_tpu_torch/csrc/attention.cu",
    "fused_cross_attention": "diff_vits_tpu_torch/csrc/attention.cu",
    "fused_geglu_ff": "diff_vits_tpu_torch/csrc/gemm.cu",
    "attention": "diff_vits_tpu_torch/csrc/attention.cu",
    "maximum_path": "diff_vits_tpu_torch/csrc/mas.cu",
    "fused_rel_self_attention": "diff_vits_tpu_torch/csrc/rel_attention.cu",
    "unconstrained_rqs": "diff_vits_tpu_torch/csrc/spline.cu",
    "flash_attention_forward": "diff_vits_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_backward": "diff_vits_tpu_torch/csrc/flash_attention.cu",
}
# per UNet call (nn/unet1d.py: 22 resnets, 16 transformer blocks; the
# attention core once in each K2 and K3)
PER_UNET = {"fused_resnet_block": 22, "fused_self_attention": 16,
            "fused_cross_attention": 16, "fused_geglu_ff": 16,
            "attention": 32}
# csrc/attention.cu's kernels by route, as the profiler names them
CORE_KERNEL = {"bfloat16": "attention_mma_kernel",
               "float32": "attention_fma_kernel"}
CORE_USERS = ("fused_self_attention", "fused_cross_attention", "attention")
# csrc/rel_attention.cu's kernels (K5's core) by route
REL_KERNEL = {"bfloat16": "rel_attention_mma_kernel<",
              "float32": "rel_attention_kernel<"}
# csrc/flash_attention.cu's kernels by route, as the profiler names them
# (bf16 at the model's head dims on tensor cores, float32 on FMA)
FLASH_KERNELS = {"mma": ("flash_fwd_mma_kernel<", "flash_bwd_dq_mma_kernel<",
                         "flash_bwd_dkdv_mma_kernel<"),
                 "fma": ("flash_fwd_kernel<", "flash_bwd_dq_kernel<",
                         "flash_bwd_dkdv_kernel<")}
FLASH_ROUTE = {"bfloat16": "mma", "float32": "fma"}
# the stochastic duration predictor's reverse drops flow_0 and so runs
# three of its four ConvFlows (models/duration.py)
K7_PER_SDP_REVERSE = 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches, warmed."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_by_name(prof):
    """{kernel name: (activities, device us)} of a torch.profiler run: the
    device's own activities (kernels, copies, sets), not the user
    annotations (``record_function`` ranges such as ``Optimizer.step``)
    that the profiler also lists on the device."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return by_name


PROFILER_TRIES = 8


def device_times(fn, iters: int = 10):
    """Mean device milliseconds per ``fn()``: the summed duration of the
    device activities torch.profiler records over ``iters`` warmed calls,
    and the same by kernel name. The profiler now and then records no
    device activity in a window, several in a row: a lost window is taken
    again after a pause, up to ``PROFILER_TRIES`` windows; (None, {}) when
    all of them are lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.25)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {k: us / 1e3 / iters
                   for k, (_, us) in device_by_name(prof).items()}
        if sum(by_name.values()) > 0:
            return sum(by_name.values()), by_name
    return None, {}


def profiled_run(fn):
    """(``fn()``'s result, the profiler, wall us) of one ``fn()`` under
    torch.profiler (CPU and CUDA), ending in a synchronise; a window that
    recorded no device activity is run again after a pause, as in
    :func:`device_times` (``fn`` must give the same result each time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.25)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if device_by_name(prof):
            break
    return out, prof, wall_us


def device_names(fn):
    """Names of the device activities of one ``fn()`` (:func:`profiled_run`;
    [] when every window was lost)."""
    return list(device_by_name(profiled_run(fn)[1]))


def device_time(fn, iters: int = 10):
    """Mean device milliseconds per ``fn()`` (:func:`device_times`)."""
    return device_times(fn, iters)[0]


def _flash_kernels(names):
    """{route: sorted K8 kernel names of that route among ``names``}."""
    return {route: sorted({k for k in kernels for n in names if k in n})
            for route, kernels in FLASH_KERNELS.items()}


def _flash_route_only(names, route):
    """Whether ``names`` hold each K8 kernel of ``route`` and none of the
    other route's."""
    seen = _flash_kernels(names)
    return all(len(seen[r]) == (3 if r == route else 0) for r in seen)


def _core_kernels(by_name, kernels=CORE_KERNEL):
    """{route: device ms} of csrc/attention.cu's kernels (or another
    route table's) among ``by_name``."""
    return {route: sum(ms for k, ms in by_name.items() if kernel in k)
            for route, kernel in kernels.items()
            if any(kernel in k for k in by_name)}


# -- kernel phase -----------------------------------------------------------

def _module_layout(torch, t, dtype):
    """``t`` as the UNet modules pass it to the fused ops: a [.., in, out]
    weight as a view of nn.Conv1d [out, in, k] or nn.Linear [out, in]
    storage; a norm parameter or bias in the compute dtype."""
    if t.dim() == 3:
        return t.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    if t.dim() == 2:
        return t.t().contiguous().t()
    return t.to(dtype)


def _attention_core(q, k, v, bias, *, heads, compute_dtype):
    """The attention core of K2 and K3 alone (csrc/attention.cu through
    its wrapper, planned by ``_cuda.attention_plan``)."""
    from diff_vits_tpu_torch.ops import _cuda
    return _cuda.attention(q, k, v, bias, heads)


def _ops(name):
    """(kernel route, plain version) of the fused op ``name``."""
    from diff_vits_tpu_torch.ops import fused_resnet as FR
    from diff_vits_tpu_torch.ops import fused_transformer as FT
    if name == "attention":
        return _attention_core, FT.attention_plain
    mod = FR if name == "fused_resnet_block" else FT
    return getattr(mod, name), getattr(mod, name + "_plain")


def _kernel_cases(torch, dtype, gen, dev):
    """(kernel name, site, positional args, keyword args, library fn,
    flops, bytes) at the main path's shapes: denoiser UNet levels 0/2/3 at B=8 (T 400,
    100, 50; C 128, 384, 512; head dims 16, 48, 64), its widest up-block
    resnet (Ci=1024), and the duration-predictor UNet at T=601 (C=64,
    head dim 8, cross-attention keys of width 256). Cross-attention keys:
    S=267 prompt frames with a ragged mask. K1 and K4 also at B=1, the
    grid-starved shapes of b=1 serving: denoiser L0 (T=400, C=128) and L3
    (T=50; K1's widest up-block resnet Ci=1024 -> 512, K4 at C=512)."""
    import torch.nn.functional as F

    f32 = torch.float32
    esz = torch.finfo(dtype).bits // 8

    def r(*shape, scale=1.0, dt=f32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    def act(*shape):
        return r(*shape, dt=dtype)

    def w(*shape, scale):
        """A weight [.., in, out] in the module's layout and dtype."""
        return _module_layout(torch, r(*shape, scale=scale, dt=dtype), dtype)

    def v(n, scale=0.1, one=0.0):
        """A norm parameter or bias in the module's dtype."""
        return _module_layout(torch, one + r(n, scale=scale), dtype)

    cases = []
    for site, b, t, ci, co, groups in [
            ("denoiser L0", 8, 400, 128, 128, 8),
            ("denoiser L2 down", 8, 100, 256, 384, 8),
            ("denoiser L3 up", 8, 50, 1024, 512, 8),
            ("dp-unet L0", 8, 601, 64, 64, 8),
            ("denoiser L0", 1, 400, 128, 128, 8),
            ("denoiser L3 up", 1, 50, 1024, 512, 8)]:
        x = act(b, t, ci)
        args = (x, r(b, 2 * co, scale=0.3), v(ci, one=1.0), v(ci),
                w(3, ci, co, scale=(3 * ci) ** -0.5), v(co), v(co, one=1.0),
                v(co), w(3, co, co, scale=(3 * co) ** -0.5), v(co))
        sc = ((w(ci, co, scale=ci ** -0.5), v(co)) if ci != co
              else (None, None))
        kw = dict(groups=groups, eps=1e-5, compute_dtype=dtype)
        w_conv1 = args[4].permute(2, 1, 0)       # the nn.Conv1d parameter
        w_conv2 = args[8].permute(2, 1, 0)

        def lib(args=args, sc=sc, w1=w_conv1, w2=w_conv2, co=co, g=groups):
            x, film = args[0], args[1]
            h = F.silu(F.group_norm(x.transpose(1, 2), g, args[2].to(x.dtype),
                                    args[3].to(x.dtype), 1e-5))
            h = F.conv1d(h, w1, args[5].to(x.dtype), padding=1)
            h = F.group_norm(h, g, args[6].to(x.dtype), args[7].to(x.dtype),
                             1e-5)
            fl = film.to(x.dtype)[:, :, None]
            h = F.silu(h * (1 + fl[:, :co]) + fl[:, co:])
            h = F.conv1d(h, w2, args[9].to(x.dtype), padding=1)
            s = (x if sc[0] is None else
                 F.linear(x, sc[0].t(), sc[1].to(x.dtype)))
            return s + h.transpose(1, 2)

        m = b * t
        flops = 2 * m * 3 * ci * co + 2 * m * 3 * co * co \
            + (2 * m * ci * co if sc[0] is not None else 0)
        nbytes = esz * (m * ci + m * co + 3 * ci * co + 3 * co * co
                        + (ci * co if sc[0] is not None else 0)) \
            + 4 * b * 2 * co + esz * (2 * ci + 6 * co)
        cases.append(("fused_resnet_block", f"{site} B={b} T={t} Ci={ci} "
                      f"Co={co}", args + sc, kw, lib, flops, nbytes))

    for site, b, t, c, ck in [("denoiser L0", 8, 400, 128, 128),
                              ("denoiser L2", 8, 100, 384, 128),
                              ("denoiser mid", 8, 50, 512, 128),
                              ("dp-unet L0", 8, 601, 64, 256),
                              ("denoiser L0", 1, 400, 128, 128),
                              ("denoiser mid", 1, 50, 512, 128)]:
        heads, s = 8, 267
        x = act(b, t, c)
        ln = (v(c, one=1.0), v(c))
        wq, wo, wk, wv = (w(c, c, scale=c ** -0.5) for _ in range(4))
        bo = v(c)
        m = b * t
        sargs = (x, *ln, wq, wk, wv, wo, bo)

        def lib_self(a=sargs, heads=heads):
            x, s1, b1, wq, wk, wv, wo, bo = a
            h = F.layer_norm(x, (x.shape[-1],), s1.to(x.dtype),
                             b1.to(x.dtype), 1e-5)

            def sp(z):
                return z.unflatten(-1, (heads, -1)).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                sp(h @ wq), sp(h @ wk), sp(h @ wv))
            return x + o.transpose(1, 2).flatten(2) @ wo + bo.to(x.dtype)

        akw = dict(heads=heads, compute_dtype=dtype)
        cases.append(("fused_self_attention",
                      f"{site} B={b} T={t} C={c} d={c // heads}", sargs, akw,
                      lib_self,
                      2 * m * c * 3 * c + 4 * b * t * t * c + 2 * m * c * c,
                      esz * (2 * m * c + 4 * c * c + 3 * c)))

        ctx = act(b, s, ck)
        keep = torch.ones(b, s, device=dev)
        for i in range(b):
            keep[i, s - 29 * i:] = 0.0
        bias = ((1 - keep) * -10000.0)[:, None, :].contiguous()
        wk2, wv2 = (w(ck, c, scale=ck ** -0.5) for _ in range(2))
        cargs = (x, ctx, bias, *ln, wq, wk2, wv2, wo, bo)

        def lib_cross(a=cargs, heads=heads):
            x, ctx, bias, s1, b1, wq, wk, wv, wo, bo = a
            h = F.layer_norm(x, (x.shape[-1],), s1.to(x.dtype),
                             b1.to(x.dtype), 1e-5)

            def sp(z):
                return z.unflatten(-1, (heads, -1)).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                sp(h @ wq), sp(ctx @ wk), sp(ctx @ wv),
                attn_mask=bias[:, None].to(x.dtype))
            return x + o.transpose(1, 2).flatten(2) @ wo + bo.to(x.dtype)

        cases.append(("fused_cross_attention",
                      f"{site} B={b} T={t} C={c} d={c // heads} S={s} "
                      f"Ck={ck}", cargs, akw, lib_cross,
                      2 * m * c * c + 4 * b * s * ck * c + 4 * b * t * s * c
                      + 2 * m * c * c,
                      esz * (2 * m * c + b * s * ck + 2 * c * c + 2 * ck * c
                             + 3 * c) + 4 * b * s))
        # the core alone at the same sites: self (S = T) and cross (S
        # prompt frames, the key bias as [B, S])
        for kind, sk, kbias in (("self", t, None),
                                ("cross", s, bias.view(b, s))):
            qkv = (act(b, t, c), act(b, sk, c), act(b, sk, c), kbias)
            cases.append(("attention", f"{site} {kind} B={b} T={t} S={sk} "
                          f"d={c // heads}", qkv, akw,
                          functools.partial(_library_core, F, qkv, heads),
                          4 * b * t * sk * c,
                          esz * (2 * b * t * c + 2 * b * sk * c)
                          + (4 * b * sk if kbias is not None else 0)))

        if b == 8:
            cases.append(_geglu_case(torch, F, site, b, t, c, x, ln, w, v,
                                     bo, dtype, esz))
    for site, t, c in [("denoiser L0", 400, 128), ("denoiser L3", 50, 512)]:
        cases.append(_geglu_case(torch, F, site, 1, t, c, act(1, t, c),
                                 (v(c, one=1.0), v(c)), w, v, v(c), dtype,
                                 esz))
    return cases


def _library_core(F, args, heads):
    """The attention core as one library call:
    F.scaled_dot_product_attention on the heads of q, k, v (views), the
    key bias as an additive mask in their dtype."""
    q, k, v, bias = args

    def sp(z):
        return z.unflatten(-1, (heads, -1)).transpose(1, 2)
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    return F.scaled_dot_product_attention(sp(q), sp(k), sp(v),
                                          attn_mask=mask)


def _geglu_case(torch, F, site, b, t, c, x, ln, w, v, bo, dtype, esz):
    """K4's case at [b, t, c]: (name, site, args, kwargs, library fn,
    flops, bytes)."""
    fargs = (x, *ln, w(c, 8 * c, scale=c ** -0.5), v(8 * c),
             w(4 * c, c, scale=(4 * c) ** -0.5), bo)

    def lib_ff(a=fargs):
        x, s1, b1, w1, bb1, w2, bb2 = a
        h = F.layer_norm(x, (x.shape[-1],), s1.to(x.dtype), b1.to(x.dtype),
                         1e-5)
        val, g = (h @ w1 + bb1.to(x.dtype)).chunk(2, dim=-1)
        return x + (val * F.gelu(g)) @ w2 + bb2.to(x.dtype)

    m = b * t
    return ("fused_geglu_ff", f"{site} B={b} T={t} C={c}", fargs,
            dict(compute_dtype=dtype), lib_ff,
            2 * m * c * 8 * c + 2 * m * 4 * c * c,
            esz * (2 * m * c + 12 * c * c + 11 * c))


def kernel_phase(torch, dev, headline_dtype="bfloat16"):
    """Hold every kernel against its plain version at every case; returns
    (ok, rows, per kernel: the first row in ``headline_dtype``, the main
    path's, with the largest |kernel - plain| of all its rows)."""
    ok = True
    rows, summary = [], {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(1234)
        for name, site, args, kw, lfn, flops, nbytes in _kernel_cases(
                torch, dtype, gen, dev):
            op, plain = _ops(name)
            kfn = functools.partial(op, *args, **kw)
            pfn = functools.partial(plain, *args, **kw)
            out = kfn()
            torch.cuda.synchronize()
            ref = pfn()
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            finite = bool(torch.isfinite(out.float()).all())
            good = finite and rel <= TOL[dname]
            rows.append(_time_row(torch, name, site, dname, kfn, pfn, lfn,
                                  flops, nbytes, diff, rel, good))
            if name in CORE_USERS:
                # bf16 on tensor cores, float32 on the FMA kernel, nothing
                # else
                rows[-1]["ok"] = good = good and \
                    list(rows[-1]["core_device_ms"]) == [dname]
            ok &= good
            if dname == headline_dtype and name not in summary:
                summary[name] = dict(rows[-1])
    for name, row in summary.items():
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows
                                 if r["name"] == name)
    return ok, rows, summary


# -- K5 and K7: the VITS encoder's attention and the spline couplings ------

REL_C, REL_HEADS, REL_WINDOW = 256, 2, 4     # reference_parity widths


def _rel_args(torch, gen, dev, b, t, dtype, ragged):
    """K5's inputs at the TextEncoder's widths as MultiHeadAttention passes
    them: weights as views of nn.Linear [out, in] storage and vectors and
    tables in the module dtype; ragged lengths (item 0 full) or none."""
    c, d = REL_C, REL_C // REL_HEADS

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    lengths = None
    if ragged:
        lengths = torch.tensor([t] + [max(1, t * (8 - i) // 8 - 3 * i)
                                      for i in range(1, b)], device=dev)
    w = [r(c, c, scale=c ** -0.5).t() for _ in range(4)]
    return (r(b, t, c), lengths, w[0], r(c, scale=0.1), w[1],
            r(c, scale=0.1), w[2], r(c, scale=0.1), w[3], r(c, scale=0.1),
            r(1, 2 * REL_WINDOW + 1, d, scale=d ** -0.5),
            r(1, 2 * REL_WINDOW + 1, d, scale=d ** -0.5))


def _rel_library(torch, args):
    """K5's function from PyTorch library calls (the yardstick, used
    nowhere in the port): F.linear projections, the memory-efficient SDPA
    with the relative-key band and the mask as one additive bias (which
    returns the row log-sum-exp), the value band from the neighbours'
    probabilities exp(score - lse), F.linear output projection."""
    import torch.nn.functional as F
    x, lengths, wq, bq, wk, bk, wv, bv, wo, bo, ek, ev = args
    b, t, c = x.shape
    h, w = REL_HEADS, REL_WINDOW
    d = c // h
    scale, dt, dev = d ** -0.5, x.dtype, x.device

    def heads(z):
        return z.unflatten(-1, (h, d)).transpose(1, 2).contiguous()

    q, k, v = (heads(F.linear(x, m.t(), bias))
               for m, bias in ((wq, bq), (wk, bk), (wv, bv)))
    ql = torch.einsum("bhtd,md->bhtm", q * scale, ek[0].to(dt))
    pos = torch.arange(t, device=dev)
    rel = pos[None, :] - pos[:, None]                      # s - t
    idx = (rel.clamp(-w, w) + w).expand(b, h, t, t)
    t_pad = (t + 15) // 16 * 16                            # aligned rows
    bias = torch.zeros(b, h, t, t_pad, device=dev, dtype=dt)[..., :t]
    bias.copy_(torch.where(rel.abs() <= w, ql.gather(-1, idx), 0.0))
    keep = (torch.ones(b, t, dtype=torch.bool, device=dev) if lengths is None
            else pos[None] < lengths[:, None])
    pair = keep[:, None, :, None] & keep[:, None, None, :]
    bias.masked_fill_(~pair, -1e4)
    out, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, 0.0, False, scale=scale)[:2]
    key = pos[:, None] + torch.arange(2 * w + 1, device=dev)[None] - w
    valid = (key >= 0) & (key < t)
    kb = F.pad(k, (0, 0, w, w)).unfold(2, 2 * w + 1, 1)   # [B,H,T,d,2w+1]
    sb = torch.einsum("bhtd,bhtdm->bhtm", q * scale, kb) + ql
    key_kept = keep[:, key.clamp(0, t - 1)] & valid        # [B, T, 2w+1]
    sb = sb.masked_fill(~(key_kept & keep[:, :, None])[:, None], -1e4)
    sb = sb.masked_fill(~valid, float("-inf"))
    pb = torch.exp(sb.float() - lse[..., :t, None])
    out = out + (pb @ ev[0].float()).to(dt)
    return F.linear(out.transpose(1, 2).flatten(2), wo.t(), bo)


def _rel_cost(b, t, esz, lengths=None):
    """(flops, bytes) of K5 at [b, t, 256]: the four projections, the score
    and PV products that these lengths need (a kept row against the
    item's kept keys, a masked row against all t, as the reference has a
    masked row attend uniformly) and the band, every row; x, the weights,
    vectors and tables read once, the output written once."""
    c, h, w = REL_C, REL_HEADS, REL_WINDOW
    d = c // h
    lens = [t] * b if lengths is None else [min(int(n), t) for n in lengths]
    pairs = sum(n * n + (t - n) * t for n in lens)
    flops = (2 * b * t * c * 4 * c + 4 * h * d * pairs
             + 4 * b * h * t * (2 * w + 1) * d)
    nbytes = esz * (2 * b * t * c + 4 * c * c + 4 * c
                    + 2 * (2 * w + 1) * d) + 4 * b
    return flops, nbytes


def _kept_err(torch, out, ref, lengths):
    """Max |out - ref| over kept rows, and that relative to max |ref|."""
    t = out.shape[1]
    keep = (torch.ones(out.shape[:2], dtype=torch.bool, device=out.device)
            if lengths is None else
            torch.arange(t, device=out.device)[None] < lengths[:, None])
    o, r = out.float()[keep], ref.float()[keep]
    diff = (o - r).abs().max().item()
    return diff, diff / max(r.abs().max().item(), 1e-30), \
        bool(torch.isfinite(o).all())


def _time_row(torch, name, site, dname, kfn, pfn, lfn, flops, nbytes, err,
              rel, good, extra=None):
    """One kernel row: times (kernel, device, plain, library, the library's
    device time) and bound."""
    ms = cuda_time(kfn)
    device_ms, by_name = device_times(kfn)
    if name in CORE_USERS:
        extra = dict(extra or {}, core_device_ms=_core_kernels(by_name))
    if name == "fused_rel_self_attention":
        extra = dict(extra or {},
                     core_device_ms=_core_kernels(by_name, REL_KERNEL))
    plain_ms = cuda_time(pfn, iters=5)
    lib_ms = cuda_time(lfn) if lfn is not None else None
    lib_device_ms = device_time(lfn) if lfn is not None else None
    peak = PEAK_FLOPS[dname]
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_S, flops / peak)
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= flops / peak \
        else "operations"
    row = dict(name=name, site=site, dtype=dname, max_abs_err=err,
               rel_err=rel, ok=good, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_device_ms, bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes, **(extra or {}))
    log(f"kernel {name:24s} {dname:8s} {site:44s} rel_err={rel:.2e} "
        f"{'ok' if good else 'FAIL'} ms={ms:.4f} device_ms={device_ms} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
        f"library_device_ms={lib_device_ms} "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + (f" core_device_ms={row['core_device_ms']}"
           if "core_device_ms" in row else ""))
    return row


def vits_kernel_phase(torch, dev, headline_dtype="bfloat16"):
    """K5 and K7 against their plain versions at the variant path's shapes;
    returns (ok, rows, {name: headline row}, the K5 route timings)."""
    import functools
    from diff_vits_tpu_torch.ops import rel_attention as RA
    from diff_vits_tpu_torch.ops import spline
    ok, rows, summary = True, [], {}
    name = "fused_rel_self_attention"
    kw = dict(heads=REL_HEADS, window=REL_WINDOW)
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(11)
        for b, t, ragged in ((8, 128, True), (8, 601, True),
                             (8, 400, False)):
            args = _rel_args(torch, gen, dev, b, t, dtype, ragged)
            kfn = functools.partial(RA.fused_rel_self_attention, *args,
                                    compute_dtype=dtype, **kw)
            pfn = functools.partial(RA.fused_rel_self_attention_plain, *args,
                                    compute_dtype=dtype, **kw)
            lfn = functools.partial(_rel_library, torch, args)
            out = kfn()
            torch.cuda.synchronize()
            ref = pfn()
            diff, rel, finite = _kept_err(torch, out, ref, args[1])
            lib_diff, lib_rel, _ = _kept_err(torch, lfn(), ref, args[1])
            flops, nbytes = _rel_cost(b, t, torch.finfo(dtype).bits // 8,
                                      args[1])
            site = (f"B={b} T={t} C={REL_C} H={REL_HEADS} w={REL_WINDOW} "
                    + ("ragged" if ragged else "no mask"))
            row = _time_row(torch, name, site, dname, kfn, pfn, lfn, flops,
                            nbytes, diff, rel, finite and rel <= TOL[dname],
                            dict(library_rel_err=lib_rel))
            # bf16 on rel_attention_mma_kernel, float32 on the FMA kernel,
            # nothing else
            row["ok"] = good = row["ok"] and \
                list(row["core_device_ms"]) == [dname]
            ok &= good
            rows.append(row)
            log(f"  library composition vs plain: rel err {lib_rel:.2e}; "
                f"core routes {row['core_device_ms']} (want {dname} only)")
            if dname == headline_dtype and t == 601:
                summary[name] = dict(rows[-1])

    name = "unconstrained_rqs"
    n, nb, tb = 8 * 601, 10, 5.0
    for dname, inverse in (("float32", True), ("float32", False),
                           ("bfloat16", True)):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(12)
        # the layout ConvFlow hands over: one [N, 3 nb - 1] projection,
        # widths and heights scaled copies, derivatives a strided slice
        proj = torch.randn(n, 3 * nb - 1, generator=gen, device=dev) \
            .to(dtype)
        uw, uh = proj[:, :nb] / 16.0, proj[:, nb:2 * nb] / 16.0
        ud = proj[:, 2 * nb:]
        x = (torch.randn(n, generator=gen, device=dev) * 3.0).to(dtype)
        skw = dict(inverse=inverse, tail_bound=tb)
        kfn = functools.partial(spline.unconstrained_rqs, x, uw, uh, ud, **skw)
        pfn = functools.partial(spline.unconstrained_rqs_plain, x, uw, uh, ud,
                                **skw)
        out, ld = kfn()
        torch.cuda.synchronize()
        ref, ref_ld = pfn()
        tol = 1e-5 if dname == "float32" else 1e-2
        out_ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        ld_ok = torch.allclose(ld, ref_ld, atol=1e-4, rtol=1e-4)
        diff = (out.float() - ref.float()).abs().max().item()
        ld_diff = (ld - ref_ld).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-30)
        good = bool(out_ok and ld_ok and torch.isfinite(out.float()).all())
        ok &= good
        esz = torch.finfo(dtype).bits // 8
        nbytes = n * (2 * esz + (3 * nb - 1) * esz + 4)
        # softmaxes and edges, softplus, bin search, the rational form
        flops = n * (25 * nb + 40)
        site = (f"N={n} bins={nb} tail={tb:g} "
                + ("inverse" if inverse else "forward"))
        rows.append(_time_row(torch, name, site, dname, kfn, pfn, None,
                              flops, nbytes, diff, rel, good,
                              dict(logdet_max_abs_err=ld_diff)))
        log(f"  log|det| max |diff| {ld_diff:.2e} (atol/rtol 1e-4)")
        if dname == "float32" and inverse:
            summary[name] = dict(rows[-1])
    summary[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows
                                       if r["name"] == name)
    summary["fused_rel_self_attention"]["max_abs_err"] = max(
        r["max_abs_err"] for r in rows
        if r["name"] == "fused_rel_self_attention")
    return ok, rows, summary, k5_route_timing(torch, dev)


def k5_route_timing(torch, dev):
    """K5 against the plain banded route at the TextEncoder's serving
    shapes (bfloat16, B 1 and 8, T 128 and 601, ragged): the numbers behind
    MultiHeadAttention's default route."""
    import functools
    from diff_vits_tpu_torch.ops import rel_attention as RA
    out = []
    gen = torch.Generator(device=dev).manual_seed(13)
    for b in (1, 8):
        for t in (128, 601):
            args = _rel_args(torch, gen, dev, b, t, torch.bfloat16, b > 1)
            kw = dict(heads=REL_HEADS, window=REL_WINDOW,
                      compute_dtype=torch.bfloat16)
            k_ms = cuda_time(functools.partial(
                RA.fused_rel_self_attention, *args, **kw))
            p_ms = cuda_time(functools.partial(
                RA.fused_rel_self_attention_plain, *args, **kw), iters=10)
            out.append(dict(b=b, t=t, kernel_ms=k_ms, plain_ms=p_ms))
            log(f"K5 route B={b} T={t} bf16: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms ({p_ms / k_ms:.1f}x)")
    return out


# -- the reference's checkpoint layout, built from a flax-named tree ---------

# the WN layers of the posterior encoder (transplant.wn_params), which the
# reference keeps under torch weight_norm (weight_g / weight_v)
REF_WEIGHT_NORM = ("vits.enc_q.enc.",)


class _Recorded:
    """A leaf a transplant helper would read: its layout (``kind``) and the
    reference key(s) (``name``: the module prefix, or the full key of a
    raw read); ``.T`` marks a transposed raw read (the EncSALayer's
    ``in_proj_weight``)."""

    def __init__(self, kind, name, transposed=False, taps=0):
        self.kind, self.name = kind, name
        self.transposed, self.taps = transposed, taps

    @property
    def T(self):
        return _Recorded(self.kind, self.name, not self.transposed)


class _AnyKey(str):
    """The one key of :class:`_Probe`: every prefix test matches it."""

    def startswith(self, *args):
        return True


class _Probe(dict):
    """The state a transplant reads while its helpers record: every key is
    in it, so every optional part (a bias, ``add_embedding``, a sampler)
    is recorded, and the tree decides which exist."""

    def __contains__(self, key):
        return True

    def __iter__(self):
        return iter([_AnyKey("")])


def _recorders(tp):
    """The transplant module ``tp``'s leaf helpers, and its helpers that
    read raw keys, replaced by recorders of (layout, reference key)."""
    def with_bias(kind):
        return lambda state, prefix: {
            "kernel": _Recorded(kind, prefix),
            "bias": _Recorded("raw", tp._j(prefix, "bias"))}

    def raw(*pairs):
        return lambda state, prefix: {
            leaf: _Recorded("raw", tp._j(prefix, key)) for leaf, key in pairs}

    return dict(
        _get=lambda state, name: _Recorded("raw", name),
        conv1d=with_bias("conv"), dense_from_conv1x1=with_bias("conv1x1"),
        dense_from_linear=with_bias("linear"),
        conv_tbc=raw(("kernel", "weight"), ("bias", "bias")),
        layernorm_gamma_beta=raw(("scale", "gamma"), ("bias", "beta")),
        layernorm=raw(("scale", "weight"), ("bias", "bias")),
        groupnorm=raw(("scale", "weight"), ("bias", "bias")),
        embedding=raw(("embedding", "weight")),
        ffn1_conv_params=lambda state, prefix, kernel_size: {
            "kernel": _Recorded("ffn1", tp._j(prefix, "ffn_1"),
                                taps=kernel_size),
            "bias": _Recorded("raw", tp._j(prefix, "ffn_1.0.bias"))})


def _reference_leaves(np, rec, value, weight_norm):
    """{reference key: numpy value} that ``rec``'s helper turns into
    ``value`` (a flax leaf)."""
    if rec.kind == "raw":
        return {rec.name: value.T if rec.transposed else value}
    if rec.kind == "ffn1":
        # transplant.ffn1_conv_params: tap i >= 1 is Linear_i, Linear_0
        # adds onto the centre tap and tap 0 has no Linear at all
        if np.any(value[0]):
            raise ValueError(f"{rec.name}: tap 0 of the FFN conv is not "
                             "zero, which no reference checkpoint can hold")
        out = {f"{rec.name}.{i}.weight": value[i].T
               for i in range(1, rec.taps)}
        out[f"{rec.name}.0.weight"] = np.zeros_like(value[0].T)
        return out
    w = {"conv": lambda k: k.transpose(2, 1, 0),
         "conv1x1": lambda k: k.T[:, :, None],
         "linear": lambda k: k.T}[rec.kind](value)
    if not any(rec.name.startswith(p) for p in weight_norm):
        return {f"{rec.name}.weight": w}
    # torch weight_norm (dim 0): weight = g * v / ||v|| over the other axes
    g = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
    return {f"{rec.name}.weight_g": g, f"{rec.name}.weight_v": w}


def reference_state_dict(tree, cfg, tp=None, prefix="module.",
                         weight_norm=REF_WEIGHT_NORM, as_tensors=True):
    """A state dict in the PyTorch reference's layout (model3's module
    names, torch weight layouts, ``prefix`` on every key as DDP writes it)
    whose transplant is the flax-named ``tree`` (numpy leaves), for the
    configuration ``cfg``. The transplant module ``tp`` (default the
    port's ``utils/transplant``; any module with the same helpers) is
    driven with its helpers replaced by recorders, which yields each flax
    leaf's reference key and layout; the keys are then filled from the
    tree, transposed back. The layers under ``weight_norm`` are stored as
    ``weight_g`` / ``weight_v``, so the transplant's collapse runs (it
    then gives the tree's weight within rounding, not bitwise). The tap 0
    of an EncSALayer FFN conv must be zero: the reference has no weight
    for it. A leaf of ``tree`` that no helper reads raises. ``as_tensors``:
    torch tensors, as a checkpoint holds them; else numpy views."""
    import numpy as np
    if tp is None:
        from diff_vits_tpu_torch.utils import transplant as tp
    saved = {name: getattr(tp, name) for name in _recorders(tp)}
    for name, fn in _recorders(tp).items():
        setattr(tp, name, fn)
    try:
        recorded = tp.diff_vits_params_from_config(_Probe(), cfg)
    finally:
        for name, fn in saved.items():
            setattr(tp, name, fn)
    out, unread = {}, []

    def walk(rec, node, path):
        for k, v in node.items():
            if k not in rec:
                unread.append(f"{path}{k}")
            elif isinstance(v, dict):
                walk(rec[k], v, f"{path}{k}.")
            else:
                out.update(_reference_leaves(np, rec[k], np.asarray(v),
                                             weight_norm))
    walk(recorded, tree, "")
    if unread:
        raise ValueError(f"the transplant reads no reference key for "
                         f"{len(unread)} leaves, e.g. {unread[:3]}")
    if not as_tensors:
        return {prefix + k: v for k, v in out.items()}
    import torch
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for kernels.json and path.json")
    out_dir = ap.parse_args(argv).out
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "diff_vits_tpu_torch").is_dir():
        print("chip_smoke: diff_vits_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from diff_vits_tpu_torch.ops import _cuda

    _exact_float32(torch)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} ({torch.cuda.device_count()} visible); "
        f"nvidia-smi: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_log = _cuda.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(build_log)

    phases = {}
    walls = {}
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = now - last[0]
        last[0] = now
        log(f"phase {name}: {walls[name]:.1f} s wall")
    k_ok, rows, summary = kernel_phase(torch, dev)
    phases["kernels"] = k_ok
    lap("kernels")
    v_ok, v_rows, v_summary, k5_route = vits_kernel_phase(torch, dev)
    phases["kernels_vits"] = v_ok
    rows += v_rows
    summary.update(v_summary)
    lap("kernels_vits")
    phases["kernels_flash"], f_rows, f_summary = flash_kernel_phase(torch,
                                                                    dev)
    rows += f_rows
    summary.update(f_summary)
    lap("kernels_flash")
    phases["mas"], summary["maximum_path"] = mas_phase(torch, dev, card)
    lap("mas")
    # no one PyTorch call
    summary["maximum_path"].update(library_ms=None, library_device_ms=None)
    phases["grad"] = grad_phase(torch, dev)
    phases["flash_grad"], flash_grad = flash_grad_phase(torch, dev, card)
    lap("grad, flash_grad")

    phases["vocoder"], vocoder, vocoder_numbers = vocoder_phase(torch, dev,
                                                                card)
    # each path's counts are read from its own run: serving for K1-K4,
    # training for K6, the variant's serving for K5 and K7, training with
    # the flash route on for K8
    p_ok, counts, details = path_phase(torch, dev, card, vocoder)
    details["vocoder"] = vocoder_numbers
    del vocoder
    phases.update(p_ok)
    lap("vocoder, path")
    cli_ok, details["cli"] = cli_phase(torch, dev, card)
    phases.update(cli_ok)
    lap("cli")
    phases["train"], train_counts, train_numbers, trainer, eval_batch = \
        train_phase(torch, dev, card)
    counts["maximum_path"] = train_counts["maximum_path"]
    phases["eval_parity"], train_numbers["eval"] = eval_phase(
        torch, trainer, eval_batch)
    lap("train, eval_parity")
    del trainer
    torch.cuda.empty_cache()
    phases["train_flash"], flash_counts, flash_numbers, trainer, _ = \
        train_run(torch, dev, card, _train_cfg(), "train (flash on)",
                  use_flash=True, steps=7, profile=True)
    lap("train_flash")
    for name in ("flash_attention_forward", "flash_attention_backward"):
        counts[name] = flash_counts[name]
    flash_site_table(f_rows, flash_numbers["flash_site_launches_per_step"],
                     card)
    del trainer
    torch.cuda.empty_cache()
    log(f"training model3, flash off vs on: median step "
        f"{train_numbers['step_s'] * 1e3:.1f} vs "
        f"{flash_numbers['step_s'] * 1e3:.1f} ms, "
        f"{train_numbers['steps_per_s']:.3f} vs "
        f"{flash_numbers['steps_per_s']:.3f} steps/s, peak "
        f"{train_numbers['max_memory_allocated_GB']:.2f} vs "
        f"{flash_numbers['max_memory_allocated_GB']:.2f} GB; card {card}")
    var_ok, var_counts, variant = variant_phase(torch, dev, card)
    phases.update(var_ok)
    lap("variant")
    for name in ("fused_rel_self_attention", "unconstrained_rqs"):
        counts[name] = var_counts[name]
    vt_ok, variant_train, _ = variant_train_phase(torch, dev, card)
    phases.update(vt_ok)
    lap("variant_train")
    tc_ok, train_cli = train_cli_phase(torch, dev, card)
    phases.update(tc_ok)
    lap("train_cli")
    cb_ok, bridge = ckpt_bridge_phase(torch, dev, card)
    phases.update(cb_ok)
    lap("ckpt_bridge")
    bv_ok, bv2 = bv2_phase(torch, dev, card,
                           variant_train["on"]["step_s"])
    phases.update(bv_ok)
    lap("bv2")
    rm_ok, remat = remat_phase(torch, dev, card)
    phases.update(rm_ok)
    lap("remat")
    dense = dict(b1=details["numbers"]["b1"]["latency_s"],
                 b8=details["numbers"]["b8"]["latency_s"],
                 step_s=flash_numbers["step_s"],
                 peak_GB=flash_numbers["max_memory_allocated_GB"])
    moe_ok, moe = moe_phase(torch, dev, card, dense)
    phases.update(moe_ok)
    lap("moe")
    dp_ok, dp = dp_nccl_phase(torch, dev, card)
    phases.update(dp_ok)
    lap("dp_nccl")
    dp_ok, dp["gloo"] = dp_gloo_phase(torch, dev, card)
    phases.update(dp_ok)
    lap("dp_gloo")
    s_ok, details["samplers"] = samplers_phase(torch, dev, card)
    phases.update(s_ok)
    lap("samplers")
    sh_ok, shard = shard_phase(torch, dev, card)
    phases.update(sh_ok)
    lap("shard")
    sp_ok, seq_par = seq_parallel_phase(torch, dev, card)
    phases.update(sp_ok)
    lap("seq_parallel")
    pp_ok, pipe = pipeline_phase(torch, dev, card)
    phases.update(pp_ok)
    lap("pipeline")
    op_ok, offpath = offpath_phase(torch, dev, card)
    phases.update(op_ok)
    lap("offpath")
    log(f"training the variant, flash off vs on: median step "
        f"{variant_train['off']['step_s'] * 1e3:.1f} vs "
        f"{variant_train['on']['step_s'] * 1e3:.1f} ms, peak "
        f"{variant_train['off']['max_memory_allocated_GB']:.2f} vs "
        f"{variant_train['on']['max_memory_allocated_GB']:.2f} GB; "
        f"card {card}")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "kernels.json").write_text(json.dumps(
            dict(card=card, rows=rows, mas=summary["maximum_path"],
                 k5_route=k5_route), indent=1))
        (out_dir / "path.json").write_text(json.dumps(details, indent=1))
        (out_dir / "train.json").write_text(json.dumps(
            dict(card=card, **train_numbers, flash=flash_numbers,
                 flash_grad=flash_grad), indent=1))
        (out_dir / "variant.json").write_text(json.dumps(
            dict(variant, train=variant_train), indent=1))
        (out_dir / "train_cli.json").write_text(json.dumps(train_cli,
                                                           indent=1))
        (out_dir / "ckpt_bridge.json").write_text(json.dumps(bridge,
                                                             indent=1))
        (out_dir / "bv2.json").write_text(json.dumps(bv2, indent=1))
        for name, numbers in (("remat", remat), ("moe", moe), ("dp", dp),
                              ("shard", shard), ("seq_parallel", seq_par),
                              ("pipeline", pipe), ("offpath", offpath),
                              ("walls", walls)):
            (out_dir / f"{name}.json").write_text(json.dumps(
                numbers, indent=1, default=str))

    table = {"kernels": [dict(
        name=name, route="cuda", source=SOURCE[name],
        replaces=REPLACES[name], launches=counts.get(name, 0),
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        device_ms=row["device_ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=row["library_ms"],
        library_device_ms=row["library_device_ms"])
        for name, row in summary.items()]}
    log(f"phases: {phases}")
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in walls.items()))
    if not all(phases.values()):
        log("chip_smoke: FAILED")
        return 1
    log(f"card: {card}")
    log(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _requests(torch, gen, symbols_n, refer_frames):
    """10 tokenised requests: 6 texts of 70-128 phones (text bucket 128)
    and 4 of 300-600 (bucket 601); random prompt mels [267, 100]."""
    reqs = []
    for i, n in enumerate([70, 96, 128, 81, 110, 77, 300, 452, 600, 377]):
        def ids(hi):
            return torch.randint(0, hi, (n,), generator=gen).numpy()
        reqs.append((f"utt{i:02d}", ids(symbols_n - 1) + 1, ids(11), ids(3),
                     torch.randn(refer_frames, 100, generator=gen).numpy()))
    return reqs


def _count_calls(model, cls, weight):
    """Forward pre-hooks on every ``cls`` module of ``model``: a one-item
    list that grows by ``weight(module, kwargs)`` a call."""
    calls = [0]

    def hook(module, args, kwargs):
        calls[0] += weight(module, kwargs)
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, cls)]
    return calls, handles


def _count_path_calls(model):
    """Denoising UNet calls (embedding-only requests launch no kernel and
    are not counted), rel-pos encoder layers run (one K5 launch each on
    the kernel route) and stochastic-duration reverses (three K7 launches
    each); returns ({what: one-item list}, hook handles)."""
    from diff_vits_tpu_torch.models.duration import (
        StochasticDurationPredictor)
    from diff_vits_tpu_torch.nn.layers import Encoder
    from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
    unet, h1 = _count_calls(model, UNet1DConditionModel, lambda m, kw: int(
        kw.get("embedding_request") is None))
    layers, h2 = _count_calls(model, Encoder, lambda m, kw: m.n_layers)
    sdp, h3 = _count_calls(model, StochasticDurationPredictor,
                           lambda m, kw: int(kw.get("reverse", False)))
    return dict(unet=unet, encoder_layers=layers, sdp_reverse=sdp), \
        h1 + h2 + h3


def _want(calls, mas: int = 0, k5: bool = True):
    """Expected launch counts from the counted calls."""
    want = {name: n * calls["unet"][0] for name, n in PER_UNET.items()}
    want["fused_rel_self_attention"] = \
        calls["encoder_layers"][0] if k5 else 0
    want["maximum_path"] = mas
    want["unconstrained_rqs"] = K7_PER_SDP_REVERSE * calls["sdp_reverse"][0]
    want["flash_attention_forward"] = want["flash_attention_backward"] = 0
    return want


def path_phase(torch, dev, card, vocoder):
    """Serving run through the kernels, with ``vocoder`` decoding every
    bucket batch, the fp32 kernels-vs-plain parity run, and the serving
    numbers (with and without the vocoder). Returns ({phase: ok}, launch
    counts, the numbers as a JSON-ready dict)."""
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.ops import fused_transformer as FT
    from diff_vits_tpu_torch.ops import rel_attention as RA
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random

    ok = {}
    cfg = load_config(str(ROOT / "configs" / "reference_parity.json"))
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"path: reference_parity widths, {n_params} parameters, random "
        "weights (seed 0)")

    # -- serving: BatchSynthesizer, bf16, batch 8, mel buckets 400/800 ----
    syn = BatchSynthesizer(cfg, model.state_dict(), batch_size=8,
                           mel_buckets=(400, 800), vocoder=vocoder,
                           dtype=torch.bfloat16, device=dev)
    reqs = _requests(torch, torch.Generator().manual_seed(1), len(symbols),
                     syn.refer_frames)
    calls, handles = _count_path_calls(syn.model)
    # the kernel routes never run the core's plain version (the UNet's
    # fused ops reach it only through their plain versions)
    plain_calls = [0]
    orig_plain = FT.attention_plain

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return orig_plain(*a, **kw)
    FT.attention_plain = counted_plain
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        results = syn.synthesize_all(reqs, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        rel_routes = RA.route_counts()
    finally:
        FT.attention_plain = orig_plain
    for h in handles:
        h.remove()
    want = _want(calls)
    order_ok = [r[0] for r in results] == [r[0] for r in reqs]
    finite = all(np.isfinite(m).all() and m.ndim == 2 and m.shape[1] == 100
                 and m.shape[0] >= 1 for _, m, _ in results)
    wav_ok = _wavs_ok(np, results, cfg.data.hop_length, syn.mel_buckets)
    ok["serve"] = (order_ok and finite and counts == want
                   and plain_calls[0] == 0)
    ok["serve_vocoder"] = wav_ok
    log(f"serve: {len(results)} requests in {wall:.3f} s (first call of "
        f"each bucket shape included, the vocoder's decodes too); frames "
        f"{[m.shape[0] for _, m, _ in results]}; wav samples "
        f"{[len(w) for _, _, w in results]} (n x hop, or the bucket's "
        f"(T - 1) x hop where shorter, finite: {wav_ok}); UNet calls "
        f"{calls['unet'][0]}, encoder layers {calls['encoder_layers'][0]}; "
        f"launches {counts} (want {want}); order {order_ok}; finite "
        f"{finite}; attention_plain calls {plain_calls[0]} (want 0)")
    ok["serve_rel_attention_mma"] = _rel_mma_only(
        rel_routes, counts["fused_rel_self_attention"], "serve")

    # -- parity: one fp32 batch, kernels vs the plain path on the card ----
    gen = torch.Generator().manual_seed(2)
    syn.batch_size = 2
    batch = syn.pad_batch(reqs[:2], 128)
    noise = torch.randn(2, 400, 100, generator=gen).to(dev)
    out = {}
    for route in (True, False):
        set_use_fused(model, route)
        # the kernel route's device activity: which attention core ran
        out[route], prof, _ = profiled_run(lambda: synthesize(
            model, *batch, noise_scale=0.0, max_len=400, init_noise=noise,
            device=dev))
        if route:
            cores = _core_kernels(
                {k: us / 1e3 for k, (_, us) in device_by_name(prof).items()})
    set_use_fused(model, True)
    (mel_k, len_k), (mel_p, len_p) = out[True], out[False]
    err = (mel_k - mel_p).abs().max().item()
    ok["parity_fp32"] = (bool(torch.equal(len_k, len_p)) and err <= 5e-3
                         and bool(torch.isfinite(mel_k).all())
                         and list(cores) == ["float32"])
    log(f"parity fp32 (kernels vs plain, 2 utterances, 400 frames, 30 "
        f"steps): frames {len_k.tolist()} vs {len_p.tolist()}, max |diff| "
        f"{err:.3e} (gate 5e-3), max |mel| {mel_p.abs().max().item():.3f}; "
        f"attention core device ms by route {cores} (want float32 only)")
    del model

    short = [r for r in reqs if len(r[1]) <= 128]
    numbers = serving_numbers(torch, syn, short, card)
    numbers["profile"] = {f"b{b}": profile_synthesize(
        torch, syn, [short[i % len(short)] for i in range(b)], card)
        for b in (1, 8)}
    # bf16 serving runs every product on the tensor-core GEMM: the FMA
    # mainloop is the float32 parity route only
    names = [k for prof in numbers["profile"].values()
             for k in prof["gemm_kernels"]]
    ok["serve_tensor_cores"] = (any("gemm_mma_kernel" in k for k in names)
                                and not any("gemm_fma_kernel" in k
                                            for k in names))
    log(f"serving GEMM kernels (profiler names): {sorted(set(names))}; "
        f"tensor cores only: {ok['serve_tensor_cores']}")
    # and the attention core only on its tensor-core kernel
    cores = [prof["attention_core_ms"]
             for prof in numbers["profile"].values()]
    ok["serve_attention_mma"] = all(list(c) == ["bfloat16"] for c in cores)
    log(f"serving attention core device ms by route: {cores}; tensor cores "
        f"only: {ok['serve_attention_mma']}")
    return ok, counts, dict(card=card, serve_wall_s=wall,
                            unet_calls=calls["unet"][0], launches=counts,
                            parity_max_abs=err, numbers=numbers)


def _wavs_ok(np, results, hop, mel_buckets):
    """Every (utt, mel, wav) has a finite float32 wav of n x hop samples
    for its n frames, or (n - 1) x hop where n filled its mel bucket (the
    decode of T frames gives (T - 1) x hop samples)."""
    def good(m, w):
        n = m.shape[0]
        want = {n * hop} | ({(n - 1) * hop} if n in mel_buckets else set())
        return (w.ndim == 1 and w.dtype == np.float32 and len(w) in want
                and bool(np.isfinite(w).all()))
    return len(results) > 0 and all(len(r) == 3 and good(r[1], r[2])
                                    for r in results)


def _rel_mma_only(routes, launches, what):
    """Whether bf16 serving ran every K5 launch (at least one) on
    rel_attention_mma_kernel, by the wrapper's route counters."""
    good = launches > 0 and routes == {
        "fused_rel_self_attention.mma_launches": launches,
        "fused_rel_self_attention.fma_launches": 0}
    log(f"{what}: K5 launches by route {routes} of {launches}; tensor cores "
        f"only: {good}")
    return good


def serving_numbers(torch, syn, short, card, what="serving",
                    sample_method="unipc"):
    """Per-request latency (median of 3 warmed runs) and real-time factor
    of ``synthesize`` (``sample_method``, ``syn.steps`` steps) at batch 1
    and 8 (text bucket 128, mel bucket 400), and the peak device memory
    over them. With ``syn.vocoder``, each run
    also decodes its mel (float32, the whole batch, as BatchSynthesizer
    does), timed apart on the host clock: the decode's wall time (the
    counterpart of the JAX bench's vocoder_overhead_s) and the real-time
    factor with it."""
    from diff_vits_tpu_torch.models.diff_vits import synthesize
    numbers = {}
    audio_s = 400 * syn.cfg.data.hop_length / syn.cfg.data.sampling_rate
    torch.cuda.reset_peak_memory_stats()
    for b in (1, 8):
        syn.batch_size = b
        args = syn.pad_batch([short[i % len(short)] for i in range(b)], 128)
        gen = torch.Generator().manual_seed(3)
        runs, decodes = [], []
        for _ in range(4):      # first run warms the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel, _ = synthesize(syn.model, *args, generator=gen, max_len=400,
                                sampling_steps=syn.steps,
                                sample_method=sample_method,
                                device=syn.device)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            if syn.vocoder is not None:
                t0 = time.perf_counter()
                with torch.inference_mode():
                    syn.vocoder(mel.float())
                torch.cuda.synchronize()
                decodes.append(time.perf_counter() - t0)
        lat = sorted(runs[1:])[1]
        numbers[f"b{b}"] = dict(latency_s=lat, runs_s=runs,
                                rtf=b * audio_s / lat)
        log(f"{what} b={b}: latency {lat * 1e3:.1f} ms per request "
            f"(median of {runs[1:]}), real-time factor "
            f"{b * audio_s / lat:.1f}x ({b} x {audio_s:.2f} s of audio); "
            f"card {card}")
        if decodes:
            both = sorted(r + d for r, d in zip(runs[1:], decodes[1:]))[1]
            dec = sorted(decodes[1:])[1]
            numbers[f"b{b}"].update(
                vocoder_s=dec, vocoder_runs_s=decodes,
                latency_with_vocoder_s=both,
                rtf_with_vocoder=b * audio_s / both)
            log(f"{what} b={b} with the vocoder: decode {dec * 1e3:.2f} ms "
                f"(median of {decodes[1:]}), mel + decode {both * 1e3:.1f} "
                f"ms, real-time factor {b * audio_s / both:.1f}x against "
                f"{b * audio_s / lat:.1f}x without; card {card}")
    numbers["max_memory_allocated_GB"] = \
        torch.cuda.max_memory_allocated() / 1e9
    log(f"{what} peak device memory "
        f"{numbers['max_memory_allocated_GB']:.2f} GB; card {card}")
    return numbers


def profile_synthesize(torch, syn, requests, card):
    """One warmed ``synthesize`` of ``requests`` (text bucket 128, mel
    bucket 400) under torch.profiler: wall time, the device's busy share
    (summed device activity over wall time; one stream, so nothing
    overlaps), device time by kernel name, and kernels launched."""
    from diff_vits_tpu_torch.models.diff_vits import synthesize

    syn.batch_size = len(requests)
    args = syn.pad_batch(requests, 128)
    _, prof, wall_us = profiled_run(lambda: synthesize(
        syn.model, *args, generator=torch.Generator().manual_seed(4),
        max_len=400, device=syn.device))
    return profile_summary(prof, wall_us, card,
                           f"synthesize b={len(requests)}")


def profile_summary(prof, wall_us, card, what):
    """The device's busy share of a profiled region (summed device activity
    over wall time; one stream, so nothing overlaps), the port's kernels
    and K6 among them, and the top kernels by device time."""
    by_name = device_by_name(prof)
    busy_us = sum(us for _, us in by_name.values())
    ours = {k: v for k, v in by_name.items() if "dvt::" in k}
    mas_us = sum(us for k, (_, us) in ours.items() if "mas_kernel" in k)
    gemm = {k: v for k, v in ours.items() if "gemm_" in k}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    res = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / wall_us,
               device_launches=sum(n for n, _ in by_name.values()),
               port_kernels_ms=sum(us for _, us in ours.values()) / 1e3,
               port_kernel_launches=sum(n for n, _ in ours.values()),
               mas_device_ms=mas_us / 1e3, mas_share_of_wall=mas_us / wall_us,
               gemm_ms=sum(us for _, us in gemm.values()) / 1e3,
               gemm_launches=sum(n for n, _ in gemm.values()),
               gemm_kernels={k: dict(launches=n, ms=us / 1e3)
                             for k, (n, us) in gemm.items()},
               attention_core_ms=_core_kernels(
                   {k: us / 1e3 for k, (_, us) in by_name.items()}),
               rel_attention_core_ms=_core_kernels(
                   {k: us / 1e3 for k, (_, us) in by_name.items()},
                   REL_KERNEL),
               top=[dict(name=k[:90], launches=n, ms=us / 1e3)
                    for k, (n, us) in top])
    log(f"profile {what}: wall {res['wall_ms']:.1f} ms, device busy "
        f"{res['device_busy_ms']:.1f} ms "
        f"({100 * res['device_busy_share']:.1f}%), "
        f"{res['device_launches']} device activities, of which the port's "
        f"kernels {res['port_kernel_launches']} taking "
        f"{res['port_kernels_ms']:.1f} ms (K6 {res['mas_device_ms']:.3f} ms, "
        f"{100 * res['mas_share_of_wall']:.2f}% of the wall); GEMM kernels "
        f"{res['gemm_launches']} taking {res['gemm_ms']:.1f} ms; card {card}")
    for k, row in res["gemm_kernels"].items():
        log(f"  gemm {row['ms']:9.2f} ms {row['launches']:6d}x {k[:90]}")
    log(f"  attention core ms by route: {res['attention_core_ms']}; K5's "
        f"core: {res['rel_attention_core_ms']}")
    for row in res["top"]:
        log(f"  {row['ms']:9.2f} ms {row['launches']:6d}x {row['name']}")
    return res


# -- vocoder: Vocos at the published widths, mel -> waveform ---------------

VOCODER_BATCH, VOCODER_FRAMES = 8, 400
# card vs CPU ``istft`` on a spectrum of N(0, 1) parts: their float32 FFTs
# agree to ~4e-8 on an H100, where keeping the imaginary parts of DC and
# Nyquist put the decode 6e-3 off
ISTFT_TOL = 1e-5


def _published_layout(state):
    """A port ``Vocos`` state dict in charactr/vocos-mel-24khz's torch
    layout (the inverse of ``convert_torch_vocos``'s renaming)."""
    top = {"embed": "backbone.embed", "norm": "backbone.norm",
           "final_norm": "backbone.final_layer_norm", "out": "head.out"}
    out = {}
    for k, v in state.items():
        head, rest = k.split(".", 1)
        if head.startswith("convnext_"):
            name = f"backbone.convnext.{head[len('convnext_'):]}.{rest}"
        else:
            name = f"{top[head]}.{rest}"
        out[name] = v.detach().cpu().clone()
    return out


def vocoder_phase(torch, dev, card):
    """Vocos at the published widths (100 mels, dim 512, intermediate 1536,
    8 layers, n_fft 1024, hop 256) with random weights from seed 5,
    written as a published-layout state dict and loaded on the card by
    ``load_vocoder`` (the converter's route); a b=8, 400-frame mel decoded
    on the card in float32 against the same module on the CPU: finite,
    (400 - 1) x 256 samples, max |diff| <= 1e-3 x max(1, max |wav|) (the
    JAX vocoder test's bound); ``istft`` alone on a random half-spectrum
    within ISTFT_TOL of its CPU run; the decode's device ms (profiler),
    wall ms (median of 3 warmed runs) and peak memory. Returns (ok, the
    vocoder on the card, numbers)."""
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.models.vocoder import Vocos, istft, load_vocoder
    from diff_vits_tpu_torch.utils.init import init_random

    cfg = load_config(str(ROOT / "configs" / "reference_parity.json"))
    ref = init_random(Vocos(device="cpu"), torch.Generator().manual_seed(5))
    path = ROOT / "build" / "vocos_published_layout.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_published_layout(ref.state_dict()), path)
    voc = load_vocoder(cfg, str(path), device=dev)
    loaded = all(torch.equal(p.cpu(), q) for p, q in zip(
        voc.state_dict().values(), ref.state_dict().values()))
    n_params = sum(p.numel() for p in voc.parameters())
    mel = torch.randn(VOCODER_BATCH, VOCODER_FRAMES, 100,
                      generator=torch.Generator().manual_seed(6)) * 2.0 - 4.0
    mel_dev = mel.to(dev)

    def decode():
        with torch.inference_mode():
            return voc(mel_dev)
    wav = decode()
    torch.cuda.synchronize()
    with torch.inference_mode():
        want = ref.eval()(mel)
    scale = max(1.0, want.abs().max().item())
    err = (wav.cpu() - want).abs().max().item()
    # the ISTFT alone on one random half-spectrum whose DC and Nyquist bins
    # have imaginary parts, which both must drop (cuFFT's C2R keeps them)
    spec = torch.randn(2, 2, 40, 513, generator=torch.Generator()
                       .manual_seed(7))
    istft_err = (istft(*spec.to(dev)).cpu() - istft(*spec)).abs().max() \
        .item()
    shape_ok = tuple(wav.shape) == (VOCODER_BATCH, (VOCODER_FRAMES - 1)
                                    * cfg.data.hop_length)
    finite = bool(torch.isfinite(wav).all())
    ok = (loaded and shape_ok and finite and err <= 1e-3 * scale
          and istft_err <= ISTFT_TOL)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(4):          # the first run warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    wall_ms = sorted(runs[1:])[1] * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    device_ms, by_name = device_times(decode, iters=5)
    audio_s = VOCODER_BATCH * (VOCODER_FRAMES - 1) * cfg.data.hop_length \
        / cfg.data.sampling_rate
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    numbers = dict(card=card, n_params=n_params, batch=VOCODER_BATCH,
                   frames=VOCODER_FRAMES, wav_shape=list(wav.shape),
                   max_abs_diff_vs_cpu=err, max_abs_wav=scale,
                   istft_max_abs_diff_vs_cpu=istft_err,
                   device_ms=device_ms, wall_ms=wall_ms,
                   wall_runs_s=runs, max_memory_allocated_GB=peak_gb,
                   audio_s=audio_s, top=[dict(name=k[:90], ms=ms)
                                         for k, ms in top])
    log(f"vocoder: Vocos {n_params} parameters (published widths, random "
        f"weights seed 5, loaded from a published-layout state dict: "
        f"{loaded}); b={VOCODER_BATCH} x {VOCODER_FRAMES} frames float32 -> "
        f"wav {tuple(wav.shape)}, finite {finite}; card vs CPU max |diff| "
        f"{err:.3e} (gate {1e-3 * scale:.3e}), the ISTFT alone "
        f"{istft_err:.2e} (gate {ISTFT_TOL:.0e}); decode device "
        f"{device_ms} ms, wall {wall_ms:.2f} ms (median of "
        f"{runs[1:]}), {audio_s:.2f} s of audio, peak {peak_gb:.3f} GB; "
        f"{'ok' if ok else 'FAIL'}; card {card}")
    for k, ms in top:
        log(f"  {ms:9.4f} ms {k[:90]}")
    return ok, voc, numbers


# -- training slice: K6, gradients through K1-K4, the training step ------

MAS_SHAPE = (32, 400, 601)   # train_batch_size, max_mel_len, text buffer


def _mas_inputs(torch, gen, dev, integer: bool):
    """neg_cent [B, Ty, Tx] float32 and the outer-product mask at the
    training shape, with ragged lengths t_x <= t_y (item 0: t_x = t_y = Ty;
    item 1: t_x = t_y; item 2: t_x = 1). ``integer`` makes the scores small
    integers, so that ties occur in the DP."""
    b, ty, tx = MAS_SHAPE
    t_y = torch.randint(ty * 3 // 10, ty + 1, (b,), generator=gen)
    t_y[0] = ty
    t_x = (t_y * torch.rand(b, generator=gen)).long().clamp(min=1)
    t_x[0], t_x[1], t_x[2] = ty, t_y[1], 1
    if integer:
        neg = torch.randint(-3, 1, (b, ty, tx), generator=gen).float()
    else:
        neg = torch.randn(b, ty, tx, generator=gen) * 20.0 - 300.0
    y_keep = torch.arange(ty)[None] < t_y[:, None]
    x_keep = torch.arange(tx)[None] < t_x[:, None]
    mask = (y_keep[:, :, None] & x_keep[:, None, :]).float()
    return neg.to(dev), mask.to(dev), t_y


def mas_phase(torch, dev, card):
    """K6 against its plain version at the training shape, on random and
    on tied scores: the paths must be identical. Returns (ok, row)."""
    from diff_vits_tpu_torch.ops import mas
    gen = torch.Generator().manual_seed(5)
    ok, worst, timed = True, 0.0, None
    for integer in (False, True):
        nc, mask, t_y = _mas_inputs(torch, gen, dev, integer)
        out = mas.maximum_path(nc, mask)
        torch.cuda.synchronize()
        ref = mas.maximum_path_plain(nc, mask)
        mismatched = int((out != ref).sum())
        # a path has one cell in each of an item's t_y rows (t_x <= t_y)
        rows_ok = bool(torch.equal(ref.sum(dim=2), mask[:, :, 0]))
        worst = max(worst, (out - ref).abs().max().item())
        good = mismatched == 0 and rows_ok and out.dtype == nc.dtype
        ok &= good
        log(f"mas {'tied' if integer else 'random'} scores B,Ty,Tx="
            f"{tuple(nc.shape)}: {mismatched} mismatched cells, one cell "
            f"per kept row {rows_ok}: {'ok' if good else 'FAIL'}")
        if timed is None:
            timed = (nc, mask, t_y)
    nc, mask, t_y = timed
    b, ty, tx = MAS_SHAPE
    ms = cuda_time(lambda: mas.maximum_path(nc, mask))
    device_ms = device_time(lambda: mas.maximum_path(nc, mask))
    plain_ms = cuda_time(lambda: mas.maximum_path_plain(nc, mask), iters=3,
                         warmup=1)
    # the DP reads the scores of each item's t_y rows, the mask's first row
    # and column (the lengths) and its cells on the path; the path is
    # written in full; ~4 operations a DP cell
    kept = int(t_y.sum())
    nbytes = 4 * (kept * tx + b * ty * tx + b * (ty + tx) + kept)
    flops = 4 * kept * tx
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["float32"])
    bound_by = ("bytes" if nbytes / PEAK_BYTES_S
                >= flops / PEAK_FLOPS["float32"] else "operations")
    row = dict(max_abs_err=worst, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               serial_row_steps=2 * ty, bytes=nbytes, flops=flops)
    log(f"mas timing: ms={ms:.4f} device_ms={device_ms} plain_ms="
        f"{plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}; serial depth "
        f"{2 * ty} dependent row steps); card {card}")
    return ok, row


def _grad_leaves(name, args):
    """Leaf tensors that need a gradient, and the arguments made of them as
    the UNet passes its parameters: a weight as a permuted view of its
    nn.Linear [out, in] / nn.Conv1d [out, in, k] storage."""
    leaves, call = [], []
    for i, t in enumerate(args):
        if t is None or (name == "fused_cross_attention" and i == 2):
            call.append(t)      # absent, or the attention bias (a constant)
            continue
        perm = None if t.is_contiguous() else tuple(range(t.dim()))[::-1]
        leaf = (t if perm is None else t.permute(perm)).detach().clone()
        leaf.requires_grad_(True)
        leaves.append(leaf)
        call.append(leaf if perm is None else leaf.permute(perm))
    return leaves, call


def grad_phase(torch, dev):
    """Gradients of sum(out * r) through each of K1-K4 (the kernel route's
    autograd Function) against plain autograd, at denoiser level 0, B=8,
    float32, with respect to x and every weight and vector: every leaf
    gets one, max rel error <= 1e-3."""
    gen = torch.Generator(device=dev).manual_seed(6)
    ok = True
    for name, site, args, kw, *_ in _kernel_cases(torch, torch.float32, gen,
                                                  dev):
        # the core alone has no autograd Function: K2 and K3 carry it
        if not site.startswith("denoiser L0") or name == "attention":
            continue
        op, plain = _ops(name)
        grads, launched = {}, {}
        for route, fn in (("kernel", op), ("plain", plain)):
            leaves, call = _grad_leaves(name, args)
            before = op.launches
            out = fn(*call, **kw)
            r = torch.randn(out.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(7))
            (out.float() * r).sum().backward()
            torch.cuda.synchronize()
            launched[route] = op.launches - before
            grads[route] = [leaf.grad for leaf in leaves]
        missing = sum(g is None for g in grads["kernel"])
        rel = max(((k - p).abs().max() / p.abs().max().clamp(min=1e-30)).item()
                  for k, p in zip(grads["kernel"], grads["plain"])
                  if k is not None)
        good = (missing == 0 and launched == {"kernel": 1, "plain": 0}
                and rel <= 1e-3)
        ok &= good
        log(f"grad {name:22s} {site}: {len(grads['kernel'])} leaves, "
            f"{missing} without a gradient, launches {launched}, max rel err "
            f"{rel:.2e} (gate 1e-3): {'ok' if good else 'FAIL'}")
    return ok


def _train_batches(np, b, t_x, t_y, s_max, n_symbols, seed):
    """Endless batches shaped like the loader's (text [B, t_x], mel
    [B, t_y, 100], prompts [B, s_max, 100]): random mels of 0.3 t_y to
    2 t_y frames cut by ``random_slice`` (crop to t_y, prompt split), texts of 20 to
    t_y tokens (item 0: as many tokens as frames)."""
    import random
    from diff_vits_tpu_torch.data.batch import Batch, pad_to, random_slice
    rng, py_rng = np.random.default_rng(seed), random.Random(seed)
    while True:
        n_mel = rng.integers(max(30, t_y * 3 // 10), 2 * t_y, b)
        cut = [random_slice(rng.normal(size=(int(n), 100)).astype(np.float32),
                            py_rng, t_y, 30) for n in n_mel]
        spec_len = np.array([len(c[0]) for c in cut])
        text_len = np.array([spec_len[0]] + [
            int(rng.integers(20, min(n, t_x) + 1)) for n in spec_len[1:]])
        keep = np.arange(t_x)[None] < text_len[:, None]

        def ids(hi, lo=0):
            return rng.integers(lo, hi, (b, t_x)) * keep

        def mels(k, n):
            return np.stack([pad_to(c[k], n) for c in cut])
        yield Batch(text=ids(n_symbols, 1), tone=ids(11), language=ids(3),
                    spec=mels(0, t_y), refer1=mels(1, s_max),
                    refer2=mels(2, s_max), text_lengths=text_len,
                    spec_lengths=spec_len,
                    refer1_lengths=np.array([len(c[1]) for c in cut]),
                    refer2_lengths=np.array([len(c[2]) for c in cut]))


def _flash_calls(model, shapes=None, no_grad=None, backward=None):
    """Forward pre-hooks on every attention module of ``model`` that has a
    flash route (``CrossAttention``, ``EncSALayer``): a one-item list that
    grows by one for each call that passes the module's own gate, i.e. the
    K8 forward launches to expect; each such output enters the loss, so as
    many backward launches. Each such call's (T, S, d) is appended to
    ``shapes`` when given. With a one-item list ``no_grad``, the gated
    calls made while autograd records nothing (forward launches only) are
    counted there instead; with a one-item list ``backward``, those made
    inside a backward pass (a rematerialised region's recompute). Returns
    (the list, hook handles)."""
    import torch
    from diff_vits_tpu_torch.nn.fairseq import EncSALayer
    from diff_vits_tpu_torch.nn.unet1d import CrossAttention
    calls = [0]

    def count(gated, t, s, d):
        if no_grad is not None and not torch.is_grad_enabled():
            no_grad[0] += gated
            return
        if backward is not None and torch._C._current_graph_task_id() != -1:
            backward[0] += gated
            return
        calls[0] += gated
        if gated and shapes is not None:
            shapes.append((t, s, d))

    def cross(m, args, kwargs):
        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        s = (x if ctx is None else ctx).shape[1]
        count(m.uses_flash(x.shape[1], s), x.shape[1], s, m.dim_head)

    def enc_sa(m, args, kwargs):
        t, c = args[0].shape[1], args[0].shape[2]
        count(m.uses_flash(t, c), t, t, c // m.num_heads)
    handles = [m.register_forward_pre_hook(
        cross if isinstance(m, CrossAttention) else enc_sa, with_kwargs=True)
        for m in model.modules() if isinstance(m, (CrossAttention,
                                                   EncSALayer))]
    return calls, handles


def _want_step(counts, flash_calls):
    """A training step's expected launches: one K6, the K8 forward and
    backward once for each call through the flash gate, nothing else."""
    want = dict.fromkeys(counts, 0)
    want["maximum_path"] = 1
    want["flash_attention_forward"] = flash_calls
    want["flash_attention_backward"] = flash_calls
    return want


def _train_cfg(**vits):
    """``configs/reference_parity.json`` with EMA on and seed 0, the VITS
    configuration changed by ``vits``."""
    import dataclasses
    from diff_vits_tpu_torch.core.config import load_config
    cfg = load_config(str(ROOT / "configs" / "reference_parity.json"))
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_ema=True, seed=0),
        vits=dataclasses.replace(cfg.vits, **vits))


def train_run(torch, dev, card, cfg, what, *, use_flash, steps,
              profile=False, prepare=None):
    """``Trainer`` on ``cfg`` (random weights from ``train.seed``, bf16
    autocast) with the flash route ``use_flash``, on batches of 32 shaped
    like the loader's (seed 8, the same for every run): 2 warm-up steps
    (the second under torch.profiler when ``profile``) and ``steps`` - 2
    timed ones. Checks finite losses, every parameter and the EMA changed,
    the EMA no alias of the parameters, and each step's launches: one K6,
    the K8 forward and backward once per call through the flash gate (more
    than none with the route on), no other kernel. ``prepare(model)``, when
    given, changes the random weights before the first step (the EMA
    starts from the result). Returns (ok, counts over the steps, numbers,
    trainer, a further batch)."""
    import math
    import numpy as np
    from torch.profiler import ProfilerActivity, profile as profiler
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.nn.unet1d import set_use_flash
    from diff_vits_tpu_torch.ops import flash_attention as FA
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import Trainer

    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    t_x = cfg.data.max_text_len * 2 + 1
    batches = _train_batches(np, b, t_x, t_y, t_y * 2 // 3 + 1, len(symbols),
                             seed=8)
    trainer = Trainer(cfg, batches, device=dev)
    if prepare is not None:
        prepare(trainer.model)
        trainer.ema = [p.detach().float().clone() for p in trainer.params]
    set_use_flash(trainer.model, use_flash)
    n_params = sum(p.numel() for p in trainer.params)
    log(f"{what}: {n_params} parameters, B={b}, text {t_x}, mel {t_y}, "
        f"compute {cfg.train.compute_dtype}, flash route {use_flash}")
    params0 = [p.detach().clone() for p in trainer.params]
    ema0 = [e.clone() for e in trainer.ema]
    shapes = []
    calls, handles = _flash_calls(trainer.model, shapes)
    route = FLASH_ROUTE[cfg.train.compute_dtype]
    other = "fma" if route == "mma" else "mma"
    it = iter(batches)
    total = {}
    times, losses, per_step_ok, flash_per_step = [], [], [], []
    # the second warm-up step is profiled; a step whose window the profiler
    # lost (no device activity) is followed by another profiled step
    profiled, profile_route_ok = None, not profile
    for i in range(steps):
        batch = next(it)
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        calls[0] = 0
        shapes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiling = profile and profiled is None and i >= 1
        if profiling:
            with profiler(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                metrics = trainer.train_step(batch)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            by_name = device_by_name(prof)
        if profiling and not by_name:
            log(f"{what} step {i + 1}: the profiler recorded no device "
                f"activity; profiling the next step")
        elif profiling:
            profiled = profile_summary(prof, wall_us, card,
                                       f"one training step of {what} "
                                       f"(step {i + 1})")
            seen = _flash_kernels(by_name)
            profiled["flash_kernels"] = seen
            profiled["flash_device_ms"] = {
                r: sum(us for n, (_, us) in by_name.items()
                       if any(k in n for k in FLASH_KERNELS[r])) / 1e3
                for r in FLASH_KERNELS}
            # the route on runs only the compute dtype's K8 kernels
            profile_route_ok = (_flash_route_only(by_name, route)
                                if use_flash else not any(seen.values()))
            log(f"{what}: K8 kernels in the profiled step {seen}, device "
                f"ms by route {profiled['flash_device_ms']}: "
                f"{'ok' if profile_route_ok else 'FAIL'}")
        if not profiling:
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
        if i >= 2 and not profiling:
            times.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        want = _want_step(counts, calls[0])
        routes = FA.route_counts()
        routes_ok = all(
            routes[f"{n}.{route}_launches"] == calls[0]
            and routes[f"{n}.{other}_launches"] == 0
            and routes[f"{n}.wide_bf16_launches"] == 0
            for n in ("flash_attention_forward", "flash_attention_backward"))
        per_step_ok.append(counts == want and routes_ok
                           and (calls[0] > 0) == use_flash)
        flash_per_step.append(calls[0])
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        losses.append({k: float(v) for k, v in metrics.items()})
        log(f"{what} step {i + 1}: "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses[-1].items()))
            + f"; launches {counts} (want {want})")
    for h in handles:
        h.remove()
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = sorted(times)[len(times) // 2]
    finite = all(math.isfinite(v) for m in losses for v in m.values())
    moved = sum(not torch.equal(p, p0)
                for p, p0 in zip(trainer.params, params0))
    ema_moved = sum(not torch.equal(e, e0)
                    for e, e0 in zip(trainer.ema, ema0))
    aliased = sum(e.untyped_storage().data_ptr()
                  == p.untyped_storage().data_ptr()
                  for e, p in zip(trainer.ema, trainer.params))
    counters = all(per_step_ok)
    site_launches = {}
    for shape in shapes:                     # the last step's gated calls
        site_launches[shape] = site_launches.get(shape, 0) + 1
    ok = (finite and moved == len(params0) and ema_moved > 0
          and aliased == 0 and counters and profile_route_ok)
    log(f"{what}: {steps} steps, losses finite {finite}; parameters changed "
        f"{moved}/{len(params0)}, EMA tensors changed {ema_moved}/"
        f"{len(ema0)}, EMA aliasing parameters {aliased}; every step one K6 "
        f"launch, K8 forward and backward launches equal to the calls "
        f"through the flash gate ({flash_per_step}), all on the {route} "
        f"kernels, no other launch {counters}: {'ok' if ok else 'FAIL'}")
    log(f"{what} numbers: median step {step_s * 1e3:.1f} ms of "
        f"{[round(t * 1e3, 1) for t in times]} ms, {1 / step_s:.3f} steps/s, "
        f"peak device memory {peak:.2f} GB; card {card}")
    numbers = dict(use_flash=use_flash, step_s=step_s, steps_s=times,
                   steps_per_s=1 / step_s, max_memory_allocated_GB=peak,
                   losses=losses, profile=profiled, n_params=n_params,
                   flash_calls_per_step=flash_per_step,
                   flash_site_launches_per_step={
                       f"T={t} S={s_} d={d}": n
                       for (t, s_, d), n in site_launches.items()})
    return ok, total, numbers, trainer, next(it)


def train_phase(torch, dev, card):
    """Model3 at ``reference_parity`` widths, the flash route off: 2
    warm-up steps (the second profiled) and 5 timed ones. Returns (ok,
    counts over the 7 steps, numbers, trainer, a batch for the eval
    phase)."""
    return train_run(torch, dev, card, _train_cfg(), "train", steps=7,
                     use_flash=False, profile=True)


def eval_phase(torch, trainer, batch):
    """``eval_fixed_t_loss`` (float32, TF32 off, eval mode) through the
    kernels against the plain route on the card: every value within rel
    1e-4, the MAS paths equal, the counters 22/16/16/16 per UNet call and
    1 per MAS call on the kernel route and 0 on the plain one. The text
    encoder's attention (K5) stays on its plain route in both runs, so
    that both align with MAS on the same scores: K5's float32 rounding
    differs from the plain route's, and one near-tie in the Viterbi DP would
    change a path."""
    import diff_vits_tpu_torch.models.vits as V
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.nn.layers import MultiHeadAttention
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.ops.mas import maximum_path_plain

    orig = V.maximum_path
    mas_of = {True: orig, False: maximum_path_plain}
    paths = {True: [], False: []}
    calls, handles = _count_path_calls(trainer.model)
    res, counts, want = {}, {}, {}
    try:
        for route in (True, False):
            def recording(nc, mask, route=route):
                paths[route].append(mas_of[route](nc, mask))
                return paths[route][-1]
            V.maximum_path = recording
            set_use_fused(trainer.model, route)
            for m in trainer.model.modules():
                if isinstance(m, MultiHeadAttention):
                    m.use_fused = False
            ops.reset_launches()
            for c in calls.values():
                c[0] = 0
            res[route] = trainer.eval_fixed_t_loss(batch)
            counts[route] = ops.launch_counts()
            want[route] = _want(calls, len(paths[route]), k5=False)
    finally:
        V.maximum_path = orig
        set_use_fused(trainer.model, True)
        for h in handles:
            h.remove()
    rel = max(abs(res[True][k] - res[False][k])
              / max(abs(res[False][k]), 1e-30) for k in res[False])
    same_paths = (len(paths[True]) == len(paths[False]) > 0 and all(
        torch.equal(a, b) for a, b in zip(paths[True], paths[False])))
    ok = (rel <= 1e-4 and same_paths and counts[True] == want[True]
          and all(v == 0 for v in counts[False].values()))
    log(f"eval loss parity (fp32, kernels vs plain): "
        + " ".join(f"{k}={res[True][k]:.6g}/{res[False][k]:.6g}"
                   for k in sorted(res[True]))
        + f"; max rel diff {rel:.2e} (gate 1e-4); MAS paths equal "
        f"{same_paths} ({len(paths[True])} calls); launches {counts[True]} "
        f"(want {want[True]}), plain route {counts[False]}: "
        f"{'ok' if ok else 'FAIL'}")
    return ok, dict(kernel=res[True], plain=res[False], max_rel=rel)


# -- cli: serving from text and wav through the command lines ---------------

CLI_TEXTS = [
    # five short rows (text bucket 64 / 128, mel bucket 400) ...
    "Hello world.",
    "The quick brown fox jumps over the lazy dog.",
    "Please call Stella, and ask her to bring these things.",
    "It was a bright cold day in April.",
    "Six spoons of fresh snow peas, five thick slabs of blue cheese.",
    # ... and five long ones (text bucket 601, mel bucket 800)
    "We also need a small plastic snake and a big toy frog for the kids, "
    "and she can scoop these things into three red bags, and we will go "
    "meet her on Wednesday at the train station near the old market "
    "square.",
    "When the sunlight strikes raindrops in the air, they act as a prism "
    "and form a rainbow; the rainbow is a division of white light into "
    "many beautiful colors, which take the shape of a long round arch with "
    "its path high above.",
    "There is, according to legend, a boiling pot of gold at one end of "
    "the rainbow, and people look but no one ever finds it, so when a man "
    "looks for something beyond his reach, his friends say he is looking "
    "for the pot of gold.",
    "Throughout the centuries people have explained the rainbow in various "
    "ways; some have accepted it as a miracle without physical "
    "explanation, while to the Hebrews it was a token that there would be "
    "no more universal floods.",
    "The Greeks used to imagine that it was a sign from the gods to "
    "foretell war or heavy rain, and the Norsemen considered the rainbow "
    "as a bridge over which the gods passed from earth to their home in "
    "the sky.",
]
CLI_STEPS = 30
DDPM_CALLS = 1000       # cfg.train.timesteps denoiser calls


def _write_prompt_wav(np, path, seconds=3.0, sr=24000, seed=8):
    """A seeded ~3 s 24 kHz int16 prompt: a gliding tone with harmonics
    under noise."""
    from diff_vits_tpu_torch.data import audio
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.25 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav + 0.02 * rng.normal(size=t.shape)
    audio.write_wav(str(path), wav.astype(np.float32), sr)
    return str(path)


class _CountNewModels:
    """Within the block, every ``DiffVits`` built gets the call hooks of
    ``install`` (default :func:`_count_path_calls`; the CLIs build their
    model inside ``main``); :meth:`calls` sums them over the models."""

    def __init__(self, install=None):
        from diff_vits_tpu_torch.models import diff_vits as DV
        self.cls, self.made, self.handles, self.models = DV.DiffVits, [], [], []
        self.install = install or _count_path_calls

    def __enter__(self):
        orig = self.orig = self.cls.__init__

        def init(model, *a, **kw):
            orig(model, *a, **kw)
            calls, handles = self.install(model)
            self.made.append(calls)
            self.handles += handles
            self.models.append(model)
        self.cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.orig
        for h in self.handles:
            h.remove()

    def calls(self):
        return {k: [sum(c[k][0] for c in self.made)] for k in self.made[0]}


def _counted(torch, fn):
    """(``fn()``, launch counts, K5 route counts, attention_plain calls)
    with every counter zeroed just before."""
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.ops import fused_transformer as FT
    from diff_vits_tpu_torch.ops import rel_attention as RA
    plain_calls = [0]
    orig_plain = FT.attention_plain

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return orig_plain(*a, **kw)
    FT.attention_plain = counted_plain
    try:
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts(), RA.route_counts(), plain_calls[0]
    finally:
        FT.attention_plain = orig_plain


def _cli_counts_ok(torch, what, calls, counts, routes, plain, models=(),
                   rel=True):
    """The counters of a run against its counted calls: exactly 22/16/16/16
    a UNet call (the core 32), one K5 launch an encoder layer, all on the
    tensor-core K5 kernel (``rel``; without it, a run of no encoder layer,
    K5 at 0), K6, K7 and K8 at 0, no call of the core's plain version,
    every floating parameter of ``models`` in bfloat16 (the tensor-core
    GEMM and attention routes)."""
    want = _want(calls)
    bf16 = all(p.dtype == torch.bfloat16 for m in models
               for p in m.parameters() if p.is_floating_point())
    good = counts == want and plain == 0 and bf16 and calls["unet"][0] > 0
    log(f"{what}: UNet calls {calls['unet'][0]}, encoder layers "
        f"{calls['encoder_layers'][0]}; launches {counts} (want {want}); "
        f"attention_plain calls {plain} (want 0); bf16 weights {bf16}")
    if not rel:
        return good
    return _rel_mma_only(routes, counts["fused_rel_self_attention"],
                         what) and good


def cli_phase(torch, dev, card):
    """Serving from text and wav through the port's command lines at
    ``reference_parity`` widths (random weights from seed 3 written as a
    port checkpoint; the vocoder phase's published-layout Vocos file),
    then the samplers other than UniPC. Returns ({phase: ok}, numbers)."""
    import tempfile
    import numpy as np
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.data import audio
    from diff_vits_tpu_torch.infer import serve, tts_infer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.checkpoint import (
        load_model_state_dict, save_checkpoint)
    from diff_vits_tpu_torch.utils.init import init_random

    ok, numbers = {}, dict(card=card)
    cfg_path = str(ROOT / "configs" / "reference_parity.json")
    cfg = load_config(cfg_path)
    hop = cfg.data.hop_length
    voc_path = str(ROOT / "build" / "vocos_published_layout.bin")
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    d = Path(tmp.name)
    model = DiffVits(cfg, len(symbols), device="cpu")
    init_random(model, torch.Generator().manual_seed(3))
    ckpt = save_checkpoint(str(d / "run"), 0, {"model": model.state_dict()})
    del model
    wav_path = _write_prompt_wav(np, d / "prompt.wav")
    rows = [(f"utt{i:02d}", t) for i, t in enumerate(CLI_TEXTS)]
    manifest = d / "utts.tsv"
    manifest.write_text("".join(f"{u}\t{t}\tEN\t{wav_path}\n"
                                for u, t in rows), encoding="utf-8")
    common = ["-c", cfg_path, "-m", ckpt, "--steps", str(CLI_STEPS),
              "--dtype", "bfloat16"]

    # -- tts_infer: one utterance, b=1, no mel bucket --------------------
    text = CLI_TEXTS[2]
    with _CountNewModels() as made:
        t0 = time.perf_counter()
        _, counts, routes, plain = _counted(torch, lambda: tts_infer.main(
            ["--text", text, "--lang", "EN", "--refer", wav_path,
             "--vocoder", "jax", "--vocoder_ckpt", voc_path, "--out_dir",
             str(d / "tts"), *common]))
        wall = time.perf_counter() - t0
    counted = _cli_counts_ok(torch, "cli tts_infer", made.calls(), counts,
                             routes, plain, made.models)
    base = d / "tts" / "tts_prompt.wav"
    mel_file, wav_file = Path(f"{base}.mel.npy"), Path(f"{base}.wav")
    good = mel_file.exists() and wav_file.exists()
    n = n_wav = -1
    if good:
        mel = np.load(mel_file)
        wav, sr = audio.read_wav(str(wav_file))
        n, n_wav = mel.shape[0], len(wav)
        good = (mel.ndim == 2 and mel.shape[1] == 100 and n >= 1
                and bool(np.isfinite(mel).all()) and sr == 24000
                and n_wav in ((n - 1) * hop, n * hop))
    ok["cli_tts_infer"] = good and counted
    numbers["tts_infer"] = dict(wall_s=wall, frames=n, wav_samples=n_wav,
                                unet_calls=made.calls()["unet"][0],
                                launches=counts)
    log(f"cli tts_infer (EN, {CLI_STEPS}-step unipc, bf16, vocoder from "
        f"{Path(voc_path).name}): {wall:.2f} s wall (model built and loaded "
        f"from the checkpoint, kernels warm); mel [{n}, 100], wav {n_wav} "
        f"samples (want {(n - 1) * hop} or {n * hop}); files {good}; card "
        f"{card}")

    # -- serve: the manifest, batch 8, mel buckets 400 and 800 -----------
    with _CountNewModels() as made:
        t0 = time.perf_counter()
        _, counts, routes, plain = _counted(torch, lambda: serve.main(
            ["--manifest", str(manifest), "--batch_size", "8",
             "--mel_buckets", "400,800", "--vocoder_ckpt", voc_path,
             "--out_dir", str(d / "serve"), *common]))
        wall = time.perf_counter() - t0
    counted = _cli_counts_ok(torch, "cli serve", made.calls(), counts,
                             routes, plain, made.models)
    frames, samples, good = [], [], True
    for utt, _ in rows:
        m, w = d / "serve" / f"{utt}.mel.npy", d / "serve" / f"{utt}.wav"
        if not (m.exists() and w.exists()):
            good = False
            continue
        mel = np.load(m)
        wav, _ = audio.read_wav(str(w))
        frames.append(mel.shape[0])
        samples.append(len(wav))
        nf = mel.shape[0]
        want = {nf * hop} | ({(nf - 1) * hop} if nf in (400, 800) else set())
        good = good and (mel.shape[1] == 100 and bool(np.isfinite(mel).all())
                         and len(wav) in want)
    buckets = {400 if f <= 400 else 800 for f in frames}
    ok["cli_serve"] = (good and counted and len(frames) == len(rows)
                       and buckets == {400, 800})
    numbers["serve"] = dict(wall_s=wall, frames=frames, wav_samples=samples,
                            unet_calls=made.calls()["unet"][0],
                            launches=counts)
    log(f"cli serve ({len(rows)} EN rows, one prompt wav, batch 8, mel "
        f"buckets 400/800, bf16, vocoder): {wall:.2f} s wall (model built "
        f"and loaded, the prompt read once); frames {frames}, wav samples "
        f"{samples}; every row's mel and wav: {good}; buckets used "
        f"{sorted(buckets)}; card {card}")

    # -- the other samplers on the same weights --------------------------
    state = load_model_state_dict(ckpt, cfg)
    syn = serve.BatchSynthesizer(cfg, state, batch_size=8, steps=CLI_STEPS,
                                 mel_buckets=(400, 800),
                                 dtype=torch.bfloat16, device=dev)
    reqs = syn._tokenise([dict(utt_id=u, text=t, lang="EN", refer=wav_path)
                          for u, t in rows])
    short = [r for r in reqs if len(r[1]) <= 128]
    model32 = DiffVits(cfg, len(symbols), device=dev)
    model32.load_state_dict(state, strict=True)
    del state
    syn.batch_size = 8
    batch8 = syn.pad_batch([short[i % len(short)] for i in range(8)], 128)
    noise = torch.randn(8, 400, 100,
                        generator=torch.Generator().manual_seed(9)).to(dev)
    for method in ("dpmsolver", "ddim"):
        calls, handles = _count_path_calls(syn.model)
        (mel, lens), counts, routes, plain = _counted(torch, lambda: synthesize(
            syn.model, *batch8, generator=torch.Generator().manual_seed(10),
            sampling_steps=CLI_STEPS, sample_method=method, max_len=400,
            device=dev))
        for h in handles:
            h.remove()
        counted = _cli_counts_ok(torch, f"{method} b=8", calls, counts,
                                 routes, plain, [syn.model])
        finite = bool(torch.isfinite(mel).all())
        out = {}
        for route in (True, False):
            set_use_fused(model32, route)
            out[route] = synthesize(model32, *batch8, noise_scale=0.0,
                                    sampling_steps=CLI_STEPS,
                                    sample_method=method, max_len=400,
                                    init_noise=noise, device=dev)
        set_use_fused(model32, True)
        (mel_k, len_k), (mel_p, len_p) = out[True], out[False]
        err = (mel_k - mel_p).abs().max().item()
        parity = bool(torch.equal(len_k, len_p)) and err <= 5e-3
        log(f"{method} parity fp32 (kernels vs plain, b=8, 400 frames, "
            f"{CLI_STEPS} steps, injected noise): frames {len_k.tolist()} vs "
            f"{len_p.tolist()}, max |diff| {err:.3e} (gate 5e-3), max |mel| "
            f"{mel_p.abs().max().item():.3f}")
        timing = serving_numbers(torch, syn, short, card, what=method,
                                 sample_method=method)
        ok[f"cli_{method}"] = counted and finite and parity
        numbers[method] = dict(unet_calls=calls["unet"][0], launches=counts,
                               parity_max_abs=err, **timing)
    del model32

    # -- ddpm: b=1, mel bucket 400, cfg.train.timesteps UNet calls --------
    syn.batch_size = 1
    batch1 = syn.pad_batch(short[:1], 128)
    calls, handles = _count_path_calls(syn.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (mel, _), counts, routes, plain = _counted(torch, lambda: synthesize(
        syn.model, *batch1, generator=torch.Generator().manual_seed(11),
        sample_method="ddpm", max_len=400, device=dev))
    wall = time.perf_counter() - t0
    for h in handles:
        h.remove()
    counted = _cli_counts_ok(torch, "ddpm b=1", calls, counts, routes, plain,
                             [syn.model])
    audio_s = 400 * hop / cfg.data.sampling_rate
    # the denoiser's DDPM_CALLS and the duration predictor's one
    ok["cli_ddpm"] = (counted and calls["unet"][0] == DDPM_CALLS + 1
                      and bool(torch.isfinite(mel).all()))
    numbers["ddpm"] = dict(unet_calls=calls["unet"][0], launches=counts,
                           latency_s=wall, rtf=audio_s / wall)
    log(f"ddpm b=1 (mel bucket 400, bf16): {calls['unet'][0]} UNet calls "
        f"(want {DDPM_CALLS} denoiser + 1 duration predictor), {wall:.2f} s "
        f"({wall / calls['unet'][0] * 1e3:.1f} ms a call, one run), "
        f"real-time factor {audio_s / wall:.3f}x; card {card}")
    del syn
    tmp.cleanup()
    torch.cuda.empty_cache()
    return ok, numbers


# -- the sampler library: every solver setting over the denoiser ---------

SAMPLER_BATCH, SAMPLER_FRAMES, SAMPLER_STEPS, DENSE_STEPS = 8, 400, 20, 100
# (name, sampler, keyword arguments, model evaluations); the first row is
# the serving default, the reference of the table
SAMPLER_SETTINGS = (
    ("unipc bh2 o2 30 (serving)", "unipc", dict(steps=30), 30),
    ("dpm++ multistep o3", "dpm", dict(order=3), 20),
    ("dpm++ singlestep o3 logSNR", "dpm",
     dict(method="singlestep", order=3, skip_type="logSNR"), 20),
    ("dpm++ singlestep_fixed o2 quadratic", "dpm",
     dict(method="singlestep_fixed", order=2, skip_type="time_quadratic"),
     20),
    ("dpmsolver multistep o2 taylor", "dpm",
     dict(algorithm_type="dpmsolver", solver_type="taylor"), 20),
    ("dpm++ multistep o2 thresholding + denoise_to_zero", "dpm",
     dict(correcting_x0_fn="dynamic_thresholding", denoise_to_zero=True),
     21),
    ("unipc bh1 o3", "unipc", dict(variant="bh1", order=3), 20),
    ("unipc vary_coeff o2 quadratic", "unipc",
     dict(variant="vary_coeff", skip_type="time_quadratic"), 20),
    ("unipc noise_prediction bh2 o2", "unipc",
     dict(algorithm_type="noise_prediction"), 20),
)


def _sample(sampler, ns, x0_fn, x, **kw):
    """The port's ``sample_dpmpp`` (``sampler`` "dpm") or ``sample_unipc``
    under inference mode, ``SAMPLER_STEPS`` steps unless given."""
    import torch
    from diff_vits_tpu_torch.diffusion.dpm_solver import sample_dpmpp
    from diff_vits_tpu_torch.diffusion.uni_pc import sample_unipc
    kw = {"steps": SAMPLER_STEPS, **kw}
    with torch.inference_mode():
        return (sample_dpmpp if sampler == "dpm" else sample_unipc)(
            x0_fn, ns, x, **kw)


def _denoiser(torch, model, batch, rows=slice(None)):
    """``model``'s content (``VITS.infer``, zero prior noise, mel bucket
    ``SAMPLER_FRAMES``) and prompt keys for ``batch``, taken once, and the
    2-argument x0 callback over ``DiffusionEncoder.denoise`` for the items
    ``rows``; returns (callback, evaluations counted by it)."""
    dm = model.diff_model
    with torch.inference_mode():
        content, _ = model.vits.infer(*batch, noise_scale=0.0,
                                      max_len=SAMPLER_FRAMES)
        prompt_h, prompt_keep = dm.encode_prompt(batch[2], batch[3])
    content, prompt_h, prompt_keep = (
        t[rows] for t in (content, prompt_h, prompt_keep))
    evals = [0]

    def x0_fn(x, t_discrete):
        evals[0] += 1
        return dm.denoise(x, t_discrete, content, prompt_h, prompt_keep)
    return x0_fn, evals


def samplers_phase(torch, dev, card):
    """The sampler library at ``reference_parity`` widths (random weights
    from seed 4; ``BatchSynthesizer``'s bf16 model and a float32 copy):
    b=8, text bucket 128, mel bucket 400, content and prompt keys taken
    once from ``VITS.infer`` / ``encode_prompt``, the solvers driven from
    one injected x_T with a 2-argument callback over
    ``DiffusionEncoder.denoise``. For each fixed-grid setting of
    ``SAMPLER_SETTINGS``: the bf16 run's denoiser calls (hooks) equal the
    setting's model evaluations and its launches 22/16/16/16 a call (the
    core 32), no K5-K8 and no ``attention_plain`` (gated); the float32
    kernel route against the plain route, max |mel diff| <= 5e-3 (gated);
    the median of 3 warmed bf16 runs (host clock, synchronised) as ms a
    request and ms a denoiser call, and the float32 kernel route's max
    |diff| to a ``DENSE_STEPS``-step DPM-Solver++ order-2 solve from the
    same x_T (printed). Then the adaptive solver (order 2, JAX's
    controls) at b=1 in bf16: launches match its own evaluations, the mel
    finite (gated), its evaluations and wall time printed; and one mel of
    the dense solve through ``inverse_dpmpp`` and back (20 steps each,
    float32), its error printed. Returns ({phase: ok}, numbers)."""
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.diffusion.dpm_solver import inverse_dpmpp
    from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP
    from diff_vits_tpu_torch.diffusion.schedule import linear_beta_schedule
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random

    t_phase = time.perf_counter()
    ok, numbers = {}, dict(card=card, settings={})
    cfg = load_config(str(ROOT / "configs" / "reference_parity.json"))
    model32 = DiffVits(cfg, len(symbols), device=dev)
    init_random(model32, torch.Generator().manual_seed(4))
    model32.eval()
    syn = BatchSynthesizer(cfg, model32.state_dict(),
                           batch_size=SAMPLER_BATCH,
                           mel_buckets=(SAMPLER_FRAMES,),
                           dtype=torch.bfloat16, device=dev)
    reqs = _requests(torch, torch.Generator().manual_seed(5), len(symbols),
                     syn.refer_frames)
    short = [r for r in reqs if len(r[1]) <= 128]
    batch = syn.pad_batch([short[i % len(short)]
                           for i in range(SAMPLER_BATCH)], 128)
    ns = NoiseScheduleVP(linear_beta_schedule(cfg.train.timesteps))
    x_T = torch.randn(SAMPLER_BATCH, SAMPLER_FRAMES, 100,
                      generator=torch.Generator().manual_seed(6)).to(dev)
    bf16_fn, _ = _denoiser(torch, syn.model, batch)
    fp32_fn, _ = _denoiser(torch, model32, batch)
    dense = _sample("dpm", ns, fp32_fn, x_T, steps=DENSE_STEPS)
    log(f"samplers: reference_parity widths, random weights (seed 4), b="
        f"{SAMPLER_BATCH}, mel bucket {SAMPLER_FRAMES}, 2-argument "
        f"callback; dense reference: {DENSE_STEPS}-step DPM-Solver++ order "
        f"2, float32 kernel route, max |mel| {dense.abs().max().item():.3f}")

    for name, sampler, kw, evals in SAMPLER_SETTINGS:
        calls, handles = _count_path_calls(syn.model)
        mel, counts, routes, plain = _counted(
            torch, lambda: _sample(sampler, ns, bf16_fn, x_T, **kw))
        for h in handles:
            h.remove()
        counted = _cli_counts_ok(torch, f"samplers {name}", calls, counts,
                                 routes, plain, [syn.model], rel=False)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _sample(sampler, ns, bf16_fn, x_T, **kw)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        lat = sorted(runs)[1]
        out = {}
        for route in (True, False):
            set_use_fused(model32, route)
            out[route] = _sample(sampler, ns, fp32_fn, x_T, **kw)
        set_use_fused(model32, True)
        err = (out[True] - out[False]).abs().max().item()
        dist = (out[True] - dense).abs().max().item()
        finite = bool(torch.isfinite(mel).all())
        ok[f"samplers_{name}"] = (counted and calls["unet"][0] == evals
                                  and finite and err <= 5e-3)
        numbers["settings"][name] = dict(
            kwargs=kw, evaluations=calls["unet"][0], launches=counts,
            ms_per_request=lat * 1e3, ms_per_call=lat * 1e3 / evals,
            runs_s=runs, parity_max_abs=err, dense_max_abs=dist)
        log(f"samplers {name}: {calls['unet'][0]} denoiser calls (want "
            f"{evals}), bf16 b={SAMPLER_BATCH} {lat * 1e3:.1f} ms a request "
            f"(median of {[round(r * 1e3, 1) for r in runs]}), "
            f"{lat * 1e3 / evals:.2f} ms a call; fp32 kernels vs plain max "
            f"|diff| {err:.3e} (gate 5e-3); max |diff| to the dense solve "
            f"{dist:.3e}; card {card}")

    # -- the adaptive solver, b=1, bf16, JAX's controls ---------------------
    one_fn, one_evals = _denoiser(torch, syn.model, batch, rows=slice(0, 1))
    calls, handles = _count_path_calls(syn.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel, counts, routes, plain = _counted(torch, lambda: _sample(
        "dpm", ns, one_fn, x_T[:1], method="adaptive", order=2))
    wall = time.perf_counter() - t0
    for h in handles:
        h.remove()
    counted = _cli_counts_ok(torch, "samplers adaptive o2 b=1", calls,
                             counts, routes, plain, [syn.model], rel=False)
    ok["samplers_adaptive"] = (counted and calls["unet"][0] == one_evals[0]
                               and bool(torch.isfinite(mel).all()))
    numbers["adaptive"] = dict(evaluations=one_evals[0], launches=counts,
                               wall_s=wall)
    log(f"samplers adaptive (DPM-Solver++ order 2, atol 0.0078, rtol 0.05, "
        f"b=1, bf16): {one_evals[0]} evaluations ({calls['unet'][0]} "
        f"denoiser calls) in {wall:.2f} s, {wall * 1e3 / one_evals[0]:.1f} "
        f"ms an evaluation with the host's E test; finite "
        f"{bool(torch.isfinite(mel).all())}; card {card}")

    # -- inversion round trip: one mel of the dense solve, float32 ----------
    inv_fn, _ = _denoiser(torch, model32, batch, rows=slice(0, 1))
    with torch.inference_mode():
        x_inv = inverse_dpmpp(inv_fn, ns, dense[:1], steps=SAMPLER_STEPS)
    back = _sample("dpm", ns, inv_fn, x_inv)
    trip = (back - dense[:1]).abs().max().item()
    numbers["round_trip"] = dict(
        mel_max_abs=trip, x_T_max_abs=(x_inv - x_T[:1]).abs().max().item())
    log(f"samplers round trip (inverse_dpmpp then sample_dpmpp, 20 steps "
        f"each, float32, one mel of the dense solve): max |mel diff| "
        f"{trip:.3e}, recovered x_T against the drawn one max |diff| "
        f"{numbers['round_trip']['x_T_max_abs']:.3e} (not gated)")
    del syn, model32
    torch.cuda.empty_cache()
    numbers["wall_s"] = time.perf_counter() - t_phase
    log(f"samplers phase: {numbers['wall_s']:.1f} s wall")
    return ok, numbers


# -- the VITS variant: stochastic duration predictor + residual spec flow --

def variant_phase(torch, dev, card):
    """Serving run of the variant through the kernels, its fp32
    kernels-vs-plain parity run and its serving numbers. Returns
    ({phase: ok}, launch counts of the serving run, numbers)."""
    import dataclasses
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.ops import rel_attention as RA
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random

    ok = {}
    cfg = load_config(str(ROOT / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(cfg, vits=dataclasses.replace(
        cfg.vits, duration_predictor="sdp", use_flow=True))
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"variant: reference_parity widths, duration_predictor='sdp', "
        f"residual-coupling flow, {n_params} parameters, random weights "
        "(seed 0)")

    syn = BatchSynthesizer(cfg, model.state_dict(), batch_size=8,
                           mel_buckets=(400, 800), dtype=torch.bfloat16,
                           device=dev)
    set_use_fused(syn.model, True)          # the K5 route on
    reqs = _requests(torch, torch.Generator().manual_seed(1), len(symbols),
                     syn.refer_frames)
    calls, handles = _count_path_calls(syn.model)
    ops.reset_launches()
    t0 = time.perf_counter()
    results = syn.synthesize_all(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rel_routes = RA.route_counts()
    for h in handles:
        h.remove()
    want = _want(calls)
    order_ok = [r[0] for r in results] == [r[0] for r in reqs]
    finite = all(np.isfinite(m).all() and m.ndim == 2 and m.shape[1] == 100
                 and m.shape[0] >= 1 for _, m in results)
    launched = all(counts[k] > 0 for k in ("fused_rel_self_attention",
                                           "unconstrained_rqs"))
    ok["variant_serve"] = order_ok and finite and launched and counts == want
    log(f"variant serve: {len(results)} requests in {wall:.3f} s (first "
        f"call of each bucket shape included); frames "
        f"{[m.shape[0] for _, m in results]}; UNet calls "
        f"{calls['unet'][0]}, encoder layers {calls['encoder_layers'][0]}, "
        f"duration-predictor reverses {calls['sdp_reverse'][0]}; launches "
        f"{counts} (want {want}); order {order_ok}; finite {finite}")
    ok["variant_serve_rel_attention_mma"] = _rel_mma_only(
        rel_routes, counts["fused_rel_self_attention"], "variant serve")
    ok["variant_serve_k7_kernel"], k7_names = _k7_by_name(
        torch, lambda: syn.synthesize_all(reqs, seed=0), want)

    # -- parity: one fp32 batch, kernels vs the plain path on the card ----
    gen = torch.Generator().manual_seed(2)
    syn.batch_size = 2
    batch = syn.pad_batch(reqs[:2], 128)
    noise = torch.randn(2, 400, 100, generator=gen).to(dev)
    dur_noise = torch.randn(2, 128, 2, generator=gen).to(dev)
    out, launches = {}, {}
    for route in (True, False):
        set_use_fused(model, route)
        ops.reset_launches()
        out[route] = synthesize(model, *batch, noise_scale=0.0, max_len=400,
                                init_noise=noise, dur_noise=dur_noise,
                                device=dev)
        launches[route] = ops.launch_counts()
    set_use_fused(model, True)
    (mel_k, len_k), (mel_p, len_p) = out[True], out[False]
    err = (mel_k - mel_p).abs().max().item()
    routes_ok = (launches[True]["fused_rel_self_attention"] > 0
                 and launches[True]["unconstrained_rqs"] > 0
                 and not any(launches[False].values()))
    ok["variant_parity_fp32"] = (
        bool(torch.equal(len_k, len_p)) and err <= 5e-3 and routes_ok
        and bool(torch.isfinite(mel_k).all()))
    log(f"variant parity fp32 (kernels vs plain, 2 utterances, 400 frames, "
        f"injected duration and initial noise): frames {len_k.tolist()} vs "
        f"{len_p.tolist()}, max |diff| {err:.3e} (gate 5e-3), max |mel| "
        f"{mel_p.abs().max().item():.3f}; launches {launches[True]} vs "
        f"{launches[False]}")
    del model

    short = [r for r in reqs if len(r[1]) <= 128]
    numbers = serving_numbers(torch, syn, short, card, "variant serving")
    return ok, counts, dict(card=card, serve_wall_s=wall, n_params=n_params,
                            calls={k: v[0] for k, v in calls.items()},
                            launches=counts, want=want, k7_kernels=k7_names,
                            frames=[int(m.shape[0]) for _, m in results],
                            parity_max_abs=err, numbers=numbers)


K7_KERNEL = "spline_group_kernel<"


def _k7_by_name(torch, run, want):
    """The variant's serving run again under torch.profiler (device
    activity only; a window that recorded none is taken again): every
    spline kernel it ran is ``spline_group_kernel``, as many launches as
    the wrapper counted, which equal ``want``'s. Returns (ok, {kernel
    name: launches})."""
    from diff_vits_tpu_torch import ops
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.25)
        ops.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        by_name = device_by_name(prof)
        if by_name:
            break
    launched = ops.launch_counts()["unconstrained_rqs"]
    names = {k: n for k, (n, _) in by_name.items() if "spline" in k}
    good = (launched == want["unconstrained_rqs"] > 0
            and all(K7_KERNEL in k for k in names)
            and sum(names.values()) == launched)
    log(f"variant serve under the profiler: K7 launches {launched} (want "
        f"{want['unconstrained_rqs']}), spline kernels by profiler name "
        f"{names}; all {K7_KERNEL}...>: {good}")
    return good, names


# -- K8: flash attention, the training step's attention with the route on --

FLASH_B, FLASH_H = 32, 8
# (site, T, S, head dim, ragged keep): the gated sites of a training step
FLASH_SITES = (("dp-unet L0 self", 601, 601, 8, False),
               ("dp-unet L0 cross", 601, 400, 8, True),
               ("denoiser L0 cross", 400, 267, 16, True),
               ("EncSALayer o_proj", 400, 400, 32, True))


def _flash_inputs(torch, gen, dev, t, s, d, ragged, dtype):
    """q [B, H, T, d], k and v [B, H, S, d] as the modules hand them over
    (heads split off [B, L, H*d] projections: strided views); a keep mask
    [B, S] with ragged lengths (item 0 all S keys, the last one key) or
    None."""
    b, h = FLASH_B, FLASH_H

    def heads(n):
        return (torch.randn(b, n, h * d, generator=gen, device=dev)
                .to(dtype).unflatten(-1, (h, d)).transpose(1, 2))
    keep = None
    if ragged:
        lengths = torch.tensor([max(1, s - (s * i) // b) for i in range(b)],
                               device=dev)
        lengths[-1] = 1
        keep = torch.arange(s, device=dev)[None] < lengths[:, None]
    return heads(t), heads(s), heads(s), keep


def _rel_err(out, ref):
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def _flash_bound(dname, b, h, t, s, d, ragged, what):
    """(bound ms, by, flops, bytes) of K8's ``what`` ("forward",
    "backward", "forward+backward"): 4 B H T S d operations forward, 2.5x
    that backward; each input read once and each output written once (the
    log-sum-exp is the forward's output and the backward's input, an
    intermediate of the pair)."""
    esz = 4 if dname == "float32" else 2
    nt, ns = b * h * t * d, b * h * s * d
    keep = b * s if ragged else 0
    fwd = 4 * b * h * t * s * d
    flops, nbytes = {
        "forward": (fwd, esz * (2 * nt + 2 * ns) + 4 * b * h * t + keep),
        "backward": (2.5 * fwd, esz * (4 * nt + 4 * ns) + 4 * b * h * t
                     + keep),
        "forward+backward": (3.5 * fwd, esz * (4 * nt + 4 * ns) + keep),
    }[what]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dname]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes)


def flash_kernel_phase(torch, dev):
    """K8 against its plain version at the gated sites' shapes (B=32, 8
    heads; float32 and bfloat16): forward output and log-sum-exp against
    ``sdpa_plain``, dq/dk/dv of the backward kernels against autograd of
    ``sdpa_plain`` and against ``sdpa_backward_plain`` on the same inputs;
    gates max |kernel - plain| / max |plain| <= 1e-3 (float32), 3e-2
    (bfloat16). Times (CUDA events, the wrappers' host work included) of the
    forward, the backward and forward + backward through autograd for the
    kernel, the plain version and the library
    (``F.scaled_dot_product_attention`` with the mask as a boolean mask;
    its backward alone as the ATen
    backward op of the backend it takes, whose dq/dk/dv against the plain
    version's are printed, not gated), the kernel's device times
    (torch.profiler) and the bounds. Returns (ok, rows, {counter name:
    headline row})."""
    import torch.nn.functional as F
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.ops import flash_attention as FA
    ok, rows = True, []
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(14)
        for site, t, s, d, ragged in FLASH_SITES:
            q, k, v, keep = _flash_inputs(torch, gen, dev, t, s, d, ragged,
                                          dtype)
            scale = d ** -0.5
            ops.reset_launches()
            o, lse = FA.flash_attention_forward(q, k, v, keep, scale)
            do = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
            grads = FA.flash_attention_backward(q, k, v, o, lse, do, keep,
                                                scale)
            torch.cuda.synchronize()
            # bf16 on the tensor-core kernels, float32 on the FMA ones
            route = FLASH_ROUTE[dname]
            routes = FA.route_counts()
            route_ok = all(routes[f"{n}.{route}_launches"] == 1
                           and routes[f"{n}.wide_bf16_launches"] == 0
                           for n in ("flash_attention_forward",
                                     "flash_attention_backward"))
            ref_o, ref_lse = FA.sdpa_plain(q, k, v, keep, sm_scale=scale,
                                           with_lse=True)
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(
                FA.sdpa_plain(*leaves, keep, sm_scale=scale), leaves, do)
            manual = FA.sdpa_backward_plain(q, k, v, o, lse, do, keep,
                                            sm_scale=scale)
            lib_bwd, lib_grads = _library_backward(torch, q, k, v, keep, do,
                                                   scale)
            lib_err = max(_rel_err(g, ga)[1]
                          for g, ga in zip(lib_grads, auto))
            errs = {"o": _rel_err(o, ref_o), "lse": _rel_err(lse, ref_lse)}
            for name, g, ga, gm, x in zip("qkv", grads, auto, manual,
                                          (q, k, v)):
                errs[f"d{name}"] = _rel_err(g, ga)
                errs[f"d{name}_vs_written_out"] = _rel_err(g, gm)
                # the gradient in its input's (a strided view's) layout
                errs[f"d{name}_layout"] = (
                    0.0, 0.0 if g.stride() == x.stride() else 1.0)
            finite = all(bool(torch.isfinite(x.float()).all())
                         for x in (o, lse, *grads))
            good = finite and all(rel <= TOL[dname]
                                  for _, rel in errs.values())
            ok &= good
            good &= route_ok
            ok &= route_ok
            row = _flash_times(torch, F, FA, dname, q, k, v, keep, o, lse,
                               do, scale, lib_bwd)
            b, h = FLASH_B, FLASH_H
            for what, key in (("forward", ""), ("backward", "bwd_"),
                              ("forward+backward", "fwd_bwd_")):
                bound, by, flops, nbytes = _flash_bound(dname, b, h, t, s, d,
                                                        ragged, what)
                row.update({f"{key}bound_ms": bound, f"{key}bound_by": by,
                            f"{key}flops": flops, f"{key}bytes": nbytes})
            row.update(site=f"{site} B={b} H={h} T={t} S={s} d={d} "
                       + ("ragged" if ragged else "no mask"), dtype=dname,
                       T=t, S=s, d=d,
                       ok=good, errors={k: v[1] for k, v in errs.items()},
                       library_bwd_err=lib_err,
                       max_abs_err=max(errs[n][0] for n in ("o", "lse")),
                       bwd_max_abs_err=max(errs[f"d{n}"][0] for n in "qkv"))
            rows.append(row)
            log(f"kernel flash_attention {dname:8s} {row['site']:50s} "
                + " ".join(f"{k}={v[1]:.2e}" for k, v in errs.items()
                           if not k.endswith("layout"))
                + f" layouts {all(errs[f'd{n}_layout'][1] == 0 for n in 'qkv')}"
                f" route {route} {route_ok} (profiler: {row['kernels']})"
                f" {'ok' if good else 'FAIL'}")
            log("  forward ms={ms:.4f} device_ms={device_ms} plain_ms="
                "{plain_ms:.4f} library_ms={library_ms:.4f} "
                "library_device_ms={library_device_ms} bound_ms="
                "{bound_ms:.4f} ({bound_by}); backward ms={bwd_ms:.4f} "
                "device_ms={bwd_device_ms} plain_ms={bwd_plain_ms:.4f} "
                "library_ms={bwd_library_ms:.4f} library_device_ms="
                "{bwd_library_device_ms} (its dq/dk/dv vs plain "
                "{library_bwd_err:.2e}) bound_ms={bwd_bound_ms:.4f} "
                "({bwd_bound_by}); forward + "
                "backward ms={fwd_bwd_ms:.4f} device_ms={fwd_bwd_device_ms} "
                "plain_ms={fwd_bwd_plain_ms:.4f} library_ms="
                "{fwd_bwd_library_ms:.4f} bound_ms={fwd_bwd_bound_ms:.4f}"
                .format(**row))
    head = next(r for r in rows if r["dtype"] == "bfloat16")
    fwd = dict(head, name="flash_attention_forward",
               max_abs_err=max(r["max_abs_err"] for r in rows))
    bwd = dict(name="flash_attention_backward", site=head["site"],
               dtype=head["dtype"],
               max_abs_err=max(r["bwd_max_abs_err"] for r in rows),
               ms=head["bwd_ms"], device_ms=head["bwd_device_ms"],
               plain_ms=head["bwd_plain_ms"],
               library_ms=head["bwd_library_ms"],
               library_device_ms=head["bwd_library_device_ms"],
               bound_ms=head["bwd_bound_ms"], bound_by=head["bwd_bound_by"])
    for r in rows:
        r["name"] = "flash_attention"
    return ok, rows, {"flash_attention_forward": fwd,
                      "flash_attention_backward": bwd}


def flash_site_table(rows, site_launches, card):
    """Each K8 row's launches per model3 step at its site (the route-on
    training step's gated calls by shape), and one line a row: device ms
    of the kernel and the library, the bound, forward and backward."""
    for r in rows:
        r["launches_per_step"] = site_launches.get(
            f"T={r['T']} S={r['S']} d={r['d']}", 0)
        log(f"K8 {r['dtype']:8s} {r['site']:50s} forward dev "
            f"{r['device_ms']} ms (library {r['library_device_ms']}, bound "
            f"{r['bound_ms']:.4f} {r['bound_by']}); backward dev "
            f"{r['bwd_device_ms']} ms (by kernel {r['bwd_kernel_ms']}; "
            f"library {r['bwd_library_device_ms']}, "
            f"bound {r['bwd_bound_ms']:.4f} {r['bwd_bound_by']}); "
            f"{r['launches_per_step']} + {r['launches_per_step']} launches a "
            f"model3 step; card {card}")


def _library_backward(torch, q, k, v, keep, do, scale):
    """The library's backward as one call, on the backend
    ``F.scaled_dot_product_attention`` takes: ATen's flash attention with
    no mask in bfloat16, its memory-efficient attention otherwise. Its
    forward runs once for its own output and log-sum-exp; the backward op
    on them and ``do`` is the call. The mask is the additive -inf bias SDPA
    makes of a boolean mask, in storage padded to 16 keys as SDPA pads it.
    Returns (the call, its (dq, dk, dv))."""
    aten = torch.ops.aten
    if keep is None and q.dtype == torch.bfloat16:
        o, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False,
                                                     False, scale=scale)

        def run():
            return aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False,
                seed, offset, scale=scale)
        return run, run()
    bias = None
    if keep is not None:
        b, s = keep.shape
        padded = torch.zeros(b, 1, 1, -(-s // 16) * 16, dtype=q.dtype,
                             device=q.device)
        padded[..., :s].masked_fill_(~keep[:, None, None, :], float("-inf"))
        bias = padded[..., :s].expand(b, q.shape[1], q.shape[2], s)
    o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, 0.0, False, scale=scale)

    def run():
        return aten._scaled_dot_product_efficient_attention_backward(
            do, q, k, v, bias, o, lse, seed, offset, 0.0,
            [True, True, True, False], False, scale=scale)[:3]
    return run, run()


def _flash_times(torch, F, FA, dname, q, k, v, keep, o, lse, do, scale,
                 library_bwd):
    """K8's times at one case: the forward and backward launchers, forward
    + backward through autograd; the plain version's; the library's
    (forward and forward + backward through ``F.scaled_dot_product_attention``,
    the backward call ``library_bwd``); the kernel's and the library's
    device times."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    mask = None if keep is None else keep[:, None, None, :]

    def fwd_bwd(fn):
        def run():
            torch.autograd.grad(fn(*leaves), leaves, do)
        return run
    kernel = dict(
        fwd=lambda: FA.flash_attention_forward(q, k, v, keep, scale),
        bwd=lambda: FA.flash_attention_backward(q, k, v, o, lse, do, keep,
                                                scale),
        fwd_bwd=fwd_bwd(lambda *x: FA.sdpa(*x, keep, sm_scale=scale,
                                           use_flash=True)))
    plain = dict(
        fwd=lambda: FA.sdpa_plain(q, k, v, keep, sm_scale=scale),
        bwd=lambda: FA.sdpa_backward_plain(q, k, v, o, lse, do, keep,
                                           sm_scale=scale),
        fwd_bwd=fwd_bwd(lambda *x: FA.sdpa_plain(*x, keep, sm_scale=scale)))
    library = dict(
        fwd=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   scale=scale),
        fwd_bwd=fwd_bwd(lambda *x: F.scaled_dot_product_attention(
            *x, attn_mask=mask, scale=scale)))
    fwd_dev, fwd_names = device_times(kernel["fwd"])
    bwd_dev, bwd_names = device_times(kernel["bwd"])
    return dict(
        ms=cuda_time(kernel["fwd"]), device_ms=fwd_dev,
        plain_ms=cuda_time(plain["fwd"], iters=5),
        library_ms=cuda_time(library["fwd"]),
        library_device_ms=device_time(library["fwd"]),
        bwd_ms=cuda_time(kernel["bwd"]),
        bwd_device_ms=bwd_dev,
        kernels=_flash_kernels([*fwd_names, *bwd_names]),
        # the backward's device ms by kernel (dQ, dK/dV)
        bwd_kernel_ms={n.split("<")[0].split("::")[-1]: ms
                       for n, ms in bwd_names.items() if "flash_" in n},
        bwd_plain_ms=cuda_time(plain["bwd"], iters=5),
        bwd_library_ms=cuda_time(library_bwd),
        bwd_library_device_ms=device_time(library_bwd),
        fwd_bwd_ms=cuda_time(kernel["fwd_bwd"]),
        fwd_bwd_device_ms=device_time(kernel["fwd_bwd"]),
        fwd_bwd_plain_ms=cuda_time(plain["fwd_bwd"], iters=5),
        fwd_bwd_library_ms=cuda_time(library["fwd_bwd"]))


# autograd nodes that pass or cut a gradient by the sign of a value: a value
# within rounding of the kink takes the other branch on another route
KINKS = ("ReluBackward", "ThresholdBackward", "ClampBackward",
         "ClampMinBackward", "ClampMaxBackward", "MaximumBackward",
         "MinimumBackward", "AbsBackward")


def _behind_kinks(loss, named_params):
    """Names of the parameters that some path of ``loss``'s autograd graph
    reaches through a kink node (``KINKS``)."""
    names = {id(p): n for n, p in named_params}
    seen, out = set(), set()
    stack = [(loss.grad_fn, False)]
    while stack:
        fn, kinked = stack.pop()
        if fn is None or (fn, kinked) in seen:
            continue
        seen.add((fn, kinked))
        kinked = kinked or fn.name().startswith(KINKS)
        var = getattr(fn, "variable", None)
        if kinked and var is not None and id(var) in names:
            out.add(names[id(var)])
        stack.extend((nxt, kinked) for nxt, _ in fn.next_functions)
    return out


class _ReluBranches:
    """Forward hooks on the modules whose output enters a ReLU (every
    ``TransformerFFNLayer.ffn_1`` and ``FFN.conv_1``). ``record`` keeps each
    call's branch (output > 0); ``impose(branches)`` makes each call take
    the recorded branches: an entry on the other side, within rounding of 0
    on either route, becomes +-1e-30 with its gradient kept."""

    def __init__(self, torch, model):
        from diff_vits_tpu_torch.nn.fairseq import TransformerFFNLayer
        from diff_vits_tpu_torch.nn.layers import FFN
        self.torch, self.want, self.seen = torch, None, []
        self.handles = [
            (m.ffn_1 if isinstance(m, TransformerFFNLayer) else m.conv_1)
            .register_forward_hook(self.hook) for m in model.modules()
            if isinstance(m, (TransformerFFNLayer, FFN))]

    def record(self):
        self.want, self.seen = None, []

    def impose(self, branches):
        self.want, self.seen = list(branches), []

    def hook(self, module, args, out):
        torch = self.torch
        if self.want is not None:
            want = self.want[len(self.seen)]
            flip = want != (out > 0)
            tiny = torch.where(want, 1e-30, -1e-30).to(out.dtype)
            out = torch.where(flip, out - out.detach() + tiny, out)
        self.seen.append((out > 0).detach())
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def _grad_gaps(g_ref, g_x, floor_max, floor_norm):
    """{leaf of both: (max |g_x - g_ref| / max |g_ref|, |g_x - g_ref| /
    |g_ref|)}, each scale at least its floor."""
    gaps = {}
    for name, g in g_ref.items():
        if name not in g_x:
            continue
        diff = g_x[name] - g
        gaps[name] = (diff.abs().max().item()
                      / max(g.abs().max().item(), floor_max),
                      diff.norm().item() / max(g.norm().item(), floor_norm))
    return gaps


def flash_grad_phase(torch, dev, card):
    """Model3 at ``reference_parity`` widths, B=8, float32 (TF32 off), eval
    mode with the UNet's fused route off (so every gated attention site
    reaches K8 and dropout is off), ``generator=None`` with injected t and
    noise: ``DiffVits.forward`` and its backward with the flash route off,
    on, and off again with every ReLU on the branches the route-on run took
    (``_ReluBranches``). Gates: the losses within rel 1e-4; the K8 forward
    and backward counters equal to the calls through the flash gate (0 with
    the route off); the gradients, on against off, within 1e-3 of each
    leaf's scale by the norm (|g_on - g_off| / |g_off|) and by the largest
    entry (max |g_on - g_off| / max |g_off|) on every leaf that no ReLU,
    clamp, abs or max separates from the loss (``_behind_kinks``); and, on
    against off with the same ReLU branches, by the largest entry on every
    leaf. Each scale is at least 1e-5 of the largest leaf's. A ReLU input
    within float32 rounding of 0 may take the other branch on the other
    route; the third run shows what those flips alone move. Returns (ok,
    numbers)."""
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    from diff_vits_tpu_torch.nn.unet1d import set_use_flash, set_use_fused
    from diff_vits_tpu_torch.ops import flash_attention as FA
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import device_batch
    from diff_vits_tpu_torch.utils.init import init_random

    cfg = _train_cfg()
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    model.eval()
    set_use_fused(model, False)
    b, t_y = 8, cfg.data.max_mel_len
    t_x = cfg.data.max_text_len * 2 + 1
    batch = next(_train_batches(np, b, t_x, t_y, t_y * 2 // 3 + 1,
                                len(symbols), seed=9))
    inputs = device_batch(batch, True, dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    t = torch.randint(0, cfg.train.timesteps, (b,), generator=gen,
                      device=dev)
    noise = torch.randn(inputs["spec"].shape, generator=gen, device=dev)
    calls, handles = _flash_calls(model)
    relus = _ReluBranches(torch, model)
    res, branches, kinked, routes = {}, {}, set(), {}
    for key, flash in (("off", False), ("on", True), ("swap", False)):
        set_use_flash(model, flash)
        model.zero_grad(set_to_none=True)
        ops.reset_launches()
        calls[0] = 0
        if key == "swap":
            relus.impose(branches["on"])
        else:
            relus.record()
        loss, _ = model(**inputs, t=t, noise=noise)
        if key == "off":
            kinked = _behind_kinks(loss, model.named_parameters())
        loss.backward()
        torch.cuda.synchronize()
        routes[key] = FA.route_counts()
        branches[key] = relus.seen
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        res[key] = (loss.item(), grads, ops.launch_counts(), calls[0])
    relus.remove()
    for h in handles:
        h.remove()
    # the route-on forward and backward once more, under the profiler: its
    # K8 kernels by name
    set_use_flash(model, True)
    names = device_names(lambda: model(**inputs, t=t, noise=noise)[0]
                         .backward())
    routes["profiled"] = _flash_kernels(names)
    routes["profile_ok"] = _flash_route_only(names, "fma")
    loss_off, g_off, c_off, n_off = res["off"]
    loss_on, g_on, c_on, n_on = res["on"]
    loss_s, g_s, c_s, n_s = res["swap"]
    flips = sum(int((x != y).sum()) for x, y in zip(branches["off"],
                                                      branches["on"]))
    swapped_ok = (len(branches["swap"]) == len(branches["on"]) and all(
        bool((x == y).all()) for x, y in zip(branches["swap"],
                                             branches["on"])))
    rel_loss = abs(loss_on - loss_off) / max(abs(loss_off), 1e-30)
    same_leaves = set(g_on) == set(g_off) == set(g_s)
    floor_max = 1e-5 * max(g.abs().max().item() for g in g_off.values())
    floor_norm = 1e-5 * max(g.norm().item() for g in g_off.values())
    gaps = {"off": _grad_gaps(g_off, g_on, floor_max, floor_norm),
            "swap": _grad_gaps(g_s, g_on, floor_max, floor_norm)}
    common = [n for n in g_off if n in gaps["off"] and n in gaps["swap"]]
    free = [n for n in common if n not in kinked]
    behind = [n for n in common if n in kinked]

    def worst(key, names, i):
        return max(((gaps[key][n][i], n) for n in names),
                   default=(float("inf"), None))
    by_norm, by_norm_name = worst("off", common, 1)
    free_max, free_name = worst("off", free, 0)
    kink_max, kink_name = worst("off", behind, 0)
    swap_max, swap_name = worst("swap", common, 0)
    k8 = ("flash_attention_forward", "flash_attention_backward")
    counts_ok = (n_on > 0 and n_off == 0 and n_s == 0
                 and all(c_on[n] == n_on for n in k8)
                 and all(c_off[n] == 0 and c_s[n] == 0 for n in k8))
    # float32: every K8 launch on the FMA kernels, by counter and by name
    fma_only = routes["profile_ok"] and all(
        routes["on"][f"{n}.fma_launches"] == n_on
        and routes["on"][f"{n}.mma_launches"] == 0 for n in k8)
    ok = (same_leaves and counts_ok and fma_only and swapped_ok
          and rel_loss <= 1e-4 and by_norm <= 1e-3 and free_max <= 1e-3
          and swap_max <= 1e-3)
    log(f"flash gradient parity (model3, B={b}, fp32, eval, fused off): "
        f"loss {loss_on:.6f} (flash) vs {loss_off:.6f}, rel {rel_loss:.2e} "
        f"(gate 1e-4); {len(g_off)} parameter gradients, {len(behind)} of "
        f"them behind a ReLU/clamp/abs/max; on vs off: worst |diff| / |grad| "
        f"{by_norm:.2e} ({by_norm_name}; gate 1e-3), worst max |diff| / max "
        f"|grad| behind no kink {free_max:.2e} ({free_name}; gate 1e-3), "
        f"behind one {kink_max:.2e} ({kink_name}; not gated); {flips} ReLU "
        f"inputs on the other branch; on vs off with the route-on ReLU "
        f"branches (loss {loss_s:.6f}): worst max |diff| / max |grad| "
        f"{swap_max:.2e} ({swap_name}; gate 1e-3); calls through the flash "
        f"gate {n_on}, launches {c_on} (route off: {c_off}); K8 kernels by "
        f"profiler {routes['profiled']}, only FMA {fma_only}: "
        f"{'ok' if ok else 'FAIL'}; card {card}")
    return ok, dict(loss_flash=loss_on, loss_plain=loss_off,
                    loss_plain_flash_branches=loss_s, rel_loss=rel_loss,
                    leaves=len(g_off), leaves_behind_kinks=len(behind),
                    worst_grad_rel=by_norm, worst_grad=by_norm_name,
                    worst_free_grad_max_rel=free_max,
                    worst_free_grad=free_name,
                    worst_kinked_grad_max_rel=kink_max,
                    worst_kinked_grad=kink_name, relu_flips=flips,
                    worst_same_branches_max_rel=swap_max,
                    worst_same_branches=swap_name,
                    over_1e4={n: dict(off=gaps["off"][n], swap=gaps["swap"][n],
                                      behind_kink=n in kinked)
                              for n in common if max(gaps["off"][n][0],
                                                     gaps["swap"][n][0])
                              > 1e-4},
                    flash_calls=n_on, launches_flash=c_on,
                    launches_plain=c_off, flash_routes=routes["on"],
                    flash_kernels=routes["profiled"])


def variant_train_phase(torch, dev, card):
    """The variant (``duration_predictor="sdp"``, residual-coupling flow)
    trained by the same ``Trainer`` at ``reference_parity`` widths, B=32,
    bf16: 2 warm-up and 3 timed steps with the flash route off, then with
    it on; the checks of ``train_run`` (K5 and K7 stay at 0: K5 runs only
    unrecorded in eval mode, K7 only in ConvFlow's reverse). Returns
    ({phase: ok}, {"off": numbers, "on": numbers}, the counts of the run
    with the route on)."""
    cfg = _train_cfg(duration_predictor="sdp", use_flow=True)
    ok, numbers, counts = {}, {}, None
    for flash in (False, True):
        key = "on" if flash else "off"
        good, total, numbers[key], trainer, _ = train_run(
            torch, dev, card, cfg, f"variant train (flash {key})",
            use_flash=flash, steps=5)
        ok[f"variant_train_flash_{key}"] = good
        counts = total
        del trainer
        torch.cuda.empty_cache()
    return ok, numbers, counts


# -- train_cli: training from a dataset on disk through the command line --

TRAIN_CLI_UTTS = 80
TRAIN_CLI_SAVE_EVERY = 3
FLASH_SITES_MODEL3 = 40       # gated attention calls a model3 training step
EVAL_SAMPLING_STEPS = 30      # Trainer.eval_sample's UniPC steps
EVAL_T_FRACS = 5              # Trainer.eval_fixed_t_loss's step fractions
# an EN phone set of text/symbols for the cleaned transcripts
TRAIN_CLI_PHONES = ("aa ae ah ao aw ay b ch d dh eh er ey f g hh ih iy jh k "
                    "l m n ng ow oy p r s sh t th uh uw v w y z zh").split()


def _write_train_corpus(np, root, n, seed=12):
    """``n`` seeded 24 kHz utterances of 1.5-6.0 s (four harmonics of a
    random pitch under noise), each with a cleaned EN line whose
    interspersed phone count is at most a third of its mel frames."""
    from diff_vits_tpu_torch.data import audio
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    sr = 24000
    for i in range(n):
        t = np.arange(int(rng.uniform(1.5, 6.0) * sr)) / sr
        f0 = rng.uniform(90.0, 300.0)
        wav = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t
                                   + rng.uniform(0, 2 * np.pi))
                  for k in range(1, 5)) + 0.02 * rng.normal(size=t.shape)
        audio.write_wav(str(root / f"utt{i:03d}.wav"),
                        wav.astype(np.float32), sr)
        frames = len(t) // 256 + 1
        k = min(300, (frames // 3 - 1) // 2)
        phones = [TRAIN_CLI_PHONES[j]
                  for j in rng.integers(0, len(TRAIN_CLI_PHONES), k)]
        line = "EN|utt {}|{}|{}|{}".format(
            i, " ".join(phones), " ".join(str(int(x)) for x in
                                          rng.integers(0, 3, k)),
            " ".join("1" * k))
        (root / f"utt{i:03d}.txt").write_text(line + "\n", encoding="utf-8")


def _train_cli_calls(model):
    """Hooks on ``model`` counting what each kernel should launch in a
    training run with ``eval_sample``: UNet calls in eval mode (K1-K4 and
    the core; training mode runs no fused block), encoder layers in eval
    mode with autograd off (K5), VITS training forwards (one MAS, K6,
    each), calls through the flash gate with autograd on (K8 forward and
    backward) and off (forward only). Returns ({what: one-item list},
    hook handles)."""
    import torch
    from diff_vits_tpu_torch.models.vits import VITS
    from diff_vits_tpu_torch.nn.layers import Encoder
    from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
    unet, h1 = _count_calls(model, UNet1DConditionModel, lambda m, kw: int(
        not m.training and kw.get("embedding_request") is None))
    layers, h2 = _count_calls(model, Encoder, lambda m, kw: m.n_layers * int(
        not m.training and not torch.is_grad_enabled()))
    mas, h3 = _count_calls(model, VITS, lambda m, kw: 1)
    flash_eval = [0]
    flash, h4 = _flash_calls(model, no_grad=flash_eval)
    return dict(unet=unet, encoder_layers=layers, mas=mas, flash=flash,
                flash_eval=flash_eval), h1 + h2 + h3 + h4


def _train_cli_want(calls):
    """Launches a run should count, from its counted calls."""
    want = {name: n * calls["unet"] for name, n in PER_UNET.items()}
    want["fused_rel_self_attention"] = calls["encoder_layers"]
    want["maximum_path"] = calls["mas"]
    want["unconstrained_rqs"] = 0
    want["flash_attention_forward"] = calls["flash"] + calls["flash_eval"]
    want["flash_attention_backward"] = calls["flash"]
    return want


def _eval_flash_sites(cfg):
    """Gated attention calls of one VITS pass in eval mode, where the UNets
    take the fused route and only the prompt encoders' ``EncSALayer``s can
    reach K8: ``VITS.o_proj`` (6 layers, 8 heads of vits.hidden_channels)
    on ``data.max_mel_len`` frames (the loader's static Ty, and
    ``eval_sample``'s ``max_len``) and the denoiser's prompt encoder
    (``n_prompt_layers``, 8 heads of diffusion_encoder.hidden_channels) on
    the loader's static S = max_mel_len * 2 // 3 + 1 prompt frames, each
    counted where ``flash_ok`` passes at that shape."""
    from diff_vits_tpu_torch.ops.flash_attention import flash_ok
    t = cfg.data.max_mel_len
    s = t * 2 // 3 + 1

    def gated(n_layers, width, frames):
        shape = (None, 8, frames, width // 8)
        return n_layers * int(flash_ok(shape, shape, True))
    return (gated(6, cfg.vits.hidden_channels, t)
            + gated(cfg.diffusion_encoder.n_prompt_layers,
                    cfg.diffusion_encoder.hidden_channels, s))


def _train_cli_derived(cfg, steps, evals, flash_on=True):
    """The same calls derived from the code for ``steps`` training steps
    and ``evals`` eval_samples: a step runs one VITS forward and
    FLASH_SITES_MODEL3 gated attention calls; an eval_sample one
    ``synthesize`` (EVAL_SAMPLING_STEPS denoiser calls and the duration
    predictor's, one TextEncoder call) and ``eval_fixed_t_loss``'s
    EVAL_T_FRACS forwards (twice with an EMA), each two UNet calls (the
    denoiser and the duration predictor), a TextEncoder and a MAS call;
    ``synthesize`` and each of those forwards make the gated calls of
    :func:`_eval_flash_sites` with autograd off. ``flash_on``: the trainer
    turned the flash route on (it does on the card)."""
    forwards = EVAL_T_FRACS * (2 if cfg.train.use_ema else 1)
    return dict(unet=evals * (EVAL_SAMPLING_STEPS + 1 + 2 * forwards),
                encoder_layers=evals * cfg.vits.n_layers * (1 + forwards),
                mas=steps + evals * forwards,
                flash=FLASH_SITES_MODEL3 * steps * flash_on,
                flash_eval=evals * (1 + forwards) * _eval_flash_sites(cfg)
                * flash_on)


class _Tee:
    """Writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def _logged_steps(text):
    """{step: {metric: value}} of the loop's ``step N k=v ...`` lines."""
    import re
    out = {}
    for m in re.finditer(r"^step (\d+) (.*) steps/s=", text, re.M):
        out[int(m.group(1))] = {k: float(v) for k, v in (
            kv.split("=") for kv in m.group(2).split())}
    return out


def train_cli_phase(torch, dev, card, cfg=None, n_utts=TRAIN_CLI_UTTS,
                    ab_runs=2):
    """Training from a dataset on disk through the port's command line:
    ``n_utts`` seeded wavs with cleaned transcripts, ``data.preprocess``
    (``--cleaned``), then ``train.cli.main`` at ``cfg`` (default
    ``reference_parity``: model3, B=32, bf16) for 6 steps (a checkpoint
    and an ``eval_sample`` every 3, the vocoder phase's published-layout
    Vocos file for the samples' wavs) and again with ``--resume auto`` to
    step 8. Gates: the native loader; every logged loss finite;
    ``model-3.ckpt`` and ``model-6.ckpt``; the resume line and step 8;
    ``sample-{1,2}.mel.npy`` and their wavs; the eval metrics; each run's
    launches equal to its counted calls, and those equal to the ones
    derived from the code. Then, not gated: both loaders' batches/s at
    B=32, the step time with the prefetch on and off in turns (``ab_runs``
    runs a side of 2 warm-up and 5 timed steps, synchronised), one
    ``eval_sample``'s and one save's wall time and the runs' peak memory.
    Returns ({phase: ok}, numbers)."""
    import contextlib
    import dataclasses
    import io
    import math
    import tempfile
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.data import preprocess
    from diff_vits_tpu_torch.data.dataset import TextMelDataset, TrainLoader
    from diff_vits_tpu_torch.data.native_loader import NativeTrainLoader
    from diff_vits_tpu_torch.train import cli
    from diff_vits_tpu_torch.train.trainer import batch_to_device

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    numbers = dict(card=card)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    d = Path(tmp.name)
    t0 = time.perf_counter()
    _write_train_corpus(np, d / "raw", n_utts)
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess.main(["--in_dir", str(d / "raw"), "--out_dir",
                         str(d / "data"), "--language", "EN", "--cleaned",
                         "--no_spec"])
    numbers["corpus_and_preprocess_s"] = time.perf_counter() - t0
    cfg = cfg or load_config(str(ROOT / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, training_files=str(
            d / "data"), val_files=str(d / "data")),
        train=dataclasses.replace(
            cfg.train, save_and_sample_every=TRAIN_CLI_SAVE_EVERY,
            vocoder_ckpt=str(ROOT / "build" / "vocos_published_layout.bin")))
    cfg_path = d / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    workdir = d / "run"
    args = ["-c", str(cfg_path), "--workdir", str(workdir), "--log_every",
            "2"] + ([] if cuda else ["--device", str(dev)])

    runs, good = [], True
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for steps, extra, evals in ((6, [], 2), (8, ["--resume", "auto"], 0)):
        tee = _Tee(sys.stdout)
        with _CountNewModels(_train_cli_calls) as made, \
                contextlib.redirect_stdout(tee):
            ops.reset_launches()
            t0 = time.perf_counter()
            trainer = cli.main([*args, *extra, "--steps", str(steps)])
            sync()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
        calls = {k: v[0] for k, v in made.calls().items()}
        want = _train_cli_want(calls)
        derived = _train_cli_derived(cfg, steps - 6 * bool(extra), evals,
                                     flash_on=cuda)
        text = tee.text()
        logged = _logged_steps(text)
        finite = all(math.isfinite(v) for m in logged.values()
                     for v in m.values())
        run_ok = (trainer.loader_kind == "native" and finite
                  and counts == want
                  and all(calls[k] == v for k, v in derived.items()))
        log(f"train_cli run {len(runs) + 1} ({' '.join(extra) or 'fresh'}, "
            f"to step {steps}): loader {trainer.loader_kind}; logged steps "
            f"{sorted(logged)} finite {finite}; counted calls {calls}, "
            f"derived from the code {derived}; launches {counts} (want "
            f"{want}); {wall:.1f} s wall: {'ok' if run_ok else 'FAIL'}")
        good = good and run_ok
        runs.append(dict(wall_s=wall, calls=calls, derived=derived,
                         launches=counts, logged=logged,
                         loader=trainer.loader_kind))
        if not extra:
            metrics = dict(trainer.last_eval_metrics)
            first_out = text
            files = {p.name for p in workdir.iterdir()}
            del trainer
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    resumed = (f"resumed from {workdir / 'model-6.ckpt'} at step 6" in text
               and trainer.step == 8)
    samples = all((workdir / f"sample-{m}.{ext}").is_file()
                  for m in (1, 2) for ext in ("mel.npy", "wav"))
    sample_finite = samples and all(
        np.isfinite(np.load(workdir / f"sample-{m}.mel.npy")).all()
        for m in (1, 2))
    eval_ok = all(k in metrics and math.isfinite(metrics[k]) for k in (
        "eval/mel_l1", "eval/mel_corr", "eval/diff_fixed_t"))
    ckpts = {"model-3.ckpt", "model-6.ckpt"} <= files
    steps_ok = (sorted(runs[0]["logged"]) == [2, 4, 6]
                and sorted(runs[1]["logged"]) == [8])
    good = (good and resumed and samples and sample_finite and eval_ok
            and ckpts and steps_ok and "loader: native" in first_out)
    log(f"train_cli: checkpoints 3 and 6 {ckpts}; resumed at step 6 and "
        f"ended at {trainer.step}: {resumed}; sample-1/2 mel and wav "
        f"{samples} (finite {sample_finite}); eval metrics {metrics}: "
        f"{eval_ok}; peak memory over the runs {peak} GB; "
        f"{'ok' if good else 'FAIL'}; card {card}")
    numbers.update(runs=runs, eval_metrics=metrics,
                   max_memory_allocated_GB=peak)

    # -- not gated: loader rates, prefetch on / off, eval and save times --
    ds = TextMelDataset(cfg)
    rates = {}
    for name, cls in (("native", NativeTrainLoader), ("python", TrainLoader)):
        it = iter(cls(ds, cfg, seed=cfg.train.seed))
        next(it)
        t0 = time.perf_counter()
        for _ in range(8):
            next(it)
        rates[name] = 8 / (time.perf_counter() - t0)
    log(f"train_cli loaders at B={cfg.train.train_batch_size} (host, "
        f"{len(ds)} utterances, 8 batches after one): native "
        f"{rates['native']:.2f} batches/s, python {rates['python']:.2f}; "
        f"card {card}")
    # the synchronous route's copy of one batch: pageable, and pinned as
    # the prefetch worker makes it (median of 10, synchronised)
    host_batch = next(iter(trainer.batches))
    copy_ms = {}
    for pinned in (False, True):
        times = []
        for _ in range(11):
            sync()
            t0 = time.perf_counter()
            batch_to_device(host_batch, dev, pinned=pinned and cuda)
            sync()
            times.append(time.perf_counter() - t0)
        copy_ms["pinned" if pinned else "pageable"] = (
            sorted(times[1:])[5] * 1e3)
    log(f"train_cli batch copy to the device at B="
        f"{cfg.train.train_batch_size}, median of 10: pageable "
        f"{copy_ms['pageable']:.2f} ms, pinned {copy_ms['pinned']:.2f} ms; "
        f"the native loader {1e3 / rates['native']:.2f} ms a batch; card "
        f"{card}")
    order = [True, False, False, True, True, False][:2 * ab_runs]
    ab = {True: [], False: []}
    for prefetch in order:
        it = trainer.device_batches(iter(trainer.batches), prefetch)
        times = []
        try:
            for _ in range(7):
                sync()
                t0 = time.perf_counter()
                trainer.step_on(next(it))
                sync()
                times.append(time.perf_counter() - t0)
        finally:
            it.close()
        ab[prefetch].append(sorted(times[2:])[2])
    med = {k: sorted(v)[len(v) // 2] for k, v in ab.items()}
    log(f"train_cli step time, prefetch on / off in turns ({order}), median "
        f"of 5 timed steps a run: on {[round(x * 1e3, 1) for x in ab[True]]}"
        f" ms, off {[round(x * 1e3, 1) for x in ab[False]]} ms; medians "
        f"{med[True] * 1e3:.1f} / {med[False] * 1e3:.1f} ms; card {card}")
    sync()
    t0 = time.perf_counter()
    trainer.eval_sample(trainer.step)
    sync()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.save(trainer.step)
    save_s = time.perf_counter() - t0
    size_gb = (workdir / f"model-{trainer.step}.ckpt").stat().st_size / 1e9
    log(f"train_cli: one eval_sample {eval_s:.2f} s wall, one save "
        f"{save_s:.2f} s ({size_gb:.2f} GB); card {card}")
    numbers.update(loader_batches_per_s=rates, batch_copy_ms=copy_ms,
                   prefetch_step_s={"on": ab[True], "off": ab[False]},
                   prefetch_order=order, eval_sample_s=eval_s, save_s=save_s,
                   checkpoint_GB=size_gb)
    del trainer
    tmp.cleanup()
    if cuda:
        torch.cuda.empty_cache()
    return {"train_cli": good}, numbers



# -- ckpt_bridge: checkpoints between the reference, JAX and the port ------

BRIDGE_STEPS = 3              # training steps from the converted checkpoint
BRIDGE_MORE = 2               # steps after the export, on every copy


def _bridge_batches(np, cfg, n, seed):
    """``n`` batches of ``train_run``'s shape (B, text 601, mel 400,
    prompts 267)."""
    from diff_vits_tpu_torch.text.symbols import symbols
    t_y = cfg.data.max_mel_len
    it = _train_batches(np, cfg.train.train_batch_size,
                        cfg.data.max_text_len * 2 + 1, t_y, t_y * 2 // 3 + 1,
                        len(symbols), seed=seed)
    return [next(it) for _ in range(n)]


def _steps(trainer, batches):
    """``trainer.train_step`` on each batch, the launches counted over all
    of them; returns (metrics as floats a step, counts)."""
    from diff_vits_tpu_torch import ops
    ops.reset_launches()
    losses = []
    for b in batches:
        metrics = trainer.train_step(b)
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses, ops.launch_counts()


def _train_want(counts, steps, flash_sites):
    """Launches of ``steps`` training steps with ``flash_sites`` gated
    attention calls a step, derived from the code (:func:`_want_step`)."""
    return {k: v * steps for k, v in _want_step(counts, flash_sites).items()}


def _trainer_state(trainer):
    """(parameters, exp_avg, exp_avg_sq, AdamW step, EMA) of ``trainer``."""
    st = [trainer.optimizer.state[p] for p in trainer.params]
    return dict(params=[p.detach() for p in trainer.params],
                exp_avg=[s["exp_avg"] for s in st],
                exp_avg_sq=[s["exp_avg_sq"] for s in st],
                step=[s["step"].reshape(()) for s in st], ema=trainer.ema)


def _max_gap(a, b):
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b))


def _loss_gap(a, b):
    return max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in x)


def ckpt_bridge_phase(torch, dev, card, cfg=None):
    """Checkpoints carried between the reference, the JAX package and the
    port, model3 at ``reference_parity`` widths:

    1. a port ``DiffVits`` (``init_random`` seed 0; each EncSALayer FFN
       conv's tap 0 zeroed, which the reference has no weight for) turned
       by :func:`reference_state_dict` into the reference's layout
       (``module.`` prefixes, the WN layers as weight_g / weight_v) and
       ``torch.save``d as ``{"step": 123, "model": ...}``;
    2. ``utils.convert.main`` on it: the converted state dict equals the
       seeded one bitwise, the WN leaves within 1e-6 of their largest
       entry;
    3. the converted checkpoint served by ``BatchSynthesizer`` (b=8, bf16,
       the path phase's requests and seed): K1-K5 counts as ``_want``
       derives them, the mels against the seeded model's under the same
       route and seed within 1e-6 x max(1, max |mel|) (serving reads no
       leaf that differs, and the kernels are deterministic: 0 expected);
    4. ``Trainer.load`` of it and BRIDGE_STEPS steps with the flash route
       on: K6 and K8 counts derived from the code (1 and
       FLASH_SITES_MODEL3 + FLASH_SITES_MODEL3 a step), finite losses;
    5. ``save_flax`` of that trainer loaded into a fresh ``Trainer``:
       params, exp_avg, exp_avg_sq, step and EMA bitwise equal; with the
       original's generator and coin-flip states copied across, it, the
       original and a copy of the original through the port's own
       checkpoint take BRIDGE_MORE steps on the same batches under
       ``torch.use_deterministic_algorithms``: the JAX-state copy's losses
       and params within the gap between the two runs of the original's
       state (0 there);
    6. ``train.cli --resume <the flax file>`` (no data: no step more)
       prints the resume line at that step.
    ``cfg`` (default ``reference_parity``, EMA on, seed 0) lets the phase
    run on the CPU at tiny widths (the launch gates then fail). Returns
    ({phase: ok}, numbers)."""
    import dataclasses
    import math
    import tempfile
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    from diff_vits_tpu_torch.nn.fairseq import EncSALayer
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
    from diff_vits_tpu_torch.train import cli as train_cli
    from diff_vits_tpu_torch.train.trainer import Trainer
    from diff_vits_tpu_torch.utils import convert
    from diff_vits_tpu_torch.utils.init import init_random

    ok, numbers = {}, dict(card=card)
    cfg = cfg or _train_cfg()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    d = Path(tmp.name)
    cfg_path = d / "config.json"
    cfg_path.write_text(json.dumps(dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, training_files=str(d / "no_data"),
            val_files=str(d / "no_data"))).to_dict()))

    # 1-2: the reference's layout, then the converter's command line
    model = DiffVits(cfg, len(symbols), device="cpu")
    init_random(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, EncSALayer):
                m.ffn.ffn_1.weight[:, :, 0] = 0.0
    seeded = model.state_dict()
    ref = reference_state_dict(convert.to_flax_params(model), cfg)
    pt = d / "model-123.pt"
    torch.save({"step": 123, "model": ref}, pt)
    del ref
    t0 = time.perf_counter()
    conv_path = convert.main(["--ref_ckpt", str(pt), "-c", str(cfg_path),
                              "--out_dir", str(d / "converted")])
    convert_s = time.perf_counter() - t0
    step, state = ckpt_lib.load_checkpoint(conv_path)
    got = state["model"]
    wn = [k for k in seeded if any(k.startswith(p) for p in REF_WEIGHT_NORM)]
    exact = all(torch.equal(got[k], v) for k, v in seeded.items()
                if k not in wn)
    wn_gap = max(float((got[k] - seeded[k]).abs().max()
                       / seeded[k].abs().max()) for k in wn)
    n_params = sum(v.numel() for v in got.values())
    ok["bridge_convert"] = (step == 123 and set(got) == set(seeded)
                            and exact and bool(wn) and wn_gap <= 1e-6)
    log(f"ckpt_bridge: {n_params} parameters; reference .pt "
        f"{pt.stat().st_size / 1e9:.3f} GB ({len(wn)} weight-normed "
        f"leaves); convert {convert_s:.2f} s wall; every other leaf "
        f"bitwise {exact}, WN leaves max |diff| / max |w| {wn_gap:.2e} "
        f"(gate 1e-6); card {card}")
    numbers.update(convert_s=convert_s, n_params=n_params, wn_gap=wn_gap)

    # 3: serve the converted checkpoint and the seeded model alike
    mels = {}
    for what, sd in (("converted", got), ("seeded", seeded)):
        syn = BatchSynthesizer(cfg, sd, batch_size=8, mel_buckets=(400, 800),
                               dtype=torch.bfloat16, device=dev)
        reqs = _requests(torch, torch.Generator().manual_seed(1),
                         len(symbols), syn.refer_frames)
        calls, handles = _count_path_calls(syn.model)
        ops.reset_launches()
        results = syn.synthesize_all(reqs, seed=0)
        sync()
        counts = ops.launch_counts()
        for h in handles:
            h.remove()
        mels[what] = [m for _, m in results]
        if what == "converted":
            want = _want(calls)
            ok["bridge_serve"] = (counts == want and all(
                np.isfinite(m).all() for m in mels[what])
                and [r[0] for r in results] == [r[0] for r in reqs])
            log(f"ckpt_bridge serve (converted, b=8 bf16): launches {counts}"
                f" (want {want}); frames {[m.shape[0] for m in mels[what]]}")
        del syn
    del model, seeded
    scale = max(1.0, max(float(np.abs(m).max()) for m in mels["seeded"]))
    same_shape = [a.shape for a in mels["converted"]] == \
        [b.shape for b in mels["seeded"]]
    mel_gap = max(float(np.abs(a - b).max()) for a, b in
                  zip(mels["converted"], mels["seeded"])) if same_shape \
        else math.inf
    ok["bridge_serve_parity"] = mel_gap <= 1e-6 * scale
    log(f"ckpt_bridge serve: converted vs seeded mels max |diff| "
        f"{mel_gap:.3e} (gate {1e-6 * scale:.1e}, 1e-6 x max(1, max |mel| "
        f"{scale:.3f}))")
    numbers.update(serve_mel_gap=mel_gap, serve_launches=counts)

    # 4: train from it, flash route on (Trainer turns it on on the card)
    batches = _bridge_batches(np, cfg, BRIDGE_STEPS + BRIDGE_MORE, seed=8)
    orig = Trainer(cfg, [], device=dev)
    orig.load(conv_path)
    t0 = time.perf_counter()
    losses, counts = _steps(orig, batches[:BRIDGE_STEPS])
    sync()
    train_s = time.perf_counter() - t0
    want = _train_want(counts, BRIDGE_STEPS, FLASH_SITES_MODEL3)
    finite = all(math.isfinite(v) for m in losses for v in m.values())
    ok["bridge_train"] = (counts == want and finite
                          and orig.step == 123 + BRIDGE_STEPS)
    log(f"ckpt_bridge train from the converted checkpoint: steps 124-"
        f"{orig.step}, "
        f"loss/all {[round(m['loss/all'], 4) for m in losses]}, launches "
        f"{counts} (want {want}, derived), finite {finite}; "
        f"{train_s:.2f} s wall")

    # 5: the JAX trainer state out and back in
    flax_step = orig.step
    sync()
    orig.logs_folder = str(d / "flax")
    t0 = time.perf_counter()
    flax_path = orig.save_flax(flax_step)
    save_flax_s = time.perf_counter() - t0
    orig.logs_folder = str(d / "port")
    t0 = time.perf_counter()
    port_path = orig.save(orig.step)
    save_s = time.perf_counter() - t0
    copies = {}
    for what, path in (("flax", flax_path), ("port", port_path)):
        copies[what] = Trainer(cfg, [], device=dev)
        t0 = time.perf_counter()
        copies[what].load(path)
        numbers[f"load_{what}_s"] = time.perf_counter() - t0
    a, b = _trainer_state(orig), _trainer_state(copies["flax"])
    same = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}
    ok["bridge_flax_state"] = all(same.values()) and \
        copies["flax"].step == orig.step
    flax_gb = Path(flax_path).stat().st_size / 1e9
    port_gb = Path(port_path).stat().st_size / 1e9
    log(f"ckpt_bridge save_flax: {save_flax_s:.2f} s wall ({flax_gb:.2f} GB)"
        f" against the port's save {save_s:.2f} s ({port_gb:.2f} GB); load "
        f"{numbers['load_flax_s']:.2f} / "
        f"{numbers['load_port_s']:.2f} s; reloaded bitwise {same}; "
        f"card {card}")
    copies["flax"].generator.set_state(orig.generator.get_state())
    copies["flax"]._py_rng.setstate(orig._py_rng.getstate())
    # two runs from one state differ after a step (reductions whose order
    # varies, read below); the deterministic algorithms take that out, so
    # the band is 0 and the gate exact
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # cuBLAS's workspace alert
            for what, tr in (("orig", orig), ("port", copies["port"]),
                             ("flax", copies["flax"])):
                runs[what] = _steps(tr, batches[BRIDGE_STEPS:])[0]
    finally:
        torch.use_deterministic_algorithms(False)
    # the same two steps on two more copies with the default algorithms:
    # the run-to-run gap the deterministic ones take out (read, not gated)
    free = {}
    for i in range(2):
        tr = Trainer(cfg, [], device=dev)
        tr.load(port_path)
        free[i] = (_steps(tr, batches[BRIDGE_STEPS:])[0], tr.params)
        del tr
    free_gap = [_loss_gap(free[0][0], free[1][0]),
                _max_gap(free[0][1], free[1][1])]
    del free
    band_loss = _loss_gap(runs["orig"], runs["port"])
    band_param = _max_gap(orig.params, copies["port"].params)
    gap_loss = _loss_gap(runs["orig"], runs["flax"])
    gap_param = _max_gap(orig.params, copies["flax"].params)
    ok["bridge_flax_resume"] = (gap_loss <= band_loss
                                and gap_param <= band_param)
    log(f"ckpt_bridge resume: {BRIDGE_MORE} more steps on the same batches "
        f"(deterministic algorithms); the JAX-state copy against the "
        f"original: losses max |diff| {gap_loss:.3e}, params "
        f"{gap_param:.3e}; the port-checkpoint copy against it (the band): "
        f"{band_loss:.3e} and {band_param:.3e} (gate: within the band); "
        f"two copies with the default algorithms: {free_gap[0]:.3e} and "
        f"{free_gap[1]:.3e}")
    numbers.update(save_flax_s=save_flax_s, save_s=save_s,
                   flax_GB=flax_gb, port_GB=port_gb,
                   band=[band_loss, band_param], gap=[gap_loss, gap_param],
                   resume_losses=runs, default_algorithms_gap=free_gap,
                   train_s=train_s, losses=losses)
    del orig, copies
    torch.cuda.empty_cache()

    # 6: the training command line resumes the JAX trainer state
    out = _Tee(sys.stdout)
    old, sys.stdout = sys.stdout, out
    try:
        trainer = train_cli.main(["-c", str(cfg_path), "--workdir",
                                  str(d / "cli"), "--resume", flax_path,
                                  "--steps", str(flax_step),
                                  "--device", str(dev)])
    finally:
        sys.stdout = old
    line = f"resumed from {flax_path} at step {flax_step}"
    ok["bridge_cli_resume"] = (line in out.text()
                               and trainer.step == flax_step)
    log(f"ckpt_bridge cli: --resume of the JAX trainer state printed "
        f"{line!r}: {line in out.text()}")
    del trainer
    tmp.cleanup()
    torch.cuda.empty_cache()
    return ok, numbers


# -- bv2: the phoneme prosody VAE on the sdp + flow variant ----------------

FLASH_SITES_VARIANT = 20      # gated calls a sdp + flow variant step
PH_PRIOR_LAYERS = 4           # PhPriorEncoder's EncSALayers


def bv2_flash_sites(cfg):
    """Gated attention calls of one bv2 training step, derived from the
    code: the sdp + flow variant's FLASH_SITES_VARIANT and the phoneme
    prior encoder's PH_PRIOR_LAYERS layers (8 heads of
    vits.hidden_channels) on the loader's text buffer (2 max_text_len + 1),
    each where ``flash_ok`` passes at that shape."""
    from diff_vits_tpu_torch.ops.flash_attention import flash_ok
    t = cfg.data.max_text_len * 2 + 1
    shape = (None, 8, t, cfg.vits.hidden_channels // 8)
    return FLASH_SITES_VARIANT + PH_PRIOR_LAYERS * int(
        flash_ok(shape, shape, True))


def unit_phoneme_posterior_std(torch, model):
    """Zero the log-std half of the phoneme posterior's projection
    (``vits.phoneme_vae.ph_encoder_q.proj``), so that it starts as N(m, 1).
    From plain random weights its log-std takes the scale of the random
    frame posterior's z and exp(log-std) overflows the phoneme KL at the
    first step, in the port as in the JAX package: the reference trains
    the VAE only after ``phoneme_vae_warmup_steps`` (bv2.py:770-773), a
    warm-up neither package applies (ROADMAP Queue 3)."""
    proj = model.vits.phoneme_vae.ph_encoder_q.proj
    half = proj.out_features // 2
    with torch.no_grad():
        proj.weight[half:] = 0.0
        proj.bias[half:] = 0.0
    return model


def bv2_phase(torch, dev, card, variant_step_s=None):
    """The bv2 configuration (``reference_parity`` widths, the stochastic
    duration predictor, the residual-coupling flow and the phoneme VAE;
    random weights from seed 0): ``BatchSynthesizer`` (b=8, bf16, mel
    buckets 400 and 800, the K5 route on) with the variant phase's
    checks, order, finite mels, K5 and K7 launched, the counters equal to
    ``_want``'s; the fp32 kernels-vs-plain parity run (injected duration
    and initial noise, zero prior noise: max |mel difference| <= 5e-3);
    latency at b=1 and 8; one training forward from the plain random
    weights, its ``loss/kl_ph`` read (not gated: it overflows, see
    :func:`unit_phoneme_posterior_std`); then ``train_run`` with the flash
    route on (2 warm-up and 3 timed steps) from those weights with the
    phoneme posterior's std at 1: K6 one a step and K8 forward and
    backward ``bv2_flash_sites`` a step over the run, derived from the
    code, and ``loss/kl_ph`` finite and non-zero every step. Returns
    ({phase: ok}, numbers)."""
    import math
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import Trainer, device_batch
    from diff_vits_tpu_torch.utils.init import init_random

    ok = {}
    cfg = _train_cfg(duration_predictor="sdp", use_flow=True,
                     use_phoneme_vae=True)
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    n_vae = sum(p.numel() for p in model.vits.phoneme_vae.parameters())
    log(f"bv2: reference_parity widths, sdp, residual-coupling flow, "
        f"phoneme VAE ({n_vae} of {n_params} parameters), random weights "
        "(seed 0)")
    syn = BatchSynthesizer(cfg, model.state_dict(), batch_size=8,
                           mel_buckets=(400, 800), dtype=torch.bfloat16,
                           device=dev)
    set_use_fused(syn.model, True)
    reqs = _requests(torch, torch.Generator().manual_seed(1), len(symbols),
                     syn.refer_frames)
    calls, handles = _count_path_calls(syn.model)
    ops.reset_launches()
    t0 = time.perf_counter()
    results = syn.synthesize_all(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for h in handles:
        h.remove()
    want = _want(calls)
    order_ok = [r[0] for r in results] == [r[0] for r in reqs]
    finite = all(np.isfinite(m).all() and m.ndim == 2 and m.shape[1] == 100
                 for _, m in results)
    launched = all(counts[k] > 0 for k in ("fused_rel_self_attention",
                                           "unconstrained_rqs"))
    ok["bv2_serve"] = order_ok and finite and launched and counts == want
    log(f"bv2 serve: {len(results)} requests in {wall:.3f} s (first call of "
        f"each bucket shape included); frames "
        f"{[m.shape[0] for _, m in results]}; launches {counts} (want "
        f"{want}); order {order_ok}; finite {finite}")

    gen = torch.Generator().manual_seed(2)
    syn.batch_size = 2
    batch = syn.pad_batch(reqs[:2], 128)
    noise = torch.randn(2, 400, 100, generator=gen).to(dev)
    dur_noise = torch.randn(2, 128, 2, generator=gen).to(dev)
    out, launches = {}, {}
    for route in (True, False):
        set_use_fused(model, route)
        ops.reset_launches()
        out[route] = synthesize(model, *batch, noise_scale=0.0, max_len=400,
                                init_noise=noise, dur_noise=dur_noise,
                                device=dev)
        launches[route] = ops.launch_counts()
    (mel_k, len_k), (mel_p, len_p) = out[True], out[False]
    err = (mel_k - mel_p).abs().max().item()
    ok["bv2_parity_fp32"] = (
        bool(torch.equal(len_k, len_p)) and err <= 5e-3
        and launches[True]["fused_rel_self_attention"] > 0
        and launches[True]["unconstrained_rqs"] > 0
        and not any(launches[False].values())
        and bool(torch.isfinite(mel_k).all()))
    log(f"bv2 parity fp32 (kernels vs plain, 2 utterances, 400 frames): "
        f"frames {len_k.tolist()} vs {len_p.tolist()}, max |diff| "
        f"{err:.3e} (gate 5e-3); launches {launches[True]} vs "
        f"{launches[False]}")
    del model
    short = [r for r in reqs if len(r[1]) <= 128]
    serving = serving_numbers(torch, syn, short, card, "bv2 serving")
    del syn
    torch.cuda.empty_cache()

    # from plain random weights the phoneme KL overflows at once (the
    # warm-up gap, ROADMAP Queue 3): one training forward, read, not gated
    raw = Trainer(cfg, [], device=dev)
    with torch.no_grad(), raw._autocast():
        _, (m, _, _) = raw.model(**device_batch(
            _bridge_batches(np, cfg, 1, seed=8)[0], True, dev),
            generator=raw.generator,
            mas_noise_scale=cfg.train.mas_noise_scale_initial)
    raw_kl_ph = float(m["loss/kl_ph"])
    del raw, m
    log(f"bv2 from plain random weights (seed 0): one training forward's "
        f"loss/kl_ph {raw_kl_ph} (the phoneme posterior's exp(log-std) "
        "overflows; the reference warms up 200k steps first, neither "
        "package does); training starts with that posterior's std at 1")
    steps = 5
    good, total, train, trainer, _ = train_run(
        torch, dev, card, cfg, "bv2 train (flash on)", use_flash=True,
        steps=steps,
        prepare=lambda model: unit_phoneme_posterior_std(torch, model))
    del trainer
    torch.cuda.empty_cache()
    sites = bv2_flash_sites(cfg)
    want = _train_want(total, steps, sites)
    kl_ph = [m["loss/kl_ph"] for m in train["losses"]]
    kl_ok = all(math.isfinite(v) and v != 0.0 for v in kl_ph)
    ok["bv2_train"] = good and total == want and kl_ok
    log(f"bv2 train: {steps} steps, launches {total} (want {want}: "
        f"{sites} gated calls a step, derived), loss/kl_ph {kl_ph} "
        f"(finite, non-zero {kl_ok}); median step "
        f"{train['step_s'] * 1e3:.1f} ms against the variant's "
        + (f"{variant_step_s * 1e3:.1f} ms" if variant_step_s else "(not run)")
        + f"; serving b=1 {serving['b1']['latency_s'] * 1e3:.1f} ms, b=8 "
        f"{serving['b8']['latency_s'] * 1e3:.1f} ms; card {card}")
    return ok, dict(card=card, n_params=n_params, n_vae_params=n_vae,
                    serve_wall_s=wall, launches=counts, want=want,
                    parity_max_abs=err, serving=serving, train=train,
                    train_launches=total, flash_sites_per_step=sites,
                    variant_step_s=variant_step_s, raw_init_kl_ph=raw_kl_ph)


# -- slice 13: rematerialisation, the MoE feed-forward, data parallelism ---

REMAT_POLICIES = ("none", "dots", "full")
REMAT_STEPS = 6     # 2 deterministic (compared), 1 warm-up, 3 timed
MOE = dict(moe_experts=4, moe_top_k=2)
MOE_TRAIN_STEPS = 3
DP_SAMPLING_STEPS = 10


def _grads(trainer):
    return [None if p.grad is None else p.grad.detach().clone()
            for p in trainer.params]


def _leaf_gap(a, b):
    """max over leaves of max |a - b| / max |b| (0 where both are None)."""
    worst = 0.0
    for x, y in zip(a, b):
        if x is None or y is None:
            if (x is None) != (y is None):
                return float("inf")
            continue
        scale = float(y.abs().max()) or 1.0
        worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def remat_phase(torch, dev, card, cfg=None, steps=REMAT_STEPS):
    """model3 at the training phase's configuration (``reference_parity``,
    B=32, bf16 autocast, EMA, the flash route on) under each
    ``train.remat_policy``: 2 steps under deterministic algorithms, whose
    losses, clipped gradients and parameters are compared with "none"'s
    (gates: losses within rel 1e-5, every gradient leaf within 1e-5 of its
    largest entry, parameters within 1e-6), then one step and ``steps`` -
    3 timed steps with the default algorithms: the median step time and
    the peak memory over them (``max_memory_allocated``; gate: "full"
    below "none"). The
    launches of the compared steps are derived from the code: one K6 a
    step; the K8 backward once and the K8 forward once ("none") or twice
    ("dots", "full": ``nn/remat`` recomputes the region that holds it) for
    each call through the flash gate in the forward (hooks; the recompute's
    calls counted apart). Returns ({phase: ok}, numbers)."""
    import dataclasses
    import itertools
    import math
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import Trainer

    cfg = cfg or _train_cfg()
    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    t_x = cfg.data.max_text_len * 2 + 1
    batches = list(itertools.islice(_train_batches(
        np, b, t_x, t_y, t_y * 2 // 3 + 1, len(symbols), seed=8), steps))
    ok, numbers, ref = {}, dict(card=card), None
    for policy in REMAT_POLICIES:
        tr = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, remat_policy=policy)), [], device=dev)
        recompute = [0]
        calls, handles = _flash_calls(tr.model, backward=recompute)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # cuBLAS's workspace alert
                losses, counts = _steps(tr, batches[:2])
        finally:
            torch.use_deterministic_algorithms(False)
        for h in handles:
            h.remove()
        grads = _grads(tr)
        params = [p.detach().clone() for p in tr.params]
        want = _train_want(counts, 2, calls[0] // 2)
        if policy != "none":
            want["flash_attention_forward"] *= 2
        tr.train_step(batches[2])     # the first with the default algorithms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for batch in batches[3:]:
            t0 = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        step_s = sorted(times)[len(times) // 2]
        finite = all(math.isfinite(v) for m in losses for v in m.values())
        row = dict(losses=losses, launches=counts, want=want,
                   gated_calls=calls[0], recompute_calls=recompute[0],
                   step_s=step_s, steps_s=times,
                   max_memory_allocated_GB=peak)
        if ref is None:
            ref = (losses, grads, params)
            gaps = (0.0, 0.0, 0.0)
        else:
            gaps = (max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                        for x, y in zip(losses, ref[0]) for k in y),
                    _leaf_gap(grads, ref[1]), _max_gap(params, ref[2]))
            row["bitwise"] = all(torch.equal(x, y)
                                 for x, y in zip(params, ref[2]))
        row["gap_to_none"] = dict(loss_rel=gaps[0], grad_rel=gaps[1],
                                  param_abs=gaps[2])
        ok[f"remat_{policy}"] = (finite and counts == want
                                 and calls[0] == 2 * FLASH_SITES_MODEL3
                                 and gaps[0] <= 1e-5 and gaps[1] <= 1e-5
                                 and gaps[2] <= 1e-6)
        numbers[policy] = row
        log(f"remat {policy}: 2 deterministic steps, losses "
            f"{[round(m['loss/all'], 4) for m in losses]}, against none: "
            f"loss rel {gaps[0]:.2e}, gradient {gaps[1]:.2e} of each leaf's "
            f"largest, params {gaps[2]:.2e} (bitwise "
            f"{row.get('bitwise', True)}); launches {counts} (want {want}: "
            f"{calls[0]} gated calls in the forwards, {recompute[0]} more "
            f"in the recomputes); median step {step_s * 1e3:.1f} ms of "
            f"{[round(t * 1e3, 1) for t in times]}, peak "
            f"{peak:.2f} GB; card {card}: "
            f"{'ok' if ok[f'remat_{policy}'] else 'FAIL'}")
        del tr, grads, params
        torch.cuda.empty_cache()
    peaks = {p: numbers[p]["max_memory_allocated_GB"] for p in REMAT_POLICIES}
    ok["remat_memory"] = peaks["full"] < peaks["none"]
    log(f"remat peak memory GB {peaks}, median step ms "
        f"{ {p: round(numbers[p]['step_s'] * 1e3, 1) for p in REMAT_POLICIES} }"
        f"; full below none: {ok['remat_memory']}; card {card}")
    return ok, numbers


def _moe_cfg(cfg):
    import dataclasses
    return dataclasses.replace(cfg, diffusion_encoder=dataclasses.replace(
        cfg.diffusion_encoder, **MOE))


def _moe_routes(model):
    """Forward pre-hooks on every ``MoEFeedForward`` of ``model``: a list
    that gets each call's top-k expert indices [B, T, k]. Returns (the
    list, hook handles)."""
    import torch
    from diff_vits_tpu_torch.parallel.moe import MoEFeedForward
    seen = []

    def hook(m, args):
        seen.append(torch.topk(m.gate(args[0]).float(),
                               min(m.top_k, m.num_experts), dim=-1).indices)
    return seen, [m.register_forward_pre_hook(hook) for m in model.modules()
                  if isinstance(m, MoEFeedForward)]


def moe_phase(torch, dev, card, dense=None, cfg=None, train_cfg=None):
    """model3 at ``reference_parity`` widths with the MoE feed-forward in
    every transformer block of the denoiser UNet (4 experts, top 2; random
    weights, seed 0). Serving (``BatchSynthesizer``, bf16, batch 8, mel
    bucket 400, 30-step UniPC) of the 6 short requests: launches derived
    from the UNet calls counted by hooks, the denoiser's and the duration
    predictor's apart (K1 22 a call of either; K2-K4 16 and the core 32 a
    duration-predictor call, none in the denoiser, whose MoE blocks take
    the plain route; K5 6 a TextEncoder call; 30 denoiser calls and one
    duration-predictor call a batch); the fp32 kernels against the plain
    route at b=1 and b=8 (injected initial noise, zero prior noise: equal
    frame counts; max |mel diff| <= 5e-3 on every item whose top-k expert
    choices are the same on both routes, and most items so: top-k routing
    is discontinuous, so rounding can move a near-tied token to another
    expert); latency at b=1 and 8; then
    ``MOE_TRAIN_STEPS`` training steps (flash on: K6 one and K8 40 + 40 a
    step, derived from the modules' gates). ``dense`` (dense model3's
    serving and training numbers of this run) is printed beside, with no
    claim. ``cfg`` / ``train_cfg`` stand in for ``reference_parity`` and
    the training phase's configuration (a CPU rehearsal at tiny widths).
    Returns ({phase: ok}, numbers)."""
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
    from diff_vits_tpu_torch.nn.layers import Encoder
    from diff_vits_tpu_torch.nn.unet1d import (
        UNet1DConditionModel, set_use_fused)
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random

    ok = {}
    cfg = _moe_cfg(cfg or load_config(str(ROOT / "configs" /
                                          "reference_parity.json")))
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = sum(p.numel() for n, p in model.named_parameters()
                if ".ff_moe." in n)
    syn = BatchSynthesizer(cfg, model.state_dict(), batch_size=8,
                           mel_buckets=(400,), dtype=torch.bfloat16,
                           device=dev)
    reqs = _requests(torch, torch.Generator().manual_seed(1), len(symbols),
                     syn.refer_frames)
    short = [r for r in reqs if len(r[1]) <= 128]
    den, h1 = _count_calls(syn.model.diff_model, UNet1DConditionModel,
                           lambda m, kw: int(kw.get("embedding_request")
                                             is None))
    dpu, h2 = _count_calls(syn.model.vits.dp, UNet1DConditionModel,
                           lambda m, kw: 1)
    layers, h3 = _count_calls(syn.model, Encoder, lambda m, kw: m.n_layers)
    ops.reset_launches()
    t0 = time.perf_counter()
    results = syn.synthesize_all(short, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for h in h1 + h2 + h3:
        h.remove()
    n_den, n_dp = den[0], dpu[0]
    want = dict.fromkeys(counts, 0)
    want.update(fused_resnet_block=PER_UNET["fused_resnet_block"]
                * (n_den + n_dp),
                fused_self_attention=PER_UNET["fused_self_attention"] * n_dp,
                fused_cross_attention=PER_UNET["fused_cross_attention"]
                * n_dp,
                fused_geglu_ff=PER_UNET["fused_geglu_ff"] * n_dp,
                attention=PER_UNET["attention"] * n_dp,
                fused_rel_self_attention=layers[0])
    derived = (n_den, n_dp, layers[0]) == (30, 1, cfg.vits.n_layers)
    finite = all(np.isfinite(m).all() and m.shape[1] == 100
                 for _, m in results)
    ok["moe_serve"] = (counts == want and derived and finite and
                       [r[0] for r in results] == [r[0] for r in short])
    log(f"moe serve: {n_params} parameters ({n_moe} in the experts), "
        f"{len(results)} requests in {wall:.3f} s (first call included); "
        f"UNet calls denoiser {n_den}, duration predictor {n_dp}, encoder "
        f"layers {layers[0]} (derived 30 / 1 / {cfg.vits.n_layers}: "
        f"{derived}); launches {counts} (want {want}); finite {finite}")

    errs, rerouted = {}, {}
    for b in (1, 8):
        syn.batch_size = b
        args = syn.pad_batch(short[:b], 128)
        noise = torch.randn(b, 400, 100,
                            generator=torch.Generator().manual_seed(b)).to(dev)
        out, routes = {}, {}
        for route in (True, False):
            set_use_fused(model, route)
            routes[route], handles = _moe_routes(model)
            out[route] = synthesize(model, *args, noise_scale=0.0,
                                    max_len=400, init_noise=noise,
                                    device=dev)
            for h in handles:
                h.remove()
        set_use_fused(model, True)
        (mel_k, len_k), (mel_p, len_p) = out[True], out[False]
        # top-k routing is discontinuous: an item whose gate logits tie to
        # within the routes' rounding may pick another expert on one route
        # (its mel then differs by more than rounding); the gate holds the
        # items routed alike on both, and needs most of them
        same = [all(torch.equal(x[i], y[i])
                    for x, y in zip(routes[True], routes[False]))
                for i in range(b)]
        diff = (mel_k - mel_p).abs().amax(dim=(1, 2)).tolist()
        errs[f"b{b}"] = max(d for d, s_ in zip(diff, same) if s_) \
            if any(same) else float("inf")
        rerouted[f"b{b}"] = {i: diff[i] for i in range(b) if not same[i]}
        ok[f"moe_parity_fp32_b{b}"] = (bool(torch.equal(len_k, len_p))
                                       and sum(same) * 2 > b
                                       and errs[f"b{b}"] <= 5e-3
                                       and bool(torch.isfinite(mel_k).all()))
    log(f"moe parity fp32 (kernels vs plain, 400 frames, 30 steps): max "
        f"|mel diff| over the items routed alike on both routes {errs} "
        f"(gate 5e-3); items another expert took on one route, with their "
        f"max |mel diff| {rerouted}")
    del model
    serving = serving_numbers(torch, syn, short, card, what="moe serving")
    del syn
    torch.cuda.empty_cache()

    good, total, train, trainer, _ = train_run(
        torch, dev, card, _moe_cfg(train_cfg or _train_cfg()),
        "moe train (flash on)", use_flash=True, steps=MOE_TRAIN_STEPS)
    del trainer
    torch.cuda.empty_cache()
    want_train = _train_want(total, MOE_TRAIN_STEPS, FLASH_SITES_MODEL3)
    ok["moe_train"] = good and total == want_train
    line = (f"moe against dense model3 (no claim): serving b=1 "
            f"{serving['b1']['latency_s'] * 1e3:.1f} ms, b=8 "
            f"{serving['b8']['latency_s'] * 1e3:.1f} ms, training step "
            f"{train['step_s'] * 1e3:.1f} ms, peak "
            f"{train['max_memory_allocated_GB']:.2f} GB")
    if dense is not None:
        line += (f"; dense b=1 {dense['b1'] * 1e3:.1f} ms, b=8 "
                 f"{dense['b8'] * 1e3:.1f} ms, step "
                 f"{dense['step_s'] * 1e3:.1f} ms, peak "
                 f"{dense['peak_GB']:.2f} GB")
    log(f"moe train: {MOE_TRAIN_STEPS} steps, launches {total} (want "
        f"{want_train}); {line}; card {card}")
    return ok, dict(card=card, n_params=n_params, n_expert_params=n_moe,
                    launches=counts, want=want, parity_max_abs=errs,
                    serving=serving, train=train, train_launches=total,
                    dense=dense)


def _exact_float32(torch):
    """float32 products in float32 (no TF32), as every phase runs them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _exact(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with float32 products exact
    (:func:`_exact_float32`; a spawned rank starts with PyTorch's defaults,
    under which cuDNN convolutions take TF32) and under
    ``torch.use_deterministic_algorithms``."""
    import torch
    _exact_float32(torch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # cuBLAS's workspace alert
            return fn(*args, **kwargs)
    finally:
        torch.use_deterministic_algorithms(False)


def _seeded_state(cfg, seed):
    """The state dict of a ``DiffVits(cfg)`` on the CPU with
    ``init_random`` weights from ``seed`` (``Trainer``'s initial ones for
    ``seed = train.seed``)."""
    import torch
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random
    model = DiffVits(cfg, len(symbols), device="cpu")
    init_random(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def _seeded_serve(cfg, seed, requests, device, **kw):
    """``parallel.launch.serve`` of ``requests`` on the weights
    :func:`_seeded_state` makes (built where it runs: nothing to send)."""
    from diff_vits_tpu_torch.parallel import launch
    return launch.serve(cfg, _seeded_state(cfg, seed), requests, device,
                        **kw)


def dp_nccl_phase(torch, dev, card, n_utts=40, cfg=None):
    """Data parallelism (``parallel.mesh``) over NCCL with one rank (a
    spawned process group of one, as torchrun on one card gives), through
    the command lines: ``train.cli`` at ``configs/multi_chip_dp.json``
    (its mesh (4,) falls back to the one rank; model3 widths, B=32, bf16)
    on ``n_utts`` seeded utterances for 2 steps and ``--resume auto`` to
    3, then ``serve --dp`` of 4 EN rows from its checkpoint (batch 4, mel
    bucket 400, 10-step UniPC, float32): the steps reached, rank 0's
    checkpoint, finite mels. Multi-GPU speed is not measured: the machine
    has one card. On the CPU (a rehearsal; ``cfg`` at tiny widths in place
    of ``multi_chip_dp.json``) the rank is a gloo one. Returns ({phase:
    ok}, numbers)."""
    import contextlib
    import dataclasses
    import io
    import tempfile
    import numpy as np
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.data import preprocess
    from diff_vits_tpu_torch.infer import serve
    from diff_vits_tpu_torch.parallel import launch

    ok, numbers = {}, dict(card=card)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    d = Path(tmp.name)
    _write_train_corpus(np, d / "raw", n_utts)
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess.main(["--in_dir", str(d / "raw"), "--out_dir",
                         str(d / "data"), "--language", "EN", "--cleaned",
                         "--no_spec"])
    cfg = cfg or load_config(str(ROOT / "configs" / "multi_chip_dp.json"))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, training_files=str(
            d / "data"), val_files=str(d / "data")),
        train=dataclasses.replace(cfg.train, save_and_sample_every=2))
    cfg_path = d / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    workdir = d / "run"
    cuda = dev.type == "cuda"
    device = [] if cuda else ["--device", str(dev)]
    train_args = ["-c", str(cfg_path), "--workdir", str(workdir),
                  "--log_every", "1", *device]
    manifest = d / "utts.tsv"
    wav = _write_prompt_wav(np, d / "prompt.wav")
    texts = ["Hello world.", "A second row, a little longer than the first.",
             "Three.", "The fourth row of the manifest for the two ranks."]
    manifest.write_text("".join(f"u{i}\t{t}\tEN\t{wav}\n"
                                for i, t in enumerate(texts)))
    serve_args = ["--manifest", str(manifest), "-c", str(cfg_path), "-m",
                  str(workdir / "model-2.ckpt"), "--batch_size", "4",
                  "--mel_buckets", "400", "--steps",
                  str(DP_SAMPLING_STEPS), "--dtype", "float32", "--dp",
                  "--out_dir", str(d / "mels"), *device]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (res,) = launch.run_ranks(launch.calls, 1, [
        (launch.train_cli, (train_args + ["--steps", "2"],)),
        (launch.train_cli, (train_args + ["--steps", "3", "--resume",
                                          "auto"],)),
        (serve.main, (serve_args,))], backend="nccl" if cuda else "gloo",
        timeout=600)
    numbers["nccl_one_rank_wall_s"] = time.perf_counter() - t0
    (step2, saved2), (step3, saved3), _ = res
    mels = sorted((d / "mels").glob("*.mel.npy"))
    finite = len(mels) == len(texts) and all(
        np.isfinite(np.load(m)).all() for m in mels)
    ok["dp_nccl_cli"] = (step2 == 2 and step3 == 3
                         and saved2 == [str(workdir / "model-2.ckpt")]
                         and saved3 == [str(workdir / "model-3.ckpt")]
                         and finite)
    log(f"dp NCCL one rank: train.cli at multi_chip_dp.json to steps "
        f"{step2} and (resumed) {step3}, checkpoints {saved2 + saved3}; "
        f"serve --dp wrote {len(mels)} finite mels {finite}; "
        f"{numbers['nccl_one_rank_wall_s']:.1f} s wall (spawn and build "
        f"included): {'ok' if ok['dp_nccl_cli'] else 'FAIL'}")
    tmp.cleanup()
    return ok, numbers


def dp_gloo_phase(torch, dev, card, cfg=None):
    """Two data-parallel ranks on the one card over gloo (NCCL refuses two
    ranks on one device), each on ``dev``: one ``Trainer`` step at
    ``cfg`` (default the training phase's ``reference_parity``: B=32
    global, 16 a rank) in float32 with lr 1e-2 and eps 1e-2 (the update
    follows the gradient's value) under deterministic algorithms, against
    one process's step on the whole batch with the same draws
    (``parallel.launch.train_step``; gates: the losses, global means over
    the ranks, within rel 1e-5 of the whole batch's, which a per-rank
    normaliser would miss by far more; parameters within 1e-4, 1% of the
    step's lr, as batches of 16 and 32 round the products differently and
    a ReLU input within that rounding of 0 takes the other branch, as the
    flash gradient phase shows; the ranks bitwise equal), and
    ``BatchSynthesizer(dp=True)`` of 4 requests (batch 4, 2 a rank,
    float32, 10-step UniPC) against one process (equal frame counts, max
    |mel diff| <= 5e-3, the parity gate of serving). Returns ({phase: ok},
    numbers)."""
    import dataclasses
    import numpy as np
    from diff_vits_tpu_torch.parallel import launch
    from diff_vits_tpu_torch.text.symbols import symbols

    ok, numbers = {}, dict(card=card)
    cfg = cfg or _train_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="float32", train_lr=1e-2, eps=1e-2))
    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    batch = next(_train_batches(np, b, cfg.data.max_text_len * 2 + 1, t_y,
                                t_y * 2 // 3 + 1, len(symbols), seed=8))
    state = _seeded_state(cfg, cfg.train.seed)
    reqs = _requests(torch, torch.Generator().manual_seed(1), len(symbols),
                     cfg.data.max_mel_len * 2 // 3 + 1)[:4]
    kw = dict(batch_size=4, mel_buckets=(400,), steps=DP_SAMPLING_STEPS,
              dtype=torch.float32)
    jobs = [(_exact, (launch.train_step, cfg, [batch], str(dev))),
            (_exact, (_seeded_serve, cfg, cfg.train.seed, reqs, str(dev)),
             kw)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_ranks(launch.calls, 2, jobs, backend="gloo",
                             timeout=600)
    numbers["gloo_two_ranks_wall_s"] = time.perf_counter() - t0
    one = launch.calls(jobs)
    (p0, m0), (p1, m1) = ranks[0][0], ranks[1][0]
    (p_one, m_one) = one[0]
    gap = max(float(np.abs(p0[n] - p_one[n]).max()) for n in p_one)
    ranks_equal = all(np.array_equal(p0[n], p1[n]) for n in p0)
    loss_gap = max(abs(m0[k] - m_one[k]) / max(abs(m_one[k]), 1e-12)
                   for k in m_one)
    moved = sum(not np.array_equal(p_one[n], state[n].numpy())
                for n in p_one)
    ok["dp_gloo_train"] = (gap <= 1e-4 and loss_gap <= 1e-5 and ranks_equal
                           and moved > len(p_one) // 2)
    mels_dp, mels_one = ranks[0][1], one[1]
    lens = [(a[1].shape, c[1].shape) for a, c in zip(mels_dp, mels_one)]
    mel_err = max(float(np.abs(a[1] - c[1]).max())
                  for a, c in zip(mels_dp, mels_one))
    ok["dp_gloo_serve"] = (all(x == y for x, y in lens) and mel_err <= 5e-3
                           and [r[0] for r in mels_dp] == [r[0] for r in reqs])
    numbers.update(param_gap=gap, loss_rel_gap=loss_gap,
                   ranks_equal=ranks_equal, mel_max_abs=mel_err,
                   metrics_two_ranks=m0, metrics_one=m_one)
    log(f"dp gloo two ranks on {dev}: one step (B={b}, {b // 2} a rank, "
        f"float32, deterministic algorithms) against one process: params "
        f"max |diff| {gap:.2e} (gate 1e-4), losses rel {loss_gap:.2e} "
        f"(gate 1e-5), "
        f"ranks bitwise equal {ranks_equal}, {moved} of {len(p_one)} "
        f"tensors moved; serve --dp mels max |diff| {mel_err:.2e} (gate "
        f"5e-3), frame counts equal "
        f"{all(x == y for x, y in lens)}; "
        f"{numbers['gloo_two_ranks_wall_s']:.1f} s wall; card {card}. "
        "Multi-GPU speed: not measured (one card)")
    return ok, numbers



# -- slice 15: the state sharded over model, fsdp and expert ---------------

# (axes, shape, MoE experts): the meshes the shard phase trains on
SHARD_BATCH = 16
SHARD_MESHES = ((("data", "model"), (1, 2), 0),
                (("data", "fsdp"), (1, 2), 0),
                (("data", "expert"), (1, 2), 4))


def _shard_cfgs(cfg, axes, shape, moe):
    """(the float32 config of a shard step, its bfloat16 twin): ``cfg`` on
    the mesh, lr and eps 1e-2 as the dp phase has them, ``moe`` experts."""
    import dataclasses
    diff = dataclasses.replace(cfg.diffusion_encoder,
                               **(dict(MOE, moe_experts=moe) if moe else {}))
    out = []
    for dtype in ("float32", "bfloat16"):
        out.append(dataclasses.replace(
            cfg, diffusion_encoder=diff, train=dataclasses.replace(
                cfg.train, compute_dtype=dtype, train_lr=1e-2, eps=1e-2,
                mesh_axes=axes, mesh_shape=shape)))
    return tuple(out)


def _shard_rank(cfg, batch, device, bf16_cfg):
    """One rank of the shard phase: ``parallel.launch.train_step`` of
    ``cfg`` (float32, under :func:`_exact`) with its step timed alone (the
    whole parameters' gather after it not included), the peak memory of
    the step, the kernel launches of the step, and the [B, H, T, d] and S
    of each K8 forward; then one step of ``bf16_cfg`` for its loss. The
    whole parameters come back from rank 0 only."""
    import torch
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.ops import flash_attention as FA
    from diff_vits_tpu_torch.parallel import launch
    seen, out = [], {}
    flash = FA.FlashSDPA

    class Recorded:         # what ``sdpa`` calls on the card
        @staticmethod
        def apply(q, k, *args):
            seen.append((tuple(q.shape), int(k.shape[2])))
            return flash.apply(q, k, *args)

    def hook(tr):
        step = tr.train_step

        def timed(b):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            seen.clear()
            t0 = time.perf_counter()
            metrics = step(b)
            torch.cuda.synchronize()
            out.update(step_s=time.perf_counter() - t0,
                       launches=ops.launch_counts(), k8_shapes=list(seen),
                       peak_GB=torch.cuda.max_memory_allocated() / 1e9)
            return metrics
        tr.train_step = timed
    FA.FlashSDPA = Recorded
    try:
        params, metrics, info = _exact(launch.train_step, cfg, [batch],
                                       device, None, 1 << 16, True, hook)
    finally:
        FA.FlashSDPA = flash
    _, bf16 = launch.train_step(bf16_cfg, [batch], device)
    return dict(out, metrics=metrics, info=info, bf16_loss=bf16["loss/all"],
                params=params if info["rank"] == 0 else None)


def _rule_shapes(cfg, mesh_):
    """Parameter name -> (the rank-local shape ``parallel.mesh``'s rules
    give on ``mesh_`` at JAX's min_size, the whole shape), from
    ``DiffVits(cfg)`` on the meta device."""
    import math
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    from diff_vits_tpu_torch.parallel import mesh
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.convert import flax_leaves
    model = DiffVits(cfg, len(symbols), device="meta")
    params = dict(model.named_parameters())
    walk = flax_leaves(model)
    flat = {path: tuple(params[n].shape[d] for d in dims)
            for n, (path, dims) in walk.items()}
    specs = mesh.state_sharding_rules(mesh_, flat)
    out = {}
    for n, (path, dims) in walk.items():
        local = list(params[n].shape)
        for i, a in enumerate(specs[path]):
            if a:
                local[dims[i]] //= mesh_[a]
        out[n] = (tuple(local), tuple(params[n].shape))
    assert all(math.prod(w) > 0 for _, w in out.values())
    return out


def _k8_local_heads(torch, dev, shapes, what="shard K8 at the local heads"):
    """K8 forward and backward at the rank-local shapes ``shapes`` ((B, H,
    T, d), S) against ``sdpa_plain`` and autograd of it on the same inputs
    (float32 and bfloat16, a ragged key mask; gates ``TOL``), logged as
    ``what``. Returns (ok, rows)."""
    from diff_vits_tpu_torch.ops import flash_attention as FA
    ok, rows = True, []
    gen = torch.Generator(device=dev).manual_seed(15)
    for (b, h, t, d), s in shapes:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev)
                       .to(dtype) for n in (t, s, s))
            lengths = torch.tensor([max(1, s - (s * i) // b)
                                    for i in range(b)], device=dev)
            keep = torch.arange(s, device=dev)[None] < lengths[:, None]
            scale = d ** -0.5
            o, lse = FA.flash_attention_forward(q, k, v, keep, scale)
            do = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
            grads = FA.flash_attention_backward(q, k, v, o, lse, do, keep,
                                                scale)
            ref_o, ref_lse = FA.sdpa_plain(q, k, v, keep, sm_scale=scale,
                                           with_lse=True)
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(
                FA.sdpa_plain(*leaves, keep, sm_scale=scale), leaves, do)
            errs = {"o": _rel_err(o, ref_o)[1], "lse": _rel_err(lse,
                                                               ref_lse)[1]}
            errs.update({f"d{n}": _rel_err(g, a)[1]
                         for n, g, a in zip("qkv", grads, auto)})
            good = all(e <= TOL[dname] for e in errs.values())
            ok &= good
            rows.append(dict(shape=[b, h, t, s, d], dtype=dname, errors=errs,
                             ok=good))
            log(f"{what} B={b} H={h} T={t} S={s} d={d}"
                f" {dname}: " + " ".join(f"{k}={v:.2e}"
                                         for k, v in errs.items())
                + f" (gate {TOL[dname]:g}) {'ok' if good else 'FAIL'}")
    return ok, rows


def shard_phase(torch, dev, card, cfg=None):
    """Training with the state sharded as JAX's ``state_sharding_rules``
    shard it (``parallel.sharding``): two gloo ranks on the one card (NCCL
    refuses two ranks on one device), one ``Trainer`` step each at ``cfg``
    (default ``reference_parity``, B = :data:`SHARD_BATCH`) on the meshes of
    :data:`SHARD_MESHES` (``model`` 2: Megatron tensor parallelism;
    ``fsdp`` 2: ZeRO-3, 8 rows a rank; ``expert`` 2 with the MoE
    feed-forward, 4 experts top 2). Each float32 step against one
    process's step on the whole batch on the card (gates: every loss
    within rel 1e-5, parameters within 1e-4), then a bfloat16 step's loss
    finite. Per rank: the held parameters, moments and EMA against the
    rules' local shapes and bytes (the prediction), the step's peak memory
    and time, the K6 and K8 launches (one K6; K8 forward and backward the
    same count), the K8 shapes (the ``model`` mesh's split sites at H = 4
    of 8, the other meshes' at 8). K8 forward and backward at the
    rank-local shapes against ``sdpa_plain``. Step time over gloo through
    the host is no speed measure. On the CPU (``cfg`` at tiny widths, a
    rehearsal) the launch and route gates fail. Returns ({phase: ok},
    numbers)."""
    import dataclasses
    import numpy as np
    from diff_vits_tpu_torch.parallel import launch
    from diff_vits_tpu_torch.text.symbols import symbols

    ok, numbers = {}, dict(card=card, meshes={})
    if cfg is None:     # B = 16 since PR 16 (32 before), for the time limit
        cfg = _train_cfg()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, train_batch_size=SHARD_BATCH))
    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    batch = next(_train_batches(np, b, cfg.data.max_text_len * 2 + 1, t_y,
                                t_y * 2 // 3 + 1, len(symbols), seed=8))
    cfgs = [_shard_cfgs(cfg, *m) for m in SHARD_MESHES]
    jobs = [(_shard_rank, (f32, batch, str(dev), b16)) for f32, b16 in cfgs]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_ranks(launch.calls, 2, jobs, backend="gloo",
                             timeout=900)
    numbers["gloo_two_ranks_wall_s"] = time.perf_counter() - t0
    one = {}
    local_shapes = set()
    for i, ((axes, shape, moe), (f32, _)) in enumerate(zip(SHARD_MESHES,
                                                           cfgs)):
        name = "x".join(f"{a}{s}" for a, s in zip(axes, shape))
        if moe not in one:
            one[moe] = _exact(launch.train_step, f32, [batch], str(dev))
        p_one, m_one = one[moe]
        r0, r1 = ranks[0][i], ranks[1][i]
        gap = max(float(np.abs(r0["params"][n] - p_one[n]).max())
                  for n in p_one)
        loss_gap = max(abs(r["metrics"][k] - m_one[k])
                       / max(abs(m_one[k]), 1e-12)
                       for r in (r0, r1) for k in m_one)
        mesh_ = dict(zip(axes, shape))
        rules = _rule_shapes(f32, mesh_)
        copies = 4 if f32.train.use_ema else 3      # param, 2 moments, EMA
        predicted = sum(4 * copies * int(np.prod(loc))
                        for loc, _ in rules.values())
        whole_bytes = sum(4 * copies * int(np.prod(w))
                          for _, w in rules.values())
        good = gap <= 1e-4 and loss_gap <= 1e-5
        per_rank = []
        for r in (r0, r1):
            info = r["info"]
            shapes_ok = all(set(sh.values()) == {rules[n][0]}
                            for n, sh in info["shapes"].items())
            heads = sorted({q[1] for q, _ in r["k8_shapes"]})
            launches = r["launches"]
            k8 = launches["flash_attention_forward"]
            launch_ok = (launches["maximum_path"] == 1 and k8 > 0
                         and launches["flash_attention_backward"] == k8
                         and k8 == len(r["k8_shapes"]))
            heads_ok = (heads == [4, 8] if "model" in axes else heads == [8])
            finite = bool(np.isfinite(r["bf16_loss"]))
            # the rules' bytes of what the rank holds (a moment once its
            # parameter has had a gradient)
            held_rules = sum(4 * len(sh) * int(np.prod(rules[n][0]))
                             for n, sh in info["shapes"].items())
            good &= (shapes_ok and info["held_bytes"] == held_rules
                     and launch_ok and heads_ok and finite)
            if "model" in axes:
                local_shapes |= {(tuple(q), s) for q, s in r["k8_shapes"]
                                 if q[1] == 4}
            per_rank.append(dict(
                coords=info["coords"], held_bytes=info["held_bytes"],
                held_rules_bytes=held_rules, predicted_bytes=predicted,
                whole_bytes=whole_bytes,
                shapes_ok=shapes_ok, peak_GB=r["peak_GB"],
                step_s=r["step_s"], k6=launches["maximum_path"],
                k8_forward=k8, k8_backward=launches[
                    "flash_attention_backward"],
                k8_heads=heads, k8_shapes=r["k8_shapes"],
                sites=len(info["sites"]), bf16_loss=r["bf16_loss"]))
            log(f"shard {name} rank {info['rank']} {info['coords']}: held "
                f"{info['held_bytes']} B (the rules' bytes of the tensors "
                f"held {held_rules}; predicted with every moment "
                f"{predicted}, whole {whole_bytes}; shapes {shapes_ok}), "
                f"{len(info['sites'])} sites on their "
                f"shards, step {r['step_s']:.3f} s, peak "
                f"{r['peak_GB']:.2f} GB, K6 {launches['maximum_path']}, "
                f"K8 {k8} + {launches['flash_attention_backward']} at H "
                f"{heads}, bf16 loss {r['bf16_loss']:.4f}; card {card}")
        ok[f"shard_{name}"] = good
        numbers["meshes"][name] = dict(
            param_gap=gap, loss_rel_gap=loss_gap, ranks=per_rank,
            metrics_one=m_one, metrics_rank0=r0["metrics"])
        log(f"shard {name} (B={b}, float32, deterministic algorithms) "
            f"against one process: params max |diff| {gap:.2e} (gate 1e-4)"
            f", losses rel {loss_gap:.2e} (gate 1e-5): "
            f"{'ok' if good else 'FAIL'}; card {card}")
    ok["shard_k8_local_heads"], numbers["k8_local_heads"] = _k8_local_heads(
        torch, dev, sorted({(q, s) for q, s in local_shapes}))
    ok["shard_k8_local_heads"] &= bool(local_shapes)
    log(f"shard phase: {numbers['gloo_two_ranks_wall_s']:.1f} s wall for the"
        f" ranks (spawn and 6 trainers included); card {card}. Step time "
        "over gloo on one card is no speed measure; multi-GPU NCCL speed: "
        "not measured (one card)")
    return ok, numbers


SEQ_FRAMES = 800        # a long mel: what sequence parallelism is for
SEQ_BATCH = 8
SEQ_SELF_SITES = 16     # the denoiser UNet's self-attention sites
SEQ_RANKS = 2
PIPE_MICRO = 4


def _seq_unet(cfg, device):
    """model3's denoiser UNet on ``device`` with random weights from seed
    4, in eval mode (the fused routes)."""
    import torch
    from diff_vits_tpu_torch.models.diffusion_encoder import (
        DiffusionEncoder)
    from diff_vits_tpu_torch.utils.init import init_random
    enc = DiffusionEncoder(cfg.diffusion_encoder, device="cpu",
                           content_channels=cfg.vits.inter_channels)
    init_random(enc, torch.Generator().manual_seed(4))
    return enc.unet.to(device).eval()


def _seq_unet_inputs(torch, cfg, device):
    """x [B, T, C_in], t [B], prompt keys [B, S, C] and keep [B, S] from
    seed 5: B = 8, T = :data:`SEQ_FRAMES`, S = 267 (ragged)."""
    gen = torch.Generator().manual_seed(5)
    unet_in = cfg.diffusion_encoder.in_channels + cfg.vits.inter_channels
    x = torch.randn(SEQ_BATCH, SEQ_FRAMES, unet_in, generator=gen)
    t = torch.randint(0, cfg.train.timesteps, (SEQ_BATCH,), generator=gen)
    ctx = torch.randn(SEQ_BATCH, 267, cfg.diffusion_encoder.hidden_channels,
                      generator=gen)
    keep = torch.arange(267)[None] < torch.tensor(
        [267 - 25 * i for i in range(SEQ_BATCH)])[:, None]
    return [a.to(device) for a in (x, t, ctx, keep)]


@contextlib.contextmanager
def _ring_blocks():
    """Inside the block, the [B, H, T, d] and S of each ring block (a K8
    forward launch of the ring) are appended to the list it yields."""
    from diff_vits_tpu_torch.parallel import ring_attention as RA
    seen = []
    block = RA._block

    def recorded(q, k, *args):
        seen.append((tuple(q.shape), int(k.shape[2])))
        return block(q, k, *args)
    RA._block = recorded
    try:
        yield seen
    finally:
        RA._block = block


def _seq_forward(torch, unet, inputs, dtype, reps=3):
    """The UNet forward on ``inputs`` in ``dtype`` (no gradient): (this
    call's output, launches of the first call, ring block shapes, median
    wall s of ``reps`` more, peak GB) in the active scope."""
    from diff_vits_tpu_torch import ops
    unet = unet.to(dtype)
    x, t, ctx, keep = inputs
    args = (x.to(dtype), t, ctx.to(dtype), keep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.no_grad(), _ring_blocks() as blocks:
        out = unet(*args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        shapes = list(blocks)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            unet(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    return (out.float(), counts, shapes, sorted(walls)[reps // 2],
            torch.cuda.max_memory_allocated() / 1e9)


def _seq_rank(cfg, batch, one_step_cfg, device):
    """One rank of the seq_parallel phase (both ranks on the one card):
    model3's denoiser UNet forward at T = 800 inside the scope in float32
    and bfloat16 (this rank's frames gathered whole; launches, ring block
    shapes, time, peak); then one ``Trainer`` step with
    ``sequence_parallel`` and ZeRO-3 over ``seq`` in float32 (under
    :func:`_exact`) and one in bfloat16, each with its launches, ring
    blocks, time and peak."""
    import torch
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.parallel import activations, launch, mesh
    from diff_vits_tpu_torch.parallel import sharding
    _exact_float32(torch)
    dev = torch.device(device)
    layout = sharding.Layout(mesh.make_mesh(None, ("seq",)), mesh.rank())
    out = {}
    unet = _seq_unet(cfg, dev)
    inputs = _seq_unet_inputs(torch, cfg, dev)
    with activations.sequence_parallel(layout):
        seq = activations.shard(SEQ_FRAMES, len(unet.block_out_channels))
        for dname in ("float32", "bfloat16"):
            y, counts, shapes, wall, peak = _seq_forward(
                torch, unet, inputs, getattr(torch, dname))
            out[dname] = dict(out=seq.gather(y).cpu().numpy(),
                              launches=counts,
                              ring=shapes, wall_s=wall, peak_GB=peak,
                              frames=seq.stop - seq.start)
    del unet
    torch.cuda.empty_cache()
    for dname, step_cfg in (("train_float32", cfg), ("train_bfloat16",
                                                     one_step_cfg)):
        rec = {}

        def hook(tr, rec=rec):
            step = tr.train_step

            def timed(b):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                with _ring_blocks() as blocks:
                    metrics = step(b)
                    torch.cuda.synchronize()
                    rec.update(step_s=time.perf_counter() - t0,
                               launches=ops.launch_counts(),
                               ring=list(blocks),
                               peak_GB=torch.cuda.max_memory_allocated()
                               / 1e9)
                return metrics
            tr.train_step = timed
        args = (launch.train_step, step_cfg, [batch], device, None, 1 << 16,
                False, hook, "seq", True)
        params, metrics = (_exact(*args) if dname == "train_float32"
                           else args[0](*args[1:]))
        out[dname] = dict(rec, metrics=metrics,
                          params=params if mesh.rank() == 0 and
                          dname == "train_float32" else None)
    return out


def seq_parallel_phase(torch, dev, card, cfg=None):
    """Sequence parallelism (``parallel.activations``, the ring of
    ``parallel.ring_attention``): two gloo ranks on the one card, model3
    at ``cfg`` (default ``reference_parity``) widths. The denoiser UNet
    (eval mode: K1 with halos and merged statistics, K2 with the ring
    core, K3, K4) at B = 8 and a long mel, T = :data:`SEQ_FRAMES` (400
    frames a rank), in float32 and bfloat16, each rank's frames gathered
    against one process's forward on the card (gates ``TOL`` of max
    |plain|); each rank's launches of the float32 forward: K1 22, K2 16,
    K3 16, K4 16 (the UNet's own), the attention core 16 (cross only) and
    K8 :data:`SEQ_RANKS` forward launches at each of the 16 self-attention
    sites (the ring's blocks), no backward. Then one ``Trainer`` step
    (B = 8, T = 800 mel frames, ZeRO-3 over ``seq``, ``sequence_parallel``)
    in float32 against one process's step (loss rel 1e-4, parameters
    1e-4), its ring: 2 K8 forward and 2 backward launches at each of the
    16 self sites; a bfloat16 step's loss finite. K8 forward and backward
    at the ring's block shapes against ``sdpa_plain``. Prints each rank's
    peak memory and time. Returns ({phase: ok}, numbers)."""
    import dataclasses
    import numpy as np
    from diff_vits_tpu_torch.parallel import launch
    from diff_vits_tpu_torch.text.symbols import symbols
    ok, numbers = {}, dict(card=card)
    cfg = cfg or _train_cfg()
    n = SEQ_RANKS
    train = dict(train_batch_size=SEQ_BATCH, train_lr=1e-2, eps=1e-2,
                 mesh_axes=("seq",), mesh_shape=(n,))
    f32 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="float32", **train))
    b16 = dataclasses.replace(f32, train=dataclasses.replace(
        f32.train, compute_dtype="bfloat16"))
    batch = next(_train_batches(np, SEQ_BATCH, cfg.data.max_text_len * 2 + 1,
                                SEQ_FRAMES, 267, len(symbols), seed=9))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_ranks(_seq_rank, n, f32, batch, b16, str(dev),
                             backend="gloo", timeout=900)
    numbers["ranks_wall_s"] = time.perf_counter() - t0
    # one process on the card
    unet = _seq_unet(cfg, dev)
    inputs = _seq_unet_inputs(torch, cfg, dev)
    one = {}
    for dname in ("float32", "bfloat16"):
        y, counts, _, wall, peak = _seq_forward(torch, unet, inputs,
                                                getattr(torch, dname))
        one[dname] = dict(out=y.cpu().numpy(), launches=counts,
                          wall_s=wall, peak_GB=peak)
    del unet
    torch.cuda.empty_cache()
    one_cfg = dataclasses.replace(f32, train=dataclasses.replace(
        f32.train, mesh_axes=("data",), mesh_shape=None))
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    p_one, m_one = _exact(launch.train_step, one_cfg, [batch], str(dev))
    one["train_s"] = time.perf_counter() - t1
    one["train_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    want_fwd = {"fused_resnet_block": 22, "fused_self_attention": 16,
                "fused_cross_attention": 16, "fused_geglu_ff": 16,
                "attention": 16, "flash_attention_forward": n * SEQ_SELF_SITES,
                "flash_attention_backward": 0}
    ring_shapes = set()
    per_rank = []
    good_fwd = good_train = True
    for r, got in enumerate(ranks):
        errs = {}
        for dname in ("float32", "bfloat16"):
            errs[dname] = _rel_err(torch.from_numpy(got[dname]["out"]),
                                   torch.from_numpy(one[dname]["out"]))[1]
            ring_shapes |= set(got[dname]["ring"])
        counts = got["float32"]["launches"]
        counts_ok = all(counts[k] == v for k, v in want_fwd.items())
        fwd_ok = (counts_ok and errs["float32"] <= TOL["float32"]
                  and errs["bfloat16"] <= TOL["bfloat16"]
                  and len(got["float32"]["ring"]) == n * SEQ_SELF_SITES)
        good_fwd &= fwd_ok
        tr = got["train_float32"]
        loss_gap = abs(tr["metrics"]["loss/all"] - m_one["loss/all"]) / abs(
            m_one["loss/all"])
        ring_calls = len(tr["ring"]) // n
        k8f = tr["launches"]["flash_attention_forward"]
        k8b = tr["launches"]["flash_attention_backward"]
        ring_ok = (ring_calls == SEQ_SELF_SITES
                   and len(tr["ring"]) == n * SEQ_SELF_SITES
                   and k8f - len(tr["ring"]) == k8b - n * SEQ_SELF_SITES)
        finite = bool(np.isfinite(got["train_bfloat16"]["metrics"][
            "loss/all"]))
        tr_ok = loss_gap <= 1e-4 and ring_ok and finite
        ring_shapes |= set(tr["ring"])
        if r == 0:
            gap = max(float(np.abs(tr["params"][k] - p_one[k]).max())
                      for k in p_one)
            numbers["param_gap"] = gap
            tr_ok &= gap <= 1e-4
        good_train &= tr_ok
        row = dict(
            frames=got["float32"]["frames"], forward_rel_err=errs,
            forward_launches=counts, forward_ring_blocks=len(
                got["float32"]["ring"]),
            forward_wall_s={d: got[d]["wall_s"] for d in errs},
            forward_peak_GB={d: got[d]["peak_GB"] for d in errs},
            train_loss_rel_gap=loss_gap, train_step_s=tr["step_s"],
            train_peak_GB=tr["peak_GB"], train_k8=[k8f, k8b],
            train_ring_blocks=len(tr["ring"]),
            bf16_step_s=got["train_bfloat16"]["step_s"],
            bf16_peak_GB=got["train_bfloat16"]["peak_GB"],
            bf16_loss=got["train_bfloat16"]["metrics"]["loss/all"])
        per_rank.append(row)
        log(f"seq_parallel rank {r}: {row['frames']} of {SEQ_FRAMES} frames;"
            f" UNet forward vs one process rel {errs['float32']:.2e} fp32 / "
            f"{errs['bfloat16']:.2e} bf16 (gates {TOL['float32']:g} / "
            f"{TOL['bfloat16']:g}), launches {counts_ok} "
            f"(K8 {counts['flash_attention_forward']} = {n} x "
            f"{SEQ_SELF_SITES} ring blocks), wall "
            f"{got['float32']['wall_s'] * 1e3:.1f} / "
            f"{got['bfloat16']['wall_s'] * 1e3:.1f} ms, peak "
            f"{got['float32']['peak_GB']:.2f} / "
            f"{got['bfloat16']['peak_GB']:.2f} GB; train step fp32 loss rel "
            f"{loss_gap:.2e} (gate 1e-4), K8 {k8f} + {k8b} of which ring "
            f"{len(tr['ring'])} + {n * SEQ_SELF_SITES}, step "
            f"{tr['step_s']:.2f} s, peak {tr['peak_GB']:.2f} GB; bf16 step "
            f"{got['train_bfloat16']['step_s']:.2f} s, peak "
            f"{got['train_bfloat16']['peak_GB']:.2f} GB, loss "
            f"{got['train_bfloat16']['metrics']['loss/all']:.4f}; card {card}")
    ok["seq_parallel_unet"] = good_fwd
    ok["seq_parallel_train"] = good_train
    log(f"seq_parallel one process: UNet forward wall "
        f"{one['float32']['wall_s'] * 1e3:.1f} / "
        f"{one['bfloat16']['wall_s'] * 1e3:.1f} ms, peak "
        f"{one['float32']['peak_GB']:.2f} / {one['bfloat16']['peak_GB']:.2f}"
        f" GB; train step {one['train_s']:.2f} s, peak "
        f"{one['train_peak_GB']:.2f} GB; params max |diff| rank 0 "
        f"{numbers.get('param_gap', float('nan')):.2e} (gate 1e-4)")
    ok["seq_parallel_k8_ring"], numbers["k8_ring_blocks"] = _k8_local_heads(
        torch, dev, sorted(ring_shapes), "seq_parallel K8 at a ring block")
    ok["seq_parallel_k8_ring"] &= bool(ring_shapes)
    numbers.update(ranks=per_rank, one=dict(
        forward_wall_s={d: one[d]["wall_s"] for d in ("float32", "bfloat16")},
        forward_peak_GB={d: one[d]["peak_GB"]
                         for d in ("float32", "bfloat16")},
        forward_launches=one["float32"]["launches"],
        train_s=one["train_s"], train_peak_GB=one["train_peak_GB"],
        metrics=m_one))
    log(f"seq_parallel phase: {numbers['ranks_wall_s']:.1f} s wall for the "
        f"ranks; card {card}. Time over gloo through the host on one card is"
        " no speed measure; NCCL with more than one rank: not measured")
    return ok, numbers


def _pipe_stack(torch, dev):
    """(layer_fn, stacked params, x): ``o_proj``'s six EncSALayers
    (``reference_parity``: C = 256, 8 heads, random weights from seed 6)
    stacked, the flash route on, eval mode; x [8, 400, 256] from seed
    7."""
    from diff_vits_tpu_torch.nn.fairseq import EncSALayer
    from diff_vits_tpu_torch.utils.init import init_random
    cfg = _train_cfg()
    c = cfg.vits.hidden_channels
    layers = [EncSALayer(c, 8, 9, p_dropout=0.2) for _ in range(6)]
    for i, layer in enumerate(layers):
        init_random(layer, torch.Generator().manual_seed(60 + i))
        layer.to(dev).eval().use_flash = True
    template = layers[0]
    stacked = {k: torch.stack([dict(m.named_parameters())[k].detach()
                               for m in layers])
               for k, _ in template.named_parameters()}
    x = torch.randn(8, 400, c, generator=torch.Generator().manual_seed(7))

    def layer_fn(p, h):
        keep = torch.ones(h.shape[0], h.shape[1], 1, device=h.device)
        return torch.func.functional_call(template, p, (h, keep))
    return layer_fn, stacked, x.to(dev)


def _pipe_run(device, n_micro, chunked=True):
    """The stack of :func:`_pipe_stack` on ``device``: through
    ``make_pipeline`` over the ranks' ``stage`` axis (a process group), or
    the sequential stack (one process) on the same ``n_micro``
    micro-batches (``chunked``) or on the whole batch; the output, the
    gradients of sum(out * w) for the stacked parameters and x, the K8
    launches, wall s and peak GB."""
    import torch
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.parallel import mesh, pipeline
    _exact_float32(torch)
    dev = torch.device(device)
    layer_fn, stacked, x = _pipe_stack(torch, dev)
    params = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    x = x.clone().requires_grad_(True)
    if mesh.distributed():
        fn = pipeline.make_pipeline(layer_fn, mesh.make_mesh(None, ("stage",)),
                                    n_micro)
    else:
        def fn(p, h):
            parts = h.split(h.shape[0] // n_micro) if chunked else [h]
            return torch.cat([pipeline.sequential(layer_fn, p, c)
                              for c in parts])
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)).to(
        dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    y = fn(params, x)
    (y * w).sum().backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return dict(out=y.detach().cpu().numpy(), dx=x.grad.cpu().numpy(),
                grads={k: v.grad.cpu().numpy() for k, v in params.items()},
                k8=[counts["flash_attention_forward"],
                    counts["flash_attention_backward"]], wall_s=wall,
                peak_GB=torch.cuda.max_memory_allocated() / 1e9)


def pipeline_phase(torch, dev, card):
    """GPipe (``parallel.pipeline``): two gloo ranks on the one card, each
    a ``stage`` of three of ``o_proj``'s six EncSALayers
    (``reference_parity`` widths, the flash route on, float32), batch 8 of
    400 frames in :data:`PIPE_MICRO` micro-batches, against the
    sequential stack in one process on the same micro-batches: output and
    the gradients of sum(out * w) for every stacked parameter and x within
    ``TOL`` of their largest magnitude; each stage launches K8 3 times a
    micro-batch forward and as many backward. The output also against the
    sequential stack on the whole batch (``TOL``); that run's gradients
    are printed, not gated: at another batch shape the kernels round
    otherwise, and a ReLU input within rounding of 0 in the feed-forward
    flips its gradient (found on the card, PR 16: one layer's ``ffn_1``
    weight 1.9e-2 of its largest entry apart, the sequential stack on 2
    rows against 8 as much as the pipeline). Returns ({phase: ok},
    numbers)."""
    from diff_vits_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    ranks = launch.run_ranks(_pipe_run, 2, str(dev), PIPE_MICRO,
                             backend="gloo", timeout=600)
    wall = time.perf_counter() - t0
    one = _pipe_run(str(dev), PIPE_MICRO)
    whole = _pipe_run(str(dev), PIPE_MICRO, chunked=False)
    def err(a, b):
        return _rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
    whole_gaps = {"out": err(whole["out"], one["out"]),
                  "dx": err(whole["dx"], one["dx"])}
    whole_gaps.update({f"d{k}": err(whole["grads"][k], g)
                       for k, g in one["grads"].items()})
    good, rows = whole_gaps["out"] <= TOL["float32"], []
    for r, got in enumerate(ranks):
        errs = {"out": err(got["out"], one["out"]),
                "dx": err(got["dx"], one["dx"])}
        errs["params"] = max(err(got["grads"][k], g)
                             for k, g in one["grads"].items())
        k8_ok = got["k8"] == [3 * PIPE_MICRO, 3 * PIPE_MICRO]
        ok_r = k8_ok and all(e <= TOL["float32"] for e in errs.values())
        good &= ok_r
        rows.append(dict(errors=errs, k8=got["k8"], wall_s=got["wall_s"],
                         peak_GB=got["peak_GB"]))
        log(f"pipeline stage {r}: vs the sequential stack out "
            f"{errs['out']:.2e}, dx {errs['dx']:.2e}, params "
            f"{errs['params']:.2e} (gate {TOL['float32']:g}); K8 "
            f"{got['k8'][0]} + {got['k8'][1]} (want {3 * PIPE_MICRO} each); "
            f"forward + backward {got['wall_s']:.2f} s, peak "
            f"{got['peak_GB']:.2f} GB; card {card}")
    # a call a layer and a micro-batch; the whole batch: a call a layer
    good &= one["k8"] == [6 * PIPE_MICRO] * 2 and whole["k8"] == [6, 6]
    log(f"pipeline one process: K8 {one['k8']} on the micro-batches, "
        f"{whole['k8']} on the whole batch ({one['wall_s']:.2f} / "
        f"{whole['wall_s']:.2f} s, peak {one['peak_GB']:.2f} / "
        f"{whole['peak_GB']:.2f} GB); the whole batch against the "
        f"micro-batches: out {whole_gaps['out']:.2e} (gate "
        f"{TOL['float32']:g}), gradients up to "
        f"{max(v for k, v in whole_gaps.items() if k != 'out'):.2e} (not "
        f"gated: ReLU kinks); ranks {wall:.1f} s wall (spawn included); "
        f"card {card}. Time over gloo on one card is no speed measure")
    return {"pipeline": good}, dict(card=card, ranks=rows, one=dict(
        k8=one["k8"], wall_s=one["wall_s"], peak_GB=one["peak_GB"]),
        whole=dict(k8=whole["k8"], gaps=whole_gaps), ranks_wall_s=wall)



# the offpath phase: the modules off the main path at the shipped widths
OFFPATH_B, OFFPATH_T = 8, 400       # batch and frames (the mel crop)
OFFPATH_CPU_ROWS = 2                # items of each batch run on the CPU too
OFFPATH_GATE = 1e-4                 # float32 card vs CPU, of max |CPU|
# a level of model3's diffusion UNet (block_out_channels 128, 256, 384,
# 512): 256 -> 384 (KUpBlock 384 -> 512), 8 GN groups, 8 heads (48 wide
# at 384), the temb of 4 x 128 and the context of hidden_channels 128 the
# denoiser hands its blocks, over a 267-frame prompt
OFFPATH_UNET = dict(c_in=256, c_out=384, c_k_out=512, temb=512, groups=8,
                    heads=8, head_dim=48, ctx=128, ctx_frames=267)
# VitsConfig's TextEncoder widths, over 128 tokens
OFFPATH_TEXT = dict(hidden=256, filter=256, heads=2, layers=6, kernel=3,
                    tokens=128)
OFFPATH_ENC_C = 256                 # OPERATIONS_ENCODER's hidden width
OFFPATH_MELS, OFFPATH_GIN = 100, 256
OFFPATH_LORA = 512                  # the UNet's widest Linear / Conv1d


class _Fp32:
    """An argument that stays float32 in the bfloat16 run (the additive
    key biases, which the UNet hands its blocks in float32)."""

    def __init__(self, t):
        self.t = t


def _fresh(args):
    """The arguments to call with: every list copied (up blocks pop their
    skips), ``_Fp32`` unwrapped."""
    return [list(a) if isinstance(a, list) else
            a.t if isinstance(a, _Fp32) else a for a in args]


def _map_args(args, fn):
    """``fn(tensor, keep_fp32)`` applied to every tensor argument."""
    out = []
    for a in args:
        if isinstance(a, list):
            out.append([fn(x, False) for x in a])
        elif isinstance(a, _Fp32):
            out.append(_Fp32(fn(a.t, True)))
        elif hasattr(a, "is_floating_point"):
            out.append(fn(a, False))
        else:
            out.append(a)
    return out


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None or isinstance(out, float) else [out]


def _out_err(got, ref, rows=None):
    """Largest max |got - ref| / max |ref| over the output's tensors (the
    first ``rows`` items of ``got``)."""
    errs = []
    for g, r in zip(_leaves(got), _leaves(ref)):
        g = g if rows is None else g[:rows]
        errs.append(_rel_err(g.cpu(), r.cpu())[1])
    return max(errs)


def _want_kernels(module):
    """K1-K4 and core launches of one fused forward of ``module``: one K1
    a ``ResnetBlock1D``, one K2, K3 and K4 and two cores a
    ``BasicTransformerBlock``."""
    from diff_vits_tpu_torch.nn.unet1d import (
        BasicTransformerBlock, ResnetBlock1D)
    res = sum(isinstance(m, ResnetBlock1D) for m in module.modules())
    blocks = sum(isinstance(m, BasicTransformerBlock)
                 for m in module.modules())
    return dict(fused_resnet_block=res, fused_self_attention=blocks,
                fused_cross_attention=blocks, fused_geglu_ff=blocks,
                attention=2 * blocks)


def _offpath_module(torch, dev, name, module, args, routed):
    """One module (built on the CPU from a seed) on the card: float32
    against the CPU on the first items; with ``routed`` (K1-K4 inside)
    the kernel route's launches counted and held against the plain route
    on the card (``TOL``), else no kernel launch at all; then bfloat16:
    finite, and for ``routed`` the same launches and ``TOL`` against its
    plain route. Returns (ok, row)."""
    import copy
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    n = OFFPATH_CPU_ROWS
    cpu = module.eval()
    want = _want_kernels(cpu) if routed else {}
    row = dict(name=name, routed=routed)
    ok = True
    with torch.no_grad():
        ref = cpu(*_fresh(_map_args(args, lambda a, _: a[:n])))
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            gpu = copy.deepcopy(cpu).to(dev, dt)
            g_args = _map_args(args, lambda a, fp32: a.to(
                dev, torch.float32 if fp32 else
                dt if a.is_floating_point() else a.dtype))
            set_use_fused(gpu, True)
            gpu(*_fresh(g_args))                 # warm (cuDNN plans)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            out = gpu(*_fresh(g_args))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in _leaves(out))
            r = dict(ms=ms, launches=counts, finite=finite)
            good = finite and counts == {k: v for k, v in want.items() if v}
            if routed:
                set_use_fused(gpu, False)
                plain = gpu(*_fresh(g_args))
                r["kernel_vs_plain"] = _out_err(out, plain)
                good &= r["kernel_vs_plain"] <= TOL[dname]
                if dname == "float32":
                    r["card_vs_cpu"] = _out_err(plain, ref, n)
            elif dname == "float32":
                r["card_vs_cpu"] = _out_err(out, ref, n)
            if "card_vs_cpu" in r:
                good &= r["card_vs_cpu"] <= OFFPATH_GATE
            r["ok"] = good
            ok &= good
            row[dname] = r
            del gpu
    f32, b16 = row["float32"], row["bfloat16"]
    extra = (f", kernel vs plain {f32['kernel_vs_plain']:.2e} / "
             f"{b16['kernel_vs_plain']:.2e} (gates {TOL['float32']:g} / "
             f"{TOL['bfloat16']:g}), launches {f32['launches']} / "
             f"{b16['launches']} (want {want})" if routed else
             f", launches {f32['launches'] or 0} / {b16['launches'] or 0}")
    log(f"offpath {name}: fp32 card vs CPU {f32['card_vs_cpu']:.2e} "
        f"(gate {OFFPATH_GATE:g}){extra}; bf16 finite {b16['finite']}; "
        f"{f32['ms']:.2f} / {b16['ms']:.2f} ms fp32 / bf16; "
        f"{'ok' if ok else 'FAILED'}")
    return ok, row


def offpath_cases(torch, b=OFFPATH_B, t=OFFPATH_T, unet=None, text=None,
                  enc_c=OFFPATH_ENC_C, mels=OFFPATH_MELS, gin=OFFPATH_GIN,
                  lora=OFFPATH_LORA):
    """(name, module, args, routed) of every module the offpath phase
    runs, built on the CPU from seeds: the 22 factory block types, the
    ``DualTransformer1D``, the general ``MultiHeadAttention``, the
    ``Decoder``, ``OPERATIONS_ENCODER`` 1-15, both speaker encoders, LoRA
    and the norms and functions around them."""
    from torch import nn
    from diff_vits_tpu_torch.core import masking
    from diff_vits_tpu_torch.models.encoders import (
        ReferenceEncoder, SpeakerEncoder)
    from diff_vits_tpu_torch.nn import fairseq, layers, lora as L
    from diff_vits_tpu_torch.nn import unet1d as U
    from diff_vits_tpu_torch.nn import unet1d_blocks as Z
    from diff_vits_tpu_torch.nn.embeddings import GaussianFourierProjection
    from diff_vits_tpu_torch.ops import attention as A
    u = dict(OFFPATH_UNET, **(unet or {}))
    tx = dict(OFFPATH_TEXT, **(text or {}))
    gen = torch.Generator().manual_seed(17)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    def keep(n, lengths):
        return (torch.arange(n)[None] < torch.tensor(lengths)[:, None]
                ).float()

    ragged = [t - 37 * i for i in range(b)]          # t .. t - 259
    ctx_len = [u["ctx_frames"] - 23 * i for i in range(b)]
    x_in, x_out = r(b, t, u["c_in"]), r(b, t, u["c_out"])
    temb = r(b, u["temb"])
    ctx = r(b, u["ctx_frames"], u["ctx"])
    ctx_bias = _Fp32(((1 - keep(u["ctx_frames"], ctx_len)) * -10000.0
                      )[:, None])
    skip_img = r(b, t, 3)
    fac = dict(resnet_groups=u["groups"], cross_attention_dim=u["ctx"],
               num_attention_heads=u["heads"],
               attention_head_dim=u["head_dim"])
    cases = []
    for typ in ("DownBlock2D", "ResnetDownsampleBlock2D", "AttnDownBlock2D",
                "CrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D",
                "SkipDownBlock2D", "AttnSkipDownBlock2D",
                "DownEncoderBlock2D", "AttnDownEncoderBlock2D",
                "KDownBlock2D", "KCrossAttnDownBlock2D"):
        torch.manual_seed(len(cases))
        m = Z.get_down_block(typ, 2, u["c_in"], u["c_out"], u["temb"], True,
                             **fac)
        args = {"DownEncoderBlock2D": [x_in],
                "AttnDownEncoderBlock2D": [x_in],
                "SkipDownBlock2D": [x_in, temb, skip_img],
                "AttnSkipDownBlock2D": [x_in, temb, skip_img],
                "CrossAttnDownBlock2D": [x_in, temb, ctx, ctx_bias],
                "SimpleCrossAttnDownBlock2D": [x_in, temb, ctx, ctx_bias],
                "KCrossAttnDownBlock2D": [x_in, temb, ctx, ctx_bias]
                }.get(typ, [x_in, temb])
        cases.append((f"down {typ}", m, args, typ in (
            "DownBlock2D", "CrossAttnDownBlock2D")))
    stack = [x_in, x_out]
    for typ in ("UpBlock2D", "ResnetUpsampleBlock2D", "CrossAttnUpBlock2D",
                "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "SkipUpBlock2D",
                "AttnSkipUpBlock2D", "UpDecoderBlock2D",
                "AttnUpDecoderBlock2D", "KUpBlock2D", "KCrossAttnUpBlock2D"):
        torch.manual_seed(len(cases))
        if typ == "KUpBlock2D":
            # its last resnet normalises in_channels in out / 32 groups,
            # which 256 -> 384 does not divide: model3's next level
            x_k = r(b, t, u["c_k_out"])
            m = Z.get_up_block(typ, 2, u["c_out"], u["c_k_out"],
                               u["c_k_out"], u["temb"], True, **fac)
            cases.append((f"up {typ}", m, [x_k, x_k, temb], False))
            continue
        m = Z.get_up_block(typ, 2, u["c_in"], u["c_out"], u["c_out"],
                           u["temb"], True, **fac)
        args = {"UpDecoderBlock2D": [x_in, temb],
                "AttnUpDecoderBlock2D": [x_in, temb],
                "SkipUpBlock2D": [x_out, stack, temb, skip_img[:, ::2]],
                "AttnSkipUpBlock2D": [x_out, stack, temb, skip_img[:, ::2]],
                # in != out: the k-unet's middle block, a skip of out wide
                "KCrossAttnUpBlock2D": [x_out, x_out, temb, ctx, ctx_bias],
                "CrossAttnUpBlock2D": [x_out, stack, temb, ctx, ctx_bias],
                "SimpleCrossAttnUpBlock2D": [x_out, stack, temb, ctx,
                                             ctx_bias]
                }.get(typ, [x_out, stack, temb])
        cases.append((f"up {typ}", m, args, typ in (
            "UpBlock2D", "CrossAttnUpBlock2D")))
    torch.manual_seed(100)
    half = u["ctx_frames"] // 3
    cases.append(("DualTransformer1D", U.DualTransformer1D(
        u["c_out"], u["heads"], u["c_out"] // u["heads"],
        cross_attention_dim=u["ctx"], norm_num_groups=u["groups"],
        condition_lengths=(half, u["ctx_frames"] - half)), [x_out, ctx],
        True))
    cases.append(("AdaLayerNorm", U.AdaLayerNorm(u["c_out"], 1000),
                  [x_out, torch.arange(b) * 97], False))
    cases.append(("AdaGroupNorm silu", U.AdaGroupNorm(
        u["temb"], u["c_out"], u["groups"], act_fn="silu"), [x_out, temb],
        False))
    cases.append(("SpatialNorm", U.SpatialNorm(u["c_out"], u["ctx"]),
                  [x_out, ctx], False))
    # the general VITS attention and the Decoder at the TextEncoder's widths
    h, n_tok = tx["hidden"], tx["tokens"]
    tok_len = [n_tok - 13 * i for i in range(b)]
    x_t, x_mask = r(b, n_tok, h), keep(n_tok, tok_len)[..., None]
    enc, enc_mask = r(b, n_tok // 2, h), keep(n_tok // 2, [
        n_tok // 2 - 5 * i for i in range(b)])[..., None]
    attn_mask = x_mask[:, None] * x_mask[:, None, None, :, 0]
    for label, kw, c_arg, mask in (
            ("MHA per-head window, proximal, block", dict(
                window_size=4, heads_share=False, proximal_bias=True,
                block_length=16), None, attn_mask),
            ("MHA enc-dec", dict(window_size=None), enc,
             x_mask[:, None] * enc_mask[:, None, None, :, 0])):
        torch.manual_seed(len(cases))

        class _Call(nn.Module):
            def __init__(self, m, c_given):
                super().__init__()
                self.m, self.c_given = m, c_given

            def forward(self, x, c, mask):
                return self.m(x, c=c if self.c_given else None,
                              attn_mask=mask)
        cases.append((label, _Call(layers.MultiHeadAttention(
            h, h, tx["heads"], **kw), c_arg is not None),
            [x_t, x_t if c_arg is None else c_arg, mask], False))
    torch.manual_seed(200)
    cases.append(("Decoder", layers.Decoder(
        h, tx["filter"], tx["heads"], tx["layers"], tx["kernel"],
        proximal_bias=True), [x_t, x_mask, enc, enc_mask], False))
    torch.manual_seed(201)
    cases.append(("FFN gelu causal", layers.FFN(
        h, h, tx["filter"], tx["kernel"], activation="gelu", causal=True),
        [x_t, x_mask], False))
    # OPERATIONS_ENCODER at hidden 256 over the frames
    x_e, k_e = r(b, t, enc_c), keep(t, ragged)[..., None]
    for code in range(1, 16):
        torch.manual_seed(300 + code)
        m = fairseq.OPERATIONS_ENCODER[code](enc_c, 0.1)
        if code == 13:
            with torch.no_grad():
                m.tao.fill_(3.0)
        cases.append((f"OPERATIONS_ENCODER[{code}] {type(m).__name__}", m,
                      [x_e, k_e], False))
    torch.manual_seed(400)

    class _OutAndProbs(nn.Module):     # the logits hold -inf where masked
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, *a):
            return self.m(*a)[:2]
    cases.append(("ConvAttentionLayer", _OutAndProbs(
        fairseq.ConvAttentionLayer(enc_c, enc_c)), [
            x_e, r(b, u["ctx_frames"], enc_c),
            r(b, u["ctx_frames"], enc_c),
            keep(u["ctx_frames"], ctx_len) > 0], False))
    mel = r(b, t, mels)
    torch.manual_seed(401)
    cases.append(("ReferenceEncoder", ReferenceEncoder(mels, gin,
                                                       device="cpu"),
                  [mel], False))
    torch.manual_seed(402)
    cases.append(("SpeakerEncoder", SpeakerEncoder(mels, 256, 256, 2,
                                                   device="cpu"),
                  [mel], False))
    # LoRA around the UNet's widest Linear and Conv1d (level 3, 50 frames)
    x_l = r(b, t // 8, lora)
    for label, m in (("LoRA Linear", L.LoRACompatibleDense(
            lora, lora, rank=4, network_alpha=4.0, generator=gen)),
            ("LoRA Conv1d", L.LoRACompatibleConv(
                lora, lora, 3, rank=4, network_alpha=4.0, generator=gen))):
        with torch.no_grad():      # an adapted layer: up no longer zero
            m.lora.up.weight.normal_(0.0, 0.05, generator=gen)
        cases.append((label, m, [x_l], False))

    class _Fn(nn.Module):
        def __init__(self, fn):
            super().__init__()
            self.fn = fn

        def forward(self, *a):
            return self.fn(*a)
    q4 = r(b, u["heads"], t, u["head_dim"])
    cases.append(("scaled_dot_product_attention causal + keys", _Fn(
        lambda q, k, v, m: A.scaled_dot_product_attention(
            q, k, v, mask=m, causal=True)),
        [q4, q4.flip(2), q4 * 0.5, keep(t, ragged)[:, None, None] > 0],
        False))
    cases.append(("FIR / K resamplers", _Fn(lambda a: (
        Z.fir_downsample_1d(a), Z.fir_upsample_1d(a), Z.k_downsample_1d(a),
        Z.k_upsample_1d(a))), [x_out], False))
    cases.append(("slice_segments / timing signal", _Fn(lambda a, i: (
        masking.slice_segments(a, i, 32),
        a + masking.get_timing_signal_1d(a.shape[1], a.shape[2],
                                         device=a.device))),
        [x_out, torch.tensor(ragged) - 40], False))
    torch.manual_seed(500)
    cases.append(("GaussianFourierProjection", GaussianFourierProjection(
        256, generator=gen), [torch.rand(b, generator=gen) + 0.01], False))
    return cases


def offpath_phase(torch, dev, card, **widths):
    """The modules off the main path on the card (``offpath_cases``):
    every module in float32 against the same module and weights on the
    CPU on the first :data:`OFFPATH_CPU_ROWS` items (TF32 off; gate
    :data:`OFFPATH_GATE`), in bfloat16 finite; the factories'
    ``DownBlock`` / ``UpBlock`` / ``CrossAttn*Block`` types and
    ``DualTransformer1D`` through K1-K4 (the counters zeroed before and
    read after each fused forward: one K1 a resnet, one K2, K3, K4 and two
    cores a transformer block) within ``TOL`` of their plain route in
    both dtypes, every other module launching no kernel. Returns
    ({phase: ok}, numbers)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    t0 = time.perf_counter()
    ok, rows = True, []
    for name, module, args, routed in offpath_cases(torch, **widths):
        good, row = _offpath_module(torch, dev, name, module, args, routed)
        ok &= good
        rows.append(row)
    wall = time.perf_counter() - t0
    worst = max(r["float32"]["card_vs_cpu"] for r in rows)
    log(f"offpath: {len(rows)} modules, {sum(r['routed'] for r in rows)} "
        f"through K1-K4; worst fp32 card vs CPU {worst:.2e} (gate "
        f"{OFFPATH_GATE:g}); {wall:.1f} s wall; card {card}")
    return {"offpath": ok}, dict(card=card, wall_s=wall, modules=rows,
                                 gate=OFFPATH_GATE)

if __name__ == "__main__":
    sys.exit(main())
