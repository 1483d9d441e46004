#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py [--json PATH]

From the root of a checkout, on a machine with an NVIDIA H100 and the CUDA
toolkit, this

1. prints the card's name and power limit (nvidia-smi) and builds the
   hand-written kernels of ``src/repro_torch/kernels/*/csrc`` with nvcc,
   one process per source, all at once; prints ptxas' registers, spills and
   shared memory of the tensor-core instantiations (``flash_tc_report``:
   the bf16 and f32 flash kernels at each head width; ``phase_report``,
   ``ssd_report``);
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shape classes, conv/deconv blocks also in bf16 (TF32 off;
   max abs error <= 1e-4 in f32, <= 5e-2 in bf16, SPPF bit-exact), timing
   kernel, plain version, a library composition (cuDNN conv + torch norm +
   act, or 3x max_pool2d + cat) and the bound (see ``bound``) — device
   times from calls queued ahead of the card, host times from a
   synchronised loop (see ``cuda_ms``); each deconv_block row also gives
   its achieved TFLOP/s and share of the bound (``achieved``);
3. captures every kernel call of one Pix2Pix and one YOLOv8 frame on the
   ``pallas_fused`` path at full width (img 256, base 64) and checks and
   times each distinct call the same way;
4. serves 4 frames on each of 2 Pix2Pix and 1 YOLOv8 streams through
   ``repro_torch.serve.build_server(impl="pallas")``, each planned segment
   a CUDA graph captured at the warm-up frame and replayed, with the launch
   counters set to 0 just before: requires exactly 316 conv_block, 64
   deconv_block and 4 sppf_pyramid launches, every one a replay (each
   replay counts the launches its graph captured,
   ``repro_torch.kernels.graph_launches``; the wrappers' own counters stay
   0), and holds every output against the same model's ``run_all`` on the
   plain (``xla``) ops on the card (atol 5e-3, rtol 1e-2); each frame's
   state lives in a slot (``serve.executor.Slot``): the run's host copies
   and clones of state leaves, counted under a dispatch mode
   (``served_copies``), are at most 2 a Pix2Pix frame and 4 a YOLOv8n
   frame, and no graph is captured in it (slots and graphs printed);
   serves 16 frames per stream on fresh servers with the parent tree's
   runner (``ParentSegment``: every state leaf copied in and cloned out),
   the slots, eager, eager, the slots, the parent (``served_ab``:
   frames/s, p50/p99, host-issue and blocked shares, memory held after
   the warm-up and peak over the run, outputs bit-equal across runs; 4
   times the launch counts, outside graphs or replayed; then the copies
   of 12 frames more); each served run
   also prints the Python collections and the allocator's new device
   segments inside it (``served_trace.GcClock``, ``device_segments``);
   then splits each
   conv_block and deconv_block
   call's device time between its passes (GEMM, split-K sum, statistics,
   normalise: ``device_split``), summed over the served run; then runs one
   frame each through full-width Pix2Pix and YOLOv8n with bf16 activations
   on the fused kernels, the counters set to 0 just before each (exactly 71
   conv_block, 8 deconv_block and 1 sppf_pyramid launches), against the
   plain ops (``bf16_forward_phase``); then drives the launcher,
   ``repro_torch.launch.serve.main``, in this process (``launcher_phase``:
   graphs against ``--no-jit-segments`` bit-exact at 316/64/4 launches,
   ``--cost measured``, ``--cost online --replan`` with one forced swap,
   no drop and each flight in flight at the swap finishing its admitted
   route, open-loop traffic, ``--mode lm``); then the paper's replicated
   pipelines (``fleet_phase``): the single server, ``replicas=2`` and
   ``workers=1``/``2`` at full width, each bit-exact against the single
   server with 316/64/4 launches summed over its replicas or workers, all
   replays; an open-loop run of each at one offered load (frames/s,
   goodput, p50/p99, host-issue share, device memory per process); one
   replica's plan swapped, then the other's, with the shared graph
   runners held to the live spans; a worker killed and evicted; one
   launcher call with ``--workers 2``;
5. holds the ``deconv2d`` kernel (``kernels/deconv/csrc``) against its plain
   version at the generator's 8 up-sampling shape classes, a B=8 case and a
   bf16 case (max abs error <= 1e-4 in f32, <= 5e-2 in bf16, reported by
   dtype), timed as in 2;
6. trains at full width: Pix2Pix (padded, ``deconv_backend="xla"``) 5
   steps of ``Adam(2e-4, b1=0.5)`` with seeded dropout on
   ``phantom_batches(1, ...)``, YOLOv8n 3 steps of ``AdamW(1e-3)`` on
   ``detection_batches(2, ...)``; every loss finite, every trainable leaf
   changed (but those whose gradient is exactly zero), BatchNorm's
   ``moving_*`` unchanged; step 1 on the card matches the same step on the
   CPU (losses and gradient norms within rtol 1e-4); ms per step and peak
   memory; both steps captured (one CUDA graph each, a replay a step);
   then ``train_ab``: at the same widths, the eager step (``step.eager``)
   and the captured one in turns from one init and seed (losses, params
   and optimizer states bit-equal with cuDNN deterministic and TF32 off;
   ms per step with the capture outside the clock; device busy a step and
   top ops under ``torch.profiler``; peak, held and reserved memory;
   captures and replays; host copies and bytes a step, ``served_copies``);
7. applies the surgery (padded -> cropping) with ``deconv_backend="pallas"``
   and evaluates the trained generator on an 8-image batch through the
   kernel: exactly 8 ``deconv2d`` launches, output within atol 1e-4 of the
   padded ``xla`` generator, SSIM/PSNR printed; then checks and times each
   of those 8 calls (the row's ``max_abs_err`` in the ``kernels`` line is
   theirs);
8. holds the two LM kernels (``kernels/attention/csrc/flash_attention.cu``,
   ``kernels/ssd/csrc/ssd.cu``) against their plain versions at their shape
   classes, in f32 and bf16 (flash: Hymba-1.5B's local and global layers,
   gemma2's D 256 softcap class, a ragged length, Sq < Sk; SSD: Hymba,
   Mamba2-2.7B's n 128 class, 4 groups, a ragged length), at the JAX
   package's pins (flash atol 3e-4 f32 / 4e-2 bf16, and bf16 also within
   one bf16 ulp of the output of the f32 plain version on the same inputs,
   ``FLASH_BF16_RTOL``; SSD y and final state atol 3e-3 / 0.15 with rtol
   2e-2, against the plain version in f32 on the same inputs), timing
   kernel, plain version, library call (SDPA with the boolean mask; none
   for softcap or the scan) and bound; each flash row also gives its
   achieved TFLOP/s (the bound's operation count over the kernel's time)
   and its share of the bound, each SSD row its device time by pass
   (``SSD_PASSES``);
9. serves Hymba-1.5B's prefill at full width: 1,589,773,120 random
   parameters from a ``torch.Generator`` on the card, ``make_lm_prefill`` on
   2 x 4096 seeded tokens with f32 and with the config's bf16 activations,
   each run with the counters set to 0 just before: exactly 32
   ``flash_attention`` and 32 ``ssd`` launches; last-token logits, KV caches
   and SSM / conv states held against the same prefill on the plain ops on
   the card (``PREFILL_F32_TOL``); ms per prefill, tokens/s, peak memory,
   each prefill's device time by kind of kernel and idle share
   (``torch.profiler``); the calls of one prefill in each dtype checked and
   timed by shape, as in 8 (so the flash and SSD time of each prefill), the
   SSD calls also split by pass;
10. decodes at full width: the captured decode step
   (``make_lm_decode_step``: one CUDA graph, replayed for every token,
   written into its caches; ``check_captured``) over
   a 16-token prompt with f32 activations and caches against
   ``__call__`` at the same positions (atol 5e-2, rtol 1e-2), then
   ``greedy_generate`` with batch 4, prompt 16 and 16 new tokens
   (``launch/serve.py --mode lm``'s defaults), tokens/s on the host clock;
   then the decode A/B (``decode_ab``): Hymba-1.5B at batch 4 with bf16
   weights and caches of ``DECODE_AB_LEN`` slots, greedy decoding with the
   eager step and the captured one (one CUDA-graph replay a token), both
   writing into the loop's caches, in turns: the tokens bit-equal, ms per
   step and peak memory of each with the capture outside the clock, the
   device's busy time a step and top ops under ``torch.profiler``, and no
   op of a step making a tensor of a layer's cache size
   (``cache_copies``);
11. drives the LM/SSM zoo at full width (``lm_zoo_phase``, ``ZOO``):
   gemma2-2b (2 x 8192, 26 layers: 26 ``flash_attention`` launches, window
   4096 on the even layers, softcap 50, D 256), mamba2-2.7b (2 x 4096, 64
   layers: 64 ``ssd`` launches at n 128) and whisper-small (frames (2,
   1500, 768), 64 tokens: 36 launches, 24 of them the kernel's non-causal
   mode) at full depth, and gemma-2b, gemma2-27b, phi4-mini, qwen2-vl-7b
   (2 layers) and the DeepSeek configs (3 layers; deepseek-v2-lite's MLA
   takes the plain route: 0 launches) at reduced depth: each f32 prefill
   through the kernels against the plain ops, the bf16 prefill timed
   (tokens/s, TFLOP/s from ``launch.analytic``), each distinct kernel call
   checked and timed as in 8, gemma2-2b and mamba2-2.7b split under
   ``torch.profiler``, and decode against ``__call__`` (atol 5e-2, rtol
   1e-2; the captured step, caches written in place; gemma2-2b through
   ``greedy_generate``, then
   gemma2-2b's decode A/B at batch 2, as in 10; then its requests on fresh
   caches (``decode_requests_ab``: 4 requests, each on caches dropped after
   it, captures, warm-ups, live graphs and memory after each, tokens
   bit-equal to the eager step's) and its step on a one-rank NCCL mesh,
   eager and captured in turns (``decode_mesh_ab``: ms a step, idle share
   under ``torch.profiler``, tokens bit-equal));
12. trains LMs on the card (``lm_train_phase``): gemma2-2b at full width
   and depth (2,614,341,888 parameters, seed 0) through
   ``repro_torch.launch.train.main`` (a one-rank NCCL mesh: DTensor
   parameters and AdamW state placed by ``dist.train_shardings``, the
   batch by ``shard_batch``), ``LM_TRAIN_B`` x ``LM_TRAIN_S``
   tokens, bf16 activations, remat on, 6 steps with one micro-batch and 4
   with two (``LM_TRAIN_RUNS``; the step captured into one CUDA graph at
   step 2 and replayed after, ``make_lm_train_step(..., donate=True)``):
   every loss finite, every parameter leaf changed, ms per step
   (synchronised, the replays from step 3), tokens/s, peak memory, no
   kernel launch under autograd and the plain routes taken
   (``kernels.grad_routes``: the forward's and remat's recompute); the same
   6 steps on the plain path (plain tensors, ``make_lm_train_step`` in the
   loop, the launcher's batches: ms, tokens/s, peak memory), and steps 1
   and 2 (the eager warm-up, the capture and its replay) of the two paths
   from the same parameters and batches, losses and every parameter within
   ``MESH_STEP1_RTOL``, one more mesh step, a replay, under
   ``torch.profiler``; the plain eager step with the parent's layer loop
   (``t[i]`` per layer) and this tree's (``unstack``) in turns, then the
   one-rank mesh step the same way (``stacked_grads_ab``: ms, peak,
   losses, device busy and the SelectBackward0 / UnbindBackward0 split of
   the plain step), failing where the backward
   makes a stacked leaf's full-shape tensor more than once a leaf
   (``stacked_grad_copies``); the captured step and ``step.eager`` in
   turns, plain and on the one-rank NCCL mesh (``lm_train_graph_ab``: ms a
   step, device busy and idle share under ``torch.profiler``, peak
   allocated and reserved memory, host copies of a captured step), failing
   unless losses, parameters and counts are bit-equal; step 1
   of gemma2-2b at 2 layers in f32 against the same step on the CPU
   (``LM_STEP1_LOSS_RTOL``, ``LM_STEP1_GRAD_TOL`` per gradient leaf); one
   bf16 step each of hymba-1.5b, mamba2-2.7b and whisper-small at full
   width and 2 layers (``LM_TRAIN_FAMILIES``: loss finite, ms, peak
   memory, the SSD and attention plain routes, step 2 a replay of the
   step's graph); and the loop's fault path
   at the smoke gemma2-2b (a checkpoint and a rescue checkpoint after an
   injected data failure each restore bit for bit, the resumed run reaches
   its last step, ``supervise`` restarts a command that fails once);
13. the distributed stack on the card, one rank (``dist_phase``): the
   launcher's ``--coordinator 127.0.0.1:<free port> --num-processes 1
   --process-id 0`` (``init_process_group`` with NCCL over TCP, the smoke
   gemma2-2b trains 2 steps, the group destroyed after), ``--production-mesh``
   and ``--multipod`` refused (256 / 512 ranks), ``make_compressed_dp_grad_fn``
   on gemma2-2b at full width and 2 layers (f32, ``DIST_B`` x ``DIST_S``,
   two error-feedback steps) on a one-rank mesh against the same call on
   the CPU (within one quantization step per element), and a checkpoint
   saved on the mesh path and resumed with ``shardings=`` whose continued
   run is bit-equal to an unbroken one;
14. the dry run (``dryrun_phase``): ``repro_torch.launch.dryrun.run_cell``
   on ``DRYRUN_CELLS`` (16 x 16 and 2 x 16 x 16 cells) at full width and
   depth and one call of ``experiments/torch_hillclimb.py``'s ``run``
   (``HILLCLIMB``) in spawned processes, one task each (their fake 256- or
   512-rank process groups never meet this process's NCCL groups, and
   none of them makes a CUDA context): each cell's step on ``meta``
   DTensors counted per rank, its three roofline terms predicted for the
   H100 SXM's peaks, bottleneck, per-rank memory and collective counts
   printed; any cell that is not ``ok`` fails the run; beside them, in
   the same processes, ``SMOKE_2X2_CELLS`` (the batch-8 decodes and train
   cells at smoke widths on a fake 2 x 2 group, where the batch and the
   heads split over different mesh dims, each checked as the tests check
   a cell: ``launch.dryrun.check_cell``) and the two-rank launches of
   ``LAUNCHES`` (``launch.train.main`` in two gloo ranks against one
   process's steps, ``launch.train.reference_steps``, within
   ``LAUNCH_RTOL``, the replicated parameters equal on both ranks) and
   the cases of ``tests/test_torch_dist_data.py`` (``DATA_KINDS``: every
   ``launch.dryrun.DATA_CASES`` case on four gloo ranks of a (2, 2) mesh
   against the same call in one process, within ``DATA_TOL`` of the
   reference's largest value, the decode steps writing into their caches;
   one line per kind); every decode cell's outputs and temps within
   ``DECODE_CELL_SPARE_GIB`` (the step writes into its donated caches) and
   the cells of ``DECODE_CELL_GIB`` within their totals; Mamba-2's decode
   cells at ``CARRY_COUNTS`` (each cell's row printed with its counts,
   bytes by kind and ``torch.__version__``); then the paper's
   Pix2Pix + YOLOv8 graphs planned once on the host over
   ``h100_submesh_engines()`` (cut points, expected cycle).

The ``kernels`` line's ``flash_attention`` and ``ssd`` rows stay those of
the bf16 Hymba-1.5B prefill (9), comparable across runs; the zoo's are in
its printed rows and in ``--json``'s ``lm_zoo``.

It prints each phase's time (``[phase time]``), a ``kernels`` JSON line
and, last, the ``{"ok": true, ...}`` line; any failure raises and exits
non-zero. Without a CUDA device, or
without the repo's ``src/repro_torch`` beside it, it exits 2 and prints no
result. ``--json PATH`` also writes every measured row to PATH.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks: HBM bandwidth, the dense TF32 and bf16
# tensor-core rates (a multiply-add counts 2 operations), and the fp32 rate
# of one-op instructions such as a max (half the 67 TFLOP/s fp32 FMA rate)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12  # the peak for bf16 operands
FP32_OPS_SIMPLE = 33.5e12
# The card's fastest fp32-accurate rate, the peak for f32 operands: three
# TF32 tensor-core products per multiply-add (hi*hi + hi*lo + lo*hi, the
# split that meets the port's f32 pin: tests/test_torch_deconv_tc.py) beat
# the 67 TFLOP/s of fp32 FMA
FP32_ACCURATE_FLOPS = TF32_FLOPS / 3

IMG, BASE = 256, 64  # the paper's full width: Pix2Pix 54,425,859 params, YOLOv8n
DEVICE = "cuda"

ACT_OPS = {"none": 0, "relu": 1, "lrelu": 1, "silu": 4, "tanh": 4}
SOURCE = "src/repro_torch/kernels/fused/csrc/fused_blocks.cu"
REPLACES = {
    "conv_block": "src/repro/kernels/fused/kernel.py:98",
    "deconv_block": "src/repro/kernels/fused/kernel.py:200",
    "sppf_pyramid": "src/repro/kernels/fused/kernel.py:169",
}
DECONV_SOURCE = "src/repro_torch/kernels/deconv/csrc/deconv2d.cu"
DECONV_REPLACES = "src/repro/kernels/deconv/kernel.py:86"
LM_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_attention": ("src/repro_torch/kernels/attention/csrc/flash_attention.cu",
                        "src/repro/kernels/attention/kernel.py:80"),
    "ssd": ("src/repro_torch/kernels/ssd/csrc/ssd.cu", "src/repro/kernels/ssd/kernel.py:67"),
}
# The bound's chunk for the SSD scan: its work is counted at 64-step chunks
# whatever chunk the kernels or the caller use, so that bounds stay
# comparable across kernel designs
SSD_STEP = 64
HYMBA_PARAMS = 1_589_773_120
PREFILL_B, PREFILL_S = 2, 4096
# The bf16 flash kernel reads bf16 and accumulates in fp32: Q.K^T of bf16
# values is exact in the products, and P enters P.V as two bf16 terms
# (p_hi + p_lo, within 2^-16 |p|). So against attention_ref in f32 on the
# same (upcast) inputs it differs by the output's rounding to bf16 (at most
# half an ulp, 2^-8 |out|) and fp32 summation order (<= 1.25e-6 in the f32
# classes, PERF.md): one bf16 ulp (2^-7 |out|) plus 1e-5.
FLASH_BF16_ATOL, FLASH_BF16_RTOL = 1e-5, 2.0**-7


def cuda_ms(fn, reps=20, warm=3):
    """``(device_ms, host_ms)`` of one ``fn()``. host_ms: wall time per call
    of a synchronised warm loop (what a caller waits when the host issues
    the calls). device_ms: CUDA events around ``reps`` calls queued behind a
    spin kernel, so the card runs them back to back and the events bracket
    device work only, not the host's issue rate (L2 stays warm)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warm
    cycles = int(3 * reps * host_s * 2e9) + 10**6  # ~3x the issue time at 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()  # the card was still spinning when the last call was issued
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / reps, host_s * 1e3
        cycles *= 4
    raise RuntimeError("could not queue the timed calls ahead of the card")


def taps_1d(n_in, n_out, k, stride, pad, transposed=False):
    """Along one axis: the kernel taps that land on a real input element,
    summed over the outputs, the number of distinct kernel offsets they use
    and the number of distinct inputs they read. Taps in the zero (or -inf)
    padding, or cropped away, are not counted. A conv output ``o`` reads
    input ``o*stride - pad + t``; a transposed conv's output ``o`` reads
    input ``i`` where ``i*stride - pad + t == o``."""
    taps, offsets, inputs = 0, set(), set()
    for o in range(n_out):
        for t in range(k):
            if transposed:
                if (o + pad - t) % stride:
                    continue
                i = (o + pad - t) // stride
            else:
                i = o * stride - pad + t
            if 0 <= i < n_in:
                taps += 1
                offsets.add(t)
                inputs.add(i)
    return taps, len(offsets), len(inputs)


def bound(name, a, bias=True):
    """(bytes time, operations time) in ms for one call, counting only the
    work this call's shapes need: the input elements some real tap reads,
    the weight slices of the kernel offsets some real tap uses, bias (when
    the call has one), gamma/beta (when it normalises) and the output, each
    once, over the HBM rate; 2*Cin ops per real tap per output channel plus
    bias, norm (3 statistics + 4 apply) and act ops per output over the
    peak rate of the operands' type (``FP32_ACCURATE_FLOPS``, or bf16 tensor
    cores); for
    SPPF, the maxes of a separable pool (a row max, then a column max, of
    the real window taps; one max per tap beyond the first) over the one-op
    fp32 rate."""
    x = a["x"]
    B, H, W, C = x.shape
    esize = x.element_size()
    if name == "sppf_pyramid":
        win, reps = a["window"], a["reps"]
        th = taps_1d(H, H, win, 1, win // 2)[0]
        tw = taps_1d(W, W, win, 1, win // 2)[0]
        nbytes = (x.numel() + B * H * W * C * (reps + 1)) * esize
        ops = reps * B * C * (H * (tw - W) + W * (th - H))
        return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_SIMPLE * 1e3
    w = a["w"]
    k, cout = w.shape[0], w.shape[-1]
    if name in ("deconv_block", "deconv2d"):
        Ho, Wo, stride, pad, tr = 2 * H, 2 * W, 2, 1, True
    else:
        stride, pad, tr = a["stride"], a["padding"], False
        Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    th, kh, ih = taps_1d(H, Ho, k, stride, pad, tr)
    tw, kw, iw = taps_1d(W, Wo, k, stride, pad, tr)
    out = B * Ho * Wo * cout
    norm = a.get("norm", "none") != "none"
    affine = cout * (int(bias) + 2 * int(norm))  # float32 bias, gamma, beta
    nbytes = esize * (B * ih * iw * C + out) + w.element_size() * kh * kw * C * cout + 4 * affine
    ops = 2 * C * cout * B * th * tw + out * (int(bias) + (7 if norm else 0) + ACT_OPS[a.get("act", "none")])
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_flops(x.dtype) * 1e3


def peak_flops(dtype):
    """The operations peak for operands of ``dtype``: bf16 tensor cores, or
    the fp32-accurate 3xTF32 rate."""
    import torch

    return BF16_FLOPS if dtype == torch.bfloat16 else FP32_ACCURATE_FLOPS


def library_fn(name, a):
    """One torch composition of the same function (a yardstick only); w in
    x's dtype, as the ops cast it."""
    import torch
    import torch.nn.functional as F

    x = a["x"].permute(0, 3, 1, 2)
    if name == "sppf_pyramid":
        pad = a["window"] // 2

        def sppf():
            outs = [x]
            for _ in range(a["reps"]):
                outs.append(F.max_pool2d(outs[-1], a["window"], 1, pad))
            return torch.cat(outs, 1)

        return sppf
    if name == "deconv2d":
        w = a["w"].to(x.dtype).flip(0, 1).permute(2, 3, 0, 1).contiguous()
        b = None if a["b"] is None else a["b"].to(x.dtype)
        return lambda: F.conv_transpose2d(x, w, b, stride=2, padding=1)
    if name == "deconv_block":
        w = a["w"].to(x.dtype).flip(0, 1).permute(2, 3, 0, 1).contiguous()

        def conv():
            return F.conv_transpose2d(x, w, a["b"].to(x.dtype), stride=2, padding=1)
    else:
        w = a["w"].to(x.dtype).permute(3, 2, 0, 1).contiguous()

        def conv():
            return F.conv2d(x, w, a["b"].to(x.dtype), stride=a["stride"], padding=a["padding"])

    act = {"none": lambda y: y, "relu": F.relu, "lrelu": lambda y: F.leaky_relu(y, 0.2),
           "silu": F.silu, "tanh": torch.tanh}[a["act"]]
    norm, g, bt, eps = a["norm"], a["gamma"], a["beta"], a["eps"]

    def block():
        y = conv()
        if norm == "batch":
            # the aten op: F.batch_norm refuses one value per channel (the 1x1 bottleneck)
            y = torch.batch_norm(y, g, bt, None, None, True, 0.0, eps, True)
        elif norm == "instance":
            y = F.instance_norm(y, weight=g, bias=bt, eps=eps)
        elif norm == "group":
            y = F.group_norm(y, a["groups"], g, bt, eps)
        return act(y)

    return block


class Bench:
    """Checks and times one kernel call against its plain version."""

    def __init__(self, ops, ref, deconv_ops, deconv_ref):
        self.ops = ops
        self.fns = {
            "conv_block": (ops.conv_block, ref.conv_block_ref),
            "deconv_block": (ops.deconv_block, ref.deconv_block_ref),
            "sppf_pyramid": (ops.sppf_pyramid, ref.sppf_pyramid_ref),
            "deconv2d": (deconv_ops.deconv2d, deconv_ref.deconv2d_ref),
        }
        self.sig = {n: inspect.signature(op) for n, (op, _) in self.fns.items()}

    def args(self, name, *args, **kw):
        """The call's full keyword arguments, absent affine terms of the
        fused blocks filled in as their wrapper fills them, and whether the
        call passed a bias."""
        a = self.sig[name].bind(*args, **kw)
        a.apply_defaults()
        a = dict(a.arguments)
        bias = a.get("b") is not None
        if name in ("conv_block", "deconv_block"):
            a["b"], a["gamma"], a["beta"] = self.ops._affine(
                a["x"], a["b"], a["gamma"], a["beta"], a["w"].shape[-1]
            )
        return a, bias

    def run(self, name, a, bias):
        import torch

        op, ref = self.fns[name]
        kernel = lambda: op(**a)  # noqa: E731
        plain = lambda: ref(**a)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        if not math.isfinite(err):
            raise AssertionError(f"{name}: non-finite output or error")
        if name == "sppf_pyramid":
            tol = 0.0
        else:
            tol = 5e-2 if a["x"].dtype == torch.bfloat16 else 1e-4
        if err > tol:
            raise AssertionError(f"{name} {tuple(a['x'].shape)}: max abs err {err:.3g} > {tol}")
        bytes_ms, ops_ms = bound(name, a, bias)
        ms, host_ms = cuda_ms(kernel)
        plain_ms, plain_host_ms = cuda_ms(plain)
        library_ms, _ = cuda_ms(library_fn(name, a))
        bound_ms = max(bytes_ms, ops_ms)
        return {
            "max_abs_err": err,
            "ms": ms,
            "host_ms": host_ms,
            "plain_ms": plain_ms,
            "plain_host_ms": plain_host_ms,
            "library_ms": library_ms,
            "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_ms": bound_ms,
            "tflop_s": ops_ms * peak_flops(a["x"].dtype) / ms / 1e12,
            "bound_share": bound_ms / ms,
        }


def achieved(r):
    """A row's achieved TFLOP/s (the bound's operation count over the
    kernel's time) and its share of the bound."""
    return f"{r['tflop_s']:.2f} TFLOP/s, {100 * r['bound_share']:.2f}% of the bound"


def describe(name, a, bias):
    x = tuple(a["x"].shape)
    if name == "sppf_pyramid":
        return f"{x} {str(a['x'].dtype)[6:]}"
    if name == "deconv2d":
        return f"{x}->{a['w'].shape[-1]}{' +b' if bias else ''} {str(a['x'].dtype)[6:]}"
    w = a["w"]
    conv = "" if name == "deconv_block" else f" k{w.shape[0]}s{a['stride']}p{a['padding']}"
    dt = "" if str(a["x"].dtype) == "torch.float32" else f" {str(a['x'].dtype)[6:]}"
    return f"{x}->{w.shape[-1]}{conv}{' +b' if bias else ''} {a['norm']}/{a['act']}{dt}"


def shape_classes(torch, dev):
    """One call per main-path shape class (first/deep Pix2Pix down blocks,
    YOLOv8 stem, 1x1 and head convs, the bottleneck/wide/final up blocks,
    SPPF) plus a B=2 batch-norm case, on random inputs; then the conv and
    deconv classes again in bf16 (x and w bf16, bias/gamma/beta f32), with a
    Cout-4 deconv with a norm (the phase GEMM writing fp32, not the narrow
    kernel)."""
    g = torch.Generator(dev).manual_seed(0)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def conv(x, k, s, p, cout, norm, act, bias=False, dtype=torch.float32):
        cin = x[-1]
        w = t(k, k, cin, cout, scale=math.sqrt(2.0 / (k * k * cin)))
        kw = dict(stride=s, padding=p, norm=norm, act=act, gamma=1 + 0.1 * t(cout), beta=0.1 * t(cout))
        if bias:
            kw["b"] = 0.1 * t(cout)
        return ("conv_block", (t(*x).to(dtype), w.to(dtype)), kw)

    def deconv(x, cout, norm, act, bias=False, dtype=torch.float32):
        w = t(4, 4, x[-1], cout, scale=math.sqrt(2.0 / (16 * x[-1])))
        kw = dict(norm=norm, act=act, gamma=1 + 0.1 * t(cout), beta=0.1 * t(cout))
        if bias:
            kw["b"] = 0.1 * t(cout)
        return ("deconv_block", (t(*x).to(dtype), w.to(dtype)), kw)

    bf16 = torch.bfloat16
    return [
        conv((1, 256, 256, 3), 4, 2, 1, 64, "none", "lrelu"),
        conv((1, 128, 128, 64), 4, 2, 1, 128, "batch", "lrelu"),
        conv((1, 2, 2, 512), 4, 2, 1, 512, "batch", "lrelu"),
        conv((1, 256, 256, 3), 3, 2, 1, 16, "batch", "silu"),
        conv((1, 64, 64, 32), 1, 1, 0, 32, "batch", "silu"),
        conv((1, 32, 32, 64), 1, 1, 0, 2, "none", "none", bias=True),
        conv((2, 32, 32, 64), 3, 1, 1, 64, "batch", "silu"),
        deconv((1, 1, 1, 512), 512, "batch", "relu"),
        deconv((1, 64, 64, 256), 64, "batch", "relu"),
        deconv((1, 128, 128, 128), 3, "none", "tanh", bias=True),
        ("sppf_pyramid", (t(1, 8, 8, 128),), {}),
        conv((1, 256, 256, 3), 4, 2, 1, 64, "none", "lrelu", dtype=bf16),
        conv((1, 128, 128, 64), 4, 2, 1, 128, "batch", "lrelu", dtype=bf16),
        conv((1, 2, 2, 512), 4, 2, 1, 512, "batch", "lrelu", dtype=bf16),
        conv((1, 256, 256, 3), 3, 2, 1, 16, "batch", "silu", dtype=bf16),
        conv((1, 64, 64, 32), 1, 1, 0, 32, "batch", "silu", dtype=bf16),
        conv((1, 32, 32, 64), 1, 1, 0, 2, "none", "none", bias=True, dtype=bf16),
        conv((2, 32, 32, 64), 3, 1, 1, 64, "batch", "silu", dtype=bf16),
        deconv((1, 1, 1, 512), 512, "batch", "relu", dtype=bf16),
        deconv((1, 64, 64, 256), 64, "batch", "relu", dtype=bf16),
        deconv((1, 128, 128, 128), 3, "none", "tanh", bias=True, dtype=bf16),
        deconv((1, 32, 32, 64), 4, "batch", "relu", dtype=bf16),
    ]


def deconv_classes(torch, dev):
    """deconv2d's shape classes: the 8 up-sampling calls of one full-width
    generator forward (B=1), one B=8 call and one bf16 call, on random
    inputs."""
    g = torch.Generator(dev).manual_seed(2)

    def call(x, cout, bias=False, dtype=torch.float32):
        t = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale  # noqa: E731
        w = t(4, 4, x[-1], cout, scale=math.sqrt(2.0 / (16 * x[-1])))
        return ("deconv2d", (t(*x).to(dtype), w.to(dtype)), {"b": 0.1 * t(cout) if bias else None})

    return [
        call((1, 1, 1, 512), 512),
        call((1, 2, 2, 1024), 512),
        call((1, 4, 4, 1024), 512),
        call((1, 8, 8, 1024), 512),
        call((1, 16, 16, 1024), 256),
        call((1, 32, 32, 512), 128),
        call((1, 64, 64, 256), 64),
        call((1, 128, 128, 128), 3, bias=True),
        call((8, 16, 16, 1024), 256),
        call((1, 64, 64, 256), 64, dtype=torch.bfloat16),
    ]


def _tensors(torch, tree, dev):
    """A numpy batch tree as tensors on ``dev``."""
    from repro_torch.nn.module import tree_map

    return tree_map(lambda a: torch.from_numpy(a).to(dev), tree)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _changed(before, after):
    """Leaf paths of a parameter tree whose value changed, and those that did not."""
    from repro_torch.nn.module import tree_leaves

    changed, same = [], []
    for path, x, y in zip(_paths(before), tree_leaves(before), tree_leaves(after)):
        (same if bool((x == y).all()) else changed).append(path)
    return changed, same


def train_phase(torch, smi, dev):
    """Full-width training: Pix2Pix (padded, xla deconvs) and YOLOv8n. Step
    1 on the card against the same step on the CPU (same init, same batch,
    no dropout), then a few steps on the card. Returns the trained
    Pix2Pix config and parameters and the phase's rows."""
    from repro_torch.data import PhantomConfig, detection_batches, phantom_batches
    from repro_torch.models import Pix2Pix, Pix2PixConfig, YOLOv8, YOLOv8Config
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import SGD, Adam, AdamW, global_norm, make_pix2pix_train_step, make_yolo_train_step

    cpu = torch.device("cpu")
    rows = {}

    def is_moving(path):
        return "moving_" in path

    def finite(metrics, what):
        bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
        if bad:
            raise AssertionError(f"{what}: non-finite {bad}")

    def timed_steps(step, params, state, batches, extra=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = step(params, state, b, *extra)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        return params, state, losses, times, torch.cuda.max_memory_allocated()

    # ---- Pix2Pix: step 1 parity through SGD(lr=1, momentum=0) (delta = -grad)
    cfg = Pix2PixConfig(img_size=IMG, base=BASE, deconv_mode="padded", deconv_backend="xla")
    model = Pix2Pix(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0))
    batch_np = next(phantom_batches(1, PhantomConfig(IMG), seed=0))
    sgd = SGD(lr=1.0, momentum=0.0)
    grads, metrics = {}, {}
    for key, d in (("cpu", cpu), ("card", dev)):
        p = tree_map(lambda t: t.to(d), p_cpu)
        st = {"g": sgd.init(p["generator"]), "d": sgd.init(p["discriminator"])}
        new, _, m = make_pix2pix_train_step(model, sgd, sgd)(p, st, _tensors(torch, batch_np, d), None)
        grads[key] = tree_map(lambda a, b: a - b, p, new)
        metrics[key] = {k: float(v) for k, v in m.items()}
    finite(metrics["card"], "pix2pix step 1")
    norms = {k: {d: float(global_norm(grads[d][k])) for d in grads} for k in ("generator", "discriminator")}
    for k in ("g_loss", "d_loss"):
        if _rel(metrics["card"][k], metrics["cpu"][k]) > 1e-4:
            raise AssertionError(f"pix2pix step 1 {k}: card {metrics['card'][k]} vs CPU {metrics['cpu'][k]}")
    for k, v in norms.items():
        if _rel(v["card"], v["cpu"]) > 1e-4:
            raise AssertionError(f"pix2pix step 1 |grad {k}|: card {v['card']} vs CPU {v['cpu']}")
    dead = {path for path, g in zip(_paths(p_cpu), tree_leaves(grads["card"])) if not bool(g.any())}
    print(
        f"pix2pix step 1, card vs CPU: g_loss {metrics['card']['g_loss']:.6f} / {metrics['cpu']['g_loss']:.6f}, "
        f"d_loss {metrics['card']['d_loss']:.6f} / {metrics['cpu']['d_loss']:.6f}, |grad G| "
        f"{norms['generator']['card']:.6f} / {norms['generator']['cpu']:.6f}, |grad D| "
        f"{norms['discriminator']['card']:.6f} / {norms['discriminator']['cpu']:.6f} (rtol 1e-4)"
    )
    del grads

    # ---- Pix2Pix: 5 Adam steps with seeded dropout
    adam = Adam(lr=2e-4, b1=0.5)
    p0 = tree_map(lambda t: t.to(dev), p_cpu)
    st = {"g": adam.init(p0["generator"]), "d": adam.init(p0["discriminator"])}
    data = phantom_batches(1, PhantomConfig(IMG), seed=0)
    batches = [_tensors(torch, next(data), dev) for _ in range(5)]
    drop = torch.Generator(dev).manual_seed(0)
    pix_step = make_pix2pix_train_step(model, adam, adam)
    params, _, losses, times, peak = timed_steps(pix_step, p0, st, batches, (drop,))
    check_train_captured(pix_step, len(batches), "pix2pix train")
    for i, m in enumerate(losses):
        finite(m, f"pix2pix step {i + 1}")
    changed, same = _changed(p0, params)
    stuck = {path for path in same if not is_moving(path)}
    moved = [path for path in changed if is_moving(path)]
    if moved or stuck != {path for path in dead if not is_moving(path)}:
        raise AssertionError(f"pix2pix: moving stats changed {moved}; unchanged trainable {sorted(stuck)}, zero-grad {sorted(dead)}")
    rows["pix2pix"] = {"losses": losses, "ms": times, "peak_bytes": peak}
    print(
        f"pix2pix train (img {IMG}, base {BASE}, batch 1, Adam 2e-4): 5 steps finite, g_loss "
        f"{losses[0]['g_loss']:.4f} -> {losses[-1]['g_loss']:.4f}; {len(changed)} leaves changed, "
        f"moving stats unchanged, unchanged trainable = the zero-gradient leaves {sorted(stuck)}; "
        f"captured (one CUDA graph, a replay a step): ms/step {sum(times[1:]) / len(times[1:]):.2f} (steps 2-5; "
        f"step 1 {times[0]:.2f}, the capture), peak {peak / 2**30:.3f} GiB | {smi}"
    )

    # ---- YOLOv8n: step 1 parity, then 3 AdamW steps
    ycfg = YOLOv8Config(img_size=IMG)
    ymodel = YOLOv8(ycfg)
    y_cpu = ymodel.init(torch.Generator().manual_seed(1))
    ydata = detection_batches(2, PhantomConfig(IMG, lesion_p=1.0), seed=2)
    ybatches_np = [next(ydata) for _ in range(3)]
    adamw = AdamW(1e-3)
    ystep = make_yolo_train_step(ymodel, adamw)
    ym = {}
    for key, d in (("cpu", cpu), ("card", dev)):
        p = tree_map(lambda t: t.to(d), y_cpu)
        _, _, m = ystep(p, adamw.init(p), _tensors(torch, ybatches_np[0], d))
        ym[key] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "grad_norm"):
        if _rel(ym["card"][k], ym["cpu"][k]) > 1e-4:
            raise AssertionError(f"yolo step 1 {k}: card {ym['card'][k]} vs CPU {ym['cpu'][k]}")
    print(
        f"yolov8n step 1, card vs CPU: loss {ym['card']['loss']:.6f} / {ym['cpu']['loss']:.6f}, grad_norm "
        f"{ym['card']['grad_norm']:.6f} / {ym['cpu']['grad_norm']:.6f} (rtol 1e-4)"
    )
    y0 = tree_map(lambda t: t.to(dev), y_cpu)
    yparams, _, ylosses, ytimes, ypeak = timed_steps(
        ystep, y0, adamw.init(y0), [_tensors(torch, b, dev) for b in ybatches_np]
    )
    check_train_captured(ystep, 1 + len(ybatches_np), "yolov8n train")  # its step 1 above, then the loop
    for i, m in enumerate(ylosses):
        finite(m, f"yolo step {i + 1}")
    changed, same = _changed(y0, yparams)
    if [q for q in changed if is_moving(q)] or [q for q in same if not is_moving(q)]:
        raise AssertionError(f"yolo: changed {changed}, unchanged {same}")
    rows["yolov8n"] = {"losses": ylosses, "ms": ytimes, "peak_bytes": ypeak}
    print(
        f"yolov8n train (img {IMG}, batch 2, AdamW 1e-3): 3 steps finite, loss {ylosses[0]['loss']:.4f} -> "
        f"{ylosses[-1]['loss']:.4f}; all {len(changed)} trainable leaves changed, moving stats unchanged; "
        f"captured: ms/step {sum(ytimes[1:]) / len(ytimes[1:]):.2f} (steps 2-3; step 1 {ytimes[0]:.2f}), "
        f"peak {ypeak / 2**30:.3f} GiB | {smi}"
    )
    rows["ab"] = train_ab(torch, smi, dev)
    return cfg, params, rows


def check_train_captured(step, count, what):
    """``step`` (a captured train step) ran ``count`` calls as replays of
    one CUDA graph."""
    replays = [g.replays for g in step.graphs.values()]
    if replays != [count]:
        raise AssertionError(f"{what}: {len(replays)} CUDA graphs replayed {replays} times, not one {count} times")


# the train A/B (``train_ab``): steps a run, runs in turns, steps under the profiler
TRAIN_AB_STEPS, TRAIN_AB_RUNS, TRAIN_AB_SPLIT = 5, ("eager", "captured", "captured", "eager"), 3
# kinds of the vision train steps' kernels, by the first pattern a kernel's
# name holds (``time_split``'s matmuls are convolutions here)
TRAIN_KINDS = (("convolution", ("cudnn", "xmma", "gemm", "conv", "nvjet", "cutlass")), ("copy", ("memcpy", "memset")),
               ("reduction", ("reduce",)), ("elementwise", ("elementwise",)))


def train_kinds(split):
    """``time_split``'s device ms by ``TRAIN_KINDS`` (the rest "other")."""
    kinds = dict.fromkeys([k for k, _ in TRAIN_KINDS] + ["other"], 0.0)
    kinds["convolution"] += split["by_kind"].get("matmul", 0.0)
    for name, ms in split["other"].items():
        kinds[next((k for k, pats in TRAIN_KINDS if any(t in name.lower() for t in pats)), "other")] += ms
    return kinds


def train_ab(torch, smi, dev):
    """The vision train steps at full width, eager (``step.eager``: the
    captured step's ops, one by one) and captured (one CUDA-graph replay a
    call), in turns (``TRAIN_AB_RUNS``), each run ``TRAIN_AB_STEPS`` steps
    from one init, one seeded dropout generator and the same batches:
    Pix2Pix (padded, xla deconvs; img ``IMG``, base ``BASE``, batch 1,
    ``Adam(2e-4, b1=0.5)`` with dropout) and YOLOv8n (img ``IMG``, batch 2,
    ``AdamW(1e-3)``), with cuDNN deterministic and TF32 off. Fails unless
    every run's losses, final params and optimizer states are bit-equal,
    the captured runs replay the one graph captured before them (its
    capture, timed apart, outside the clock), and a captured step makes one
    host copy per input leaf (a fill for each count) and one clone per
    output leaf. Reports ms per step (host clock, synchronised at the end
    of the run), the memory the capture holds and reserves above the
    inputs (the graph's static trees, its pool), each run's peak above its
    start and the memory reserved after it, then ``TRAIN_AB_SPLIT`` steps
    of each under ``torch.profiler``
    (``time_split``: device busy a step, idle share, top kernels and ops)
    and the copies and bytes of one captured step (``served_copies``)."""
    from repro_torch.data import PhantomConfig, detection_batches, phantom_batches
    from repro_torch.models import Pix2Pix, Pix2PixConfig, YOLOv8, YOLOv8Config
    from repro_torch.train import Adam, AdamW, make_pix2pix_train_step, make_yolo_train_step

    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        pix = Pix2Pix(Pix2PixConfig(img_size=IMG, base=BASE, deconv_mode="padded", deconv_backend="xla"))
        adam = Adam(lr=2e-4, b1=0.5)
        data = phantom_batches(1, PhantomConfig(IMG), seed=4)
        yolo = YOLOv8(YOLOv8Config(img_size=IMG))
        adamw = AdamW(1e-3)
        ydata = detection_batches(2, PhantomConfig(IMG, lesion_p=1.0), seed=5)
        cases = {
            "pix2pix": (make_pix2pix_train_step(pix, adam, adam),
                        pix.init(torch.Generator().manual_seed(2)),
                        lambda p: {"g": adam.init(p["generator"]), "d": adam.init(p["discriminator"])},
                        [next(data) for _ in range(TRAIN_AB_STEPS)], True,
                        f"Pix2Pix (img {IMG}, base {BASE}, batch 1, Adam 2e-4 with dropout)"),
            "yolov8n": (make_yolo_train_step(yolo, adamw), yolo.init(torch.Generator().manual_seed(3)), adamw.init,
                        [next(ydata) for _ in range(TRAIN_AB_STEPS)], False,
                        f"YOLOv8n (img {IMG}, batch 2, AdamW 1e-3)"),
        }
        for name in list(cases):
            out[name] = _train_ab_model(torch, smi, dev, name, *cases.pop(name))
            torch.cuda.empty_cache()  # the model's graph and its pool are gone with its step
    finally:
        torch.backends.cudnn.deterministic = flags
    return out


def _train_ab_model(torch, smi, dev, name, step, init_cpu, init_state, batches_np, dropout, what):
    from repro_torch.nn.module import tree_leaves, tree_map

    p0 = tree_map(lambda t: t.to(dev), init_cpu)
    s0 = init_state(p0)
    batches = [_tensors(torch, b, dev) for b in batches_np]
    drop = torch.Generator(dev) if dropout else None
    calls = {"eager": step.eager, "captured": step}

    def run(kind, n=TRAIN_AB_STEPS):
        extra = () if drop is None else (drop.manual_seed(0),)
        p, s, metrics = p0, s0, []
        for b in batches[:n]:
            p, s, m = calls[kind](p, s, b, *extra)
            metrics.append(m)
        return p, s, metrics

    # the capture and a warm-up of the eager ops, outside the clock
    torch.cuda.synchronize()
    held0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run("captured", 1)
    torch.cuda.synchronize()
    g = next(iter(step.graphs.values()))
    capture = {"s": time.perf_counter() - t0, "peak_above_bytes": torch.cuda.max_memory_allocated() - held0,
               "held_bytes": torch.cuda.memory_allocated() - held0,
               "reserved_bytes": torch.cuda.memory_reserved() - reserved0,
               "static_bytes": sum(t.nbytes for t in tree_leaves((g.static_in, g.static_out)) if t.device.type == dev.type)}
    del g
    run("eager", 1)
    rows, ref = [], None
    for kind in TRAIN_AB_RUNS:
        replays = sum(g.replays for g in step.graphs.values())
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, s, metrics = run(kind)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_AB_STEPS
        row = {"step": kind, "ms_per_step": ms, "peak_above_bytes": torch.cuda.max_memory_allocated() - start,
               "reserved_bytes": torch.cuda.memory_reserved() - reserved0,
               "replays": sum(g.replays for g in step.graphs.values()) - replays}
        got = (p, s, [{k: v.clone() for k, v in m.items()} for m in metrics])
        if ref is None:
            ref = got
        elif not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref))):
            bad = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref)))
            raise AssertionError(f"{name} train A/B: the {kind} run differs from the first run in {bad} leaves")
        row["losses"] = [{k: float(v) for k, v in m.items() if "loss" in k} for m in metrics]
        rows.append(row)
        del p, s, metrics, got
    if len(step.graphs) != 1 or [r["replays"] for r in rows] != [0 if r["step"] == "eager" else TRAIN_AB_STEPS
                                                                for r in rows]:
        raise AssertionError(f"{name} train A/B: {len(step.graphs)} graphs, replays {[r['replays'] for r in rows]}")
    # the copies of one captured step
    extra = () if drop is None else (drop.manual_seed(0),)
    n_counts = sum(1 for x in tree_leaves(s0) if x.device.type == "cpu" and x.ndim == 0 and not x.is_floating_point())
    with served_copies(torch) as copies:
        outs = step(p0, s0, batches[0], *extra)
    n_in, n_out = len(tree_leaves((p0, s0, batches[0]))) - n_counts, len(tree_leaves(outs)) - n_counts
    by_op = {}
    for key, c in copies.rows.items():
        by_op[key.split(" ")[0]] = by_op.get(key.split(" ")[0], 0) + c
    if by_op != {"copy_": n_in, "clone": n_out}:
        raise AssertionError(f"{name} train A/B: a captured step copied {by_op}, not {n_in} in and {n_out} out")
    del outs
    splits = {kind: time_split(torch, lambda *_: run(kind, TRAIN_AB_SPLIT), None, None) for kind in ("eager", "captured")}
    by = {k: [r for r in rows if r["step"] == k] for k in ("eager", "captured")}
    print(f"train A/B, {what}: {TRAIN_AB_STEPS} steps a run, eager / captured / captured / eager, losses, params "
          f"and optimizer states bit-equal in all four (cuDNN deterministic, TF32 off); eager "
          + ", ".join(f"{r['ms_per_step']:.2f}" for r in by["eager"]) + " ms/step, captured (one CUDA-graph replay a "
          "step) " + ", ".join(f"{r['ms_per_step']:.2f}" for r in by["captured"]) + " ms/step (host clock); the capture "
          f"(warm-up, capture, one replay) {capture['s']:.2f} s, its peak {capture['peak_above_bytes'] / 2**30:.3f} "
          f"GiB above the inputs, then held +{capture['held_bytes'] / 2**30:.3f} GiB (the graph's static trees "
          f"{capture['static_bytes'] / 2**30:.3f}), reserved +{capture['reserved_bytes'] / 2**30:.3f} GiB; a run's "
          "peak above its start: eager " + ", ".join(f"{r['peak_above_bytes'] / 2**30:.3f}" for r in by["eager"])
          + " GiB, captured " + ", ".join(f"{r['peak_above_bytes'] / 2**30:.3f}" for r in by["captured"])
          + " GiB; reserved after each run, above the inputs': "
          + ", ".join(f"{r['step']} +{r['reserved_bytes'] / 2**30:.3f}" for r in rows)
          + f" GiB; {len(step.graphs)} capture, {sum(r['replays'] for r in rows)} replays in the timed runs; one "
          f"captured step's host copies: {by_op['copy_']} copy_ ({copies.bytes['copy_'] / 1e9:.4f} GB) in, "
          f"{by_op['clone']} clone ({copies.bytes['clone'] / 1e9:.4f} GB) out | {smi}")
    for kind, split in splits.items():
        if not split:
            print(f"  {kind}: train time split not measured (the profiler recorded no kernel)")
            continue
        split["train_kinds"] = train_kinds(split)
        kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["train_kinds"].items(), key=lambda kv: -kv[1]))
        print(f"  {kind}, {TRAIN_AB_SPLIT} steps under torch.profiler: {split['wall_ms']:.2f} ms wall, device busy "
              f"{split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}%; busy "
              f"{split['busy_ms'] / TRAIN_AB_SPLIT:.2f} ms a step; largest other kernels: "
              + "; ".join(f"{k} {v:.2f}" for k, v in split["top_other"]) + f" | {smi}")
        if split["top_ops"]:
            print("    its device ms by op (own kernels): " + "; ".join(f"{k} {v:.2f}" for k, v in split["top_ops"]))
    for sp in splits.values():
        sp.pop("backward", None)
        sp.pop("other", None)
    return {"runs": rows, "capture": capture, "copies": by_op, "copy_bytes": copies.bytes, "splits": splits}


def _paths(tree, path=""):
    """Leaf paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in _paths(v, f"{path}.{i}")]
    return [path]


def eval_phase(torch, deconv_ops, cfg, params, dev):
    """The paper's deployment: surgery (padded -> cropping) on the trained
    weights, with the up-sampling on the deconv2d kernel, evaluated on an
    8-image batch. Returns the kernel's launches in that forward, the calls
    it made, and the metrics."""
    from repro_torch.core import substitute_pix2pix
    from repro_torch.data import PhantomConfig, phantom_batches
    from repro_torch.models import Pix2Pix
    from repro_torch.train import make_pix2pix_infer, psnr, ssim, to_uint8_range

    cfg_c = dataclasses.replace(substitute_pix2pix(cfg, "cropping"), deconv_backend="pallas")
    b = _tensors(torch, next(phantom_batches(8, PhantomConfig(IMG), seed=99)), dev)
    infer_c = make_pix2pix_infer(Pix2Pix(cfg_c))
    calls = []
    real = deconv_ops.deconv2d

    def recorder(*args, **kw):
        calls.append(("deconv2d", args, kw))
        return real(*args, **kw)

    deconv_ops.deconv2d = recorder
    try:
        torch.cuda.synchronize()
        deconv_ops.reset_launches()
        fake_c = infer_c(params, b["src"])
        torch.cuda.synchronize()
        launches = deconv_ops.launches["deconv2d"]
    finally:
        deconv_ops.deconv2d = real
    if launches != int(math.log2(IMG)):  # 7 up blocks + the final layer at img 256
        raise AssertionError(f"deconv2d launched {launches} times in one generator forward, want {int(math.log2(IMG))}")
    fake = make_pix2pix_infer(Pix2Pix(cfg))(params, b["src"])
    if tuple(fake_c.shape) != (8, IMG, IMG, 3) or not bool(torch.isfinite(fake_c).all()):
        raise AssertionError(f"surgery output: shape {tuple(fake_c.shape)} or non-finite values")
    diff = (fake_c - fake).abs().max().item()
    if diff > 1e-4:
        raise AssertionError(f"cropping + deconv2d kernel vs padded xla: max |delta| {diff:.3g} > 1e-4")
    real_u8, fake_u8 = to_uint8_range(b["dst"]), to_uint8_range(fake_c)
    metrics = {"ssim": float(ssim(real_u8, fake_u8).mean()) * 100, "psnr": float(psnr(real_u8, fake_u8).mean()),
               "max_delta_vs_padded_xla": diff, "deconv2d_launches": launches}
    print(
        f"surgery + eval (cropping, deconv_backend='pallas', 8 images): deconv2d launches {launches}, "
        f"max |cropping+kernel - padded xla| = {diff:.2e} (atol 1e-4); SSIM {metrics['ssim']:.2f}, "
        f"PSNR {metrics['psnr']:.2f} dB (5 steps of training: values only)"
    )
    return launches, calls, metrics


def attention_pairs(Sq, Sk, causal, window):
    """The (query, key) pairs inside ``attention_ref``'s mask, counted row
    by row: query i sits at key position i + Sk - Sq."""
    off, total = Sk - Sq, 0
    for i in range(Sq):
        qp = i + off
        hi = min(Sk, qp + 1) if causal else Sk
        lo = max(0, qp - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def lm_bound(name, a):
    """(bytes time, operations time) in ms for one LM kernel call: every
    input read once and every output written once over the HBM rate;
    operations over the operands' peak (``peak_flops``).
    Flash attention: 4 D operations per (query, key) pair inside the mask
    (the score and its share of P.V), for each query head. The SSD scan, as
    the kernel chunks it (``SSD_STEP``): per chunk of L steps the L(L+1)/2
    causal pairs of C.B^T once per group (n multiply-adds each) and of the
    decayed mix once per head (p each), plus per step and head the
    inter-chunk read-out and the state update (p n each)."""
    if name == "flash_attention":
        q, k = a["q"], a["k"]
        B, Sq, Hq, D = q.shape
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        ops = 4 * B * Hq * D * attention_pairs(Sq, k.shape[1], a["causal"], int(a["window"] or 0))
        dtype = q.dtype
    else:
        x, Bm = a["x"], a["B"]
        b, s, h, p = x.shape
        g, n = Bm.shape[2], Bm.shape[3]
        state = 4 * b * h * p * n if a["return_state"] else 0
        nbytes = x.element_size() * (2 * x.numel() + a["dt"].numel() + 2 * Bm.numel()) + 4 * h + state
        pairs = sum(min(SSD_STEP, s - c) * (min(SSD_STEP, s - c) + 1) // 2 for c in range(0, s, SSD_STEP))
        ops = 2 * b * (g * pairs * n + h * pairs * p + 2 * h * s * p * n)
        dtype = x.dtype
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_flops(dtype) * 1e3


def lm_library_fn(name, a):
    """``F.scaled_dot_product_attention`` with the boolean mask and GQA (a
    yardstick only; the port never calls it), or None: no one PyTorch call
    applies a softcap or computes the SSD scan."""
    import torch
    import torch.nn.functional as F

    if name != "flash_attention" or a["softcap"]:
        return None
    q, k, v = (a[n].transpose(1, 2) for n in ("q", "k", "v"))
    Sq, Sk, dev = q.shape[2], k.shape[2], q.device
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if a["causal"]:
        mask &= kpos <= qpos
    if a["window"]:
        mask &= (qpos - kpos) < a["window"]
    scale = a["scale"] if a["scale"] is not None else 1.0 / math.sqrt(q.shape[-1])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


class LMBench:
    """Checks and times one LM kernel call against its plain version."""

    def __init__(self, attn_ops, attn_ref, ssd_ops, ssd_ref):
        self.fns = {
            "flash_attention": (attn_ops.attention, attn_ref.attention_ref),
            "ssd": (ssd_ops.ssd, ssd_ref.ssd_chunked),
        }
        self.sig = {n: inspect.signature(op) for n, (op, _) in self.fns.items()}

    def args(self, name, *args, **kw):
        a = self.sig[name].bind(*args, **kw)
        a.apply_defaults()
        return dict(a.arguments)

    def run(self, name, a):
        """Flash: the kernel against ``attention_ref`` in the same dtype (atol
        3e-4 f32, 4e-2 bf16: the JAX package's pins); in bf16 also against
        ``attention_ref`` in f32 on the same (upcast) inputs, within
        ``FLASH_BF16_ATOL`` + ``FLASH_BF16_RTOL`` |out|, and the plain bf16
        version's own distance from it is recorded as a control. SSD: y and
        the final state against ``ssd_chunked`` in f32 on the same inputs
        (atol 3e-3 / 0.15 for f32 / bf16 inputs, rtol 2e-2), the JAX
        package's pins; its plain time is taken in the working dtype, A in
        x's dtype as the model passes it. ``max_abs_err`` is the error
        against the f32 reference."""
        import torch

        op, ref = self.fns[name]
        kernel = lambda: op(**a)  # noqa: E731
        got = kernel()
        bf16 = (a["q"] if name == "flash_attention" else a["x"]).dtype == torch.bfloat16
        a32 = {k: v.float() if isinstance(v, torch.Tensor) else v for k, v in a.items()}
        extra = {}
        if name == "flash_attention":
            plain = lambda: ref(**a)  # noqa: E731
            want = plain()
            checks = [(got, want, 4e-2 if bf16 else 3e-4, 0.0)]
            if bf16:
                want32 = ref(**a32)
                checks.insert(0, (got, want32, FLASH_BF16_ATOL, FLASH_BF16_RTOL))
                extra = {"err_vs_same_dtype_ref": (got.float() - want.float()).abs().max().item(),
                         "bf16_plain_vs_f32": (want.float() - want32).abs().max().item(),
                         "out_absmax": want32.abs().max().item(),
                         "out_rms": want32.square().mean().sqrt().item()}
        else:
            a32["return_state"] = True
            wy, wst = ref(**a32)
            atol, rtol = (0.15 if bf16 else 3e-3), 2e-2
            checks = [(got[0], wy, atol, rtol), (got[1], wst, atol, rtol)] if a["return_state"] else [(got, wy, atol, rtol)]
            aw = dict(a, A=a["A"].to(a["x"].dtype))
            plain = lambda: ref(**aw)  # noqa: E731
        torch.cuda.synchronize()
        errs = []
        for g, w, atol, rtol in checks:
            if g.shape != w.shape:
                raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
            d = (g.float() - w.float()).abs()
            errs.append(d.max().item())
            if not math.isfinite(errs[-1]) or (d - atol - rtol * w.float().abs()).max().item() > 0:
                raise AssertionError(
                    f"{name} {describe_lm(name, a)}: max abs err {errs[-1]:.3g} beyond atol {atol:g}, rtol {rtol:g}"
                )
        err = errs[0] if name == "flash_attention" else max(errs)
        bytes_ms, ops_ms = lm_bound(name, a)
        ms, host_ms = cuda_ms(kernel)
        peak = BF16_FLOPS if bf16 else FP32_ACCURATE_FLOPS
        plain_ms, _ = cuda_ms(plain, reps=5)
        lib = lm_library_fn(name, a)
        library_ms = cuda_ms(lib)[0] if lib is not None else None
        return {"max_abs_err": err, "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                "tflop_s": ops_ms * peak / ms / 1e12, "bound_share": max(bytes_ms, ops_ms) / ms, **extra}


def ptxas_report(log):
    """ptxas' ``-v`` report, by entry function: ``{mangled name:
    {"registers", "spill_stores", "spill_loads", "static_smem"}}`` (spills
    and shared memory in bytes; dynamic shared memory is not in the log)."""
    out, cur = {}, None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line):
            cur = out.setdefault(m.group(1), dict.fromkeys(("registers", "spill_stores", "spill_loads", "static_smem"), 0))
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            if m := re.search(r"Used (\d+) registers", line):
                cur["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                cur["static_smem"] = int(m.group(1))
    return out


def flash_tc_report(log, smem_bytes, kernel="flash_kernel_tc"):
    """The flash tensor-core instantiations in a build log, by head width:
    ``flash_kernel_tc<D>`` (bf16) or, with ``kernel="flash_kernel_tf32"``,
    the f32 entry's; ptxas' registers and spills, and the dynamic shared
    memory a launch asks for (``smem_bytes(D)``)."""
    rows = {}
    for fn, r in ptxas_report(log).items():
        if m := re.search(rf"{kernel}ILi(\d+)E", fn):
            D = int(m.group(1))
            rows[D] = {**r, "dynamic_smem": smem_bytes(D)}
    return dict(sorted(rows.items()))


def phase_report(log, smem_bytes):
    """The phase GEMM, conv GEMM and narrow instantiations of
    ``phase_gemm.cuh`` and ``fused_blocks.cu`` in a build log: ptxas'
    registers and spills, and the dynamic shared memory a launch asks for
    (``smem_bytes(esize, narrow, tile_rows)``: the conv GEMM's tiles are the
    phase GEMM's; the narrow kernel's at its largest tile, 8 input rows). A
    bf16 GEMM that writes fp32 (for a norm) is marked ``f32 out``."""
    rows = {}
    for fn, r in ptxas_report(log).items():
        if m := re.search(r"(phase|conv)_gemm_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E(f?)", fn):
            f32, bm = m.group(2) == "f", int(m.group(3))
            out = ",f32 out" if not f32 and m.group(5) == "f" else ""
            key = f"{m.group(1)}_gemm<{'f32' if f32 else 'bf16'},{bm},{'vec' if m.group(4) == '1' else 'scalar'}{out}>"
            rows[key] = {**r, "dynamic_smem": smem_bytes(4 if f32 else 2, 0, bm)}
        elif m := re.search(r"narrow_kernelI(f|13__nv_bfloat16)Li(\d)E", fn):
            key = f"narrow<{'f32' if m.group(1) == 'f' else 'bf16'},{m.group(2)}>"
            rows[key] = {**r, "dynamic_smem": smem_bytes(0, 1, 8)}
    return dict(sorted(rows.items()))


def ssd_report(log, smem_bytes):
    """The SSD passes' instantiations (``ssd_{cb,state,scan}_kernel<X, N>``,
    ``ssd_pass_kernel``) in a build log: ptxas' registers and spills, and
    the dynamic shared memory a launch asks for (``smem_bytes(esize, n,
    pass)``, pass 0 cb, 1 state, 2 scan; the passing kernel has none)."""
    rows = {}
    for fn, r in ptxas_report(log).items():
        if m := re.search(r"ssd_(cb|state|pass|scan)_kernel(?:I(f|13__nv_bfloat16)Li(\d+)E)?", fn):
            which, t, n = m.group(1), m.group(2), m.group(3)
            key = f"ssd_{which}" + (f"<{'f32' if t == 'f' else 'bf16'},{n}>" if t else "")
            pas = {"cb": 0, "state": 1, "scan": 2}.get(which)
            dyn = smem_bytes(4 if t == "f" else 2, int(n), pas) if t and pas is not None else 0
            rows[key] = {**r, "dynamic_smem": dyn}
    return dict(sorted(rows.items()))


# kernel name fragment -> the conv_block / deconv_block pass it belongs to
BLOCK_PASSES = (("conv_gemm_kernel", "gemm"), ("phase_gemm_kernel", "gemm"), ("narrow_kernel", "narrow"),
                ("splitk_reduce", "split-K sum"), ("stats_", "statistics"), ("norm_act", "normalise"))
# the SSD scan's four passes (csrc/ssd.cu)
SSD_PASSES = (("ssd_cb_kernel", "C.B^T"), ("ssd_state_kernel", "chunk states"), ("ssd_pass_kernel", "state passing"),
              ("ssd_scan_kernel", "chunk scan"))


def device_split(torch, fn, reps=5, passes=BLOCK_PASSES):
    """Device ms per call of ``fn``, by pass (``passes``), under
    ``torch.profiler``; empty when the profiler recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = next((k for frag, k in passes if frag in e.key), "other")
        out[kind] = out.get(kind, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def describe_lm(name, a):
    if name == "flash_attention":
        soft = f" softcap {a['softcap']:g}" if a["softcap"] else ""
        mode = "" if a["causal"] else " non-causal"
        return (f"q{tuple(a['q'].shape)} k{tuple(a['k'].shape)} window {a['window'] or 0}{soft}{mode} "
                f"{str(a['q'].dtype)[6:]}")
    return f"x{tuple(a['x'].shape)} B{tuple(a['B'].shape)} {str(a['x'].dtype)[6:]}"


def lm_classes(torch, dev):
    """The LM kernels' shape classes on random inputs (the JAX package's
    distributions), each in f32 and bf16: flash at Hymba-1.5B's local and
    global prefill layers, gemma2's D 256 softcap class, a ragged length
    and Sq < Sk; the SSD scan at Hymba-1.5B, Mamba2-2.7B's n 128 class, 4
    groups, and a ragged length."""
    import torch.nn.functional as F

    g = torch.Generator(dev).manual_seed(3)
    t = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale  # noqa: E731
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Sk, Hq, Hk, D, window, softcap in (
            (2, 4096, 4096, 25, 5, 64, 1024, None), (2, 4096, 4096, 25, 5, 64, 0, None),
            (1, 4096, 4096, 8, 4, 256, 4096, 50.0), (2, 1000, 1000, 25, 5, 64, 256, None),
            (2, 384, 4096, 25, 5, 64, 1024, None),
        ):
            q, k, v = t(B, Sq, Hq, D).to(dtype), t(B, Sk, Hk, D).to(dtype), t(B, Sk, Hk, D).to(dtype)
            out.append(("flash_attention", (q, k, v), dict(causal=True, window=window, softcap=softcap)))
        for b, s, h, p, gg, n, ch in (
            (2, 4096, 50, 64, 1, 16, 256), (1, 2048, 80, 64, 1, 128, 256), (2, 512, 4, 64, 4, 64, 128),
            (2, 1000, 50, 64, 1, 16, 256),
        ):
            x, dt = t(b, s, h, p).to(dtype), F.softplus(t(b, s, h)).to(dtype)
            A = -torch.exp(t(h, scale=0.5))
            Bm, Cm = t(b, s, gg, n, scale=0.5).to(dtype), t(b, s, gg, n, scale=0.5).to(dtype)
            out.append(("ssd", (x, dt, A, Bm, Cm), dict(chunk=ch, return_state=True)))
    return out


@contextlib.contextmanager
def patched(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def _rel_norm(a, b):
    """Relative Frobenius difference ||a - b|| / ||b||, in float32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _prefill_leaves(res):
    logits, c = res
    return {"logits": logits, "kv.k": c["kv"]["k"], "kv.v": c["kv"]["v"], "ssm.conv": c["ssm"]["conv"],
            "ssm.ssm": c["ssm"]["ssm"]}


# Tolerances of the kernel-routed prefill against the plain-ops prefill,
# fixed before the first run (PERF.md §6). f32: both routes compute one
# function in fp32 and differ only in summation order (online vs full
# softmax, SSD steps of 64 vs chunks of 256), ~1e-7 relative per op grown
# through 32 residual layers: relative Frobenius difference <= 1e-4 for the
# logits and the f32 SSM states, <= 1e-3 for what is stored in bf16 (KV
# caches, conv tails: a 1e-7 change can flip a bf16 rounding). bf16: the
# plain route rounds inside attention and the scan (bf16 scores, probs,
# cumsum), the kernels accumulate in fp32; each leaf's difference between
# the two bf16 routes must stay within twice the plain bf16 route's own
# distance from the f32 plain prefill, plus 1e-3.
PREFILL_F32_TOL = {"logits": 1e-4, "kv.k": 1e-3, "kv.v": 1e-3, "ssm.conv": 1e-3, "ssm.ssm": 1e-4}


def time_split(torch, prefill, params, tokens):
    """One ``prefill(params, tokens)`` (a prefill or a training step) under
    ``torch.profiler``: device time by kind of kernel (the two LM kernels,
    matmuls, everything else), the device's idle share of the CUDA-event
    wall of the same run (the profiler's own host cost included), the ops
    whose own kernels take the most device time (``top_ops``) and the
    backward nodes whose kernels, theirs and their ops', take the most
    (``top_backward``; every node's in ``backward``), and the device ms of
    every kernel outside the LM kernels and the matmuls (``other``). Empty
    when the profiler recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        prefill(params, tokens)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    by_kind, other, ops, backward = {}, {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            if e.key.startswith("autograd::engine::evaluate_function: "):
                backward[e.key.split(": ", 1)[1]] = e.device_time_total / 1e3
            elif e.self_device_time_total > 0:
                ops[e.key] = e.self_device_time_total / 1e3
            continue
        low, ms = e.key.lower(), e.self_device_time_total / 1e3
        if "flash_kernel" in low:
            kind = "flash_attention"
        elif "ssd_" in low:  # the four passes of csrc/ssd.cu: ssd_{cb,state,pass,scan}_kernel
            kind = "ssd"
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            kind = "matmul"
        else:
            kind = "other"
            other[e.key[:60]] = other.get(e.key[:60], 0.0) + ms
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    busy = sum(by_kind.values())
    if busy == 0.0:
        return {}
    def top(d, k):
        return sorted(d.items(), key=lambda kv: -kv[1])[:k]

    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall, "by_kind": by_kind,
            "top_other": top(other, 5), "top_ops": top(ops, 8), "top_backward": top(backward, 6),
            "backward": backward, "other": other}


def hymba_prefill_phase(torch, smi, dev, lm_bench, attn_ops, attn_ref, ssd_ops, ssd_ref):
    """Hymba-1.5B's prefill at full width, through the kernels and on the
    plain ops. Returns the config, the parameters, the main-path launches,
    the kernels' calls of one prefill in each dtype grouped by shape
    (``{dtype name: [(kernel, args, count)]}``), and rows."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import build_model, get_arch
    from repro_torch.nn.module import param_count
    from repro_torch.train import make_lm_prefill

    cfg = get_arch("hymba_1_5b").config
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n = param_count(params)
    if n != HYMBA_PARAMS:
        raise AssertionError(f"hymba-1.5b has {n} parameters, want {HYMBA_PARAMS}")
    print(f"hymba-1.5b: {n:,} random f32 parameters on the card in {time.perf_counter() - t0:.1f} s")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (PREFILL_B, PREFILL_S)).astype(np.int32)
    ).to(dev)
    groups = {}

    def recorder(key, name, real):
        def f(*args, **kw):
            a = lm_bench.args(name, *args, **kw)
            sig = (name, describe_lm(name, a), a.get("window"), a.get("chunk"))
            groups.setdefault(key, {}).setdefault(sig, [a, 0])[1] += 1
            return real(*args, **kw)

        return f

    results, rows, launches = {}, {}, None
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        prefill = make_lm_prefill(build_model(dataclasses.replace(cfg, act_dtype=dtype)))
        # warm-up, recording the kernels' calls by shape
        with patched(attn_ops, "attention", recorder(key, "flash_attention", attn_ops.attention)), \
                patched(ssd_ops, "ssd", recorder(key, "ssd", ssd_ops.ssd)):
            prefill(params, tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        attn_ops.reset_launches()
        ssd_ops.reset_launches()
        kernels.grad_routes.clear()
        t0 = time.perf_counter()
        start.record()
        kern = prefill(params, tokens)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        launches = {**attn_ops.launches, **ssd_ops.launches}
        if launches != {"flash_attention": cfg.n_layers, "ssd": cfg.n_layers} or kernels.grad_routes:
            raise AssertionError(f"{key} prefill launched {launches}, want {cfg.n_layers} of each; plain routes "
                                 f"taken for autograd {dict(kernels.grad_routes)}, want none")
        ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated()
        split = time_split(torch, prefill, params, tokens)
        rows[f"{key}_split"] = split
        if not split:
            print(f"prefill {key} time split: not measured (the profiler recorded no kernel)")
        else:
            kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["by_kind"].items(), key=lambda kv: -kv[1]))
            print(f"prefill {key} under torch.profiler: {split['wall_ms']:.2f} ms wall, device busy "
                  f"{split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}%; largest other: "
                  + "; ".join(f"{k} {v:.2f}" for k, v in split["top_other"]))
        with patched(attn_ops, "attention", attn_ref.attention_ref), patched(ssd_ops, "ssd", ssd_ref.ssd_chunked):
            start.record()
            plain = prefill(params, tokens)
            end.record()
            torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        results[key] = {"kernel": _prefill_leaves(kern), "plain": _prefill_leaves(plain)}
        shapes = {k: tuple(v.shape) for k, v in results[key]["kernel"].items()}
        for leaf, v in results[key]["kernel"].items():
            if not bool(torch.isfinite(v.float()).all()) or tuple(v.shape) != tuple(results[key]["plain"][leaf].shape):
                raise AssertionError(f"{key} prefill {leaf}: non-finite values or shape {tuple(v.shape)}")
        tok_s = PREFILL_B * PREFILL_S / (ms / 1e3)
        rows[key] = {"ms": ms, "host_ms": host_ms, "plain_route_ms": plain_ms, "tokens_per_s": tok_s,
                     "peak_bytes": peak, "launches": launches, "shapes": shapes}
        print(
            f"prefill {key} (batch {PREFILL_B} x {PREFILL_S} tokens): launches {json.dumps(launches)}; "
            f"{ms:.2f} ms on the card (host {host_ms:.2f}), {tok_s:,.0f} tokens/s, peak {peak / 2**30:.2f} GiB; "
            f"plain-ops route {plain_ms:.2f} ms | {smi}"
        )
    f32, b16 = results["float32"], results["bfloat16"]
    checks = {}
    for leaf, tol in PREFILL_F32_TOL.items():
        d = _rel_norm(f32["kernel"][leaf], f32["plain"][leaf])
        e_plain = _rel_norm(b16["plain"][leaf], f32["plain"][leaf])
        e_kern = _rel_norm(b16["kernel"][leaf], f32["plain"][leaf])
        d16 = _rel_norm(b16["kernel"][leaf], b16["plain"][leaf])
        tol16 = 2 * e_plain + 1e-3
        checks[leaf] = {"f32_rel": d, "f32_tol": tol, "bf16_rel": d16, "bf16_tol": tol16,
                        "bf16_plain_vs_f32": e_plain, "bf16_kernel_vs_f32": e_kern}
        print(f"  {leaf:8s} f32 kernel vs plain {d:.3e} (<= {tol:g}); bf16 kernel vs plain {d16:.3e} "
              f"(<= {tol16:.3e}); vs the f32 plain prefill: bf16 plain {e_plain:.3e}, bf16 kernel {e_kern:.3e}")
        if not d <= tol or not d16 <= tol16:
            raise AssertionError(f"prefill {leaf}: kernel route vs plain ops beyond tolerance {checks[leaf]}")
    rows["checks"] = checks
    calls = {}
    for key, g in groups.items():
        calls[key] = [(name, a, count) for (name, *_), (a, count) in g.items()]
        if sorted((nm, c) for nm, _, c in calls[key]) != sorted(
            [("flash_attention", cfg.n_layers - len(cfg.global_layers)), ("flash_attention", len(cfg.global_layers)),
             ("ssd", cfg.n_layers)]
        ):
            raise AssertionError(
                f"unexpected {key} prefill kernel calls {[(nm, describe_lm(nm, a), c) for nm, a, c in calls[key]]}"
            )
    return cfg, params, launches, calls, rows


def check_captured(step, count, what):
    """``step`` (``make_lm_decode_step``'s) ran ``count`` decode steps as
    replays of one CUDA graph, captured once for the one cache set (its
    counts outlive the graph, which goes with the caches)."""
    if (step.captures, step.replays) != (1, count):
        raise AssertionError(f"{what}: {step.captures} CUDA graphs captured and {step.replays} replays, not one "
                             f"replayed {count} times")


def hymba_decode_phase(torch, smi, dev, cfg, params):
    """decode_step over a 16-token prompt (f32 activations and caches)
    against __call__ at the same positions, then greedy_generate with
    launch/serve.py --mode lm's defaults (batch 4, prompt 16, 16 tokens)."""
    import numpy as np

    from repro_torch.configs import build_model
    from repro_torch.train import greedy_generate, make_lm_decode_step

    model = build_model(dataclasses.replace(cfg, act_dtype=torch.float32))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)).to(dev)
    with torch.no_grad():
        full, _ = model(params, toks)
    step = make_lm_decode_step(model)
    caches = model.init_caches(2, 16, dtype=torch.float32, device=dev)
    outs = []
    for t in range(16):
        lg, caches = step(params, toks[:, t : t + 1], caches, t)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    torch.cuda.synchronize()
    check_captured(step, 16, "hymba-1.5b decode")
    err = (dec - full).abs().max().item()
    torch.testing.assert_close(dec, full, atol=5e-2, rtol=1e-2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)).to(dev)
    greedy_generate(model, params, prompt[:, :2], 2, 4, cache_dtype=torch.float32)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = greedy_generate(model, params, prompt, 16, 32, cache_dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(gen.shape) != (4, 16) or not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError(f"greedy_generate gave {tuple(gen.shape)} / out-of-vocabulary ids")
    row = {"decode_vs_call_max_abs_err": err, "generate_wall_s": wall, "tokens_per_s": 4 * 16 / wall,
           "ms_per_step": wall * 1e3 / 31}
    print(
        f"decode (f32, 16 tokens, batch 2, one CUDA graph replayed 16 times) vs __call__: max |delta logits| "
        f"{err:.3e} (atol 5e-2, rtol 1e-2); "
        f"greedy_generate batch 4, prompt 16, 16 new: {row['tokens_per_s']:.1f} tokens/s, "
        f"{row['ms_per_step']:.1f} ms per decode step (host clock) | {smi}"
    )
    row["decode_ab"] = decode_ab(torch, smi, "hymba_1_5b", cfg, params, dev)
    return row


# the decode A/B at full width and depth (``decode_ab``): batch per arch;
# caches of decode_32k's length, bf16 weights, activations and caches; the
# steps of the run under the profiler
DECODE_AB_B = {"gemma2_2b": 2, "hymba_1_5b": 4}
DECODE_AB_LEN, DECODE_AB_PROMPT, DECODE_AB_NEW, DECODE_AB_SPLIT = 32768, 8, 8, 4


def cache_copies(torch, limit):
    """A ``TorchDispatchMode`` whose ``rows`` count, while it is entered,
    every op whose output is a new tensor (not a view of its inputs nor an
    in-place write into them) of ``limit`` bytes or more, by op, shape and
    the ``repro_torch`` lines that called it: where a decode step copies a
    cache."""
    import traceback

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class CacheCopies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {x.untyped_storage().data_ptr() for x in tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)}
            for o in tree_leaves(out):
                if isinstance(o, torch.Tensor) and o.nbytes >= limit and o.untyped_storage().data_ptr() not in ins:
                    where = [f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}" for f in traceback.extract_stack()
                             if "repro_torch" in f.filename][-2:]
                    key = f"{func} {tuple(o.shape)} at {' <- '.join(where[::-1])}"
                    self.rows[key] = self.rows.get(key, 0) + 1
            return out

    mode = CacheCopies()
    mode.rows = {}
    return mode


def stacked_grad_copies(torch, leaves):
    """A ``TorchDispatchMode`` whose ``rows`` count, while it is entered,
    the new tensors (not in an input's storage) of a stacked leaf's shape
    and dtype that the backward makes in a node which hands its gradient
    to a leaf of that shape (an edge into the leaf's ``AccumulateGrad``):
    the stacked leaves' gradients and the sums they are added into, by op
    and shape. ``leaves``: the stacked parameter leaves (their shapes and
    dtypes)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    kinds = {(tuple(t.shape), t.dtype) for t in leaves}

    class StackedGradCopies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            node = torch._C._current_autograd_node()
            if node is None:
                return out
            feeds = {(tuple(f.variable.shape), f.variable.dtype) for f, _ in node.next_functions
                     if f is not None and hasattr(f, "variable")}
            ins = {x.untyped_storage().data_ptr() for x in tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)}
            for o in tree_leaves(out):
                kind = (tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor) else None
                if kind in kinds and kind in feeds and o.untyped_storage().data_ptr() not in ins:
                    key = (str(func), kind[0])
                    self.rows[key] = self.rows.get(key, 0) + 1
            return out

    mode = StackedGradCopies()
    mode.rows = {}
    return mode


def decode_ab(torch, smi, arch, cfg, params, dev):
    """Greedy decoding of ``arch`` at full width and depth (the weights
    ``params`` cast to bf16, bf16 activations and caches of
    ``DECODE_AB_LEN`` slots, batch ``DECODE_AB_B[arch]``, a
    ``DECODE_AB_PROMPT``-token prompt fed token by token, then
    ``DECODE_AB_NEW`` greedy tokens: ``greedy_generate``'s loop), the eager
    ``model.decode_step`` against the captured step
    (``make_lm_decode_step``: the step captured into one CUDA graph per
    cache set and replayed for every token), both writing into the loop's
    caches, in turns (eager, captured, captured, eager, after a short
    warm-up of each): the generated tokens bit-equal in all four; each
    captured run replays a graph at every step and captures one at its
    first step (the previous run's caches, and the graph on them, are
    gone); only the warm-up run's capture warms up first, on scratch
    caches (its first step timed and its peak taken). Each run's first
    step is taken before its clock starts and reported apart; then ms per step over the other steps (host clock,
    synchronised at its end) and the peak memory of those steps
    (``max_memory_allocated`` from a reset after the first, the weights and
    the caches included). Then ``DECODE_AB_SPLIT`` steps of each under
    ``torch.profiler`` (``time_split``, the captured step's graph captured
    before): the device's busy time a step, its idle share, its top ops
    and kernels; and one eager step under ``cache_copies``: the phase
    fails if an op of the step makes a new tensor of one layer's KV cache
    size or more. Returns the rows and the splits."""
    import numpy as np

    from repro_torch.configs import build_model
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import make_lm_decode_step

    B, n = DECODE_AB_B[arch], DECODE_AB_PROMPT + DECODE_AB_NEW - 1
    model = build_model(dataclasses.replace(cfg, act_dtype=torch.bfloat16))
    steps = {"eager": torch.no_grad()(model.decode_step), "captured": make_lm_decode_step(model)}
    captured = steps["captured"]
    weights = tree_map(lambda t: t.to(torch.bfloat16), params)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, DECODE_AB_PROMPT)).astype(np.int32)).to(dev)

    def loop(step, w, caches, count, first=None):
        return _decode_loop(torch, step, w, prompt, caches, count, first)

    def new_caches():
        return model.init_caches(B, DECODE_AB_LEN, dtype=torch.bfloat16, device=dev)

    def run(name, count=n):
        # handed over, not held here: the loop's caches are the only reference
        caches = [new_caches()]
        cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(caches[0]))
        graphs, replayed = captured.captures, captured.replays
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark = {"t0": time.perf_counter()}

        def first():
            torch.cuda.synchronize()
            mark["first_s"] = time.perf_counter() - mark["t0"]
            mark["first_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mark["t1"] = time.perf_counter()

        tokens = loop(steps[name], weights, caches.pop(), count, first)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - mark["t1"]) * 1e3 / (count - 1)
        if name == "captured" and (captured.replays - replayed != count or captured.captures - graphs != 1):
            raise AssertionError(f"{arch} decode A/B: the captured run replayed {captured.replays - replayed} of "
                                 f"{count} steps with {captured.captures - graphs} new captures")
        return {"step": name, "ms_per_step": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
                "first_step_s": mark["first_s"], "first_step_peak_bytes": mark["first_peak"],
                "cache_bytes": cache_bytes, "tokens": tokens}

    with torch.no_grad():
        warm = {name: run(name, 4) for name in steps}  # the captured step's capture at its first step
        runs = [run(k) for k in ("eager", "captured", "captured", "eager")]
        splits = {"eager": time_split(torch, lambda w, c: loop(steps["eager"], w, c, DECODE_AB_SPLIT), weights,
                                      new_caches())}
        caches = new_caches()
        loop(captured, weights, caches, 1)  # its capture, outside the profile
        splits["captured"] = time_split(torch, lambda w, c: loop(captured, w, c, DECODE_AB_SPLIT), weights, caches)
        layer_bytes = min(a.nbytes // a.shape[0] for a in tree_leaves(caches) if DECODE_AB_LEN in a.shape)
        with cache_copies(torch, layer_bytes) as copies:
            steps["eager"](weights, prompt[:, :1], caches, 0)
        del caches
    first = runs[0]["tokens"]
    if tuple(first.shape) != (B, DECODE_AB_NEW) or not all(torch.equal(r["tokens"], first) for r in runs):
        raise AssertionError(f"{arch} decode A/B: the eager and captured steps generated different tokens")
    for r in runs + list(warm.values()):
        r.pop("tokens")
    graphs, warm_ups = captured.captures, len(captured.warmed)
    del weights, steps, captured
    torch.cuda.empty_cache()
    by = {k: [r for r in runs if r["step"] == k] for k in ("eager", "captured")}
    print(f"decode A/B, {arch} full width and depth, batch {B}, bf16 weights and caches of {DECODE_AB_LEN} "
          f"slots ({runs[0]['cache_bytes'] / 2**30:.2f} GiB), prompt {DECODE_AB_PROMPT} + {DECODE_AB_NEW} greedy "
          f"tokens (bit-equal in all four runs), both in place: eager "
          + ", ".join(f"{r['ms_per_step']:.2f}" for r in by["eager"]) + " ms per step, peak "
          + ", ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in by["eager"]) + " GiB; captured (one CUDA-graph "
          "replay a step) " + ", ".join(f"{r['ms_per_step']:.2f}" for r in by["captured"]) + " ms per step, peak "
          + ", ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in by["captured"]) + " GiB (host clock, steps 2 to "
          f"{n}); first step eager " + ", ".join(f"{r['first_step_s']:.2f}" for r in by["eager"]) + " s, captured "
          + ", ".join(f"{r['first_step_s']:.2f}" for r in by["captured"]) + f" s; {graphs} graphs captured in "
          f"all, one a run, {warm_ups} warm-up, at the warm-up run's first step with its capture: "
          f"{warm['captured']['first_step_s']:.2f} s, peak {warm['captured']['first_step_peak_bytes'] / 2**30:.2f} "
          f"GiB (its scratch caches included) | {smi}")
    for name, split in splits.items():
        if not split:
            print(f"  {name}: decode time split not measured (the profiler recorded no kernel)")
            continue
        busy = split["busy_ms"] / DECODE_AB_SPLIT
        kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["by_kind"].items(), key=lambda kv: -kv[1]))
        print(f"  {name}, {DECODE_AB_SPLIT} steps under torch.profiler: {split['wall_ms']:.2f} ms wall, device "
              f"busy {split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}%; busy {busy:.2f} "
              f"ms a step against {min(r['ms_per_step'] for r in by[name]):.2f} ms a step without the profiler; "
              "largest other kernels: " + "; ".join(f"{k} {v:.2f}" for k, v in split["top_other"]) + f" | {smi}")
        if split["top_ops"]:
            print("    its device ms by op (own kernels): " + "; ".join(f"{k} {v:.2f}" for k, v in split["top_ops"]))
    print(f"  one eager step, new tensors of a layer's KV cache ({layer_bytes / 2**20:.0f} MiB) or more: "
          + ("; ".join(f"x{c} {k}" for k, c in copies.rows.items()) or "none"))
    if copies.rows:
        raise AssertionError(f"{arch} decode: the step copies a cache: {copies.rows}")
    return {"runs": runs, "splits": splits, "graphs": graphs,
            "capture": {k: warm["captured"][k] for k in ("first_step_s", "first_step_peak_bytes")}}


# gemma2-2b's decode over fresh caches per request (``decode_requests_ab``)
# and on a one-rank NCCL mesh (``decode_mesh_ab``), at ``decode_ab``'s size
# (batch 2, bf16, 32768 slots, 8 prompt + 8 greedy tokens). Predicted before
# the first run: each request's first step captures (the first also warms
# up, on scratch caches), no graph outlives its request, allocated memory
# after each request is what it was before it; a step of the requests as
# fast as decode_ab's captured step (12.23-12.36 ms, PR 28 run 5); the
# captured mesh step within 5% of it, its idle share under 10% (the eager
# mesh step's 89-91%)
DECODE_REQUESTS = 4
DECODE_REQUESTS_PREDICTED_MS = (12.0, 12.6)
DECODE_MESH_RUNS = ("eager", "captured", "captured", "eager")
DECODE_MESH_PREDICTED_RATIO = 1.05
DECODE_MESH_PREDICTED_IDLE = 0.10


def _decode_loop(torch, step, weights, prompt, caches, count, first=None):
    """``count`` decode calls of ``step`` on ``caches``, the prompt fed
    first, then greedy tokens; the greedy tokens (each a DTensor's local
    tensor on a mesh). ``first()`` is called after the first step."""
    tok, outs, n_prompt = prompt[:, :1], [], prompt.shape[1]
    for t in range(count):
        logits, caches = step(weights, tok, caches, t)
        if t + 1 < n_prompt:
            tok = prompt[:, t + 1 : t + 2]
        else:
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            outs.append(tok.to_local() if hasattr(tok, "to_local") else tok)
        if t == 0 and first is not None:
            first()
    return torch.cat(outs, 1) if outs else None


def decode_requests_ab(torch, smi, cfg, params, dev):
    """gemma2-2b (``cfg`` at full width and depth, ``params`` cast to bf16,
    bf16 activations and caches of ``DECODE_AB_LEN`` slots, batch
    ``DECODE_AB_B``) serving ``DECODE_REQUESTS`` requests of
    ``DECODE_AB_PROMPT`` prompt and ``DECODE_AB_NEW`` greedy tokens through
    one ``make_lm_decode_step`` step, each request on fresh caches dropped
    after it and with a prompt of its own; before each, the eager
    ``model.decode_step`` serves the same prompt on caches of its own.
    After each request: the step's captures, warm-ups (signatures warmed),
    live graphs, allocated and reserved GiB; its first step (the capture,
    with the signature's warm-up at the first request, and the first
    replay) in ms, then ms a step over the others (host clock, synchronised
    at the end). Fails unless every request's tokens are bit-equal to the
    eager step's, the requests took one capture each and one warm-up in
    all, no graph outlives its request, and the allocated memory after each
    request is what it was before it. Returns the rows."""
    import numpy as np

    from repro_torch.configs import build_model
    from repro_torch.nn.module import tree_map
    from repro_torch.train import make_lm_decode_step

    B, n = DECODE_AB_B["gemma2_2b"], DECODE_AB_PROMPT + DECODE_AB_NEW - 1
    model = build_model(dataclasses.replace(cfg, act_dtype=torch.bfloat16))
    weights = tree_map(lambda t: t.to(torch.bfloat16), params)
    eager, step = torch.no_grad()(model.decode_step), make_lm_decode_step(model)
    rng = np.random.default_rng(7)

    def serve(decode, prompt, marks):
        # the request's caches live in this call only
        caches = model.init_caches(B, DECODE_AB_LEN, dtype=torch.bfloat16, device=dev)

        def first():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        marks.append(time.perf_counter())
        tokens = _decode_loop(torch, decode, weights, prompt, caches, n, first)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return tokens

    rows = []
    with torch.no_grad():
        for r in range(DECODE_REQUESTS):
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, DECODE_AB_PROMPT)).astype(np.int32)).to(dev)
            want = serve(eager, prompt, [])
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            marks = []
            got = serve(step, prompt, marks)
            same = tuple(got.shape) == (B, DECODE_AB_NEW) and torch.equal(got, want)
            del got
            torch.cuda.synchronize()
            row = {"request": r, "bit_equal": same, "captures": step.captures, "warm_ups": len(step.warmed),
                   "live_graphs": len(step.graphs), "allocated_before_gib": before / 2**30,
                   "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                   "reserved_gib": torch.cuda.memory_reserved() / 2**30,
                   "first_step_ms": (marks[1] - marks[0]) * 1e3, "ms_per_step": (marks[2] - marks[1]) * 1e3 / (n - 1)}
            row["allocated_added_bytes"] = torch.cuda.memory_allocated() - before
            rows.append(row)
            print(f"  request {r}: tokens {'bit-equal to the eager step' if same else 'DIFFER'}; captures "
                  f"{row['captures']}, warm-ups {row['warm_ups']}, live graphs {row['live_graphs']}; allocated "
                  f"{row['allocated_gib']:.3f} GiB ({row['allocated_added_bytes']:+d} bytes against before the "
                  f"request), reserved {row['reserved_gib']:.2f} GiB; first step (capture"
                  f"{' after the warm-up' if r == 0 else ''} and first replay) {row['first_step_ms']:.1f} ms, then "
                  f"{row['ms_per_step']:.2f} ms a step | {smi}")
    replays = step.replays
    del weights, step, eager
    torch.cuda.empty_cache()
    ms = [r["ms_per_step"] for r in rows]
    lo, hi = DECODE_REQUESTS_PREDICTED_MS
    print(f"decode requests, gemma2-2b full width and depth, batch {B}, bf16 caches of {DECODE_AB_LEN} slots, "
          f"{DECODE_REQUESTS} requests of {DECODE_AB_PROMPT} + {DECODE_AB_NEW} tokens, each on fresh caches dropped "
          f"after it: {rows[-1]['captures']} captures, {rows[-1]['warm_ups']} warm-up, {replays} replays; "
          f"ms a step " + ", ".join(f"{v:.2f}" for v in ms) + f" (predicted {lo:g}-{hi:g}); first steps "
          + ", ".join(f"{r['first_step_ms']:.1f}" for r in rows) + f" ms | {smi}")
    bad = [r["request"] for r in rows if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"decode requests {bad}: the captured step's tokens differ from the eager step's")
    if [r["captures"] for r in rows] != list(range(1, DECODE_REQUESTS + 1)) or rows[-1]["warm_ups"] != 1:
        raise AssertionError(f"decode requests: captures {[r['captures'] for r in rows]}, warm-ups "
                             f"{rows[-1]['warm_ups']}; want one capture a request and one warm-up")
    if any(r["live_graphs"] or r["allocated_added_bytes"] for r in rows):
        raise AssertionError("decode requests: a graph or its memory outlived its request: "
                             + json.dumps([{k: r[k] for k in ("live_graphs", "allocated_added_bytes")} for r in rows]))
    return {"requests": rows, "ms_per_step": sum(ms) / len(ms), "fastest_ms": min(ms), "replays": replays}


def decode_mesh_ab(torch, smi, cfg, params, dev, plain_ms):
    """gemma2-2b's decode as in ``decode_requests_ab`` on a one-rank NCCL
    mesh (``launch.mesh.make_host_mesh``): the weights placed by
    ``dist.tree_shardings_shaped``, each run's fresh caches by
    ``dist.cache_shardings``, the prompt by ``dist.batch_sharding`` (every
    DTensor replicated, holding the plain tensor), the ops under
    ``dist.mesh_ops``. The eager ``model.decode_step`` and
    ``make_lm_decode_step``'s captured step in ``DECODE_MESH_RUNS`` order,
    after a warm run of each (DTensor's sharding propagation; the captured
    step's signature warm-up, an eager call, then its capture), each run on
    fresh caches from the same prompt: ms a step over steps 2 to n (host
    clock, synchronised at the end; the first step, a capture in the
    captured runs, before the clock), the tokens bit-equal in all four; then
    ``DECODE_AB_SPLIT`` steps of each under ``torch.profiler``
    (``time_split``: device busy, idle share). ``plain_ms``: the plain
    captured step's ms a step (its fastest request); the ratio takes the
    fastest captured run, since the card's spread moves whole runs (the
    plain captured step 11.1-11.2 or 12.2-12.4 ms a step within one process
    on an H100 80GB HBM3 at 700 W). Fails unless the tokens are bit-equal
    and each captured run captured once and replayed every step. Returns
    the rows."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import build_model
    from repro_torch.dist import batch_sharding, cache_shardings, default_rules, device_put, mesh_ops
    from repro_torch.dist import tree_shardings_shaped
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.module import tree_map
    from repro_torch.train import make_lm_decode_step

    B, n = DECODE_AB_B["gemma2_2b"], DECODE_AB_PROMPT + DECODE_AB_NEW - 1
    model = build_model(dataclasses.replace(cfg, act_dtype=torch.bfloat16))
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, DECODE_AB_PROMPT)).astype(np.int32)).to(dev)
    mesh = make_host_mesh(1, device=dev)
    try:
        rules = default_rules(False, mesh.mesh_dim_names)
        weights = tree_map(lambda t: t.to(torch.bfloat16), params)
        weights = device_put(weights, tree_shardings_shaped(mesh, model.axes(), weights, rules))
        prompt = device_put(prompt, batch_sharding(mesh, B, rules))
        steps = {"eager": torch.no_grad()(model.decode_step), "captured": make_lm_decode_step(model)}
        captured = steps["captured"]

        def new_caches():
            caches = model.init_caches(B, DECODE_AB_LEN, dtype=torch.bfloat16, device=dev)
            return device_put(caches, cache_shardings(mesh, caches, rules))

        def run(name, count=n):
            captures, replays, mark = captured.captures, captured.replays, {}

            def first():
                torch.cuda.synchronize()
                mark["t1"] = time.perf_counter()

            tokens = _decode_loop(torch, steps[name], weights, prompt, new_caches(), count, first)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - mark["t1"]) * 1e3 / (count - 1)
            return {"step": name, "ms_per_step": ms, "tokens": tokens,
                    "captures": captured.captures - captures, "replays": captured.replays - replays}

        with torch.no_grad(), mesh_ops():
            warm = [run(name, 3) for name in steps]
            runs = [run(name) for name in DECODE_MESH_RUNS]
            splits = {"eager": time_split(torch, lambda w, c: _decode_loop(torch, steps["eager"], w, prompt, c,
                                                                          DECODE_AB_SPLIT), weights, new_caches())}
            caches = new_caches()
            _decode_loop(torch, captured, weights, prompt, caches, 1)  # its capture, outside the profile
            splits["captured"] = time_split(torch, lambda w, c: _decode_loop(torch, captured, w, prompt, c,
                                                                            DECODE_AB_SPLIT), weights, caches)
            del caches
        del weights, steps, captured
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    first = runs[0]["tokens"]
    same = tuple(first.shape) == (B, DECODE_AB_NEW) and all(torch.equal(r["tokens"], first) for r in runs)
    for r in runs + warm:
        r.pop("tokens")
    by = {k: [r["ms_per_step"] for r in runs if r["step"] == k] for k in ("eager", "captured")}
    ratio = min(by["captured"]) / plain_ms
    print(f"decode on a one-rank NCCL mesh, gemma2-2b full width and depth, batch {B}, bf16 caches of "
          f"{DECODE_AB_LEN} slots, runs {' / '.join(DECODE_MESH_RUNS)}: ms a step eager "
          + ", ".join(f"{v:.2f}" for v in by["eager"]) + ", captured " + ", ".join(f"{v:.2f}" for v in by["captured"])
          + f" (the fastest {ratio:.3f}x the plain captured step's fastest, {plain_ms:.2f}, predicted <= "
          f"{DECODE_MESH_PREDICTED_RATIO:g}); "
          f"tokens {'bit-equal in all four runs' if same else 'DIFFER'}; the warm run's captures / replays "
          f"{warm[1]['captures']} / {warm[1]['replays']} of 3 calls (call 1 the warm-up), each captured run's "
          + ", ".join(f"{r['captures']} / {r['replays']}" for r in runs if r["step"] == "captured") + f" | {smi}")
    for name, split in splits.items():
        if not split:
            print(f"  mesh {name}: not measured (the profiler recorded no kernel)")
            continue
        kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["by_kind"].items(), key=lambda kv: -kv[1]))
        note = f" (predicted under {100 * DECODE_MESH_PREDICTED_IDLE:g}%)" if name == "captured" else ""
        print(f"  mesh {name}, {DECODE_AB_SPLIT} steps under torch.profiler: {split['wall_ms']:.2f} ms wall, device "
              f"busy {split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}%{note}; largest other "
              "kernels: " + "; ".join(f"{k} {v:.2f}" for k, v in split["top_other"]) + f" | {smi}")
    if not same:
        raise AssertionError("gemma2-2b mesh decode: the eager and captured steps generated different tokens")
    bad = [(r["captures"], r["replays"]) for r in runs if r["step"] == "captured" and (r["captures"], r["replays"])
           != (1, n)]
    if bad or (warm[1]["captures"], warm[1]["replays"]) != (1, 2):
        raise AssertionError(f"gemma2-2b mesh decode: captures / replays {bad or warm[1]}, want the warm-up then "
                             f"one capture a run and a replay a step")
    return {"runs": runs, "warm": warm, "ratio_to_plain": ratio, "bit_equal": same,
            "splits": {k: {m: v for m, v in sp.items() if m not in ("backward", "other")} for k, sp in splits.items()}}


def distinct_calls(bench, cs, names=REPLACES):
    """The distinct calls among ``cs`` (``(name, args, kw)`` of the kernels
    ``names``): ``{(name, desc, groups): [full kwargs, bias passed, count]}``."""
    out = {}
    for name, a_, kw in cs:
        if name in names:
            a, bias = bench.args(name, *a_, **kw)
            out.setdefault((name, describe(name, a, bias), a.get("groups")), [a, bias, 0])[2] += 1
    return out


def block_split(torch, ops, bench, calls, frames):
    """conv_block's and deconv_block's device time by pass (``device_split``)
    for each distinct call of one Pix2Pix + YOLOv8 frame pair
    (``capture_main_path_calls``), and summed over the served run (each
    call's count times ``frames`` of its model). Returns ``(rows, totals)``:
    rows ``[(name, desc, count, split)]``, totals ``{name: {pass: ms}}``."""
    rows, totals = [], {"conv_block": {}, "deconv_block": {}}
    for key, cs in calls.items():
        for (name, desc, _), (a, _, count) in distinct_calls(bench, cs, totals).items():
            op = getattr(ops, name)
            sp = device_split(torch, lambda: op(**a), reps=3)
            rows.append((name, desc, count, sp))
            for k, v in sp.items():
                totals[name][k] = totals[name].get(k, 0.0) + v * count * frames[key]
    return rows, totals


@contextlib.contextmanager
def recording(ops):
    """Within the block ``ops``' kernel functions are recorders: each call
    is appended, as ``(name, args, kw)``, to the list in ``sink[0]`` (the
    block's value), then made. The model ops bind ``ops``' functions when
    the models are built (Pix2Pix) or called (YOLO), so models built and
    run inside the block show exactly the calls their path makes."""
    sink = [[]]
    real = {n: getattr(ops, n) for n in REPLACES}

    def recorder(name):
        def f(*args, **kw):
            sink[0].append((name, args, kw))
            return real[name](*args, **kw)

        return f

    for n in REPLACES:
        setattr(ops, n, recorder(n))
    try:
        yield sink
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


def capture_main_path_calls(torch, ops, build_server, dev):
    """Every kernel call of one Pix2Pix and one YOLOv8 frame on the
    pallas_fused path of the server's models."""
    calls = {"pix": [], "yolo": []}
    with recording(ops) as sink:
        bundle = build_server(img=IMG, base=BASE, n_pix=1, n_yolo=1, impl="pallas", device=dev)
        for key, model in zip(("pix", "yolo"), bundle.models):
            sink[0] = calls[key]
            x = bundle.frame_for(bundle.streams[0 if key == "pix" else 1].name, 0)
            fused = model.segment_fn(0, model.n_layers, impl="pallas_fused")
            model.finalize(fused(model.params, model.init_state(x)))
    torch.cuda.synchronize()
    return calls


# The bf16 forward through the fused kernels against the plain-ops route,
# fixed before its first run by the bf16-prefill rule: each output's
# relative Frobenius distance from the same bf16 forward on the plain ops
# must stay within twice that plain bf16 route's own distance from the f32
# plain-ops forward, plus 1e-3. (The kernels keep the pre-norm values and
# the accumulators in fp32 where the plain bf16 route rounds them.)
def bf16_forward_phase(torch, ops, dev, img=IMG, base=BASE):
    """One frame each through full-width Pix2Pix (cropping, batch norm) and
    YOLOv8n with ``act_dtype=bfloat16`` on the ``pallas_fused`` path (the
    served segments' ops), with the launch counters set to 0 just before
    each; the same models' ``run_all`` on the plain ops in bf16 and in f32.
    Returns the kernels' launches per model, the checks per output and
    every kernel call per model (``recording``)."""
    from repro_torch.core.pipeline import pix2pix_staged, yolo_staged
    from repro_torch.models import Pix2PixConfig, Pix2PixGenerator, YOLOv8, YOLOv8Config

    pcfg = Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping")
    ycfg = YOLOv8Config(img_size=img)
    models = (
        ("pix", pix2pix_staged, pcfg, {"generator": Pix2PixGenerator(pcfg).init(torch.Generator(dev).manual_seed(0))}),
        ("yolo", yolo_staged, ycfg, YOLOv8(ycfg).init(torch.Generator(dev).manual_seed(1))),
    )
    frame = torch.randn((1, img, img, 3), generator=torch.Generator(dev).manual_seed(5), device=dev)
    launches, checks, calls = {}, {}, {}
    for key, staged, cfg, params in models:
        with recording(ops) as sink, torch.no_grad():
            calls[key] = sink[0]
            m16 = staged(dataclasses.replace(cfg, act_dtype=torch.bfloat16), params)
            fused = m16.segment_fn(0, m16.n_layers, impl="pallas_fused")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ops.reset_launches()
            got = m16.finalize(fused(m16.params, m16.init_state(frame)))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches[key] = dict(ops.launches)
        with torch.no_grad():
            plain16 = m16.run_all(frame)
            plain32 = staged(cfg, params).run_all(frame)
        outs = [(key, got, plain16, plain32)] if key == "pix" else [
            (f"{key}.{k}", got[k], plain16[k], plain32[k]) for k in ("p3", "p4", "p5")]
        for name, g, w16, w32 in outs:
            if g.dtype != torch.bfloat16 or g.shape != w16.shape or not bool(torch.isfinite(g.float()).all()):
                raise AssertionError(f"bf16 forward {name}: {g.dtype} {tuple(g.shape)} or non-finite values")
            e_plain = _rel_norm(w16, w32)
            d = _rel_norm(g, w16)
            checks[name] = {"rel": d, "tol": 2 * e_plain + 1e-3, "plain_bf16_vs_f32": e_plain,
                            "kernel_vs_f32": _rel_norm(g, w32)}
    return launches, checks, calls


AB_FRAMES = 16  # frames per stream of each served_ab run: the main path's run is too short to time
# served_ab's runs, in turns: the parent tree's runner, this tree's slots,
# the eager ops (jit_segments=False)
AB_RUNS = ("parent", "slots", "eager", "eager", "slots", "parent")
SERVED_COPY_OPS = ("copy_", "clone", "cat", "_to_copy")


def served_copies(torch):
    """A ``TorchDispatchMode`` whose ``rows`` count, while it is entered,
    the host-issued ops that copy a tensor (``SERVED_COPY_OPS``), by op
    and output shape (``bytes``: the bytes they wrote, by op). In a served run whose segments are replayed CUDA
    graphs (a replay is no dispatched op) these are the copies and clones
    of its state leaves."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ServedCopies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if name in SERVED_COPY_OPS:
                key = f"{name} {tuple(out.shape)}"
                self.rows[key] = self.rows.get(key, 0) + 1
                self.bytes[name] = self.bytes.get(name, 0) + out.nbytes
            return out

    mode = ServedCopies()
    mode.rows, mode.bytes = {}, {}
    return mode


class ParentSegment:
    """The parent tree's segment runner, kept for ``served_ab``: one CUDA
    graph per (params, stream, state structure), captured on input buffers
    of its own into the stream's pool; each call copies every state leaf
    into them, replays, and clones every output leaf that is not a
    pass-through (the executor then ``record_stream``s every state leaf and
    admits merged frames by ``torch.cat``: ``parent_runner``)."""

    def __init__(self, name, fn):
        import weakref

        self.name, self.fn, self.graphs, self.holders = name, fn, {}, weakref.WeakSet()

    def __call__(self, params, state):
        import torch

        from repro_torch.kernels import graph_launches
        from repro_torch.nn.module import tree_def, tree_leaves, tree_unflatten

        leaves = tree_leaves(state)
        if not leaves or leaves[0].device.type != "cuda":
            return self.fn(params, state)
        stream = torch.cuda.current_stream(leaves[0].device)
        key = (id(params), stream.cuda_stream, tree_def(state),
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(params, state, leaves, stream)
        for buf, t in zip(g.static_in, leaves):
            buf.copy_(t)
        g.graph.replay()
        g.replays += 1
        graph_launches.update(g.launches)
        return tree_unflatten(g.static_out, [leaves[a] if a is not None else o.clone()
                                             for o, a in zip(tree_leaves(g.static_out), g.alias)])

    def _capture(self, params, state, leaves, stream):
        import torch

        from repro_torch.core import pipeline
        from repro_torch.kernels import launch_counters
        from repro_torch.nn.module import tree_leaves, tree_unflatten

        side = pipeline._capture_stream(leaves[0].device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            static_in = [t.clone() for t in leaves]
            static_state = tree_unflatten(state, static_in)
            self.fn(params, static_state)
        counters = launch_counters()
        before = {pkg: dict(c) for pkg, c in counters.items()}
        try:
            graph, static_out, pool_graphs = pipeline.capture_graph(
                stream, side, lambda: self.fn(params, static_state), f"segment {self.name}")
        finally:
            launched = {}
            for pkg, c in counters.items():
                for k, v in c.items():
                    if v != before[pkg][k]:
                        launched[k] = v - before[pkg][k]
                c.update(before[pkg])
        ids = {id(t): i for i, t in enumerate(static_in)}
        alias = [ids.get(id(o)) for o in tree_leaves(static_out)]
        captured = pipeline.CapturedGraph(graph, params, static_in, static_out, alias, launched)
        pool_graphs.add(captured)
        return captured


@contextlib.contextmanager
def parent_runner():
    """Within the block, models' captured runners are ``ParentSegment``s and
    executors run without slots, as the parent tree's did."""
    from repro_torch.core import pipeline
    from repro_torch.serve import executor

    real_init = executor.StreamExecutor.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        self._use_slots = False

    with patched(pipeline, "CapturedSegment", ParentSegment), patched(executor.StreamExecutor, "__init__", init):
        yield


def served_ab(torch, build_server, ops, dev, smi, want, clock):
    """The main path's serving on fresh servers (``AB_RUNS``): the parent
    tree's runner (``parent_runner``: every state leaf copied into each
    segment's graph and its outputs cloned out), this tree's slots, the
    eager ops (``jit_segments=False``) twice, the slots, the parent: after
    one warm-up frame per stream (captures, allocator), ``AB_FRAMES`` frames
    per stream with the counters set to 0 and the peak memory reset just
    before. Each eager run must launch ``AB_FRAMES / 4`` times ``want``
    outside any graph, each graph run replay as many and capture nothing;
    every run's outputs bit-equal to the first's. Then, untimed, 4 frames
    per stream more under ``served_copies`` (the parent's copies and
    clones; the slots' at most 2 a Pix2Pix frame and 4 a YOLOv8n frame).
    Memory: held and reserved after the warm-up (weights, slots, graph
    pools) and the peak over the timed run. Returns a row per run."""
    import gc

    from repro_torch import kernels as kernels_pkg
    from served_trace import device_segments

    want = {n: v * AB_FRAMES // 4 for n, v in want.items()}
    rows, ref = [], None
    for runner in AB_RUNS:
        jit = runner != "eager"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        m0, v0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        with parent_runner() if runner == "parent" else contextlib.nullcontext():
            bundle = build_server(img=IMG, base=BASE, n_pix=2, n_yolo=1, impl="pallas", device=dev,
                                  jit_segments=jit)
            server, ex = bundle.server, bundle.server.executor
            if ex._use_slots != (runner == "slots"):
                raise AssertionError(f"{runner} run: slots {ex._use_slots}")
            for s in bundle.streams:
                server.submit(s.model_index, bundle.frame_for(s.name, 99))
            server.drain()
            torch.cuda.synchronize()
            held, reserved = torch.cuda.memory_allocated() - m0, torch.cuda.memory_reserved() - v0
            server.reset_metrics()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            kernels_pkg.reset_graph_launches()
            n_graphs = sum(len(m.captured_graphs()) for m in bundle.models)
            frames_in = {s.name: [bundle.frame_for(s.name, t) for t in range(AB_FRAMES)] for s in bundle.streams}
            torch.cuda.synchronize()
            seg0, _ = device_segments(torch)
            clock.start()
            for t in range(AB_FRAMES):
                for s in bundle.streams:
                    server.submit(s.model_index, frames_in[s.name][t])
            server.pump()
            outs = server.drain()
            torch.cuda.synchronize()
            gcs, new_segments = clock.stop(), device_segments(torch)[0] - seg0
            rep = server.report()
            peak = torch.cuda.max_memory_allocated() - mem0
            eager = dict(ops.launches)
            replayed = {n: kernels_pkg.graph_launches[n] for n in REPLACES}
            captured = sum(len(m.captured_graphs()) for m in bundle.models) - n_graphs
            if (replayed, eager) != ((want, dict.fromkeys(REPLACES, 0)) if jit else (dict.fromkeys(REPLACES, 0), want)):
                raise AssertionError(f"{runner} run: replayed {replayed}, outside a graph {eager}, want {want}")
            if captured or ex.slots_beyond_bound:
                raise AssertionError(f"{runner} run: {captured} graphs captured in the timed run, "
                                     f"{ex.slots_beyond_bound} slots beyond their bound")
            got = {s.name: outs[s.name][-AB_FRAMES:] for s in bundle.streams}
            if ref is None:
                ref = got
            for name, o_list in got.items():
                for a, b in zip(o_list, ref[name]):
                    if not all(torch.equal(x, y) for x, y in zip(_leaves_of(a), _leaves_of(b))):
                        raise AssertionError(f"{runner} run: {name}'s outputs differ from the {AB_RUNS[0]} run's")
            copies, copies_s = None, None
            if jit:
                mode = served_copies(torch)
                t0 = time.perf_counter()
                with mode:
                    for t in range(4):
                        for s in bundle.streams:
                            server.submit(s.model_index, frames_in[s.name][t])
                    server.pump()
                    server.drain()
                torch.cuda.synchronize()
                copies, copies_s = sum(mode.rows.values()), time.perf_counter() - t0
                if runner == "slots" and copies > 2 * 8 + 4 * 4:
                    raise AssertionError(f"slots run: {copies} host copies in 12 frames: {mode.rows}")
            row = {"runner": runner, "frames_per_s": rep["aggregate_fps"], "p50_ms": rep["latency_p50_ms"],
                   "p99_ms": rep["latency_p99_ms"], "issue_share": _engine_shares(rep),
                   "blocked_share": 1 - rep["overlap"]["overlap_efficiency"], "peak_mem_bytes": peak,
                   "held_bytes": held, "reserved_bytes": reserved, "graphs": n_graphs,
                   "slots": [r["slots"] for r in ex.slot_counts()], "host_copies_12_frames": copies, "gc": gcs,
                   "new_device_segments": new_segments}
            rows.append(row)
            print(f"served {rep['frames']} frames, {runner:6s}: {rep['aggregate_fps']:.2f} frames/s, p50 "
                  f"{rep['latency_p50_ms']:.2f} ms, p99 {rep['latency_p99_ms']:.2f} ms, host-issue share "
                  f"{json.dumps(row['issue_share'])}, blocked {100 * row['blocked_share']:.2f}% of the tick wall, peak "
                  f"memory {peak / 2**20:.1f} MiB over the run, held / reserved after the warm-up "
                  f"{held / 2**20:.1f} / {reserved / 2**20:.1f} MiB ({n_graphs} graphs, slots {row['slots']}); "
                  f"host copies and clones in 12 more frames {copies} ({copies_s and round(copies_s, 3)} s); "
                  f"{len(gcs)} Python collections "
                  f"({sum(g[1] for g in gcs):.2f} ms), {new_segments} new device segments | {smi}")
            del bundle, server, ex, outs, got
    for runner in ("parent", "slots", "eager"):
        fps = [r["frames_per_s"] for r in rows if r["runner"] == runner]
        print(f"served A/B, {runner}: {', '.join(f'{v:.2f}' for v in fps)} frames/s | {smi}")
    return rows


def _launch(torch, launch_main, argv):
    """``repro_torch.launch.serve.main(argv)`` in this process, its output
    kept but for its ``[serve]`` lines; returns ``(result, report,
    seconds)``, the report parsed from the launcher's JSON."""
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = launch_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    report = json.loads(out[out.index("{\n"):]) if "{\n" in out else None
    for ln in out.splitlines():
        if ln.startswith("[serve]"):
            print("  " + ln[:200])
    return result, report, seconds


def _leaves_of(out):
    return [out[k] for k in sorted(out)] if isinstance(out, dict) else [out]


def _engine_shares(report):
    return {e: round(w["issue_frac"], 4) for e, w in (report.get("engines") or {}).items()}


def launcher_phase(torch, smi, dev, ops, want):
    """The launcher (``repro_torch.launch.serve.main``) in this process:

    1. ``--mode streams --impl pallas --img 256 --base 64 --streams 2
       --yolo-streams 1 --frames 4`` with the segments as CUDA graphs and
       with ``--no-jit-segments``: the per-frame outputs bit-exact between
       the two, the launch counters set to 0 just before each run: the
       eager run launches ``want`` (316/64/4) outside any graph, the graph
       run replays ``want`` (each replay counts the launches its graph
       captured, ``kernels.graph_launches``) plus each graph's first
       replay, made with its slot, and launches outside a graph only each
       graph's warm-up (the launches its capture recorded);
       frames/s, p50/p99, each engine's host-issue share and the peak of
       ``max_memory_allocated`` over the run, for both;
    2. ``--cost measured --cost-cache``, then ``--cost online --replan
       --calibration-cache`` with an injected stall (``segment_delay_fn``)
       on the engine carrying the most planned work once the re-planner
       has calibrated: exactly one swap, every frame completed in
       per-stream order, every flight admitted after the swap on the new
       plan, each flight in flight at the swap ran the rest of its
       admitted route segment by segment and its frames completed, the
       calibration file written;
    3. ``--traffic poisson --rate 30 --duration 1 --admission``;
    4. ``--mode lm --arch hymba_1_5b --tokens 4 --batch 2 --prompt-len 8``:
       its decode steps one captured CUDA graph, replayed for each token.

    Returns the phase's rows."""
    import gc
    import tempfile

    import repro_torch.serve as serve_pkg
    from repro_torch import kernels as kernels_pkg
    from repro_torch.launch import serve as launch_serve

    rows = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    base = ["--mode", "streams", "--impl", "pallas", "--img", str(IMG), "--base", str(BASE), "--streams", "2",
            "--yolo-streams", "1", "--frames", "4"]
    outs = {}
    for key, extra in (("graphs", []), ("eager", ["--no-jit-segments"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        kernels_pkg.reset_graph_launches()
        bundle, rep, seconds = _launch(torch, launch_serve.main, base + extra)
        eager = dict(ops.launches)
        replayed = {n: kernels_pkg.graph_launches[n] for n in REPLACES}
        peak = torch.cuda.max_memory_allocated() - mem0
        graphs = [g for m in bundle.models for _, g in m.captured_graphs()]
        warm = {n: sum(g.launches.get(n, 0) for g in graphs) for n in REPLACES}
        if key == "graphs":
            # each graph: one eager run before its capture and one replay
            # after it, when its slot is made; then the frames' replays
            served = {n: want[n] + warm[n] for n in REPLACES}
            if not bundle.server.executor.captures_graphs or replayed != served or eager != warm:
                raise AssertionError(f"graph run: replayed {replayed} (want {want} + the {len(graphs)} graphs' "
                                     f"first replays {warm}), outside a graph {eager} (want their warm-ups {warm})")
        elif eager != want or any(replayed.values()) or graphs:
            raise AssertionError(f"eager run: launched {eager} (want {want}), replayed {replayed}")
        outs[key] = {name: [[t.clone() for t in _leaves_of(o)] for o in o_list]
                     for name, o_list in bundle.server.executor.outputs.items()}
        rows[key] = {"frames_per_s": rep["aggregate_fps"], "p50_ms": rep["latency_p50_ms"],
                     "p99_ms": rep["latency_p99_ms"], "frames": rep["frames"], "issue_share": _engine_shares(rep),
                     "overlap_efficiency": rep["overlap"]["overlap_efficiency"], "peak_mem_bytes": peak,
                     "launches_outside_graphs": eager, "replayed_launches": replayed, "graphs": len(graphs),
                     "seconds": seconds}
        print(f"launcher {key}: {rep['frames']} frames, {rep['aggregate_fps']:.2f} frames/s, p50 "
              f"{rep['latency_p50_ms']:.2f} ms, p99 {rep['latency_p99_ms']:.2f} ms, host-issue share "
              f"{json.dumps(rows[key]['issue_share'])}, peak memory {peak / 2**20:.1f} MiB over the run "
              f"({len(graphs)} graphs), launches {json.dumps(replayed if key == 'graphs' else eager)}, "
              f"{seconds:.1f} s | {smi}")
        del bundle, graphs
    worst = 0
    for name in outs["graphs"]:
        a, b = outs["graphs"][name], outs["eager"][name]
        if len(a) != 4 or len(b) != 4:
            raise AssertionError(f"{name}: {len(a)} / {len(b)} outputs, want 4")
        for fa, fb in zip(a, b):
            for ta, tb in zip(fa, fb):
                if ta.shape != tb.shape or not bool(torch.isfinite(ta).all()):
                    raise AssertionError(f"{name}: shape {tuple(ta.shape)} vs {tuple(tb.shape)} or non-finite")
                if not torch.equal(ta, tb):
                    worst = max(worst, (ta - tb).abs().max().item())
    if worst:
        raise AssertionError(f"graph replay differs from the eager ops by up to {worst:.3e}: want bit-exact")
    print(f"launcher: graph-replayed outputs bit-exact against eager ({len(outs['graphs'])} streams x 4 frames)")
    del outs

    cache = tmp / "timings.json"
    bundle, rep, seconds = _launch(torch, launch_serve.main, base + ["--cost", "measured", "--cost-cache", str(cache)])
    entries = len(json.loads(cache.read_text())["entries"])
    if bundle.plan.cost_provider != "measured" or rep["frames"] != 12 or not entries:
        raise AssertionError(f"--cost measured: plan {bundle.plan.cost_provider}, {rep['frames']} frames, "
                             f"{entries} cache entries")
    rows["measured"] = {"cuts": [list(c) for c in bundle.plan.cuts], "cache_entries": entries, "seconds": seconds,
                        "frames_per_s": rep["aggregate_fps"]}
    print(f"launcher --cost measured: cuts {bundle.plan.cuts}, {entries} timings cached, "
          f"{rep['aggregate_fps']:.2f} frames/s, {seconds:.1f} s")
    del bundle

    calib = tmp / "calib.json"
    stall = {"on": False}
    swaps_at = []
    ran = []  # (flight, segment) of every segment issued after the swap

    def with_stall(**kw):
        b = real_build(**kw)
        ex, rp = b.server.executor, b.replanner
        load = {}
        for segs in b.plan.segments:
            for sg in segs:
                load[sg.engine] = load.get(sg.engine, 0.0) + sg.expected_cost
        slow = max(load, key=load.get)
        slow_name = b.plan.engine_names[slow]

        def delay(seg):
            if not stall["on"]:
                if not rp.calibrated:
                    return 0.0
                stall.update(on=True, tick=ex.tick_count, scale=rp.online.scale(slow_name), engine=slow_name)
            if seg.engine != slow:
                return 0.0
            # four times the calibrated wall of the span: a fixed slowdown
            return 4.0 * stall["scale"] * rp._expected_base(seg.model_index, seg.engine, seg.lo, seg.hi, seg.impl)

        real_swap, real_run = ex.swap_plan, ex._run_segment

        def swap(ir):
            # each flight in flight, with the stage it had reached and its admitted route
            swaps_at.append((ex.tick_count, [(f, f.stage, f.route) for f in ex.in_flight], ex.plan))
            return real_swap(ir)

        def run_segment(flight):
            if swaps_at:
                ran.append((flight, flight.route[flight.stage]))
            return real_run(flight)

        ex.segment_delay_fn, ex.swap_plan, ex._run_segment = delay, swap, run_segment
        return b

    argv = base[:-1] + ["16", "--cost", "online", "--replan", "--profile-every", "1", "--replan-cooldown", "1000",
                        "--calibration-cache", str(calib)]
    with patched(serve_pkg, "build_server", with_stall) as real_build:
        bundle, rep, seconds = _launch(torch, launch_serve.main, argv)
    ex, summary = bundle.server.executor, rep["replan"]
    submitted = 16 * len(bundle.streams)
    if summary["swaps"] != 1 or len(swaps_at) != 1 or len(ex.completions) != submitted or rep["frames"] != submitted:
        raise AssertionError(f"replan run: {summary['swaps']} swaps, {len(ex.completions)} of {submitted} "
                             f"frames completed; stall {stall}; events {summary['events']}")
    for s in bundle.streams:
        fids = [c.frame_id for c in ex.completions if c.stream == s.name]
        if fids != sorted(fids) or len(fids) != 16:
            raise AssertionError(f"{s.name}: completions out of order or missing: {fids}")
    tick, flights, old = swaps_at[0]
    done = {(c.stream, c.frame_id) for c in ex.completions}
    names = [s.name for s in bundle.streams]
    # every flight in flight at the swap ran the rest of its admitted route,
    # segment by segment, and each of its frames completed
    for f, stage, route in flights:
        rest = [(sg.lo, sg.hi, sg.engine) for sg in route[stage:]]
        got = [(sg.lo, sg.hi, sg.engine) for g, sg in ran if g is f]
        frames = [(names[m.stream_index], m.frame_id) for m in f.members]
        if f.revision != old.revision or got != rest or f.stage != len(route) or not set(frames) <= done:
            raise AssertionError(f"swap at tick {tick}: flight of {frames} admitted under revision {f.revision} "
                                 f"ran {got} after it, want the rest of its route {rest}")
    # every flight admitted after the swap ran the new plan's route
    stale = [(f.revision, sg.lo, sg.hi) for f, sg in ran
             if all(f is not g for g, _, _ in flights) and f.revision != ex.plan.revision]
    if stale:
        raise AssertionError(f"swap at tick {tick}: segments of flights admitted on the old plan after it {stale}")
    in_flight = len(flights)
    finished_old = [sg for f, sg in ran if any(f is g for g, _, _ in flights)]
    if not calib.exists() or not json.loads(calib.read_text())["engines"]:
        raise AssertionError("--calibration-cache was not written")
    ev = summary["events"][0]
    rows["replan"] = {"swap_tick": tick, "in_flight_at_swap": in_flight, "old_route_segments_after": len(finished_old),
                      "old_cuts": ev["old_cuts"], "new_cuts": ev["new_cuts"], "drift": ev["drift"],
                      "stall": {k: v for k, v in stall.items() if k != "on"}, "swap_stall": summary["swap_stall"],
                      "frames": rep["frames"], "frames_per_s": rep["aggregate_fps"], "seconds": seconds}
    print(f"launcher --cost online --replan: 1 swap at tick {tick} (stall on {stall.get('engine')} from tick "
          f"{stall.get('tick')}), cuts {ev['old_cuts']} -> {ev['new_cuts']}, drift {ev['drift']}, "
          f"{in_flight} flights in flight at the swap finished on their admitted route "
          f"({len(finished_old)} old-route segments after it), {rep['frames']} of {submitted} frames, 0 dropped, "
          f"swap stall {summary['swap_stall']['hot_path_stall_ms']:.1f} ms, {seconds:.1f} s | {smi}")
    del bundle

    bundle, rep, seconds = _launch(torch, launch_serve.main, base[:-2] + [
        "--traffic", "poisson", "--rate", "30", "--duration", "1", "--admission"])
    adm = rep["admission"]
    if not rep["frames"] or not adm["offered"]:
        raise AssertionError(f"open loop served {rep['frames']} frames of {adm['offered']} offered")
    rows["open_loop"] = {"frames": rep["frames"], "admission": adm, "goodput_fps": rep.get("goodput_fps"),
                         "p99_ms": rep["latency_p99_ms"], "seconds": seconds}
    print(f"launcher open loop (poisson 30 Hz/stream, 1 s, admission): {rep['frames']} frames served of "
          f"{adm['offered']} offered ({adm['dropped']} dropped), goodput {rep.get('goodput_fps', 0):.2f} frames/s, "
          f"p99 {rep['latency_p99_ms']:.2f} ms, {seconds:.1f} s | {smi}")
    del bundle

    from repro_torch.train import steps as train_steps

    made = []

    def recording(model):
        made.append(real(model))
        return made[-1]

    with patched(train_steps, "make_lm_decode_step", recording) as real:
        gen, _, seconds = _launch(torch, launch_serve.main, ["--mode", "lm", "--arch", "hymba_1_5b", "--tokens", "4",
                                                              "--batch", "2", "--prompt-len", "8"])
    if tuple(gen.shape) != (2, 4) or gen.device.type != "cuda" or len(made) != 1:
        raise AssertionError(f"--mode lm generated {tuple(gen.shape)} on {gen.device} through {len(made)} steps")
    check_captured(made[0], 8 + 4 - 1, "launcher --mode lm")
    rows["lm"] = {"tokens": gen.tolist(), "seconds": seconds}
    print(f"launcher --mode lm (hymba_1_5b smoke): generated {tuple(gen.shape)} on the card, its 11 decode steps "
          f"one CUDA graph replayed 11 times, {seconds:.1f} s")
    del made
    shutil.rmtree(tmp, ignore_errors=True)
    return rows


# The fleet phase's open-loop load, the same total for 1 and 2 replicas or
# workers: Poisson arrivals at FLEET_RATE_HZ on each of the 3 streams for
# FLEET_HORIZON_S seconds (600 frames/s offered), each frame held to a
# FLEET_DEADLINE_MS deadline (goodput counts the frames that meet it)
FLEET_RATE_HZ, FLEET_HORIZON_S, FLEET_DEADLINE_MS = 200.0, 2.0, 50.0
FLEET_FRAMES = 4  # frames per stream of each fleet's closed-loop check
FLEET_RUNS = 2  # open-loop runs of each fleet, one after the other


def fleet_phase(torch, smi, dev, ops, want):
    """The paper's replicated pipelines at full width (img 256, base 64,
    ``impl="pallas"``, 2 Pix2Pix + 1 YOLOv8 streams, every segment a
    replayed CUDA graph), through ``build_server``:

    1. the single server (R1), ``replicas=2`` in this process (R2), and
       ``workers=1`` / ``workers=2`` worker processes (W1, W2), each fed
       the same ``FLEET_FRAMES`` frames per stream, named offers, after its
       warm-up (the workers warm and capture before their ready): per-stream
       outputs bit-exact against R1; the conv_block, deconv_block and
       sppf_pyramid launches, summed over the replicas (this process's
       counters) or over the workers' ``counters()``, equal ``want`` (the
       main path's 316/64/4 for the same frames), every one a replay;
    2. ``FLEET_RUNS`` open-loop runs of each at the same total offered
       load (``FLEET_RATE_HZ`` per stream for ``FLEET_HORIZON_S``): frames/s,
       goodput under ``FLEET_DEADLINE_MS``, p50/p99, each engine's
       host-issue share, and device memory per process (what the server
       allocates and reserves after its warm-up, the reservations holding
       the CUDA-graph pools, and the peak allocated over the run, which
       holds the outputs the server keeps);
    3. on R2: one replica swaps to the ``max_cuts=2`` plan and serves, then
       the other: the retired spans' runners stay in the shared models'
       cache, held by the other replica alone and without graphs on the
       swapped replica's streams, until both have swapped; then the cache
       holds the live spans only (counted in ``captured_graphs()``), and
       every output stays bit-exact against R1;
    4. on W2: worker 1 killed, 2 more frames per stream offered: it is
       evicted and its streams are served by worker 0;
    5. one launcher call with ``--workers 2``.

    Returns the phase's rows."""
    import gc

    from repro_torch import kernels as kernels_pkg
    from repro_torch.core.api import plan as core_plan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import TrafficConfig, build_server

    F = FLEET_FRAMES
    kw = dict(img=IMG, base=BASE, n_pix=2, n_yolo=1, impl="pallas", device=dev, max_queue=8,
              deadline_ms=FLEET_DEADLINE_MS,
              traffic=TrafficConfig(process="poisson", rate_hz=FLEET_RATE_HZ, seed=5))
    rows, ref, frames = {}, None, None

    def drive(server, streams, lo, n):
        for t in range(lo, lo + n):
            for s in streams:
                server.offer(s.name, frames[s.name][t])
            server.tick()
        return server.drain()

    def counts(server, proc):
        """(replayed, outside a graph) launches of the three kernels."""
        if proc:
            c = server.counters()
            return ({n: c["graph_launches"].get(n, 0) for n in REPLACES},
                    {n: c["launches"].get(n, 0) for n in REPLACES}, c)
        torch.cuda.synchronize()
        return {n: kernels_pkg.graph_launches[n] for n in REPLACES}, dict(ops.launches), None

    def reset(server, proc):
        torch.cuda.synchronize()
        ops.reset_launches()
        kernels_pkg.reset_graph_launches()
        if proc:
            server.reset_counters()

    def host(outs, name, n):
        return [[t.cpu() for t in _leaves_of(o)] for o in outs[name][-n:]]

    def worst_diff(got, want_):
        worst = 0.0
        for name in want_:
            for fa, fb in zip(got[name], want_[name]):
                for ta, tb in zip(fa, fb):
                    if ta.shape != tb.shape or not bool(torch.isfinite(ta).all()):
                        raise AssertionError(f"{name}: shape {tuple(ta.shape)} vs {tuple(tb.shape)} or non-finite")
                    if not torch.equal(ta, tb):
                        worst = max(worst, (ta - tb).abs().max().item())
        return worst

    t_step = [time.perf_counter()]

    def step(what):
        """Print the host seconds since the previous step."""
        now = time.perf_counter()
        print(f"[fleet time] {what}: {now - t_step[0]:.1f} s")
        t_step[0] = now

    for key, fkw in (("R1", {}), ("R2", {"replicas": 2}), ("W1", {"workers": 1}), ("W2", {"workers": 2})):
        proc = "workers" in fkw
        step("before " + key)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        m0, v0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        bundle = build_server(**kw, **fkw)
        server = bundle.server
        if not server.executor.captures_graphs:
            raise AssertionError(f"{key}: the segments are not captured in CUDA graphs")
        if frames is None:
            frames = {s.name: [bundle.frame_for(s.name, t) for t in range(F + 2)] for s in bundle.streams}
        if not proc:  # a worker warms every stream (its graph captures) before its ready
            for s in bundle.streams:
                server.offer(s.name, bundle.frame_for(s.name, 99))
            server.drain()
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        # allocated: weights, kept outputs; reserved adds the CUDA-graph pools
        held, reserved = torch.cuda.memory_allocated() - m0, torch.cuda.memory_reserved() - v0
        server.reset_metrics()
        reset(server, proc)
        outs = drive(server, bundle.streams, 0, F)
        replayed, outside, c = counts(server, proc)
        if replayed != want or any(outside.values()):
            raise AssertionError(f"{key}: replayed {replayed}, outside a graph {outside}, want {want} all replayed")
        for s in bundle.streams:
            if len(outs[s.name]) != F + (0 if proc else 1):
                raise AssertionError(f"{key} {s.name}: {len(outs[s.name])} outputs")
        got = {s.name: host(outs, s.name, F) for s in bundle.streams}
        if ref is None:
            ref = got
        worst = worst_diff(got, ref)
        if worst:
            raise AssertionError(f"{key}: outputs differ from the single server's by up to {worst:.3e}: want bit-exact")
        workers_mem = ({w: {"held_bytes": wc["mem_bytes"], "reserved_bytes": wc["reserved_bytes"]}
                        for w, wc in c["per_worker"].items()} if proc else None)
        graphs = ([wc["captured_graphs"] for wc in c["per_worker"].values()] if proc
                  else [len(m.captured_graphs()) for m in bundle.models])
        print(f"fleet {key}: ready in {ready_s:.1f} s, {F} frames x {len(bundle.streams)} streams bit-exact against "
              f"the single server, launches {json.dumps(replayed)} all replayed, captured graphs {graphs}, device "
              f"memory allocated / reserved {held / 2**20:.1f} / {reserved / 2**20:.1f} MiB in this process"
              + (f", per worker {[(round(v['held_bytes'] / 2**20, 1), round(v['reserved_bytes'] / 2**20, 1)) for v in workers_mem.values()]} MiB"
                 if proc else ""))

        step(f"{key} built, warmed and checked")
        rows[key] = {"ready_s": ready_s, "held_bytes": held, "reserved_bytes": reserved, "workers_mem": workers_mem,
                     "captured_graphs": graphs, "launches": replayed, "open_loop": []}
        # the open loop, the same total offered load for every fleet, twice
        for run in range(FLEET_RUNS):
            server.reset_metrics()
            reset(server, proc)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r0 = torch.cuda.memory_allocated()
            rep = bundle.run_open_loop(FLEET_HORIZON_S, max_wall_s=120.0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - r0
            worker_peaks = ([wc["peak_mem_bytes"] for wc in server.counters()["per_worker"].values()]
                            if proc else None)
            adm = rep["admission"]
            row = {"frames": rep["frames"], "offered": adm["offered"], "dropped": adm["dropped"],
                   "frames_per_s": rep["aggregate_fps"], "goodput_fps": rep["goodput_fps"],
                   "p50_ms": rep["latency_p50_ms"], "p99_ms": rep["latency_p99_ms"], "wall_s": rep["wall_s"],
                   "issue_share": _engine_shares(rep), "blocked_share": 1 - rep["overlap"]["overlap_efficiency"],
                   "router": rep.get("router", {}).get("routed_frames"), "run_peak_bytes": peak,
                   "worker_peak_bytes": worker_peaks}
            rows[key]["open_loop"].append(row)
            print(f"fleet {key} open loop {run + 1} ({FLEET_RATE_HZ:g} Hz x {len(bundle.streams)} streams, "
                  f"{FLEET_HORIZON_S:g} s, {FLEET_DEADLINE_MS:g} ms deadline): {rep['frames']} of {adm['offered']} "
                  f"offered served ({adm['dropped']} dropped) in {rep['wall_s']:.2f} s: {rep['aggregate_fps']:.2f} "
                  f"frames/s, goodput {rep['goodput_fps']:.2f} frames/s, p50 {rep['latency_p50_ms']:.2f} ms, p99 "
                  f"{rep['latency_p99_ms']:.2f} ms, host-issue share {json.dumps(row['issue_share'])}, blocked "
                  f"{100 * row['blocked_share']:.2f}% of the tick wall, routed {row['router']}, peak allocated over "
                  f"the run {peak / 2**20:.1f} MiB in this process"
                  + (f", per worker {[round(v / 2**20, 1) for v in worker_peaks]} MiB" if proc else "")
                  + f" | {smi}")

        step(f"{key} open loops")
        if key == "R2":
            rows["R2_swap"] = fleet_swap_check(torch, bundle, core_plan, drive, host, worst_diff, ref, F)
            step("R2 swap check")
        if key == "W2":
            rows["W2_kill"] = fleet_kill_check(torch, bundle, drive, F)
            step("W2 kill check")
        bundle.close()
        del bundle, server, outs
        step(f"{key} closed")

    base = ["--mode", "streams", "--impl", "pallas", "--img", str(IMG), "--base", str(BASE), "--streams", "2",
            "--yolo-streams", "1", "--frames", "4", "--workers", "2"]
    bundle, rep, seconds = _launch(torch, launch_serve.main, base)
    if (rep["workers"], rep["alive_workers"], rep["frames"], rep["worker_failures"]) != (2, [0, 1], 12, []):
        raise AssertionError(f"launcher --workers 2: {rep['workers']} workers, alive {rep['alive_workers']}, "
                             f"{rep['frames']} frames, failures {rep['worker_failures']}")
    if any(h.process is not None for h in bundle.server.handles):
        raise AssertionError("launcher --workers 2 left a worker running")
    rows["launcher_workers"] = {"frames": rep["frames"], "frames_per_s": rep["aggregate_fps"],
                                "routed": rep["router"]["routed_frames"], "seconds": seconds}
    print(f"launcher --workers 2: {rep['frames']} frames, {rep['aggregate_fps']:.2f} frames/s, routed "
          f"{rep['router']['routed_frames']}, workers stopped, {seconds:.1f} s | {smi}")
    del bundle
    return rows


def fleet_swap_check(torch, bundle, core_plan, drive, host, worst_diff, ref, F):
    """The graph runners the replicas share, on the card: replica A swaps
    to the ``max_cuts=2`` plan and serves frame 0 of every stream again,
    then replica B does. Returns the rows."""
    fleet = bundle.server
    a, b = (s.executor for s in fleet.servers)
    alt = core_plan([m.graph for m in bundle.models], list(bundle.engines), max_cuts=2, impl="pallas")
    old = [{(s.lo, s.hi, s.impl) for s in segs} for segs in bundle.plan.segments]
    new = [{(s.lo, s.hi, s.impl) for s in segs} for segs in alt.segments]
    if old == new:
        raise AssertionError("the max_cuts=2 plan runs the same spans")

    def held(ex, mi):
        return {k[1:4] for k in ex._seg_fns if k[0] == mi}

    def state():
        return [{"runners": sorted(m.__dict__.get("_graph_runners", {})), "graphs": len(m.captured_graphs())}
                for m in bundle.models]

    streams_a = {st.cuda_stream for st in a._engine_streams or ()}
    before = state()
    a.swap_plan(alt)
    drive(fleet, bundle.streams, 0, 1)
    mid = state()
    for mi, m in enumerate(bundle.models):
        cache = m.__dict__.get("_graph_runners", {})
        if set(cache) != held(a, mi) | held(b, mi):
            raise AssertionError(f"model {mi} after A's swap: runners {sorted(cache)}, held by A {held(a, mi)}, B "
                                 f"{held(b, mi)}")
        for span in old[mi] - new[mi]:
            r = cache.get(span)
            if r is None:
                continue
            if a in r.holders or any(k[1] in streams_a for k in r.graphs):
                raise AssertionError(f"model {mi} span {span}: still held by A or with graphs on A's streams")
    b.swap_plan(alt)
    outs = drive(fleet, bundle.streams, 0, 1)
    after = state()
    for mi, m in enumerate(bundle.models):
        cache = m.__dict__.get("_graph_runners", {})
        if set(cache) != held(a, mi) | held(b, mi) or set(cache) & (old[mi] - new[mi]):
            raise AssertionError(f"model {mi} after both swaps: runners {sorted(cache)}, want the live {new[mi]}")
        live = sum(len(r.graphs) for r in cache.values())
        if len(m.captured_graphs()) != live:
            raise AssertionError(f"model {mi}: {len(m.captured_graphs())} graphs, {live} in the live runners")
    # the last two outputs of each stream: frame 0 again, after each swap
    got = {s.name: host(outs, s.name, 2) for s in bundle.streams}
    worst = worst_diff(got, {n: v[:1] * 2 for n, v in ref.items()})
    if worst:
        raise AssertionError(f"after the swaps the outputs differ from the single server's by up to {worst:.3e}")
    print(f"fleet R2 swap: runners and graphs per model before {before}, after A's swap {mid}, after both {after}; "
          f"outputs after the swaps bit-exact against the single server")
    return {"before": before, "after_a": mid, "after_both": after}


def _pipe_sink(conn, n):
    conn.send_bytes(b"ready")
    for _ in range(n):
        conn.recv_bytes()
        conn.send_bytes(b"done")


def host_pipe_rates(sizes_mb=(16, 128)):
    """MB/s of one message of each size through a ``multiprocessing`` pipe
    to a spawned process (the transport of the workers' RPCs), each timed
    from the send to the reply that it arrived. ``Connection`` reads a
    message with ``os.read(fd, remaining)``, which allocates the whole
    remainder for every chunk the pipe yields, so the rate falls with the
    message's size where allocations are dear."""
    from multiprocessing import get_context

    ctx = get_context("spawn")
    a, b = ctx.Pipe()
    p = ctx.Process(target=_pipe_sink, args=(b, len(sizes_mb)))
    p.start()
    a.recv_bytes()
    rates = {}
    for mb in sizes_mb:
        payload = bytes(mb * 2**20)
        t0 = time.perf_counter()
        a.send_bytes(payload)
        a.recv_bytes()
        rates[mb] = mb * 2**20 / 1e6 / (time.perf_counter() - t0)
    p.join(timeout=30)
    return rates


def fleet_kill_check(torch, bundle, drive, F):
    """The 2-worker fleet's outputs drained (through shared memory) and
    timed; then worker 1 killed: its streams re-route to worker 0, which
    serves them. Returns the row."""
    server = bundle.server
    t0 = time.perf_counter()
    kept = server.drain()
    drain_s = time.perf_counter() - t0
    drained = sum(t.numel() * t.element_size() for v in kept.values() for o in v for t in _leaves_of(o))
    rates = host_pipe_rates()
    print(f"fleet W2 drain: {sum(len(v) for v in kept.values())} outputs, {drained / 1e6:.1f} MB, in {drain_s:.2f} s "
          f"({drained / 1e6 / drain_s:.1f} MB/s through shared memory); one pipe message to a spawned process: "
          + ", ".join(f"{mb} MB at {r:.1f} MB/s" for mb, r in rates.items()))
    del kept
    victim = 1
    moved = sorted(n for n, w in server.router.assignments.items() if w == victim)
    if not moved:
        raise AssertionError("the router left worker 1 idle")
    proc = server.handles[victim].process
    proc.kill()
    proc.join(timeout=30.0)
    if proc.is_alive():
        raise AssertionError(f"worker {victim} survived its kill")
    before = {n: len(v) for n, v in server.drain().items()}
    outs = drive(server, bundle.streams, F, 2)
    rep = server.report()
    if rep["alive_workers"] != [0] or server.router.summary()["evicted"] != [victim]:
        raise AssertionError(f"kill: alive {rep['alive_workers']}, router {server.router.summary()}")
    (failure,) = [f for f in rep["worker_failures"] if f["worker"] == victim]
    served = {n: len(outs.get(n, [])) - before.get(n, 0) for n in moved}
    if failure["migrated_streams"] != moved or any(v != 2 for v in served.values()):
        raise AssertionError(f"kill: migrated {failure['migrated_streams']} (want {moved}), served after it {served}")
    for n in moved:
        mi = next(s.model_index for s in bundle.streams if s.name == n)
        for t, o in zip((F, F + 1), outs[n][-2:]):
            want_out = bundle.models[mi].run_all(bundle.frame_for(n, t))
            for a_, b_ in zip(_leaves_of(o), _leaves_of(want_out)):
                torch.testing.assert_close(a_, b_.cpu(), atol=5e-3, rtol=1e-2)
    print(f"fleet W2 kill: worker {victim} killed, evicted on '{failure['reason'][:60]}', streams {moved} served by "
          f"worker 0 ({served} frames after the kill, within the served pin of run_all)")
    return {"migrated": moved, "served_after": served, "reason": failure["reason"], "drain_s": drain_s,
            "drained_bytes": drained, "pipe_mb_per_s": rates}


# The LM/SSM zoo on the card (``lm_zoo_phase``): (architecture, layers kept
# at full width or None for full depth, prompt length). gemma2-2b prefills
# its context length, so its local layers see 4096 of 8192 keys; the
# reduced configs keep one local and one global layer (gemma2-27b) or the
# dense first layer and two MoE layers (the DeepSeek configs).
ZOO = (
    ("gemma2_2b", None, 8192),
    ("mamba2_2_7b", None, 4096),
    ("whisper_small", None, 64),
    ("gemma_2b", 2, 4096),
    ("gemma2_27b", 2, 4096),
    ("phi4_mini_3_8b", 2, 4096),
    ("qwen2_vl_7b", 2, 4096),
    ("deepseek_moe_16b", 3, 4096),
    ("deepseek_v2_lite_16b", 3, 4096),
)
ZOO_B = 2
# Tolerances of the zoo's kernel-routed f32 prefill against its plain-ops
# prefill (relative Frobenius difference per leaf), fixed before the first
# run, for the reason given at ``PREFILL_F32_TOL``: the two routes differ
# in summation order only, so the logits and every f32 leaf within 1e-4,
# and a leaf stored in bf16 (the KV caches, the conv tails) within 1e-3.
ZOO_F32_TOL = {"f32": 1e-4, "bf16": 1e-3}


def _zoo_leaves(res):
    """{name: tensor} of a prefill's (last-token logits, caches)."""
    from repro_torch.nn.module import tree_leaves

    logits, caches = res
    return {"logits": logits, **dict(zip(_paths(caches), tree_leaves(caches)))}


def zoo_expected(cfg, family):
    """The kernel launches of one prefill: flash attention once per GQA
    layer (MLA takes the plain route: its q.k head dim 192 and v head dim
    128 are not one of the kernel's head widths), three times per Whisper
    decoder layer and once per encoder layer, the SSD scan once per Mamba2
    layer."""
    if family == "mamba2":
        return {"flash_attention": 0, "ssd": cfg.n_layers}
    if family == "whisper":
        return {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_dec_layers, "ssd": 0}
    return {"flash_attention": 0 if cfg.attn_type == "mla" else cfg.n_layers, "ssd": 0}


def lm_zoo_phase(torch, smi, dev, lm_bench, attn_ops, attn_ref, ssd_ops, ssd_ref):
    """Every LM/SSM architecture of the port on the card (``ZOO``): random
    f32 parameters from ``torch.Generator(dev).manual_seed(0)``; a prefill
    of ``ZOO_B`` x its prompt length through the kernels in f32 against the
    same prefill on the plain ops (``patched``: ``attention_ref`` and
    ``ssd_chunked``), within ``ZOO_F32_TOL`` per leaf, with exactly
    ``zoo_expected`` launches (the counters set to 0 just before) and no
    plain route taken for autograd; the bf16 prefill timed with CUDA events
    (prompt tokens/s, achieved TFLOP/s from ``launch.analytic``); each
    distinct kernel call of the bf16 prefill (and of Whisper's f32 one)
    held against its plain version and timed (``LMBench``); gemma2-2b and
    mamba2-2.7b's bf16 prefills split by kind of kernel
    (``time_split``); decode against ``__call__`` at the JAX
    package's pin (atol 5e-2, rtol 1e-2) for gemma2-2b (through
    ``greedy_generate``), mamba2-2.7b and whisper-small. Returns rows."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import build_model, get_arch
    from repro_torch.launch.analytic import fwd_flops_per_token, whisper_encoder_flops
    from repro_torch.nn.module import param_count
    from repro_torch.train import greedy_generate, make_lm_decode_step

    rows = {}
    for arch, depth, S in ZOO:
        t_arch = time.perf_counter()
        spec = get_arch(arch)
        cfg = spec.config
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        whisper = spec.family == "whisper"
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (ZOO_B, S)).astype(np.int32)).to(dev)
        frames = None
        if whisper:
            frames = torch.from_numpy(rng.standard_normal((ZOO_B, cfg.n_frames, cfg.d_model), np.float32)).to(dev)
        params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
        n = param_count(params)
        want_n = None if depth is not None else spec.config.n_params()
        if want_n is not None and n != want_n:
            raise AssertionError(f"{arch}: {n} parameters, want {want_n}")
        full_depth = "full depth" if depth is None else f"{depth} of {spec.config.n_layers} layers"
        print(f"{arch}: {n:,} random f32 parameters on the card ({full_depth}, full width)")
        expected = zoo_expected(cfg, spec.family)
        groups = {}

        def recorder(key, name, real):
            def f(*args, **kw):
                a = lm_bench.args(name, *args, **kw)
                sig = (name, describe_lm(name, a), a.get("window"), a.get("chunk"))
                groups.setdefault(key, {}).setdefault(sig, [a, 0])[1] += 1
                return real(*args, **kw)

            return f

        def prefill_fn(model):
            @torch.no_grad()
            def run(p):
                return model.prefill(p, frames, tokens) if whisper else model.prefill(p, tokens)

            return run

        def counted(run, what):
            attn_ops.reset_launches()
            ssd_ops.reset_launches()
            kernels.grad_routes.clear()
            out = run(params)
            torch.cuda.synchronize()
            got = {**attn_ops.launches, **ssd_ops.launches}
            if got != expected or kernels.grad_routes:
                raise AssertionError(f"{arch} {what} prefill launched {got}, want {expected}; plain routes taken "
                                     f"for autograd {dict(kernels.grad_routes)}, want none")
            return out

        # f32: kernels against the plain ops
        run32 = prefill_fn(build_model(dataclasses.replace(cfg, act_dtype=torch.float32)))
        with patched(attn_ops, "attention", recorder("f32", "flash_attention", attn_ops.attention)), \
                patched(ssd_ops, "ssd", recorder("f32", "ssd", ssd_ops.ssd)):
            run32(params)  # warm-up, recording the kernels' calls by shape
        kern = _zoo_leaves(counted(run32, "f32"))
        with patched(attn_ops, "attention", attn_ref.attention_ref), patched(ssd_ops, "ssd", ssd_ref.ssd_chunked):
            plain = _zoo_leaves(run32(params))
            torch.cuda.synchronize()
        checks = {}
        for leaf, v in kern.items():
            w = plain[leaf]
            if tuple(v.shape) != tuple(w.shape) or not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"{arch} prefill {leaf}: shape {tuple(v.shape)} vs {tuple(w.shape)}, or non-finite")
            tol = ZOO_F32_TOL["bf16" if v.dtype == torch.bfloat16 else "f32"]
            checks[leaf] = (_rel_norm(v, w), tol)
        worst_leaf = max(checks, key=lambda k: checks[k][0] / checks[k][1])
        bad = {k: c for k, c in checks.items() if not c[0] <= c[1]}
        print(f"  f32 prefill ({ZOO_B} x {S} tokens{', frames ' + str(tuple(frames.shape)) if whisper else ''}): "
              f"launches {json.dumps(expected)}; kernel vs plain route: logits {checks['logits'][0]:.3e} "
              f"(<= {checks['logits'][1]:g}), worst of {len(checks)} leaves {worst_leaf} {checks[worst_leaf][0]:.3e} "
              f"(<= {checks[worst_leaf][1]:g})")
        if bad:
            raise AssertionError(f"{arch} prefill: kernel route vs plain ops beyond tolerance {bad}")
        del kern, plain
        if whisper:
            non_causal = sum(c for (nm, desc, *_), (a, c) in groups["f32"].items() if not a["causal"])
            if non_causal != cfg.n_enc_layers + cfg.n_dec_layers:
                raise AssertionError(f"whisper prefill: {non_causal} non-causal flash calls, want "
                                     f"{cfg.n_enc_layers + cfg.n_dec_layers}")
            print(f"  of the {expected['flash_attention']} flash_attention launches, {non_causal} non-causal "
                  "(encoder self-attention, cross-attention)")
        if spec.family == "lm" and cfg.attn_type == "mla":
            print("  0 kernel launches: MLA takes the plain route (q.k head dim "
                  f"{cfg.qk_nope_dim + cfg.qk_rope_dim}, v head dim {cfg.v_head_dim}; the kernel takes one head "
                  "width for q, k and v)")

        # bf16: the timed prefill
        run16 = prefill_fn(build_model(dataclasses.replace(cfg, act_dtype=torch.bfloat16)))
        with patched(attn_ops, "attention", recorder("bf16", "flash_attention", attn_ops.attention)), \
                patched(ssd_ops, "ssd", recorder("bf16", "ssd", ssd_ops.ssd)):
            run16(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        counted(run16, "bf16")
        end.record()
        torch.cuda.synchronize()
        ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated()
        # executed FLOPs: the analytic forward per token, less the LM head of
        # all but the last token (prefill computes the last token's logits)
        flops = ZOO_B * S * fwd_flops_per_token(cfg, S, "prefill") - ZOO_B * (S - 1) * 2 * cfg.d_model * cfg.vocab
        if whisper:
            flops += whisper_encoder_flops(cfg, ZOO_B)
        row = {"depth": depth or "full", "params": n, "prompt": [ZOO_B, S], "launches": expected,
               "f32_checks": checks, "bf16_ms": ms, "tokens_per_s": ZOO_B * S / (ms / 1e3),
               "tflop_s": flops / (ms / 1e3) / 1e12, "flops": flops, "peak_bytes": peak}
        print(f"  bf16 prefill: {ms:.2f} ms on the card, {row['tokens_per_s']:,.0f} prompt tokens/s, "
              f"{row['tflop_s']:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP, launch.analytic), peak "
              f"{peak / 2**30:.2f} GiB | {smi}")
        if arch in ("gemma2_2b", "mamba2_2_7b"):
            split = time_split(torch, lambda p, _t: run16(p), params, None)
            row["bf16_split"] = split
            if not split:
                print("  bf16 prefill time split: not measured (the profiler recorded no kernel)")
            else:
                kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["by_kind"].items(), key=lambda kv: -kv[1]))
                print(f"  bf16 prefill under torch.profiler: {split['wall_ms']:.2f} ms wall, device busy "
                      f"{split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}%; largest other: "
                      + "; ".join(f"{k} {v:.2f}" for k, v in split["top_other"]))

        # each distinct kernel call on its own: bf16, and Whisper's f32 (the non-causal mode in f32)
        row["calls"] = []
        for key in ("bf16", "f32") if whisper else ("bf16",):
            for (name, desc, *_), (a, count) in groups.get(key, {}).items():
                r = lm_bench.run(name, a)
                row["calls"].append({"kernel": name, "shape": desc, "count": count, **r})
                lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                rate = f" ({achieved(r)})" if name == "flash_attention" else ""
                print(f"  {name:15s} {desc:62s} x{count}: kernel {r['ms']:.4f} ms{rate}, plain {r['plain_ms']:.4f}, "
                      f"library {lib}, bound {r['bound_ms']:.5f} "
                      f"({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}), max_err vs f32 "
                      f"{r['max_abs_err']:.2e}")
        del groups

        # decode against __call__
        if depth is None:
            model = build_model(dataclasses.replace(cfg, act_dtype=torch.float32))
            T = 8 if whisper else 16
            with torch.no_grad():
                if arch == "gemma2_2b":
                    t0 = time.perf_counter()
                    gen = greedy_generate(model, params, tokens[:, :16], 16, 32, cache_dtype=torch.float32)
                    torch.cuda.synchronize()
                    row["generate_tokens_per_s"] = ZOO_B * 16 / (time.perf_counter() - t0)
                    if tuple(gen.shape) != (ZOO_B, 16) or not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
                        raise AssertionError(f"greedy_generate gave {tuple(gen.shape)} / out-of-vocabulary ids")
                    seq, T = torch.cat([tokens[:, :16], gen], dim=1), 32
                else:
                    seq = tokens[:, :T]
                full = model(params, frames, seq)[0] if whisper else model(params, seq)[0]
                caches = model.init_caches(ZOO_B, T, dtype=torch.float32, device=dev)
                if whisper:  # the cross K/V of the same frames
                    _, pc = model.prefill(params, frames, seq[:, :1], cache_dtype=torch.float32)
                    caches = dict(caches, cross_k=pc["cross_k"], cross_v=pc["cross_v"])
                step = make_lm_decode_step(model)
                outs = []
                for t in range(T):
                    lg, caches = step(params, seq[:, t : t + 1], caches, t)
                    outs.append(lg)
                dec = torch.cat(outs, 1)
                check_captured(step, T, f"{arch} decode")
                del step
            err = (dec - full).abs().max().item()
            torch.testing.assert_close(dec, full, atol=5e-2, rtol=1e-2)
            row["decode_vs_call_max_abs_err"] = err
            gen_s = (f"; greedy_generate batch {ZOO_B}, prompt 16, 16 new: {row['generate_tokens_per_s']:.1f} "
                     "tokens/s (host clock)") if "generate_tokens_per_s" in row else ""
            print(f"  decode (f32, {T} steps, one CUDA graph replayed {T} times) vs __call__: max |delta logits| "
                  f"{err:.3e} (atol 5e-2, rtol 1e-2)"
                  f"{gen_s}")
            del model, full, caches, dec
            if arch in DECODE_AB_B:
                torch.cuda.empty_cache()
                row["decode_ab"] = decode_ab(torch, smi, arch, cfg, params, dev)
            if arch == "gemma2_2b":
                row["decode_requests_ab"] = requests = decode_requests_ab(torch, smi, cfg, params, dev)
                row["decode_mesh_ab"] = decode_mesh_ab(torch, smi, cfg, params, dev, requests["fastest_ms"])
        del params
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_arch
        print(f"  [{arch} time] {row['seconds']:.1f} s")
        rows[arch] = row
    return rows


# LM training on the card (``lm_train_phase``): gemma2-2b at full width and
# depth through the training launcher, batch x sequence, bf16 activations,
# remat on (the config's default); steps with one micro-batch, then with two
LM_TRAIN_B, LM_TRAIN_S = 4, 1024
LM_TRAIN_RUNS = ((1, 6), (2, 4))  # (micro-batches, steps)
# Step 1 of gemma2-2b (full width, 2 layers, f32, TF32 off, 2 x 256) on the
# card against the CPU, fixed before the first run: the two devices run the
# same ops in f32 and differ in summation order only (cuBLAS against the
# CPU's BLAS, reduction trees, the embedding backward's scatter), a few f32
# ulps per accumulated term (2^-24 sqrt(K), K <= 9216: ~1e-6 relative); so
# the loss within rtol 1e-4 (train_phase's pin) and each gradient leaf's
# relative Frobenius difference within 1e-4 (the f32 pin of the prefill
# checks, PREFILL_F32_TOL)
LM_STEP1_B, LM_STEP1_S = 2, 256
LM_STEP1_LOSS_RTOL, LM_STEP1_GRAD_TOL = 1e-4, 1e-4
# one bf16 step of each other family at full width and 2 layers (Whisper: 2
# encoder and 2 decoder layers, its 1500 frames and 448 text positions)
LM_TRAIN_FAMILIES = (("hymba_1_5b", 2, 1024), ("mamba2_2_7b", 2, 1024), ("whisper_small", 2, 448))


class _RecordingOptimizer:
    """An optimizer that keeps the gradients it is given, then updates as
    ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def _lm_batch(torch, rng, cfg, B, S, dev, whisper=False):
    import numpy as np

    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    if whisper:
        batch["frames"] = torch.from_numpy(rng.standard_normal((B, cfg.n_frames, cfg.d_model), np.float32)).to(dev)
    return batch


# The one-rank mesh step against the plain step (gemma2-2b at full width and
# depth, bf16, steps 1 and 2: the key's eager warm-up, then its capture and
# first replay), fixed before the first run: one rank runs the plain step's
# local ops on the same values (DTensor adds dispatch, not arithmetic), so
# the losses and every parameter agree to float32 rounding of the sums whose
# order the card may change between two launches (cuBLAS's split choices,
# the embedding backward's accumulation): 1e-6 relative
MESH_STEP1_RTOL = 1e-6


def _local(t):
    """A DTensor's local block (on one rank, its whole value); any other leaf as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def mesh_vs_plain_step1(torch, smi, dev, cfg, init, steps):
    """Steps 1 and 2 of the launcher's gemma2-2b run through the
    distributed stack (a one-rank NCCL mesh, ``train_shardings``,
    ``device_put``, ``on_mesh``, ``shard_batch``, ``act_spec`` set) against
    the same steps on plain tensors, from the same parameters and batches:
    step 1 is each key's eager warm-up, step 2 its capture and first replay
    (the captured path); then one more mesh step, a replay, under
    torch.profiler."""
    import torch.distributed as dist

    from repro_torch.configs import build_model
    from repro_torch.data import shard_batch, token_batches
    from repro_torch.dist import device_put, on_mesh, train_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import AdamW, make_lm_train_step
    from repro_torch.train.optimizer import warmup_cosine

    # the activation constraint the dry run's train cells set (the batch over
    # "data"): on a one-rank mesh it is the identity
    model = build_model(dataclasses.replace(cfg, act_spec=("data",)))
    opt = AdamW(lr=warmup_cosine(1e-3, 50, steps), weight_decay=0.01)
    data = token_batches(LM_TRAIN_B, LM_TRAIN_S, cfg.vocab, seed=0)
    host = [next(data) for _ in range(3)]
    mesh = make_host_mesh(1, device=dev)
    try:
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        state = opt.init(params)
        sh = train_shardings(mesh, model.axes(), model.abstract(), state, LM_TRAIN_B)
        params, state = device_put(params, sh.params), device_put(state, sh.opt_state)
        step = on_mesh(make_lm_train_step(model, opt, donate=True))
        mesh_losses, ms = [], []
        for b in host[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, shard_batch(b, sh.batch))  # donated: the same buffers
            mesh_losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        snap = [t.to_local().clone() for t in tree_leaves(params)]
        split = time_split(torch, lambda p, b: step(p, state, b), params, shard_batch(host[2], sh.batch))
        check_train_captured(step, 2, "the one-rank mesh step")
        del params, state, step, m
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.to(dev, copy=True), init)
    state, plain = opt.init(params), make_lm_train_step(model, opt, donate=True)
    plain_losses = []
    for b in host[:2]:
        params, state, m = plain(params, state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        plain_losses.append(float(m["loss"]))
    check_train_captured(plain, 1, "the plain step")
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(snap, tree_leaves(params))]
    loss_rel = max(_rel(a, b) for a, b in zip(mesh_losses, plain_losses))
    del params, state, plain, snap, m
    torch.cuda.empty_cache()
    row = {"loss": [mesh_losses, plain_losses], "loss_rel": loss_rel, "param_rel": rel, "first_step_ms": ms[0],
           "capture_step_ms": ms[1], "split": split}
    print(f"gemma2-2b steps 1-2 (the eager warm-up, then the capture and its replay), one-rank mesh (DTensor) vs plain "
          f"tensors, the same parameters and batches: losses " + ", ".join(f"{a:.7f} / {b:.7f}" for a, b in
                                                                           zip(mesh_losses, plain_losses))
          + f" (worst rel {loss_rel:.2e}), parameters after step 2: worst leaf max|delta| / max|leaf| {max(rel):.2e} "
          f"over {len(rel)} leaves (<= {MESH_STEP1_RTOL:g}); the mesh step 1 took {ms[0]:.1f} ms on the host clock "
          f"(DTensor's sharding propagation meets every op for the first time), step 2 {ms[1]:.1f} ms")
    if split:
        kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["by_kind"].items(), key=lambda kv: -kv[1]))
        print(f"  mesh step 3 (a replay) under torch.profiler: {split['wall_ms']:.2f} ms wall, device busy "
              f"{split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}% | {smi}")
    if not (loss_rel <= MESH_STEP1_RTOL and max(rel) <= MESH_STEP1_RTOL):
        raise AssertionError(f"one-rank mesh steps 1-2 differ from the plain steps: loss {loss_rel:.3e}, "
                             f"parameters {max(rel):.3e}")
    return row


# The stacked-layer gradients (``nn.module.unstack``: one ``unbind`` of each
# stacked leaf a forward, whose backward stacks the layers' gradients),
# against the parent formulation (``t[i]`` of every leaf for every layer,
# each backpropagating a zero-filled tensor of the leaf's full shape), on
# the plain gemma2-2b step at full depth (LM_TRAIN_B x LM_TRAIN_S, bf16,
# remat), in turns. Predicted from the parent's profile on the card
# (SelectBackward0 266.19 of 822.39 ms of device time, the step
# 940.99-983.21 ms, peak 43.41-44.08 GiB): SelectBackward0's
# time goes; the stacks (UnbindBackward0) take about 2F / 3.35 TB/s ~ 5 ms
# (F = 8.10 GB of f32 block parameters); device busy falls to about 560 ms
# and the synchronised step to about 680-720 ms; the peak is no higher than
# the parent's; the losses are bit-equal
STACKED_RUNS = ("parent", "change", "change", "parent")
STACKED_STEPS = 3  # steps a run from the same parameters and batches (the mean from step 2)
STACKED_PREDICTED_MS = (680.0, 720.0)
STACKED_PREDICTED_BUSY_MS = 560.0


@contextlib.contextmanager
def parent_layers():
    """The parent tree's layer loops while entered: the four LM families
    take ``t[i]`` of every stacked leaf for every layer
    (``nn.module.layer``) in place of ``unstack``."""
    from repro_torch.models import hymba, lm, mamba2, whisper
    from repro_torch.nn.module import layer, tree_leaves

    def loop(tree):
        return [layer(tree, i) for i in range(tree_leaves(tree)[0].shape[0])]

    saved = [(m, m.unstack) for m in (hymba, lm, mamba2, whisper)]
    for m, _ in saved:
        m.unstack = loop
    try:
        yield
    finally:
        for m, fn in saved:
            m.unstack = fn


def stacked_grads_ab(torch, smi, dev, cfg, init):
    """The gemma2-2b step (``cfg``: full depth, bf16, remat) with this
    tree's layer loop and the parent's, in ``STACKED_RUNS`` order, on plain
    tensors and then on a one-rank NCCL mesh (``act_spec`` over "data", as
    in ``mesh_vs_plain_step1``), uncaptured (``step.eager``, so that each
    formulation runs its own ops): each run ``STACKED_STEPS`` donated steps
    from ``init`` on the same batches (ms synchronised, peak memory,
    losses); one plain step of each under ``stacked_grad_copies`` (fails
    where a stacked leaf's gradient is made more than once) and one of each
    under ``torch.profiler`` (device busy, SelectBackward0 /
    UnbindBackward0). Returns the row."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import build_model
    from repro_torch.data import shard_batch
    from repro_torch.dist import device_put, on_mesh, train_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import AdamW, make_lm_train_step

    opt = AdamW(lr=1e-4, weight_decay=0.01)
    rng = np.random.default_rng(4)
    host = [_lm_batch(torch, rng, cfg, LM_TRAIN_B, LM_TRAIN_S, torch.device("cpu")) for _ in range(STACKED_STEPS)]
    batches = [{k: v.to(dev) for k, v in b.items()} for b in host]
    stacked = tree_leaves(init["blocks"])

    def fresh():
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        return params, opt.init(params)

    def within(formulation):
        return parent_layers() if formulation == "parent" else contextlib.nullcontext()

    def timed(formulation, step, params, state, batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        with within(formulation):
            for b in batches:
                t0 = time.perf_counter()
                params, state, m = step(params, state, b)
                losses.append(m["loss"].item())
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        return {"formulation": formulation, "ms": ms, "step_ms": sum(ms[1:]) / len(ms[1:]), "losses": losses,
                "peak_bytes": torch.cuda.max_memory_allocated()}

    model = build_model(cfg)
    runs = {"plain": [], "mesh": []}
    step = make_lm_train_step(model, opt, donate=True).eager  # uncaptured: each formulation runs its own ops
    for formulation in STACKED_RUNS:
        params, state = fresh()
        runs["plain"].append(timed(formulation, step, params, state, batches))
        del params, state
        torch.cuda.empty_cache()
    mesh_model = build_model(dataclasses.replace(cfg, act_spec=("data",)))
    for formulation in STACKED_RUNS:
        mesh = make_host_mesh(1, device=dev)
        try:
            params, state = fresh()
            sh = train_shardings(mesh, mesh_model.axes(), mesh_model.abstract(), state, LM_TRAIN_B)
            params, state = device_put(params, sh.params), device_put(state, sh.opt_state)
            mesh_step = on_mesh(make_lm_train_step(mesh_model, opt, donate=True)).eager
            runs["mesh"].append(timed(formulation, mesh_step, params, state, [shard_batch(b, sh.batch) for b in host]))
            del params, state, mesh_step
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
    counts, splits = {}, {}
    for formulation in ("parent", "change"):
        params, state = fresh()
        with within(formulation):
            with stacked_grad_copies(torch, stacked) as mode:
                params, state, _ = step(params, state, batches[0])
            torch.cuda.synchronize()
            counts[formulation] = mode.rows
            splits[formulation] = time_split(torch, lambda p, b: step(p, state, b), params, batches[1])
        del params, state
        torch.cuda.empty_cache()
    per_shape = {}
    for t in stacked:
        per_shape[tuple(t.shape)] = per_shape.get(tuple(t.shape), 0) + 1
    made = {}
    for (_, shape), k in counts["change"].items():
        made[shape] = made.get(shape, 0) + k
    over = {shape: k for shape, k in made.items() if k > per_shape.get(shape, 0)}
    row = {"runs": runs, "counts": {f: {f"{op} {list(shape)}": k for (op, shape), k in c.items()}
                                    for f, c in counts.items()},
           "stacked_leaves": len(stacked), "splits": splits}

    def ops(c):
        got = {}
        for (op, _), k in c.items():
            got[op] = got.get(op, 0) + k
        return ", ".join(f"{op} {k}" for op, k in sorted(got.items())) or "none"

    print(f"gemma2-2b stacked-layer gradients (full depth, {LM_TRAIN_B} x {LM_TRAIN_S}, bf16, remat; "
          f"{len(stacked)} stacked leaves, {cfg.n_layers} layers): new tensors of a stacked leaf's full shape made in "
          f"the backward for a leaf, this tree {sum(counts['change'].values())} ({ops(counts['change'])}), the parent "
          f"formulation {sum(counts['parent'].values())} ({ops(counts['parent'])}); most for one leaf shape: "
          f"{max((made.get(s, 0) / n for s, n in per_shape.items()), default=0):g} a leaf (<= 1)")
    for f in ("parent", "change"):
        sp = splits[f]
        if sp:
            bw = sp["backward"]
            print(f"  {f} plain step under torch.profiler: device busy {sp['busy_ms']:.2f} ms of {sp['wall_ms']:.2f} "
                  f"wall (predicted for this tree about {STACKED_PREDICTED_BUSY_MS:g}), SelectBackward0 "
                  f"{bw.get('SelectBackward0', 0.0):.2f} ms, UnbindBackward0 {bw.get('UnbindBackward0', 0.0):.2f} ms; "
                  "by backward node: " + "; ".join(f"{k} {v:.2f}" for k, v in sp["top_backward"]))
        else:
            print(f"  {f} plain step split: not measured (the profiler recorded no kernel)")
    lo, hi = STACKED_PREDICTED_MS
    same = True
    for path, rs in runs.items():
        def mean(f):
            vals = [r["step_ms"] for r in rs if r["formulation"] == f]
            return sum(vals) / len(vals)

        losses = {f: [r["losses"] for r in rs if r["formulation"] == f] for f in ("parent", "change")}
        bit_equal = all(a == losses["parent"][0] for f in losses for a in losses[f])
        same = same and bit_equal
        peaks = {f: max(r["peak_bytes"] for r in rs if r["formulation"] == f) for f in ("parent", "change")}
        verdict = "no higher, as predicted" if peaks["change"] <= peaks["parent"] else "HIGHER than predicted"
        print(f"  {path}, runs {' / '.join(STACKED_RUNS)}: step ms (steps 2-{STACKED_STEPS}) "
              + ", ".join(f"{r['step_ms']:.2f}" for r in rs)
              + f"; this tree {mean('change'):.2f}"
              + (f" (predicted {lo:g}-{hi:g})" if path == "plain" else " (predicted below the parent's)")
              + f", parent formulation {mean('parent'):.2f}; peak this tree {peaks['change'] / 2**30:.2f} GiB, "
              f"parent {peaks['parent'] / 2**30:.2f} GiB ({verdict}); losses "
              f"{'bit-equal in all four runs' if bit_equal else 'differ: ' + json.dumps(losses)} | {smi}")
    if over or sum(counts["change"].values()) != len(stacked):
        raise AssertionError(f"the backward made a stacked leaf's full-shape tensor more than once a leaf: "
                             f"{row['counts']['change']}")
    return row


# The captured LM train step against its eager ops (``lm_train_graph_ab``):
# the gemma2-2b step (full width and depth, LM_TRAIN_B x LM_TRAIN_S, bf16,
# remat, AdamW with a warmup_cosine rate) as ``make_lm_train_step(...,
# donate=True)`` runs it on the card (one CUDA graph a key, written into the
# trees it was captured on) and as ``step.eager`` runs it (the same ops, one
# by one), in turns, on plain tensors and then on a one-rank NCCL mesh
# (``on_mesh``, ``act_spec`` over "data"). Every run starts from the same
# values in the same buffers (the graph's) and takes the same batches.
# Predicted before the first run from the eager step's profile on the card
# (device busy 556.46-561.38 ms; eager plain 682.40-1085.66 ms a step, mesh
# 1.47-1.91x the plain step, idle 61.3% under the profiler; peak 44.11
# GiB): the captured plain step falls to about its device busy,
# 560-600 ms; the captured mesh step within 5% of the captured plain one,
# its idle share under 10%; losses and parameters bit-equal to the eager
# step's; the peak no higher than 44.11 GiB plus the static batch
GRAPH_AB_RUNS = ("eager", "captured", "captured", "eager")
GRAPH_AB_STEPS = 4  # timed steps a run
GRAPH_AB_SPLIT = 2  # steps of each kind under torch.profiler
GRAPH_AB_PREDICTED_MS = (560.0, 600.0)
GRAPH_AB_PREDICTED_MESH_RATIO = 1.05
GRAPH_AB_PREDICTED_IDLE = 0.10
GRAPH_AB_EAGER_PEAK_GIB = 44.11


def lm_train_graph_ab(torch, smi, dev, cfg, init):
    """The gemma2-2b step (``cfg``: full depth, bf16, remat) captured and
    eager in ``GRAPH_AB_RUNS`` order, on plain tensors, then on a one-rank
    NCCL mesh (``_graph_ab_path``). Returns the rows."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import build_model
    from repro_torch.data import shard_batch
    from repro_torch.dist import device_put, on_mesh, train_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import AdamW, make_lm_train_step
    from repro_torch.train.optimizer import warmup_cosine

    opt = AdamW(lr=warmup_cosine(1e-3, 2, 50), weight_decay=0.01)
    rng = np.random.default_rng(6)
    host = [{k: v.numpy() for k, v in _lm_batch(torch, rng, cfg, LM_TRAIN_B, LM_TRAIN_S, torch.device("cpu")).items()}
            for _ in range(GRAPH_AB_STEPS)]
    rows = {}
    for path in ("plain", "mesh"):
        mesh = make_host_mesh(1, device=dev) if path == "mesh" else None
        try:
            model = build_model(dataclasses.replace(cfg, act_spec=("data",)) if mesh else cfg)
            params = tree_map(lambda t: t.to(dev, copy=True), init)
            state = opt.init(params)
            if mesh:
                sh = train_shardings(mesh, model.axes(), model.abstract(), state, LM_TRAIN_B)
                params, state = device_put(params, sh.params), device_put(state, sh.opt_state)
                batches = [shard_batch(b, sh.batch) for b in host]
            else:
                batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]

            def make_step():
                step = make_lm_train_step(model, opt, donate=True)
                return on_mesh(step) if mesh else step

            rows[path] = _graph_ab_path(torch, smi, path, make_step, {"params": params, "state": state},
                                        tree_leaves(init), batches)
            del params, state, batches
        finally:
            if mesh is not None:
                dist.destroy_process_group()
        torch.cuda.empty_cache()
    plain, mesh_row = rows["plain"], rows["mesh"]
    ratio = mesh_row["captured_ms"] / plain["captured_ms"]
    lo, hi = GRAPH_AB_PREDICTED_MS
    print(f"  captured mesh / captured plain {ratio:.3f} (predicted <= {GRAPH_AB_PREDICTED_MESH_RATIO:g}); captured "
          f"plain {plain['captured_ms']:.2f} ms a step (predicted {lo:g}-{hi:g}); eager mesh / eager plain "
          f"{mesh_row['eager_ms'] / plain['eager_ms']:.3f} | {smi}")
    rows["mesh_over_plain_captured"] = ratio
    return rows


def _graph_ab_path(torch, smi, path, make_step, trees, init_leaves, batches):
    """``lm_train_graph_ab`` on one path: ``make_step()``'s step (captured)
    and its ``eager`` on ``trees`` (``params``, ``state``), each run
    ``GRAPH_AB_STEPS`` steps from ``init_leaves`` in the same buffers. The
    first eager run comes before any capture; then the key's warm-up and
    capture, outside the clock (their ms, peak allocated and reserved, the
    pool they leave; one eager step before, untimed), the two captured runs (every step a replay), the host
    copies of one captured step (``served_copies``) and ``GRAPH_AB_SPLIT``
    captured steps under ``torch.profiler``; then the graph is dropped,
    its pool released, before the last eager run and the eager steps under
    the profiler (the graph's pool and the eager step's cache together
    would not fit beside the trees). Each run: ms a step synchronised,
    peak allocated and reserved, the reserve it added. Fails unless every
    run's losses, final parameters and counts are bit-equal, the captured
    runs replay one graph, and a captured step copies only the batch in
    and clones only the metrics out."""
    from repro_torch.nn.module import tree_leaves

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def reset():
        """The parameters back to ``init`` in their buffers, the moments
        and the count to 0."""
        with torch.no_grad():
            for t, h in zip(tree_leaves(trees["params"]), init_leaves):
                local(t).copy_(h)
            for t in tree_leaves({k: v for k, v in trees["state"].items() if k != "step"}):
                local(t).zero_()
            count = trees["state"]["step"]
            if count.device.type == "cpu" and not hasattr(count, "placements"):
                trees["state"] = {**trees["state"], "step": torch.zeros((), dtype=torch.int32)}
            else:
                local(count).zero_()
        torch.cuda.synchronize()

    def run(call, n=GRAPH_AB_STEPS):
        losses, ms = [], []
        for b in batches[:n]:
            t0 = time.perf_counter()
            trees["params"], trees["state"], m = call(trees["params"], trees["state"], b)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    runs, ref, reserved = [], [], [torch.cuda.memory_reserved()]

    def timed(kind, call, graphs):
        reset()
        replays = sum(g.replays for g in graphs.values())
        torch.cuda.reset_peak_memory_stats()
        losses, ms = run(call)
        row = {"kind": kind, "ms": ms, "step_ms": sum(ms) / len(ms), "losses": losses,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
               "reserved_added_gib": (torch.cuda.memory_reserved() - reserved[0]) / 2**30,
               "replays": sum(g.replays for g in graphs.values()) - replays,
               "count": int(local(trees["state"]["step"]))}
        reserved[0] = torch.cuda.memory_reserved()
        got = [local(t).to("cpu") for t in tree_leaves(trees["params"])]
        if not ref:
            ref.extend((losses, got))
        else:
            row["bit_equal"] = losses == ref[0] and all(torch.equal(a, b) for a, b in zip(got, ref[1]))
        runs.append(row)

    step = make_step()
    eager = step.eager
    reset()
    run(eager, 1)  # first-use work (DTensor's sharding propagation on the mesh) outside the clock
    timed("eager", eager, {})
    # the key's warm-up (call 1, eager) and capture (call 2, then its first replay), outside the clock
    torch.cuda.synchronize()
    held0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    reset()
    _, first = run(step, 2)
    capture = {"warm_up_ms": first[0], "capture_and_replay_ms": first[1],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "held_above_gib": (torch.cuda.memory_allocated() - held0) / 2**30,
               "reserved_above_gib": (torch.cuda.memory_reserved() - reserved0) / 2**30,
               "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    reserved[0] = torch.cuda.memory_reserved()
    timed("captured", step, step.graphs)
    timed("captured", step, step.graphs)
    reset()
    run(step, 1)
    with served_copies(torch) as copies:
        run(step, 1)
    by_op = {}
    for key, c in copies.rows.items():
        by_op[key.split(" ")[0]] = by_op.get(key.split(" ")[0], 0) + c
    reset()
    splits = {"captured": time_split(torch, lambda *_: run(step, GRAPH_AB_SPLIT), None, None)}
    graphs = [g.replays for g in step.graphs.values()]
    del step  # the graph and its pool
    torch.cuda.empty_cache()
    reserved[0] = torch.cuda.memory_reserved()
    timed("eager", eager, {})
    reset()
    splits["eager"] = time_split(torch, lambda *_: run(eager, GRAPH_AB_SPLIT), None, None)
    eager_ms = [r["step_ms"] for r in runs if r["kind"] == "eager"]
    captured_ms = [r["step_ms"] for r in runs if r["kind"] == "captured"]
    same = all(r.get("bit_equal", True) for r in runs)
    counts_ok = all(r["count"] == GRAPH_AB_STEPS for r in runs)
    n_batch, n_metrics = len(tree_leaves(batches[0])), 5
    row = {"capture": capture, "runs": runs, "copies": by_op, "copy_bytes": copies.bytes,
           "eager_ms": sum(eager_ms) / len(eager_ms), "captured_ms": sum(captured_ms) / len(captured_ms),
           "graphs": graphs, "bit_equal": same,
           "splits": {k: {n: v for n, v in sp.items() if n not in ("backward", "other")} for k, sp in splits.items()}}
    lo, hi = GRAPH_AB_PREDICTED_MS
    print(f"gemma2-2b train step captured vs eager, {path} ({LM_TRAIN_B} x {LM_TRAIN_S}, bf16, remat, full depth; runs "
          f"{' / '.join(GRAPH_AB_RUNS)}, {GRAPH_AB_STEPS} steps each from the same values in the same buffers): "
          f"ms a step (synchronised) eager " + ", ".join(f"{v:.2f}" for v in eager_ms) + ", captured "
          + ", ".join(f"{v:.2f}" for v in captured_ms)
          + (f" (predicted {lo:g}-{hi:g})" if path == "plain" else "") + f"; losses, parameters and counts "
          f"{'bit-equal in all four runs' if same and counts_ok else 'DIFFER'}; key's warm-up {capture['warm_up_ms']:.1f} "
          f"ms, capture + first replay {capture['capture_and_replay_ms']:.1f} ms, their peak allocated "
          f"{capture['peak_gib']:.2f} GiB (predicted <= {GRAPH_AB_EAGER_PEAK_GIB:g}), reserved at most "
          f"{capture['peak_reserved_gib']:.2f} GiB, after them held +{capture['held_above_gib']:.2f} GiB and reserved +"
          f"{capture['reserved_above_gib']:.2f} GiB (the graph's pool, the eager cache released); a run's peak "
          f"allocated / reserved and the reserve it added: "
          + ", ".join(f"{r['kind']} {r['peak_gib']:.2f} / {r['peak_reserved_gib']:.2f} +{r['reserved_added_gib']:.2f}"
                      for r in runs)
          + f" GiB (a replay allocates nothing: its working set lies in the pool; the last eager run after the pool "
          f"was released); graphs {len(graphs)}, replays in the runs {[r['replays'] for r in runs]}; one captured "
          f"step's host copies {json.dumps(by_op)} ({sum(copies.bytes.values()) / 1e6:.3f} MB) | {smi}")
    for kind, sp in splits.items():
        if not sp:
            print(f"  {kind}, {path}: not measured (the profiler recorded no kernel)")
            continue
        kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(sp["by_kind"].items(), key=lambda kv: -kv[1]))
        note = f" (predicted under {100 * GRAPH_AB_PREDICTED_IDLE:g}%)" if kind == "captured" else ""
        print(f"  {kind}, {path}, {GRAPH_AB_SPLIT} steps under torch.profiler: {sp['wall_ms']:.2f} ms wall, device "
              f"busy {sp['busy_ms']:.2f} ms ({sp['busy_ms'] / GRAPH_AB_SPLIT:.2f} a step; {kinds}), idle "
              f"{100 * sp['idle_share']:.1f}%{note}")
    if not (same and counts_ok):
        raise AssertionError(f"gemma2-2b {path}: captured and eager runs differ: "
                             + json.dumps([{k: r.get(k) for k in ("kind", "losses", "count", "bit_equal")}
                                           for r in runs]))
    want = [0 if k == "eager" else GRAPH_AB_STEPS for k in GRAPH_AB_RUNS]
    if len(graphs) != 1 or [r["replays"] for r in runs] != want:
        raise AssertionError(f"gemma2-2b {path}: {len(graphs)} graphs, replays {[r['replays'] for r in runs]}, "
                             f"want one graph replayed {want}")
    if by_op != {"copy_": n_batch, "clone": n_metrics}:
        raise AssertionError(f"gemma2-2b {path}: a captured step copied {by_op}, want {n_batch} copy_ (the batch) "
                             f"and {n_metrics} clone (the metrics)")
    return row


def lm_train_phase(torch, smi, dev, attn_ops, ssd_ops):
    """LM training on the card (item 12 of the docstring). Returns rows."""
    import sys as _sys
    import tempfile

    import numpy as np

    from torch.distributed.tensor import DTensor

    from repro_torch import kernels
    from repro_torch.configs import build_model, get_arch
    from repro_torch.data import FailingIterator, Prefetcher, to_device, token_batches
    from repro_torch.launch.supervisor import supervise
    from repro_torch.launch.train import main as train_main
    from repro_torch.nn.module import param_count, tree_leaves, tree_map
    from repro_torch.train import (AdamW, LoopConfig, make_lm_train_step, restore_checkpoint,
                                   run_train_loop)
    from repro_torch.train.optimizer import warmup_cosine

    rows = {}
    cpu = torch.device("cpu")

    def reset():
        attn_ops.reset_launches()
        ssd_ops.reset_launches()
        kernels.grad_routes.clear()

    def no_launches(what):
        got = {**attn_ops.launches, **ssd_ops.launches}
        if any(got.values()):
            raise AssertionError(f"{what}: kernel launches under autograd {got}, want none")
        return dict(kernels.grad_routes)

    # ---- gemma2-2b, full width and depth, through the launcher (a one-rank mesh, DTensor parameters)
    spec = get_arch("gemma2_2b")
    init = build_model(spec.config).init(torch.Generator().manual_seed(0))  # the launcher's draw, on the host
    n = param_count(init)
    if n != spec.config.n_params():
        raise AssertionError(f"gemma2-2b: {n} parameters, want {spec.config.n_params()}")
    bcfg = dataclasses.replace(spec.config, act_dtype=torch.bfloat16)
    for n_micro, steps in LM_TRAIN_RUNS:
        argv = ["--arch", "gemma2_2b", "--steps", str(steps), "--batch", str(LM_TRAIN_B), "--seq", str(LM_TRAIN_S),
                "--n-micro", str(n_micro), "--log-every", "1", "--device", str(dev)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        out = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        routes = no_launches(f"gemma2-2b training, n_micro {n_micro}")
        hist = out.history
        if out.step != steps or len(hist) != steps or not all(math.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"gemma2-2b n_micro {n_micro}: step {out.step}, losses {[h['loss'] for h in hist]}")
        if not all(isinstance(t, DTensor) for t in tree_leaves(out.params)):
            raise AssertionError("launch.train.main returned parameters that are not DTensors")
        params, opt_state = tree_map(_local, out.params), tree_map(_local, out.opt_state)  # one rank: the whole
        del out
        stuck = [i for i, (a, b) in enumerate(zip(tree_leaves(init), tree_leaves(params)))
                 if bool(torch.equal(a, b.to(cpu)))]
        if stuck:
            raise AssertionError(f"gemma2-2b n_micro {n_micro}: leaves {stuck} unchanged after {steps} steps")
        ms = [h["time"] * 1e3 for h in hist]
        step_ms = sum(ms[2:]) / len(ms[2:])  # replays: step 1 is the key's warm-up, step 2 its capture
        split = {}
        if n_micro == 1:  # one more plain eager step of the trained state under torch.profiler
            step = make_lm_train_step(build_model(bcfg), AdamW(lr=1e-4, weight_decay=0.01), donate=True).eager
            batch = _lm_batch(torch, np.random.default_rng(3), spec.config, LM_TRAIN_B, LM_TRAIN_S, dev)
            split = time_split(torch, lambda p, b: step(p, opt_state, b), params, batch)
            del step, batch
        row = {"path": "mesh", "n_micro": n_micro, "steps": steps, "batch": [LM_TRAIN_B, LM_TRAIN_S], "params": n,
               "losses": [h["loss"] for h in hist], "ms": ms, "step_ms": step_ms,
               "tokens_per_s": LM_TRAIN_B * LM_TRAIN_S / (step_ms / 1e3), "peak_bytes": peak,
               "grad_routes": routes, "wall_s": wall, "split": split}
        rows[f"gemma2_2b n_micro {n_micro}"] = row
        print(f"gemma2-2b train ({n:,} parameters, full depth, {LM_TRAIN_B} x {LM_TRAIN_S} tokens, bf16, remat, "
              f"n_micro {n_micro}, launch.train.main on a one-rank NCCL mesh, DTensor parameters): {steps} steps, "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} (all finite), all {len(tree_leaves(init))} "
              f"leaves changed; step ms {step_ms:.2f} (steps 3-{steps}, CUDA-graph replays, synchronised; step 1, "
              f"the eager warm-up, {ms[0]:.2f}, step 2, the capture and its replay, {ms[1]:.2f}), "
              f"{row['tokens_per_s']:,.0f} tokens/s, peak {peak / 2**30:.2f} GiB; kernel launches 0, plain routes "
              f"taken under autograd {json.dumps(routes)} ({routes.get('flash_attention', 0) / steps:g} flash a "
              f"step: {spec.config.n_layers} layers x {n_micro} micro-batches x forward and remat's recompute); "
              f"main {wall:.1f} s | {smi}")
        if split:
            kinds = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split["by_kind"].items(), key=lambda kv: -kv[1]))
            print(f"  one more plain eager step under torch.profiler: {split['wall_ms']:.2f} ms wall, device busy "
                  f"{split['busy_ms']:.2f} ms ({kinds}), idle {100 * split['idle_share']:.1f}%; largest other: "
                  + "; ".join(f"{k} {v:.2f}" for k, v in split["top_other"]))
            print("  its device ms by op (own kernels): " + "; ".join(f"{k} {v:.2f}" for k, v in split["top_ops"]))
            print("  by backward node (with its ops): " + "; ".join(f"{k} {v:.2f}" for k, v in split["top_backward"]))
        elif n_micro == 1:
            print("  step time split: not measured (the profiler recorded no kernel)")
        del params, opt_state
        torch.cuda.empty_cache()

    # ---- the same run on the plain path (plain tensors, make_lm_train_step called directly, the same batches)
    steps = LM_TRAIN_RUNS[0][1]
    model = build_model(bcfg)
    opt = AdamW(lr=warmup_cosine(1e-3, 50, steps), weight_decay=0.01)
    params = tree_map(lambda t: t.to(dev, copy=True), init)
    state = opt.init(params)
    data = Prefetcher(token_batches(LM_TRAIN_B, LM_TRAIN_S, bcfg.vocab, seed=0), transform=lambda b: to_device(b, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    try:
        out = run_train_loop(make_lm_train_step(model, opt, donate=True), params, state, data,
                             LoopConfig(steps, None, log_every=1), log_fn=lambda line: None)
    finally:
        data.close()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    no_launches("gemma2-2b plain training")
    hist = out.history
    ms = [h["time"] * 1e3 for h in hist]
    step_ms = sum(ms[2:]) / len(ms[2:])
    mesh_row = rows["gemma2_2b n_micro 1"]
    loss_rel = [_rel(a, h["loss"]) for a, h in zip(mesh_row["losses"], hist)]
    rows["gemma2_2b plain"] = {"path": "plain", "n_micro": 1, "steps": steps, "losses": [h["loss"] for h in hist],
                               "ms": ms, "step_ms": step_ms, "tokens_per_s": LM_TRAIN_B * LM_TRAIN_S / (step_ms / 1e3),
                               "peak_bytes": peak, "loss_rel_vs_mesh": loss_rel}
    print(f"gemma2-2b train on the plain path (plain tensors, make_lm_train_step in run_train_loop, the launcher's "
          f"batches): {steps} steps, step ms {step_ms:.2f} (steps 3-{steps}, replays; step 1 {ms[0]:.2f}, step 2 "
          f"{ms[1]:.2f}), "
          f"{LM_TRAIN_B * LM_TRAIN_S / (step_ms / 1e3):,.0f} tokens/s, peak {peak / 2**30:.2f} GiB; mesh path "
          f"{mesh_row['step_ms']:.2f} ms ({mesh_row['step_ms'] / step_ms:.3f}x), {mesh_row['tokens_per_s']:,.0f} "
          f"tokens/s, peak {mesh_row['peak_bytes'] / 2**30:.2f} GiB; loss per step relative to the mesh path's: "
          + ", ".join(f"{r:.1e}" for r in loss_rel) + f" | {smi}")
    del out, params, state
    torch.cuda.empty_cache()
    rows["gemma2_2b step1 mesh vs plain"] = mesh_vs_plain_step1(torch, smi, dev, bcfg, init, steps)
    rows["gemma2_2b stacked grads"] = stacked_grads_ab(torch, smi, dev, bcfg, init)
    rows["gemma2_2b graph ab"] = lm_train_graph_ab(torch, smi, dev, bcfg, init)
    del init

    # ---- step 1 on the card against the CPU (f32, 2 layers)
    cfg = dataclasses.replace(spec.config, n_layers=2, act_dtype=torch.float32)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0))
    batch_np = _lm_batch(torch, np.random.default_rng(1), cfg, LM_STEP1_B, LM_STEP1_S, cpu)
    def step1(d):
        """(metrics, gradient leaves, parameter leaves after the step), on the host."""
        opt = _RecordingOptimizer(AdamW(lr=1e-3, weight_decay=0.01))
        p = tree_map(lambda t: t.to(d), p_cpu)
        reset()
        new, _, m = make_lm_train_step(model, opt)(p, opt.opt.init(p), tree_map(lambda t: t.to(d), batch_np))
        no_launches(f"step 1 on {d}")
        return ({k: float(v) for k, v in m.items()}, [g.to(cpu) for g in tree_leaves(opt.grads)],
                [t.to(cpu) for t in tree_leaves(new)])

    (mc, gc, pc), (md, gd, pd) = step1(cpu), step1(dev)
    torch.cuda.empty_cache()
    loss_rel = _rel(md["loss"], mc["loss"])
    grad_rel = [_rel_norm(a, b) for a, b in zip(gd, gc)]
    worst = max(range(len(grad_rel)), key=grad_rel.__getitem__)
    paths = _paths(p_cpu)
    dp = max(float((a - b).abs().max()) for a, b in zip(pd, pc))
    rows["step1_vs_cpu"] = {"loss": [md["loss"], mc["loss"]], "loss_rel": loss_rel, "grad_rel": grad_rel,
                            "worst_leaf": paths[worst], "grad_norm": [md["grad_norm"], mc["grad_norm"]],
                            "max_param_delta": dp}
    print(f"gemma2-2b step 1 (full width, 2 layers, f32, {LM_STEP1_B} x {LM_STEP1_S}), card vs CPU: loss "
          f"{md['loss']:.6f} / {mc['loss']:.6f} (rel {loss_rel:.2e}, <= {LM_STEP1_LOSS_RTOL:g}), gradient leaves' "
          f"relative Frobenius difference: worst {grad_rel[worst]:.3e} ({paths[worst]}, <= {LM_STEP1_GRAD_TOL:g}), "
          f"median {sorted(grad_rel)[len(grad_rel) // 2]:.3e} over {len(grad_rel)} leaves; grad_norm "
          f"{md['grad_norm']:.6f} / {mc['grad_norm']:.6f}; parameters after AdamW max |delta| {dp:.3e}")
    if not loss_rel <= LM_STEP1_LOSS_RTOL or not grad_rel[worst] <= LM_STEP1_GRAD_TOL:
        raise AssertionError(f"gemma2-2b step 1: card vs CPU beyond tolerance: loss {loss_rel:.3e}, "
                             f"{ {paths[i]: r for i, r in enumerate(grad_rel) if not r <= LM_STEP1_GRAD_TOL} }")
    del p_cpu, gc, gd, pc, pd

    # ---- one bf16 step of each other family at full width, 2 layers
    for arch, depth, S in LM_TRAIN_FAMILIES:
        fspec = get_arch(arch)
        whisper = fspec.family == "whisper"
        layers = {"n_enc_layers": depth, "n_dec_layers": depth} if whisper else {"n_layers": depth}
        fcfg = dataclasses.replace(fspec.config, act_dtype=torch.bfloat16, **layers)
        fmodel = build_model(fcfg)
        params = fmodel.init(torch.Generator(dev).manual_seed(0))
        opt = AdamW(lr=1e-3, weight_decay=0.01)
        state = opt.init(params)
        step = make_lm_train_step(fmodel, opt, donate=True)
        rng = np.random.default_rng(2)
        batches = [_lm_batch(torch, rng, fcfg, 2, S, dev, whisper) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i, batch in enumerate(batches):
            reset()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            loss = m["loss"].item()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(loss):
                raise AssertionError(f"{arch} step {i + 1}: loss {loss}")
        peak = torch.cuda.max_memory_allocated()
        routes = no_launches(f"{arch} training step")
        check_train_captured(step, 1, f"{arch} training step 2")  # step 1 is the key's eager warm-up
        want = {"ssd"} if fspec.family == "mamba2" else {"flash_attention"} if whisper else {"flash_attention", "ssd"}
        if set(routes) != want:
            raise AssertionError(f"{arch}: plain routes taken {routes}, want {sorted(want)}")
        rows[arch] = {"layers": depth, "batch": [2, S], "params": param_count(params), "loss": loss,
                      "ms": times, "peak_bytes": peak, "grad_routes": routes}
        print(f"{arch} train step ({param_count(params):,} parameters, full width, {depth} layers"
              f"{' each side, frames (2, ' + str(fcfg.n_frames) + ', ' + str(fcfg.d_model) + ')' if whisper else ''}, "
              f"2 x {S} tokens, bf16, remat): step 2 loss {loss:.4f} (finite, new tokens), {times[1]:.2f} ms (its "
              f"capture and first replay; step 1, the eager warm-up, {times[0]:.2f}), peak {peak / 2**30:.2f} GiB; kernel launches 0, plain routes a step "
              f"{json.dumps(routes)} | {smi}")
        del params, state, step, batches, batch
        torch.cuda.empty_cache()

    # ---- the loop's fault path: rescue checkpoint, bit-exact restore, resume
    scfg = dataclasses.replace(spec.smoke, act_dtype=torch.float32)
    smodel = build_model(scfg)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    real = make_lm_train_step(smodel, opt, donate=True)
    last = {}

    def step(p, s, b):
        out = real(p, s, b)
        last["tree"], last["step"] = {"params": out[0], "opt_state": out[1]}, int(out[1]["step"])
        return out

    data = token_batches(4, 64, scfg.vocab, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()} for _ in range(16)]

    def fresh():
        p = smodel.init(torch.Generator().manual_seed(0), device=dev)
        return p, opt.init(p)

    def same(a, b):
        return all(x.device == y.device and torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    quiet = []
    with tempfile.TemporaryDirectory() as d:
        out = run_train_loop(step, *fresh(), iter(batches), LoopConfig(8, d, ckpt_every=4, log_every=100),
                             log_fn=quiet.append)
        tree, at, _ = restore_checkpoint(d, last["tree"])
        if out.step != 8 or at != 8 or not same(tree, {"params": out.params, "opt_state": out.opt_state}):
            raise AssertionError(f"loop: step {out.step}, checkpoint at {at}, restored tree differs from the saved one")
        try:
            run_train_loop(step, *fresh(), FailingIterator(iter(batches[8:]), 2), LoopConfig(16, d, ckpt_every=4),
                           log_fn=quiet.append)
            raise AssertionError("the injected data failure did not reach the caller")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        tree, at, _ = restore_checkpoint(d, last["tree"])
        if at != 10 or last["step"] != 10 or not same(tree, last["tree"]):
            raise AssertionError(f"rescue checkpoint at {at}, last step {last['step']}: restored tree differs")
        out = run_train_loop(step, *fresh(), iter(batches[10:]), LoopConfig(16, d, ckpt_every=4), log_fn=quiet.append)
        if out.step != 16 or "[loop] resumed from step 10" not in quiet:
            raise AssertionError(f"resumed run reached step {out.step}; log {quiet}")
        marker = Path(d) / "ran"
        rc = supervise([_sys.executable, "-c", f"import pathlib, sys; m = pathlib.Path({str(marker)!r}); "
                        "ok = m.exists(); m.touch(); sys.exit(0 if ok else 3)"], max_restarts=2, backoff=0.0,
                       log=quiet.append)
        if rc != 0:
            raise AssertionError(f"supervise returned {rc}: {quiet}")
    rows["fault_path"] = {"rescue_step": 10, "resumed_to": 16, "supervise_rc": rc}
    print("loop fault path (gemma2-2b smoke, f32, on the card): checkpoint at step 8 restores bit for bit; a data "
          "failure at step 10 leaves a rescue checkpoint that restores the last step's tree bit for bit; the resumed "
          "run reaches step 16; supervise restarts a command that fails once and returns 0")
    return rows


DIST_B, DIST_S = 2, 64  # the compressed-gradient batch (gemma2-2b at full width, 2 layers, f32)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_phase(torch, smi, dev):
    """The distributed stack on the card, one rank (the docstring's item
    13). Returns rows."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import build_model, get_arch
    from repro_torch.data import shard_batch, token_batches
    from repro_torch.dist import PartitionSpec, device_put, make_compressed_dp_grad_fn, on_mesh, train_shardings
    from repro_torch.dist import zeros_like_error
    from repro_torch.launch.distributed import backend_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.train import AdamW, LoopConfig, make_lm_train_step, run_train_loop
    from repro_torch.train.losses import chunked_cross_entropy

    rows = {}
    cpu = torch.device("cpu")
    quiet = []

    # ---- the multi-process flags, one process: TCP rendezvous at a coordinator, NCCL
    port = _free_port()
    seen = {}

    def recording(backend=None, **kwargs):
        seen.update(kwargs, backend=backend)
        real(backend, **kwargs)
        seen["group"] = (dist.get_backend(), dist.get_world_size(), dist.get_rank())

    with patched(dist, "init_process_group", recording) as real:
        out = train_main(["--smoke", "--steps", "2", "--batch", "4", "--seq", "64", "--log-every", "1",
                          "--device", str(dev), "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
                          "--process-id", "0"])
    backend = backend_for(dev)  # nccl on the card
    want = {"backend": backend, "init_method": f"tcp://127.0.0.1:{port}", "world_size": 1, "rank": 0}
    if {k: seen.get(k) for k in want} != want or seen.get("group") != (backend, 1, 0):
        raise AssertionError(f"--coordinator: init_process_group got {seen}, want {want}")
    if out.step != 2 or not all(math.isfinite(h["loss"]) for h in out.history) or dist.is_initialized():
        raise AssertionError(f"--coordinator run: step {out.step}, history {out.history}, "
                             f"group left {dist.is_initialized()}")
    rows["tcp_init"] = {"init_method": seen["init_method"], "group": list(seen["group"]),
                        "losses": [h["loss"] for h in out.history]}
    print(f"--coordinator 127.0.0.1:{port} --num-processes 1 --process-id 0: init_process_group({backend}, "
          f"{seen['init_method']}) -> group {seen['group']}, the smoke gemma2-2b trains 2 steps (losses "
          + ", ".join(f"{h['loss']:.4f}" for h in out.history) + "), the group destroyed after main")
    del out

    # ---- --production-mesh / --multipod need 256 / 512 ranks
    for flags, need in ((["--production-mesh"], 256), (["--production-mesh", "--multipod"], 512)):
        try:
            train_main(["--smoke", "--steps", "1", "--device", str(dev), *flags])
            raise AssertionError(f"{flags} trained on one card")
        except RuntimeError as e:
            if f"need {need} ranks" not in str(e):
                raise
        if dist.is_initialized():
            raise AssertionError(f"{flags} left a process group")
    print("--production-mesh and --production-mesh --multipod raise RuntimeError on one card: need 256 / 512 ranks")

    # ---- compressed data-parallel gradients on the card (a one-rank mesh) vs the CPU (mesh=None)
    spec = get_arch("gemma2_2b")
    cfg = dataclasses.replace(spec.config, n_layers=2, act_dtype=torch.float32)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    b_cpu = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (DIST_B, DIST_S)).astype(np.int32))
             for k in ("tokens", "labels")}

    def loss_fn(p, b):
        hidden, _ = model(p, b["tokens"], return_hidden=True)
        return chunked_cross_entropy(model.head, p, hidden, b["labels"])

    def two_steps(mesh, d):
        gf = make_compressed_dp_grad_fn(loss_fn, mesh, PartitionSpec("data"))
        p, b = tree_map(lambda t: t.to(d), p_cpu), tree_map(lambda t: t.to(d), b_cpu)
        g1, e1 = gf(p, b, zeros_like_error(p, 2))
        g2, e2 = gf(p, b, e1)
        return [[t.to(cpu) for t in tree_leaves(x)] for x in (g1, e1, g2, e2)]

    mesh = make_host_mesh(1, device=dev)
    try:
        t0 = time.perf_counter()
        card = two_steps(mesh, dev)
        card_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    host = two_steps(None, cpu)
    # each device's dequantized leaf is level * scale, scale = max|g| / 127: the levels may differ by one
    # where the two devices' sums straddle a rounding boundary, the scales by the sums' rounding
    worst_level, flipped, n_el, scale_rel = 0, 0, 0, 0.0
    for c, h in ((card[0], host[0]), (card[2], host[2])):
        for a, b in zip(c, h):
            sa, sb = float(a.abs().max()) / 127, float(b.abs().max()) / 127
            diff = (torch.round(a / max(sa, 1e-30)) - torch.round(b / max(sb, 1e-30))).abs()
            worst_level = max(worst_level, int(diff.max()))
            flipped += int((diff > 0).sum())
            n_el += diff.numel()
            scale_rel = max(scale_rel, abs(sa - sb) / max(sb, 1e-30))
    resid = max(float((a - b).abs().max()) for a, b in zip(card[3], host[3]))
    rows["compressed"] = {"batch": [DIST_B, DIST_S], "layers": 2, "worst_level_delta": worst_level,
                          "flipped_share": flipped / n_el, "scale_rel": scale_rel, "resid_max_abs": resid,
                          "card_s": card_s}
    print(f"make_compressed_dp_grad_fn (gemma2-2b full width, 2 layers, f32, {DIST_B} x {DIST_S}, 8 bits, 2 carriers, "
          f"two error-feedback steps): card (one-rank NCCL mesh, the all-reduce over 'data') vs CPU (mesh=None): "
          f"levels differ by at most {worst_level} quantization step (<= 1) at {flipped} of {n_el:,} elements, "
          f"scales within {scale_rel:.2e} (<= 1e-5); residuals max |delta| {resid:.3e}; card {card_s:.1f} s")
    if not (worst_level <= 1 and scale_rel <= 1e-5):
        raise AssertionError(f"compressed gradients: card vs CPU levels {worst_level} apart, scales {scale_rel:.2e}")
    del card, host, p_cpu, model

    # ---- a checkpoint saved on the mesh path, resumed with shardings=: bit-equal to an unbroken run
    scfg = dataclasses.replace(spec.smoke, n_layers=2, act_dtype=torch.float32)
    smodel = build_model(scfg)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    data = token_batches(4, 64, scfg.vocab, seed=0)
    batches = [next(data) for _ in range(8)]
    mesh = make_host_mesh(1, device=dev)
    try:
        p0 = smodel.init(torch.Generator().manual_seed(0), device=dev)
        sh = train_shardings(mesh, smodel.axes(), smodel.abstract(), opt.init(p0), 4)
        shardings = {"params": sh.params, "opt_state": sh.opt_state}
        step = on_mesh(make_lm_train_step(smodel, opt, donate=True))

        def fresh():  # copies: a replicated leaf is placed without one, and the step writes into it
            return device_put(tree_map(torch.clone, p0), sh.params), device_put(opt.init(p0), sh.opt_state)

        def feed(bs):
            return (shard_batch(b, sh.batch) for b in bs)

        with tempfile.TemporaryDirectory() as d:
            whole = run_train_loop(step, *fresh(), feed(batches), LoopConfig(8, f"{d}/a", ckpt_every=4, log_every=1),
                                   log_fn=quiet.append, shardings=shardings)
            # the captured step's buffers, which the next runs of the step take over (trees copied in)
            unbroken = [t.to_local().clone() for t in tree_leaves((whole.params, whole.opt_state))]
            run_train_loop(step, *fresh(), feed(batches[:4]), LoopConfig(4, f"{d}/b", ckpt_every=4, log_every=1),
                           log_fn=quiet.append, shardings=shardings)
            manifest = Path(f"{d}/b/MANIFEST").read_text().split()
            shards = sorted(p.name for p in Path(f"{d}/b").glob("step_*/shard_*"))
            resumed = run_train_loop(step, *fresh(), feed(batches[4:]),
                                     LoopConfig(8, f"{d}/b", ckpt_every=4, log_every=1), log_fn=quiet.append,
                                     shardings=shardings)
        placed = all(isinstance(t, DTensor) and t.placements == s.placements
                     for t, s in zip(tree_leaves(resumed.params), tree_leaves(sh.params)))
        same = all(torch.equal(a, b.to_local()) for a, b in
                   zip(unbroken, tree_leaves((resumed.params, resumed.opt_state))))
        hist = [h["loss"] for h in whole.history[4:]] == [h["loss"] for h in resumed.history]
    finally:
        dist.destroy_process_group()
    if not ("[loop] resumed from step 4" in quiet and manifest == ["4", "1"] and shards == ["shard_00000.ckpt"]
            and placed and same and hist):
        raise AssertionError(f"mesh checkpoint resume: manifest {manifest}, shards {shards}, placed {placed}, "
                             f"bit-equal {same}, losses {hist}; log {quiet[-4:]}")
    rows["resume"] = {"manifest": manifest, "bit_equal": same, "losses": [h["loss"] for h in resumed.history]}
    print("mesh checkpoint (smoke gemma2-2b, 2 layers, f32, one-rank NCCL mesh): saved at step 4 (shard_00000.ckpt, "
          "MANIFEST names step 4 and 1 rank), resumed with shardings= (every leaf a DTensor with its placements); "
          f"steps 5-8 bit-equal to an unbroken run (parameters, AdamW state, losses) | {smi}")
    return rows


# (arch, shape, multi-pod) cells of the dry run (``dryrun_phase``): gemma2-2b's
# training and decode cells and mamba2-2.7b's batch-1 decode over 524,288
# tokens (the sequence-sharded caches) on the 16 x 16 mesh; mamba2-2.7b's and
# whisper-small's prefills on the 2 x 16 x 16 mesh (the batch over "pod" and
# "data"; on torch 2.11 they need the embedding lookup as aten.embedding and
# the strategies dist.mesh_ops registers for Mamba2's causal pad and
# LayerNorm's var_mean)
# mamba2-2.7b's batch-128 decode on both meshes: its SSD decode step runs with
# the batch over "data" (and "pod") and the heads over "model"
DRYRUN_CELLS = (("gemma2_2b", "train_4k", False), ("gemma2_2b", "decode_32k", False),
                ("mamba2_2_7b", "long_500k", False), ("mamba2_2_7b", "prefill_32k", True),
                ("whisper_small", "prefill_32k", True), ("mamba2_2_7b", "decode_32k", False),
                ("mamba2_2_7b", "decode_32k", True), ("hymba_1_5b", "decode_32k", False),
                ("gemma2_2b", "long_500k", True), ("hymba_1_5b", "long_500k", True))
# a decode cell's step writes into its donated caches: its outputs (the
# logits) and temps (about one layer's cache at most) stay within this many
# GiB a rank, where a step that returned new caches came to a whole cache
# each (26 GiB each for gemma2-2b's decode_32k, whose total bound
# tests/test_torch_decode_donate.py holds); and these cells' totals within
# their bounds (from 33.12 GiB)
DECODE_CELL_SPARE_GIB = 2.0
DECODE_CELL_GIB = {("hymba_1_5b", "decode_32k", False): 15.0}
# Mamba-2's decode cells on either mesh, every torch version: the layer loop
# carries the residual whole over "model" (dist.carry), so a step issues one
# all-reduce a layer for the out-projection's partial sum and one for the
# gated norm's statistics: (all-reduce, all-gather, reduce-scatter)
CARRY_COUNTS = {("mamba2_2_7b", "decode_32k"): (128, 0, 0), ("mamba2_2_7b", "long_500k"): (128, 0, 0)}
# experiments/torch_hillclimb.py's own example: (arch, shape, variant)
HILLCLIMB = ("mamba2_2_7b", "train_4k", {"n_micro": 2})
# smoke-width cells on a fake 2 x 2 ("data", "model") group, where every mesh
# dim splits the batch or the heads (tests/test_torch_dryrun.py's cells; on
# torch 2.11 these raised in DTensor's view of an einsum's batch and head dims,
# and the M-RoPE train cell in its in-place index_put): (family's arch, kind)
SMOKE_2X2_CELLS = tuple((a, "decode") for a in ("gemma2_2b", "deepseek_moe_16b", "qwen2_vl_7b", "mamba2_2_7b",
                                                 "hymba_1_5b", "whisper_small")) + tuple(
    (a, "train") for a in ("gemma2_2b", "deepseek_moe_16b", "deepseek_v2_lite_16b", "qwen2_vl_7b", "hymba_1_5b",
                           "whisper_small"))
# two-rank launches on the host, (arch, micro-batches): MoE's dispatch over
# both ranks' tokens; Mamba2, whose scan argument A has no batch dim
LAUNCHES = (("deepseek_moe_16b", 2), ("mamba2_2_7b", 1))
LAUNCH_RTOL = 1e-5  # tests/test_torch_dist_ranks.py's bound on the two ranks' losses
# tests/test_torch_dist_data.py's cases (launch.dryrun.DATA_CASES): each kind
# on four gloo ranks of a (2, 2) ("data", "model") mesh against one process
DATA_KINDS = ("decode", "long", "prefill", "train")


def _smoke_2x2_cells():
    """``SMOKE_2X2_CELLS`` built, run and checked by
    ``launch.dryrun.check_cell`` (two micro-batches, its smoke-width
    shapes) on a fake 2 x 2 group. Returns a row per cell."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun

    rows = []
    for arch, kind in SMOKE_2X2_CELLS:
        t0 = time.perf_counter()
        with dryrun.dry_run(4):
            counts = dryrun.check_cell(init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")), arch, kind)
        rows.append({"arch": arch, "kind": kind, "flops": counts.flops,
                     "collectives": sum(counts.collective_counts.values()), "host_s": time.perf_counter() - t0})
    return rows


def _two_rank_launch_rank(rank, world, port, arch, n_micro, queue):
    """One rank of a two-process launch (``launch.train.main``): its
    metrics, its replicated parameters and whether it made a CUDA
    context."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.nn.module import tree_leaves

    torch.set_num_threads(1)
    res = launch_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
                             "--n-micro", str(n_micro), "--device", "cpu", "--log-every", "1", "--coordinator",
                             f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id", str(rank)])
    replicas = [t.to_local().numpy() for t in tree_leaves(res.params) if not any(p.is_shard() for p in t.placements)]
    queue.put((rank, {k: [h[k] for h in res.history] for k in ("loss", "aux", "grad_norm")}, replicas,
               torch.cuda.is_initialized()))


def _gloo_ranks(target, world, *args):
    """``target(rank, world, port, *args, queue)`` in ``world`` spawned
    processes that meet over TCP on a free local port, every rank with
    ``PYTHONHASHSEED=0`` (DTensor's ties follow each process's string
    hashing); each rank puts ``(rank, *rest)`` on the queue. Returns
    ``{rank: rest}``; raises where a rank exits non-zero. Every process
    is joined or killed."""
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        ranks = [ctx.Process(target=target, args=(r, world, port, *args, queue)) for r in range(world)]
        for p in ranks:
            p.start()
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
    try:
        got = dict((r, rest) for r, *rest in (queue.get(timeout=600) for _ in ranks))
    finally:
        for p in ranks:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if any(p.exitcode for p in ranks):
        raise AssertionError(f"{target.__name__}: exit codes {[p.exitcode for p in ranks]}")
    return got


def _two_rank_launch(arch, n_micro):
    """``arch``'s smoke config trained two steps by ``launch.train.main`` in
    two gloo ranks on the host, against one process's steps on the batches
    assembled from each rank's rows (``launch.train.reference_steps``):
    losses, load-balance terms and gradient norms within ``LAUNCH_RTOL``,
    and the replicated parameters equal on both ranks. Returns the row."""
    import numpy as np

    from repro_torch.launch.train import reference_steps

    got = _gloo_ranks(_two_rank_launch_rank, 2, arch, n_micro)
    if any(g[2] for g in got.values()):
        raise AssertionError(f"{arch} launch ranks: CUDA context {[g[2] for g in got.values()]}")
    history, _ = reference_steps(arch, 2, 4, 16, n_micro=n_micro, world=2)
    want = {k: [h[k] for h in history] for k in got[0][0]}
    rel = max(abs(a - b) / abs(b) for k in want for a, b in zip(got[0][0][k], want[k]) if b)
    apart = sum(not np.array_equal(a, b) for a, b in zip(got[0][1], got[1][1]))
    if got[0][0] != got[1][0] or rel > LAUNCH_RTOL or apart:
        raise AssertionError(f"{arch} launch: ranks' metrics {got[0][0]} {got[1][0]} against one process's {want}: "
                             f"max relative {rel:.3e} (bound {LAUNCH_RTOL}); {apart} replicated parameters apart")
    return {"arch": arch, "n_micro": n_micro, "metrics": got[0][0], "one_process": want, "max_rel": rel,
            "replicas": len(got[0][1])}


def _data_rank(rank, world, port, kind, queue):
    """One of four gloo ranks on a (2, 2) ("data", "model") mesh running
    every ``launch.dryrun.DATA_CASES`` case of ``kind`` and, on plain
    tensors in this process, the same call: each case's error
    (``data_error``) or the traceback it raised, and whether the rank
    made a CUDA context."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        got = dryrun.data_rank(kind, init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()
    errs = {a: r if isinstance(r, str) else dryrun.data_error(r, dryrun.data_outputs(a, kind))
            for a, r in got.items()}
    queue.put((rank, errs, torch.cuda.is_initialized()))


def _data_check(kind):
    """``kind``'s ``DATA_CASES`` on four gloo ranks against one process:
    each case's largest error over the ranks. Raises where a rank raised,
    made a CUDA context or a case is outside ``DATA_TOL``."""
    import torch

    from repro_torch.launch import dryrun

    got = _gloo_ranks(_data_rank, 4, kind)
    if any(g[1] for g in got.values()):
        raise AssertionError(f"ranks with data, {kind}: CUDA context {[g[1] for g in got.values()]}")
    raised = {a: e for g in got.values() for a, e in g[0].items() if isinstance(e, str)}
    if raised:
        raise AssertionError(f"ranks with data, {kind}: "
                             + "\n".join(f"{a} raised:\n{e}" for a, e in raised.items()))
    cases = {a: max(g[0][a] for g in got.values()) for a in got[0][0]}
    out = {a: e for a, e in cases.items() if not e <= dryrun.DATA_TOL}
    if out:
        raise AssertionError(f"ranks with data, {kind}: {out} outside {dryrun.DATA_TOL} of the reference's "
                             "largest value")
    return {"kind": kind, "cases": cases, "max_err": max(cases.values()), "tol": dryrun.DATA_TOL,
            "torch": torch.__version__}


def _dryrun_task(task):
    """One dry-run task in a process of its own (spawned): a cell's row
    (``("cell", (arch, shape, multi_pod))``), the hillclimb script's
    (``("hillclimb", (arch, shape, variant))``), the smoke-width 2 x 2
    cells' (``("2x2", None)``), a two-rank launch's (``("launch", (arch,
    micro-batches))``) or one kind of the cases on ranks with data
    (``("data", kind)``),
    its host seconds, and whether the process has made a CUDA context (it
    must not)."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "experiments"))
    import torch

    torch.set_num_threads(1)
    kind, args = task
    t0 = time.perf_counter()
    if kind == "cell":
        from repro_torch.launch.dryrun import run_cell

        row = run_cell(*args)
    elif kind == "hillclimb":
        import torch_hillclimb

        arch, shape, variant = args
        row = dict(torch_hillclimb.run(arch, shape, **variant), status="ok")
    elif kind == "2x2":
        row = {"cells": _smoke_2x2_cells(), "status": "ok"}
    elif kind == "data":
        row = dict(_data_check(args), status="ok")
    else:
        row = dict(_two_rank_launch(*args), status="ok")
    return row, time.perf_counter() - t0, torch.cuda.is_initialized()


def _h100_plan_line(smi):
    """The paper's Pix2Pix + YOLOv8 graphs (img 256, base 64) planned on the
    host over ``h100_submesh_engines()`` (192 + 64 cards, the small engine
    under the DLA-analogue constraints), analytic costs: its cut points and
    expected cycle. Planning only: no model runs on that pair."""
    from repro_torch.core import DLA_ANALOGUE_CONSTRAINTS, h100_submesh_engines, plan
    from repro_torch.models import Pix2PixConfig, Pix2PixGenerator, YOLOv8, YOLOv8Config

    big, small = h100_submesh_engines(constraints_small=DLA_ANALOGUE_CONSTRAINTS)
    graphs = [Pix2PixGenerator(Pix2PixConfig(img_size=256, base=64, deconv_mode="cropping")).layer_graph(),
              YOLOv8(YOLOv8Config(img_size=256)).layer_graph()]
    ir = plan(graphs, [small, big], cost="analytic", impl="pallas")
    print(f"plan over h100_submesh_engines() ({small.name} {small.n_chips} cards, {big.name} {big.n_chips}; "
          f"analytic costs, Pix2Pix + YOLOv8 at img 256): cuts {ir.cuts}, engines "
          f"{[[ir.engine_names[seg.engine] for seg in segs] for segs in ir.segments]}, expected cycle "
          f"{ir.expected_cycle * 1e6:.3f} us (predicted, planning only) | {smi}")
    return {"cuts": ir.cuts, "expected_cycle_s": ir.expected_cycle}


def dryrun_phase(smi):
    """The dry run (the docstring's item 14): ``DRYRUN_CELLS`` through
    ``launch.dryrun.run_cell`` and ``HILLCLIMB`` through
    ``experiments/torch_hillclimb.py``, at full width and depth, the
    smoke-width 2 x 2 cells and the two-rank MoE launch, each task in one
    of four spawned processes with its own fake process group (or its own
    gloo ranks) apart from this process's groups; every cell ``ok``, no
    CUDA context in those processes and Mamba-2's decode cells at
    ``CARRY_COUNTS``. Then the planning line over the H100 engine pair.
    Returns the rows."""
    import multiprocessing

    import torch

    torch_version = torch.__version__
    t0 = time.perf_counter()
    # the longest first (gemma2-2b's train_4k cell, the hillclimb call, the
    # 2 x 2 cells, the launches), so that the short cells fill in at the end
    tasks = ([("cell", DRYRUN_CELLS[0]), ("hillclimb", HILLCLIMB), ("2x2", None)] + [("launch", a) for a in LAUNCHES]
             + [("data", k) for k in DATA_KINDS] + [("cell", c) for c in DRYRUN_CELLS[1:]])
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [ex.submit(_dryrun_task, t) for t in tasks]
        done = [f.result(timeout=900) for f in futures]
    wall = time.perf_counter() - t0
    rows = []
    for (kind, args), (r, seconds, touched_card) in zip(tasks, done):
        if touched_card:
            raise AssertionError(f"the dry run's process made a CUDA context ({kind} {args})")
        if kind == "2x2":
            print(f"dry run, smoke widths on a fake 2 x 2 (data, model) group: {len(r['cells'])} cells ok ("
                  + ", ".join(f"{c['arch']} {c['kind']} {c['collectives']} collectives {c['host_s']:.1f} s"
                              for c in r["cells"]) + f"), host {seconds:.1f} s")
            rows.append(dict(r, task=kind, host_s=seconds))
            continue
        if kind == "data":
            print(f"ranks with data, {args}: {len(r['cases'])} cases on 4 gloo ranks, (2, 2) (data, model), "
                  f"torch {r['torch']}: largest error {r['max_err']:.3e} of the reference's largest value "
                  f"(bound {r['tol']}) (" + ", ".join(f"{a} {e:.2e}" for a, e in r["cases"].items())
                  + f"), host {seconds:.1f} s")
            rows.append(dict(r, task=kind, host_s=seconds))
            continue
        if kind == "launch":
            print(f"two-rank launch ({r['arch']} smoke, 2 gloo ranks, {r['n_micro']} micro-batches): "
                  f"{r['metrics']} against one process's {r['one_process']}: max relative {r['max_rel']:.3e} "
                  f"(bound {LAUNCH_RTOL}); {r['replicas']} replicated parameters equal on both ranks, "
                  f"host {seconds:.1f} s")
            rows.append(dict(r, task=kind, host_s=seconds))
            continue
        if r["status"] != "ok":
            raise AssertionError(f"dry run {r['arch']} {r['shape']} {r['mesh']}: {r['status']} {r.get('error')}\n"
                                 f"{r.get('trace', '')}")
        mem = {k: v / 2**30 for k, v in r["memory_per_device"].items()}
        if kind == "cell" and r["kind"] == "decode":
            bound = DECODE_CELL_GIB.get(args, mem["total"])
            if mem["outputs"] + mem["temps"] > DECODE_CELL_SPARE_GIB or mem["total"] > bound:
                raise AssertionError(f"dry run {r['arch']} {r['shape']} {r['mesh']}: {mem} GiB a rank, want "
                                     f"outputs + temps <= {DECODE_CELL_SPARE_GIB} and a total <= {bound} (the "
                                     "caches written in place)")
        counts = {k: v for k, v in r["collective_counts"].items() if k != "bytes_by_kind"}
        mb = {k: v / 1e6 for k, v in r["collective_counts"]["bytes_by_kind"].items() if v}
        what = f"hillclimb {args[2]}" if kind == "hillclimb" else "dry run"
        print(f"{what} {r['arch']} {r['shape']} {r['mesh']}, torch {torch_version} (predicted for the H100 SXM's "
              f"peaks): compute {r['t_compute_s'] * 1e3:.3f} ms, memory {r['t_memory_s'] * 1e3:.3f} ms, "
              f"collective {r['t_collective_s'] * 1e3:.3f} ms, bottleneck {r['bottleneck']}, per-rank memory "
              f"{mem['total']:.2f} GiB (outputs {mem['outputs']:.3f}, temps {mem['temps']:.3f}), "
              f"collectives {counts} "
              "(MB a rank by kind " + ", ".join(f"{k} {v:.4f}" for k, v in mb.items()) + f"), host {seconds:.1f} s")
        want = CARRY_COUNTS.get((r["arch"], r["shape"])) if kind == "cell" else None
        got = tuple(counts[k] for k in ("all-reduce", "all-gather", "reduce-scatter"))
        if want is not None and got != want:
            raise AssertionError(f"dry run {r['arch']} {r['shape']} {r['mesh']}, torch {torch_version}: "
                                 f"{got} all-reduces / all-gathers / reduce-scatters a step, want {want} (the "
                                 "layer loop's carry)")
        rows.append(dict(r, task=kind, host_s=seconds, torch=torch_version))
    n_data = sum(len(r["cases"]) for r in rows if r["task"] == "data")
    print(f"dry run: {len(DRYRUN_CELLS)} cells, the hillclimb call, {len(SMOKE_2X2_CELLS)} smoke-width 2 x 2 "
          f"cells, {len(LAUNCHES)} two-rank launches and {n_data} cases on ranks with data ok in "
          f"{wall:.1f} s on the host (4 processes), no CUDA context in their processes | {smi}")
    return {"rows": rows, "wall_s": wall, "h100_plan": _h100_plan_line(smi)}


def served_main_path(torch, smi, dev, ops, frames, per_frame, clock):
    """Step 4's served run on the main path (the module docstring), then
    ``served_ab``. ``frames``: the run's frames per model; ``per_frame``:
    each model's kernel launches a frame. Returns ``(want, launches,
    report, rows)``: the launch counts the run must make and made, its
    server report and the served rows."""
    from repro_torch import kernels as kernels_pkg
    from repro_torch.serve import build_server
    from served_trace import device_segments

    print(f"-- main path: build_server(img={IMG}, base={BASE}, n_pix=2, n_yolo=1, impl='pallas'), "
          "each segment a replayed CUDA graph")
    bundle = build_server(img=IMG, base=BASE, n_pix=2, n_yolo=1, impl="pallas", device=dev)
    if not bundle.server.executor.captures_graphs:
        raise AssertionError("the served run does not capture its segments in CUDA graphs")
    impls = {i for b in bundle.plan.impl_bindings() for i in b}
    routes = [[(s.engine, s.lo, s.hi) for s in segs] for segs in bundle.plan.segments]
    print(f"plan: impls {sorted(impls)} routes {routes} cycle {bundle.plan.expected_cycle * 1e3:.3f} ms (analytic)")
    if impls != {"pallas_fused"}:
        raise AssertionError(f"plan binds {impls}, want only pallas_fused")
    server = bundle.server
    for s in bundle.streams:  # warm-up frame per stream (allocator, first launches, graph captures)
        server.submit(s.model_index, bundle.frame_for(s.name, 99))
    server.drain()
    torch.cuda.synchronize()
    server.reset_metrics()
    warm_counts = len(server.executor.completions)
    frames_in = {s.name: [bundle.frame_for(s.name, t) for t in range(4)] for s in bundle.streams}
    torch.cuda.synchronize()
    ops.reset_launches()
    kernels_pkg.reset_graph_launches()
    replays0 = {id(g): g.replays for m in bundle.models for _, g in m.captured_graphs()}
    seg0, _ = device_segments(torch)
    copies = served_copies(torch)
    with served_copies(torch):  # a dispatch mode's first entry pays a one-time set-up: outside the clock
        torch.zeros(1, device=dev).clone()
    clock.start()
    with copies:
        for t in range(4):
            for s in bundle.streams:
                server.submit(s.model_index, frames_in[s.name][t])
        server.pump()
        outs = server.drain()
    torch.cuda.synchronize()
    gcs, new_segments = clock.stop(), device_segments(torch)[0] - seg0
    # every launch of the run is a graph replay: each replay of a captured
    # segment counts the launches its capture recorded
    launches = {n: ops.launches[n] + kernels_pkg.graph_launches[n] for n in REPLACES}
    rep = server.report()
    print("launches:", json.dumps(launches), "of which outside a graph:", json.dumps(dict(ops.launches)))
    for m in bundle.models:
        for name, g in m.captured_graphs():
            print(f"  graph {name}: {g.replays - replays0.get(id(g), 0)} replays x {json.dumps(g.launches)}")
    # 8 Pix2Pix frames x 8 + 4 YOLOv8 frames x 63 = 316 at img 256
    want = {n: frames["pix"] * per_frame["pix"][n] + frames["yolo"] * per_frame["yolo"][n] for n in REPLACES}
    if launches != want or any(ops.launches.values()):
        raise AssertionError(f"launch counts {launches} ({dict(ops.launches)} outside a graph), want {want}")
    # each frame written once into its slot, each output leaf cloned once
    # (Pix2Pix x; YOLOv8n p3, p4, p5), nothing between two segments; no
    # capture in the run (its slots all made at the warm-up)
    ex = server.executor
    n_copies = sum(copies.rows.values())
    graphs_now = sum(len(m.captured_graphs()) for m in bundle.models)
    slot_rows = ex.slot_counts()
    print(f"served_copies: {n_copies} host copies and clones of state leaves in {rep['frames']} frames (at most "
          f"{2 * frames['pix'] + 4 * frames['yolo']}): {json.dumps(copies.rows)}; {graphs_now} graphs "
          f"({len(replays0)} before the run), slots {json.dumps(slot_rows)}")
    if n_copies > 2 * frames["pix"] + 4 * frames["yolo"] or any(
            k.split()[0] in ("cat", "_to_copy") for k in copies.rows):
        raise AssertionError(f"the served run copies state leaves between segments: {copies.rows}")
    if graphs_now != len(replays0) or ex.slots_beyond_bound or any(r["slots"] > r["bound"] for r in slot_rows):
        raise AssertionError(f"a capture in the timed run: {graphs_now} graphs against {len(replays0)}, "
                             f"{ex.slots_beyond_bound} slots beyond their bound")
    print(
        f"served {rep['frames']} frames in {rep['wall_s'] * 1e3:.1f} ms: {rep['aggregate_fps']:.2f} frames/s, "
        f"p50 {rep['latency_p50_ms']:.2f} ms, p99 {rep['latency_p99_ms']:.2f} ms; {len(gcs)} Python collections "
        f"in the run ({sum(g[1] for g in gcs):.2f} ms: {gcs}), {new_segments} new device segments | {smi}"
    )
    shapes = {0: [(1, IMG, IMG, 3)], 1: [(1, IMG // d, IMG // d, 66) for d in (8, 16, 32)]}
    worst = 0.0
    for s in bundle.streams:
        got_all = outs[s.name][-4:]
        if len(outs[s.name]) - 1 != 4:
            raise AssertionError(f"{s.name}: {len(outs[s.name]) - 1} outputs, want 4")
        model = bundle.models[s.model_index]
        for t, got in enumerate(got_all):
            want_out = model.run_all(frames_in[s.name][t])
            g = [got] if s.model_index == 0 else [got[k] for k in ("p3", "p4", "p5")]
            w = [want_out] if s.model_index == 0 else [want_out[k] for k in ("p3", "p4", "p5")]
            if [tuple(x.shape) for x in g] != shapes[s.model_index]:
                raise AssertionError(f"{s.name}: shapes {[tuple(x.shape) for x in g]}")
            for a_, b_ in zip(g, w):
                if not torch.isfinite(a_).all():
                    raise AssertionError(f"{s.name}: non-finite output")
                torch.testing.assert_close(a_, b_, atol=5e-3, rtol=1e-2)
                worst = max(worst, (a_ - b_).abs().max().item())
    print(f"outputs: {len(bundle.streams)} streams x 4 frames finite, shapes right, "
          f"max |served - xla run_all| = {worst:.2e} (atol 5e-3, rtol 1e-2); warm-up completions {warm_counts}")

    served_rows = [{"jit_segments": True, "frames_per_s": rep["aggregate_fps"], "p50_ms": rep["latency_p50_ms"],
                    "p99_ms": rep["latency_p99_ms"], "issue_share": _engine_shares(rep),
                    "blocked_share": 1 - rep["overlap"]["overlap_efficiency"], "gc": gcs,
                    "new_device_segments": new_segments, "host_copies": copies.rows, "slots": slot_rows}]
    print(f"host-issue share {json.dumps(served_rows[0]['issue_share'])}, blocked "
          f"{100 * served_rows[0]['blocked_share']:.2f}% of the tick wall")
    served_rows += served_ab(torch, build_server, ops, dev, smi, want, clock)
    return want, launches, rep, served_rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--json", help="also write every measured row to this file")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "deconv" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.deconv import kernel as deconv_kernel
    from repro_torch.kernels.deconv import ops as deconv_ops
    from repro_torch.kernels.deconv import ref as deconv_ref
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention import ref as attn_ref
    from repro_torch.kernels.fused import kernel, ops, ref
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.serve import build_server
    from served_trace import GcClock

    clock = GcClock()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(what):
        now = time.perf_counter()
        print(f"[phase time] {what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t_build = time.perf_counter()
    kernel_mods = (kernel, deconv_kernel, attn_kernel, ssd_kernel)
    with concurrent.futures.ThreadPoolExecutor(len(kernel_mods)) as pool:  # one nvcc per source, at once
        builds = list(pool.map(lambda k: k.build(), kernel_mods))
    print(f"build: {time.perf_counter() - t_build:.1f} s for the {len(kernel_mods)} sources")
    for built in builds:
        print(f"  {Path(built['path']).name}: {built['seconds']:.1f} s nvcc")
        for line in built["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.split(":", 1)[-1].strip())
    for k in kernel_mods:
        k.library()
    flash_tc = {}
    for kern, dt in (("flash_kernel_tc", "bf16"), ("flash_kernel_tf32", "f32")):
        flash_tc[kern] = flash_tc_report(builds[kernel_mods.index(attn_kernel)]["log"],
                                         getattr(attn_kernel.library(), f"flash_attention_{dt}_smem_bytes"), kern)
        if not flash_tc[kern]:
            print(f"{kern}: no ptxas report (the library was built before this run)")
        for D, r in flash_tc[kern].items():
            print(f"{kern}<{D}> ({dt}): {r['registers']} registers, spill stores {r['spill_stores']} B, "
                  f"spill loads {r['spill_loads']} B, shared memory {r['dynamic_smem']} B dynamic + "
                  f"{r['static_smem']} B static")
    phase_tc = {}
    for mod in (deconv_kernel, kernel):
        lib_name = Path(mod._SRC).name
        phase_tc[lib_name] = phase_report(builds[kernel_mods.index(mod)]["log"],
                                          deconv_kernel.library().deconv2d_smem_bytes)
        if not phase_tc[lib_name]:
            print(f"{lib_name}: no ptxas report of the phase kernels (the library was built before this run)")
        for inst, r in phase_tc[lib_name].items():
            print(f"{lib_name} {inst}: {r['registers']} registers, spill stores {r['spill_stores']} B, "
                  f"spill loads {r['spill_loads']} B, shared memory {r['dynamic_smem']} B dynamic")
    ssd_tc = ssd_report(builds[kernel_mods.index(ssd_kernel)]["log"], ssd_kernel.library().ssd_smem_bytes)
    if not ssd_tc:
        print("ssd.cu: no ptxas report (the library was built before this run)")
    for inst, r in ssd_tc.items():
        print(f"ssd.cu {inst}: {r['registers']} registers, spill stores {r['spill_stores']} B, "
              f"spill loads {r['spill_loads']} B, shared memory {r['dynamic_smem']} B dynamic + "
              f"{r['static_smem']} B static")

    lap("build")
    bench = Bench(ops, ref, deconv_ops, deconv_ref)
    rows = []
    print("-- kernels vs plain versions, main-path shape classes (ms on the card, CUDA events)")
    for name, a_, kw in shape_classes(torch, dev):
        a, bias = bench.args(name, *a_, **kw)
        r = bench.run(name, a, bias)
        rows.append({"phase": "classes", "kernel": name, "shape": describe(name, a, bias), **r})
        print(
            f"{name:13s} {describe(name, a, bias):50s} max_err={r['max_abs_err']:.2e} kernel_ms={r['ms']:.4f} "
            f"(host {r['host_ms']:.4f}) plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} "
            f"({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'})"
        )
        if name == "deconv_block":
            print(f"{'':13s} {achieved(r)}")

    lap("shape classes")
    print(f"-- every kernel call of one Pix2Pix + one YOLOv8 frame (img {IMG}, base {BASE})")
    calls = capture_main_path_calls(torch, ops, build_server, dev)
    per_frame = {
        key: {n: sum(1 for c in cs if c[0] == n) for n in REPLACES} for key, cs in calls.items()
    }
    print("launches per frame:", json.dumps(per_frame))
    depth = int(math.log2(IMG))  # Pix2Pix down blocks (and up blocks + final)
    if per_frame != {
        "pix": {"conv_block": depth, "deconv_block": depth, "sppf_pyramid": 0},
        "yolo": {"conv_block": 63, "deconv_block": 0, "sppf_pyramid": 1},
    }:
        raise AssertionError(f"unexpected per-frame kernel calls {per_frame}")
    frames = {"pix": 8, "yolo": 4}  # the served run below: 2x4 Pix2Pix, 1x4 YOLOv8 frames
    fields = ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    totals = {n: dict.fromkeys(fields + ("max_abs_err",), 0.0) for n in REPLACES}
    pair = {n: dict.fromkeys(fields, 0.0) for n in REPLACES}
    for key, cs in calls.items():
        groups = distinct_calls(bench, cs)
        for (name, desc, _), (a, bias, count) in groups.items():
            r = bench.run(name, a, bias)
            rows.append({"phase": key, "kernel": name, "shape": desc, "count": count, **r})
            if name != "sppf_pyramid":
                print(f"{name:13s} {desc:45s} x{count}: kernel {r['ms']:.4f} ms ({achieved(r)}), library "
                      f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}, max_err {r['max_abs_err']:.2e}")
            for f in fields:
                totals[name][f] += r[f] * count * frames[key]
                pair[name][f] += r[f] * count
            totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"], r["max_abs_err"])
        print(f"{key}: {len(cs)} calls in {len(groups)} distinct shapes, all within tolerance")
    for n in REPLACES:
        print(
            f"{n:13s} per frame pair: kernel {pair[n]['ms']:.4f} ms on the card (host-issued "
            f"{pair[n]['host_ms']:.4f}), plain {pair[n]['plain_ms']:.4f}, library "
            f"{pair[n]['library_ms']:.4f}, bound {pair[n]['bound_ms']:.5f}"
        )
    for n in ("conv_block", "deconv_block"):
        blk = pair[n]
        print(f"{'':13s} {n}: {blk['ops_ms'] * FP32_ACCURATE_FLOPS / blk['ms'] / 1e12:.2f} TFLOP/s, "
              f"{100 * blk['bound_ms'] / blk['ms']:.2f}% of the bound | {smi}")

    lap("kernel calls of one frame pair")
    want, launches, rep, served_rows = served_main_path(torch, smi, dev, ops, frames, per_frame, clock)

    # after the served run: the profiler's tracing must not tax its launches
    split_rows, split_totals = block_split(torch, ops, bench, calls, frames)
    for name, desc, count, sp in split_rows:
        print(f"{name:13s} {desc:45s} x{count} device ms by pass (torch.profiler): "
              + (", ".join(f"{k} {v:.4f}" for k, v in sp.items()) or "not measured (no kernel recorded)"))
    for name, tot in split_totals.items():
        print(f"{name:13s} over the served run, device ms by pass: "
              + (", ".join(f"{k} {v:.3f}" for k, v in tot.items()) or "not measured") + f" | {smi}")
    del calls

    lap("served run and pass splits")
    print(f"-- main path in bf16: one frame each through Pix2Pix and YOLOv8n (img {IMG}, base {BASE}, "
          "act_dtype bfloat16) on the fused kernels, against the plain ops")
    bf16_launches, bf16_checks, bf16_calls = bf16_forward_phase(torch, ops, dev)
    want16 = {"pix": {"conv_block": depth, "deconv_block": depth, "sppf_pyramid": 0},
              "yolo": {"conv_block": 63, "deconv_block": 0, "sppf_pyramid": 1}}
    print("launches:", json.dumps(bf16_launches))
    if bf16_launches != want16:
        raise AssertionError(f"bf16 forward launched {bf16_launches}, want {want16}")
    for name, c in bf16_checks.items():
        print(f"  {name:8s} bf16 kernels vs bf16 plain ops {c['rel']:.3e} (<= {c['tol']:.3e}); vs the f32 plain "
              f"ops: bf16 plain {c['plain_bf16_vs_f32']:.3e}, bf16 kernels {c['kernel_vs_f32']:.3e}")
        if not c["rel"] <= c["tol"]:
            raise AssertionError(f"bf16 forward {name}: kernels vs plain ops beyond tolerance {c}")
    # each distinct call of that forward on its own, at the bf16 pin (Bench.run)
    for key, cs in bf16_calls.items():
        groups = distinct_calls(bench, cs)
        for (name, desc, _), (a, bias, count) in groups.items():
            r = bench.run(name, a, bias)
            rows.append({"phase": f"{key} bf16", "kernel": name, "shape": desc, "count": count, **r})
            print(f"{name:13s} {desc:50s} x{count}: max_err {r['max_abs_err']:.2e} (<= 5e-2), kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}")
        print(f"{key} bf16: {len(cs)} calls in {len(groups)} distinct shapes, all within 5e-2")
    del bf16_calls

    lap("bf16 forward")
    print(f"-- the launcher: repro_torch.launch.serve.main in this process (img {IMG}, base {BASE})")
    launcher_rows = launcher_phase(torch, smi, dev, ops, want)
    lap("launcher")
    print(f"-- the fleets: replicas and worker processes (img {IMG}, base {BASE}, impl pallas, CUDA graphs)")
    fleet_rows = fleet_phase(torch, smi, dev, ops, want)
    lap("fleets")

    print("-- deconv2d vs its plain version, shape classes (ms on the card, CUDA events)")
    class_err = {}
    for name, a_, kw in deconv_classes(torch, dev):
        a, bias = bench.args(name, *a_, **kw)
        r = bench.run(name, a, bias)
        dt = str(a["x"].dtype)[6:]
        class_err[dt] = max(class_err.get(dt, 0.0), r["max_abs_err"])
        rows.append({"phase": "deconv2d classes", "kernel": name, "shape": describe(name, a, bias), **r})
        print(
            f"{name:9s} {describe(name, a, bias):34s} max_err={r['max_abs_err']:.2e} kernel_ms={r['ms']:.4f} "
            f"(host {r['host_ms']:.4f}) plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'})"
        )
        print(f"{'':9s} {achieved(r)}")
    for dt, e in class_err.items():
        print(f"deconv2d classes, {dt}: max abs err {e:.3e} (pin {1e-4 if dt == 'float32' else 5e-2:g})")

    lap("deconv2d classes")
    print(f"-- training at full width (img {IMG}, base {BASE}), TF32 off")
    cfg, trained, train_rows = train_phase(torch, smi, dev)

    lap("training")
    print("-- main path: surgery + evaluation through the deconv2d kernel")
    deconv_launches, deconv_calls, eval_metrics = eval_phase(torch, deconv_ops, cfg, trained, dev)
    deconv_tot = dict.fromkeys(fields, 0.0)
    deconv_err = 0.0  # the f32 main-path calls alone: the classes report theirs by dtype
    for name, a_, kw in deconv_calls:
        a, bias = bench.args(name, *a_, **kw)
        r = bench.run(name, a, bias)
        deconv_err = max(deconv_err, r["max_abs_err"])
        rows.append({"phase": "eval", "kernel": name, "shape": describe(name, a, bias), **r})
        print(f"deconv2d {describe(name, a, bias):34s} kernel {r['ms']:.4f} ms ({achieved(r)}), library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}, max_err {r['max_abs_err']:.2e}")
        for f in fields:
            deconv_tot[f] += r[f]
    print(
        f"deconv2d per generator forward (8 calls, batch 8): kernel {deconv_tot['ms']:.4f} ms on the card "
        f"(host-issued {deconv_tot['host_ms']:.4f}; "
        f"{deconv_tot['ops_ms'] * FP32_ACCURATE_FLOPS / deconv_tot['ms'] / 1e12:.2f} TFLOP/s, "
        f"{100 * deconv_tot['bound_ms'] / deconv_tot['ms']:.2f}% of the bound), plain {deconv_tot['plain_ms']:.4f}, "
        f"library {deconv_tot['library_ms']:.4f}, bound {deconv_tot['bound_ms']:.5f}, max_err {deconv_err:.2e} | {smi}"
    )

    lap("surgery and evaluation")
    print("-- LM kernels vs plain versions, shape classes (ms on the card, CUDA events)")
    lm_bench = LMBench(attn_ops, attn_ref, ssd_ops, ssd_ref)
    ssd_split = {}

    def split_ssd(a, what, count=1):
        sp = device_split(torch, lambda: ssd_ops.ssd(**a), reps=3, passes=SSD_PASSES)
        ssd_split[what] = {k: v * count for k, v in sp.items()}
        print(f"{'':15s} ssd device ms by pass{f' x{count}' if count > 1 else ''} (torch.profiler): "
              + (", ".join(f"{k} {v * count:.4f}" for k, v in sp.items()) or "not measured (no kernel recorded)"))

    for name, a_, kw in lm_classes(torch, dev):
        a = lm_bench.args(name, *a_, **kw)
        r = lm_bench.run(name, a)
        rows.append({"phase": "lm classes", "kernel": name, "shape": describe_lm(name, a), **r})
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(
            f"{name:15s} {describe_lm(name, a):52s} max_err={r['max_abs_err']:.2e} kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib} bound_ms={r['bound_ms']:.5f} "
            f"({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'})"
        )
        if name == "flash_attention":
            print(f"{'':15s} {achieved(r)}")
        else:
            split_ssd(a, f"class {describe_lm(name, a)}")
        if "bf16_plain_vs_f32" in r:
            print(f"{'':15s} bf16 vs f32 plain on the same inputs: kernel {r['max_abs_err']:.3e}, plain bf16 "
                  f"(control) {r['bf16_plain_vs_f32']:.3e}; kernel vs plain bf16 {r['err_vs_same_dtype_ref']:.3e}; "
                  f"|out| max {r['out_absmax']:.3e}, rms {r['out_rms']:.3e}")

    lap("LM shape classes")
    print(f"-- main path: Hymba-1.5B prefill at full width ({PREFILL_B} x {PREFILL_S} tokens), TF32 off")
    hcfg, hparams, lm_launches, lm_calls, prefill_rows = hymba_prefill_phase(
        torch, smi, dev, lm_bench, attn_ops, attn_ref, ssd_ops, ssd_ref
    )
    # each dtype's prefill calls on their own, by shape; the kernels line takes the bf16 prefill's
    lm_tot, lm_lib_none = {}, set()
    for key in ("float32", "bfloat16"):
        tot_k = lm_tot[key] = {n: dict.fromkeys(fields + ("max_abs_err",), 0.0) for n in LM_KERNELS}
        dt = "f32" if key == "float32" else "bf16"
        for name, a, count in lm_calls[key]:
            r = lm_bench.run(name, a)
            rows.append({"phase": f"prefill {dt}", "kernel": name, "shape": describe_lm(name, a), "count": count, **r})
            if r["library_ms"] is None:
                lm_lib_none.add(name)
            for f in fields:
                tot_k[name][f] += (r[f] or 0.0) * count
            tot_k[name]["max_abs_err"] = max(tot_k[name]["max_abs_err"], r["max_abs_err"])
            ctl = (f" (plain bf16 {r['bf16_plain_vs_f32']:.2e}, |out| rms {r['out_rms']:.2e})"
                   if "bf16_plain_vs_f32" in r else "")
            rate = f" ({achieved(r)})" if name == "flash_attention" else ""
            print(f"{name:15s} {describe_lm(name, a):52s} x{count}: kernel {r['ms']:.4f} ms{rate}, plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f}, max_err vs f32 {r['max_abs_err']:.2e}{ctl}")
            if name == "ssd":
                split_ssd(a, f"prefill {dt}", count)
        peak = BF16_FLOPS if key == "bfloat16" else FP32_ACCURATE_FLOPS
        for n, tot in tot_k.items():
            lib = "none" if n in lm_lib_none else f"{tot['library_ms']:.4f}"
            rate = (f" ({tot['ops_ms'] * peak / tot['ms'] / 1e12:.2f} TFLOP/s, "
                    f"{100 * tot['bound_ms'] / tot['ms']:.2f}% of the bound)") if n == "flash_attention" else ""
            print(f"{n:15s} per {dt} prefill ({lm_launches[n]} calls): kernel {tot['ms']:.4f} ms on the card{rate}, "
                  f"plain {tot['plain_ms']:.4f}, library {lib}, bound {tot['bound_ms']:.5f} | {smi}")
    del lm_calls

    lap("Hymba prefill")
    print("-- Hymba-1.5B decode at full width (f32 activations and caches; the decode A/B in bf16)")
    decode_row = hymba_decode_phase(torch, smi, dev, hcfg, hparams)
    del hparams
    torch.cuda.empty_cache()
    lap("Hymba decode")
    print("-- the LM/SSM zoo at full width: gemma2-2b, mamba2-2.7b and whisper-small at full depth, the other six "
          "configs at reduced depth (TF32 off)")
    t_zoo = time.perf_counter()
    zoo_rows = lm_zoo_phase(torch, smi, dev, lm_bench, attn_ops, attn_ref, ssd_ops, ssd_ref)
    print(f"LM zoo phase: {time.perf_counter() - t_zoo:.1f} s")
    lap("LM zoo")
    print("-- LM training: gemma2-2b at full width and depth through launch.train, step 1 vs the CPU, hymba, mamba2 "
          "and whisper steps, the loop's fault path (TF32 off)")
    train_lm_rows = lm_train_phase(torch, smi, dev, attn_ops, ssd_ops)
    lap("LM training")
    print("-- the distributed stack on one rank: TCP init through the launcher's flags, the production meshes' "
          "refusal, compressed gradients vs the CPU, a checkpoint resumed on the mesh")
    dist_rows = dist_phase(torch, smi, dev)
    lap("distributed")
    print("-- the dry run: production-mesh cells on meta tensors over a fake process group, in a spawned process")
    dryrun_rows = dryrun_phase(smi)
    lap("dry run")

    kernels = []
    for n in REPLACES:
        tot = totals[n]
        kernels.append({
            "name": n, "route": "cuda", "source": SOURCE, "replaces": REPLACES[n],
            "launches": launches[n], "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"],
        })
    kernels.append({
        "name": "deconv2d", "route": "cuda", "source": DECONV_SOURCE, "replaces": DECONV_REPLACES,
        "launches": deconv_launches, "max_abs_err": deconv_err, "ms": deconv_tot["ms"],
        "plain_ms": deconv_tot["plain_ms"], "bound_ms": deconv_tot["bound_ms"],
        "bound_by": "operations" if deconv_tot["ops_ms"] > deconv_tot["bytes_ms"] else "bytes",
        "library_ms": deconv_tot["library_ms"],
    })
    for n, (source, replaces) in LM_KERNELS.items():
        tot = lm_tot["bfloat16"][n]
        kernels.append({
            "name": n, "route": "cuda", "source": source, "replaces": replaces,
            "launches": lm_launches[n], "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes",
            "library_ms": None if n in lm_lib_none else tot["library_ms"],
        })
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "rows": rows, "kernels": kernels, "report": rep, "per_frame_pair": pair,
             "train": train_rows, "eval": eval_metrics, "deconv2d_per_forward": deconv_tot,
             "deconv2d_class_max_abs_err": class_err, "block_split": {"rows": split_rows, "totals": split_totals},
             "phase_ptxas": phase_tc, "ssd_ptxas": ssd_tc, "ssd_split": ssd_split,
             "bf16_forward": {"launches": bf16_launches, "checks": bf16_checks},
             "hymba_prefill": prefill_rows, "lm_per_prefill": lm_tot, "hymba_decode": decode_row,
             "flash_ptxas": flash_tc, "launcher": launcher_rows, "served_ab": served_rows,
             "fleets": fleet_rows, "lm_zoo": zoo_rows, "lm_train": train_lm_rows, "dist": dist_rows,
             "dryrun": dryrun_rows,
             "seconds": time.perf_counter() - t_start}, indent=1, default=str))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
