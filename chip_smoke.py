"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines and raising on failure (the script then
exits non-zero and prints no final line), run in the order 1, 2, 3, 4, 3b,
5, 3c, 6, 7, 8, 9 (3b takes its shapes from the CMDA model that phase 5
serves, 3c from the one that phase 7 trains):

1. device   — a CUDA card is required; prints its name and power limit and
              turns TF32 off so that float32 checks are float32.
2. build    — compiles the port's CUDA kernels from csrc/ (one nvcc each, in
              parallel) and prints the build seconds and ptxas's registers
              and spills per kernel instantiation; counts the tensor-core
              instructions (HMMA, HGMMA) in the SASS of the three
              libraries' bf16 kernels, raising if any has none (K2-bwd's
              one-pass kernel must have HGMMA, wgmma, in each of its four
              instantiations, one per padded width), and the FP32-pipe and F2FP instructions per
              MUFU.EX2 in the main loop of the flash-attention bf16 kernels,
              forward and backward.
3. kernels  — every stride-1 bottleneck shape of SlowFast-R50 8x8 serving
              (the K1 shape table) and four off-path shapes (slow s5 and
              fast s2 at the 224 crop, a projection with channel counts
              that are not multiples of 8, a height that the strip does not
              divide) through the fused kernel against its plain version,
              in float32 and bfloat16, at 1 clip and at the request batch,
              and the path's shapes in bfloat16 also at the 30-view test
              batch of phase 8 (64 clips, printing each one's split);
              at the request batch it also times the kernel, the plain
              version and the same block unfused through the port's
              nn.Module (cuDNN), beside the block's bound on an H100, and
              prints the bf16 kernel's split of the work.
3b. attention — the flash-attention kernel against its plain version at
              the four CMDA-R50 shapes (one per lateral fusion) and five
              off-path shapes (ragged keys; pooled non-local keys; three on
              the bf16 kernel's tile edges), in float32 and bfloat16, at 1
              clip and at the request batch, and the path's shapes in
              bfloat16 also at phase 8's 64-clip batch; at the request batch it also
              times the kernel, the plain version and
              scaled_dot_product_attention, beside the shape's bound, and
              prints the kernel's ratio to each.
4. serving  — SlowFast-R50 8x8 at full width (400 classes, 32 frames,
              256² test crop, bf16, TPU.FUSED_EVAL) on seeded random weights
              made in the JAX package's layout and carried across by the
              port's weight bridge; answers three requests through
              make_forward, checks 26 kernel launches per request and the
              scores, and holds them against the module's own forward,
              printing the fused engine's request time less K1's kernel
              time (phase 3); then the same at float32 on one clip, at a
              tight tolerance.
5. cmda     — SlowFastDualAttention-R50 8x8 (the CMDA model) at full width,
              the same way, with the attention's query and key convs
              scaled on a seeded clip so that its logits are of a trained
              model's order: three requests through make_forward, 4 attention
              launches per request and none of the fused bottleneck, held
              against the same model under TPU.FLASH_ATTENTION False (the
              plain version on the card); then float32 on one clip.
3c. attention backward — the flash-attention backward kernels against
              their plain version (attention_backward), and K2's output
              with its log-sum-exp store on against it off (bit for bit),
              at the four CMDA-R50 fusion shapes of the 224² training crop
              and three off-path shapes (ragged keys, ragged tiles, D = C =
              24), in float32 and bfloat16, at 1 clip and at the training
              batch, and at the
              smallest path shape and 1 clip also against autograd through
              chunked_attention (the JAX package's backward written out); a
              second call on the same inputs must give bit-identical dK and
              dV (and dQ in float32; bf16 dQ, summed by atomic adds, within
              the tolerance); at the training batch it prints the bf16
              kernel's split (keys a block, queries a tile, ring stages,
              blocks and blocks an SM, shared memory) and times the
              kernels, the plain
              version and the backward of scaled_dot_product_attention,
              beside the shape's bound and PR 5's two-pass kernel's times.
6. train    — SlowFast-R50 8x8 at full width trained as
              configs/Kinetics/SLOWFAST_8x8_R50.yaml trains (224² crop,
              bf16, 8 clips a card, SGD lr 0.1 with nesterov momentum 0.9,
              weight decay 1e-4, dropout 0.5, final BNs zero-initialised):
              2 warm-up and 5 timed steps through create_train_state and
              make_train_step, no kernel launched, every loss finite, BN
              running statistics moved; then one timed step (after one
              warm-up) with TPU.REMAT and TPU.REMAT_STAGES [2].
7. cmda_train — CMDA-R50 8x8 the same way, attention calibrated as in
              phase 5: 4 forward and 4 backward calls of the attention
              kernels a step and no fused bottleneck; then one step on one
              clip in float32 and one in bfloat16, each held against the
              same step under TPU.FLASH_ATTENTION False (plain forward,
              backward by autograd through it, on the card).

8. thirty_view — the 30-view test of configs/Kinetics/SLOWFAST_8x8_R50.yaml
              (TPU.FUSED_EVAL, K1) and then of
              SLOWFAST_DUALATTENTION_8x8_R50.yaml (K2, attention calibrated
              as in phase 5), bf16, on the synthetic test split (8 videos x
              10 x 3 views = 240 clips in 4 batches of the yaml's 64, the
              last 48 real and 16 padded) through the loader (8 threads),
              the pinned host→GPU copy, the preprocess and the forward
              (perform_test): one untimed batch, the forward alone on a
              resident batch, then the timed test. Gates: 26 K1 launches a
              batch on SlowFast and none on CMDA, 4 K2 launches a batch on
              CMDA and none on SlowFast; K1 plans no shape (each was
              planned, and held against the plain version, at 64 clips in
              phase 3); every clip's probabilities finite and summing to 1
              within TEST_ROW_TOL; the TestMeter complete; the first
              batch's pathways on the card within PRE_TOL of the CPU
              preprocess in float32; per video, the centred log mean
              probabilities within TEST_LOGIT_TOL of their scale of those
              of test() from a .pyth of the same weights without the
              kernels (SlowFast: TPU.FUSED_EVAL False, the module forward;
              CMDA: TPU.FLASH_ATTENTION False, the plain attention). Prints
              end-to-end clips/s, the forward alone, each batch's wait on
              the loader and its copy, preprocess and forward times, and
              peak memory.
9. epochs   — CMDA-R50 as phase 7 trains it (8 clips a step, 224² crops
              from the 320-short-side canvas, jitter [256, 320], bf16,
              dropout 0.5, attention calibrated): train_epoch over the
              synthetic train split (64 videos, 8 steps) and eval_epoch over
              the val split (64 clips, 8 batches) through the loaders, once
              untimed (epoch 0: the loaders' first buffers and pinned
              canvases, the eval shapes' cuDNN plans) and once timed (epoch
              1). Gates: 4 K2 launches a train step and a val batch, 12
              K2-bwd launches a train step, no K1 (epoch 1); finite losses;
              BN running statistics moved; each step's lr get_lr_at_epoch's
              at its fractional epoch; val errors in [0, 100]. Prints train
              clips/s through the loader beside phase 7's steps alone, val
              clips/s, both epochs, and peak memory.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; the kernels' JSON line sums the launches of phases
4, 5, 7, 8 and 9. The last three lines are the kernels' JSON record, the
card's name and power limit, and the device JSON line.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
REQUESTS = 3
CLIPS_PER_REQUEST = 4
# the 30-view test batch: TEST.BATCH_SIZE of the Kinetics yamls (phase 8)
TEST_CLIPS = 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# float32: the kernel and the plain version differ only in summation order
# (K up to 3·2048); 1e-4 of the output's scale is ~100x that rounding.
F32_TOL = 1e-4
# bfloat16: the kernel rounds a and b to bf16 after their ReLU and c and the
# projection before the add, as the TPU kernel does; the plain version keeps
# float32 until the output. One bf16 rounding is 2^-9 = 0.2% relative; 2% of
# the output's scale allows for the few roundings that reach the output.
BF16_TOL = 2e-2
# serving, bf16: the fused engine folds BN into bf16 weights where the module
# runs conv and BN separately in bf16, so logits differ at bf16 rounding
# (~1%); class probabilities of the two paths then agree to within 2e-2.
SERVE_BF16_ATOL = 2e-2
# serving, float32, one clip: both paths are float32 throughout; folding BN
# and the kernel's summation order move the probabilities by far less.
SERVE_F32_ATOL = 1e-4
# attention, float32: the kernel and the plain version differ only in
# summation order (up to 128-term dot products, 32768-key softmax sums) and
# exp2 against exp, both within a few f32 ulps; 1e-4 of the output's scale.
ATTN_F32_TOL = 1e-4
# attention, bfloat16: both sides take float32 logits of the same bf16 q
# and k (exact products, sums in another order) and run the softmax in
# float32, but the kernel rounds each probability p_j to bf16 once before
# its tensor-core product with v, where the plain version keeps float32.
# The output is sum_j w_j v_j with w_j = p_j / sum_i p_i; the kernel takes
# the row sum from the unrounded probabilities, so each of its weights is
# w_j (1 + e_j) with |e_j| <= 2^-9, which moves the output by at most
# sum_j w_j |e_j| |v_j| <= 2^-9 max|v|. Each side then rounds its output to
# bf16 (half an ulp, at most 2^-8 of its magnitude), so the two differ by
# at most 2^-9 max|v| + 2^-7 of the output's scale: within 1e-2 of that
# scale while max|v| is within 1.1 times it, and in practice far inside,
# as the e_j have random signs and average out over the keys a row
# attends to. 1e-2 of the output's scale.
ATTN_BF16_TOL = 1e-2
# attention backward, float32: the kernels and the plain version compute the
# same sums in another order (up to 25088-term sums over keys or queries);
# 1e-4 of each gradient's scale.
ATTN_BWD_F32_TOL = 1e-4
# attention backward, bfloat16: both sides take float32 products of the same
# bf16 q, k, v and dO, the same float32 lse and D = rowsum(dO ∘ O) from the
# same bf16 O, and round each gradient to bf16 once (half an ulp: at most
# 2^-8 = 3.9e-3 of its magnitude). The kernel also rounds P and dS to bf16
# as the A operands of Pᵀ dO, dS k and dSᵀ q: each term of those sums is off
# by at most 2^-8 relative, and the errors have random signs, so a sum moves
# by about 2^-8 of its own magnitude, not of the sum of its terms' (the
# CPU emulator and the model in tests/test_torch_port_attention_backward.py
# put kernel against plain at 2-7e-3 of the scale). Held against autograd
# through chunked_attention, D is the unrounded O's: D moves by up to 2^-8
# Σ_c |dO_c O_c|, which enters dS as P δD; measured, it adds under 1.5e-3
# of the scale at D = C = 8-128. 2e-2 of each gradient's scale, five bf16
# roundings of room.
ATTN_BWD_BF16_TOL = 2e-2
# CMDA serving against its plain-attention path: bf16 attention outputs that
# differ by one ulp pass through the rest of the network in bf16, as K1's do
# (SERVE_BF16_ATOL); in float32 only the summation order differs. Both hold
# once the attention logits are calibrated (ATTN_LOGIT_STD).
CMDA_BF16_ATOL = 2e-2
CMDA_F32_ATOL = 1e-4
# The attention is unscaled (no 1/sqrt(D)). On random weights the standard
# deviation of its logits reaches the hundreds at s3_fuse and tens of
# thousands at s4_fuse, where the softmax is an argmax that one rounding
# upstream flips; a trained model's logits are of order 1-10. The
# query and key convs are scaled so that each fusion's logits have this
# standard deviation on a seeded clip.
ATTN_LOGIT_STD = 3.0
# H100 SXM exponentials: 16 per clock per SM (the special-function unit's
# throughput for compute capability 9.0, CUDA C programming guide), 132 SMs
# at the 1.98 GHz maximum boost clock (NVIDIA data sheet)
EXP_RATE = 16 * 132 * 1.98e9
# the shapes beside the CMDA path: (label, N, M, D, C); the last three sit
# on the bf16 kernel's tile edges (N not a multiple of its 64- or 128-row
# blocks, M not of its 64-key tiles, D and C not multiples of 16 or 8)
# K1's shapes beside the SlowFast path, with no launch on it: (label, t_len,
# h, cin, ci, cout, kt, proj)
K1_OFF_PATH = [("slow s5 224 crop", 8, 7, 2048, 512, 2048, 3, False),
               ("fast s2 224 crop", 32, 56, 32, 8, 32, 3, False),
               ("proj c 40/12/48", 8, 20, 40, 12, 48, 3, True),
               ("ragged strip h 13", 8, 13, 256, 64, 256, 1, False)]
# the shapes beside the CMDA training path for the attention backward
ATTN_BWD_OFF_PATH = [("ragged keys", 1296, 1300, 8, 16),
                     ("ragged tiles", 2085, 1057, 32, 32),
                     ("d 24 c 24", 700, 333, 24, 24)]
# K2-bwd's two-pass kernel (PR 5) at the training batch, ms a call, in the
# two smoke runs that PERF.md records (NVIDIA H100 80GB HBM3, 700 W)
ATTN_BWD_PR5_MS = {"s1_fuse": "6.3493 / 6.4194", "s2_fuse": "8.9250 / 8.8969",
                   "s3_fuse": "1.0781 / 1.0813", "s4_fuse": "0.2682 / 0.2689"}
# training: clips a card (the reference configs train TRAIN.BATCH_SIZE 64
# over 8 GPUs), warm-up and timed steps
TRAIN_CLIPS = 8
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# One CMDA train step on one clip with the attention kernels against the
# same step with the plain attention (FLASH_ATTENTION False).
# float32, per parameter tensor: |p_kernel - p_plain| over |p_plain -
# p_before| in L2, the step's difference over the step itself, where a
# tensor's step is below 1e-3 of the largest tensor's over that floor (the
# key conv's bias has a zero gradient in exact arithmetic, as a shift of
# every key by q·b cancels in the softmax, so its step is weight decay and
# rounding noise). The paths differ only in the attention's summation
# order (about 1e-6 relative: ATTN_F32_TOL, ATTN_BWD_F32_TOL), carried
# through the rest of the backward in float32; 1e-3.
CMDA_TRAIN_F32_TOL = 1e-3
# bfloat16: a tensor whose gradient is a sum that mostly cancels (a BN
# weight's over 25088 positions) takes a bf16 step that is mostly rounding
# noise, on either path, so tensor by tensor the two paths can differ by
# the step itself. What the kernels must not do is add error: over all
# parameters, the bf16 step with the kernels is held no farther from the
# float32 step (plain attention) than the bf16 step with the plain
# attention is, in L2, within twice: the kernels' own roundings (P once in
# the forward, P and dS once in the backward) are of the size of the plain
# path's (its output's and its gradients'), and two independent errors of
# one size make √2.
CMDA_TRAIN_BF16_RATIO = 2.0
# Running statistics: the step's new batch statistics enter with momentum
# 0.1; max |difference| within 1e-4 (f32) and 1e-2 (bf16) of max(1,
# max |statistic|).
CMDA_STATS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the 30-view test and the epochs: loader threads (the yamls' NUM_WORKERS)
LOADER_WORKERS = 8
# every clip's bf16 probabilities: a softmax in float32 rounded to bf16 per
# class (2^-9 relative each) sums to 1 within 400 · 2^-9 · max p, and in
# practice within a few 1e-3 as the roundings have random signs; 1e-2.
TEST_ROW_TOL = 1e-2
# the 30-view test with the kernels against the same weights without them
# (SlowFast: fused engine vs module forward; CMDA: K2 vs plain attention),
# per video: the log of the mean probability less its mean over the
# classes (for one clip, the logits less theirs). The two paths differ by
# bf16 roundings (BN folded into bf16 weights and K1's roundings of a, b, c;
# K2's one rounding of P), each of order 2^-8 of a layer's activations with
# random signs, so over the ~50 layers of an R50 of order √50 · 2^-8 ≈ 3% of
# the logits' spread (phase 4 sees 2.7% of the largest probability on one
# request). A wrong block or attention moves the logits by their own
# spread. 0.1 of the largest |centred log mean probability|: three times
# the rounding estimate, a tenth of a fault.
TEST_LOGIT_TOL = 0.1
# the preprocess on the card against the CPU, float32: the same ops in the
# same order on both (gathers, one lerp per axis, the normalization), so
# only fused multiply-adds may differ, an ulp of values within ±3; 1e-5.
PRE_TOL = 1e-5
ATTN_OFF_PATH = [("ragged keys", 1296, 1300, 8, 16),
                 ("pooled non-local", 3136, 784, 64, 64),
                 ("ragged tiles", 2085, 1057, 32, 32),
                 ("d 4 c 24", 200, 333, 4, 24),
                 ("c 100", 1500, 777, 64, 100)]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def kernel_counters():
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_backward)
    from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
        fused_bottleneck

    return {"fused_bottleneck": fused_bottleneck,
            "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def cuda_ms(fn, iters=10, reps=5):
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from efficient_slowfast_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    for name, out in reports.items():
        func = "?"
        for line in out.splitlines():
            entry = re.search(r"entry function '\w*?\d([a-z_]+kernel)I(\w+?)EE",
                              line)
            if entry:  # e.g. flash_attention_tc_kernel<32,32>
                args = re.findall(r"__nv_bfloat16|^f|(?<=L[ib])\d+",
                                  entry.group(2))
                func = entry.group(1) + "<" + ",".join(
                    {"__nv_bfloat16": "bf16", "f": "float"}.get(a, a)
                    for a in args) + ">"
            elif "registers" in line or "spill" in line or "error" in line:
                log("build", f"{name}: {func}: {line.split(':', 1)[-1].strip()}")
    log("build", f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    # cuobjdump ships beside nvcc in the CUDA toolkit
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass_counts(tool, _build.lib_path("flash_attention"))
    k1_sass_counts(tool, _build.lib_path("fused_bottleneck"))
    bwd_sass_counts(tool, _build.lib_path("flash_attention_bwd"))


SASS_OPS = ("HMMA", "HGMMA", "MUFU.EX2", "FFMA", "FADD", "FMUL", "FMNMX",
            "F2FP")


def sass_counts(tool, lib):
    """Count K2's tensor-core instructions in its SASS, raising if its bf16
    kernels have none; and, in the main loop of each D = C instantiation
    (the loop whose body holds the most MUFU.EX2: 32 logits and 2
    rescales per tile and warp lane), the FP32-pipe instructions per
    MUFU.EX2."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    total = dict.fromkeys(("HMMA", "HGMMA"), 0)
    for func in sass.split("Function : ")[1:]:
        shape = re.search(r"flash_attention_tc_kernelILi(\d+)ELi(\d+)E",
                          func.split("\n", 1)[0])
        if not shape:
            continue
        # (address, opcode and its first modifier, operands): "HMMA.16816"
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
            r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)?)([^;]*);", func)]
        count = lambda ops: {op: sum(o == op or o.startswith(op + ".")
                                     for o in ops) for op in SASS_OPS}
        n = count([o for _, o, _ in ins])
        total["HMMA"] += n["HMMA"]
        total["HGMMA"] += n["HGMMA"]
        dp, cp = int(shape.group(1)), int(shape.group(2))
        if dp != cp:
            continue
        loops = [(int(t.group(1), 16), a) for a, o, rest in ins
                 if o.split(".")[0] == "BRA"
                 and (t := re.search(r"0x([0-9a-f]+)", rest))
                 and int(t.group(1), 16) < a]
        ex2_in = lambda span: sum(span[0] <= a <= span[1] and o == "MUFU.EX2"
                                  for a, o, _ in ins)
        lo, hi = max(loops, key=ex2_in, default=(0, ins[-1][0]))
        body = count([o for a, o, _ in ins if lo <= a <= hi])
        fp32 = sum(body[op] for op in ("FFMA", "FADD", "FMUL", "FMNMX",
                                       "F2FP"))
        log("build", f"flash_attention bf16 DP {dp} CP {cp} main loop: "
            + ", ".join(f"{op} {body[op]}" for op in SASS_OPS)
            + f"; FP32-pipe per MUFU.EX2 {fp32 / max(body['MUFU.EX2'], 1):.2f}")
    log("build", f"flash_attention bf16 kernels: HMMA {total['HMMA']}, "
        f"HGMMA {total['HGMMA']} in the SASS")
    if not total["HMMA"] + total["HGMMA"]:
        raise AssertionError("K2's bf16 kernels use no tensor-core "
                             "instruction (no HMMA or HGMMA in the SASS)")


def k1_sass_counts(tool, lib):
    """Count the tensor-core instructions of K1's bf16 kernels (one per
    kt, projection and warp tile), raising if any has none."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = 0
    for func in sass.split("Function : ")[1:]:
        name = re.search(r"fused_bottleneck_tc_kernelILi(\d)ELb(\d)ELi(\d)E",
                         func.split("\n", 1)[0])
        if not name:
            continue
        found += 1
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         func)
        hmma, hgmma = ops.count("HMMA"), ops.count("HGMMA")
        log("build", f"fused_bottleneck bf16 kt {name.group(1)} proj "
            f"{name.group(2)} m16 tiles {name.group(3)}: HMMA {hmma}, HGMMA "
            f"{hgmma} in the SASS")
        if not hmma + hgmma:
            raise AssertionError("K1's bf16 kernel uses no tensor-core "
                                 "instruction (no HMMA or HGMMA in the SASS)")
    if found != 8:
        raise AssertionError(f"{found} K1 bf16 kernels in the SASS, "
                             "expected 8")


def bwd_sass_counts(tool, lib):
    """Count the tensor-core instructions of K2-bwd's bf16 one-pass kernel
    (one instantiation per padded width, with its consumer warpgroups and
    blocks an SM), raising if any has no HGMMA (wgmma), and print the
    FP32-pipe and F2FP
    instructions per MUFU.EX2 of its main loop (the loop whose body holds
    the most MUFU.EX2: 32 per tile and thread)."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = 0
    for func in sass.split("Function : ")[1:]:
        name = re.search(
            r"attention_bwd_wgmma_kernelILi(\d+)ELi(\d)ELi(\d)E",
            func.split("\n", 1)[0])
        if not name:
            continue
        found += 1
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
            r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)?)([^;]*);", func)]
        count = lambda ops: {op: sum(o == op or o.startswith(op + ".")
                                     for o in ops) for op in SASS_OPS}
        n = count([o for _, o, _ in ins])
        loops = [(int(t.group(1), 16), a) for a, o, rest in ins
                 if o.split(".")[0] == "BRA"
                 and (t := re.search(r"0x([0-9a-f]+)", rest))
                 and int(t.group(1), 16) < a]
        ex2_in = lambda span: sum(span[0] <= a <= span[1] and o == "MUFU.EX2"
                                  for a, o, _ in ins)
        lo, hi = max(loops, key=ex2_in, default=(0, ins[-1][0]))
        body = count([o for a, o, _ in ins if lo <= a <= hi])
        fp32 = sum(body[op] for op in ("FFMA", "FADD", "FMUL", "FMNMX",
                                       "F2FP"))
        ex2 = max(body["MUFU.EX2"], 1)
        log("build", f"flash_attention_backward bf16 WP {name.group(1)} "
            f"consumer warpgroups {name.group(2)}, {name.group(3)} blocks an "
            f"SM: HMMA {n['HMMA']}, HGMMA "
            f"{n['HGMMA']}, MUFU.EX2 {n['MUFU.EX2']}, F2FP {n['F2FP']} in "
            f"the SASS; main loop " + ", ".join(
                f"{op} {body[op]}" for op in SASS_OPS) +
            f"; FP32-pipe per MUFU.EX2 {fp32 / ex2:.2f}, F2FP per MUFU.EX2 "
            f"{body['F2FP'] / ex2:.2f}")
        if not n["HGMMA"]:
            raise AssertionError("K2-bwd's bf16 kernel uses no wgmma (no "
                                 "HGMMA in the SASS)")
    if found != 4:
        raise AssertionError(f"{found} K2-bwd bf16 kernels in the SASS, "
                             "expected 4")


# ---------------------------------------------------------------------------
def serving_cfg(dtype="bfloat16"):
    """SlowFast-R50 8x8 serving at the 30-view test shape (bench.py:121-149)."""
    from efficient_slowfast_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "SlowFast"
    cfg.MODEL.ARCH = "slowfast"
    cfg.RESNET.DEPTH = 50
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3, 3], [4, 4], [6, 6], [3, 3]]
    cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 4
    cfg.NONLOCAL.LOCATION = [[[], []]] * 4
    cfg.NONLOCAL.GROUP = [[1, 1]] * 4
    cfg.NONLOCAL.POOL = [[[1, 2, 2], [1, 2, 2]]] * 4
    cfg.SLOWFAST.ALPHA = 4
    cfg.SLOWFAST.BETA_INV = 8
    cfg.SLOWFAST.FUSION_KERNEL_SZ = 7
    cfg.MODEL.NUM_CLASSES = 400
    cfg.DATA.NUM_FRAMES = 32
    cfg.DATA.CROP_SIZE = 224
    cfg.DATA.TEST_CROP_SIZE = 256
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.FUSED_EVAL = True
    return cfg


def kernel_rows(cfg, model):
    """The stride-1 blocks of the serving forward, grouped by shape:
    [(label, t_len, h, cin, ci, cout, kt, proj, launches per request)]."""
    from efficient_slowfast_tpu_torch.engine.inference import STAGES

    blocks = []  # (pathway, stage, block index, shape key)
    strides = [s[0] for s in cfg.RESNET.SPATIAL_STRIDES]
    t_len = [cfg.DATA.NUM_FRAMES // cfg.SLOWFAST.ALPHA, cfg.DATA.NUM_FRAMES]
    for pw, name in enumerate(("slow", "fast")):
        h = cfg.DATA.TEST_CROP_SIZE // 4  # after the stem's two stride-2 ops
        for si, stage in enumerate(STAGES):
            h //= strides[si]
            i = 0
            while hasattr(getattr(model, stage), f"pathway{pw}_res{i}"):
                blk = getattr(getattr(model, stage), f"pathway{pw}_res{i}")
                br = blk.branch2
                if i > 0 or strides[si] == 1:  # strided block 0s are cuDNN's
                    blocks.append((name, stage, i, (
                        t_len[pw], h, br.a.in_channels, br.a.out_channels,
                        br.c.out_channels, br.a.kernel_size[0],
                        hasattr(blk, "branch1"))))
                i += 1
    rows = []
    for (name, stage, key), grp in itertools.groupby(
            blocks, key=lambda b: (b[0], b[1], b[3])):
        idx = [b[2] for b in grp]
        span = f"res{idx[0]}" + (f"-{idx[-1]}" if len(idx) > 1 else "")
        rows.append((f"{name} {stage} {span}",) + key + (len(idx),))
    return rows


def make_block(t_len, h, cin, ci, cout, kt, proj, clips, dtype, gen,
               card_gen=None):
    """Seeded inputs of one block: x and BN-folded weights (kernel layout).
    x is drawn on the card from ``card_gen`` where given (the test batch's
    activations run to gigabytes)."""
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen)
    x = (rn(clips * t_len, h, h, cin) if card_gen is None else torch.randn(
        clips * t_len, h, h, cin, generator=card_gen, device=dev)).to(dev, dtype)
    w = dict(wa=rn(kt, cin, ci) / (kt * cin) ** 0.5, ba=0.1 * rn(ci),
             wb=rn(3, 3, ci, ci) / (9 * ci) ** 0.5, bb=0.1 * rn(ci),
             wc=rn(ci, cout) / ci ** 0.5, bc=0.1 * rn(cout),
             wp=rn(cin, cout) / cin ** 0.5 if proj else None,
             bp=0.1 * rn(cout) if proj else None)
    w = {k: (None if v is None else
             v.to(dev, dtype if k.startswith("w") else torch.float32))
         for k, v in w.items()}
    return x, w


def block_cost(n, h, cin, ci, cout, kt, proj, elem):
    """(FLOPs, bytes) of one block: each input read once, out written once."""
    px = n * h * h
    wts = kt * cin * ci + 9 * ci * ci + ci * cout + (cin * cout if proj else 0)
    flops = 2 * px * wts
    nbytes = (px * (cin + cout) + wts) * elem + 4 * (2 * ci + cout * (2 if proj else 1))
    return flops, nbytes


def phase_kernels(cfg, model, smi):
    from efficient_slowfast_tpu_torch.models.resnet import ResBlock
    from efficient_slowfast_tpu_torch.ops.kernels import _build
    from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import (
        bottleneck_reference, fused_bottleneck, plan, smem_bytes)

    gen = torch.Generator().manual_seed(SEED)
    rows = kernel_rows(cfg, model)
    per_request = sum(r[8] for r in rows)
    if per_request != 26:
        raise AssertionError(f"{per_request} stride-1 blocks, expected 26")
    lib = _build.load("fused_bottleneck")
    lib.fused_bottleneck_tc_smem_bytes.restype = ctypes.c_size_t
    lib.fused_bottleneck_tc_max_clusters.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t]
    for ci, smem in ((64, 232448), (8, 115712)):  # the plan's two budgets
        log("kernels", f"K1 bf16 blocks resident at once, Ci {ci}, {smem} B "
            "a block, by cluster size: " + ", ".join(
                f"{cl}: {cl * lib.fused_bottleneck_tc_max_clusters(ci, cl, smem)}"
                for cl in (1, 2, 4, 8)))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    record = []
    card_gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, t_len, h, cin, ci, cout, kt, proj, count in rows + [
            r + (0,) for r in K1_OFF_PATH]:
        # the path's shapes also at the 30-view test batch (phase 8), in
        # its dtype: the plan picks each of those shapes' splits anew
        cases = [(dtype, tol, clips) for dtype, tol in (
            (torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL))
            for clips in (1, CLIPS_PER_REQUEST)]
        if count:
            cases.append((torch.bfloat16, BF16_TOL, TEST_CLIPS))
        for dtype, tol, clips in cases:
            x, w = make_block(t_len, h, cin, ci, cout, kt, proj, clips,
                              dtype, gen, card_gen if clips == TEST_CLIPS
                              else None)
            args = (x, t_len, w["wa"], w["ba"], w["wb"], w["bb"], w["wc"],
                    w["bc"], w["wp"], w["bp"])
            out = fused_bottleneck(*args)
            torch.cuda.synchronize()
            ref = bottleneck_reference(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            finite = bool(torch.isfinite(out).all())
            log("kernels", f"{label:18s} {str(dtype)[6:]:8s} clips {clips}"
                f" max_abs_err {err:.3e} (scale {scale:.3g}, tol "
                f"{tol * scale:.3e})")
            if not finite or err > tol * scale:
                raise AssertionError(f"{label} {dtype} clips {clips}: "
                                     f"err {err} > {tol * scale}")
            if clips == TEST_CLIPS:
                sp = plan(x.shape[0], h, h, cin, ci, cout, kt, 2, proj)
                log("kernels", f"{label:18s} bf16     clips {clips} split: "
                    f"cluster {sp.cluster}, strip rows {sp.rows}, CTAs "
                    f"{sp.ctas}, output pixels per CTA {sp.pixels}, shared "
                    f"memory {sp.smem} B (ring {sp.ring} B)")
            if clips != 1 and count:
                worst[dtype] = max(worst[dtype], err)
            del x, w, args, out, ref
        # timing at the request batch, in the serving dtype
        dtype = torch.bfloat16
        x, w = make_block(t_len, h, cin, ci, cout, kt, proj, CLIPS_PER_REQUEST,
                          dtype, gen)
        split = plan(x.shape[0], h, h, cin, ci, cout, kt, 2, proj)
        smem = lib.fused_bottleneck_tc_smem_bytes(h, h, ci, split.rows,
                                                  split.ring // 2)
        if smem != split.smem or smem != smem_bytes(2, h, h, ci, split.rows,
                                                    split.ring):
            raise AssertionError(f"{label}: shared memory {split.smem} B in "
                                 f"the wrapper, {smem} B in the kernel")
        resident = lib.fused_bottleneck_tc_max_clusters(ci, split.cluster,
                                                        split.smem)
        if resident <= 0:
            raise AssertionError(f"{label}: no cluster of the split fits "
                                 f"(CUDA error {-resident})")
        resident *= split.cluster  # blocks
        args = (x, t_len, w["wa"], w["ba"], w["wb"], w["bb"], w["wc"], w["bc"],
                w["wp"], w["bp"])
        k_ms = cuda_ms(lambda: fused_bottleneck(*args))
        p_ms = cuda_ms(lambda: bottleneck_reference(*args), iters=3, reps=3)
        blk = ResBlock(cin, cout, kt, 1, dim_inner=ci, dtype=dtype).to(
            "cuda", memory_format=torch.channels_last_3d).eval()
        xb = x.view(CLIPS_PER_REQUEST, t_len, h, h, cin).permute(0, 4, 1, 2, 3)
        with torch.inference_mode():
            lib_ms = cuda_ms(lambda: blk(xb))
        flops, nbytes = block_cost(x.shape[0], h, cin, ci, cout, kt, proj, 2)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        log("kernels", f"{label:18s} bf16 x{count} per request | kernel "
            f"{k_ms:.4f} ms | plain {p_ms:.4f} ms | cuDNN unfused {lib_ms:.4f}"
            f" ms | kernel/bound {k_ms / bound:.2f}, kernel/cuDNN "
            f"{k_ms / lib_ms:.2f} | bound {bound:.5f} ms ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) | split: "
            f"cluster {split.cluster}, strip rows {split.rows}"
            f"{'' if h % split.rows == 0 else ' (ragged)'}, CTAs "
            f"{split.ctas} ({-(-split.ctas // resident)} wave(s) of "
            f"{resident} resident), output pixels per CTA {split.pixels}, "
            f"shared memory {split.smem} B (ring {split.ring} B) | {smi}")
        record.append(dict(label=label, count=count, ms=k_ms, plain_ms=p_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by,
                           flops=flops, bytes=nbytes))
    log("kernels", f"worst max_abs_err at the request and test batches: f32 "
        f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}")
    return record, worst[torch.bfloat16]


# ---------------------------------------------------------------------------
def jax_layout_weights(model, seed):
    """Seeded weights in the JAX package's variable layout (numpy): MSRA
    fan-out normal convs, normal(0.01) classifier, BN scale 1 and bias 0,
    with running statistics jittered as the repo's engine tests do; for
    CMDA, ECA's Conv1d normal(1/sqrt(fan-in)) and every attention γ 0.5
    (at its zero init the attention would never reach the output)."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables

    rs = np.random.RandomState(seed)
    shapes = state_dict_to_jax_variables(model.state_dict())
    key = [0]

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel" and v.ndim == 5:  # DHWIO
                fan_out = int(np.prod(v.shape[:3])) * v.shape[4]
                out[k] = (rs.randn(*v.shape) * np.sqrt(2.0 / fan_out)).astype(
                    np.float32)
            elif k == "kernel" and v.ndim == 3:  # (k, I, O)
                out[k] = (rs.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
                          ).astype(np.float32)
            elif k == "kernel":
                out[k] = (rs.randn(*v.shape) * 0.01).astype(np.float32)
            elif k == "gamma":
                out[k] = np.full(v.shape, 0.5, np.float32)
            elif k == "scale":
                out[k] = np.ones(v.shape, np.float32)
            elif k == "bias":
                out[k] = np.zeros(v.shape, np.float32)
            elif k == "mean":
                key[0] += 1
                out[k] = np.full(v.shape, 0.05 * (key[0] % 7 - 3), np.float32)
            elif k == "var":
                key[0] += 1
                out[k] = np.full(v.shape, 1.0 + 0.1 * (key[0] % 5), np.float32)
        return out

    return fill(shapes)


def serving_model(cfg, seed):
    from efficient_slowfast_tpu_torch.models import build_model
    from efficient_slowfast_tpu_torch.utils.weights import \
        jax_variables_to_state_dict

    model = build_model(cfg, device="cuda")
    variables = jax_layout_weights(model, seed)
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model.eval()


def clips(cfg, batch, gen, dtype):
    t, s, a = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.SLOWFAST.ALPHA
    return [torch.randn(batch, t // a, s, s, 3, generator=gen).to("cuda", dtype),
            torch.randn(batch, t, s, s, 3, generator=gen).to("cuda", dtype)]


def check_scores(out, batch, classes, what):
    if out.shape != (batch, classes):
        raise AssertionError(f"{what}: shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite scores")
    row_err = (out.sum(-1) - 1).abs().max().item()
    if row_err > 1e-3:
        raise AssertionError(f"{what}: rows sum to 1 ± {row_err}")


def serve(fwd, requests):
    """Answer each request; (outputs, wall seconds) on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for req in requests:
        outs.append(fwd(req))
        torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def serve_and_compare(phase, cfg, fwd, ref, names, expect, tol, seed, smi):
    """Answer REQUESTS requests of bf16 clips through ``fwd`` with every
    launch count set to 0 just before and read just after, check the counts
    against ``expect``, and hold the scores against those of ``ref`` (which
    launches no kernel) on the same requests. ``names`` labels the two
    paths. Returns the counts of ``fwd``'s run and its seconds per
    request."""
    gen = torch.Generator().manual_seed(seed)
    requests = [clips(cfg, CLIPS_PER_REQUEST, gen, torch.bfloat16)
                for _ in range(REQUESTS)]
    serve(fwd, requests[:1])  # warm-up: cuDNN plans, allocator
    serve(ref, requests[:1])

    reset_counts()
    outs, dt = serve(fwd, requests)
    counts = read_counts()
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} for {REQUESTS} "
                             f"requests, expected {expect}")
    reset_counts()
    refs, dt_ref = serve(ref, requests)
    if any(read_counts().values()):
        raise AssertionError(f"the {names[1]} launched {read_counts()}")
    err = 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        for out, name in ((o, names[0]), (r, names[1])):
            check_scores(out, CLIPS_PER_REQUEST, cfg.MODEL.NUM_CLASSES,
                         f"{name} request {i}")
        err = max(err, (o - r).abs().max().item())
    top1 = float(np.mean([(o.argmax(-1) == r.argmax(-1)).float().mean().item()
                          for o, r in zip(outs, refs)]))
    pmax = max(o.max().item() for o in outs)
    n_clips = REQUESTS * CLIPS_PER_REQUEST
    per_request = ", ".join(f"{n} {c // REQUESTS}" for n, c in counts.items())
    log(phase, f"bf16: {REQUESTS} requests x {CLIPS_PER_REQUEST} clips, "
        f"kernel launches {counts} (per request: {per_request})")
    log(phase, f"bf16: {names[0]} vs {names[1]} max |dp| {err:.3e} (tol "
        f"{tol}), top-1 agreement {top1:.3f}, max p {pmax:.3f}")
    log(phase, f"bf16: {names[0]} {n_clips / dt:.2f} clips/s | {names[1]} "
        f"{n_clips / dt_ref:.2f} clips/s | {smi}")
    if err > tol:
        raise AssertionError(f"{phase} bf16: {names[0]} vs {names[1]} {err}")
    return counts, dt / REQUESTS


def compare_one_clip(phase, cfg, fwd, ref, names, tol, seed, smi):
    """Hold ``fwd`` against ``ref`` on one seeded float32 clip."""
    req = clips(cfg, 1, torch.Generator().manual_seed(seed), torch.float32)
    out, expected = fwd(req), ref(req)
    torch.cuda.synchronize()
    check_scores(out, 1, cfg.MODEL.NUM_CLASSES, f"{names[0]} f32")
    err = (out - expected).abs().max().item()
    log(phase, f"f32, 1 clip: {names[0]} vs {names[1]} max |dp| {err:.3e} "
        f"(tol {tol}) | {smi}")
    if err > tol:
        raise AssertionError(f"{phase} f32: {names[0]} vs {names[1]} {err}")


def phase_serving(cfg, model, k1_ms, smi):
    """k1_ms: K1's kernel time per request (phase 3)."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg_module = cfg.clone()
    cfg_module.TPU.FUSED_EVAL = False
    counts, request_s = serve_and_compare(
        "serving", cfg, make_forward(cfg, model),
        make_forward(cfg_module, model), ("fused engine", "module forward"),
        {"fused_bottleneck": 26 * REQUESTS, "flash_attention": 0,
         "flash_attention_backward": 0},
        SERVE_BF16_ATOL, SEED + 1, smi)
    log("serving", f"bf16: fused engine {request_s * 1e3:.2f} ms per request,"
        f" of which K1's 26 launches {k1_ms:.2f} ms (phase 3); the rest "
        f"{request_s * 1e3 - k1_ms:.2f} ms | {smi}")
    return counts["fused_bottleneck"]


def phase_serving_f32(smi):
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg = serving_cfg("float32")
    model = serving_model(cfg, SEED)
    cfg_module = cfg.clone()
    cfg_module.TPU.FUSED_EVAL = False
    compare_one_clip("serving", cfg, make_forward(cfg, model),
                     make_forward(cfg_module, model),
                     ("fused engine", "module forward"), SERVE_F32_ATOL,
                     SEED + 2, smi)


# ---------------------------------------------------------------------------
def cmda_cfg(dtype="bfloat16", flash=True):
    """SlowFastDualAttention-R50 8x8 serving at the 30-view test shape, the
    shapes of configs/Kinetics/SLOWFAST_DUALATTENTION_8x8_R50.yaml (the
    module forward serves it: the fused engine does not cover CMDA)."""
    cfg = serving_cfg(dtype)
    cfg.MODEL.MODEL_NAME = "SlowFastDualAttention"
    cfg.TPU.FUSED_EVAL = False
    cfg.TPU.FLASH_ATTENTION = flash
    return cfg


def calibrate_attention(cfg, model, seed):
    """Scale each fusion's query and key convs (weight and bias, by one
    factor each) so that its logits have ATTN_LOGIT_STD on a seeded clip,
    fusion by fusion, as each scale moves the fusions after it."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    fwd = make_forward(cfg, model)
    req = clips(cfg, 1, torch.Generator().manual_seed(seed), torch.float32)
    stds = []
    for i in range(1, 5):
        att = getattr(model, f"s{i}_fuse").attention_spatial_s2f
        seen = {}
        hook = att.register_forward_hook(
            lambda m, inp, out: seen.update(x=inp[0]))
        fwd(req)
        hook.remove()
        with torch.inference_mode():
            q = att.query_conv(seen["x"]).flatten(2).float()  # (1, D, N)
            k = att.key_conv(seen["x"]).flatten(2).float()
            std = torch.einsum("bdn,bdm->bnm", q[:, :, ::64], k).std().item()
            f = (ATTN_LOGIT_STD / std) ** 0.5
            for conv in (att.query_conv, att.key_conv):
                conv.weight.mul_(f)
                conv.bias.mul_(f)
        stds.append(std)
    log("cmda", "attention logit std before calibration, s1-s4_fuse: "
        + ", ".join(f"{x:.4g}" for x in stds) + f" -> {ATTN_LOGIT_STD}")


def attention_rows(cfg, model):
    """The SpatialAttention of each lateral fusion of one forward:
    [(label, N, M, D, C, launches per request)]."""
    t_len = cfg.DATA.NUM_FRAMES // cfg.SLOWFAST.ALPHA
    h = cfg.DATA.TEST_CROP_SIZE // 4  # after the stem's two stride-2 ops
    strides = [1] + [s[0] for s in cfg.RESNET.SPATIAL_STRIDES]
    rows = []
    for i in range(4):
        h //= strides[i]
        att = getattr(model, f"s{i + 1}_fuse").attention_spatial_s2f
        n = t_len * h * h
        rows.append((f"s{i + 1}_fuse", n, n, att.query_conv.out_channels,
                     att.value_conv.out_channels, 1))
    return rows


def attention_cost(b, n, m, d, c):
    """(FLOPs, bf16 bytes, exponentials) of one call: q, k, v read once and
    out written once."""
    return (2 * b * n * m * (d + c), 2 * b * (n * d + m * d + m * c + n * c),
            b * n * m)


def phase_attention(rows, smi):
    import torch.nn.functional as F

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        chunked_attention, flash_attention)

    gen = torch.Generator().manual_seed(SEED + 3)
    card_gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rn = lambda *shape, dtype: torch.randn(*shape, generator=gen).to(
        "cuda", dtype)
    rn_card = lambda *shape, dtype: torch.randn(
        *shape, generator=card_gen, device="cuda").to(dtype)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    record = []
    for label, n, m, d, c, count in rows + [r + (0,) for r in ATTN_OFF_PATH]:
        # the path's shapes also at the 30-view test batch (phase 8), in
        # its dtype
        cases = [(dtype, tol, b) for dtype, tol in (
            (torch.float32, ATTN_F32_TOL), (torch.bfloat16, ATTN_BF16_TOL))
            for b in (1, CLIPS_PER_REQUEST)]
        if count:
            cases.append((torch.bfloat16, ATTN_BF16_TOL, TEST_CLIPS))
        for dtype, tol, b in cases:
            draw = rn_card if b == TEST_CLIPS else rn
            q, k, v = (draw(b, n, d, dtype=dtype), draw(b, m, d, dtype=dtype),
                       draw(b, m, c, dtype=dtype))
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = chunked_attention(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            finite = bool(torch.isfinite(out).all())
            log("attention", f"{label:16s} {str(dtype)[6:]:8s} clips {b} "
                f"max_abs_err {err:.3e} (scale {scale:.3g}, tol "
                f"{tol * scale:.3e})")
            if out.dtype != dtype or not finite or err > tol * scale:
                raise AssertionError(f"{label} {dtype} clips {b}: "
                                     f"err {err} > {tol * scale}")
            if b != 1 and count:
                worst[dtype] = max(worst[dtype], err)
            del q, k, v, out, ref
        torch.cuda.empty_cache()
        # timing at the request batch, in the serving dtype
        b, dtype = CLIPS_PER_REQUEST, torch.bfloat16
        q, k, v = (rn(b, n, d, dtype=dtype), rn(b, m, d, dtype=dtype),
                   rn(b, m, c, dtype=dtype))
        big = b * n * m > 2 ** 30  # the 32768-token rows: few repetitions
        k_ms = cuda_ms(lambda: flash_attention(q, k, v),
                       iters=2 if big else 10, reps=3 if big else 5)
        p_ms = cuda_ms(lambda: chunked_attention(q, k, v), iters=1, reps=3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], scale=1.0),
            iters=2 if big else 10, reps=3 if big else 5)
        flops, nbytes, exps = attention_cost(b, n, m, d, c)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_exp = exps / EXP_RATE * 1e3
        bound = max(t_ops, t_bytes, t_exp)
        by = "bytes" if t_bytes == bound else "operations"
        log("attention", f"{label:16s} bf16 N {n} M {m} D {d} C {c} x{count}"
            f" per request | kernel {k_ms:.4f} ms | plain {p_ms:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms | kernel/bound {k_ms / bound:.2f}, "
            f"kernel/sdpa {k_ms / lib_ms:.2f} | bound {bound:.5f} ms ({by}; tensor "
            f"cores {t_ops:.5f} ms for {flops / 1e9:.3f} GFLOP, exp "
            f"{t_exp:.5f} ms for {exps:.3e}, memory {t_bytes:.5f} ms for "
            f"{nbytes / 1e6:.3f} MB) | {smi}")
        record.append(dict(label=label, count=count, ms=k_ms, plain_ms=p_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by))
    log("attention", f"worst max_abs_err at the request and test batches on the CMDA "
        f"path: f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e}")
    return record, worst[torch.bfloat16]


def cmda_model(cfg, state):
    """The CMDA model of ``cfg`` with the calibrated weights ``state``."""
    from efficient_slowfast_tpu_torch.models import build_model

    model = build_model(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    return model.eval()


def phase_cmda(cfg, model, smi):
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg_plain = cmda_cfg(flash=False)
    counts, _ = serve_and_compare(
        "cmda", cfg, make_forward(cfg, model),
        make_forward(cfg_plain, cmda_model(cfg_plain, model.state_dict())),
        ("flash kernel", "plain attention"),
        {"fused_bottleneck": 0, "flash_attention": 4 * REQUESTS,
         "flash_attention_backward": 0},
        CMDA_BF16_ATOL, SEED + 4, smi)
    return counts["flash_attention"]


def phase_cmda_f32(state, smi):
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg, cfg_plain = cmda_cfg("float32"), cmda_cfg("float32", flash=False)
    compare_one_clip("cmda", cfg, make_forward(cfg, cmda_model(cfg, state)),
                     make_forward(cfg_plain, cmda_model(cfg_plain, state)),
                     ("flash kernel", "plain attention"), CMDA_F32_ATOL,
                     SEED + 5, smi)


def attention_backward_cost(b, n, m, d, c):
    """(FLOPs, bytes, exponentials) of one backward call: the five products
    2 N M (3D + 2C) per clip; q, k, v, out and dO read once and dq, dk, dv
    written once in bf16, lse read once in float32."""
    return (2 * b * n * m * (3 * d + 2 * c),
            2 * b * 2 * (n * d + m * d + m * c + n * c) + 4 * b * n,
            b * n * m)


def phase_attention_backward(rows, smi):
    """K2-bwd against attention_backward at the training shapes ``rows``
    and off-path shapes; returns (per-shape record, worst bf16 error on the
    path at the training batch)."""
    import torch.nn.functional as F

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        _forward, attention_backward, backward_split, chunked_attention,
        flash_attention_backward)

    gen = torch.Generator().manual_seed(SEED + 7)
    rn = lambda *shape, dtype: torch.randn(*shape, generator=gen).to(
        "cuda", dtype)
    smallest = min(r[1] for r in rows)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    record = []
    for label, n, m, d, c, count in rows + [r + (0,)
                                            for r in ATTN_BWD_OFF_PATH]:
        for dtype, tol in ((torch.float32, ATTN_BWD_F32_TOL),
                           (torch.bfloat16, ATTN_BWD_BF16_TOL)):
            for b in (1, TRAIN_CLIPS):
                q, k, v, dout = (rn(b, n, d, dtype=dtype),
                                 rn(b, m, d, dtype=dtype),
                                 rn(b, m, c, dtype=dtype),
                                 rn(b, n, c, dtype=dtype))
                out, lse = _forward(q, k, v, with_lse=True)
                if not torch.equal(out, _forward(q, k, v, False)[0]):
                    raise AssertionError(f"{label} {dtype} clips {b}: K2's "
                                         "output moved with its lse store")
                grads = flash_attention_backward(q, k, v, out, lse, dout)
                again = flash_attention_backward(q, k, v, out, lse, dout)
                torch.cuda.synchronize()
                # dK and dV are sums in a fixed order; bf16 dQ is summed
                # over key blocks by float32 atomic adds in any order
                exact = [torch.equal(g, a) for g, a in zip(grads, again)]
                dq_moved = (grads[0].float() - again[0].float()).abs().max(
                    ).item()
                if not all(exact[1:]) or (dtype == torch.float32
                                          and not exact[0]):
                    raise AssertionError(f"{label} {dtype} clips {b}: two "
                                         "calls differ (dq/dk/dv "
                                         f"bit-identical {exact})")
                dq_scale = max(1.0, grads[0].float().abs().max().item())
                if dq_moved > tol * dq_scale:
                    raise AssertionError(f"{label} {dtype} clips {b}: dq "
                                         f"moved {dq_moved} between calls")
                del again
                refs = [("plain", attention_backward(q, k, v, out, lse,
                                                     dout))]
                if count and b == 1 and n == smallest:
                    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                    refs.append(("autograd", torch.autograd.grad(
                        chunked_attention(*leaves), leaves, dout)))
                torch.cuda.synchronize()
                for name, ref in refs:
                    errs = []
                    for g, r in zip(grads, ref):
                        err = (g.float() - r.float()).abs().max().item()
                        scale = max(1.0, r.float().abs().max().item())
                        if (g.dtype != dtype or not bool(
                                torch.isfinite(g).all()) or err > tol * scale):
                            raise AssertionError(
                                f"{label} {dtype} clips {b} vs {name}: "
                                f"err {err} > {tol * scale}")
                        errs.append((err, scale))
                        if b == TRAIN_CLIPS and count:
                            worst[dtype] = max(worst[dtype], err)
                    log("attention_backward",
                        f"{label:16s} {str(dtype)[6:]:8s} clips {b} vs "
                        f"{name}: max_abs_err dq/dk/dv " +
                        " / ".join(f"{e:.3e} (scale {s_:.3g})"
                                   for e, s_ in errs) + f", tol {tol} of "
                        "the scale; K2's output bit-identical with its lse "
                        "store on and off; a second call: dk, dv "
                        f"bit-identical, dq {'bit-identical' if exact[0] else f'moved {dq_moved:.3e}'}")
                del q, k, v, dout, out, lse, grads, refs
        # timing at the training batch, in the training dtype
        b, dtype = TRAIN_CLIPS, torch.bfloat16
        q, k, v, dout = (rn(b, n, d, dtype=dtype), rn(b, m, d, dtype=dtype),
                         rn(b, m, c, dtype=dtype), rn(b, n, c, dtype=dtype))
        out, lse = _forward(q, k, v, with_lse=True)
        big = b * n * m > 2 ** 30
        reps = dict(iters=2 if big else 10, reps=3 if big else 5)
        k_ms = cuda_ms(lambda: flash_attention_backward(q, k, v, out, lse,
                                                        dout), **reps)
        p_ms = cuda_ms(lambda: attention_backward(q, k, v, out, lse, dout),
                       iters=1, reps=3)
        q4, k4, v4 = (t[:, None].detach().requires_grad_()
                      for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), dout[:, None], retain_graph=True), **reps)
        del o4
        flops, nbytes, exps = attention_backward_cost(b, n, m, d, c)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_exp = exps / EXP_RATE * 1e3
        bound = max(t_ops, t_bytes, t_exp)
        by = "bytes" if t_bytes == bound else "operations"
        split = backward_split(b, n, m, d, c)
        log("attention_backward", f"{label:16s} bf16 N {n} M {m} D {d} C {c}"
            f" x{count} per train step | kernels {k_ms:.4f} ms (PR 5 "
            f"two-pass: {ATTN_BWD_PR5_MS.get(label, 'not measured')}) | "
            f"plain {p_ms:.4f} ms | sdpa backward {lib_ms:.4f} ms | "
            f"kernels/bound {k_ms / bound:.2f}, kernels/sdpa "
            f"{k_ms / lib_ms:.2f} | bound "
            f"{bound:.5f} ms ({by}; tensor cores {t_ops:.5f} ms for "
            f"{flops / 1e9:.3f} GFLOP, exp {t_exp:.5f} ms for {exps:.3e}, "
            f"memory {t_bytes:.5f} ms for {nbytes / 1e6:.3f} MB) | split: "
            f"Bc {split['keys']} keys, Br {split['queries']} queries, "
            f"{split['stages']} stages, {split['blocks']} CTAs "
            f"({split['per_sm']} an SM), {split['smem']} B shared memory, "
            f"width {split['width']} | "
            f"{smi}")
        record.append(dict(label=label, count=count, ms=k_ms, plain_ms=p_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by))
        del q, k, v, dout, out, lse, q4, k4, v4
        torch.cuda.empty_cache()
    log("attention_backward", f"worst max_abs_err at the training batch on "
        f"the CMDA path: f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e}")
    return record, worst[torch.bfloat16]


# ---------------------------------------------------------------------------
def train_cfg(model_name="SlowFast", dtype="bfloat16", flash=True):
    """SlowFast-R50 8x8 (or CMDA-R50) trained as
    configs/Kinetics/SLOWFAST_8x8_R50.yaml (and
    SLOWFAST_DUALATTENTION_8x8_R50.yaml) train it: the 224² crop (the
    inputs are made at the test crop, set to it), final BNs
    zero-initialised, SGD lr 0.1 with nesterov momentum 0.9, weight decay
    1e-4 and none on BN, dropout 0.5."""
    cfg = serving_cfg(dtype)
    cfg.MODEL.MODEL_NAME = model_name
    cfg.DATA.TEST_CROP_SIZE = cfg.DATA.CROP_SIZE
    cfg.TPU.FUSED_EVAL = False
    cfg.TPU.FLASH_ATTENTION = flash
    cfg.RESNET.ZERO_INIT_FINAL_BN = True
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.SOLVER.BASE_LR = 0.1
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = True
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.BN.WEIGHT_DECAY = 0.0
    return cfg


def train_model(cfg, seed):
    """``serving_model``'s seeded weights with each block's final BN
    zero-initialised, as the model is built for training."""
    model = serving_model(cfg, seed)
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "zero_init_gamma", False):
                m.weight.zero_()
    return model


def train_batches(cfg, count, batch, seed, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    return [(clips(cfg, batch, gen, dtype),
             torch.randint(0, cfg.MODEL.NUM_CLASSES, (batch,),
                           generator=gen).cuda()) for _ in range(count)]


def train_steps(phase, cfg, model, expect, smi):
    """TRAIN_WARMUP then TRAIN_STEPS steps of TRAIN_CLIPS bf16 clips through
    create_train_state and make_train_step, every launch count set to 0
    just before the timed steps and read just after; checks the counts
    against ``expect``, the losses and that the running statistics moved.
    Returns (state, step, counts)."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)

    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    batches = train_batches(cfg, TRAIN_WARMUP + TRAIN_STEPS, TRAIN_CLIPS,
                            SEED + 8)
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    lr = cfg.SOLVER.BASE_LR
    bn = model.s2.pathway0_res0.branch2.a_bn
    before = bn.running_mean.clone()
    for x, y in batches[:TRAIN_WARMUP]:
        step(state, x, y, lr, drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mets = [step(state, x, y, lr, drop) for x, y in batches[TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack([m["loss"] for m in mets]).tolist()
    moved = (bn.running_mean - before).abs().max().item()
    log(phase, f"bf16, {TRAIN_CLIPS} clips a step: {TRAIN_STEPS} steps "
        f"after {TRAIN_WARMUP} warm-up | losses " +
        ", ".join(f"{x:.4f}" for x in losses) + f" | top1_err "
        f"{mets[-1]['top1_err'].item():.1f} | kernel launches {counts} | "
        f"running mean of s2 res0 a_bn moved {moved:.3e}")
    log(phase, f"bf16: {TRAIN_CLIPS / dt:.2f} train clips/s, {dt * 1e3:.2f} "
        f"ms per step, peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) | {smi}")
    if counts != expect:
        raise AssertionError(f"{phase}: kernel launches {counts} for "
                             f"{TRAIN_STEPS} steps, expected {expect}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if not moved > 0:
        raise AssertionError(f"{phase}: BN running statistics did not move")
    return state, step, counts, TRAIN_CLIPS / dt


def phase_train(smi):
    """SlowFast-R50 training; then one step with stage remat on s2."""
    from efficient_slowfast_tpu_torch.models.slowfast import remat_stage

    cfg = train_cfg()
    model = train_model(cfg, SEED)
    state, step, _, _ = train_steps(
        "train", cfg, model, {"fused_bottleneck": 0, "flash_attention": 0,
                              "flash_attention_backward": 0}, smi)
    remat = cfg.clone()
    remat.TPU.REMAT = True
    remat.TPU.REMAT_STAGES = [2]
    for idx, name in enumerate(("s2", "s3", "s4", "s5")):
        getattr(model, name).remat = remat_stage(remat, idx)
    (x0, y0), (x, y) = train_batches(cfg, 2, TRAIN_CLIPS, SEED + 10)
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    step(state, x0, y0, cfg.SOLVER.BASE_LR, drop)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step(state, x, y, cfg.SOLVER.BASE_LR, drop)["loss"].item()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log("train", f"bf16, TPU.REMAT True, TPU.REMAT_STAGES [2]: one step "
        f"after one warm-up {dt * 1e3:.2f} ms, loss {loss:.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}")
    if not np.isfinite(loss):
        raise AssertionError(f"train with remat: non-finite loss {loss}")


def one_step(cfg, state_dict, batch, seed):
    """The model of ``cfg`` loaded with ``state_dict``, after one train
    step on ``batch``: {name: tensor} of its parameters and buffers."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)

    model = cmda_model(cfg, state_dict)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    step(state, *batch, cfg.SOLVER.BASE_LR,
         torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_cmda_train(cfg, model, smi):
    """CMDA-R50 training; then one step of one clip in f32 and bf16, each
    with the attention kernels against the plain attention. Returns the
    timed steps' launch counts and train clips/s."""
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL

    cmda = cfg.MODEL.MODEL_NAME
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    _, _, counts, clips_per_s = train_steps(
        "cmda_train", cfg, model,
        {"fused_bottleneck": 0, "flash_attention": 4 * TRAIN_STEPS,
         "flash_attention_backward":
             4 * BACKWARD_LAUNCHES_PER_CALL * TRAIN_STEPS}, smi)
    del model
    torch.cuda.empty_cache()
    stats = [k for k in state_dict
             if k.endswith(("running_mean", "running_var"))]
    params = [k for k in state_dict if k not in stats
              and not k.endswith("num_batches_tracked")]
    dist = lambda a, b: sum((a[k].double() - b[k].double()).norm().item() ** 2
                            for k in params) ** 0.5
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        batch = train_batches(cfg, 1, 1, SEED + 11, dtype)[0]
        after = {flash: one_step(train_cfg(cmda, name, flash), state_dict,
                                 batch, SEED)
                 for flash in (True, False)}
        if dtype == torch.float32:
            ref = after[False]  # the float32 step, plain attention
        steps = {k: (after[False][k].double() - state_dict[k].double()
                     ).norm().item() for k in params}
        floor = 1e-3 * max(steps.values())
        worst_p, where_p = max(
            ((after[True][k].double() - after[False][k].double()).norm()
             .item() / max(steps[k], floor), k) for k in params)
        worst_s, where_s = max(
            ((after[True][k] - after[False][k]).abs().max().item() / max(
                1.0, after[False][k].abs().max().item()), k) for k in stats)
        step = dist(ref, state_dict)
        e_kernel, e_plain = dist(after[True], ref), dist(after[False], ref)
        log("cmda_train", f"{name}, 1 clip, one step: attention kernels vs "
            f"plain attention: worst |dp| / |step| {worst_p:.3e} ({where_p}),"
            f" worst running statistic {worst_s:.3e} ({where_s}; tol "
            f"{CMDA_STATS_TOL[dtype]}); all parameters, distance from the f32 "
            f"plain step over that step: kernels {e_kernel / step:.3e}, plain "
            f"{e_plain / step:.3e}, kernels vs plain "
            f"{dist(after[True], after[False]) / step:.3e} | {smi}")
        bad = (worst_p > CMDA_TRAIN_F32_TOL if dtype == torch.float32
               else e_kernel > CMDA_TRAIN_BF16_RATIO * e_plain)
        if bad or worst_s > CMDA_STATS_TOL[dtype]:
            raise AssertionError(
                f"cmda_train {name}: kernels vs plain {worst_p} (f32 tol "
                f"{CMDA_TRAIN_F32_TOL}); from the f32 step kernels "
                f"{e_kernel / step}, plain {e_plain / step} (bf16 ratio "
                f"{CMDA_TRAIN_BF16_RATIO}); statistics {worst_s}")
        del after
        torch.cuda.empty_cache()
    return counts, clips_per_s


# ---------------------------------------------------------------------------
def yaml_cfg(name, opts):
    """configs/Kinetics/``name`` through the port's config loader, with the
    synthetic backend, bf16 and ``opts``."""
    from efficient_slowfast_tpu_torch.config import load_cfg

    return load_cfg(os.path.join(ROOT, "configs", "Kinetics", name), [
        "TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "synthetic",
        "TRAIN.DATASET", "synthetic",
        "DATA_LOADER.NUM_WORKERS", LOADER_WORKERS] + list(opts))


def smoke_dir():
    """A git-ignored directory of the checkout for the smoke's files."""
    path = os.path.join(ROOT, "build", "smoke")
    os.makedirs(path, exist_ok=True)
    return path


def test_meter(cfg, loader):
    """The port's TestMeter for ``loader``'s split, holding every clip's
    probabilities (finite, each row summing to 1 within TEST_ROW_TOL)
    before it ensembles them."""
    from efficient_slowfast_tpu_torch.utils.meters import TestMeter

    class Checked(TestMeter):
        worst_row = 0.0
        clips = 0

        def update_stats(self, preds, labels, clip_ids):
            if not np.isfinite(preds).all():
                raise AssertionError("thirty_view: non-finite scores")
            err = float(np.abs(preds.sum(1) - 1.0).max())
            self.worst_row = max(self.worst_row, err)
            if err > TEST_ROW_TOL:
                raise AssertionError(f"thirty_view: rows sum to 1 ± {err}")
            self.clips += len(preds)
            super().update_stats(preds, labels, clip_ids)

    views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    return Checked(len(loader.dataset) // views, views, cfg.MODEL.NUM_CLASSES,
                   len(loader), ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
                   topk=cfg.TRAIN.TOPK)


def check_preprocess(cfg, batch):
    """The first batch's pathways, preprocessed in float32 on the card,
    against the same preprocess on the CPU (8 clips at a time), returning
    the largest difference."""
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_test_preprocess

    pre = make_test_preprocess(cfg, torch.float32)
    keys = ("width", "spatial_idx", "portrait")
    on_card = pre(batch["frames"], *(batch[k] for k in keys))
    err = 0.0
    for i in range(0, batch["frames"].shape[0], 8):
        part = slice(i, i + 8)
        on_cpu = pre(batch["frames"][part].cpu(), *(batch[k][part] for k in keys))
        for a, b in zip(on_card, on_cpu):
            err = max(err, (a[part].cpu() - b).abs().max().item())
    return err


def phase_thirty_view(name, fused, expect_per_batch, smi):
    """One model's 30-view test on the synthetic test split, through the
    loader, the pinned host→GPU copy, the preprocess and the forward.
    Returns (kernel launches of the timed run, video_preds, cfg, model)."""
    from efficient_slowfast_tpu_torch.data.loader import (construct_loader,
                                                          prefetch_to_device)
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_test_preprocess
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.engine.test import perform_test
    from efficient_slowfast_tpu_torch.ops.kernels import fused_bottleneck as fb
    from efficient_slowfast_tpu_torch.utils.meters import StageTimes

    cfg = yaml_cfg(name, ["TPU.FUSED_EVAL", fused])
    label = cfg.MODEL.MODEL_NAME + (" fused" if fused else "")
    model = serving_model(cfg, SEED)
    if cfg.MODEL.MODEL_NAME == "SlowFastDualAttention":
        calibrate_attention(cfg, model, SEED + 6)
    loader = construct_loader(cfg, "test")
    n_clips, batch = len(loader.dataset), loader.batch_size
    if batch != TEST_CLIPS:
        raise AssertionError(f"thirty_view: {name} batches {batch} clips, "
                             f"phases 3 and 3b hold the kernels at {TEST_CLIPS}")
    real_tail = n_clips - (len(loader) - 1) * batch
    log("thirty_view", f"{label}: {name}, {n_clips} clips (8 videos x "
        f"{cfg.TEST.NUM_ENSEMBLE_VIEWS} x {cfg.TEST.NUM_SPATIAL_CROPS} views)"
        f" in {len(loader)} batches of {batch}, the last {real_tail} real + "
        f"{batch - real_tail} padded, {cfg.DATA_LOADER.NUM_WORKERS} loader "
        f"threads, canvas {loader.dataset.frames_shape()} uint8")

    # untimed: one batch (cuDNN plans, the kernels' plans, the pinned ring)
    plans = fb.plan.cache_info().misses
    pre = make_test_preprocess(cfg, torch.bfloat16)
    fwd = make_forward(cfg, model)
    for first in prefetch_to_device(loader, "cuda"):
        inputs = pre(first["frames"], first["width"], first["spatial_idx"],
                     first["portrait"])
        fwd(inputs)
        torch.cuda.synchronize()
        pre_err = check_preprocess(cfg, first)
        break
    warm_plans = fb.plan.cache_info().misses - plans
    # the forward alone on a resident preprocessed batch
    reps = len(loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd(inputs)
    torch.cuda.synchronize()
    fwd_alone = reps * batch / (time.perf_counter() - t0)
    del inputs, first

    times = StageTimes()
    meter = test_meter(cfg, loader)
    plans = fb.plan.cache_info().misses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stats = perform_test(cfg, model, loader, meter, times=times)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    timed_plans = fb.plan.cache_info().misses - plans

    split = times.summary()
    log("thirty_view", f"{label}: kernel launches {counts} ({len(loader)} "
        f"batches) | K1 plans made: {warm_plans} in the untimed batch, "
        f"{timed_plans} in the timed run (every shape was planned and held "
        f"at {TEST_CLIPS} clips in phase 3) | {stats} | rows of every clip sum "
        f"to 1 within {meter.worst_row:.2e} | preprocess on the card vs the "
        f"CPU, f32, first batch: max |d| {pre_err:.3e} (tol {PRE_TOL})")
    for i in range(len(split["forward"])):
        log("thirty_view", f"{label}: batch {i}: waiting on the loader "
            f"{split['wait'][i]:.2f} ms (host) | copy {split['copy'][i]:.2f}"
            f" ms | preprocess {split['preprocess'][i]:.2f} ms | forward "
            f"{split['forward'][i]:.2f} ms (CUDA events)")
    means = {k: statistics.mean(v) for k, v in split.items()}
    log("thirty_view", f"{label}: end to end {meter.clips / dt:.2f} clips/s "
        f"({dt:.3f} s for {meter.clips} clips: loader, copy, preprocess, "
        f"forward, meter) | forward alone on a resident {batch}-clip batch "
        f"{fwd_alone:.2f} clips/s | per batch mean: wait {means['wait']:.2f},"
        f" copy {means['copy']:.2f}, preprocess {means['preprocess']:.2f}, "
        f"forward {means['forward']:.2f} ms | peak memory "
        f"{peak / 2 ** 30:.2f} GiB | {smi}")

    expect = {k: v * len(loader) for k, v in expect_per_batch.items()}
    if counts != expect:
        raise AssertionError(f"thirty_view {label}: kernel launches {counts}"
                             f", expected {expect}")
    if meter.clips != n_clips:
        raise AssertionError(f"thirty_view {label}: {meter.clips} clips "
                             f"scored, expected {n_clips}")
    if warm_plans or timed_plans:
        raise AssertionError(f"thirty_view {label}: K1 planned {warm_plans} "
                             f"shapes in the untimed batch and {timed_plans} "
                             "in the timed run, which phase 3 did not hold "
                             "against the plain version")
    if pre_err > PRE_TOL:
        raise AssertionError(f"thirty_view {label}: preprocess on the card "
                             f"vs the CPU {pre_err}")
    return counts, meter.video_preds / meter.num_clips, cfg, model


def centred_log(means):
    """Per-video log mean probabilities less their mean over the classes:
    for one clip, the logits less theirs."""
    lp = np.log(np.maximum(means, 1e-30))
    return lp - lp.mean(1, keepdims=True)


def phase_thirty_view_reference(cfg, model, kernel_means, opts, what, smi):
    """The test again through ``test()`` with ``opts`` (the path without
    the kernels), its weights from a .pyth of the kernel run's, holding
    each video's centred log mean probabilities within TEST_LOGIT_TOL of
    their scale and printing top-1 agreement."""
    from efficient_slowfast_tpu_torch.engine.test import test

    label = cfg.MODEL.MODEL_NAME
    path = os.path.join(smoke_dir(), f"{label.lower()}_r50.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    ref_cfg = cfg.clone()
    ref_cfg.merge_from_list(list(opts) + [
        "TEST.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", smoke_dir()])
    reset_counts()
    meter = test(ref_cfg)
    if any(read_counts().values()):
        raise AssertionError(f"the path without kernels launched "
                             f"{read_counts()}")
    ref_means = meter.video_preds / meter.num_clips
    ref_c, got_c = centred_log(ref_means), centred_log(kernel_means)
    scale = float(np.abs(ref_c).max())
    err = float(np.abs(got_c - ref_c).max())
    top1 = float((ref_means.argmax(1) == kernel_means.argmax(1)).mean())
    log("thirty_view", f"{label}: {what} vs test() from the .pyth with "
        f"{' '.join(map(str, opts))}: per-video centred log mean "
        f"probabilities max |d| {err:.3e} of scale {scale:.3e} (tol "
        f"{TEST_LOGIT_TOL * scale:.3e}), mean probabilities max |d| "
        f"{float(np.abs(kernel_means - ref_means).max()):.3e} (max p "
        f"{float(ref_means.max()):.3e}), top-1 agreement {top1:.3f} | "
        f"{meter.stats} | {smi}")
    if not err <= TEST_LOGIT_TOL * scale:
        raise AssertionError(f"thirty_view {label}: {what} vs reference "
                             f"{err} > {TEST_LOGIT_TOL} x {scale}")


def phase_epochs(step_clips_per_s, smi):
    """CMDA-R50 as phase 7 trains it: an untimed train and val epoch (the
    loaders' first buffers and pinned canvases, the eval shapes' cuDNN
    plans), then a timed train epoch and val epoch through the synthetic
    loaders. Returns the timed epochs' launch counts."""
    from efficient_slowfast_tpu_torch.data.loader import construct_loader
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_train_preprocess
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_eval_step,
                                                           make_train_step)
    from efficient_slowfast_tpu_torch.engine.train import (eval_epoch,
                                                           train_epoch)
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL
    from efficient_slowfast_tpu_torch.utils.lr_policy import get_lr_at_epoch
    from efficient_slowfast_tpu_torch.utils.meters import TrainMeter, ValMeter

    cfg = yaml_cfg("SLOWFAST_DUALATTENTION_8x8_R50.yaml",
                   ["TRAIN.BATCH_SIZE", TRAIN_CLIPS])
    model = train_model(cfg, SEED)
    calib = cfg.clone()
    calib.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE  # as in phase 7
    calibrate_attention(calib, model, SEED + 9)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    eval_step = make_eval_step(cfg, state.model)
    lrs, losses = [], []

    def recorded(state, inputs, labels, lr, generator):
        lrs.append(lr)
        mets = step(state, inputs, labels, lr, generator)
        losses.append(mets["loss"])
        return mets

    pre = make_train_preprocess(cfg, dtype=torch.bfloat16)
    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    bn = model.s2.pathway0_res0.branch2.a_bn
    before = bn.running_mean.clone()

    def epochs(epoch):
        """(train seconds, val seconds, val meter) of one epoch each."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_loader.set_epoch(epoch)
        train_epoch(cfg, state, recorded, pre, train_loader,
                    TrainMeter(len(train_loader), cfg), epoch, generator=drop)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        val = ValMeter(len(val_loader), cfg)
        eval_epoch(cfg, state, eval_step, pre, val_loader, val, epoch)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1, val

    cold = epochs(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_train, t_val, val = epochs(1)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    moved = (bn.running_mean - before).abs().max().item()
    steps = len(train_loader)
    expect_lr = [get_lr_at_epoch(cfg, e + i / steps)
                 for e in (0, 1) for i in range(steps)]
    n_train = steps * train_loader.batch_size
    n_val = len(val_loader.dataset)
    log("epochs", f"CMDA-R50 train epochs 0 and 1: {steps} steps of "
        f"{train_loader.batch_size} clips each ({cfg.DATA.TRAIN_CROP_SIZE}² "
        f"crops from the {cfg.DATA.TRAIN_JITTER_SCALES[1]}-short-side canvas,"
        f" jitter {list(cfg.DATA.TRAIN_JITTER_SCALES)}) | losses "
        + ", ".join(f"{x:.4f}" for x in losses) + " | lr "
        + ", ".join(f"{x:.5f}" for x in lrs) + f" | running mean of s2 res0 "
        f"a_bn moved {moved:.3e}")
    log("epochs", f"CMDA-R50 val epoch 1: {len(val_loader)} batches, {n_val} "
        f"clips | top1_err {val.min_top1_err:.2f} top{cfg.TRAIN.TOPK}_err "
        f"{val.min_top_k_err:.2f} | kernel launches (epoch 1, train and val) "
        f"{counts}")
    log("epochs", f"bf16, epoch 1: train {n_train / t_train:.2f} clips/s "
        f"through the loader ({t_train:.3f} s; phase 7's steps alone "
        f"{step_clips_per_s:.2f}) | val {n_val / t_val:.2f} clips/s "
        f"({t_val:.3f} s) | peak memory {peak / 2 ** 30:.2f} GiB | epoch 0 "
        f"(the loaders' first epoch): train {n_train / cold[0]:.2f}, val "
        f"{n_val / cold[1]:.2f} clips/s | {smi}")

    expect = {"fused_bottleneck": 0,
              "flash_attention": 4 * steps + 4 * len(val_loader),
              "flash_attention_backward":
                  4 * BACKWARD_LAUNCHES_PER_CALL * steps}
    if counts != expect:
        raise AssertionError(f"epochs: kernel launches {counts}, expected "
                             f"{expect}")
    if len(losses) != 2 * steps or not all(np.isfinite(losses)):
        raise AssertionError(f"epochs: losses {losses}")
    if not moved > 0:
        raise AssertionError("epochs: BN running statistics did not move")
    if lrs != expect_lr:
        raise AssertionError(f"epochs: lr {lrs}, expected {expect_lr}")
    for v in (cold[2], val):
        if not (0 <= v.min_top1_err <= 100 and 0 <= v.min_top_k_err <= 100):
            raise AssertionError(f"epochs: val errors {v.min_top1_err}, "
                                 f"{v.min_top_k_err}")
    return counts


def per_request(record, key):
    return sum(r[key] * r["count"] for r in record)


def kernel_entry(name, source, replaces, launches, err, record):
    """One kernel's JSON entry: per-request sums over its main-path rows."""
    path = [r for r in record if r["count"]]
    ops_share = sum(r["bound_ms"] * r["count"] for r in path
                    if r["bound_by"] == "operations") / per_request(
                        path, "bound_ms")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=per_request(path, "ms"),
        plain_ms=per_request(path, "plain_ms"),
        bound_ms=per_request(path, "bound_ms"),
        bound_by="operations" if ops_share >= 0.5 else "bytes",
        library_ms=per_request(path, "library_ms"))


def main():
    smi = phase_device()
    phase_build()
    cfg = serving_cfg()
    model = serving_model(cfg, SEED)
    k1_record, k1_err = phase_kernels(cfg, model, smi)
    k1_launches = phase_serving(cfg, model, per_request(k1_record, "ms"),
                                smi)
    del model
    torch.cuda.empty_cache()
    phase_serving_f32(smi)
    torch.cuda.empty_cache()

    cfg = cmda_cfg()
    model = serving_model(cfg, SEED)
    k2_record, k2_err = phase_attention(attention_rows(cfg, model), smi)
    calibrate_attention(cfg, model, SEED + 6)
    k2_launches = phase_cmda(cfg, model, smi)
    state = model.state_dict()
    del model
    torch.cuda.empty_cache()
    phase_cmda_f32(state, smi)
    del state
    torch.cuda.empty_cache()

    cfg = train_cfg("SlowFastDualAttention")
    model = train_model(cfg, SEED)
    bwd_record, bwd_err = phase_attention_backward(
        attention_rows(cfg, model), smi)
    phase_train(smi)
    torch.cuda.empty_cache()
    calibrate_attention(cfg, model, SEED + 9)
    train_counts, step_clips_per_s = phase_cmda_train(cfg, model, smi)
    del model
    torch.cuda.empty_cache()

    none = {"fused_bottleneck": 0, "flash_attention": 0,
            "flash_attention_backward": 0}
    sf_counts, sf_means, cfg, model = phase_thirty_view(
        "SLOWFAST_8x8_R50.yaml", True, {**none, "fused_bottleneck": 26}, smi)
    phase_thirty_view_reference(cfg, model, sf_means,
                                ["TPU.FUSED_EVAL", False], "fused engine", smi)
    del model
    torch.cuda.empty_cache()
    cmda_counts, cmda_means, cfg, model = phase_thirty_view(
        "SLOWFAST_DUALATTENTION_8x8_R50.yaml", False,
        {**none, "flash_attention": 4}, smi)
    phase_thirty_view_reference(cfg, model, cmda_means,
                                ["TPU.FLASH_ATTENTION", False],
                                "flash attention", smi)
    del model
    torch.cuda.empty_cache()
    epoch_counts = phase_epochs(step_clips_per_s, smi)

    # launches on the main paths: serving (phases 4, 5), CMDA training
    # (phase 7), the 30-view tests (phase 8) and the epochs (phase 9)
    k1_launches += sf_counts["fused_bottleneck"]
    k2_launches += sum(c["flash_attention"]
                       for c in (train_counts, cmda_counts, epoch_counts))
    bwd_launches = sum(c["flash_attention_backward"]
                       for c in (train_counts, epoch_counts))

    kernels = [
        kernel_entry(
            "fused_bottleneck",
            "efficient_slowfast_tpu_torch/csrc/fused_bottleneck.cu",
            "efficient_slowfast_tpu/ops/pallas/fused_bottleneck.py:200",
            k1_launches, k1_err, k1_record),
        kernel_entry(
            "flash_attention",
            "efficient_slowfast_tpu_torch/csrc/flash_attention.cu",
            "efficient_slowfast_tpu/ops/pallas/flash_attention.py:112",
            k2_launches, k2_err, k2_record),
        kernel_entry(
            "flash_attention_backward",
            "efficient_slowfast_tpu_torch/csrc/flash_attention_bwd.cu",
            "efficient_slowfast_tpu/ops/pallas/flash_attention.py:219",
            bwd_launches, bwd_err, bwd_record)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
