"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

Phases (each asserts or exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together, and print what
     -Xptxas -v reports;
  3. hold each kernel against its plain PyTorch version at B=256, TF32
     off: the fp32 pyramid on the fusion group of each of the five
     topologies and the fp32 single-layer kernel on every layer of
     cifar10, cifar10_full and cifar10_strided, in fp32 and with
     act_bits=6; their int8 variants at act_bits=8 on the same groups and
     layers; pow2_matmul in both modes at the cifar10 and lenet5 head
     shapes;
  3c. hold the selective scan against its plain version at the
     falcon-mamba layer (Bz 4, S 512, D 8192, N 16) in bf16 and f32 with
     zero and carried state, at decode (S = 1), at N = 64 and at D of 200
     and 8200, which no CTA's channels divide; and the seed conv at the
     kernel bench's shape, at B=256, on an odd frame and on a frame whose
     ring runs in column strips;
  3d. the plans the reference serves and the card refused before: compile
     a 5-layer topology, one with a pool-4 layer and one too wide for a
     block (regroup_topologies) on the card in fp32 and int8, and hold
     them against their plain versions;
  4. the fp32 path: compile cifar10 at full width from seeded params, run
     B=256 through the fused plan and the vmem_budget=0 plan, and compare
     both with the plain-version forward;
  5. serve 24 requests of 1-256 frames with deadlines through
     Engine(plan, microbatch=256) with the flush loop on, and hold every
     answer against plan(x) and the plain-version forward;
  4b. the int8 and pow2 path on an on-grid B=256 batch: plan (a)
     QuantSpec(weight_bits=8, act_bits=8, int8_compute=True), fused and
     vmem_budget=0, bit for bit against the 8-bit fake-quant plan; plan
     (b) QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True,
     per_layer_bits=(8, 8, 8)), bit for bit against its fake-quant twin
     (fp32 kernels, fp32-decode head); plan (c) QuantSpec(pow2_weights=
     True) against the plain-version forward;
  5b. serve the same burst through Engine(plan (b)) and hold every answer
     bit for bit against plan (b)(x);
  4c. the fp32 gate: falcon-mamba at full width and depth in float32,
     drawn on the card; prefill (B=2, S=256) through the kernel against
     the same prefill through the plain scan, and prefill of S-1 tokens
     plus one decode_step against the full forward's last two rows;
  5c. serving at the config's dtype (bf16), full depth: prefill 4
     prompts of 512 tokens, then 32 greedy decode steps; ssm_scan
     launched once per layer per call, the plain scan never called;
  5d. the seed conv's own path, what the kernel bench runs on it: the
     seed kernel beside the single-layer kernel on cifar10 conv1;
  5e. multi-tenant serving under faults: verify_plan (plan and structure
     scopes) finds no error on every card plan the script builds; NaN
     quantizes to code 0 on the card as on the CPU, also through plan
     (b)'s integer head; then one Router serves cifar10 at full width to
     tenants "fp32" (the fused plan, weight 1) and "int8" (plan (b),
     weight 3) from 4 submitter threads, 48 requests of 1-256 frames each
     with 10 s deadlines, under faults scoped to "int8" (a dispatch error
     one retry heals, then a stall past its 2 s watchdog that demotes it
     to per_layer), with "fp32" hot-swapped to a seed-1 plan in flight and
     rolled back, and swaps to a NaN-weight plan (V301) and a lenet5 plan
     (serving surface) refused; every answer equals a direct call of the
     plan and rung that served it, the plain versions are never called;
  5f. the spatial pipeline: cifar10 at full width as a 3-stage plan (one
     conv layer a stage) in fp32 and with plan (b)'s quantization, on a
     stage mesh of three slots on cuda:0, each its own stream; B=256 as 4
     µbatches of 64 through run_pipelined, exact and boxed edges, serial
     and overlapped, and on a (3, 2) (stage, data) mesh: features bit for
     bit against the same plan run in sequence, logits against the
     1-stage fused plans (fp32 at the logits' tolerance, int8 bit for
     bit), S x M stage launches a call (fill and drain launch nothing);
     phase 5's 24 requests through Engine(plan, mesh=..., microbatch=64,
     n_microbatches=4), every answer equal to the plan on the padded group
     and the rung staying mesh; a DeviceLoss on the mesh rung demotes to
     fused with no retry, a StalledDispatch past its watchdog demotes and
     the abandoned attempt launches nothing; verify_plan(scopes=
     ("pipeline",)) finds no error on either plan and one V103 warning on
     the boxed runner; no plain version is called;
  5g. training on the card: lenet5 and cifar10 at full width on the
     port's synthetic data at B=128; the backward's precision at lenet5
     B=16 against a float64 composition (beside cuDNN's); one step's
     gradients (fp32 and 8-bit QAT) through the kernels' autograd against
     autograd of the plain composition on the card and against the CPU,
     every conv and FC gradient finite and nonzero; 60 lenet5 steps (loss below half its
     start, test accuracy above 0.5), 4/4-bit QAT (last loss below 0.7 of
     the first), pow2 QAT through the pow2 kernel; a cifar10
     ResilientTrainer run with failures at 3 steps equal to the clean run;
     classify_model on the trained lenet5; ms per training step and
     frames/s (fp32 and QAT 8), and the forward's device time against the
     backward's (profiler); the stream-conv kernels launch once per group a
     forward, no plain version is called, the phase takes under 60 s;
  5h. the static gate and the CNN examples on the card: the analysis
     CLI's run_verify over the five topologies x fp32 / quant / int8 in
     the plan, structure and resource scopes and the pipelined probe
     (pipeline scope) finds no error, and V203 reads each launch's
     requested shared memory (nonzero, at most 232,448 B); run_lint()
     over src/repro_torch finds nothing; examples/torch/dhm_cnn.py and
     serve_cnn.py run at their default sizes and print OK; the pyramid
     and single-layer kernels, fp32 and int8, launch, no plain version
     is called, the phase takes under 120 s;
  5i. the other nine LM families at full width (FAMILIES): an fp32 gate
     per config, drawn on the card from seed 0 at one pattern unit's depth
     (two layers where the pattern is one layer; whisper-base whole),
     B=2, S=64 (recurrentgemma-9b S=2085, so its 2048-slot rings wrap;
     internvl2-2b with 256 prefix embeddings, whisper-base with
     (2, 1500, 512) encoder frames; the MoE configs at their capacity
     factor 1.25, so experts drop tokens, and the full forward's MoE
     routed in the groups serving routes: the prompt, then the new token
     alone): prefill of S-1 tokens and one decode_step against the full
     forward's last two rows within the logits' tolerance; then bf16
     serving, prefill of 4 x 512 tokens and 32 greedy decode steps, at
     full depth where the weights fit (recurrentgemma-9b, qwen2.5-3b,
     stablelm-12b, internvl2-2b, whisper-base) and 2-4 layers otherwise,
     finite and shaped logits, with prefill ms, tokens/s, decode ms per
     step and peak memory; each config freed before the next; no port
     kernel launches (these architectures run none), under 180 s;
  5j. LM training: (a) falcon-mamba-7b at full width, 2 layers, fp32,
     B=2, S=256: train_loss and every gradient leaf through the scan
     kernel's autograd Function against autograd of the plain
     composition on the card (each leaf finite, nonzero, within a
     relative L2 error of 1e-4), remat='full' bit-equal with the kernel
     launched twice a layer, µbatches 1 and 2: the accumulated
     gradients within the same 1e-4, and after make_train_step's AdamW
     step the losses within rtol 1e-5 and the parameters within atol
     1e-5 but for at most 2e-4 of the elements; (b) bf16 training, 4
     layers, B=4, S=512, 10 AdamW steps (f32 master copy) on one
     synthetic_token_batches batch: the first loss within 1.5 of ln V,
     the last below the first, ms a step, tokens/s and a step's peak
     memory; (c) the nine other families one
     train_loss and gradient each at full width and 5i's gate depth,
     B=2, S=64, fp32 where parameters and gradients fit 60 GB: the loss
     equal to the full forward's f32 CE over the whole vocabulary, every
     leaf finite and nonzero but for expert slices no token reached;
     (d) examples/torch/quickstart.py, serve.py and train_lm.py at their
     default sizes print OK; (e) the scan kernel launches, the plain
     scan is never called; under 180 s. falcon-mamba's bf16 weights that
     phase 6 times are set aside during the phase and drawn again after
     it from the same seed;
  5k. (run last, after phase 6's profiles: it needs no profiler, and the
     pipeline sweep's profile once recorded no kernel after it) the dry
     run: launch/dryrun.py's run_cell at full width on the meta
     device for decode_32k of all ten LM configs and train_4k of
     qwen2.5-3b and falcon-mamba-7b, every status ok, the op log's FLOPs
     equal to FlopCounterMode's, beside model_flops, with trace_s; then
     the same recorder over real steps on the card, falcon-mamba-7b bf16
     training (5j's 4 layers, B=4, S=512, one step through the scan
     kernel) and qwen2.5-3b bf16 prefill of 4 x 512 at full depth: the
     card's log holds the meta trace's FLOPs and op counts per overload,
     the predicted peak (arguments + the log's peak live bytes) lies
     within 10 % of torch.cuda.max_memory_allocated above the cell's
     start, and the step timed without the recorder gives its TFLOP/s
     beside the dense bf16 peak; the scan kernel launches, the plain
     scan is never called;
  6. time each kernel, its plain version and the library call with CUDA
     events at main-path shapes, beside the card's bound; the fp32 and
     int8 conv kernels, pow2_matmul, the seed conv and their library calls
     also by their device time on the profiler's clock, with the conv
     kernels' CTAs per SM and the pow2 and seed wrappers' host time per
     launch (enqueue, no synchronise); the int8 convs also beside
     torch._int_mm of each layer's unfolded codes (the int8 products
     alone, device time); then the plans,
     and one serving micro-batch piece by piece, and the Engine's host
     split (submit, packing, watchdog, _stage, enqueue, _sync); the selective scan by
     its device time at the prefill, decode and one-sequence shapes, with
     the lanes its plan takes; then the LM's prefill and
     decode step, with their device time by kernel, and the same for
     recurrentgemma-9b and qwen2.5-3b in bf16 at full depth; then the pipeline
     sweep: the 3-stage fp32 plan on the stage mesh over M in {1, 2, 4, 8}
     x µbatch in {16, 32, 64, 128, 256} x overlap, in frames/s, beside the 1-stage
     fused plan and the stages run in sequence, with the profiler's union
     of kernel device time against its sum; the 2-stage plan's serial
     rows; fit_constants on the serial rows, estimate_pipeline beside each
     row and autotune_pipeline's pick; last, 5j's bf16 training step: the
     scan's forward against its recomputed backward at the step's shape,
     with the backward's peak memory, and the step's forward, backward
     and optimizer on CUDA events and on the profiler, with its busy
     share (the heaviest profiles last: after one, the profiler has
     dropped records of later sessions); every line with the card's name
     and power limit;
  7. print the {"kernels": [...]} line, then the {"ok": true, ...} line.

The launch counts are zeroed just before phase 4 and read just after
phase 5 (the fp32 path), zeroed just before phase 4b and read just after
phase 5b (the int8 and pow2 path), zeroed just before phase 4c's kernel
runs and read just after phase 5c (the LM path), and zeroed just before
phase 5d and read just after it, zeroed just before phase 5e's
traffic and read just after it, and zeroed just before phase 5f's
pipelined runs and read just after them (``launches_5f`` in the record),
and zeroed just before phase 5g's training runs and read just after them
(``launches_5g``), zeroed just before phase 5h's verification and
examples and read just after them (``launches_5h``), and zeroed just
before phase 5i and read just after it (``launches_5i``, all 0), and
zeroed just before phase 5j's kernel runs and read at its end
(``launches_5j``), and zeroed just before phase 5k's steps on the card
and read at its end (``launches_5k``): they show that each path went through its kernels. Every watchdog thread has ended before the record prints. Reference outputs that need kernel launches are computed
before a path's counts are zeroed.
Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense int8 on the tensor cores, and HBM3 bandwidth. The bound of
# a kernel is the larger of its operations over the peak for their type
# and its bytes over the bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_S = 3.35e12
SEED = 0
BATCH = 256
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5
# Logits of the compiled plans against the plain forward: the reference
# tests' own fp32 tolerance for logits (sums of 1024 features).
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-4
QUANT_BITS = 6
# Fake-quant outputs may sit one quant step apart where an fp32 sum in
# another order lands on the other side of a rounding boundary; more than
# this share of such elements would mean a real fault.
QUANT_MAX_STEP_SHARE = 1e-3
INT8_BITS = 8
# pow2_matmul's fp32 mode against its plain version; the activations sit
# on a 2^-4 grid, where every partial sum of these shapes is exact.
POW2_RTOL, POW2_ATOL = 1e-5, 1e-6
# (M, K, N) of the pow2 heads: cifar10's two FC layers, lenet5's two.
POW2_SHAPES = ((BATCH, 1024, 64), (BATCH, 64, 10), (BATCH, 800, 500), (BATCH, 500, 10))
# The selective scan against its plain version: (Bz, S, D, N, x/B/C dtype,
# with h0). The falcon-mamba layer at prefill in bf16 and f32, zero and
# carried state; decode (S = 1, carried state); D of 200 and 8200, which
# no CTA's channels divide; N = 64. Both sides compute in f32: the
# reference's own tolerance.
SSM_CASES = (("prefill bf16", 4, 512, 8192, 16, "bfloat16", False),
             ("prefill f32", 4, 512, 8192, 16, "float32", False),
             ("prefill f32 carried state", 4, 512, 8192, 16, "float32", True),
             ("decode bf16", 4, 1, 8192, 16, "bfloat16", True),
             ("decode f32", 4, 1, 8192, 16, "float32", True),
             ("ragged D", 2, 37, 200, 16, "float32", True),
             ("ragged D 8200", 2, 33, 8200, 16, "bfloat16", True),
             ("N 64", 2, 64, 1024, 64, "bfloat16", True))
# The scan's shapes on the LM path and one sequence: (Bz, S) at D 8192,
# N 16, bf16.
SSM_SHAPES = (("prefill", 4, 512), ("decode", 4, 1), ("one sequence", 1, 512))
# The seed conv: the kernel bench's cifar10-conv1 shape (8 frames of
# 32x32x3 SAME-padded to 36x36, K 5, N 32), the same at B=256, and an odd
# frame: (B, H, W, C, N, K); and a frame whose ring of K + 1 rows exceeds a
# block (column strips).
SEED_SHAPES = ((8, 36, 36, 3, 32, 5), (BATCH, 36, 36, 3, 32, 5), (3, 13, 17, 5, 7, 3))
SEED_STRIP_SHAPE = (2, 9, 3000, 16, 8, 5)
REGROUP_BATCH = 8
# SFU throughput for expf (16 per clock per SM) and the boost clock at
# which the published peaks above are taken.
SFU_PER_CLOCK_PER_SM, N_SMS, BOOST_CLOCK_HZ = 16, 132, 1.98e9
LM_ARCH = "falcon-mamba-7b"
LM_GATE_BATCH, LM_GATE_LEN = 2, 256  # the fp32 gate's prompt
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 32  # bf16 serving
# Phase 5e: requests per tenant, submitter threads, the requests' deadline
# and the int8 tenant's watchdog.
MT_REQUESTS, MT_SUBMITTERS, MT_DEADLINE_MS, MT_DISPATCH_TIMEOUT_S = 48, 4, 10_000.0, 2.0
HOST_SPLIT_BATCHES = 40  # phase 6: micro-batches the Engine's host split averages
# Phase 5f: the stage mesh and the µbatches B=256 is cut into; phase 6's
# pipeline sweep: µbatch counts, µbatch sizes (128 and 256 beside the
# serving sizes, to see whether the streams overlap once a stage's kernels
# outlast the host's enqueue), and the stage counts of the plans the cost
# model is fitted on.
PIPE_STAGES, PIPE_M = 3, 4
SWEEP_M, SWEEP_MB, SWEEP_STAGES = (1, 2, 4, 8), (16, 32, 64, 128, 256), (3, 2)
# Phase 5g: the training batch; the steps and data of the reference's own
# training tests (test_cnn.py::TestTraining); the pow2 QAT steps; the
# resilient run's steps, checkpoint period and failures; the timed steps
# and profiled repetitions; the phase's time limit.
TRAIN_BATCH = 128
TRAIN_STEPS, TRAIN_PER_CLASS = 60, 64
POW2_TRAIN_STEPS = 10
RESILIENT_STEPS, RESILIENT_CKPT, RESILIENT_FAILS = 30, 5, (7, 19, 23)
TRAIN_TIMED_STEPS, TRAIN_PROFILED = 10, 3
PHASE_5G_LIMIT_S = 60.0
# Phase 5h: the static gate's matrix and the two CNN examples, and its
# time limit.
PHASE_5H_LIMIT_S = 120.0
# Phase 5i, the other nine LM families at full width: (config, the fp32
# gate's depth and prompt, the bf16 serving depth). The gate's depth is
# one pattern unit where the pattern is longer than one layer, and
# recurrentgemma's prompt of 2085 tokens is longer than its 2048-token
# window and not a multiple of it, so its local layers' rings wrap. The
# serving depths are the full ones where the bf16 weights fit one card
# beside the rest of the script (granite-34b needs 94.5 GB, llama4-scout
# 215.5 GB, qwen3-moe 470.3 GB), and command-r-35b's is cut for time.
FAMILIES = (("recurrentgemma-9b", 3, 2085, 38), ("qwen2.5-3b", 2, 64, 36),
            ("stablelm-12b", 2, 64, 40), ("internvl2-2b", 2, 64, 24),
            ("whisper-base", 6, 64, 6), ("command-r-35b", 2, 64, 4),
            ("granite-34b", 2, 64, 4), ("llama4-scout-17b-a16e", 4, 64, 4),
            ("qwen3-moe-235b-a22b", 2, 64, 2))
FAM_GATE_BATCH = 2
FAM_BATCH, FAM_PROMPT, FAM_NEW = 4, 512, 32  # bf16 serving
PHASE_5I_LIMIT_S = 180.0
# Phase 6: the families whose prefill and decode are timed and profiled.
FAM_TIMED = ("recurrentgemma-9b", "qwen2.5-3b")
# Phase 5j, LM training: the fp32 gradient gate's depth (falcon-mamba-7b at
# full width, LM_GATE_BATCH x LM_GATE_LEN tokens); bf16 training's depth,
# batch, sequence and AdamW steps on one repeated batch, and the profiled
# repetitions; the nine other families' one step each at 5i's gate depth;
# the bytes of parameters and gradients below which a family trains in
# fp32 (the card's 80 GB less room for activations and the transient
# gradient buffers of a stacked leaf); each gradient leaf's relative L2
# error against the plain composition; the phase's time limit.
LM_TRAIN_GATE_LAYERS = 2
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_LEN, LM_TRAIN_STEPS = 4, 4, 512, 10
LM_TRAIN_PROFILED = 2
FAM_TRAIN_BATCH, FAM_TRAIN_LEN = 2, 64
FAM_TRAIN_FP32_BYTES = 60e9
LM_GRAD_REL_L2 = 1e-4
# µbatches against one batch after one AdamW step: the losses within
# rtol 1e-5 and the parameters within atol 1e-5 (the reference test's
# bounds) but for at most this share of the elements (the trainer
# allowance of tests/test_torch_training.py): AdamW divides each
# element's first moment by the root of its second, so where an
# element's gradient is near zero the last bits of the two sums' orders
# move its update by a visible share of the learning rate. The gradients
# themselves are held at LM_GRAD_REL_L2.
MB_PARAM_OFF_SHARE = 2e-4
PHASE_5J_LIMIT_S = 180.0
# 8-bit QAT gradients against another device's or another order's sums:
# each tensor within this relative L2 error, the features equal but for
# at most QUANT_MAX_STEP_SHARE elements one quant step apart (a float64
# conv sum alone moves cifar10's by 6.6e-3 on the CPU,
# tests/test_torch_training.py::test_qat8_gradients_move_with_the_last_bit_of_the_conv_sums).
QAT_GRAD_REL_L2 = 2e-2
# The backward's precision on lenet5's first layer at a small batch: the
# frames (normal, seed SEED) under which cuDNN's algorithm is measured
# against PyTorch's own convolution and a float64 composition.
PRECISION_BATCH = 16

# Phase 5k, the dry run: the full-width cells traced on meta (decode_32k
# for every config, train_4k for two), and the cells the same recorder
# watches on the card: (config, layers (None: all), batch, sequence,
# kind), falcon-mamba at 5j's bf16 training setting and qwen2.5-3b's bf16
# prefill at 5i's serving size; the predicted peak (arguments + the log's
# peak live bytes) within DRY_PEAK_RTOL of the allocator's; the dense bf16
# peak (NVIDIA data sheet, H100 SXM) for the achieved rate's share; the
# phase's time limit.
DRY_TRAIN_ARCHS = ("qwen2.5-3b", "falcon-mamba-7b")
DRY_CUDA_CELLS = (("falcon-mamba-7b", LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_LEN, "train"),
                  ("qwen2.5-3b", None, FAM_BATCH, FAM_PROMPT, "prefill"))
DRY_PEAK_RTOL = 0.10
PEAK_BF16_FLOPS = 989e12
PHASE_5K_LIMIT_S = 400.0


def regroup_topologies(cnn) -> dict:
    """Topologies the card refused before, in the classes of ``cnn`` (the
    port's or the reference's ``models.cnn``): five fused layers (the
    pyramid kernel takes four), a pool-4 layer (a window the kernels were
    not compiled for) and a frame too wide for one block of the
    single-layer kernel (column strips)."""
    spec = cnn.ConvLayerSpec
    return {
        "five": cnn.CNNTopology(
            "five", 32, 3, tuple(spec(n_out=16, kernel=3, padding="SAME", pool=0, act="relu")
                                 for _ in range(5)), (16,), 10),
        "pool4": cnn.CNNTopology(
            "pool4", 32, 3, (spec(n_out=16, kernel=3, padding="SAME", pool=4, act="relu"),
                             spec(n_out=32, kernel=3, padding="SAME", pool=2, act="tanh")),
            (16,), 10),
        "wide": cnn.CNNTopology(
            "wide", (12, 4100), 3, (spec(n_out=8, kernel=5, padding="SAME", pool=2, act="relu"),),
            (), 10),
    }


def precise_convs():
    """cuDNN off, TF32 off: the numerics of the training backward
    (``kernels/stream_conv/ops.py`` ``_backward_numerics``)."""
    import torch

    return torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def training_grads(topo, params, x, y, quant, *, plain=False) -> tuple:
    """(gradients, conv features) of the training loss (what
    ``paper/train_cnn.py``'s ``_loss_fn`` computes) at ``params`` on the
    device of ``x``: through the compiled plan, or ``plain``: native autograd of the per-layer
    composition of ``ref.py`` (cuDNN off) around the same compiled plan's
    baked params and head."""
    import contextlib

    import torch

    from repro_torch.core.dhm import QuantSpec, compile_dhm
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers
    from repro_torch.kernels.stream_conv.ref import stream_conv_pyramid_ref
    from repro_torch.tree_util import tree_flatten

    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().to(x.device).requires_grad_() for t in leaves]
    plan = compile_dhm(topo, treedef.unflatten(leaves), quant=QuantSpec(**quant), device=x.device)
    with precise_convs() if plain else contextlib.nullcontext():
        if plain:
            feats = stream_conv_pyramid_ref(
                x, [c["w"] for c in plan.conv_params], [c["b"] for c in plan.conv_params],
                layers=as_pyramid_layers(topo.conv_layers), act_bits=quant.get("act_bits"))
        else:
            feats = plan.features(x)
        logp = torch.log_softmax(plan.head_fn(feats), -1)
        loss = -torch.gather(logp, 1, y[:, None].long()).mean()
        grads = torch.autograd.grad(loss, leaves)
    return [g.detach() for g in grads], feats.detach()


def f64_grads(topo, params, x, y) -> list:
    """Gradients of the fp32 training loss through the same composition
    in float64 on the CPU."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.stream_conv.ref import _conv_nhwc
    from repro_torch.tree_util import tree_flatten

    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().cpu().double().requires_grad_() for t in leaves]
    p = treedef.unflatten(leaves)
    h = x.cpu().double()
    for spec, layer in zip(topo.conv_layers, p["conv"]):
        h = _conv_nhwc(h, layer["w"], stride=spec.stride, padding=spec.padding,
                       dtype=torch.float64) + layer["b"]
        h = torch.tanh(h) if spec.act == "tanh" else torch.maximum(h, h.new_zeros(()))
        pw, ps = spec.pool_cfg
        if pw:
            h = F.max_pool2d(h.permute(0, 3, 1, 2), pw, ps).permute(0, 2, 3, 1)
    h = h.reshape(h.shape[0], -1)
    for i, layer in enumerate(p["fc"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(p["fc"]) - 1:
            h = torch.tanh(h)
    loss = F.cross_entropy(h, y.cpu().long())
    return [g.float() for g in torch.autograd.grad(loss, leaves)]


def count_plain_versions() -> tuple:
    """Wrap the conv and pow2 wrappers' plain versions so that each call
    is counted: returns the counts by name and a function that puts the
    plain versions back."""
    from repro_torch.kernels.pow2_matmul import ops as kpow2_ops
    from repro_torch.kernels.stream_conv import ops as kconv_ops

    plain = {"stream_conv_block_ref": 0, "stream_conv_pyramid_ref": 0, "pow2_matmul_ref": 0,
             "pow2_matmul_int_ref": 0}
    mods = {n_: kconv_ops if "conv" in n_ else kpow2_ops for n_ in plain}
    plain_fns = {n_: getattr(mods[n_], n_) for n_ in plain}

    def counted(name_):
        def call(*args, **kwargs):
            plain[name_] += 1
            return plain_fns[name_](*args, **kwargs)
        return call

    def restore():
        for n_, fn_ in plain_fns.items():
            setattr(mods[n_], n_, fn_)

    for n_ in plain:
        setattr(mods[n_], n_, counted(n_))
    return plain, restore


def phase_5g(smi: str) -> dict:
    """Training on the card (phase 5g). Returns the launches of the
    training path's window."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.analysis.invariants import planned_launches
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dhm import compile_dhm
    from repro_torch.data import make_image_dataset
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import ops as kconv_ops
    from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec
    from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn
    from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine
    from repro_torch.paper.analysis import classify_model
    from repro_torch.paper.train_cnn import train_cnn, train_step
    from repro_torch.runtime import FaultInjector, ResilientTrainer
    from repro_torch.tree_util import tree_flatten
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    names = ("lenet5", "cifar10")
    modes = {"fp32": {}, "QAT 8": dict(weight_bits=8, act_bits=8)}
    topos = {n: ALL_TOPOLOGIES[n] for n in names}
    data = {n: make_image_dataset(hw=t.square_input_hw(), channels=t.input_channels, seed=SEED)
            for n, t in topos.items()}
    init = {n: init_cnn(torch.Generator().manual_seed(SEED), t, device=dev) for n, t in topos.items()}
    batch = {n: (data[n].x_train[:TRAIN_BATCH].to(dev), data[n].y_train[:TRAIN_BATCH].to(dev))
             for n in names}

    # References, before the counts are zeroed: autograd of the plain
    # composition on the card, and the CPU's gradients.
    refs = {}
    for n in names:
        xb, yb = batch[n]
        for m, q in modes.items():
            refs[n, m] = (training_grads(topos[n], init[n], xb, yb, q, plain=True),
                          training_grads(topos[n], init[n], xb.cpu(), yb.cpu(), q))
    # The backward's precision where cuDNN's own algorithm loses digits:
    # lenet5 at a small batch, against a float64 composition, through the
    # port's backward (PyTorch's own convolution) and through cuDNN under
    # deterministic, TF32-free flags.
    lenet = topos["lenet5"]
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(rng.normal(size=(PRECISION_BATCH, 28, 28, 1)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 10, size=PRECISION_BATCH)).to(dev)
    truth = f64_grads(lenet, init["lenet5"], xs, ys)

    def rel_err(grads):
        return max(float((a.cpu() - b).norm() / b.norm()) for a, b in zip(grads, truth))

    port_err = rel_err(training_grads(lenet, init["lenet5"], xs, ys, {})[0])
    numerics = kconv_ops._backward_numerics
    kconv_ops._backward_numerics = lambda t: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    try:
        cudnn_err = rel_err(training_grads(lenet, init["lenet5"], xs, ys, {})[0])
    finally:
        kconv_ops._backward_numerics = numerics
    cpu_err = rel_err(training_grads(lenet, init["lenet5"], xs.cpu(), ys.cpu(), {})[0])
    check(port_err <= 1e-5, f"5g lenet5 B={PRECISION_BATCH}: relative L2 {port_err} against float64")
    print(f"[5g] backward precision, lenet5 B={PRECISION_BATCH} (normal frames) against a float64 "
          f"composition, largest relative L2 of a gradient: the port (PyTorch's CUDA conv, TF32 "
          f"off) {port_err:.3e}, cuDNN (deterministic, TF32 off) {cudnn_err:.3e}, the CPU "
          f"{cpu_err:.3e}")
    torch.cuda.synchronize()

    plain, restore_plain = count_plain_versions()
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    try:
        # One step's gradients, held as in the card tests.
        for n in names:
            xb, yb = batch[n]
            want_launches = planned_launches(compile_dhm(topos[n], init[n], device=dev))
            for m, q in modes.items():
                before = sum(kconv.LAUNCHES.values())
                got, feats = training_grads(topos[n], init[n], xb, yb, q)
                n_launches = sum(kconv.LAUNCHES.values()) - before
                check(n_launches == want_launches,
                      f"5g {n} {m}: {n_launches} stream-conv launches for a forward whose plan "
                      f"plans {want_launches}")
                errs, steps = [], []
                for (want, want_feats), what in zip(refs[n, m], ("plain on the card", "the CPU")):
                    d = (feats.cpu() - want_feats.cpu()).abs()
                    if q:
                        steps.append(int((d > 1e-6).sum()))
                        check(float(d.max()) <= stream_quant_spec(8).scale + 1e-6
                              and steps[-1] <= QUANT_MAX_STEP_SHARE * d.numel(),
                              f"5g {n} {m}: features {steps[-1]} elements apart, max "
                              f"{float(d.max())}, against {what}")
                    worst = 0.0
                    for a, b in zip(got, want):
                        a, b = a.cpu(), b.cpu()
                        check(bool(torch.isfinite(a).all()) and bool((a != 0).any()),
                              f"5g {n} {m}: a gradient is zero or not finite")
                        if q:
                            rel = float((a - b).norm() / b.norm())
                            check(rel <= QAT_GRAD_REL_L2,
                                  f"5g {n} {m}: relative L2 {rel} against {what}")
                            worst = max(worst, rel)
                        else:
                            check(torch.allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL),
                                  f"5g {n} {m}: max |delta| {float((a - b).abs().max())} "
                                  f"against {what}")
                            worst = max(worst, float((a - b).abs().max()))
                    errs.append(worst)
                print(f"[5g] {n} {m} B={TRAIN_BATCH}: {len(got)} gradients finite and nonzero; "
                      f"{'largest relative L2' if q else 'max |delta|'} {errs[0]:.3e} against "
                      f"autograd of the plain composition on the card, {errs[1]:.3e} against the "
                      "CPU" + (f"; features one quant step apart at {steps[0]} and {steps[1]} of "
                               f"{feats.numel()} elements" if q else ""))

        # The reference's training tests on the card.
        topo = topos["lenet5"]
        ds = make_image_dataset(hw=28, channels=1, seed=0, n_train_per_class=TRAIN_PER_CLASS)
        trained = train_cnn(topo, steps=TRAIN_STEPS, dataset=ds, log_every=20, device=dev)
        first, last = trained.history[0]["loss"], trained.history[-1]["loss"]
        check(last < 0.5 * first and trained.float_accuracy > 0.5,
              f"5g lenet5 fp32: loss {first:.4f} -> {last:.4f}, accuracy {trained.float_accuracy}")
        qat = train_cnn(topo, steps=TRAIN_STEPS, dataset=ds, weight_bits=4, act_bits=4, log_every=20,
                        device=dev)
        q_first, q_last = qat.history[0]["loss"], qat.history[-1]["loss"]
        check(q_last < 0.7 * q_first and np.isfinite(q_last),
              f"5g lenet5 QAT 4/4: loss {q_first:.4f} -> {q_last:.4f}")
        p2_before = sum(kpow2.LAUNCHES.values())
        p2 = train_cnn(topo, steps=POW2_TRAIN_STEPS, dataset=ds, pow2_weights=True, log_every=1,
                       device=dev)
        p2_launches = sum(kpow2.LAUNCHES.values()) - p2_before
        check(p2_launches > 0 and all(np.isfinite(h["loss"]) for h in p2.history),
              f"5g lenet5 pow2 QAT: {p2_launches} pow2 launches, losses {p2.history}")
        print(f"[5g] lenet5 {TRAIN_STEPS} steps ({smi}): fp32 loss {first:.4f} -> {last:.4f}, "
              f"test accuracy {trained.float_accuracy:.4f}; QAT 4/4 loss {q_first:.4f} -> "
              f"{q_last:.4f}, accuracy {qat.float_accuracy:.4f}; pow2 QAT {POW2_TRAIN_STEPS} steps "
              f"loss {p2.history[0]['loss']:.4f} -> {p2.history[-1]['loss']:.4f} with "
              f"{p2_launches} pow2_matmul launches")

        # The resilient trainer on cifar10: failures replayed from checkpoints.
        topo = topos["cifar10"]
        xt, yt = data["cifar10"].x_train.to(dev), data["cifar10"].y_train.to(dev)
        cfg = AdamWConfig(weight_decay=0.01)
        sched = linear_warmup_cosine(3e-3, warmup_steps=20, total_steps=RESILIENT_STEPS)

        def batch_fn(step):
            idx = np.random.default_rng(SEED + step).integers(0, xt.shape[0], TRAIN_BATCH)
            idx = torch.from_numpy(idx).to(dev)
            return xt[idx], yt[idx]

        def step_fn(state, b, step):
            params, opt, loss, _ = train_step(*state, *b, sched(step), topo=topo, cfg=cfg)
            return (params, opt), {"loss": float(loss)}

        state0 = (init["cifar10"], adamw_init(init["cifar10"], cfg))
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        finals = {}
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckdir:
            for what, fails in (("clean", ()), ("faulty", RESILIENT_FAILS)):
                tr = ResilientTrainer(step_fn, batch_fn,
                                      CheckpointManager(os.path.join(ckdir, what)),
                                      ckpt_every=RESILIENT_CKPT,
                                      fault_injector=FaultInjector(fail_at_steps=fails))
                t0 = time.perf_counter()
                state, metrics = tr.run(state0, num_steps=RESILIENT_STEPS)
                finals[what] = (state, metrics, tr.restarts, time.perf_counter() - t0)
        (c_state, c_m, _, c_s), (f_state, f_m, f_restarts, f_s) = finals["clean"], finals["faulty"]
        dev_max = max(float((a - b).abs().max()) for a, b in
                      zip(tree_flatten(f_state[0])[0], tree_flatten(c_state[0])[0]))
        check(f_restarts == len(RESILIENT_FAILS) and dev_max <= 1e-6 and int(f_state[1].step) ==
              RESILIENT_STEPS, f"5g resilient cifar10: {f_restarts} restarts, max |delta| {dev_max}")
        print(f"[5g] cifar10 ResilientTrainer, {RESILIENT_STEPS} steps at B={TRAIN_BATCH}, "
              f"checkpoints every {RESILIENT_CKPT}: failures at {RESILIENT_FAILS} -> "
              f"{f_restarts} restarts, final params max |delta| {dev_max} against the clean run; "
              f"last loss {f_m['loss']:.4f} (clean {c_m['loss']:.4f}); {f_s:.2f} s against the "
              f"clean run's {c_s:.2f} s")
        torch.cuda.synchronize()
    finally:
        restore_plain()
    launches = {**kconv.LAUNCHES, **kpow2.LAUNCHES}
    check(all(v == 0 for v in plain.values()), f"phase 5g called plain versions: {plain}")
    check(launches["stream_conv_pyramid"] > 0 and launches["pow2_matmul"] > 0,
          f"the training path's launches: {launches}")

    stats = classify_model(trained.params, 3)
    print(f"[5g] classify_model(trained lenet5, 3 bits) (paper Table 1): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stats.as_percent().items())
          + f", multiplierless {100 * stats.multiplierless:.2f} % of {stats.total} conv weights")

    # ms per training step and frames/s; the forward's device time against
    # the backward's (profiler: forward alone, forward and backward, and the
    # whole step, each over TRAIN_PROFILED steps).
    def busy_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRAIN_PROFILED):
                fn()
            torch.cuda.synchronize()
        rows = {}
        for evt in prof.key_averages():
            if str(evt.device_type).endswith("CUDA"):
                us = getattr(evt, "self_device_time_total", None)
                us = evt.self_cuda_time_total if us is None else us
                rows[evt.key] = us / 1e3 / TRAIN_PROFILED
        return sum(rows.values()), rows

    t_checks = time.perf_counter() - t_phase
    for n in names:
        xb, yb = batch[n]
        for m, q in modes.items():
            st = [init[n], adamw_init(init[n], AdamWConfig(weight_decay=0.01))]

            def step():
                st[0], st[1], loss, _ = train_step(st[0], st[1], xb, yb, 1e-3, topo=topos[n],
                                                   cfg=AdamWConfig(weight_decay=0.01), **q)
                return loss

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_TIMED_STEPS):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
            fwd, fwd_rows = busy_ms(lambda: _forward_loss(topos[n], st[0], xb, yb, q))
            fb, fb_rows = busy_ms(lambda: training_grads(topos[n], st[0], xb, yb, q))
            full, _ = busy_ms(step)
            kern = sum(v for k, v in fwd_rows.items() if k.startswith(("sc_", "p2_")))
            print(f"[5g] {n} {m} training step at B={TRAIN_BATCH} ({smi}): {ms:.3f} ms "
                  f"(host clock, {TRAIN_TIMED_STEPS} steps), {TRAIN_BATCH / ms * 1e3:.0f} frames/s; "
                  f"device busy {full:.4f} ms a step: forward {fwd:.4f} ms ({kern:.4f} of it the "
                  f"stream-conv kernels), backward {fb - fwd:.4f} ms, optimizer {full - fb:.4f} ms")
            top = sorted(((v, k) for k, v in fb_rows.items() if k not in fwd_rows), reverse=True)
            for v, k in top[:4]:
                print(f"[5g]   backward {v:.4f} ms  {k[:90]}")
            if q:
                continue
            # What the backward's precision costs: the loss and its
            # gradient with the backward's convs on PyTorch's own CUDA
            # convolution (the port's) and on cuDNN (deterministic, TF32
            # off), host clock.
            grad_ms = {}
            numerics = kconv_ops._backward_numerics
            for what, ctx in (("port", numerics), ("cuDNN", lambda t: torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=True, allow_tf32=False))):
                kconv_ops._backward_numerics = ctx
                try:
                    training_grads(topos[n], st[0], xb, yb, q)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(TRAIN_TIMED_STEPS):
                        training_grads(topos[n], st[0], xb, yb, q)
                    torch.cuda.synchronize()
                    grad_ms[what] = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
                finally:
                    kconv_ops._backward_numerics = numerics
            print(f"[5g] {n} loss and gradient at B={TRAIN_BATCH} ({smi}): {grad_ms['port']:.3f} ms "
                  f"with the backward's convs on PyTorch's CUDA convolution, {grad_ms['cuDNN']:.3f} "
                  "ms on cuDNN (deterministic, TF32 off), host clock")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5G_LIMIT_S, f"phase 5g took {elapsed:.1f} s")
    print(f"[5g] training path launches: { {k: v for k, v in launches.items() if v} }; plain "
          f"versions called 0 times; phase {elapsed:.1f} s ({t_checks:.1f} s of checks, "
          f"{elapsed - t_checks:.1f} s of timing)")
    return launches


def run_example(phase: str, file: str, argv) -> float:
    """``examples/torch/<file>``'s ``main(argv)`` in this process, its
    output echoed under ``[phase]``; fails unless it ends with ``OK``.
    Returns its seconds (host clock, the card synchronized)."""
    import contextlib
    import importlib.util
    import io

    import torch

    spec = importlib.util.spec_from_file_location(f"example_{file[:-3]}",
                                                  os.path.join(ROOT, "examples", "torch", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[{phase}] {file} | {line}")
    check(lines[-1:] == ["OK"], f"{phase} examples/torch/{file} ended with {lines[-1:]}")
    return secs


def phase_5h(smi: str) -> dict:
    """The static gate and the CNN examples on the card (phase 5h). Returns
    the launches of the phase's window."""
    import tempfile

    import torch

    from repro_torch.analysis.cli import run_lint, run_verify
    from repro_torch.core.dhm.pipeline import join_watchdogs
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.models.cnn import ALL_TOPOLOGIES
    from repro_torch.paper import train_cnn

    dev = torch.device("cuda")

    t_phase = time.perf_counter()
    plain, restore_plain = count_plain_versions()
    results_dir = train_cnn.RESULTS_DIR
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        traces = []
        findings = run_verify(ALL_TOPOLOGIES, device=dev, traces=traces)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        errors = [f.render() for f in findings if f.is_error]
        check(not errors, f"5h run_verify on the card: {errors}")
        smem = [b for tr in traces for _, _, b in tr.phase_launches("features")]
        check(len(traces) == 3 * len(ALL_TOPOLOGIES) and smem
              and all(0 < b <= kconv.SMEM_LIMIT for b in smem),
              f"5h V203 read {len(smem)} launches of {len(traces)} plans: {sorted(set(smem))}")
        print(f"[5h] run_verify(5 topologies x fp32/quant/int8, scopes plan, structure, resource; "
              f"pipelined probes, scope pipeline) on the card: {len(findings)} findings, 0 errors; "
              f"V203 read the shared memory of {len(smem)} feature launches of {len(traces)} "
              f"plans, {min(smem)}-{max(smem)} B (limit {kconv.SMEM_LIMIT} B); "
              f"{t_verify:.2f} s ({smi})")
        t0 = time.perf_counter()
        lint = run_lint()
        check(lint == [], f"5h run_lint: {[f.render() for f in lint]}")
        print(f"[5h] run_lint() over src/repro_torch: no finding ({time.perf_counter() - t0:.2f} s)")
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as cache:
            train_cnn.RESULTS_DIR = cache
            ex_s = {f: run_example("5h", f, []) for f in ("dhm_cnn.py", "serve_cnn.py")}
    finally:
        train_cnn.RESULTS_DIR = results_dir
        restore_plain()
    launches = {**kconv.LAUNCHES, **kpow2.LAUNCHES}
    check(all(v == 0 for v in plain.values()), f"phase 5h called plain versions: {plain}")
    check(all(launches[k] > 0 for k in ("stream_conv_pyramid", "stream_conv_fused",
                                        "stream_conv_pyramid_int8", "stream_conv_fused_int8")),
          f"phase 5h launches: {launches}")
    check(join_watchdogs(30.0) == 0, "a watchdog thread is still running after phase 5h")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5H_LIMIT_S, f"phase 5h took {elapsed:.1f} s")
    print(f"[5h] examples at their default sizes on the card: "
          + ", ".join(f"{f} {t:.2f} s" for f, t in ex_s.items())
          + f"; launches { {k: v for k, v in launches.items() if v} }; plain versions called 0 "
          f"times; phase {elapsed:.1f} s ({smi})")
    return launches


def family_inputs(cfg, batch, seq, gen, dev) -> tuple:
    """Tokens (batch, seq) and the VLM prefix embeddings or enc-dec frames
    (normal x 0.1, as the reference's tests draw them), drawn from the CPU
    generator ``gen``, on ``dev``; and the prefix length."""
    import torch

    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen).to(dev)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = (torch.randn((batch, cfg.n_prefix_tokens, cfg.d_model),
                                           generator=gen) * 0.1).to(dev)
    if cfg.family == "encdec":
        kw["encoder_frames"] = (torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                            generator=gen) * 0.1).to(dev)
    return toks, kw, (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)


def moe_drops(x, p, spec) -> tuple:
    """(dropped, routed) (token, slot) pairs of one MoE layer's routing of
    ``x`` (B, T, d): the cumsum of ``moe._route_group``, counted."""
    import torch

    from repro_torch.models.moe import _expert_positions, _top_k

    probs = torch.softmax(torch.matmul(x.float(), p["router"].float()), dim=-1)
    ids = _top_k(probs, spec.top_k)[1].reshape(x.shape[0], -1)
    pos = _expert_positions(ids, spec.n_experts)
    return int((pos >= spec.capacity(x.shape[1])).sum()), ids.numel()


def phase_5i(smi: str) -> dict:
    """The other nine LM families on the card (phase 5i). Returns the
    launches of the phase's window (every kernel: 0)."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.models import moe as mmoe
    from repro_torch.models import transformer as T
    from repro_torch.models.accounting import param_bytes, param_count

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    mods = (kconv, kpow2, kscan, klegacy)

    @contextlib.contextmanager
    def served_groups():
        """The MoE of a full forward routed as serving routes it: the
        prompt's tokens as one group, the last token alone (decode routes
        one token, whose k slots never overflow); and the drops counted."""
        plain, drops = T.moe_apply, [0, 0]

        def split(p, spec, x):
            d, n = moe_drops(x[:, :-1], p, spec)
            drops[0] += d
            drops[1] += n
            y0, a0 = plain(p, spec, x[:, :-1])
            y1, _ = plain(p, spec, x[:, -1:])
            return torch.cat([y0, y1], dim=1), a0

        T.moe_apply = split
        try:
            yield drops
        finally:
            T.moe_apply = plain

    t_phase = time.perf_counter()
    for m in mods:
        m.reset_launch_counts()
    base_mem = torch.cuda.memory_allocated()
    for name, gate_depth, gate_len, serve_depth in FAMILIES:
        # (a) the fp32 gate at full width.
        t0 = time.perf_counter()
        arch = get_arch(name)
        cfg32 = dataclasses.replace(arch, n_layers=gate_depth, dtype="float32")
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
        toks, kw, n_pre = family_inputs(cfg32, FAM_GATE_BATCH, gate_len, gen, dev)
        moe = contextlib.nullcontext([0, 0])
        if cfg32.n_experts:
            moe = served_groups()
        with moe as drops:
            h, _, _ = T.forward_hidden(params, cfg32, toks, **kw)
        full = T.unembed(params, cfg32, h[:, -2:])
        del h
        pre, cache = T.prefill(params, cfg32, toks[:, :-1], max_len=n_pre + gate_len, **kw)
        dec, _ = T.decode_step(params, cfg32, toks[:, -1:], cache, n_pre + gate_len - 1)
        torch.cuda.synchronize()
        errs = []
        for what, got, want in (("prefill", pre, full[:, 0]), ("decode", dec, full[:, 1])):
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"5i {name} fp32 {what}: {tuple(got.shape)} vs {tuple(want.shape)} or not finite")
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
                  f"5i {name} fp32 {what} against the full forward: max |delta| {err}")
            errs.append(err)
        ring = ""
        if cfg32.window and gate_len - 1 > cfg32.window:
            ring = (f"; the local layers' {cfg32.window}-slot rings wrapped "
                    f"({gate_len - 1} prompt tokens)")
        moe_note = (f"; MoE at capacity factor {cfg32.capacity_factor} dropped {drops[0]} of "
                    f"{drops[1]} (token, slot) pairs of the prompt over its MoE layers" if cfg32.n_experts else "")
        print(f"[5i] {name} fp32 gate: {gate_depth} layers at full width "
              f"({param_count(cfg32):,} params, {param_bytes(cfg32) / 1e9:.1f} GB), "
              f"B={FAM_GATE_BATCH}, S={gate_len}{f' + {n_pre} prefix' if n_pre else ''}: "
              f"prefill(S-1) max |delta| {errs[0]:.3e}, decode_step {errs[1]:.3e} against the "
              f"full forward's last two rows (max |logit| {float(full.abs().max()):.3f})"
              f"{ring}{moe_note}; {time.perf_counter() - t0:.1f} s")
        del params, cache, full, pre, dec, toks, kw
        torch.cuda.empty_cache()

        # (b) bf16 serving at the config's dtype.
        t0 = time.perf_counter()
        cfg = dataclasses.replace(arch, n_layers=serve_depth)
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
        toks, kw, n_pre = family_inputs(cfg, FAM_BATCH, FAM_PROMPT, gen, dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        max_len = n_pre + FAM_PROMPT + FAM_NEW
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, max_len=max_len, **kw)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        check(logits.shape == (FAM_BATCH, cfg.vocab_size) and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()), f"5i {name} bf16 prefill logits")
        tok = logits.argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for i in range(FAM_NEW):
            logits, cache = T.decode_step(params, cfg, tok, cache, n_pre + FAM_PROMPT + i)
            tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        check(logits.shape == (FAM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"5i {name} bf16 decode logits")
        peak = torch.cuda.max_memory_allocated()
        n_tok = FAM_BATCH * (n_pre + FAM_PROMPT)
        print(f"[5i] {name} bf16 serving, {serve_depth} of {arch.n_layers} layers "
              f"({param_bytes(cfg) / 1e9:.1f} GB of weights, drawn in {t_init:.1f} s): prefill "
              f"{FAM_BATCH}x{FAM_PROMPT}{f' + {n_pre} prefix' if n_pre else ''} "
              f"{t_pre * 1e3:.1f} ms (first call, host clock), {n_tok / t_pre:.0f} tokens/s; "
              f"{FAM_NEW} greedy decode steps {t_dec / FAM_NEW * 1e3:.2f} ms per step; peak "
              f"allocated {peak / 1e9:.2f} GB ({(peak - base_mem) / 1e9:.2f} GB above the "
              f"phase's start) ({smi})")
        del params, cache, logits, tok, toks, kw
        torch.cuda.empty_cache()
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check(all(v == 0 for v in launches.values()), f"phase 5i launched kernels: {launches}")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5I_LIMIT_S, f"phase 5i took {elapsed:.1f} s")
    print(f"[5i] nine LM families: every fp32 gate within rtol {LOGITS_RTOL}, atol "
          f"{LOGITS_ATOL}; bf16 logits finite and shaped; launches {launches} (these "
          f"architectures run no port kernel); phase {elapsed:.1f} s ({smi})")
    return launches


def lm_loss_and_grads(params, cfg, batch, vocab_chunk=8192):
    """``train_loss`` of ``batch`` and its gradient for every leaf of
    ``params`` (the same leaves, detached and requiring grad)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree_util import tree_flatten

    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss, metrics = T.train_loss(treedef.unflatten(leaves), cfg, batch, vocab_chunk=vocab_chunk)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(
        torch.autograd.grad(loss, leaves))


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def leaf_paths(tree, path=()):
    """The path of every leaf of a dict/list tree, in ``tree_flatten``'s
    order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (i,))
    elif tree is not None:
        yield path


def moe_leaf_slices(params, cfg) -> list:
    """The MoE layers of the stack in the order a forward calls them: the
    path of the dict holding ``w_gate``, ``w_up`` and ``w_down``, and the
    unit index into those stacked leaves (None for a tail layer)."""
    from repro_torch.tree_util import tree_leaves

    pat = cfg.block_pattern
    out = []
    units = params["stack"]["units"]
    if units is not None:
        n_units = tree_leaves(units)[0].shape[0]
        for u in range(n_units):
            for i in range(len(pat)):
                if "w_gate" in units[i].get("ffn", {}):
                    out.append((("stack", "units", i, "ffn"), u))
    for t, p_t in enumerate(params["stack"]["tail"]):
        if "w_gate" in p_t.get("ffn", {}):
            out.append((("stack", "tail", t, "ffn"), None))
    return out


EVENTS_ROW = "CUDA events (the device's span)"


def device_busy_ms(fn, reps: int, tries: int = 3) -> tuple:
    """Device busy ms per call of ``fn`` (profiler, every CUDA kernel over
    ``reps`` calls after one warm call) and the ms by kernel name. The
    profiler has recorded no kernel at all on the H100 (phase 6's
    ``device_ms``), or dropped some of a call's (a count that is not a
    multiple of ``reps``); such a reading is taken again, and said so, up
    to ``tries`` times, then the calls are timed on CUDA events (the
    device's span, idle gaps included: the one row ``EVENTS_ROW``), and
    said so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows, count = {}, 0
        for evt in prof.key_averages():
            if str(evt.device_type).endswith("CUDA"):
                us = getattr(evt, "self_device_time_total", None)
                us = evt.self_cuda_time_total if us is None else us
                rows[evt.key] = us / 1e3 / reps
                count += evt.count
        if sum(rows.values()) > 0 and count % reps == 0:
            return sum(rows.values()), rows
        print(f"[6] the profiler recorded {count} kernels over {reps} calls (try {attempt} of "
              f"{tries}); reading again")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"[6] {ms:.4f} ms a call on CUDA events instead (the device's span)")
    return ms, {EVENTS_ROW: ms}


def phase_5j(smi: str) -> dict:
    """LM training on the card (phase 5j). Returns the launches of the
    phase's window."""
    import dataclasses
    import gc
    import math
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, synthetic_token_batches
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.ssm_scan import ops as kssm_ops
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_chunked_ref
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.launch.steps import VOCAB_CHUNK, make_train_step
    from repro_torch.models import moe as mmoe
    from repro_torch.models import ssm as mssm
    from repro_torch.models import transformer as T
    from repro_torch.models.accounting import param_bytes, param_count
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree_util import tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    mods = (kconv, kpow2, kscan, klegacy)
    t_phase = time.perf_counter()
    kernel_scan, dispatch_plain = mssm.ssm_scan, kssm_ops.ssm_scan_ref
    plain_calls = [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return dispatch_plain(*args, **kwargs)

    def plain_scan(x_, dt_, b_, c_, a_, d_skip_, h0_=None, **_):
        return ssm_scan_chunked_ref(x_, dt_, b_, c_, a_, d_skip_, h0_)

    def launches():
        return {k: v for m in mods for k, v in m.LAUNCHES.items()}

    arch = get_arch(LM_ARCH)
    kssm_ops.ssm_scan_ref = counted_plain
    try:
        # (a) the fp32 gradient gate. The plain composition's loss and
        # gradients first (no kernel), then the counts are zeroed.
        cfg32 = dataclasses.replace(arch, n_layers=LM_TRAIN_GATE_LAYERS, dtype="float32",
                                    remat="none")
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32, device=dev)
        batch = {"tokens": torch.randint(0, arch.vocab_size, (LM_GATE_BATCH, LM_GATE_LEN + 1),
                                         generator=gen).to(dev)}
        mssm.ssm_scan = plain_scan
        try:
            want_loss, _, want = lm_loss_and_grads(params, cfg32, batch)
            torch.cuda.synchronize()
        finally:
            mssm.ssm_scan = kernel_scan
        for m in mods:
            m.reset_launch_counts()
        plain_calls[0] = 0
        t0 = time.perf_counter()
        loss, _, grads = lm_loss_and_grads(params, cfg32, batch)
        torch.cuda.synchronize()
        check(kscan.LAUNCHES["ssm_scan"] == LM_TRAIN_GATE_LAYERS,
              f"5j gate: ssm_scan launched {kscan.LAUNCHES['ssm_scan']} times")
        check(abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss)),
              f"5j gate loss {float(loss)} against the plain composition's {float(want_loss)}")
        errs = []
        for g_, w_ in zip(grads, want):
            check(bool(torch.isfinite(g_).all()) and bool((g_ != 0).any()),
                  f"5j gate: a gradient leaf {tuple(g_.shape)} is not finite or is zero")
            errs.append(rel_l2(g_, w_))
        check(max(errs) <= LM_GRAD_REL_L2, f"5j gate gradients: relative L2 {max(errs)}")
        t_gate = time.perf_counter() - t0
        remat_loss, _, remat_grads = lm_loss_and_grads(
            params, dataclasses.replace(cfg32, remat="full"), batch)
        torch.cuda.synchronize()
        check(kscan.LAUNCHES["ssm_scan"] == 3 * LM_TRAIN_GATE_LAYERS,
              f"5j remat='full' launched ssm_scan {kscan.LAUNCHES['ssm_scan'] - 2} times")
        check(torch.equal(remat_loss, loss) and all(torch.equal(a, b) for a, b in
                                                    zip(remat_grads, grads)),
              "5j remat='full' is not bit-equal to remat='none'")
        del remat_grads, want
        # µbatch accumulation: the gradients of the two halves, each over
        # two, summed in f32 as make_train_step sums them, against the
        # whole batch's; then one make_train_step of each.
        halves = [{"tokens": t} for t in batch["tokens"].chunk(2)]
        acc = [torch.zeros_like(g) for g in grads]
        for half in halves:
            acc = [a + g / 2 for a, g in zip(acc, lm_loss_and_grads(params, cfg32, half)[2])]
        mb_grad = max(rel_l2(a, g) for a, g in zip(acc, grads))
        check(mb_grad <= LM_GRAD_REL_L2, f"5j µbatch gradients: relative L2 {mb_grad}")
        del acc, grads
        stepped = {}
        for mb in (1, 2):
            opt = adamw_init(params, AdamWConfig())
            p_new, opt_new, metrics = make_train_step(cfg32, microbatches=mb)(params, opt, batch)
            stepped[mb] = (float(metrics["loss"]), p_new)
            del opt, opt_new, p_new
        torch.cuda.synchronize()
        mb_loss = abs(stepped[2][0] - stepped[1][0]) / abs(stepped[1][0])
        diffs = [(a - b).abs() for a, b in zip(tree_leaves(stepped[1][1]),
                                                tree_leaves(stepped[2][1]))]
        mb_param = max(float(d.max()) for d in diffs)
        mb_off = sum(int((d > 1e-5).sum()) for d in diffs)
        n_el = sum(d.numel() for d in diffs)
        del diffs
        check(mb_loss <= 1e-5 and mb_off <= MB_PARAM_OFF_SHARE * n_el,
              f"5j µbatches 2 against 1: loss rtol {mb_loss}, {mb_off} of {n_el} parameters "
              f"outside atol 1e-5 (max |delta| {mb_param})")
        print(f"[5j] {LM_ARCH} fp32 gradient gate, {LM_TRAIN_GATE_LAYERS} layers at full width "
              f"({param_count(cfg32):,} params), B={LM_GATE_BATCH}, S={LM_GATE_LEN}: train_loss "
              f"{float(loss):.6f} (plain composition {float(want_loss):.6f}), {len(errs)} gradient "
              f"leaves finite and nonzero, relative L2 against autograd of the plain composition "
              f"max {max(errs):.3e}, median {sorted(errs)[len(errs) // 2]:.3e} ({t_gate:.2f} s); "
              f"remat='full' bit-equal, ssm_scan twice a layer; µbatches 2 against 1: "
              f"gradients relative L2 max {mb_grad:.3e}, after make_train_step's AdamW step "
              f"the loss rtol {mb_loss:.2e}, {mb_off} of {n_el:,} parameters outside atol 1e-5, "
              f"max |delta| {mb_param:.3e} (learning rate 3e-4)")
        del params, stepped, batch, halves, g_, w_
        gc.collect()
        torch.cuda.empty_cache()

        # (b) bf16 training at the config's dtype, remat and AdamW
        # (keep_master_copy), LM_TRAIN_STEPS steps on one repeated batch.
        cfg = dataclasses.replace(arch, n_layers=LM_TRAIN_LAYERS)
        opt_cfg = AdamWConfig(keep_master_copy=True)
        base_mem = torch.cuda.memory_allocated()
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
        opt = adamw_init(params, opt_cfg)
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_LEN,
                                   batch_size=LM_TRAIN_BATCH)
        batch = {"tokens": torch.from_numpy(
            next(synthetic_token_batches(stream, seed=SEED))["tokens"]).to(dev)}
        torch.cuda.synchronize()
        state_mem = torch.cuda.memory_allocated() - base_mem
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, opt_cfg=opt_cfg)
        losses, step_s = [], []
        before = kscan.LAUNCHES["ssm_scan"]
        for _ in range(LM_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        train_launches = kscan.LAUNCHES["ssm_scan"] - before
        peak = torch.cuda.max_memory_allocated() - base_mem - state_mem
        check(all(math.isfinite(x) for x in losses), f"5j bf16 losses {losses}")
        check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.5 and losses[-1] < losses[0],
              f"5j bf16 losses: first {losses[0]} (ln V {math.log(cfg.vocab_size):.3f}), "
              f"last {losses[-1]}")
        check(train_launches == 2 * LM_TRAIN_LAYERS * LM_TRAIN_STEPS,
              f"5j bf16 training launched ssm_scan {train_launches} times")
        ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
        n_tok = LM_TRAIN_BATCH * LM_TRAIN_LEN
        print(f"[5j] {LM_ARCH} bf16 training, {LM_TRAIN_LAYERS} of {arch.n_layers} layers at full "
              f"width ({param_count(cfg):,} params; weights, f32 master and moments "
              f"{state_mem / 1e9:.2f} GB), B={LM_TRAIN_BATCH}, S={LM_TRAIN_LEN}, remat "
              f"'{cfg.remat}', AdamW with the f32 master copy, {LM_TRAIN_STEPS} steps on one "
              f"synthetic_token_batches batch: losses {losses[0]:.4f} (ln V "
              f"{math.log(cfg.vocab_size):.4f}) -> {losses[-1]:.4f}; {ms:.2f} ms a step (host "
              f"clock, synchronized, median of steps 2-{LM_TRAIN_STEPS}; the first "
              f"{step_s[0] * 1e3:.1f}), {n_tok / ms * 1e3:.0f} tokens/s; ssm_scan "
              f"{train_launches} launches (2 a layer a step: the forward and remat's recompute); "
              f"a step's peak allocated {peak / 1e9:.2f} GB above the weights and optimizer "
              f"state ({smi})")

        del params, opt, batch, metrics
        torch.cuda.empty_cache()

        # (c) the nine other families: one train_loss and gradient each at
        # full width and 5i's gate depth, fp32 where parameters and
        # gradients fit FAM_TRAIN_FP32_BYTES, the config's dtype otherwise.
        plain_moe = T.moe_apply
        for name, gate_depth, _, _ in FAMILIES:
            t0 = time.perf_counter()
            fam = get_arch(name)
            cfg = dataclasses.replace(fam, n_layers=gate_depth, dtype="float32")
            fp32_bytes = 2 * param_bytes(cfg)
            if fp32_bytes > FAM_TRAIN_FP32_BYTES:
                cfg = dataclasses.replace(fam, n_layers=gate_depth)
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
            toks, kw, n_pre = family_inputs(cfg, FAM_TRAIN_BATCH, FAM_TRAIN_LEN + 1, gen, dev)
            reached = []

            def recording(p, spec, x):
                # The experts each MoE layer of the forward routes a token
                # to (remat's recompute is not recorded; nothing is saved).
                if len(reached) < n_moe:
                    with torch.no_grad():
                        probs = torch.softmax(torch.matmul(x.float(), p["router"].float()), -1)
                        ids = mmoe._top_k(probs, spec.top_k)[1].reshape(x.shape[0], -1)
                        keep = (mmoe._expert_positions(ids, spec.n_experts)
                                < spec.capacity(x.shape[1]))
                        reached.append(set(ids[keep].unique().tolist()))
                return plain_moe(p, spec, x)

            moe_slices = moe_leaf_slices(params, cfg) if cfg.n_experts else []
            n_moe = len(moe_slices)
            T.moe_apply = recording
            try:
                loss, metrics, grads = lm_loss_and_grads(params, cfg, {"tokens": toks, **kw})
            finally:
                T.moe_apply = plain_moe
            with torch.no_grad():
                h, _, aux = T.forward_hidden(params, cfg, toks[:, :-1], **kw)
                w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
                logits = torch.matmul(h[:, n_pre:].float(), w.float())
                full_ce = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                          toks[:, 1:].reshape(-1).long())
                want_loss = full_ce + 0.01 * aux
            torch.cuda.synchronize()
            check(abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss)),
                  f"5j {name} train_loss {float(loss)} against the full-vocab CE "
                  f"{float(want_loss)}")
            paths = {path: i for i, path in enumerate(leaf_paths(params))}
            unreached = 0
            expert_leaves = set()
            for (path, u), experts_hit in zip(moe_slices, reached):
                for key in ("w_gate", "w_up", "w_down"):
                    idx = paths[path + (key,)]
                    expert_leaves.add(idx)
                    g = grads[idx] if u is None else grads[idx][u]
                    for e in range(cfg.n_experts):
                        if not bool((g[e] != 0).any()):
                            check(e not in experts_hit,
                                  f"5j {name}: expert {e} of a layer got tokens and no gradient")
                            unreached += 1
            for i, g in enumerate(grads):
                check(bool(torch.isfinite(g).all()), f"5j {name}: a gradient leaf is not finite")
                check(i in expert_leaves or bool((g != 0).any()),
                      f"5j {name}: gradient leaf {i} {tuple(g.shape)} is zero")
            peak = torch.cuda.max_memory_allocated() - base_mem
            fits = "fit" if cfg.dtype == "float32" else "would not fit"
            print(f"[5j] {name} {cfg.dtype} (fp32 parameters and gradients, "
                  f"{fp32_bytes / 1e9:.1f} GB, {fits} {FAM_TRAIN_FP32_BYTES / 1e9:.0f} GB), "
                  f"{gate_depth} layers at full width, B={FAM_TRAIN_BATCH}, S={FAM_TRAIN_LEN}"
                  f"{f' + {n_pre} prefix' if n_pre else ''}: train_loss {float(loss):.6f} against "
                  f"the full forward's f32 CE over all {cfg.vocab_size:,} columns "
                  f"{float(want_loss):.6f} (last chunk {cfg.vocab_size % VOCAB_CHUNK or VOCAB_CHUNK} "
                  f"of {VOCAB_CHUNK} columns); {len(grads)} gradient leaves finite and nonzero"
                  + (f" but for {unreached} expert slices that no token reached (of "
                     f"{n_moe * cfg.n_experts} in {n_moe} MoE layers, each slice counted once "
                     f"for each of its 3 weights)" if cfg.n_experts else "")
                  + f"; peak allocated {peak / 1e9:.2f} GB above the family's start; "
                  f"{time.perf_counter() - t0:.1f} s")
            del params, grads, toks, kw, h, logits, w
            torch.cuda.empty_cache()

        # (d) the three LM examples at their default sizes.
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckpt:
            ex_s = {"quickstart.py": run_example("5j", "quickstart.py", []),
                    "serve.py": run_example("5j", "serve.py", []),
                    "train_lm.py": run_example("5j", "train_lm.py", ["--ckpt-dir", ckpt])}
    finally:
        mssm.ssm_scan = kernel_scan
        kssm_ops.ssm_scan_ref = dispatch_plain
    # (e) the window's launches: the scan kernel ran, the plain scan never.
    window = launches()
    check(window["ssm_scan"] > 0, f"phase 5j launches: {window}")
    check(plain_calls[0] == 0, f"phase 5j called the plain scan {plain_calls[0]} times")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5J_LIMIT_S, f"phase 5j took {elapsed:.1f} s")
    print(f"[5j] LM training: examples at their default sizes "
          + ", ".join(f"{f} {t:.2f} s" for f, t in ex_s.items())
          + f"; launches { {k: v for k, v in window.items() if v} }; the plain scan called 0 "
          f"times; phase {elapsed:.1f} s ({smi})")
    return window


def phase_5k(smi: str) -> dict:
    """The dry run (phase 5k). Returns the launches of the phase's window:
    (b)'s CUDA steps."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.ssm_scan import ops as kssm_ops
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze_hlo, op_counts, record, top_contributors
    from repro_torch.launch.mesh import make_production_mesh

    dev = torch.device("cuda")
    mods = (kconv, kpow2, kscan, klegacy)
    t_phase = time.perf_counter()

    # (a) the dry run at full width on meta, through run_cell (records and
    # logs in a temporary directory).
    cells = ([(a, "decode_32k") for a in list_archs()]
             + [(a, "train_4k") for a in DRY_TRAIN_ARCHS])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    results = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    saved_dir, dryrun.RESULTS_DIR = dryrun.RESULTS_DIR, results
    try:
        for arch, shape_name in cells:
            rec = dryrun.run_cell(arch, shape_name)
            check(rec["status"] == "ok", f"5k dry run {arch} x {shape_name}: {rec['status']}")
            st, mem = rec["step"], rec["memory"]
            check(st["flops"] == st["flop_counter_flops"] and
                  os.path.exists(dryrun.log_path(dryrun.cell_path(arch, shape_name, False))),
                  f"5k dry run {arch} x {shape_name}: {st}")
            print(f"[5k] dry run {arch} x {shape_name} on meta: {st['flops']:.4e} FLOPs "
                  f"(model_flops {rec['model_flops']:.4e}, x{st['flops'] / rec['model_flops']:.4f}), "
                  f"{st['hbm_bytes']:.4e} HBM bytes of the eager step, peak live "
                  f"{st['peak_live_bytes'] / 1e9:.2f} GB above {st['argument_bytes'] / 1e9:.2f} GB "
                  f"of arguments on one card; per device of 256: arguments "
                  f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
                  f"{mem['output_size_in_bytes'] / 1e9:.3f} GB; {st['ops']:,} ops, "
                  f"log {rec['hlo_bytes'] / 1e6:.1f} MB; trace_s {rec['trace_s']} ({smi})")
    finally:
        dryrun.RESULTS_DIR = saved_dir
        shutil.rmtree(results, ignore_errors=True)

    # (b) the recorder over real steps on the card, each against its meta
    # trace: the same FLOPs and ops, the predicted peak within
    # DRY_PEAK_RTOL of the allocator's; then the same step timed without
    # the recorder.
    mesh = make_production_mesh(device="cpu")
    dispatch_plain, plain_calls = kssm_ops.ssm_scan_ref, [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return dispatch_plain(*args, **kwargs)

    for m in mods:
        m.reset_launch_counts()
    kssm_ops.ssm_scan_ref = counted_plain
    try:
        for arch, layers, b, s, kind in DRY_CUDA_CELLS:
            cfg = get_arch(arch)
            cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg
            shape = ShapeConfig(f"5k_{kind}", s, b, kind)
            tr = dryrun.trace_cell(cfg, shape, mesh)
            want = analyze_hlo(tr.instrs)
            step, meta_args, _ = dryrun.cell_step(cfg, shape, mesh)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            args = dryrun.cell_args(cfg, shape, torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            arg_bytes = dryrun.tree_bytes(args)
            check(arg_bytes == dryrun.tree_bytes(meta_args),
                  f"5k {arch}: arguments {arg_bytes} B on the card, {dryrun.tree_bytes(meta_args)} "
                  f"B on meta")
            torch.cuda.reset_peak_memory_stats()
            before = kscan.LAUNCHES["ssm_scan"]
            out, rec, counter = record(step, *args, device=dev)
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated() - base
            launched = kscan.LAUNCHES["ssm_scan"] - before
            del out
            got = analyze_hlo(rec.instrs)
            check(got.flops == want.flops and counter == tr.counter_flops,
                  f"5k {arch} {kind}: {got.flops} FLOPs on the card, {want.flops} on meta")
            on_card, on_meta = op_counts(rec.instrs), op_counts(tr.instrs)
            diff = {k: (on_meta.get(k), on_card.get(k)) for k in set(on_card) | set(on_meta)
                    if on_card.get(k) != on_meta.get(k)}
            check(not diff, f"5k {arch} {kind}: op counts differ (meta, card): {diff}")
            predicted = arg_bytes + tr.peak_live_bytes
            off = predicted / measured - 1
            check(abs(off) <= DRY_PEAK_RTOL,
                  f"5k {arch} {kind}: predicted peak {predicted} B, the allocator's {measured} B")
            if arch == "falcon-mamba-7b":
                check(launched == 2 * cfg.n_layers, f"5k {arch}: ssm_scan launched {launched} times")
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            del out
            rate = want.flops / step_s
            print(f"[5k] {arch} {cfg.dtype} {kind}, {cfg.n_layers} layers at full width, B={b}, "
                  f"S={s}, on the card under the recorder: {len(rec.instrs):,} ops, per overload "
                  f"the meta trace's; {got.flops:.4e} FLOPs (meta {want.flops:.4e}, "
                  f"FlopCounterMode {counter:.4e}), {got.hbm_bytes:.4e} HBM bytes; peak: "
                  f"predicted {predicted / 1e9:.3f} GB (arguments {arg_bytes / 1e9:.3f} + live "
                  f"{tr.peak_live_bytes / 1e9:.3f}; the card's log {rec.peak_live_bytes / 1e9:.3f}), "
                  f"max_memory_allocated {measured / 1e9:.3f} GB ({off * 100:+.2f} %); "
                  f"ssm_scan launched {launched} times; the step without the recorder "
                  f"{step_s * 1e3:.2f} ms (host clock, synchronized): {rate / 1e12:.2f} TFLOP/s, "
                  f"{rate / PEAK_BF16_FLOPS * 100:.2f} % of the dense bf16 peak "
                  f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {got.hbm_bytes / step_s / 1e12:.3f} TB/s of "
                  f"logged traffic ({smi})")
            print(f"[5k] {arch} {kind}: the log's largest HBM-byte contributors: "
                  + "; ".join(f"{c['op']} at {c['site']} {c['shape']} {c['bytes'] / 1e9:.2f} GB"
                              for c in top_contributors(tr.instrs, 4)))
            del args, rec, tr, meta_args
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        kssm_ops.ssm_scan_ref = dispatch_plain
    window = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check(window["ssm_scan"] > 0, f"phase 5k launches: {window}")
    check(plain_calls[0] == 0, f"phase 5k called the plain scan {plain_calls[0]} times")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5K_LIMIT_S, f"phase 5k took {elapsed:.1f} s")
    print(f"[5k] dry run: launches { {k: v for k, v in window.items() if v} }; the plain scan "
          f"called 0 times; phase {elapsed:.1f} s ({smi})")
    return window


def time_lm_training(smi: str) -> None:
    """Phase 6's LM training rows: where a step of phase 5j's bf16 training
    (falcon-mamba-7b, LM_TRAIN_LAYERS layers, B x S) spends the card's
    time, and the scan's forward against its recomputed backward at that
    shape with the backward's peak memory. The heaviest profiles come
    last: after one, the profiler has dropped records of later sessions."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, synthetic_token_batches
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch.steps import VOCAB_CHUNK, make_train_step
    from repro_torch.models import ssm as mssm
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
    from repro_torch.tree_util import tree_flatten

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LM_TRAIN_LAYERS)
    opt_cfg = AdamWConfig(keep_master_copy=True)
    params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    opt = adamw_init(params, opt_cfg)
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_LEN,
                               batch_size=LM_TRAIN_BATCH)
    batch = {"tokens": torch.from_numpy(
        next(synthetic_token_batches(stream, seed=SEED))["tokens"]).to(dev)}
    step = make_train_step(cfg, opt_cfg=opt_cfg)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()

    # The scan alone at the training shape: its inputs captured from one
    # forward; the forward kernel against the recomputed backward.
    captured = []
    kernel_scan = mssm.ssm_scan

    def capture(*args, **kwargs):
        if not captured:
            captured.append(tuple(None if a is None else a.detach() for a in args))
        return kernel_scan(*args, **kwargs)

    mssm.ssm_scan = capture
    try:
        with torch.no_grad():
            T.train_loss(params, cfg, batch, vocab_chunk=VOCAB_CHUNK)
    finally:
        mssm.ssm_scan = kernel_scan
    s_in = captured[0]
    g_y = torch.randn(tuple(s_in[0].shape), generator=torch.Generator().manual_seed(SEED)).to(dev)

    def scan_fwd_only():
        with torch.no_grad():
            return ssm_scan(*s_in)

    def scan_fwd_bwd():
        leaves = [t.detach().requires_grad_() for t in s_in[:6]]
        y, _ = ssm_scan(*leaves)
        return torch.autograd.grad(y, leaves, g_y)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bwd = torch.cuda.memory_allocated()
    scan_fwd_bwd()
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - before_bwd
    s_fwd, f_rows = device_busy_ms(scan_fwd_only, LM_TRAIN_PROFILED)
    s_fb, s_rows = device_busy_ms(scan_fwd_bwd, LM_TRAIN_PROFILED)
    shape = tuple(s_in[0].shape) + (s_in[2].shape[-1],)
    print(f"[6] the scan at 5j's training shape (Bz, S, D, N) = {shape}, x {s_in[0].dtype} "
          f"({smi}, {'CUDA events' if EVENTS_ROW in f_rows else 'profiler'}): forward (the "
          f"kernel) {s_fwd:.4f} ms device; forward and recomputed backward (the reference's "
          f"composition under autograd, {len(s_rows)} kernel names) {s_fb:.4f} ms, the "
          f"backward {s_fb - s_fwd:.4f} ms ({(s_fb - s_fwd) / s_fwd:.0f}x the forward); the "
          f"backward's peak {bwd_peak / 1e9:.2f} GB above its inputs (a (Bz, S, D, N) f32 "
          f"tensor is {math.prod(shape) * 4 / 1e9:.2f} GB)")
    del captured, s_in, g_y

    # A step's parts on CUDA events (the device's span of each), then on
    # the profiler: the forward, the forward and backward, the whole step.
    def fwd():
        with torch.enable_grad():
            leaves, treedef = tree_flatten(params)
            leaves = [t.detach().requires_grad_() for t in leaves]
            return T.train_loss(treedef.unflatten(leaves), cfg, batch, vocab_chunk=VOCAB_CHUNK)[0]

    def fwd_bwd():
        return lm_loss_and_grads(params, cfg, batch)

    def full_step():
        _, _, g = lm_loss_and_grads(params, cfg, batch)
        g, _ = clip_by_global_norm(g, 1.0)
        return adamw_update(tree_flatten(params)[1].unflatten(g), opt, params, opt_cfg, 3e-4)

    spans = []
    for _ in range(LM_TRAIN_PROFILED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.enable_grad():
            leaves, treedef = tree_flatten(params)
            leaves = [t.detach().requires_grad_() for t in leaves]
            loss, _ = T.train_loss(treedef.unflatten(leaves), cfg, batch, vocab_chunk=VOCAB_CHUNK)
        ev[1].record()
        g = torch.autograd.grad(loss, leaves)
        ev[2].record()
        g, _ = clip_by_global_norm(treedef.unflatten(list(g)), 1.0)
        adamw_update(g, opt, params, opt_cfg, 3e-4)
        ev[3].record()
        torch.cuda.synchronize()
        spans.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del loss, leaves, g
    span = [sum(x[i] for x in spans) / len(spans) for i in range(3)]
    print(f"[6] 5j's bf16 training step ({LM_TRAIN_LAYERS} layers, B={LM_TRAIN_BATCH}, "
          f"S={LM_TRAIN_LEN}) on CUDA events ({smi}): forward {span[0]:.3f} ms, backward "
          f"{span[1]:.3f} ms, optimizer {span[2]:.3f} ms (each the device's span, mean of "
          f"{LM_TRAIN_PROFILED} steps)")
    t_fwd, _ = device_busy_ms(fwd, LM_TRAIN_PROFILED)
    t_fb, fb_rows = device_busy_ms(fwd_bwd, LM_TRAIN_PROFILED)
    t_full, full_rows = device_busy_ms(full_step, LM_TRAIN_PROFILED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_TRAIN_PROFILED):
        full_step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / LM_TRAIN_PROFILED
    if EVENTS_ROW in full_rows:
        busy = "busy share not measured (the profiler recorded no kernel)"
    else:
        busy = f"busy {t_full:.3f} ms of {ms:.2f} ms (host clock), busy share {t_full / ms:.3f}"
    print(f"[6] 5j's bf16 training step on the profiler ({smi}, {LM_TRAIN_PROFILED} "
          f"repetitions): {busy}; forward {t_fwd:.3f} ms, backward {t_fb - t_fwd:.3f} ms, "
          f"optimizer {t_full - t_fb:.3f} ms device")
    for v, k in sorted(((v, k) for k, v in fb_rows.items()), reverse=True)[:6]:
        print(f"[6]   forward+backward {v:.3f} ms  {k[:90]}")


def _forward_loss(topo, params, x, y, quant):
    """The training loss with its autograd graph built, no backward."""
    import torch

    from repro_torch.paper.train_cnn import _loss_fn
    from repro_torch.tree_util import tree_map

    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        return _loss_fn(p, topo, x, y, quant.get("weight_bits"), quant.get("act_bits"), False)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)

    import numpy as np
    import torch.nn.functional as F

    import dataclasses

    from repro_torch.analysis.verify import verify_plan
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.dhm import (
        DispatchError,
        Engine,
        FaultPlan,
        QuantSpec,
        Router,
        StalledDispatch,
        SwapRejected,
        compile_dhm,
    )
    from repro_torch.core.dhm.pipeline import join_watchdogs
    from repro_torch.core.dhm.fusion import plan_fusion_groups
    from repro_torch.core.quant.fixed_point import dynamic_spec, quantize_fixed
    from repro_torch.core.quant.packing import unpack_codes_u4
    from repro_torch.core.quant.pow2 import decode_pow2
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.pow2_matmul import ops as kpow2_ops
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.pow2_matmul import (
        pow2_matmul,
        pow2_matmul_int_ref,
        pow2_matmul_ref,
        quantize_weights,
    )
    from repro_torch.kernels.ssm_scan import ops as kssm_ops
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import ops as kconv_ops
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.kernels.stream_conv import (
        stream_conv2d,
        stream_conv2d_ref,
        stream_conv2d_seed,
        stream_conv_block,
        stream_conv_block_ref,
        stream_conv_pyramid,
        stream_conv_pyramid_ref,
    )
    from repro_torch.kernels.stream_conv.epilogue import (
        Int8Scales,
        quantize_stream,
        stream_quant_spec,
    )
    from repro_torch.kernels.stream_conv.ops import _pad_same
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry
    from repro_torch.models import ssm as mssm
    from repro_torch.models import transformer as T
    from repro_torch.models.accounting import model_flops, param_bytes, param_count
    from repro_torch.models.cnn import ALL_TOPOLOGIES, cnn_apply_reference, init_cnn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, device 0: {kind}, "
          f"count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _nvcc.build(["stream_conv", "pow2_matmul", "ssm_scan", "stream_conv_seed"])
    print(f"[2] nvcc build: {time.perf_counter() - t0:.1f} s"
          + ("" if logs else " (library already built in this checkout)"))
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"[2] {name}.cu: {line}")
    kconv._library()  # loads them and checks the descriptor layouts
    kpow2._library()
    kscan._library()
    klegacy._library()

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32).to(dev)

    params = {name: init_cnn(gen, topo, device=dev) for name, topo in ALL_TOPOLOGIES.items()}

    def compare_quant(out, ref, bits, what):
        step = stream_quant_spec(bits).scale
        d = (out - ref).abs()
        off = int((d > 1e-6).sum())
        check(float(d.max()) <= step + 1e-6,
              f"{what}: max |delta| {float(d.max())} above one quant step {step}")
        share = off / d.numel()
        check(share <= QUANT_MAX_STEP_SHARE,
              f"{what}: {off} of {d.numel()} elements one step apart")
        return float(d.max()), off

    # -- 3. each kernel against its plain version ------------------------------
    errs = {"stream_conv_pyramid": 0.0, "stream_conv_fused": 0.0}
    for name, topo in ALL_TOPOLOGIES.items():
        h, w = topo.input_shape
        x = randn(BATCH, h, w, topo.input_channels)
        idxs = tuple(range(len(topo.conv_layers)))
        for grp in plan_fusion_groups(topo, idxs):
            layers = [topo.conv_layers[i] for i in grp.layers]
            ws = [params[name]["conv"][i]["w"] for i in grp.layers]
            bs = [params[name]["conv"][i]["b"] for i in grp.layers]
            check(grp.fused, f"{name}: expected one fused group, got {grp}")
            block_list = [grp.block_rows] + ([1] if name in ("cifar10", "lenet5") else [])
            for bits in (None, QUANT_BITS):
                for br in block_list:
                    out = stream_conv_pyramid(x, ws, bs, layers=layers,
                                              act_bits=bits, block_rows=br)
                    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers),
                                                  act_bits=bits)
                    torch.cuda.synchronize()
                    check(out.shape == ref.shape, f"{name} pyramid shape {out.shape} vs {ref.shape}")
                    what = f"pyramid {name} layers {grp.layers} block_rows {br} act_bits {bits}"
                    if bits is None:
                        err = float((out - ref).abs().max())
                        check(torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL),
                              f"{what}: max |delta| {err}")
                        errs["stream_conv_pyramid"] = max(errs["stream_conv_pyramid"], err)
                        print(f"[3] {what}: shape {tuple(out.shape)} max |delta| {err:.3e}")
                    else:
                        err, off = compare_quant(out, ref, bits, what)
                        print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} "
                              "elements one step apart")
    for name in ("cifar10", "cifar10_full", "cifar10_strided"):
        topo = ALL_TOPOLOGIES[name]
        h, w = topo.input_shape
        c = topo.input_channels
        for li, spec in enumerate(topo.conv_layers):
            x = randn(BATCH, h, w, c)
            p = params[name]["conv"][li]
            kw = dict(padding=spec.padding, stride=spec.stride, act=spec.act,
                      pool=spec.pool, pool_stride=spec.pool_stride)
            for bits in (None, QUANT_BITS):
                out = stream_conv_block(x, p["w"], p["b"], act_bits=bits, **kw)
                ref = stream_conv_block_ref(x, p["w"], p["b"], act_bits=bits, **kw)
                torch.cuda.synchronize()
                check(out.shape == ref.shape, f"{name} layer {li}: {out.shape} vs {ref.shape}")
                what = f"single-layer {name} layer {li} act_bits {bits}"
                if bits is None:
                    err = float((out - ref).abs().max())
                    check(torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL),
                          f"{what}: max |delta| {err}")
                    errs["stream_conv_fused"] = max(errs["stream_conv_fused"], err)
                    print(f"[3] {what}: shape {tuple(out.shape)} max |delta| {err:.3e}")
                else:
                    err, off = compare_quant(out, ref, bits, what)
                    print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} "
                          "elements one step apart")
            h, w = spec.out_hw(h, w)
            c = spec.n_out

    def bake_int8(w, bits):
        spec = dynamic_spec(w, bits)
        return quantize_fixed(w, spec).to(torch.int8).contiguous(), spec.scale

    def compare_int8(out, ref, act, what):
        """Equal on relu layers; where tanh follows, elements may sit one
        quant step apart (the card's tanhf against torch.tanh), counted."""
        if act == "relu":
            check(torch.equal(out, ref), f"{what}: max |delta| {float((out - ref).abs().max())}")
            return 0.0, 0
        return compare_quant(out, ref, INT8_BITS, what)

    errs.update(stream_conv_pyramid_int8=0.0, stream_conv_fused_int8=0.0,
                pow2_matmul=0.0, pow2_matmul_int=0.0)
    for name, topo in ALL_TOPOLOGIES.items():
        h, w = topo.input_shape
        x = randn(BATCH, h, w, topo.input_channels)
        (grp,) = plan_fusion_groups(topo, tuple(range(len(topo.conv_layers))), elem_bytes=1)
        layers = [topo.conv_layers[i] for i in grp.layers]
        baked = [bake_int8(params[name]["conv"][i]["w"], INT8_BITS) for i in grp.layers]
        ws = [c for c, _ in baked]
        bs = [params[name]["conv"][i]["b"] for i in grp.layers]
        scales = tuple(Int8Scales(in_bits=INT8_BITS, w_scale=sc) for _, sc in baked)
        out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=INT8_BITS,
                                  int8_scales=scales, block_rows=grp.block_rows)
        ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers),
                                      act_bits=INT8_BITS, int8_scales=scales)
        torch.cuda.synchronize()
        check(out.shape == ref.shape, f"{name} int8 pyramid shape {out.shape} vs {ref.shape}")
        what = f"int8 pyramid {name} layers {grp.layers} block_rows {grp.block_rows}"
        err, off = compare_int8(out, ref, layers[0].act, what)
        errs["stream_conv_pyramid_int8"] = max(errs["stream_conv_pyramid_int8"], err)
        print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} elements one step apart")
    for name in ("cifar10", "cifar10_full", "cifar10_strided"):
        topo = ALL_TOPOLOGIES[name]
        h, w = topo.input_shape
        c = topo.input_channels
        for li, spec in enumerate(topo.conv_layers):
            x = randn(BATCH, h, w, c)
            wq, wsc = bake_int8(params[name]["conv"][li]["w"], INT8_BITS)
            b = params[name]["conv"][li]["b"]
            kw = dict(padding=spec.padding, stride=spec.stride, act=spec.act, pool=spec.pool,
                      pool_stride=spec.pool_stride, act_bits=INT8_BITS,
                      int8_scales=Int8Scales(in_bits=INT8_BITS, w_scale=wsc))
            out = stream_conv_block(x, wq, b, **kw)
            ref = stream_conv_block_ref(x, wq, b, **kw)
            torch.cuda.synchronize()
            check(out.shape == ref.shape, f"{name} int8 layer {li}: {out.shape} vs {ref.shape}")
            what = f"int8 single-layer {name} layer {li}"
            err, off = compare_int8(out, ref, spec.act, what)
            errs["stream_conv_fused_int8"] = max(errs["stream_conv_fused_int8"], err)
            print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} elements one "
                  "step apart")
            h, w = spec.out_hw(h, w)
            c = spec.n_out
    pow2_cases = {}
    for m, k, n in POW2_SHAPES:
        wt = randn(k, n) * (2.0 / k) ** 0.5
        xg = torch.clamp(torch.round(randn(m, k) * 16) / 16, -2.0, 1.9375)
        packed, scale = quantize_weights(wt)
        pow2_cases[(m, k, n)] = (xg, packed, scale)
        out = pow2_matmul(xg, packed, scale)
        ref = pow2_matmul_ref(xg, packed, scale)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=POW2_RTOL, atol=POW2_ATOL),
              f"pow2_matmul fp32 {(m, k, n)}: max |delta| {err}")
        errs["pow2_matmul"] = max(errs["pow2_matmul"], err)
        xspec = stream_quant_spec(INT8_BITS)
        out = pow2_matmul(xg, packed, scale, x_spec=xspec)
        ref = pow2_matmul_int_ref(xg, packed, scale, x_spec=xspec)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"pow2_matmul integer {(m, k, n)}: max |delta| "
              f"{float((out - ref).abs().max())}")
        print(f"[3] pow2_matmul {(m, k, n)}: fp32 decode max |delta| {err:.3e}, integer mode equal")

    # -- 3c. the selective scan and the seed conv against their plain versions --
    errs.update(ssm_scan=0.0, stream_conv2d_seed=0.0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def ssm_inputs(bz, s, d, n, dtype, with_h0):
        x = (randn(bz, s, d) * 0.5).to(dtypes[dtype])
        dt = F.softplus(randn(bz, s, d))
        b, c = randn(bz, s, n).to(dtypes[dtype]), randn(bz, s, n).to(dtypes[dtype])
        a = -torch.exp(randn(d, n) * 0.3)
        return x, dt, b, c, a, randn(d), (randn(bz, d, n) if with_h0 else None)

    for what, bz, s, d, n, dtype, with_h0 in SSM_CASES:
        args = ssm_inputs(bz, s, d, n, dtype, with_h0)
        y, h_last = ssm_scan(*args)
        y_ref, h_ref = ssm_scan_ref(*args)
        torch.cuda.synchronize()
        err = max(float((y - y_ref).abs().max()), float((h_last - h_ref).abs().max()))
        for name_, got, want in (("y", y, y_ref), ("h_last", h_last, h_ref)):
            check(got.shape == want.shape and torch.allclose(got, want, rtol=FP32_RTOL,
                                                             atol=FP32_ATOL),
                  f"ssm_scan {what} {name_}: max |delta| {float((got - want).abs().max())}")
        errs["ssm_scan"] = max(errs["ssm_scan"], err)
        print(f"[3c] ssm_scan {what} (Bz {bz}, S {s}, D {d}, N {n}, {dtype}, "
              f"h0 {'carried' if with_h0 else 'zero'}): max |delta| {err:.3e}")
    for b_, h_, w_, c_, n_, k_ in SEED_SHAPES:
        xs, wt = randn(b_, h_, w_, c_), randn(k_, k_, c_, n_) * 0.2
        out = stream_conv2d_seed(xs, wt.reshape(k_ * k_, c_, n_), k=k_)
        ref = stream_conv2d_ref(xs, wt)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(out.shape == ref.shape and torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL),
              f"seed conv {(b_, h_, w_, c_, n_, k_)}: max |delta| {err}")
        errs["stream_conv2d_seed"] = max(errs["stream_conv2d_seed"], err)
        print(f"[3c] seed conv {b_}x{h_}x{w_}x{c_}, K {k_}, N {n_}: max |delta| {err:.3e}")
    b_, h_, w_, c_, n_, k_ = SEED_STRIP_SHAPE
    strips = klegacy.seed_tile(b_, h_, w_, c_, n_, k_, n_sms=n_sms,
                               resident=klegacy._resident)["strips"]
    xs, wt = randn(b_, h_, w_, c_), randn(k_, k_, c_, n_) * 0.2
    before = klegacy.LAUNCHES["stream_conv2d_seed"]
    out = stream_conv2d_seed(xs, wt.reshape(k_ * k_, c_, n_), k=k_)
    ref = stream_conv2d_ref(xs, wt)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(len(strips) > 1 and klegacy.LAUNCHES["stream_conv2d_seed"] == before + len(strips),
          f"seed conv over column strips: {len(strips)} strips")
    check(torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL),
          f"seed conv {SEED_STRIP_SHAPE} over {len(strips)} column strips: max |delta| {err}")
    errs["stream_conv2d_seed"] = max(errs["stream_conv2d_seed"], err)
    print(f"[3c] seed conv {b_}x{h_}x{w_}x{c_}, K {k_}, N {n_} in {len(strips)} column strips: "
          f"max |delta| {err:.3e}")

    # -- 3d. plans the reference serves that the card refused before ------------
    # Compiled on the card: the fusion groups split for the pyramid kernel
    # (at most MAX_PYRAMID_LAYERS layers within SMEM_LIMIT), the pool-4
    # windows on the run-time window path, the wide frame in column
    # strips. fp32 logits against the plain forward on the card; the int8
    # plan's features against the same plan on the CPU (the plain
    # versions): equal, but where tanh follows (counted, as in phase 3).
    from repro_torch.models import cnn as tcnn

    card_plans = []  # (what, plan) of every card plan the script builds: phase 5e verifies them
    for name, topo in regroup_topologies(tcnn).items():
        h, w = topo.input_shape
        x = randn(REGROUP_BATCH, h, w, topo.input_channels)
        rparams = init_cnn(torch.Generator().manual_seed(SEED), topo, device=dev)
        kconv.reset_launch_counts()
        rplan = compile_dhm(topo, rparams, quant=QuantSpec())
        groups = [g.layers for g in rplan.fusion_groups]
        check(all(len(g) <= kconv.MAX_PYRAMID_LAYERS for g in groups), f"{name}: groups {groups}")
        logits_r = rplan(x)
        want = cnn_apply_reference(rparams, topo, x)
        torch.cuda.synchronize()
        err = float((logits_r - want).abs().max())
        check(logits_r.shape == want.shape and bool(torch.isfinite(logits_r).all())
              and torch.allclose(logits_r, want, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"{name} fp32 plan: max |delta| {err} against the plain forward")
        fp32_launches = {k: v for k, v in kconv.LAUNCHES.items() if v}
        q8 = QuantSpec(weight_bits=8, act_bits=8, int8_compute=True)
        cpu_params = {k: [{kk: vv.cpu() for kk, vv in p.items()} for p in v]
                      for k, v in rparams.items()}
        want8 = compile_dhm(topo, cpu_params, quant=q8, device="cpu").features(x.cpu())
        kconv.reset_launch_counts()
        plan8 = compile_dhm(topo, rparams, quant=q8)
        feats8 = plan8.features(x)
        torch.cuda.synchronize()
        tanh = any(spec.act == "tanh" for spec in topo.conv_layers)
        err8, off8 = compare_int8(feats8.cpu(), want8, "tanh" if tanh else "relu",
                                  f"{name} int8 plan")
        card_plans += [(f"3d {name} fp32", rplan), (f"3d {name} int8", plan8)]
        print(f"[3d] {name} ({topo.input_shape} x {topo.input_channels}, {len(topo.conv_layers)} "
              f"layers, B={REGROUP_BATCH}): card groups {groups} (int8 "
              f"{[g.layers for g in plan8.fusion_groups]}); fp32 logits max |delta| {err:.3e} "
              f"against the plain forward, launches {fp32_launches}; int8 features max |delta| "
              f"{err8:.3e} ({off8} one step apart) against the CPU plan, launches "
              f"{ {k: v for k, v in kconv.LAUNCHES.items() if v} }")

    # -- 4. + 5. the main path, with the launch counts ---------------------------
    topo = ALL_TOPOLOGIES["cifar10"]
    cparams = init_cnn(torch.Generator().manual_seed(SEED), topo, device=dev)
    h, w = topo.input_shape
    x = randn(BATCH, h, w, topo.input_channels)
    kconv.reset_launch_counts()
    plan = compile_dhm(topo, cparams, quant=QuantSpec())
    plan0 = compile_dhm(topo, cparams, quant=QuantSpec(), vmem_budget=0)
    check([g.layers for g in plan.fusion_groups] == [(0, 1, 2)],
          f"fused plan groups {plan.fusion_groups}")
    check(all(not g.fused for g in plan0.fusion_groups), "vmem_budget=0 plan fuses")
    logits = plan(x)
    logits0 = plan0(x)
    ref_logits = cnn_apply_reference(cparams, topo, x)
    torch.cuda.synchronize()
    for what, out in (("fused plan", logits), ("vmem_budget=0 plan", logits0)):
        check(out.shape == (BATCH, topo.n_classes) and bool(torch.isfinite(out).all()),
              f"{what}: logits {tuple(out.shape)} not finite/shaped")
        err = float((out - ref_logits).abs().max())
        check(torch.allclose(out, ref_logits, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"{what}: max |delta| {err} against the plain forward")
        print(f"[4] cifar10 {what}, B={BATCH}: logits max |delta| {err:.3e} against "
              "the plain-version forward")

    rng = np.random.default_rng(SEED)
    eng = Engine(plan, microbatch=BATCH, auto_flush=True, default_deadline_ms=10_000.0)
    eng.reset_stats()
    frames = [rng.normal(size=(int(rng.integers(1, BATCH + 1)), h, w, topo.input_channels))
              .astype(np.float32) for _ in range(24)]
    t0 = time.perf_counter()
    reqs = [eng.submit(f) for f in frames]
    results = [r.result(timeout=120.0) for r in reqs]
    wall = time.perf_counter() - t0
    eng.stop()
    main_launches = dict(kconv.LAUNCHES)
    st = eng.stats()
    for f, got in zip(frames, results):
        want = plan(f).cpu()
        plain = cnn_apply_reference(cparams, topo, torch.from_numpy(f).to(dev)).cpu()
        check(got.shape == want.shape, f"engine logits {tuple(got.shape)} vs {tuple(want.shape)}")
        check(torch.allclose(got, want, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"engine logits max |delta| {float((got - want).abs().max())} against plan(x)")
        check(torch.allclose(got, plain, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"engine logits max |delta| {float((got - plain).abs().max())} against the "
              "plain-version forward")
    check(eng.rung == "fused", f"engine rung {eng.rung!r}")
    check(eng.demotions == [], f"engine demotions {eng.demotions}")
    check(st.n_retries == 0, f"engine retries {st.n_retries}")
    check(st.n_ok == len(frames) and st.n_errors == 0, f"engine outcomes: {st.summary()}")
    check(main_launches["stream_conv_pyramid"] > 0, "main path never launched the pyramid")
    check(main_launches["stream_conv_fused"] > 0, "main path never launched the single-layer kernel")
    lat = st.rung_latency_ms["fused"]
    n_frames = sum(f.shape[0] for f in frames)
    print(f"[5] engine: {len(frames)} requests / {n_frames} frames on rung {eng.rung}, "
          f"p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms, "
          f"{st.frames_per_s:.0f} frames/s busy, {n_frames / wall:.0f} frames/s wall, "
          f"{st.n_batches} micro-batches, 0 retries, 0 demotions")
    print(f"[5] main-path launches: {main_launches}")

    # -- 4b. + 5b. the int8 and pow2 path, with its own launch counts ------------
    qspec8 = stream_quant_spec(INT8_BITS)
    xq = quantize_stream(x, INT8_BITS).to(torch.float32) * qspec8.scale  # on-grid batch
    quant_a = QuantSpec(weight_bits=8, act_bits=8, int8_compute=True)
    quant_b = QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8))
    quant_c = QuantSpec(pow2_weights=True)
    # Reference outputs first, outside the counted window: the fake-quant
    # twins of plans (a) and (b) run the fp32 kernels.
    want_a = compile_dhm(topo, cparams, quant=QuantSpec(weight_bits=8, act_bits=8))(xq)
    want_b = compile_dhm(topo, cparams, quant=QuantSpec(
        act_bits=8, pow2_weights=True, per_layer_bits=(8, 8, 8)))(xq)
    plain_a = cnn_apply_reference(cparams, topo, xq, weight_bits=8, act_bits=8)
    plain_c = cnn_apply_reference(cparams, topo, x, pow2_weights=True)
    q_frames = [(quantize_stream(torch.from_numpy(f), INT8_BITS).to(torch.float32)
                 * qspec8.scale).numpy() for f in frames]
    torch.cuda.synchronize()
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    plan_a = compile_dhm(topo, cparams, quant=quant_a)
    plan_a0 = compile_dhm(topo, cparams, quant=quant_a, vmem_budget=0)
    plan_b = compile_dhm(topo, cparams, quant=quant_b)
    plan_c = compile_dhm(topo, cparams, quant=quant_c)
    check([g.layers for g in plan_a.fusion_groups] == [(0, 1, 2)],
          f"int8 plan groups {plan_a.fusion_groups}")
    check(all(not g.fused for g in plan_a0.fusion_groups), "int8 vmem_budget=0 plan fuses")
    logits_a = plan_a(xq)
    logits_a0 = plan_a0(xq)
    logits_b = plan_b(xq)
    logits_c = plan_c(x)
    eng_b = Engine(plan_b, microbatch=BATCH, auto_flush=True, default_deadline_ms=10_000.0)
    eng_b.reset_stats()
    t0 = time.perf_counter()
    reqs = [eng_b.submit(f) for f in q_frames]
    results_b = [r.result(timeout=120.0) for r in reqs]
    wall_b = time.perf_counter() - t0
    eng_b.stop()
    torch.cuda.synchronize()
    int8_launches = {**kconv.LAUNCHES, **kpow2.LAUNCHES}
    for what, out, want in (("plan (a) fused", logits_a, want_a),
                            ("plan (a) vmem_budget=0", logits_a0, want_a),
                            ("plan (b)", logits_b, want_b)):
        check(out.shape == (BATCH, topo.n_classes) and bool(torch.isfinite(out).all()),
              f"{what}: logits {tuple(out.shape)} not finite/shaped")
        check(torch.equal(out, want), f"{what}: max |delta| {float((out - want).abs().max())} "
              "against its fake-quant twin")
        print(f"[4b] cifar10 {what}, B={BATCH}, on-grid batch: logits equal to the fake-quant "
              "twin bit for bit")
    for what, out, plain in (("plan (a) fused", logits_a, plain_a), ("plan (c)", logits_c, plain_c)):
        err = float((out - plain).abs().max())
        check(torch.allclose(out, plain, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"{what}: max |delta| {err} against the plain forward")
        print(f"[4b] cifar10 {what}, B={BATCH}: logits max |delta| {err:.3e} against the "
              "plain-version forward")
    st_b = eng_b.stats()
    for f, got in zip(q_frames, results_b):
        want = plan_b(f).cpu()
        check(torch.equal(got, want), f"engine (b) logits max |delta| "
              f"{float((got - want).abs().max())} against plan(x)")
    check(eng_b.rung == "fused", f"engine (b) rung {eng_b.rung!r}")
    check(eng_b.demotions == [], f"engine (b) demotions {eng_b.demotions}")
    check(st_b.n_retries == 0, f"engine (b) retries {st_b.n_retries}")
    check(st_b.n_ok == len(frames) and st_b.n_errors == 0, f"engine (b) outcomes: {st_b.summary()}")
    for key in ("stream_conv_pyramid_int8", "stream_conv_fused_int8", "pow2_matmul",
                "pow2_matmul_int"):
        check(int8_launches[key] > 0, f"the int8 and pow2 path never launched {key}")
    lat = st_b.rung_latency_ms["fused"]
    print(f"[5b] engine on plan (b): {len(frames)} requests / {n_frames} frames on rung "
          f"{eng_b.rung}, p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms, "
          f"{st_b.frames_per_s:.0f} frames/s busy, {n_frames / wall_b:.0f} frames/s wall, "
          f"{st_b.n_batches} micro-batches, 0 retries, 0 demotions, every answer equal to plan(x)")
    print(f"[5b] int8 and pow2 path launches: {int8_launches}")

    # -- 4c. + 5c. the falcon-mamba LM path, with its own launch counts ----------
    # The fp32 gate first: full width and depth in float32, prefill through
    # the kernel against the same prefill through the plain scan, and
    # prefill + one decode step against the full forward. Then serving at
    # the config's dtype (bf16). The plain path's reference logits are
    # computed before the counts are zeroed; every call to the plain scan
    # through the dispatch is counted, and the serving run must make none.
    lm_cfg = get_arch(LM_ARCH)
    cfg32 = dataclasses.replace(lm_cfg, dtype="float32")
    n_lm_layers = lm_cfg.n_layers
    kernel_scan = mssm.ssm_scan
    plain_calls = [0]
    dispatch_plain = kssm_ops.ssm_scan_ref

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return dispatch_plain(*args, **kwargs)

    kssm_ops.ssm_scan_ref = counted_plain

    def plain_scan(x_, dt_, b_, c_, a_, d_skip_, h0_=None, **_):
        return ssm_scan_ref(x_, dt_, b_, c_, a_, d_skip_, h0_)

    t0 = time.perf_counter()
    params32 = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
    torch.cuda.synchronize()
    print(f"[4c] {LM_ARCH} float32 at full width and depth ({n_lm_layers} layers, "
          f"{param_count(cfg32):,} params, {param_bytes(cfg32) / 1e9:.1f} GB) drawn on the card "
          f"in {time.perf_counter() - t0:.1f} s")
    gate_toks = torch.randint(0, lm_cfg.vocab_size, (LM_GATE_BATCH, LM_GATE_LEN),
                              generator=gen).to(dev)
    mssm.ssm_scan = plain_scan
    try:
        plain_logits, _ = T.prefill(params32, cfg32, gate_toks, max_len=LM_GATE_LEN + 1)
        torch.cuda.synchronize()
    finally:
        mssm.ssm_scan = kernel_scan
    kscan.reset_launch_counts()
    plain_calls[0] = 0
    logits32, _ = T.prefill(params32, cfg32, gate_toks, max_len=LM_GATE_LEN + 1)
    h32, _, _ = T.forward_hidden(params32, cfg32, gate_toks)
    full_last2 = T.unembed(params32, cfg32, h32[:, -2:])
    pre32, cache32 = T.prefill(params32, cfg32, gate_toks[:, :-1], max_len=LM_GATE_LEN)
    dec32, _ = T.decode_step(params32, cfg32, gate_toks[:, -1:], cache32, LM_GATE_LEN - 1)
    torch.cuda.synchronize()
    gate_launches = kscan.LAUNCHES["ssm_scan"]
    check(gate_launches == 4 * n_lm_layers, f"fp32 gate launched ssm_scan {gate_launches} times")
    for what, got, want in (("prefill, kernel vs plain scan", logits32, plain_logits),
                            ("prefill(S-1) vs full forward row S-2", pre32, full_last2[:, 0]),
                            ("decode_step vs full forward row S-1", dec32, full_last2[:, 1])):
        err = float((got - want).abs().max())
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"fp32 gate {what}: {tuple(got.shape)} vs {tuple(want.shape)} or not finite")
        check(torch.allclose(got, want, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"fp32 gate {what}: max |delta| {err}")
        print(f"[4c] {what}, B={LM_GATE_BATCH}, S={LM_GATE_LEN}: logits max |delta| {err:.3e} "
              f"(max |logit| {float(want.abs().max()):.3f})")
    del params32, cache32, h32
    torch.cuda.empty_cache()

    params16 = T.init_params(torch.Generator(device=dev).manual_seed(SEED), lm_cfg)
    prompts = torch.randint(0, lm_cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen).to(dev)
    torch.cuda.synchronize()
    before = kscan.LAUNCHES["ssm_scan"]
    t0 = time.perf_counter()
    lm_logits, lm_cache = T.prefill(params16, lm_cfg, prompts, max_len=LM_PROMPT + LM_NEW)
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    prefill_launches = kscan.LAUNCHES["ssm_scan"] - before
    check(prefill_launches == n_lm_layers, f"prefill launched ssm_scan {prefill_launches} times")
    check(lm_logits.shape == (LM_BATCH, lm_cfg.vocab_size) and lm_logits.dtype == torch.bfloat16
          and bool(torch.isfinite(lm_logits).all()), "bf16 prefill logits not finite/shaped")
    tok = lm_logits.argmax(-1, keepdim=True)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        before = kscan.LAUNCHES["ssm_scan"]
        lm_logits, lm_cache = T.decode_step(params16, lm_cfg, tok, lm_cache, LM_PROMPT + i)
        check(kscan.LAUNCHES["ssm_scan"] - before == n_lm_layers,
              f"decode step {i} launched ssm_scan {kscan.LAUNCHES['ssm_scan'] - before} times")
        check(bool(torch.isfinite(lm_logits).all()), f"decode step {i}: logits not finite")
        tok = lm_logits.argmax(-1, keepdim=True)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_wall = time.perf_counter() - t0
    lm_launches = dict(kscan.LAUNCHES)
    check(plain_calls[0] == 0, f"the LM path called the plain scan {plain_calls[0]} times")
    kssm_ops.ssm_scan_ref = dispatch_plain
    gen_toks = torch.cat(generated, dim=1)
    print(f"[5c] {LM_ARCH} bf16 serving: prefill {LM_BATCH}x{LM_PROMPT} in "
          f"{prefill_wall * 1e3:.1f} ms (first call), {LM_NEW} greedy decode steps in "
          f"{decode_wall * 1e3:.1f} ms; ssm_scan {n_lm_layers} launches per prefill and per "
          f"step, the plain scan never called; {len(set(gen_toks.flatten().tolist()))} distinct "
          f"tokens generated, sequence 0 starts {gen_toks[0, :8].tolist()}")
    print(f"[5c] LM path launches: {lm_launches}")

    # -- 5d. the seed conv's own path: what the kernel bench runs on it ----------
    # benchmarks/kernel_bench.py runs the seed kernel once on cifar10 conv1
    # (8 frames, SAME-padded to 36x36) beside the single-layer kernel on the
    # same frames; here the two outputs must agree.
    sb, sh, sw, sc, sn, sk = SEED_SHAPES[0]
    bench_x = randn(sb, sh - sk + 1, sw - sk + 1, sc)
    bench_w = randn(sk, sk, sc, sn) * 0.2
    bench_pad = F.pad(bench_x, (0, 0, sk // 2, sk // 2, sk // 2, sk // 2))
    bench_taps = bench_w.reshape(sk * sk, sc, sn)
    torch.cuda.synchronize()
    klegacy.reset_launch_counts()
    seed_out = stream_conv2d_seed(bench_pad, bench_taps, k=sk)
    fused_out = stream_conv2d(bench_x, bench_w, padding="SAME")
    torch.cuda.synchronize()
    seed_launches = dict(klegacy.LAUNCHES)
    check(seed_launches["stream_conv2d_seed"] == 1, f"seed path launches {seed_launches}")
    check(torch.allclose(seed_out, fused_out, rtol=FP32_RTOL, atol=FP32_ATOL),
          f"seed vs single-layer kernel: max |delta| {float((seed_out - fused_out).abs().max())}")
    print(f"[5d] kernel bench path: seed conv and single-layer kernel on {sb}x{sh}x{sw}x{sc}, "
          f"K {sk}, N {sn} agree (max |delta| {float((seed_out - fused_out).abs().max()):.3e}); "
          f"launches {seed_launches}")

    # -- 5e. multi-tenant serving under faults: the Router, the Engine's fault ----
    # hooks and the verifier's plan and structure scopes. Every card plan the
    # script builds verifies clean first, and the card's NaN -> code result is
    # held against the CPU's; then the launch counts are zeroed and two
    # tenants serve cifar10 at full width through one Router: "fp32" (the
    # fused fp32 plan) and "int8" (plan (b)), with faults scoped to "int8" (a
    # dispatch error one retry heals, then a stall past its 2 s watchdog that
    # demotes it to per_layer), a hot swap of "fp32" to a seed-1 plan with
    # requests in flight, its rollback, and two swaps the verifier refuses.
    t_phase = time.perf_counter()
    plan_b0 = compile_dhm(topo, cparams, quant=quant_b, vmem_budget=0)
    card_plans += [("cifar10 fp32 fused", plan), ("cifar10 fp32 vmem_budget=0", plan0),
                   ("(a) fused", plan_a), ("(a) vmem_budget=0", plan_a0), ("(b) fused", plan_b),
                   ("(b) vmem_budget=0", plan_b0), ("(c)", plan_c)]
    for what, p_ in card_plans:
        errors = [f.render() for f in verify_plan(p_, scopes=("plan", "structure")) if f.is_error]
        check(not errors, f"verify_plan({what}): {errors}")
    print(f"[5e] verify_plan(scopes=('plan', 'structure')): no error finding on "
          f"{len(card_plans)} card plans ({', '.join(w for w, _ in card_plans)})")
    # NaN -> integer code: C++ leaves the float -> int cast of NaN undefined;
    # the port sets code 0 (the reference's), and the card must agree with
    # the CPU, in the quantizers and through plan (b)'s integer head.
    special = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"),
                            1.0, -0.3, 7.9, 1e-3])
    for what, fn in (("quantize_stream", lambda t: quantize_stream(t, INT8_BITS)),
                     ("quantize_fixed", lambda t: quantize_fixed(t, qspec8))):
        on_card, on_cpu = fn(special.to(dev)).cpu(), fn(special)
        check(torch.equal(on_card, on_cpu), f"{what}: card {on_card.tolist()} vs CPU {on_cpu.tolist()}")
    cpu_cparams = {k: [{kk: vv.cpu() for kk, vv in p_.items()} for p_ in v] for k, v in cparams.items()}
    plan_b_cpu = compile_dhm(topo, cpu_cparams, quant=quant_b, device="cpu")
    nan_feats = torch.full((4,) + tuple(topo.feature_shape()), float("nan"))
    with torch.inference_mode():
        head_card = plan_b.head_fn(nan_feats.to(dev)).cpu()
        head_cpu = plan_b_cpu.head_fn(nan_feats)
    check(bool(torch.isfinite(head_card).all()) and torch.equal(head_card, head_cpu),
          f"plan (b) head on NaN features: card {head_card[0].tolist()} vs CPU {head_cpu[0].tolist()}")
    print(f"[5e] NaN -> code 0 on the card as on the CPU (quantize_stream, quantize_fixed); plan (b)'s "
          f"integer head on NaN features serves finite logits equal to the CPU's, "
          f"row 0 {head_card[0].tolist()}")

    plan_s1 = compile_dhm(topo, init_cnn(torch.Generator().manual_seed(SEED + 1), topo, device=dev),
                          quant=QuantSpec())
    nan_params = {k: [{kk: vv.clone() for kk, vv in p_.items()} for p_ in v] for k, v in cparams.items()}
    nan_params["conv"][0]["w"][0, 0, 0, 0] = float("nan")
    plan_nan = compile_dhm(topo, nan_params, quant=QuantSpec())
    plan_lenet = compile_dhm(ALL_TOPOLOGIES["lenet5"], params["lenet5"], quant=QuantSpec())
    rng5e = np.random.default_rng(SEED + 5)
    traffic = [(tenant, rng5e.normal(size=(int(rng5e.integers(1, BATCH + 1)), h, w,
                                           topo.input_channels)).astype(np.float32))
               for _ in range(MT_REQUESTS) for tenant in ("fp32", "int8")]
    faults = FaultPlan([DispatchError(at=1, times=1, tenant="int8"),
                        StalledDispatch(at=4, times=1, stall_s=30.0, rung="fused", tenant="int8")],
                       seed=SEED)
    torch.cuda.synchronize()
    # Which rung served each request: the engine's rung when it completes
    # it (a router flush takes at most one micro-batch, so one rung).
    served_on, complete = {}, Engine._complete

    def recording_complete(self, req, logits, done):
        served_on[id(req)] = self.rung
        return complete(self, req, logits, done)

    plain = {"stream_conv_block_ref": 0, "stream_conv_pyramid_ref": 0, "pow2_matmul_ref": 0,
             "pow2_matmul_int_ref": 0}
    plain_fns = {name_: getattr(kconv_ops if "conv" in name_ else kpow2_ops, name_) for name_ in plain}

    def counted(name_):
        def call(*args, **kwargs):
            plain[name_] += 1
            return plain_fns[name_](*args, **kwargs)
        return call

    Engine._complete = recording_complete
    for name_ in plain:
        setattr(kconv_ops if "conv" in name_ else kpow2_ops, name_, counted(name_))
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    try:
        router = Router(microbatch=BATCH, default_deadline_ms=MT_DEADLINE_MS, fault_plan=faults,
                        join_timeout_s=60.0)
        router.add("fp32", plan, weight=1.0)
        router.add("int8", plan_b, weight=3.0, dispatch_timeout_s=MT_DISPATCH_TIMEOUT_S)
        eng_fp32_old = router.engine("fp32")
        submitted, half, swapped = [], threading.Event(), threading.Event()
        sub_lock = threading.Lock()

        def submitter(tid):
            # The first half of the traffic, then (once the swap is in) the rest.
            for i in range(tid, len(traffic), MT_SUBMITTERS):
                if i >= len(traffic) // 2 and not swapped.wait(60.0):
                    return
                tenant, f = traffic[i]
                req = router.submit(tenant, f)
                with sub_lock:
                    submitted.append((i, req))
                    if len(submitted) == len(traffic) // 2:
                        half.set()

        t0 = time.perf_counter()
        with router:
            threads = [threading.Thread(target=submitter, args=(tid,), name=f"submitter-{tid}")
                       for tid in range(MT_SUBMITTERS)]
            for t in threads:
                t.start()
            check(half.wait(60.0), "the submitters did not reach half the traffic")
            queued_at_swap = len(eng_fp32_old._queue)
            router.swap("fp32", plan_s1)  # with requests in flight
            swapped.set()
            for t in threads:
                t.join(60.0)
            check(not any(t.is_alive() for t in threads), "a submitter thread did not end")
            answers = {i: req.result(timeout=60.0) for i, req in submitted}
            wall_mt = time.perf_counter() - t0
            eng_fp32_new, eng_int8 = router.engine("fp32"), router.engine("int8")
            router.rollback("fp32")
            x_rb = traffic[0][1]
            answer_rb = router.submit("fp32", x_rb).result(timeout=60.0)
            refused = {}
            for what, bad in (("NaN weight", plan_nan), ("lenet5", plan_lenet)):
                try:
                    router.swap("fp32", bad)
                except SwapRejected as e:
                    refused[what] = e
            check(router.engine("fp32") is eng_fp32_old, "rollback did not restore the old engine")
        torch.cuda.synchronize()
    finally:
        Engine._complete = complete
        for name_, fn_ in plain_fns.items():
            setattr(kconv_ops if "conv" in name_ else kpow2_ops, name_, fn_)
    mt_launches = {**kconv.LAUNCHES, **kpow2.LAUNCHES}
    check(all(v == 0 for v in plain.values()), f"the serving phase called plain versions: {plain}")
    for key in ("stream_conv_pyramid", "stream_conv_pyramid_int8", "stream_conv_fused_int8",
                "pow2_matmul_int"):
        check(mt_launches[key] > 0, f"the multi-tenant path never launched {key}")
    check("V301" in getattr(refused.get("NaN weight"), "invariants", ()),
          f"the NaN-weight swap was not refused with V301: {refused.get('NaN weight')!r}")
    check("serving surface" in str(refused.get("lenet5", "")),
          f"the lenet5 swap was not refused for its surface: {refused.get('lenet5')!r}")

    # Every answer against a direct call, on the card, of the plan and rung
    # that served it, on the request's frames padded to the micro-batch as
    # the engine pads them (same shapes, so the same kernels and GEMMs).
    def padded(f):
        return np.concatenate([f, np.zeros((BATCH - f.shape[0],) + f.shape[1:], np.float32)])

    per_layer_fwd = {}

    def direct(eng_, rung_, f):
        if rung_ == "fused":
            fwd_ = eng_.plan
        else:
            fwd_ = per_layer_fwd.setdefault(id(eng_), eng_._build_unfused_fwd())
        with torch.inference_mode():
            return fwd_(torch.from_numpy(padded(f)).to(dev)).cpu()[: f.shape[0]]

    n_pre = n_post = 0
    rungs = {"fp32": set(), "int8": set()}
    for i, req in submitted:
        tenant, f = traffic[i]
        rung_ = served_on[id(req)]
        rungs[tenant].add(rung_)
        if tenant == "fp32":
            check(req._engine in (eng_fp32_old, eng_fp32_new), "an fp32 request on an unknown engine")
            n_pre += req._engine is eng_fp32_old
            n_post += req._engine is eng_fp32_new
        want = direct(req._engine, rung_, f)
        check(torch.equal(answers[i], want), f"{tenant} request {i} on rung {rung_}: max |delta| "
              f"{float((answers[i] - want).abs().max())} against the direct call")
    check(torch.equal(answer_rb, direct(eng_fp32_old, "fused", x_rb)), "after the rollback")
    check(n_pre > 0 and n_post > 0, f"the swap split no traffic: {n_pre} pre-swap, {n_post} post-swap")
    check(rungs["int8"] == {"fused", "per_layer"} and rungs["fp32"] == {"fused"},
          f"rungs served: {rungs}")
    for what, eng_ in (("fp32 (pre-swap engine)", eng_fp32_old), ("fp32 (post-swap engine)", eng_fp32_new)):
        st_ = eng_.stats()
        check(st_.n_errors == 0 and st_.n_retries == 0 and eng_.demotions == [],
              f"{what}: {st_.summary()}")
    st8 = eng_int8.stats()
    check(st8.n_errors == 0 and st8.n_retries == 1 and eng_int8.rung == "per_layer"
          and [d["rung"] for d in eng_int8.demotions] == ["fused"]
          and "did not complete" in eng_int8.demotions[0]["reason"],
          f"int8 tenant: {st8.summary()}, demotions {eng_int8.demotions}")
    check(join_watchdogs(30.0) == 0, "a watchdog thread is still running after the phase")
    torch.cuda.synchronize()
    print(smi)
    for tenant, engs in (("fp32", (("seed-0 plan", eng_fp32_old), ("seed-1 plan", eng_fp32_new))),
                         ("int8", (("plan (b)", eng_int8),))):
        sts = [(what, e_.stats()) for what, e_ in engs]
        n_req = sum(st_.n_ok for _, st_ in sts)
        n_fr = sum(st_.n_frames for _, st_ in sts)
        lat = "; ".join(f"{what} rung {r_} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms "
                        f"({v['n']} requests)"
                        for what, st_ in sts for r_, v in st_.rung_latency_ms.items())
        sts = [st_ for _, st_ in sts]
        print(f"[5e] tenant {tenant}: {n_req} requests / {n_fr} frames, {n_fr / wall_mt:.0f} frames/s "
              f"wall over the run; {lat}; retries {sum(st_.n_retries for st_ in sts)}, demotions "
              f"{sum(st_.n_demotions for st_ in sts)}, errors {sum(st_.n_errors for st_ in sts)}")
    print(f"[5e] {len(submitted)} requests from {MT_SUBMITTERS} submitter threads in {wall_mt:.2f} s; "
          f"fp32 swapped to the seed-{SEED + 1} plan in flight ({queued_at_swap} requests queued at "
          f"the swap; {n_pre} answers from the old plan, {n_post} from the new), rolled back; "
          f"refused: NaN weight "
          f"{list(refused['NaN weight'].invariants)}, lenet5 (serving surface); every answer equal "
          f"to a direct call of its plan and rung; plain versions called 0 times; launches "
          f"{ {k: v for k, v in mt_launches.items() if v} }; phase {time.perf_counter() - t_phase:.1f} s")

    # -- 5f. the spatial pipeline: the stages on their own streams --------------
    # cifar10 at full width, 3 stages of one conv layer each, fp32 and plan
    # (b)'s quantization; a stage mesh of three slots on the card, each its
    # own stream. B=256 as 4 µbatches of 64 through run_pipelined (exact and
    # boxed edges, serial and overlapped, and a (3, 2) (stage, data) mesh):
    # the features bit for bit against the same plan run in sequence, the
    # logits against the 1-stage fused plans (fp32 at the logits'
    # tolerance, int8 bit for bit). Then phase 5's burst through the
    # Engine's mesh rung, chaos on that rung, and the verifier's pipeline
    # scope. References are computed before the counts are zeroed; every
    # plain version is counted and must not be called.
    from repro_torch.analysis.invariants import planned_launches
    from repro_torch.analysis.verify import make_pipeline_probe
    from repro_torch.core.dhm import DeviceLoss, PipelineConfig, build_plan_pipeline
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    pipe_mesh = make_mesh((PIPE_STAGES,), ("stage",))
    pipe_mesh2 = make_mesh((PIPE_STAGES, 2), ("stage", "data"))
    check({str(d) for d in pipe_mesh.devices} == {"cuda:0"}
          and len({sl.stream.cuda_stream for sl in pipe_mesh.slots}) == PIPE_STAGES,
          f"stage mesh {pipe_mesh}: not {PIPE_STAGES} streams on cuda:0")
    plan3 = compile_dhm(topo, cparams, quant=QuantSpec(), n_stages=PIPE_STAGES)
    plan3_b = compile_dhm(topo, cparams, quant=quant_b, n_stages=PIPE_STAGES)
    for p_ in (plan3, plan3_b):
        check([st.conv_layers for st in p_.stages] == [(0,), (1,), (2,)],
              f"3-stage plan stages {[st.conv_layers for st in p_.stages]}")
    pipe_shape = (PIPE_M, BATCH // PIPE_M) + tuple(x.shape[1:])
    pipe_in = {"fp32": (plan3, x, plan), "(b)": (plan3_b, xq, plan_b)}
    with torch.inference_mode():
        pipe_want = {k: (p3.features(xin), p1(xin)) for k, (p3, xin, p1) in pipe_in.items()}
        # (what, request) -> the 3-stage plan on the frames padded to a group
        pipe_direct = {(what, i): p3(torch.from_numpy(padded(f)).to(dev)).cpu()[: f.shape[0]]
                       for what, (p3, fs) in (("fp32", (plan3, frames)), ("(b)", (plan3_b, q_frames)))
                       for i, f in enumerate(fs)}
    per_call = {k: planned_launches(p3) for k, (p3, _, _) in pipe_in.items()}
    torch.cuda.synchronize()
    for name_ in plain:
        plain[name_] = 0
        setattr(kconv_ops if "conv" in name_ else kpow2_ops, name_, counted(name_))
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    try:
        pipe_errs = {}
        for what, (p3, xin, p1) in pipe_in.items():
            feats_want, logits_1 = pipe_want[what]
            mbs = xin.reshape(pipe_shape)
            runs = [(em, ov, pipe_mesh, None) for em in ("exact", "boxed") for ov in (False, True)]
            runs.append(("auto", False, pipe_mesh2, "data"))
            for em, ov, mesh_, dax in runs:
                before = sum(kconv.LAUNCHES.values())
                with torch.inference_mode():
                    feats = p3.run_pipelined(mbs, mesh=mesh_, data_axis=dax, overlap=ov,
                                             edge_mode=em)
                    flat = feats.reshape((BATCH,) + tuple(feats.shape[2:]))
                    logits_p = p3.head_fn(flat)
                torch.cuda.synchronize()
                n_l = sum(kconv.LAUNCHES.values()) - before
                d_ = 2 if dax else 1
                check(n_l == d_ * PIPE_M * per_call[what],
                      f"5f {what} {em} overlap={ov} data={dax}: {n_l} stage launches, want "
                      f"{d_} x {PIPE_M} x {per_call[what]}")
                check(torch.equal(flat, feats_want), f"5f {what} {em} overlap={ov} data={dax}: "
                      f"features max |delta| {float((flat - feats_want).abs().max())}")
                err = float((logits_p - logits_1).abs().max())
                if what == "fp32":
                    check(torch.allclose(logits_p, logits_1, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
                          f"5f fp32 logits max |delta| {err} against the 1-stage fused plan")
                else:
                    check(torch.equal(logits_p, logits_1),
                          f"5f (b) logits max |delta| {err} against the 1-stage fused plan (b)")
                pipe_errs[what] = max(pipe_errs.get(what, 0.0), err)
            print(f"[5f] {what} 3-stage plan, {PIPE_M} µbatches of {BATCH // PIPE_M}: exact and "
                  f"boxed, serial and overlapped, and a (3, 2) (stage, data) mesh: features equal "
                  f"to the plan run in sequence bit for bit, {per_call[what]} launch(es) per stage "
                  f"body, {PIPE_M * per_call[what]} per call (fill and drain launch nothing); "
                  f"logits max |delta| {pipe_errs[what]:.3e} against the 1-stage fused plan")
        # Phase 5's burst through the Engine's mesh rung.
        pipe_engines = {}
        for what, (p3, _, _) in pipe_in.items():
            eng_p = Engine(p3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                           auto_flush=True, default_deadline_ms=10_000.0)
            eng_p.reset_stats()
            burst = frames if what == "fp32" else q_frames
            t0 = time.perf_counter()
            reqs = [eng_p.submit(f) for f in burst]
            got_p = [r.result(timeout=120.0) for r in reqs]
            wall_p = time.perf_counter() - t0
            eng_p.stop()
            for i, g_ in enumerate(got_p):
                want_ = pipe_direct[(what, i)]
                check(torch.equal(g_, want_), f"5f engine {what} request {i}: max |delta| "
                      f"{float((g_ - want_).abs().max())} against the plan")
            st_p = eng_p.stats()
            check(eng_p.rung == "mesh" and eng_p.demotions == [] and st_p.n_retries == 0
                  and st_p.n_ok == len(burst) and st_p.n_errors == 0,
                  f"5f engine {what}: rung {eng_p.rung}, {st_p.summary()}")
            pipe_engines[what] = (st_p, wall_p)
            lat = st_p.rung_latency_ms["mesh"]
            print(f"[5f] engine {what} on the mesh rung (group {eng_p.group} = {PIPE_M} x "
                  f"{BATCH // PIPE_M}): {len(burst)} requests / {n_frames} frames, p50 "
                  f"{lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms, {st_p.frames_per_s:.0f} "
                  f"frames/s busy, {n_frames / wall_p:.0f} frames/s wall, {st_p.n_batches} groups; "
                  "every answer equal to the plan on the padded group; 0 retries, 0 demotions")
        # Chaos on the mesh rung: a device loss demotes with no retry; a stall
        # past the watchdog demotes, and the abandoned attempt launches
        # nothing: the only launches are the fused rung's warmup and the
        # request's, and the mesh closure is never entered.
        x_c = frames[3]
        eng_l = Engine(plan3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                       retry_backoff_s=1e-4,
                       fault_plan=FaultPlan([DeviceLoss(at=0, times=None, rung="mesh")]))
        got_l = eng_l.infer(x_c)
        check(eng_l.rung == "fused" and [d["rung"] for d in eng_l.demotions] == ["mesh"]
              and eng_l.stats().n_retries == 0, f"5f device loss: rung {eng_l.rung}, "
              f"demotions {eng_l.demotions}, retries {eng_l.stats().n_retries}")
        check(torch.equal(got_l, pipe_direct[("fp32", 3)]), "5f device loss: answer")
        eng_s = Engine(plan3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                       dispatch_timeout_s=MT_DISPATCH_TIMEOUT_S,
                       fault_plan=FaultPlan([StalledDispatch(at=0, times=1, stall_s=30.0,
                                                             rung="mesh")]))
        mesh_calls, mesh_fwd = [], eng_s._fwd
        eng_s._fwd = lambda xb: mesh_calls.append(1) or mesh_fwd(xb)
        torch.cuda.synchronize()
        before = sum(kconv.LAUNCHES.values())
        t0 = time.perf_counter()
        got_s = eng_s.infer(x_c)
        check(join_watchdogs(30.0) == 0, "5f: a watchdog thread outlived the stall")
        stall_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        n_after = sum(kconv.LAUNCHES.values()) - before
        check(mesh_calls == [] and eng_s.rung == "fused"
              and [d["rung"] for d in eng_s.demotions] == ["mesh"]
              and "did not complete" in eng_s.demotions[0]["reason"],
              f"5f stall: rung {eng_s.rung}, demotions {eng_s.demotions}, mesh calls {mesh_calls}")
        check(n_after == 2 * per_call["fp32"],
              f"5f stall: {n_after} launches after the stall, want the fused rung's "
              f"{2 * per_call['fp32']} (warmup and request)")
        check(torch.equal(got_s, pipe_direct[("fp32", 3)]), "5f stall: answer")
        print(f"[5f] chaos on the mesh rung: DeviceLoss demotes to fused with 0 retries; a "
              f"StalledDispatch past its {MT_DISPATCH_TIMEOUT_S:.0f} s watchdog demotes to fused "
              f"in {stall_wall:.2f} s, the abandoned attempt launched nothing ({n_after} "
              "launches after it, all the fused rung's warmup and request)")
        # The verifier's pipeline scope on both plans, exact and boxed.
        for what, (p3, _, _) in pipe_in.items():
            pr_ = make_pipeline_probe(p3, n_microbatches=PIPE_M, microbatch=BATCH // PIPE_M)
            errors = [f.render() for f in verify_plan(p3, scopes=("pipeline",), pipeline=pr_)
                      if f.is_error]
            check(not errors and len(pr_.transfers) == (PIPE_STAGES - 1) * PIPE_M,
                  f"5f verify_plan({what}, pipeline): {errors}, {len(pr_.transfers)} transfers")
            boxed_ = verify_plan(p3, scopes=("pipeline",), pipeline=make_pipeline_probe(
                p3, n_microbatches=PIPE_M, microbatch=BATCH // PIPE_M, edge_mode="boxed"))
            check([(f.rule, f.severity) for f in boxed_] == [("V103", "warning")],
                  f"5f boxed probe of {what}: {[f.render() for f in boxed_]}")
            print(f"[5f] verify_plan({what}, scopes=('pipeline',)): no error, "
                  f"{len(pr_.transfers)} edge transfers in classes "
                  f"{sorted({t[0] for t in pr_.transfers})}; the boxed runner: one V103 warning "
                  f"({boxed_[0].message})")
        torch.cuda.synchronize()
    finally:
        for name_, fn_ in plain_fns.items():
            setattr(kconv_ops if "conv" in name_ else kpow2_ops, name_, fn_)
    pipe_launches = {**kconv.LAUNCHES, **kpow2.LAUNCHES}
    check(all(v == 0 for v in plain.values()), f"phase 5f called plain versions: {plain}")
    for key in ("stream_conv_fused", "stream_conv_fused_int8", "pow2_matmul_int"):
        check(pipe_launches[key] > 0, f"the pipeline path never launched {key}")
    check(join_watchdogs(30.0) == 0, "a watchdog thread is still running after phase 5f")
    print(f"[5f] pipeline path launches: { {k: v for k, v in pipe_launches.items() if v} }; plain "
          f"versions called 0 times; phase {time.perf_counter() - t_phase:.1f} s")

    # -- 5g. training on the card ------------------------------------------------
    train_launches = phase_5g(smi)

    # -- 5h. the static gate and the CNN examples --------------------------------
    static_launches = phase_5h(smi)

    # -- 5i. the other nine LM families --------------------------------------------
    family_launches = phase_5i(smi)

    # -- 5j. LM training ---------------------------------------------------------------
    # The bf16 falcon-mamba weights phase 6 times are set aside for the
    # phase's fp32 families and drawn again after it, from the same seed.
    del params16
    torch.cuda.empty_cache()
    lm_train_launches = phase_5j(smi)
    params16 = T.init_params(torch.Generator(device=dev).manual_seed(SEED), lm_cfg)

    # -- 6. timing at main-path shapes -------------------------------------------
    def time_ms(fn, iters=50, warmup=5):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def cost(layer_idxs, code_bytes=4):
        """(operations, bytes) of a run of cifar10 conv layers at B=BATCH: 2
        per conv MAC over the frame's real outputs; the input and weights
        read once at ``code_bytes`` per element (4 fp32, 1 int8 codes), the
        biases read once and the output written once in fp32."""
        hh, ww = topo.input_shape
        cc = topo.input_channels
        flops, nbytes = 0, 0
        for i, spec in enumerate(topo.conv_layers):
            hc, wc = spec.conv_hw(hh, ww)
            if i in layer_idxs:
                if i == layer_idxs[0]:
                    nbytes += BATCH * hh * ww * cc * code_bytes
                flops += 2 * BATCH * hc * wc * spec.kernel ** 2 * cc * spec.n_out
                nbytes += spec.kernel ** 2 * cc * spec.n_out * code_bytes + spec.n_out * 4
            hh, ww = spec.out_hw(hh, ww)
            cc = spec.n_out
            if i == layer_idxs[-1]:
                nbytes += BATCH * hh * ww * cc * 4
        return flops, nbytes

    def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    ws = [p["w"] for p in plan.conv_params]
    bs = [p["b"] for p in plan.conv_params]
    specs = topo.conv_layers
    check(all(s.padding == "SAME" and s.stride == 1 and s.kernel % 2 for s in specs),
          "the library chain takes SAME stride-1 odd-kernel layers")
    w_nchw = [wt.permute(3, 2, 0, 1).contiguous() for wt in ws]
    x_nchw = x.permute(0, 3, 1, 2).contiguous()

    acts = {"tanh": torch.tanh, "relu": F.relu, "none": lambda t: t}

    def library_chain(idxs, xin):
        """cuDNN conv -> max-pool -> act on NCHW: cifar10's layers are
        stride 1 with odd kernels, where SAME is a symmetric k // 2 pad."""
        for i in idxs:
            xin = F.conv2d(xin, w_nchw[i], bs[i], padding=specs[i].kernel // 2)
            pw, ps = specs[i].pool_cfg
            xin = acts[specs[i].act](F.max_pool2d(xin, pw, ps))
        return xin

    layers_in = [x]
    for spec, p in zip(specs, plan.conv_params):
        layers_in.append(stream_conv_block_ref(
            layers_in[-1], p["w"], p["b"], padding=spec.padding, act=spec.act, pool=spec.pool))
    layers_in_nchw = [t.permute(0, 3, 1, 2).contiguous() for t in layers_in]

    # Device time on the profiler's clock: the wrappers' host work (group
    # geometry, ctypes descriptors) can set the pace of a loop of CUDA-event
    # timed calls near 0.1 ms, so the fp32 conv kernels and the cuDNN chain
    # are also timed by the kernels' own time.
    from torch.profiler import ProfilerActivity, profile

    def queued_ms(fn, reps=20, spin_cycles=1 << 22, spins=5):
        """Device time per call on CUDA events, for a reading the profiler
        keeps dropping: ``reps`` calls queued behind a spin kernel, so that
        the device runs them back to back once the host has queued them all.
        The reading holds every kernel of the call and the device's gaps
        between launches, and no host time: the start event must still be
        pending when the last call is queued, else the spin is made four
        times longer and the reading taken again."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        for _ in range(spins):
            torch.cuda._sleep(spin_cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            ahead = not start.query()
            torch.cuda.synchronize()
            if ahead:
                return start.elapsed_time(end) / reps
            spin_cycles *= 4
        raise RuntimeError("the host could not queue the calls ahead of the device")

    def device_ms(fn, reps=20, kernel=None, tries=3):
        """Device time per call: the CUDA kernels ``reps`` calls launch (those
        whose name holds ``kernel``, or all), summed on the profiler's clock,
        over ``reps``. A reading counts only if the profiler recorded every
        launch (``reps`` of ``kernel``'s, or the same number of kernels each
        call): on the H100 the profiler has read a cluster kernel far below
        what a CUDA graph of the same launches took, as if records were lost,
        has recorded no kernel at all, and has dropped launches of one small
        kernel in three readings running. Such a reading is taken again, and
        said so, up to ``tries`` times; then the call is timed on queued CUDA
        events instead (``queued_ms``: the whole call), and said so."""
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, tries + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            total_us, count = 0.0, 0
            for evt in prof.key_averages():
                if str(evt.device_type).endswith("CUDA") and (kernel is None or kernel in evt.key):
                    us = getattr(evt, "self_device_time_total", None)
                    total_us += evt.self_cuda_time_total if us is None else us
                    count += evt.count
            if total_us > 0 and ((count == reps) if kernel else (count % reps == 0)):
                return total_us / 1e3 / reps
            print(f"[6] the profiler recorded {count} kernels of {kernel or 'the call'} over "
                  f"{reps} calls (try {attempt} of {tries}); reading again")
        ms_ = queued_ms(fn, reps)
        print(f"[6] the profiler dropped launches of {kernel or 'the call'} {tries} times; "
              f"{ms_:.5f} ms per call on queued CUDA events (every kernel of the call) instead")
        return ms_

    def host_us(fn, n=200):
        """The host's time per call over ``n`` calls with no synchronise
        between them: the wrapper's enqueue time, not the kernel's."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return elapsed / n * 1e6

    kernels = []
    pyr_layers = as_pyramid_layers(specs)
    block_rows = plan.fusion_groups[0].block_rows
    geom = group_geometry(h, w, topo.input_channels, pyr_layers, tuple(s.kernel for s in specs),
                          tuple(s.n_out for s in specs), block_rows=block_rows)
    pyr_smem = kconv.pyramid_smem_bytes(geom)
    pyr_ctas = kconv.ctas_per_sm("stream_conv_pyramid", pyr_smem)

    def run_pyramid():
        return stream_conv_pyramid(x, ws, bs, layers=specs, block_rows=block_rows)

    ms = time_ms(run_pyramid)
    plain = time_ms(lambda: stream_conv_pyramid_ref(x, ws, bs, layers=pyr_layers))
    lib = time_ms(lambda: library_chain((0, 1, 2), x_nchw))
    dev_k = device_ms(run_pyramid, kernel="sc_pyramid_kernel")
    dev_lib = device_ms(lambda: library_chain((0, 1, 2), x_nchw))
    b_ms, b_by = bound(*cost((0, 1, 2)))
    print(f"[6] pyramid cifar10 B={BATCH}: {ms:.4f} ms (CUDA events), {dev_k:.4f} ms device, "
          f"plain {plain:.4f} ms, library {lib:.4f} ms ({dev_lib:.4f} ms device), bound "
          f"{b_ms:.4f} ms ({b_by}); {dev_k / dev_lib:.3f}x the cuDNN chain's device time "
          f"({'beats' if dev_k < dev_lib else 'behind'} it), {b_ms / dev_k:.3f} of the bound; "
          f"{pyr_smem} B of shared memory, {pyr_ctas} CTAs per SM")
    kernels.append(dict(
        name="stream_conv_pyramid", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:440",
        launches=main_launches["stream_conv_pyramid"], max_abs_err=errs["stream_conv_pyramid"],
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        device_ms=dev_k, library_device_ms=dev_lib, ctas_per_sm=pyr_ctas,
    ))
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "dev": 0.0, "dev_lib": 0.0, "flops": 0,
           "bytes": 0}
    fused_ctas = []
    for i, spec in enumerate(specs):
        xi, p = layers_in[i], plan.conv_params[i]
        kw = dict(padding=spec.padding, act=spec.act, pool=spec.pool)
        hp, wp = xi.shape[1] + spec.kernel - 1, xi.shape[2] + spec.kernel - 1  # SAME, stride 1
        g_i = kconv.fused_geometry(hp, wp, xi.shape[3], k=spec.kernel, stride=1, pool=spec.pool,
                                   pool_stride=spec.pool_stride, block_r=8, n_out=spec.n_out)
        fused_ctas.append(kconv.ctas_per_sm("stream_conv_fused", g_i["smem"], g_i["threads"]))
        t_k = time_ms(lambda: stream_conv_block(xi, p["w"], p["b"], **kw))
        t_p = time_ms(lambda: stream_conv_block_ref(xi, p["w"], p["b"], **kw))
        t_l = time_ms(lambda: library_chain((i,), layers_in_nchw[i]))
        d_k = device_ms(lambda: stream_conv_block(xi, p["w"], p["b"], **kw),
                        kernel="sc_fused_kernel")
        d_l = device_ms(lambda: library_chain((i,), layers_in_nchw[i]))
        f_i, b_i = cost((i,))
        lb_ms, lb_by = bound(f_i, b_i)
        print(f"[6] single-layer cifar10 layer {i} B={BATCH}: {t_k:.4f} ms (CUDA events), "
              f"{d_k:.4f} ms device (the kernel alone), plain {t_p:.4f} ms, library "
              f"{t_l:.4f} ms ({d_l:.4f} ms device), bound {lb_ms:.4f} ms ({lb_by}); "
              f"{g_i['smem']} B of shared memory, {g_i['threads']} threads x {fused_ctas[-1]} "
              f"CTAs per SM, TN {g_i['tn']}, "
              f"{g_i['n_rb']} row blocks x {BATCH} images")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l), ("dev", d_k),
                         ("dev_lib", d_l), ("flops", f_i), ("bytes", b_i)):
            tot[key] += val
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    print(f"[6] single-layer cifar10 per-layer stack (3 launches): {tot['ms']:.4f} ms "
          f"(CUDA events), {tot['dev']:.4f} ms device, plain {tot['plain']:.4f} ms, library "
          f"{tot['lib']:.4f} ms ({tot['dev_lib']:.4f} ms device), bound {b_ms:.4f} ms ({b_by}); "
          f"{tot['dev'] / tot['dev_lib']:.3f}x the cuDNN layers' device time "
          f"({'beats' if tot['dev'] < tot['dev_lib'] else 'behind'} them)")
    kernels.append(dict(
        name="stream_conv_fused", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:168",
        launches=main_launches["stream_conv_fused"], max_abs_err=errs["stream_conv_fused"],
        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=b_ms, bound_by=b_by,
        library_ms=tot["lib"], device_ms=tot["dev"], library_device_ms=tot["dev_lib"],
        ctas_per_sm=min(fused_ctas),
    ))

    # The int8 kernels, timed at their own wrappers on the codes the plan
    # hands them (frame quantized and, for the single layer, padded): the
    # host-side quantize is not the kernel's. Two yardsticks, neither of
    # which the port calls: the fp32 cuDNN chain on the same shapes (a
    # different function: PyTorch has no int8 conv on CUDA) and the int8
    # products alone, torch._int_mm of each layer's unfolded codes (K
    # padded to a multiple of 8 with zero codes) by the layer's weight
    # codes, summed over the layers by device time (the unfold untimed).
    ws8 = [p["w"] for p in plan_a.conv_params]
    bs8 = [p["b"] for p in plan_a.conv_params]
    sc8 = plan_a.int8_scales
    bits8 = (INT8_BITS,) * len(specs)
    g8 = group_geometry(h, w, topo.input_channels, pyr_layers, tuple(s.kernel for s in specs),
                        tuple(s.n_out for s in specs),
                        block_rows=plan_a.fusion_groups[0].block_rows)
    x8 = quantize_stream(xq, INT8_BITS)
    layers_in8 = [xq]
    for spec, p, sc in zip(specs, plan_a.conv_params, sc8):
        layers_in8.append(stream_conv_block_ref(
            layers_in8[-1], p["w"], p["b"], padding=spec.padding, act=spec.act, pool=spec.pool,
            act_bits=INT8_BITS, int8_scales=sc))
    codes_in8 = [_pad_same(quantize_stream(layers_in8[i], sc8[i].in_bits), spec.kernel).contiguous()
                 for i, spec in enumerate(specs)]

    def int_mm_operands(i):
        """Layer i's unfolded codes (B * positions, K) and weight codes
        (K, N), K padded to a multiple of 8: the conv as one int8 GEMM."""
        kk = specs[i].kernel
        cols = F.unfold(codes_in8[i].permute(0, 3, 1, 2).float(), kk)  # (B, C*k*k, L)
        a = cols.permute(0, 2, 1).reshape(-1, cols.shape[1]).round().to(torch.int8)
        wmat = ws8[i].permute(2, 0, 1, 3).reshape(-1, ws8[i].shape[3])  # (C*k*k, N)
        k_pad = -(-a.shape[1] // 8) * 8
        a = F.pad(a, (0, k_pad - a.shape[1])).contiguous()
        wmat = F.pad(wmat, (0, 0, 0, k_pad - wmat.shape[0])).contiguous()
        return a, wmat

    mm_ops = [int_mm_operands(i) for i in range(len(specs))]
    check(all(torch.equal(torch._int_mm(a, b_).double(), a.double() @ b_.double())
              for a, b_ in mm_ops[1:]), "torch._int_mm yardstick disagrees with the int8 products")
    int_mm_dev = sum(device_ms(lambda a=a, b_=b_: torch._int_mm(a, b_)) for a, b_ in mm_ops)
    print(f"[6] torch._int_mm of cifar10's unfolded codes B={BATCH}, 3 layers (K "
          f"{', '.join(str(a.shape[1]) for a, _ in mm_ops)}): {int_mm_dev:.5f} ms device")

    lay8 = kconv.int8_pyramid_layout(g8)
    pyr8_ctas = kconv.ctas_per_sm("stream_conv_pyramid_int8", lay8.smem)

    def run_pyr8():
        return kconv.stream_conv_pyramid_cuda(x8, ws8, bs8, geom=g8, act_bits=bits8,
                                              int8_scales=sc8)

    ms = time_ms(run_pyr8)
    plain = time_ms(lambda: stream_conv_pyramid_ref(xq, ws8, bs8, layers=pyr_layers,
                                                    act_bits=bits8, int8_scales=sc8))
    lib = time_ms(lambda: library_chain((0, 1, 2), x_nchw))
    dev_k = device_ms(run_pyr8, kernel="sc_pyramid_i8_kernel")
    dev_lib = device_ms(lambda: library_chain((0, 1, 2), x_nchw))
    b_ms, b_by = bound(*cost((0, 1, 2), code_bytes=1), peak=PEAK_INT8_OPS)
    print(f"[6] int8 pyramid cifar10 B={BATCH}: {ms:.4f} ms (CUDA events), {dev_k:.5f} ms device, "
          f"plain {plain:.4f} ms, library (fp32 cuDNN chain) {lib:.4f} ms ({dev_lib:.4f} ms "
          f"device), torch._int_mm {int_mm_dev:.5f} ms device, bound {b_ms:.4f} ms ({b_by}); "
          f"{dev_k / b_ms:.1f}x the bound; {lay8.smem} B of shared memory, {pyr8_ctas} CTAs per SM, "
          f"n8 tiles a task {[li.nt for li in lay8.layers]}")
    kernels.append(dict(
        name="stream_conv_pyramid_int8", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:440",
        launches=int8_launches["stream_conv_pyramid_int8"],
        max_abs_err=errs["stream_conv_pyramid_int8"],
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        device_ms=dev_k, library_device_ms=dev_lib, int_mm_device_ms=int_mm_dev,
        ctas_per_sm=pyr8_ctas,
    ))
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "dev": 0.0, "dev_lib": 0.0, "flops": 0,
           "bytes": 0}
    fused8_ctas = []
    for i, spec in enumerate(specs):
        xi, p, sc, codes_i = layers_in8[i], plan_a.conv_params[i], sc8[i], codes_in8[i]
        kw = dict(padding=spec.padding, act=spec.act, pool=spec.pool, act_bits=INT8_BITS,
                  int8_scales=sc)
        g_i = kconv.fused_geometry(*codes_i.shape[1:], k=spec.kernel, stride=1, pool=spec.pool,
                                   pool_stride=spec.pool_stride, block_r=8, n_out=spec.n_out,
                                   elem_bytes=1)
        fused8_ctas.append(kconv.ctas_per_sm("stream_conv_fused_int8", g_i["smem"],
                                             g_i["threads"]))

        def run_k():
            return kconv.stream_conv_fused_cuda(codes_i, p["w"], p["b"], act=spec.act,
                                                pool=spec.pool, act_bits=INT8_BITS,
                                                int8_scales=sc)

        t_k = time_ms(run_k)
        t_p = time_ms(lambda: stream_conv_block_ref(xi, p["w"], p["b"], **kw))
        t_l = time_ms(lambda: library_chain((i,), layers_in_nchw[i]))
        d_k = device_ms(run_k, kernel="sc_fused_i8_kernel")
        d_l = device_ms(lambda: library_chain((i,), layers_in_nchw[i]))
        f_i, b_i = cost((i,), code_bytes=1)
        lb_ms, lb_by = bound(f_i, b_i, peak=PEAK_INT8_OPS)
        print(f"[6] int8 single-layer cifar10 layer {i} B={BATCH}: {t_k:.4f} ms (CUDA events), "
              f"{d_k:.5f} ms device, plain {t_p:.4f} ms, library (fp32 cuDNN) {t_l:.4f} ms "
              f"({d_l:.4f} ms device), bound {lb_ms:.4f} ms ({lb_by}); {g_i['smem']} B of shared "
              f"memory, {g_i['threads']} threads x {fused8_ctas[-1]} CTAs per SM, n8 tiles a "
              f"task {g_i['tn']}, {g_i['n_rb']} row blocks x {BATCH} images")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l), ("dev", d_k),
                         ("dev_lib", d_l), ("flops", f_i), ("bytes", b_i)):
            tot[key] += val
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peak=PEAK_INT8_OPS)
    print(f"[6] int8 single-layer cifar10 stack (3 launches): {tot['ms']:.4f} ms (CUDA events), "
          f"{tot['dev']:.5f} ms device, plain {tot['plain']:.4f} ms, library {tot['lib']:.4f} ms "
          f"({tot['dev_lib']:.4f} ms device), torch._int_mm {int_mm_dev:.5f} ms device, bound "
          f"{b_ms:.4f} ms ({b_by}); {tot['dev'] / b_ms:.1f}x the bound")
    kernels.append(dict(
        name="stream_conv_fused_int8", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:168",
        launches=int8_launches["stream_conv_fused_int8"],
        max_abs_err=errs["stream_conv_fused_int8"],
        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=tot["lib"],
        device_ms=tot["dev"], library_device_ms=tot["dev_lib"], int_mm_device_ms=int_mm_dev,
        ctas_per_sm=min(fused8_ctas),
    ))

    # pow2_matmul at all four head shapes; the record sums the cifar10
    # head's two (one head). Device time on the profiler's clock beside
    # the CUDA-event time, which at these sizes the wrapper's host work can
    # set; and the wrapper's host time per launch (enqueue only).
    for mode in ("pow2_matmul", "pow2_matmul_int"):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "dev": 0.0, "dev_lib": 0.0}
        bound_by = set()
        for si, shape in enumerate(POW2_SHAPES):
            m, k, n = shape
            xg, packed, scale = pow2_cases[shape]
            w_dec = decode_pow2(unpack_codes_u4(packed), torch.ones((), device=dev))[:, :n].contiguous()
            if mode == "pow2_matmul":
                def run_k():
                    return kpow2.pow2_matmul_cuda(xg, packed, scale)
                t_p = time_ms(lambda: pow2_matmul_ref(xg, packed, scale))
                ops, peak, x_bytes = 2 * m * k * n, PEAK_FP32_FLOPS, 4 * m * k
            else:
                xc = quantize_fixed(xg, qspec8).to(torch.int8)

                def run_k():
                    return kpow2.pow2_matmul_cuda(xc, packed, scale, x_scale=qspec8.scale)
                t_p = time_ms(lambda: pow2_matmul_int_ref(xg, packed, scale, x_spec=qspec8))
                ops, peak, x_bytes = 2 * m * k * n, PEAK_INT8_OPS, m * k

            def run_lib():
                return torch.matmul(xg, w_dec) * scale
            t_k = time_ms(run_k)
            t_l = time_ms(run_lib)
            d_k = device_ms(run_k, kernel="p2_matmul")
            d_l = device_ms(run_lib)
            q_k = queued_ms(run_k)
            h_us = host_us(run_k)
            nbytes = x_bytes + packed.numel() + 4 * n + 4 * m * n
            t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_S
            print(f"[6] {mode} {shape}: {t_k:.4f} ms (CUDA events), {d_k:.5f} ms device "
                  f"({q_k:.5f} ms on queued CUDA events), "
                  f"plain {t_p:.4f} ms, library (torch.matmul on decoded weights, x scale) "
                  f"{t_l:.4f} ms ({d_l:.5f} ms device), bound "
                  f"{max(t_ops, t_bytes) * 1e3:.6f} ms; {d_k / d_l:.3f}x the library's device "
                  f"time; wrapper enqueue {h_us:.2f} us per launch (host clock, 200 launches)")
            if si < 2:
                bound_by.add("operations" if t_ops >= t_bytes else "bytes")
                for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                                 ("bound", max(t_ops, t_bytes) * 1e3), ("dev", d_k),
                                 ("dev_lib", d_l)):
                    tot[key] += val
        print(f"[6] {mode} cifar10 head (2 launches): {tot['dev']:.5f} ms device, library "
              f"{tot['dev_lib']:.5f} ms device, {tot['dev'] / tot['dev_lib']:.3f}x "
              f"({'beats' if tot['dev'] < tot['dev_lib'] else 'behind'} it)")
        kernels.append(dict(
            name=mode, route="cuda", source="src/repro_torch/csrc/pow2_matmul.cu",
            replaces="src/repro/kernels/pow2_matmul/pow2.py:77",
            launches=int8_launches[mode], max_abs_err=errs[mode],
            ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
            bound_by="bytes" if "bytes" in bound_by else "operations", library_ms=tot["lib"],
            device_ms=tot["dev"], library_device_ms=tot["dev_lib"],
        ))
    fwd_ms = time_ms(lambda: plan(x), iters=20)
    fwd0_ms = time_ms(lambda: plan0(x), iters=20)
    print(f"[6] cifar10 plan(x) B={BATCH}: fused {fwd_ms:.4f} ms, vmem_budget=0 {fwd0_ms:.4f} ms")
    plan_ms = {name_: time_ms(lambda: p_(xq), iters=20)
               for name_, p_ in (("(a) fused", plan_a), ("(a) vmem_budget=0", plan_a0),
                                 ("(b)", plan_b), ("(c)", plan_c))}
    print(f"[6] cifar10 plan(x) B={BATCH}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in plan_ms.items()))
    # The same plans by the device time of all their kernels per call: at
    # B=256 the wrappers' host work can set the pace of the calls above.
    plan_dev = {name_: device_ms(fn_) for name_, fn_ in (
        ("fp32 fused", lambda: plan(x)), ("fp32 vmem_budget=0", lambda: plan0(x)),
        ("(a) fused", lambda: plan_a(xq)), ("(a) vmem_budget=0", lambda: plan_a0(xq)))}
    print(f"[6] cifar10 plan(x) B={BATCH}, device time of its kernels: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in plan_dev.items()))
    # One serving micro-batch, piece by piece: the host-to-card copy of a
    # packed batch, the conv features (one pyramid launch), the FC head,
    # and the logits' copy back; beside the Engine's host-clock time per
    # micro-batch (packing, watchdog thread, and all of the above).
    host_batch = np.zeros((BATCH, h, w, topo.input_channels), np.float32)
    feats = plan.features(x)
    out = plan.head_fn(feats)
    parts = {
        "h2d": time_ms(lambda: torch.from_numpy(host_batch).to(dev), iters=20),
        "features": time_ms(lambda: plan.features(x), iters=20),
        "head": time_ms(lambda: plan.head_fn(feats), iters=20),
        "d2h": time_ms(lambda: out.to("cpu"), iters=20),
    }
    per_batch_ms = st.busy_s / st.n_batches * 1e3
    print(f"[6] engine micro-batch of {BATCH}: {per_batch_ms:.4f} ms host clock; on the card "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; card share {sum(parts.values()) / per_batch_ms:.3f}")
    # The Engine's host split, per micro-batch: an Engine on the fused fp32
    # plan takes requests of BATCH frames, one flush each, with its own
    # methods wrapped here to time them on the host clock (the Engine has no
    # timing knob): submit (the gate's checks), the flush around the watched
    # dispatch (packing and completing), the watchdog (call_with_timeout
    # minus the work inside its thread: starting the thread and handing the
    # result back), _stage (the copy to the card), the forward's enqueue of
    # its launches, and _sync (the card finishing, then the copy back).
    from repro_torch.core.dhm import engine as tengine

    split = dict.fromkeys(("submit", "flush", "watchdog", "stage", "enqueue", "sync"), 0.0)

    def timed(key, fn):
        def call(*args, **kwargs):
            t_ = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[key] += time.perf_counter() - t_
        return call

    eng6 = Engine(plan, microbatch=BATCH)
    split_frames = [rng.normal(size=(BATCH, h, w, topo.input_channels)).astype(np.float32)
                    for _ in range(HOST_SPLIT_BATCHES)]
    watchdog_fn = tengine.call_with_timeout
    tengine.call_with_timeout = timed("watchdog", watchdog_fn)
    eng6._stage, eng6._sync = timed("stage", eng6._stage), timed("sync", eng6._sync)
    eng6._fwd = timed("enqueue", eng6._fwd)
    submit6, flush6 = timed("submit", eng6.submit), timed("flush", eng6.flush)
    try:
        for warm in range(2):
            for f in split_frames[:3] if warm == 0 else split_frames:
                req = submit6(f)
                flush6()
                req.result(timeout=60.0)
            if warm == 0:
                split = dict.fromkeys(split, 0.0)
    finally:
        tengine.call_with_timeout = watchdog_fn
    ms6 = {k: v / HOST_SPLIT_BATCHES * 1e3 for k, v in split.items()}
    inside = ms6["stage"] + ms6["enqueue"] + ms6["sync"]
    print(f"[6] engine host split per micro-batch of {BATCH} frames (host clock, mean of "
          f"{HOST_SPLIT_BATCHES}): submit {ms6['submit']:.4f} ms; flush {ms6['flush']:.4f} ms = "
          f"packing and completion {ms6['flush'] - ms6['watchdog']:.4f} + watchdog thread start and "
          f"hand-off {ms6['watchdog'] - inside:.4f} + _stage {ms6['stage']:.4f} + forward enqueue "
          f"{ms6['enqueue']:.4f} + _sync {ms6['sync']:.4f}")

    # The selective scan at the LM path's shapes: the falcon-mamba layer at
    # prefill (bf16 x, B and C, the zero cache as h0, as prefill passes it)
    # and at decode (S = 1, the carried state). The bound is the largest of
    # its bytes (x, dt and y per element, B, C, A, D_skip and both states)
    # over the memory rate, its expf over the SFU rate, and its FLOPs (six
    # per state update, three per channel and step) over the fp32 peak.
    def ssm_bound(bz, s, d, n, elem):
        nbytes = bz * s * d * (elem + 4 + 4) + 2 * bz * s * n * elem + d * n * 4 + d * 4 \
            + 2 * bz * d * n * 4
        t_bytes = nbytes / PEAK_BYTES_S
        t_exp = bz * s * d * n / (SFU_PER_CLOCK_PER_SM * N_SMS * BOOST_CLOCK_HZ)
        t_ops = bz * s * d * (6 * n + 3) / PEAK_FP32_FLOPS
        by = "bytes" if t_bytes >= max(t_exp, t_ops) else "operations"
        return max(t_bytes, t_exp, t_ops) * 1e3, by, (t_bytes * 1e3, t_exp * 1e3, t_ops * 1e3)

    # Device time on the profiler's clock at each shape (CUDA events at
    # decode measure the wrapper's enqueue), and the plan's lanes.
    di_lm, n_lm = lm_cfg.ssm_expand * lm_cfg.d_model, lm_cfg.ssm_state
    ssm_times = {}
    for what, bz_, s in SSM_SHAPES:
        x_, dt_, b_, c_, a_, dsk_, h0_ = ssm_inputs(bz_, s, di_lm, n_lm, "bfloat16", True)
        if what == "prefill":
            h0_ = torch.zeros_like(h0_)
        args_ = (x_, dt_, b_, c_, a_, dsk_, h0_)
        t_k = time_ms(lambda: ssm_scan(*args_), iters=50 if s > 1 else 500)
        d_k = device_ms(lambda: ssm_scan(*args_), kernel="ssm_scan")
        t_p = time_ms(lambda: ssm_scan_ref(*args_), iters=3 if s > 1 else 50, warmup=1)
        b_ms, b_by, terms = ssm_bound(bz_, s, di_lm, n_lm, 2)
        plan_s = kscan.scan_plan(bz_, s, di_lm, n_lm, n_sms=n_sms)
        ssm_times[what] = dict(ms=t_k, dev=d_k, plain=t_p, bound=b_ms, by=b_by,
                               lanes=plan_s["lanes"])
        print(f"[6] ssm_scan {what} (Bz {bz_}, S {s}, D {di_lm}, N {n_lm}, bf16): {d_k:.5f} ms "
              f"device, {t_k:.4f} ms (CUDA events), plain {t_p:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}; bytes {terms[0]:.5f}, expf {terms[1]:.5f}, FLOPs {terms[2]:.5f} ms), "
              f"{d_k / b_ms:.2f}x the bound, no library call; plan "
              f"{ {k: plan_s[k] for k in ('lanes', 'npl', 'chunk', 'dc', 'ctas', 'warps')} }")
    kernels.append(dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/scan.py:61",
        launches=lm_launches["ssm_scan"], max_abs_err=errs["ssm_scan"],
        ms=ssm_times["prefill"]["ms"], plain_ms=ssm_times["prefill"]["plain"],
        bound_ms=ssm_times["prefill"]["bound"], bound_by=ssm_times["prefill"]["by"],
        library_ms=None, device_ms=ssm_times["prefill"]["dev"],
        launches_by_shape=dict(gate=gate_launches, prefill=prefill_launches,
                               decode=lm_launches["ssm_scan"] - gate_launches - prefill_launches),
        device_ms_decode=ssm_times["decode"]["dev"], bound_ms_decode=ssm_times["decode"]["bound"],
        plain_ms_decode=ssm_times["decode"]["plain"],
        device_ms_one_sequence=ssm_times["one sequence"]["dev"],
        bound_ms_one_sequence=ssm_times["one sequence"]["bound"],
        lanes={k: v["lanes"] for k, v in ssm_times.items()},
    ))

    # The LM end to end at bf16, full depth: prefill and one decode step.
    # The decode step's bound is reading every weight once.
    pf_ms = time_ms(lambda: T.prefill(params16, lm_cfg, prompts, max_len=LM_PROMPT + LM_NEW),
                    iters=5, warmup=1)
    pf_flops = model_flops(lm_cfg, ShapeConfig("prefill", LM_PROMPT, LM_BATCH, "prefill"))
    print(f"[6] prefill {LM_BATCH}x{LM_PROMPT} bf16: {pf_ms:.3f} ms, "
          f"{LM_BATCH * LM_PROMPT / pf_ms * 1e3:.0f} tokens/s, {pf_flops / pf_ms / 1e9:.1f} "
          f"TFLOP/s of model FLOPs ({pf_flops / 1e12:.2f} TFLOP), {n_lm_layers} scans "
          f"{n_lm_layers * ssm_times['prefill']['dev']:.3f} ms of it (device)")
    dec_args = (params16, lm_cfg, tok, lm_cache, LM_PROMPT + LM_NEW)
    dec_ms = time_ms(lambda: T.decode_step(*dec_args), iters=10, warmup=2)
    dec_bound = param_bytes(lm_cfg) / PEAK_BYTES_S * 1e3
    print(f"[6] decode step B={LM_BATCH} bf16: {dec_ms:.3f} ms per step (CUDA events), "
          f"{decode_wall / LM_NEW * 1e3:.3f} ms host clock in phase 5c, "
          f"{LM_BATCH / dec_ms * 1e3:.0f} tokens/s; weight-read bound {dec_bound:.3f} ms; "
          f"{n_lm_layers} scans {n_lm_layers * ssm_times['decode']['dev']:.4f} ms of it (device)")
    # Where a prefill's and a decode step's time goes: device time by
    # kernel under the profiler, against the host clock.
    def device_breakdown(what, fn, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        rows = []
        for evt in prof.key_averages():
            if not str(evt.device_type).endswith("CUDA"):
                continue
            us = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if us is None else us
            rows.append((us / 1e3 / reps, evt.count // reps, evt.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        print(f"[6] {what} under the profiler: {wall_ms:.3f} ms host clock, device busy "
              f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of it) in {sum(r[1] for r in rows)} "
              "kernels")
        for ms_, cnt, key in rows[:8]:
            print(f"[6]   {ms_:.4f} ms  x{cnt}  {key[:90]}")

    device_breakdown(f"prefill {LM_BATCH}x{LM_PROMPT}",
                     lambda: T.prefill(params16, lm_cfg, prompts, max_len=LM_PROMPT + LM_NEW), 1)
    device_breakdown("decode step", lambda: T.decode_step(*dec_args), 2)

    # Two of phase 5i's families at full depth in bf16: prefill of 4 x 512
    # tokens and a decode step on CUDA events, and where their device time
    # goes (profiler). Each model is drawn again and freed after.
    for name in FAM_TIMED:
        arch = get_arch(name)
        fam_params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), arch)
        fam_toks, _, _ = family_inputs(arch, FAM_BATCH, FAM_PROMPT, gen, dev)
        max_len = FAM_PROMPT + FAM_NEW

        def fam_prefill():
            return T.prefill(fam_params, arch, fam_toks, max_len=max_len)

        fam_logits, fam_cache = fam_prefill()
        fam_tok = fam_logits.argmax(-1, keepdim=True)
        fam_pf = time_ms(fam_prefill, iters=5, warmup=1)
        fam_flops = model_flops(arch, ShapeConfig("prefill", FAM_PROMPT, FAM_BATCH, "prefill"))

        def fam_decode():
            return T.decode_step(fam_params, arch, fam_tok, fam_cache, FAM_PROMPT)

        fam_dec = time_ms(fam_decode, iters=10, warmup=2)
        print(f"[6] {name} bf16, {arch.n_layers} layers ({param_bytes(arch) / 1e9:.1f} GB): "
              f"prefill {FAM_BATCH}x{FAM_PROMPT} {fam_pf:.3f} ms (CUDA events), "
              f"{FAM_BATCH * FAM_PROMPT / fam_pf * 1e3:.0f} tokens/s, "
              f"{fam_flops / fam_pf / 1e9:.1f} TFLOP/s of model FLOPs; decode step B={FAM_BATCH} "
              f"{fam_dec:.3f} ms, {FAM_BATCH / fam_dec * 1e3:.0f} tokens/s, weight-read bound "
              f"{param_bytes(arch) / PEAK_BYTES_S * 1e3:.3f} ms ({smi})")
        device_breakdown(f"{name} prefill {FAM_BATCH}x{FAM_PROMPT}", fam_prefill, 1)
        device_breakdown(f"{name} decode step", fam_decode, 2)
        del fam_params, fam_cache, fam_logits, fam_tok, fam_toks
        torch.cuda.empty_cache()

    # The seed conv beside the single-layer kernel (the same bare conv on the
    # same padded frame) and cuDNN, at the kernel bench's shape and at B=256:
    # CUDA events, device time on the profiler's clock (the seed kernel
    # alone; every kernel of the bare F.conv2d call), and the wrapper's host
    # time per launch.
    seed_times = {}
    for b_, h_, w_, c_, n_, k_ in SEED_SHAPES[:2]:
        xp, wt = randn(b_, h_, w_, c_), randn(k_, k_, c_, n_) * 0.2
        taps = wt.reshape(k_ * k_, c_, n_)
        xp_nchw, w_oihw = xp.permute(0, 3, 1, 2).contiguous(), wt.permute(3, 2, 0, 1).contiguous()

        def run_seed():
            return stream_conv2d_seed(xp, taps, k=k_)

        def run_cudnn():
            return F.conv2d(xp_nchw, w_oihw)
        t_k = time_ms(run_seed)
        t_f = time_ms(lambda: stream_conv2d(xp, wt, padding="VALID"))
        t_l = time_ms(run_cudnn)
        t_p = time_ms(lambda: stream_conv2d_ref(xp, wt))
        d_k = device_ms(run_seed, kernel="sc_seed_kernel")
        d_l = device_ms(run_cudnn)
        h_us = host_us(run_seed)
        ho, wo = h_ - k_ + 1, w_ - k_ + 1
        b_ms, b_by = bound(2 * b_ * ho * wo * k_ * k_ * c_ * n_,
                           4 * (b_ * h_ * w_ * c_ + k_ * k_ * c_ * n_ + b_ * ho * wo * n_))
        seed_times[b_] = dict(ms=t_k, plain=t_p, bound=b_ms, by=b_by, lib=t_l, dev=d_k,
                              dev_lib=d_l)
        print(f"[6] seed conv {b_}x{h_}x{w_}x{c_}, K {k_}, N {n_}: {t_k:.4f} ms (CUDA events), "
              f"{d_k:.5f} ms device, single-layer kernel {t_f:.4f} ms, cuDNN {t_l:.4f} ms "
              f"({d_l:.5f} ms device), plain {t_p:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
              f"{d_k / d_l:.3f}x cuDNN's device time "
              f"({'beats' if d_k < d_l else 'behind'} it); wrapper enqueue {h_us:.2f} us per "
              "launch (host clock, 200 launches)")
    s8, s256 = seed_times[SEED_SHAPES[0][0]], seed_times[SEED_SHAPES[1][0]]
    kernels.append(dict(
        name="stream_conv2d_seed", route="cuda", source="src/repro_torch/csrc/stream_conv_seed.cu",
        replaces="src/repro/kernels/stream_conv/legacy.py:44",
        launches=seed_launches["stream_conv2d_seed"], max_abs_err=errs["stream_conv2d_seed"],
        ms=s8["ms"], plain_ms=s8["plain"], bound_ms=s8["bound"], bound_by=s8["by"],
        library_ms=s8["lib"], device_ms=s8["dev"], library_device_ms=s8["dev_lib"],
        ms_b256=s256["ms"], device_ms_b256=s256["dev"], library_device_ms_b256=s256["dev_lib"],
        bound_ms_b256=s256["bound"],
    ))

    # The spatial pipeline sweep: cifar10's 3-stage fp32 plan on the stage
    # mesh (three streams of cuda:0), M µbatches of mb frames, serial and
    # overlapped, in frames/s from CUDA events; beside each row the same
    # frames through the 1-stage fused plan (one pyramid launch) and the
    # 3-stage plan run in sequence on one stream, and the profiler's union
    # of kernel device time against its sum (a union below the sum means
    # the stage streams overlapped). Then the 2-stage plan's serial rows
    # (another ratio of stage FLOPs to edge bytes, without which the fit is
    # degenerate), fit_constants on the serial rows, estimate_pipeline
    # beside each row, and autotune_pipeline's pick from the rows.
    from repro_torch.core.dhm import autotune_pipeline, estimate_pipeline, fit_constants, sweep_sample

    trace_path = os.path.join(ROOT, "build", "pipeline_sweep_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)

    def kernel_union(fn, reps=5, tries=3):
        """(sum, union) of the kernels' device intervals per call, ms, over
        ``reps`` calls on the profiler's clock, and the kernels per call;
        (None, None, 0) when the profiler recorded no kernel in ``tries``
        readings (it drops records at times)."""
        fn()
        torch.cuda.synchronize()
        for attempt in range(tries):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(trace_path)
            with open(trace_path) as fh:
                evs = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"]
            os.remove(trace_path)
            if evs:
                break
            print(f"[6] the profiler recorded no kernel of a pipelined call over {reps} calls "
                  f"(try {attempt + 1} of {tries}); reading again")
        else:
            return None, None, 0
        iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in evs)
        total = sum(b - a for a, b in iv)
        union, end = 0.0, None
        for a, b in iv:
            if end is None or a > end:
                union += b - a
                end = b
            elif b > end:
                union += b - end
                end = b
        return total / reps / 1e3, union / reps / 1e3, len(evs) / reps

    sweep_rows, sweep_samples = [], []
    sweep_plans = {3: plan3, 2: compile_dhm(topo, cparams, quant=QuantSpec(), n_stages=2)}
    gen_sw = torch.Generator().manual_seed(SEED + 6)
    for n_st in SWEEP_STAGES:
        p_st = sweep_plans[n_st]
        mesh_st = pipe_mesh if n_st == PIPE_STAGES else make_mesh((n_st,), ("stage",))
        for mb in SWEEP_MB:
            for m_ in SWEEP_M:
                xs = torch.randn((m_ * mb, h, w, topo.input_channels), generator=gen_sw).to(dev)
                mbs = xs.reshape((m_, mb) + tuple(xs.shape[1:]))
                with torch.inference_mode():
                    t_fused = time_ms(lambda: plan.features(xs), iters=20)
                    t_seq = time_ms(lambda: p_st.features(xs), iters=20)
                for ov in ((False, True) if n_st == PIPE_STAGES else (False,)):
                    runner = build_plan_pipeline(p_st, mesh=mesh_st,
                                                 cfg=PipelineConfig(n_st, m_, overlap=ov),
                                                 microbatch=mb)
                    with torch.inference_mode():
                        t_pipe = time_ms(lambda: runner(mbs), iters=20)
                        k_sum, k_union, k_n = kernel_union(lambda: runner(mbs))
                    fps = m_ * mb / t_pipe * 1e3
                    row = dict(n_stages=n_st, n_microbatches=m_, microbatch=mb, data=1,
                               overlap=ov, edge_mode="auto", frames_per_s=fps, ms=t_pipe,
                               fused_fps=m_ * mb / t_fused * 1e3,
                               sequential_fps=m_ * mb / t_seq * 1e3,
                               kernel_sum_ms=k_sum, kernel_union_ms=k_union, kernels=k_n)
                    sweep_rows.append(row)
                    if not ov:
                        sweep_samples.append(sweep_sample(p_st, n_microbatches=m_, microbatch=mb,
                                                          data=1, frames_per_s=fps))
    fitted = fit_constants(sweep_samples)
    print(f"[6] pipeline sweep, cifar10 fp32 ({smi}): fit_constants on "
          f"{len(sweep_samples)} serial rows: {fitted.flops_per_s:.4e} FLOP/s, "
          f"{fitted.bytes_per_s:.4e} B/s, tick overhead {fitted.tick_overhead_s * 1e3:.4f} ms "
          f"(source {fitted.source})")
    for row in sweep_rows:
        est = estimate_pipeline(sweep_plans[row["n_stages"]], n_microbatches=row["n_microbatches"],
                                microbatch=row["microbatch"], overlap=row["overlap"],
                                constants=fitted)
        row["model_fps"] = est.frames_per_s
        print(f"[6] pipeline S={row['n_stages']} M={row['n_microbatches']} "
              f"mb={row['microbatch']} overlap={row['overlap']} ({smi}): "
              f"{row['frames_per_s']:.0f} frames/s ({row['ms']:.4f} ms a call, CUDA events); "
              f"1-stage fused {row['fused_fps']:.0f}, {row['n_stages']}-stage in sequence "
              f"{row['sequential_fps']:.0f} frames/s; "
              + (f"kernels {row['kernels']:.0f} a call, device sum {row['kernel_sum_ms']:.4f} ms, "
                 f"union {row['kernel_union_ms']:.4f} ms (union/sum "
                 f"{row['kernel_union_ms'] / row['kernel_sum_ms']:.3f}, busy share "
                 f"{row['kernel_union_ms'] / row['ms']:.3f})" if row["kernels"] else
                 "kernels' device time not measured (the profiler recorded none)")
              + f"; model {est.frames_per_s:.0f} frames/s")
    pick = autotune_pipeline(plan3, PIPE_STAGES,
                             measurements=[r for r in sweep_rows if r["n_stages"] == PIPE_STAGES],
                             constants=fitted)
    model_pick = autotune_pipeline(plan3, PIPE_STAGES, constants=fitted,
                                   grains=SWEEP_MB, microbatches=SWEEP_M)
    print(f"[6] autotune_pipeline(cifar10 3-stage, 3 slots, the measured rows) ({smi}): "
          f"{pick.summary()}; on the fitted model alone: {model_pick.summary()}")

    # 5j's LM training step and the scan's recomputed backward, last: the
    # heaviest profiles of the script.
    time_lm_training(smi)

    # -- 5k. the dry run, after every profile: it needs no profiler, and a
    # profile after it (the pipeline sweep) once recorded no kernel.
    dryrun_launches = phase_5k(smi)

    check(join_watchdogs(30.0) == 0, "a watchdog thread is still running at the end")
    torch.cuda.synchronize()

    # -- 7. the record ------------------------------------------------------------
    for rec in kernels:
        rec["launches_5f"] = pipe_launches.get(rec["name"], 0)
        rec["launches_5g"] = train_launches.get(rec["name"], 0)
        rec["launches_5h"] = static_launches.get(rec["name"], 0)
        rec["launches_5i"] = family_launches.get(rec["name"], 0)
        rec["launches_5j"] = lm_train_launches.get(rec["name"], 0)
        rec["launches_5k"] = dryrun_launches.get(rec["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 — any failed phase fails the run
        import traceback

        traceback.print_exc()
        sys.exit(1)
