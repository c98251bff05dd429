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
     layers; the int8 single-layer kernel's wgmma path at VGG-16's
     layers VGG16_CHECK_LAYERS (224x224, C 128 and 512, with and without
     the 2x2 pool), bit for bit, every launch on that path; pow2_matmul
     in both modes at the cifar10 and lenet5 head shapes;
  3c. hold the selective scan against its plain version at the
     falcon-mamba layer (Bz 4, S 512, D 8192, N 16) in bf16 and f32 with
     zero and carried state, at decode (S = 1), at N = 64 and at D of 200
     and 8200, which no CTA's channels divide; its gradient (the backward
     kernel) against autograd of the reference's composition at the
     training layer in bf16 and f32, with a carried state and h_last
     read, at ragged D and S and at N 32 and 64 (SSM_BWD_CASES: each leaf
     within relative L2 1e-4, two calls bit for bit); and the seed conv at the
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
     answer bit for bit against plan(x) (the plan's CUDA graph) and eager
     forward on the group as the engine pads it, and against the
     plain-version forward;
  4b. the int8 and pow2 path on an on-grid B=256 batch: plan (a)
     QuantSpec(weight_bits=8, act_bits=8, int8_compute=True), fused and
     vmem_budget=0, bit for bit against the 8-bit fake-quant plan; plan
     (b) QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True,
     per_layer_bits=(8, 8, 8)), bit for bit against its fake-quant twin
     (fp32 kernels, fp32-decode head); plan (c) QuantSpec(pow2_weights=
     True) against the plain-version forward;
  5b. serve the same burst through Engine(plan (b)) and hold every answer
     bit for bit against plan (b)(x) and eager forward on the padded group;
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
     n_microbatches=4), whose rung is one CUDA graph (a JittedForward
     captured once, in its warmup probe), every answer equal to the plan
     on the padded group and the rung staying mesh; a DeviceLoss on the
     mesh rung's graph demotes to fused with no retry, a StalledDispatch
     past its watchdog demotes and the abandoned attempt launches nothing;
     verify_plan(scopes=("pipeline",)) on a replay of the rung's graph
     finds no error on either plan and one V103 warning on the boxed
     runner; no plain version is called;
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
     forward, no plain version is called, the phase takes under 60 s
     (its 60 lenet5 steps and pow2 steps run through train_cnn, so
     through the graph of 5n);
  5n. the CNN train step as one CUDA graph per (topology, quant mode,
     batch) (paper/train_cnn.py jit_train_step): (e) the QAT exponent's
     formula on the card equal to the CPU's at every float32 within 1,024
     ulps of each power of two, torch.ldexp exact; for lenet5 and cifar10
     at full width, B=128, in fp32, QAT 8/8, QAT 4/4 and pow2: (a) 20
     graph steps bit for bit 20 eager train_steps from the same init on
     the same batches (params, both moments, step, loss, grad norm); (b)
     one capture a key, the caller's trees unchanged, the launches over
     the 20 steps equal to the eager steps' (the warm-up an eager step,
     each replay its capture's), memory_allocated flat over 100 replays
     (QAT 8/8); (c) an eager step under set_sync_debug_mode("error")
     raises nothing; (d) a replay logs the forward's stream-conv (and in
     pow2 the pow2) launches; (f) train_cnn lenet5 through the graph, 10
     steps, losses within rtol 1e-4 of the CPU's run; (g) the cifar10
     ResilientTrainer of 5g through the graph, bit for bit the clean run;
     (h) eager against graph ms a step (host clock, CUDA events), frames/s
     and the card's busy share (profiler); no plain version is called,
     under 120 s;
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
     kernel's autograd Function (its backward the backward kernel, once
     a layer) against autograd of the plain composition on the card
     (each leaf finite, nonzero, within a relative L2 error of 1e-4),
     remat='full' bit-equal with the scan launched twice a layer and its
     backward once, µbatches 1 and 2: the accumulated
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
     (d) examples/torch/quickstart.py, serve.py (also with --pow2 and
     with --arch falcon-mamba-7b: its decode through the jitted step's
     graph) and train_lm.py at their default sizes print OK (5o (e):
     quickstart's 30 and train_lm's 20 steps each through one
     JittedTrainStep key, one capture, every later step a replay); (e)
     the scan's kernels launch (the backward once a layer a step), their
     plain versions are never called; under 180
     s. falcon-mamba's bf16 weights that phase 6 times are set aside
     during the phase and 5o and drawn again after them from the same
     seed;
  5o. the LM train step as one CUDA graph per (batch, trees)
     (launch/steps.py JittedTrainStep): (a) falcon-mamba-7b at 5j (b)'s
     configuration (4 layers at full width, bf16, remat 'full', AdamW
     with the f32 master copy, B=4, S=512) through jit_train_step, the
     params and optimizer state donated and each call's trees handed
     back: two eager steps from one state bit for bit, then 10 graph
     steps side by side with 10 eager make_train_step steps from the same
     init on the same 10 batches, every leaf bit for bit (params, master,
     m, v, step; loss, ce, aux, grad norm), ssm_scan counted 2 a layer at
     every jitted call (the forward and remat's recompute on autograd's
     thread) and ssm_scan_bwd 1, one capture, no leaf staged after the
     first call,
     memory_allocated unchanged across every replay, the memory reckoned
     beside max_memory_allocated; (d) an eager step and a replay under
     set_sync_debug_mode("error") raise nothing; (b) train_lm.py's 100m
     preset at full width (12 layers, d 768, vocab 32,768, S 512, B 8,
     f32), its step through its JittedTrainStep (no donation,
     sched(step) on the card) for 20 steps bit for bit its eager
     closure, the trees handed in unchanged; (c) the nine other families
     at 5j (c)'s depth and dtype through jit_train_step, 2 graph steps
     against 2 eager steps (bit for bit; the MoE families within a
     relative L2 of 1e-4): side by side where the eager run and the
     graph key fit the card together by the printed reckoning, else a
     dense family whose eager step fits alone in turn, the eager run
     first and its exact bit checksums held against the graph's after
     it, where the state twice and the eager step's measured peak above
     it fit; an MoE family whose state
     does not fit side by side runs scaled_down() instead; each family
     left out printed with its reckoning; (e) in 5j (d); (f) in phase 6;
     the plain scan never called, under 120 s;
  5l. the plan's jitted closure (jitted_forward(), one CUDA graph of the
     kernels per input shape): cifar10 at full width on fresh plans, the
     fp32 fused plan, its vmem_budget=0 plan, plans (a), (b) and (c), at
     B = 1, 8 and 256: each replay bit for bit equal to eager forward, one
     capture a shape, the replay's launches counted equal to the eager
     call's (a capture's first call counts its eager warm-up too), x
     unchanged under donate=False, the donating closure's buffer read in
     place (no device copy, the verifier's lower_donated); phase 5's burst
     through Engine(plan, microbatch=256) donating and not, every answer
     equal to eager forward on the padded group, the rung fused with one
     capture; a DispatchError past the retries demotes to per_layer, which
     serves through its own graph; two Router tenants (fp32 and plan (b))
     from 4 threads, every answer equal to eager forward; then CUDA-event
     ms of eager forward against the graph at B = 1, 8 and 256 (fp32 and
     plan (b)) and the Engine's host ms per micro-batch eager against the
     graph; no plain version is called, under 60 s;
  5m. the LM decode step as one CUDA graph per (batch, cache)
     (launch/steps.py jit_decode_step, the cache donated, the position a
     card tensor advanced in place), in three parts where the weights are
     on the card: (a) after 5c, falcon-mamba-7b bf16 at full width and
     depth, B=4, after the 512-token prompt, 32 greedy steps, each jitted
     call's logits and every cache leaf bit for bit eager decode_step's,
     the scan counted 64 times at each replay, the plain scan never
     called; (b) in 5i's loop, each of the nine families at its serving
     depth (qwen2.5-3b and recurrentgemma-9b full), 8 steps bit for bit
     eager's, recurrentgemma's prompt ending 4 tokens before its
     2048-slot rings' end so decoding wraps them; (c) in phase 6, eager
     against the graph in ms per step on CUDA events and on the host
     clock, tokens/s, the graph's busy share under the profiler and the
     weight-read bound, for falcon-mamba-7b, recurrentgemma-9b and
     qwen2.5-3b; (d) the peak memory allocated with the graph's pool, per
     family; under 120 s in all;
  5k. (run last, after phase 6's profiles: it needs no profiler, and the
     pipeline sweep's profile once recorded no kernel after it) the dry
     run: launch/dryrun.py's run_cell at full width on the meta
     device for decode_32k of all ten LM configs and train_4k of
     qwen2.5-3b and falcon-mamba-7b, every status ok, the op log's FLOPs
     equal to FlopCounterMode's, beside model_flops, with trace_s; then
     the same recorder over real steps on the card, falcon-mamba-7b bf16
     training (5j's 4 layers, B=4, S=512, one step through the scan's
     kernels) and qwen2.5-3b bf16 prefill of 4 x 512 at full depth: the
     card's log holds the meta trace's FLOPs and op counts per overload,
     the predicted peak (arguments + the log's peak live bytes) lies
     within 10 % of torch.cuda.max_memory_allocated above the cell's
     start, and the step timed without the recorder gives its TFLOP/s
     beside the dense bf16 peak; the scan's kernels launch (the backward
     once a layer), their plain versions are never called;
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
     the lanes its plan takes, and its backward kernel at 5j's training
     layer by its device time and on CUDA events beside its bound, the
     plain backward and the forward kernel, with both backwards' peak
     memory; then the LM's prefill and
     decode step, with their device time by kernel, and the same for
     recurrentgemma-9b and qwen2.5-3b in bf16 at full depth; then the pipeline
     sweep: the 3-stage fp32 plan on the stage mesh over M in {1, 2, 4, 8}
     x µbatch in {16, 32, 64, 128, 256} x overlap, in frames/s, beside the 1-stage
     fused plan and the stages run in sequence, with the profiler's union
     of kernel device time against its sum; the 2-stage plan's serial
     rows; fit_constants on the serial rows, estimate_pipeline beside each
     row and autotune_pipeline's pick; the Engine's mesh rung, its eager
     closure against its CUDA graph, serial and overlapped: ms a call on
     CUDA events and on the host clock, and the Engine's frames/s on
     phase 5's burst; last, 5j's bf16 training step's forward, backward
     and optimizer on CUDA events and on the profiler, with its busy
     share; then 5o (f): ms a step eager against the graph on the host
     clock and on CUDA events, tokens/s and the busy share under the
     profiler, of 5o (a)'s step, the 100m preset's and quickstart.py's
     (the heaviest profiles last: after one, the profiler has dropped
     records of later sessions); every line with the card's name and
     power limit;
  7. print the {"kernels": [...]} line, then the {"ok": true, ...} line.

The launch counts are zeroed just before phase 4 and read just after
phase 5 (the fp32 path), zeroed just before phase 4b and read just after
phase 5b (the int8 and pow2 path), zeroed just before phase 4c's kernel
runs and read just after phase 5c (the LM path), and zeroed just before
phase 5d and read just after it, zeroed just before phase 5e's
traffic and read just after it, and zeroed just before phase 5f's
pipelined runs and read just after them (``launches_5f`` in the record),
and zeroed just before phase 5g's training runs and read just after them
(``launches_5g``), zeroed just before phase 5n's steps and read at its
end (``launches_5n``), zeroed just before phase 5h's verification and
examples and read just after them (``launches_5h``), and zeroed just
before phase 5i and read just after it (``launches_5i``, all 0), and
zeroed just before phase 5j's kernel runs and read at its end
(``launches_5j``), zeroed just before phase 5o and read at its end
(``launches_5o``), zeroed just before phase 5l's captures and read after
its Router (``launches_5l``), zeroed just before phase 5m (a) and read
just after it (``launches_5m``; 5m (b) runs in 5i's window and launches
no port kernel there), and zeroed just before phase 5k's steps on
the card and read at its end (``launches_5k``). A CUDA graph's replay
adds the launches its capture recorded, and the first call of a shape
also its eager warm-up's: they show that each path went through its kernels. Every watchdog thread has ended before the record prints. Reference outputs that need kernel launches are computed
before a path's counts are zeroed.
Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import math
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
# The single-layer int8 kernel's wgmma path at VGG-16's single layers
# (conv layers 2-12 at 224x224, B = BATCH): the layers phase 3 holds bit
# for bit (C 128 pooled at 112 wide, C 512 unpooled at 28, C 512 pooled at
# 14); phase 6 times all eleven. Stream codes over the whole 8-bit grid,
# weight codes in [-8, 8] at a weight scale of 2^-10, so that the outputs
# spread over the grid rather than clip, and a bias of about 0.05.
VGG16_CHECK_LAYERS = (3, 8, 12)
VGG16_W_SCALE = 2.0 ** -10
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
# The scan's gradient against its plain version (autograd of the
# reference's composition on the card): (what, Bz, S, D, N, dtype, h0,
# the cotangent of h_last). Each leaf within a relative L2 error of
# SSM_BWD_REL_L2 (the kernel sums the recurrence in another order; bf16
# leaves round an f32 gradient that differs in its last bits), two calls
# bit for bit.
SSM_BWD_CASES = (("training layer bf16", 4, 512, 8192, 16, "bfloat16", False, False),
                 ("training layer f32", 4, 512, 8192, 16, "float32", False, False),
                 ("carried state and h_last read", 2, 256, 8192, 16, "float32", True, True),
                 ("ragged D and S", 2, 37, 200, 16, "float32", True, True),
                 ("ragged D 8200", 2, 33, 8200, 16, "bfloat16", True, False),
                 ("N 32", 2, 300, 384, 32, "bfloat16", False, True),
                 ("N 64", 2, 64, 1024, 64, "float32", True, True))
SSM_BWD_REL_L2 = 1e-4
SSM_BWD_LEAVES = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")
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
MESH_ITERS = 50  # phase 6: calls of the mesh rung's closures per timing
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
# Phase 5n, the CNN train step as CUDA graphs: the topologies and quant
# modes, the steps held bit for bit against the eager step (at
# TRAIN_BATCH), the schedule's warmup, the replays over which memory is
# held flat, train_cnn's steps against the CPU's, the profiled steps of
# the busy share, and the phase's time limit.
GRAPH_TRAIN_TOPOS = ("lenet5", "cifar10")
GRAPH_TRAIN_MODES = (("fp32", {}), ("QAT 8/8", dict(weight_bits=8, act_bits=8)),
                     ("QAT 4/4", dict(weight_bits=4, act_bits=4)),
                     ("pow2", dict(pow2_weights=True)))
GRAPH_TRAIN_STEPS, GRAPH_TRAIN_WARMUP = 20, 5
GRAPH_TRAIN_REPLAYS = 100
GRAPH_TRAIN_CNN_STEPS = 10
GRAPH_TRAIN_PROFILED = 2
PHASE_5N_LIMIT_S = 120.0
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
# Phase 5o, the LM train step as one CUDA graph per (batch, trees): the
# graph steps of (a) (5j (b)'s configuration, a new batch each step) and
# of (b) (examples/torch/train_lm.py's 100m preset at its default 20
# steps), (c)'s steps a family at 5j (c)'s gate depth; the relative L2
# error within which an MoE family's leaves may sit from the eager
# step's (the backward of MoE's dispatch and combine gathers repeats
# indices: a scatter_add_ that sums in its atomics' order; the gradients'
# gate); the card's room held back from (c)'s reckoning; the steps each
# timing of (f) averages (phase 6) and the profiled repetitions; the
# phase's time limit.
GRAPH_LM_STEPS = 10
GRAPH_100M_PRESET, GRAPH_100M_STEPS = "100m", 20
GRAPH_FAM_STEPS = 2
MOE_GRAPH_REL_L2 = LM_GRAD_REL_L2
GRAPH_FAM_MARGIN = 4e9
GRAPH_LM_TIMED, GRAPH_LM_PROFILED = 5, 2
PHASE_5O_LIMIT_S = 120.0
# Phase 6, what cuda_graphs.capture's release before a capture would cost
# a decode graph: the turns, each with the release and without it.
RELEASE_TURNS = 3
# 8-bit QAT gradients against another device's or another order's sums:
# each tensor within this relative L2 error, the features equal but for
# at most QUANT_MAX_STEP_SHARE elements one quant step apart (a float64
# conv sum alone moves cifar10's by 6.6e-3 on the CPU,
# tests/test_torch_training.py::test_qat8_gradients_move_with_the_last_bit_of_the_conv_sums).
QAT_GRAD_REL_L2 = 2e-2
# The backward's precision on lenet5 at a small batch: the frames (normal,
# seed SEED) under which the port's backward kernels, autograd of the plain
# composition on PyTorch's own convolution and on cuDNN's deterministic
# algorithm are measured against a float64 composition.
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
# Phase 5l, the plan's jitted closure: (plan, its QuantSpec's key, its
# vmem_budget) of the plans captured, the batch sizes of each capture, the
# Router's requests per tenant, the Engine's micro-batches timed on the
# host clock (the first 3 are its warm-up), CUDA-event calls per reading,
# and the phase's time limit.
PHASE_5L_PLANS = (("fp32 fused", "fp32", None), ("fp32 vmem_budget=0", "fp32", 0),
                  ("(a)", "a", None), ("(b)", "b", None), ("(c)", "c", None))
PHASE_5L_SIZES = (1, 8, 256)
PHASE_5L_TENANT_REQUESTS = 6
PHASE_5L_HOST_BATCHES = 23
PHASE_5L_ITERS = 50
PHASE_5L_LIMIT_S = 60.0
# Phase 5m, the LM decode step as one CUDA graph: falcon-mamba's greedy
# steps after 5c's prompt, each of 5i's families' steps after its prompt
# (recurrentgemma-9b's prompt ends GRAPH_RING_LEAD tokens before its
# 2048-slot rings' end, so decoding wraps them), the calls timed in phase
# 6, and the time limit of the phase's three parts together.
DEC_GRAPH_STEPS = 32
FAM_GRAPH_STEPS = 8
GRAPH_RING_LEAD = 4
DEC_GRAPH_ITERS = 20
PHASE_5M_LIMIT_S = 120.0


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
    """cuDNN off, TF32 off: the numerics of the plain composition the
    backward kernels are held to (PyTorch's own convolution)."""
    import torch

    return torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def training_grads(topo, params, x, y, quant, *, plain=False, cudnn=False) -> tuple:
    """(gradients, conv features) of the training loss (what
    ``paper/train_cnn.py``'s ``_loss_fn`` computes) at ``params`` on the
    device of ``x``: through the compiled plan, or ``plain``: native autograd of the per-layer
    composition of ``ref.py`` (cuDNN off, or with ``cudnn`` on cuDNN's
    deterministic algorithm, ``backends.cudnn_backward``) around the same
    compiled plan's baked params and head."""
    import contextlib

    import torch

    from repro_torch.core.dhm import QuantSpec, compile_dhm
    from repro_torch.kernels.backends import cudnn_backward
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers
    from repro_torch.kernels.stream_conv.ref import stream_conv_pyramid_ref
    from repro_torch.tree_util import tree_flatten

    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().to(x.device).requires_grad_() for t in leaves]
    plan = compile_dhm(topo, treedef.unflatten(leaves), quant=QuantSpec(**quant), device=x.device)
    convs = (cudnn_backward() if cudnn else precise_convs()) if plain else contextlib.nullcontext()
    with convs:
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

    from repro_torch.analysis.invariants import planned_backward_launches, planned_launches
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dhm import compile_dhm
    from repro_torch.data import make_image_dataset
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.stream_conv import conv as kconv
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
    # port's backward kernels, and autograd of the plain composition on
    # PyTorch's own convolution and on cuDNN under deterministic, TF32-free
    # flags.
    lenet = topos["lenet5"]
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(rng.normal(size=(PRECISION_BATCH, 28, 28, 1)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 10, size=PRECISION_BATCH)).to(dev)
    truth = f64_grads(lenet, init["lenet5"], xs, ys)

    def rel_err(grads):
        return max(float((a.cpu() - b).norm() / b.norm()) for a, b in zip(grads, truth))

    port_err = rel_err(training_grads(lenet, init["lenet5"], xs, ys, {})[0])
    plain_err = rel_err(training_grads(lenet, init["lenet5"], xs, ys, {}, plain=True)[0])
    cudnn_err = rel_err(training_grads(lenet, init["lenet5"], xs, ys, {}, plain=True,
                                       cudnn=True)[0])
    cpu_err = rel_err(training_grads(lenet, init["lenet5"], xs.cpu(), ys.cpu(), {})[0])
    check(port_err <= 1e-5, f"5g lenet5 B={PRECISION_BATCH}: relative L2 {port_err} against float64")
    print(f"[5g] backward precision, lenet5 B={PRECISION_BATCH} (normal frames) against a float64 "
          f"composition, largest relative L2 of a gradient: the port (its backward kernels) "
          f"{port_err:.3e}, the plain composition on PyTorch's CUDA conv (TF32 off) "
          f"{plain_err:.3e}, on cuDNN (deterministic, TF32 off) {cudnn_err:.3e}, the CPU "
          f"{cpu_err:.3e}")
    torch.cuda.synchronize()

    plain, restore_plain = count_plain_versions()
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    try:
        # One step's gradients, held as in the card tests.
        for n in names:
            xb, yb = batch[n]
            plan_n = compile_dhm(topos[n], init[n], device=dev)
            want_launches = planned_launches(plan_n)
            want_bwd = planned_backward_launches(plan_n)
            for m, q in modes.items():
                before = dict(kconv.LAUNCHES)
                got, feats = training_grads(topos[n], init[n], xb, yb, q)
                torch.cuda.synchronize()
                n_launches = sum(kconv.LAUNCHES[k] - before[k] for k in kconv.FORWARD_KERNELS)
                n_bwd = sum(kconv.LAUNCHES[k] - before[k] for k in kconv.BACKWARD_KERNELS)
                check(n_launches == want_launches and n_bwd == want_bwd,
                      f"5g {n} {m}: {n_launches} forward and {n_bwd} backward stream-conv launches "
                      f"where the plan plans {want_launches} and {want_bwd}")
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
    check(launches["stream_conv_pyramid"] > 0 and launches["stream_conv_bwd_dw"] > 0
          and launches["pow2_matmul"] > 0, f"the training path's launches: {launches}")

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
            # The loss and its gradient through the port (its backward
            # kernels) against autograd of the plain composition on
            # PyTorch's own CUDA convolution and on cuDNN (deterministic,
            # TF32 off), host clock.
            grad_ms = {}
            for what, kw in (("port", {}), ("plain", dict(plain=True)),
                             ("cuDNN", dict(plain=True, cudnn=True))):
                training_grads(topos[n], st[0], xb, yb, q, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TRAIN_TIMED_STEPS):
                    training_grads(topos[n], st[0], xb, yb, q, **kw)
                torch.cuda.synchronize()
                grad_ms[what] = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
            print(f"[5g] {n} loss and gradient at B={TRAIN_BATCH} ({smi}): {grad_ms['port']:.3f} ms "
                  f"through the port's backward kernels, {grad_ms['plain']:.3f} ms through the "
                  f"plain composition on PyTorch's CUDA convolution, {grad_ms['cuDNN']:.3f} ms on "
                  "cuDNN (deterministic, TF32 off), host clock")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5G_LIMIT_S, f"phase 5g took {elapsed:.1f} s")
    print(f"[5g] training path launches: { {k: v for k, v in launches.items() if v} }; plain "
          f"versions called 0 times; phase {elapsed:.1f} s ({t_checks:.1f} s of checks, "
          f"{elapsed - t_checks:.1f} s of timing)")
    return launches


def phase_5n(smi: str) -> dict:
    """The CNN train step as CUDA graphs on the card (phase 5n,
    ``paper/train_cnn.py`` ``jit_train_step``). Returns the launches of
    the phase's window."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.quant.fixed_point import ceil_log2_each
    from repro_torch.data import make_image_dataset
    from repro_torch.kernels import probe
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn
    from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine
    from repro_torch.paper.train_cnn import jit_train_step, train_cnn, train_step
    from repro_torch.runtime import FaultInjector, ResilientTrainer
    from repro_torch.tree_util import tree_flatten

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = AdamWConfig(weight_decay=0.01)
    sched = linear_warmup_cosine(3e-3, warmup_steps=GRAPH_TRAIN_WARMUP,
                                 total_steps=GRAPH_TRAIN_STEPS)

    def leaves(*trees):
        return [t for tree in trees for t in tree_flatten(tree)[0]]

    def counts():
        return {**kconv.LAUNCHES, **kpow2.LAUNCHES}

    # (e) the QAT exponent's formula on the card against the CPU's at every
    # float32 within 1,024 ulps of each power of two, and the scale's ldexp.
    k = np.arange(-126, 128)
    grid = ((k + 127) << 23)[:, None] + np.arange(-1024, 1025)[None, :]
    v = torch.from_numpy(grid.reshape(-1).astype(np.int32).view(np.float32))
    got_e = ceil_log2_each(v.to(dev)).cpu()
    apart = torch.nonzero(got_e.view(torch.int32) != ceil_log2_each(v).view(torch.int32)).flatten()
    e = torch.arange(-149, 128, dtype=torch.float32)
    ldexp_ok = torch.equal(torch.ldexp(torch.ones_like(e), e),
                           torch.ldexp(torch.ones_like(e).to(dev), e.to(dev)).cpu())
    check(apart.numel() == 0 and ldexp_ok,
          f"5n exponent: {apart.numel()} of {v.numel()} values apart from the CPU's "
          f"(first {[(float(v[i]), float(got_e[i])) for i in apart[:5]]}); ldexp exact {ldexp_ok}")

    # The formula on the float32 log of each device, as a record of where
    # the card's logf and the CPU's part: 2^k + u ulps, the card's exponent
    # and the CPU's.
    def f32_log_formula(t):
        inv_ln2 = torch.full((), 1.0 / math.log(2.0), dtype=torch.float32, device=t.device)
        return torch.ceil(torch.log(torch.clamp(t, min=1e-12)) * inv_ln2)

    card32, cpu32 = f32_log_formula(v.to(dev)).cpu(), f32_log_formula(v)
    off = torch.nonzero(card32 != cpu32).flatten().tolist()
    flat = grid.reshape(-1)
    where = [f"2^{int(k[i // 2049])}{int(flat[i] - ((k[i // 2049] + 127) << 23)):+d}:"
             f"{int(card32[i])}/{int(cpu32[i])}" for i in off]
    print(f"[5n] (e) the QAT exponent (ceil_log2_each: the steps of ceil(log(max(v, 1e-12)) * "
          f"float32(1/ln 2)) at or below v) on the card equals the CPU's at all {v.numel()} float32 "
          f"values within 1,024 ulps of 2^-126..2^127; torch.ldexp(1, e) exact for e in [-149, "
          f"127]. The formula on each device's float32 log parts at {len(off)} of them "
          "(2^k+ulps:card/CPU): " + " ".join(where))

    names = GRAPH_TRAIN_TOPOS
    topos = {n: ALL_TOPOLOGIES[n] for n in names}
    data = {n: make_image_dataset(hw=t.square_input_hw(), channels=t.input_channels, seed=SEED)
            for n, t in topos.items()}
    init = {n: init_cnn(torch.Generator().manual_seed(SEED), t, device=dev) for n, t in topos.items()}
    batches = {}
    for n in names:
        xt, yt = data[n].x_train.to(dev), data[n].y_train.to(dev)
        rng = np.random.default_rng(SEED + 2)
        idx = [torch.from_numpy(rng.integers(0, xt.shape[0], TRAIN_BATCH)).to(dev)
               for _ in range(GRAPH_TRAIN_STEPS)]
        batches[n] = [(xt[i], yt[i]) for i in idx]
    step_t = [torch.full((), s, dtype=torch.int32, device=dev) for s in range(GRAPH_TRAIN_STEPS)]
    # (f)'s reference, before the counts are zeroed: train_cnn on the CPU
    # (the plain versions) from the same init on the same data.
    lenet = topos["lenet5"]
    ds = make_image_dataset(hw=28, channels=1, seed=0, n_train_per_class=TRAIN_PER_CLASS)
    p0 = init_cnn(torch.Generator().manual_seed(SEED + 1), lenet, device="cpu")
    on_cpu = train_cnn(lenet, steps=GRAPH_TRAIN_CNN_STEPS, dataset=ds, init_params=p0,
                       log_every=1, device="cpu")
    torch.cuda.synchronize()

    plain, restore_plain = count_plain_versions()
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    rows = []
    try:
        for n in names:
            for m, q in GRAPH_TRAIN_MODES:
                opt0 = adamw_init(init[n], cfg)
                kept = [t.clone() for t in leaves(init[n], opt0)]
                runs = {}
                for how in ("eager", "graph"):
                    step_fn = jit_train_step(topos[n], cfg, sched, **q) if how == "graph" else None
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    before = counts()
                    p, o, out = init[n], opt0, []
                    for s, (xb, yb) in enumerate(batches[n]):
                        if s == 1:  # step 0: the eager builds, the graph's warm-up and capture
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            start.record()
                        if step_fn is None:
                            p, o, loss, gnorm = train_step(p, o, xb, yb, sched(step_t[s]),
                                                           topo=topos[n], cfg=cfg, **q)
                        else:
                            p, o, loss, gnorm = step_fn(p, o, xb, yb, s)
                        out.append(leaves(p, o) + [loss, gnorm])
                    end.record()
                    torch.cuda.synchronize()
                    host = (time.perf_counter() - t0) * 1e3 / (GRAPH_TRAIN_STEPS - 1)
                    after = counts()
                    runs[how] = dict(out=out, fn=step_fn, host=host,
                                     events=start.elapsed_time(end) / (GRAPH_TRAIN_STEPS - 1),
                                     launches={k_: after[k_] - before[k_] for k_ in after
                                               if after[k_] != before[k_]})
                eager, graph = runs["eager"], runs["graph"]
                step_fn = graph["fn"]
                # (a) every step bit for bit: params, both moments, the step
                # count, the loss and the gradient norm.
                apart = [s for s, (a, b) in enumerate(zip(graph["out"], eager["out"]))
                         if not all(x_.dtype == y_.dtype and torch.equal(x_, y_) for x_, y_ in zip(a, b))]
                check(not apart, f"5n {n} {m}: graph steps {apart} differ from the eager steps")
                # (b) one capture; the caller's trees unchanged (a step's input
                # is the previous step's output, held above bit for bit).
                check(step_fn._cache_size() == 1, f"5n {n} {m}: {step_fn._cache_size()} captures")
                check(all(torch.equal(a, b) for a, b in zip(leaves(init[n], opt0), kept)),
                      f"5n {n} {m}: the graph wrote the caller's initial trees")
                # The warm-up counts as an eager step, each replay as its capture.
                check(graph["launches"] == eager["launches"] and eager["launches"],
                      f"5n {n} {m}: launches over {GRAPH_TRAIN_STEPS} steps, graph "
                      f"{graph['launches']} against eager {eager['launches']}")
                # (d) a replay logs the forward's kernels.
                xb0, yb0 = batches[n][0]
                with probe.recording() as log:
                    step_fn(init[n], opt0, xb0, yb0, 1)
                logged = sorted({name_ for _, name_, _ in log.launches})
                want_p2 = bool(q.get("pow2_weights"))
                check(any(x_.startswith("stream_conv") for x_ in logged)
                      and ("pow2_matmul" in logged) == want_p2,
                      f"5n {n} {m}: a replay logged {logged}")
                # (c) an eager step synchronises nothing.
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    train_step(init[n], opt0, xb0, yb0, sched(step_t[1]), topo=topos[n], cfg=cfg, **q)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                # (h) the card's busy time a step, eager and graph.
                # A reading the profiler could not take is None (not measured).
                busy = {}
                for how, fn_ in (("eager", lambda: train_step(
                        init[n], opt0, xb0, yb0, sched(step_t[1]), topo=topos[n], cfg=cfg, **q)),
                                 ("graph", lambda: step_fn(init[n], opt0, xb0, yb0, 1))):
                    ms_, by_kernel = device_busy_ms(fn_, GRAPH_TRAIN_PROFILED)
                    busy[how] = None if EVENTS_ROW in by_kernel else ms_
                per_step = sum(eager["launches"].values()) // GRAPH_TRAIN_STEPS
                rows.append((n, m, eager, graph, busy))
                print(f"[5n] {n} {m} B={TRAIN_BATCH}: {GRAPH_TRAIN_STEPS} graph steps bit for bit the "
                      f"eager steps (params, m, v, step, loss, grad norm), one capture, the caller's "
                      f"trees unchanged; {per_step} port-kernel launches a step, a replay logged "
                      f"{logged}; no synchronisation in an eager step")
                if m == "QAT 8/8":
                    # (b) memory over 100 replays.
                    kept_out = step_fn(init[n], opt0, xb0, yb0, 2)
                    torch.cuda.synchronize()
                    mem0 = torch.cuda.memory_allocated(dev)
                    for r in range(GRAPH_TRAIN_REPLAYS):
                        kept_out = step_fn(init[n], opt0, xb0, yb0, r)
                    torch.cuda.synchronize()
                    mem1 = torch.cuda.memory_allocated(dev)
                    del kept_out
                    check(mem1 == mem0 and step_fn._cache_size() == 1,
                          f"5n {n} {m}: memory_allocated {mem0} -> {mem1} over "
                          f"{GRAPH_TRAIN_REPLAYS} replays")
                    print(f"[5n] {n} {m}: memory_allocated {mem0} B before and after "
                          f"{GRAPH_TRAIN_REPLAYS} replays, one capture")
                del runs, eager, graph, step_fn

        # (f) train_cnn through the graph on the card against the CPU's run.
        on_card = train_cnn(lenet, steps=GRAPH_TRAIN_CNN_STEPS, dataset=ds, init_params=p0,
                            log_every=1, device=dev)
        lc, lh = ([h["loss"] for h in r.history] for r in (on_card, on_cpu))
        worst = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        check(len(lc) == GRAPH_TRAIN_CNN_STEPS and worst <= FP32_RTOL,
              f"5n train_cnn lenet5: card losses {lc} against the CPU's {lh}")
        print(f"[5n] (f) train_cnn lenet5 fp32, {GRAPH_TRAIN_CNN_STEPS} steps through the graph: "
              f"losses {lc[0]:.6f} -> {lc[-1]:.6f}, largest relative deviation from the CPU's "
              f"{worst:.2e} (gate {FP32_RTOL}); test accuracy {on_card.float_accuracy:.4f} "
              f"(CPU {on_cpu.float_accuracy:.4f})")

        # (g) the resilient trainer through the graph on cifar10, 5g's faults.
        topo = topos["cifar10"]
        xt, yt = data["cifar10"].x_train.to(dev), data["cifar10"].y_train.to(dev)
        rsched = linear_warmup_cosine(3e-3, warmup_steps=20, total_steps=RESILIENT_STEPS)

        def batch_fn(step):
            idx = np.random.default_rng(SEED + step).integers(0, xt.shape[0], TRAIN_BATCH)
            idx = torch.from_numpy(idx).to(dev)
            return xt[idx], yt[idx]

        state0 = (init["cifar10"], adamw_init(init["cifar10"], cfg))
        kept = [t.clone() for t in leaves(*state0)]
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        finals = {}
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckdir:
            for what, fails in (("clean", ()), ("faulty", RESILIENT_FAILS)):
                jitted = jit_train_step(topo, cfg, rsched)

                def step_fn(state, b, step, jitted=jitted):
                    params, opt, loss, _ = jitted(*state, *b, step)
                    return (params, opt), {"loss": float(loss)}

                tr = ResilientTrainer(step_fn, batch_fn,
                                      CheckpointManager(os.path.join(ckdir, what)),
                                      ckpt_every=RESILIENT_CKPT,
                                      fault_injector=FaultInjector(fail_at_steps=fails))
                state, metrics = tr.run(state0, num_steps=RESILIENT_STEPS)
                finals[what] = (state, metrics, tr.restarts, jitted._cache_size())
        (c_state, c_m, _, c_keys), (f_state, f_m, f_restarts, f_keys) = finals["clean"], finals["faulty"]
        same = all(torch.equal(a, b) for a, b in zip(leaves(*f_state), leaves(*c_state)))
        check(f_restarts == len(RESILIENT_FAILS) and same and int(f_state[1].step) == RESILIENT_STEPS
              and c_keys == f_keys == 1
              and all(torch.equal(a, b) for a, b in zip(leaves(*state0), kept)),
              f"5n resilient cifar10 through the graph: {f_restarts} restarts, bit for bit {same}")
        print(f"[5n] (g) cifar10 ResilientTrainer through the graph, {RESILIENT_STEPS} steps at "
              f"B={TRAIN_BATCH}, checkpoints every {RESILIENT_CKPT}, failures at {RESILIENT_FAILS}: "
              f"{f_restarts} restarts, final params and state bit for bit the clean run's, one "
              f"capture each; last loss {f_m['loss']:.4f} (clean {c_m['loss']:.4f})")
        torch.cuda.synchronize()
    finally:
        restore_plain()
    launches = counts()
    check(all(v_ == 0 for v_ in plain.values()), f"phase 5n called plain versions: {plain}")
    check(launches["stream_conv_pyramid"] > 0 and launches["pow2_matmul"] > 0,
          f"the train graph path's launches: {launches}")
    def busy_text(ms_, events_ms):
        if ms_ is None:
            return "busy not measured (the profiler lost records)"
        return f"busy {ms_:.4f} ms (share {ms_ / events_ms:.3f})"

    for n, m, eager, graph, busy in rows:
        print(f"[5n] (h) {n} {m} training step at B={TRAIN_BATCH} ({smi}): eager "
              f"{eager['host']:.3f} ms (host clock), {eager['events']:.3f} ms (CUDA events), "
              f"{TRAIN_BATCH / eager['host'] * 1e3:.0f} frames/s, "
              f"{busy_text(busy['eager'], eager['events'])}; graph {graph['host']:.3f} ms, "
              f"{graph['events']:.3f} ms, {TRAIN_BATCH / graph['host'] * 1e3:.0f} frames/s, "
              f"{busy_text(busy['graph'], graph['events'])}; {GRAPH_TRAIN_STEPS - 1} steps each")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5N_LIMIT_S, f"phase 5n took {elapsed:.1f} s")
    print(f"[5n] train graph path launches: { {k_: v_ for k_, v_ in launches.items() if v_} }; "
          f"plain versions called 0 times; phase {elapsed:.1f} s")
    return launches


def load_example(file: str):
    """``examples/torch/<file>`` as a module (not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{file[:-3]}",
                                                  os.path.join(ROOT, "examples", "torch", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(phase: str, file: str, argv, returned=None) -> float:
    """``examples/torch/<file>``'s ``main(argv)`` in this process, its
    output echoed under ``[phase]``; fails unless it ends with ``OK``.
    Returns its seconds (host clock, the card synchronized); what
    ``main`` returns is appended to the list ``returned`` if one is
    given."""
    import contextlib
    import io

    import torch

    mod = load_example(file)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    if returned is not None:
        returned.append(out)
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


def phase_5i(smi: str, graph_s: list) -> dict:
    """The other nine LM families on the card (phase 5i), and phase 5m's
    gate on each (its seconds appended to ``graph_s``). Returns the
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
        del cache, logits, tok, toks, kw

        # 5m (b): the decode step as one CUDA graph, bit for bit against
        # eager; recurrentgemma's prompt ends just before its rings' end.
        g_prompt = cfg.window - GRAPH_RING_LEAD if cfg.window else FAM_PROMPT
        toks, kw, n_pre = family_inputs(cfg, FAM_BATCH, g_prompt, gen, dev)
        g = decode_graph_gate(name, params, cfg, toks, kw, n_pre, FAM_GRAPH_STEPS)
        graph_s.append(g["s"])
        wrap = (f"; the {cfg.window}-slot rings wrapped at step {GRAPH_RING_LEAD}"
                if cfg.window else "")
        print(f"[5m] {name} bf16, {serve_depth} of {arch.n_layers} layers, B={FAM_BATCH} after "
              f"a {g_prompt}-token prompt{f' + {n_pre} prefix' if n_pre else ''}: "
              f"{FAM_GRAPH_STEPS} steps of the decode graph bit for bit eager decode_step's"
              f"{wrap}; peak allocated {g['peak'] / 1e9:.2f} GB with the graph's pool and its "
              f"{g['cache_bytes'] / 1e6:.1f} MB static cache; {g['s']:.1f} s ({smi})")
        del params, toks, kw
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
    bwd_plain = kssm_ops.ssm_scan_bwd_ref
    plain_calls = [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return dispatch_plain(*args, **kwargs)

    def counted_bwd_plain(*args, **kwargs):
        plain_calls[0] += 1
        return bwd_plain(*args, **kwargs)

    def plain_scan(x_, dt_, b_, c_, a_, d_skip_, h0_=None, **_):
        return ssm_scan_chunked_ref(x_, dt_, b_, c_, a_, d_skip_, h0_)

    def launches():
        return {k: v for m in mods for k, v in m.LAUNCHES.items()}

    arch = get_arch(LM_ARCH)
    kssm_ops.ssm_scan_ref = counted_plain
    kssm_ops.ssm_scan_bwd_ref = counted_bwd_plain
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
        check(kscan.LAUNCHES["ssm_scan"] == LM_TRAIN_GATE_LAYERS
              and kscan.LAUNCHES["ssm_scan_bwd"] == LM_TRAIN_GATE_LAYERS,
              f"5j gate: ssm_scan launched {kscan.LAUNCHES['ssm_scan']} times, ssm_scan_bwd "
              f"{kscan.LAUNCHES['ssm_scan_bwd']}")
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
        check(kscan.LAUNCHES["ssm_scan"] == 3 * LM_TRAIN_GATE_LAYERS
              and kscan.LAUNCHES["ssm_scan_bwd"] == 2 * LM_TRAIN_GATE_LAYERS,
              f"5j remat='full' launched ssm_scan "
              f"{kscan.LAUNCHES['ssm_scan'] - LM_TRAIN_GATE_LAYERS} times, ssm_scan_bwd "
              f"{kscan.LAUNCHES['ssm_scan_bwd'] - LM_TRAIN_GATE_LAYERS}")
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
              f"the gradient through ssm_scan_bwd, once a layer; remat='full' bit-equal, "
              f"ssm_scan twice a layer, ssm_scan_bwd once; µbatches 2 against 1: "
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
        before = dict(kscan.LAUNCHES)
        for _ in range(LM_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        train_launches = kscan.LAUNCHES["ssm_scan"] - before["ssm_scan"]
        bwd_launches = kscan.LAUNCHES["ssm_scan_bwd"] - before["ssm_scan_bwd"]
        peak = torch.cuda.max_memory_allocated() - base_mem - state_mem
        check(all(math.isfinite(x) for x in losses), f"5j bf16 losses {losses}")
        check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.5 and losses[-1] < losses[0],
              f"5j bf16 losses: first {losses[0]} (ln V {math.log(cfg.vocab_size):.3f}), "
              f"last {losses[-1]}")
        check(train_launches == 2 * LM_TRAIN_LAYERS * LM_TRAIN_STEPS
              and bwd_launches == LM_TRAIN_LAYERS * LM_TRAIN_STEPS,
              f"5j bf16 training launched ssm_scan {train_launches} times, ssm_scan_bwd "
              f"{bwd_launches}")
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
              f"{train_launches} launches (2 a layer a step: the forward and remat's recompute), "
              f"ssm_scan_bwd {bwd_launches} (1 a layer a step); "
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

        # (d) the three LM examples at their default sizes; 5o (e): the two
        # that train run their steps through one graph, replayed.
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        jitted = {}
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckpt:
            ex_s = {"quickstart.py": run_example("5j", "quickstart.py", [],
                                                 jitted.setdefault("quickstart.py", [])),
                    "serve.py": run_example("5j", "serve.py", []),
                    "serve.py --pow2": run_example("5j", "serve.py", ["--pow2"]),
                    "serve.py --arch falcon-mamba-7b": run_example(
                        "5j", "serve.py", ["--arch", "falcon-mamba-7b"]),
                    "train_lm.py": run_example("5j", "train_lm.py", ["--ckpt-dir", ckpt],
                                               jitted.setdefault("train_lm.py", []))}
        for file, n_steps in (("quickstart.py", 30), ("train_lm.py", 20)):
            step_fn = jitted[file][0]
            check(step_fn._cache_size() == 1 and step_fn.captures == 1
                  and step_fn.replays == n_steps - 1 and not step_fn.donate,
                  f"5o (e) {file}: {step_fn._cache_size()} keys, {step_fn.captures} captures, "
                  f"{step_fn.replays} replays over {n_steps} steps")
            print(f"[5o] (e) examples/torch/{file} at its default size: its {n_steps} steps "
                  f"through one JittedTrainStep key (donate=False), 1 capture, "
                  f"{step_fn.replays} replays")
        del jitted, step_fn
    finally:
        mssm.ssm_scan = kernel_scan
        kssm_ops.ssm_scan_ref = dispatch_plain
        kssm_ops.ssm_scan_bwd_ref = bwd_plain
    # (e) the window's launches: the scan's kernels ran, their plain
    # versions never.
    window = launches()
    check(window["ssm_scan"] > 0 and window["ssm_scan_bwd"] > 0, f"phase 5j launches: {window}")
    check(plain_calls[0] == 0,
          f"phase 5j called the plain scan or its gradient {plain_calls[0]} times")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5J_LIMIT_S, f"phase 5j took {elapsed:.1f} s")
    print(f"[5j] LM training: examples at their default sizes "
          + ", ".join(f"{f} {t:.2f} s" for f, t in ex_s.items())
          + f"; launches { {k: v for k, v in window.items() if v} }; the plain scan and its "
          f"gradient called 0 times; phase {elapsed:.1f} s ({smi})")
    return window


def meta_params(cfg):
    """``cfg``'s parameter tree on ``meta`` (shapes and dtypes only), what
    ``jit_train_step`` reckons the optimizer state's shapes from."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import params_shapes

    return params_shapes(cfg, make_mesh((1, 1), ("data", "model"), device="cpu"))[0]


def lm_train_lockstep(tag, jitted, eager, init, batches, moe=False) -> dict:
    """Phase 5o's gate on one configuration. ``init()`` draws (params,
    optimizer state) on the card; ``eager(params, opt, batch, step)`` is
    the eager step. First two eager steps from that state on
    ``batches[0]`` agree bit for bit (within ``MOE_GRAPH_REL_L2`` where
    ``moe``). Then ``jitted`` (the trees each call returns handed back to
    the next) and ``eager`` (its own trees) run side by side from it over
    ``batches``, step s given to the graph as the int s and to the eager
    step as a 0-d int32 tensor on the card: every leaf of the params, the
    optimizer state (step, m, v, master) and the metrics bit for bit (MoE:
    within ``MOE_GRAPH_REL_L2`` relative L2). Without donation the trees
    handed to the first call are held unchanged. Returns the scan's and
    its gradient's launches of each jitted call, ``memory_allocated``
    before each jitted
    call (after a collection) and what the call added to it (a replay
    adds nothing: its outputs replace the last call's), the state's
    bytes, the eager step's peak above it, the peak
    allocated and reserved above the start while the two run side by
    side, the worst MoE error, the leaves of the state and the host ms
    of each call."""
    import gc

    import torch

    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.tree_util import tree_leaves

    dev = torch.device("cuda")
    gc_collect_and_empty()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    p0, o0 = init()
    torch.cuda.synchronize()
    state_b = torch.cuda.memory_allocated() - base
    steps = [torch.full((), s, dtype=torch.int32, device=dev) for s in range(len(batches))]

    def apart(got, want):
        """The leaves that differ, and the largest relative L2 error among
        them."""
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        return bad, max((rel_l2(got[i].float(), want[i].float()) for i in bad), default=0.0)

    torch.cuda.reset_peak_memory_stats()
    first = tree_leaves(eager(p0, o0, batches[0], steps[0]))
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base - state_b
    bad, worst = apart(first, tree_leaves(eager(p0, o0, batches[0], steps[0])))
    del first
    check(not bad or (moe and worst <= MOE_GRAPH_REL_L2),
          f"5o {tag}: two eager steps from one state differ at leaves {bad[:8]} (relative L2 "
          f"{worst:.3e})")
    eager_worst = worst
    gc_collect_and_empty()
    torch.cuda.reset_peak_memory_stats()
    given = [] if jitted.donate else tree_leaves((p0, o0))
    kept = [t.clone() for t in given]
    pg, og, pe, oe = p0, o0, p0, o0
    del p0, o0
    scans, bwds, mem, grew, g_ms, e_ms = [], [], [], [], [], []
    for s, batch in enumerate(batches):
        gc.collect()  # the eager step's cyclic garbage, freed at no fixed time
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        before = dict(kscan.LAUNCHES)
        t0 = time.perf_counter()
        pg, og, mg = jitted(pg, og, batch, s)
        torch.cuda.synchronize()
        g_ms.append((time.perf_counter() - t0) * 1e3)
        grew.append(torch.cuda.memory_allocated() - mem[-1])
        scans.append(kscan.LAUNCHES["ssm_scan"] - before["ssm_scan"])
        bwds.append(kscan.LAUNCHES["ssm_scan_bwd"] - before["ssm_scan_bwd"])
        t0 = time.perf_counter()
        pe, oe, me = eager(pe, oe, batch, steps[s])
        torch.cuda.synchronize()
        e_ms.append((time.perf_counter() - t0) * 1e3)
        got, want = tree_leaves((pg, og, mg)), tree_leaves((pe, oe, me))
        check(len(got) == len(want), f"5o {tag} step {s}: {len(got)} leaves against {len(want)}")
        bad, err = apart(got, want)
        worst = max(worst, err)
        check(not bad or (moe and err <= MOE_GRAPH_REL_L2),
              f"5o {tag} step {s}: leaves {bad[:8]} of {len(got)} differ from the eager step's "
              f"(relative L2 {err:.3e})")
        del got, want
    check(all(torch.equal(a, b) for a, b in zip(given, kept)),
          f"5o {tag}: the graph wrote the trees handed to its first call")
    del given, kept
    out = dict(scans=scans, bwds=bwds, mem=mem, grew=grew, state=state_b, eager_peak=eager_peak,
               peak=torch.cuda.max_memory_allocated() - base,
               reserved=torch.cuda.max_memory_reserved() - base_reserved,
               worst=worst, eager_worst=eager_worst, n_leaves=len(tree_leaves((pg, og))),
               g_ms=g_ms, e_ms=e_ms, final=(pe, oe, pg, og))
    return out


def bit_digest(tree):
    """Per leaf of ``tree``, two exact int64 checksums of its bits on the
    card: the sum of its elements' bit patterns and that sum weighted by
    position mod 65,521. Trees equal bit for bit have equal digests; a
    leaf whose bits differ anywhere changes them but for a chance
    cancellation."""
    import torch

    from repro_torch.tree_util import tree_leaves

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_leaves(tree):
        bits = t.detach().reshape(-1).view(ints[t.element_size()])
        total = weighted = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), 1 << 24):
            chunk = bits[i:i + (1 << 24)].long()
            pos = torch.arange(i, i + chunk.numel(), device=t.device) % 65521 + 1
            total, weighted = total + chunk.sum(), weighted + (chunk * pos).sum()
        out.append(torch.stack([total, weighted]))
    return torch.stack(out)


def lm_train_in_turn(tag, jitted, eager, init, batches) -> dict:
    """Phase 5o (c)'s gate on a configuration whose eager run and graph key
    do not fit the card side by side: the eager run first, then the
    graph's, each from ``init()`` (seeded: the two draws are checked
    equal), one on the card at a time. Two eager steps from that state on
    ``batches[0]`` agree bit for bit; then ``eager`` runs over
    ``batches`` keeping exact checksums of every leaf (:func:`bit_digest`)
    of its params, optimizer state and metrics, its trees are freed, and
    ``jitted`` (donating; each call's trees handed back) runs over the
    same batches, every leaf's checksums equal to the eager step's. The
    graph runs only where the card holds two copies of the state (the
    caller's and the key's) beside the eager step's measured peak above
    it (what the graph's pool holds) and ``GRAPH_FAM_MARGIN``; else the
    result holds ``left_out``, the reason. Returns what
    :func:`lm_train_lockstep` returns, but ``final``."""
    import gc

    import torch

    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.tree_util import tree_leaves

    dev = torch.device("cuda")
    gc_collect_and_empty()
    base = torch.cuda.memory_allocated()
    steps = [torch.full((), s, dtype=torch.int32, device=dev) for s in range(len(batches))]
    p, o = init()
    torch.cuda.synchronize()
    state_b = torch.cuda.memory_allocated() - base
    d_init = bit_digest((p, o))
    torch.cuda.reset_peak_memory_stats()
    d_first = bit_digest(eager(p, o, batches[0], steps[0]))
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base - state_b
    d_again = bit_digest(eager(p, o, batches[0], steps[0]))
    check(torch.equal(d_first, d_again),
          f"5o {tag}: two eager steps from one state differ at leaves "
          f"{torch.nonzero((d_first != d_again).any(-1)).flatten().tolist()[:8]}")
    want, e_ms = [], []
    for s, batch in enumerate(batches):
        t0 = time.perf_counter()
        p, o, m = eager(p, o, batch, steps[s])
        torch.cuda.synchronize()
        e_ms.append((time.perf_counter() - t0) * 1e3)
        want.append(bit_digest((p, o, m)))
    del p, o, m
    gc_collect_and_empty()
    room = torch.cuda.mem_get_info()[0] - GRAPH_FAM_MARGIN
    need = 2 * state_b + eager_peak
    out = dict(state=state_b, eager_peak=eager_peak, need=need, room=room, worst=0.0,
               eager_worst=0.0, e_ms=e_ms)
    if need > room:
        out["left_out"] = (f"the caller's state, the key's and the eager step's peak above it "
                           f"{need / 1e9:.2f} GB against {room / 1e9:.2f} GB free less "
                           f"{GRAPH_FAM_MARGIN / 1e9:.0f}")
        return out
    torch.cuda.reset_peak_memory_stats()
    pg, og = init()
    check(torch.equal(bit_digest((pg, og)), d_init), f"5o {tag}: two seeded inits differ")
    scans, bwds, mem, grew, g_ms = [], [], [], [], []
    for s, batch in enumerate(batches):
        gc.collect()
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        before = dict(kscan.LAUNCHES)
        t0 = time.perf_counter()
        pg, og, mg = jitted(pg, og, batch, s)
        torch.cuda.synchronize()
        g_ms.append((time.perf_counter() - t0) * 1e3)
        grew.append(torch.cuda.memory_allocated() - mem[-1])
        scans.append(kscan.LAUNCHES["ssm_scan"] - before["ssm_scan"])
        bwds.append(kscan.LAUNCHES["ssm_scan_bwd"] - before["ssm_scan_bwd"])
        got = bit_digest((pg, og, mg))
        check(got.shape == want[s].shape,
              f"5o {tag} step {s}: {got.shape[0]} leaves against {want[s].shape[0]}")
        bad = torch.nonzero((got != want[s]).any(-1)).flatten().tolist()
        check(not bad, f"5o {tag} step {s}: leaves {bad[:8]} of {got.shape[0]} differ from "
                       f"the eager step's (their bit checksums)")
    out.update(scans=scans, bwds=bwds, mem=mem, grew=grew, g_ms=g_ms,
               peak=torch.cuda.max_memory_allocated() - base,
               n_leaves=len(tree_leaves((pg, og))))
    return out


def gc_collect_and_empty() -> None:
    """Free what Python still holds and return the cached blocks to the
    card, so that a graph's private pool finds room."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_5o(smi: str) -> dict:
    """The LM train step as one CUDA graph per (batch, trees) on the card
    (phase 5o: ``launch/steps.py`` ``jit_train_step`` and the LM examples'
    ``JittedTrainStep``). Returns the launches of the phase's window."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, synthetic_token_batches
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.ssm_scan import ops as kssm_ops
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.launch.steps import JittedTrainStep, jit_train_step, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.accounting import param_bytes, param_count
    from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 10)
    mods = (kconv, kpow2, kscan, klegacy)
    t_phase = time.perf_counter()
    dispatch_plain, bwd_plain = kssm_ops.ssm_scan_ref, kssm_ops.ssm_scan_bwd_ref
    plain_calls = [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return dispatch_plain(*args, **kwargs)

    def counted_bwd_plain(*args, **kwargs):
        plain_calls[0] += 1
        return bwd_plain(*args, **kwargs)

    def graph_checks(tag, jitted, res, n_steps, scans_per_step, bwds_per_step, staged):
        check(jitted._cache_size() == 1 and jitted.captures == 1
              and jitted.replays == n_steps - 1,
              f"5o {tag}: {jitted._cache_size()} keys, {jitted.captures} captures, "
              f"{jitted.replays} replays over {n_steps} calls")
        check(res["scans"] == [scans_per_step] * n_steps,
              f"5o {tag}: ssm_scan counted {res['scans']} at the jitted calls (eager counts "
              f"{scans_per_step} a step)")
        check(res["bwds"] == [bwds_per_step] * n_steps,
              f"5o {tag}: ssm_scan_bwd counted {res['bwds']} at the jitted calls (eager counts "
              f"{bwds_per_step} a step)")
        check(jitted.staged == staged, f"5o {tag}: {jitted.staged} leaves staged, not {staged}")
        check(not any(res["grew"][1:]),
              f"5o {tag}: memory_allocated added by each jitted call {res['grew']}")

    def ms_text(res):
        g, e = sorted(res["g_ms"][1:]), sorted(res["e_ms"][1:])
        return (f"graph {g[len(g) // 2]:.3f} ms a step (the first call, warm-up and capture, "
                f"{res['g_ms'][0]:.1f}), eager {e[len(e) // 2]:.3f} (host clock, synchronized, "
                f"medians of calls 2-{len(res['g_ms'])}, side by side)")

    for m in mods:
        m.reset_launch_counts()
    kssm_ops.ssm_scan_ref = counted_plain
    kssm_ops.ssm_scan_bwd_ref = counted_bwd_plain
    try:
        # (a) falcon-mamba-7b at full width, 5j (b)'s configuration, through
        # jit_train_step (donated; the returned trees handed back).
        cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LM_TRAIN_LAYERS)
        opt_cfg = AdamWConfig(keep_master_copy=True)
        n, pb = param_count(cfg), param_bytes(cfg)
        state_est = pb + 12 * n  # weights, f32 master, m and v
        peak_est = state_est + 2 * pb  # the new state, the gradients and their clipped copies
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_LEN,
                                   batch_size=LM_TRAIN_BATCH)
        it = synthetic_token_batches(stream, seed=SEED)
        batches = [{"tokens": torch.from_numpy(next(it)["tokens"]).to(dev)}
                   for _ in range(GRAPH_LM_STEPS)]
        jitted, _ = jit_train_step(cfg, None, meta_params(cfg), batches[0], opt_cfg=opt_cfg)
        train = make_train_step(cfg, opt_cfg=opt_cfg)

        def init_a():
            params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
            return params, adamw_init(params, opt_cfg)

        print(f"[5o] (a) {LM_ARCH} reckoning: {n:,} params; the state (bf16 weights, f32 master, "
              f"m, v) {state_est / 1e9:.2f} GB, a step's peak above it at most "
              f"{peak_est / 1e9:.2f} GB (the new state, the gradients and their clipped copies); "
              f"the eager run and the graph's key (its static state and its pool) side by side "
              f"{2 * (state_est + peak_est) / 1e9:.2f} GB")
        start_mem = torch.cuda.memory_allocated()
        res = lm_train_lockstep("(a)", jitted, lambda p, o, b, s: train(p, o, b), init_a, batches)
        graph_checks("(a)", jitted, res, GRAPH_LM_STEPS, 2 * LM_TRAIN_LAYERS, LM_TRAIN_LAYERS,
                     res["n_leaves"])
        pe, oe, pg, og = res.pop("final")
        check(pg is jitted._graphs[next(iter(jitted._graphs))].params,
              "5o (a): the donated step did not return its static params")
        replays = jitted.replays
        # (d) no synchronisation in an eager step, nor in a replay.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            train(pe, oe, batches[0])
            jitted(pg, og, batches[0], GRAPH_LM_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[5o] (a) {LM_ARCH} bf16, {LM_TRAIN_LAYERS} layers at full width, B={LM_TRAIN_BATCH}, "
              f"S={LM_TRAIN_LEN}, remat '{cfg.remat}', AdamW with the f32 master copy, through "
              f"jit_train_step (donated, each call's trees handed back): two eager steps from one "
              f"state bit for bit; {GRAPH_LM_STEPS} graph steps bit for bit {GRAPH_LM_STEPS} eager "
              f"make_train_step steps on {GRAPH_LM_STEPS} batches ({res['n_leaves']} leaves of "
              f"params, master, m, v and step; loss, ce, aux, grad norm); one capture, "
              f"{replays} replays; ssm_scan counted {res['scans'][0]} at every jitted call "
              f"(2 a layer: the forward and remat's recompute on autograd's thread) and "
              f"ssm_scan_bwd {res['bwds'][0]} (1 a layer), as eager counts them; "
              f"{res['n_leaves']} leaves staged at the first call, none after; "
              f"memory_allocated unchanged across every replay ({min(res['mem'][1:])}-"
              f"{max(res['mem'][1:])} B before them, the eager side's garbage apart); (d) an "
              f"eager step and a "
              f"replay under set_sync_debug_mode('error'): nothing raised. Memory: the state "
              f"{res['state'] / 1e9:.2f} GB (reckoned {state_est / 1e9:.2f}), the eager step's "
              f"peak above it {res['eager_peak'] / 1e9:.2f} GB (at most {peak_est / 1e9:.2f}), "
              f"side by side max_memory_allocated {res['peak'] / 1e9:.2f} GB and "
              f"max_memory_reserved {res['reserved'] / 1e9:.2f} GB above the part's start "
              f"(reckoned {2 * (state_est + peak_est) / 1e9:.2f}; the graph's pool is reserved, "
              f"not allocated), {start_mem / 1e9:.2f} GB allocated before it; {ms_text(res)} "
              f"({smi})")
        del pe, oe, pg, og, jitted, train, batches, res
        gc_collect_and_empty()

        # (b) examples/torch/train_lm.py's 100m preset at full width: its
        # step through its JittedTrainStep (no donation, sched(step) on the
        # card) against its eager closure.
        ex = load_example("train_lm.py")
        cfg = ex.make_cfg(GRAPH_100M_PRESET)
        *_, seq, batch = ex.PRESETS[GRAPH_100M_PRESET]
        opt_cfg = AdamWConfig(weight_decay=0.01)
        sched = linear_warmup_cosine(1e-3, warmup_steps=20, total_steps=GRAPH_100M_STEPS)
        eager = ex.make_train_step(cfg, opt_cfg, sched)
        jitted = JittedTrainStep(eager, donate=False)
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch)
        batches = [{"tokens": torch.from_numpy(next(synthetic_token_batches(
            stream, seed=1000 + s))["tokens"]).to(dev)} for s in range(GRAPH_100M_STEPS)]

        def init_b():
            params = T.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
            return params, adamw_init(params, opt_cfg)

        res = lm_train_lockstep("(b)", jitted, eager, init_b, batches)
        graph_checks("(b)", jitted, res, GRAPH_100M_STEPS, 0, 0, GRAPH_100M_STEPS * res["n_leaves"])
        pe = res.pop("final")[0]
        print(f"[5o] (b) train_lm.py --preset {GRAPH_100M_PRESET} at full width "
              f"({param_count(cfg):,} params, {cfg.n_layers} layers, d {cfg.d_model}, vocab "
              f"{cfg.vocab_size:,}, S {seq}, B {batch}, {cfg.dtype}, remat '{cfg.remat}'), "
              f"{GRAPH_100M_STEPS} steps with sched(step) on the card through its JittedTrainStep "
              f"(donate=False): two eager steps bit for bit; every graph step bit for bit the "
              f"example's eager closure (params, m, v, step, loss, grad norm), the trees handed "
              f"in unchanged; one capture, {jitted.replays} replays; memory_allocated unchanged "
              f"across every replay; state {res['state'] / 1e9:.3f} GB, max "
              f"allocated {res['peak'] / 1e9:.2f} GB; {ms_text(res)} ({smi})")
        del pe, jitted, eager, batches, res, ex
        gc_collect_and_empty()

        # (c) the nine other families at 5j (c)'s gate depth and dtype,
        # through jit_train_step: side by side with the eager run where
        # both fit the card, else the eager run first and the graph's
        # after it, by the bits' checksums (lm_train_in_turn). An MoE
        # family (held within MOE_GRAPH_REL_L2, so side by side) whose
        # state does not fit at full width runs scaled_down() instead.
        def reckon(cfg, room):
            """The optimizer's config, the state's and a step's peak's bytes
            reckoned, and the reckoning as text."""
            master = cfg.dtype != "float32"
            n, pb = param_count(cfg), param_bytes(cfg)
            state_est = pb + (12 if master else 8) * n
            peak_est = state_est + 2 * pb
            return (AdamWConfig(keep_master_copy=master), state_est, peak_est,
                    f"{cfg.dtype}, {n:,} params: state {state_est / 1e9:.2f} GB, a step's "
                    f"peak above it at most {peak_est / 1e9:.2f}, side by side "
                    f"{2 * (state_est + peak_est) / 1e9:.2f} GB, in turn "
                    f"{(2 * state_est + peak_est) / 1e9:.2f} (the eager step alone "
                    f"{(state_est + peak_est) / 1e9:.2f}), against {room / 1e9:.2f} GB free "
                    f"less {GRAPH_FAM_MARGIN / 1e9:.0f}")

        for name, gate_depth, _, _ in FAMILIES:
            t0 = time.perf_counter()
            fam = get_arch(name)
            cfg = dataclasses.replace(fam, n_layers=gate_depth, dtype="float32")
            if 2 * param_bytes(cfg) > FAM_TRAIN_FP32_BYTES:
                cfg = dataclasses.replace(fam, n_layers=gate_depth)
            moe = bool(cfg.n_experts)
            gc_collect_and_empty()
            room = torch.cuda.mem_get_info()[0] - GRAPH_FAM_MARGIN
            opt_cfg, state_est, peak_est, reckoning = reckon(cfg, room)
            width = f"{gate_depth} layers at full width"
            side_by_side = 2 * (state_est + peak_est) <= room
            if not side_by_side and (moe or state_est + peak_est > room):
                how = ("the eager run and the graph's key do not fit side by side" if moe
                       else "the eager step alone does not fit")
                print(f"[5o] (c) {name}, {gate_depth} layers at full width: left out, {how} "
                      f"({reckoning})")
                if not moe:
                    continue
                cfg = fam.scaled_down()
                opt_cfg, state_est, peak_est, reckoning = reckon(cfg, room)
                width = (f"scaled_down() ({cfg.n_layers} layers, d {cfg.d_model}, "
                         f"{cfg.n_experts} experts, top {cfg.top_k})")
                side_by_side = True
            toks = []
            for _ in range(GRAPH_FAM_STEPS):
                tk, kw, n_pre = family_inputs(cfg, FAM_TRAIN_BATCH, FAM_TRAIN_LEN + 1, gen, dev)
                toks.append({"tokens": tk, **kw})
            jitted, _ = jit_train_step(cfg, None, meta_params(cfg), toks[0], opt_cfg=opt_cfg)
            train = make_train_step(cfg, opt_cfg=opt_cfg)

            def init_c(cfg=cfg, opt_cfg=opt_cfg):
                params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                                       device=dev)
                return params, adamw_init(params, opt_cfg)

            def eager_c(p, o, b, s, train=train):
                return train(p, o, b)

            if side_by_side:
                res = lm_train_lockstep(f"(c) {name}", jitted, eager_c, init_c, toks, moe=moe)
                res.pop("final")
                run = "side by side"
            else:
                res = lm_train_in_turn(f"(c) {name}", jitted, eager_c, init_c, toks)
                run = "in turn, by the bits' checksums"
                if "left_out" in res:
                    print(f"[5o] (c) {name}, {width}: the eager steps ran ({GRAPH_FAM_STEPS}, "
                          f"two from one state bit for bit; state {res['state'] / 1e9:.2f} GB, "
                          f"the eager step's peak above it {res['eager_peak'] / 1e9:.2f} GB); "
                          f"the graph left out: {res['left_out']} ({reckoning})")
                    del jitted, train, toks, res
                    gc_collect_and_empty()
                    continue
            graph_checks(f"(c) {name}", jitted, res, GRAPH_FAM_STEPS, 0, 0, res["n_leaves"])
            how = (f"within relative L2 {res['worst']:.3e} (gate {MOE_GRAPH_REL_L2}; two eager "
                   f"steps {res['eager_worst']:.3e})" if moe else "bit for bit")
            print(f"[5o] (c) {name}, {width}, B={FAM_TRAIN_BATCH}, S={FAM_TRAIN_LEN}"
                  f"{f' + {n_pre} prefix' if n_pre else ''} ({reckoning}), {run}: "
                  f"{GRAPH_FAM_STEPS} graph steps {how} the eager steps; one capture; state "
                  f"{res['state'] / 1e9:.2f} GB, the eager step's peak above it "
                  f"{res['eager_peak'] / 1e9:.2f} GB, max allocated {res['peak'] / 1e9:.2f} GB; "
                  f"{time.perf_counter() - t0:.1f} s")
            del jitted, train, toks, res
            gc_collect_and_empty()
    finally:
        kssm_ops.ssm_scan_ref = dispatch_plain
        kssm_ops.ssm_scan_bwd_ref = bwd_plain
    window = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check(window["ssm_scan"] > 0 and window["ssm_scan_bwd"] > 0, f"phase 5o launches: {window}")
    check(plain_calls[0] == 0,
          f"phase 5o called the plain scan or its gradient {plain_calls[0]} times")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5O_LIMIT_S, f"phase 5o took {elapsed:.1f} s")
    print(f"[5o] LM train graphs: launches { {k: v for k, v in window.items() if v} }; the plain "
          f"scan and its gradient called 0 times; phase {elapsed:.1f} s ({smi})")
    return window


def time_lm_train_graphs(smi: str) -> None:
    """Phase 5o (f), in phase 6 after the other training profiles: ms a
    step eager against the graph, on the host clock and on CUDA events,
    tokens/s, and the card's busy share under the profiler, for 5o (a)'s
    falcon-mamba-7b step (jit_train_step, donated), train_lm.py's 100m
    preset and quickstart.py's step (their JittedTrainStep, no donation).
    Each eager step runs from the same state every time (its outputs
    dropped); each graph call hands back what the last one returned."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, synthetic_token_batches
    from repro_torch.launch.steps import JittedTrainStep, jit_train_step, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine

    dev = torch.device("cuda")

    def falcon():
        cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LM_TRAIN_LAYERS)
        opt_cfg = AdamWConfig(keep_master_copy=True)
        train = make_train_step(cfg, opt_cfg=opt_cfg)
        jitted, _ = jit_train_step(cfg, None, meta_params(cfg), None, opt_cfg=opt_cfg)
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
        return (f"5o (a) {LM_ARCH} ({LM_TRAIN_LAYERS} layers, B={LM_TRAIN_BATCH}, "
                f"S={LM_TRAIN_LEN}, {cfg.dtype})", lambda p, o, b, s: train(p, o, b), jitted,
                params, adamw_init(params, opt_cfg), LM_TRAIN_BATCH, LM_TRAIN_LEN, cfg.vocab_size)

    def preset_100m():
        ex = load_example("train_lm.py")
        cfg = ex.make_cfg(GRAPH_100M_PRESET)
        *_, seq, batch = ex.PRESETS[GRAPH_100M_PRESET]
        opt_cfg = AdamWConfig(weight_decay=0.01)
        eager = ex.make_train_step(cfg, opt_cfg, linear_warmup_cosine(
            1e-3, warmup_steps=20, total_steps=GRAPH_100M_STEPS))
        params = T.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        return (f"5o (b) train_lm.py --preset {GRAPH_100M_PRESET} (B={batch}, S={seq}, "
                f"{cfg.dtype})",
                eager, JittedTrainStep(eager, donate=False), params,
                adamw_init(params, opt_cfg), batch, seq, cfg.vocab_size)

    def quickstart():
        ex = load_example("quickstart.py")
        cfg = ex.make_cfg()
        opt_cfg = AdamWConfig(weight_decay=0.01)
        eager = ex.make_train_step(cfg, opt_cfg)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        return (f"quickstart.py's step (B=16, S=64, {cfg.dtype})", eager,
                JittedTrainStep(eager, donate=False), params, adamw_init(params, opt_cfg), 16, 64,
                cfg.vocab_size)

    for build in (falcon, preset_100m, quickstart):
        gc_collect_and_empty()
        what, eager, jitted, params, opt, b, s, vocab = build()
        stream = TokenStreamConfig(vocab_size=vocab, seq_len=s, batch_size=b)
        batch = {"tokens": torch.from_numpy(
            next(synthetic_token_batches(stream, seed=SEED))["tokens"]).to(dev)}
        step_t = torch.full((), 1, dtype=torch.int32, device=dev)
        state = [params, opt]
        del params, opt

        def eager_call():
            return eager(state[0], state[1], batch, step_t)

        def graph_call():
            out = jitted(state[0], state[1], batch, 1)
            if jitted.donate:
                state[0], state[1] = out[0], out[1]
            return out

        rows, kernel_ms = {}, {}
        for how, fn in (("eager", eager_call), ("graph", graph_call)):
            gc_collect_and_empty()
            fn()  # the builds; the graph's warm-up and capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_LM_TIMED):
                fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / GRAPH_LM_TIMED
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(GRAPH_LM_TIMED):
                fn()
            end.record()
            torch.cuda.synchronize()
            events = start.elapsed_time(end) / GRAPH_LM_TIMED
            busy, by_kernel = device_busy_ms(fn, GRAPH_LM_PROFILED)
            rows[how] = (host, events, None if EVENTS_ROW in by_kernel else busy)
            kernel_ms[how] = by_kernel
        check(jitted.captures == 1, f"5o (f) {what}: {jitted.captures} captures")

        def row(how):
            host, events, busy = rows[how]
            share = ("busy not measured (the profiler lost records)" if busy is None
                     else f"busy {busy:.3f} ms (share {busy / events:.3f} of the events' span)")
            return (f"{how} {host:.3f} ms (host clock), {events:.3f} ms (CUDA events), "
                    f"{b * s / host * 1e3:.0f} tokens/s, {share}")

        print(f"[6] 5o (f) {what} ({smi}): {row('eager')}; {row('graph')}; means of "
              f"{GRAPH_LM_TIMED} steps after one, the profiler over {GRAPH_LM_PROFILED}")
        if not any(EVENTS_ROW in k for k in kernel_ms.values()):
            # Where the graph's kernels spend more (or less) than eager's.
            diff = {k: kernel_ms["graph"].get(k, 0.0) - kernel_ms["eager"].get(k, 0.0)
                    for k in set(kernel_ms["graph"]) | set(kernel_ms["eager"])}
            print(f"[6] 5o (f) {what}: graph minus eager device ms by kernel, largest first: "
                  + "; ".join(f"{v:+.3f} {k[:70]}" for k, v in
                              sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:5]))
        del eager, jitted, state, batch
    gc_collect_and_empty()


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
    bwd_plain = kssm_ops.ssm_scan_bwd_ref

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return dispatch_plain(*args, **kwargs)

    def counted_bwd_plain(*args, **kwargs):
        plain_calls[0] += 1
        return bwd_plain(*args, **kwargs)

    for m in mods:
        m.reset_launch_counts()
    kssm_ops.ssm_scan_ref = counted_plain
    kssm_ops.ssm_scan_bwd_ref = counted_bwd_plain
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
            before = dict(kscan.LAUNCHES)
            out, rec, counter = record(step, *args, device=dev)
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated() - base
            launched = kscan.LAUNCHES["ssm_scan"] - before["ssm_scan"]
            bwd_launched = kscan.LAUNCHES["ssm_scan_bwd"] - before["ssm_scan_bwd"]
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
                check(launched == 2 * cfg.n_layers and bwd_launched == cfg.n_layers,
                      f"5k {arch}: ssm_scan launched {launched} times, ssm_scan_bwd "
                      f"{bwd_launched}")
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
                  f"ssm_scan launched {launched} times, ssm_scan_bwd {bwd_launched}; the step "
                  f"without the recorder "
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
        kssm_ops.ssm_scan_bwd_ref = bwd_plain
    window = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check(window["ssm_scan"] > 0 and window["ssm_scan_bwd"] > 0, f"phase 5k launches: {window}")
    check(plain_calls[0] == 0,
          f"phase 5k called the plain scan or its gradient {plain_calls[0]} times")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5K_LIMIT_S, f"phase 5k took {elapsed:.1f} s")
    print(f"[5k] dry run: launches { {k: v for k, v in window.items() if v} }; the plain scan "
          f"and its gradient called 0 times; phase {elapsed:.1f} s ({smi})")
    return window


def phase_5l(smi: str, topo, cparams, x, xq, frames, quants) -> dict:
    """The plan's jitted closure on the card (phase 5l): CUDA graphs of the
    kernels, captured per input shape. Returns the launches of the phase's
    window."""
    import numpy as np
    import torch

    from repro_torch.analysis.verify import ProbeContext
    from repro_torch.core.dhm import DispatchError, Engine, FaultPlan, Router, compile_dhm
    from repro_torch.core.dhm.engine import JittedForward, forward
    from repro_torch.core.dhm.pipeline import join_watchdogs
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.stream_conv import conv as kconv

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    frame = tuple(x.shape[1:])

    def counts():
        return {**kconv.LAUNCHES, **kpow2.LAUNCHES}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items() if v != before[k]}

    def eager(plan_, xb):
        with torch.inference_mode():
            return forward(plan_, xb)

    def padded(f):
        return np.concatenate([f, np.zeros((BATCH - f.shape[0],) + f.shape[1:], np.float32)])

    def events_ms(fn, iters=PHASE_5L_ITERS):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # Fresh plans on phase 4's params, so that every capture of the phase
    # is counted from none.
    plans = {what: compile_dhm(topo, cparams, quant=quants[q], vmem_budget=budget)
             for what, q, budget in PHASE_5L_PLANS}
    inputs = {what: (x if q in ("fp32", "c") else xq) for what, q, _ in PHASE_5L_PLANS}
    plain, restore_plain = count_plain_versions()
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    try:
        # (a) each plan's closures at B = 1, 8 and 256 against eager forward.
        for what, plan_ in plans.items():
            fwd, fwd_d = plan_.jitted_forward(), plan_.jitted_forward(donate=True)
            check(isinstance(fwd, JittedForward) and fwd_d.donate and not fwd.donate
                  and plan_.jitted_forward() is fwd, f"5l {what}: closures {fwd!r} {fwd_d!r}")
            for b_ in PHASE_5L_SIZES:
                xb = inputs[what][:b_].contiguous()
                before = counts()
                want = eager(plan_, xb)
                torch.cuda.synchronize()
                per_call = delta(before)
                kept = xb.clone()
                before = counts()
                first = fwd(xb)  # warm-up + capture + replay
                first_launches = delta(before)
                before = counts()
                again = plan_(xb)  # a replay alone
                torch.cuda.synchronize()
                replay_launches = delta(before)
                check(torch.equal(first, want) and torch.equal(again, want),
                      f"5l {what} B={b_}: graph against eager forward, max |delta| "
                      f"{float((first - want).abs().max())}, {float((again - want).abs().max())}")
                check(torch.equal(xb, kept), f"5l {what} B={b_}: donate=False changed the input")
                check(first_launches == {k: 2 * v for k, v in per_call.items()}
                      and replay_launches == per_call,
                      f"5l {what} B={b_}: eager {per_call}, first call {first_launches}, "
                      f"replay {replay_launches}")
                rep = ProbeContext(plan_, batch=b_).lower_donated()
                check(rep.declared and rep.input_copies == 0,
                      f"5l {what} B={b_}: the donating closure copied its buffer: {rep}")
                with fwd_d.lock:
                    buf = fwd_d.input_buffer(tuple(xb.shape))
                    buf.copy_(xb)
                    donated = fwd_d(buf)
                check(torch.equal(donated, want), f"5l {what} B={b_}: donating closure")
            check(fwd._cache_size() == len(PHASE_5L_SIZES)
                  and fwd_d._cache_size() == len(PHASE_5L_SIZES),
                  f"5l {what}: {fwd._cache_size()} and {fwd_d._cache_size()} captures for "
                  f"{len(PHASE_5L_SIZES)} shapes")
            print(f"[5l] {what}: jitted_forward() at B={PHASE_5L_SIZES} bit for bit equal to eager "
                  f"forward, one capture a shape (donate=False and True), x unchanged, replay "
                  f"launches {replay_launches} equal to the eager call's, the donating closure's "
                  f"buffer read in place (0 device copies)")

        # (b) phase 5's burst through Engine(plan, microbatch=256), donating
        # and not, on plans of their own.
        fused0 = plans["fp32 fused"]
        for donate in (True, False):
            plan_e = compile_dhm(topo, cparams, quant=quants["fp32"])
            eng = Engine(plan_e, microbatch=BATCH, auto_flush=True, donate=donate,
                         default_deadline_ms=10_000.0)
            reqs = [eng.submit(f) for f in frames]
            answers = [r.result(timeout=120.0) for r in reqs]
            eng.stop()
            for f, got in zip(frames, answers):
                want = eager(fused0, torch.from_numpy(padded(f)).to(dev))[: f.shape[0]].cpu()
                check(torch.equal(got, want), f"5l engine donate={donate}: max |delta| "
                      f"{float((got - want).abs().max())} against eager forward")
            st_ = eng.stats()
            check(eng.rung == "fused" and eng.demotions == [] and st_.n_errors == 0
                  and isinstance(eng._fwd, JittedForward) and eng._fwd.donate is donate
                  and eng._fwd._cache_size() == 1,
                  f"5l engine donate={donate}: rung {eng.rung}, {st_.summary()}, "
                  f"captures {getattr(eng._fwd, '_cache_size', lambda: None)()}")
            print(f"[5l] Engine(plan, microbatch={BATCH}, donate={donate}): {len(frames)} requests "
                  f"on rung fused through one graph, every answer bit for bit equal to eager "
                  f"forward on the padded group; {st_.n_batches} micro-batches")
        plan_f = compile_dhm(topo, cparams, quant=quants["fp32"])
        eng_f = Engine(plan_f, microbatch=BATCH, retry_backoff_s=1e-4,
                       fault_plan=FaultPlan([DispatchError(at=0, times=3)]))
        got_f = eng_f.infer(frames[0])
        want_f = eager(plans["fp32 vmem_budget=0"], torch.from_numpy(padded(frames[0])).to(dev))
        check(eng_f.rung == "per_layer" and [d["rung"] for d in eng_f.demotions] == ["fused"]
              and isinstance(eng_f._fwd, JittedForward) and eng_f._fwd._cache_size() == 1
              and torch.equal(got_f, want_f[: frames[0].shape[0]].cpu()),
              f"5l demotion: rung {eng_f.rung}, demotions {eng_f.demotions}")
        print(f"[5l] a DispatchError past 2 retries demotes fused -> per_layer, which serves "
              f"through its own graph (1 capture), bit for bit equal to the vmem_budget=0 plan's "
              f"eager forward")
        # Two tenants from 4 threads.
        tenants = {"fp32": compile_dhm(topo, cparams, quant=quants["fp32"]),
                   "int8": compile_dhm(topo, cparams, quant=quants["b"])}
        rng_l = np.random.default_rng(SEED + 12)
        traffic = [(t_, rng_l.normal(size=(int(rng_l.integers(1, BATCH + 1)),) + frame)
                    .astype(np.float32)) for _ in range(PHASE_5L_TENANT_REQUESTS)
                   for t_ in tenants]
        results = {}
        router = Router(microbatch=BATCH, default_deadline_ms=MT_DEADLINE_MS, join_timeout_s=60.0)
        for t_, p_ in tenants.items():
            router.add(t_, p_)

        def submitter(tid):
            for i in range(tid, len(traffic), MT_SUBMITTERS):
                results[i] = router.submit(*traffic[i])

        with router:
            threads = [threading.Thread(target=submitter, args=(tid,))
                       for tid in range(MT_SUBMITTERS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            answers = {i: r.result(timeout=60.0) for i, r in results.items()}
        for i, (t_, f) in enumerate(traffic):
            want = eager(tenants[t_], torch.from_numpy(padded(f)).to(dev))[: f.shape[0]].cpu()
            check(torch.equal(answers[i], want), f"5l router {t_} request {i}: max |delta| "
                  f"{float((answers[i] - want).abs().max())} against eager forward")
        for t_ in tenants:
            check(router.engine(t_).rung == "fused", f"5l router {t_}: {router.engine(t_).rung}")
        print(f"[5l] Router, tenants fp32 and plan (b), {len(traffic)} requests from "
              f"{MT_SUBMITTERS} threads: every answer bit for bit equal to eager forward")
        torch.cuda.synchronize()
    finally:
        restore_plain()
    launches = counts()
    check(all(v == 0 for v in plain.values()), f"phase 5l called plain versions: {plain}")
    for key in ("stream_conv_pyramid", "stream_conv_fused", "stream_conv_pyramid_int8",
                "pow2_matmul", "pow2_matmul_int"):  # plan (a)'s one group is a pyramid
        check(launches[key] > 0, f"phase 5l never launched {key}")
    check(join_watchdogs(30.0) == 0, "a watchdog thread is still running after phase 5l")

    # (c) timing: eager forward against the graph, and the Engine's host ms
    # per micro-batch with its fused rung eager against the graph.
    for what in ("fp32 fused", "(b)"):
        plan_ = plans[what]
        fwd = plan_.jitted_forward()
        for b_ in PHASE_5L_SIZES:
            xb = inputs[what][:b_].contiguous()
            e_ms = events_ms(lambda: eager(plan_, xb))
            g_ms = events_ms(lambda: fwd(xb))
            print(f"[5l] {what} B={b_}: eager forward {e_ms:.4f} ms, graph {g_ms:.4f} ms "
                  f"(CUDA events, {PHASE_5L_ITERS} calls queued; {smi})")
    host = {}
    for mode in ("eager", "graph"):
        eng = Engine(plans["fp32 fused"], microbatch=BATCH)
        if mode == "eager":
            eng._fwd = lambda xb, p_=plans["fp32 fused"]: eager(p_, xb)
        batches = [np.random.default_rng(SEED + 20 + i).normal(size=(BATCH,) + frame)
                   .astype(np.float32) for i in range(PHASE_5L_HOST_BATCHES)]
        for i, f in enumerate(batches):
            if i == 3:
                eng.reset_stats()
            eng.infer(f)
        st_ = eng.stats()
        host[mode] = st_.busy_s / st_.n_batches * 1e3
    print(f"[5l] Engine micro-batch of {BATCH} on rung fused, host clock per micro-batch (mean of "
          f"{PHASE_5L_HOST_BATCHES - 3}): eager {host['eager']:.4f} ms, graph {host['graph']:.4f} "
          f"ms ({smi})")
    elapsed = time.perf_counter() - t_phase
    check(elapsed < PHASE_5L_LIMIT_S, f"phase 5l took {elapsed:.1f} s")
    print(f"[5l] launches { {k: v for k, v in launches.items() if v} }; plain versions called 0 "
          f"times; phase {elapsed:.1f} s ({smi})")
    return launches


def ssm_bwd_bound(bz, s, d, n, elem) -> tuple:
    """The least time the card could take for the scan's gradient at
    (Bz, S, D, N) with x, B and C of ``elem`` bytes (no h0, h_last unread,
    as in training): the largest of its bytes (x, dt, g_y, dx, ddt per
    element; B, C, dB, dC per step; A, dA, D_skip, dD) over the memory
    rate, one exponential a state and step (exp(dt A), which both the
    states and the adjoint need) over the SFU rate, and 20 FLOPs a state
    and step (the state's update 4, the reverse step 16) over the fp32
    peak. Returns (ms, what binds it, (bytes, exp, FLOPs) ms)."""
    nbytes = (bz * s * d * (2 * elem + 3 * 4) + 4 * bz * s * n * elem + 2 * d * n * 4
              + 2 * d * 4)
    t_bytes = nbytes / PEAK_BYTES_S
    t_exp = bz * s * d * n / (SFU_PER_CLOCK_PER_SM * N_SMS * BOOST_CLOCK_HZ)
    t_ops = 20 * bz * s * d * n / PEAK_FP32_FLOPS
    by = "bytes" if t_bytes >= max(t_exp, t_ops) else "operations"
    return max(t_bytes, t_exp, t_ops) * 1e3, by, (t_bytes * 1e3, t_exp * 1e3, t_ops * 1e3)


def time_lm_training(smi: str) -> None:
    """Phase 6's LM training rows: where a step of phase 5j's bf16 training
    (falcon-mamba-7b, LM_TRAIN_LAYERS layers, B x S) spends the card's
    time. The heaviest profiles come last: after one, the profiler has
    dropped records of later sessions."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStreamConfig, synthetic_token_batches
    from repro_torch.launch.steps import VOCAB_CHUNK, make_train_step
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


def decode_graph_gate(tag, params, cfg, toks, kw, n_pre, steps) -> dict:
    """Phase 5m's gate on one model: prefill ``toks`` (B, S) (with the VLM
    or enc-dec inputs ``kw``), then ``steps`` greedy steps through eager
    ``decode_step`` and through ``jit_decode_step(cfg)`` from
    the same cache on the same tokens, the graph's position a device tensor
    advanced in place: each step's logits and every leaf of the two caches
    bit for bit. Returns the scan launches of each jitted call, the seconds
    and the peak memory allocated during the gate (the graph's pool and its
    static cache included)."""
    import torch

    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.launch.steps import jit_decode_step
    from repro_torch.models import transformer as T
    from repro_torch.tree_util import tree_leaves

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start = n_pre + toks.shape[1]
    scans = []
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, toks, max_len=start + steps, **kw)
        decode = jit_decode_step(cfg)
        pos = torch.full((), start, dtype=torch.long, device=toks.device)
        tok = logits.argmax(-1, keepdim=True)
        eager_cache = graph_cache = cache
        for i in range(steps):
            want, eager_cache = T.decode_step(params, cfg, tok, eager_cache, start + i)
            before = kscan.LAUNCHES["ssm_scan"]
            got, graph_cache = decode(params, graph_cache, tok, pos)
            scans.append(kscan.LAUNCHES["ssm_scan"] - before)
            pos.add_(1)
            check(torch.equal(got, want), f"5m {tag} step {i}: the graph's logits differ from "
                  f"eager decode_step's by {float((got.float() - want.float()).abs().max())}")
            bad = [j for j, (a, b) in enumerate(zip(tree_leaves(graph_cache),
                                                   tree_leaves(eager_cache)))
                   if not torch.equal(a, b)]
            check(not bad, f"5m {tag} step {i}: cache leaves {bad} differ from eager's")
            tok = want.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
    check(decode._cache_size() == 1, f"5m {tag}: {decode._cache_size()} captures")
    out = dict(scans=scans, s=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(),
               cache_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(graph_cache)))
    decode.clear()
    return out


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
    from repro_torch.core.dhm.engine import forward
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
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
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
    from repro_torch.models.cnn import VGG16, ALL_TOPOLOGIES, cnn_apply_reference, init_cnn

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
    logs = _nvcc.build(["stream_conv", "stream_conv_bwd", "pow2_matmul", "ssm_scan",
                        "ssm_scan_bwd", "stream_conv_seed"])
    print(f"[2] nvcc build: {time.perf_counter() - t0:.1f} s"
          + ("" if logs else " (library already built in this checkout)"))
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"[2] {name}.cu: {line}")
    kconv._library()  # loads them and checks the descriptor layouts
    kconv._bwd_library()
    kpow2._library()
    kscan._library()
    kscan._bwd_library()
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
    vgg_in, (vh, vw), vc = {}, VGG16.input_shape, VGG16.input_channels
    for li, spec in enumerate(VGG16.conv_layers):
        vgg_in[li] = (vh, vw, vc)
        vh, vw = spec.out_hw(vh, vw)
        vc = spec.n_out

    def vgg16_layer(li):
        """VGG-16 conv layer ``li``'s operands at B = BATCH (values on the
        8-bit grid, weight codes, bias) and its ``stream_conv_block``
        keywords, drawn from the layer's own seed."""
        (hh, ww, cc), spec = vgg_in[li], VGG16.conv_layers[li]
        g = torch.Generator(device=dev).manual_seed(SEED + li)
        xv = torch.randint(-128, 128, (BATCH, hh, ww, cc), generator=g, device=dev) / 64.0
        wq = torch.randint(-8, 9, (3, 3, cc, spec.n_out), generator=g, device=dev,
                           dtype=torch.int8)
        bv = 0.05 * torch.randn(spec.n_out, generator=g, device=dev)
        kw = dict(padding=spec.padding, act=spec.act, pool=spec.pool, act_bits=INT8_BITS,
                  int8_scales=Int8Scales(in_bits=INT8_BITS, w_scale=VGG16_W_SCALE))
        return xv, wq, bv, kw

    errs["stream_conv_fused_int8_wgmma"] = 0.0
    kconv.reset_launch_counts()
    for li in VGG16_CHECK_LAYERS:
        xv, wq, bv, kw = vgg16_layer(li)
        out = stream_conv_block(xv, wq, bv, **kw)
        ref = stream_conv_block_ref(xv, wq, bv, **kw)
        torch.cuda.synchronize()
        what = f"int8 single-layer wgmma path VGG-16 layer {li} {vgg_in[li]} B={BATCH}"
        check(out.shape == ref.shape, f"{what}: {out.shape} vs {ref.shape}")
        check(torch.equal(out, ref), f"{what}: max |delta| {float((out - ref).abs().max())}")
        check(int(torch.unique(ref).numel()) > 8, f"{what}: the outputs clip to the grid's ends")
        print(f"[3] {what}: equal, {int(torch.unique(ref).numel())} distinct outputs")
        del xv, wq, bv, out, ref
    wgmma_launches = kconv.PATH_LAUNCHES["wgmma"]
    check(kconv.PATH_LAUNCHES == {"wgmma": len(VGG16_CHECK_LAYERS), "mma_sync": 0},
          f"VGG-16's single layers took the paths {kconv.PATH_LAUNCHES}, not one wgmma launch each")
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
    errs["ssm_scan_bwd"] = 0.0
    for what, bz, s, d, n, dtype, with_h0, with_gh in SSM_BWD_CASES:
        args = (*ssm_inputs(bz, s, d, n, dtype, with_h0), randn(bz, s, d),
                randn(bz, d, n) if with_gh else None)
        got = kscan.ssm_scan_bwd_cuda(*args)
        again = kscan.ssm_scan_bwd_cuda(*args)
        want = ssm_scan_bwd_ref(*args)
        torch.cuda.synchronize()
        rels = {}
        for name_, g_, a_, w_ in zip(SSM_BWD_LEAVES, got, again, want):
            if w_ is None:
                check(g_ is None, f"ssm_scan_bwd {what}: {name_} without h0")
                continue
            rels[name_] = rel_l2(g_.float(), w_.float())
            check(g_.dtype == w_.dtype and g_.shape == w_.shape
                  and bool(torch.isfinite(g_).all()) and rels[name_] <= SSM_BWD_REL_L2,
                  f"ssm_scan_bwd {what} {name_}: {g_.dtype} {tuple(g_.shape)} against "
                  f"{w_.dtype} {tuple(w_.shape)}, relative L2 {rels[name_]:.3e}")
            check(torch.equal(g_, a_), f"ssm_scan_bwd {what} {name_}: two calls differ")
            errs["ssm_scan_bwd"] = max(errs["ssm_scan_bwd"],
                                       float((g_.float() - w_.float()).abs().max()))
        print(f"[3c] ssm_scan_bwd {what} (Bz {bz}, S {s}, D {d}, N {n}, {dtype}, h0 "
              f"{'carried' if with_h0 else 'zero'}, h_last {'read' if with_gh else 'unread'}): "
              "relative L2 " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + "; two calls bit for bit")
        del got, again, want, args
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
    def padded(f):
        return np.concatenate([f, np.zeros((BATCH - f.shape[0],) + f.shape[1:], np.float32)])

    for f, got in zip(frames, results):
        # plan(x) runs the plan's CUDA graph; eager forward its kernels one
        # by one: both on the group as the engine pads it, bit for bit.
        group = torch.from_numpy(padded(f)).to(dev)
        want = plan(group)[: f.shape[0]].cpu()
        with torch.inference_mode():
            want_eager = forward(plan, group)[: f.shape[0]].cpu()
        plain = cnn_apply_reference(cparams, topo, torch.from_numpy(f).to(dev)).cpu()
        check(got.shape == want.shape, f"engine logits {tuple(got.shape)} vs {tuple(want.shape)}")
        check(torch.equal(got, want) and torch.equal(got, want_eager),
              f"engine logits max |delta| {float((got - want).abs().max())} against plan(x), "
              f"{float((got - want_eager).abs().max())} against eager forward")
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
        group = torch.from_numpy(padded(f)).to(dev)
        want = plan_b(group)[: f.shape[0]].cpu()
        with torch.inference_mode():
            want_eager = forward(plan_b, group)[: f.shape[0]].cpu()
        check(torch.equal(got, want) and torch.equal(got, want_eager), f"engine (b) logits max "
              f"|delta| {float((got - want).abs().max())} against plan(x), "
              f"{float((got - want_eager).abs().max())} against eager forward")
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

    # -- 5m (a). the decode step as one CUDA graph: falcon-mamba ---------------
    # The same prompts, then DEC_GRAPH_STEPS greedy steps through eager
    # decode_step and through the jitted step (the cache donated, the
    # position on the card), bit for bit at every step; each jitted call
    # counts the scan once a layer (the first its eager warm-up, every
    # later one its replay), and the plain scan never runs.
    kscan.reset_launch_counts()
    plain_calls[0] = 0
    kssm_ops.ssm_scan_ref = counted_plain
    try:
        graph_a = decode_graph_gate(LM_ARCH, params16, lm_cfg, prompts, {}, 0, DEC_GRAPH_STEPS)
    finally:
        kssm_ops.ssm_scan_ref = dispatch_plain
    decode_graph_launches = dict(kscan.LAUNCHES)
    check(plain_calls[0] == 0, f"5m called the plain scan {plain_calls[0]} times")
    check(graph_a["scans"] == [n_lm_layers] * DEC_GRAPH_STEPS,
          f"5m jitted calls launched ssm_scan {graph_a['scans']} times")
    check(decode_graph_launches["ssm_scan"] == n_lm_layers * (1 + 2 * DEC_GRAPH_STEPS),
          f"5m launches {decode_graph_launches}")
    graph_s = [graph_a["s"]]
    print(f"[5m] {LM_ARCH} bf16, {n_lm_layers} layers at full width, B={LM_BATCH} after a "
          f"{LM_PROMPT}-token prompt: {DEC_GRAPH_STEPS} steps of the decode graph bit for bit "
          f"eager decode_step's (logits and every cache leaf); ssm_scan {n_lm_layers} launches "
          f"counted at each jitted call; the plain scan never called; peak allocated "
          f"{graph_a['peak'] / 1e9:.2f} GB with the graph's pool and its "
          f"{graph_a['cache_bytes'] / 1e6:.1f} MB static cache; {graph_a['s']:.1f} s ({smi})")
    print(f"[5m] decode graph launches: {decode_graph_launches}")

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
    from repro_torch.core.dhm.engine import JittedForward
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
        # Phase 5's burst through the Engine's mesh rung: one CUDA graph,
        # captured in the rung's warmup probe and replayed for every group.
        pipe_engines = {}
        for what, (p3, _, _) in pipe_in.items():
            eng_p = Engine(p3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                           auto_flush=True, default_deadline_ms=10_000.0)
            graph_p = eng_p._fwd
            check(isinstance(graph_p, JittedForward) and graph_p.donate
                  and graph_p._cache_size() == 1,
                  f"5f engine {what}: the mesh rung is {graph_p!r}, not one donating graph")
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
                  and st_p.n_ok == len(burst) and st_p.n_errors == 0
                  and eng_p._fwd is graph_p and graph_p._cache_size() == 1,
                  f"5f engine {what}: rung {eng_p.rung}, {st_p.summary()}, "
                  f"{graph_p._cache_size()} captures")
            pipe_engines[what] = (st_p, wall_p)
            lat = st_p.rung_latency_ms["mesh"]
            print(f"[5f] engine {what} on the mesh rung (group {eng_p.group} = {PIPE_M} x "
                  f"{BATCH // PIPE_M}): {len(burst)} requests / {n_frames} frames, p50 "
                  f"{lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms, {st_p.frames_per_s:.0f} "
                  f"frames/s busy, {n_frames / wall_p:.0f} frames/s wall, {st_p.n_batches} groups "
                  "through one CUDA graph (one capture); every answer equal to the plan on the "
                  "padded group; 0 retries, 0 demotions")
        # Chaos on the mesh rung: a device loss demotes with no retry; a stall
        # past the watchdog demotes, and the abandoned attempt launches
        # nothing: the only launches are the fused rung's warmup and the
        # request's, and the mesh closure is never entered.
        x_c = frames[3]
        eng_l = Engine(plan3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                       retry_backoff_s=1e-4,
                       fault_plan=FaultPlan([DeviceLoss(at=0, times=None, rung="mesh")]))
        graph_l = eng_l._fwd
        check(isinstance(graph_l, JittedForward) and graph_l._cache_size() == 1,
              f"5f device loss: the mesh rung is {graph_l!r}, not one graph")
        got_l = eng_l.infer(x_c)
        check(eng_l.rung == "fused" and [d["rung"] for d in eng_l.demotions] == ["mesh"]
              and eng_l.stats().n_retries == 0 and graph_l._cache_size() == 1,
              f"5f device loss: rung {eng_l.rung}, "
              f"demotions {eng_l.demotions}, retries {eng_l.stats().n_retries}")
        check(torch.equal(got_l, pipe_direct[("fp32", 3)]), "5f device loss: answer")
        eng_s = Engine(plan3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                       dispatch_timeout_s=MT_DISPATCH_TIMEOUT_S,
                       fault_plan=FaultPlan([StalledDispatch(at=0, times=1, stall_s=30.0,
                                                             rung="mesh")]))
        mesh_calls, mesh_fwd = [], eng_s._fwd
        check(isinstance(mesh_fwd, JittedForward) and mesh_fwd._cache_size() == 1,
              f"5f stall: the mesh rung is {mesh_fwd!r}, not one graph")
        eng_s._fwd = lambda xb: mesh_calls.append(1) or mesh_fwd(xb)
        torch.cuda.synchronize()
        before = sum(kconv.LAUNCHES.values())
        t0 = time.perf_counter()
        got_s = eng_s.infer(x_c)
        check(join_watchdogs(30.0) == 0, "5f: a watchdog thread outlived the stall")
        stall_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        n_after = sum(kconv.LAUNCHES.values()) - before
        check(mesh_calls == [] and eng_s.rung == "fused" and mesh_fwd._cache_size() == 1
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
        # The verifier's pipeline scope on both plans, exact and boxed: each
        # probe reads one replay of the mesh rung's graph.
        for what, (p3, _, _) in pipe_in.items():
            pr_ = make_pipeline_probe(p3, n_microbatches=PIPE_M, microbatch=BATCH // PIPE_M)
            errors = [f.render() for f in verify_plan(p3, scopes=("pipeline",), pipeline=pr_)
                      if f.is_error]
            n_conv = sum(name.startswith("stream_conv") for _, name, _ in pr_.launches)
            check(not errors and len(pr_.transfers) == (PIPE_STAGES - 1) * PIPE_M
                  and n_conv == PIPE_M * per_call[what],
                  f"5f verify_plan({what}, pipeline): {errors}, {len(pr_.transfers)} transfers, "
                  f"{n_conv} stage launches in the replay")
            boxed_ = verify_plan(p3, scopes=("pipeline",), pipeline=make_pipeline_probe(
                p3, n_microbatches=PIPE_M, microbatch=BATCH // PIPE_M, edge_mode="boxed"))
            check([(f.rule, f.severity) for f in boxed_] == [("V103", "warning")],
                  f"5f boxed probe of {what}: {[f.render() for f in boxed_]}")
            print(f"[5f] verify_plan({what}, scopes=('pipeline',)) on a replay of the rung's "
                  f"graph: no error, {n_conv} stage launches, "
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

    # -- 5n. the CNN train step as CUDA graphs --------------------------------------
    train_graph_launches = phase_5n(smi)

    # -- 5h. the static gate and the CNN examples --------------------------------
    static_launches = phase_5h(smi)

    # -- 5i. the other nine LM families --------------------------------------------
    family_launches = phase_5i(smi, graph_s)

    # -- 5j. LM training ---------------------------------------------------------------
    # The bf16 falcon-mamba weights phase 6 times are set aside for the
    # phase's fp32 families and 5o's trees side by side, and drawn again
    # after 5o, from the same seed.
    del params16
    torch.cuda.empty_cache()
    lm_train_launches = phase_5j(smi)

    # -- 5o. the LM train step as one CUDA graph per (batch, trees) -------------
    lm_train_graph_launches = phase_5o(smi)
    params16 = T.init_params(torch.Generator(device=dev).manual_seed(SEED), lm_cfg)

    # -- 5l. the plan's jitted closure: CUDA graphs of the kernels ----------------
    jitted_launches = phase_5l(smi, topo, cparams, x, xq, frames,
                               {"fp32": QuantSpec(), "a": quant_a, "b": quant_b, "c": quant_c})

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

    # The same kernel's wgmma path at VGG-16's eleven single layers, B =
    # BATCH, timed at its wrapper on padded codes with the K-major weights a
    # plan bakes, each output bit for bit its plain version's. The
    # yardstick: torch._int_mm of the layer's unfolded codes (built in int8
    # from the padded frame, untimed) by its weight codes, the int8 products
    # alone; PyTorch has no int8 conv on CUDA. The bound counts 2 operations
    # a MAC, the padded codes and weights read once, the fp32 output
    # written once.
    tot = {"ms": 0.0, "plain": 0.0, "dev": 0.0, "lib": 0.0, "dev_lib": 0.0, "flops": 0,
           "bytes": 0}
    wg_ctas = []
    for li in range(2, len(VGG16.conv_layers)):
        spec = VGG16.conv_layers[li]
        xv, wq, bv, kw = vgg16_layer(li)
        codes = _pad_same(quantize_stream(xv, INT8_BITS), 3).contiguous()
        wk = kconv.kmajor_weights(wq)
        g_i = kconv.fused_plan(*codes.shape[1:], k=3, stride=1, pool=spec.pool, pool_stride=None,
                               block_r=8, n_out=spec.n_out, elem_bytes=1)
        check(g_i["path"] == "wgmma" and len(g_i["strips"]) == len(g_i["slices"]) == 1,
              f"VGG-16 layer {li}: {g_i['path']}, {len(g_i['strips'])} strips, "
              f"{len(g_i['slices'])} slices")
        wg_ctas.append(kconv.ctas_per_sm("stream_conv_fused_int8_wgmma", g_i["smem"],
                                         g_i["threads"]))

        def run_k():
            return kconv.stream_conv_fused_cuda(codes, wq, bv, act=spec.act, pool=spec.pool,
                                                act_bits=INT8_BITS, int8_scales=kw["int8_scales"],
                                                w_kmajor=wk)

        ref = stream_conv_block_ref(xv, wq, bv, **kw)
        check(torch.equal(run_k(), ref), f"VGG-16 layer {li}: the wgmma path differs from its "
              "plain version")
        t_k = time_ms(run_k)
        d_k = device_ms(run_k, kernel="sc_fused_i8_kernel")
        t_p = time_ms(lambda: stream_conv_block_ref(xv, wq, bv, **kw), iters=3, warmup=1)
        del ref, xv
        hh, ww, cc = vgg_in[li]
        a = codes.unfold(1, 3, 1).unfold(2, 3, 1)  # (B, H, W, C, 3, 3)
        a = a.permute(0, 1, 2, 4, 5, 3).reshape(BATCH * hh * ww, 9 * cc).contiguous()
        wmat = wq.reshape(9 * cc, spec.n_out).contiguous()
        if li == 2:
            rows = torch.arange(0, a.shape[0], 9973, device=dev)
            check(torch.equal(torch._int_mm(a, wmat)[rows].double(),
                              a[rows].double() @ wmat.double()),
                  "torch._int_mm yardstick disagrees with VGG-16's int8 products")
        t_l = time_ms(lambda: torch._int_mm(a, wmat), iters=10, warmup=2)
        d_l = device_ms(lambda: torch._int_mm(a, wmat))
        del a, wmat
        f_i = 2 * BATCH * hh * ww * 9 * cc * spec.n_out
        b_i = (codes.numel() + wq.numel() + 4 * spec.n_out
               + 4 * BATCH * g_i["h_keep"] * g_i["w_keep"] * spec.n_out)
        lb_ms, lb_by = bound(f_i, b_i, peak=PEAK_INT8_OPS)
        print(f"[6] int8 single-layer wgmma VGG-16 layer {li} {vgg_in[li]} N {spec.n_out} pool "
              f"{spec.pool} B={BATCH}: {t_k:.4f} ms (CUDA events), {d_k:.4f} ms device, plain "
              f"{t_p:.3f} ms, torch._int_mm {t_l:.4f} ms ({d_l:.4f} ms device), bound "
              f"{lb_ms:.4f} ms ({lb_by}); {f_i / d_k / 1e9:.1f} TOP/s; {g_i['smem']} B of shared "
              f"memory, {g_i['stages']} ring stages, {g_i['r_o']} output rows x "
              f"{g_i['n_rb']} row blocks x {BATCH} images")
        for key, val in (("ms", t_k), ("plain", t_p), ("dev", d_k), ("lib", t_l),
                         ("dev_lib", d_l), ("flops", f_i), ("bytes", b_i)):
            tot[key] += val
        del codes, wk, wq, bv
    torch.cuda.empty_cache()
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peak=PEAK_INT8_OPS)
    print(f"[6] int8 single-layer wgmma VGG-16 layers 2-12 (11 launches): {tot['ms']:.4f} ms "
          f"(CUDA events), {tot['dev']:.4f} ms device, plain {tot['plain']:.3f} ms, "
          f"torch._int_mm {tot['lib']:.4f} ms ({tot['dev_lib']:.4f} ms device), bound "
          f"{b_ms:.4f} ms ({b_by}); {tot['dev'] / b_ms:.2f}x the bound, "
          f"{tot['dev'] / tot['dev_lib']:.2f}x torch._int_mm's device time")
    kernels.append(dict(
        name="stream_conv_fused_int8_wgmma", route="cuda",
        source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:168",
        launches=wgmma_launches, max_abs_err=errs["stream_conv_fused_int8_wgmma"],
        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=tot["lib"],
        device_ms=tot["dev"], library_device_ms=tot["dev_lib"], int_mm_device_ms=tot["dev_lib"],
        ctas_per_sm=min(wg_ctas),
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
    print(f"[6] cifar10 plan(x) (its CUDA graph) B={BATCH}: fused {fwd_ms:.4f} ms, "
          f"vmem_budget=0 {fwd0_ms:.4f} ms")
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

    split = dict.fromkeys(("submit", "flush", "watchdog", "stage", "forward", "sync"), 0.0)

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
    eng6._forward = timed("forward", eng6._forward)  # _stage and the graph's enqueue
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
    ms6["enqueue"] = ms6["forward"] - ms6["stage"]
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
    # The scan's gradient at 5j's training layer (bf16, h0 zero, h_last
    # unread, as a step calls it): the call (the backward kernel and its
    # reduction) on the profiler's clock and on CUDA events, the plain
    # backward (autograd of the reference's composition), the bound, and
    # the peak memory of each.
    bz_, s_ = LM_TRAIN_BATCH, LM_TRAIN_LEN
    args_ = (*ssm_inputs(bz_, s_, di_lm, n_lm, "bfloat16", False), randn(bz_, s_, di_lm), None)
    peaks = {}
    for what, fn in (("kernel", kscan.ssm_scan_bwd_cuda), ("plain", ssm_scan_bwd_ref)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fn(*args_)
        torch.cuda.synchronize()
        peaks[what] = (torch.cuda.max_memory_allocated() - before) / 1e9
    t_k = time_ms(lambda: kscan.ssm_scan_bwd_cuda(*args_), iters=20)
    d_k = device_ms(lambda: kscan.ssm_scan_bwd_cuda(*args_))
    t_p = time_ms(lambda: ssm_scan_bwd_ref(*args_), iters=3, warmup=1)
    b_ms, b_by, terms = ssm_bwd_bound(bz_, s_, di_lm, n_lm, 2)
    plan_b = kscan.scan_bwd_plan(bz_, s_, di_lm, n_lm, n_sms=n_sms)
    print(f"[6] ssm_scan_bwd (Bz {bz_}, S {s_}, D {di_lm}, N {n_lm}, bf16, g_y): {d_k:.5f} ms device "
          f"(the kernel and its reduction), {t_k:.4f} ms (CUDA events), plain {t_p:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}; bytes {terms[0]:.5f}, one expf a state and step "
          f"{terms[1]:.5f}, FLOPs {terms[2]:.5f} ms), {d_k / b_ms:.2f}x the bound, no library "
          f"call; the forward kernel {ssm_times['prefill']['dev']:.5f} ms device; peak "
          f"{peaks['kernel']:.3f} GB above its inputs (the gradients and a "
          f"{plan_b['workspace'] * 4 / 1e9:.3f} GB workspace), the plain {peaks['plain']:.3f} "
          f"GB; plan { {k: plan_b[k] for k in ('lanes', 'npl', 'chunk', 'dc', 'per_sm', 'nblk')} }")
    kernels.append(dict(
        name="ssm_scan_bwd", route="cuda", source="src/repro_torch/csrc/ssm_scan_bwd.cu",
        replaces="src/repro/models/ssm.py:113",
        launches=lm_train_launches["ssm_scan_bwd"], max_abs_err=errs["ssm_scan_bwd"],
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=d_k,
    ))
    del args_

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
        return busy_ms, wall_ms

    # 5m (c): a decode step eager against its CUDA graph, on CUDA events and
    # on the host clock (DEC_GRAPH_ITERS calls, then a synchronize), the
    # graph's busy share under the profiler, beside the weight-read bound.
    def decode_graph_times(name, params_, cfg_, tok_, cache_, index, eager_ms, bound_ms):
        from repro_torch.launch.steps import jit_decode_step

        t0 = time.perf_counter()
        jd = jit_decode_step(cfg_)
        pos = torch.full((), index, dtype=torch.long, device=dev)
        with torch.no_grad():
            _, static = jd(params_, cache_, tok_, pos)

            def eager():
                return T.decode_step(params_, cfg_, tok_, cache_, index)

            def graph():
                return jd(params_, static, tok_, pos)

            graph_ms = time_ms(graph, iters=DEC_GRAPH_ITERS, warmup=2)
            host = {}
            for what, fn in (("eager", eager), ("graph", graph)):
                fn()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(DEC_GRAPH_ITERS):
                    fn()
                torch.cuda.synchronize()
                host[what] = (time.perf_counter() - t1) * 1e3 / DEC_GRAPH_ITERS
            busy, wall = device_breakdown(f"{name} decode step, the graph", graph, 2)
        check(jd._cache_size() == 1, f"5m {name}: {jd._cache_size()} captures while timing")
        jd.clear()
        share = (f"the card busy {busy:.3f} of {wall:.3f} ms ({busy / wall:.3f}) under the "
                 "profiler" if busy > 0 else "busy share not measured (the profiler recorded "
                 "no kernel)")
        print(f"[5m] {name} decode step B={LM_BATCH} bf16, eager against the graph: "
              f"{eager_ms:.3f} / {graph_ms:.3f} ms on CUDA events, {host['eager']:.3f} / "
              f"{host['graph']:.3f} ms on the host clock ({DEC_GRAPH_ITERS} calls, then a "
              f"synchronize); {LM_BATCH / eager_ms * 1e3:.0f} / {LM_BATCH / graph_ms * 1e3:.0f} "
              f"tokens/s; graph {graph_ms / bound_ms:.2f}x the weight-read bound "
              f"{bound_ms:.3f} ms; {share} ({smi})")
        graph_s.append(time.perf_counter() - t0)

    # What the capture sequence's release (cuda_graphs.capture's
    # release=True, the train steps': after the warm-up, a synchronize,
    # gc.collect and torch.cuda.empty_cache) would cost a serving graph,
    # whose capture skips it: a new decode key's first call (its eager
    # warm-up and the capture) and the eager decode step right after it,
    # which finds the allocator's cache emptied, with the release and
    # without it, in turns, on the host clock.
    def capture_release_cost(name, params_, cfg_, tok_, cache_, index):
        import functools

        from repro_torch import cuda_graphs
        from repro_torch.launch.steps import jit_decode_step

        pos = torch.full((), index, dtype=torch.long, device=dev)
        rows = {True: [], False: []}
        plain_capture = cuda_graphs.capture
        with torch.no_grad():
            for release in (True, False) * RELEASE_TURNS:
                jd = jit_decode_step(cfg_)
                T.decode_step(params_, cfg_, tok_, cache_, index)  # the cache warm
                torch.cuda.synchronize()
                if release:
                    cuda_graphs.capture = functools.partial(plain_capture, release=True)
                try:
                    t0 = time.perf_counter()
                    jd(params_, cache_, tok_, pos)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                finally:
                    cuda_graphs.capture = plain_capture
                T.decode_step(params_, cfg_, tok_, cache_, index)
                torch.cuda.synchronize()
                rows[release].append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
                check(jd._cache_size() == 1, f"release cost {name}: {jd._cache_size()} keys")
                jd.clear()
                del jd

        def text(release):
            first = ", ".join(f"{a:.3f}" for a, _ in rows[release])
            after = ", ".join(f"{b:.3f}" for _, b in rows[release])
            return f"first call {first} ms, the eager step after it {after} ms"

        print(f"[6] capture release, {name} decode graph B={LM_BATCH} bf16, {RELEASE_TURNS} turns "
              f"(host clock; {smi}): with the release {text(True)}; without it (the serving "
              f"graphs' capture) {text(False)}")

    device_breakdown(f"prefill {LM_BATCH}x{LM_PROMPT}",
                     lambda: T.prefill(params16, lm_cfg, prompts, max_len=LM_PROMPT + LM_NEW), 1)
    device_breakdown("decode step", lambda: T.decode_step(*dec_args), 2)
    decode_graph_times(LM_ARCH, params16, lm_cfg, tok, lm_cache, LM_PROMPT + LM_NEW, dec_ms,
                       dec_bound)
    capture_release_cost(LM_ARCH, params16, lm_cfg, tok, lm_cache, LM_PROMPT + LM_NEW)

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
        decode_graph_times(name, fam_params, arch, fam_tok, fam_cache, FAM_PROMPT, fam_dec,
                           param_bytes(arch) / PEAK_BYTES_S * 1e3)
        del fam_params, fam_cache, fam_logits, fam_tok, fam_toks
        torch.cuda.empty_cache()

    elapsed = sum(graph_s)
    check(elapsed < PHASE_5M_LIMIT_S, f"phase 5m took {elapsed:.1f} s")
    print(f"[5m] the decode graphs: every step bit for bit eager's; phase {elapsed:.1f} s in "
          f"its three parts ({smi})")

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

    # The Engine's mesh rung, its eager closure (JittedForward.fn: the
    # runner and the head, enqueued from Python) against its CUDA graph:
    # the 3-stage fp32 plan on the stage mesh, B=256 as 4 x 64, serial and
    # overlapped. A call's ms on CUDA events (MESH_ITERS calls queued) and
    # on the host clock (each call synchronized), its kernels' device sum
    # and union on the profiler's clock, then phase 5's burst
    # through the Engine with either closure serving, in turns (eager,
    # graph, graph, eager): frames/s over its busy time and over the wall.
    from repro_torch.core.dhm.engine import JittedForward

    def host_clock_ms(fn, iters=MESH_ITERS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    for ov in (False, True):
        eng_m = Engine(plan3, mesh=pipe_mesh, microbatch=BATCH // PIPE_M, n_microbatches=PIPE_M,
                       overlap=ov, auto_flush=True, default_deadline_ms=10_000.0)
        graph_m = eng_m._fwd
        check(isinstance(graph_m, JittedForward) and graph_m._cache_size() == 1,
              f"[6] mesh rung overlap={ov}: {graph_m!r}")

        def eager_m(xb, fn_=graph_m.fn):
            with torch.no_grad():
                return fn_(xb)

        closures = {"eager": eager_m, "graph": graph_m}
        with torch.no_grad():
            check(torch.equal(eager_m(x), graph_m(x)), f"[6] mesh rung overlap={ov}: graph != eager")
        ms_ev = {k: time_ms(lambda f_=f_: f_(x), iters=MESH_ITERS) for k, f_ in closures.items()}
        ms_host = {k: host_clock_ms(lambda f_=f_: f_(x)) for k, f_ in closures.items()}
        kern = {k: kernel_union(lambda f_=f_: f_(x)) for k, f_ in closures.items()}
        served = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            eng_m._fwd = closures[mode]
            eng_m.reset_stats()
            t0 = time.perf_counter()
            reqs = [eng_m.submit(f) for f in frames]
            for r in reqs:
                r.result(timeout=120.0)
            wall = time.perf_counter() - t0
            st_m = eng_m.stats()
            check(st_m.n_ok == len(frames) and st_m.n_errors == 0 and eng_m.rung == "mesh",
                  f"[6] mesh rung {mode} overlap={ov}: {st_m.summary()}")
            served[mode].append((st_m.frames_per_s, n_frames / wall))
        eng_m.stop()
        check(graph_m._cache_size() == 1, f"[6] mesh rung overlap={ov}: recaptured")
        for mode in ("eager", "graph"):
            print(f"[6] engine mesh rung {mode}, cifar10 fp32 3 stages, {PIPE_M} x "
                  f"{BATCH // PIPE_M}, overlap={ov} ({smi}): {ms_ev[mode]:.4f} ms a call (CUDA "
                  f"events, {MESH_ITERS} calls queued), {ms_host[mode]:.4f} ms (host clock, each "
                  f"call synchronized); "
                  + (f"kernels {kern[mode][2]:.0f} a call, device sum {kern[mode][0]:.4f} ms, union "
                     f"{kern[mode][1]:.4f} ms (busy share {kern[mode][1] / ms_ev[mode]:.3f}); "
                     if kern[mode][2] else "kernels' device time not measured (the profiler "
                     "recorded none); ")
                  + f"phase 5's burst ({n_frames} frames), two runs: "
                  + ", ".join(f"{b:.0f} frames/s busy, {w:.0f} wall" for b, w in served[mode]))

    # 5j's LM training step and the scan's backward kernel against the
    # plain backward, then 5o (f)'s LM train steps eager against their
    # graphs, last: the heaviest profiles of the script. The bf16
    # falcon-mamba serving state is freed first: nothing after reads it.
    del params16, lm_cache, lm_logits, dec_args, tok, prompts
    gc_collect_and_empty()
    time_lm_training(smi)
    time_lm_train_graphs(smi)

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
        rec["launches_5l"] = jitted_launches.get(rec["name"], 0)
        rec["launches_5m"] = decode_graph_launches.get(rec["name"], 0)
        rec["launches_5n"] = train_graph_launches.get(rec["name"], 0)
        rec["launches_5o"] = lm_train_graph_launches.get(rec["name"], 0)
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
