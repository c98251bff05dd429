"""The paper, end to end, on the PyTorch/CUDA port: train LeNet5, pick the
bit-width, classify the constants, estimate FPGA resources under all
three multiplier strategies, report DHM throughput — then run the
GPU analogue through the DHM compiler: ``compile_dhm`` the topology
(topology -> DPN -> stages -> fused-kernel plan, quantization baked in)
and run the plan on one device, as a 2-stage spatial pipeline on a
(2 stage x 2 data) mesh of four stream slots, and behind the serving
Engine.

The counterpart of ``examples/dhm_cnn.py``. It runs on the card unless
given ``--device cpu``; ``--steps`` sets the LeNet5 training steps (the
trained model is cached under ``$REPRO_RESULTS_DIR/cnn/``, default
``results/cnn/``).

    PYTHONPATH=src python examples/torch/dhm_cnn.py
    PYTHONPATH=src python examples/torch/dhm_cnn.py --device cpu --steps 20
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.dhm import (
    CYCLONE_V_5CGXFC9E7,
    Engine,
    MultiplierStrategy,
    QuantSpec,
    balance_report,
    cnn_to_dpn,
    compile_dhm,
    dhm_throughput_gops,
    estimate_resources,
)
from repro_torch.core.dhm.resources import ParamClassFractions
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.cnn import CIFAR10_FULL, LENET5, cnn_apply_reference, init_cnn
from repro_torch.paper.analysis import classify_model
from repro_torch.paper.train_cnn import get_trained_cnn

BITS = 3  # the paper's LeNet5 bit width
STAGES, MICROBATCHES = 2, 6


def _frames(seed: int, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    ap.add_argument("--steps", type=int, default=400,
                    help="LeNet5 training steps (the reference's default)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    # The plain forward the plans are held against runs through PyTorch's
    # own convolution: keep it in full float32 on the card.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("== 1. Train + quantize (paper §4.1) ==")
    trained = get_trained_cnn("lenet5", steps=args.steps, device=dev)
    print(f"LeNet5 float accuracy (synthetic task): {trained.float_accuracy:.3f}")
    stats = classify_model(trained.params, BITS)
    print(f"param classes @ {BITS}b: zero={100*stats.zero:.1f}% "
          f"one={100*stats.one:.1f}% pow2={100*stats.pow2:.1f}% "
          f"other={100*stats.other:.1f}% -> "
          f"{100*stats.multiplierless:.1f}% multiplierless")

    print("\n== 2. DHM resource mapping (paper §4.2, Tables 2-3) ==")
    g = cnn_to_dpn(LENET5, bits=BITS)
    print(f"DPN: {len(g.actors)} actors, {g.total_multipliers()} multipliers,"
          f" {g.total_line_buffer_bits()} line-buffer bits")
    fr = ParamClassFractions(stats.zero, stats.one, stats.pow2, stats.other)
    for strat in MultiplierStrategy:
        rep = estimate_resources(g, CYCLONE_V_5CGXFC9E7, bits=BITS, strategy=strat,
                                 fractions=fr)
        print("  " + rep.summary())

    print("\n== 3. DHM throughput (paper Table 4) ==")
    print("  " + dhm_throughput_gops(LENET5, 65.71).summary())

    print("\n== 4. Compile: topology -> DPN -> stages -> fused plan ==")
    plan = compile_dhm(LENET5, trained.params, quant=QuantSpec(weight_bits=BITS, act_bits=BITS),
                       n_stages=STAGES, device=dev)
    br = balance_report([s.cost_flops for s in plan.stages], plan.n_stages, n_microbatches=8)
    print(f"  {plan.n_stages} stages over {len(plan.conv_params)} conv "
          f"layers: boundaries {plan.assignment.boundaries}, bottleneck "
          f"{plan.assignment.bottleneck/1e3:.0f}k flops, pipeline "
          f"efficiency {br.pipeline_efficiency:.2f}")
    x = _frames(0, (8, 28, 28, 1), dev)
    ref = cnn_apply_reference(trained.params, LENET5, x, weight_bits=BITS, act_bits=BITS)
    logits = plan(x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        out = plan(x)
    _sync(dev)
    us = (time.perf_counter() - t0) / 5 * 1e6
    ok = torch.allclose(logits, ref, atol=1e-4)
    print(f"  quantized compiled plan {tuple(x.shape)} -> "
          f"{tuple(logits.shape)}: matches fake-quant reference={ok}, "
          f"{us:.0f} us/call ({8 / (us * 1e-6):.0f} frames/s)")
    if not torch.isfinite(out).all():
        raise SystemExit("the compiled plan gave non-finite logits")

    print("\n== 4b. Generalized layer vocabulary: cifar10_full ==")
    full_params = init_cnn(torch.Generator().manual_seed(2), CIFAR10_FULL, device=dev)
    full_plan = compile_dhm(CIFAR10_FULL, full_params,
                            quant=QuantSpec(weight_bits=6, act_bits=6), device=dev)
    xf = _frames(3, (4, 32, 32, 3), dev)
    ref_f = cnn_apply_reference(full_params, CIFAR10_FULL, xf, weight_bits=6, act_bits=6)
    ok = torch.allclose(full_plan(xf), ref_f, atol=1e-4)
    shapes = " -> ".join(f"{h}x{w}" for (_, _, _, h, w) in CIFAR10_FULL.conv_shapes())
    print(f"  cifar10_full (3x3/stride-2 overlapping pool, conv dims "
          f"{shapes}): quantized plan matches reference={ok}")

    print("\n== 5. THE SAME LeNet5 plan, spatial pipeline on a mesh ==")
    for st in plan.stages:
        print(f"  stage {st.index}: {st.io.in_shape} -> {st.io.out_shape}")
    mesh = make_mesh((STAGES, 2), ("stage", "data"), device=dev.type)
    mbs = _frames(1, (MICROBATCHES, 4, 28, 28, 1), dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = plan.run_pipelined(mbs, mesh=mesh, data_axis="data")
        seq = torch.stack([plan.features(mbs[i]) for i in range(MICROBATCHES)])
    _sync(dev)
    if not torch.equal(out, seq):
        raise SystemExit("the pipelined features differ from the single-device plan's")
    print(f"  2-stage heterogeneous pipeline on (2 stage x 2 data) stream slots: "
          f"matches single-device plan=True ({time.perf_counter() - t0:.2f}s, "
          f"bubble={plan.n_stages - 1}/{MICROBATCHES + 1} ticks)")

    print("\n== 6. Serving engine: µbatch queue over the same plan ==")
    eng = Engine(plan, microbatch=8)
    reqs = [
        eng.submit(np.random.default_rng(10 + i).normal(
            size=(int(np.random.default_rng(20 + i).integers(1, 6)), 28, 28, 1)
        ).astype(np.float32))
        for i in range(5)
    ]
    eng.flush()
    total = sum(r.result().shape[0] for r in reqs)
    print(f"  served {len(reqs)} requests ({total} frames); {eng.stats().summary()}")
    print("OK")


if __name__ == "__main__":
    main()
