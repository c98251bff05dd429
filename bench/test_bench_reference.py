"""The plain reference against the port on the CPU, at small batches: the
int8 plan's logits equal the reference's bit for bit, and one QAT step
gives the reference's loss, gradient and update."""
import json
from pathlib import Path

import pytest
import torch

from bench import inputs, program
from bench.correct import frames_outside
from bench.reference import cnn as reference

CONFIGS = Path(__file__).resolve().parent / "configs"
MIX = json.loads((Path(__file__).resolve().parent / "traffic" / "train_b128.json").read_text())


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["cifar10-q6", "lenet5-q3"])
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_int8_plan_equals_the_reference(name, seed):
    cfg = _cfg(name)
    topo = cfg["topology"]
    params = inputs.make_params(topo, cfg["init"], seed, "cpu")
    x, _ = inputs.make_frames(topo, cfg["frames"], 24, seed + 1, "cpu")
    with torch.no_grad():
        logits = program.compile_plan(cfg, params, "cpu")(x)
    ref = reference.int8_forward(cfg, params, x, block=16)
    assert frames_outside(logits, ref) == 0
    assert torch.equal(logits, ref)
    # TF32 holds the head's quantized operands exactly.
    assert torch.equal(reference.int8_forward(cfg, params, x, precision="tf32"), ref)


def test_one_bit_fewer_is_outside():
    cfg = _cfg("cifar10-q6")
    topo = cfg["topology"]
    params = inputs.make_params(topo, cfg["init"], 4, "cpu")
    x, _ = inputs.make_frames(topo, cfg["frames"], 16, 5, "cpu")
    ref = reference.int8_forward(cfg, params, x)
    lower = {**cfg, "infer_quant": {**cfg["infer_quant"], "weight_bits": 5, "act_bits": 5}}
    assert frames_outside(reference.int8_forward(lower, params, x), ref) == 16
    altered = ref.clone()
    altered[3, 2] += 2.0 ** -20
    assert frames_outside(altered, ref) == 1
    altered[5, 1] = float("nan")
    assert frames_outside(altered, ref) == 2


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10), 0.1])
    r = reference.round_tf32(t)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2**-9 and r[3] == -(1.0 + 2**-10)
    assert abs(float(r[4]) - 0.1) <= 0.1 * 2**-11


@pytest.mark.parametrize("name", ["cifar10-q6", "lenet5-q3"])
def test_qat_step_matches_the_ports(name):
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.paper.train_cnn import train_step

    cfg = _cfg(name)
    topo = cfg["topology"]
    params = inputs.make_params(topo, cfg["init"], 7, "cpu")
    x, y = inputs.make_frames(topo, cfg["frames"], 12, 8, "cpu")
    opt = AdamWConfig(weight_decay=MIX["weight_decay"])
    lr = reference.learning_rate(MIX, 5)
    new, state, loss, _ = train_step(params, adamw_init(params, opt), x, y, lr,
                                     topo=program.topology(topo), cfg=opt, **cfg["train_quant"])
    mix = {**MIX, "warmup_steps": 0, "total_steps": 10**6}
    ref = reference.qat_steps(cfg, {**mix, "peak_lr": lr}, params, [(x, y)])
    assert float(loss) == pytest.approx(ref["losses"][0], rel=1e-5)
    for m, g in zip(reference.leaves(state.m), ref["first_grad"]):
        torch.testing.assert_close(m.double() / 0.1, g, rtol=1e-3, atol=1e-7)
    # AdamW's first step moves each element by about lr whatever its
    # gradient, so an element whose gradient is near nought moves by
    # round-off: compare each leaf's change as a whole.
    for p, r, p0 in zip(reference.leaves(new), ref["params"], reference.leaves(params)):
        d_prog, d_ref = p.double() - p0.double(), r - p0.double()
        assert float((d_prog - d_ref).norm()) <= 1e-3 * float(d_ref.norm())
