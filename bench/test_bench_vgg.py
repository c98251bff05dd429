"""The VGG configuration, its reference, loop and metrics on the CPU: the
configuration file is the port's ``VGG16``; on a VGG-16-patterned network
at 32x32 with a sixteenth of the channels (relu convs, the relu head, 10
classes) the port's int8 plan gives the reference's features bit for bit
and logits within the cell's limit, its float32 and fake-quant plans the
reference's float forward; the bfloat16 control lies outside the limit;
the loop's check fails a broken timed path; the new metrics read a
hand-built trace. The full-size numbers come from the card
(``tests/test_torch_vgg16_card.py``, ``bench/control_vgg.py``)."""
import json
import time
from pathlib import Path

import pytest
import torch

from bench import harness, inputs
from bench.cell import Cell, Readings
from bench.count import cnn as count
from bench.loops import infer_requests_vgg as loop
from bench.reference import vgg as reference
from bench.trace import Trace

BENCH = Path(__file__).resolve().parent
SPEC = harness.load_spec()
CFG = harness.config(SPEC, "vgg16-q8")
LIMITS = json.loads((BENCH / "limits" / "vgg16-q8.infer.json").read_text())["limits"]
PEAKS = {"int8_ops_per_s": 1.979e15, "fp32_flops_per_s": 6.7e13, "hbm_bytes_per_s": 3.35e12}


def _small() -> dict:
    """VGG-16's pattern at 32x32, a sixteenth of its channels, 10 classes."""
    topo = dict(CFG["topology"], name="vgg16_small", input_hw=32, fc_dims=[256, 256],
                n_classes=10,
                conv_layers=[dict(layer, n_out=layer["n_out"] // 16)
                             for layer in CFG["topology"]["conv_layers"]])
    return dict(CFG, topology=topo, frames=dict(CFG["frames"], n_classes=10))


SMALL = _small()


def _inputs(seed, n=12):
    params = inputs.make_params(SMALL["topology"], SMALL["init"], seed, "cpu")
    x, _ = inputs.make_frames(SMALL["topology"], SMALL["frames"], n, seed + 1, "cpu")
    return params, x


def test_the_config_is_the_ports_vgg16():
    from repro_torch.configs import vgg16

    assert loop.topology(CFG) == vgg16.CONFIG
    assert vgg16.SELECTED_BITS == CFG["bits"] == 8
    assert CFG["infer_quant"] == {"weight_bits": 8, "act_bits": 8, "int8_compute": True}
    topo = CFG["topology"]
    assert count.conv_macs(topo) == vgg16.CONFIG.feature_extractor_macs() == 15_346_630_656
    assert count.head_macs(topo) == 25_088 * 4_096 + 4_096 * 4_096 + 4_096 * 1_000
    n_params = (sum(c * n * k * k + n for c, n, k, *_ in count.conv_shapes(topo))
                + sum(i * o + o for i, o in count.fc_dims(topo)))
    assert n_params == 138_357_544


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_int8_plan_equals_the_reference(seed):
    params, x = _inputs(seed)
    plan = loop.compile_plan(loop.topology(SMALL), SMALL, params, "cpu")
    with torch.no_grad():
        feats, logits = plan.features(x), plan(x)
    ref_feats = reference.features(SMALL, params, x, block=5)
    assert loop.codes_off(feats, ref_feats) == 0
    ref = reference.head(SMALL, params, ref_feats)
    assert loop.logit_gap(logits, ref) <= LIMITS["logit_gap"]


@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "fake_quant8"])
def test_float_plans_match_the_reference(bits):
    """The float32 plan within float32's summation order (rtol 1e-5 of
    the largest logit); the 8-bit fake-quant plan bit for bit, since its
    products and their sums are exact in float32 at this size."""
    from repro_torch.core.dhm.compiler import QuantSpec, compile_dhm

    params, x = _inputs(5)
    plan = compile_dhm(loop.topology(SMALL), params,
                       quant=QuantSpec(weight_bits=bits, act_bits=bits), device="cpu")
    with torch.no_grad():
        logits = plan(x)
    ref = reference.float_logits(SMALL, params, x, bits=bits)
    if bits is None:
        assert float((logits - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert torch.equal(logits, ref)


def test_the_control_is_outside():
    params, x = _inputs(7)
    feats = reference.features(SMALL, params, x)
    ref = reference.head(SMALL, params, feats)
    control = reference.head(SMALL, params, feats, precision="bf16")
    assert loop.logit_gap(control, ref) > LIMITS["logit_gap"]


def test_logit_gap_and_codes_off():
    ref = torch.tensor([[1.0, -4.0], [0.5, 0.25]])
    prog = ref.clone()
    assert loop.logit_gap(prog, ref) == 0.0
    prog[1, 1] += 0.05
    assert loop.logit_gap(prog, ref) == pytest.approx(0.1)
    prog[0, 0] = float("nan")
    assert loop.logit_gap(prog, ref) != loop.logit_gap(prog, ref)  # NaN
    feats = torch.zeros(2, 3, dtype=torch.float64)
    other = feats.clone()
    other[0, 1] = 2.0 ** -6
    assert loop.codes_off(other.float(), feats) == 1
    assert loop.codes_off(torch.full((2, 3), float("nan")), feats) == 6


def _cell(seconds=0.2):
    return Cell(name="vgg16-q8.infer", config=SMALL, mix=harness.mix("infer_256"),
                seed=2**31 + 21, seconds=seconds, trace=False, device=torch.device("cpu"),
                t_start=time.perf_counter(),
                sizes={"frames_per_request": 8, "pool_batches": 2, "warmup_seconds": 0.05})


def test_a_sound_run_is_correct():
    line, found = harness.run(SPEC, _cell())
    assert line["correct"], line["checks"]
    assert {c.name for c in found} == {"feature_codes_off", "logit_gap", "requests_unanswered"}
    assert set(line["metrics"]) == {"infer_frames_per_s", "infer_p95_ms", "setup_s"}


def _altered_logits(monkeypatch):
    from repro_torch.core.dhm import engine

    forward = engine.forward

    def altered(plan, x):
        out = forward(plan, x).clone()
        out[0, 0] += 0.25
        return out

    monkeypatch.setattr(engine, "forward", altered)


def _altered_features(monkeypatch):
    from repro_torch.core.dhm.compiler import CompiledDHM

    features = CompiledDHM.features

    def altered(self, x):
        out = features(self, x).clone()
        out[0, 0, 0, 0] += 2.0 ** -6
        return out

    monkeypatch.setattr(CompiledDHM, "features", altered)


@pytest.mark.parametrize("fault, check", [(_altered_logits, "logit_gap"),
                                          (_altered_features, "feature_codes_off")],
                         ids=["logits", "features"])
def test_a_broken_path_is_not_correct(monkeypatch, fault, check):
    fault(monkeypatch)
    line, found = harness.run(SPEC, _cell())
    assert line["correct"] is False
    assert check in [c.name for c in found if not c.ok]


def test_full_size_is_refused_on_the_cpu():
    cell = harness.make_cell(SPEC, "vgg16-q8.infer", seed=1, seconds=0.1, trace=False,
                             device="cpu", t_start=time.perf_counter(),
                             sizes={"frames_per_request": 2, "pool_batches": 1})
    with pytest.raises(RuntimeError, match="runs on a card"):
        loop.run(cell)


def _readings(device_ops, work):
    cell = harness.make_cell(SPEC, "vgg16-q8.infer", seed=1, seconds=1.0, trace=True,
                             device="cpu", t_start=time.perf_counter())
    spans = [("bench.enqueue", 0.0, 0.001)]
    return Readings(cell=cell, trace=Trace(device=device_ops, spans=spans),
                    host_s={}, work=work, peaks=dict(PEAKS))


def test_the_fused_i8_metrics():
    fused = "void sc_fused_i8_kernel(ScFused)"
    ops = [(fused, 0.0, 0.004), ("sc_pyramid_i8_kernel(ScPyramid)", 0.004, 0.005),
           (fused, 0.005, 0.011)]
    work = {"requests": 2, "frames_per_request": 256, "window_s": 0.02,
            "fused_i8_layers": [2, 12]}
    r = _readings(ops, work)
    assert harness.metric_reader("infer_fused_i8_us").read(r) == pytest.approx(5000.0)
    topo = CFG["topology"]
    # Layer 2: 112x112x64 codes in, 112x112x128 floats out; layer 12: 14x14x512 in,
    # 7x7x512 floats out (pooled); their operations at the int8 peak.
    ops2 = 2.0 * 64 * 128 * 9 * 112 * 112 * 256
    bytes2 = 256 * (112 * 112 * 64 + 4 * 112 * 112 * 128)
    ops12 = 2.0 * 512 * 512 * 9 * 14 * 14 * 256
    bytes12 = 256 * (14 * 14 * 512 + 4 * 7 * 7 * 512)
    least = (max(ops2 / 1.979e15, bytes2 / 3.35e12) + max(ops12 / 1.979e15, bytes12 / 3.35e12))
    fused_roofline = harness.metric_reader("fused_i8_roofline")
    assert fused_roofline.layer_seconds(topo, 2, 256, PEAKS) == pytest.approx(
        max(ops2 / 1.979e15, bytes2 / 3.35e12))
    assert fused_roofline.read(r) == pytest.approx(100.0 * least * 2 / 0.010)
    # A program without the launch table, or a window without the kernel, reads nothing.
    for w, o in (({k: v for k, v in work.items() if not k.startswith("fused")}, ops),
                 (work, ops[1:2])):
        for name in ("infer_fused_i8_us", "fused_i8_roofline"):
            assert harness.metric_reader(name).read(_readings(o, w)) is None
