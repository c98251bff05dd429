"""VGG-16 (configuration D) at its published widths on the card: the int8
plan at 224x224 and 8 bits against the benchmark's plain reference
(``bench/reference/vgg.py``), and a replay of its graph against the plan's
launch table.

Every test needs an NVIDIA card: it asks for it inside the test (the
``card`` fixture) and skips there without one. Run on a machine with the
card and the CUDA toolkit (the kernels are built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_vgg16_card.py

This file imports no JAX: the machine with the card has none.

Tolerances: the conv features bit for bit (the int8 conv sums integer
codes exactly); the logits within the ``logit_gap`` limit of the
benchmark's cell ``vgg16-q8.infer`` (``bench/limits/vgg16-q8.infer.json``,
which says why), since cuBLAS sums the 25,088-wide head in float32.
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import inputs  # noqa: E402
from bench.loops.infer_requests_vgg import codes_off, logit_gap  # noqa: E402
from bench.reference import vgg as reference  # noqa: E402
from repro_torch import cuda_graphs  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.models.cnn import VGG16  # noqa: E402

CFG = json.loads((ROOT / "bench" / "configs" / "vgg16-q8.json").read_text())
LIMITS = json.loads((ROOT / "bench" / "limits" / "vgg16-q8.infer.json").read_text())["limits"]
FRAMES = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    return torch.device("cuda")


@pytest.fixture
def plan_and_frames(card):
    topo = CFG["topology"]
    params = inputs.make_params(topo, CFG["init"], 2**31 + 3, card)
    x, _ = inputs.make_frames(topo, CFG["frames"], FRAMES, 2**31 + 4, card)
    plan = compile_dhm(VGG16, params, quant=QuantSpec(8, 8, int8_compute=True), device=card)
    return plan, params, x


@pytest.mark.card
def test_vgg16_int8_plan_equals_the_reference(plan_and_frames):
    plan, params, x = plan_and_frames
    with torch.no_grad():
        feats = plan.features(x)
    logits = plan(x)  # the graph's replay
    ref_feats = reference.features(CFG, params, x)
    assert feats.shape == (FRAMES, 7, 7, 512)
    assert codes_off(feats, ref_feats) == LIMITS["feature_codes_off"] == 0
    ref = reference.head(CFG, params, ref_feats)
    assert logit_gap(logits, ref) <= LIMITS["logit_gap"]
    # The control, the head's sums rounded to bfloat16, is outside.
    control = reference.head(CFG, params, ref_feats, precision="bf16")
    assert logit_gap(control, ref) > LIMITS["logit_gap"]


@pytest.mark.card
def test_a_replay_launches_the_launch_table(plan_and_frames):
    plan, _, x = plan_and_frames
    table = plan.launch_table
    assert [e.kernel for e in table] == (["stream_conv_pyramid_int8"]
                                         + ["stream_conv_fused_int8"] * 11)
    assert [e.slices for e in table] == [1] * 12
    assert [e.path for e in table] == ["mma_sync"] + ["wgmma"] * 11
    want = {"stream_conv_pyramid_int8": 1, "stream_conv_fused_int8": 11}
    paths = dict(kconv.PATH_LAUNCHES)
    with torch.no_grad():
        plan.features(x)  # eager
    assert {k: v - paths[k] for k, v in kconv.PATH_LAUNCHES.items()} == {"wgmma": 11,
                                                                         "mma_sync": 0}
    plan(x)  # the first call: warm-up and capture
    before = dict(kconv.LAUNCHES)
    plan(x)
    torch.cuda.synchronize()
    got = {k: kconv.LAUNCHES[k] - before[k] for k in kconv.LAUNCHES}
    assert {k: v for k, v in got.items() if v} == want
    record = [r for r in cuda_graphs.graphs() if r.owner == "JittedForward"][-1]
    assert record.launch_table == table
    if record.ops:
        assert sum("sc_fused_i8_kernel" in op for op in record.ops) == 11
        assert sum("sc_pyramid_i8_kernel" in op for op in record.ops) == 1
