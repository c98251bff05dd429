"""The verifier's resource scope on the card: the shared memory each
launch of a card plan really requested, read by V203 from the launchers'
log, against the bytes the plan's groups record and the 232,448 B a
Hopper block may use.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit (the kernels are built with nvcc at first
use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_analysis_card.py

This file imports no JAX: the machine with the card has none.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.cli import run_verify  # noqa: E402
from repro_torch.analysis.invariants import card_cost, planned_launches  # noqa: E402
from repro_torch.analysis.verify import ProbeContext, verify_plan  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.kernels.stream_conv.conv import SMEM_LIMIT  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

pytestmark = pytest.mark.card

NAMES = sorted(ALL_TOPOLOGIES)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    return torch.device("cuda")


def _replace_smem(plan, gi, smem):
    flat = list(plan.card_smem)
    flat[gi] = smem
    stages, k = [], 0
    for st in plan.stages:
        n = len(st.groups)
        stages.append(dataclasses.replace(st, card_smem=tuple(flat[k:k + n])))
        k += n
    return dataclasses.replace(plan, stages=tuple(stages))


def _ids(findings):
    return sorted({f.rule for f in findings})


@pytest.mark.parametrize("name", NAMES)
def test_every_variant_verifies_clean_in_all_four_scopes_on_the_card(card, name):
    """The CLI's matrix for one topology (fp32, quant, int8; the plan and
    the pipelined plan): no finding, and every features launch of every
    plan requested nonzero shared memory within a Hopper block."""
    traces = []
    assert run_verify({name: ALL_TOPOLOGIES[name]}, device=card, traces=traces) == []
    assert len(traces) == 3
    for tr in traces:
        launches = tr.phase_launches("features")
        assert launches and all(0 < smem <= SMEM_LIMIT for _, _, smem in launches)


@pytest.mark.parametrize("quant", [{}, dict(weight_bits=8, act_bits=8, int8_compute=True)],
                         ids=["fp32", "int8"])
def test_each_launch_requests_its_groups_costed_bytes(card, quant):
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device=card)
    for budget in (None, 0):
        plan = compile_dhm(topo, params, quant=QuantSpec(**quant), vmem_budget=budget)
        assert verify_plan(plan) == []
        launches = ProbeContext(plan).trace().phase_launches("features")
        assert len(launches) == planned_launches(plan)
        assert len(plan.card_smem) == len(plan.fusion_groups)
        want = [b for g, b in zip(plan.fusion_groups, plan.card_smem)
                for _ in range(card_cost(plan, g)[0])]
        assert [smem for _, _, smem in launches] == want


def test_card_bytes_shrunk_below_the_launch_are_V203(card):
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device=card)
    for budget in (None, 0):
        plan = compile_dhm(topo, params, vmem_budget=budget)
        assert verify_plan(plan, scopes=("resource",)) == []
        bad = _replace_smem(plan, 0, plan.card_smem[0] - 16)
        findings = verify_plan(bad, scopes=("resource",))
        assert _ids(findings) == ["V202", "V203"]
        assert any("under-estimated" in f.message for f in findings if f.rule == "V203")


def test_the_pow2_head_logs_its_receive_slots(card):
    from repro_torch.kernels import probe
    from repro_torch.kernels.backends import sm_count
    from repro_torch.kernels.pow2_matmul.pow2 import p2_plan

    topo = ALL_TOPOLOGIES["lenet5"]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device=card)
    plan = compile_dhm(topo, params, quant=QuantSpec(pow2_weights=True))
    x = torch.zeros((256, 28, 28, 1), device=card)
    with torch.inference_mode(), probe.recording() as log:
        log.phase = "head"
        plan(x)
        torch.cuda.synchronize()
    heads = [entry for entry in log.launches if entry[1] == "pow2_matmul"]
    assert heads
    fc = plan.fc_params[0]["w"]
    want = p2_plan(256, fc.shape[0], fc.shape[1], sm_count(card))["recv_bytes"]
    assert heads[0][2] == want
