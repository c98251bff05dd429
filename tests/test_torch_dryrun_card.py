"""The dry run's recorder on the card (phase 5k (b) of ``chip_smoke.py``
at a reduced depth) and the selective scan as a registered op on CUDA.

- A CUDA call of ``repro_torch::ssm_scan`` launches the hand-written
  kernel, never the plain version, and is one op of the log.
- A real step on the card (falcon-mamba train through the scan's kernels,
  qwen2.5-3b prefill; full width, a few layers, bf16) logs the ops its
  ``meta`` trace logged, per overload, and the same FLOPs; the peak the
  trace predicts (arguments + its live bytes' peak) is within 10 % of
  ``torch.cuda.max_memory_allocated`` above the test's start.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_dryrun_card.py

This file imports no JAX: the machine with the card has none.
"""
import dataclasses
import gc

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as kssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

pytestmark = pytest.mark.card

PEAK_RTOL = 0.10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    return torch.device("cuda")


@pytest.fixture
def counted_plain(monkeypatch):
    calls = [0]
    plain = kssm_ops.ssm_scan_ref

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(kssm_ops, "ssm_scan_ref", counted)
    bwd_plain = kssm_ops.ssm_scan_bwd_ref

    def counted_bwd(*args):
        calls[0] += 1
        return bwd_plain(*args)

    monkeypatch.setattr(kssm_ops, "ssm_scan_bwd_ref", counted_bwd)
    return calls


def test_scan_op_on_cuda_launches_the_kernel_and_never_the_plain_version(card, counted_plain):
    g = torch.Generator(device=card).manual_seed(0)
    bz, s, d, n = 2, 33, 200, 16
    x = torch.randn((bz, s, d), generator=g, device=card).to(torch.bfloat16)
    dt = torch.rand((bz, s, d), generator=g, device=card) * 0.1
    b, c = (torch.randn((bz, s, n), generator=g, device=card).to(torch.bfloat16)
            for _ in range(2))
    a = -torch.rand((d, n), generator=g, device=card)
    d_skip = torch.randn((d,), generator=g, device=card)
    before = kscan.LAUNCHES["ssm_scan"]
    (y, h_last), rec, counter = H.record(kssm_ops.scan_op, x, dt, b, c, a, d_skip, None,
                                         device=card)
    torch.cuda.synchronize()
    assert kscan.LAUNCHES["ssm_scan"] == before + 1 and counted_plain[0] == 0
    assert [i.op for i in rec.instrs] == ["repro_torch.ssm_scan.default"]
    assert counter == H.analyze_hlo(rec.instrs).flops == 2 * bz * s * d * n
    assert y.is_cuda and (tuple(y.shape), tuple(h_last.shape)) == ((bz, s, d), (bz, d, n))
    want = kssm_ops.scan_op(*(t.cpu() for t in (x, dt, b, c, a, d_skip)), None)
    assert counted_plain[0] == 1  # the CPU call, for the comparison
    torch.testing.assert_close(y.cpu(), want[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,layers,kind", [("falcon-mamba-7b", 2, "train"),
                                              ("qwen2.5-3b", 4, "prefill")])
def test_a_step_on_the_card_logs_its_meta_trace_and_the_predicted_peak(
        card, counted_plain, arch, layers, kind):
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    shape = ShapeConfig("card", 256, 2, kind)
    mesh = make_production_mesh(device="cpu")
    tr = D.trace_cell(cfg, shape, mesh)
    step, meta_args, _ = D.cell_step(cfg, shape, mesh)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = D.cell_args(cfg, shape, torch.Generator(device=card).manual_seed(0))
    torch.cuda.synchronize()
    assert D.tree_bytes(args) == D.tree_bytes(meta_args)
    torch.cuda.reset_peak_memory_stats()
    before = dict(kscan.LAUNCHES)
    out, rec, counter = H.record(step, *args, device=card)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    del out
    assert H.op_counts(rec.instrs) == H.op_counts(tr.instrs)
    assert H.analyze_hlo(rec.instrs).flops == H.analyze_hlo(tr.instrs).flops
    assert counter == tr.counter_flops
    predicted = D.tree_bytes(args) + tr.peak_live_bytes
    assert abs(predicted / measured - 1) <= PEAK_RTOL, (predicted, measured)
    launched = {k: kscan.LAUNCHES[k] - v for k, v in before.items()}
    falcon = arch == "falcon-mamba-7b"
    assert launched == {"ssm_scan": 2 * layers if falcon else 0,
                        "ssm_scan_bwd": layers if falcon else 0}
    assert counted_plain[0] == 0
