"""FLOP parity of the dry run, the MoE and SSM configurations: each cell's
step traced on ``meta`` at ``scaled_down()``, B=2, S=64, counted from
the port's op log, against the reference's ``analyze_hlo`` of the same
step compiled by XLA on one CPU device, rtol 1e-6. The helpers and the
rest of the dry run's tests are in ``test_torch_dryrun.py``; the
configurations are split over three files so that no file's XLA compiles
take half a minute.

And the pin of falcon-mamba's train step: per layer the scan op and its
gradient's op, 2 Bz S D N each, the reference's count exactly (ROADMAP
Queue 3, repaired).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from test_torch_dryrun import B, KINDS, S, assert_flop_parity, port_trace  # noqa: E402

ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "falcon-mamba-7b")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCHS)
def test_flops_equal_the_references_hlo_analysis(name, kind):
    assert_flop_parity(name, kind)


def test_falcon_mamba_train_charges_the_scan_two_contractions_a_layer():
    """The pin for ROADMAP Queue 3: per layer the scan op (the forward's
    contraction with C) and its gradient's op (the states' contraction
    with g_y into dC), each 2 Bz S D N; no ``bmm`` at a scan site and no
    ``bmm`` with a contraction of 1 anywhere (the recomputed composition's
    einsum and its outer product g_y x C are gone)."""
    cfg = get_arch("falcon-mamba-7b").scaled_down()
    d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    per = 2 * B * S * d * n
    instrs = port_trace("falcon-mamba-7b", "train").instrs
    charged = [(i.packet, i.site.split(":")[0], H.instr_flops(i)) for i in instrs
               if i.packet in (H.SCAN_OP, H.SCAN_BWD_OP) or "ssm_scan" in i.site]
    assert sorted(charged) == sorted(
        [("repro_torch.ssm_scan", "kernels/ssm_scan/ops.py", per)] * cfg.n_layers
        + [("repro_torch.ssm_scan_bwd", "kernels/ssm_scan/ops.py", per)] * cfg.n_layers)
    assert not [i for i in instrs if i.packet == "aten.bmm" and "ssm_scan" in i.site]
    assert not [i for i in instrs if i.packet == "aten.bmm" and i.operands[0].shape[-1] == 1]
