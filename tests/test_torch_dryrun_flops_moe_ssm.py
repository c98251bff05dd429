"""FLOP parity of the dry run, the MoE and SSM configurations: each cell's
step traced on ``meta`` at ``scaled_down()``, B=2, S=64, counted from
the port's op log, against the reference's ``analyze_hlo`` of the same
step compiled by XLA on one CPU device, rtol 1e-6. The helpers and the
rest of the dry run's tests are in ``test_torch_dryrun.py``; the
configurations are split over three files so that no file's XLA compiles
take half a minute.

And the pin of falcon-mamba's train step: the port counts two more 2 Bz
S D N contractions a layer than the reference's HLO (ROADMAP Queue 3).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from test_torch_dryrun import B, KINDS, S, assert_flop_parity, port_trace  # noqa: E402
from test_torch_dryrun import scan_recompute_flops  # noqa: E402

ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "falcon-mamba-7b")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCHS)
def test_flops_equal_the_references_hlo_analysis(name, kind):
    assert_flop_parity(name, kind)


def test_falcon_mamba_train_charges_the_scan_four_contractions_a_layer():
    """The pin for ROADMAP Queue 3: per layer the scan op, the recompute's
    einsum (``ref.py``) and its backward's two ``bmm``s, one of them the
    outer product g_y x C with a contraction of 1 (XLA fuses that one as a
    broadcast multiply, so the reference counts two of the four)."""
    cfg = get_arch("falcon-mamba-7b").scaled_down()
    d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    per = 2 * B * S * d * n
    charged = [(i.packet, i.site.split(":")[0], H.instr_flops(i))
               for i in port_trace("falcon-mamba-7b", "train").instrs
               if H.instr_flops(i) == per and (i.packet == H.SCAN_OP or "ssm_scan" in i.site)]
    assert len(charged) == 4 * cfg.n_layers
    assert sorted({(p, s) for p, s, _ in charged}) == [
        ("aten.bmm", "kernels/ssm_scan/ops.py"), ("aten.bmm", "kernels/ssm_scan/ref.py"),
        ("repro_torch.ssm_scan", "kernels/ssm_scan/ops.py")]
    outer = [i for i in port_trace("falcon-mamba-7b", "train").instrs
             if i.packet == "aten.bmm" and i.operands[0].shape[-1] == 1]
    assert len(outer) == cfg.n_layers
    assert scan_recompute_flops("falcon-mamba-7b") == 2 * cfg.n_layers * per
