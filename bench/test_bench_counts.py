"""The benchmark's work counts against hand-worked numbers, and its
configuration files against the port's own configurations."""
import json
from pathlib import Path

import pytest

from bench.count import cnn as count

CONFIGS = Path(__file__).resolve().parent / "configs"


def _topo(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["topology"]


@pytest.mark.parametrize("name, conv, head", [
    # cifar10: 3*32*25*32*32 + 32*32*25*16*16 + 32*64*25*8*8; 1024*64 + 64*10
    ("cifar10-q6", 12_288_000, 66_176),
    # lenet5: 1*20*25*24*24 + 20*50*25*8*8; 800*500 + 500*10
    ("lenet5-q3", 1_888_000, 405_000),
])
def test_macs_per_frame(name, conv, head):
    topo = _topo(name)
    assert count.conv_macs(topo) == conv
    assert count.head_macs(topo) == head


def test_infer_work_and_bounds():
    topo = _topo("cifar10-q6")
    w = count.infer_work(topo, 4096, int8=True)
    assert w.conv_ops == 2 * 12_288_000 * 4096
    # 1-byte input codes read once, the 4x4x64 float32 features written once.
    assert w.conv_bytes == 4096 * (32 * 32 * 3 + 4 * 4 * 64 * 4)
    assert w.head_flops == 2 * 66_176 * 4096
    peaks = {"int8_ops_per_s": 1.979e15, "fp32_flops_per_s": 6.7e13, "hbm_bytes_per_s": 3.35e12}
    # 100.7 GOP at 1,979 TOP/s: 0.0509 ms, above the bytes' 0.0200 ms.
    assert w.conv_seconds(peaks) == pytest.approx(2 * 12_288_000 * 4096 / 1.979e15)
    assert w.compute_seconds(peaks) == pytest.approx(
        w.conv_ops / 1.979e15 + w.head_flops / 6.7e13)
    assert count.train_flops(topo, 128) == 3 * 2 * (12_288_000 + 66_176) * 128


@pytest.mark.parametrize("name, module", [("cifar10-q6", "cifar10"), ("lenet5-q3", "lenet5")])
def test_configs_are_the_ports(name, module):
    """Each configuration file is the port's CONFIG at its SELECTED_BITS."""
    import importlib

    from bench import program

    ported = importlib.import_module(f"repro_torch.configs.{module}")
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    assert program.topology(cfg["topology"]) == ported.CONFIG
    bits = ported.SELECTED_BITS
    assert cfg["infer_quant"] == {"weight_bits": bits, "act_bits": bits, "int8_compute": True}
    assert cfg["train_quant"] == {"weight_bits": bits, "act_bits": bits}
    assert ported.CONFIG.feature_extractor_macs() == count.conv_macs(cfg["topology"])
