"""VGG-16 (configuration D) in the port, on the CPU: the topology and its
config module, the head activation (``CNNTopology.fc_act``) on every path
that runs a head, its default leaving the five topologies as they were,
and the card's launch table of VGG-16 at 224x224 against the single-layer
launcher's own ``fused_plan``, in pure Python.

The comparison with the benchmark's plain reference is in
``bench/test_bench_vgg.py``; the full-width plan on the card in
``tests/test_torch_vgg16_card.py``."""
import dataclasses

import pytest
import torch

from repro_torch import cuda_graphs
from repro_torch.core.dhm import QuantSpec, compile_dhm
from repro_torch.core.dhm.compiler import (
    CardLaunch,
    card_fusion_groups,
    card_launch,
    validate_topology,
)
from repro_torch.core.dhm.engine import JittedForward, forward, plan_jitted_forward
from repro_torch.core.dhm.fusion import DEFAULT_VMEM_BUDGET, plan_fusion_groups
from repro_torch.kernels.stream_conv.conv import fused_plan
from repro_torch.models.cnn import (
    ALL_TOPOLOGIES,
    VGG16,
    cnn_apply,
    cnn_apply_reference,
    init_cnn,
)

# VGG-16's pattern at 32x32 with a sixteenth of its channels and 10 classes.
SMALL = dataclasses.replace(
    VGG16, name="vgg16_small", input_hw=32, fc_dims=(64, 64), n_classes=10,
    conv_layers=tuple(dataclasses.replace(sp, n_out=sp.n_out // 16) for sp in VGG16.conv_layers))


def _params(topo, seed=0):
    params = init_cnn(torch.Generator().manual_seed(seed), topo, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for group in params.values():
        for p in group:
            p["b"] = 0.05 * torch.randn(p["b"].shape, generator=gen)
    return params


def _frames(topo, n=6, seed=2):
    h, w = topo.input_shape
    x = torch.randn((n, h, w, topo.input_channels), generator=torch.Generator().manual_seed(seed))
    return torch.clamp(torch.round(x * 64), -128, 127) / 64  # on the 8-bit stream grid


def test_vgg16_is_configuration_d():
    from repro_torch.configs import vgg16

    assert vgg16.CONFIG is VGG16 and vgg16.SELECTED_BITS == 8
    assert "vgg16" not in ALL_TOPOLOGIES
    assert [sp.n_out for sp in VGG16.conv_layers] == [64, 64, 128, 128, 256, 256, 256,
                                                       512, 512, 512, 512, 512, 512]
    assert [i for i, sp in enumerate(VGG16.conv_layers) if sp.pool] == [1, 3, 6, 9, 12]
    assert all(sp.kernel == 3 and sp.padding == "SAME" and sp.act == "relu"
               and sp.pool in (0, 2) for sp in VGG16.conv_layers)
    assert VGG16.feature_shape() == (7, 7, 512)
    assert (VGG16.fc_dims, VGG16.n_classes, VGG16.fc_act) == ((4096, 4096), 1000, "relu")
    assert VGG16.feature_extractor_macs() == 15_346_630_656
    validate_topology(VGG16)


@pytest.mark.parametrize("name", sorted(ALL_TOPOLOGIES))
def test_the_default_head_is_the_tanh_composition(name):
    """The five topologies' plans and plain composition give a tanh head
    between FC layers, as they did before the head had an activation."""
    topo = ALL_TOPOLOGIES[name]
    assert topo.fc_act == "tanh"
    params, x = _params(topo), _frames(topo)
    with torch.no_grad():
        feats = compile_dhm(topo, params, device="cpu").features(x)
        h = feats.reshape(feats.shape[0], -1)
        for i, p in enumerate(params["fc"]):
            h = torch.matmul(h, p["w"]) + p["b"]
            if i < len(params["fc"]) - 1:
                h = torch.tanh(h)
        assert torch.equal(cnn_apply(params, topo, x), h)
    torch.testing.assert_close(cnn_apply_reference(params, topo, x), h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", [QuantSpec(), QuantSpec(weight_bits=8, act_bits=8),
                                   QuantSpec(weight_bits=8, act_bits=8, int8_compute=True)],
                         ids=["fp32", "fake_quant8", "int8"])
def test_the_relu_head_on_every_path(quant):
    """``fc_act="relu"``: the compiled head, ``cnn_apply`` and the plain
    composition take relu between FC layers, and differ from a tanh head."""
    params, x = _params(SMALL), _frames(SMALL)
    plan = compile_dhm(SMALL, params, quant=quant, device="cpu")
    tanh_plan = compile_dhm(dataclasses.replace(SMALL, fc_act="tanh"), params, quant=quant,
                            device="cpu")
    with torch.no_grad():
        logits = plan(x)
        assert torch.equal(forward(plan, x), logits)
        assert not torch.equal(tanh_plan(x), logits)
        if not quant.int8_compute:
            got = cnn_apply(params, SMALL, x, weight_bits=quant.weight_bits,
                            act_bits=quant.act_bits)
            assert torch.equal(got, logits)
            ref = cnn_apply_reference(params, SMALL, x, weight_bits=quant.weight_bits,
                                      act_bits=quant.act_bits)
            if quant.weight_bits is None:
                torch.testing.assert_close(ref, logits, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(ref, logits)


def test_an_unknown_head_activation_is_refused():
    with pytest.raises(ValueError, match="unknown fc_act 'gelu'"):
        validate_topology(dataclasses.replace(SMALL, fc_act="gelu"))
    with pytest.raises(ValueError, match="unknown fc_act"):
        compile_dhm(dataclasses.replace(SMALL, fc_act="sigmoid"), _params(SMALL), device="cpu")


def test_vgg16_launch_table_at_224():
    """The int8 plan for the card: one pyramid launch for layers 0-1, then
    each layer alone on the single-layer kernel's wgmma path, one launch
    each (one column strip, one channel slice), as its own ``fused_plan``
    gives."""
    idxs = tuple(range(len(VGG16.conv_layers)))
    groups = plan_fusion_groups(VGG16, idxs, vmem_budget=DEFAULT_VMEM_BUDGET, elem_bytes=1)
    groups = card_fusion_groups(VGG16, idxs, groups, elem_bytes=1, block_r=8)
    table = [card_launch(VGG16, g, elem_bytes=1, block_r=8) for g in groups]
    assert table[0] == CardLaunch("stream_conv_pyramid_int8", (0, 1))
    assert [e.layers for e in table[1:]] == [(i,) for i in range(2, 13)]
    h, w, c = 112, 112, 64  # layer 2's input
    for e, sp in zip(table[1:], VGG16.conv_layers[2:]):
        geo = fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=sp.pool, pool_stride=None,
                         block_r=8, n_out=sp.n_out, elem_bytes=1)
        assert e.kernel == "stream_conv_fused_int8"
        assert (e.strips, e.slices) == (len(geo["strips"]), len(geo["slices"]))
        assert e.path == geo["path"] == "wgmma"
        h, w = sp.out_hw(h, w)
        c = sp.n_out
    assert table[0].path == "mma_sync"
    assert [e.slices for e in table[1:]] == [1] * 11
    assert all(e.strips == 1 for e in table)
    assert sum(e.launches for e in table) == 12


def test_a_cpu_plan_has_no_launch_table():
    plan = compile_dhm(SMALL, _params(SMALL), quant=QuantSpec(8, 8, int8_compute=True),
                       device="cpu")
    assert plan.launch_table == ()
    assert plan_jitted_forward(plan).launch_table == ()
    assert JittedForward(lambda x: x, "cpu").launch_table == ()
    assert cuda_graphs.GraphRecord(id=1, owner="", key="", phases=(), ops=(), warmup_s=0.0,
                                   release_s=0.0, capture_s=0.0).launch_table == ()
