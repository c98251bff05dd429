"""Training on the card: gradients through the hand-written stream-conv
kernels, held against autograd of the plain composition on the card and
against the CPU.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit (the kernels are built with nvcc at first
use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_training_card.py

This file imports no JAX: the machine with the card has none.

The Function's backward on the card is the hand-written backward kernels
(``csrc/stream_conv_bwd.cu``). The plain composition on the card is
differentiated with cuDNN off: under ``deterministic=True,
allow_tf32=False`` cuDNN picks, for lenet5's first layer at B=16, an
algorithm whose gradients sit 5.8e-4 (relative L2) from a float64
composition (``chip_smoke.py`` phase 5g prints the figure).

Tolerances: fp32 and the pow2 QAT head per element at rtol 1e-4, atol
1e-5 (IEEE fp32 sums in other orders), against the plain composition on
the card, the CPU and a float64 composition. Under 8-bit fake-quant a
sum in another order may put an output one quant step from the other
side's, and every layer after it sees that step: the features are held
equal but for at most ``MAX_STEP_SHARE`` of elements exactly one step
apart, and each gradient tensor within a relative L2 error of
``QAT_REL_L2``. A last-bit change of the conv sums alone (float32 against
float64 on the CPU) moves cifar10's 8-bit gradients at B=128 by up to
6.6e-3 (``tests/test_torch_training.py::test_qat8_gradients_move_with_the_last_bit_of_the_conv_sums``);
a broken mask or pool routing moves them by O(1). The resilient
trainer's replayed run against the clean one at atol 1e-6
(``test_runtime.py``'s own).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.analysis.invariants import (  # noqa: E402
    planned_backward_launches,
    planned_launches,
)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.engine import forward  # noqa: E402
from repro_torch.data import make_image_dataset  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import ref as kref  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.kernels.stream_conv.halo import as_pyramid_layers  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine  # noqa: E402
from repro_torch.paper.train_cnn import train_cnn, train_step  # noqa: E402
from repro_torch.runtime import FaultInjector, ResilientTrainer  # noqa: E402
from repro_torch.tree_util import tree_flatten, tree_map  # noqa: E402

pytestmark = pytest.mark.card

NAMES = sorted(ALL_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
MAX_STEP_SHARE = 1e-3
QAT_REL_L2 = 2e-2
BATCH = 16
MODES = {"fp32": {}, "qat8": dict(weight_bits=8, act_bits=8), "pow2": dict(pow2_weights=True)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _setup(name, batch=BATCH):
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device="cpu")
    rng = np.random.default_rng(0)
    h, w = topo.input_shape
    x = torch.from_numpy(rng.normal(size=(batch, h, w, topo.input_channels)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, topo.n_classes, size=batch))  # int64
    return topo, params, x, y


def _precise():
    """cuDNN off, TF32 off: the numerics of the Function's backward."""
    return torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def _grads(topo, params, x, y, device, quant, *, plain=False, vmem_budget=None):
    """(gradients of the training loss on ``device``, the plan, its
    features): through ``cnn_apply``'s plan (the kernels' autograd
    Function on the card), or ``plain``: native autograd of the per-layer
    composition of ``ref.py`` (cuDNN off on the card)."""
    leaves, treedef = tree_flatten(params)
    leaves = [t.to(device).requires_grad_() for t in leaves]
    plan = compile_dhm(topo, treedef.unflatten(leaves), quant=QuantSpec(**quant), device=device,
                       vmem_budget=vmem_budget)
    x, y = x.to(device), y.to(device)
    if plain:
        with _precise():
            feats = kref.stream_conv_pyramid_ref(
                x, [p["w"] for p in plan.conv_params], [p["b"] for p in plan.conv_params],
                layers=as_pyramid_layers(topo.conv_layers), act_bits=quant.get("act_bits"))
            loss = torch.nn.functional.cross_entropy(plan.head_fn(feats), y)
            grads = torch.autograd.grad(loss, leaves)
    else:
        feats = plan.features(x)
        loss = torch.nn.functional.cross_entropy(plan.head_fn(feats), y)
        grads = torch.autograd.grad(loss, leaves)
    return [g.cpu() for g in grads], plan, feats.detach().cpu()


def _f64_grads(topo, params, x, y):
    """Gradients of the fp32 training loss through the same composition
    in float64 on the CPU."""
    leaves, treedef = tree_flatten(params)
    leaves = [t.double().requires_grad_() for t in leaves]
    p = treedef.unflatten(leaves)
    h = x.double()
    for spec, layer in zip(topo.conv_layers, p["conv"]):
        h = kref._conv_nhwc(h, layer["w"], stride=spec.stride, padding=spec.padding,
                            dtype=torch.float64) + layer["b"]
        h = torch.tanh(h) if spec.act == "tanh" else torch.maximum(h, h.new_zeros(()))
        pw, ps = spec.pool_cfg
        if pw:
            h = torch.nn.functional.max_pool2d(h.permute(0, 3, 1, 2), pw, ps).permute(0, 2, 3, 1)
    h = h.reshape(h.shape[0], -1)
    for i, layer in enumerate(p["fc"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(p["fc"]) - 1:
            h = torch.tanh(h)
    loss = torch.nn.functional.cross_entropy(h, y)
    return [g.float() for g in torch.autograd.grad(loss, leaves)]


def _assert_close(got, want, mode):
    for a, b in zip(got, want):
        if mode == "qat8":
            assert float((a - b).norm()) <= QAT_REL_L2 * float(b.norm())
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **FP32)


def _assert_features(got, want, mode):
    if mode != "qat8":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32)
        return
    d = (got - want).abs()
    off = d > 1e-6
    np.testing.assert_allclose(d[off].numpy(), stream_quant_spec(8).scale, rtol=1e-5)
    assert float(off.float().mean()) <= MAX_STEP_SHARE, int(off.sum())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_every_parameter_gets_a_finite_nonzero_gradient_on_the_card(card, name, mode):
    topo, params, x, y = _setup(name)
    grads, _, _ = _grads(topo, params, x, y, card, MODES[mode])
    assert len(grads) == len(tree_flatten(params)[0])
    for g in grads:
        assert g is not None and bool(torch.isfinite(g).all()) and bool((g != 0).any())


@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_card_gradients_equal_plain_autograd_on_the_card_and_the_cpus(card, name, mode, vmem_budget):
    topo, params, x, y = _setup(name)
    quant = MODES[mode]
    got, _, feats = _grads(topo, params, x, y, card, quant, vmem_budget=vmem_budget)
    plain, _, plain_feats = _grads(topo, params, x, y, card, quant, plain=True)
    cpu, _, cpu_feats = _grads(topo, params, x, y, torch.device("cpu"), quant,
                               vmem_budget=vmem_budget)
    _assert_features(feats, plain_feats, mode)
    _assert_features(feats, cpu_feats, mode)
    _assert_close(got, plain, mode)
    _assert_close(got, cpu, mode)
    if mode == "fp32":
        _assert_close(got, _f64_grads(topo, params, x, y), mode)


@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("name", NAMES)
def test_a_training_step_launches_each_group_once_and_no_plain_version(card, name, vmem_budget):
    """The forward launches its planned kernels once a group; the backward,
    logged in the caller's log though autograd runs it on its own thread,
    its planned backward kernels once a group; neither calls a plain
    version."""
    topo, params, x, y = _setup(name)
    _grads(topo, params, x, y, card, {}, vmem_budget=vmem_budget)  # builds and warms up
    kconv.reset_launch_counts()
    with probe.recording() as log:
        _, plan, _ = _grads(topo, params, x, y, card, {}, vmem_budget=vmem_budget)
    torch.cuda.synchronize()
    assert [d for d in log.dispatches if d[2]] == []  # no plain version
    bwd = [d for d in log.dispatches if d[1] == "stream_conv_pyramid_bwd"]
    assert len(log.dispatches) - len(bwd) == len(bwd) == len(plan.fusion_groups)

    def launched(kernels):
        return (sum(kconv.LAUNCHES[k] for k in kernels),
                sum(1 for _, k, _ in log.launches if k in kernels))

    want = planned_launches(plan)
    assert launched(kconv.FORWARD_KERNELS) == (want, want)
    want = planned_backward_launches(plan)
    assert launched(kconv.BACKWARD_KERNELS) == (want, want)


def test_the_pow2_head_carries_the_conv_features_gradient_on_the_card(card):
    topo, params, x, y = _setup("cifar10")
    kpow2.reset_launch_counts()
    got, _, _ = _grads(topo, params, x, y, card, MODES["pow2"])
    assert sum(kpow2.LAUNCHES.values()) == len(topo.fc_dims) + 1
    cpu, _, _ = _grads(topo, params, x, y, torch.device("cpu"), MODES["pow2"])
    _assert_close(got, cpu, "pow2")
    assert all(bool((g != 0).any()) for g in got[: 2 * len(topo.conv_layers)])


def test_an_int8_plan_with_grad_raises_on_the_card(card):
    topo, params, x, _ = _setup("cifar10")
    p = tree_map(lambda t: t.to(card).requires_grad_(), params)
    plan = compile_dhm(topo, p, quant=QuantSpec(weight_bits=8, act_bits=8, int8_compute=True))
    with pytest.raises(ValueError, match="forward-only"):
        forward(plan, x.to(card))  # the eager composition, which autograd sees
    with torch.inference_mode():
        assert plan(x.to(card)).shape == (BATCH, topo.n_classes)


def test_train_cnn_on_the_card_follows_the_cpu(card):
    ds = make_image_dataset(hw=28, channels=1, seed=0, n_train_per_class=16)
    init = init_cnn(torch.Generator().manual_seed(1), ALL_TOPOLOGIES["lenet5"], device="cpu")
    runs = [train_cnn(ALL_TOPOLOGIES["lenet5"], steps=5, batch_size=32, dataset=ds, log_every=1,
                      init_params=init, device=dev) for dev in (card, "cpu")]
    np.testing.assert_allclose([h["loss"] for h in runs[0].history],
                               [h["loss"] for h in runs[1].history], rtol=1e-4)
    assert runs[0].params["conv"][0]["w"].device.type == "cuda"


def test_the_resilient_trainer_replays_to_the_clean_run_on_the_card(card, tmp_path):
    topo = ALL_TOPOLOGIES["cifar10"]
    ds = make_image_dataset(hw=32, channels=3, seed=0, n_train_per_class=16)
    x_train, y_train = ds.x_train.to(card), ds.y_train.to(card)
    cfg, sched = AdamWConfig(weight_decay=0.01), linear_warmup_cosine(3e-3, 20, 12)

    def batch_fn(step):
        idx = torch.from_numpy(np.random.default_rng(step).integers(0, x_train.shape[0], 32)).to(card)
        return x_train[idx], y_train[idx]

    def step_fn(state, batch, step):
        params, opt, loss, _ = train_step(*state, *batch, sched(step), topo=topo, cfg=cfg)
        return (params, opt), {"loss": float(loss)}

    params = init_cnn(torch.Generator().manual_seed(2), topo, device=card)
    state0 = (params, adamw_init(params, cfg))
    runs = []
    for what, faults in (("clean", ()), ("faulty", (5, 9))):
        tr = ResilientTrainer(step_fn, batch_fn,
                              CheckpointManager(str(tmp_path / what), async_write=False),
                              ckpt_every=4, fault_injector=FaultInjector(fail_at_steps=faults))
        runs.append((tr.run(state0, num_steps=12)[0], tr.restarts))
    (clean, _), (faulty, restarts) = runs
    assert restarts == 2 and int(faulty[1].step) == int(clean[1].step) == 12
    for a, b in zip(tree_flatten(faulty[0])[0], tree_flatten(clean[0])[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=1e-6)
