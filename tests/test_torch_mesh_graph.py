"""The Engine's ``mesh`` rung as the port's jitted mesh closure, on the CPU.

The reference jits the rung (``repro.core.dhm.engine.Engine._build_mesh_fwd``:
the µbatch reshape, ``runner.apply`` and the head as one executable that
donates its frames). The port's rung is a ``JittedForward`` of the same
composition (``engine._mesh_forward``): on the card one CUDA graph per
group shape (``tests/test_torch_mesh_graph_card.py``), on the CPU the eager
composition with the same surface. Held here:

- the rung is a ``JittedForward`` with the engine's ``donate``, one entry
  for any number of groups; a donating engine stages each group into the
  closure's input buffer, a non-donating one leaves the caller's tensor;
- its answers equal the port's single-device plan bit for bit (fp32,
  6-bit fake-quant, int8; exact and boxed edges, serial and overlapped,
  and a (2, 2) (stage, data) mesh) and match the reference's ``forward``
  (``backend="ref"``) at the ROADMAP's tolerances, as
  ``tests/test_torch_pipeline.py`` holds the pipelined plans;
- ``probe.replayed`` logs a graph's edge transfers again into an open log
  and nowhere without one; the verifier's pipeline probe reads the rung's
  closure and logs what the eager runner logs;
- a mesh whose slots are not all on the plan's device (several cards, or
  one card that is not the plan's) keeps the eager closure with one
  warning naming the devices; slots all on the plan's device give the
  ``JittedForward`` (the decision is taken on a list of devices: no card
  is needed).

Tolerances against the reference: fp32 rtol 1e-4, atol 1e-5; under
fake-quant and int8 the features are equal except elements exactly one
quant step apart, in at most one frame, whose logits are then left out.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import functools  # noqa: E402
import logging  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm.engine import forward as jax_forward  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.analysis.verify import make_pipeline_probe, verify_plan  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import Engine, QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.engine import JittedForward, _mesh_jitted, build_plan_pipeline  # noqa: E402
from repro_torch.core.dhm.pipeline import PipelineConfig  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES  # noqa: E402

NAME = "cifar10"
QUANTS = {
    "fp32": {},
    "fq6": dict(weight_bits=6, act_bits=6),
    "int8": dict(weight_bits=8, act_bits=8, int8_compute=True),
}
FP32 = dict(rtol=1e-4, atol=1e-5)
MAX_OFF_FRAMES = 1
MB, N_MB = 2, 3
# (edge mode, overlap, data columns): the stage-only layouts on 3 stages,
# the (2, 2) (stage, data) mesh on 2.
LAYOUTS = {
    "exact": ("exact", False, 0),
    "exact_overlap": ("exact", True, 0),
    "boxed": ("boxed", False, 0),
    "boxed_overlap": ("boxed", True, 0),
    "stage2_data2": ("auto", False, 2),
}


@functools.lru_cache(maxsize=None)
def _params():
    return jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), JAX_TOPOLOGIES[NAME]))


@functools.lru_cache(maxsize=None)
def _plan(quant="fp32", n_stages=3):
    return compile_dhm(ALL_TOPOLOGIES[NAME], params_from_numpy(_params(), "cpu"),
                       quant=QuantSpec(**QUANTS[quant]), n_stages=n_stages, device="cpu")


def _frames(n, seed):
    topo = ALL_TOPOLOGIES[NAME]
    h, w = topo.input_shape
    return np.random.default_rng(seed).normal(
        size=(n, h, w, topo.input_channels)).astype(np.float32)


def _engine(plan, layout="exact", **kw):
    edge_mode, overlap, data = LAYOUTS[layout]
    if data:
        mesh = make_mesh((plan.n_stages, data), ("stage", "data"), device="cpu")
        kw.update(data_axis="data", microbatch=2 * MB)
    else:
        mesh = make_mesh((plan.n_stages,), ("stage",), device="cpu")
        kw.setdefault("microbatch", MB)
    return Engine(plan, mesh=mesh, n_microbatches=N_MB, edge_mode=edge_mode, overlap=overlap,
                  **kw)


def _padded_direct(plan, x, group):
    """``plan`` on ``x`` padded to the engine's group, as the engine pads."""
    pad = -x.shape[0] % group
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
    with torch.no_grad():
        return torch.cat([plan(xp[i:i + group]) for i in range(0, xp.shape[0], group)])[:x.shape[0]]


# ---------------------------------------------------------------------------
# the rung's closure


@pytest.mark.parametrize("donate", [True, False])
def test_mesh_rung_is_a_jitted_forward_with_the_engines_donation(donate):
    plan = _plan()
    eng = _engine(plan, donate=donate)
    assert eng.rung == "mesh" and eng.group == MB * N_MB
    fwd = eng._fwd
    assert isinstance(fwd, JittedForward) and fwd.donate is donate
    assert fwd.device == plan.device and not fwd.on_card
    x = _frames(3 * eng.group - 1, 7)  # three groups, the last padded
    assert torch.equal(eng.infer(x), _padded_direct(plan, x, eng.group))
    assert eng.stats().n_batches == 3 and eng._fwd is fwd
    assert fwd._cache_size() == 1  # the warmup probe's shape served every group
    xb = torch.from_numpy(_frames(eng.group, 8))
    with torch.no_grad():
        assert torch.equal(fwd(xb), fwd.fn(xb))  # the eager composition


def test_a_donating_engine_stages_into_the_closures_input_buffer():
    plan = _plan()
    batch = _frames(MB * N_MB, 9)
    eng = _engine(plan, donate=True)
    fwd = eng._fwd
    with fwd.lock:
        staged = eng._stage(batch, fwd)
        assert staged is fwd.input_buffer(batch.shape)
        assert torch.equal(staged, torch.from_numpy(batch))
        got = fwd(staged)
    assert torch.equal(got, _padded_direct(plan, batch, eng.group))

    keep = _engine(plan, donate=False)
    fwd_k = keep._fwd
    with fwd_k.lock:
        staged = keep._stage(batch, fwd_k)
        assert staged is not fwd_k.input_buffer(batch.shape)
    x = torch.from_numpy(batch.copy())
    fwd_k(x)
    assert torch.equal(x, torch.from_numpy(batch))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("quant", sorted(QUANTS))
def test_mesh_rung_answers_equal_the_single_device_plan(quant, layout):
    n_stages = 2 if LAYOUTS[layout][2] else 3
    plan = _plan(quant, n_stages)
    eng = _engine(plan, layout)
    assert eng.rung == "mesh" and isinstance(eng._fwd, JittedForward)
    x = _frames(eng.group + 3, 11)  # two groups, the second padded
    got = eng.infer(x)
    assert torch.equal(got, _padded_direct(plan, x, eng.group))
    assert eng.demotions == [] and eng.stats().n_retries == 0


@functools.lru_cache(maxsize=None)
def _reference(quant, x_bytes):
    x = np.frombuffer(x_bytes, np.float32).reshape((-1,) + _frames(1, 0).shape[1:])
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES[NAME], _params(), n_stages=3,
                                  quant=jcompiler.QuantSpec(**QUANTS[quant]), backend="ref")
    return np.asarray(jplan.features(jnp.asarray(x))), np.asarray(jax_forward(jplan, jnp.asarray(x)))


@pytest.mark.parametrize("quant", sorted(QUANTS))
def test_mesh_rung_matches_the_references_forward(quant):
    plan = _plan(quant)
    eng = _engine(plan, "boxed_overlap")
    x = _frames(eng.group, 12)
    logits = eng.infer(x).numpy()
    with torch.no_grad():
        feats = eng._runner(torch.from_numpy(x).reshape((N_MB, MB) + x.shape[1:]))
    feats = feats.reshape((eng.group, -1)).numpy()
    want_feats, want_logits = _reference(quant, x.tobytes())
    want_feats = want_feats.reshape(feats.shape)
    if quant == "fp32":
        np.testing.assert_allclose(feats, want_feats, **FP32)
        np.testing.assert_allclose(logits, want_logits, **FP32)
        return
    d = np.abs(feats - want_feats)
    off = d > 1e-6
    np.testing.assert_allclose(d[off], stream_quant_spec(QUANTS[quant]["act_bits"]).scale,
                               rtol=1e-5)
    off_frames = off.any(axis=1)
    assert off_frames.sum() <= MAX_OFF_FRAMES, int(off.sum())
    np.testing.assert_allclose(logits[~off_frames], want_logits[~off_frames], **FP32)


# ---------------------------------------------------------------------------
# transfers at a replay, and the verifier's probe


def test_replayed_relogs_transfers_into_an_open_log_and_none_without_one():
    transfers = ((0, (0, 1), (2, 16, 16, 32)), (1, (1, 2), (2, 8, 8, 32)))
    launches = (("stream_conv_fused", 4096),)
    before = kconv.LAUNCHES["stream_conv_fused"]
    try:
        probe.replayed(launches, transfers)  # no log open: counted, logged nowhere
        assert kconv.LAUNCHES["stream_conv_fused"] == before + 1
        with probe.recording() as log:
            log.phase = "features"
            probe.replayed(launches, transfers)
            probe.replayed(launches)  # a graph with no edge logs no transfer
        assert log.transfers == list(transfers)
        assert log.launches == [("features", "stream_conv_fused", 4096)] * 2
        assert kconv.LAUNCHES["stream_conv_fused"] == before + 3
    finally:
        kconv.LAUNCHES["stream_conv_fused"] = before


@pytest.mark.parametrize("edge_mode", ["exact", "boxed"])
@pytest.mark.parametrize("overlap", [False, True])
def test_pipeline_probe_reads_the_rungs_closure_and_logs_the_eager_runners_transfers(
        edge_mode, overlap):
    plan = _plan()
    pr = make_pipeline_probe(plan, n_microbatches=N_MB, microbatch=MB, overlap=overlap,
                             edge_mode=edge_mode)
    runner = build_plan_pipeline(plan, mesh=make_mesh((3,), ("stage",), device="cpu"),
                                 cfg=PipelineConfig(3, N_MB, overlap=overlap, edge_mode=edge_mode))
    mbs = torch.zeros((N_MB, MB) + _frames(1, 0).shape[1:])
    with torch.no_grad(), probe.recording() as log:
        runner(mbs)
    assert pr.transfers == log.transfers and len(pr.transfers) == 2 * N_MB
    assert pr.launches == [] and pr.mb_local == MB and pr.edge_plan == runner.edge_plan
    found = [(f.rule, f.severity) for f in verify_plan(plan, scopes=("pipeline",), pipeline=pr)]
    assert found == ([("V103", "warning")] if edge_mode == "boxed" else [])


# ---------------------------------------------------------------------------
# the rung's slots, and a mesh over several devices


@pytest.mark.parametrize("slots, device", [
    pytest.param([("cuda", i) for i in (0, 1, 0, 1)], ("cuda", 0), id="two_cards"),
    pytest.param([("cuda", 1)] * 3, ("cuda", 0), id="one_card_not_the_plans"),
])
def test_a_mesh_over_several_devices_keeps_the_eager_closure_with_a_warning(
        caplog, slots, device):
    calls = []

    def fn(xb):
        calls.append(torch.is_grad_enabled())
        return xb * 2

    cards = [torch.device(*d) for d in slots]
    with caplog.at_level(logging.WARNING, logger="repro_torch.dhm.engine"):
        eager = _mesh_jitted(fn, torch.device(*device), cards, donate=True)
    assert not isinstance(eager, JittedForward)
    assert [r.levelno for r in caplog.records] == [logging.WARNING]
    message = caplog.records[0].getMessage()
    assert str(sorted({str(d) for d in cards})) in message and str(torch.device(*device)) in message
    x = torch.ones(2, requires_grad=True)
    assert torch.equal(eager(x), torch.full((2,), 2.0)) and calls == [False]


@pytest.mark.parametrize("slots, device", [
    pytest.param([torch.device("cuda", 0)] * 3, "cuda:0", id="card"),
    pytest.param([torch.device("cpu")] * 2, "cpu", id="cpu"),
])
def test_slots_all_on_the_plans_device_give_the_jitted_closure(caplog, slots, device):
    def fn(xb):
        return xb * 2

    with caplog.at_level(logging.WARNING, logger="repro_torch.dhm.engine"):
        one = _mesh_jitted(fn, device, slots, donate=True)
    assert isinstance(one, JittedForward) and one.donate and one.fn is fn
    assert one.device == torch.device(device)
    assert caplog.records == []
