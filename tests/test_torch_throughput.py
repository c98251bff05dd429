"""The port's throughput models and µbatch autotuner, held for equality
with the reference's (``tests/test_throughput.py``): pure Python on both
sides, so every number must be the same.

- the paper's Table-4 law (316.48 Gop/s for LeNet5 at 65.71 MHz, the
  Cifar10 and Zynq rows);
- ``estimate_pipeline`` / ``pipeline_workload`` / ``sweep_sample`` on the
  reference test's synthetic plans over a grid of configurations, and on
  compiled plans of all five topologies at every ``n_stages``;
- ``fit_constants`` recovering planted constants, and its fallbacks;
- ``autotune_pipeline`` with and without measurements, ``candidate_grid``;
- ``load_sweep_measurements`` on a temporary file.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402
import json  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm import pipeline as jpipeline  # noqa: E402
from repro.core.dhm import throughput as jthroughput  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compile_dhm  # noqa: E402
from repro_torch.core.dhm import pipeline as tpipeline  # noqa: E402
from repro_torch.core.dhm import throughput as tthroughput  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES  # noqa: E402

NAMES = sorted(JAX_TOPOLOGIES)
PKGS = {"jax": (jthroughput, jpipeline), "torch": (tthroughput, tpipeline)}


def _specs(mod, *shapes):
    return tuple(mod.StageIOSpec(in_shape=a, out_shape=b) for a, b in zip(shapes[:-1], shapes[1:]))


def _fake_plan(mod, stage_flops, shapes):
    """A duck-typed plan (the reference test's): .stages with cost_flops
    and io, .n_stages."""
    stages = [types.SimpleNamespace(cost_flops=f, io=s)
              for f, s in zip(stage_flops, _specs(mod, *shapes))]
    return types.SimpleNamespace(stages=stages, n_stages=len(stages))


PLAN_SHAPES = {
    "A": ((1.0e6, 2.0e6, 1.5e6), ((16, 16, 4), (8, 8, 8), (4, 4, 16), (2, 2, 32))),
    "B": ((4.0e6, 3.0e6, 5.0e6), ((12, 12, 6), (6, 6, 24), (3, 3, 48), (1, 1, 96))),
    "C": ((3.0e6, 3.0e6), ((8, 8, 4), (4, 4, 8), (2, 2, 8))),
}


def _plans(key):
    flops, shapes = PLAN_SHAPES[key]
    return {w: _fake_plan(mods[1], flops, shapes) for w, mods in PKGS.items()}


def _both(fn):
    """``fn(throughput module, pipeline module, which)`` on both packages;
    an exception counts as its class and message, which must agree too."""
    out = {}
    for w, mods in PKGS.items():
        try:
            out[w] = fn(*mods, w)
        except ValueError as e:
            out[w] = ("raised", type(e).__name__, str(e))
    return out


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {k: _fields(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


def _consts(mod, c):
    return None if c is None else mod.PipelineCostConstants(*c)


CONSTS = (None, (1e9, 1e9, 1e-4), (3e9, 2e9, 5e-5), (1e9, 1e9, 0.0))


class TestStreamingLaw:
    def test_streaming_throughput(self):
        for args in ((100.0, 10.0, 1000.0), (3.8e6, 784.0, 65.71e6)):
            got = _both(lambda t, p, w: t.streaming_throughput(*args))
            assert got["torch"] == got["jax"]

    @pytest.mark.parametrize("name,f_mhz", [("lenet5", 65.71), ("cifar10", 63.89),
                                            ("svhn", 54.17), ("cifar10_full", 100.0),
                                            ("cifar10_strided", 100.0)])
    def test_table4_values_are_the_references(self, name, f_mhz):
        got = tthroughput.dhm_throughput_gops(ALL_TOPOLOGIES[name], f_mhz)
        want = jthroughput.dhm_throughput_gops(JAX_TOPOLOGIES[name], f_mhz)
        assert _fields(got) == _fields(want)
        assert got.summary() == want.summary()

    def test_table4_lenet5_pin(self):
        r = tthroughput.dhm_throughput_gops(ALL_TOPOLOGIES["lenet5"], 65.71)
        assert r.gops == pytest.approx(316.48, abs=0.1)
        assert r.frames_per_s == pytest.approx(65.71e6 / (28 * 28 * 1))
        assert "Gop/s" in r.summary()


class TestEstimate:
    @pytest.mark.parametrize("key", sorted(PLAN_SHAPES))
    def test_workload_and_estimates_over_a_grid(self, key):
        plans = _plans(key)
        wl = _both(lambda t, p, w: t.pipeline_workload(plans[w]))
        assert wl["torch"] == wl["jax"]
        for c in CONSTS:
            for M in (1, 2, 4, 8):
                for mb in (8, 16, 32):
                    for data in (1, 2):
                        for overlap in (False, True):
                            for edge_mode in ("auto", "exact", "boxed"):
                                got = _both(lambda t, p, w: t.estimate_pipeline(
                                    plans[w], n_microbatches=M, microbatch=mb, data=data,
                                    overlap=overlap, edge_mode=edge_mode,
                                    constants=_consts(t, c)))
                                assert _fields(got["torch"]) == _fields(got["jax"])
                                assert got["torch"].summary() == got["jax"].summary()
                                s = _both(lambda t, p, w: t.sweep_sample(
                                    plans[w], n_microbatches=M, microbatch=mb, data=data,
                                    frames_per_s=100.0 * M, overlap=overlap,
                                    edge_mode=edge_mode))
                                assert s["torch"] == s["jax"]

    def test_the_reference_tests_arithmetic(self):
        plan = _plans("A")["torch"]
        c = tthroughput.PipelineCostConstants(1e9, 1e9, 1e-4)
        est = tthroughput.estimate_pipeline(plan, n_microbatches=4, microbatch=8, data=2,
                                            constants=c)
        assert est.t_compute_s == pytest.approx(2e6 * 4 / 1e9)
        assert est.t_comm_s == pytest.approx(4.0 * (8 * 8 * 8 + 4 * 4 * 16) * 4 / 1e9)
        assert est.n_ticks == 6 and est.bubble_fraction == pytest.approx(2 / 6)
        with pytest.raises(ValueError, match="not divisible"):
            tthroughput.estimate_pipeline(plan, n_microbatches=2, microbatch=9, data=2)

    @pytest.mark.parametrize("name", NAMES)
    def test_compiled_plans_price_as_the_references(self, name):
        params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), JAX_TOPOLOGIES[name]))
        for n_stages in range(1, len(ALL_TOPOLOGIES[name].conv_layers) + 1):
            plan = compile_dhm(ALL_TOPOLOGIES[name], params_from_numpy(params, "cpu"),
                               n_stages=n_stages, device="cpu")
            jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES[name], params, n_stages=n_stages,
                                          backend="ref")
            assert tthroughput.pipeline_workload(plan) == jthroughput.pipeline_workload(jplan)
            for overlap in (False, True):
                got = tthroughput.estimate_pipeline(plan, n_microbatches=4, microbatch=8,
                                                    overlap=overlap)
                want = jthroughput.estimate_pipeline(jplan, n_microbatches=4, microbatch=8,
                                                     overlap=overlap)
                assert _fields(got) == _fields(want)
            for n_dev in (n_stages, 2 * n_stages):
                assert _fields(tthroughput.autotune_pipeline(plan, n_dev)) == \
                    _fields(jthroughput.autotune_pipeline(jplan, n_dev))


def _planted_samples(t, which, true, keys=("A", "B")):
    samples = []
    for key in keys:
        plan = _plans(key)[which]
        for M in (2, 4, 8):
            for mb in (8, 16):
                est = t.estimate_pipeline(plan, n_microbatches=M, microbatch=mb, constants=true)
                samples.append(t.sweep_sample(plan, n_microbatches=M, microbatch=mb, data=1,
                                              frames_per_s=est.frames_per_s))
    return samples


class TestFit:
    def test_recovers_planted_constants_as_the_reference(self):
        got = _both(lambda t, p, w: t.fit_constants(
            _planted_samples(t, w, t.PipelineCostConstants(3e9, 2e9, 5e-5))))
        assert _fields(got["torch"]) == _fields(got["jax"])
        fit = got["torch"]
        assert fit.source == "fitted"
        assert fit.flops_per_s == pytest.approx(3e9, rel=1e-6)
        assert fit.bytes_per_s == pytest.approx(2e9, rel=1e-6)
        assert fit.tick_overhead_s == pytest.approx(5e-5, rel=1e-6)

    def test_fallbacks_are_the_references(self):
        degenerate = _both(lambda t, p, w: t.fit_constants(
            _planted_samples(t, w, t.PipelineCostConstants(3e9, 2e9, 5e-5), keys=("A",))))
        assert _fields(degenerate["torch"]) == _fields(degenerate["jax"])
        assert degenerate["torch"].source == "default"
        assert tthroughput.fit_constants([]).source == "default"
        s = tthroughput.sweep_sample(_plans("A")["torch"], n_microbatches=4, microbatch=8,
                                     data=1, frames_per_s=100.0, overlap=True)
        assert tthroughput.fit_constants([s] * 5).source == "default"
        assert _fields(tthroughput.PipelineCostConstants()) == \
            _fields(jthroughput.PipelineCostConstants())


MEASURED = [
    {"n_stages": 3, "n_microbatches": 4, "microbatch": 16, "data": 2,
     "overlap": False, "edge_mode": "auto", "frames_per_s": 400.0},
    {"n_stages": 3, "n_microbatches": 8, "microbatch": 32, "data": 2,
     "overlap": False, "edge_mode": "auto", "frames_per_s": 700.0},
    {"n_stages": 3, "n_microbatches": 2, "microbatch": 16, "data": 2,
     "overlap": True, "edge_mode": "auto", "frames_per_s": 250.0},
    {"n_stages": 3, "n_microbatches": 2, "microbatch": 8, "data": 2,
     "overlap": False, "edge_mode": "boxed", "frames_per_s": 300.0},
]


class TestAutotune:
    @pytest.mark.parametrize("key", sorted(PLAN_SHAPES))
    def test_with_and_without_measurements(self, key):
        plans = _plans(key)
        for n_dev in (2, 3, 6, 8):
            for meas in ((), MEASURED, MEASURED[:1], [dict(MEASURED[0], data=4)]):
                for c in CONSTS:
                    got = _both(lambda t, p, w: t.autotune_pipeline(
                        plans[w], n_dev, measurements=meas, constants=_consts(t, c)))
                    assert _fields(got["torch"]) == _fields(got["jax"])
                    if not isinstance(got["torch"], tuple):
                        assert got["torch"].summary() == got["jax"].summary()

    def test_measured_outranks_model(self):
        t = tthroughput.autotune_pipeline(_plans("A")["torch"], 8, measurements=MEASURED)
        assert t.source == "measured" and t.n_microbatches == 8 and t.microbatch == 32
        assert t.frames_per_s == 700.0 and t.estimate is not None

    @pytest.mark.parametrize("key", sorted(PLAN_SHAPES))
    def test_candidate_grid_is_the_references(self, key):
        plans = _plans(key)
        for n_dev in (1, 3, 8):
            for grains in ((8, 16, 32), (6, 8, 16), (7,)):
                got = _both(lambda t, p, w: t.candidate_grid(plans[w], n_dev, grains=grains))
                assert got["torch"] == got["jax"]
        for mod in (tthroughput, jthroughput):
            with pytest.raises(ValueError, match="no pipeline candidate"):
                mod.autotune_pipeline(_plans("A")["jax"], 8, grains=(7,))


class TestLoadSweep:
    def test_filters_topology_and_label_as_the_reference(self, tmp_path):
        rows = [
            {"path": "pipeline_sweep", "topology": "cifar10", "label": "fp32",
             "frames_per_s": 100.0},
            {"path": "pipeline_sweep", "topology": "svhn", "label": "fp32",
             "frames_per_s": 200.0},
            {"path": "pipeline_sweep", "topology": "cifar10", "label": "int8",
             "frames_per_s": 250.0},
            {"path": "e2e_pipelined", "topology": "cifar10", "label": "fp32",
             "frames_per_s": 300.0},
        ]
        hist = tmp_path / "sweeps.jsonl"
        hist.write_text(json.dumps({"git_sha": "x", "rows": rows}) + "\n\n" + "not json\n"
                        + json.dumps({"git_sha": "y", "rows": rows[:1]}) + "\n")
        for topo, label in (("cifar10", "fp32"), ("cifar10", "int8"), ("svhn", "fp32"),
                            ("lenet5", "fp32")):
            got = _both(lambda t, p, w: t.load_sweep_measurements(hist, topo, label))
            assert got["torch"] == got["jax"]
        assert [r["frames_per_s"] for r in tthroughput.load_sweep_measurements(hist, "cifar10")] \
            == [100.0, 100.0]
        assert tthroughput.load_sweep_measurements(tmp_path / "absent.jsonl", "x") == []
