"""The LM train step jitted (``launch/steps.py`` ``JittedTrainStep``,
``jit_train_step``) on the CPU, where a call is the eager step on the
key's static buffers, held against the reference (``repro.launch.steps``:
``jax.jit(make_train_step(...))`` and its ``jit_train_step``, which
donates the parameters and optimizer state).

- ``jit_train_step`` (donating, the returned trees handed back) and a
  ``JittedTrainStep`` of ``make_train_step`` without donation, two steps
  of ``qwen2.5-3b`` and ``falcon-mamba-7b`` at ``scaled_down()`` with 1
  and 2 µbatches, against the reference's two jitted steps on the same
  numpy parameters and tokens: losses within rtol 1e-5, every parameter
  and optimizer leaf within rtol 1e-4, atol 1e-5 but for at most
  ``MAX_OFF_SHARE`` of the elements (the allowance of
  ``test_torch_launch.py``: AdamW divides each element's first moment by
  the root of its second, so an element whose gradient is near zero
  turns an fp32 rounding difference into a visible share of its update),
  none off by more than 3 % of the summed learning rate; and bit for bit
  against the port's own eager step.
- The surface: one key per (batch, trees); the caller's trees unchanged
  without donation; with donation a handed-back tree is not staged (the
  count of staged leaves pinned) and any other tree is copied in and left
  as it was; ``OptState.master`` carried in bf16 training; a step
  that returns trees of other shapes cannot be donated; the step count
  reaches ``fn`` as a 0-d int32 tensor, from an int or a tensor.
- ``dryrun.cell_step`` gives the eager step, whose op log on ``meta``
  is ``make_train_step``'s.
- ``examples/torch/train_lm.py``: a run with an injected failure ends
  where the clean run ends, through the jitted step; each LM example's
  jitted step is its eager closure bit for bit; ``quickstart.py`` runs
  its 30 steps through one key.
- ``kernels/probe.py``'s capture log across threads: launches logged
  from a second thread onto the capture's stream land in the capture's
  log once, launches onto another stream never.

The CUDA graphs themselves are held in ``test_torch_lm_train_graph_card.py``.
"""
import contextlib
import functools
import importlib.util
import io
import os
import threading

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.optflags import BASELINE, OptFlags  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, OptState, adamw_init  # noqa: E402
from repro_torch.tree_util import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4
MAX_OFF_SHARE = 2e-4
STEPS = 2
CONFIGS = ("qwen2.5-3b", "falcon-mamba-7b")


def _cfgs(name):
    return (jconfigs.get_arch(name).scaled_down(), tconfigs.get_arch(name).scaled_down())


def _tokens(vocab, b=4, s=16, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _init(name):
    jcfg, _ = _cfgs(name)
    return jax.device_get(jT.init_params(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _reference(name, microbatches, donating):
    """Two reference steps: ``jit_train_step`` (donating) or a bare
    ``jax.jit(make_train_step)``. Returns (per step: the losses, the
    numpy leaves of params and optimizer state)."""
    jcfg, _ = _cfgs(name)
    # Auto axes: the reference's shardings as hints, as its launcher uses them.
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    toks = _tokens(jcfg.vocab_size)
    if donating:
        p_sds, _, _ = jspecs.params_shapes(jcfg, mesh)
        b_sds = {"tokens": jax.ShapeDtypeStruct(toks.shape, jnp.int32)}
        step, _ = jsteps.jit_train_step(jcfg, mesh, p_sds, b_sds, microbatches=microbatches,
                                        lr=LR)
    else:
        step = jax.jit(jsteps.make_train_step(jcfg, mesh, lr=LR, microbatches=microbatches))
    params = jax.tree_util.tree_map(jnp.asarray, _init(name))
    opt = j_adamw_init(params, JAdamWConfig())
    out = []
    for _ in range(STEPS):
        params, opt, metrics = step(params, opt, {"tokens": jnp.asarray(toks)})
        out.append((float(metrics["loss"]),
                    [np.asarray(x) for x in jax.tree_util.tree_leaves((params, opt))]))
    return out


def _port_init(name, opt_cfg=None):
    params = lm_params_from_numpy(_init(name), device="cpu")
    return params, adamw_init(params, opt_cfg or AdamWConfig())


def _assert_close_to_reference(got, want, n_steps):
    off = total = 0
    largest = 0.0
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        if g.dtype.kind == "i":
            assert np.array_equal(g, w)
            continue
        off += int((np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)).sum())
        total += w.size
        largest = max(largest, float(np.abs(g - w).max()))
    assert off <= MAX_OFF_SHARE * total, (off, total)
    # The moments' and parameters' largest deviation: a share of the rate.
    assert largest <= 0.03 * LR * n_steps or largest <= 1e-4, largest


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("donating", [True, False])
def test_jitted_step_matches_the_reference_and_the_eager_step(name, microbatches, donating):
    jcfg, tcfg = _cfgs(name)
    toks = torch.from_numpy(_tokens(jcfg.vocab_size))
    if donating:
        t_sds = tspecs.params_shapes(
            tcfg, make_mesh((1, 1), ("data", "model"), device="cpu"))[0]
        jitted, opt_sds = tsteps.jit_train_step(tcfg, None, t_sds, {"tokens": toks},
                                                microbatches=microbatches, lr=LR)
        assert jitted.donate and opt_sds.m is not None
    else:
        jitted = tsteps.JittedTrainStep(
            lambda p, o, b, s, f=tsteps.make_train_step(tcfg, lr=LR, microbatches=microbatches):
            f(p, o, b), donate=False)
    eager = tsteps.make_train_step(tcfg, lr=LR, microbatches=microbatches)
    p, o = _port_init(name)
    pe, oe = _port_init(name)
    for s, (want_loss, want) in enumerate(_reference(name, microbatches, donating)):
        p, o, metrics = jitted(p, o, {"tokens": toks})
        pe, oe, me = eager(pe, oe, {"tokens": toks})
        assert set(metrics) == {"ce", "aux", "loss", "grad_norm"}
        np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
        _assert_close_to_reference(tree_leaves((p, o)), want, s + 1)
        for a, b in zip(tree_leaves((p, o, metrics)), tree_leaves((pe, oe, me))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(o.step) == STEPS and jitted._cache_size() == 1


def _qwen_step(donate, opt_cfg=None, cfg=None):
    cfg = cfg or _cfgs("qwen2.5-3b")[1]
    eager = tsteps.make_train_step(cfg, opt_cfg=opt_cfg)
    return tsteps.JittedTrainStep(lambda p, o, b, s: eager(p, o, b), donate=donate), eager


def test_one_key_per_batch_and_trees_and_the_callers_trees_unchanged():
    step, _ = _qwen_step(donate=False)
    p, o = _port_init("qwen2.5-3b")
    kept = [t.clone() for t in tree_leaves((p, o))]
    toks = torch.from_numpy(_tokens(_cfgs("qwen2.5-3b")[1].vocab_size))
    p1, o1, _ = step(p, o, {"tokens": toks})
    p2, o2, _ = step(p1, o1, {"tokens": toks})
    assert step._cache_size() == 1
    # Without donation the returned trees are new tensors and stay valid.
    entry = next(iter(step._graphs.values()))
    static = {t.untyped_storage().data_ptr() for t in entry.leaves}
    assert not static & {t.untyped_storage().data_ptr() for t in tree_leaves((p1, o1, p2, o2))}
    assert int(o1.step) == 1 and int(o2.step) == 2
    step(p, o, {"tokens": toks[:2]})
    assert step._cache_size() == 2
    step(p, o, {"tokens": toks[:, :9]})
    assert step._cache_size() == 3
    step(p, o, {"tokens": toks[:2]})
    assert step._cache_size() == 3
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p, o)), kept))
    assert step.staged == 5 * len(kept) and step.captures == step.replays == 0


def test_a_handed_back_tree_is_not_staged_and_any_other_is_copied_in():
    step, eager = _qwen_step(donate=True)
    p, o = _port_init("qwen2.5-3b")
    n = len(tree_leaves((p, o)))
    kept = [t.clone() for t in tree_leaves((p, o))]
    toks = torch.from_numpy(_tokens(_cfgs("qwen2.5-3b")[1].vocab_size))
    p1, o1, _ = step(p, o, {"tokens": toks})
    assert step.staged == n
    entry = next(iter(step._graphs.values()))
    assert p1 is entry.params and o1 is entry.opt_state
    p2, o2, m2 = step(p1, o1, {"tokens": toks})
    assert step.staged == n and p2 is p1 and int(o2.step) == 2
    # The trees handed back were advanced in place: two eager steps.
    pe, oe, me = eager(*eager(p, o, {"tokens": toks})[:2], {"tokens": toks})
    for a, b in zip(tree_leaves((p2, o2, m2)), tree_leaves((pe, oe, me))):
        assert torch.equal(a, b)
    # Another tree is copied in and left as it was.
    p3, o3, _ = step(p, o, {"tokens": toks})
    assert step.staged == 2 * n and p3 is p1 and int(o3.step) == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p, o)), kept))
    # One leaf of another tree: that leaf alone is staged.
    mixed = OptState(step=o.step.clone(), m=o3.m, v=o3.v, master=None)
    step(p3, mixed, {"tokens": toks})
    assert step.staged == 2 * n + 1 and step._cache_size() == 1


def test_the_master_copy_is_carried_in_bf16_training():
    cfg = tconfigs.get_arch("qwen2.5-3b").scaled_down(dtype="bfloat16")
    opt_cfg = AdamWConfig(keep_master_copy=True)
    step, eager = _qwen_step(donate=True, opt_cfg=opt_cfg, cfg=cfg)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = adamw_init(params, opt_cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    p, o = params, opt
    pe, oe = params, opt
    for _ in range(3):
        p, o, m = step(p, o, {"tokens": toks})
        pe, oe, me = eager(pe, oe, {"tokens": toks})
        assert o.master is not None
        for a, b in zip(tree_leaves((p, o, m)), tree_leaves((pe, oe, me))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert {t.dtype for t in tree_leaves(o.master)} == {torch.float32}
    assert {t.dtype for t in tree_leaves(p)} == {torch.bfloat16}
    # The bf16 params are the rounded master copy.
    assert all(torch.equal(a, b.to(torch.bfloat16))
               for a, b in zip(tree_leaves(p), tree_leaves(o.master)))


def test_a_step_returning_other_shapes_cannot_be_donated():
    def shrink(p, o, b, s):
        return {"w": p["w"][:1]}, o, {"n": s}

    p = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="donated"):
        tsteps.JittedTrainStep(shrink, donate=True)(p, (), {"x": torch.zeros(2)})
    out = tsteps.JittedTrainStep(shrink, donate=False)(p, (), {"x": torch.zeros(2)}, 7)
    assert out[0]["w"].shape == (1,) and int(out[2]["n"]) == 7


@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_the_step_reaches_fn_as_a_0d_int32_tensor(kind):
    seen = []

    def fn(p, o, b, s):
        seen.append((s.shape, s.dtype, int(s)))
        return {"w": p["w"] + s}, o, {"s": s * 1}

    step = tsteps.JittedTrainStep(fn, donate=True)
    p, o = {"w": torch.zeros(2, dtype=torch.int32)}, ()
    for i in (3, 5):
        p, o, m = step(p, o, {"x": torch.zeros(1)}, i if kind == "int" else torch.tensor(i))
    assert seen == [((), torch.int32, 3), ((), torch.int32, 5)]
    assert p["w"].tolist() == [8, 8] and int(m["s"]) == 5


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("microbatches", [1, 2])
def test_cell_step_gives_the_eager_step_and_todays_op_log(name, microbatches):
    cfg = tconfigs.get_arch(name).scaled_down()
    shape = ShapeConfig("t", 32, 2, "train")
    mesh = make_production_mesh(device="cpu")
    opt = OptFlags(microbatches=microbatches) if microbatches > 1 else BASELINE
    step, args, _ = D.cell_step(cfg, shape, mesh, opt)
    assert not isinstance(step, tsteps.JittedTrainStep)
    _, rec, counter = H.record(step, *args, device="meta")
    today = tsteps.make_train_step(cfg, mesh, microbatches=microbatches)
    _, want, want_counter = H.record(today, *args, device="meta")
    assert H.op_counts(rec.instrs) == H.op_counts(want.instrs)
    assert H.analyze_hlo(rec.instrs) == H.analyze_hlo(want.instrs)
    assert counter == want_counter and rec.peak_live_bytes == want.peak_live_bytes


def _example(file):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{file[:-3]}", os.path.join(REPO, "examples", "torch", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        step = mod.main(argv)
    lines = buf.getvalue().splitlines()
    assert lines[-1] == "OK"
    return step, lines


def test_train_lm_restarts_to_the_clean_runs_end_through_the_jitted_step(tmp_path):
    mod = _example("train_lm.py")
    args = ["--device", "cpu", "--steps", "12", "--ckpt-every", "5"]
    clean, c_lines = _main(mod, args + ["--ckpt-dir", str(tmp_path / "clean")])
    faulted, f_lines = _main(mod, args + ["--ckpt-dir", str(tmp_path / "faulted"),
                                          "--inject-failure-at", "7"])
    assert isinstance(clean, tsteps.JittedTrainStep) and not clean.donate
    assert clean._cache_size() == faulted._cache_size() == 1
    done, done_f = (next(ln for ln in lines if ln.startswith("done:"))
                    for lines in (c_lines, f_lines))
    assert "restarts=0" in done and "restarts=1" in done_f
    assert done.split("final loss ")[1].split()[0] == done_f.split("final loss ")[1].split()[0]


@pytest.mark.parametrize("file", ["train_lm.py", "quickstart.py"])
def test_an_examples_jitted_step_is_its_eager_closure_bit_for_bit(file):
    from repro_torch.optim import linear_warmup_cosine

    mod = _example(file)
    opt_cfg = AdamWConfig(weight_decay=0.01)
    if file == "train_lm.py":
        cfg = mod.make_cfg("smoke")
        eager = mod.make_train_step(cfg, opt_cfg, linear_warmup_cosine(1e-3, warmup_steps=3,
                                                                       total_steps=8))
    else:
        cfg = mod.make_cfg()
        eager = mod.make_train_step(cfg, opt_cfg)
    jitted = tsteps.JittedTrainStep(eager, donate=False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = adamw_init(params, opt_cfg)
    rng = np.random.default_rng(0)
    pj, oj, pe, oe = params, opt, params, opt
    for s in range(8):
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))}
        pj, oj, mj = jitted(pj, oj, batch, s)
        pe, oe, me = eager(pe, oe, batch, torch.tensor(s, dtype=torch.int32))
        for a, b in zip(tree_leaves((pj, oj, mj)), tree_leaves((pe, oe, me))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert jitted._cache_size() == 1 and int(oj.step) == 8


def test_quickstart_trains_through_one_key():
    step, lines = _main(_example("quickstart.py"), ["--device", "cpu"])
    assert isinstance(step, tsteps.JittedTrainStep) and not step.donate
    assert step._cache_size() == 1 and step.staged == 30 * len(tree_leaves(
        next(iter(step._graphs.values())).leaves))
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("step ")]
    assert len(losses) == 4 and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# The probe's capture log across threads


def _launch_from_thread(name, stream, own_log=False):
    """``probe.launched`` from a new thread (as autograd's device thread
    or a tenant's would launch), with a log of that thread's own open or
    not; returns that log's launches."""
    got = []

    def body():
        if own_log:
            with probe.recording() as log:
                probe.launched(name, 64, stream)
            got.extend(log.launches)
        else:
            probe.launched(name, 64, stream)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    return got


def test_a_capture_log_takes_launches_onto_its_stream_from_any_thread():
    capture_stream, other_stream = 0x7F00, 0x7F08
    before = dict(kscan.LAUNCHES)
    with probe.recording() as log, probe.capturing(capture_stream, log):
        # The capturing thread itself: logged once.
        probe.launched("ssm_scan", 32, capture_stream)
        # Autograd's thread on the capture's stream (a remat recompute).
        assert _launch_from_thread("ssm_scan", capture_stream) == []
        # Another thread's eager launch on its own stream: never logged.
        assert _launch_from_thread("ssm_scan", other_stream) == []
        assert _launch_from_thread("ssm_scan", None) == []
        # A thread with a log of its own: there, and on the capture's
        # stream in the capture's log as well.
        own = _launch_from_thread("ssm_scan", other_stream, own_log=True)
        assert own == [("", "ssm_scan", 64)]
        own = _launch_from_thread("ssm_scan", capture_stream, own_log=True)
        assert own == [("", "ssm_scan", 64)]
        assert log.launches == [("", "ssm_scan", 32), ("", "ssm_scan", 64),
                                ("", "ssm_scan", 64)]
        # What the capture logged is what its replays count again.
        kscan.LAUNCHES["ssm_scan"] += 3
        probe.uncount(log.launches)
        assert kscan.LAUNCHES == before
    # Closed: nothing routes by that stream any more.
    assert probe._CAPTURES == {}
    assert _launch_from_thread("ssm_scan", capture_stream, own_log=True) == [
        ("", "ssm_scan", 64)]
    with probe.recording() as replay_log:
        probe.replayed([(n, s) for _, n, s in log.launches])
    assert kscan.LAUNCHES["ssm_scan"] == before["ssm_scan"] + 3
    assert [n for _, n, _ in replay_log.launches] == ["ssm_scan"] * 3
    kscan.LAUNCHES["ssm_scan"] -= 3
