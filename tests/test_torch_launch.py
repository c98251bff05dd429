"""The port's launch layer on the CPU, held against the reference's
``repro.launch``: the train step (one and two AdamW steps on the same
numpy parameters and tokens, µbatch accumulation, the indivisible batch),
the serve steps, the sharding rules over all ten configurations at full
size on stand-ins of the 16 x 16 and 2 x 16 x 16 production meshes, and
the meta-device shape stand-ins for every configuration and input shape.

Tolerances:
- a train step against the reference's: losses rtol 1e-4; parameters
  rtol 1e-3, atol 1e-5 per element except at most ``MAX_PARAM_OFF_SHARE``
  of the elements, none off by more than 3 % of the summed learning rate
  (the trainer allowance of ``test_torch_training.py``: AdamW divides
  each element's first moment by the root of its second, so an element
  whose gradient is near zero turns an fp32 rounding difference into a
  visible share of its update);
- µbatches against one batch, in the port: losses rtol 1e-5, parameters
  atol 1e-5 (``test_optimizations.py::test_mb_equals_single_batch``);
- serve steps: rtol 1e-4, atol 1e-5; specs, shapes and dtypes: equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree_util import tree_leaves  # noqa: E402

MAX_PARAM_OFF_SHARE = 2e-4
LR = 3e-4


class FakeMesh:
    """A mesh's sizes and axis names only: what the rules read."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


PROD_MESHES = {"16x16": FakeMesh(data=16, model=16),
               "2x16x16": FakeMesh(pod=2, data=16, model=16)}


def _tiny(arch_cls, **kw):
    """test_optimizations.py's tiny dense config."""
    base = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=128, dtype="float32", remat="none")
    base.update(kw)
    return arch_cls(**base)


CONFIGS = {
    "tiny": lambda: (_tiny(jbase.ArchConfig), _tiny(tbase.ArchConfig)),
    "falcon-mamba-7b": lambda: (jconfigs.get_arch("falcon-mamba-7b").scaled_down(n_layers=2),
                                tconfigs.get_arch("falcon-mamba-7b").scaled_down(n_layers=2)),
}


def _setup(name, b=8, s=16, seed=1):
    jcfg, tcfg = CONFIGS[name]()
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
    return jcfg, tcfg, jp, toks


def _norm(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def _jflat(tree) -> dict:
    """{path: leaf} of a reference tree (``PartitionSpec``s as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jsh._path_str(path): leaf for path, leaf in flat}


def _tflat(tree, path=()) -> dict:
    """{path: leaf} of a port tree (``P``s and meta tensors as leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _tflat(sub, path + (key,)).items()}
    if isinstance(tree, list) and not isinstance(tree, tsh.P):
        return {k: v for i, sub in enumerate(tree) for k, v in _tflat(sub, path + (i,)).items()}
    return {} if tree is None else {"/".join(map(str, path)): tree}


def _assert_specs_equal(want_tree, got_tree):
    want, got = _jflat(want_tree), _tflat(got_tree)
    assert want.keys() == got.keys()
    for k, spec in want.items():
        assert isinstance(got[k], tsh.P)
        assert tuple(got[k]) == tuple(_norm(e) for e in spec), (k, spec, got[k])


def _assert_shapes_equal(want_tree, got_tree):
    want, got = _jflat(want_tree), _tflat(got_tree)
    assert want.keys() == got.keys()
    for k, sds in want.items():
        t = got[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(sds.shape), (k, tuple(t.shape), sds.shape)
        assert str(t.dtype).replace("torch.", "") == np.dtype(sds.dtype).name, (k, t.dtype)


# ---------------------------------------------------------------------------
# The train step


def _ref_steps(jcfg, jp, toks, n_steps, microbatches=1):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step = jax.jit(jsteps.make_train_step(jcfg, mesh, lr=LR, microbatches=microbatches))
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    opt = j_adamw_init(params, JAdamWConfig())
    losses = []
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, {"tokens": jnp.asarray(toks)})
        losses.append(float(metrics["loss"]))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)], losses


def _port_steps(tcfg, jp, toks, n_steps, microbatches=1):
    step = tsteps.make_train_step(tcfg, None, lr=LR, microbatches=microbatches)
    params = lm_params_from_numpy(jp, device="cpu")
    opt = adamw_init(params, AdamWConfig())
    losses, metrics = [], None
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, {"tokens": torch.from_numpy(toks)})
        losses.append(float(metrics["loss"]))
    assert set(metrics) == {"ce", "aux", "loss", "grad_norm"}
    assert int(opt.step) == n_steps
    return [t.numpy() for t in tree_leaves(params)], losses


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n_steps", [1, 2])
def test_train_step_matches_the_reference(name, n_steps):
    jcfg, tcfg, jp, toks = _setup(name)
    want, want_losses = _ref_steps(jcfg, jp, toks, n_steps)
    got, losses = _port_steps(tcfg, jp, toks, n_steps)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    off = total = 0
    largest = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        off += int((np.abs(g - w) > 1e-5 + 1e-3 * np.abs(w)).sum())
        total += w.size
        largest = max(largest, float(np.abs(g - w).max()))
    assert off <= MAX_PARAM_OFF_SHARE * total, (off, total)
    assert largest <= 0.03 * LR * n_steps, largest


def test_microbatches_equal_one_batch():
    """The reference's test_mb_equals_single_batch on the port: 4 µbatches
    of 2 against one batch of 8 (the loss is mean-reduced, so the
    gradients average exactly)."""
    _, tcfg, jp, toks = _setup("tiny")
    p1, l1 = _port_steps(tcfg, jp, toks, 1, microbatches=1)
    p4, l4 = _port_steps(tcfg, jp, toks, 1, microbatches=4)
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    for a, b in zip(p1, p4):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_indivisible_batch_raises():
    _, tcfg, jp, _ = _setup("tiny")
    params = lm_params_from_numpy(jp, device="cpu")
    step = tsteps.make_train_step(tcfg, None, microbatches=4)
    with pytest.raises(ValueError, match="divisible"):
        step(params, adamw_init(params, AdamWConfig()), {"tokens": torch.zeros((6, 9), dtype=torch.int32)})


def test_jit_train_step_gives_the_references_optimizer_shapes():
    jcfg, tcfg, _, _ = _setup("tiny")
    j_sds, _, _ = jspecs.params_shapes(jcfg, jax.make_mesh((1, 1), ("data", "model")))
    t_sds, _, _ = tspecs.params_shapes(tcfg, make_mesh((1, 1), ("data", "model"), device="cpu"))
    batch = tspecs.input_specs(tcfg, tbase.SHAPES["train_4k"])
    step, opt = tsteps.jit_train_step(tcfg, None, t_sds, batch)
    want = jax.eval_shape(lambda p: j_adamw_init(p, JAdamWConfig()), j_sds)
    _assert_shapes_equal(want.m, opt.m)
    _assert_shapes_equal(want.v, opt.v)
    assert opt.master is None and opt.step.dtype == torch.int32 and opt.step.shape == ()
    assert callable(step) and tsteps.VOCAB_CHUNK == jsteps.VOCAB_CHUNK == 8192
    specs = tsh.param_specs(t_sds, FakeMesh(data=16, model=16), fsdp=True)
    assert tsteps.opt_specs_like(specs) is specs


def test_serve_steps_match_the_reference():
    jcfg, tcfg, jp, toks = _setup("tiny", b=2, s=12)
    shape = jbase.ShapeConfig("small", 16, 2, "prefill")
    want, want_cache = jsteps.make_prefill_step(jcfg, shape)(jp, {"tokens": toks[:, :-1]})
    tp = lm_params_from_numpy(jp, device="cpu")
    got, cache = tsteps.make_prefill_step(tcfg, tbase.ShapeConfig("small", 16, 2, "prefill"))(
        tp, {"tokens": torch.from_numpy(toks[:, :-1])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want, _ = jsteps.make_decode_step(jcfg)(jp, want_cache, toks[:, -1:], jnp.asarray(12))
    got, _ = tsteps.make_decode_step(tcfg)(tp, cache, torch.from_numpy(toks[:, -1:]), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Sharding rules and shape stand-ins


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_param_batch_and_cache_specs_match_the_reference(name):
    """Every leaf's spec, for all ten configurations at full size, on the
    production meshes' sizes: parameters with and without FSDP, the
    inputs of every shape the config supports, and the decode caches
    with and without sequence sharding."""
    jcfg, tcfg = jconfigs.get_arch(name), tconfigs.get_arch(name)
    j_params = jax.eval_shape(lambda k: jT.init_params(k, jcfg), jax.random.PRNGKey(0))
    t_params, _, _ = tspecs.params_shapes(tcfg, PROD_MESHES["16x16"])
    for mesh in PROD_MESHES.values():
        for fsdp in (False, True):
            _assert_specs_equal(jsh.param_specs(j_params, mesh, fsdp=fsdp),
                                tsh.param_specs(t_params, mesh, fsdp=fsdp))
        for key, shape in jbase.SHAPES.items():
            if not jcfg.supports_shape(shape):
                continue
            t_shape = tbase.SHAPES[key]
            j_in = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in jspecs.input_specs(
                jcfg, shape, jax.make_mesh((1, 1), ("data", "model"))).items()}
            _assert_specs_equal(jsh.batch_specs(j_in, mesh),
                                tsh.batch_specs(tspecs.input_specs(tcfg, t_shape), mesh))
            if shape.kind in ("decode", "long_decode"):
                j_cache = jax.eval_shape(lambda s=shape: jT.init_stack_cache(
                    jcfg, jcfg.n_layers, s.global_batch, s.seq_len))
                t_cache, _, _ = tspecs.cache_shapes(tcfg, t_shape, mesh)
                for seq in (False, True):
                    _assert_specs_equal(jsh.cache_specs(j_cache, mesh, jcfg, seq_sharded=seq),
                                        tsh.cache_specs(t_cache, mesh, tcfg, seq_sharded=seq))


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_shape_stand_ins_match_the_references_eval_shape(name):
    """``input_specs``, ``params_shapes`` and ``cache_shapes``: the
    reference's shapes and dtypes on the meta device for every input
    shape the config supports, and the inputs' layout (``batch_specs``)
    the reference's input shardings, both on a 1 x 1 mesh."""
    jcfg, tcfg = jconfigs.get_arch(name), tconfigs.get_arch(name)
    j_mesh = jax.make_mesh((1, 1), ("data", "model"))
    t_mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    j_sds, _, j_specs = jspecs.params_shapes(jcfg, j_mesh)
    t_sds, t_named, t_specs = tspecs.params_shapes(tcfg, t_mesh)
    _assert_shapes_equal(j_sds, t_sds)
    _assert_specs_equal(j_specs, t_specs)
    assert all(n.mesh is t_mesh and n.spec == _tflat(t_specs)[k]
               for k, n in _tflat(t_named).items())
    for key, shape in jbase.SHAPES.items():
        if not jcfg.supports_shape(shape):
            continue
        j_in = jspecs.input_specs(jcfg, shape, j_mesh)
        t_in = tspecs.input_specs(tcfg, tbase.SHAPES[key], t_mesh)
        _assert_shapes_equal(j_in, t_in)
        _assert_specs_equal({k: v.sharding.spec for k, v in j_in.items()},
                            tsh.batch_specs(t_in, t_mesh))
        if shape.kind in ("decode", "long_decode"):
            j_cache, _, j_cspecs = jspecs.cache_shapes(jcfg, shape, j_mesh)
            t_cache, _, t_cspecs = tspecs.cache_shapes(tcfg, tbase.SHAPES[key], t_mesh)
            _assert_shapes_equal(j_cache, t_cache)
            _assert_specs_equal(j_cspecs, t_cspecs)


def test_constrain_spec_restates_the_references_cases():
    """tests/test_launch.py's TestConstrainSpec cases, and the spec type's
    one-name normalization."""
    assert tsh.constrain_spec(tsh.P("model", None), (92553, 2048),
                              FakeMesh(data=1, model=1)) == tsh.P("model", None)
    assert tsh.constrain_spec(tsh.P(("pod", "data"), None), (16, 8),
                              FakeMesh(pod=2, data=16)) == tsh.P("pod", None)
    assert tsh.constrain_spec(tsh.P("data", None), (1, 8), FakeMesh(data=16)) == tsh.P(None, None)
    assert tsh.constrain_spec(tsh.P("model", None), (92553, 2048),
                              PROD_MESHES["16x16"]) == tsh.P(None, None)
    assert tsh.P(("data",), None) == tsh.P("data", None) and repr(tsh.P("model")) == "P('model')"


def test_production_mesh_has_the_references_shape_and_axes():
    mesh = make_production_mesh(device="cpu")
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    assert mesh.axis_names == ("data", "model")
    pods = make_production_mesh(multi_pod=True, device="cpu")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16} and pods.size == 512
    specs = tsh.param_specs(tspecs.params_shapes(
        dataclasses.replace(tconfigs.get_arch("qwen2.5-3b"), n_layers=2), mesh)[0], mesh)
    assert specs["stack"]["units"][0]["attn"]["wq"]["w"] == tsh.P(None, None, "model")
