"""The CNN training step with its QAT exponent and learning rate on the
device, and jitted (``paper/train_cnn.py`` ``jit_train_step``), on the
CPU, held against the reference (``repro.paper.train_cnn``, whose step is
a bare ``jax.jit`` of loss, gradient, clipping and AdamW with
``sched(step)`` inside).

- The exponent (``fixed_point.ceil_log2``) is computed where the tensor
  lives. Its elementwise form equals XLA's float32
  ``jnp.ceil(jnp.log2(jnp.maximum(v, 1e-12)))``, eager and jitted, at all
  520,446 float32 values within 1,024 ulps of every power of two from
  2^-126 to 2^127 (the only places where ``ceil`` can move), and at a
  million values drawn over the whole range.
- An eager step of lenet5 in fp32, 8/8 and 4/4-bit QAT and pow2 reads no
  tensor value on the host: a ``TorchDispatchMode`` raises on
  ``aten._local_scalar_dense``, the op behind ``.item()``, ``int()``,
  ``float()`` and ``bool()`` of a tensor (the pattern of
  ``launch/hlo_analysis.py`` ``OpRecorder``).
- ``fake_quant_dynamic`` and its straight-through gradient are the
  reference's bit for bit on every conv and FC tensor of the five
  topologies at 3, 4, 6 and 8 bits.
- The schedule from a step tensor: the warmup branch bit for bit the
  reference's ``sched(jnp.asarray(s))``; the cosine branch equal wherever
  ``torch.cos`` and XLA's ``cos`` agree on the same float32 input; where
  they round it one ulp apart (14 of its 381 inputs), the reference's
  arithmetic on torch's cos gives the port's value bit for bit, so no
  other op differs.
- ``JittedTrainStep`` (on the CPU the eager step on its static buffers)
  bit for bit 10 eager ``train_step``s with ``lr=sched(step)``, the
  caller's trees unchanged, the returned trees sharing no storage with
  the static ones, the step an int or a tensor.
- ``train_cnn`` (through ``jit_train_step``) against the reference's on
  the same arrays with the pow2 head: losses at the fp32 trainer's rtol
  1e-4 (the fp32 and 8-bit trainers are held in
  ``test_torch_training.py``).

The CUDA graphs themselves are held in ``test_torch_train_graph_card.py``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core.quant import fixed_point as jfp  # noqa: E402
from repro.data import make_image_dataset as jax_make_image_dataset  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import LENET5 as JAX_LENET5  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro.optim.schedules import linear_warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.paper.train_cnn import train_cnn as jax_train_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.quant import fixed_point as tfp  # noqa: E402
from repro_torch.data import SyntheticImageDataset  # noqa: E402
from repro_torch.models.cnn import LENET5  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine  # noqa: E402
from repro_torch.paper.train_cnn import (  # noqa: E402
    JittedTrainStep,
    jit_train_step,
    train_cnn,
    train_step,
)
from repro_torch.tree_util import tree_flatten  # noqa: E402

BATCH = 4
# (weight_bits, act_bits, pow2_weights) of the training modes.
MODES = {"fp32": (None, None, False), "qat8": (8, 8, False), "qat4": (4, 4, False),
         "pow2": (None, None, True)}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _grid() -> np.ndarray:
    """Every float32 within 1,024 ulps of 2^k, k = -126..127 (520,446)."""
    k = np.arange(-126, 128)
    bits = ((k + 127) << 23)[:, None] + np.arange(-1024, 1025)[None, :]
    return bits.reshape(-1).astype(np.int32).view(np.float32)


def test_exponent_formula_is_xlas_on_every_value_near_a_power_of_two():
    v = _grid()
    assert v.size == 520_446
    got = tfp.ceil_log2_each(torch.from_numpy(v)).numpy()

    def xla(a):
        return jnp.ceil(jnp.log2(jnp.maximum(a, 1e-12)))

    # Equal as numbers: XLA's ceil gives -0.0 on (0.5, 1), the count +0.0.
    for want in (np.asarray(xla(jnp.asarray(v))), np.asarray(jax.jit(xla)(jnp.asarray(v)))):
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, [(float(v[i]), float(got[i]), float(want[i])) for i in bad[:5]]


def test_exponent_is_xlas_anywhere_else():
    """Away from the powers of two the formula cannot step: one million
    float32 bit patterns drawn over the whole positive range, and zero,
    the clamp, the largest float, the least subnormal, inf and NaN."""
    rng = np.random.default_rng(7)
    v = rng.integers(0, 0x7F800000, 1_000_000).astype(np.int32).view(np.float32)
    v = np.concatenate([v, np.array([0.0, 1e-12, np.finfo(np.float32).max, 1e-45, np.inf, np.nan],
                                    np.float32)])
    got = tfp.ceil_log2_each(torch.from_numpy(v)).numpy()
    want = np.asarray(jnp.ceil(jnp.log2(jnp.maximum(jnp.asarray(v), 1e-12))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [-30, -15, -13, -1, 0, 1, 12, 30])
def test_exponent_tensor_is_the_host_int_and_the_references(k):
    """``ceil_log2`` is a 0-d float32 tensor on x's device; ``_ceil_log2``
    its host view; both the reference's ``dynamic_spec`` exponent."""
    p = np.float32(2.0 ** k)
    for top in (np.nextafter(p, np.float32(0)), p, np.nextafter(p, np.float32(np.inf))):
        arr = np.array([0.5 * top, -top], np.float32)
        m = tfp.ceil_log2(torch.from_numpy(arr))
        assert m.shape == () and m.dtype == torch.float32 and m.device.type == "cpu"
        want = 7 - jfp.dynamic_spec(jnp.asarray(arr), 8).frac_bits
        assert tfp._ceil_log2(torch.from_numpy(arr)) == int(m) == want


class _NoHostReads(TorchDispatchMode):
    """Raise on any read of a tensor's value on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor value was read on the host inside the step")
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _setup():
    """lenet5 at the reference's init (key 1) as numpy, and a seeded batch."""
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(1), JAX_LENET5))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=BATCH).astype(np.int64)
    return params, x, y


def _step_args(mode):
    params, x, y = _setup()
    tparams = params_from_numpy(params, "cpu")
    cfg = AdamWConfig(weight_decay=0.01)
    wb, ab, p2 = MODES[mode]
    kw = dict(topo=LENET5, cfg=cfg, weight_bits=wb, act_bits=ab, pow2_weights=p2)
    return tparams, adamw_init(tparams, cfg), torch.from_numpy(x), torch.from_numpy(y), kw


@pytest.mark.parametrize("mode", sorted(MODES))
def test_an_eager_step_reads_nothing_on_the_host(mode):
    params, opt, x, y, kw = _step_args(mode)
    sched = linear_warmup_cosine(3e-3, 20, 100)
    step = torch.tensor(3, dtype=torch.int32)
    # The guard itself: a host read inside it raises.
    with pytest.raises(AssertionError, match="host"), _NoHostReads():
        int(step)
    with _NoHostReads():
        new_p, new_opt, loss, gnorm = train_step(params, opt, x, y, sched(step), **kw)
    assert bool(torch.isfinite(loss)) and float(gnorm) > 0
    assert int(new_opt.step) == 1


def _topology_tensors(name):
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(3), JAX_TOPOLOGIES[name]))
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(params)]


@pytest.mark.parametrize("name", sorted(JAX_TOPOLOGIES))
def test_fake_quant_dynamic_and_its_gradient_are_the_references(name):
    rng = np.random.default_rng(1)
    for arr in _topology_tensors(name):
        g = rng.normal(size=arr.shape).astype(np.float32)
        # Scale a tensor up so a value sits past the clip range's top.
        arr = arr.copy()
        arr.reshape(-1)[0] = np.float32(2.0) ** np.ceil(np.log2(np.abs(arr).max() + 1e-30))
        for bits in (3, 4, 6, 8):
            want, vjp = jax.vjp(lambda a: jfp.fake_quant_dynamic(a, bits), jnp.asarray(arr))
            (want_g,) = vjp(jnp.asarray(g))
            x = torch.from_numpy(arr).requires_grad_()
            got = tfp.fake_quant_dynamic(x, bits)
            (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(g))
            np.testing.assert_array_equal(_bits(got.detach().numpy()), _bits(np.asarray(want)))
            np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_schedule_from_a_step_tensor_is_the_references():
    jsched, tsched = jax_warmup_cosine(3e-3, 20, 400), linear_warmup_cosine(3e-3, 20, 400)
    cos_apart = 0
    for s in range(401):
        want = np.asarray(jsched(jnp.asarray(s)))
        got = tsched(torch.tensor(s)).numpy()
        assert got.dtype == np.float32
        if s < 20:
            assert _bits(got) == _bits(want), s
            continue
        # The cosine branch: the input to cos is the reference's bit for
        # bit; the two libraries' cos may round it one ulp apart.
        t = torch.clamp((torch.tensor(s) - 20).to(torch.float32) / 380, 0.0, 1.0)
        arg = (np.pi * t).numpy()
        jt = jnp.clip(jnp.asarray(s - 20).astype(jnp.float32) / 380, 0.0, 1.0)
        assert _bits(arg) == _bits(np.asarray(jnp.pi * jt)), s
        tcos = torch.cos(torch.from_numpy(arg)).numpy()
        if _bits(tcos) == _bits(np.asarray(jnp.cos(arg))):
            assert _bits(got) == _bits(want), s
        else:
            # The reference's own arithmetic on torch's cos gives the
            # port's value: cos is the only op apart.
            cos_apart += 1
            assert abs(int(_bits(tcos)) - int(_bits(np.asarray(jnp.cos(arg))))) == 1, s
            rest = 3e-3 * (0.1 + (1 - 0.1) * (0.5 * (1.0 + jnp.asarray(tcos))))
            assert _bits(got) == _bits(np.asarray(rest)), s
    assert cos_apart <= 14, cos_apart


def _eager_steps(mode, n, sched):
    params, opt, x, y, kw = _step_args(mode)
    out = []
    for s in range(n):
        params, opt, loss, gnorm = train_step(params, opt, x, y, sched(torch.tensor(s, dtype=torch.int32)),
                                              **kw)
        out.append((params, opt, loss, gnorm))
    return out


def _leaves(*trees):
    return [t for tree in trees for t in tree_flatten(tree)[0]]


@pytest.mark.parametrize("mode", ["fp32", "qat8"])
@pytest.mark.parametrize("step_kind", ["int", "tensor"])
def test_jitted_step_is_the_eager_step_bit_for_bit(mode, step_kind):
    sched = linear_warmup_cosine(3e-3, 3, 10)
    want = _eager_steps(mode, 10, sched)
    params, opt, x, y, kw = _step_args(mode)
    step_fn = jit_train_step(LENET5, kw["cfg"], sched, weight_bits=kw["weight_bits"],
                             act_bits=kw["act_bits"], pow2_weights=kw["pow2_weights"])
    assert isinstance(step_fn, JittedTrainStep)
    kept = [t.clone() for t in _leaves(params, opt)]
    p, o = params, opt
    for s in range(10):
        given = _leaves(p, o)
        before = [t.clone() for t in given]
        step = s if step_kind == "int" else torch.tensor(s)
        p, o, loss, gnorm = step_fn(p, o, x, y, step)
        # The caller's trees are never written.
        assert all(torch.equal(a, b) for a, b in zip(given, before))
        wp, wo, wloss, wgnorm = want[s]
        for a, b in zip(_leaves(p, o) + [loss, gnorm], _leaves(wp, wo) + [wloss, wgnorm]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params, opt), kept))
    assert step_fn._cache_size() == 1


def test_returned_trees_share_no_storage_and_a_new_batch_shape_is_a_new_key():
    params, opt, x, y, kw = _step_args("fp32")
    step_fn = jit_train_step(LENET5, kw["cfg"], linear_warmup_cosine(3e-3, 3, 10))
    p1, o1, _, _ = step_fn(params, opt, x, y, 0)
    entry = next(iter(step_fn._graphs.values()))
    static = {t.untyped_storage().data_ptr()
              for t in entry.leaves + entry.batch_leaves + [entry.step]}
    for t in _leaves(p1, o1):
        assert t.untyped_storage().data_ptr() not in static
    want1 = _leaves(*_eager_steps("fp32", 1, step_fn.sched)[0][:2])
    p2, o2, _, _ = step_fn(p1, o1, x, y, 1)
    # Trees returned earlier stay valid after later calls.
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p1, o1), want1))
    assert step_fn._cache_size() == 1
    step_fn(p2, o2, x[:2], y[:2], 2)
    assert step_fn._cache_size() == 2


@functools.lru_cache(maxsize=None)
def _pow2_pair():
    ds = jax_make_image_dataset(hw=28, channels=1, seed=0, n_train_per_class=64)
    p = jax.device_get(jax_init_cnn(jax.random.PRNGKey(1), JAX_LENET5))
    want = jax_train_cnn(JAX_LENET5, steps=5, dataset=ds, log_every=1, pow2_weights=True,
                         init_params=jax.tree_util.tree_map(jnp.asarray, p))
    tds = SyntheticImageDataset(*(np.array(a) for a in (ds.x_train, ds.y_train, ds.x_test, ds.y_test)),
                                ds.n_classes)
    got = train_cnn(LENET5, steps=5, dataset=tds, init_params=p, log_every=1, pow2_weights=True,
                    device="cpu")
    return want, got


def test_pow2_trainer_losses_match_the_reference():
    want, got = _pow2_pair()
    assert [h["step"] for h in got.history] == list(range(5))
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history], rtol=1e-4)
