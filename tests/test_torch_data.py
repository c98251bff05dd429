"""The port's data pipeline on the CPU: the reference's own
``test_data.py`` assertions on the port, and the port against the
reference.

The token stream is the reference's numpy generator, so its batches are
held equal to the reference's bit for bit. The image dataset is drawn
from a ``torch.Generator`` with the reference's recipe: its numbers are
not the reference's ``jax.random`` ones (and are not compared), its
shapes, dtypes, label layout and value range are. To train both packages
on the same frames, the tests carry the reference's arrays across.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.data import TokenStreamConfig as JaxTokenStreamConfig  # noqa: E402
from repro.data import make_image_dataset as jax_make_image_dataset  # noqa: E402
from repro.data import synthetic_token_batches as jax_token_batches  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ShardedLoader,
    TokenStreamConfig,
    make_image_dataset,
    synthetic_token_batches,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402


class TestImageDataset:
    def test_shapes_and_determinism(self):
        a = make_image_dataset(hw=16, channels=2, n_train_per_class=8,
                               n_test_per_class=4, seed=7)
        b = make_image_dataset(hw=16, channels=2, n_train_per_class=8,
                               n_test_per_class=4, seed=7)
        assert a.x_train.shape == (80, 16, 16, 2)
        assert a.x_test.shape == (40, 16, 16, 2)
        np.testing.assert_array_equal(a.x_train, b.x_train)

    def test_different_seeds_differ(self):
        a = make_image_dataset(hw=8, channels=1, n_train_per_class=4,
                               n_test_per_class=2, seed=0)
        b = make_image_dataset(hw=8, channels=1, n_train_per_class=4,
                               n_test_per_class=2, seed=1)
        assert not np.allclose(a.x_train, b.x_train)

    def test_labels_balanced(self):
        ds = make_image_dataset(hw=8, channels=1, n_train_per_class=8,
                                n_test_per_class=2, seed=0, n_classes=5)
        counts = np.bincount(np.asarray(ds.y_train), minlength=5)
        assert np.all(counts == 8)


def test_image_dataset_has_the_references_layout_but_its_own_numbers():
    kw = dict(hw=12, channels=3, n_classes=4, n_train_per_class=6, n_test_per_class=3, seed=2)
    got, want = make_image_dataset(**kw), jax_make_image_dataset(**kw)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype
    np.testing.assert_array_equal(got.y_train.numpy(), np.asarray(want.y_train))
    np.testing.assert_array_equal(got.y_test.numpy(), np.asarray(want.y_test))
    assert got.n_classes == want.n_classes == 4
    assert float(got.x_train.abs().max()) <= 2.0
    assert not np.allclose(got.x_train.numpy(), np.asarray(want.x_train))  # another generator
    # Each class is its own smooth template: a frame sits closer to its
    # class's mean than to the other classes' means.
    means = torch.stack([got.x_train[got.y_train == k].mean(0) for k in range(4)])
    d = ((got.x_train[:, None] - means[None]) ** 2).flatten(2).sum(-1)
    assert (d.argmin(1) == got.y_train.long()).float().mean() > 0.9


class TestTokenStream:
    def test_deterministic_by_seed(self):
        cfg = TokenStreamConfig(vocab_size=97, seq_len=32, batch_size=4)
        a = next(synthetic_token_batches(cfg, seed=3))["tokens"]
        b = next(synthetic_token_batches(cfg, seed=3))["tokens"]
        np.testing.assert_array_equal(a, b)

    def test_shapes_and_range(self):
        cfg = TokenStreamConfig(vocab_size=97, seq_len=32, batch_size=4)
        t = next(synthetic_token_batches(cfg, seed=0))["tokens"]
        assert t.shape == (4, 33)
        assert t.min() >= 0 and t.max() < 97

    def test_recurrence_structure(self):
        """With eps=0 the stream is exactly the affine recurrence."""
        cfg = TokenStreamConfig(vocab_size=101, seq_len=16, batch_size=2,
                                noise_eps=0.0)
        t = next(synthetic_token_batches(cfg, seed=0))["tokens"]
        pred = (t[:, :-1] * cfg.mult + cfg.add) % cfg.vocab_size
        np.testing.assert_array_equal(pred, t[:, 1:])

    @pytest.mark.parametrize(
        "eps,v",
        [(0.01, 8), (0.05, 16), (0.1, 64), (0.2, 97), (0.3, 128),
         (0.4, 256), (0.49, 512), (0.25, 11), (0.15, 33), (0.5, 500)],
    )
    def test_property_loss_floor_bounds(self, eps, v):
        cfg = TokenStreamConfig(vocab_size=v, seq_len=8, batch_size=1,
                                noise_eps=eps)
        floor = cfg.loss_floor
        assert 0.0 < floor < np.log(v) + 1e-6
        assert floor == JaxTokenStreamConfig(vocab_size=v, seq_len=8, batch_size=1,
                                             noise_eps=eps).loss_floor


@pytest.mark.parametrize("seed", [0, 5])
def test_token_batches_equal_the_references(seed):
    kw = dict(vocab_size=97, seq_len=24, batch_size=3, noise_eps=0.2)
    got = synthetic_token_batches(TokenStreamConfig(**kw), seed=seed)
    want = jax_token_batches(JaxTokenStreamConfig(**kw), seed=seed)
    for _ in range(3):
        a, b = next(got)["tokens"], next(want)["tokens"]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


class TestShardedLoader:
    def test_prefetch_preserves_order(self):
        def gen():
            for i in range(5):
                yield {"x": np.full((2, 3), i, np.float32)}

        loader = ShardedLoader(gen(), prefetch=3, device="cpu")
        vals = [int(b["x"][0, 0]) for b in loader]
        assert vals == [0, 1, 2, 3, 4]

    def test_device_put(self):
        def gen():
            yield {"x": np.ones((2, 2), np.float32)}

        batch = next(iter(ShardedLoader(gen(), device="cpu")))
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"

    def test_sharded_put_single_device(self):
        mesh = make_mesh((1,), ("data",), device="cpu")

        def gen():
            yield {"x": np.arange(8, dtype=np.float32).reshape(4, 2)}

        batch = next(iter(ShardedLoader(gen(), shardings={"x": mesh}, device="cpu")))
        (shard,) = batch["x"]
        np.testing.assert_array_equal(shard.numpy(), np.arange(8).reshape(4, 2))


def test_sharded_put_splits_over_the_data_axis_and_replicates_over_the_others():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    x = np.arange(16, dtype=np.float32).reshape(4, 4)

    def gen():
        yield {"x": x, "y": np.zeros(3, np.int32)}

    batch = next(iter(ShardedLoader(gen(), shardings={"x": mesh}, device="cpu")))
    shards = [s.numpy() for s in batch["x"]]
    for slot, shard in zip(mesh.slots, shards):
        np.testing.assert_array_equal(shard, x[2 * slot.coords[0]: 2 * slot.coords[0] + 2])
    assert batch["y"].dtype == torch.int32 and tuple(batch["y"].shape) == (3,)
    with pytest.raises(ValueError, match="does not split"):
        next(iter(ShardedLoader(iter([{"x": x[:3]}]), shardings={"x": mesh}, device="cpu")))


def test_loader_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedLoader(iter([]))
