"""Non-paper CNN: stride-2 downsampling variant of the Cifar10 topology —
the first two layers downsample with conv stride 2 instead of pooling
(32 -> 16 -> 8), the last keeps a 2x2/2 pool. Exercises the generalized
conv-stride lowering path. Selected bit-width: 6."""
from repro_torch.models.cnn import CIFAR10_STRIDED as CONFIG  # noqa: F401

SELECTED_BITS = 6
