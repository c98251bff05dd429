"""Non-paper CNN: Caffe's cifar10_full — 5x5 SAME convs with OVERLAPPING
3x3/stride-2 max-pool (32 -> 15 -> 7 -> 3). Exercises the generalized
pool-window != pool-stride lowering path. Selected bit-width: 6 (as
Cifar10, same parameter statistics regime)."""
from repro_torch.models.cnn import CIFAR10_FULL as CONFIG  # noqa: F401

SELECTED_BITS = 6
