"""Paper CNN: Cifar10 (Table 1). Selected bit-width: 6."""
from repro_torch.models.cnn import CIFAR10 as CONFIG  # noqa: F401

SELECTED_BITS = 6
