"""Paper CNN: LeNet5 (Table 1). Selected bit-width: 3."""
from repro_torch.models.cnn import LENET5 as CONFIG  # noqa: F401

SELECTED_BITS = 3
