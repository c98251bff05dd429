"""Paper CNN: SVHN (Table 1). Selected bit-width: 6."""
from repro_torch.models.cnn import SVHN as CONFIG  # noqa: F401

SELECTED_BITS = 6
