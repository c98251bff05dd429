"""VGG-16, configuration D (Simonyan & Zisserman, arXiv:1409.1556,
Table 1). Selected bit-width: 8, the usual int8 deployment width."""
from repro_torch.models.cnn import VGG16 as CONFIG  # noqa: F401

SELECTED_BITS = 8
