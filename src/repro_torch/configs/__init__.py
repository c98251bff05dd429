"""Architecture configs: the paper's CNNs + the 10 assigned LM-family
architectures, each with its input-shape set."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, get_arch, list_archs

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "list_archs"]
