"""Configs: the 10 assigned architectures, the paper's Table III zoo and the
dry-run's shape cells."""
from repro_torch.configs.archs import ARCHS, ARCH_IDS, get_config, reduced
from repro_torch.configs.mdinference_zoo import TABLE_III, ablation_zoo, paper_zoo
from repro_torch.configs.shapes import SHAPES, applicable, input_specs, skip_reason

__all__ = [
    "ARCHS", "ARCH_IDS", "get_config", "reduced",
    "TABLE_III", "ablation_zoo", "paper_zoo",
    "SHAPES", "applicable", "input_specs", "skip_reason",
]
