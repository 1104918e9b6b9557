"""The paper's model zoo (Table III) + the on-device hedge-tier recipe.

Top-1 accuracy on ILSVRC-2012 and execution-latency statistics measured on
an AWS p2.xlarge GPU server over 1 000 runs (values transcribed from the
paper).  ``NasNet Fictional`` is the paper's synthetic low-accuracy copy of
NasNet Large, used *only* in the §VI-C stage ablation.

:data:`ONDEVICE_HEDGE` is the zoo's *executable* entry: the recipe for the
real tiny variant that plays the paper's on-device duplicate
(MobileNetV1_128 0.25, §V-B) in the serving stack.
``repro_torch.serving.backend.OnDeviceBackend`` registers it so hedged requests
run on a second tier for real instead of sampling a latency profile.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.registry import ModelProfile, ModelRegistry

__all__ = [
    "TABLE_III",
    "NASNET_FICTIONAL",
    "HedgeVariantSpec",
    "ONDEVICE_HEDGE",
    "ServingGeometry",
    "SERVING_GEOMETRY",
    "paper_zoo",
    "ablation_zoo",
]

TABLE_III: tuple[ModelProfile, ...] = (
    ModelProfile("SqueezeNet", 49.0, 4.91, 0.06),
    ModelProfile("MobileNetV1 0.25", 49.7, 3.21, 0.08),
    ModelProfile("MobileNetV1 0.5", 63.2, 4.21, 0.06),
    ModelProfile("DenseNet", 64.2, 25.49, 0.14),
    ModelProfile("MobileNetV1 0.75", 68.3, 4.67, 0.07),
    ModelProfile("MobileNetV1 1.0", 71.0, 5.43, 0.11),
    ModelProfile("NasNet Mobile", 73.9, 21.18, 0.17),
    ModelProfile("InceptionResNetV2", 77.5, 50.85, 0.33),
    ModelProfile("InceptionV3", 77.9, 31.11, 0.19),
    ModelProfile("InceptionV4", 80.1, 59.21, 0.22),
    ModelProfile("NasNet Large", 82.6, 112.61, 0.36),
)

NASNET_FICTIONAL = ModelProfile("NasNet Fictional", 50.0, 112.61, 0.36)


def paper_zoo() -> ModelRegistry:
    """The default cloud-side zoo (Table III without the fictional model)."""
    return ModelRegistry(TABLE_III)


def ablation_zoo() -> ModelRegistry:
    """Zoo for the §VI-C decomposition study (adds NasNet Fictional)."""
    return ModelRegistry(TABLE_III + (NASNET_FICTIONAL,))


@dataclasses.dataclass(frozen=True)
class HedgeVariantSpec:
    """Recipe for the real on-device hedge tier.

    The serving analogue of the paper's duplicate model: "most likely to
    complete within any SLA", so the smallest config we can build.  The
    quality score matches the paper's MobileNetV1_128 0.25 top-1 (41.4 %).
    """

    name: str = "hedge-xs (on-device)"
    arch: str = "gemma-2b"
    d_model: int = 32
    n_layers: int = 1
    n_heads: int = 2
    n_kv_heads: int = 1
    head_dim: int = 16
    quality: float = 41.4

    def config(self):
        """Materialize the tiny same-family :class:`ModelConfig`."""
        from repro_torch.configs.archs import reduced

        return reduced(
            self.arch,
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
        )


ONDEVICE_HEDGE = HedgeVariantSpec()


@dataclasses.dataclass(frozen=True)
class ServingGeometry:
    """Single source of truth for the serving tiers' cache geometry.

    Every shape the execution tiers compile against derives from here, so
    the batch-size ladder, the paged-cache page pool, and the dense ring
    caches cannot drift apart:

    * ``max_len`` — the dense tiers' (:class:`repro_torch.serving.backend.JitBackend`
      / :class:`~repro_torch.serving.backend.OnDeviceBackend`) ring-cache length;
      the historical hardcoded 256.
    * ``prompt_width`` — the continuous tier's *fixed* prefill width.  All
      prompts are right-padded to exactly this many tokens, so one prefill
      executable per ladder batch size covers every request shape.
    * ``bs_ladder`` — the power-of-two prefill batch sizes that get a
      pre-compiled ``prefill_bs{N}`` entry point each.
    * ``n_slots`` — width of the persistent decode batch (the single
      fixed-shape ``decode`` executable).
    * ``page_size`` / ``n_pages`` — the block-paged KV cache: page 0 is the
      reserved trash page inactive rows write into; ``None`` sizes the pool
      so every slot can hold a full request
      (``1 + n_slots * ceil((prompt_width + max_steps) / page_size)``).
    * ``max_steps`` — per-request decode-step cap on the continuous tier.
    """

    max_len: int = 256
    prompt_width: int = 32
    bs_ladder: tuple[int, ...] = (1, 2, 4, 8)
    n_slots: int = 8
    page_size: int = 8
    n_pages: int | None = None
    max_steps: int = 32

    def __post_init__(self):
        if any(n & (n - 1) for n in self.bs_ladder) or not self.bs_ladder:
            raise ValueError(f"bs_ladder must be powers of two: {self.bs_ladder}")
        if tuple(sorted(self.bs_ladder)) != tuple(self.bs_ladder):
            raise ValueError(f"bs_ladder must be sorted: {self.bs_ladder}")
        if self.prompt_width % self.page_size:
            raise ValueError(
                f"prompt_width ({self.prompt_width}) must be a multiple of "
                f"page_size ({self.page_size})"
            )

    @property
    def pages_per_slot(self) -> int:
        """Worst-case pages one slot can reserve (full prompt + max steps)."""
        need = self.prompt_width + self.max_steps
        return -(-need // self.page_size)

    @property
    def total_pages(self) -> int:
        """Physical page-pool size: the trash page + every slot full."""
        if self.n_pages is not None:
            return self.n_pages
        return 1 + self.n_slots * self.pages_per_slot


SERVING_GEOMETRY = ServingGeometry()
