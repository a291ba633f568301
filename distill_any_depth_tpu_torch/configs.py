"""Model presets: the port's own copy of the JAX package's encoder and
model configurations (distill_any_depth_tpu/configs.py:14-176).

Only the fields the ported inference path reads are kept; the presets'
values are identical, so a preset name means the same network in both
packages.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """DINOv2-style ViT encoder hyper-parameters."""

    name: str
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    base_img_size: int = 518
    mlp_ratio: float = 4.0
    init_values: float | None = 1.0  # LayerScale init; None disables
    interpolate_offset: float = 0.1
    out_indices: tuple[int, int, int, int] = (2, 5, 8, 11)


def _enc(name, dim, depth, heads, idx, **kw) -> EncoderConfig:
    return EncoderConfig(
        name=name, embed_dim=dim, depth=depth, num_heads=heads, out_indices=idx, **kw
    )


ENCODERS: dict[str, EncoderConfig] = {
    "vits": _enc("vits", 384, 12, 6, (2, 5, 8, 11)),
    "vitb": _enc("vitb", 768, 12, 12, (2, 5, 8, 11)),
    "vitl": _enc("vitl", 1024, 24, 16, (4, 11, 17, 23)),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Encoder + DPT head.

    ``trailing_head_relu`` distinguishes the student head (ReLU inside the
    output conv stack) from the teacher head (no trailing ReLU; the ReLU is
    applied after the optional resize to the input resolution).
    """

    arch_name: str
    encoder: EncoderConfig
    features: int
    out_channels: tuple[int, int, int, int]
    head_out_channels: int = 1
    use_clstoken: bool = False
    trailing_head_relu: bool = True
    interp_to_input: bool = False
    # channels 0-1 pass through signed, channels 2+ are ReLU'd
    wo_relu_1_2_channel: bool = False


MODELS: dict[str, ModelConfig] = {
    "depthanything-small": ModelConfig(
        "depthanything-small", ENCODERS["vits"], 64, (48, 96, 192, 384)
    ),
    "depthanything-base": ModelConfig(
        "depthanything-base", ENCODERS["vitb"], 128, (96, 192, 384, 768)
    ),
    "depthanything-large": ModelConfig(
        "depthanything-large",
        dataclasses.replace(ENCODERS["vitl"], init_values=1e-5),
        256,
        (256, 512, 1024, 1024),
        trailing_head_relu=False,
        interp_to_input=True,
    ),
}


def model_config(arch_name: str) -> ModelConfig:
    if arch_name not in MODELS:
        raise KeyError(f"unknown arch {arch_name!r}; have {sorted(MODELS)}")
    return MODELS[arch_name]
