"""Model presets and training configuration: the port's own copy of the
JAX package's configs (distill_any_depth_tpu/configs.py:14-281).

Only the fields the ported paths read are kept; the presets' values and
the defaults are identical, so a preset name or a default config means the
same network and the same training in both packages. The training fields
of features not ported yet (native loader, adapters, the dp/tp mesh, remat,
attention implementation, device preprocessing) are not fields here: the
training CLI refuses their flags.
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
    # Local-window attention (odd window width in patches; None = global).
    window_size: int | None = None
    # The windowed variant (DinoWindowVisionTransformer): no cls token, the
    # PEG conv positional encoding blended with the interpolated pos-embed
    # on a step schedule, and all four taps equal to the final post-norm
    # layer.
    use_cls_token: bool = True
    use_pos_conv: bool = False
    pe_start_step: int = 2000
    pe_total_step: int = 10000
    final_taps: bool = False


def _enc(name, dim, depth, heads, idx, **kw) -> EncoderConfig:
    return EncoderConfig(
        name=name, embed_dim=dim, depth=depth, num_heads=heads, out_indices=idx, **kw
    )


ENCODERS: dict[str, EncoderConfig] = {
    "vits": _enc("vits", 384, 12, 6, (2, 5, 8, 11)),
    "vitb": _enc("vitb", 768, 12, 12, (2, 5, 8, 11)),
    "vitl": _enc("vitl", 1024, 24, 16, (4, 11, 17, 23)),
    # the windowed high-resolution ViT-B: window 7, PEG, no cls token, a
    # 224-based pos-embed grid, four identical final-layer taps
    "vitb_window": _enc(
        "vitb_window", 768, 12, 12, (2, 5, 8, 11),
        window_size=7, use_pos_conv=True, use_cls_token=False,
        base_img_size=224, init_values=1e-5, final_taps=True,
    ),
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
    # the windowed ViT-B teacher
    "depthanything-base-window": ModelConfig(
        "depthanything-base-window",
        ENCODERS["vitb_window"],
        128,
        (96, 192, 384, 768),
        trailing_head_relu=False,
        interp_to_input=True,
    ),
}


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Distillation loss stack weights and options."""

    normalization: str = "hybrid"  # global | hybrid | local | none
    num_segments: int = 4
    lambda_sc: float = 0.5
    lambda_lg: float = 0.5
    lambda_feat: float = 1.0
    lambda_grad: float = 0.2
    use_hdn: bool = True
    hdn_variant: str = "dr"  # dr | dp | ds
    hdn_level: int = 3
    lambda_hdn: float = 0.8


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam with L2 decay, global-norm clipping, warmup then cosine/step decay."""

    lr: float = 1e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 0
    schedule: str = "cosine"  # cosine | step | none
    total_steps: int = 10_000
    step_size: int = 10_000
    gamma: float = 0.1
    eta_min_ratio: float = 0.01
    max_grad_norm: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    student: ModelConfig = MODELS["depthanything-base"]
    teachers: tuple[str, ...] = ("depthanything-large",)
    # safetensors weights of teacher i (reference layout); a teacher without
    # one keeps its seeded random init
    teacher_checkpoints: tuple[str, ...] = ()
    loss: LossConfig = LossConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    batch_size: int = 16
    image_size: int = 392
    num_epochs: int = 50
    num_iterations: int = 0
    seed: int = 42
    val_split: float = 0.1
    log_interval: int = 100
    # student weights and the train state every this many steps (0 = never)
    checkpoint_interval: int = 1000
    early_stopping: int = 0
    output_dir: str = "output"
    dataset_dir: str = "data/nyu"
    teacher_dtype: str = "bfloat16"
    # "int8" / "int8_pallas": the teachers' encoder GEMMs run as dynamic W8A8
    # int8 (ops/quant; kernel 9 for "int8_pallas"). Teachers are
    # inference-only inside the step; students always train unquantized.
    teacher_quant: str = "none"
    # run the teacher forward as sequential chunks of this batch size (0 = off)
    teacher_chunk: int = 8
    # bf16 student compute; parameters and optimizer state stay fp32
    student_compute_dtype: str = "bfloat16"


def model_config(arch_name: str) -> ModelConfig:
    if arch_name not in MODELS:
        raise KeyError(f"unknown arch {arch_name!r}; have {sorted(MODELS)}")
    return MODELS[arch_name]
