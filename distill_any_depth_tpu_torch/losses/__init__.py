"""The distillation loss stack: counterparts of distill_any_depth_tpu/losses/."""
