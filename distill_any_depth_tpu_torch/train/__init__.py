"""Distillation training: optimizer state, the train step and the loop."""
