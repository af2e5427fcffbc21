"""Single-GPU training (counterpart of hi3d_tpu/training): trainable-parameter
selection and AdamW, LR-multiplier schedules, EMA, the train step with
gradient accumulation, and the Trainer (metrics, checkpoints, resume)."""
