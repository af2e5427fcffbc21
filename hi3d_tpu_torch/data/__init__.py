"""Training data: stage-1 orbit renders (counterpart of hi3d_tpu/data)."""
