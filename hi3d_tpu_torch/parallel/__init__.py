"""Multi-GPU training (counterpart of hi3d_tpu/parallel): the process group
under torchrun (`dist`) and the ZeRO-2-sharded AdamW (`zero`)."""
