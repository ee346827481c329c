"""Runnable demos of the port (`python -m accl_tpu_torch.examples.<name>`):
KV-cache generation and dense / MoE training with checkpoints."""
