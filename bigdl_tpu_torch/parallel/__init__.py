"""bigdl_tpu_torch.parallel — see the modules."""
