"""bigdl_tpu_torch.resilience — see the modules."""
