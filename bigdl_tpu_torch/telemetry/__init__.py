"""bigdl_tpu_torch.telemetry — see the modules."""
