"""The continuous-learning loop (counterpart of ``bigdl_tpu/loop``):
streaming ingest → online training slices → health-gated, crc-verified
rolling hot-swaps into the live serving fleet, guarded post-swap by an
SLO burn-rate watch with automatic fleet-wide rollback.
"""
from .continuous import DEPLOY_OUTCOMES, ContinuousLoop

__all__ = ["ContinuousLoop", "DEPLOY_OUTCOMES"]
