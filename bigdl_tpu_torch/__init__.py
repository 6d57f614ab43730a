"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

The JAX package stays the reference; this package mirrors its
subpackage and module names, so each module here has one counterpart
there.  Plain tensor code is PyTorch; every Pallas kernel on a ported
path is a kernel written by hand for Hopper (``ops/``), with a plain
PyTorch version beside it that runs only for CPU tensors.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`.device`).  This package never imports
jax or ``bigdl_tpu``.
"""

__version__ = "0.1.0"
