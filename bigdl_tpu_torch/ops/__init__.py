"""bigdl_tpu_torch.ops — hand-written Hopper kernels for the hot ops.

K1 flash-attention forward (CUDA C++, ``csrc/flash_fwd.cu``) with its
backward K2 dK/dV and K3 dQ (``csrc/flash_bwd.cu``) in
``ops.flash_attention``, and K4 LayerNorm forward (Triton) in
``ops.layer_norm``; block-sparse attention K6 forward with K7 dK/dV and
K8 dQ, and the block-sparse matmul K9 (CUDA C++, ``csrc/block_sparse.cu``)
in ``ops.block_sparse``; the 3×3 stride-1 conv K5 (CUDA C++,
``csrc/conv3x3.cu``, forward and dX) in ``ops.conv3x3``, beside the k²
GEMM conv of ``ops.conv_gemm``; the fused softmax cross entropy
(``ops.fused_xent``) is plain PyTorch, as its JAX counterpart is jnp.
Each wrapper runs its plain PyTorch version for CPU tensors only; a
CUDA tensor launches the kernel or raises, forward and backward.  The
package re-exports what the JAX package's ``ops`` exports from its
block-sparse module, but not ``flash_attention`` or ``fused_layer_norm``:
``ops.flash_attention`` and ``ops.layer_norm`` stay the modules (with
their launch counters).
"""
from .block_sparse import (BlockMask, block_sparse_attention,
                           block_sparse_matmul, magnitude_block_mask,
                           sliding_window_mask, strided_mask)
