#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. probe — a CUDA device is required; print the card's
   ``nvidia-smi`` name and power limit; TF32 off for matmul and cuDNN.
2. build — compile the kernels from this checkout's sources: the four
   CUDA libraries (``flash_fwd.cu``: K1; ``flash_bwd.cu``: K2 and K3;
   ``block_sparse.cu``: K6-K9; ``conv3x3.cu``: K5) with one ``nvcc``
   each, started together, into ``.torch_kernels/``; Triton compiles K4
   at first launch.  Print the build seconds, and for each instantiation
   of K1, K2, K3, K6-K8, K5's bf16 and f32 kernels (one per KC input
   channels a step and BN output channels a block) and K9 in bf16 and
   in f32 (split products; one per KC, BN and W orientation)
   its registers, spills and dynamic
   shared memory (ptxas) and its wgmma (HGMMA) and TMA (UTMALDG)
   instructions (``cuobjdump -sass``, where the toolkit has it); each
   bf16 attention kernel at D 128, 192 and 256, the f32 K1-K3 and K6-K8
   (bf16 products on bf16 pieces of each f32 operand) at D 16-256, the
   chunked K1, K2, K3 and K6-K8 above 256 in both dtypes (one
   instantiation each for every head dim), the
   bf16 K5 at KC 64, every f32 K5 (split products too) and every K9
   instantiation must not spill and must hold both (and the attention
   kernels, the f32 K5 and every K9 must not have their wgmma
   serialised, ptxas C7520 or C7514), two bf16
   K5 or K9 blocks must share an SM (an f32 K5 or K9 block is alone on
   its SM), and no library may still hold the f32 dQ's or the f32 K5's
   retired FMA loops, the retired wide route's forward, dK/dV or dQ
   in either dtype, or K9's retired tile loop.
3. kernel parity — each kernel against its plain PyTorch version on the
   card at the shapes the served, the training, the block-sparse
   training, the matmul and the ResNet-50 paths give it, with the stated
   tolerance (the f32 dK/dV and dQ on split products, at every head dim,
   against the plain version's math carried in f64); the block-sparse
   kernels also at
   block 32, 8 (ragged
   T 200), 96, 16 (phase 9's page-window mask, 32 x 32 pages), in f32, non-causal with a dead q block, strided, with NaN
   in the K/V rows no query may attend (bf16 and f32 D 128, 256 and
   320), and on all-ones masks against
   K1-K3 (K6-K8 = K1-K3 bit for bit on the same inputs in both dtypes,
   in f32 at D 128 and 256, in both at D 320);
   the attention kernels on the head-strided layout of an attention
   layer at the training shapes and in f32 (no copy; bit for bit the
   contiguous launch) and K4 on a column slice; bf16 head dims 192 and 256 (the
   Hopper bodies in all three passes, dK/dV and dQ on 64-row blocks; NaN
   in dead K/V at 256 too), f32 head dims 192 and 256 (the Hopper
   bodies' split products in all three passes, 32-row streamed tiles),
   and in both dtypes head dims above 256 (the chunked forward, dK/dV and
   dQ at 300, 320, 384 and 512, also head-strided at 320 with no operand
   copy); K5 forward and dX
   at ResNet-50's
   four stage shapes (B 64) in bf16 and in f32, ResNet-CIFAR's first
   width (B 128, 32 x 32, C = O = 16) and ragged C 3, O 10, H 7, W 5
   (its bf16 rows of 10 and 3 channels against the plain f32 sum),
   with K5's pixel box, its dead rows and the bytes its TMA boxes
   request, and the wrapper's whole call (in f32 with its weight split);
   K9 forward and dX with the route each took (the block route at
   blocks that are multiples of 64, W read in place, in f32 on split
   products; the coarse route at blocks 8, 16 and 32 in both dtypes,
   over a masked copy of W, which is held bit for bit against its plain
   version, with NaN in every dead block, and timed on its own beside the
   call that includes it), blocks 16 and 32 also on the block route, the
   bytes the TMA boxes request (in f32 on the block route also the split
   of W into its pieces, which the call's time includes); kernel, plain
   and library times
   (SDPA's backward by CUDA graph replay, with the backend that ran);
   the bound.
4. serving path — the flagship TransformerLM (V 32000, D 1024, 8 heads,
   8 layers, max_len 1024; random weights from a seeded generator)
   served in bf16 by the port's ``InferenceServer``: a batch of four
   512-token prompts, then four 200-token prompts, 32 new tokens each.
   Every status OK, every id in 1..V, the launch counts per batch
   exactly 8 flash (one per layer in the prefill) and (2*8+1)*32 = 544
   LayerNorm; the last-prompt-position logits of one prompt held
   against the same model run in f32 on the CPU.
5. training path — the same flagship trained by the port's
   ``LocalOptimizer``: ``TimeDistributedCriterion(CrossEntropyCriterion(),
   True)``, SGD at lr 0.01, bf16 compute over f32 master weights, 8
   iterations over one batch of 16 int32 sequences of 1024 ids.  Every
   loss finite, no step skipped, the last loss below the first,
   launches per step exactly K1 8, K2 8, K3 8, K4 17 and no operand
   copy (the layer's q, k, v are read in place); the same 8 steps
   in f32 on the card give the same first loss and the same decreases
   L_k - L_1; a 2-layer copy at full width trained 3 steps in f32 on the
   card and on the CPU gives the same losses, decreases and parameter
   updates.  Step ms, tokens/s, MFU and peak memory; the f32 run's step
   ms, tokens/s and launches per step, with no operand copy either.
6. block-sparse training path — the flagship with max_len 4096 and
   ``seq_strategy="blocksparse"`` (sliding window 2 + 1 global at block
   512), trained as in phase 5 over one batch of 4 sequences of 4096
   ids: the same checks, launches per step exactly K6 8, K7 8, K8 8,
   K4 17 and K1-K3 0; a 2-layer copy (T 512, block 64) card vs CPU;
   the flash flagship at T 4096 against an all-ones block-sparse mask,
   3 steps each, losses within BS_FIRST_REL_TOL.  Step ms, tokens/s (also for flash at
   T 4096, and for the f32 run with its launches per step, no operand
   copy), MFU on
   executed and flash-equivalent work, peak memory.
7. the block-sparse matmul's entry point — ``block_sparse_matmul`` at
   the flagship MLP shape in bf16 and in f32 under autograd, 3
   forward+backward passes each, at the MLP's block 128 and at block 8:
   2 launches of K9 per pass, at block 128 all on its block route (dX
   reads W in place; in f32 all 6 on split products, none on the coarse
   route), at block 8 all on its coarse route after one masked copy of W
   each; dW zero on every dead tile, the forward and dX as phase 3 holds
   them.
8. ResNet-50 training path — ``bench.py``'s ``conv_impl="pallas"`` leg on
   the port: ``ResNet50(1000)`` with the conv7 stem (random weights from
   a seeded generator), every ``SpatialConvolution`` on ``"pallas"`` (the
   13 3x3 stride-1 convs run K5), ``ClassNLLCriterion``, SGD at lr 0.01,
   bf16 compute over f32 masters, 8 iterations of ``LocalOptimizer`` over
   one batch of 64 random 224x224 images.  Every loss finite, no step
   skipped, the last loss below the first, launches per step exactly K5
   26 (13 forward, 13 dX) and no other kernel; the same 8 steps in f32 on
   the card give the same first loss and decreases, with K5 26 a step on
   its split-product route, timed beside the ``"xla"`` impl's f32 steps
   (cuDNN, TF32 off); ``"pallas"`` against
   ``"xla"`` (cuDNN) in f32 at B 8, 3 steps: losses, decreases and every
   parameter update; the card against the CPU in f32 at B 2, 3 steps:
   the same plus BatchNorm's running statistics, then one eval-mode
   forward.  Step ms, images/s, MFU, peak memory, and the ``"xla"``
   impl's bf16 images/s beside them.
9. paged serving path — phase 4's model and four 512-token prompts in
   bf16, 32 new tokens, through ``KVPagePool`` (page size 16, a bf16
   arena of 160 pages): (a) ``InferenceServer(kv_pool=...)``, each stream
   equal to ``cached_generate``'s (B 1) token for token, launches K1 8
   and K4 17 x 32 per request and nothing else; (b) with the page window
   8 + 1 global: K6 8 per request at block 16 and no K1, the first
   token's logits against the same windowed paged prefill in f32 on the
   CPU, a 96-token prompt's stream equal to (a)'s; (c) a prefill server
   and a decode server, each with its own pool, across the crc-sealed
   handoff: first token + the rest equal (a)'s, a flipped byte resolves
   INTERNAL_ERROR, the blob's bytes and its seal and verify seconds;
   (d) a 40-page pool: one of two 512-token requests OK, the other
   OVERLOADED, then OK again; (e) beam search, bf16 B 2 x 4 beams, 1
   beam = greedy, and in f32 (128-token prompt, 16 new) the score
   against the f32 forward's rescoring of the returned ids; (f) the
   int8 KV cache, B 4: first tokens equal bf16's, launches K1 8 and K4
   17 x 32.  Every pool free at the end; prefill + first token ms,
   decode tokens/s and latency for each leg.
10. train, validate, checkpoint, resume, swap — (a) phase 5's flagship
   and batch, bf16, 8 iterations, with ``set_validation`` every 4 over 8
   held-out sequences in batches of 4 (``Loss`` of the training
   criterion), ``set_checkpoint`` every 4 (async writer), train and
   validation summaries: model/optimMethod/trainState at 4 and 8, each
   with a sidecar that verifies; the native crc32c = the pure-Python
   table on the first 16 MB of ``model.8``; the validation loss finite
   and equal (1e-6 relative) to ``evaluate_dataset`` by hand on each
   step's restored params; "Loss" read back at every iteration;
   launches a step K1 8, K2 8, K3 8, K4 17 (a validation step adds K1 8
   and K4 17 per held-out batch); (b) the same 8 steps once more, then a
   model from another seed resumed from step 4 and trained to 8: bit for
   bit the uninterrupted run's params when two uninterrupted runs agree
   bit for bit, else within phase 5's first-loss and decrease limits,
   printing the first parameter that differs; (c) the XOR classifier
   of ``tests/test_resilience.py:201`` on the card with two batches
   scaled 100x under ``set_loss_spike_guard(k=2)``: at least one
   rollback, every loss finite; (d) a bf16 server on the flagship (seed
   0) serving two of phase 4's 512-token prompts, 16 new tokens (K1 8,
   K4 272 a batch): ``swap_params(path=model.8)`` gives the streams of a
   fresh server on the restored model, a bit-flipped copy is refused
   (``SwapRejected``, quarantined, streams unchanged), ``poison_params``
   is refused.  Leg bytes, serialize, blocked and background write
   seconds, verify, resume, validation and swap seconds, crc GB/s.
11. the Torch-style API — (a) the flagship in f32, 4 steps written with
   the verbs (``zero_grad_parameters``, ``forward``, the criterion's
   ``forward`` and ``backward``, ``backward``, ``update_parameters``)
   against ``LocalOptimizer``'s 4 steps from the same weights and
   batches: losses within 1e-6, every update row within 1e-2, whether
   bit for bit; launches a step K1 8, K2 8, K3 8, K4 17 (one forward a
   step); both step ms; (b) phase 5's bf16 cell with residual dropout
   0.1, 8 steps: every loss finite, the last below the first, launches
   as phase 5, the eval forward = a dropout-0 model's bit for bit, one
   generator seed twice the same bits and two seeds different ones, the
   keep share of a 16 x 1024 x 1024 mask within 5 sigma of 0.9; the step
   ms beside phase 5's; one step traced with dropout and one without;
   (c) ``Sequential(Transpose([(2, 3)]),
   LayerNorm(1024))`` on [16, 1024, 1024] and a ``Narrow`` column slice
   into flash attention, bf16 and f32: K4 (its strided instantiation)
   and K1-K3 read the view with no copy, the output bit for bit the
   contiguous input's, the strided K4 within phase 3's K4 limit of the
   plain version; its ms beside the copy route's (a copy, then the
   row-pitched K4), the copy's, its bound, the plain version and
   ``F.layer_norm`` on the view; (d) every layer and criterion class
   ported with the API, and the Tensor facade's ops, forward and
   backward in f32 on the card against the CPU (each within 1e-5 of its
   largest value, every tensor on the card), the random layers also
   trained on the card.
12. training breadth — (a) phase 5's cell built with ``remat=True``
   beside the same weights without, in one call: every loss finite, no
   step skipped, the last below the first, launches a step K1 16 (the
   forward and each block's recompute), K2 8, K3 8, K4 33 and no
   operand copy, the first loss = the plain run's bit for bit, the
   decreases within 5e-2 and each update p_8 - p_0 within 1e-2 row by
   row (bit for bit reported); both runs' step ms and peak memory; an
   eval forward under ``no_grad`` launches K1 8 and K4 17; (b) with
   dropout 0.1, 2 steps with and without remat from the same step
   seeds: the losses equal bit for bit, the updates within 1e-2 row by
   row (bit for bit reported); (c) ``seq_strategy="block"`` at block
   512, bf16, 8 steps from phase 5's weights and batch: K1-K3 0, K4 17
   a step, the first loss within 4e-5 of (a)'s flash run and the
   decreases within 5e-2; step ms and peak memory; its 2-layer copy at
   block 64 (T 256, B 2, 3 steps, f32) card vs CPU at phase 5's limits;
   (d) the 2-layer copy in f32, 3 steps, card vs CPU at phase 5's limits
   under Adagrad, Adadelta, Adamax, RMSprop,
   ``TorchOptimMethod(torch.optim.Adam)`` and SGD with momentum 0.9, a
   ``Step`` schedule, ``L1L2Regularizer(1e-4, 1e-4)`` on the embedding
   and the head and ``set_scale_w(0.5)`` on the head, each step's
   learning rate its schedule's; (e) ``LBFGS`` with the line search on
   the 4-dimensional Rosenbrock function in f32 on the card below
   1e-2, its first 5 evaluation points within 1e-5 of the CPU's.  The
   phase's seconds.
13. the image and sequence zoo — (a) the perf harness's default
   workload (``bigdl_tpu/models/perf.py``): ``Inception_v1(1000)``
   (random weights from a seeded generator) at B 32, 224 x 224, every
   ``SpatialConvolution`` on ``"pallas"``, ``ClassNLLCriterion``, SGD
   0.01, 8 ``LocalOptimizer`` steps in bf16 over f32 masters, then 8 in
   f32: every loss finite, no step skipped, the last below the first, K5
   exactly 20 a step (10 forward, 10 dX) and no other kernel; the f32
   first loss against bf16's, and the decrease the 8 steps made read as
   the f32 eval loss of each run's trained weights (bf16's LogSoftMax
   rounds each sample's logged loss to 2^-5, coarser than the decreases
   at SGD 0.01); ``"pallas"`` against ``"xla"`` (cuDNN, TF32 off) at B 8
   and the card against the CPU at B 2, 3 f32 steps each with dropout 0,
   at phase 8's limits, every update row by row (where a 1e-7 input
   perturbation of the reference alone moves an update past half the
   limit, the model's conditioning at random init, that update is held
   to twice the perturbation's reading); step ms, images/s, peak memory,
   the FLOP a step per image from the layer shapes, MFU, and one bf16
   step under ``torch.profiler`` by the op that launched each kernel; (b)
   ``Inception_v2`` and ``Vgg16`` at B 32 in bf16, 3 steps each: losses
   finite, K5 exactly 54 and 25 a step (VGG-16's 3-channel input padded
   to 16: one copy a step), step ms, images/s, one step profiled; each
   card vs CPU in f32 at B 2 at phase 8's limits (Inception v2 one step
   in training mode for its BatchNorm statistics, then 2 with BatchNorm
   frozen; VGG-16 2 steps, with the perturbation rule of (a)); (c)
   ``SimpleRNN`` at ``bench.py``'s leg (V 4001, H 40, T 25,
   B 12, one-hot input, ``TimeDistributedCriterion(ClassNLLCriterion(),
   True)``, f32): 8 steps on the card, the last loss below the first,
   records/s, and 3 steps card vs CPU; ``LSTMClassifier`` at
   ``models/train.py``'s config (vocabulary 2002, embed 64, hidden 64, 20
   classes, T 64, B 32) with LSTM and with GRU cells, 3 f32 steps card vs
   CPU; at phase 5's f32 limits (the decreases plus 2 f32 ulps of the
   first loss, as phase 12 (d)'s regularized run); (d) every other class
   of the slice (the
   conv and pooling tail, the recurrent cells and containers, the
   Tree-LSTM, the TF ops, a graph, ``Autoencoder``, ``VggForCifar10``;
   ``utils/api_cases.zoo_tail_cases``) forward and backward in f32 on the
   card against the CPU, each within 1e-5 of its largest value with
   every tensor on the card, and ``lenet_graph`` = ``LeNet5`` bit for
   bit on the card (cuDNN's deterministic algorithms); (e) K5 at every
   distinct shape (a) and (b) handed it, forward and dX, bf16 and f32,
   row by row at phase 3's limits (bf16 rows shorter than 16 against
   the plain version's f32 sum, ``api_cases.conv3x3_yardstick``),
   timed beside its bound, the plain version and ``F.conv2d`` /
   ``conv2d_input``, and K5's kernel time in one step of each model.
   The phase's seconds.
14. Switch-MoE — ``bench.py``'s MoE leg (``bench.py:711-731``: V 32000,
   D 512, 4 heads of 128, 4 layers, mlp 2048, 8 experts, capacity 1.25,
   aux 0.01; random weights from ``manual_seed(0)``): (a) 8
   ``LocalOptimizer`` steps at T 1024, B 16, SGD 0.01, ``"flash"``,
   bf16 over f32 masters, then the same in f32: every loss finite, no
   step skipped, the last below the first, launches a step exactly K1 4,
   K2 4, K3 4, K4 9 and no operand copy, each step's loss minus its
   criterion loss = 0.01 x the aux buffers' sum (1e-6 of the loss), the
   bf16 first loss and decreases at phase 5's limits against the f32 run
   routed as the bf16 run routed (each step's top-1 choices replayed: a
   near tie that bf16's rounding resolves the other way moves a token to
   another expert, an O(1) change, not a rounding), the freely routed f32
   run reported beside it with the share of first choices it routes
   elsewhere; step
   ms, tokens/s, peak memory, the active parameters (``bench.py:295-300``)
   and the active MFU, each layer's dropped share at steps 1 and 8, and
   one more step traced by ``torch.profiler``, grouped into K1-K4, the
   experts' bmm, the dispatch's scatter, the combine's gather, routing
   and the rest; (b) a 2-layer copy at full width, f32, 3 steps card vs
   CPU at phase 5's limits, capacity loose (f 8.0), binding (f 0.5) and
   top-2; (c) served in bf16 by ``InferenceServer`` as phase 4 (B 4,
   512- then 200-token prompts, 32 new tokens; K1 4 and K4 288 a batch):
   every status OK, ids in 1..V, last-position logits against f32 on the
   CPU, the paged stream (page 16) = ``cached_generate``'s at B 1, one
   beam = greedy, ``capacity_bind_report`` on the served sequences,
   prefill + first token ms and decode tokens/s; (d) one layer's index
   dispatch against the one-hot einsum form of the JAX layer at the
   step's shape (16384 tokens, C 2560), f32, top-1 bit for bit and top-2
   within 1e-6 of the largest output, both timed; then K1-K4 at the MoE
   step's shapes as phase 3 holds them.
15. a ``{"kernels": [...]}`` line (K1-K4 with a ``moe step`` variant
   each: its time at the MoE step's shape, its launches (a)'s bf16 run's),
   the ``nvidia-smi`` line, and as the last line ``{"ok": true,
   "device": {...}}``.

The full record goes to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --phase12

runs phase 1, builds K1-K4 and runs phase 12 alone (record in
``chiprun_out/chip_phase12.json``; exit 1 on a failed check).

    python3 chip_smoke.py --phase13

runs phase 1, builds K5 and runs phase 13 alone (record in
``chiprun_out/chip_phase13.json``; exit 1 on a failed check).

    python3 chip_smoke.py --phase-moe

runs phase 1, builds K1-K4 and runs phase 14 alone (record in
``chiprun_out/chip_phase_moe.json``; exit 1 on a failed check).

    python3 chip_smoke.py --profile

runs phases 1-2, then profiles the served generator of phase 4, one
training step of phase 5, one block-sparse training step of phase 6,
one flash training step at the same T 4096, B 4, and one bf16 ResNet-50
step of phase 8 with ``torch.profiler`` (device time by kernel, and for
ResNet-50 by the op that launched it: K5 forward, K5 dX, the dW
matmuls and pads, cuDNN, the NCHW/NHWC layout copies; launches, the
device's busy share) into ``chiprun_out/chip_profile.json``.
"""
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM data-sheet peaks (dense) and memory rate.  "float32" is the
# rate of the FMA loops; "float32_split" the f32 rate of the f32 K2 and K7,
# which form their four f32 products from 22 bf16 products on the tensor
# cores (six for each score product, five for dV and dK);
# "float32_split_fwd" that of the f32 K1 and K6: 12 bf16 products for
# their two (six for S, six for P.V); "float32_split_dq" that of the f32
# K3 and K8: 18 for their three (six each for S, dP and dQ);
# "float32_split_conv" that of the f32 K5 and "float32_split_mm" that of
# the f32 K9 (either route): six for their one
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              "float32_split": 989e12 * 4 / 22,
              "float32_split_fwd": 989e12 * 2 / 12,
              "float32_split_dq": 989e12 * 3 / 18,
              "float32_split_conv": 989e12 / 6,
              "float32_split_mm": 989e12 / 6}
MEM_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(vocab=32000, embed_dim=1024, num_heads=8, num_layers=8,
                max_len=1024)
BATCH, MAX_NEW, PROMPT_LENS = 4, 32, (512, 200)
# phase 9: paged serving (the JAX package's page size, kvpool.py:161); a
# bf16 arena of 160 pages (42 MB) holds the four 512-token requests and
# their growth, 40 pages only one; the page window 8 + 1 global binds at
# 512 tokens (32 pages); beam search in f32 on a 128-token prompt; its
# score against the f32 forward's rescoring of the returned ids
PAGE_SIZE, PAGED_POOL_PAGES, EXHAUST_PAGES, PAGE_WINDOW = 16, 160, 40, 8
BEAMS, BEAM_F32_PROMPT, BEAM_F32_NEW, BEAM_SCORE_REL_TOL = 4, 128, 16, 1e-3

# tolerances, kernel vs its plain version on the same inputs.
# K1-K3 are held row by row (row_rel_err): under causal masking the
# rows' scales spread over three orders of magnitude (row i of O and dQ
# averages i + 1 keys; the last key rows of dK and dV see few queries),
# so a limit set against the largest value of a tensor would not see a
# wrong last tile.  bf16: P (and dS) round to bf16 after the running max
# (kernel) or the final max (plain), a 2^-9 relative difference per
# weight, and each output rounds to bf16, where the two f32 results may
# land on neighbouring values (1 ulp is 2^-8 to 2^-7 of the value).
# The limits sit just above the readings at the shapes of phase 3
# (PERF.md).  f32: summation order only.  K4 bf16 (absolute): the f32
# results agree to ~1e-6 and may round to neighbouring bf16 values,
# 1 ulp = 2^-5 for |y| in [4, 8); its rows all have one scale.
ROW_TOL = {"bfloat16": 7e-3, "float32": 1e-4}
TOL = {("layer_norm_fwd", "bfloat16"): 4e-2,
       ("layer_norm_fwd", "float32"): 1e-4}
LSE_TOL = 1e-3
# a row whose norm is below this share of the largest row's (keys that no
# query sees, gradients that vanish in exact arithmetic) is held to an
# absolute limit of ROW_TOL times that floor; a dQ row with one live key
# is read against its terms' size instead (dq_row_err)
ROW_FLOOR = 1e-4
# last-position logits, bf16 on the card vs f32 on the CPU, relative to
# the largest |logit|: bf16 activations carry ~2^-8 relative error
# through 8 residual blocks
LOGITS_REL_TOL = 5e-2
# training.  At random init every loss is about ln V whatever the
# network computes, so the losses alone prove little: what the backward
# decides is how far each step moves the loss, and where it moves the
# parameters.  bf16 vs f32 on the card, 8 steps: the first loss, and each
# decrease L_k - L_1 relative to the f32 one (bf16 activations and
# gradients through 8 blocks).  f32 card vs CPU, 2 layers, 3 steps: the
# losses, each decrease, and every parameter's update p_3 - p_0 row by
# row (row_rel_err) — summation order, and the f32 storage of the
# parameters: one f32 ulp of a loss near 10.5 is 9e-8 of it and 3e-5 of
# a decrease of 0.03, and an embedding row's update of ~1e-6 per element
# on weights near 0.03 (ulp 1.9e-9) reads ~2e-3 from rounding alone.
# Each limit sits a few times above its reading (PERF.md).
TRAIN_FIRST_REL_TOL = 5e-6
TRAIN_DECREASE_REL_TOL = 5e-2
TRAJ_RTOL = 1e-6
TRAJ_DECREASE_REL_TOL = 2e-4
TRAJ_UPDATE_ROW_TOL = 1e-2
TRAIN_BATCH, TRAIN_T, TRAIN_ITERS, TRAIN_LR = 16, 1024, 8, 0.01
SMALL_LAYERS, SMALL_T, SMALL_BATCH, SMALL_ITERS = 2, 256, 2, 3
# phase 6: bench.py's transformerlm_blocksparse_T4096 leg
BS_CFG = {"window": 2, "globals": 1, "block": 512}
BS_BATCH, BS_T, BS_CMP_ITERS = 4, 4096, 3
BS_SMALL_CFG, BS_SMALL_T, BS_SMALL_BATCH = (
    {"window": 2, "globals": 1, "block": 64}, 512, 1)
# bf16 vs f32 first loss at T 4096, B 4 (the same 16384 tokens as phase
# 5 in 4 sequences): the readings, 7.870e-06 block-sparse and 9.860e-06
# flash (PERF.md), are 8-10x phase 5's whatever the attention kernel, so
# the gap comes with the shape; both are held to one limit, 4x above them
BS_FIRST_REL_TOL = 4e-5
# the flash and all-ones block-sparse runs compute the same function
# through K1-K3 and K6-K8; in bf16 K1 is the Hopper kernel, which rounds
# at other points than K6 (phase 3 holds the pair row by row; K7/K8 give
# K2/K3's bits), so their three losses are held to each other at
# BS_FIRST_REL_TOL, the limit above for two bf16 computations of one loss
# phase 7: the flagship MLP's first weight, a magnitude mask
MM_SHAPE, MM_BLOCK, MM_DENSITY = (16384, 1024, 4096), 128, 0.5
# phase 8: bench.py's ResNet-50 leg (bench.py:231-250), B 64 from its sweep
RESNET_CLASSES, RESNET_BATCH, RESNET_HW, RESNET_LR = 1000, 64, 224, 0.01
# a training step's FLOP per image: 3 x the 8.18 GFLOP forward
# (bench.py:63-65)
RESNET_STEP_FLOP_PER_IMAGE = 3 * 8.18e9
RESNET_K5_PER_STEP = 26          # 13 3x3 stride-1 convs, forward and dX
RESNET_CMP_BATCH, RESNET_CPU_BATCH, RESNET_CMP_ITERS = 8, 2, 3
# ResNet-50 tolerances.  bf16 vs f32 on the card, 8 steps at B 64: the
# first loss and each decrease L_k - L_1 relative to f32's.  "pallas" vs
# "xla" (f32, B 8) and card vs CPU (f32, B 2): the losses and decreases
# of 3 steps, every BatchNorm statistic after one step, and every
# parameter update p_3 - p_0 row by row with BatchNorm frozen.  f32
# differs in summation order only, but ResNet-50's backward at random
# init is ill conditioned in training mode: the global average pool and
# the identity shortcuts hand every BatchNorm an output gradient with a
# large component constant over the positions it normalizes, which its
# backward subtracts, so an input perturbed by 1e-7 moves the first
# step's conv-weight gradients by 2 % (median) and the updates of three
# steps by 100 % (CPU, B 8; PERF.md).  With BatchNorm frozen (running
# statistics, an affine map) the same perturbation moves no update by
# more than 3e-3, so the updates are held there.  Each limit sits a few
# times above its reading on the H100 (PERF.md): first loss bf16 vs f32
# 8.5e-4, decreases 7.5e-2; f32 first losses equal or 4.7e-7 apart,
# decreases 1.4e-2 in training mode, rows 2.9e-3 frozen (pallas vs xla)
# and 1.6e-3 (card vs CPU), BatchNorm statistics 1.3e-5; eval forward
# 1.2e-6.
RESNET_FIRST_REL_TOL = 4e-3
RESNET_DECREASE_REL_TOL = 0.25
RESNET_CMP_RTOL = 1e-5
RESNET_CMP_DECREASE_REL_TOL = 5e-2
RESNET_CMP_ROW_TOL = 1e-2
RESNET_EVAL_REL_TOL = 1e-5


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def _event_ms(run, n: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cuda_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed ``reps`` times (CUDA events), so the host's
    launch cost is out of the measure.  Inputs stay warm in L2 between
    calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(lambda: [graph.replay() for _ in range(reps)],
                   iters * reps)
    del graph
    return ms


def max_row_norm(torch, t) -> float:
    return torch.linalg.vector_norm(t.float(), dim=-1).max().item()


def row_rel_err(torch, got, ref, scale=None) -> float:
    """The worst row's relative error: for each row of the last dim,
    ||got - ref|| / (||ref|| + ROW_FLOOR * scale) in f32.  ``scale``
    defaults to ref's largest row norm; rows zero on both sides read 0."""
    d = torch.linalg.vector_norm(got.float() - ref.float(), dim=-1)
    r = torch.linalg.vector_norm(ref.float(), dim=-1)
    if scale is None:
        scale = r.max().item()
    return (d / (r + ROW_FLOOR * scale)).max().item()


def dq_row_err(torch, got, ref, keep, k, v, d_o, sm_scale, scale) -> float:
    """dQ's ``row_rel_err`` at ``scale``, except on a query row with one
    live key j under ``keep`` ((T, S) bool): there dQ = P (dP - delta)
    k_j sm_scale is 0 in exact arithmetic (delta = dO . O and O = v_j),
    both sides hold only the rounding of dP - delta, which two summation
    orders do not share, and no f32 arithmetic meets a floor set against
    the largest row; such a row is read against the size of its terms
    before they cancel, sm_scale ||dO_i|| ||v_j|| ||k_j||."""
    one = keep.sum(dim=-1) == 1
    err = row_rel_err(torch, got[..., ~one, :], ref[..., ~one, :],
                      scale) if not bool(one.all()) else 0.0
    if bool(one.any()):
        i = torch.nonzero(one).flatten()
        j = keep[i].int().argmax(dim=-1)

        def norm(t):
            return torch.linalg.vector_norm(t.float(), dim=-1)

        size = sm_scale * norm(d_o[..., i, :]) * norm(v[..., j, :]) * norm(
            k[..., j, :])
        err = max(err, (norm(got[..., i, :].float() - ref[..., i, :].float())
                        / size).max().item())
    return err


def bwd_yardstick(torch, fa, D, dt, tensors):
    """The inputs of the plain backward that a backward kernel is held to:
    for the f32 kernels on split products (every head dim: the chunked
    backward above 256) the tensors in f64, so the plain version's math
    runs in f64 (its own f32 rounding, which dS = P (dP - delta) amplifies
    on a row whose dP and delta nearly cancel, would read as the kernel's
    error); the tensors as they are for bf16, whose kernels (the chunked
    backward above 256 too) round where the plain version does."""
    if dt != torch.float32:
        return tensors
    return [t.double() for t in tensors]


def bound(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def ptxas_functions(report: str) -> dict:
    """Per entry function of an ``nvcc -Xptxas -v`` report: registers,
    stack, spill stores and loads (bytes)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_counts(so_path):
    """Per function of a built library, how many SASS instructions are
    wgmma (HGMMA) and TMA loads (UTMALDG) (``cuobjdump -sass``); None
    where the toolkit has no ``cuobjdump``."""
    opcodes = ("HGMMA", "UTMALDG")
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    if not Path(tool).exists():
        return None
    proc = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        return None
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                if op in line:
                    counts[fn][op] += 1
    return counts


# phase 2's kernels, by their mangled names: (pattern, labels by its first
# group, dtype)
DESIGN_KERNELS = (
    (r"attn_(fwd)_wgmma_kernelILi(\d+)E.*?(Dense|List)Sweep",
     {"fwdDense": "K1", "fwdList": "K6"}, "bfloat16"),
    (r"attn_(fwd)_split_kernelILi(\d+)E.*?(Dense|List)Sweep",
     {"fwdDense": "K1", "fwdList": "K6"}, "float32"),
    (r"bwd_(dkv|dq)_wgmma_kernelILi(\d+)E.*?(Dense|List)Sweep",
     {"dkvDense": "K2", "dqDense": "K3", "dkvList": "K7", "dqList": "K8"},
     "bfloat16"),
    (r"bwd_(dkv|dq)_split_kernelILi(\d+)E.*?(Dense|List)Sweep",
     {"dkvDense": "K2", "dqDense": "K3", "dkvList": "K7", "dqList": "K8"},
     "float32"),
)
# the chunked forward above head dim 256 (K1, K6), one instantiation per
# dtype and sweep for every such head dim: (dtype by its mangled
# argument, sweep)
CHUNK_KERNEL = r"attn_fwd_chunk_kernelI(13__nv_bfloat16|f)NS_\d+(Dense|List)Sweep"
# the chunked dK/dV and dQ above head dim 256 (K2, K3, K7, K8), one
# instantiation per pass, dtype and sweep for every such head dim: (pass,
# dtype by its mangled argument, sweep)
CHUNK_BWD_KERNEL = (r"bwd_(dkv|dq)_chunk_kernelI(13__nv_bfloat16|f)NS_\d+"
                    r"(Dense|List)Sweep")
#: the head dim phase 2 reports the chunked forward under
CHUNKED = "above 256"
# the FMA loops the f32 K3, K8 and K5 ran before their split products,
# the wide route's (a warp per output row) forward, which K1 and K6 ran
# above head dim 256, and its dK/dV and dQ in either dtype, which K2/K3
# and K7/K8 ran there, and K9's tile loop (FMA, WMMA), which blocks that
# are not multiples of 16 ran: phase 2 fails if a built library still
# holds one
RETIRED_KERNELS = (r"flash_bwd_dq_kernel|bs_dq_kernel|conv3x3_kernel_f32"
                   r"|wide_fwd_kernel|wide_(dkv|dq)_kernel|bs_mm_kernel_tile")


# the head dims phase 2 holds each Hopper attention kernel to: in bf16 D
# 128, 192 and 256 (K2, K3, K7 and K8 there are the 64-row blocks); in f32
# (split products; K2, K3, K7 and K8 on 64-row blocks) at every head dim
# (at 192 and 256 on 32-row streamed tiles, the own rows split into
# registers); above 256 the chunked kernels in both dtypes
CHECKED_HEAD_DIMS = {
    (label, dtype): dims + (CHUNKED,)
    for label in ("K1", "K2", "K3", "K6", "K7", "K8")
    for dtype, dims in (("bfloat16", (128, 192, 256)),
                        ("float32", (16, 32, 64, 128, 192, 256)))}


def design_kernel(fn: str):
    """(label, head dim, dtype) of a phase-2 kernel's mangled name, or
    None for the others; the chunked forward's and backward's head dim
    is ``CHUNKED``."""
    for pattern, labels, dtype in DESIGN_KERNELS:
        m = re.search(pattern, fn)
        if m:
            key = m.group(1) + (m.group(3) if m.lastindex == 3 else "")
            return labels[key], int(m.group(2)), dtype
    m = re.search(CHUNK_KERNEL, fn)
    if m:
        return ({"Dense": "K1", "List": "K6"}[m.group(2)], CHUNKED,
                "float32" if m.group(1) == "f" else "bfloat16")
    m = re.search(CHUNK_BWD_KERNEL, fn)
    if m:
        return ({"dkvDense": "K2", "dqDense": "K3", "dkvList": "K7",
                 "dqList": "K8"}[m.group(1) + m.group(3)], CHUNKED,
                "float32" if m.group(2) == "f" else "bfloat16")
    return None


def kernel_design(torch):
    """Phase 2's report of the Hopper kernels' build: per instantiation
    of K1, K2, K3 and K6-K8 (dtype, head dim) its registers, spills and
    dynamic shared memory from ptxas, and its count of wgmma (HGMMA) and
    TMA load (UTMALDG) instructions in SASS.  Fails where a bf16 kernel
    at D 128, 192 or 256 (the bf16 route of head dims 129-256; K2, K3, K7
    and K8 there are the 64-row dK/dV and dQ blocks), or an f32 one (split
    products) at D 16-256, or a chunked kernel above 256 (K1-K3, K6-K8,
    one instantiation per dtype for every head dim), spills, has its
    wgmma serialised by ptxas (C7520, C7514),
    holds no HGMMA or no UTMALDG, or is missing, and where a library still
    holds a retired FMA loop (``RETIRED_KERNELS``).  A library loaded
    from an earlier build in the same checkout has no ptxas report
    (``_support.BUILD_INFO``): its registers and spills read "not
    measured"."""
    import ctypes

    from bigdl_tpu_torch.ops import _support

    def smem_fn(lib, name, n):
        fn = getattr(_support.load_cuda_library(lib), name)
        fn.argtypes, fn.restype = [ctypes.c_int] * n, ctypes.c_int
        return fn

    fwd = smem_fn("flash_fwd", "bigdl_flash_fwd_smem_bytes", 2)
    bwd = smem_fn("flash_bwd", "bigdl_flash_bwd_smem_bytes", 3)
    bs_fwd = smem_fn("block_sparse", "bigdl_bs_fwd_smem_bytes", 2)
    bs_bwd = smem_fn("block_sparse", "bigdl_bs_bwd_smem_bytes", 3)
    smem_of = {"K1": fwd, "K2": lambda D, dt: bwd(1, D, dt),
               "K3": lambda D, dt: bwd(0, D, dt), "K6": bs_fwd,
               "K7": lambda D, dt: bs_bwd(1, D, dt),
               "K8": lambda D, dt: bs_bwd(0, D, dt)}
    # conv3x3's kernels are reported by conv_design; it is scanned here for
    # a retired loop only
    libs = {"flash_fwd": ("K1",), "flash_bwd": ("K2", "K3"),
            "block_sparse": ("K6", "K7", "K8"), "conv3x3": ()}
    rows, failures = [], []
    for lib_name, labels in libs.items():
        report = _support.BUILD_INFO[lib_name][1]
        ptxas = ptxas_functions(report)
        # ptxas's remark that a kernel's wgmma are serialised (C7520: a
        # product on a divergent path)
        serialised = set(re.findall(r"serialized.*?function '([^']+)'", report))
        sass = sass_counts(_support.load_cuda_library(lib_name)._name)
        for fn in sorted(set(ptxas) | set(sass or {})):
            if re.search(RETIRED_KERNELS, fn):
                failures.append(f"{lib_name} still holds {fn}")
            found = design_kernel(fn)
            if found is None or found[0] not in labels:
                continue
            label, D, dtype = found
            rep = ptxas.get(fn)
            ops = None if sass is None else sass.get(fn)
            row = dict(kernel=fn, label=label, dtype=dtype, head_dim=D,
                       dynamic_smem_bytes=smem_of[label](
                           320 if D == CHUNKED else D,
                           int(dtype == "bfloat16")),
                       ptxas=rep, sass=ops)
            rows.append(row)
            regs = ("not measured (an earlier build was loaded)"
                    if rep is None else
                    f"{rep.get('registers')} registers, spill stores "
                    f"{rep.get('spill_stores')} B, loads "
                    f"{rep.get('spill_loads')} B")
            print(f"{label} {dtype:>8} D {D!s:>3}: {regs}, dynamic smem "
                  f"{row['dynamic_smem_bytes']} B; SASS "
                  f"{'not measured (no cuobjdump)' if ops is None else ops}")
            spills = rep and (rep.get("spill_stores") or rep.get("spill_loads"))
            if D in CHECKED_HEAD_DIMS.get((label, dtype), ()):
                if spills:
                    failures.append(f"{label} {dtype} D {D} spills: {rep}")
                if fn in serialised:
                    failures.append(f"{label} {dtype} D {D}: ptxas "
                                    f"serialises its wgmma (C7520, C7514)")
                if ops is not None and not (ops["HGMMA"] and ops["UTMALDG"]):
                    failures.append(f"{label} {dtype} D {D} holds no HGMMA "
                                    f"or no UTMALDG: {ops}")
        for (label, dtype), dims in CHECKED_HEAD_DIMS.items():
            if label not in labels:
                continue
            for D in dims:
                built = any(r["label"] == label and r["head_dim"] == D
                            and r["dtype"] == dtype for r in rows)
                if not built and (ptxas or sass):
                    failures.append(f"{label} {dtype} D {D} missing from "
                                    f"the build's reports")
    return rows, failures


# the wgmma GEMMs by their mangled names: K5 in bf16 and in f32 (split
# products; KC input channels a step, BN output channels a block) and
# K9 in bf16 and in f32 (split products; KC, BN, W read K-major), which
# its block and coarse routes share
CONV_KERNEL = r"conv3x3_kernel_wgmmaILi(\d+)ELi(\d+)E"
CONV_SPLIT_KERNEL = r"conv3x3_kernel_splitILi(\d+)ELi(\d+)E"
MM_KERNEL = r"bs_mm_kernel_wgmmaILi(\d+)ELi(\d+)ELb([01])E"
MM_SPLIT_KERNEL = r"bs_mm_kernel_splitILi(\d+)ELi(\d+)ELb([01])E"


def wgmma_design(lib_name, label, pattern, names, smem, occ, checked,
                 dtype="bfloat16", blocks=2, serial_check=False):
    """Phase 2's report of a GEMM on TMA and wgmma (K5, K9) in ``dtype``:
    per instantiation (its template arguments, by ``names``) its
    registers, spills and dynamic shared memory (ptxas), how many blocks
    the card runs on one SM at once, and its wgmma (HGMMA) and TMA load
    (UTMALDG) instructions in SASS.  Fails where fewer than ``blocks``
    blocks share an SM, and where an instantiation that ``checked`` takes
    spills or holds no HGMMA or no UTMALDG, or, with ``serial_check``,
    has its wgmma serialised by ptxas (any "serialized" remark: C7514,
    C7520)."""
    from bigdl_tpu_torch.ops import _support

    report = _support.BUILD_INFO[lib_name][1]
    ptxas = ptxas_functions(report)
    serialised = set(re.findall(r"serialized.*?function '([^']+)'", report))
    sass = sass_counts(_support.load_cuda_library(lib_name)._name)
    rows, failures = [], []
    for fn in sorted(set(ptxas) | set(sass or {})):
        m = re.search(pattern, fn)
        if m is None:
            continue
        args = tuple(int(v) for v in m.groups())
        rep = ptxas.get(fn)
        ops = None if sass is None else sass.get(fn)
        row = dict(kernel=fn, label=label, dtype=dtype,
                   **dict(zip(names, args)), dynamic_smem_bytes=smem(*args),
                   blocks_per_sm=occ(*args), ptxas=rep, sass=ops)
        rows.append(row)
        regs = ("not measured (an earlier build was loaded)"
                if rep is None else
                f"{rep.get('registers')} registers, spill stores "
                f"{rep.get('spill_stores')} B, loads "
                f"{rep.get('spill_loads')} B")
        what = " ".join(f"{n.upper()} {v:3d}" for n, v in zip(names, args))
        print(f"{label} {dtype} {what}: {regs}, dynamic smem "
              f"{row['dynamic_smem_bytes']} B, {row['blocks_per_sm']} "
              f"blocks an SM; SASS "
              f"{'not measured (no cuobjdump)' if ops is None else ops}")
        if row["blocks_per_sm"] < blocks:
            failures.append(f"{label} {dtype} {what}: {row['blocks_per_sm']} "
                            f"blocks an SM, want {blocks}")
        if checked(*args):
            if rep and (rep.get("spill_stores") or rep.get("spill_loads")):
                failures.append(f"{label} {dtype} {what} spills: {rep}")
            if ops is not None and not (ops["HGMMA"] and ops["UTMALDG"]):
                failures.append(f"{label} {dtype} {what} holds no HGMMA or "
                                f"no UTMALDG: {ops}")
            if serial_check and fn in serialised:
                failures.append(f"{label} {dtype} {what}: ptxas serialises "
                                f"its wgmma")
    if (ptxas or sass) and not any(checked(*(r[n] for n in names))
                                   for r in rows):
        failures.append(f"{label} {dtype} kernels missing from the build's "
                        f"reports")
    return rows, failures


def _int_fn(lib_name, name, n):
    import ctypes

    from bigdl_tpu_torch.ops import _support

    fn = getattr(_support.load_cuda_library(lib_name), name)
    fn.argtypes, fn.restype = [ctypes.c_int] * n, ctypes.c_int
    return fn


def conv_design(torch):
    """K5's build (``wgmma_design``), per (KC, BN): in bf16 two blocks an
    SM, KC 64 must not spill, must hold HGMMA and UTMALDG and must not
    have its wgmma serialised; in f32 (split products) a block alone on
    its SM, and no instantiation may spill, lack HGMMA or UTMALDG, or
    have its wgmma serialised."""
    smem = _int_fn("conv3x3", "bigdl_conv3x3_smem_bytes", 3)
    occ = _int_fn("conv3x3", "bigdl_conv3x3_blocks_per_sm", 3)
    rows, failures = wgmma_design(
        "conv3x3", "K5", CONV_KERNEL, ("kc", "bn"),
        lambda kc, bn: smem(kc, bn, 1), lambda kc, bn: occ(kc, bn, 1),
        lambda kc, bn: kc == 64, serial_check=True)
    more_rows, more_failures = wgmma_design(
        "conv3x3", "K5", CONV_SPLIT_KERNEL, ("kc", "bn"),
        lambda kc, bn: smem(kc, bn, 0), lambda kc, bn: occ(kc, bn, 0),
        lambda kc, bn: True, dtype="float32", blocks=1, serial_check=True)
    return rows + more_rows, failures + more_failures


def mm_design(torch):
    """K9's kernels (``wgmma_design``), per (KC, BN, W K-major), which its
    block and coarse routes share: in bf16 two blocks an SM, in f32
    (split products) a block alone on its SM; none may spill, each must
    hold HGMMA and UTMALDG, and none may have its wgmma serialised."""
    smem = _int_fn("block_sparse", "bigdl_bs_mm_smem_bytes", 4)
    occ = _int_fn("block_sparse", "bigdl_bs_mm_blocks_per_sm", 4)
    names = ("kc", "bn", "kmajor")
    rows, failures = wgmma_design(
        "block_sparse", "K9", MM_KERNEL, names,
        lambda *args: smem(*args, 1), lambda *args: occ(*args, 1),
        lambda *args: True, serial_check=True)
    more_rows, more_failures = wgmma_design(
        "block_sparse", "K9", MM_SPLIT_KERNEL, names,
        lambda *args: smem(*args, 0), lambda *args: occ(*args, 0),
        lambda *args: True, dtype="float32", blocks=1, serial_check=True)
    return rows + more_rows, failures + more_failures


def flash_cases(torch):
    """(label, B, H, T, S, D, dtype, causal): the served prefill, the
    training step, the 200-token batch, causal T > S, f32 (also
    head-strided), narrower heads, head dims 192 and 256 (the Hopper
    route of 129-256, in f32 on split products) and above 256 (the
    chunked forward, in both dtypes: 300 padded to 320, 320 also
    head-strided, 384, 512).  A label starting "strided" takes q, k and v
    in the (B, T, H, D).transpose(1, 2) layout an attention layer
    makes."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("served", 4, 8, 512, 512, 128, bf16, True),
            ("train", 16, 8, 1024, 1024, 128, bf16, True),
            ("strided_train", 16, 8, 1024, 1024, 128, bf16, True),
            ("ragged_T200", 4, 8, 200, 200, 128, bf16, True),
            ("causal_T>S", 2, 8, 300, 200, 128, bf16, True),
            ("f32_causal", 2, 8, 512, 512, 128, f32, True),
            ("strided_f32_causal", 2, 8, 512, 512, 128, f32, True),
            ("f32_noncausal_D64", 2, 4, 200, 333, 64, f32, False),
            ("bf16_noncausal_D32", 2, 4, 96, 130, 32, bf16, False),
            ("bf16_causal_T1_D16", 3, 2, 1, 1, 16, bf16, True),
            ("D192", 2, 8, 1024, 1024, 192, bf16, True),
            ("D256", 2, 8, 1024, 1024, 256, bf16, True),
            ("wide_D320", 2, 8, 1024, 1024, 320, bf16, True),
            ("f32_D192", 2, 8, 1024, 1024, 192, f32, True),
            ("f32_D256", 2, 8, 1024, 1024, 256, f32, True),
            ("wide_f32_D320", 2, 8, 1024, 1024, 320, f32, True),
            ("wide_D512", 2, 8, 1024, 1024, 512, bf16, True),
            ("wide_f32_D512", 2, 8, 1024, 1024, 512, f32, True),
            ("wide_D300", 1, 4, 512, 512, 300, bf16, True),
            ("wide_f32_D300", 1, 4, 512, 512, 300, f32, True),
            ("wide_D384", 1, 4, 384, 500, 384, bf16, False),
            ("wide_f32_D384", 1, 4, 384, 500, 384, f32, False),
            ("strided_D320", 1, 4, 300, 300, 320, bf16, True),
            ("strided_f32_D320", 1, 4, 300, 300, 320, f32, True)]


def attn_inputs(torch, label, B, H, rows, D, dt, g, n):
    """n (B, H, rows, D) tensors from ``g``: contiguous, or for a
    "strided" label the (B, rows, H, D).transpose(1, 2) views of an
    attention layer."""
    if label.startswith("strided"):
        return [torch.randn(B, rows, H, D, device="cuda", generator=g
                            ).to(dt).transpose(1, 2) for _ in range(n)]
    return [torch.randn(B, H, rows, D, device="cuda", generator=g).to(dt)
            for _ in range(n)]


def check_flash(torch, F, cases=None):
    from bigdl_tpu_torch.ops import flash_attention as fa

    rows = []
    for label, B, H, T, S, D, dt, causal in cases or flash_cases(torch):
        g = torch.Generator(device="cuda").manual_seed(7)
        q, = attn_inputs(torch, label, B, H, T, D, dt, g, 1)
        k, v = attn_inputs(torch, label, B, H, S, D, dt, g, 2)
        scale = 1.0 / math.sqrt(D)
        copies = fa.OPERAND_COPIES.count
        chunked = fa.LAUNCHES_CHUNKED[dt].count
        o, lse = fa._flash_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        copies = fa.OPERAND_COPIES.count - copies
        chunked = fa.LAUNCHES_CHUNKED[dt].count - chunked
        o_ref, lse_ref = fa._flash_plain(q, k, v, causal, scale)
        err = (o.float() - o_ref.float()).abs().max().item()
        row_err = row_rel_err(torch, o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        dname = str(dt).split(".")[-1]
        tol = ROW_TOL[dname]
        ok = row_err <= tol and lse_err <= LSE_TOL and bool(
            torch.isfinite(o.float()).all()) and chunked == int(fa._wide(D))
        same = None
        if label.startswith("strided"):
            # in place (no copy), and the contiguous launch's bits
            c = fa._flash_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal, scale)
            same = bool(torch.equal(o, c[0]) and torch.equal(lse, c[1]))
            ok = ok and same and copies == 0
            del c
        ms = cuda_ms(lambda: fa._flash_cuda(q, k, v, causal, scale))
        plain_ms = cuda_ms(lambda: fa._flash_plain(q, k, v, causal, scale))
        lib_ms = None
        if T == S:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
        pairs = sum(min(S, t + 1) for t in range(T)) if causal else T * S
        item = q.element_size()
        nbytes = item * (2 * B * H * T * D + 2 * B * H * S * D) + 4 * B * H * T
        # the f32 K1 forms its products from bf16 products on the tensor
        # cores
        bound_ms, bound_by = bound(nbytes, 4.0 * B * H * pairs * D,
                                   split_rate(dname, "fwd"))
        rows.append(dict(case=label, shape=[B, H, T, S, D], dtype=dname,
                         causal=causal, max_abs_err=err, row_rel_err=row_err,
                         lse_err=lse_err, tol=tol, ok=ok,
                         chunked_launches=chunked,
                         operand_copies=copies, equals_contiguous=same,
                         ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K1 flash_fwd {label:>20} {dname:>8} row err {row_err:.3e} "
              f"(tol {tol:g}) max abs err {err:.3e} lse_err {lse_err:.3e} "
              f"chunked {chunked} copies {copies}"
              f"{'' if same is None else f' = contiguous bitwise {same}'} "
              f"| kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms sdpa {lib_ms} ms (kernel / sdpa "
              f"{ms / lib_ms if lib_ms else None}) bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}) {'OK' if ok else 'FAIL'}")
    return rows


def check_layer_norm(torch, F, cases=None):
    from bigdl_tpu_torch.ops import layer_norm as ln

    rows = []
    for label, R, Fdim, dt in cases or (
            ("served_prefill", 2048, 1024, torch.bfloat16),
            ("train", 16384, 1024, torch.bfloat16),
            ("f32", 2048, 1024, torch.float32),
            ("decode_step", 4, 1024, torch.bfloat16),
            ("ragged_F", 300, 1000, torch.bfloat16),
            ("column_slice", 16384, 1024, torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(11)
        if label == "column_slice":   # rows 1536 apart, read in place
            x = torch.randn(R, 1536, device="cuda", generator=g).to(dt)[
                :, 256:256 + Fdim]
        else:
            x = torch.randn(R, Fdim, device="cuda", generator=g).to(dt)
        gamma = (1 + 0.1 * torch.randn(Fdim, device="cuda", generator=g)).to(dt)
        beta = (0.1 * torch.randn(Fdim, device="cuda", generator=g)).to(dt)
        copies = ln.X_COPIES.count
        y = ln._layer_norm_cuda(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        copies = ln.X_COPIES.count - copies
        y_ref = ln._layer_norm_plain(x, gamma, beta, 1e-5)
        err = (y.float() - y_ref.float()).abs().max().item()
        dname = str(dt).split(".")[-1]
        tol = TOL[("layer_norm_fwd", dname)]
        ok = err <= tol and bool(torch.isfinite(y.float()).all()) \
            and copies == 0
        if label == "column_slice":
            ok = ok and bool(torch.equal(y, ln._layer_norm_cuda(
                x.contiguous(), gamma, beta, 1e-5)))
        ms = cuda_ms(lambda: ln._layer_norm_cuda(x, gamma, beta, 1e-5))
        plain_ms = cuda_ms(lambda: ln._layer_norm_plain(x, gamma, beta, 1e-5))
        lib_ms = cuda_ms(lambda: F.layer_norm(x, (Fdim,), gamma, beta, 1e-5))
        item = x.element_size()
        nbytes = item * (2 * R * Fdim + 2 * Fdim)
        # the kernel's arithmetic is f32 whatever x's dtype
        bound_ms, bound_by = bound(nbytes, 8.0 * R * Fdim, "float32")
        rows.append(dict(case=label, shape=[R, Fdim], dtype=dname,
                         max_abs_err=err, tol=tol, ok=ok, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K4 layer_norm {label:>15} {dname:>8} err {err:.3e} "
              f"(tol {tol:g}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"F.layer_norm {lib_ms:.4f} ms bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}) {'OK' if ok else 'FAIL'}")
    return rows


def launch_counters():
    """Every kernel's launch counter, by the kernel's name (K1-K3 and
    K6-K8 also by f32 head dim 192 and 256 and above 256 by dtype, K9 on
    its f32 block route and on its coarse route by dtype, and the coarse
    route's masked copy of W: the ``variants`` of the ``kernels`` line), and
    the attention and LayerNorm wrappers' counts
    of operand copies, which the bf16 main paths hold at 0.  A checkout
    without some of the variants' counters (``f32_steps.py`` runs these
    helpers on an earlier one) lists those it has."""
    from bigdl_tpu_torch.ops import block_sparse as bs
    from bigdl_tpu_torch.ops import conv3x3
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import layer_norm as ln

    by_dim = [c for m in (fa, bs) for n in ("LAUNCHES_F32", "LAUNCHES_DKV_F32",
                                            "LAUNCHES_DQ_F32",
                                            "LAUNCHES_CHUNKED",
                                            "LAUNCHES_DKV_CHUNKED",
                                            "LAUNCHES_DQ_CHUNKED")
              for c in getattr(m, n, {}).values()]
    by_dim += [getattr(bs, n) for n in ("LAUNCHES_MM_F32", "LAUNCHES_MM_MASK")
               if hasattr(bs, n)]
    by_dim += list(getattr(bs, "LAUNCHES_MM_COARSE", {}).values())
    by_dim.append(ln.LAUNCHES_STRIDED)
    return {c.name: c for c in (fa.LAUNCHES, fa.LAUNCHES_DKV,
                                fa.LAUNCHES_DQ, ln.LAUNCHES, bs.LAUNCHES,
                                bs.LAUNCHES_DKV, bs.LAUNCHES_DQ,
                                bs.LAUNCHES_MM, conv3x3.LAUNCHES, *by_dim,
                                fa.OPERAND_COPIES, ln.X_COPIES)}


def want_launches(**counts):
    """Every counter at 0 but those named."""
    return {n: counts.get(n, 0) for n in launch_counters()}


def bwd_cases(torch):
    """(label, B, H, T, S, D, dtype, causal) for K2/K3: the training
    step (also head-strided, as ``flash_cases``), a ragged T, causal
    T > S and S > T, f32 (also head-strided), narrower heads, head dims
    192 and 256 (K2 and K3 on the 64-row Hopper blocks, in f32 too, on
    split products) and above 256 in both dtypes (the chunked backward:
    320, also head-strided in bf16, and 512; in bf16 also 300 padded to
    320 and 384 with T != S, not causal)."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("train", 16, 8, 1024, 1024, 128, bf16, True),
            ("strided_train", 16, 8, 1024, 1024, 128, bf16, True),
            ("ragged_T200", 4, 8, 200, 200, 128, bf16, True),
            ("causal_T>S", 2, 8, 300, 200, 128, bf16, True),
            ("causal_S>T", 2, 8, 200, 300, 64, bf16, True),
            ("f32_causal", 2, 8, 512, 512, 128, f32, True),
            ("strided_f32_causal", 2, 8, 512, 512, 128, f32, True),
            ("f32_noncausal_D64", 2, 4, 200, 333, 64, f32, False),
            ("bf16_noncausal_D32", 2, 4, 96, 130, 32, bf16, False),
            ("D192", 2, 8, 1024, 1024, 192, bf16, True),
            ("D256", 2, 8, 1024, 1024, 256, bf16, True),
            ("ragged_D256", 2, 8, 200, 300, 256, bf16, True),
            ("wide_D320", 2, 8, 1024, 1024, 320, bf16, True),
            ("f32_D192", 2, 8, 1024, 1024, 192, f32, True),
            ("f32_D256", 2, 8, 1024, 1024, 256, f32, True),
            ("wide_f32_D320", 2, 8, 1024, 1024, 320, f32, True),
            ("wide_D512", 2, 8, 1024, 1024, 512, bf16, True),
            ("wide_f32_D512", 2, 8, 1024, 1024, 512, f32, True),
            ("wide_D300", 1, 4, 512, 512, 300, bf16, True),
            ("wide_D384", 1, 4, 384, 500, 384, bf16, False),
            ("strided_D320", 1, 4, 300, 300, 320, bf16, True)]


def sdpa_bwd_ms(torch, F, q, k, v, d_o, iters: int = 10, reps: int = 5,
                **sdpa_kw):
    """Device time of the backward of one ``scaled_dot_product_attention``
    call on (q, k, v) with output gradient ``d_o``, and the backend that
    ran it (the name of the forward's autograd node).  The forward runs
    once on a side stream; ``iters`` calls of ``torch.autograd.grad`` are
    captured in one CUDA graph on that stream (autograd runs a backward
    on its forward's stream) and replayed ``reps`` times between CUDA
    events, so the host is out of the measure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)

        def grad():
            return torch.autograd.grad(out, leaves, d_o, retain_graph=True)

        for _ in range(3):
            grad()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            grad()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(lambda: [graph.replay() for _ in range(reps)],
                   iters * reps)
    backend = type(out.grad_fn).__name__
    del graph, out, leaves
    return ms, backend


def bwd_tma_bytes(BH, T, S, D, causal, dkv):
    """The bytes the TMA loads of the bf16 K2 (``dkv``) or K3 request
    on the dense sweep (``flash_bwd.cu``'s ``DenseSweep``): per block of
    128 own rows (64 at D 192 and 256) its two own tensors once and two
    streamed 64-row tiles a step, from the causal diagonal on (K2) or up
    to it (K3).  Streamed tiles are read from L2 once a block, however
    many blocks of a head read them."""
    own = 128 if D <= 128 else 64
    rows, other = (S, T) if dkv else (T, S)
    boxes = 0   # rows of each of the two tensors, in boxes
    for b in range(-(-rows // own)):
        if dkv:
            begin = b * own if causal else 0
            n = -(-(other - begin) // 64) if other > begin else 0
        else:
            n = -(-(min(other, (b + 1) * own) if causal else other) // 64)
        boxes += own + 64 * n if n else 0   # a block with no step loads nothing
    return BH * 2 * D * 2 * boxes


def chunk_bwd_tma_bytes(BH, T, S, D, causal, dkv, item):
    """The bytes the TMA loads of the chunked K2 (``dkv``) or K3 request
    on the dense sweep at a padded head dim D above 256: per block of 64
    own rows and each of its ceil(D / 256) chunks, for every streamed
    tile (64 rows in bf16, 32 in f32; ``item`` the bytes of an element)
    both own tensors' 64 rows and both streamed tensors' tile rows over
    all of D, then the tile's chunk operands (dO and Q, or K) over the
    chunk's 256 columns.  Each block reads its own rows again for every
    tile, from L2 after the first read."""
    tr = 64 if item == 2 else 32
    rows, other = (S, T) if dkv else (T, S)
    per_tile = 2 * 64 * D + 2 * tr * D + (2 if dkv else 1) * tr * 256
    tiles = 0
    for b in range(-(-rows // 64)):
        if dkv:
            begin = b * 64 if causal else 0
            n = -(-(other - begin) // 64) if other > begin else 0
        else:
            n = -(-(min(other, (b + 1) * 64) if causal else other) // 64)
        tiles += n * (64 // tr)
    return BH * -(-D // 256) * tiles * per_tile * item


def check_flash_bwd(torch, F, cases=None):
    """K2 and K3 against ``_flash_bwd_plain`` on the same (q, k, v, O,
    LSE, dO), O and LSE from K1 (for the f32 split-product kernels its math
    in f64, ``bwd_yardstick``); no operand copied, one launch of each
    pass counted as chunked above head dim 256, and a head-strided launch
    equal to the contiguous one bit for bit.  Times: each kernel
    alone (graph replay), the whole plain backward, and the backward of
    one ``scaled_dot_product_attention`` call (``sdpa_bwd_ms``: graph
    replay too)."""
    from bigdl_tpu_torch.ops import flash_attention as fa

    rows = []
    for label, B, H, T, S, D, dt, causal in cases or bwd_cases(torch):
        g = torch.Generator(device="cuda").manual_seed(13)
        q, = attn_inputs(torch, label, B, H, T, D, dt, g, 1)
        k, v = attn_inputs(torch, label, B, H, S, D, dt, g, 2)
        d_o, = attn_inputs(torch, label, B, H, T, D, dt, g, 1)
        scale = 1.0 / math.sqrt(D)
        o, lse = fa._flash_cuda(q, k, v, causal, scale)
        do, delta = fa._bwd_inputs(q, o, d_o)
        chunked_counters = (fa.LAUNCHES_DKV_CHUNKED[dt],
                            fa.LAUNCHES_DQ_CHUNKED[dt])
        chunked = [c.count for c in chunked_counters]
        copies = fa.OPERAND_COPIES.count
        dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()   # one kernel per synchronise
        dq = fa._launch_dq(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        chunked = [c.count - n for c, n in zip(chunked_counters, chunked)]
        copies = fa.OPERAND_COPIES.count - copies
        dq_ref, dk_ref, dv_ref = fa._flash_bwd_plain(
            *bwd_yardstick(torch, fa, D, dt, [q, k, v, o, lse, d_o]), causal,
            scale)
        dname = str(dt).split(".")[-1]
        tol = ROW_TOL[dname]
        outs = (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))
        # one scale for the three: at T = S = 1 dq and dk vanish in exact
        # arithmetic and both sides hold rounding noise; dQ's rows with one
        # live key (the first causal row) against their terms' size
        norm = max(max_row_norm(torch, b) for _, _, b in outs)
        rel = {n: row_rel_err(torch, a, b, norm) for n, a, b in outs[1:]}
        keep = (fa._causal_keep(T, S, "cuda") if causal
                else torch.ones(T, S, dtype=torch.bool, device="cuda"))
        rel["dq"] = dq_row_err(torch, dq, dq_ref, keep, k, v, d_o, scale,
                               norm)
        err = {n: (a.float() - b.float()).abs().max().item()
               for n, a, b in outs}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (dq, dk, dv))
        ok = (finite and max(rel.values()) <= tol and copies == 0
              and chunked == [int(fa._wide(D))] * 2)
        same = None
        if label.startswith("strided"):
            # dO read in place too; the contiguous launches' bits
            qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
            same = bool(all(torch.equal(a, b) for a, b in zip(
                (dk, dv, dq),
                fa._launch_dkv(qc, kc, vc, doc, lse, delta, causal, scale)
                + (fa._launch_dq(qc, kc, vc, doc, lse, delta, causal,
                                 scale),))))
            ok = ok and same
            del qc, kc, vc, doc
        big = B * H * T * S >= 1 << 26
        ms_dkv = cuda_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                                causal, scale))
        ms_dq = cuda_ms(lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                              causal, scale))
        plain_ms = cuda_ms(lambda: fa._flash_bwd_plain(
            q, k, v, o, lse, d_o, causal, scale),
            iters=5 if big else 20, reps=3 if big else 5)
        lib_ms = lib_backend = None
        if T == S:
            lib_ms, lib_backend = sdpa_bwd_ms(torch, F, q, k, v, d_o,
                                              is_causal=causal)
        pairs = sum(min(S, t + 1) for t in range(T)) if causal else T * S
        item = q.element_size()
        BH = B * H
        stats = 8 * BH * T
        # the f32 K2 and K3 form their products from bf16 products on the
        # tensor cores
        b_dkv, by_dkv = bound(item * (2 * BH * T * D + 4 * BH * S * D)
                              + stats, 8.0 * BH * pairs * D,
                              split_rate(dname, "dkv"))
        b_dq, by_dq = bound(item * (3 * BH * T * D + 2 * BH * S * D)
                            + stats, 6.0 * BH * pairs * D,
                            split_rate(dname, "dq"))
        # the TMA traffic and its rate: the bf16 Hopper bodies up to D
        # 256, the chunked backward above it in both dtypes
        tma = {}
        if fa._wide(D):
            tma = {p: chunk_bwd_tma_bytes(BH, T, S, fa._bwd_head_dim(D),
                                          causal, p == "dkv", item)
                   for p in ("dkv", "dq")}
        elif dname == "bfloat16":
            tma = {p: bwd_tma_bytes(BH, T, S, D, causal, p == "dkv")
                   for p in ("dkv", "dq")}
        rows.append(dict(
            case=label, shape=[B, H, T, S, D], dtype=dname, causal=causal,
            row_rel_err=rel, max_abs_err=err, tol=tol, ok=ok,
            chunked_launches=chunked, operand_copies=copies,
            equals_contiguous=same, plain_ms=plain_ms,
            library_ms=lib_ms,
            library_backend=lib_backend,
            dkv=dict(ms=ms_dkv, bound_ms=b_dkv, bound_by=by_dkv,
                     max_abs_err=max(err["dk"], err["dv"]),
                     tma_bytes=tma.get("dkv")),
            dq=dict(ms=ms_dq, bound_ms=b_dq, bound_by=by_dq,
                    max_abs_err=err["dq"], tma_bytes=tma.get("dq"))))
        rates = "".join(f" {k} TMA {n / 1e6:.1f} MB ({n / ms / 1e9:.2f} TB/s)"
                        for (k, n), ms in zip(tma.items(), (ms_dkv, ms_dq)))
        print(f"K2/K3 flash_bwd {label:>18} {dname:>8} row err dq "
              f"{rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol "
              f"{tol:g}) chunked {chunked} copies {copies}"
              f"{'' if same is None else f' = contiguous bitwise {same}'} "
              f"| K2 {ms_dkv:.4f} ms (bound {b_dkv:.4f}, {by_dkv}) "
              f"K3 {ms_dq:.4f} ms (bound {b_dq:.4f}, {by_dq}) plain "
              f"{plain_ms:.4f} ms sdpa bwd {lib_ms} ms ({lib_backend}){rates} "
              f"{'OK' if ok else 'FAIL'}")
    return rows


def bs_cases(torch):
    """(label, B, H, T, D, dtype, causal, mask) for K6-K8: the block-sparse
    training step, block 32 (partly live 64-row tiles), ragged T 200 at
    block 8 (a 25 x 25 mask), block 96, the serving mask of phase 9
    (block 16, window 8 + 1 global, B 1, T 512), f32, non-causal with a dead q
    block, strided, all-ones masks in bf16 and f32 (held against K1-K3 as
    well), the training step and the f32 case head-strided (as
    ``flash_cases``), head dims
    192 and 256 (the Hopper route of 129-256: K7 and K8 on 64-row
    blocks; in f32 all three on split products, also on an all-ones mask
    at 256) and above 256 in both dtypes (K6 the chunked forward, K7 and
    K8 the chunked backward: 320, also head-strided and on an all-ones
    mask, 300 padded to 320, 384, 512)."""
    import numpy as np

    from bigdl_tpu_torch.ops import block_sparse as bs

    bf16, f32 = torch.bfloat16, torch.float32
    dead = bs.sliding_window_mask(8, 8, 2, causal=False).mask.copy()
    dead[3, :] = False
    return [("train", 4, 8, 4096, 128, bf16, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 512, 512)),
            ("strided_train", 4, 8, 4096, 128, bf16, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 512, 512)),
            ("block32", 2, 8, 1024, 128, bf16, True,
             bs.sliding_window_mask(32, 32, 2, 1, True, 32, 32)),
            ("ragged_T200_block8", 4, 8, 200, 128, bf16, True,
             bs.sliding_window_mask(25, 25, 3, 1, True, 8, 8)),
            ("block96", 2, 8, 768, 128, bf16, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 96, 96)),
            # phase 9's windowed paged prefill: 32 x 32 pages of 16
            ("serve_page16", 1, 8, PROMPT_LENS[0], 128, bf16, True,
             bs.sliding_window_mask(32, 32, PAGE_WINDOW, 1, True, PAGE_SIZE,
                                    PAGE_SIZE)),
            ("f32_block128", 2, 8, 1024, 128, f32, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("strided_f32_block128", 2, 8, 1024, 128, f32, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("noncausal_dead_qblock", 2, 8, 1024, 64, bf16, False,
             bs.BlockMask(dead, 128, 128)),
            ("strided_block128", 2, 8, 2048, 128, bf16, True,
             bs.strided_mask(16, 16, 4, True, 128, 128)),
            ("all_ones_train", 4, 8, 4096, 128, bf16, True,
             bs.BlockMask(np.ones((8, 8), bool), 512, 512)),
            ("all_ones_f32", 2, 8, 1024, 128, f32, True,
             bs.BlockMask(np.ones((8, 8), bool), 128, 128)),
            ("D192", 2, 8, 1024, 192, bf16, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("D256", 2, 8, 1024, 256, bf16, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("block32_D256", 2, 8, 1024, 256, bf16, True,
             bs.sliding_window_mask(32, 32, 2, 1, True, 32, 32)),
            ("f32_D192", 2, 8, 1024, 192, f32, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("f32_D256", 2, 8, 1024, 256, f32, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("all_ones_f32_D256", 2, 8, 1024, 256, f32, True,
             bs.BlockMask(np.ones((8, 8), bool), 128, 128)),
            ("wide_D320", 2, 8, 1024, 320, bf16, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            ("wide_f32_D320", 2, 8, 1024, 320, f32, True,
             bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)),
            *((f"{pre}D{D}", 1, 4, 512, D, dt, True,
               bs.sliding_window_mask(16, 16, 2, 1, True, 32, 32))
              for pre, dt in (("wide_", bf16), ("wide_f32_", f32))
              for D in (300, 384, 512)),
            *((f"strided_{pre}D320", 1, 4, 512, 320, dt, True,
               bs.sliding_window_mask(4, 4, 2, 1, True, 128, 128))
              for pre, dt in (("", bf16), ("f32_", f32))),
            *((f"all_ones_{pre}D320", 1, 4, 512, 320, dt, True,
               bs.BlockMask(np.ones((4, 4), bool), 128, 128))
              for pre, dt in (("", bf16), ("f32_", f32)))]


def split_rate(dname: str, kind: str) -> str:
    """The ``PEAK_FLOPS`` key of a forward (``kind`` "fwd": K1, K6), dK/dV
    ("dkv": K2, K7) or dQ ("dq": K3, K8) launch in ``dname``: in f32 its
    split products on the tensor cores."""
    if dname != "float32":
        return dname
    return {"fwd": "float32_split_fwd", "dkv": "float32_split",
            "dq": "float32_split_dq"}[kind]


def _bs_bounds(B, H, T, D, item, live, dname):
    """(ms, by) of K6, K7 and K8 over ``live`` score elements per head:
    2, 4 and 3 products of 2 * live * D FLOP; bytes as K1-K3 move them;
    each at ``split_rate``."""
    BH = B * H
    return (bound(item * 4 * BH * T * D + 4 * BH * T, 4.0 * BH * live * D,
                  split_rate(dname, "fwd")),
            bound(item * 6 * BH * T * D + 8 * BH * T, 8.0 * BH * live * D,
                  split_rate(dname, "dkv")),
            bound(item * 5 * BH * T * D + 8 * BH * T, 6.0 * BH * live * D,
                  split_rate(dname, "dq")))


def check_block_sparse(torch, F):
    """K6, K7 and K8 against ``_bs_attention_plain`` / ``_bs_bwd_plain``
    on the same inputs (O and LSE from K6; the f32 split-product K7 and K8
    against ``_bs_bwd_plain``'s math in f64, ``bwd_yardstick``), row by
    row.  The all-ones
    cases also against K1-K3, fed the same (O, LSE, dO, delta) from K6:
    K6-K8 equal K1-K3 bit for bit in both dtypes (one Hopper body over
    the same tiles), and each pair is timed on those same tiles.
    Times: each kernel
    alone (graph replay), the plain forward and backward, and
    ``scaled_dot_product_attention`` with the elementwise boolean mask,
    forward and backward (``sdpa_bwd_ms``), both by graph replay."""
    from bigdl_tpu_torch.ops import block_sparse as bs
    from bigdl_tpu_torch.ops import flash_attention as fa

    rows = []
    for label, B, H, T, D, dt, causal, mask in bs_cases(torch):
        g = torch.Generator(device="cuda").manual_seed(17)
        q, k, v, d_o = attn_inputs(torch, label, B, H, T, D, dt, g, 4)
        scale = 1.0 / math.sqrt(D)
        chunked_counters = (bs.LAUNCHES_CHUNKED[dt],
                            bs.LAUNCHES_DKV_CHUNKED[dt],
                            bs.LAUNCHES_DQ_CHUNKED[dt])
        chunked = [c.count for c in chunked_counters]
        copies = fa.OPERAND_COPIES.count
        o, lse = bs._bs_fwd_cuda(q, k, v, mask, causal, scale)
        torch.cuda.synchronize()   # one kernel per synchronise
        do, delta = fa._bwd_inputs(q, o, d_o)
        dk, dv = bs._launch_bs_dkv(q, k, v, do, lse, delta, mask, causal,
                                   scale)
        torch.cuda.synchronize()
        dq = bs._launch_bs_dq(q, k, v, do, lse, delta, mask, causal, scale)
        torch.cuda.synchronize()
        chunked = [c.count - n for c, n in zip(chunked_counters, chunked)]
        copies = fa.OPERAND_COPIES.count - copies
        o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, causal, scale)
        grads_ref = bs._bs_bwd_plain(
            *bwd_yardstick(torch, fa, D, dt, [q, k, v, o, lse, d_o]), mask,
            causal, scale)
        dname = str(dt).split(".")[-1]
        tol = ROW_TOL[dname]
        outs = (("o", o, o_ref), ("dq", dq, grads_ref[0]),
                ("dk", dk, grads_ref[1]), ("dv", dv, grads_ref[2]))
        gscale = max(max_row_norm(torch, b) for _, _, b in outs[1:])
        rel = {n: row_rel_err(torch, a, b, None if n == "o" else gscale)
               for n, a, b in outs if n != "dq"}
        keep = bs._elementwise_keep(mask, causal, "cuda")
        rel["dq"] = dq_row_err(torch, dq, grads_ref[0], keep, k, v, d_o,
                               scale, gscale)
        err = {n: (a.float() - b.float()).abs().max().item()
               for n, a, b in outs}
        lse_err = (lse - lse_ref).abs().max().item()
        finite = all(bool(torch.isfinite(t.float()).all())
                     for _, t, _ in outs)
        ok = (finite and max(rel.values()) <= tol and lse_err <= LSE_TOL
              and chunked == [int(fa._wide(D))] * 3)
        del o_ref, lse_ref, grads_ref
        live = int(keep.sum().item())
        row = dict(case=label, shape=[B, H, T, D], dtype=dname,
                   causal=causal, mask=repr(mask), live_per_head=live,
                   tiles=bs.tile_work(mask, causal), row_rel_err=rel,
                   max_abs_err=err, lse_err=lse_err, tol=tol,
                   chunked_launches=chunked, operand_copies=copies)
        if label.startswith("strided"):
            # read in place (no copy) by K6-K8, above 256 by the chunked
            # kernels too; the contiguous launches' bits
            qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
            oc, lsec = bs._bs_fwd_cuda(qc, kc, vc, mask, causal, scale)
            got = bs._launch_bs_dkv(qc, kc, vc, doc, lse, delta, mask,
                                    causal, scale) + (bs._launch_bs_dq(
                                        qc, kc, vc, doc, lse, delta, mask,
                                        causal, scale),)
            same = {n: bool(torch.equal(a, b)) for n, a, b in zip(
                ("o", "lse", "dk", "dv", "dq"), (o, lse, dk, dv, dq),
                (oc, lsec) + got)}
            row.update(equals_contiguous=same, ok=ok and all(same.values())
                       and copies == 0)
            rows.append(row)
            print(f"K6-K8 block_sparse {label}: row err o {rel['o']:.3e} dq "
                  f"{rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} "
                  f"(tol {tol:g}) copies {copies}, equal to the contiguous "
                  f"launches {same} {'OK' if row['ok'] else 'FAIL'}")
            del qc, kc, vc, doc, oc, lsec, got
            continue
        if label.startswith("all_ones"):
            o1, lse1 = fa._flash_cuda(q, k, v, causal, scale)
            dk1, dv1 = fa._launch_dkv(q, k, v, do, lse, delta, causal, scale)
            dq1 = fa._launch_dq(q, k, v, do, lse, delta, causal, scale)
            pairs = (("o", o, o1), ("lse", lse, lse1), ("dq", dq, dq1),
                     ("dk", dk, dk1), ("dv", dv, dv1))
            same = {n: bool(torch.equal(a, b)) for n, a, b in pairs}
            row["equals_flash_bitwise"] = same
            said = f"bitwise equal {same}"
            ok = ok and all(same.values())
            # the same tiles through each body's two sweeps: what the
            # lists cost over the dense sweep, per kernel
            times = {
                "K6": lambda: bs._bs_fwd_cuda(q, k, v, mask, causal,
                                              scale),
                "K1": lambda: fa._flash_cuda(q, k, v, causal, scale),
                "K7": lambda: bs._launch_bs_dkv(q, k, v, do, lse, delta,
                                                mask, causal, scale),
                "K2": lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                             causal, scale),
                "K8": lambda: bs._launch_bs_dq(q, k, v, do, lse, delta,
                                               mask, causal, scale),
                "K3": lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                            causal, scale)}
            row["same_tiles_ms"] = {n: cuda_ms(f, iters=10, reps=4)
                                    for n, f in times.items()}
            said += "; same tiles ms " + ", ".join(
                f"{n} {t:.4f}" for n, t in row["same_tiles_ms"].items())
            row["ok"] = ok
            rows.append(row)
            print(f"K6-K8 vs K1-K3 {label}: {said} "
                  f"{'OK' if ok else 'FAIL'}")
            continue
        big = B * H * T * T >= 1 << 28
        it = dict(iters=3, reps=2) if big else {}
        ms = cuda_ms(lambda: bs._bs_fwd_cuda(q, k, v, mask, causal, scale))
        ms_dkv = cuda_ms(lambda: bs._launch_bs_dkv(q, k, v, do, lse, delta,
                                                   mask, causal, scale))
        ms_dq = cuda_ms(lambda: bs._launch_bs_dq(q, k, v, do, lse, delta,
                                                 mask, causal, scale))
        plain_ms = cuda_ms(lambda: bs._bs_attention_plain(
            q, k, v, mask, causal, scale), **it)
        plain_bwd_ms = cuda_ms(lambda: bs._bs_bwd_plain(
            q, k, v, o, lse, d_o, mask, causal, scale), **it)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep), **it)
        lib_bwd_ms, lib_backend = sdpa_bwd_ms(torch, F, q, k, v, d_o,
                                              attn_mask=keep)
        del keep
        (b_f, by_f), (b_dkv, by_dkv), (b_dq, by_dq) = _bs_bounds(
            B, H, T, D, q.element_size(), live, dname)
        row.update(ok=ok, plain_ms=plain_ms, plain_bwd_ms=plain_bwd_ms,
                   library_ms=lib_ms, library_bwd_ms=lib_bwd_ms,
                   library_backend=lib_backend,
                   fwd=dict(ms=ms, bound_ms=b_f, bound_by=by_f,
                            max_abs_err=max(err["o"], lse_err)),
                   dkv=dict(ms=ms_dkv, bound_ms=b_dkv, bound_by=by_dkv,
                            max_abs_err=max(err["dk"], err["dv"])),
                   dq=dict(ms=ms_dq, bound_ms=b_dq, bound_by=by_dq,
                           max_abs_err=err["dq"]))
        rows.append(row)
        print(f"K6-K8 block_sparse {label:>21} {dname:>8} row err o "
              f"{rel['o']:.3e} dq {rel['dq']:.3e} dk {rel['dk']:.3e} dv "
              f"{rel['dv']:.3e} lse {lse_err:.3e} (tol {tol:g}) chunked "
              f"{chunked} "
              f"| K6 "
              f"{ms:.4f} ms (bound {b_f:.4f}, {by_f}) K7 {ms_dkv:.4f} ms "
              f"(bound {b_dkv:.4f}) K8 {ms_dq:.4f} ms (bound {b_dq:.4f}) "
              f"plain {plain_ms:.4f} / {plain_bwd_ms:.4f} ms sdpa "
              f"{lib_ms:.4f} / bwd {lib_bwd_ms:.4f} ms ({lib_backend}) "
              f"{'OK' if ok else 'FAIL'}")
        del q, k, v, d_o, o, lse, do, delta, dk, dv, dq
        torch.cuda.empty_cache()
    rows += [check_bs_poison(torch, D, dt) for D, dt in (
        (128, torch.bfloat16), (256, torch.bfloat16), (128, torch.float32),
        (256, torch.float32), (320, torch.bfloat16), (320, torch.float32))]
    return rows


def check_bs_poison(torch, D, dt):
    """The skip proof on the card (``tests/test_block_sparse.py``'s, at
    T 1024, block 32, head dim D, dtype ``dt``): NaN in every K/V row that
    no query may attend; O, LSE and the three gradients finite and equal
    to the clean run's bit for bit."""
    import numpy as np

    from bigdl_tpu_torch.ops import block_sparse as bs

    m = np.eye(32, dtype=bool)
    m[:, 0] = True
    m[16, 16] = False     # k block 16 is now read by no query
    mask = bs.BlockMask(m, 32, 32)
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, d_o = (torch.randn(2, 8, 1024, D, device="cuda", generator=g
                                ).to(dt) for _ in range(4))
    dead = ~bs._elementwise_keep(mask, True, "cuda").any(dim=0)
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    runs = []
    for kk, vv in ((k, v), (kp, vp)):
        o, lse = bs._bs_fwd_cuda(q, kk, vv, mask, True, 0.1)
        runs.append((o, lse) + bs._bs_bwd_cuda(q, kk, vv, o, lse, d_o, mask,
                                                True, 0.1))
    torch.cuda.synchronize()
    names = ("o", "lse", "dq", "dk", "dv")
    finite = {n: bool(torch.isfinite(t.float()).all())
              for n, t in zip(names, runs[1])}
    same = {n: bool(torch.equal(a, b))
            for n, a, b in zip(names, runs[1], runs[0])}
    ok = all(finite.values()) and all(same.values())
    dname = str(dt).split(".")[-1]
    print(f"K6-K8 NaN-poisoned dead K/V ({int(dead.sum())} rows of 1024, "
          f"block 32, D {D}, {dname}): finite {finite} equal to the clean "
          f"run {same} {'OK' if ok else 'FAIL'}")
    return dict(case=f"nan_poison_block32_D{D}_{dname}",
                dead_rows=int(dead.sum()), finite=finite,
                equals_clean_bitwise=same, ok=ok)


def mm_cases(torch):
    """(label, M, K, N, block, dtype) for K9: the flagship MLP shape in
    bf16 and f32 (the block route, on split products in f32), the kernel
    lab's shape in f32, ragged M, and on the coarse route (blocks that are
    not multiples of 64) blocks 32 and 16 in both dtypes (timed on the
    block route too) and block 8 in both dtypes."""
    bf16, f32 = torch.bfloat16, torch.float32
    M, K, N = MM_SHAPE
    return [("mlp_bf16", M, K, N, MM_BLOCK, bf16),
            ("mlp_f32", M, K, N, MM_BLOCK, f32),
            ("lab_f32", 64, 1024, 1024, 512, f32),
            ("ragged_M100", 100, K, N, MM_BLOCK, bf16),
            ("block32", 4096, K, K, 32, bf16),
            ("block32_f32", 4096, K, K, 32, f32),
            ("block16", 4096, K, K, 16, bf16),
            ("block16_f32", 4096, K, K, 16, f32),
            ("block8_bf16", 4096, K, K, 8, bf16),
            ("block8_f32", 4096, K, K, 8, f32)]


def mm_inputs(torch, M, K, N, block, dt):
    """x, W, dY and W's magnitude mask, from one seeded generator."""
    from bigdl_tpu_torch.ops import block_sparse as bs

    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(M, K, device="cuda", generator=g).to(dt)
    w = (0.03 * torch.randn(K, N, device="cuda", generator=g)).to(dt)
    gy = torch.randn(M, N, device="cuda", generator=g).to(dt)
    return x, w, gy, bs.magnitude_block_mask(w, block, block, MM_DENSITY)


def mm_boxes(M, K, N, mask, dtype, plan=None):
    """What K9 reads for one call in ``dtype`` on ``plan`` (default: the
    one ``_mm_plan`` gives): KC, BN, and the bytes its TMA boxes request,
    per live step of each 128-row tile and BN-column tile (a KC chunk of a
    live K block on the block route, a coarse tile holding a live element
    on the coarse route): two 64-row x boxes (one where the tile has 64
    rows or fewer; 2 bytes an element in bf16, 4 in f32) and W's box
    (bf16: 2 bytes an element; f32: its three bf16 pieces, 6); x and W
    come from L2 after their first read."""
    import torch

    from bigdl_tpu_torch.ops import block_sparse as bs

    plan = plan or bs._mm_plan(dtype, mask.block_q, mask.block_k, K, N)
    kc, bn_t = plan.kc, plan.bn
    x_item, w_item = (2, 2) if dtype == torch.bfloat16 else (4, 6)
    steps = (int(bs._coarse_grid(mask, kc, bn_t).sum()) if plan.coarse else
             mask.nnz * (mask.block_q // kc) * (mask.block_k // bn_t))
    x_step = -(-M // 64) * 64 * kc * x_item
    w_step = -(-M // 128) * kc * bn_t * w_item
    return dict(kc=kc, bn=bn_t, coarse=plan.coarse,
                tma_bytes=steps * (x_step + w_step))


def _other_plans(bs, dt, block, K, N, plan):
    """For a block that both routes take (a multiple of 16), the route
    ``_mm_plan`` did not pick, for the forward and for dX: (label, plan,
    dX's plan), or None."""
    block_plan = bs._block_plan(dt, block, block)
    if block_plan is None:
        return None
    if plan.coarse:
        return "block", block_plan, block_plan
    return "coarse", bs._coarse_plan(dt, K, N), bs._coarse_plan(dt, N, K)


def check_mm_masked(torch, bs, w, mask, plan, dname):
    """The coarse route's masked copy of W (``bigdl_bs_mm_mask``) against
    its plain version on the same W, bit for bit, with NaN in every dead
    block; its time, the plain version's, ``torch.where`` (the same
    function where no padding is needed, bf16) and its bound: W's live
    elements read once and the padded copy written (2 bytes an element in
    bf16, 6 in f32)."""
    live = bs._elementwise_weight_mask(mask, "cuda")
    poisoned = w.masked_fill(~live, float("nan"))
    got, ldw, kmajor = bs._mm_masked(poisoned, mask, plan)
    want = torch.empty_like(got if got.dim() == 3 else got[None])
    bs._mm_masked_plain(w, mask, want)
    equal = bool(torch.equal(got if got.dim() == 3 else got[None], want))
    ms = cuda_ms(lambda: bs._mm_masked(w, mask, plan))
    dst = torch.empty_like(want)
    plain_ms = cuda_ms(lambda: bs._mm_masked_plain(w, mask, dst))
    K, N = w.shape
    padded = K % plan.kc == 0 and N % plan.bn == 0
    zero = torch.zeros((), dtype=w.dtype, device="cuda")
    lib_ms = (cuda_ms(lambda: torch.where(live, w, zero))
              if dname == "bfloat16" and padded else None)
    nbytes = int(live.sum().item()) * w.element_size() + want.numel() * 2
    b_ms, b_by = bound(nbytes, 0.0, dname)
    return dict(equal_to_plain=equal, max_abs_err=0.0 if equal else math.inf,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, ldw=ldw, kmajor=kmajor)


def check_block_sparse_mm(torch):
    """K9 against ``_bs_mm_plain`` row by row: the forward, and dX = K9 on
    (dY, Wᵀ, maskᵀ) with Wᵀ a view (read in place on the block route, its
    storage copied masked K-major on the coarse route); NaN in every dead
    W tile; the route each took.  Times against ``torch.matmul`` on the
    masked dense W; at blocks 16 and 32 the other route on the same
    inputs too (forward and dX, held to the same limit); the bytes the
    TMA boxes request; on the coarse route the masked copy of W (bit for
    bit its plain version; its time is part of the call's); in f32 the
    bound of six bf16 products an f32 one (the FMA loop's beside it) and,
    on the block route, the time of the wrapper's split of W into its
    pieces, which the kernel's time includes."""
    from bigdl_tpu_torch.ops import block_sparse as bs

    rows = []
    for label, M, K, N, block, dt in mm_cases(torch):
        x, w, gy, mask = mm_inputs(torch, M, K, N, block, dt)
        coarse_before = bs.LAUNCHES_MM_COARSE[dt].count
        y = bs._bs_mm_cuda(x, w, mask)
        torch.cuda.synchronize()
        dx = bs._bs_mm_cuda(gy, w.t(), mask.transposed())
        torch.cuda.synchronize()
        route = ("coarse" if bs.LAUNCHES_MM_COARSE[dt].count > coarse_before
                 else "block")
        dname = str(dt).split(".")[-1]
        tol = ROW_TOL[dname]
        y_ref = bs._bs_mm_plain(x, w, mask)
        dx_ref = bs._bs_mm_plain(gy, w.t(), mask.transposed())
        rel = {"y": row_rel_err(torch, y, y_ref),
               "dx": row_rel_err(torch, dx, dx_ref)}
        err = (y.float() - y_ref.float()).abs().max().item()
        live = bs._elementwise_weight_mask(mask, "cuda")
        poisoned = bs._bs_mm_cuda(x, w.masked_fill(~live, float("nan")),
                                  mask)
        poison_ok = bool(torch.isfinite(poisoned.float()).all()) and bool(
            torch.equal(poisoned, y))
        # the route _mm_plan gives the case's blocks
        plan = bs._mm_plan(dt, block, block, K, N)
        want_route = "coarse" if plan.coarse else "block"
        ok = max(rel.values()) <= tol and poison_ok and route == want_route
        w_dense = torch.where(live, w, torch.zeros((), dtype=dt,
                                                   device="cuda"))
        ms = cuda_ms(lambda: bs._bs_mm_cuda(x, w, mask))
        dx_ms = cuda_ms(lambda: bs._bs_mm_cuda(gy, w.t(), mask.transposed()))
        plain_ms = cuda_ms(lambda: bs._bs_mm_plain(x, w, mask))
        lib_ms = cuda_ms(lambda: torch.matmul(x, w_dense))
        item = x.element_size()
        nnz = mask.nnz * mask.block_q * mask.block_k
        rate = "float32_split_mm" if dname == "float32" else dname
        nbytes, flops = item * (M * K + nnz + M * N), 2.0 * M * nnz
        b_ms, b_by = bound(nbytes, flops, rate)
        row = dict(case=label, shape=[M, K, N], block=block, dtype=dname,
                   route=route, density=mask.density, row_rel_err=rel,
                   max_abs_err=err, tol=tol, nan_poison_ok=poison_ok,
                   ms=ms, dx_ms=dx_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, bound_rate=rate,
                   boxes=mm_boxes(M, K, N, mask, dt),
                   boxes_dx=mm_boxes(M, N, K, mask.transposed(), dt))
        extra = (f" KC {row['boxes']['kc']} BN {row['boxes']['bn']}, TMA "
                 f"boxes {row['boxes']['tma_bytes'] / 1e6:.1f} MB "
                 f"({row['boxes']['tma_bytes'] / ms / 1e9:.2f} TB/s), dX "
                 f"{row['boxes_dx']['tma_bytes'] / 1e6:.1f} MB "
                 f"({row['boxes_dx']['tma_bytes'] / dx_ms / 1e9:.2f} TB/s)")
        other = _other_plans(bs, dt, block, K, N, plan)
        if other is not None:
            name, o_plan, o_dx_plan = other
            o_rel = max(
                row_rel_err(torch, bs._launch_mm(x, w, mask, o_plan), y_ref),
                row_rel_err(torch, bs._launch_mm(
                    gy, w.t(), mask.transposed(), o_dx_plan), dx_ref))
            row["other_route"] = dict(
                route=name, kc=o_plan.kc, bn=o_plan.bn, row_rel_err=o_rel,
                ms=cuda_ms(lambda: bs._launch_mm(x, w, mask, o_plan)),
                dx_ms=cuda_ms(lambda: bs._launch_mm(
                    gy, w.t(), mask.transposed(), o_dx_plan)),
                boxes=mm_boxes(M, K, N, mask, dt, o_plan))
            ok = ok and o_rel <= tol
            o = row["other_route"]
            extra += (f"; the {name} route (KC {o['kc']} BN {o['bn']}) "
                      f"{o['ms']:.4f} ms, dX {o['dx_ms']:.4f}, row err "
                      f"{o_rel:.3e}")
        if route == "coarse":
            row["masked_w"] = check_mm_masked(torch, bs, w, mask, plan, dname)
            m = row["masked_w"]
            ok = ok and m["equal_to_plain"]
            extra += (f"; masked copy of W {m['ms']:.4f} ms (in the call; "
                      f"plain {m['plain_ms']:.4f}, bound {m['bound_ms']:.4f},"
                      f" equal to plain: {m['equal_to_plain']})")
        if dname == "float32":
            row["fma_bound_ms"] = bound(nbytes, flops, "float32")[0]
            extra += f"; FMA bound {row['fma_bound_ms']:.4f} ms"
            if route == "block":
                row["split_w_ms"] = cuda_ms(lambda: bs._mm_pieces(w))
                extra += f", W's split {row['split_w_ms']:.4f} ms"
        row["ok"] = ok
        rows.append(row)
        print(f"K9 block_sparse_mm {label:>12} {dname:>8} {route:>6} route "
              f"row err y {rel['y']:.3e} dx {rel['dx']:.3e} (tol {tol:g}) "
              f"NaN in dead tiles ignored: {poison_ok} | kernel {ms:.4f} ms "
              f"(dX {dx_ms:.4f}) plain {plain_ms:.4f} ms "
              f"matmul(x, W*mask) {lib_ms:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by});{extra} (want the {want_route} route) "
              f"{'OK' if ok else 'FAIL'}")
        del x, w, gy, y, dx, poisoned, w_dense, y_ref, dx_ref
        torch.cuda.empty_cache()
    return rows


def conv_cases(torch):
    """(label, B, H, W, C, O, dtype) for K5: ResNet-50's four stage shapes
    at B 64 (the 13 3x3 stride-1 convs of a step) in both types,
    ResNet-CIFAR's first width (C = O = 16 at 32 x 32, B 128) and a
    ragged case (C 3, O 10, H 7, W 5) in both types."""
    bf16, f32 = torch.bfloat16, torch.float32
    stages = [("stage1", 64, 56, 56, 64, 64), ("stage2", 64, 28, 28, 128, 128),
              ("stage3", 64, 14, 14, 256, 256), ("stage4", 64, 7, 7, 512, 512)]
    return ([(*st, bf16) for st in stages]
            + [(st[0] + "_f32", *st[1:], f32) for st in stages]
            + [("cifar16", 128, 32, 32, 16, 16, bf16),
               ("ragged", 2, 7, 5, 3, 10, bf16),
               ("ragged_f32", 2, 7, 5, 3, 10, f32)])


def conv_boxes(B, H, W, C, O, dtype):
    """What K5 reads for one call at these widths in ``dtype`` (its plan
    from ``bigdl_conv3x3_plan``): its pixel box (TN, TH, TW), KC and BN,
    the share of its rows that lie outside the images, and the bytes its
    TMA boxes request: nine taps of each pixel box per chunk of KC
    channels and per BN output channels (bf16, or f32 for the split
    kernel), and each block's weight boxes (bf16; three pieces in f32),
    which come from L2 where x and the weights fit."""
    import ctypes

    import torch

    from bigdl_tpu_torch.ops import _support, conv3x3

    fn = _support.load_cuda_library("conv3x3").bigdl_conv3x3_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c = conv3x3._padded_channels(C, dtype)
    f32 = dtype == torch.float32
    plan = (ctypes.c_int * 5)()
    n_boxes = fn(B, H, W, c, O, int(not f32), plan)
    tn, th, tw, kc, bn = plan
    steps = 9 * -(-c // kc)
    tiles_o = -(-O // bn)
    a = n_boxes * tiles_o * steps * tn * th * tw * kc * (4 if f32 else 2)
    b = -(-n_boxes // 2) * tiles_o * steps * bn * kc * (6 if f32 else 2)
    return dict(box=[tn, th, tw], n_boxes=n_boxes, kc=kc, bn=bn,
                dead_rows=1.0 - B * H * W / (n_boxes * 64),
                tma_bytes=a + b)


def check_conv3x3(torch, F):
    """K5 against ``_conv3x3_plain`` at ``conv_cases`` (phase 3)."""
    return [conv3x3_row(torch, F, *case) for case in conv_cases(torch)]


def conv3x3_row(torch, F, label, B, H, W, C, O, dt, iters=20, reps=5,
                call=True):
    """K5 against ``_conv3x3_plain``, forward and dX (K5 on the flipped,
    in/out-transposed weights), row by row over output pixels.  Times:
    each launch alone on the operands the wrapper hands it (graph
    replay, ``iters`` calls ``reps`` times), with ``call`` the wrapper's
    whole forward call (in f32 with its split of the weights into bf16
    pieces), the plain forward, and the library yardsticks:
    ``F.conv2d`` on channels-last tensors for the forward,
    ``torch.nn.grad.conv2d_input`` for dX (TF32 off)."""
    from bigdl_tpu_torch.ops import conv3x3
    from bigdl_tpu_torch.utils.api_cases import conv3x3_yardstick

    g = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dt)
    w = (torch.randn(3, 3, C, O, device="cuda", generator=g)
         / (3 * math.sqrt(C))).to(dt)
    gy = torch.randn(B, H, W, O, device="cuda", generator=g).to(dt)
    wk = w.permute(0, 1, 3, 2).contiguous()       # (tap, out, in)
    wk_dx = w.flip(0, 1).contiguous()             # the dX conv's
    y = conv3x3._conv3x3_cuda(x, wk)
    dx = conv3x3._conv3x3_cuda(gy, wk_dx)
    torch.cuda.synchronize()
    w_dx = w.flip(0, 1).transpose(2, 3)
    y_ref = conv3x3_yardstick(x, w)
    dx_ref = conv3x3_yardstick(gy, w_dx)
    dname = str(dt).split(".")[-1]
    tol = ROW_TOL[dname]
    rel = {"y": row_rel_err(torch, y, y_ref),
           "dx": row_rel_err(torch, dx, dx_ref)}
    # where the yardstick is the f32 sum, the reading against the plain
    # version's own bf16 output beside it (not held)
    rounded = {k: row_rel_err(torch, got, conv3x3._conv3x3_plain(a, b))
               for k, got, ref, a, b in (("y", y, y_ref, x, w),
                                         ("dx", dx, dx_ref, gy, w_dx))
               if ref.dtype != got.dtype}
    err = max((y.float() - y_ref.float()).abs().max().item(),
              (dx.float() - dx_ref.float()).abs().max().item())
    finite = bool(torch.isfinite(y.float()).all()) and bool(
        torch.isfinite(dx.float()).all())
    ok = finite and max(rel.values()) <= tol
    del y_ref, dx_ref

    def operands(a, k):
        # what _conv3x3_cuda hands the kernel: x padded where TMA
        # needs it, the f32 weights as their bf16 pieces
        a, k = conv3x3._pad_channels(a, k)
        if a.dtype == torch.float32:
            k = conv3x3._weight_pieces(k, -(-a.shape[-1] // 8) * 8)
        return a, k, torch.empty(a.shape[:3] + (k.shape[2],),
                                 dtype=a.dtype, device="cuda")

    timing = dict(iters=iters, reps=reps)
    launch_args = operands(x, wk)
    ms = cuda_ms(lambda: conv3x3._launch(*launch_args), **timing)
    launch_args = operands(gy, wk_dx)
    dx_ms = cuda_ms(lambda: conv3x3._launch(*launch_args), **timing)
    del launch_args
    call_ms = (cuda_ms(lambda: conv3x3._conv3x3_cuda(x, wk), **timing)
               if call else None)
    plain_ms = cuda_ms(lambda: conv3x3._conv3x3_plain(x, w),
                       iters=min(iters, 5), reps=min(reps, 3))
    # the library on the same NHWC memory: NCHW-shaped channels-last
    x_cl, gy_cl = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    w_cl = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    lib_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, padding=1), **timing)
    lib_dx_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input(
        x_cl.shape, w_cl, gy_cl, padding=1), **timing)
    item = x.element_size()
    # the f32 K5 forms its product from six bf16 products on the
    # tensor cores
    b_ms, b_by = bound(item * (B * H * W * (C + O) + 9 * C * O),
                       2.0 * 9 * B * H * W * C * O,
                       "float32_split_conv" if dname == "float32"
                       else dname)
    cb = conv_boxes(B, H, W, C, O, dt)
    row = dict(case=label, shape=[B, H, W, C, O], dtype=dname,
               row_rel_err=rel, max_abs_err=err, tol=tol, ok=ok,
               rounded_row_rel_err=rounded, ms=ms, dx_ms=dx_ms,
               call_ms=call_ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_dx_ms=lib_dx_ms, bound_ms=b_ms,
               bound_by=b_by, boxes=cb)
    call_txt = f"; the wrapper's call {call_ms:.4f}" if call else ""
    vs_rounded = "".join(f", {k} {v:.3e}" for k, v in rounded.items())
    if vs_rounded:
        vs_rounded = (f" (vs the plain version's bf16 output"
                      f"{vs_rounded[1:]}: not held)")
    print(f"K5 conv3x3 {label:>10} {dname:>8} {B}x{H}x{W}x{C}->{O} row "
          f"err y {rel['y']:.3e} dx {rel['dx']:.3e} (tol {tol:g})"
          f"{vs_rounded} | "
          f"kernel {ms:.4f} ms (dX {dx_ms:.4f}{call_txt}) plain "
          f"{plain_ms:.4f} ms "
          f"F.conv2d {lib_ms:.4f} ms conv2d_input {lib_dx_ms:.4f} ms "
          f"bound {b_ms:.4f} ms ({b_by}; kernel / bound "
          f"{ms / b_ms:.2f}, / F.conv2d {ms / lib_ms:.2f}) "
          f"{'OK' if ok else 'FAIL'} | box {cb['box']} x "
          f"{cb['n_boxes']}, KC {cb['kc']} BN {cb['bn']}, dead rows "
          f"{cb['dead_rows']:.3f}, TMA boxes "
          f"{cb['tma_bytes'] / 1e6:.1f} MB "
          f"({cb['tma_bytes'] / ms / 1e9:.2f} TB/s)")
    del x, w, gy, wk, wk_dx, y, dx, x_cl, gy_cl, w_cl
    torch.cuda.empty_cache()
    return row


def serve_flagship(torch):
    """Phase 4: the port's InferenceServer at full flagship width."""
    import numpy as np

    from bigdl_tpu_torch.models.generate import cached_generate, last_logits
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import layer_norm as ln
    from bigdl_tpu_torch.serving import InferenceServer, Status

    cfg = FLAGSHIP
    V, L = cfg["vocab"], cfg["num_layers"]
    counters = launch_counters()

    def build(device):
        return TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                             num_heads=cfg["num_heads"], num_layers=L,
                             max_len=cfg["max_len"], device=device,
                             generator=torch.Generator().manual_seed(0))

    t0 = time.perf_counter()
    model = build("cuda")
    build_s = time.perf_counter() - t0
    server = InferenceServer(model, max_batch=BATCH,
                             generate_dtype=torch.bfloat16).start()
    rng = np.random.RandomState(0)
    batches, failures = [], []
    prompts_by_len = {}
    try:
        for T0 in PROMPT_LENS:
            prompts = rng.randint(1, V + 1, size=(BATCH, T0)).astype(np.int32)
            prompts_by_len[T0] = prompts
            for c in counters.values():
                c.reset()
            futs = [server.submit_generate(p, MAX_NEW) for p in prompts]
            results = [f.result(timeout=600) for f in futs]
            n_flash, n_ln = fa.LAUNCHES.count, ln.LAUNCHES.count
            n_bwd = fa.LAUNCHES_DKV.count + fa.LAUNCHES_DQ.count
            statuses = [r.status.value for r in results]
            outs = [np.asarray(r.output) for r in results
                    if r.status is Status.OK]
            ids_ok = len(outs) == BATCH and all(
                o.shape == (MAX_NEW,) and o.min() >= 1 and o.max() <= V
                for o in outs)
            want_ln = (2 * L + 1) * MAX_NEW
            batch = dict(prompt_len=T0, statuses=statuses,
                         launches={n: c.count for n, c in counters.items()},
                         latency_s=[r.latency_s for r in results],
                         first_ids=[o[:8].tolist() for o in outs])
            batches.append(batch)
            print(f"main path: prompt {T0}: statuses {statuses} flash "
                  f"{n_flash} (want {L}) layer_norm {n_ln} (want {want_ln}) "
                  f"latency {max(batch['latency_s']):.3f} s")
            if statuses != ["ok"] * BATCH:
                failures.append(f"prompt {T0}: statuses {statuses} "
                                f"{[r.error for r in results]}")
            if not ids_ok:
                failures.append(f"prompt {T0}: generated ids out of 1..{V}")
            if batch["launches"] != want_launches(flash_fwd=L,
                                                  layer_norm_fwd=want_ln):
                failures.append(f"prompt {T0}: launches {batch['launches']}"
                                f", want flash {L}, ln {want_ln}, no other")
    finally:
        server.stop(timeout=60)

    # end-to-end timing of the served generator (the server's path):
    # prefill + first token alone, then the full 32-token generate
    gen = cached_generate(model, compute_dtype=torch.bfloat16)
    params = model.param_tree()
    timing = {}
    for T0, prompts in prompts_by_len.items():
        def run(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen(params, prompts, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run(MAX_NEW)  # warm
        prefill_s = min(run(1) for _ in range(3))
        full_s = min(run(MAX_NEW) for _ in range(3))
        tps = BATCH * (MAX_NEW - 1) / (full_s - prefill_s)
        timing[T0] = dict(prefill_s=prefill_s, generate_s=full_s,
                          decode_tokens_per_s=tps)
        print(f"main path: prompt {T0}: prefill+first token "
              f"{prefill_s * 1e3:.2f} ms, generate {full_s * 1e3:.2f} ms, "
              f"decode {tps:.1f} tokens/s (batch {BATCH})")

    # the last-prompt-position logits of one prompt: bf16 on the card vs
    # the same port model (same seed) in f32 on the CPU
    prompt = prompts_by_len[PROMPT_LENS[1]][:1]
    got = last_logits(model, prompt, compute_dtype=torch.bfloat16).cpu()
    ref_model = build("cpu")
    ref = last_logits(ref_model, prompt)
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    same_top1 = int(got.argmax()) == int(ref.argmax())
    print(f"main path: last-position logits bf16/cuda vs f32/cpu: max abs "
          f"err {err:.4e} ({rel:.3e} of max |logit|, tol {LOGITS_REL_TOL}); "
          f"top-1 agrees: {same_top1}")
    if not rel <= LOGITS_REL_TOL:
        failures.append(f"logits vs f32 CPU reference: rel err {rel:.3e}")
    return dict(model_build_s=build_s, batches=batches, timing=timing,
                logits_max_abs_err=err, logits_rel_err=rel,
                logits_top1_agrees=same_top1), failures


def _flagship(torch, device):
    """Phase 4's model: the flagship in f32 from ``manual_seed(0)``."""
    from bigdl_tpu_torch.models.transformer import TransformerLM

    cfg = FLAGSHIP
    return TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                         num_heads=cfg["num_heads"],
                         num_layers=cfg["num_layers"],
                         max_len=cfg["max_len"], device=device,
                         generator=torch.Generator().manual_seed(0))


def serve_paged(torch):
    """Phase 9: paged serving at full flagship width in bf16, phase 4's
    four 512-token prompts, 32 new tokens, page size 16 — (a) the dense
    paged server, (b) the windowed one (K6 prefill), (c) prefill and
    decode roles across a handoff, (d) pool exhaustion, (e) beam search,
    (f) the int8 KV cache.  Returns (record, failures); the record's
    ``launches`` are those of (a), (b) and (f)'s checked runs, each read
    from zero."""
    import numpy as np

    from bigdl_tpu_torch.models import generate as tgen
    from bigdl_tpu_torch.serving import InferenceServer, KVPagePool, Status
    from bigdl_tpu_torch.serving.pools import (deserialize_handoff,
                                               serialize_handoff)

    bf16, f32 = torch.bfloat16, torch.float32
    V, L = FLAGSHIP["vocab"], FLAGSHIP["num_layers"]
    T0, n_req = PROMPT_LENS[0], BATCH
    per_ln = (2 * L + 1) * MAX_NEW
    counters = launch_counters()
    failures, rec = [], {}
    total = {n: 0 for n in counters}

    def count_from_zero():
        for c in counters.values():
            c.reset()

    def read_counts():
        got = {n: c.count for n, c in counters.items()}
        for n, c in got.items():
            total[n] += c
        return got

    def check(ok, what):
        if not ok:
            failures.append(f"phase 9 {what}")
        return ok

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    model = _flagship(torch, "cuda")
    params = model.param_tree()
    prompts = np.random.RandomState(0).randint(
        1, V + 1, size=(n_req, T0)).astype(np.int32)     # phase 4's
    short = np.random.RandomState(9).randint(1, V + 1, 96).astype(np.int32)
    gen = tgen.cached_generate(model, compute_dtype=bf16)
    want = [gen(params, p[None], MAX_NEW).cpu().numpy()[0, T0:]
            for p in prompts]
    pool = KVPagePool.for_model(model, PAGED_POOL_PAGES, PAGE_SIZE,
                                dtype=bf16)
    rec["pool"] = dict(num_pages=pool.num_pages, page_size=pool.page_size,
                       arena_bytes=pool.arena_bytes())

    def serve(label, **kw):
        """The four prompts submitted together, then the 96-token one;
        the server's timings and the direct prefill's."""
        server = InferenceServer(model, kv_pool=pool, max_batch=n_req,
                                 generate_dtype=bf16, **kw).start()
        try:
            count_from_zero()
            t = time.perf_counter()
            results = [f.result(timeout=600) for f in
                       [server.submit_generate(p, MAX_NEW) for p in prompts]]
            wall = time.perf_counter() - t
            launches = read_counts()
            snap = server.metrics.snapshot()
            extra = server.submit_generate(short, MAX_NEW).result(timeout=600)
        finally:
            server.stop(timeout=60)
        dec = tgen.cached_paged_decoder(
            model, pool, compute_dtype=bf16,
            page_window=kw.get("kv_page_window"))

        def first():
            seq = dec.start(params, prompts[0])
            seq.release()

        prefill_s = min(synced(first)[1] for _ in range(3))
        outs = [np.asarray(r.output) for r in results if r.ok]
        row = dict(statuses=[r.status.value for r in results],
                   launches=launches, wall_s=wall,
                   latency_s=[r.latency_s for r in results],
                   prefill_first_token_ms=prefill_s * 1e3,
                   ttft_p50_s=snap["ttft_p50_s"],
                   tpot_p50_s=snap["tpot_p50_s"],
                   decode_tokens_per_s=n_req / snap["tpot_p50_s"],
                   short_status=extra.status.value,
                   free_pages=pool.free_pages)
        print(f"paged {label}: statuses {row['statuses']} launches "
              f"flash {launches['flash_fwd']} block_sparse "
              f"{launches['block_sparse_fwd']} layer_norm "
              f"{launches['layer_norm_fwd']} | prefill+first token "
              f"{row['prefill_first_token_ms']:.2f} ms (B 1), ttft p50 "
              f"{snap['ttft_p50_s'] * 1e3:.2f} ms, loop of {n_req}: tpot "
              f"p50 {snap['tpot_p50_s'] * 1e3:.2f} ms, decode "
              f"{row['decode_tokens_per_s']:.1f} tokens/s, latency "
              f"{max(row['latency_s']):.3f} s, free pages {pool.free_pages}")
        check(row["statuses"] == ["ok"] * n_req,
              f"{label}: statuses {row['statuses']} "
              f"{[r.error for r in results]}")
        check(len(outs) == n_req and all(
            o.shape == (MAX_NEW,) and o.min() >= 1 and o.max() <= V
            for o in outs), f"{label}: ids out of 1..{V}")
        check(extra.ok, f"{label}: the 96-token prompt: {extra.error}")
        check(pool.free_pages == pool.num_pages,
              f"{label}: {pool.free_pages} of {pool.num_pages} pages free")
        return row, outs, np.asarray(extra.output)

    # (a) the dense paged server: the unpaged stream, token for token
    rec["dense"], dense_outs, dense_short = serve("dense")
    same = [bool(np.array_equal(o, w)) for o, w in zip(dense_outs, want)]
    rec["dense"]["equals_unpaged"] = same
    print(f"paged dense: each stream equals cached_generate's (B 1): {same}")
    check(all(same) and len(same) == n_req,
          f"dense: streams equal the unpaged ones: {same}")
    check(rec["dense"]["launches"] == want_launches(
        flash_fwd=L * n_req, layer_norm_fwd=per_ln * n_req),
        f"dense: launches {rec['dense']['launches']}, want flash "
        f"{L * n_req}, ln {per_ln * n_req}, no other")

    # (b) the windowed server: K6 prefill at block 16 over 32 x 32 pages
    rec["windowed"], _, win_short = serve(
        "windowed", kv_page_window=PAGE_WINDOW, kv_page_globals=1)
    rec["windowed"]["short_equals_dense"] = bool(
        np.array_equal(win_short, dense_short))
    check(rec["windowed"]["short_equals_dense"],
          "windowed: the 96-token stream differs from the dense one")
    check(rec["windowed"]["launches"] == want_launches(
        block_sparse_fwd=L * n_req, layer_norm_fwd=per_ln * n_req),
        f"windowed: launches {rec['windowed']['launches']}, want "
        f"block_sparse {L * n_req}, ln {per_ln * n_req}, no other")
    rec["page16_k6_launches"] = rec["windowed"]["launches"][
        "block_sparse_fwd"]
    n_pages = T0 // PAGE_SIZE
    arena = (n_pages, L, FLAGSHIP["num_heads"], PAGE_SIZE,
             FLAGSHIP["embed_dim"] // FLAGSHIP["num_heads"])
    logits = []
    for m, dt in ((model, bf16), (_flagship(torch, "cpu"), f32)):
        prefill, _ = tgen._paged_machinery(m, 1, L, PAGE_SIZE,
                                           page_window=PAGE_WINDOW,
                                           page_globals=1)
        with torch.no_grad():
            logits.append(prefill(
                tgen._cast_floats(m.param_tree(), dt),
                torch.as_tensor(prompts[:1], device=m.device),
                torch.arange(n_pages, device=m.device),
                torch.zeros(arena, dtype=dt, device=m.device),
                torch.zeros(arena, dtype=dt, device=m.device)).cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    rel = err / logits[1].abs().max().item()
    rec["windowed"].update(logits_max_abs_err=err, logits_rel_err=rel)
    print(f"paged windowed: K6 launches {rec['page16_k6_launches']}; "
          f"last-position logits bf16/cuda vs f32/cpu (the windowed paged "
          f"prefill): max abs err {err:.4e} ({rel:.3e} of max |logit|, tol "
          f"{LOGITS_REL_TOL}); 96-token stream equals the dense one: "
          f"{rec['windowed']['short_equals_dense']}")
    check(rel <= LOGITS_REL_TOL, f"windowed: logits rel err {rel:.3e}")

    # (c) prefill and decode roles across the crc-sealed handoff
    pools = [KVPagePool.for_model(model, PAGED_POOL_PAGES, PAGE_SIZE,
                                  dtype=bf16) for _ in range(2)]
    pre, dec = (InferenceServer(model, kv_pool=p, role=r,
                                generate_dtype=bf16).start()
                for p, r in zip(pools, ("prefill", "decode")))
    try:
        t = time.perf_counter()
        blobs = [f.result(timeout=600) for f in
                 [pre.submit_prefill(p) for p in prompts[:2]]]
        prefill_wall = time.perf_counter() - t
        t = time.perf_counter()
        got = [f.result(timeout=600) for f in
               [dec.submit_decode(b.output, MAX_NEW) for b in blobs]]
        decode_wall = time.perf_counter() - t
        small = pre.submit_prefill(short).result(timeout=600)
        bad = bytearray(small.output)
        bad[len(bad) // 2] ^= 0x40
        refused = dec.submit_decode(bytes(bad), MAX_NEW).result(timeout=600)
    finally:
        pre.stop(timeout=60)
        dec.stop(timeout=60)
    check(all(b.ok for b in blobs + got + [small]),
          f"roles: statuses {[r.status.value for r in blobs + got]}")
    t = time.perf_counter()
    heads = [deserialize_handoff(b.output) for b in blobs]
    verify_s = (time.perf_counter() - t) / len(blobs)
    h = heads[0]
    t = time.perf_counter()
    resealed = serialize_handoff(h["k_pages"], h["v_pages"],
                                 h["first_token"], h["pos"], h["page_size"],
                                 extras={"kv_dtype": h["kv_dtype"]})
    seal_s = time.perf_counter() - t
    streams = [np.concatenate([[hd["first_token"]], g.output])
               for hd, g in zip(heads, got)]
    same = [bool(np.array_equal(s_, o)) for s_, o in zip(streams,
                                                         dense_outs)]
    rec["roles"] = dict(
        blob_bytes=[len(b.output) for b in blobs], seal_s=seal_s,
        verify_s=verify_s, resealed_equal=resealed == blobs[0].output,
        prefill_latency_s=[b.latency_s for b in blobs],
        decode_latency_s=[g.latency_s for g in got],
        prefill_wall_s=prefill_wall, decode_wall_s=decode_wall,
        decode_tokens_per_s=2 * (MAX_NEW - 1) / decode_wall,
        equals_dense=same, corrupt_status=refused.status.value,
        corrupt_error=refused.error,
        free_pages=[p.free_pages for p in pools])
    print(f"paged roles: blob {len(blobs[0].output)} bytes, seal "
          f"{seal_s:.4f} s, verify {verify_s:.4f} s (native crc32c), "
          f"latency of prefill + seal {max(rec['roles']['prefill_latency_s']):.3f}"
          f" s, of verify + decode {max(rec['roles']['decode_latency_s']):.3f} s "
          f"({rec['roles']['decode_tokens_per_s']:.1f} tokens/s for 2); "
          f"first + rest equal (a): {same}; flipped byte: "
          f"{refused.status.value}; free pages "
          f"{rec['roles']['free_pages']}")
    check(all(same) and len(same) == 2, f"roles: streams equal (a): {same}")
    check(rec["roles"]["resealed_equal"], "roles: resealed blob differs")
    check(refused.status is Status.INTERNAL_ERROR
          and "crc32c" in (refused.error or ""),
          f"roles: flipped byte gave {refused.status.value}")
    check(all(p.free_pages == p.num_pages for p in pools),
          f"roles: free pages {rec['roles']['free_pages']}")

    # (d) exhaustion: 40 pages hold one 512-token request, not two
    small_pool = KVPagePool.for_model(model, EXHAUST_PAGES, PAGE_SIZE,
                                      dtype=bf16)
    server = InferenceServer(model, kv_pool=small_pool, max_batch=2,
                             batch_window_s=0.05,
                             generate_dtype=bf16).start()
    try:
        first_two = [f.result(timeout=600) for f in
                     [server.submit_generate(p, MAX_NEW)
                      for p in prompts[:2]]]
        again = server.submit_generate(prompts[1], MAX_NEW).result(
            timeout=600)
    finally:
        server.stop(timeout=60)
    statuses = sorted(r.status.value for r in first_two)
    rec["exhaustion"] = dict(statuses=statuses, again=again.status.value,
                             exhaustions=small_pool.exhaustions,
                             free_pages=small_pool.free_pages,
                             latency_s=[r.latency_s for r in first_two],
                             again_latency_s=again.latency_s)
    print(f"paged exhaustion ({EXHAUST_PAGES} pages): {statuses} (latency "
          f"{[round(r.latency_s, 3) for r in first_two]} s), then "
          f"{again.status.value} ({again.latency_s:.3f} s); free pages "
          f"{small_pool.free_pages}")
    check(statuses == ["ok", "overloaded"] and again.ok
          and small_pool.free_pages == small_pool.num_pages,
          f"exhaustion: {rec['exhaustion']}")

    # (e) beam search: bf16 B 2 x 4 beams; 1 beam = greedy; f32 scores
    beam = tgen.make_beam_search(model, compute_dtype=bf16)
    ids, scores = beam(params, prompts[:2], MAX_NEW, num_beams=BEAMS)
    ids = ids.cpu().numpy()
    _, beam_prefill = synced(lambda: beam(params, prompts[:2], 1,
                                          num_beams=BEAMS))
    _, beam_full = synced(lambda: beam(params, prompts[:2], MAX_NEW,
                                       num_beams=BEAMS))
    greedy = tgen.make_generate(model, compute_dtype=bf16)(
        params, prompts[:2], MAX_NEW).cpu().numpy()
    one, _ = beam(params, prompts[:2], MAX_NEW, num_beams=1)
    one_equal = bool(np.array_equal(one.cpu().numpy(), greedy))
    beam32 = tgen.make_beam_search(model)
    p128 = prompts[2:3, :BEAM_F32_PROMPT]
    f_ids, f_score = beam32(params, p128, BEAM_F32_NEW, num_beams=BEAMS)
    with torch.no_grad():
        lp = model(f_ids[:, :-1].long())
    picked = torch.gather(lp[:, BEAM_F32_PROMPT - 1:], -1,
                          f_ids[:, BEAM_F32_PROMPT:, None].long() - 1)
    rescored = picked.sum().item()
    score_rel = abs(rescored - f_score.item()) / abs(rescored)
    rec["beam"] = dict(
        ids_in_vocab=bool(ids[:, T0:].min() >= 1 and ids.max() <= V),
        scores=scores.tolist(), finite=bool(torch.isfinite(scores).all()),
        one_beam_equals_greedy=one_equal,
        prefill_first_token_ms=beam_prefill * 1e3,
        generate_ms=beam_full * 1e3,
        decode_tokens_per_s=2 * (MAX_NEW - 1) / (beam_full - beam_prefill),
        f32_score=f_score.item(), f32_rescored=rescored,
        f32_score_rel_err=score_rel)
    print(f"paged beam: bf16 B 2 x {BEAMS} beams: scores "
          f"{[round(x, 3) for x in scores.tolist()]}, prefill+first token "
          f"{beam_prefill * 1e3:.2f} ms, generate {beam_full * 1e3:.2f} ms, "
          f"decode {rec['beam']['decode_tokens_per_s']:.1f} tokens/s; "
          f"1 beam = greedy: {one_equal}; f32 score {f_score.item():.5f} vs "
          f"rescored {rescored:.5f} (rel {score_rel:.2e}, tol "
          f"{BEAM_SCORE_REL_TOL})")
    check(rec["beam"]["ids_in_vocab"] and rec["beam"]["finite"],
          f"beam: ids or scores {rec['beam']}")
    check(one_equal, "beam: 1 beam differs from greedy")
    check(score_rel <= BEAM_SCORE_REL_TOL, f"beam: f32 score rel {score_rel}")

    # (f) the int8 KV cache
    q8 = tgen.make_generate(model, compute_dtype=bf16, kv_dtype="int8")
    full = gen(params, prompts, MAX_NEW).cpu().numpy()
    count_from_zero()
    out8 = q8(params, prompts, MAX_NEW).cpu().numpy()
    launches = read_counts()
    _, q8_prefill = synced(lambda: q8(params, prompts, 1))
    _, q8_full = synced(lambda: q8(params, prompts, MAX_NEW))
    agree = float((out8[:, T0:] == full[:, T0:]).mean())
    rec["int8"] = dict(
        launches=launches, agree_share=agree,
        first_token_equal=bool((out8[:, T0] == full[:, T0]).all()),
        ids_in_vocab=bool(out8.min() >= 1 and out8.max() <= V),
        prefill_first_token_ms=q8_prefill * 1e3, generate_ms=q8_full * 1e3,
        decode_tokens_per_s=n_req * (MAX_NEW - 1) / (q8_full - q8_prefill))
    print(f"paged int8: first tokens equal bf16's: "
          f"{rec['int8']['first_token_equal']}, share of tokens equal "
          f"{agree:.4f}, launches flash {launches['flash_fwd']} layer_norm "
          f"{launches['layer_norm_fwd']}; prefill+first token "
          f"{q8_prefill * 1e3:.2f} ms, generate {q8_full * 1e3:.2f} ms, decode "
          f"{rec['int8']['decode_tokens_per_s']:.1f} tokens/s (batch {n_req})")
    check(rec["int8"]["first_token_equal"] and rec["int8"]["ids_in_vocab"],
          f"int8: {rec['int8']}")
    check(launches == want_launches(flash_fwd=L, layer_norm_fwd=per_ln),
          f"int8: launches {launches}, want flash {L}, ln {per_ln}")
    rec["launches"] = total
    del model, pool, pools, small_pool
    torch.cuda.empty_cache()
    return rec, failures


def _lm(torch, device, num_layers, max_len=None, seq_strategy="flash",
        blocksparse=None, seed=0, dropout=0.0, remat=False):
    from bigdl_tpu_torch.models.transformer import TransformerLM

    cfg = FLAGSHIP
    return TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                         num_heads=cfg["num_heads"], num_layers=num_layers,
                         max_len=max_len or cfg["max_len"],
                         seq_strategy=seq_strategy, blocksparse=blocksparse,
                         output="logits", dropout=dropout, remat=remat,
                         device=device,
                         generator=torch.Generator().manual_seed(seed))


def _lm_data(B: int, T: int):
    """B samples of T int32 ids in 1..V, inputs then targets, from
    ``numpy.random.RandomState(0)``."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample, array

    V = FLAGSHIP["vocab"]
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    return array([Sample(a, b) for a, b in zip(x, y)])


def make_trainer(torch, model, B, T, iters, compute_dtype, on_check=None,
                 data=None, crit=None, method=None):
    """The port's LocalOptimizer over one batch of B samples, SGD at
    ``TRAIN_LR`` (or ``method``), stopping after ``iters`` iterations;
    ``on_check(state)`` runs each time the loop evaluates its end trigger
    (before the first iteration and after each).  The samples and the
    criterion are the flagship's (B sequences of T ids) unless ``data``
    and ``crit`` are given."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    def check(state):
        if on_check is not None:
            on_check(state)
        return state["neval"] > iters

    if crit is None:
        crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    if data is None:
        data = _lm_data(B, T)
    opt = LocalOptimizer(model, data, crit, batch_size=B)
    opt.set_optim_method(method if method is not None else SGD(TRAIN_LR))
    opt.set_end_when(Trigger(check))
    if compute_dtype is not None:
        opt.set_compute_dtype(compute_dtype)
    return opt


def run_training(torch, model, B, T, iters, compute_dtype, updates=False,
                 data=None, crit=None, method=None):
    """Train and record, at each end-trigger check: the host clock, the
    state's loss and every launch count.  Each iteration ends in the
    loss read-back, a device sync, so consecutive clocks bound one
    whole step.  With ``updates``, also each parameter's whole update
    (final minus initial value) and every buffer's final value, on the
    CPU."""
    from bigdl_tpu_torch.utils.rng import RNG

    counters = launch_counters()
    marks = []

    def mark(state):
        marks.append((time.perf_counter(), state.get("loss"),
                      {n: c.count for n, c in counters.items()}))

    opt = make_trainer(torch, model, B, T, iters, compute_dtype, mark, data,
                       crit, method)
    start = ({n: p.detach().clone() for n, p in model.named_parameters()}
             if updates else {})
    RNG().set_seed(1)
    for c in counters.values():
        c.reset()
    opt.optimize()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    losses = [m[1] for m in marks[1:]]
    step_s = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    per_step = [{n: b[2][n] - a[2][n] for n in b[2]}
                for a, b in zip(marks, marks[1:])]
    return dict(losses=losses, step_s=step_s, launches_per_step=per_step,
                launches={n: c.count for n, c in counters.items()},
                skipped_steps=opt.skipped_steps,
                updates={n: (p.detach() - start[n]).cpu()
                         for n, p in model.named_parameters() if n in start},
                buffers={n: b.detach().cpu() for n, b in model.named_buffers()
                         if updates})


def decrease_rel_err(got, ref) -> float:
    """The worst step's relative error in the loss decrease: over k > 1,
    |(got_k - got_1) - (ref_k - ref_1)| / |ref_k - ref_1|."""
    return max(abs((g - got[0]) - (r - ref[0])) / abs(r - ref[0])
               for g, r in zip(got[1:], ref[1:]))


def train_flagship(torch):
    """Phase 5: the port's LocalOptimizer trains the flagship."""
    cfg = FLAGSHIP
    L, Dm = cfg["num_layers"], cfg["embed_dim"]
    B, T = TRAIN_BATCH, TRAIN_T
    failures = []

    model = _lm(torch, "cuda", L)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bf16 = run_training(torch, model, B, T, TRAIN_ITERS, torch.bfloat16)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    losses = bf16["losses"]
    want = want_launches(flash_fwd=L, flash_bwd_dkv=L, flash_bwd_dq=L,
                         layer_norm_fwd=2 * L + 1)
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(x)
                                             for x in losses):
        failures.append(f"training losses {losses}")
    if bf16["skipped_steps"]:
        failures.append(f"{bf16['skipped_steps']} training steps skipped")
    if not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    bad = [s for s in bf16["launches_per_step"] if s != want]
    if bad:
        failures.append(f"launches per step {bad[0]}, want {want}")
    # iterations 3-8: host clock between loop iterations, each ending in
    # the loss read-back (a device sync)
    steady = bf16["step_s"][2:]
    step_ms = 1e3 * sum(steady) / len(steady)
    tokens_per_s = B * T / (step_ms / 1e3)
    attn_flops_per_token = 6.0 * T * Dm * L   # bench.py's convention
    mfu_6nd = 6.0 * n_params * tokens_per_s / PEAK_FLOPS["bfloat16"]
    mfu = ((6.0 * n_params + attn_flops_per_token) * tokens_per_s
           / PEAK_FLOPS["bfloat16"])
    print(f"training path: bf16, B {B} T {T}: losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{bf16['launches_per_step'][0]}; step {step_ms:.2f} ms "
          f"(iterations 3-{TRAIN_ITERS}), {tokens_per_s:.0f} tokens/s, MFU "
          f"{mfu:.4f} (6ND only {mfu_6nd:.4f}), peak memory "
          f"{peak_gb:.2f} GB")

    # the same 8 steps in f32 on the card, same weights and batch: the
    # framework's default precision, timed as the bf16 run
    f32 = run_training(torch, _lm(torch, "cuda", L), B, T, TRAIN_ITERS, None)
    torch.cuda.empty_cache()
    ref = f32["losses"]
    f32_steady = f32["step_s"][2:]
    f32_step_ms = 1e3 * sum(f32_steady) / len(f32_steady)
    f32_tokens_per_s = B * T / (f32_step_ms / 1e3)
    print(f"training path: f32, B {B} T {T}: step {f32_step_ms:.2f} ms "
          f"(iterations 3-{TRAIN_ITERS}), {f32_tokens_per_s:.0f} tokens/s; "
          f"launches per step {f32['launches_per_step'][0]}")
    # the f32 kernels read every operand in place too
    if any(st["attn_operand_copies"] for st in f32["launches_per_step"]):
        failures.append(f"f32 steps copied attention operands: "
                        f"{f32['launches_per_step']}")
    first_rel = abs(losses[0] - ref[0]) / abs(ref[0])
    dec_rel = decrease_rel_err(losses, ref)
    print(f"training path: bf16 vs f32 on the card: first loss "
          f"{losses[0]:.6f} vs {ref[0]:.6f}, rel {first_rel:.3e} (tol "
          f"{TRAIN_FIRST_REL_TOL}); decreases L_k - L_1 "
          f"{[round(x - losses[0], 6) for x in losses[1:]]} vs "
          f"{[round(x - ref[0], 6) for x in ref[1:]]}, worst rel "
          f"{dec_rel:.3e} (tol {TRAIN_DECREASE_REL_TOL})")
    if len(ref) != TRAIN_ITERS or not first_rel <= TRAIN_FIRST_REL_TOL:
        failures.append(f"first loss bf16 vs f32 rel {first_rel:.3e}")
    if not dec_rel <= TRAIN_DECREASE_REL_TOL:
        failures.append(f"loss decreases bf16 vs f32 rel {dec_rel:.3e}")

    # a 2-layer copy at full width in f32: the card against the CPU
    small = {dev: run_training(torch, _lm(torch, dev, SMALL_LAYERS),
                               SMALL_BATCH, SMALL_T, SMALL_ITERS, None,
                               updates=True)
             for dev in ("cuda", "cpu")}
    card, cpu = small["cuda"]["losses"], small["cpu"]["losses"]
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    traj_dec_rel = decrease_rel_err(card, cpu)
    got, want = small["cuda"]["updates"], small["cpu"]["updates"]
    scale = max(max_row_norm(torch, u) for u in want.values())
    upd_err = {n: row_rel_err(torch, got[n], u, scale)
               for n, u in want.items()}
    worst = max(upd_err, key=upd_err.get)
    print(f"training path: 2-layer f32 losses card {card} cpu {cpu}: max "
          f"rel {traj_rel:.3e} (rtol {TRAJ_RTOL}), decreases worst rel "
          f"{traj_dec_rel:.3e} (tol {TRAJ_DECREASE_REL_TOL}); updates "
          f"p_{SMALL_ITERS} - p_0 of {len(want)} parameters, worst row err "
          f"{upd_err[worst]:.3e} in {worst} (tol {TRAJ_UPDATE_ROW_TOL})")
    if len(card) != SMALL_ITERS or not traj_rel <= TRAJ_RTOL:
        failures.append(f"2-layer f32 card vs cpu: {card} vs {cpu}")
    if not traj_dec_rel <= TRAJ_DECREASE_REL_TOL:
        failures.append(f"2-layer f32 loss decreases card vs cpu rel "
                        f"{traj_dec_rel:.3e}")
    if not upd_err[worst] <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"2-layer f32 updates card vs cpu: {worst} row err "
                        f"{upd_err[worst]:.3e}")
    if small["cuda"]["launches"]["flash_bwd_dq"] != SMALL_LAYERS * SMALL_ITERS:
        failures.append(f"2-layer card run launches "
                        f"{small['cuda']['launches']}")
    return dict(
        n_params=n_params, batch=B, seq_len=T, lr=TRAIN_LR,
        losses=losses, step_s=bf16["step_s"],
        launches_per_step=bf16["launches_per_step"][0],
        launches=bf16["launches"], skipped_steps=bf16["skipped_steps"],
        step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu,
        mfu_6nd=mfu_6nd, peak_memory_gb=peak_gb,
        timing="host clock between loop iterations 3-8, each ending in "
               "the loss read-back (a device sync)",
        f32_losses=ref, f32_step_s=f32["step_s"], f32_step_ms=f32_step_ms,
        f32_tokens_per_s=f32_tokens_per_s,
        f32_launches_per_step=f32["launches_per_step"][0],
        bf16_vs_f32_first_rel=first_rel,
        bf16_vs_f32_decrease_rel=dec_rel,
        small_f32=dict(layers=SMALL_LAYERS, batch=SMALL_BATCH, seq_len=SMALL_T,
                       card_losses=card, cpu_losses=cpu, max_rel=traj_rel,
                       decrease_rel=traj_dec_rel, update_row_err=upd_err)
    ), failures


def train_blocksparse(torch):
    """Phase 6: the port's LocalOptimizer trains the block-sparse
    flagship at T 4096 (bench.py's transformerlm_blocksparse_T4096)."""
    from bigdl_tpu_torch.ops import block_sparse as bs

    cfg = FLAGSHIP
    L, Dm = cfg["num_layers"], cfg["embed_dim"]
    B, T = BS_BATCH, BS_T
    lm_kw = dict(max_len=T, seq_strategy="blocksparse", blocksparse=BS_CFG)
    failures = []

    model = _lm(torch, "cuda", L, **lm_kw)
    n_params = sum(p.numel() for p in model.parameters())
    mask = model.blocks[0][1].block_mask(T, T)
    work = bs.attention_work(mask, 1, 1, Dm // cfg["num_heads"], causal=True)
    frac = work["executed_vs_flash_fraction"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = run_training(torch, model, B, T, TRAIN_ITERS, torch.bfloat16)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    losses = run["losses"]
    want = want_launches(block_sparse_fwd=L, block_sparse_bwd_dkv=L,
                         block_sparse_bwd_dq=L, layer_norm_fwd=2 * L + 1)
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(x)
                                             for x in losses):
        failures.append(f"block-sparse training losses {losses}")
    if run["skipped_steps"]:
        failures.append(f"{run['skipped_steps']} block-sparse steps skipped")
    if not losses[-1] < losses[0]:
        failures.append(f"block-sparse loss did not fall: {losses[0]} -> "
                        f"{losses[-1]}")
    bad = [st for st in run["launches_per_step"] if st != want]
    if bad:
        failures.append(f"block-sparse launches per step {bad[0]}, want "
                        f"{want}")

    def speed(step_s):
        steady = step_s[2:]
        step_ms = 1e3 * sum(steady) / len(steady)
        return step_ms, B * T / (step_ms / 1e3)

    step_ms, tokens_per_s = speed(run["step_s"])
    attn_flops = 6.0 * T * Dm * L   # bench.py's convention, flash basis
    mfu = ((6.0 * n_params + frac * attn_flops) * tokens_per_s
           / PEAK_FLOPS["bfloat16"])
    mfu_flash_eq = ((6.0 * n_params + attn_flops) * tokens_per_s
                    / PEAK_FLOPS["bfloat16"])
    print(f"block-sparse path: bf16, B {B} T {T}, mask {mask} (executed vs "
          f"flash {frac:.4f}): losses {[round(x, 4) for x in losses]}; "
          f"launches per step {run['launches_per_step'][0]}; step "
          f"{step_ms:.2f} ms (iterations 3-{TRAIN_ITERS}), {tokens_per_s:.0f}"
          f" tokens/s, MFU {mfu:.4f} executed ({mfu_flash_eq:.4f} on the "
          f"flash-equivalent basis), peak memory {peak_gb:.2f} GB")

    # the same 8 steps in f32 on the card, timed as the bf16 run
    f32 = run_training(torch, _lm(torch, "cuda", L, **lm_kw), B, T,
                       TRAIN_ITERS, None)
    torch.cuda.empty_cache()
    ref = f32["losses"]
    f32_step_ms, f32_tokens_per_s = speed(f32["step_s"])
    print(f"block-sparse path: f32, B {B} T {T}: step {f32_step_ms:.2f} ms "
          f"(iterations 3-{TRAIN_ITERS}), {f32_tokens_per_s:.0f} tokens/s; "
          f"launches per step {f32['launches_per_step'][0]}")
    if any(st["attn_operand_copies"] for st in f32["launches_per_step"]):
        failures.append(f"block-sparse f32 steps copied attention operands: "
                        f"{f32['launches_per_step']}")
    first_rel = abs(losses[0] - ref[0]) / abs(ref[0])
    dec_rel = decrease_rel_err(losses, ref)
    print(f"block-sparse path: bf16 vs f32 on the card: first loss "
          f"{losses[0]:.6f} vs {ref[0]:.6f}, rel {first_rel:.3e} (tol "
          f"{BS_FIRST_REL_TOL}); decreases "
          f"{[round(x - losses[0], 6) for x in losses[1:]]} vs "
          f"{[round(x - ref[0], 6) for x in ref[1:]]}, worst rel "
          f"{dec_rel:.3e} (tol {TRAIN_DECREASE_REL_TOL})")
    if len(ref) != TRAIN_ITERS or not first_rel <= BS_FIRST_REL_TOL:
        failures.append(f"block-sparse first loss bf16 vs f32 rel "
                        f"{first_rel:.3e}")
    if not dec_rel <= TRAIN_DECREASE_REL_TOL:
        failures.append(f"block-sparse loss decreases bf16 vs f32 rel "
                        f"{dec_rel:.3e}")

    # a 2-layer copy at full width, an 8 x 8 mask at block 64: f32 on
    # the card against the CPU
    small_kw = dict(max_len=BS_SMALL_T, seq_strategy="blocksparse",
                    blocksparse=BS_SMALL_CFG)
    small = {dev: run_training(torch, _lm(torch, dev, SMALL_LAYERS,
                                          **small_kw),
                               BS_SMALL_BATCH, BS_SMALL_T, SMALL_ITERS, None,
                               updates=True)
             for dev in ("cuda", "cpu")}
    card, cpu = small["cuda"]["losses"], small["cpu"]["losses"]
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    traj_dec_rel = decrease_rel_err(card, cpu)
    got, want_upd = small["cuda"]["updates"], small["cpu"]["updates"]
    scale = max(max_row_norm(torch, u) for u in want_upd.values())
    upd_err = {n: row_rel_err(torch, got[n], u, scale)
               for n, u in want_upd.items()}
    worst = max(upd_err, key=upd_err.get)
    print(f"block-sparse path: 2-layer f32 (T {BS_SMALL_T}, block 64) "
          f"losses card {card} cpu {cpu}: max rel {traj_rel:.3e} (rtol "
          f"{TRAJ_RTOL}), decreases worst rel {traj_dec_rel:.3e} (tol "
          f"{TRAJ_DECREASE_REL_TOL}); updates worst row err "
          f"{upd_err[worst]:.3e} in {worst} (tol {TRAJ_UPDATE_ROW_TOL})")
    if len(card) != SMALL_ITERS or not traj_rel <= TRAJ_RTOL:
        failures.append(f"block-sparse 2-layer card vs cpu: {card} vs {cpu}")
    if not traj_dec_rel <= TRAJ_DECREASE_REL_TOL:
        failures.append(f"block-sparse 2-layer decreases rel "
                        f"{traj_dec_rel:.3e}")
    if not upd_err[worst] <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"block-sparse 2-layer updates: {worst} row err "
                        f"{upd_err[worst]:.3e}")
    if small["cuda"]["launches"]["block_sparse_bwd_dq"] \
            != SMALL_LAYERS * SMALL_ITERS:
        failures.append(f"block-sparse 2-layer launches "
                        f"{small['cuda']['launches']}")

    # flash at T 4096 (8 steps: its speed on the same basis), and an
    # all-ones block-sparse mask (window 8 of 8 blocks), 3 steps: the
    # same function through K1-K3 and through K6-K8
    flash = run_training(torch, _lm(torch, "cuda", L, max_len=T), B, T,
                         TRAIN_ITERS, torch.bfloat16)
    torch.cuda.empty_cache()
    ones = run_training(torch, _lm(torch, "cuda", L, max_len=T,
                                   seq_strategy="blocksparse",
                                   blocksparse=dict(BS_CFG, window=8)),
                        B, T, BS_CMP_ITERS, torch.bfloat16)
    torch.cuda.empty_cache()
    # flash's first loss in f32 at the same shape: its bf16 vs f32 gap
    flash_f32 = run_training(torch, _lm(torch, "cuda", L, max_len=T), B, T,
                             1, None)["losses"][0]
    torch.cuda.empty_cache()
    flash_first_rel = abs(flash["losses"][0] - flash_f32) / abs(flash_f32)
    if not flash_first_rel <= BS_FIRST_REL_TOL:
        failures.append(f"flash at T {T}: first loss bf16 vs f32 rel "
                        f"{flash_first_rel:.3e}")
    flash_ms, flash_tps = speed(flash["step_s"])
    a, b = flash["losses"][:BS_CMP_ITERS], ones["losses"]
    ones_rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    print(f"block-sparse path: flash at T {T}: first loss bf16 vs f32 "
          f"{flash['losses'][0]:.6f} vs {flash_f32:.6f}, rel "
          f"{flash_first_rel:.3e} (tol {BS_FIRST_REL_TOL}); step "
          f"{flash_ms:.2f} ms, {flash_tps:.0f} tokens/s; block-sparse / "
          f"flash step {step_ms / flash_ms:.4f}; losses flash {a} vs all-ones mask "
          f"{b}: identical {a == b}, max rel {ones_rel:.3e} (tol "
          f"{BS_FIRST_REL_TOL})")
    if len(b) != BS_CMP_ITERS or not ones_rel <= BS_FIRST_REL_TOL:
        failures.append(f"flash vs all-ones block-sparse losses {a} vs {b}")
    if flash["launches_per_step"][0] != want_launches(
            flash_fwd=L, flash_bwd_dkv=L, flash_bwd_dq=L,
            layer_norm_fwd=2 * L + 1) or ones["launches_per_step"][0] != want:
        failures.append(f"flash / all-ones launches "
                        f"{flash['launches_per_step'][0]} / "
                        f"{ones['launches_per_step'][0]}")
    return dict(
        config=dict(FLAGSHIP, max_len=T, seq_strategy="blocksparse",
                    blocksparse=BS_CFG), mask=repr(mask),
        executed_vs_flash_fraction=frac, n_params=n_params, batch=B,
        seq_len=T, lr=TRAIN_LR, losses=losses, step_s=run["step_s"],
        launches_per_step=run["launches_per_step"][0],
        launches=run["launches"], skipped_steps=run["skipped_steps"],
        step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu,
        mfu_flash_equivalent=mfu_flash_eq, peak_memory_gb=peak_gb,
        f32_losses=ref, f32_step_s=f32["step_s"], f32_step_ms=f32_step_ms,
        f32_tokens_per_s=f32_tokens_per_s,
        f32_launches_per_step=f32["launches_per_step"][0],
        bf16_vs_f32_first_rel=first_rel,
        bf16_vs_f32_decrease_rel=dec_rel,
        small_f32=dict(layers=SMALL_LAYERS, batch=BS_SMALL_BATCH,
                       seq_len=BS_SMALL_T, blocksparse=BS_SMALL_CFG,
                       card_losses=card, cpu_losses=cpu, max_rel=traj_rel,
                       decrease_rel=traj_dec_rel, update_row_err=upd_err),
        flash=dict(losses=flash["losses"], step_s=flash["step_s"],
                   f32_first_loss=flash_f32,
                   bf16_vs_f32_first_rel=flash_first_rel,
                   step_ms=flash_ms, tokens_per_s=flash_tps,
                   launches_per_step=flash["launches_per_step"][0]),
        all_ones=dict(losses=b, max_rel_vs_flash=ones_rel,
                      identical=a == b),
        step_ratio_vs_flash=step_ms / flash_ms), failures


def matmul_entry(torch, dt, block=MM_BLOCK):
    """Phase 7: ``block_sparse_matmul`` at the flagship MLP shape in ``dt``
    under autograd, 3 forward+backward passes (phase 3's inputs, a
    magnitude mask at ``block``): 6 K9 launches, at the MLP's block 128
    all on the block route (in f32 on split products), at block 8 all on
    the coarse route, each after one masked copy of W."""
    from bigdl_tpu_torch.ops import block_sparse as bs

    failures = []
    dname = str(dt).split(".")[-1]
    x, w, gy, mask = mm_inputs(torch, *MM_SHAPE, block, dt)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    counters = {name: c for name, c in launch_counters().items()
                if name.startswith("block_sparse_mm")}
    for counter in counters.values():
        counter.reset()
    t0 = time.perf_counter()
    outs = []
    for _ in range(3):
        y = bs.block_sparse_matmul(xl, wl, mask)
        dx, dw = torch.autograd.grad(y, (xl, wl), gy)
        outs.append((y.detach(), dx, dw))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = {name: c.count for name, c in counters.items()}
    coarse = bool(bs._mm_plan(dt, block, block, *w.shape).coarse)
    split = "f32" if dt == torch.float32 else "bf16"
    want = {name: 0 for name in counts}
    want["block_sparse_mm"] = 6
    if coarse:
        want[f"block_sparse_mm coarse {split}"] = 6
        want["block_sparse_mm masked W"] = 6
    elif dt == torch.float32:
        want["block_sparse_mm f32"] = 6
    live = bs._elementwise_weight_mask(mask, "cuda")
    dead_zero = all(not bool(o[2][~live].any()) for o in outs)
    same = all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
               for o in outs)
    y, dx, dw = outs[0]
    rel_y = row_rel_err(torch, y, bs._bs_mm_plain(x, w, mask))
    rel_dx = row_rel_err(torch, dx, bs._bs_mm_plain(
        gy, w.t(), mask.transposed()))
    tol = ROW_TOL[dname]
    route = "coarse" if coarse else "block"
    print(f"matmul path: block_sparse_matmul x {tuple(x.shape)} W "
          f"{tuple(w.shape)} {dname}, {mask}: 3 forward+backward passes, "
          f"launches {counts} (want {want}: all on the {route} route), dW "
          f"zero on every dead tile: {dead_zero}, passes equal: "
          f"{same}; row err y {rel_y:.3e} dx {rel_dx:.3e} (tol {tol:g}); "
          f"{wall_s * 1e3:.1f} ms")
    if counts != want:
        failures.append(f"block_sparse_matmul {dname} at block {block} "
                        f"launched {counts} in 3 passes; want {want}")
    if not (dead_zero and same and rel_y <= tol and rel_dx <= tol):
        failures.append(f"block_sparse_matmul {dname} at block {block}: dead "
                        f"dW zero {dead_zero}, passes equal {same}, row err "
                        f"{rel_y:.3e} / {rel_dx:.3e}")
    del x, w, gy, xl, wl, outs, y, dx, dw
    torch.cuda.empty_cache()
    return dict(shape=list(MM_SHAPE), block=block, density=MM_DENSITY,
                dtype=dname, route=route, passes=3, launches=counts,
                dead_tile_dw_zero=dead_zero,
                passes_equal=same, row_rel_err_y=rel_y,
                row_rel_err_dx=rel_dx, wall_ms=wall_s * 1e3), failures


def _resnet(torch, device, impl):
    """ResNet50(1000), conv7 stem, random weights from seed 0, every
    ``SpatialConvolution`` on ``impl``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet50

    model = ResNet50(RESNET_CLASSES, device=device,
                     generator=torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            m.set_conv_impl(impl)
    return model


def _images(B: int):
    """B random 224x224 images in [0, 1) and labels in 1..1000, float32,
    from ``numpy.random.RandomState(0)`` (bench.py's ``_bench_resnet``)."""
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rng.randint(1, RESNET_CLASSES + 1, size=B).astype(np.float32)
    return x, y


def _image_data(B: int, x_scale: float = 1.0):
    """``_images(B)`` as a dataset, the images times ``x_scale``."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample, array

    x, y = _images(B)
    return array([Sample(a, b) for a, b in zip(x * np.float32(x_scale), y)])


def _rows(t):
    """A parameter or statistic as rows: one per output channel (or
    class), one row for a vector."""
    return t.reshape(t.shape[0], -1) if t.dim() > 1 else t.reshape(1, -1)


def _train_resnet(torch, device, impl, B, iters, dtype, frozen_bn=False):
    """``iters`` LocalOptimizer steps of a fresh ``_resnet``; with
    ``frozen_bn`` every BatchNorm stays in eval mode (running statistics,
    no update of them), so the backward is well conditioned (see
    RESNET_CMP_*).  Returns (model, run_training record with updates)."""
    from bigdl_tpu_torch import nn

    model = _resnet(torch, device, impl)
    if frozen_bn:
        for m in model.modules():
            if isinstance(m, nn.BatchNormalization):
                # LocalOptimizer's model.train() reaches each child's train
                m.train = (lambda mode=True, m=m:
                           torch.nn.Module.train(m, False))
    run = run_training(torch, model, B, 0, iters, dtype, updates=True,
                       data=_image_data(B), crit=nn.ClassNLLCriterion())
    return model, run


def _update_errs(torch, got, ref):
    """Each parameter's update p_k - p_0 in ``got`` against ``ref``'s, row
    by row (one row an output channel or class), against a floor set by
    the largest row of all of ``ref``'s updates."""
    scale = max((max_row_norm(torch, _rows(u))
                 for u in ref["updates"].values()), default=0.0)
    return {n: row_rel_err(torch, _rows(got["updates"][n]), _rows(u), scale)
            for n, u in ref["updates"].items()}


def compare_runs(torch, got, ref, label, rows, path="resnet50 path",
                 tols=None, loss_ulps=0, twin=None, controls=None):
    """``got`` against ``ref`` (two ``run_training`` records with
    ``updates``): each decrease, and with ``rows`` every loss and every
    parameter update and BatchNorm statistic row by row, else the first
    loss.  ``tols``: (losses, decreases, rows), phase 8's by default.
    ``loss_ulps``: the decreases are held to their limit plus that many
    f32 ulps of the first loss (phase 12's rule where f32 cannot resolve
    a slow decrease of a large loss to the limit).  ``twin``: ``ref``'s
    run again on its input times 1 + 1e-7; where that perturbation alone
    moves a parameter's update by more than half the row limit (the
    model's own conditioning at random init, not either side's error),
    that parameter is held to twice the perturbation's reading instead,
    never past ``WIDEN_CAP``, and no more than ``WIDEN_SHARE`` of the
    updates so.  ``controls``: {fault: ``got``'s run with a wrong K5}
    (``_K5Fault``); each widened update's reading under each is recorded
    beside its limit, and the comparison must reject ``K5_FAULT_HELD``'s.
    Returns (record, failures)."""
    loss_tol, dec_tol, row_tol = tols or (RESNET_CMP_RTOL,
                                          RESNET_CMP_DECREASE_REL_TOL,
                                          RESNET_CMP_ROW_TOL)
    card, want = got["losses"], ref["losses"]
    # in training mode only the first loss comes from the forward alone
    held = card if rows else card[:1]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(held, want))
    dec_rel = decrease_rel_err(card, want) if len(want) > 1 else 0.0
    floor = loss_ulps * _f32_ulp(want[0])
    dec_ok = all(abs((a - card[0]) - (b - want[0]))
                 <= dec_tol * abs(b - want[0]) + floor
                 for a, b in zip(card[1:], want[1:]))
    rec = dict(losses=card, ref_losses=want, loss_rel=loss_rel,
               decrease_rel=dec_rel)
    msg = (f"{path}: {label}: losses {card} vs {want}, "
           f"{'max' if rows else 'first'} rel {loss_rel:.3e} (tol "
           f"{loss_tol}); decreases worst rel {dec_rel:.3e} (tol "
           f"{dec_tol}{f' + {loss_ulps} f32 ulps' if loss_ulps else ''})")
    failures = []
    if len(card) != len(want) or not loss_rel <= loss_tol:
        failures.append(f"{label}: losses {card} vs {want}")
    if not dec_ok:
        failures.append(f"{label}: decreases rel {dec_rel:.3e}")
    if rows:
        errs = _update_errs(torch, got, ref)
        errs.update({n: row_rel_err(torch, _rows(got["buffers"][n]),
                                    _rows(b))
                     for n, b in ref["buffers"].items()})
        sens = _update_errs(torch, twin, ref) if twin is not None else {}
        limits = {n: max(row_tol, 2 * sens.get(n, 0.0)) for n in errs}
        worst = max(errs, key=lambda n: errs[n] / limits[n])
        rec.update(row_err=errs, worst=[worst, errs[worst]],
                   row_limit=limits[worst])
        msg += (f"; {len(errs)} parameter updates and statistics, worst row "
                f"err {errs[worst]:.3e} in {worst} (tol "
                f"{limits[worst]:.3e})")
        if sens:
            wide = {n: v for n, v in limits.items() if v > row_tol}
            top = max(sens, key=sens.get)
            rec.update(perturbation_row_err=sens, widened=wide)
            msg += (f"; a 1e-7 input perturbation of the reference moves "
                    f"{len(wide)} updates past {row_tol / 2:g} (worst "
                    f"{sens[top]:.3e} in {top}): those held to twice it "
                    f"(cap {WIDEN_CAP:g}, at most {WIDEN_SHARE:g} of them)")
            if wide and max(wide.values()) > WIDEN_CAP:
                failures.append(f"{label}: {top} widened to "
                                f"{2 * sens[top]:.3e} (cap {WIDEN_CAP:g})")
            if len(wide) > WIDEN_SHARE * len(errs):
                failures.append(f"{label}: {len(wide)} of {len(errs)} "
                                f"updates widened")
        if not errs[worst] <= limits[worst]:
            failures.append(f"{label}: {worst} row err {errs[worst]:.3e}")
    print(msg)
    if rows and controls:
        rec["controls"], bad = _controls(torch, controls, ref, limits,
                                         row_tol, loss_tol, label, path)
        failures += bad
    return rec, failures


def _controls(torch, controls, ref, limits, row_tol, loss_tol, label,
              path):
    """``compare_runs``'s negative controls: for each fault, the losses'
    worst relative error, every update's row error and how many pass
    their limits; each widened update's reading beside its limit."""
    wide = sorted(n for n, v in limits.items() if v > row_tol)
    rec, failures = {}, []
    for fault, run in sorted(controls.items()):
        errs = _update_errs(torch, run, ref)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(run["losses"], ref["losses"]))
        over = sorted(n for n in errs if not errs[n] <= limits[n])
        rejected = bool(over) or not loss_rel <= loss_tol
        rec[fault] = dict(loss_rel=loss_rel, over=over, rejected=rejected,
                          widened={n: dict(limit=limits[n], row_err=errs[n])
                                   for n in wide})
        print(f"{path}: {label}: control, K5's output x (1 + {fault:g}): "
              f"losses max rel {loss_rel:.3e} (tol {loss_tol:g}); "
              f"{len(over)} of {len(errs)} updates past their limits "
              f"(worst {max(errs.values()):.3e}); rejected: {rejected}; "
              f"the widened updates: "
              + ", ".join(f"{n} {errs[n]:.3e} (limit {limits[n]:.3e})"
                          for n in wide))
        if fault == K5_FAULT_HELD and not rejected:
            failures.append(f"{label}: a K5 off by {fault:g} passes")
    return rec, failures


def train_resnet50(torch):
    """Phase 8: the port's LocalOptimizer trains ResNet-50 at ImageNet
    shape with every 3x3 stride-1 conv on K5 (bench.py's pallas leg)."""
    B, iters = RESNET_BATCH, TRAIN_ITERS
    failures = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, run = _train_resnet(torch, "cuda", "pallas", B, iters,
                               torch.bfloat16)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    losses = run["losses"]
    want = want_launches(conv3x3=RESNET_K5_PER_STEP)
    failures += _check_run(run, iters, want, "resnet50")

    def speed(step_s):
        steady = step_s[2:]
        step_ms = 1e3 * sum(steady) / len(steady)
        ips = B / (step_ms / 1e3)
        return step_ms, ips, RESNET_STEP_FLOP_PER_IMAGE * ips / PEAK_FLOPS[
            "bfloat16"]

    step_ms, ips, mfu = speed(run["step_s"])
    # the "xla" impl (cuDNN for every conv) in bf16: the model-level
    # yardstick
    _, xla = _train_resnet(torch, "cuda", "xla", B, iters, torch.bfloat16)
    torch.cuda.empty_cache()
    xla_ms, xla_ips, xla_mfu = speed(xla["step_s"])
    if xla["launches"]["conv3x3"]:
        failures.append(f"the xla impl launched K5 {xla['launches']}")
    print(f"resnet50 path: bf16, B {B}, pallas: losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{run['launches_per_step'][0]}; step {step_ms:.2f} ms "
          f"(iterations 3-{iters}), {ips:.1f} images/s, MFU {mfu:.4f}, peak "
          f"memory {peak_gb:.2f} GB | xla impl: step {xla_ms:.2f} ms, "
          f"{xla_ips:.1f} images/s, MFU {xla_mfu:.4f}")

    # the same 8 steps in f32 on the card, same weights and batch (K5's
    # split-product route), timed, and beside them the "xla" impl's f32
    # steps (cuDNN, TF32 off)
    _, f32 = _train_resnet(torch, "cuda", "pallas", B, iters, None)
    torch.cuda.empty_cache()
    f32_ms, f32_ips, _ = speed(f32["step_s"])
    _, xla32 = _train_resnet(torch, "cuda", "xla", B, iters, None)
    torch.cuda.empty_cache()
    xla32_ms, xla32_ips, _ = speed(xla32["step_s"])
    bad = [st for st in f32["launches_per_step"] if st != want]
    if bad:
        failures.append(f"resnet50 f32 launches per step {bad[0]}, want "
                        f"{want}")
    if xla32["launches"]["conv3x3"]:
        failures.append(f"the xla impl launched K5 in f32 "
                        f"{xla32['launches']}")
    print(f"resnet50 path: f32, B {B}, pallas: step {f32_ms:.2f} ms "
          f"(iterations 3-{iters}), {f32_ips:.1f} images/s, K5 launches "
          f"per step {f32['launches_per_step'][0]['conv3x3']} | xla impl "
          f"(cuDNN, TF32 off): step {xla32_ms:.2f} ms, {xla32_ips:.1f} "
          f"images/s")
    ref = f32["losses"]
    first_rel = abs(losses[0] - ref[0]) / abs(ref[0])
    dec_rel = decrease_rel_err(losses, ref)
    print(f"resnet50 path: bf16 vs f32 on the card: first loss "
          f"{losses[0]:.6f} vs {ref[0]:.6f}, rel {first_rel:.3e} (tol "
          f"{RESNET_FIRST_REL_TOL}); decreases "
          f"{[round(x - losses[0], 6) for x in losses[1:]]} vs "
          f"{[round(x - ref[0], 6) for x in ref[1:]]}, worst rel "
          f"{dec_rel:.3e} (tol {RESNET_DECREASE_REL_TOL})")
    if len(ref) != iters or not first_rel <= RESNET_FIRST_REL_TOL:
        failures.append(f"resnet50 first loss bf16 vs f32 rel {first_rel:.3e}")
    if not dec_rel <= RESNET_DECREASE_REL_TOL:
        failures.append(f"resnet50 loss decreases bf16 vs f32 rel "
                        f"{dec_rel:.3e}")

    # "pallas" (K5) against "xla" (cuDNN) on the card, f32, B 8: 3 steps
    # in training mode (losses, decreases), 3 with BatchNorm frozen
    # (every parameter update row by row)
    cmp = {}
    for frozen in (False, True):
        runs = {impl: _train_resnet(torch, "cuda", impl, RESNET_CMP_BATCH,
                                    RESNET_CMP_ITERS, None, frozen)[1]
                for impl in ("pallas", "xla")}
        torch.cuda.empty_cache()
        tag = "frozen BatchNorm" if frozen else "training mode"
        cmp[tag], bad = compare_runs(
            torch, runs["pallas"], runs["xla"],
            f"pallas vs xla, f32, B {RESNET_CMP_BATCH}, {tag}", rows=frozen)
        failures += bad
        if runs["pallas"]["launches"]["conv3x3"] != (RESNET_K5_PER_STEP
                                                     * RESNET_CMP_ITERS):
            failures.append(f"pallas B {RESNET_CMP_BATCH} {tag} launches "
                            f"{runs['pallas']['launches']}")

    # the card against the CPU, f32, B 2: one step in training mode (the
    # loss and every BatchNorm statistic, which come from the forward),
    # then one eval-mode forward; 3 steps with BatchNorm frozen (every
    # parameter update)
    models, one, three = {}, {}, {}
    for dev in ("cuda", "cpu"):
        models[dev], one[dev] = _train_resnet(
            torch, dev, "pallas", RESNET_CPU_BATCH, 1, None)
        three[dev] = _train_resnet(torch, dev, "pallas", RESNET_CPU_BATCH,
                                   RESNET_CMP_ITERS, None, frozen_bn=True)[1]
    one["cuda"]["updates"] = one["cpu"]["updates"] = {}
    vs_cpu = {}
    vs_cpu["training mode, 1 step"], bad = compare_runs(
        torch, one["cuda"], one["cpu"],
        f"card vs cpu, f32, B {RESNET_CPU_BATCH}, 1 step: statistics",
        rows=True)
    failures += bad
    vs_cpu["frozen BatchNorm"], bad = compare_runs(
        torch, three["cuda"], three["cpu"],
        f"card vs cpu, f32, B {RESNET_CPU_BATCH}, frozen BatchNorm",
        rows=True)
    failures += bad
    x = torch.from_numpy(_images(RESNET_CPU_BATCH)[0])
    with torch.no_grad():
        out = {dev: m.evaluate()(x.to(m.device)).float().cpu()
               for dev, m in models.items()}
    eval_rel = ((out["cuda"] - out["cpu"]).abs().max()
                / out["cpu"].abs().max()).item()
    print(f"resnet50 path: eval-mode forward card vs cpu: max abs err "
          f"{eval_rel:.3e} of max |output| (tol {RESNET_EVAL_REL_TOL})")
    if not eval_rel <= RESNET_EVAL_REL_TOL:
        failures.append(f"resnet50 eval forward card vs cpu {eval_rel:.3e}")
    del models
    torch.cuda.empty_cache()
    return dict(
        config=dict(model="ResNet50", classes=RESNET_CLASSES, stem="conv7",
                    conv_impl="pallas", batch=B, hw=RESNET_HW, lr=RESNET_LR,
                    compute_dtype="bfloat16"),
        n_params=n_params, losses=losses, step_s=run["step_s"],
        launches_per_step=run["launches_per_step"][0],
        launches=run["launches"], skipped_steps=run["skipped_steps"],
        step_ms=step_ms, images_per_s=ips, mfu=mfu, peak_memory_gb=peak_gb,
        timing="host clock between loop iterations 3-8, each ending in the "
               "loss read-back (a device sync)",
        xla=dict(losses=xla["losses"], step_ms=xla_ms, images_per_s=xla_ips,
                 mfu=xla_mfu),
        f32=dict(losses=ref, step_s=f32["step_s"], step_ms=f32_ms,
                 images_per_s=f32_ips,
                 launches_per_step=f32["launches_per_step"][0],
                 xla=dict(losses=xla32["losses"], step_s=xla32["step_s"],
                          step_ms=xla32_ms, images_per_s=xla32_ips)),
        f32_losses=ref, bf16_vs_f32_first_rel=first_rel,
        bf16_vs_f32_decrease_rel=dec_rel, pallas_vs_xla_f32=cmp,
        card_vs_cpu_f32=vs_cpu, eval_forward_rel=eval_rel), failures


def _kernel_group(name: str) -> str:
    if "attn_fwd_" in name and "ListSweep" in name:   # bf16 and f32
        return "K6 block_sparse_fwd"
    if "bwd_dkv_" in name and "ListSweep" in name:   # bf16 and f32
        return "K7 block_sparse_bwd_dkv"
    if "bwd_dq_" in name and "ListSweep" in name:   # bf16 and f32
        return "K8 block_sparse_bwd_dq"
    if "bs_mm_kernel" in name:
        return "K9 block_sparse_mm"
    if "attn_fwd_" in name:
        return "K1 flash_fwd"
    if "bwd_dkv_" in name:
        return "K2 flash_bwd_dkv"
    if "bwd_dq_" in name:
        return "K3 flash_bwd_dq"
    if "_ln_fwd" in name:
        return "K4 layer_norm_fwd"
    if "conv3x3_kernel" in name:
        return "K5 conv3x3"
    if "bernoulli" in name.lower():
        return "dropout masks (bernoulli draws)"
    if any(s in name.lower() for s in ("gemm", "gemv", "nvjet", "cutlass",
                                       "xmma", "sm90_")):
        return "matmul (cuBLAS)"
    return "other (elementwise, softmax, copies, sampling)"


def profile_served(torch):
    """``--profile``: the served generator of phase 4 (4 x 512-token
    prompts, bf16) under ``torch.profiler``, once for the prefill and
    first token alone and once for all 32 new tokens.  Device time by
    kernel and by group, launches, and the device's busy share of the
    wall time (wall taken without the profiler, min of 3)."""
    import numpy as np

    from bigdl_tpu_torch.models.generate import cached_generate
    from bigdl_tpu_torch.models.transformer import TransformerLM

    cfg = FLAGSHIP
    model = TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                          num_heads=cfg["num_heads"],
                          num_layers=cfg["num_layers"],
                          max_len=cfg["max_len"], device="cuda",
                          generator=torch.Generator().manual_seed(0))
    gen = cached_generate(model, compute_dtype=torch.bfloat16)
    params = model.param_tree()
    prompts = np.random.RandomState(0).randint(
        1, cfg["vocab"] + 1, size=(BATCH, PROMPT_LENS[0])).astype(np.int32)
    report = {}
    for label, n in (("prefill", 1), ("generate", MAX_NEW)):
        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen(params, prompts, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run()
        report[label] = dict(new_tokens=n, **profile_window(torch, run))
        print_profile(f"profile {label} ({n} new tokens, batch {BATCH}, "
                      f"prompt {PROMPT_LENS[0]})", report[label])
    return report


def _resnet_group(kernel: str, ops) -> str:
    """The group of a kernel of a conv model's step (ResNet-50's, the
    zoo's), from its name and the names of the op that launched it and
    that op's ancestors."""
    def under(*parts):
        return any(part in op for op in ops for part in parts)

    if "conv3x3_kernel" in kernel:
        return "K5 conv3x3 dX" if under("_Conv3x3Backward") \
            else "K5 conv3x3 forward"
    if kernel.startswith(("Memcpy", "Memset")):
        return ("memcpy / memset (the batch's upload, parameter and state "
                "copies)")
    if under("aten::contiguous"):
        return "layout copies NCHW <-> NHWC (around K5)"
    if under("aten::cat"):
        return "Concat: torch.cat of the branches' outputs (its copies)"
    gemm = any(t in kernel.lower() for t in ("gemm", "gemv", "nvjet",
                                              "cutlass", "xmma", "sm90_"))
    if under("_Conv3x3Backward"):
        if gemm:
            return "K5 dW: 9 matmuls a conv over row windows (cuBLAS)"
        if under("constant_pad_nd"):
            return "K5 dW: the pads of x and g"
        return "K5 dX and dW: weight flip, casts, other copies"
    if under("convolution"):
        return "cuDNN conv (stem, 1x1, strided 3x3; forward and backward)"
    if gemm:
        return "matmul (cuBLAS: the classifier)"
    return "BN, ReLU, pooling, loss, optimizer and other elementwise"


def _op_groups(prof, group):
    """Device ms and launches by ``group(kernel name, op names)`` over the
    kernels each CPU op launched (the innermost op first, then its
    ancestors)."""
    groups = {}
    for e in prof.events():
        if not e.kernels:
            continue
        ops, op = [], e
        while op is not None:
            ops.append(op.name)
            op = op.cpu_parent
        for k in e.kernels:
            g = groups.setdefault(group(k.name, ops), [0.0, 0])
            g[0] += k.duration / 1e3
            g[1] += 1
    return groups


def profile_window(torch, run, group_by_op=None, ranges=(), top=12):
    """Wall (min of 3 runs of ``run`` without the profiler), then one run
    under ``torch.profiler``: device time by kernel and by group,
    launches, and the device's busy share of that wall.  Groups come
    from the kernel's name, or with ``group_by_op`` from it and the ops
    that launched the kernel; device time no op claims is
    "unattributed".  ``ranges``: the names of ``record_function`` ranges
    the run opens, whose device-side spans are no kernels; ``top``: how
    many kernels to list."""
    from torch.profiler import ProfilerActivity, profile

    cuda_type = torch.autograd.DeviceType.CUDA
    wall_s = min(run() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != cuda_type or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = (us / 1e3, e.count)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    if group_by_op is not None:
        groups = _op_groups(prof, group_by_op)
        rest = [device_ms - sum(g[0] for g in groups.values()),
                sum(c for _, c in by_kernel.values())
                - sum(g[1] for g in groups.values())]
        if rest[1]:
            groups["unattributed"] = rest
    else:
        groups = {}
        for name, (ms, count) in by_kernel.items():
            g = groups.setdefault(_kernel_group(name), [0.0, 0])
            g[0] += ms
            g[1] += count
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        wall_ms=wall_s * 1e3, device_ms=device_ms,
        busy_share=device_ms / (wall_s * 1e3) if device_ms else None,
        launches=sum(c for _, c in by_kernel.values()),
        groups={k: dict(ms=v[0], launches=v[1]) for k, v in groups.items()},
        top_kernels=[dict(name=k[:120], ms=v[0], launches=v[1])
                     for k, v in top])


def print_profile(title: str, rep: dict):
    busy = (f"{rep['busy_share']:.4f}" if rep["device_ms"]
            else "not measured (no device time in the trace)")
    print(f"{title}: wall {rep['wall_ms']:.3f} ms, device "
          f"{rep['device_ms']:.3f} ms, busy share {busy}, "
          f"{rep['launches']} launches")
    for k, v in sorted(rep["groups"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {k:>48}: {v['ms']:9.3f} ms  {v['launches']:6d} launches")
    for t in rep["top_kernels"]:
        print(f"    {t['ms']:9.3f} ms {t['launches']:6d}x  {t['name'][:100]}")


def profile_training(torch, B=TRAIN_BATCH, T=TRAIN_T, **lm_kw):
    """``--profile``: one bf16 training step of phase 5 (B 16, T 1024),
    or of phase 6 with its ``lm_kw``, under ``torch.profiler``, after
    two warm iterations; each timed run is one more iteration of the
    same LocalOptimizer."""
    model = _lm(torch, "cuda", FLAGSHIP["num_layers"], **lm_kw)
    opt = make_trainer(torch, model, B, T, 2, torch.bfloat16)
    opt.optimize()

    def run():
        state = opt.optim_method.state
        opt.set_end_when(lambda s, last=state["neval"]: s["neval"] > last)
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rep = profile_window(torch, run)
    drop = f", dropout {lm_kw['dropout']}" if lm_kw.get("dropout") else ""
    print_profile(f"profile training step (bf16, batch {B}, T {T}, "
                  f"{model.seq_strategy}{drop})", rep)
    del model, opt
    torch.cuda.empty_cache()
    return rep


def profile_resnet(torch):
    """``--profile``: one bf16 ResNet-50 step of phase 8 (B 64,
    ``"pallas"``) under ``torch.profiler`` after two warm iterations,
    grouped by the op that launched each kernel."""
    model = _resnet(torch, "cuda", "pallas")
    rep = profile_conv_model(torch, model, RESNET_BATCH,
                             f"profile ResNet-50 training step (bf16, batch "
                             f"{RESNET_BATCH}, pallas)")
    del model
    torch.cuda.empty_cache()
    return rep


# phase 10: train with validation and verified checkpoints, resume, roll
# back a loss spike, swap a checkpoint into a live server
VAL_SEQS, VAL_BATCH, CKPT_EVERY = 8, 4, 4
SWAP_PROMPTS, SWAP_NEW = 2, 16
CRC_CHECK_BYTES = 16 << 20
VAL_REL_TOL = 1e-6


def _params_cpu(model):
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


def _val_data():
    """VAL_SEQS held-out sequences of TRAIN_T ids (``RandomState(1)``)."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample, array

    V = FLAGSHIP["vocab"]
    rng = np.random.RandomState(1)
    x = rng.randint(1, V + 1, size=(VAL_SEQS, TRAIN_T)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(VAL_SEQS, TRAIN_T)).astype(np.int32)
    return array([Sample(a, b) for a, b in zip(x, y)])


def _val_methods():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import Loss

    return [Loss(nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                             True))]


def _spike_leg(torch, tmp):
    """(c): the XOR classifier of ``tests/test_resilience.py:201`` on the
    card, two spiked batches under ``set_loss_spike_guard(k=2)``, a
    checkpoint every iteration."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, array
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Trigger,
                                       several_iteration)
    from bigdl_tpu_torch.resilience import RetryPolicy, faults

    rng = np.random.RandomState(0)
    x = rng.rand(256, 2).astype(np.float32)
    y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.float32) + 1
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(2, 2, device="cuda", generator=g),
                          nn.LogSoftMax(device="cuda"), device="cuda")
    fault = faults.ScaleInjector(at=257, n=128, scale=100.0)
    ds = array([Sample(a, b) for a, b in zip(x, y)]) >> fault \
        >> SampleToMiniBatch(64)
    losses = []

    def end(state):
        if "loss" in state:
            losses.append(state["loss"])
        return state["neval"] > 12

    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), batch_size=64)
    opt.set_optim_method(SGD(learning_rate=0.1)).set_end_when(Trigger(end))
    opt.set_checkpoint(str(tmp / "spike"), several_iteration(1))
    opt.set_loss_spike_guard(k=2, ratio=2.0, warmup=2)
    opt.set_retry_policy(RetryPolicy(max_retries=5, backoff_base=0.01))
    opt.optimize()
    finite = all(math.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    return dict(rollbacks=opt.rollbacks, spiked_records=fault.fired,
                iterations=opt.optim_method.state["neval"] - 1,
                losses=losses, finite=finite)


def train_checkpoint_swap(torch):
    """Phase 10: (a) the flagship trained as in phase 5 with validation,
    verified async checkpoints and summaries; (b) a fresh model resumed
    from step 4; (c) a loss-spike rollback; (d) the step-8 checkpoint
    swapped into a live bf16 server.  Returns (record, failures); the
    record's ``launches`` are the whole phase's, read from zero."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.optim import several_iteration
    from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.resilience.checkpoint import (sidecar_path,
                                                       verify_file)
    from bigdl_tpu_torch.serving import InferenceServer, SwapRejected
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.utils.rng import RNG
    from bigdl_tpu_torch.visualization import (TrainSummary,
                                               ValidationSummary)
    from bigdl_tpu_torch.visualization.crc32c import crc32c, crc32c_table

    L, V = FLAGSHIP["num_layers"], FLAGSHIP["vocab"]
    B, T, iters = TRAIN_BATCH, TRAIN_T, TRAIN_ITERS
    failures, rec = [], {}

    def check(ok, what):
        if not ok:
            failures.append(f"phase 10 {what}")

    counters = launch_counters()
    for c in counters.values():
        c.reset()
    tmp = Path(tempfile.mkdtemp(prefix="phase10-"))
    t_phase = time.perf_counter()
    try:
        # (a) train with validation, checkpoints and summaries
        model = _lm(torch, "cuda", L)
        marks = []
        opt = make_trainer(torch, model, B, T, iters, torch.bfloat16,
                           lambda s: marks.append(
                               (s.get("loss"),
                                {n: c.count for n, c in counters.items()})))
        ckpt = tmp / "ckpt"
        opt.set_validation(several_iteration(CKPT_EVERY), _val_data(),
                           _val_methods(), batch_size=VAL_BATCH)
        opt.set_checkpoint(str(ckpt), several_iteration(CKPT_EVERY))
        ts = TrainSummary(str(tmp / "logs"), "phase10")
        vs = ValidationSummary(str(tmp / "logs"), "phase10")
        opt.set_train_summary(ts).set_validation_summary(vs)
        RNG().set_seed(1)
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        rec["train_s"] = time.perf_counter() - t0
        losses = [m[0] for m in marks[1:]]
        trained = _params_cpu(model)
        step = want_launches(flash_fwd=L, flash_bwd_dkv=L, flash_bwd_dq=L,
                             layer_norm_fwd=2 * L + 1)
        val = {n: step[n] + {"flash_fwd": VAL_SEQS // VAL_BATCH * L,
                             "layer_norm_fwd": VAL_SEQS // VAL_BATCH
                             * (2 * L + 1)}.get(n, 0) for n in step}
        per_step = [{n: b[1][n] - a[1][n] for n in b[1]}
                    for a, b in zip(marks, marks[1:])]
        bad = [(k + 1, s) for k, s in enumerate(per_step)
               if s != (val if (k + 1) % CKPT_EVERY == 0 else step)]
        check(not bad, f"launches per step {bad[:1]}, want {step} (and "
                       f"{val} at a validation step)")
        check(len(losses) == iters and all(map(math.isfinite, losses))
              and opt.skipped_steps == 0, f"training losses {losses}")
        names = sorted(os.listdir(ckpt))
        legs = [f"{leg}.{n}" for n in (4, 8)
                for leg in ("model", "optimMethod", "trainState")]
        t0 = time.perf_counter()
        verified = {f: verify_file(str(ckpt / f)) for f in legs}
        rec["verify_s"] = time.perf_counter() - t0
        check(all(v is True for v in verified.values()),
              f"checkpoint files {names}, verified {verified}")
        # the native crc against the plain table on the first 16 MB
        with open(ckpt / "model.8", "rb") as f:
            head = f.read(CRC_CHECK_BYTES)
        t0 = time.perf_counter()
        native_crc = crc32c(head)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        table_crc = crc32c_table(head)
        table_s = time.perf_counter() - t0
        check(native_crc == table_crc, f"native crc {native_crc:08x} != "
                                       f"table {table_crc:08x}")
        rec.update(crc_bytes=len(head), native_crc_gb_s=len(head) / native_s
                   / 1e9, table_crc_gb_s=len(head) / table_s / 1e9,
                   native_crc_s=native_s, table_crc_s=table_s)
        # summaries: Loss at every iteration, validation at 4 and 8
        got_loss = ts.read_scalar("Loss")
        check([s for s, _ in got_loss] == list(range(1, iters + 1))
              and all(v == float(np.float32(x))
                      for (_, v), x in zip(got_loss, losses)),
              f"summary Loss {got_loss} vs losses {losses}")
        vals = {s["step"]: s for s in opt.validation_stats}
        check(sorted(vals) == [4, 8] and [s for s, _ in vs.read_scalar(
            "Loss")] == [4, 8], f"validation at {sorted(vals)}")
        ts.close()
        vs.close()
        # the validation loss against evaluate_dataset by hand on the
        # restored params of each step
        val_rel = {}
        for n in (4, 8):
            leg = file_io.load(str(ckpt / f"model.{n}"))
            model.set_param_tree(leg["params"])
            (res,) = evaluate_dataset(model, _val_data(), _val_methods(),
                                      batch_size=VAL_BATCH)
            want_v, got_v = res.result()[0], vals[n]["results"][0][0]
            val_rel[n] = abs(got_v - want_v) / abs(want_v)
            check(math.isfinite(got_v) and val_rel[n] <= VAL_REL_TOL,
                  f"validation loss at {n}: {got_v} vs by hand {want_v}")
        stats = opt.checkpoint_stats
        rec.update(
            losses=losses, checkpoint_files=names,
            leg_bytes={k: v for s in stats for k, v in s["bytes"].items()},
            serialize_s=[s["serialize_s"] for s in stats],
            blocked_s=[s["blocked_s"] for s in stats],
            background_write_s=opt.checkpoint_write_seconds,
            background_writes=opt.checkpoint_writes,
            validation={n: dict(loss=vals[n]["results"][0][0],
                                seconds=vals[n]["seconds"],
                                rel_vs_by_hand=val_rel[n]) for n in vals},
            launches_per_step=per_step[0],
            launches_validation_step=per_step[CKPT_EVERY - 1])
        del model, opt
        torch.cuda.empty_cache()
        print(f"phase 10 (a): losses {[round(x, 4) for x in losses]}; "
              f"legs {rec['leg_bytes']} bytes; serialize "
              f"{[round(s, 3) for s in rec['serialize_s']]} s on the step's "
              f"path, blocked {[round(s, 4) for s in rec['blocked_s']]} s, "
              f"background write {rec['background_write_s']:.3f} s for "
              f"{rec['background_writes']} checkpoints; verify of "
              f"{len(legs)} files {rec['verify_s']:.3f} s; crc on "
              f"{len(head)} bytes native {rec['native_crc_gb_s']:.3f} GB/s "
              f"vs table {rec['table_crc_gb_s'] * 1e3:.3f} MB/s; "
              f"validation { {n: (round(v['loss'], 6), round(v['seconds'], 3)) for n, v in rec['validation'].items()} } "
              f"(loss, s), rel vs by hand {val_rel}")

        # (b) resume: the uninterrupted steps once more, then a fresh
        # model (another seed) resumed from step 4
        again = _lm(torch, "cuda", L)
        opt2 = make_trainer(torch, again, B, T, iters, torch.bfloat16)
        RNG().set_seed(1)
        opt2.optimize()
        repeat = _params_cpu(again)
        del again
        deterministic = all(torch.equal(trained[n], repeat[n])
                            for n in trained)
        fresh = _lm(torch, "cuda", L, seed=7)
        res_marks = []
        opt3 = make_trainer(torch, fresh, B, T, iters, torch.bfloat16,
                            lambda s: res_marks.append(s.get("loss")))
        opt3.set_checkpoint(str(ckpt), several_iteration(10 * iters))
        RNG().set_seed(999)
        t0 = time.perf_counter()
        restored = opt3.resume_from_checkpoint(CKPT_EVERY)
        torch.cuda.synchronize()
        rec["resume_s"] = time.perf_counter() - t0
        check(restored and opt3.optim_method.state["neval"]
              == CKPT_EVERY + 1, "resume_from_checkpoint(4)")
        opt3.optimize()
        resumed = _params_cpu(fresh)
        del fresh, opt2, opt3
        torch.cuda.empty_cache()
        res_losses = res_marks[1:]
        first_diff = next((n for n in trained
                           if not torch.equal(trained[n], resumed[n])), None)
        rec["resume"] = dict(deterministic=deterministic,
                             losses=res_losses, first_differing=first_diff,
                             uninterrupted_losses=losses[CKPT_EVERY:])
        if deterministic:
            check(first_diff is None and res_losses == losses[CKPT_EVERY:],
                  f"resumed run differs from the uninterrupted one at "
                  f"{first_diff}: {res_losses} vs {losses[CKPT_EVERY:]}")
        else:
            ref = losses[CKPT_EVERY:]
            first_rel = abs(res_losses[0] - ref[0]) / abs(ref[0])
            dec_rel = decrease_rel_err(res_losses, ref)
            rec["resume"].update(first_rel=first_rel, decrease_rel=dec_rel)
            check(first_rel <= TRAIN_FIRST_REL_TOL
                  and dec_rel <= TRAIN_DECREASE_REL_TOL,
                  f"resumed losses {res_losses} vs {ref}")
        print(f"phase 10 (b): two uninterrupted runs bit for bit equal: "
              f"{deterministic}; resume {rec['resume_s']:.3f} s; resumed "
              f"losses {[round(x, 6) for x in res_losses]}, first "
              f"parameter that differs from the uninterrupted run: "
              f"{first_diff}")

        # (c) loss-spike rollback on the card
        rec["spike"] = _spike_leg(torch, tmp)
        check(rec["spike"]["rollbacks"] >= 1 and rec["spike"]["finite"]
              and rec["spike"]["spiked_records"] == 128,
              f"spike rollback {rec['spike']}")
        print(f"phase 10 (c): rollbacks {rec['spike']['rollbacks']}, "
              f"{rec['spike']['iterations']} iterations, every loss "
              f"finite: {rec['spike']['finite']}")

        # (d) the step-8 checkpoint into a live bf16 server
        prompts = np.random.RandomState(0).randint(
            1, V + 1, size=(BATCH, PROMPT_LENS[0])).astype(
                np.int32)[:SWAP_PROMPTS]
        serve_launch = want_launches(flash_fwd=L,
                                     layer_norm_fwd=(2 * L + 1) * SWAP_NEW)

        def streams(server, counted=False):
            before = {n: c.count for n, c in counters.items()}
            futs = [server.submit_generate(p, SWAP_NEW) for p in prompts]
            res = [f.result(timeout=600) for f in futs]
            check(all(r.ok for r in res),
                  f"swap statuses {[r.status.value for r in res]}")
            if counted:
                got = {n: c.count - before[n] for n, c in counters.items()}
                check(got == serve_launch, f"served batch launches {got}, "
                                           f"want {serve_launch}")
            return [np.asarray(r.output).tolist() for r in res]

        server = InferenceServer(_flagship(torch, "cuda"), max_batch=BATCH,
                                 generate_dtype=torch.bfloat16).start()
        try:
            old = streams(server, counted=True)
            assert server.swap_params(path=str(ckpt / "model.8"))
            swap_s = server.last_swap_s
            new = streams(server, counted=True)
            bad = ckpt / "model.9"
            shutil.copyfile(ckpt / "model.8", bad)
            shutil.copyfile(sidecar_path(str(ckpt / "model.8")),
                            sidecar_path(str(bad)))
            faults.bit_flip(str(bad))
            try:
                server.swap_params(path=str(bad))
                flipped = "installed"
            except SwapRejected as e:
                flipped = f"rejected: {e}"
            after_flip = streams(server)
            try:
                server.swap_params(params=faults.poison_params(
                    server.model.param_tree()))
                poisoned = "installed"
            except SwapRejected as e:
                poisoned = f"rejected: {e}"
            after_poison = streams(server)
        finally:
            server.stop(timeout=120)
        ref_model = _flagship(torch, "cuda")
        ref_model.set_param_tree(file_io.load(str(ckpt / "model.8"))
                                 ["params"])
        ref_server = InferenceServer(ref_model, max_batch=BATCH,
                                     generate_dtype=torch.bfloat16).start()
        try:
            want_new = streams(ref_server)
        finally:
            ref_server.stop(timeout=120)
        del ref_model
        torch.cuda.empty_cache()
        check(new == want_new, "swapped streams differ from a fresh "
                               "server's on the restored model")
        check(flipped.startswith("rejected") and "crc32c" in flipped
              and os.path.exists(str(bad) + ".corrupt")
              and after_flip == new, f"bit-flipped swap: {flipped}")
        check(poisoned.startswith("rejected") and after_poison == new,
              f"poisoned swap: {poisoned}")
        rec["swap"] = dict(verify_s=swap_s[0], canary_s=swap_s[1],
                           install_s=swap_s[2], streams_changed=new != old,
                           equal_fresh=new == want_new, bit_flip=flipped,
                           poison=poisoned, first_ids=[s[:8] for s in new])
        print(f"phase 10 (d): swap verify {swap_s[0]:.3f} s, canary "
              f"{swap_s[1]:.4f} s, install {swap_s[2]:.4f} s; streams = a "
              f"fresh server's on model.8: {new == want_new} (changed: "
              f"{new != old}); bit flip {flipped[:60]}; poison "
              f"{poisoned[:60]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = {n: c.count for n, c in counters.items()}
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10: {rec['seconds']:.1f} s; launches "
          f"{ {n: v for n, v in rec['launches'].items() if v} }")
    return rec, failures


# phase 11: the Torch-style API.  (a) 4 f32 steps of the flagship
# written with the verbs against LocalOptimizer's, phase 5's f32 limits
# (TRAJ_RTOL on the losses, TRAJ_UPDATE_ROW_TOL on each update row);
# (b) phase 5's bf16 cell with residual dropout 0.1, 8 steps, and a
# keep share within 5 sigma of 0.9 on one 16 x 1024 x 1024 mask;
# (c) a transposed LayerNorm input (K4's strided instantiation: its
# features are T apart) and a column-sliced attention input (K1-K3)
# read in place, bit for bit the contiguous input's; (d) every class
# ported with the API, card against CPU in f32 (``utils/api_cases.py``)
VERBS_ITERS, DROPOUT, DROPOUT_ITERS = 4, 0.1, 8
STRIDED_B = 16


def zoo_sweep(torch, cases=None, phase="11 (d)"):
    """Phase 11 (d), and 13 (d) on ``cases``: each case on the card
    against the CPU; every tensor the card's run returns must lie on the
    card.  The random layers also run in training mode on the card: the
    dropout mask and RReLU's slopes of ``backward`` are the forward's."""
    from bigdl_tpu_torch.nn.module import rng_scope
    from bigdl_tpu_torch.utils.api_cases import (ZOO_REL_TOL, rel_err,
                                                 zoo_case_on, zoo_cases)

    rows, failures = [], []
    for case in zoo_cases() if cases is None else cases:
        name = case[0]
        try:
            ref = zoo_case_on(case, "cpu")
            got = zoo_case_on(case, "cuda", module=ref[4]
                              if case[3] is None else None)
            on_card = all(t.device.type == "cuda" for t in got[3])
            err = max([rel_err(g, w) for part in range(3)
                       for g, w in zip(got[part], ref[part], strict=True)],
                      default=0.0)
            train_ok = True
            if case[4]:                 # the random layers, trained
                m = got[4].train()
                x = torch.randn(64, 64, device="cuda")
                with rng_scope(torch.Generator(device="cuda").manual_seed(0)):
                    y = m.forward(x)
                gi = m.update_grad_input(x, torch.ones_like(y))
                if name == "Dropout":
                    train_ok = bool(torch.equal(gi == 0, y == 0))
                else:
                    neg = x < 0
                    train_ok = bool(torch.allclose(gi[neg], y[neg] / x[neg],
                                                   rtol=1e-5))
            why = (None if on_card and err <= ZOO_REL_TOL and train_ok else
                   f"rel err {err:.3e} (tol {ZOO_REL_TOL}), on the card "
                   f"{on_card}, the forward's masks in backward {train_ok}")
        except Exception as e:          # a class that raises fails the phase
            err, on_card, train_ok = float("nan"), False, False
            why = f"{type(e).__name__}: {e}"
        rows.append(dict(name=name, rel_err=err, on_card=on_card,
                         train_ok=train_ok, ok=why is None))
        if why is not None:
            failures.append(f"phase {phase} {name}: {why}")
    return rows, failures


def _verbs_step_data(torch, opt):
    """The batches ``opt``'s loop would train on, in its order: the host
    stream seeded as ``run_training`` seeds it, one step seed drawn a
    step, the dataset shuffled at each epoch's end."""
    from bigdl_tpu_torch.optim.optimizer import _device_batch, _epoch_records
    from bigdl_tpu_torch.utils.rng import RNG, next_step_seed

    RNG().set_seed(1)
    ds, seen = opt.dataset, 0
    epoch = _epoch_records(ds)
    it = ds.data(train=True)
    while True:
        batch = next(it)
        next_step_seed()
        yield _device_batch(batch, opt.model.device)
        seen += batch.size()
        if seen >= epoch:
            seen = 0
            ds.shuffle()
            it = ds.data(train=True)


def verbs_vs_optimizer(torch):
    """Phase 11 (a): the flagship in f32, 4 steps written with the verbs
    against LocalOptimizer's 4 steps from the same weights and batches."""
    from bigdl_tpu_torch import nn

    L, B, T = FLAGSHIP["num_layers"], TRAIN_BATCH, TRAIN_T
    failures = []
    model = _lm(torch, "cuda", L)
    start = _params_cpu(model)
    ref = run_training(torch, model, B, T, VERBS_ITERS, None, updates=True)
    del model
    torch.cuda.empty_cache()

    counters = launch_counters()
    model = _lm(torch, "cuda", L)
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    opt = make_trainer(torch, model, B, T, VERBS_ITERS, None)
    model.train()
    losses, step_s, per_step = [], [], []
    data = _verbs_step_data(torch, opt)
    for _ in range(VERBS_ITERS):
        x, y = next(data)
        before = {n: c.count for n, c in counters.items()}
        t0 = time.perf_counter()
        model.zero_grad_parameters()
        out = model.forward(x)
        loss = crit.forward(out, y)
        g = crit.backward(out, y)
        model.backward(x, g)
        model.update_parameters(TRAIN_LR)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        per_step.append({n: c.count - before[n] for n, c in counters.items()})
        del out, g
    got = {n: (p.detach() - start[n].to(p.device)).cpu()
           for n, p in model.named_parameters()}
    bitwise = all(torch.equal(got[n], ref["updates"][n]) for n in got) \
        and losses == ref["losses"]
    del model
    torch.cuda.empty_cache()

    want = want_launches(flash_fwd=L, flash_bwd_dkv=L, flash_bwd_dq=L,
                         layer_norm_fwd=2 * L + 1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                      ref["losses"]))
    scale = max(max_row_norm(torch, u) for u in ref["updates"].values())
    upd_err = {n: row_rel_err(torch, got[n], u, scale)
               for n, u in ref["updates"].items()}
    worst = max(upd_err, key=upd_err.get)
    ms = 1e3 * sum(step_s[1:]) / (VERBS_ITERS - 1)
    ref_ms = 1e3 * sum(ref["step_s"][1:]) / (VERBS_ITERS - 1)
    print(f"phase 11 (a): verbs f32 losses {losses} vs LocalOptimizer "
          f"{ref['losses']}: max rel {loss_rel:.3e} (tol {TRAJ_RTOL}); "
          f"updates of {len(got)} parameters, worst row err "
          f"{upd_err[worst]:.3e} in {worst} (tol {TRAJ_UPDATE_ROW_TOL}); "
          f"bit for bit: {bitwise}; step {ms:.2f} ms vs LocalOptimizer "
          f"{ref_ms:.2f} ms (steps 2-{VERBS_ITERS}); launches per step "
          f"{ {n: v for n, v in per_step[0].items() if v} }")
    if len(losses) != VERBS_ITERS or not loss_rel <= TRAJ_RTOL:
        failures.append(f"phase 11 (a) losses {losses} vs {ref['losses']}")
    if not upd_err[worst] <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"phase 11 (a) {worst} row err {upd_err[worst]:.3e}")
    bad = [s for s in per_step if s != want]
    if bad:
        failures.append(f"phase 11 (a) launches per step {bad[0]}, want "
                        f"{want}")
    return dict(losses=losses, optimizer_losses=ref["losses"],
                loss_rel=loss_rel, update_row_err=upd_err[worst],
                worst=worst, bitwise=bitwise, step_ms=ms,
                optimizer_step_ms=ref_ms, launches_per_step=per_step[0],
                forwards_per_step=1), failures


def dropout_leg(torch, bf16_step_ms):
    """Phase 11 (b): phase 5's bf16 cell with residual dropout 0.1; one
    step traced with dropout and one without, in this call."""
    from bigdl_tpu_torch.nn.dropout import dropout
    from bigdl_tpu_torch.nn.module import rng_scope

    cfg, L, B, T = FLAGSHIP, FLAGSHIP["num_layers"], TRAIN_BATCH, TRAIN_T
    failures = []

    def lm(p):
        return _lm(torch, "cuda", L, dropout=p)

    model = lm(DROPOUT)
    run = run_training(torch, model, B, T, DROPOUT_ITERS, torch.bfloat16)
    losses = run["losses"]
    want = want_launches(flash_fwd=L, flash_bwd_dkv=L, flash_bwd_dq=L,
                         layer_norm_fwd=2 * L + 1)
    if len(losses) != DROPOUT_ITERS or not all(math.isfinite(v)
                                               for v in losses):
        failures.append(f"phase 11 (b) losses {losses}")
    elif not losses[-1] < losses[0]:
        failures.append(f"phase 11 (b) loss did not fall: {losses}")
    bad = [s for s in run["launches_per_step"] if s != want]
    if bad:
        failures.append(f"phase 11 (b) launches per step {bad[0]}, want "
                        f"{want}")
    steady = run["step_s"][2:]
    ms = 1e3 * sum(steady) / len(steady)

    x = torch.randint(1, cfg["vocab"] + 1, (2, T),
                      generator=torch.Generator().manual_seed(3)).to("cuda")
    plain = lm(0.0)
    plain.set_param_tree(model.param_tree())
    with torch.no_grad():
        eval_equal = bool(torch.equal(model.evaluate().forward(x),
                                      plain.evaluate().forward(x)))
        model.train()
        outs = []
        for seed in (5, 5, 6):
            with rng_scope(torch.Generator(device="cuda").manual_seed(seed)):
                outs.append(model.forward(x))
        same_seed = bool(torch.equal(outs[0], outs[1]))
        other_seed = not bool(torch.equal(outs[0], outs[2]))
    del model, plain, outs
    torch.cuda.empty_cache()
    n = B * T * cfg["embed_dim"]
    mask = dropout(torch.ones(B, T, cfg["embed_dim"], device="cuda"),
                   DROPOUT, torch.Generator(device="cuda").manual_seed(0))
    keep = (mask != 0).float().mean().item()
    del mask
    sigma = math.sqrt((1 - DROPOUT) * DROPOUT / n)
    keep_ok = abs(keep - (1 - DROPOUT)) <= 5 * sigma
    print(f"phase 11 (b): dropout {DROPOUT}, bf16, B {B} T {T}: losses "
          f"{[round(v, 4) for v in losses]}; launches per step "
          f"{ {k: v for k, v in run['launches_per_step'][0].items() if v} }; "
          f"step {ms:.2f} ms (iterations 3-{DROPOUT_ITERS}) vs phase 5's "
          f"{bf16_step_ms:.2f} ms; eval = dropout-0 model bit for bit: "
          f"{eval_equal}; one seed twice equal: {same_seed}, two seeds "
          f"differ: {other_seed}; keep share {keep:.6f} (0.9 +- "
          f"{5 * sigma:.2e})")
    # where the dropout step's extra time goes: one step traced with
    # dropout and one without, each after two warm iterations
    traced = {"dropout": profile_training(torch, dropout=DROPOUT),
              "plain": profile_training(torch)}
    groups = {k: traced["dropout"]["groups"].get(k, {}).get("ms", 0.0)
              - traced["plain"]["groups"].get(k, {}).get("ms", 0.0)
              for k in set(traced["dropout"]["groups"])
              | set(traced["plain"]["groups"])}
    print(f"phase 11 (b): traced step with dropout: wall "
          f"{traced['dropout']['wall_ms']:.3f} ms, device "
          f"{traced['dropout']['device_ms']:.3f} ms, "
          f"{traced['dropout']['launches']} launches; without: wall "
          f"{traced['plain']['wall_ms']:.3f}, device "
          f"{traced['plain']['device_ms']:.3f}, "
          f"{traced['plain']['launches']} launches; device ms added by "
          f"group { {k: round(v, 3) for k, v in groups.items()} }")
    for ok, what in ((eval_equal, "eval forward differs from the dropout-0 "
                                  "model's"),
                     (same_seed, "one generator seed gave two masks"),
                     (other_seed, "two generator seeds gave one mask"),
                     (keep_ok, f"keep share {keep}")):
        if not ok:
            failures.append(f"phase 11 (b) {what}")
    return dict(losses=losses, step_ms=ms, phase5_bf16_step_ms=bf16_step_ms,
                launches_per_step=run["launches_per_step"][0],
                eval_equal=eval_equal, same_seed=same_seed,
                other_seed_differs=other_seed, keep_share=keep,
                keep_sigma=sigma, traced=traced), failures


def strided_leg(torch):
    """Phase 11 (c): ``Sequential(Transpose([(2, 3)]), LayerNorm(1024))``
    on [B, 1024, T] and a ``Narrow`` column slice into flash attention,
    bf16 and f32: each kernel reads the view in place (the transposed
    view's features are T apart: K4's strided instantiation), and each
    output equals the contiguous input's bit for bit.  The strided K4 is
    held against the plain version at phase 3's K4 limit and timed
    beside the route it replaces (a copy, then the row-pitched K4), the
    copy alone, the row-pitched K4 on the contiguous input, the plain
    version and ``F.layer_norm`` on the view."""
    import torch.nn.functional as F

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops import layer_norm as ln
    from bigdl_tpu_torch.optim.optimizer import cast_floats
    from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map

    D, H, T, B = FLAGSHIP["embed_dim"], FLAGSHIP["num_heads"], TRAIN_T, \
        STRIDED_B
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, failures = [], []
    counters = launch_counters()

    def run(model, params, x, go):
        for c in counters.values():
            c.reset()
        with torch.enable_grad():
            params = tree_map(lambda p: p.detach().requires_grad_(), params)
            out = model.apply_fn(params, x)
            grads = torch.autograd.grad(out, tree_leaves(params), go)
        torch.cuda.synchronize()
        return out.detach(), grads, {n: c.count for n, c in counters.items()}

    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        seq = nn.Sequential(nn.Transpose([(2, 3)], device="cuda"),
                            nn.LayerNorm(D, device="cuda"))
        with torch.no_grad():
            seq[1].weight.normal_(1.0, 0.1, generator=g)
            seq[1].bias.normal_(0.0, 0.1, generator=g)
        x = torch.randn(B, D, T, device="cuda", generator=g).to(dt)
        params = cast_floats(seq.param_tree(), dt)
        go = torch.randn(B, T, D, device="cuda", generator=g).to(dt)
        y, gr, n = run(seq, params, x, go)
        xc = x.transpose(1, 2).contiguous()
        y_ref, gr_ref, _ = run(seq[1], params["1"], xc, go)
        xv, gm, bt = x.transpose(1, 2), params["1"]["weight"], \
            params["1"]["bias"]
        err = (y.float() - ln._layer_norm_plain(
            xv, gm, bt, 1e-5).float()).abs().max().item()
        tol = TOL[("layer_norm_fwd", dname)]
        rows.append(leg_row(
            f"transpose+layernorm {dname}", n, y, y_ref, gr, gr_ref,
            n["layer_norm_fwd"] == 1 and n["layer_norm_fwd_strided"] == 1
            and n["layer_norm_x_copies"] == 0 and err <= tol))
        # the strided K4 on the view, beside the copy route it replaces,
        # that route's parts, the plain version and F.layer_norm
        rows[-1].update(
            ms=cuda_ms(lambda: ln._layer_norm_cuda(xv, gm, bt, 1e-5)),
            copy_route_ms=cuda_ms(lambda: ln._layer_norm_cuda(
                xv.contiguous(), gm, bt, 1e-5)),
            copy_ms=cuda_ms(lambda: xv.contiguous()),
            contiguous_ms=cuda_ms(lambda: ln._layer_norm_cuda(xc, gm, bt,
                                                              1e-5)),
            plain_ms=cuda_ms(lambda: ln._layer_norm_plain(xv, gm, bt, 1e-5)),
            library_ms=cuda_ms(lambda: F.layer_norm(xv, (D,), gm, bt, 1e-5)),
            max_abs_err=err, tol=tol)
        rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound(
            x.element_size() * (2 * B * T * D + 2 * D), 8.0 * B * T * D,
            "float32")

        mha = nn.Sequential(nn.Narrow(3, 1, D, device="cuda"),
                            nn.MultiHeadAttention(
                                D, H, causal=True, seq_strategy="flash",
                                device="cuda",
                                generator=torch.Generator().manual_seed(1)))
        x = torch.randn(B, T, 2 * D, device="cuda", generator=g).to(dt)
        params = cast_floats(mha.param_tree(), dt)
        go = torch.randn(B, T, D, device="cuda", generator=g).to(dt)
        y, gr, n = run(mha, params, x, go)
        y_ref, gr_ref, _ = run(mha[1], params["1"],
                               x.narrow(2, 0, D).contiguous(), go)
        rows.append(leg_row(
            f"narrow+flash attention {dname}", n, y, y_ref, gr, gr_ref,
            n["flash_fwd"] == 1 and n["flash_bwd_dkv"] == 1
            and n["flash_bwd_dq"] == 1 and n["attn_operand_copies"] == 0))
    for r in rows:
        timing = (f"; K4 strided {r['ms']:.4f} ms, the copy route "
                  f"{r['copy_route_ms']:.4f} (the copy {r['copy_ms']:.4f}, "
                  f"K4 on the contiguous input {r['contiguous_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f}, "
                  f"F.layer_norm {r['library_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}), err vs plain "
                  f"{r['max_abs_err']:.3e} (tol {r['tol']:g})"
                  if "ms" in r else "")
        print(f"phase 11 (c): {r['case']}: launches {r['launches']}; as "
              f"designed {r['as_designed']}; output bit for bit the "
              f"contiguous input's: {r['output_bitwise']}; parameter "
              f"gradients bit for bit: {r['grads_bitwise']} (worst rel "
              f"{r['grad_rel']:.3e}){timing}")
        if not (r["as_designed"] and r["output_bitwise"]):
            failures.append(f"phase 11 (c) {r['case']}: {r}")
    return rows, failures


def leg_row(case, launches, y, y_ref, grads, grads_ref, as_designed):
    """A phase 11 (c) case: ``as_designed`` (each kernel launched once,
    the copies as the route makes them, the error within its limit),
    whether the output is the contiguous input's bit for bit; the
    parameter gradients (the backward's own reductions over the two
    layouts) are reported, bitwise or by their worst relative error."""
    import torch

    from bigdl_tpu_torch.utils.api_cases import rel_err

    return dict(case=case, launches={k: v for k, v in launches.items() if v},
                as_designed=bool(as_designed),
                output_bitwise=bool(torch.equal(y, y_ref)),
                grads_bitwise=all(bool(torch.equal(a, b))
                                  for a, b in zip(grads, grads_ref)),
                grad_rel=max(rel_err(a, b)
                             for a, b in zip(grads, grads_ref)))


def torch_api(torch, bf16_step_ms):
    """Phase 11: the Torch-style API, (a)-(d).  Returns (record,
    failures); the record's ``launches`` are the whole phase's, read from
    zero."""
    from bigdl_tpu_torch.utils.api_cases import (ZOO_REL_TOL, rel_err,
                                                 tensor_ops)

    failures, rec = [], {}
    t_phase = time.perf_counter()
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    totals = {n: 0 for n in counters}

    def bank():
        # bank each leg's launches, read from zero
        for n, c in counters.items():
            totals[n] += c.count
            c.reset()

    rec["verbs"], more = verbs_vs_optimizer(torch)
    failures += more
    bank()
    rec["dropout"], more = dropout_leg(torch, bf16_step_ms)
    failures += more
    bank()
    rec["strided"], more = strided_leg(torch)
    failures += more
    # (c)'s path launches are its view runs', not the contiguous
    # references' or the timing's
    for c in counters.values():
        c.reset()
    for r in rec["strided"]:
        for n, v in r["launches"].items():
            totals[n] += v
    rows, more = zoo_sweep(torch)
    failures += more
    bank()
    worst = max(rows, key=lambda r: r["rel_err"]
                if math.isfinite(r["rel_err"]) else float("inf"))
    print(f"phase 11 (d): {len(rows)} classes card vs CPU, forward and "
          f"backward f32: {sum(r['ok'] for r in rows)} within {ZOO_REL_TOL}, "
          f"every tensor on the card, worst {worst['rel_err']:.3e} "
          f"({worst['name']})")
    got, on_card = tensor_ops("cuda")
    want, _ = tensor_ops("cpu")
    t_err = {k: rel_err(got[k], want[k]) for k in want}
    t_worst = max(t_err, key=t_err.get)
    print(f"phase 11 (d): {len(t_err)} Tensor ops card vs CPU, worst "
          f"{t_err[t_worst]:.3e} ({t_worst}), on the card: {on_card}")
    if not on_card or not t_err[t_worst] <= ZOO_REL_TOL:
        failures.append(f"phase 11 (d) Tensor {t_worst} {t_err[t_worst]} "
                        f"on card {on_card}")
    rec["zoo"] = rows
    rec["tensor_ops"] = t_err
    rec["launches"] = totals
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {rec['seconds']:.1f} s; launches "
          f"{ {n: v for n, v in totals.items() if v} }")
    return rec, failures


# phase 12: training breadth.  (a) phase 5's cell with remat beside it
# without, same weights, one call; (b) the same with dropout 0.1, 2
# steps each from the same step seeds; (c) seq_strategy="block" at
# block 512 in bf16, and its 2-layer copy at block 64, card vs CPU;
# (d) the optim methods, a schedule, regularizers and a gradient scale
# on the 2-layer copy, card vs CPU; (e) LBFGS on Rosenbrock.  The limits
# are phase 5's (and phase 6's first-loss limit for "block" vs flash);
# remat's first loss and its dropout losses are held bit for bit.
BREADTH_DROPOUT, BREADTH_DROPOUT_ITERS = 0.1, 2
BLOCK_SIZE, SMALL_BLOCK_SIZE = 512, 64
LBFGS_POINTS, LBFGS_REL_TOL, ROSEN_TOL = 5, 1e-5, 1e-2


def _flagship_run(torch, model, iters, dtype=None):
    """``run_training`` of ``model`` on phase 5's batch, with the peak
    memory of the run (read from a reset), and the parameters' updates
    taken on the CPU (so no device copy adds to the peak)."""
    B, T = TRAIN_BATCH, TRAIN_T
    start = _params_cpu(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = run_training(torch, model, B, T, iters, dtype or torch.bfloat16)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["updates"] = {n: p.detach().to("cpu", copy=True) - start[n]
                      for n, p in model.named_parameters()}
    steady = rec["step_s"][2:] or rec["step_s"][1:]
    rec["step_ms"] = 1e3 * sum(steady) / len(steady)
    return rec


def _update_err(torch, got, want, skip=()):
    """The worst parameter's ``row_rel_err`` of ``got``'s updates against
    ``want``'s, at the largest update row's scale (phase 5's reading)."""
    scale = max(max_row_norm(torch, u) for u in want.values())
    err = {n: row_rel_err(torch, got[n], u, scale)
           for n, u in want.items() if not any(s in n for s in skip)}
    worst = max(err, key=err.get)
    return worst, err[worst]


def _nz(counts):
    return {n: v for n, v in counts.items() if v}


def _same_bits(torch, a, b):
    return all(torch.equal(a[n], b[n]) for n in b)


def remat_leg(torch):
    """Phase 12 (a), (b)."""
    L = FLAGSHIP["num_layers"]
    failures = []
    runs = {}
    for remat in (False, True):
        model = _lm(torch, "cuda", L, remat=remat)
        runs[remat] = _flagship_run(torch, model, TRAIN_ITERS)
        if remat:
            # the eval forward: one K1 per layer, one K4 per norm
            counters = launch_counters()
            for c in counters.values():
                c.reset()
            model.evaluate()
            x = torch.randint(1, FLAGSHIP["vocab"] + 1, (2, TRAIN_T),
                              generator=torch.Generator().manual_seed(0),
                              dtype=torch.int32).cuda()
            with torch.no_grad():
                y = model(x)
            torch.cuda.synchronize()
            eval_launches = {n: c.count for n, c in counters.items()}
            eval_ok = bool(torch.isfinite(y).all())
            del y
        del model
        torch.cuda.empty_cache()
    plain, rm = runs[False], runs[True]
    losses = rm["losses"]
    want = want_launches(flash_fwd=2 * L, flash_bwd_dkv=L, flash_bwd_dq=L,
                         layer_norm_fwd=4 * L + 1)
    want_eval = want_launches(flash_fwd=L, layer_norm_fwd=2 * L + 1)
    dec_rel = decrease_rel_err(losses, plain["losses"])
    worst, upd = _update_err(torch, rm["updates"], plain["updates"])
    bitwise = losses == plain["losses"] and _same_bits(
        torch, rm["updates"], plain["updates"])
    print(f"phase 12 (a): remat bf16, B {TRAIN_BATCH} T {TRAIN_T}: losses "
          f"{[round(v, 4) for v in losses]}; first loss = plain's bit for "
          f"bit: {losses[0] == plain['losses'][0]}; decreases worst rel "
          f"{dec_rel:.3e} (tol {TRAIN_DECREASE_REL_TOL}); updates worst row "
          f"err {upd:.3e} in {worst} (tol {TRAJ_UPDATE_ROW_TOL}); bit for "
          f"bit: {bitwise}; step {rm['step_ms']:.2f} ms, peak "
          f"{rm['peak_gb']:.2f} GB vs plain {plain['step_ms']:.2f} ms, "
          f"{plain['peak_gb']:.2f} GB; launches per step "
          f"{_nz(rm['launches_per_step'][0])}; eval forward "
          f"{_nz(eval_launches)}")
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(v)
                                             for v in losses):
        failures.append(f"phase 12 (a) losses {losses}")
    if rm["skipped_steps"] or plain["skipped_steps"]:
        failures.append("phase 12 (a) skipped steps")
    if not losses[-1] < losses[0]:
        failures.append(f"phase 12 (a) loss did not fall: {losses}")
    bad = [st for st in rm["launches_per_step"] if st != want]
    if bad:
        failures.append(f"phase 12 (a) launches per step {_nz(bad[0])}, "
                        f"want {_nz(want)}")
    if losses[0] != plain["losses"][0]:
        failures.append(f"phase 12 (a) first loss {losses[0]} vs plain "
                        f"{plain['losses'][0]}")
    if not dec_rel <= TRAIN_DECREASE_REL_TOL:
        failures.append(f"phase 12 (a) decreases rel {dec_rel:.3e}")
    if not upd <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"phase 12 (a) {worst} row err {upd:.3e}")
    if eval_launches != want_eval or not eval_ok:
        failures.append(f"phase 12 (a) eval forward launches "
                        f"{_nz(eval_launches)}, finite {eval_ok}")
    rec = dict(
        remat=dict(losses=losses, step_ms=rm["step_ms"],
                   peak_memory_gb=rm["peak_gb"], step_s=rm["step_s"],
                   launches_per_step=rm["launches_per_step"][0]),
        plain=dict(losses=plain["losses"], step_ms=plain["step_ms"],
                   peak_memory_gb=plain["peak_gb"], step_s=plain["step_s"]),
        decrease_rel=dec_rel, update_row_err=upd, worst=worst,
        bitwise=bitwise, eval_launches=eval_launches)
    launches = {n: rm["launches"][n] + plain["launches"][n]
                for n in rm["launches"]}
    for n, v in eval_launches.items():
        launches[n] += v

    # (b) dropout 0.1: remat's recompute must draw the forward's masks
    drop = {}
    for remat in (False, True):
        model = _lm(torch, "cuda", L, dropout=BREADTH_DROPOUT, remat=remat)
        drop[remat] = _flagship_run(torch, model, BREADTH_DROPOUT_ITERS)
        del model
        torch.cuda.empty_cache()
        for n, v in drop[remat]["launches"].items():
            launches[n] += v
    d_plain, d_rm = drop[False], drop[True]
    worst_d, upd_d = _update_err(torch, d_rm["updates"], d_plain["updates"])
    d_bitwise = _same_bits(torch, d_rm["updates"], d_plain["updates"])
    print(f"phase 12 (b): dropout {BREADTH_DROPOUT}, {BREADTH_DROPOUT_ITERS} "
          f"steps: losses remat {d_rm['losses']} plain {d_plain['losses']}; "
          f"updates worst row err {upd_d:.3e} in {worst_d}; bit for bit: "
          f"{d_bitwise}")
    if d_rm["losses"] != d_plain["losses"] \
            or len(d_rm["losses"]) != BREADTH_DROPOUT_ITERS:
        failures.append(f"phase 12 (b) losses {d_rm['losses']} vs "
                        f"{d_plain['losses']}")
    if not upd_d <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"phase 12 (b) {worst_d} row err {upd_d:.3e}")
    rec["dropout"] = dict(remat_losses=d_rm["losses"],
                          plain_losses=d_plain["losses"],
                          update_row_err=upd_d, worst=worst_d,
                          bitwise=d_bitwise)
    rec["launches"] = launches
    return rec, plain, failures


def _tensor_err(torch, got, want, skip=()):
    """The worst parameter's ||got - want|| / ||want|| over the whole
    tensor (parameters whose update is 0 on both sides read 0)."""
    err = {}
    for n, u in want.items():
        if any(k in n for k in skip):
            continue
        d = torch.linalg.vector_norm((got[n] - u).float()).item()
        r = torch.linalg.vector_norm(u.float()).item()
        err[n] = d / r if r else d
    worst = max(err, key=err.get)
    return worst, err[worst]


def _small_card_vs_cpu(torch, label, make, method=None, iters=SMALL_ITERS,
                       adaptive=0.0, loss_ulps=0, phase="12"):
    """``make(device)``'s model trained ``iters`` steps in f32 on the card
    and on the CPU (phase 5's 2-layer copy and batch), held to phase 5's
    limits: the losses, the decreases and every update row by row.
    ``method()`` builds a fresh optim method a run; each step's learning
    rate is recorded.

    ``adaptive`` (its learning rate, else 0): the method divides each
    gradient element by its own size (Adagrad, Adamax, RMSprop, Adam),
    so an element whose gradient is rounding noise (a cancelling sum)
    moves by about lr in a direction of its own on each side, and one
    such element is 1/sqrt(F) of a row's update: the updates are held at
    the same limit over each whole tensor instead (the row-by-row reading
    is reported), and the key bias ``bk``, whose gradient is zero in
    exact arithmetic, by its size (at most 10 lr a step; RMSprop's first
    step is 10 lr).
    ``loss_ulps``: the decreases are held to phase 5's limit plus that
    many f32 ulps of the first loss, where a penalty makes the logged
    loss too large for f32 to resolve a decrease to the limit."""
    runs, lrs = {}, {}
    for dev in ("cuda", "cpu"):
        m = method() if method is not None else None
        if m is not None:
            step, lrs[dev] = m.step, []

            def rec_step(g, p, s, lr, _step=step, _lrs=lrs[dev]):
                _lrs.append(lr)
                return _step(g, p, s, lr)
            m.step = rec_step
        runs[dev] = run_training(torch, make(dev), SMALL_BATCH, SMALL_T,
                                 iters, None, updates=True, method=m)
    card, cpu = runs["cuda"]["losses"], runs["cpu"]["losses"]
    got, want = runs["cuda"]["updates"], runs["cpu"]["updates"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    dec = decrease_rel_err(card, cpu)
    floor = loss_ulps * _f32_ulp(cpu[0])
    dec_abs = max(abs((a - card[0]) - (b - cpu[0]))
                  for a, b in zip(card[1:], cpu[1:]))
    dec_ok = all(abs((a - card[0]) - (b - cpu[0]))
                 <= TRAJ_DECREASE_REL_TOL * abs(b - cpu[0]) + floor
                 for a, b in zip(card[1:], cpu[1:]))
    skip = (".bk",) if adaptive else ()
    worst, upd = _update_err(torch, got, want, skip)
    held, held_err = (_tensor_err(torch, got, want, skip) if adaptive
                      else (worst, upd))
    failures = []
    if len(card) != iters or not rel <= TRAJ_RTOL:
        failures.append(f"phase {phase} {label}: losses {card} vs {cpu}")
    if not dec_ok:
        failures.append(f"phase {phase} {label}: decreases rel {dec:.3e} (abs "
                        f"{dec_abs:.3e}, floor {floor:.3e})")
    if not held_err <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"phase {phase} {label}: {held} err {held_err:.3e}")
    bk = None
    if adaptive:
        bk = max(u.abs().max().item() for n, u in got.items() if ".bk" in n)
        if not bk <= 10 * adaptive * iters:
            failures.append(f"phase {phase} {label}: bk moved {bk:.3e}")
    if runs["cuda"]["skipped_steps"] or runs["cpu"]["skipped_steps"]:
        failures.append(f"phase {phase} {label}: skipped steps")
    rec = dict(card_losses=card, cpu_losses=cpu, max_rel=rel,
               decrease_rel=dec, decrease_abs=dec_abs,
               decrease_floor=floor, update_row_err=upd, worst=worst,
               held_by="tensor" if adaptive else "row",
               update_err=held_err, held_worst=held, bk_max_update=bk,
               lrs=lrs.get("cuda"), cpu_lrs=lrs.get("cpu"),
               launches=runs["cuda"]["launches"])
    print(f"phase {phase} {label}: losses card {card} cpu {cpu}: max rel "
          f"{rel:.3e}, decreases {dec:.3e} (abs {dec_abs:.3e}"
          + (f", floor {floor:.3e}" if floor else "") + "), updates worst "
          f"row err {upd:.3e} in {worst}"
          + (f", worst tensor err {held_err:.3e} in {held}, bk max "
             f"{bk:.3e}" if adaptive else "")
          + (f"; lr {rec['lrs']}" if rec["lrs"] else ""))
    return rec, failures


def _f32_ulp(x: float) -> float:
    """One f32 ulp at |x|."""
    import numpy as np

    return float(np.spacing(np.float32(abs(x))))


def block_leg(torch, plain):
    """Phase 12 (c): "block" attention on the flagship against (a)'s flash
    run, and its 2-layer copy at block 64, card vs CPU."""
    L = FLAGSHIP["num_layers"]
    failures = []
    model = _lm(torch, "cuda", L, seq_strategy="block")
    run = _flagship_run(torch, model, TRAIN_ITERS)
    del model
    torch.cuda.empty_cache()
    losses = run["losses"]
    want = want_launches(layer_norm_fwd=2 * L + 1)
    first_rel = abs(losses[0] - plain["losses"][0]) / abs(plain["losses"][0])
    dec_rel = decrease_rel_err(losses, plain["losses"])
    print(f"phase 12 (c): block {BLOCK_SIZE} bf16: losses "
          f"{[round(v, 4) for v in losses]}; first loss vs flash rel "
          f"{first_rel:.3e} (tol {BS_FIRST_REL_TOL}); decreases worst rel "
          f"{dec_rel:.3e} (tol {TRAIN_DECREASE_REL_TOL}); step "
          f"{run['step_ms']:.2f} ms, peak {run['peak_gb']:.2f} GB vs flash "
          f"{plain['step_ms']:.2f} ms, {plain['peak_gb']:.2f} GB; launches "
          f"per step {_nz(run['launches_per_step'][0])}")
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(v)
                                             for v in losses) \
            or not losses[-1] < losses[0] or run["skipped_steps"]:
        failures.append(f"phase 12 (c) losses {losses}")
    bad = [st for st in run["launches_per_step"] if st != want]
    if bad:
        failures.append(f"phase 12 (c) launches per step {_nz(bad[0])}, "
                        f"want {_nz(want)}")
    if not first_rel <= BS_FIRST_REL_TOL:
        failures.append(f"phase 12 (c) first loss rel {first_rel:.3e}")
    if not dec_rel <= TRAIN_DECREASE_REL_TOL:
        failures.append(f"phase 12 (c) decreases rel {dec_rel:.3e}")

    def small(dev):
        m = _lm(torch, dev, SMALL_LAYERS, seq_strategy="block")
        for blk in m.blocks:
            blk[1].block_size = SMALL_BLOCK_SIZE
        return m

    small_rec, more = _small_card_vs_cpu(torch, f"(c) block "
                                         f"{SMALL_BLOCK_SIZE} 2-layer",
                                         small)
    failures += more
    launches = dict(run["launches"])
    for n, v in small_rec["launches"].items():
        launches[n] += v
    return dict(losses=losses, step_ms=run["step_ms"],
                peak_memory_gb=run["peak_gb"], step_s=run["step_s"],
                first_rel=first_rel, decrease_rel=dec_rel,
                launches_per_step=run["launches_per_step"][0],
                small=small_rec, launches=launches), failures


def optim_methods_leg(torch):
    """Phase 12 (d): each optim method on the 2-layer copy, card vs CPU,
    each step's learning rate equal to its schedule's."""
    from bigdl_tpu_torch.optim import (SGD, Adadelta, Adagrad, Adamax,
                                       L1L2Regularizer, RMSprop, Step,
                                       TorchOptimMethod)

    # phase 5's 2-layer copy, built once: each run takes a copy
    master = _lm(torch, "cpu", SMALL_LAYERS)

    def plain(dev):
        return copy.deepcopy(master)._place(torch.device(dev))

    def regularized(dev):
        m = plain(dev)
        head = m[len(m) - 1]
        m[0].w_regularizer = L1L2Regularizer(1e-4, 1e-4)
        head.w_regularizer = L1L2Regularizer(1e-4, 1e-4)
        head.b_regularizer = L1L2Regularizer(1e-4, 1e-4)
        head.set_scale_w(0.5)
        return m

    n = SMALL_ITERS
    # (label, method factory, model, each step's lr, the rate of an
    # adaptive method (see _small_card_vs_cpu) or 0, loss ulps).
    # The adaptive methods' rates keep each step a small move of the
    # loss (at 1e-2 Adagrad's first step halves it).  The regularized
    # run's logged loss is ~4316 (the embedding's N(0, 1) weights under
    # L1 and L2 1e-4), where one f32 ulp is 4.9e-4, a sixth of a step's
    # decrease: its decreases are held to phase 5's limit plus 2 ulps of
    # that loss
    cases = (
        ("Adagrad", lambda: Adagrad(1e-4), plain, [1e-4] * n, 1e-4, 0),
        ("Adadelta", lambda: Adadelta(), plain, [1.0] * n, 0.0, 0),
        ("Adamax", lambda: Adamax(1e-4), plain, [1e-4] * n, 1e-4, 0),
        ("RMSprop", lambda: RMSprop(1e-5), plain, [1e-5] * n, 1e-5, 0),
        # the bridge's lr is the multiplier 1.0; Adam's own is 1e-4
        ("TorchOptimMethod(Adam)",
         lambda: TorchOptimMethod(torch.optim.Adam, lr=1e-4), plain,
         [1.0] * n, 1e-4, 0),
        ("SGD momentum + Step + L1L2 + scale_w",
         lambda: SGD(TRAIN_LR, momentum=0.9,
                     learning_rate_schedule=Step(2, 0.5)),
         regularized, [TRAIN_LR * 0.5 ** (k // 2) for k in range(n)],
         0.0, 2))
    failures, rows = [], []
    launches = {c: 0 for c in launch_counters()}
    for label, method, make, want_lr, adaptive, ulps in cases:
        t0 = time.perf_counter()
        rec, more = _small_card_vs_cpu(torch, f"(d) {label}", make, method,
                                       adaptive=adaptive, loss_ulps=ulps)
        rec.update(label=label, seconds=time.perf_counter() - t0)
        failures += more
        if rec["lrs"] != want_lr or rec["cpu_lrs"] != want_lr:
            failures.append(f"phase 12 (d) {label}: lr {rec['lrs']} / "
                            f"{rec['cpu_lrs']}, want {want_lr}")
        for k, v in rec.pop("launches").items():
            launches[k] += v
        rows.append(rec)
    return rows, launches, failures


def lbfgs_leg(torch):
    """Phase 12 (e): LBFGS with the line search on the 4-dimensional
    Rosenbrock function in f32, on the card and on the CPU
    (tests/test_local_optimizer.py:161)."""
    from bigdl_tpu_torch.optim import LBFGS

    def run(dev):
        points = []

        def feval(x):
            points.append(x.detach().to("cpu", copy=True))
            a, b = x[:-1], x[1:]
            r = b - a * a
            f = torch.sum(100.0 * r * r + (1 - a) ** 2)
            g = torch.zeros_like(x)
            g[:-1] += -400.0 * a * r - 2.0 * (1 - a)
            g[1:] += 200.0 * r
            return float(f), g

        lbfgs = LBFGS(max_iter=100, learning_rate=0.5, line_search=True)
        x = torch.zeros(4, device=dev)
        for _ in range(20):
            x, _ = lbfgs.optimize(feval, x)
        return feval(x)[0], points

    def rel_of(a, b):
        d = float((a - b).abs().max())
        return d / max(float(b.abs().max()), 1e-30) if d else 0.0

    f_card, p_card = run("cuda")
    f_cpu, p_cpu = run("cpu")
    rel = max(rel_of(a, b) for a, b in zip(p_card[:LBFGS_POINTS],
                                           p_cpu[:LBFGS_POINTS]))
    print(f"phase 12 (e): LBFGS Rosenbrock f32: f {f_card:.3e} card, "
          f"{f_cpu:.3e} cpu (tol {ROSEN_TOL}); first {LBFGS_POINTS} points "
          f"evaluated, card vs cpu max rel {rel:.3e} (tol {LBFGS_REL_TOL}); "
          f"{len(p_card)} and {len(p_cpu)} evaluations")
    failures = []
    if not f_card < ROSEN_TOL:
        failures.append(f"phase 12 (e) Rosenbrock {f_card}")
    if len(p_card) < LBFGS_POINTS or not rel <= LBFGS_REL_TOL:
        failures.append(f"phase 12 (e) points card vs cpu rel {rel:.3e}")
    return dict(f_card=f_card, f_cpu=f_cpu, points_rel=rel,
                evaluations=(len(p_card), len(p_cpu))), failures


def training_breadth(torch):
    """Phase 12 (a)-(e).  Returns (record, failures); the record's
    ``launches`` are the whole phase's, each leg's read from zero."""
    t_phase = time.perf_counter()
    failures, rec, legs = [], {}, {}
    t0 = time.perf_counter()
    rec["remat"], plain, more = remat_leg(torch)
    legs["a, b"] = time.perf_counter() - t0
    failures += more
    launches = dict(rec["remat"]["launches"])
    t0 = time.perf_counter()
    rec["block"], more = block_leg(torch, plain)
    legs["c"] = time.perf_counter() - t0
    failures += more
    t0 = time.perf_counter()
    rows, optim_launches, more = optim_methods_leg(torch)
    legs["d"] = time.perf_counter() - t0
    failures += more
    rec["optim_methods"] = rows
    t0 = time.perf_counter()
    rec["lbfgs"], more = lbfgs_leg(torch)
    legs["e"] = time.perf_counter() - t0
    rec["leg_seconds"] = legs
    failures += more
    for part in (rec["block"]["launches"], optim_launches):
        for n, v in part.items():
            launches[n] += v
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12: {rec['seconds']:.1f} s (legs "
          f"{ {k: round(v, 1) for k, v in legs.items()} }); launches "
          f"{_nz(launches)}")
    return rec, failures


# phase 13: the image and sequence zoo.  (a) Inception v1 at the perf
# harness's defaults (bigdl_tpu/models/perf.py: B 32, 3 x 224 x 224,
# ClassNLLCriterion, SGD 0.01), every SpatialConvolution on "pallas";
# (b) Inception v2 and VGG-16 at B 32 in bf16; (c) SimpleRNN at bench.py's
# leg and the LSTM/GRU classifier at models/train.py's config; (d) every
# other class of the slice card vs CPU; (e) K5 at every distinct shape
# (a) and (b) gave it.  The limits are phase 8's for the image models
# (phase 5's for the recurrent ones), phase 3's for K5.
ZOO_BATCH, ZOO_ITERS, ZOO_B_ITERS = 32, 8, 3
ZOO_CMP_BATCH, ZOO_CPU_BATCH, ZOO_CMP_ITERS, ZOO_CPU_B_ITERS = 8, 2, 3, 2
# K5 launches a training step: the 3x3 stride-1 convs forward, and the dX
# of each whose input is not the data (VGG-16's first conv's is)
ZOO_K5_PER_STEP = {"inception_v1": 20, "inception_v2": 54, "vgg16": 25}
# ``compare_runs``'s ``twin``: no update may be widened past this limit,
# nor more than this share of a comparison's updates widened at all
WIDEN_CAP, WIDEN_SHARE = 0.1, 0.25
# the negative controls of a widened comparison: the card's run again
# with K5's output (forward and dX) times 1 + each fault; the comparison
# must reject the held one (1e-2: a kernel off by the row limit itself)
K5_FAULTS, K5_FAULT_HELD = (1e-3, 1e-2), 1e-2
RNN_V, RNN_H, RNN_T, RNN_B, RNN_ITERS = 4001, 40, 25, 12, 8
# at SGD 0.01 SimpleRNN's loss (8.3) falls 1.1e-4 a step: 116 f32 ulps,
# so phase 5's 2e-4 of a decrease is 0.02 ulp; its decreases are held
# to that limit plus 2 ulps of the first loss, as phase 12 (d) holds its
# regularized run's
RNN_LOSS_ULPS = 2
CLS_V, CLS_E, CLS_H, CLS_C, CLS_T, CLS_B = 2002, 64, 64, 20, 64, 32


def _zoo_model(torch, name, device, impl="pallas", dropout=None):
    """One of the zoo's image models (1000 classes), random weights from
    seed 0, every ``SpatialConvolution`` on ``impl``; every Dropout at p
    ``dropout`` where given (the model's own rates otherwise)."""
    from bigdl_tpu_torch import models, nn

    make = {"inception_v1": models.Inception_v1,
            "inception_v2": models.Inception_v2,
            "vgg16": models.Vgg16}[name]
    model = make(RESNET_CLASSES, device=device,
                 generator=torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            m.set_conv_impl(impl)
        if isinstance(m, nn.Dropout) and dropout is not None:
            m.set_p(dropout)
    return model


def _train_zoo(torch, name, device, impl, B, iters, dtype, frozen_bn=False,
               dropout=None, x_scale=1.0):
    """``_train_resnet`` for a zoo model: ``iters`` LocalOptimizer steps
    over phase 8's images (times ``x_scale``).  Returns (model,
    run_training record)."""
    from bigdl_tpu_torch import nn

    model = _zoo_model(torch, name, device, impl, dropout)
    if frozen_bn:
        for m in model.modules():
            if isinstance(m, nn.BatchNormalization):
                m.train = (lambda mode=True, m=m:
                           torch.nn.Module.train(m, False))
    run = run_training(torch, model, B, 0, iters, dtype, updates=True,
                       data=_image_data(B, x_scale),
                       crit=nn.ClassNLLCriterion())
    return model, run


class _K5Fault:
    """Within the block, K5's wrapper returns its output times 1 +
    ``fault``, forward and dX: a wrong kernel, the negative control of a
    comparison (``compare_runs``'s ``controls``)."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        from bigdl_tpu_torch.ops import conv3x3

        self._real = real = conv3x3._conv3x3_cuda
        conv3x3._conv3x3_cuda = lambda x, wk: real(x, wk) * (1 + self.fault)
        return self

    def __exit__(self, *exc):
        from bigdl_tpu_torch.ops import conv3x3

        conv3x3._conv3x3_cuda = self._real


def _k5_controls(torch, name, B, iters):
    """The card's f32 ``"pallas"`` run of a comparison (dropout 0) again
    under each of ``K5_FAULTS`` (their launches counted nowhere)."""
    out = {}
    for fault in K5_FAULTS:
        with _K5Fault(fault):
            out[fault] = _train_zoo(torch, name, "cuda", "pallas", B, iters,
                                    None, dropout=0.0)[1]
    return out


class _K5Shapes:
    """Within the block, count each (B, H, W, C, O) that K5's wrapper is
    handed (forward and dX alike; C the input's channels); the launch
    counters are untouched."""

    def __init__(self):
        import collections

        self.counts = collections.Counter()

    def __enter__(self):
        from bigdl_tpu_torch.ops import conv3x3

        self._real = real = conv3x3._conv3x3_cuda

        def recording(x, wk):
            self.counts[tuple(x.shape) + (wk.shape[2],)] += 1
            return real(x, wk)

        conv3x3._conv3x3_cuda = recording
        return self

    def __exit__(self, *exc):
        from bigdl_tpu_torch.ops import conv3x3

        conv3x3._conv3x3_cuda = self._real


def step_flop_per_image(torch, model, hw=RESNET_HW):
    """A training step's FLOP per image, 3 x the forward's, from the
    layer shapes: 2 C_in/groups k_h k_w per output element of every
    conv, 2 in out per sample of every Linear (one eval forward of one
    image; the elementwise layers are not counted).  Containers call
    their children's ``apply_fn``, so each conv and Linear's is wrapped
    for the forward."""
    from bigdl_tpu_torch import nn

    total = [0.0]

    def counting(m, per_output):
        real = m.apply_fn

        def apply_fn(params, x):
            out = real(params, x)
            total[0] += per_output * (out.numel() if per_output > 0
                                      else 1)
            return out
        return apply_fn

    wrapped = []
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            k = m.kernel_h * m.kernel_w * m.n_input_plane // m.n_group
            m.apply_fn = counting(m, 2.0 * k)
        elif isinstance(m, nn.Linear):
            m.apply_fn = counting(m, 2.0 * m.input_size)
        else:
            continue
        wrapped.append(m)
    was_training = model.training
    model.evaluate()
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, hw, hw, device=model.device))
    finally:
        for m in wrapped:
            del m.apply_fn
        model.train(was_training)
    return 3 * total[0]


def _eval_loss(torch, model, B):
    """The f32 eval-mode loss of ``model`` on phase 8's batch of B
    images (no dropout), without a graph."""
    from bigdl_tpu_torch import nn

    x, y = _images(B)
    was_training = model.training
    model.evaluate()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(model.device))
        loss = float(nn.ClassNLLCriterion().forward(
            out.float(), torch.from_numpy(y).to(model.device)))
    model.train(was_training)
    return loss


def _steady(step_s, B, skip=2):
    steady = step_s[skip:]
    step_ms = 1e3 * sum(steady) / len(steady)
    return step_ms, B / (step_ms / 1e3)


def _check_run(run, iters, want, label, falls=True):
    """A training run's own checks: every loss finite, no step skipped,
    with ``falls`` the last loss below the first, each step's launches
    ``want``."""
    failures = []
    losses = run["losses"]
    if len(losses) != iters or not all(math.isfinite(x) for x in losses):
        failures.append(f"{label} losses {losses}")
    if run["skipped_steps"]:
        failures.append(f"{label}: {run['skipped_steps']} steps skipped")
    if falls and not losses[-1] < losses[0]:
        failures.append(f"{label} loss did not fall: {losses[0]} -> "
                        f"{losses[-1]}")
    if want is not None:
        bad = [st for st in run["launches_per_step"] if st != want]
        if bad:
            failures.append(f"{label} launches per step {_nz(bad[0])}, "
                            f"want {_nz(want)}")
    return failures


def profile_conv_model(torch, model, B, title):
    """One bf16 training step of ``model`` over phase 8's images under
    ``torch.profiler`` after two warm iterations, grouped by the op that
    launched each kernel."""
    from bigdl_tpu_torch import nn

    opt = make_trainer(torch, model, B, 0, 2, torch.bfloat16,
                       data=_image_data(B), crit=nn.ClassNLLCriterion())
    opt.optimize()

    def run():
        state = opt.optim_method.state
        opt.set_end_when(lambda s, last=state["neval"]: s["neval"] > last)
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rep = profile_window(torch, run, group_by_op=_resnet_group)
    print_profile(title, rep)
    return rep


def zoo_inception_v1(torch, shapes):
    """Phase 13 (a).  K5's shapes are counted into ``shapes``."""
    B, iters = ZOO_BATCH, ZOO_ITERS
    failures = []
    want = want_launches(conv3x3=ZOO_K5_PER_STEP["inception_v1"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with shapes["inception_v1"]:
        model, bf16 = _train_zoo(torch, "inception_v1", "cuda", "pallas", B,
                                 iters, torch.bfloat16)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flop = step_flop_per_image(torch, model)
    n_params = sum(p.numel() for p in model.parameters())
    # the decrease the 8 steps made, read in f32: the eval-mode loss of
    # the start and of each run's trained (f32 master) weights
    eval_loss = {"bf16": _eval_loss(torch, model, B)}
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, f32 = _train_zoo(torch, "inception_v1", "cuda", "pallas", B,
                            iters, None)
    f32_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_loss["f32"] = _eval_loss(torch, model, B)
    del model
    eval_loss["start"] = _eval_loss(
        torch, _zoo_model(torch, "inception_v1", "cuda"), B)
    torch.cuda.empty_cache()
    failures += _check_run(bf16, iters, want, "inception_v1 bf16")
    failures += _check_run(f32, iters, want, "inception_v1 f32")
    step_ms, ips = _steady(bf16["step_s"], B)
    f32_ms, f32_ips = _steady(f32["step_s"], B)
    mfu = flop * ips / PEAK_FLOPS["bfloat16"]
    losses, ref = bf16["losses"], f32["losses"]
    first_rel = abs(losses[0] - ref[0]) / abs(ref[0])
    # the logged losses' decreases are not held: at SGD 0.01 they are
    # 1e-3 to 7e-3 and move with each step's dropout masks, where the bf16
    # LogSoftMax rounds each sample's loss to 2^-5 (the batch mean to
    # ~1.5e-3); the decrease the run made is held in f32 instead
    logged_dec_rel = decrease_rel_err(losses, ref)
    made = {k: eval_loss[k] - eval_loss["start"] for k in ("bf16", "f32")}
    dec_rel = abs(made["bf16"] - made["f32"]) / abs(made["f32"])
    print(f"zoo (a) inception_v1: {flop / 1e9:.3f} GFLOP a training step "
          f"per image (3 x the forward's, from the layer shapes), "
          f"{n_params} parameters")
    print(f"zoo (a) inception_v1 bf16, B {B}, pallas: losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{_nz(bf16['launches_per_step'][0])}; step {step_ms:.2f} ms "
          f"(iterations 3-{iters}), {ips:.1f} images/s, MFU {mfu:.4f}, "
          f"peak memory {peak_gb:.2f} GB | f32: step {f32_ms:.2f} ms, "
          f"{f32_ips:.1f} images/s, peak memory {f32_peak_gb:.2f} GB, "
          f"launches per step {_nz(f32['launches_per_step'][0])}")
    print(f"zoo (a) inception_v1 bf16 vs f32: first loss {losses[0]:.6f} "
          f"vs {ref[0]:.6f}, rel {first_rel:.3e} (tol "
          f"{RESNET_FIRST_REL_TOL}); the decrease {iters} steps made, the f32 "
          f"eval loss from {eval_loss['start']:.6f}: {made['bf16']:.6f} "
          f"vs {made['f32']:.6f}, rel {dec_rel:.3e} (tol "
          f"{RESNET_DECREASE_REL_TOL}); the logged losses' decreases "
          f"{[round(x - losses[0], 5) for x in losses[1:]]} vs "
          f"{[round(x - ref[0], 5) for x in ref[1:]]}, worst rel "
          f"{logged_dec_rel:.3e} (not held)")
    if not first_rel <= RESNET_FIRST_REL_TOL:
        failures.append(f"inception_v1 first loss bf16 vs f32 rel "
                        f"{first_rel:.3e}")
    if not dec_rel <= RESNET_DECREASE_REL_TOL:
        failures.append(f"inception_v1 decreases bf16 vs f32 rel "
                        f"{dec_rel:.3e}")
    # "pallas" (K5) against "xla" (cuDNN, TF32 off), then the card against
    # the CPU, f32, dropout 0: no BatchNorm, so every update row by row
    # (its deep activations are near the conv biases at random init, so
    # the max pools pick among near-equal values: each comparison's
    # reference is run again on its input times 1 + 1e-7, and an update
    # that perturbation moves past half the limit is held to twice it)
    runs = {impl: _train_zoo(torch, "inception_v1", "cuda", impl,
                             ZOO_CMP_BATCH, ZOO_CMP_ITERS, None,
                             dropout=0.0)[1] for impl in ("pallas", "xla")}
    twin = _train_zoo(torch, "inception_v1", "cuda", "xla", ZOO_CMP_BATCH,
                      ZOO_CMP_ITERS, None, dropout=0.0, x_scale=1 + 1e-7)[1]
    controls = _k5_controls(torch, "inception_v1", ZOO_CMP_BATCH,
                            ZOO_CMP_ITERS)
    torch.cuda.empty_cache()
    cmp_rec, bad = compare_runs(
        torch, runs["pallas"], runs["xla"],
        f"pallas vs xla, f32, B {ZOO_CMP_BATCH}", rows=True,
        path="zoo (a) inception_v1", twin=twin, controls=controls)
    failures += bad
    if runs["xla"]["launches"]["conv3x3"]:
        failures.append(f"inception_v1 xla impl launched K5 "
                        f"{runs['xla']['launches']}")
    dev_runs = {dev: _train_zoo(torch, "inception_v1", dev, "pallas",
                                ZOO_CPU_BATCH, ZOO_CMP_ITERS, None,
                                dropout=0.0)[1] for dev in ("cuda", "cpu")}
    twin = _train_zoo(torch, "inception_v1", "cpu", "pallas", ZOO_CPU_BATCH,
                      ZOO_CMP_ITERS, None, dropout=0.0, x_scale=1 + 1e-7)[1]
    controls = _k5_controls(torch, "inception_v1", ZOO_CPU_BATCH,
                            ZOO_CMP_ITERS)
    cpu_rec, bad = compare_runs(
        torch, dev_runs["cuda"], dev_runs["cpu"],
        f"card vs cpu, f32, B {ZOO_CPU_BATCH}", rows=True,
        path="zoo (a) inception_v1", twin=twin, controls=controls)
    failures += bad
    model = _zoo_model(torch, "inception_v1", "cuda")
    profile = profile_conv_model(
        torch, model, B, f"zoo (a) profile: inception_v1 training step "
                         f"(bf16, batch {B}, pallas)")
    del model
    torch.cuda.empty_cache()
    launches = {n: bf16["launches"][n] + f32["launches"][n]
                + runs["pallas"]["launches"][n]
                + dev_runs["cuda"]["launches"][n] for n in bf16["launches"]}
    return dict(
        config=dict(model="Inception_v1", classes=RESNET_CLASSES,
                    conv_impl="pallas", batch=B, hw=RESNET_HW, lr=TRAIN_LR,
                    compute_dtype="bfloat16", source="bigdl_tpu/models/"
                    "perf.py:28-44 (defaults :131-134)"),
        n_params=n_params, step_flop_per_image=flop, losses=losses,
        step_s=bf16["step_s"], launches_per_step=bf16["launches_per_step"][0],
        bf16_launches=bf16["launches"],
        step_ms=step_ms, images_per_s=ips, mfu=mfu, peak_memory_gb=peak_gb,
        f32=dict(losses=ref, step_s=f32["step_s"], step_ms=f32_ms,
                 images_per_s=f32_ips, peak_memory_gb=f32_peak_gb,
                 launches_per_step=f32["launches_per_step"][0]),
        bf16_vs_f32_first_rel=first_rel, eval_losses=eval_loss,
        bf16_vs_f32_decrease_rel=dec_rel,
        bf16_vs_f32_logged_decrease_rel=logged_dec_rel,
        pallas_vs_xla_f32=cmp_rec, card_vs_cpu_f32=cpu_rec,
        profile=profile, launches=launches,
        timing="host clock between loop iterations 3-8, each ending in the "
               "loss read-back (a device sync)"), failures


def zoo_v2_vgg(torch, shapes):
    """Phase 13 (b): Inception v2 and VGG-16, bf16 at B 32, then each
    card vs CPU in f32 at B 2."""
    from bigdl_tpu_torch.ops import conv3x3

    failures, rec = [], {}
    launches = None
    for name in ("inception_v2", "vgg16"):
        B = ZOO_BATCH
        want = want_launches(conv3x3=ZOO_K5_PER_STEP[name])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        copies = conv3x3.X_COPIES.count
        with shapes[name]:
            model, run = _train_zoo(torch, name, "cuda", "pallas", B,
                                    ZOO_B_ITERS, torch.bfloat16)
        x_copies = (conv3x3.X_COPIES.count - copies) / ZOO_B_ITERS
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        flop = step_flop_per_image(torch, model)
        del model
        torch.cuda.empty_cache()
        losses = run["losses"]
        failures += _check_run(run, ZOO_B_ITERS, want, name, falls=False)
        step_ms, ips = _steady(run["step_s"], B, skip=1)
        mfu = flop * ips / PEAK_FLOPS["bfloat16"]
        print(f"zoo (b) {name} bf16, B {B}, pallas: losses "
              f"{[round(x, 4) for x in losses]}; launches per step "
              f"{_nz(run['launches_per_step'][0])}, K5's x copies per step "
              f"{x_copies:g}; step {step_ms:.2f} ms (iterations "
              f"2-{ZOO_B_ITERS}), {ips:.1f} images/s, {flop / 1e9:.3f} "
              f"GFLOP a step per image, MFU {mfu:.4f}, peak memory "
              f"{peak_gb:.2f} GB")
        r = dict(losses=losses, step_s=run["step_s"],
                 launches_per_step=run["launches_per_step"][0],
                 bf16_launches=run["launches"],
                 x_copies_per_step=x_copies, step_ms=step_ms,
                 images_per_s=ips, step_flop_per_image=flop, mfu=mfu,
                 peak_memory_gb=peak_gb)
        model = _zoo_model(torch, name, "cuda")
        r["profile"] = profile_conv_model(
            torch, model, B, f"zoo (b) profile: {name} training step (bf16, "
                             f"batch {B}, pallas)")
        del model
        torch.cuda.empty_cache()
        parts = [run["launches"]]
        B = ZOO_CPU_BATCH
        if name == "inception_v2":
            # one step in training mode (the loss and every BatchNorm
            # statistic), then steps with BatchNorm frozen (every update)
            one = {dev: _train_zoo(torch, name, dev, "pallas", B, 1, None)[1]
                   for dev in ("cuda", "cpu")}
            one["cuda"]["updates"] = one["cpu"]["updates"] = {}
            r["card_vs_cpu_training_mode"], bad = compare_runs(
                torch, one["cuda"], one["cpu"],
                f"card vs cpu, f32, B {B}, 1 step: statistics", rows=True,
                path=f"zoo (b) {name}")
            failures += bad
            parts.append(one["cuda"]["launches"])
        runs = {dev: _train_zoo(torch, name, dev, "pallas", B,
                                ZOO_CPU_B_ITERS, None,
                                frozen_bn=name == "inception_v2",
                                dropout=0.0)[1] for dev in ("cuda", "cpu")}
        torch.cuda.empty_cache()
        tag = ", frozen BatchNorm" if name == "inception_v2" else ""
        # at random init VGG-16's deep activations are the conv biases and
        # a small data-dependent part, so each 2x2 max pool picks among
        # near-equal values: an input perturbed by 1e-7 moves some updates
        # by several percent on the CPU alone; such updates are held to
        # twice that reading (``compare_runs``'s ``twin``)
        twin = controls = None
        if name == "vgg16":
            twin = _train_zoo(torch, name, "cpu", "pallas", B,
                              ZOO_CPU_B_ITERS, None, dropout=0.0,
                              x_scale=1 + 1e-7)[1]
            controls = _k5_controls(torch, name, B, ZOO_CPU_B_ITERS)
        r["card_vs_cpu"], bad = compare_runs(
            torch, runs["cuda"], runs["cpu"],
            f"card vs cpu, f32, B {B}{tag}", rows=True,
            path=f"zoo (b) {name}", twin=twin, controls=controls)
        failures += bad
        parts.append(runs["cuda"]["launches"])
        for part in parts:
            launches = dict(part) if launches is None else {
                n: launches[n] + part[n] for n in launches}
        rec[name] = r
    rec["launches"] = launches
    return rec, failures


def _one_hot_lm_data(B, V, T, seed=0):
    """B one-hot sequences of T steps over V symbols and their next
    symbols as 1-based targets (bench.py's SimpleRNN leg)."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample, array

    seq = np.random.RandomState(seed).randint(0, V, (B, T + 1))
    x = np.eye(V, dtype=np.float32)[seq[:, :-1]]
    y = (seq[:, 1:] + 1).astype(np.float32)
    return array([Sample(a, b) for a, b in zip(x, y)])


def _text_data(B, V, T, seed=0):
    """B sequences of T word ids in 1..V-2, a tail of padding id V-1 (the
    classifier's ``padding_value``, models/train.py:116-119) on each,
    and labels in 1..CLS_C."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample, array

    rng = np.random.RandomState(seed)
    x = rng.randint(1, V - 1, (B, T)).astype(np.float32)
    for i, n in enumerate(rng.randint(T // 2, T + 1, B)):
        x[i, n:] = V - 1
    y = rng.randint(1, CLS_C + 1, B).astype(np.float32)
    return array([Sample(a, b) for a, b in zip(x, y)])


def zoo_recurrent(torch):
    """Phase 13 (c): SimpleRNN at bench.py's leg and the LSTM/GRU
    classifier, f32, card vs CPU at phase 5's limits."""
    from bigdl_tpu_torch import models, nn

    failures, rec = [], {}
    tols = (TRAJ_RTOL, TRAJ_DECREASE_REL_TOL, TRAJ_UPDATE_ROW_TOL)

    def simple_rnn(dev):
        return models.SimpleRNN(RNN_V, RNN_H, RNN_V, device=dev,
                                generator=torch.Generator().manual_seed(0))

    def rnn_run(dev, iters):
        return run_training(
            torch, simple_rnn(dev), RNN_B, 0, iters, None, updates=True,
            data=_one_hot_lm_data(RNN_B, RNN_V, RNN_T),
            crit=nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True))

    run = rnn_run("cuda", RNN_ITERS)
    failures += _check_run(run, RNN_ITERS, want_launches(), "simple_rnn")
    step_ms, rps = _steady(run["step_s"], RNN_B)
    print(f"zoo (c) simple_rnn (V {RNN_V}, H {RNN_H}, T {RNN_T}, B "
          f"{RNN_B}, f32): losses {[round(x, 5) for x in run['losses']]}; "
          f"step {step_ms:.3f} ms (iterations 3-{RNN_ITERS}), {rps:.1f} "
          f"records/s, {rps * RNN_T:.0f} steps of a sequence a second")
    rec["simple_rnn"] = dict(losses=run["losses"], step_s=run["step_s"],
                             step_ms=step_ms, records_per_s=rps)
    runs = {dev: rnn_run(dev, ZOO_CMP_ITERS) for dev in ("cuda", "cpu")}
    rec["simple_rnn"]["card_vs_cpu"], bad = compare_runs(
        torch, runs["cuda"], runs["cpu"], "card vs cpu, f32", rows=True,
        path="zoo (c) simple_rnn", tols=tols, loss_ulps=RNN_LOSS_ULPS)
    failures += bad
    for cell in ("lstm", "gru"):
        def cls_run(dev, cell=cell):
            model = models.LSTMClassifier(
                CLS_V, CLS_E, CLS_H, CLS_C, padding_value=CLS_V - 1,
                cell=cell, device=dev,
                generator=torch.Generator().manual_seed(0))
            return run_training(torch, model, CLS_B, 0, ZOO_CMP_ITERS, None,
                                updates=True,
                                data=_text_data(CLS_B, CLS_V, CLS_T),
                                crit=nn.ClassNLLCriterion())

        runs = {dev: cls_run(dev) for dev in ("cuda", "cpu")}
        failures += _check_run(runs["cuda"], ZOO_CMP_ITERS, want_launches(),
                               f"lstm_classifier {cell}")
        step_ms, rps = _steady(runs["cuda"]["step_s"], CLS_B, skip=1)
        r, bad = compare_runs(
            torch, runs["cuda"], runs["cpu"], "card vs cpu, f32", rows=True,
            path=f"zoo (c) lstm_classifier {cell} (V {CLS_V}, embed "
                 f"{CLS_E}, hidden {CLS_H}, {CLS_C} classes, T {CLS_T}, B "
                 f"{CLS_B}; step {step_ms:.3f} ms, {rps:.1f} records/s)",
            tols=tols, loss_ulps=RNN_LOSS_ULPS)
        r.update(step_ms=step_ms, records_per_s=rps)
        rec[f"lstm_classifier_{cell}"] = r
        failures += bad
    return rec, failures


def lenet_graph_leg(torch):
    """Phase 13 (d): ``lenet_graph`` on ``LeNet5``'s weights equals it bit
    for bit on the card, forward and backward.  cuDNN runs its
    deterministic algorithms for the leg (the default ones of the
    weight gradient may sum in another order from run to run)."""
    import numpy as np

    from bigdl_tpu_torch.models import LeNet5, lenet_graph

    seq = LeNet5(device="cuda", generator=torch.Generator().manual_seed(3))
    g = lenet_graph(device="cuda")
    with torch.no_grad():
        for p, q in zip(g.parameters(), seq.parameters(), strict=True):
            p.copy_(q)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(16, 28, 28).astype(np.float32)).cuda()
    go = torch.from_numpy(rng.randn(16, 10).astype(np.float32)).cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        same = dict(forward=torch.equal(seq.forward(x), g.forward(x)),
                    input_gradient=torch.equal(seq.backward(x, go),
                                               g.backward(x, go)),
                    parameter_gradients=all(
                        torch.equal(p.grad, q.grad) for p, q in zip(
                            g.parameters(), seq.parameters())))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"zoo (d) lenet_graph = LeNet5 on the same weights on the card, "
          f"bit for bit: {same}")
    return same


def _zoo_shape_rows(torch, F, shapes):
    """Phase 13 (e): K5 at every distinct (B, H, W, C, O) of ``shapes``
    (forward and dX calls alike), bf16 and f32, each against the plain
    version row by row at phase 3's limits, timed as phase 3 times it
    (fewer replays)."""
    distinct = sorted(set().union(*(s.counts for s in shapes.values())))
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for shape in distinct:
            B, H, W, C, O = shape
            label = f"zoo {H}x{W} {C}->{O}"
            rows.append(conv3x3_row(torch, F, label, B, H, W, C, O, dt,
                                    iters=5, reps=2, call=False))
    return rows


def zoo_phase(torch, F):
    """Phase 13 (a)-(e).  Returns (record, failures); the record's
    ``launches`` are the main paths' (a)-(c), each read from zero."""
    from bigdl_tpu_torch.utils.api_cases import (ZOO_REL_TOL,
                                                 zoo_tail_cases)

    t_phase = time.perf_counter()
    failures, rec, legs = [], {}, {}
    shapes = {n: _K5Shapes() for n in ZOO_K5_PER_STEP}
    t0 = time.perf_counter()
    rec["inception_v1"], more = zoo_inception_v1(torch, shapes)
    legs["a"] = time.perf_counter() - t0
    failures += more
    t0 = time.perf_counter()
    rec["v2_vgg"], more = zoo_v2_vgg(torch, shapes)
    legs["b"] = time.perf_counter() - t0
    failures += more
    t0 = time.perf_counter()
    rec["recurrent"], more = zoo_recurrent(torch)
    legs["c"] = time.perf_counter() - t0
    failures += more
    t0 = time.perf_counter()
    rows, more = zoo_sweep(torch, zoo_tail_cases(), "13 (d)")
    failures += more
    worst = max(rows, key=lambda r: r["rel_err"]
                if math.isfinite(r["rel_err"]) else float("inf"))
    print(f"zoo (d): {len(rows)} classes card vs CPU, forward and backward "
          f"f32: {sum(r['ok'] for r in rows)} within {ZOO_REL_TOL}, every "
          f"tensor on the card, worst {worst['rel_err']:.3e} "
          f"({worst['name']})")
    rec["zoo_tail"] = rows
    rec["lenet_graph_bit_for_bit"] = same = lenet_graph_leg(torch)
    if not all(same.values()):
        failures.append(f"phase 13 (d): lenet_graph != LeNet5 on the card "
                        f"{same}")
    legs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k5 = _zoo_shape_rows(torch, F, shapes)
    failures += [f"phase 13 (e) K5 {r['case']} {r['dtype']}: row err "
                 f"{r['row_rel_err']}" for r in k5 if not r["ok"]]
    rec["k5_shapes"] = k5
    # K5's time in one training step of each model, summed over its
    # launches at the shapes (e) timed
    by_shape = {(tuple(r["shape"]), r["dtype"]): r for r in k5}
    steps = {}
    for name, s in shapes.items():
        iters = ZOO_ITERS if name == "inception_v1" else ZOO_B_ITERS
        part = {k: 0.0 for k in ("ms", "plain_ms", "library_ms",
                                 "bound_ms")}
        err, by = 0.0, {"bytes": 0.0, "operations": 0.0}
        for shape, n in s.counts.items():
            r = by_shape[(shape, "bfloat16")]
            for k in part:
                part[k] += n / iters * r[k]
            err = max(err, r["max_abs_err"])
            by[r["bound_by"]] += n / iters * r["bound_ms"]
        # the step's bound is the sum of its launches' bounds; named by
        # the limit that makes up most of it
        run = (rec["inception_v1"] if name == "inception_v1"
               else rec["v2_vgg"][name])
        part.update(launches_per_step=sum(s.counts.values()) / iters,
                    launches=run["bf16_launches"]["conv3x3"],
                    max_abs_err=err, bound_by=max(by, key=by.get))
        steps[name] = part
        print(f"zoo (e) {name}: K5's {part['launches_per_step']:g} launches "
              f"of a bf16 step ({part['launches']} in its run) take "
              f"{part['ms']:.3f} ms of kernel time "
              f"(plain {part['plain_ms']:.3f}, F.conv2d "
              f"{part['library_ms']:.3f}, bound {part['bound_ms']:.3f})")
    rec["k5_per_step"] = steps
    legs["e"] = time.perf_counter() - t0
    launches = dict(rec["inception_v1"]["launches"])
    for part in (rec["v2_vgg"]["launches"],):
        for n, v in part.items():
            launches[n] += v
    rec["launches"] = launches
    rec["leg_seconds"] = legs
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13: {rec['seconds']:.1f} s (legs "
          f"{ {k: round(v, 1) for k, v in legs.items()} }); launches "
          f"{_nz(launches)}")
    return rec, failures


# phase 14: Switch-MoE.  bench.py's "Switch-MoE LM (single-chip dense
# dispatch)" leg (bench.py:711-731): V 32000, D 512, 4 heads of 128, 4
# layers, mlp 2048, 8 experts, capacity 1.25, aux 0.01, T 1024, B 16,
# bf16 over f32 masters.  (a) trained 8 steps, then in f32, freely routed
# and routed as the bf16 run routed (the held comparison: near ties flip
# some first choices between bf16 and f32, PERF.md); (b) a 2-layer
# copy at full width card vs CPU in f32, capacity loose, binding and
# top-2; (c) served in bf16 as phase 4 serves the flagship, paged as
# phase 9, one beam; (d) the index dispatch against the one-hot einsum
# form at one layer's bench shape; then K1-K4 at the step's shapes.
MOE = dict(vocab=32000, embed_dim=512, num_heads=4, num_layers=4,
           mlp_dim=2048, experts=8, capacity=1.25, aux=0.01, max_len=1024)
MOE_BATCH, MOE_T, MOE_ITERS = 16, 1024, 8
# (b): capacity loose (no assignment dropped at random init) and binding
MOE_SMALL = (("loose f 8.0", 8.0, 1), ("binding f 0.5", 0.5, 1),
             ("top-2 f 1.25", 1.25, 2))
# the reported loss minus the criterion's against 0.01 x the aux
# buffers' sum, relative to the loss: the two f32 sums' roundings
MOE_AUX_REL_TOL = 1e-6
# (d): the index dispatch against the one-hot form, f32, relative to the
# largest output (bit for bit expected for top-1)
MOE_DISPATCH_REL_TOL = 1e-6
# the profiled step's record_function ranges: routing, slots, aux, the
# whole MoE forward
MOE_RANGES = ("moe.route", "moe.slots", "moe.aux", "moe.ffn")


def _moe_lm(torch, device, num_layers=None, capacity=None, top_k=1, seed=0):
    from bigdl_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(
        MOE["vocab"], embed_dim=MOE["embed_dim"], num_heads=MOE["num_heads"],
        mlp_dim=MOE["mlp_dim"], num_layers=num_layers or MOE["num_layers"],
        max_len=MOE["max_len"], seq_strategy="flash", output="logits",
        moe_experts=MOE["experts"], moe_aux_coef=MOE["aux"],
        moe_capacity_factor=capacity or MOE["capacity"], moe_top_k=top_k,
        device=device, generator=torch.Generator().manual_seed(seed))


def active_params(model) -> int:
    """bench.py:295-300: every parameter, less the (E - 1)/E inactive
    share of each MoE layer's expert weights, from the modules' own
    leaves."""
    from bigdl_tpu_torch.parallel.moe import MoEFFN

    active = sum(p.numel() for p in model.parameters())
    for m in model.modules():
        if isinstance(m, MoEFFN) and m.n_experts > 1:
            ex = sum(getattr(m, k).numel() for k in ("wi", "bi", "wo", "bo"))
            active -= ex * (m.n_experts - 1) // m.n_experts
    return active


def _record_drops(model):
    """Each MoE layer's dispatch records the share of its routing
    assignments that capacity dropped, a device scalar a forward (read
    after the run); returns the per-layer lists."""
    drops = []
    for blk in model.blocks:
        moe, seen = blk[3], []
        slots = moe.slots

        def rec(idxk, _slots=slots, _seen=seen):
            slot, keep, C = _slots(idxk)
            _seen.append(1.0 - keep.float().mean())
            return slot, keep, C
        moe.slots = rec
        drops.append(seen)
    return drops


def _route_layers(model, pinned=None):
    """Each MoE layer's router records its choices, a forward at a time
    (per-layer lists, returned); with ``pinned`` (such lists from another
    run) each forward routes to the choices that run made instead, its
    gates the recorded experts' probabilities (renormalised for top-k)."""
    seen_by_layer = []
    for li, blk in enumerate(model.blocks):
        moe, seen = blk[3], []
        route = moe.route

        def pinned_route(params, x2d, _route=route, _seen=seen, _li=li,
                         _k=moe.top_k):
            gk, idxk, probs = _route(params, x2d)
            if pinned is not None:
                idxk = pinned[_li][len(_seen)]
                gk = probs.gather(1, idxk)
                if _k > 1:
                    gk = gk / gk.sum(dim=-1, keepdim=True)
            _seen.append(idxk.detach())
            return gk, idxk, probs
        moe.route = pinned_route
        seen_by_layer.append(seen)
    return seen_by_layer


def moe_train(torch, dtype, record_drops=False, pinned=None):
    """The MoE LM trained MOE_ITERS steps by LocalOptimizer: at each
    end-trigger check the host clock, the loss, the criterion's loss of
    the step, the layers' aux buffers and every launch count; each
    layer's routing choices a forward (``_route_layers``, routed as
    ``pinned`` when given)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.rng import RNG

    crit_losses = []

    class Recording(nn.TimeDistributedCriterion):
        def _loss(self, out, y):
            loss = super()._loss(out, y)
            crit_losses.append(loss.detach())
            return loss

    model = _moe_lm(torch, "cuda")
    drops = _record_drops(model) if record_drops else None
    routing = _route_layers(model, pinned)
    counters = launch_counters()
    marks = []

    def mark(state):
        aux = sum(blk[3].aux_loss for blk in model.blocks)
        marks.append((time.perf_counter(), state.get("loss"),
                      {n: c.count for n, c in counters.items()},
                      float(aux)))

    opt = make_trainer(torch, model, MOE_BATCH, MOE_T, MOE_ITERS, dtype,
                       mark, crit=Recording(nn.CrossEntropyCriterion(), True))
    RNG().set_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    for c in counters.values():
        c.reset()
    opt.optimize()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m[1] for m in marks[1:]]
    run = dict(
        losses=losses, crit_losses=[float(c) for c in crit_losses],
        aux_sums=[m[3] for m in marks[1:]],
        step_s=[b[0] - a[0] for a, b in zip(marks, marks[1:])],
        launches_per_step=[{n: b[2][n] - a[2][n] for n in b[2]}
                           for a, b in zip(marks, marks[1:])],
        launches={n: c.count for n, c in counters.items()},
        skipped_steps=opt.skipped_steps, peak_memory_gb=peak_gb,
        held_before_gb=held_gb,
        active_params=active_params(model),
        n_params=sum(p.numel() for p in model.parameters()),
        routing=routing)
    if drops is not None:
        run["dropped_share"] = {f"step {k + 1}": [float(d[k]) for d in drops]
                                for k in (0, MOE_ITERS - 1)}
    return model, opt, run


def _moe_group(kernel: str, ops) -> str:
    """The group of a kernel of the MoE step: K1-K4 by name, the rest by
    the op that launched it (the MoE forward's own ranges, and the
    autograd nodes of its backward)."""
    def under(*parts):
        return any(part in op for op in ops for part in parts)

    if any(k in kernel for k in ("attn_fwd_", "bwd_dkv_", "bwd_dq_",
                                 "_ln_fwd")):
        return _kernel_group(kernel)
    if under("aten::bmm", "BmmBackward"):
        return "experts: bmm (forward and backward)"
    if under("aten::index_put", "IndexPutBackward"):
        return "dispatch: scatter to slots (index_put; bwd a gather)"
    if under("aten::index_select", "IndexSelectBackward"):
        return "combine: gather from slots (index_select; bwd index_add)"
    if under(*MOE_RANGES[:3]):
        return "routing: router, softmax, top-1, one-hot, cumsum, aux"
    if under(MOE_RANGES[3]):
        return "MoE forward, other (zeros, gelu, where, combine, casts)"
    if any(s in kernel.lower() for s in ("gemm", "gemv", "nvjet", "cutlass",
                                         "xmma", "sm90_")):
        return "matmul (cuBLAS: projections, vocab head, router bwd)"
    return "other (elementwise, loss, optimizer, backward of the rest)"


def profile_moe_step(torch, model, opt):
    """One more bf16 MoE step of ``opt`` under ``torch.profiler`` (after
    three unprofiled ones for the wall), the MoE forward's parts inside
    ``record_function`` ranges, grouped by ``_moe_group``."""
    from torch.profiler import record_function

    def ranged(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    for blk in model.blocks:
        moe = blk[3]
        for name, attr in zip(MOE_RANGES, ("route", "slots", "aux_term",
                                           "_compute")):
            setattr(moe, attr, ranged(name, getattr(moe, attr)))

    def run():
        state = opt.optim_method.state
        opt.set_end_when(lambda s, last=state["neval"]: s["neval"] > last)
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rep = profile_window(torch, run, group_by_op=_moe_group,
                         ranges=MOE_RANGES, top=25)
    print_profile(f"phase 14 (a) profile MoE training step (bf16, batch "
                  f"{MOE_BATCH}, T {MOE_T})", rep)
    return rep


def moe_dispatch_leg(torch):
    """Phase 14 (d): one MoE layer at the bench step's shape (16 x 1024
    tokens, D 512, H 2048, E 8, capacity 1.25: C 2560), f32, eval: the
    index dispatch against the one-hot einsum form, and both timed
    (CUDA events over 5 calls, host launches included)."""
    from bigdl_tpu_torch.parallel.moe import MoEFFN, onehot_forward

    rec, failures = {}, []
    for top_k in (1, 2):
        moe = MoEFFN(MOE["embed_dim"], MOE["mlp_dim"], MOE["experts"],
                     capacity_factor=MOE["capacity"], top_k=top_k,
                     device="cuda",
                     generator=torch.Generator().manual_seed(0)).evaluate()
        x = torch.randn(MOE_BATCH, MOE_T, MOE["embed_dim"], device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            1))
        params = moe.param_tree()
        with torch.no_grad():
            got = moe(x)
            want = onehot_forward(moe, params, x)
            _, keep, C = moe.slots(moe.route(params, x.reshape(
                -1, MOE["embed_dim"]))[1])
            times = {}
            for name, fn in (("index", lambda: moe(x)),
                             ("onehot", lambda: onehot_forward(moe, params,
                                                               x))):
                fn()
                torch.cuda.synchronize()
                times[name] = _event_ms(lambda f=fn: [f() for _ in range(5)],
                                        5)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        same = bool(torch.equal(got, want))
        dropped = 1.0 - keep.float().mean().item()
        ok = err <= MOE_DISPATCH_REL_TOL * scale and (same or top_k > 1)
        rec[f"top{top_k}"] = dict(
            tokens=MOE_BATCH * MOE_T, capacity=C, dropped_share=dropped,
            max_abs_err=err, max_abs_out=scale, bit_for_bit=same,
            index_ms=times["index"], onehot_ms=times["onehot"], ok=ok)
        print(f"phase 14 (d) dispatch top-{top_k}, f32, {MOE_BATCH * MOE_T} "
              f"tokens, C {C}, dropped {dropped:.4f}: index vs one-hot max "
              f"abs err {err:.3e} ({err / scale:.3e} of max |y|, tol "
              f"{MOE_DISPATCH_REL_TOL}), bit for bit {same}; index "
              f"{times['index']:.3f} ms, one-hot einsum "
              f"{times['onehot']:.3f} ms {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 14 (d) top-{top_k} dispatch err {err:.3e}"
                            f" of {scale:.3e}, bit for bit {same}")
        del got, want, moe, x
        torch.cuda.empty_cache()
    return rec, failures


def moe_serve_leg(torch):
    """Phase 14 (c): the MoE LM (seed 0) served in bf16 by
    InferenceServer as phase 4 serves the flagship, the paged stream and
    one beam against cached_generate, the capacity report, the timings."""
    import numpy as np

    from bigdl_tpu_torch.models import generate as tgen
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import layer_norm as ln
    from bigdl_tpu_torch.serving import InferenceServer, KVPagePool, Status

    bf16 = torch.bfloat16
    V, L = MOE["vocab"], MOE["num_layers"]
    counters = launch_counters()
    failures, rec = [], dict(batches=[])
    model = _moe_lm(torch, "cuda")
    server = InferenceServer(model, max_batch=BATCH,
                             generate_dtype=bf16).start()
    rng = np.random.RandomState(0)
    prompts_by_len, served = {}, {}
    try:
        for T0 in PROMPT_LENS:
            prompts = rng.randint(1, V + 1, size=(BATCH, T0)).astype(np.int32)
            prompts_by_len[T0] = prompts
            for c in counters.values():
                c.reset()
            results = [f.result(timeout=600) for f in
                       [server.submit_generate(p, MAX_NEW) for p in prompts]]
            launches = {n: c.count for n, c in counters.items()}
            statuses = [r.status.value for r in results]
            outs = [np.asarray(r.output) for r in results
                    if r.status is Status.OK]
            served[T0] = outs
            ids_ok = len(outs) == BATCH and all(
                o.shape == (MAX_NEW,) and o.min() >= 1 and o.max() <= V
                for o in outs)
            want_ln = (2 * L + 1) * MAX_NEW
            rec["batches"].append(dict(
                prompt_len=T0, statuses=statuses, launches=launches,
                latency_s=[r.latency_s for r in results]))
            print(f"phase 14 (c) served prompt {T0}: statuses {statuses} "
                  f"flash {fa.LAUNCHES.count} (want {L}) layer_norm "
                  f"{ln.LAUNCHES.count} (want {want_ln}) latency "
                  f"{max(r.latency_s for r in results):.3f} s")
            if statuses != ["ok"] * BATCH or not ids_ok:
                failures.append(f"phase 14 (c) prompt {T0}: statuses "
                                f"{statuses}, ids in 1..V {ids_ok}")
            if launches != want_launches(flash_fwd=L, layer_norm_fwd=want_ln):
                failures.append(f"phase 14 (c) prompt {T0}: launches "
                                f"{_nz(launches)}")
    finally:
        server.stop(timeout=60)

    params = model.param_tree()
    gen = tgen.cached_generate(model, compute_dtype=bf16)
    timing = {}
    for T0, prompts in prompts_by_len.items():
        def run(n, _p=prompts):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen(params, _p, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run(MAX_NEW)
        prefill_s = min(run(1) for _ in range(3))
        full_s = min(run(MAX_NEW) for _ in range(3))
        timing[T0] = dict(prefill_s=prefill_s, generate_s=full_s,
                          decode_tokens_per_s=BATCH * (MAX_NEW - 1)
                          / (full_s - prefill_s))
        print(f"phase 14 (c) prompt {T0}: prefill+first token "
              f"{prefill_s * 1e3:.2f} ms, generate {full_s * 1e3:.2f} ms, "
              f"decode {timing[T0]['decode_tokens_per_s']:.1f} tokens/s "
              f"(batch {BATCH})")
    rec["timing"] = timing

    # last-position logits: bf16 on the card vs the same model in f32 on
    # the CPU (phase 4's limit)
    prompt = prompts_by_len[PROMPT_LENS[1]][:1]
    got = tgen.last_logits(model, prompt, compute_dtype=bf16).cpu()
    ref = tgen.last_logits(_moe_lm(torch, "cpu"), prompt)
    rel = (got - ref).abs().max().item() / ref.abs().max().item()
    rec["logits_rel_err"] = rel
    print(f"phase 14 (c) last-position logits bf16/cuda vs f32/cpu: "
          f"{rel:.3e} of max |logit| (tol {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        failures.append(f"phase 14 (c) logits vs f32 CPU: rel {rel:.3e}")

    # the paged stream (page size 16) = cached_generate's at B 1; one
    # beam = greedy
    T0 = PROMPT_LENS[0]
    prompts = prompts_by_len[T0]
    pool = KVPagePool.for_model(model, PAGED_POOL_PAGES, PAGE_SIZE,
                                dtype=bf16)
    dec = tgen.cached_paged_decoder(model, pool, compute_dtype=bf16)
    paged_equal = []
    for p in prompts[:2]:
        want = gen(params, p[None], MAX_NEW).cpu().numpy()[0, T0:]
        seq = dec.start(params, p)
        toks = [seq.last] + [dec.step(params, seq)
                             for _ in range(MAX_NEW - 1)]
        seq.release()
        paged_equal.append(bool(np.array_equal(toks, want)))
    beam = tgen.make_beam_search(model, compute_dtype=bf16)
    one, _ = beam(params, prompts[:2], MAX_NEW, num_beams=1)
    greedy = gen(params, prompts[:2], MAX_NEW)
    beam_equal = bool(torch.equal(one.cpu(), greedy.cpu()))
    rec.update(paged_equal=paged_equal, beam1_equals_greedy=beam_equal,
               pool_free_after=pool.free_pages == pool.num_pages)
    print(f"phase 14 (c) paged (page {PAGE_SIZE}) = cached_generate at B 1: "
          f"{paged_equal}; 1 beam = greedy: {beam_equal}; pool free "
          f"{rec['pool_free_after']}")
    if not (all(paged_equal) and beam_equal and rec["pool_free_after"]):
        failures.append(f"phase 14 (c) paged {paged_equal} beam "
                        f"{beam_equal} pool {rec['pool_free_after']}")

    # the share of the served sequences' routing assignments the training
    # dispatch's capacity would drop, on the served (bf16) weights
    report = {}
    for T0, outs in served.items():
        ids = np.concatenate([prompts_by_len[T0], np.stack(outs)], axis=1)
        report[T0] = tgen.capacity_bind_report(
            model, tgen._cast_floats(params, bf16), ids)
        print(f"phase 14 (c) capacity_bind_report on the {T0}-token "
              f"prompts + {MAX_NEW} generated: "
              f"{ {k: round(v, 5) for k, v in report[T0].items()} }")
    rec["capacity_bind_report"] = report
    rec["launches"] = {n: sum(b["launches"][n] for b in rec["batches"])
                       for n in counters}
    del model, pool
    torch.cuda.empty_cache()
    return rec, failures


def moe_phase(torch, F, smi):
    """Phase 14 (a)-(d), then K1-K4 at the MoE step's shapes.  Returns
    (record, failures); the record's ``launches`` are (a)'s bf16 run and
    (c)'s served batches, each read from zero."""
    t_phase = time.perf_counter()
    failures, rec = [], {}
    L, B, T = MOE["num_layers"], MOE_BATCH, MOE_T
    bf16 = torch.bfloat16

    # (a) bf16 over f32 masters, 8 steps; then the same in f32
    model, opt, run = moe_train(torch, bf16, record_drops=True)
    losses = run["losses"]
    want = want_launches(flash_fwd=L, flash_bwd_dkv=L, flash_bwd_dq=L,
                         layer_norm_fwd=2 * L + 1)
    if len(losses) != MOE_ITERS or not all(math.isfinite(x) for x in losses):
        failures.append(f"phase 14 (a) losses {losses}")
    if run["skipped_steps"]:
        failures.append(f"phase 14 (a) {run['skipped_steps']} steps skipped")
    if not losses[-1] < losses[0]:
        failures.append(f"phase 14 (a) loss did not fall: {losses}")
    bad = [st for st in run["launches_per_step"] if st != want]
    if bad:
        failures.append(f"phase 14 (a) launches per step {_nz(bad[0])}")
    aux_err = [abs(l - c - MOE["aux"] * a) / abs(l) for l, c, a in zip(
        losses, run["crit_losses"], run["aux_sums"])]
    if len(run["crit_losses"]) != MOE_ITERS \
            or not max(aux_err) <= MOE_AUX_REL_TOL:
        failures.append(f"phase 14 (a) loss - criterion vs 0.01 aux: "
                        f"{aux_err}")
    steady = run["step_s"][2:]
    step_ms = 1e3 * sum(steady) / len(steady)
    tps = B * T / (step_ms / 1e3)
    mfu = 6.0 * run["active_params"] * tps / PEAK_FLOPS["bfloat16"]
    mfu_attn = ((6.0 * run["active_params"] + 6.0 * T * MOE["embed_dim"] * L)
                * tps / PEAK_FLOPS["bfloat16"])
    run.update(step_ms=step_ms, tokens_per_s=tps, active_mfu=mfu,
               active_mfu_attn_incl=mfu_attn, aux_rel_err=aux_err)
    print(f"phase 14 (a) MoE LM bf16, B {B} T {T}, {MOE['experts']} experts "
          f"({smi}): losses {[round(x, 4) for x in losses]}; launches per "
          f"step {_nz(run['launches_per_step'][0])}; step {step_ms:.2f} ms "
          f"(iterations 3-{MOE_ITERS}), {tps:.0f} tokens/s, parameters "
          f"{run['n_params']} ({run['active_params']} active), active MFU "
          f"{mfu:.4f} (with attention {mfu_attn:.4f}), peak memory "
          f"{run['peak_memory_gb']:.2f} GB ({run['held_before_gb']:.2f} GB "
          f"held before the run, the model's included); loss - criterion "
          f"vs 0.01 aux "
          f"worst {max(aux_err):.3e} (tol {MOE_AUX_REL_TOL}); dropped share "
          f"by layer {run['dropped_share']}")
    rec["profile"] = profile_moe_step(torch, model, opt)
    bf16_routing = [layer[:MOE_ITERS] for layer in run.pop("routing")]
    rec["bf16"] = run
    del model, opt
    torch.cuda.empty_cache()
    # f32 routed freely, then f32 routed as the bf16 run routed
    free_model, _, free = moe_train(torch, None)
    del free_model
    f32_model, _, f32 = moe_train(torch, None, pinned=bf16_routing)
    del f32_model
    torch.cuda.empty_cache()
    # the share of first choices the free f32 run routes elsewhere than
    # the bf16 run, a layer, at steps 1 and 8
    free_routing = free.pop("routing")
    flips = {f"step {k + 1}": [
        (a[k][:, 0] != b[k][:, 0]).float().mean().item()
        for a, b in zip(bf16_routing, free_routing)]
        for k in (0, MOE_ITERS - 1)}
    f32.pop("routing")
    free_first = abs(losses[0] - free["losses"][0]) / abs(free["losses"][0])
    free_dec = decrease_rel_err(losses, free["losses"])
    ref = f32["losses"]
    f32_ms = 1e3 * sum(free["step_s"][2:]) / len(free["step_s"][2:])
    first_rel = abs(losses[0] - ref[0]) / abs(ref[0])
    dec_rel = decrease_rel_err(losses, ref)
    free.update(step_ms=f32_ms, tokens_per_s=B * T / (f32_ms / 1e3),
                bf16_vs_f32_first_rel=free_first,
                bf16_vs_f32_decrease_rel=free_dec, first_choice_flips=flips)
    f32.update(bf16_vs_f32_first_rel=first_rel,
               bf16_vs_f32_decrease_rel=dec_rel)
    rec["f32"], rec["f32_bf16_routing"] = free, f32
    print(f"phase 14 (a) f32: step {f32_ms:.2f} ms, "
          f"{free['tokens_per_s']:.0f} tokens/s; first choices routed "
          f"elsewhere than bf16's, by layer: {flips}; bf16 vs f32 first "
          f"loss {losses[0]:.6f} vs {free['losses'][0]:.6f}, rel "
          f"{free_first:.3e}, decreases worst rel {free_dec:.3e}; vs f32 "
          f"routed as bf16: first loss {ref[0]:.6f}, rel {first_rel:.3e} "
          f"(tol {TRAIN_FIRST_REL_TOL}), decreases worst rel {dec_rel:.3e} "
          f"(tol {TRAIN_DECREASE_REL_TOL})")
    if any(st["attn_operand_copies"] for run_ in (free, f32)
           for st in run_["launches_per_step"]):
        failures.append("phase 14 (a) f32 steps copied attention operands")
    if len(ref) != MOE_ITERS or not first_rel <= TRAIN_FIRST_REL_TOL:
        failures.append(f"phase 14 (a) first loss bf16 vs f32 routed as "
                        f"bf16: rel {first_rel:.3e}")
    if not dec_rel <= TRAIN_DECREASE_REL_TOL:
        failures.append(f"phase 14 (a) decreases bf16 vs f32 routed as "
                        f"bf16: rel {dec_rel:.3e}")
    if len(free["losses"]) != MOE_ITERS or not all(
            math.isfinite(x) for x in free["losses"]) \
            or not free["losses"][-1] < free["losses"][0]:
        failures.append(f"phase 14 (a) f32 losses {free['losses']}")

    # (b) a 2-layer copy at full width, f32, card vs CPU
    rec["card_vs_cpu"] = {}
    for label, cap, top_k in MOE_SMALL:
        small, more = _small_card_vs_cpu(
            torch, f"(b) {label}", lambda dev, c=cap, k=top_k: _moe_lm(
                torch, dev, SMALL_LAYERS, capacity=c, top_k=k), phase="14")
        rec["card_vs_cpu"][label] = small
        failures += more

    # (c) serving; (d) the dispatch
    rec["serving"], more = moe_serve_leg(torch)
    failures += more
    rec["dispatch"], more = moe_dispatch_leg(torch)
    failures += more

    # K1-K4 at the MoE step's shapes (4 heads of 128; LayerNorm over 512)
    case = ("moe_train", B, MOE["num_heads"], T, T,
            MOE["embed_dim"] // MOE["num_heads"], bf16, True)
    rec["kernels"] = dict(
        flash=check_flash(torch, F, [case]),
        flash_bwd=check_flash_bwd(torch, F, [case]),
        layer_norm=check_layer_norm(torch, F, [("moe_train", B * T,
                                                MOE["embed_dim"], bf16)]))
    failures += [f"phase 14 K{n} {r['case']}: {r.get('row_rel_err')}"
                 for n, rows in (("1", rec["kernels"]["flash"]),
                                 ("2/K3", rec["kernels"]["flash_bwd"]),
                                 ("4", rec["kernels"]["layer_norm"]))
                 for r in rows if not r["ok"]]
    launches = dict(run["launches"])
    for n, v in rec["serving"]["launches"].items():
        launches[n] += v
    rec["launches"] = launches
    rec["step_launches"] = run["launches"]
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14: {rec['seconds']:.1f} s; launches {_nz(launches)}")
    return rec, failures


# the phase-3 cases the ``kernels`` line's variants read, and the tag of
# their counters (a kernel's name, then the tag)
VARIANT_CASES = {"f32_D192": "f32 D 192", "f32_D256": "f32 D 256",
                 "wide_D320": "bf16 D > 256", "wide_f32_D320": "f32 D > 256",
                 "mlp_f32": "f32", "block8_bf16": "coarse bf16",
                 "block8_f32": "coarse f32",
                 "block8_bf16 masked W": "masked W"}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the build, profile the served generator, "
                         "one training step, one block-sparse and one "
                         "flash training step at T 4096, and one ResNet-50 "
                         "step instead of phases 3-10")
    ap.add_argument("--phase12", action="store_true",
                    help="build K1-K4 and run phase 12 (training "
                         "breadth) alone")
    ap.add_argument("--phase13", action="store_true",
                    help="build K5 and run phase 13 (the image and "
                         "sequence zoo) alone")
    ap.add_argument("--phase-moe", action="store_true",
                    help="build K1-K4 and run phase 14 (Switch-MoE) "
                         "alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; a CUDA card is "
                    "required")
    if not (REPO / "bigdl_tpu_torch" / "__init__.py").exists():
        return fail(f"bigdl_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    # phase 1: probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # phase 2: build — the four CUDA libraries at once, then Triton's K4
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import layer_norm as ln

    libs = (("flash_fwd", "flash_bwd") if args.phase12 or args.phase_moe
            else
            ("conv3x3",) if args.phase13 else
            ("flash_fwd", "flash_bwd", "block_sparse", "conv3x3"))
    t0 = time.perf_counter()
    _support.load_cuda_libraries(*libs)
    cuda_build_s = time.perf_counter() - t0
    for lib in libs:
        for line in _support.BUILD_INFO[lib][1].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Performance")):
                print(f"ptxas {lib}: {line.strip()}")
    triton_build_s = 0.0
    if not args.phase13:
        t0 = time.perf_counter()
        x = torch.ones(4, 1024, device="cuda", dtype=torch.bfloat16)
        ln._layer_norm_cuda(x, x[0], x[0], 1e-5)
        torch.cuda.synchronize()
        triton_build_s = time.perf_counter() - t0
    print(f"build: {' + '.join(f'{n}.cu' for n in libs)} (nvcc, sm_90a, in "
          f"parallel) "
          f"{cuda_build_s:.1f} s (each: "
          f"{ {k: round(v[0], 1) for k, v in _support.BUILD_INFO.items()} }"
          f") -> {_support.BUILD_DIR}; layer_norm (triton, first launch) "
          f"{triton_build_s:.1f} s")

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.phase13:
        rec, failures = zoo_phase(torch, F)
        (out / "chip_phase13.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, torch=torch.__version__,
            zoo_path=rec, failures=failures), indent=1, default=str))
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        print(smi)
        return 1 if failures else 0
    if args.phase_moe:
        rec, failures = moe_phase(torch, F, smi)
        (out / "chip_phase_moe.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, torch=torch.__version__,
            moe_path=rec, failures=failures), indent=1, default=str))
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        print(smi)
        return 1 if failures else 0
    if args.phase12:
        rec, failures = training_breadth(torch)
        (out / "chip_phase12.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, torch=torch.__version__,
            training_breadth_path=rec, failures=failures), indent=1,
            default=str))
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        print(smi)
        return 1 if failures else 0

    design_rows, design_failures = kernel_design(torch)
    for design in (conv_design, mm_design):
        more_rows, more_failures = design(torch)
        design_rows += more_rows
        design_failures += more_failures

    if args.profile:
        if design_failures:
            for f in design_failures:
                print(f"FAIL: {f}", file=sys.stderr)
            return 1
        report = dict(served=profile_served(torch),
                      training_step=profile_training(torch),
                      blocksparse_training_step=profile_training(
                          torch, BS_BATCH, BS_T, max_len=BS_T,
                          seq_strategy="blocksparse", blocksparse=BS_CFG),
                      flash_T4096_training_step=profile_training(
                          torch, BS_BATCH, BS_T, max_len=BS_T),
                      resnet50_training_step=profile_resnet(torch))
        (out / "chip_profile.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, torch=torch.__version__,
            profile=report), indent=1))
        print(smi)
        return 0

    # phase 3: kernel parity
    failures = list(design_failures)
    flash_rows = check_flash(torch, F)
    ln_rows = check_layer_norm(torch, F)
    bwd_rows = check_flash_bwd(torch, F)
    failures += [f"K1 {r['case']}: row err {r['row_rel_err']:.3e} lse "
                 f"{r['lse_err']:.3e}" for r in flash_rows if not r["ok"]]
    failures += [f"K4 {r['case']}: err {r['max_abs_err']:.3e}"
                 for r in ln_rows if not r["ok"]]
    failures += [f"K2/K3 {r['case']}: row err {r['row_rel_err']}"
                 for r in bwd_rows if not r["ok"]]
    bs_rows = check_block_sparse(torch, F)
    mm_rows = check_block_sparse_mm(torch)
    failures += [f"K6-K8 {r['case']}: {r}" for r in bs_rows if not r["ok"]]
    failures += [f"K9 {r['case']}: row err {r['row_rel_err']} NaN-poison "
                 f"{r['nan_poison_ok']}" for r in mm_rows if not r["ok"]]
    conv_rows = check_conv3x3(torch, F)
    failures += [f"K5 {r['case']}: row err {r['row_rel_err']}"
                 for r in conv_rows if not r["ok"]]

    # phase 4: the serving path
    served, path_failures = serve_flagship(torch)
    failures += path_failures

    # phase 5: the training path
    trained, train_failures = train_flagship(torch)
    failures += train_failures

    # phase 6: the block-sparse training path
    bs_trained, bs_failures = train_blocksparse(torch)
    failures += bs_failures

    # phase 7: the block-sparse matmul through its entry point, bf16 and
    # f32, at the MLP's block 128 (the block route) and at block 8 (the
    # coarse route)
    mm_paths = []
    for block in (MM_BLOCK, 8):
        for dt in (torch.bfloat16, torch.float32):
            mm_path, mm_failures = matmul_entry(torch, dt, block)
            mm_paths.append(mm_path)
            failures += mm_failures

    # phase 8: the ResNet-50 training path
    resnet, resnet_failures = train_resnet50(torch)
    failures += resnet_failures

    # phase 9: paged serving — dense, windowed (K6 at block 16), prefill
    # and decode roles, exhaustion, beam search, the int8 KV cache
    paged, paged_failures = serve_paged(torch)
    failures += paged_failures

    # phase 10: train with validation and verified checkpoints, resume,
    # a loss-spike rollback, the hot swap of a checkpoint into a server
    phase10, phase10_failures = train_checkpoint_swap(torch)
    failures += phase10_failures

    # phase 11: the Torch-style API — the flagship trained by the verbs,
    # with dropout 0.1, strided layouts through K4 and K1-K3, and every
    # class ported with the API card against CPU
    phase11, phase11_failures = torch_api(torch, trained["step_ms"])
    failures += phase11_failures

    # phase 12: training breadth — remat, "block" attention, the optim
    # methods, schedules, regularizers and scales, LBFGS
    phase12, phase12_failures = training_breadth(torch)
    failures += phase12_failures

    # phase 13: the image and sequence zoo — Inception v1 at the perf
    # harness's defaults, Inception v2 and VGG-16 on K5, the recurrent
    # models, every other class of the slice card vs CPU, K5 at the
    # zoo's shapes
    phase13, phase13_failures = zoo_phase(torch, F)
    failures += phase13_failures

    # phase 14: Switch-MoE — bench.py's MoE leg trained in bf16 and f32,
    # a 2-layer copy card vs CPU, served, the dispatch against the one-hot
    # form, K1-K4 at the MoE step's shapes
    phase14, phase14_failures = moe_phase(torch, F, smi)
    failures += phase14_failures

    # launches summed over every path, each read from zero
    launches = {n: sum(b["launches"][n] for b in served["batches"])
                + trained["launches"][n] + bs_trained["launches"][n]
                + resnet["launches"][n] + paged["launches"][n]
                + phase10["launches"][n] + phase11["launches"][n]
                + phase12["launches"][n] + phase13["launches"][n]
                + phase14["launches"][n]
                for n in launch_counters()}
    for mm_path in mm_paths:
        for name, n in mm_path["launches"].items():
            launches[name] += n
    bs_row = bs_rows[0]
    rows = {"flash_fwd": dict(flash_rows[0]),
            "layer_norm_fwd": dict(ln_rows[0]),
            "flash_bwd_dkv": dict(bwd_rows[0], **bwd_rows[0]["dkv"]),
            "flash_bwd_dq": dict(bwd_rows[0], **bwd_rows[0]["dq"]),
            "block_sparse_fwd": dict(bs_row, **bs_row["fwd"]),
            "block_sparse_bwd_dkv": dict(
                bs_row, **bs_row["dkv"], plain_ms=bs_row["plain_bwd_ms"],
                library_ms=bs_row["library_bwd_ms"]),
            "block_sparse_bwd_dq": dict(
                bs_row, **bs_row["dq"], plain_ms=bs_row["plain_bwd_ms"],
                library_ms=bs_row["library_bwd_ms"]),
            "block_sparse_mm": dict(mm_rows[0]),
            "conv3x3": dict(conv_rows[0])}
    bs_src = "bigdl_tpu_torch/ops/csrc/block_sparse.cu"
    kernels = []
    for name, route, source, replaces in (
            ("flash_fwd", "cuda", "bigdl_tpu_torch/ops/csrc/flash_fwd.cu",
             "bigdl_tpu/ops/flash_attention.py:150"),
            ("flash_bwd_dkv", "cuda", "bigdl_tpu_torch/ops/csrc/flash_bwd.cu",
             "bigdl_tpu/ops/flash_attention.py:236"),
            ("flash_bwd_dq", "cuda", "bigdl_tpu_torch/ops/csrc/flash_bwd.cu",
             "bigdl_tpu/ops/flash_attention.py:271"),
            ("layer_norm_fwd", "triton", "bigdl_tpu_torch/ops/layer_norm.py",
             "bigdl_tpu/ops/layer_norm.py:25"),
            ("block_sparse_fwd", "cuda", bs_src,
             "bigdl_tpu/ops/block_sparse.py:292"),
            ("block_sparse_bwd_dkv", "cuda", bs_src,
             "bigdl_tpu/ops/block_sparse.py:317"),
            ("block_sparse_bwd_dq", "cuda", bs_src,
             "bigdl_tpu/ops/block_sparse.py:345"),
            ("block_sparse_mm", "cuda", bs_src,
             "bigdl_tpu/ops/block_sparse.py:626"),
            ("conv3x3", "cuda", "bigdl_tpu_torch/ops/csrc/conv3x3.cu",
             "bigdl_tpu/ops/conv3x3_pallas.py:60")):
        row = rows[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
        if launches[name] == 0:
            failures.append(f"{name} was never launched on the main paths")
    # the f32 instantiations at D 192 and 256 and the chunked forward
    # above 256 (D 320) in each dtype, on no main path (B 2, H 8, T 1024,
    # causal; K6-K8 under phase 3's window 2 + 1 global): their launches
    # on the main paths, by their own counters
    def bs_pass(r, p):
        return dict(r, **r[p], **({} if p == "fwd" else dict(
            plain_ms=r["plain_bwd_ms"], library_ms=r["library_bwd_ms"])))

    for kernel, cases in (
            (kernels[0], flash_rows),
            (kernels[1], [dict(r, **r["dkv"]) for r in bwd_rows]),
            (kernels[2], [dict(r, **r["dq"]) for r in bwd_rows]),
            *((kernels[i], [bs_pass(r, p) for r in bs_rows if p in r])
              for i, p in ((4, "fwd"), (5, "dkv"), (6, "dq"))),
            (kernels[7], mm_rows + [
                dict(r["masked_w"], case=f"{r['case']} masked W")
                for r in mm_rows if "masked_w" in r])):
        kernel["variants"] = [dict(
            name=name, route="cuda", source=kernel["source"],
            replaces=kernel["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"])
            for r in cases if r["case"] in VARIANT_CASES
            for name in [f"{kernel['name']} {VARIANT_CASES[r['case']]}"]
            if name in launches]
    # K6 at the serving mask (block 16, 32 x 32 pages, window 8 + 1
    # global): phase 3's case, its launches phase 9's windowed server's
    for r in bs_rows:
        if r["case"] == "serve_page16":
            row = bs_pass(r, "fwd")
            kernels[4]["variants"].append(dict(
                name="block_sparse_fwd page16", route="cuda",
                source=bs_src, replaces=kernels[4]["replaces"],
                launches=paged["page16_k6_launches"],
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"]))

    # K5 at the zoo's shapes, one variant a model: one bf16 training
    # step's launches, their times summed over phase 13 (e)'s rows; its
    # launches that model's bf16 run's (phase 13 (a), (b))
    kernels[8]["variants"] = [dict(
        name=f"conv3x3 {name} step bf16", route="cuda",
        source=kernels[8]["source"], replaces=kernels[8]["replaces"],
        launches=step["launches"], max_abs_err=step["max_abs_err"],
        ms=step["ms"], plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
        bound_by=step["bound_by"], library_ms=step["library_ms"])
        for name, step in phase13["k5_per_step"].items()]

    # K1-K4 at the MoE step's shapes (4 heads of 128; LayerNorm over
    # 512), one variant each: its launches phase 14 (a)'s bf16 run's
    moe_k = phase14["kernels"]
    moe_rows = {"flash_fwd": moe_k["flash"][0],
                "flash_bwd_dkv": dict(moe_k["flash_bwd"][0],
                                      **moe_k["flash_bwd"][0]["dkv"]),
                "flash_bwd_dq": dict(moe_k["flash_bwd"][0],
                                     **moe_k["flash_bwd"][0]["dq"]),
                "layer_norm_fwd": moe_k["layer_norm"][0]}
    for kernel in kernels[:4]:
        r = moe_rows[kernel["name"]]
        kernel.setdefault("variants", []).append(dict(
            name=f"{kernel['name']} moe step", route=kernel["route"],
            source=kernel["source"], replaces=kernel["replaces"],
            launches=phase14["step_launches"][kernel["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))

    # K4's strided instantiation, one variant a dtype: phase 11 (c)'s
    # transposed LayerNorm input, its launches that leg's count
    kernels[3]["variants"] += [dict(
        name=f"layer_norm_fwd strided {r['case'].split()[-1]}",
        route="triton", source=kernels[3]["source"],
        replaces=kernels[3]["replaces"],
        launches=r["launches"].get("layer_norm_fwd_strided", 0),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"])
        for r in phase11["strided"] if "ms" in r]

    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=kind, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, cuda_build_s=cuda_build_s,
        build_s={k: v[0] for k, v in _support.BUILD_INFO.items()},
        triton_build_s=triton_build_s, hopper_design=design_rows,
        flash=flash_rows, layer_norm=ln_rows,
        flash_bwd=bwd_rows, block_sparse=bs_rows, block_sparse_mm=mm_rows,
        conv3x3=conv_rows, serving_path=served, training_path=trained,
        blocksparse_training_path=bs_trained, matmul_path=mm_paths,
        resnet50_training_path=resnet, paged_serving_path=paged,
        checkpoint_swap_path=phase10, torch_api_path=phase11,
        training_breadth_path=phase12, zoo_path=phase13, moe_path=phase14,
        kernels=kernels, failures=failures, seconds=time.perf_counter()
        - T_START), indent=1))

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
