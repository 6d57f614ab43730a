"""SimpleRNN and the LSTM/GRU text classifier (counterpart of
``bigdl_tpu/models/rnn.py``; reference models/rnn/SimpleRNN.scala).

SimpleRNN: one-hot input → Recurrent(RnnCell) → TimeDistributed(Linear)
→ LogSoftMax over the class dim of (N, T, C), trained with
``TimeDistributedCriterion(ClassNLLCriterion())``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..device import DeviceLike
from ._build import Build


def SimpleRNN(input_size: int = 4001, hidden_size: int = 40,
              output_size: int = 4001, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> nn.Sequential:
    L = Build(device, generator)
    return L.seq(
        L(nn.Recurrent, L(nn.RnnCell, input_size, hidden_size)).set_name(
            "rnn"),
        L(nn.TimeDistributed, L(nn.Linear, hidden_size, output_size)),
        L(nn.LogSoftMax))


def LSTMClassifier(vocab_size: int, embed_dim: int, hidden: int,
                   class_num: int, padding_value: int = 0,
                   cell: str = "lstm", device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None
                   ) -> nn.Sequential:
    """The LSTM/GRU text classifier (BASELINE.md workload 5): 1-based ids
    (N, T) → embedding → Recurrent(LSTM or GRU) → the last step →
    Linear → LogSoftMax.  ``padding_value``: a padding id whose
    embedding rows are zeroed (0: none)."""
    if cell not in ("lstm", "gru"):
        raise ValueError(f"cell must be 'lstm' or 'gru', got {cell!r}")
    L = Build(device, generator)
    return L.seq(
        L(nn.LookupTable, vocab_size, embed_dim, padding_value=padding_value),
        L(nn.Recurrent, L(nn.GRU if cell == "gru" else nn.LSTM, embed_dim,
                          hidden)),
        L(nn.Select, 2, -1),
        L(nn.Linear, hidden, class_num),
        L(nn.LogSoftMax))
