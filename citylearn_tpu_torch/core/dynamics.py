"""LSTM temperature dynamics (reference ``citylearn/dynamics.py``, which
runs ``torch.nn.LSTM`` one building at a time): plain functions on
tensors with per-building weight stacks, batched over districts and the
buildings of one dynamics group.
"""

from __future__ import annotations

from typing import Tuple

import torch

from citylearn_tpu_torch.core.types import DynamicsParams


def lstm_predict(dyn: DynamicsParams, model_in: torch.Tensor,
                 h0: torch.Tensor, c0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one group's stacked LSTM over the lookback window.

    ``model_in``: (D, Bg, lookback, F); ``h0``/``c0``: (D, L, Bg, H)
    carried across env steps (reference ``building.py:3020-3024`` detaches
    and reuses the hidden state). Returns (pred (D, Bg), h, c) where pred
    is the normalized temperature from the linear head on the final
    hidden output (``dynamics.py:94-101``).
    """
    H = dyn.lin_w.shape[1]
    x = model_in                                    # (D, Bg, S, F)
    hs, cs = [], []
    for l, (w_ih, w_hh, b) in enumerate(zip(dyn.w_ih, dyn.w_hh, dyn.bias)):
        h_t, c_t = h0[:, l], c0[:, l]               # (D, Bg, H)
        ys = []
        for s in range(x.shape[2]):
            gates = (torch.einsum("bgf,dbf->dbg", w_ih, x[:, :, s])
                     + torch.einsum("bgh,dbh->dbg", w_hh, h_t) + b)
            i = torch.sigmoid(gates[..., 0 * H:1 * H])
            f = torch.sigmoid(gates[..., 1 * H:2 * H])
            g = torch.tanh(gates[..., 2 * H:3 * H])
            o = torch.sigmoid(gates[..., 3 * H:4 * H])
            c_t = f * c_t + i * g
            h_t = o * torch.tanh(c_t)
            ys.append(h_t)
        x = torch.stack(ys, dim=2)                  # (D, Bg, S, H) feeds the next layer
        hs.append(h_t)
        cs.append(c_t)
    pred = torch.einsum("dbh,bh->db", x[:, :, -1], dyn.lin_w) + dyn.lin_b
    return pred, torch.stack(hs, dim=1), torch.stack(cs, dim=1)
