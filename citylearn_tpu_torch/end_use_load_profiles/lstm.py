"""LSTM temperature-dynamics model training (reference
``citylearn/end_use_load_profiles/lstm_model/``), on the card.

Trains the lookback-window LSTM used by ``LSTMDynamicsBuilding`` from
(ideal + partial-load) simulation results and returns a state dict the
schema compiler loads (the tensor names of the torch models shipped with
the datasets). The cells are written out with ``torch.matmul`` rather
than taken from ``torch.nn.LSTM``, whose cuDNN path runs float32 in TF32
by default: the port runs float32 as float32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _init_lstm(gen: torch.Generator, input_size: int, hidden: int,
               num_layers: int) -> Dict[str, torch.Tensor]:
    """U(-1/sqrt(hidden), 1/sqrt(hidden)) weights in the JAX package's key
    order: per layer ``weight_ih``, ``weight_hh``, ``bias_ih``,
    ``bias_hh``, then the linear head's weight and bias."""
    bound = 1.0 / np.sqrt(hidden)
    u = lambda *shape: (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound
    params = {}
    for l in range(num_layers):
        fan = input_size if l == 0 else hidden
        params[f"l_lstm.weight_ih_l{l}"] = u(4 * hidden, fan)
        params[f"l_lstm.weight_hh_l{l}"] = u(4 * hidden, hidden)
        params[f"l_lstm.bias_ih_l{l}"] = u(4 * hidden)
        params[f"l_lstm.bias_hh_l{l}"] = u(4 * hidden)
    params["l_linear.weight"] = u(1, hidden)
    params["l_linear.bias"] = u(1)
    return params


def forward(params: Mapping[str, torch.Tensor], x: torch.Tensor, num_layers: int,
            hidden: int) -> torch.Tensor:
    """x: (batch, lookback, F) -> (batch,) prediction from the last hidden
    state of the top layer. Gates ``i, f, g, o`` as in torch's LSTM."""
    seq = x
    for l in range(num_layers):
        w_ih = params[f"l_lstm.weight_ih_l{l}"]
        w_hh = params[f"l_lstm.weight_hh_l{l}"]
        b = params[f"l_lstm.bias_ih_l{l}"] + params[f"l_lstm.bias_hh_l{l}"]
        xw = torch.matmul(seq, w_ih.T)             # every step's input term at once
        h = x.new_zeros((x.shape[0], hidden))
        c = x.new_zeros((x.shape[0], hidden))
        ys = []
        for t in range(seq.shape[1]):
            g = xw[:, t] + torch.matmul(h, w_hh.T) + b
            i, f, gg, o = g.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        seq = torch.stack(ys, dim=1)
    out = torch.matmul(seq[:, -1, :], params["l_linear.weight"].T) + params["l_linear.bias"]
    return out[:, 0]


def make_windows(features: np.ndarray, target: np.ndarray, lookback: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding lookback windows: features (T, F) -> (N, lookback, F)."""
    T = len(target)
    n = T - lookback
    X = np.stack([features[i:i + lookback] for i in range(n)])
    y = target[lookback:]
    return X.astype(np.float32), y.astype(np.float32)


def fit_lstm(features, target, lookback: int = 12, hidden: int = 16, num_layers: int = 2,
             epochs: int = 50, batch_size: int = 256, lr: float = 1e-3, seed: int = 0,
             device=None, initial_state: Optional[Mapping[str, np.ndarray]] = None
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """:func:`train_lstm`'s loop: returns the trained tensors on the
    device and the loss of every Adam step, (n_steps,) on the device."""
    from citylearn_tpu_torch import resolve_device

    dev = resolve_device(device)
    if isinstance(features, (list, tuple)):
        pairs = [make_windows(f, t, lookback) for f, t in zip(features, target)]
        X = np.concatenate([p[0] for p in pairs])
        y = np.concatenate([p[1] for p in pairs])
    else:
        X, y = make_windows(features, target, lookback)
    init = (_init_lstm(torch.Generator().manual_seed(seed), X.shape[-1], hidden, num_layers)
            if initial_state is None
            else {k: torch.tensor(np.asarray(v, np.float32)) for k, v in initial_state.items()})
    params = {k: v.to(dev).requires_grad_(True) for k, v in init.items()}
    # optax.adam(lr)'s settings
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    X, y = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    rng = np.random.RandomState(seed)
    n = len(X)
    losses = []
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            loss = torch.mean((forward(params, X[sel], num_layers, hidden) - y[sel]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    steps = torch.stack(losses) if losses else X.new_zeros(0)
    return {k: v.detach() for k, v in params.items()}, steps


def train_lstm(features, target, lookback: int = 12, hidden: int = 16, num_layers: int = 2,
               epochs: int = 50, batch_size: int = 256, lr: float = 1e-3, seed: int = 0,
               device=None, initial_state: Optional[Mapping[str, np.ndarray]] = None
               ) -> Mapping[str, np.ndarray]:
    """Train and return a torch-layout state dict (numpy arrays).

    ``features``/``target`` may be lists of per-segment arrays (e.g. the
    independent partial-load simulation runs): windows are built within
    each segment so no window or target spans a segment boundary.
    Batches follow ``np.random.RandomState(seed).permutation`` per epoch
    (the last partial batch dropped); the weights start from
    ``initial_state`` (numpy arrays by name) when given, else from
    :func:`_init_lstm` on a ``torch.Generator`` seeded with ``seed``.
    ``device=None`` trains on the card."""
    params, _ = fit_lstm(features, target, lookback, hidden, num_layers, epochs,
                         batch_size, lr, seed, device, initial_state)
    return {k: v.cpu().numpy() for k, v in params.items()}
