"""The twin soft-Q pass of the SAC update: both critics of a pair through
one set of kernels.

:func:`twin_q` computes ``(q1(obs, act), q2(obs, act))`` for two
:class:`citylearn_tpu_torch.agents.sac.SoftQ` networks of the same shape,
(``q1``, ``q2``) or (``q1_target``, ``q2_target``). On CPU tensors it
runs the networks' own ``forward`` (the plain version), and
``torch.autograd`` takes the backward. On CUDA tensors it launches the
hand-written kernels of ``csrc/twin_q.cu`` through a
``torch.autograd.Function`` whose backward is a kernel too: a layer of
both critics and every agent in one launch, the bias, relu, LayerNorm
and the value head fused around the product; backward a row pass and a
column pass a layer. It replaces no Pallas kernel: the JAX package
leaves the update to XLA.

The kernels read each network's own parameter tensors by pointer, by
name (``w``, ``b``, ``ln_scale``, ``ln_bias``), and ``obs`` and ``act``
through their strides. The backward computes what
``ctx.needs_input_grad`` asks for: with ``param_grads=False`` the
parameters enter detached, so a loss that wants only the gradient to the
action (the policy loss) computes no parameter gradient.

Widths the kernels take: every hidden layer, and the input of a layer
whose input gradient is asked for, 1 to 512 wide; the input 1 wide or
more; any batch N of 1 or more; one hidden layer or more. Other shapes
raise.

``twin_q.launches`` counts the kernel launches, as K1-K6's counters do: a
forward pass launches one kernel a hidden layer, a backward a row pass a
layer and, where the parameters' gradients are asked for, a column pass
a layer (an update with two hidden layers makes 6 + 4 + 2 launches);
inside a CUDA graph it counts the captured ones. The span ``twin_q``
counts the forward passes.

:func:`reference` is the pass in plain PyTorch in any precision, with
each relu on given branches; :func:`relu_branches` reads the branches
the kernels took, and :func:`branch_flips` where they differ from the
reference's signs, for the tests on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.ops import _build

MAX_WIDTH = 512

_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_INPUT = [_PTR, _LL, _LL, _LL, _LL, _INT, _PTR, _LL, _LL, _LL, _INT]
ARGTYPES = {
    "twin_q_forward_launch": _INPUT + [_INT] * 3 + [_PTR] * 18 + [_PTR],
    "twin_q_rows_launch": [_INT] * 4 + [_PTR] * 15 + [_INT] * 2 + [_PTR],
    "twin_q_columns_launch": _INPUT + [_INT] * 3 + [_PTR] * 20 + [_PTR],
}


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the launch functions' argument and return types on ``lib``."""
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return declare(_build.load("twin_q"))


def _launch(name: str, device: torch.device, *args):
    twin_q.launches += 1
    _run(name, device, args)


def _run(name: str, device: torch.device, args: tuple):
    # the launch function runs on the CUDA runtime's current device: make it
    # the tensors' card
    with torch.cuda.device(device):
        err = getattr(_library(), name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"twin_q: {name} failed: CUDA error {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _ptrs(pair) -> tuple:
    """The two critics' tensors of a pair, by pointer."""
    return pair[0].data_ptr(), pair[1].data_ptr()


def _first_input(obs: torch.Tensor, act: torch.Tensor) -> tuple:
    """The first layer's input, (obs, act) side by side, read in place:
    both critics read it (critic stride 0)."""
    return (obs.data_ptr(), 0, *obs.stride(), obs.shape[-1],
            act.data_ptr(), *act.stride(), act.shape[-1])


def _dense_input(y: torch.Tensor) -> tuple:
    """A later layer's input, the (2, A, N, width) output of the one before."""
    return (y.data_ptr(), *y.stride(), y.shape[-1], None, 0, 0, 0, 0)


class _Nets(NamedTuple):
    """Two critics' parameters by name, each a list over layers of
    (critic 1's, critic 2's): ``w`` and ``b`` the hidden layers' then the
    value head's, ``ln_scale`` and ``ln_bias`` the hidden layers'."""
    w: list
    b: list
    ln_scale: list
    ln_bias: list

    @classmethod
    def of(cls, q1, q2) -> "_Nets":
        return cls(*(list(zip(getattr(q1, f), getattr(q2, f))) for f in cls._fields))

    def flat(self) -> list:
        """The tensors in the order ``_TwinQ.apply`` takes them."""
        return [x for field in self for pair in field for x in pair]

    @classmethod
    def unflat(cls, flat: Sequence, layers: int) -> "_Nets":
        it = iter(flat)
        take = lambda n: [(next(it), next(it)) for _ in range(n)]
        return cls(take(layers + 1), take(layers + 1), take(layers), take(layers))


class _Layer(NamedTuple):
    """What a hidden layer's forward saves for the backward, each for both
    critics: its output (2, A, N, H), relu's output (2, A, N, H), and the
    LayerNorm's mean and sd (2, A, N)."""
    y: torch.Tensor
    relu: torch.Tensor
    mean: torch.Tensor
    sd: torch.Tensor


class _Saved(NamedTuple):
    obs: torch.Tensor
    act: torch.Tensor
    nets: _Nets
    layers: List[_Layer]


def _saved(ctx) -> _Saved:
    """What ``_TwinQ.forward`` saved, by name."""
    obs, act, *rest = ctx.saved_tensors
    n = 4 * ctx.layers
    params, kept = rest[:-n], rest[-n:]
    return _Saved(obs, act, _Nets.unflat(params, ctx.layers),
                  [_Layer(*kept[i:i + 4]) for i in range(0, n, 4)])


class _TwinQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, obs, act, save, L, *params):
        nets = _Nets.unflat(params, L)
        A, N, K = obs.shape
        dev = obs.device
        empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        q = (empty(A, N, 1), empty(A, N, 1))
        x, saved = _first_input(obs, act), []
        for l in range(L):
            H = nets.ln_scale[l][0].shape[-1]
            last = l == L - 1
            y = empty(2, A, N, H) if save or not last else None
            r, mean, sd = (empty(2, A, N, H), empty(2, A, N), empty(2, A, N)) if save \
                else (None, None, None)
            head = (*_ptrs(nets.w[L]), *_ptrs(nets.b[L])) if last else (None,) * 4
            _launch("twin_q_forward_launch", dev, *x, A, N, H,
                    *_ptrs(nets.w[l]), *_ptrs(nets.b[l]), *_ptrs(nets.ln_scale[l]),
                    *_ptrs(nets.ln_bias[l]), *head, _ptr(y), _ptr(r), _ptr(mean), _ptr(sd),
                    *((q[0].data_ptr(), q[1].data_ptr()) if last else (None, None)))
            saved += [y, r, mean, sd]
            if not last:
                x = _dense_input(y)
        if save:
            ctx.save_for_backward(obs, act, *params, *saved)
            ctx.layers = L
        return q

    @staticmethod
    @once_differentiable
    def backward(ctx, dq0, dq1):
        obs, act, nets, layers = _saved(ctx)
        L = ctx.layers
        A, N, K = obs.shape
        M = act.shape[-1]
        dev = obs.device
        need_obs, need_act = ctx.needs_input_grad[:2]
        need_params = any(ctx.needs_input_grad[4:])
        empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        dq = [g.contiguous() for g in (dq0, dq1)]
        grads = _Nets(*([(torch.empty_like(a), torch.empty_like(b)) for a, b in field]
                        for field in nets)) if need_params else None
        dy = dx = None
        for l in reversed(range(L)):
            y, r, mean, sd = layers[l]
            H = y.shape[-1]
            last = l == L - 1
            width = K + M if l == 0 else layers[l - 1].y.shape[-1]
            lo, hi = (0, width) if l > 0 else (0 if need_obs else K, K + M if need_act else K)
            dx = empty(2, A, N, hi - lo) if hi > lo else None
            dz = empty(2, A, N, H) if need_params else None
            dy_out = empty(2, A, N, H) if need_params and last else None
            head = (*_ptrs(dq), *_ptrs(nets.w[L])) if last else (None,) * 4
            _launch("twin_q_rows_launch", dev, A, N, H, width, _ptr(dy), *head,
                    r.data_ptr(), mean.data_ptr(), sd.data_ptr(),
                    *_ptrs(nets.ln_scale[l]), *_ptrs(nets.w[l]),
                    _ptr(dy_out), _ptr(dz), _ptr(dx), lo, hi)
            if need_params:
                x = _first_input(obs, act) if l == 0 else _dense_input(layers[l - 1].y)
                head_grads = (*_ptrs(grads.w[L]), *_ptrs(grads.b[L])) if last else (None,) * 4
                _launch("twin_q_columns_launch", dev, *x, A, N, H,
                        dz.data_ptr(), _ptr(dy_out if last else dy), r.data_ptr(),
                        mean.data_ptr(), sd.data_ptr(), _ptr(y if last else None),
                        *(head[:2] if last else (None, None)),
                        *_ptrs(grads.w[l]), *_ptrs(grads.b[l]), *_ptrs(grads.ln_scale[l]),
                        *_ptrs(grads.ln_bias[l]), *head_grads)
            dy = dx
        # the first layer's input gradient, both critics summed
        both = lambda a, b: dx[0, ..., a - lo:b - lo] + dx[1, ..., a - lo:b - lo]
        d_obs = both(0, K) if need_obs else None
        d_act = both(K, K + M) if need_act else None
        flat = grads.flat() if need_params else [None] * len(nets.flat())
        return (d_obs, d_act, None, None,
                *(g if need else None for g, need in zip(flat, ctx.needs_input_grad[4:])))


def _check(q1, q2, obs: torch.Tensor, act: torch.Tensor):
    """Raise unless the kernels take these inputs and networks."""
    A, N, K = obs.shape
    if act.dim() != 3 or act.shape[:2] != (A, N) or N < 1 or act.shape[-1] < 1:
        raise ValueError(f"twin_q wants obs (A, N, K) and act (A, N, M) with N >= 1, got "
                         f"{tuple(obs.shape)} and {tuple(act.shape)}")
    width = K + act.shape[-1]
    if obs.requires_grad and width > MAX_WIDTH:
        raise ValueError(f"twin_q's input gradient takes {MAX_WIDTH} columns at most, "
                         f"got {width}")
    for x in (obs, act, *q1.parameters(), *q2.parameters()):
        if x.device != obs.device or x.dtype != torch.float32:
            raise ValueError(f"twin_q wants float32 on {obs.device}, got {x.dtype} on "
                             f"{x.device}")
    hidden = [g.shape[-1] for g in q1.ln_scale]
    if not hidden or any(not 1 <= h <= MAX_WIDTH for h in hidden):
        raise ValueError(f"twin_q takes hidden widths of 1 to {MAX_WIDTH}, one layer or more, "
                         f"got {hidden}")
    sizes = [width, *hidden, 1]
    shapes = {"w": [(A, i, o) for i, o in zip(sizes[:-1], sizes[1:])],
              "b": [(A, o) for o in sizes[1:]],
              "ln_scale": [(A, h) for h in hidden], "ln_bias": [(A, h) for h in hidden]}
    for net in (q1, q2):
        got = {f: [tuple(p.shape) for p in getattr(net, f)] for f in shapes}
        if got != shapes or not all(p.is_contiguous() for f in shapes for p in getattr(net, f)):
            raise ValueError(f"twin_q wants two networks of contiguous parameters shaped "
                             f"{shapes}, got {got}")


@tracing.traced("twin_q")
def twin_q(q1, q2, obs: torch.Tensor, act: torch.Tensor, *, param_grads: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q1(obs, act), q2(obs, act))``, each (A, N, 1), for two ``SoftQ``
    networks of the same shape; ``obs`` (A, N, K) and ``act`` (A, N, M)
    in any strides. With ``param_grads=False`` no gradient flows into the
    networks' parameters (the card's backward computes none).

    CPU tensors run the networks' ``forward``; CUDA tensors launch the
    kernels, and anything else raises. The kernels take hidden widths of
    1 to 512 (every width the repo's configurations use: 8 to 256, and the
    host-loop MARLISA's 400 and 300)."""
    if obs.device.type == "cpu":
        return q1(obs, act), q2(obs, act)
    if obs.device.type != "cuda":
        raise ValueError(f"twin_q runs on CPU or CUDA tensors, not {obs.device}")
    return _kernels(q1, q2, obs, act, param_grads)


def _kernels(q1, q2, obs, act, param_grads: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`twin_q`'s kernel path."""
    _check(q1, q2, obs, act)
    nets = _Nets.of(q1, q2)
    params = nets.flat() if param_grads else [p.detach() for p in nets.flat()]
    save = torch.is_grad_enabled() and any(x.requires_grad for x in (obs, act, *params))
    return _TwinQ.apply(obs, act, save, len(nets.ln_scale), *params)


twin_q.launches = 0


def reference(q1, q2, obs: torch.Tensor, act: torch.Tensor, relu=None):
    """The twin pass in plain PyTorch, in the precision of the networks'
    parameters: each network as ``SoftQ.forward`` writes it, with each
    hidden layer's relu on the branch that ``relu[l]`` ((2, A, N, H)
    booleans, True where it passes) gives, where given. Returns the two
    values, and per hidden layer its pre-activations (2, A, N, H) and
    their scale ``|x| @ |W| + |b|``, the size that their rounding error in
    float32 is a multiple of."""
    values, pre, scale = [], [[], []], [[], []]
    for c, q in enumerate((q1, q2)):
        x = torch.cat([obs, act], dim=-1)
        for l, (w, b) in enumerate(zip(q.w[:-1], q.b[:-1])):
            z = torch.matmul(x, w) + b[:, None, :]
            pre[c].append(z)
            scale[c].append((torch.matmul(x.abs(), w.abs()) + b.abs()[:, None, :]).detach())
            x = torch.relu(z) if relu is None else z * relu[l][c]
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
            x = ((x - mean) / torch.sqrt(var + 1e-5) * q.ln_scale[l][:, None]
                 + q.ln_bias[l][:, None])
        values.append(torch.matmul(x, q.w[-1]) + q.b[-1][:, None, :])
    layers = lambda xs: [torch.stack(pair) for pair in zip(*xs)]
    return tuple(values), layers(pre), layers(scale)


def relu_branches(value: torch.Tensor) -> List[torch.Tensor]:
    """The relu branch that the kernels' forward took in each hidden layer,
    (2, A, N, H) booleans, True where it passed: read from what the forward
    saved for its backward. ``value`` is either of its outputs."""
    return [layer.relu > 0 for layer in _saved(value.grad_fn).layers]


def branch_flips(branches, pre, scale) -> Tuple[int, float]:
    """Where the kernels' relu branches and the signs of :func:`reference`'s
    pre-activations (computed on those branches) disagree: how many
    elements, and the largest ``|pre|`` among them in float32 epsilons of
    its scale (0 where none)."""
    eps = torch.finfo(torch.float32).eps
    flips = [(took != (z > 0)) for took, z in zip(branches, pre)]
    count = sum(int(f.sum()) for f in flips)
    worst = max((float((z.detach().abs() / (eps * s))[f].max()) for f, z, s in
                 zip(flips, pre, scale) if f.any()), default=0.0)
    return count, worst
