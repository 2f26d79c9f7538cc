"""The twin soft-Q pass (``citylearn_tpu_torch.ops.twin_q``).

On the CPU the wrapper is the networks' own ``forward`` and autograd: the
values, every parameter's gradient and, with ``param_grads=False``, the
action's alone, against two ``SoftQ.forward`` calls, at 1 and 3 hidden
layers, widths 8, 64 and 256, N = 1, 37 and 300 and an odd input width.
The kernel source ``csrc/twin_q.cu`` runs on the CPU through the
thread-per-lane emulation of ``tests/_cuda_emulation.py`` behind the
wrapper's own ``autograd.Function``, against the plain version within
1e-5 (forward, relative to the values' mean magnitude; each gradient
leaf by the norm of its difference over the plain leaf's norm, as the
benchmark's ``grad_gap`` measures it), at ragged N and at every column
count a thread takes (widths up to 64, 128, 256, 512).

The ``gpu`` tests hold the kernels on the card, within the same 1e-5,
against the plain version there in float64 (``twin_q.reference``) with
each relu on the branch the kernels' forward took, at the benchmark
cells' shapes, the host-loop agents' (A=1, MARLISA's 400x300) and ragged
N. A pre-activation within rounding of 0 can take the other branch in
another precision or order of sums, and the gradient steps there: at the
cell-1 case's draws the float32 plain version misses the float64 one by
7.8e-4. So the branches are checked first: float64's pre-activations,
computed on their own, take the kernels' branch everywhere but at a few
elements (one and FLIP_SHARE of them at most), each within FLIP_EPS float32
epsilons of its rounding scale ``|x| @ |W| + |b|``.
Two runs bit-equal (no atomics); a width the kernels do not take raises;
an eager ``_sac_step`` makes three forward and two backward twin passes,
12 kernel launches.
This file imports no JAX: on the card,
``python -m pytest --noconftest -m gpu tests/test_torch_twin_q.py``."""

import copy

import pytest
import torch

import _cuda_emulation as emulation
from citylearn_tpu_torch import tracing
from citylearn_tpu_torch.agents import sac
from citylearn_tpu_torch.ops import twin_q as twin_q_mod
from citylearn_tpu_torch.ops.twin_q import twin_q

TOL = 1e-5
FLIP_EPS = 32
FLIP_SHARE = 1e-5


def nets(A, K, M, hidden, device, seed=0):
    """Two SoftQ nets of one shape, LayerNorm's scale and bias drawn off
    their initial 1 and 0 so that their gradients matter."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(2):
        q = sac.SoftQ(A, K, M, hidden, g, device)
        with torch.no_grad():
            for s, b in zip(q.ln_scale, q.ln_bias):
                s.add_(0.2 * torch.randn(s.shape, generator=g, device=device))
                b.add_(0.2 * torch.randn(b.shape, generator=g, device=device))
        out.append(q)
    return out


def inputs(A, N, K, M, device, seed=1):
    """obs as ``BatchedSAC._update`` lays it out (an agent-first view of
    row-major replay rows), act contiguous and requiring grad."""
    g = torch.Generator(device=device).manual_seed(seed)
    obs = torch.randn((N, A * K), generator=g, device=device).view(N, A, K).transpose(0, 1)
    act = torch.randn((A, N, M), generator=g, device=device).tanh().requires_grad_()
    dq = torch.randn((2, A, N, 1), generator=g, device=device)
    return obs, act, dq


def run(fn, q1, q2, obs, act, dq, param_grads=True):
    """Values, then the gradients of sum(dq * q) to every parameter (or
    to ``act`` alone)."""
    return finish(fn(q1, q2, obs, act, param_grads=param_grads), q1, q2, act, dq, param_grads)


def finish(values, q1, q2, act, dq, param_grads):
    loss = (dq[0] * values[0]).sum() + (dq[1] * values[1]).sum()
    leaves = [*q1.parameters(), *q2.parameters()] if param_grads else [act]
    return [v.detach() for v in values], torch.autograd.grad(loss, leaves)


def plain(q1, q2, obs, act, param_grads=True):
    return q1(obs, act), q2(obs, act)


def grad_gap(ours, ref) -> float:
    return max(float(torch.linalg.vector_norm((x - y).double())
                     / torch.linalg.vector_norm(y.double()).clamp(min=1e-30))
               for x, y in zip(ours, ref))


def value_gap(ours, ref) -> float:
    return max(float((x - y).abs().max() / y.abs().mean())
               for x, y in zip(ours, (r.detach() for r in ref)))


# --- the CPU: the plain path -----------------------------------------------------

@pytest.mark.parametrize("n_rows", [1, 37, 300])
@pytest.mark.parametrize("width", [8, 64, 256])
@pytest.mark.parametrize("layers", [1, 3])
def test_plain_path_is_the_nets_forward(layers, width, n_rows):
    A, K, M = 2, 6, 3          # K + M odd
    q1, q2 = nets(A, K, M, [width] * layers, "cpu")
    obs, act, dq = inputs(A, n_rows, K, M, "cpu")
    for param_grads in (True, False):
        ours = run(twin_q, q1, q2, obs, act, dq, param_grads)
        ref = run(plain, q1, q2, obs, act, dq, param_grads)
        for x, y in zip(ours[0] + list(ours[1]), ref[0] + list(ref[1])):
            assert torch.equal(x, y)


def test_cpu_policy_loss_leaves_the_nets_without_gradients():
    q1, q2 = nets(2, 5, 2, [8, 8], "cpu")
    obs, act, _ = inputs(2, 9, 5, 2, "cpu")
    torch.minimum(*twin_q(q1, q2, obs, act, param_grads=False)).sum().backward()
    assert act.grad is not None
    assert all(p.grad is not None for p in q1.parameters())    # the plain path: autograd's


# --- the CPU: the kernel source, emulated ------------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return twin_q_mod.declare(emulation.build("twin_q", tmp_path_factory.mktemp("twin_q")))


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrapper's kernel path on CPU tensors, its launches through the
    emulated library."""
    def launch(name, device, args):
        assert getattr(emulated, name)(*args, None) == 0, name

    monkeypatch.setattr(twin_q_mod, "_run", launch)
    return lambda q1, q2, obs, act, param_grads=True: twin_q_mod._kernels(q1, q2, obs, act,
                                                                          param_grads)


@pytest.mark.parametrize("A,K,M,hidden,n_rows", [
    (2, 5, 2, [16, 8], 37),          # widths to 64: one column a thread; N ragged
    (1, 30, 1, [100, 64], 16),       # the host-loop agent; 100: two columns a thread
    (2, 36, 1, [256], 19),           # four columns a thread, the input past one chunk
    (1, 4, 3, [300, 24, 8], 5),      # 300: eight columns a thread; three layers
], ids=["16x8", "100x64", "256", "300x24x8"])
def test_emulated_kernels_match_the_plain_version(kernels, A, K, M, hidden, n_rows):
    q1, q2 = nets(A, K, M, hidden, "cpu")
    obs, act, dq = inputs(A, n_rows, K, M, "cpu")
    for param_grads in (True, False):
        values, grads = run(kernels, q1, q2, obs, act, dq, param_grads)
        ref_values, ref_grads = run(plain, q1, q2, obs, act, dq, param_grads)
        assert value_gap(values, ref_values) < TOL
        assert grad_gap(grads, ref_grads) < TOL


def test_emulated_target_pass_saves_nothing_and_counts(kernels):
    """Under no_grad (the target's pass) the values alone; a forward
    launches a kernel a hidden layer, a backward a row and a column pass
    a layer."""
    q1, q2 = nets(2, 5, 2, [16, 16], "cpu")
    obs, act, dq = inputs(2, 20, 5, 2, "cpu")
    before = twin_q.launches
    with torch.no_grad():
        values = kernels(q1, q2, obs, act)
    assert not values[0].requires_grad and twin_q.launches == before + 2
    assert value_gap(values, plain(q1, q2, obs, act)) < TOL
    run(kernels, q1, q2, obs, act, dq)
    assert twin_q.launches == before + 8


def test_branch_check_names_a_wrong_branch(kernels):
    """The branches that the emulated kernels took agree with float64's
    but within rounding of 0; one turned where the pre-activation is far
    from 0 is counted, and lies far past FLIP_EPS."""
    q1, q2 = nets(2, 5, 2, [16, 8], "cpu")
    obs, act, _ = inputs(2, 37, 5, 2, "cpu")
    branches = twin_q_mod.relu_branches(kernels(q1, q2, obs, act)[0])
    wide = [copy.deepcopy(q).double() for q in (q1, q2)]
    _, pre, scale = twin_q_mod.reference(*wide, obs.double(), act.double(), relu=branches)
    count, worst = twin_q_mod.branch_flips(branches, pre, scale)
    assert [b.shape for b in branches] == [(2, 2, 37, 16), (2, 2, 37, 8)]
    assert count <= 1 and worst <= FLIP_EPS
    far = (pre[1].abs() / scale[1]).flatten().argmax()
    branches[1].view(-1)[far] ^= True
    count_after, worst_after = twin_q_mod.branch_flips(branches, pre, scale)
    assert count_after == count + 1 and worst_after > 1e4 * FLIP_EPS


def test_widths_the_kernels_do_not_take_raise(kernels):
    q1, q2 = nets(1, 4, 1, [513], "cpu")
    obs, act, _ = inputs(1, 4, 4, 1, "cpu")
    with pytest.raises(ValueError, match="hidden widths"):
        kernels(q1, q2, obs, act)
    q1, q2 = nets(1, 4, 1, [8], "cpu")
    with pytest.raises(ValueError, match="shaped"):
        kernels(q1, nets(1, 4, 1, [16], "cpu")[1], obs, act)


# --- the card ----------------------------------------------------------------------

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("A,K,M,hidden,n_rows", [
    (5, 36, 1, [256, 256], 256),     # cell challenge2022_phase1.sac_train
    (3, 37, 3, [256, 256], 256),     # cell challenge2023_phase1.sac_train
    (1, 30, 1, [256, 256], 256),     # the host-loop SAC
    (1, 30, 1, [400, 300], 100),     # the host-loop MARLISA's default nets
    (5, 36, 1, [64, 32, 16], 37),    # ragged N, three layers
    (2, 36, 1, [8, 8], 1),
], ids=["cell1", "cell5", "hostloop", "marlisa", "ragged", "n1"])
def test_kernels_match_the_plain_version_on_the_card(A, K, M, hidden, n_rows):
    needs_card()
    q1, q2 = nets(A, K, M, hidden, "cuda")
    obs, act, dq = inputs(A, n_rows, K, M, "cuda")
    wide = [copy.deepcopy(q).double() for q in (q1, q2)]
    wide_act = act.detach().double().requires_grad_()
    for param_grads in (True, False):
        out = twin_q(q1, q2, obs, act, param_grads=param_grads)
        branches = twin_q_mod.relu_branches(out[0])
        values, grads = finish(out, q1, q2, act, dq, param_grads)
        ref_out, pre, scale = twin_q_mod.reference(*wide, obs.double(), wide_act, relu=branches)
        count, worst = twin_q_mod.branch_flips(branches, pre, scale)
        assert worst <= FLIP_EPS
        assert count <= 1 + FLIP_SHARE * sum(b.numel() for b in branches)
        ref_values, ref_grads = finish(ref_out, *wide, wide_act, dq.double(), param_grads)
        assert value_gap(values, ref_values) < TOL
        assert grad_gap(grads, ref_grads) < TOL
        again = run(twin_q, q1, q2, obs, act, dq, param_grads)
        assert all(torch.equal(x, y) for x, y in zip(values + list(grads),
                                                     again[0] + list(again[1])))


@pytest.mark.gpu
def test_widths_the_kernels_do_not_take_raise_on_the_card():
    needs_card()
    q1, q2 = nets(1, 4, 1, [600], "cuda")
    obs, act, _ = inputs(1, 4, 4, 1, "cuda")
    with pytest.raises(ValueError, match="hidden widths"):
        twin_q(q1, q2, obs, act)


@pytest.mark.gpu
def test_an_update_makes_three_forward_and_two_backward_passes():
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    agent_nets = sac.make_agent_nets(5, 36, 1, (256, 256), 3e-4, gen, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    draw = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    batch = (draw(5, 256, 36), draw(5, 256, 1).tanh(), draw(5, 256), draw(5, 256, 36),
             torch.zeros(5, 256, device="cuda"))
    bounds = (torch.ones(5, 1, device="cuda"), torch.zeros(5, 1, device="cuda"),
              torch.ones(5, 1, device="cuda"))
    before = twin_q.launches
    with tracing.recording() as rec:
        sac._sac_step(agent_nets, batch, (draw(5, 256, 1), draw(5, 256, 1)), *bounds,
                      alpha=0.2, discount=0.99, tau=5e-3)
    assert len(rec.durations("twin_q")) == 3
    # two hidden layers: three forwards of 2 launches, the critics' backward
    # of a row and a column pass a layer, the policy loss's of row passes
    assert twin_q.launches - before == 3 * 2 + 2 * 2 + 2
