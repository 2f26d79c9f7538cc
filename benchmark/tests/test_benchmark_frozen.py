"""The frozen copies still match the program code they were copied from:
the writers write the same bytes, the counts give the same numbers."""

import filecmp
import inspect

import pytest
import torch

from benchmark.frozen import counts, synthetic, timing

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("writer,kwargs", [
    ("write_battery_pv_dataset", dict(n_buildings=3, n_rows=200)),
    ("write_lstm_dataset", dict(n_buildings=2, n_rows=200)),
])
def test_frozen_writers_write_the_programs_bytes(tmp_path, writer, kwargs):
    from citylearn_tpu_torch import synthetic as program

    a, b = tmp_path / "frozen", tmp_path / "program"
    getattr(synthetic, writer)(str(a), seed=SEED, **kwargs)
    getattr(program, writer)(str(b), seed=SEED, **kwargs)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    # torch.save's archives name their records by file; compare the tensors
    for name in [n for n in mismatch if n.endswith(".pth")]:
        x, y = torch.load(a / name), torch.load(b / name)
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        mismatch.remove(name)
    assert not mismatch and not errors


def test_k2_counts_match_the_programs():
    from citylearn_tpu_torch.ops import collect
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    K, D, B, n_knots = 7, 9, 5, 5
    actions = torch.rand((K, D, B), generator=g) * 2 - 1
    prep = collect.CollectPrep(bparams=torch.zeros(8, B),
                               curves=tuple(torch.zeros(n_knots, B) for _ in range(4)),
                               hours_ratio=1.0, ratio=1.0)
    assert counts.k2_operations(K, D, B, n_knots, int((actions >= 0).sum())) \
        == collect.collect_operation_count(prep, actions)
    inputs = [actions, actions, actions, prep.bparams, *prep.curves, *(torch.zeros(D, B),) * 3]
    outputs = [actions, *(torch.zeros(D, B),) * 3]
    assert counts.k2_bytes(K, D, B, n_knots) == chip_smoke.tensor_bytes(inputs + outputs)


def test_frozen_timers_are_chip_smokes():
    import chip_smoke

    for name in ("time_cuda", "time_graph"):
        assert inspect.getsource(getattr(timing, name)) == \
            inspect.getsource(getattr(chip_smoke, name))


def test_sac_flops_count_every_product_of_the_update():
    """Counted once by hand at a small width: the next-action sample (P)
    and two target critics (2Q), per critic a forward, weight gradients and
    input gradients past the first layer, and the actor's sample, two
    critics, their input gradients and its own backward."""
    A, K, M, h, N = 2, 3, 1, (4, 4), 5
    q = (K + M) * 4 + 16 + 4
    p = K * 4 + 16 + 2 * 4 * M
    per_row = (p + 2 * q) + 2 * (3 * q - (K + M) * 4) + (p + 4 * q + 2 * p - K * 4)
    assert counts.sac_update_flops(A, K, M, h, N) == 2 * A * N * per_row
    assert counts.policy_forward_flops(A, K, M, h) == 2 * A * p
