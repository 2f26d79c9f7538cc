"""P6, the neighborhood family's temperature and occupant post-pass
(``ops.postpass``). On the CPU: its plain version on an LSTM-dynamics
district, where it must give the temperature that K5's plain version
predicts from the same cooling observations (both step the same LSTM; the
hidden sizes 20 and 50 lie outside the kernel's compiled paths); the
kernel's block size; the operation count with the static channels'
products once per row.

On the card (``gpu`` tests: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernel_postpass.py``) the kernel against its plain version
with ``chip_smoke.py::compare_postpass``'s tolerances and near-threshold
rule: temperature within 2e-4 |T| + 5e-3 C, set points and the carried
occupant state equal except where a building parts at a step whose
temperature tolerance straddles a decision; on the EULP and quebec shapes
of ``synthetic.write_neighborhood_dataset`` (the quebec one with a
hand-written tree, so that the occupants act) and on LSTM districts of 20
and 50 hidden units."""

import tempfile
import warnings

import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.ops import lstm as k5
from citylearn_tpu_torch.ops import neighborhood as k6
from citylearn_tpu_torch.ops import postpass as p6
from citylearn_tpu_torch.synthetic import write_lstm_dataset, write_neighborhood_dataset

S = 48
HOURS = range(1, 25)
LSTM_PLANS = {"cooling_device": [0.8 if h < 12 else 0.4 for h in HOURS],
              "dhw_storage": [0.05] * 24,
              "electrical_storage": [0.091 if h < 9 else -0.08 for h in HOURS]}
NEIGHBORHOOD_PLANS = {"cooling_or_heating_device": [0.6 if h < 12 else -0.5 for h in HOURS],
                      "heating_device": [0.3 if h < 8 else 0.1 for h in HOURS],
                      "electrical_storage": [0.091 if h < 9 else -0.08 for h in HOURS]}
WIDE = {"hidden20": dict(hidden_size=20), "heterogeneous": dict(heterogeneous=True)}


def lstm_district(name, n_steps=S, device="cpu"):
    with tempfile.TemporaryDirectory() as tmp:
        path = write_lstm_dataset(tmp, n_rows=n_steps + 41, seed=9, lookback=4, **WIDE[name])
        return pack(compile_schema(path, episode_time_steps=n_steps + 1), device=device)[:2]


def k5_cooling_obs(cfg, params):
    """K5's plain run of one district: its cooling observation (device
    output plus tank discharge) and its temperature row."""
    inputs = rollout_fast.lstm_episode_inputs(cfg, params, 1, LSTM_PLANS)
    rec = k5.lstm_episode_reference(**inputs, record=True)[9]
    cool = rec[k5.R_COUT] + torch.clamp(-rec[k5.R_CBAL], min=0.0)
    return cool.contiguous(), rec[k5.R_TEMP]


@pytest.mark.parametrize("name", list(WIDE))
def test_plain_version_takes_an_lstm_district(name):
    """On K5's cooling observations the post-pass predicts K5's
    temperature, bit for bit: the same LSTM on the same inputs."""
    cfg, params = lstm_district(name)
    cool, temp = k5_cooling_obs(cfg, params)
    out = p6.neighborhood_postpass_reference(cfg, params, cool, torch.zeros_like(cool), S)
    assert out[3] is None
    assert torch.equal(out[0], temp)
    assert float((temp[4:] - params.series.indoor_dry_bulb_temperature[4:S]).abs().max()) > 0.1
    assert torch.equal(out[1], params.series.indoor_dry_bulb_temperature_cooling_set_point[:S])


@pytest.mark.parametrize("name, hidden, threads", [("hidden20", {20}, 96),
                                                   ("heterogeneous", {8, 50}, 224)])
def test_block_threads(name, hidden, threads):
    """A thread per gate row of the widest building, in whole warps."""
    cfg, params = lstm_district(name)
    cool, _ = k5_cooling_obs(cfg, params)
    inputs = p6.postpass_inputs(cfg, params, cool, torch.zeros_like(cool), S)
    assert {u[k5.M_HIDDEN] for u in inputs["weights"].units} == hidden
    assert inputs["lookback"] == 4
    assert p6.block_threads(inputs["weights"]) == threads


def test_operation_count_counts_static_products_per_row():
    """Windows start at t == lookback; each step after adds one window per
    building and one row of static products (rows 1 to S - 1)."""
    cfg, params = lstm_district("heterogeneous")
    cool, _ = k5_cooling_obs(cfg, params)
    weights = p6.postpass_inputs(cfg, params, cool, torch.zeros_like(cool), S)["weights"]
    count = lambda n: p6.operation_count(weights, 4, n)
    assert count(4) == len(weights.units) * 4 * 6
    first = sum(4 * (2 * 4 * H * (2 + H) + 9 * H + (2 * 4 * H * 2 * H + 9 * H if L == 2 else 0))
                + 2 * H + 2 + 4 * 2 * 4 * H * (F - 2) for L, H, F, *_ in weights.units)
    assert count(5) - count(4) == first + len(weights.units) * 6
    step = first - sum(3 * 2 * 4 * H * (F - 2) for L, H, F, *_ in weights.units)
    assert count(6) - count(5) == step + len(weights.units) * 6


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def neighborhoods(card):
    out = {}
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the quebec shape's missing trees
        for name, kw, start in (("eulp", dict(n_buildings=12, n_rows=8760), 2952),
                                ("quebec", dict(n_buildings=8, n_rows=800, quebec=True), 0)):
            path = write_neighborhood_dataset(f"{tmp}/{name}", seed=0, **kw)
            out[name] = pack(compile_schema(path, simulation_start_time_step=start,
                                            episode_time_steps=169), device=card)[:2]
    return out


def compare_on_card(label, cfg, params, cool, heat, n_steps):
    import chip_smoke

    before = p6.postpass_kernel.launches
    chip_smoke.compare_postpass(label, cfg, params, cool, heat, n_steps, 0)
    torch.cuda.synchronize()
    assert p6.postpass_kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["eulp", "quebec"])
def test_cuda_kernel_matches_reference(neighborhoods, name):
    """P6 on the card against its plain version over 168 steps of K6's
    recorded demand observations; the hidden sizes 8 to 32 (the compiled
    paths) in one and two layers on the EULP shape, the occupants with a
    hand-written tree on the quebec one."""
    import chip_smoke

    cfg, params = neighborhoods[name]
    if name == "quebec":
        cfg, params = chip_smoke.hand_set_trees(cfg, params)
    rec = rollout_fast.run_neighborhood_episode(cfg, params, 1, NEIGHBORHOOD_PLANS,
                                                record_series=True, device=params.device)[-1]
    compare_on_card(name, cfg, params, rec[k6.R_COUT].contiguous(),
                    rec[k6.R_HOUT].contiguous(), 168)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(WIDE))
def test_cuda_kernel_outside_the_templates(card, name):
    """The path of hidden sizes outside the compiled ones (20; 50 beside
    8), weights read through L1, a block of 96 or 224 threads."""
    cfg, params = lstm_district(name, 168, card)
    cool, _ = k5_cooling_obs(cfg, params)
    compare_on_card(name, cfg, params, cool, torch.zeros_like(cool), 168)
