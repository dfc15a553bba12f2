"""The search kernel's phase clocks (``csrc/whole_search.cu`` ``Clock``, the
wrapper's ``CLOCK_COUNTERS``, ``utils/tracing.py`` ``device_counts``) and the
benchmark's ten readers of them.

On the CPU: the per-unit device buffer, the counters' order against the
kernel's, the readers on synthetic counts, and that neither the plain search
nor spans off clock anything. Tests marked ``card`` need a CUDA device and
skip without one; they run on the card with

    python -m pytest --noconftest -m card tests/test_torch_kernel_clocks.py

at each cell's library and shape and on both streamed libraries at H=512:
the clocked launch searches bit for bit as the unclocked one, its phases sum
to its cycles, it counts every dense layer and, on the tensor cores, every
layer norm taken in a dense layer's epilogue, and spans off launch no clocked
kernel and count nothing. The two tensor-core libraries, resident and
streamed, search bit for bit alike on one network at H=256.
"""

import dataclasses
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import spec
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import architecture_from_config
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.scripts import benchmark_mcts
from simulate_2048_tpu_torch.search.mcts import draw_root_noise, root_inputs
from simulate_2048_tpu_torch.training import self_play as tsp
from simulate_2048_tpu_torch.training.config import default_config
from simulate_2048_tpu_torch.utils import tracing

PHASES = ("feed", "products", "norm", "barrier", "tree")
BETTER = {"feed": "lower", "products": "higher", "norm": "lower", "barrier": "lower", "tree": "lower"}
PLAYERS = {"selfplay": ("selfplay", "selfplay_moves_per_s", ("appendix_c.selfplay", "capacity_probe.selfplay")),
           "eval": ("deep_eval", "eval_moves_per_s", ("capacity_probe.deep_eval",))}  # fmt: skip
READERS = [(phase, suffix) for suffix in PLAYERS for phase in PHASES]


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for named in tracing.snapshot()["counts"].values():
        for name, value in named.items():
            out[name] = out.get(name, 0) + value
    return out


# ---- the per-unit buffer and the counters


def test_a_unit_gets_one_zeroed_buffer_counted_under_its_names():
    names = ("a.x", "a.y", "a.z")
    tracing.span("segment", unit=True)
    buf = tracing.device_counts(names, "cpu")
    assert buf.dtype == torch.int64 and buf.tolist() == [0, 0, 0]
    assert tracing.device_counts(names, "cpu") is buf  # the unit's second launch adds to the same buffer
    buf += torch.tensor([3, 0, 7])  # what a kernel adds after the count was made
    tracing.span("segment", unit=True)
    other = tracing.device_counts(names, "cpu")
    assert other is not buf and other.tolist() == [0, 0, 0]
    other[1] = 5
    snap = tracing.snapshot()["counts"]
    assert list(snap.values()) == [{"a.x": 3, "a.y": 0, "a.z": 7}, {"a.x": 0, "a.y": 5, "a.z": 0}]


def test_the_buffers_go_with_their_units():
    for _ in range(tracing.KEEP_UNITS + 3):
        tracing.span("segment", unit=True)
        tracing.device_counts(("a.x",), "cpu")
    assert len(tracing._buffers) == tracing.KEEP_UNITS
    assert {key[0] for key in tracing._buffers} == set(tracing._counts)
    tracing.reset()
    assert not tracing._buffers


def test_the_counters_follow_the_kernels_order():
    source = (sk._build.CSRC / "whole_search.cu").read_text()
    phases = re.search(r"enum Phase \{([^}]*)\}", source).group(1).replace(" ", "").split(",")
    counters = re.search(r"enum Counter \{([^}]*)\}", source).group(1).replace(" ", "").split(",")
    assert phases == ["kFeed", "kProducts", "kNorm", "kBarrier", "kTree", "kPhases"]
    assert counters == ["kCycles=kPhases", "kLayers", "kProducerCycles", "kProducerStalls", "kEpilogueNorms",
                        "kCounters"]  # fmt: skip
    assert sk.CLOCK_COUNTERS == (
        *(f"search.kernel.cycles.{p}" for p in PHASES), "search.kernel.cycles", "search.kernel.layers",
        "search.kernel.producer_cycles", "search.kernel.producer_stall_cycles", "search.kernel.epilogue_norms",
    )  # fmt: skip


def test_the_plain_search_clocks_nothing_while_spans_record():
    config, network = clock_network("appendix_c.selfplay", "cpu", hidden=32, blocks=1)
    cfg = tsp.search_config_from(config)._replace(num_simulations=4, max_depth=4)
    packed = sk.pack_search_params(network, 1, max(cfg.num_actions, cfg.codebook_size))
    obs, _, noise = roots(config, cfg, 2, "cpu")
    h, p, v = (t.contiguous() for t in root_inputs(network, obs, cfg, None, noise))
    with cpu_profile():
        sk.whole_search(h, p, v, packed, cfg)
    assert not any(name.startswith("search.kernel") for name in counts())


def test_phases_need_the_kernel_on_the_card():
    with pytest.raises(ValueError, match="--phases"):
        benchmark_mcts.benchmark(boards=2, sims=2, mode="tiny", device="cpu", phases=True)


# ---- the benchmark's readers


class FakeRun:
    """What a reader reads: the player, the traced unit's window and the program's snapshot."""

    def __init__(self, player, counted):
        self.player = player
        self.trace = type("Trace", (), {"spans": [("unit", 0, 10**6)]})()
        self._program_snapshot = {
            "spans": [{"name": "segment", "parent": None, "unit": 3, "start_ns": 10, "end_ns": 20, "stream_ns": None}],
            "counts": {2: {"search.kernel.cycles": 7, "search.kernel.cycles.feed": 7}, 3: counted},
        }


def clocked(**cycles) -> dict[str, int]:
    phases = {f"search.kernel.cycles.{p}": c for p, c in cycles.items()}
    return {**phases, "search.kernel.cycles": sum(cycles.values()), "search.kernel.clocked_launches": 200}


@pytest.mark.parametrize("phase,suffix", READERS)
def test_a_reader_reads_its_phase_over_the_warps_cycles_of_the_traced_unit(phase, suffix):
    name = f"search.kernel_{phase}_share.{suffix}"
    player, moves, cells = PLAYERS[suffix]
    other = "deep_eval" if player == "selfplay" else "selfplay"
    read = spec.reader(name)
    assert read(FakeRun(player, clocked(**{p: 10 * (i + 1) for i, p in enumerate(PHASES)}))) == pytest.approx(
        100.0 * 10 * (PHASES.index(phase) + 1) / 150
    )
    assert read(FakeRun(player, clocked(**{phase: 0, "tree": 5}))) == (100.0 if phase == "tree" else 0.0)
    assert read(FakeRun(player, {"search.root_calls": 200})) is None  # a program that clocks no kernel
    assert read(FakeRun(player, {"search.kernel.cycles": 0})) is None
    assert read(FakeRun(other, clocked(feed=1, products=1, norm=1, barrier=1, tree=1))) is None
    no_tracer = FakeRun(player, {})
    no_tracer._program_snapshot = None
    assert read(no_tracer) is None
    declared = {m["name"]: m for m in spec.read_json(spec.ROOT / "BENCHMARK.json")["per_layer"]}[name]
    assert tuple(declared["workloads"]) == cells and declared["source"] == "program_counter"
    assert declared["layer"] == "search kernel" and declared["unit"] == "%" and declared["moves"] == moves
    assert declared["better"] == BETTER[phase]
    for cell in cells:
        assert name in [m["name"] for m in spec.load_cell(cell).per_layer]


@pytest.mark.parametrize("suffix", sorted(PLAYERS))
def test_a_players_five_shares_sum_to_100(suffix):
    player = PLAYERS[suffix][0]
    run = FakeRun(player, clocked(feed=123, products=4567, norm=890, barrier=2345, tree=67))
    assert sum(spec.reader(f"search.kernel_{p}_share.{suffix}")(run) for p in PHASES) == pytest.approx(100.0)


# ---- on the card

# Each cell's library and shape, and both streamed libraries at H=512: (hidden, weight dtype, bins, batch, eval).
CARD_CASES = {
    "appendix_c.selfplay": (256, torch.float32, (1, 1), 256, False),
    "capacity_probe.selfplay": (256, torch.bfloat16, (256, 128), 256, False),
    "capacity_probe.deep_eval": (256, torch.bfloat16, (256, 128), 128, True),
    "bf16_streamed_h512": (512, torch.bfloat16, (256, 128), 256, False),
    "float32_streamed_h512": (512, torch.float32, (1, 1), 256, False),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def clock_network(case: str, device, hidden: int | None = None, blocks: int | None = None):
    """The preset's network (10 blocks) at the case's width and heads, random weights; the eval calibration of
    ``capacity_probe`` (prior temperature 4.0, ``pb_c_init`` 0.5) for the deep evaluation."""
    width, _, bins, _, _ = CARD_CASES[case]
    config = dataclasses.replace(default_config(), hidden_size=hidden or width,
                                 num_residual_blocks=blocks or default_config().num_residual_blocks,
                                 value_bins=bins[0], reward_bins=bins[1], eval_prior_temperature=4.0,
                                 eval_pb_c_init=0.5)  # fmt: skip
    network = architecture_from_config(config)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in network.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
    return config, network.to(device)


def roots(config, cfg, batch: int, device, noised: bool = True):
    state = envlib.reset_batch(17, batch, torch.device(device))
    gen = torch.Generator(device=device).manual_seed(5)
    noise = draw_root_noise(cfg, batch, gen, device) if noised else None
    return envlib.get_observation(state), ~envlib.get_legal_actions(state), noise


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_the_clocked_kernel_searches_bit_for_bit_and_clocks_every_cycle(card, case):
    hidden, wdtype, _, batch, eval_mode = CARD_CASES[case]
    config, network = clock_network(case, card)
    cfg = tsp.search_config_from(config, eval_mode=eval_mode)
    if eval_mode:  # the deep evaluation draws no root noise
        cfg = cfg._replace(dirichlet_fraction=0.0)
    plan = sk.search_plan(cfg, hidden, wdtype)
    k = max(cfg.num_actions, cfg.codebook_size)
    packed = sk.pack_search_params(network, config.num_residual_blocks, k, wdtype, plan or None,
                                   value_bins=cfg.value_bins, reward_bins=cfg.reward_bins)  # fmt: skip
    workspace = sk.SearchWorkspace(packed)
    obs, invalid, noise = roots(config, cfg, batch, card, noised=not eval_mode)
    with torch.no_grad():
        inputs = [t.contiguous() for t in root_inputs(network, obs, cfg, invalid, noise)]
    library = sk.library_name(wdtype, plan > 0)

    launches = sk.LAUNCHES[library]
    plain = [t.clone() for t in sk.whole_search(*inputs, packed, cfg, workspace)]
    torch.cuda.synchronize()
    assert counts() == {}  # spans off: the unclocked kernel, nothing counted
    with cpu_profile():
        timed = [t.clone() for t in sk.whole_search(*inputs, packed, cfg, workspace)]
    torch.cuda.synchronize()
    assert sk.LAUNCHES[library] == launches + 2  # both launches under the library that ran them
    for a, b in zip(plain, timed):
        assert torch.equal(a, b)
    assert torch.equal(plain[0].argmax(-1), timed[0].argmax(-1))

    counted = counts()
    assert set(counted) == {*sk.CLOCK_COUNTERS, "search.kernel.clocked_launches"}
    assert counted["search.kernel.clocked_launches"] == 1
    cycles = counted["search.kernel.cycles"]
    phases = [counted[f"search.kernel.cycles.{p}"] for p in PHASES]
    assert cycles > 0 and all(c >= 0 for c in phases) and abs(sum(phases) - cycles) <= 0.01 * cycles
    assert phases[PHASES.index("products")] > 0 and phases[PHASES.index("tree")] > 0
    blocks = sk.kernel_blocks(batch, library)
    per_simulation = 2 * (2 * (1 + 2 * config.num_residual_blocks) + 2)  # 88 at NB=10
    assert counted["search.kernel.layers"] == per_simulation * cfg.num_simulations * blocks
    # The tensor-core kernel takes every tower layer norm in the epilogue of the dense layer before it.
    norms = 4 * (1 + 2 * config.num_residual_blocks) if wdtype == torch.bfloat16 else 0  # 84 at NB=10
    assert counted["search.kernel.epilogue_norms"] == norms * cfg.num_simulations * blocks
    producer, stalls = counted["search.kernel.producer_cycles"], counted["search.kernel.producer_stall_cycles"]
    if library == "whole_search_streamed":  # no producer warp: every thread copies
        assert producer == stalls == 0
    else:
        assert 0 <= stalls <= producer and producer > 0


@pytest.mark.card
def test_resident_and_streamed_tensor_core_libraries_search_alike(card):
    """At H=256 a bfloat16 pack runs resident (8 warps) or streamed (12 warps):
    each output's k-steps and each layer norm's m-tiles are summed in one
    order whichever warp owns them, so the two libraries' searches are equal
    bit for bit on one network, clocked or not."""
    config, network = clock_network("capacity_probe.selfplay", card)
    cfg = tsp.search_config_from(config)
    k = max(cfg.num_actions, cfg.codebook_size)
    obs, invalid, noise = roots(config, cfg, 256, card)
    with torch.no_grad():
        inputs = [t.contiguous() for t in root_inputs(network, obs, cfg, invalid, noise)]
    out = {}
    for chunk in (None, sk.STREAM_CHUNK):
        packed = sk.pack_search_params(network, config.num_residual_blocks, k, torch.bfloat16, chunk,
                                       value_bins=cfg.value_bins, reward_bins=cfg.reward_bins)  # fmt: skip
        workspace = sk.SearchWorkspace(packed)
        library = sk.library_name(torch.bfloat16, chunk is not None)
        out[library] = [t.clone() for t in sk.whole_search(*inputs, packed, cfg, workspace)]
        with cpu_profile():
            out[library + ".clocked"] = [t.clone() for t in sk.whole_search(*inputs, packed, cfg, workspace)]
    torch.cuda.synchronize()
    assert set(out) == {"whole_search_bf16", "whole_search_bf16_streamed", "whole_search_bf16.clocked",
                        "whole_search_bf16_streamed.clocked"}  # fmt: skip
    want = out.pop("whole_search_bf16")
    assert (want[0].sum(-1) == cfg.num_simulations).all()
    for name, got in out.items():
        for a, b in zip(want, got):
            assert torch.equal(a, b), name
