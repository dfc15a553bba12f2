"""The root's h/f as a CUDA graph (``ops/search_kernel.py`` ``RootGraph``,
``RootGraphs``), its counters, and the benchmark's readers of them.

On the CPU: the cache key (what changes it and what does not), a search
through a root graph against the eager root with a stand-in for the capture,
the counters, and the two readers. Tests marked ``card`` need a CUDA device
and skip without one; they run on the card with

    python -m pytest --noconftest -m card tests/test_torch_root_graph.py

(``--noconftest``: this directory's conftest loads JAX, which a CUDA host of
the port need not have): a replay bit for bit against the eager root at the
benchmark's widths, weights updated in place or replaced, segments of
self-play, and the benchmark's recorder.
"""

import dataclasses

import pytest
import torch

from perfbench.harness import spec
from perfbench.harness.record import SearchRecorder
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import architecture_from_config, network_from_config
from simulate_2048_tpu_torch.ops import search_kernel
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.search.mcts import draw_root_noise, root_inputs
from simulate_2048_tpu_torch.training import self_play as tsp
from simulate_2048_tpu_torch.training.config import default_config, tiny_config
from simulate_2048_tpu_torch.utils import tracing

COUNTERS = ("search.root_calls", "search.root_graph_replays", "search.root_graph_captures")
READERS = {"search.root_graph_share.selfplay": ("selfplay", ("appendix_c.selfplay", "capacity_probe.selfplay")),
           "search.root_graph_share.eval": ("deep_eval", ("capacity_probe.deep_eval",))}  # fmt: skip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh_cache():
    search_kernel._root_graphs.clear()
    tracing.reset()
    yield
    search_kernel._root_graphs.clear()
    tracing.reset()


def tiny_game_config(**overrides):
    base = dict(hidden_size=16, num_residual_blocks=1, num_simulations=3, search_max_depth=4, num_parallel_games=8,
                search_backend="pallas", use_bfloat16=False)  # fmt: skip
    return dataclasses.replace(tiny_config(), **{**base, **overrides})


def counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for named in tracing.snapshot()["counts"].values():
        for name, value in named.items():
            out[name] = out.get(name, 0) + value
    return {name: out.get(name, 0) for name in COUNTERS}


def root_batch(config, batch: int, seed: int, device="cpu"):
    """Observations of fresh games, their illegal-action mask and Dirichlet root noise."""
    state = envlib.reset_batch(seed, batch, torch.device(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = tsp.search_config_from(config)
    return envlib.get_observation(state), ~envlib.get_legal_actions(state), draw_root_noise(cfg, batch, gen, device)


class EagerGraph:
    """A stand-in for a captured graph on the CPU: a replay runs the root on the static inputs into the outputs."""

    def __init__(self, root):
        self.root, self.outputs = root, root()

    def replay(self):
        for out, new in zip(self.outputs, self.root()):
            out.copy_(new)


class CpuRootGraph(search_kernel.RootGraph):
    def capture(self):
        self.graph = EagerGraph(self._root)
        self.outputs = self.graph.outputs
        tracing.count("search.root_graph_captures", 1)


# ---- the key


@pytest.mark.parametrize(
    "field, value",
    [("prior_temperature", 4.0), ("dirichlet_fraction", 0.0), ("root_selection", "gumbel"),
     ("value_transform_epsilon", None), ("num_actions", 3), ("codebook_size", 16)],
)  # fmt: skip
def test_each_field_the_root_reads_changes_the_key(field, value):
    config = tiny_game_config()
    network = network_from_config(config, prng_key(1))
    cfg = tsp.search_config_from(config)
    assert getattr(cfg, field) != value
    assert set(search_kernel.ROOT_FIELDS) >= {field}
    base = search_kernel.RootGraphs(network, cfg, "cpu").key
    assert search_kernel.RootGraphs(network, cfg._replace(**{field: value}), "cpu").key != base
    assert search_kernel.RootGraphs(network, cfg._replace(num_simulations=7, pb_c_init=0.5), "cpu").key == base


def test_the_batch_shape_picks_its_own_graph_from_the_process_wide_cache():
    config = tiny_game_config()
    network = network_from_config(config, prng_key(1))
    cfg = tsp.search_config_from(config)
    first, again = search_kernel.RootGraphs(network, cfg, "cpu"), search_kernel.RootGraphs(network, cfg, "cpu")
    graph = first.get(8, True, True)
    assert again.get(8, True, True) is graph and first.get(8, True, True) is graph
    others = [first.get(16, True, True), first.get(8, False, True), first.get(8, True, False)]
    assert len({id(g) for g in [graph, *others]}) == 4
    assert graph.observations.shape == (8, 16) and graph.invalid.shape == graph.noise.shape == (8, 4)
    assert others[1].invalid is None and others[2].noise is None
    assert len(search_kernel._root_graphs) == 4
    for batch in range(100, 100 + search_kernel.ROOT_GRAPH_CACHE):
        first.get(batch, True, True)
    assert len(search_kernel._root_graphs) == search_kernel.ROOT_GRAPH_CACHE
    assert search_kernel.RootGraphs(network, cfg, "cpu").get(8, True, True) is not graph  # evicted: a new one


@pytest.mark.parametrize("eval_mode", [False, True])
@pytest.mark.parametrize(
    "field, value", [("max_trajectory_length", 2), ("replay_buffer_size", 16), ("eval_max_moves", 2)]
)
def test_what_the_warm_up_changes_leaves_the_key(eval_mode, field, value):
    config = tiny_game_config()
    network = network_from_config(config, prng_key(1))
    warm = dataclasses.replace(config, **{field: value})
    key = search_kernel.RootGraphs(network, tsp.search_config_from(config, eval_mode), "cpu").key
    assert search_kernel.RootGraphs(network, tsp.search_config_from(warm, eval_mode), "cpu").key == key


def test_new_storage_changes_the_key_and_an_update_in_place_does_not():
    config = tiny_game_config()
    network = network_from_config(config, prng_key(1))
    cfg = tsp.search_config_from(config)
    key = search_kernel.RootGraphs(network, cfg, "cpu").key
    with torch.no_grad():
        network.prediction.policy_logits.weight.mul_(2.0)
    assert search_kernel.RootGraphs(network, cfg, "cpu").key == key
    network.representation.trunk.proj.weight.data = network.representation.trunk.proj.weight.data.clone()
    replaced = search_kernel.RootGraphs(network, cfg, "cpu").key
    assert replaced != key
    network.afterstate_dynamics.trunk.proj.weight.data = network.afterstate_dynamics.trunk.proj.weight.data.clone()
    assert search_kernel.RootGraphs(network, cfg, "cpu").key == replaced  # the root reads no φ weight


# ---- a search through a root graph, on the CPU


@pytest.mark.parametrize("noised", [True, False])
def test_a_search_through_a_root_graph_equals_the_eager_one(noised):
    config = tiny_game_config() if noised else dataclasses.replace(tiny_game_config(), dirichlet_fraction=0.0)
    network = network_from_config(config, prng_key(2))
    cfg = tsp.search_config_from(config)
    packed = search_kernel.pack_search_params(network, 1, 32)
    graph = CpuRootGraph(network, cfg, 8, True, noised, "cpu")
    for move in range(3):
        obs, invalid, noise = root_batch(config, 8, 10 + move)
        noise = noise if noised else None
        eager = search_kernel.run_search_kernel(network, obs, cfg, invalid, noise, packed=packed)
        replayed = search_kernel.run_search_kernel(network, obs, cfg, invalid, noise, packed=packed, root_graph=graph)
        for a, b in zip(eager, replayed):
            assert torch.equal(a, b)
        for a, b in zip(root_inputs(network, obs, cfg, invalid, noise), graph.outputs):
            assert torch.equal(a, b)
    assert counts() == {"search.root_calls": 6, "search.root_graph_replays": 3, "search.root_graph_captures": 1}
    with pytest.raises(ValueError, match="mask / noise"):
        graph(obs, None, noise)


def test_the_counters_count_one_root_call_a_move():
    config = tiny_game_config(max_trajectory_length=5)
    network = network_from_config(config, prng_key(3))
    state = envlib.reset_batch(4, 8, torch.device("cpu"))
    state, _, _ = tsp.generate_games(network, torch.Generator().manual_seed(1), config, 0, env_state=state)
    tsp.generate_games(network, torch.Generator().manual_seed(2), config, 0, env_state=state)
    tsp.evaluate_games(network, torch.Generator().manual_seed(3), dataclasses.replace(config, eval_max_moves=4), 8)
    # 2 segments of 5 moves, then 4 evaluation moves; the CPU runs the root eagerly.
    assert counts() == {"search.root_calls": 14, "search.root_graph_replays": 0, "search.root_graph_captures": 0}
    cfg = tsp.search_config_from(config)
    graph = CpuRootGraph(network, cfg, 8, True, True, "cpu")
    packed = search_kernel.pack_search_params(network, 1, 32)
    for move in range(4):
        obs, invalid, noise = root_batch(config, 8, move)
        search_kernel.run_search_kernel(network, obs, cfg, invalid, noise, packed=packed, root_graph=graph)
    assert counts() == {"search.root_calls": 18, "search.root_graph_replays": 4, "search.root_graph_captures": 1}


def test_counts_of_host_ints_stay_one_number():
    for _ in range(1000):
        tracing.count("search.root_calls", 1)
    tracing.count("search.root_calls", torch.tensor(5))
    (named,) = tracing._counts.values()
    assert len(named["search.root_calls"]) == 2 and counts()["search.root_calls"] == 1005


# ---- the benchmark's readers


class FakeRun:
    """What a reader reads: the player, the traced unit's window and the program's snapshot."""

    def __init__(self, player, counted):
        self.player = player
        self.trace = type("Trace", (), {"spans": [("unit", 0, 10**6)]})()
        self._program_snapshot = {
            "spans": [{"name": "segment", "parent": None, "unit": 3, "start_ns": 10, "end_ns": 20, "stream_ns": None}],
            "counts": {2: {"search.root_graph_captures": 1, "search.root_calls": 2}, 3: counted},
        }


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_root_graph_readers_read_replays_over_calls_of_the_traced_unit(name):
    player, cells = READERS[name]
    other = "deep_eval" if player == "selfplay" else "selfplay"
    read = spec.reader(name)
    assert read(FakeRun(player, {"search.root_calls": 200, "search.root_graph_replays": 200})) == 100.0
    assert read(FakeRun(player, {"search.root_calls": 200, "search.root_graph_replays": 50})) == 25.0
    assert read(FakeRun(player, {"search.root_calls": 200})) == 0.0  # the root ran eagerly
    assert read(FakeRun(player, {"selfplay.lanes_searched": 5})) is None  # a program that counts no root calls
    assert read(FakeRun(other, {"search.root_calls": 200, "search.root_graph_replays": 200})) is None
    no_tracer = FakeRun(player, {})
    no_tracer._program_snapshot = None
    assert read(no_tracer) is None
    declared = {m["name"]: m for m in spec.read_json(spec.ROOT / "BENCHMARK.json")["per_layer"]}[name]
    assert tuple(declared["workloads"]) == cells and declared["source"] == "program_counter"
    assert declared["layer"] == "networks at the root" and declared["unit"] == "%"
    for cell in cells:
        assert name in [m["name"] for m in spec.load_cell(cell).per_layer]


# ---- on the card


def card_network(heads: str, device):
    """The benchmark's widths (H=256, 10 blocks, bfloat16 towers), scalar or 256/128-bin heads, random weights."""
    bins = {"scalar": (1, 1), "categorical": (256, 128)}[heads]
    config = dataclasses.replace(default_config(), value_bins=bins[0], reward_bins=bins[1])
    network = architecture_from_config(config)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in network.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
    return config, network.to(device)


@pytest.mark.card
@pytest.mark.parametrize("heads", ["scalar", "categorical"])
@pytest.mark.parametrize("batch", [128, 256])
@pytest.mark.parametrize("noised", [True, False])
def test_a_replay_equals_the_eager_root_bit_for_bit(card, heads, batch, noised):
    config, network = card_network(heads, card)
    cfg = tsp.search_config_from(config, eval_mode=not noised)
    if not noised:
        cfg = cfg._replace(dirichlet_fraction=0.0)
    graph = search_kernel.RootGraph(network, cfg, batch, True, noised, card)
    for move in range(3):  # the capture's call, then replays of new inputs
        obs, invalid, noise = root_batch(config, batch, 20 + move, card)
        noise = noise if noised else None
        replayed = [t.clone() for t in graph(obs, invalid, noise)]
        eager = root_inputs(network, obs, cfg, invalid, noise)
        for a, b in zip(eager, replayed):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert counts()["search.root_graph_captures"] == 1


@pytest.mark.card
def test_a_replay_reads_weights_updated_in_place(card):
    config, network = card_network("categorical", card)
    cfg = tsp.search_config_from(config)
    obs, invalid, noise = root_batch(config, 128, 3, card)
    graph = search_kernel.RootGraph(network, cfg, 128, True, True, card)
    before = [t.clone() for t in graph(obs, invalid, noise)]
    with torch.no_grad():
        for p in network.representation.parameters():
            p.mul_(1.05)
        network.prediction.policy_logits.bias.add_(0.5)
    after = [t.clone() for t in graph(obs, invalid, noise)]
    assert not torch.equal(before[0], after[0]) and not torch.equal(before[1], after[1])
    for a, b in zip(root_inputs(network, obs, cfg, invalid, noise), after):
        assert torch.equal(a, b)
    assert counts()["search.root_graph_captures"] == 1


def card_game_config(**overrides):
    base = dict(hidden_size=64, num_residual_blocks=2, num_simulations=8, search_max_depth=8, num_parallel_games=32,
                max_trajectory_length=4, search_backend="pallas", use_bfloat16=True)  # fmt: skip
    return dataclasses.replace(tiny_config(), **{**base, **overrides})


@pytest.mark.card
def test_a_new_network_captures_anew_and_the_same_one_does_not(card):
    config = card_game_config()
    state = envlib.reset_batch(5, 32, card)
    for seed in (1, 1, 2):
        network = network_from_config(config, prng_key(seed)).to(card)
        tsp.play_segment(network, state, torch.Generator(device=card).manual_seed(3), 1.0, config, 32)
        del network
    # The second network of seed 1 has storage of its own: a new key, a new capture.
    assert counts() == {"search.root_calls": 12, "search.root_graph_replays": 12, "search.root_graph_captures": 3}
    network = network_from_config(config, prng_key(1)).to(card)
    search = tsp._make_search(network, config, tsp.search_config_from(config), card)
    obs, invalid, noise = root_batch(config, 32, 4, card)
    search(obs, invalid, noise)
    search(obs, invalid, noise)
    assert counts()["search.root_graph_captures"] == 4


@pytest.mark.card
def test_three_segments_capture_once_and_the_recorder_sees_every_call(card):
    config = card_game_config()
    network = network_from_config(config, prng_key(6)).to(card)
    state = envlib.reset_batch(8, 32, card)
    gen = torch.Generator(device=card).manual_seed(9)
    with SearchRecorder() as recorder:
        for _ in range(3):
            state, traj, _ = tsp.generate_games(network, gen, config, 0, env_state=state)
    assert counts() == {"search.root_calls": 12, "search.root_graph_replays": 12, "search.root_graph_captures": 1}
    assert len(recorder.calls) == 12
    cfg = tsp.search_config_from(config)
    packed = search_kernel.pack_search_params(network, 2, 32, stream_chunk=None)
    for call in recorder.calls:  # what the recorder kept is what the eager root and the kernel give
        eager = search_kernel.run_search_kernel(network, call.observations, cfg, call.invalid, call.noise,
                                                packed=packed)  # fmt: skip
        assert torch.equal(eager.visit_counts, call.visits) and torch.equal(eager.search_value, call.value)
