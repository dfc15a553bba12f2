"""The FLOP and byte counters against hand counts at a tiny shape."""

from perfbench.harness import flops


def test_search_flops_hand_count():
    # H=4, one block: 2 (1 + 2) + 2 = 8 dense 4x4 layers; heads min(a + vb + rb, k + vb) = min(2 + 1 + 1, 3 + 1) = 4.
    per_sim = 2 * (8 * 16 + 4 * 4)
    assert flops.search_flops(4, 1, 2, 3, searches=5, sims=7) == per_sim * 5 * 7


def test_search_flops_takes_the_cheaper_heads():
    # Categorical: a + vb + rb = 2 + 9 + 5 = 16 against k + vb = 3 + 9 = 12.
    assert flops.search_flops(4, 1, 2, 3, 1, 1, vb=9, rb=5) == 2 * (8 * 16 + 4 * 12)


def test_search_flops_at_the_preset_matches_the_recorded_bound():
    # 1.477e11 FLOP at H=256, 10 blocks, 256 searches of 100 simulations: 2.20 ms at 67 TFLOP/s.
    total = flops.search_flops(256, 10, 4, 32, 256, 100)
    assert abs(total - 1.4773e11) < 1e8
    assert abs(total / flops.PEAK_FLOPS["float32"] - 2.205e-3) < 1e-5


def test_root_flops_hand_count():
    # h: 3x4 projection, (2 + 1) tower layers, hidden-state layer; f: (2 + 1) tower layers, heads 4 x (2 + 1).
    per = 3 * 4 + 3 * 16 + 16 + 3 * 16 + 4 * 3
    assert flops.root_flops(4, 1, 2, 3, 1, searches=2) == 2 * per * 2


def test_kernel_bound_is_operations_at_the_preset():
    config = {"hidden_size": 256, "num_residual_blocks": 10, "action_size": 4, "codebook_size": 32,
              "num_simulations": 100, "value_bins": 1, "reward_bins": 1, "search_weight_dtype": "float32"}
    seconds, which = flops.kernel_bound_seconds(config, 256, 1)
    assert which == "operations" and abs(seconds - 2.205e-3) < 1e-5
    # One search of one simulation a launch reads all the weights for little work: bound by bytes.
    assert flops.kernel_bound_seconds({**config, "num_simulations": 1}, 1, 1)[1] == "bytes"
