"""The yardstick: operations the work needs, and the chip's peaks.

Operations are counted from the search's definition and the shapes, never
from what a kernel does: a simulation expands one transition, so a later
kernel that skips work the definition does not need cannot make the count
stale.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at its 700 W limit (the data sheet's dense rates).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def search_flops(h: int, nb: int, a: int, k: int, searches: int, sims: int, vb: int = 1, rb: int = 1) -> float:
    """FLOP the searches need: each simulation expands through one transition,
    a fuse layer, a tower, a head layer and a second tower (2 (1 + 2 nb) + 2
    dense h x h layers), plus that transition's heads. The cheaper heads are
    counted (reward, value and action logits after g -> f: h (a + vb + rb)
    against q and chance logits after phi -> psi: h (k + vb); vb, rb are the
    value and reward bins, 1 for a scalar head), so this is a lower bound
    whichever mix of parents the run expands."""
    layers = 2 * (1 + 2 * nb) + 2
    per_sim = 2.0 * (layers * h * h + h * min(a + vb + rb, k + vb))
    return per_sim * searches * sims


def root_flops(h: int, nb: int, a: int, obs: int, vb: int, searches: int) -> float:
    """FLOP of h then f at the roots of ``searches`` searches: h's projection of
    the observation, its tower and hidden-state layer; f's projection, tower,
    policy and value heads."""
    per = obs * h + (2 * nb + 1) * h * h + h * h + (2 * nb + 1) * h * h + h * (a + vb)
    return 2.0 * per * searches


def search_weight_bytes(h: int, nb: int, k: int, vb: int, rb: int, bytes_per_weight: int) -> float:
    """Bytes of the weights a search launch must read once: the four towers with
    their fuse and head layers, the input rows and logit heads, and the
    categorical heads."""
    dense = (4 * (1 + 2 * nb) + 4) * h * h + 2 * k * h + 2 * h * k
    cat = h * ((vb if vb > 1 else 0) * 2 + (rb if rb > 1 else 0))
    return float((dense + cat) * bytes_per_weight)


def config_shape(config: dict) -> dict:
    """The shape arguments of the counters from a configuration file."""
    return {
        "h": config["hidden_size"],
        "nb": config["num_residual_blocks"],
        "a": config["action_size"],
        "k": max(config["action_size"], config["codebook_size"]),
        "sims": config["num_simulations"],
        "vb": config["value_bins"],
        "rb": config["reward_bins"],
    }


def move_flops(config: dict, searches: int) -> float:
    """Search plus root FLOP of ``searches`` searches of a configuration."""
    s = config_shape(config)
    return search_flops(s["h"], s["nb"], s["a"], s["k"], searches, s["sims"], s["vb"], s["rb"]) + root_flops(
        s["h"], s["nb"], s["a"], config["observation_dim"], s["vb"], searches
    )


def kernel_bound_seconds(config: dict, searches: int, launches: int) -> tuple[float, str]:
    """The least time the search kernel could take for ``searches`` searches in
    ``launches`` launches: the larger of operations over the products' peak and
    weight bytes over HBM bandwidth, and which of the two bounds it."""
    s = config_shape(config)
    precision = config["search_weight_dtype"]
    ops = search_flops(s["h"], s["nb"], s["a"], s["k"], searches, s["sims"], s["vb"], s["rb"]) / PEAK_FLOPS[precision]
    width = 2 if precision == "bfloat16" else 4
    data = launches * search_weight_bytes(s["h"], s["nb"], s["k"], s["vb"], s["rb"], width) / PEAK_BYTES
    return (ops, "operations") if ops >= data else (data, "bytes")
