"""The Stochastic MuZero networks as the benchmark's reference computes them:
plain PyTorch over a dict of weights, with no kernel and no module of the
program.

The weights are the benchmark's own (``harness/weights.py``), keyed by the
names of the layers they fill. Six networks: h (representation), f
(prediction), φ (afterstate_dynamics), ψ (afterstate_prediction), g
(dynamics) and e (encoder, unused here). A trunk is a projection, residual
blocks (LayerNorm, ReLU, dense, LayerNorm, ReLU, dense, plus the input) and a
final LayerNorm and ReLU; heads are dense layers on the trunk's output. A
head with one output is a scalar in h-space; one with ``bins`` outputs is a
categorical distribution over ``bins`` atoms evenly spaced on [0, support
max] in h-space, whose expectation is the scalar.

Two numerics:

- :func:`root` is the network at the root of a search as the configuration
  runs it: with ``use_bfloat16`` every trunk layer takes its input, weight
  and bias in bfloat16 and returns bfloat16; LayerNorms and heads are
  float32 (LayerNorm's variance as E[x²] − E[x]², at least 0; a
  categorical value as softmax(logits) times the atoms, one product).
- :func:`transitions` is one expansion inside the search: φ, ψ, g and f in
  float32, except the products (every dense layer and logit head; not the
  scalar heads or the biases), whose inputs are first rounded to
  ``products``: "float32" (unrounded), "bfloat16", or "float8" (e4m3 with a
  scale per weight matrix and per input row, the control below bfloat16).
  LayerNorm's variance is the mean of squared deviations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PRODUCTS = ("float32", "bfloat16", "float8")
LN_EPS = 1e-6


class Heads(NamedTuple):
    """Head sizes and supports of a configuration."""

    value_bins: int
    reward_bins: int
    value_support_max: float
    reward_support_max: float


def heads_of(config: dict) -> Heads:
    return Heads(config["value_bins"], config["reward_bins"], config["value_support_max"],
                 config["reward_support_max"])  # fmt: skip


def round_to(x: torch.Tensor, products: str, per_row: bool) -> torch.Tensor:
    """``x`` rounded to the products' input type, back in float32."""
    if products == "float32":
        return x.float()
    if products == "bfloat16":
        return x.to(torch.bfloat16).float()
    if products != "float8":
        raise ValueError(f"products is one of {PRODUCTS}, not {products!r}")
    top = x.abs().amax(-1, keepdim=True) if per_row else x.abs().amax()
    scale = 448.0 / torch.clamp_min(top.float(), 1e-30)
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def _matmul(x: torch.Tensor, w: torch.Tensor, products: str) -> torch.Tensor:
    """x (B, in) @ w (out, in)^T with both rounded to ``products``, summed in float32."""
    return round_to(x, products, True) @ round_to(w, products, False).t()


def layer_norm_fast(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + LN_EPS) * weight) + bias


def layer_norm_two_pass(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    d = x - x.mean(-1, keepdim=True)
    return d * torch.rsqrt(torch.square(d).mean(-1, keepdim=True) + LN_EPS) * weight + bias


def expectation(logits: torch.Tensor, support_max: float) -> torch.Tensor:
    """softmax(logits) · atoms inside the search (exponentials, two sums, one
    division), atoms i · support_max / (bins − 1)."""
    bins = logits.shape[-1]
    step = torch.full((), support_max / (bins - 1), dtype=torch.float32, device=logits.device)
    atoms = torch.arange(bins, dtype=torch.float32, device=logits.device) * step
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return (e * atoms).sum(-1) / e.sum(-1)


class _Root:
    """Trunks and heads at the root of a search (the configuration's numerics)."""

    def __init__(self, w: dict[str, torch.Tensor], blocks: int, bf16: bool):
        self.w, self.blocks = w, blocks
        self.dtype = torch.bfloat16 if bf16 else torch.float32

    def trunk_dense(self, x, name):
        dt = self.dtype
        return torch.matmul(x.to(dt), self.w[f"{name}.weight"].to(dt).t()) + self.w[f"{name}.bias"].to(dt)

    def head(self, x, name):
        return torch.matmul(x.float(), self.w[f"{name}.weight"].t()) + self.w[f"{name}.bias"]

    def norm(self, x, name):
        return layer_norm_fast(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def trunk(self, x, net):
        x = self.trunk_dense(x, f"{net}.trunk.proj")
        for i in range(self.blocks):
            b = f"{net}.trunk.tower.blocks.{i}"
            r = x
            t = self.trunk_dense(torch.relu(self.norm(x, f"{b}.norm1")), f"{b}.fc1")
            t = self.trunk_dense(torch.relu(self.norm(t, f"{b}.norm2")), f"{b}.fc2")
            x = t + r
        return torch.relu(self.norm(x, f"{net}.trunk.norm"))


@torch.no_grad()
def root(w: dict[str, torch.Tensor], observations: torch.Tensor, blocks: int, bf16: bool, heads: Heads):
    """h then f at the root: (hidden (B, H) float32, policy logits (B, A), value (B,) in h-space)."""
    net = _Root(w, blocks, bf16)
    hidden = net.head(net.trunk(observations, "representation"), "representation.hidden_state")
    x = net.trunk(hidden, "prediction")
    value = net.head(x, "prediction.value")
    if heads.value_bins == 1:
        value = value[:, 0]
    else:  # the root's expectation: probabilities times atoms, as one product
        bins = heads.value_bins
        step = torch.full((), heads.value_support_max / (bins - 1), dtype=torch.float32, device=value.device)
        value = torch.softmax(value, -1) @ (torch.arange(bins, dtype=torch.float32, device=value.device) * step)
    return hidden.float(), net.head(x, "prediction.policy_logits"), value


class Expansion(NamedTuple):
    """Both transition types at a batch of (parent, edge) pairs."""

    afterstate: torch.Tensor  # (B, H) φ
    q_value: torch.Tensor  # (B,) ψ, h-space
    chance_logits: torch.Tensor  # (B, C)
    hidden: torch.Tensor  # (B, H) g
    reward: torch.Tensor  # (B,) g, h-space
    value: torch.Tensor  # (B,) f at g's output, h-space
    action_logits: torch.Tensor  # (B, A)


def transitions(w: dict[str, torch.Tensor], blocks: int, heads: Heads, num_actions: int, codebook: int,
                products: str):  # fmt: skip
    """``expand(parent_embedding (B, H), edge (B,)) -> Expansion``: φ then ψ
    (a decision parent's afterstate) and g then f (a chance parent's child),
    both at every pair, products rounded to ``products``."""

    def dense(x, name):
        return _matmul(x, w[f"{name}.weight"], products) + w[f"{name}.bias"]

    def norm(x, name):
        return layer_norm_two_pass(x, w[f"{name}.weight"], w[f"{name}.bias"])

    def tower(x, net):
        x = dense(x, f"{net}.trunk.proj")
        for i in range(blocks):
            b = f"{net}.trunk.tower.blocks.{i}"
            t = dense(torch.relu(norm(x, f"{b}.norm1")), f"{b}.fc1")
            x = dense(torch.relu(norm(t, f"{b}.norm2")), f"{b}.fc2") + x
        return torch.relu(norm(x, f"{net}.trunk.norm"))

    def scalar(x, name, bins, support_max):
        if bins == 1:
            return x @ w[f"{name}.weight"][0] + w[f"{name}.bias"][0]
        return expectation(dense(x, name), support_max)

    def fuse(x, net, other, index):
        rows = round_to(w[f"{net}.{other}.weight"].t(), products, False)  # (inputs, H): one row an input
        bias = w[f"{net}.state_proj.bias"] + w[f"{net}.{other}.bias"]
        return _matmul(x, w[f"{net}.state_proj.weight"], products) + bias + rows[index]

    def expand(parent: torch.Tensor, edge: torch.Tensor) -> Expansion:
        fused = fuse(parent, "afterstate_dynamics", "action_proj", edge.clamp(max=num_actions - 1))
        afterstate = dense(tower(fused, "afterstate_dynamics"), "afterstate_dynamics.afterstate")
        y = tower(afterstate, "afterstate_prediction")
        q = scalar(y, "afterstate_prediction.q_value", heads.value_bins, heads.value_support_max)
        fused = fuse(parent, "dynamics", "chance_proj", edge.clamp(max=codebook - 1))
        x = tower(fused, "dynamics")
        hidden = dense(x, "dynamics.next_state")
        reward = scalar(x, "dynamics.reward", heads.reward_bins, heads.reward_support_max)
        z = tower(hidden, "prediction")
        return Expansion(
            afterstate=afterstate,
            q_value=q,
            chance_logits=dense(y, "afterstate_prediction.chance_logits"),
            hidden=hidden,
            reward=reward,
            value=scalar(z, "prediction.value", heads.value_bins, heads.value_support_max),
            action_logits=dense(z, "prediction.policy_logits"),
        )

    return expand
