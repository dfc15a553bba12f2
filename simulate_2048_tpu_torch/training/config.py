"""Training configuration: the PyTorch port's own copy.

Field names, defaults, validation and the tiny/small/full presets are
identical to ``simulate_2048_tpu.training.config`` (the port imports nothing
from the JAX package, so it keeps this copy; ``tests/test_torch_evaluate.py``
holds the two field for field). Only the meaning of ``search_backend`` is
read for the port:

- ``"pallas"``: the hand-written CUDA whole-search kernel
  (``ops/search_kernel.py``); on CPU tensors its plain PyTorch version.
- ``"xla"``: the port's plain batched array-tree search (``search/mcts.py``).
- ``"auto"``: the kernel whenever the tensors are on CUDA and the search is
  in the kernel's scope, the plain search otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    """Immutable training configuration (``config.py:11-114``)."""

    # Environment.
    observation_dim: int = 16  # flattened 4x4 board
    action_size: int = 4
    codebook_size: int = 32

    # Networks.
    hidden_size: int = 256
    num_residual_blocks: int = 10
    use_bfloat16: bool = False  # compute dtype for residual towers

    # MCTS.
    num_simulations: int = 100
    discount: float = 0.999
    dirichlet_alpha: float = 0.25
    dirichlet_fraction: float = 0.1
    pb_c_init: float = 1.25
    pb_c_base: float = 19652.0
    # Tree-depth cap. The backup's recorded-path arrays (and the one-hot
    # contractions over them) scale with this, so a tight bound is faster.
    # Measured: a trained small-config net at 64 sims never exceeds depth 11,
    # so 32 does not bind in practice (results bit-identical when it never
    # binds; when it does, the capped simulation re-backs-up the existing
    # child's value — mctx's max_depth semantics). None = unbounded
    # (reference behavior, ``stochastic_mctx.py:227``).
    search_max_depth: int | None = 32
    # Chance-node child selection in search: "argmax" = deterministic
    # p(c)/(1+N) visit allocation (round-1 behavior); "sample" = c ~ σ as in
    # the paper. Progressive widening (``mctx``-style, SURVEY §2.3 #16) caps
    # chance children at ceil(pw_c·(N+1)^pw_alpha); None disables it. See
    # ``search.mcts.SearchConfig`` and ``tests/test_search.py`` for the
    # equivalence/divergence analysis (mctx itself is unavailable here).
    chance_selection: str = "argmax"
    pw_c: float | None = None
    pw_alpha: float = 0.5
    # Search prior calibration (round-2 sweep, docs/project.md): softmax
    # temperature on policy/chance logits entering the tree. The trained
    # prior measures as overconfident; prior_temperature=4 + pb_c_init=0.5
    # lifted the 30k champion checkpoint from 2186 to 2938 eval with no
    # retraining. 1.0 = paper/reference behavior.
    prior_temperature: float = 1.0
    # Root action selection for COLLECTION search. "puct" = Dirichlet-noised
    # PUCT (paper/reference, ``stochastic_mctx.py:289-301``); "gumbel" =
    # Gumbel-MuZero sequential halving at the root (``search/mcts.py``
    # ``SearchConfig.root_selection``): policy targets become the improved
    # policy softmax(logits + σ(q̂)) and Gumbel noise replaces Dirichlet —
    # matches PUCT strength at 2-4× fewer simulations, multiplying self-play
    # games per chip-hour. Applies to collection only: evaluation always
    # searches with PUCT + the eval calibration overrides, so eval curves
    # stay comparable across arms (and across rounds).
    root_selection: str = "puct"
    # Gumbel root σ(q̂) = (c_visit + max N)·c_scale·q̂ (mctx defaults). The
    # round-4 A/Bs measured the default c_scale=0.1 as too Q-dominated for
    # from-scratch collection on 2048 (σ ≈ 6 nats at init under min-max
    # completion, docs/project.md) — a gentler scale is the first knob to
    # turn when revisiting gumbel collection.
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 0.1
    # EVAL-ONLY search calibration overrides (None = use the training values).
    # The round-2 sweep found prior_temperature=4 + pb_c_init=0.5 lifts a
    # trained checkpoint ~+750 eval — but the SAME knobs at collection time
    # are harmful from scratch (a random value net dominates the Q-driven
    # search and policy-target entropy collapses; runs/showcase_r2_failed_*).
    # Calibration therefore belongs at evaluation: self_play.search_config_from
    # applies these in eval_mode (evaluate_games / trainer evals / greedy
    # play_segment) and never at collection; tests/test_self_play.py::
    # TestEvalSearchCalibration pins the wiring.
    eval_prior_temperature: float | None = None
    eval_pb_c_init: float | None = None
    # Search execution backend for self-play/eval batches (see the module
    # docstring for what each value means in the port).
    # - "xla": the plain batched array-tree search (search/mcts.py).
    # - "pallas": the whole-search CUDA kernel (ops/search_kernel.py); raises
    #   if the search is outside its scope (PUCT root, argmax chance
    #   selection, no widening). Any batch size is in scope.
    # - "auto": the kernel on CUDA tensors when in scope, plain otherwise.
    # Default "xla" keeps the field identical to the JAX package's.
    search_backend: str = "xla"
    # Weight/embedding storage dtype inside the search kernel: "float32" or
    # "bfloat16" (products take bfloat16 inputs and sum in float32).
    search_weight_dtype: str = "float32"
    # Search in RAW value space: networks predict in h-scaled space, so their
    # value/q/reward outputs are passed through h⁻¹ before the tree's linear
    # r + γ·v backups (paper-faithful). False reproduces the reference, which
    # feeds h-space outputs straight into mctx (``stochastic_mctx.py:105-212``)
    # — that mixes h-space bootstraps with raw rewards in TD targets and
    # collapses the learned value horizon to ~td_steps of raw reward
    # (docs/project.md round-2 soak analysis).
    search_untransform_values: bool = True

    # Temperature schedule [(step, temperature), …] (paper: greedy from 300k).
    temperature_schedule: tuple[tuple[int, float], ...] = (
        (0, 1.0),
        (100_000, 0.5),
        (200_000, 0.1),
        (300_000, 0.0),
    )

    # Model-side observation lift: re-encode each board cell's scalar
    # exponent as a 16-way one-hot before the representation/encoder trunks
    # (256 inputs). The reference's JAX path trains on log2/16 scalars
    # (``core.py:347``), which makes every value/policy distinction thread
    # through learned per-cell thresholds; one-hot is the standard encoding
    # of strong 2048 networks (the reference's own NumPy env offers it,
    # ``twentyfortyeight.py:66-68``, but its training never uses it).
    observation_onehot: bool = False

    # Act greedily from this move index ON within each self-play game (None =
    # never): AlphaZero's opening-temperature trick. With Monte-Carlo value
    # targets (td_lambda=1.0) every sampled-at-temperature move past the
    # opening injects play noise directly into the stored returns; a cutoff
    # keeps opening diversity while the returns reflect near-greedy strength.
    temperature_move_cutoff: int | None = None

    # Replay buffer.
    replay_buffer_size: int = 125_000  # trajectories
    min_buffer_size: int = 1_000
    max_trajectory_length: int = 200

    # Training.
    batch_size: int = 1024
    num_unroll_steps: int = 5
    td_steps: int = 10
    td_lambda: float = 0.5

    # Prioritized replay (paper: α=β=1).
    priority_alpha: float = 1.0
    priority_beta: float = 1.0

    # Optimization.
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    max_grad_norm: float = 5.0
    warmup_steps: int = 1_000
    # Post-warmup cosine decay horizon. None = constant LR after warmup (the
    # paper/reference schedule, ``learner.py:54-90`` — tuned for 20M-step
    # runs). Short soaks at batch ≤256 measurably churn past their
    # end-of-warmup peak at constant 3e-4 (docs/project.md round-2 A/Bs);
    # set this to ≈ the planned run length to consolidate instead.
    lr_decay_steps: int | None = None
    lr_final_fraction: float = 0.1

    # Schedule.
    training_steps: int = 20_000_000
    checkpoint_interval: int = 1_000
    checkpoint_buffer: bool = False  # persist replay experience too (reference never does)
    log_interval: int = 100
    eval_interval: int = 1_000
    # 2048 scores have huge variance; 10 greedy games (the reference's
    # ``config.py:76``) cannot support curve comparisons. 32+ with a
    # reported standard error keeps eval noise quantified.
    eval_games: int = 32
    # Evaluation plays FULL games up to this many moves (training segments
    # stay max_trajectory_length long; the reference caps eval games at 200
    # moves too, clipping measurable strength — reaching 2048 takes ~950+).
    eval_max_moves: int = 1_200
    # DEEP evaluation at long-run decision points (VERDICT r3 weak #4: the
    # 32-game inline evals' sem ≈ 300 hid a 2174 → 2826 improvement that the
    # n=128 protocol exposed). Every ``deep_eval_interval`` steps the trainer
    # plays ``deep_eval_games`` full games (sem ≈ 150 at n=128), logs them
    # under ``deep_eval/``, and keeps a best-by-deep-eval checkpoint in
    # ``<checkpoint_dir>/best`` — champion selection is by deep eval, never
    # by the noisy inline curve. None = off (short runs).
    deep_eval_interval: int | None = None
    deep_eval_games: int = 128

    # Ground truncated segments' value targets with their successor segment
    # once it is generated (replay.backfill_returns): the boundary bootstrap
    # ν_last is replaced by one segment of real reward plus the next
    # segment's target, shifting every stored target in closed form. Off =
    # collection-time targets are final (reference/paper behavior).
    cross_segment_backfill: bool = False

    # Reanalyze (MuZero Reanalyse; training/reanalyze.py): every
    # reanalyze_interval learner steps, refresh the value targets (and, in
    # "search" mode, the policy targets) of reanalyze_episodes buffered
    # episodes with the CURRENT network, round-robin over the buffer. None =
    # off (reference/paper-2048 behavior: targets frozen at collection —
    # the round-2 root cause of the value function pinning at its myopic
    # fixed point, docs/project.md). "value" mode re-bootstraps the TD(λ)
    # recursion with fresh f-values (one forward pass per position);
    # "search" mode re-runs MCTS per position (reanalyze_num_simulations,
    # None = num_simulations) and rewrites policy targets too.
    reanalyze_interval: int | None = None
    reanalyze_episodes: int = 32
    reanalyze_mode: str = "value"
    reanalyze_num_simulations: int | None = None
    # Search calibration for "search"-mode reanalyze (None = training values).
    # Rationale: reanalyzed policy targets should come from the STRONGEST
    # searcher available, and the round-2 sweep measured prior_temperature=4 +
    # pb_c_init=0.5 (hand the search to Q) worth ~+750 eval on the same
    # weights — reanalyze with these set distills the calibrated searcher
    # back into the prior without touching collection or eval protocols.
    reanalyze_prior_temperature: float | None = None
    reanalyze_pb_c_init: float | None = None

    # Stop generating new self-play data once the learner reaches this step
    # (None = never). Diagnostic knob for the round-2 decline A/Bs: training
    # past the freeze point isolates optimization churn from data poisoning.
    freeze_data_after: int | None = None

    # Self-play. Same games-per-train-step ratio as the reference
    # (8 games / 100 steps, ``config.py:79-80``) but in large batches:
    # tiny per-move MCTS batches are dispatch-latency-bound on accelerators.
    num_parallel_games: int = 256
    generation_interval: int = 3200

    # Value scaling h(x) = sign(x)(√(|x|+1) − 1) + εx.
    value_epsilon: float = 0.001

    # Categorical (two-hot) value/reward heads over an h-space support
    # (``ops.distributional``; MuZero App. F). 1 = scalar MSE heads, the
    # reference's only mode (``losses.py:134-177``). >1 switches the value,
    # Q and reward heads to ``*_bins`` logits trained with cross-entropy
    # toward a two-hot target — far better conditioned than MSE for 2048's
    # heavy-tailed returns (scalar value loss at init ≈ 750). The supports
    # are h-space upper bounds: 320 ≈ raw return 64k, 100 ≈ raw one-move
    # reward 8k; targets beyond clip to the last atom. The scalar-facing
    # search/eval API is unchanged (the networks' ``forward`` returns the
    # expectation; the whole-search kernel reduces the heads itself).
    value_bins: int = 1
    reward_bins: int = 1
    value_support_max: float = 320.0
    reward_support_max: float = 100.0

    # EfficientZero self-supervised consistency (Ye et al. 2021): weight of
    # the cosine distance between each unrolled hidden state and the
    # stop-gradient re-encoding of the true next observation. 0 = off
    # (paper/reference behavior). The round-2 model probe measured ~130%
    # relative drift after one unroll step — this loss pins the latent
    # rollout to the encoder's manifold so in-tree value/reward predictions
    # stay meaningful at depth.
    consistency_loss_weight: float = 0.0

    # MuZero Appendix G: scale the gradient flowing INTO each unrolled
    # dynamics step by this factor (forward pass unchanged), keeping the
    # total gradient through the K-step unroll O(1) instead of O(K). The
    # reference omits it; 1.0 reproduces that (kept as the default so A/B
    # attribution against earlier round-2 runs stays clean — flip to 0.5 for
    # the paper-faithful behavior, tested as arm E10).
    dynamics_gradient_scale: float = 1.0

    # Loss weights (``config.py:87-91``).
    policy_loss_weight: float = 1.0
    value_loss_weight: float = 0.25
    reward_loss_weight: float = 1.0
    chance_loss_weight: float = 1.0
    commitment_loss_weight: float = 0.25
    # Afterstate value loss: paper Eq. 5 trains ψ's Q^k toward the same z
    # target as the position's value; the reference never does, leaving its
    # Q head AT RANDOM INIT while search backs it up into every chance node
    # (``stochastic_mctx.py:155-165``). 0 reproduces that (keeps earlier-arm
    # attribution clean); 0.25 = paper-faithful (same scale as value).
    afterstate_value_loss_weight: float = 0.0

    # Chance-target mode. 2048's chance event is FULLY OBSERVED: the spawn is
    # one of 16 cells × {2, 4} = 32 outcomes = the paper's codebook size, so a
    # ground-truth chance code exists (code = 2·cell + is_four, the slot order
    # of ``ops.board.afterstate_outcomes``) and no learned encoder is needed.
    # - "oracle" (default): supervise ψ's chance logits (and teacher-force g's
    #   chance input) with the real spawn extracted from consecutive boards
    #   (obs_{t+1} − afterstate(obs_t, a_t)). Immune to the VQ-VAE code
    #   collapse documented in docs/project.md.
    # - "oracle_dist": same g input, but ψ's CE target is the EXACT spawn
    #   distribution given the afterstate (0.9/n per empty cell for a 2,
    #   0.1/n for a 4) — zero-variance version of "oracle"; the CE converges
    #   to the true spawn entropy instead of fluctuating around it.
    # - "encoder": the paper's design — a VQ-VAE encoder of obs_{t+1} gives
    #   the (stop-gradient) chance target + commitment loss. Collapses to one
    #   code on 2048 (docs/project.md).
    # - "placeholder": reproduces the reference's constant index-0 target
    #   (``losses.py:296-298`` — its declared-but-unwired training path).
    chance_target_mode: str = "oracle"

    # Value-target mode: "search" stores raw MCTS root values (the reference's
    # actual behavior); "td_lambda" applies the TD(λ) n-step recursion the
    # reference defines but never calls (``self_play.py:524-579``).
    value_target_mode: str = "search"

    # Codebook-usage entropy bonus: total loss subtracts
    # codebook_entropy_weight * H(batch-mean encoder distribution).
    # 0 = paper-faithful; > 0 fights majority-code collapse.
    codebook_entropy_weight: float = 0.0

    # Anti-collapse exploration for the VQ-VAE encoder: scale of Gumbel noise
    # added to encoder logits when picking the (stop-gradient) chance-code
    # target during training. 0 = paper-faithful deterministic argmax, which
    # empirically collapses to a single code on 2048 (docs/project.md).
    encoder_noise_scale: float = 0.0

    seed: int = 42

    def __post_init__(self):
        valid_modes = ("oracle", "oracle_dist", "encoder", "placeholder")
        if self.chance_target_mode not in valid_modes:
            raise ValueError(f"chance_target_mode must be one of {valid_modes}")
        if self.chance_target_mode.startswith("oracle") and self.codebook_size < 32:
            raise ValueError(
                "oracle chance targets index the 16 cells x {2,4} outcome space: "
                f"codebook_size must be >= 32, got {self.codebook_size}"
            )
        if self.value_target_mode not in ("search", "td_lambda"):
            raise ValueError("value_target_mode must be 'search' or 'td_lambda'")
        if self.reanalyze_mode not in ("value", "search"):
            raise ValueError("reanalyze_mode must be 'value' or 'search'")
        if self.search_backend not in ("xla", "pallas", "auto"):
            raise ValueError("search_backend must be 'xla', 'pallas' or 'auto'")
        if self.root_selection not in ("puct", "gumbel"):
            raise ValueError("root_selection must be 'puct' or 'gumbel'")
        if self.root_selection == "gumbel" and self.search_backend == "pallas":
            raise ValueError(
                "the whole-search kernel implements PUCT root selection only; "
                "root_selection='gumbel' requires search_backend='xla' or 'auto'"
            )
        if self.search_weight_dtype not in ("float32", "bfloat16"):
            raise ValueError("search_weight_dtype must be 'float32' or 'bfloat16'")
        if self.value_bins < 1 or self.reward_bins < 1:
            raise ValueError("value_bins/reward_bins must be >= 1")
        if self.value_bins == 2 or self.reward_bins == 2:
            raise ValueError(
                "2-bin categorical heads cannot two-hot encode (one interval); "
                "use 1 (scalar) or >= 3"
            )

    def get_temperature(self, training_step: int) -> float:
        """Scheduled action-selection temperature (``config.py:96-114``)."""
        temperature = self.temperature_schedule[0][1]
        for step, temp in self.temperature_schedule:
            if training_step >= step:
                temperature = temp
        return temperature


def apply_overrides(config: TrainConfig, items: list[str]) -> TrainConfig:
    """Apply ``FIELD=VALUE`` override strings with type coercion.

    Shared by the train/eval CLIs' ``--set`` flags. Values are parsed as
    Python literals and then coerced against the dataclass field's declared
    type — so ``--set use_bfloat16=true`` (lowercase) becomes the bool True
    instead of silently storing the truthy *string* ``'true'`` in a bool
    field (``dataclasses.replace`` does no type checking). Raises
    ``ValueError`` with the offending field for anything uncoercible.
    """
    import dataclasses
    import typing

    hints = typing.get_type_hints(TrainConfig)
    fields = {}
    for item in items:
        key, _, raw = item.partition("=")
        if not any(f.name == key for f in dataclasses.fields(TrainConfig)):
            raise ValueError(f"unknown TrainConfig field: {key!r}")
        fields[key] = _coerce_override(key, raw, hints[key])
    return dataclasses.replace(config, **fields)


def _coerce_override(key: str, raw: str, hint):
    """One override value → the field's declared type (helper of
    :func:`apply_overrides`)."""
    import ast
    import typing

    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw  # bare string (e.g. --set chance_target_mode=oracle)

    args = typing.get_args(hint)
    allow_none = type(None) in args
    bases = [a for a in (args or (hint,)) if a is not type(None)]
    base = bases[0] if bases else hint

    if value is None:
        if allow_none:
            return None
        raise ValueError(f"{key}: None is not valid (field type {hint})")
    if base is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        raise ValueError(f"{key}: cannot coerce {raw!r} to bool")
    if base is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        raise ValueError(f"{key}: cannot coerce {raw!r} to float")
    if base is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise ValueError(f"{key}: cannot coerce {raw!r} to int")
    if base is str:
        if isinstance(value, str):
            return value
        raise ValueError(f"{key}: cannot coerce {raw!r} to str")
    # Tuple-typed fields (temperature_schedule): accept list/tuple literals,
    # normalizing lists to tuples recursively.
    if isinstance(value, list):
        return tuple(tuple(x) if isinstance(x, list) else x for x in value)
    return value


def default_config() -> TrainConfig:
    """Paper Appendix-C configuration (``config.py:117-126``).

    The full preset computes residual towers in bfloat16 (params and
    LayerNorm stats stay f32). Flip with ``--set use_bfloat16=False``.

    ``search_backend="auto"``: on CUDA the whole-search kernel runs every
    search (its packed weights are ``search_weight_dtype``, float32 unless
    set, whatever ``use_bfloat16`` says, as in the JAX package's kernel).
    """
    return TrainConfig(use_bfloat16=True, search_backend="auto")


def small_config() -> TrainConfig:
    """Reduced configuration for experimentation (``config.py:129-153``)."""
    return TrainConfig(
        hidden_size=128,
        num_residual_blocks=5,
        num_simulations=50,
        replay_buffer_size=10_000,
        min_buffer_size=500,
        batch_size=256,
        training_steps=100_000,
        checkpoint_interval=100,
        log_interval=10,
        eval_interval=100,
        num_parallel_games=64,
        generation_interval=800,
    )


def tiny_config() -> TrainConfig:
    """Minimal configuration for debugging (``config.py:156-179``)."""
    return TrainConfig(
        hidden_size=64,
        num_residual_blocks=2,
        num_simulations=10,
        replay_buffer_size=1_000,
        min_buffer_size=10,
        max_trajectory_length=64,
        batch_size=32,
        training_steps=1_000,
        checkpoint_interval=100,
        log_interval=1,
        eval_interval=50,
        eval_games=2,
        eval_max_moves=80,
        num_parallel_games=2,
        generation_interval=20,
    )
