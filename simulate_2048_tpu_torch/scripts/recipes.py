"""The training recipes beside this module (``run_*.sh``) as configs.

Each recipe script runs ``python -m simulate_2048_tpu_torch.train`` with a
preset and ``--set`` overrides; :func:`recipe_config` rebuilds the config it
trains from the script itself, so that a caller that drives the recipe's
config in-process (``chip_smoke.py``) cannot drift from the script.
"""

from __future__ import annotations

import shlex
from pathlib import Path

from simulate_2048_tpu_torch.training.config import (
    TrainConfig,
    apply_overrides,
    default_config,
    small_config,
    tiny_config,
)

RECIPE_DIR = Path(__file__).resolve().parent
PRESETS = {"tiny": tiny_config, "small": small_config, "full": default_config}


def script_argv(path: str | Path) -> list[str]:
    """The arguments a recipe script gives its train CLI: the words after
    ``-m <package>.train`` on its command line (continuation lines joined,
    shell variables left as written)."""
    text = Path(path).read_text().replace("\\\n", " ")
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if "-m" in words and words.index("-m") + 1 < len(words) and words[words.index("-m") + 1].endswith(".train"):
            return words[words.index("-m") + 2 :]
    raise ValueError(f"{path} runs no train CLI")


def set_overrides(argv: list[str]) -> list[str]:
    """The ``FIELD=VALUE`` strings of ``argv``'s ``--set`` flags, in order."""
    return [argv[i + 1] for i, word in enumerate(argv[:-1]) if word == "--set"]


def recipe_config(name: str, extra: list[str] | tuple[str, ...] = ()) -> TrainConfig:
    """The config that ``RECIPE_DIR/name`` trains, with ``extra`` overrides applied after its own."""
    argv = script_argv(RECIPE_DIR / name)
    mode = argv[argv.index("--mode") + 1]
    return apply_overrides(PRESETS[mode](), set_overrides(argv) + list(extra))
