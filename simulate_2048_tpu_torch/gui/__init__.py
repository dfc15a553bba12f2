"""Matplotlib GUI for interactive play (optional dependency)."""

from simulate_2048_tpu_torch.gui.window import TILE_COLORS, WindowBoard

__all__ = ["TILE_COLORS", "WindowBoard"]
