"""Matplotlib board window with tile colors and a keyboard hook.

Counterpart of the reference's ``twentyfortyeight/utils/windows.py:16-184``
(WindowBoard: render a value board as colored cells, register key handlers,
blocking show). Matplotlib is imported lazily so headless installs of the
framework never require it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

# Classic 2048 palette: tile value -> (background, text color).
TILE_COLORS: dict[int, tuple[str, str]] = {
    0: ("#cdc1b4", "#cdc1b4"),
    2: ("#eee4da", "#776e65"),
    4: ("#ede0c8", "#776e65"),
    8: ("#f2b179", "#f9f6f2"),
    16: ("#f59563", "#f9f6f2"),
    32: ("#f67c5f", "#f9f6f2"),
    64: ("#f65e3b", "#f9f6f2"),
    128: ("#edcf72", "#f9f6f2"),
    256: ("#edcc61", "#f9f6f2"),
    512: ("#edc850", "#f9f6f2"),
    1024: ("#edc53f", "#f9f6f2"),
    2048: ("#edc22e", "#f9f6f2"),
}
_BIG_TILE = ("#3c3a32", "#f9f6f2")
_BACKGROUND = "#bbada0"


class WindowBoard:
    """Interactive board window."""

    def __init__(self, title: str = "2048", size: int = 4):
        import matplotlib.pyplot as plt

        self._plt = plt
        self.size = size
        self.fig, self.ax = plt.subplots(figsize=(5, 5))
        self.fig.canvas.manager.set_window_title(title)
        self.ax.set_axis_off()
        self.ax.set_aspect("equal")
        self._closed = False
        self.fig.canvas.mpl_connect("close_event", self._on_close)

    def _on_close(self, _event) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def show_image(self, board: np.ndarray) -> None:
        """Render a value board (``windows.py:121-142``)."""
        from matplotlib.patches import FancyBboxPatch

        self.ax.clear()
        self.ax.set_axis_off()
        self.ax.set_xlim(0, self.size)
        self.ax.set_ylim(0, self.size)
        self.ax.add_patch(
            FancyBboxPatch((0, 0), self.size, self.size, boxstyle="round,pad=0.02", color=_BACKGROUND)
        )
        board = np.asarray(board)
        for row in range(self.size):
            for col in range(self.size):
                value = int(board[row, col])
                bg, fg = TILE_COLORS.get(value, _BIG_TILE)
                y = self.size - 1 - row
                self.ax.add_patch(
                    FancyBboxPatch(
                        (col + 0.05, y + 0.05), 0.9, 0.9, boxstyle="round,pad=0.01", color=bg
                    )
                )
                if value:
                    fontsize = 22 if value < 1000 else 16
                    self.ax.text(
                        col + 0.5, y + 0.5, str(value), ha="center", va="center",
                        fontsize=fontsize, fontweight="bold", color=fg,
                    )
        self.fig.canvas.draw_idle()
        self._plt.pause(0.001)

    def register_key_handler(self, handler: Callable) -> None:
        """Subscribe to key presses (``windows.py:144-163``)."""
        self.fig.canvas.mpl_connect("key_press_event", handler)

    def show(self, block: bool = True) -> None:
        self._plt.show(block=block)

    def close(self) -> None:
        self._plt.close(self.fig)
        self._closed = True
