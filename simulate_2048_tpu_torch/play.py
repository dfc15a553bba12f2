"""Manual play: ``python -m simulate_2048_tpu_torch.play``.

Counterpart of the reference's ``manuals_control.py:98-108``: arrow keys /
named keys move, backspace resets, escape quits. Falls back to a terminal
REPL when matplotlib is unavailable (e.g. a headless machine). Host-side
only: the game runs on the NumPy engine, so there is no ``--device``.
"""

from __future__ import annotations

import argparse

from simulate_2048_tpu_torch.engine import ACTIONS, TwentyFortyEight

# Accept both matplotlib arrow-key names and the reference's named actions
# (the reference only matched 'left'/'up'/… — actual arrow keys, which
# matplotlib also reports as 'left' etc., so both work here too).
KEY_TO_ACTION = {**ACTIONS, "a": 0, "w": 1, "d": 2, "s": 3}


def play_gui() -> None:
    from simulate_2048_tpu_torch.gui import WindowBoard

    env = TwentyFortyEight()
    window = WindowBoard(title="2048 — simulate_2048_tpu_torch")

    def handler(event) -> None:
        if event.key == "escape":
            window.close()
            return
        if event.key == "backspace":
            window.show_image(env.reset())
            return
        if event.key in KEY_TO_ACTION:
            obs, reward, done = env.step(KEY_TO_ACTION[event.key])
            print(f"reward={reward:.2f}")
            window.show_image(obs)
            if done:
                print("game over — backspace to restart")

    window.register_key_handler(handler)
    window.show_image(env.reset())
    window.show(block=True)


def play_terminal() -> None:
    env = TwentyFortyEight()
    env.reset()
    print("moves: a/w/d/s or left/up/right/down, r = reset, q = quit")
    env.render()
    while True:
        try:
            cmd = input("> ").strip().lower()
        except EOFError:
            return
        if cmd in ("q", "quit", "exit"):
            return
        if cmd in ("r", "reset"):
            env.reset()
            env.render()
            continue
        if cmd in KEY_TO_ACTION:
            _obs, reward, done = env.step(KEY_TO_ACTION[cmd])
            print(f"reward={reward:.2f}")
            env.render()
            if done:
                print("game over — r to restart")


def main() -> None:
    parser = argparse.ArgumentParser(description="Play 2048 interactively")
    parser.add_argument("--terminal", action="store_true", help="force terminal mode")
    args = parser.parse_args()
    if args.terminal:
        play_terminal()
        return
    try:
        play_gui()
    except ImportError:
        print("matplotlib unavailable — terminal mode")
        play_terminal()


if __name__ == "__main__":
    main()
