"""Readings that set a cell's limits: the program's numbers over many seeds,
and the control's, in one process.

    python3 perfbench/control.py --workload <name> --seconds <s> --seeds <n> ... [--control-seeds <n> ...]

For each seed: the cell's set-up and a window of ``--seconds`` as a run
makes them, then the check (``harness/check.py``) of what the window
produced. For each control seed, the same searches are judged again with the
control in the program's place: the reference with its products one
precision below the configuration's (``check.CONTROL``). One JSON line per
seed and judge on standard output; every number is printed, whatever its
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, seconds: float, device, control: bool) -> list[dict]:
    """The program's numbers (and with ``control`` the control's) of one seed."""
    import torch

    from perfbench.harness import check, players
    from perfbench.harness.record import SearchRecorder

    player = players.PLAYERS[cell.traffic["player"]](cell, seed, device)
    player.setup()
    recorder = SearchRecorder()
    with recorder:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            player.unit(recorder)
    out = []
    judges = [None] + ([check.CONTROL[cell.config["search_weight_dtype"]]] if control else [])
    for products in judges:
        numbers, compared = check.judge(player, recorder, control=products)
        out.append({"workload": cell.name, "seed": seed, "judged": products or "program",
                    "correct": all(n.ok for n in numbers), **compared,
                    "units": [[u.moves, u.calls[1] - u.calls[0], u.seconds] for u in player.units],
                    "numbers": {n.name: n.value for n in numbers}, "limits": {n.name: n.limit for n in numbers}})
    del player, recorder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    from perfbench.harness import spec

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds + args.control_seeds:
        for line in readings(cell, seed, args.seconds, device, seed in args.control_seeds):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
