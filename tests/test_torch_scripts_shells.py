"""The port's orchestration shells (``simulate_2048_tpu_torch/scripts``:
``champion_r5_watchdog.sh``, ``watchdog_arm.sh``, ``r5b_queue.sh``,
``r5b_phase2.sh`` and their step reader ``latest_step.sh``), on the CPU.

Each parses (``bash -n``). The step reader takes the newest ``step_<n>.pt``
of a port checkpoint directory (``training/checkpoint.py``), not JAX's orbax
step directories. ``watchdog_arm.sh`` and the queue's ``run_to_target`` each
drive a stub launch script that writes ``step_<n>.pt`` and exits early once:
they must relaunch it with the remaining steps (target + 10 - step, as the
JAX shells compute it) until the target is reached. A ``sleep`` first on
``PATH`` cuts the shells' 30 s wait between checks on a PID to 0.1 s. That a relaunch resumes
and adds ``--steps`` to the resumed step is the port's train CLI's own
behaviour, held by ``test_torch_trainer.py::test_train_cli_runs_resumes_and_evaluate_loads``.
"""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

SCRIPTS = Path(__file__).resolve().parents[1] / "simulate_2048_tpu_torch" / "scripts"
SHELLS = ["champion_r5_watchdog.sh", "watchdog_arm.sh", "r5b_queue.sh", "r5b_phase2.sh", "latest_step.sh"]

STUB = """#!/bin/bash
# A launch script's stand-in: "trains" $1 steps from the newest checkpoint,
# except the first time, when it stops halfway and exits 1.
cur=$(ls "$STUB_CKPT" 2>/dev/null | sed -nE 's/^step_([0-9]+)\\.pt$/\\1/p' | sort -n | tail -1)
cur=${cur:-0}
mkdir -p "$STUB_CKPT"
echo "$1" >> "$STUB_CALLS"
if [ ! -f "$STUB_CALLS.crashed" ]; then
  touch "$STUB_CALLS.crashed" "$STUB_CKPT/step_$(( cur + $1 / 2 )).pt"
  exit 1
fi
touch "$STUB_CKPT/step_$(( cur + $1 )).pt"
"""

FAST_SLEEP = f"""#!/bin/bash
exec {shutil.which("sleep")} 0.1
"""


@pytest.mark.parametrize("name", SHELLS)
def test_shell_parses(name):
    path = SCRIPTS / name
    assert os.access(path, os.X_OK), f"{name} is not executable"
    subprocess.run(["bash", "-n", str(path)], check=True)


def latest(directory) -> str:
    out = subprocess.run(["bash", str(SCRIPTS / "latest_step.sh"), str(directory)], check=True,
                         capture_output=True, text=True)  # fmt: skip
    return out.stdout.strip()


def test_latest_step_reads_port_checkpoint_files(tmp_path):
    assert latest(tmp_path / "missing") == "0"
    assert latest(tmp_path) == "0"
    for name in ("step_900.pt", "step_10000.pt", "step_2500.pt", "step_20000.pt.123.tmp", "train_config.json",
                 "12000", "step_x.pt", "deep_eval_best.json"):  # fmt: skip
        (tmp_path / name).touch()
    (tmp_path / "best").mkdir()
    (tmp_path / "best" / "step_30000.pt").touch()
    (tmp_path / "40000").mkdir()  # an orbax step directory: not the port's
    assert latest(tmp_path) == "10000"


def stubbed(tmp_path):
    """A copy of the scripts under ``tmp_path`` (so that the shells' ``cd`` to
    the checkout lands there and their logs go to ``tmp_path/runs``), a stub
    launch script, and its environment, whose ``PATH`` starts with a fast
    ``sleep``."""
    scripts = tmp_path / "simulate_2048_tpu_torch" / "scripts"
    shutil.copytree(SCRIPTS, scripts, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    stub = tmp_path / "stub.sh"
    stub.write_text(STUB)
    stub.chmod(0o755)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "sleep").write_text(FAST_SLEEP)
    (bin_dir / "sleep").chmod(0o755)
    env = {**os.environ, "STUB_CKPT": str(tmp_path / "ckpt"), "STUB_CALLS": str(tmp_path / "calls"),
           "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}  # fmt: skip
    return scripts, stub, env


def test_watchdog_arm_relaunches_to_the_target(tmp_path):
    scripts, stub, env = stubbed(tmp_path)
    dead = subprocess.Popen(["true"])
    dead.wait()
    subprocess.run(["bash", str(scripts / "watchdog_arm.sh"), str(dead.pid), str(tmp_path / "ckpt"), "1000",
                    str(stub), str(tmp_path / "arm.log")], check=True, env=env, timeout=60)  # fmt: skip
    # First launch: 1,010 steps asked, 505 done before the early exit; the second finishes the 505 left.
    assert (tmp_path / "calls").read_text().split() == ["1010", "505"]
    assert latest(tmp_path / "ckpt") == "1010"
    log = (tmp_path / "runs" / "torch_watchdog_arm.log").read_text()
    assert "exited at checkpoint step 0" in log and "exited at checkpoint step 505" in log
    assert "resuming" in log and "exited at checkpoint step 1010" in log


def test_queue_run_to_target_relaunches_to_the_target(tmp_path):
    scripts, stub, env = stubbed(tmp_path)
    (tmp_path / "runs").mkdir()
    call = (f"source {scripts / 'r5b_queue.sh'} && "
            f"run_to_target {stub} {tmp_path / 'ckpt'} 600 {tmp_path / 'arm.log'}")  # fmt: skip
    subprocess.run(["bash", "-c", call], check=True, env=env, timeout=60, cwd=tmp_path)
    assert (tmp_path / "calls").read_text().split() == ["610", "305"]
    assert latest(tmp_path / "ckpt") == "610"
    log = (tmp_path / "runs" / "torch_r5b_queue.log").read_text()
    assert "610 more steps (at 0/600)" in log and "305 more steps (at 305/600)" in log and "reached 600" in log
    # Sourcing only defines the function: nothing of the queue itself ran.
    assert sorted(p.name for p in (tmp_path / "runs").iterdir()) == ["torch_r5b_queue.log"]
