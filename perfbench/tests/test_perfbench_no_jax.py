"""No module of a run has the top-level name jax, jaxlib, flax or
simulate_2048_tpu (compared whole: the port's name begins with the JAX
package's)."""

import subprocess
import sys
import textwrap

from perfbench import run as run_mod
from perfbench.harness import spec


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = run_mod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "simulate_2048_tpu_torch.ops.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run_mod.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "simulate_2048_tpu.ops.fake", sys)
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert {"simulate_2048_tpu", "flax"} <= set(run_mod.forbidden_modules())


def test_a_run_loads_no_jax():
    code = textwrap.dedent(
        """
        import sys
        from perfbench.tests.conftest import run_tiny, tiny_cell
        from perfbench import run
        for name in ("appendix_c.selfplay", "capacity_probe.deep_eval"):
            assert run_tiny(tiny_cell(name))["correct"]
        print(run.forbidden_modules())
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
