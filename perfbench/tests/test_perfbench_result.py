"""The result line's schema, from a whole run of each cell at a tiny size on the CPU."""

import json

import pytest

from perfbench.tests.conftest import run_tiny, tiny_cell

CELLS = ["appendix_c.selfplay", "capacity_probe.selfplay", "capacity_probe.deep_eval"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    cell = tiny_cell(name)
    result = json.loads(json.dumps(run_tiny(cell, trace=trace)))
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in result["device"]
    reported = cell.per_layer if trace else cell.end_to_end
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # On the CPU the device metrics read nothing; the host's do.
        assert set(result["metrics"]) <= {m["name"] for m in reported}
    else:
        assert set(result["metrics"]) == {m["name"] for m in reported}
        assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for name_, check in result["checks"].items():
        assert set(check) == {"value", "limit"}
        assert check["value"] <= check["limit"], name_
