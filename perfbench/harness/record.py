"""The benchmark's span around the program's search layer.

The self-play and evaluation loops make one call a move into
``simulate_2048_tpu_torch.ops.search_kernel.run_search_kernel`` (root h/f,
then one kernel launch). :class:`SearchRecorder` wraps that call for the
run: it counts the calls and keeps a device copy of what each call took and
gave (observations, illegal-action mask, root noise; visit counts, root Q,
root value), so that the check after the window can compare what the timed
path produced. The copies are a handful of small device-to-device copies a
move, and every run makes them, traced or not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SearchCall(NamedTuple):
    observations: torch.Tensor  # (B, 16) float32
    invalid: torch.Tensor  # (B, A) bool
    noise: torch.Tensor | None  # (B, A) root noise, None without
    visits: torch.Tensor  # (B, A) int32
    qvalues: torch.Tensor  # (B, A)
    value: torch.Tensor  # (B,)


class SearchRecorder:
    """``with SearchRecorder() as rec:`` records every search call made inside."""

    def __init__(self):
        self.calls: list[SearchCall] = []

    def __enter__(self) -> "SearchRecorder":
        from simulate_2048_tpu_torch.ops import search_kernel

        self._module, self._inner = search_kernel, search_kernel.run_search_kernel

        def recorded(network, observations, config, invalid_actions=None, noise=None, **kw):
            out = self._inner(network, observations, config, invalid_actions, noise, **kw)
            self.calls.append(
                SearchCall(
                    observations=observations.detach().clone(),
                    invalid=invalid_actions.detach().clone(),
                    noise=None if noise is None else noise.detach().clone(),
                    visits=out.visit_counts.detach().clone(),
                    qvalues=out.qvalues.detach().clone(),
                    value=out.search_value.detach().clone(),
                )
            )
            return out

        search_kernel.run_search_kernel = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._module.run_search_kernel = self._inner
