"""On the card, at each cell's own size: the control (the configuration's
own lower precision: the program's QAT training path) fails the check on
three seeds, and the program as configured passes it."""

from __future__ import annotations

import time

import pytest

from benchmark import harness

CELLS = ["mnv2_train.b16"]


def _run(cell: str, seed: int, device: str, control: bool) -> dict:
    ctx = harness.Context(harness.resolve(cell), seed, 8.0, False, device, time.perf_counter(),
                          control=control)
    return harness.run_cell(ctx)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    harness.set_environment()
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        assert _run(cell, seed, card, control=True)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(card, cell):
    harness.set_environment()
    assert _run(cell, 2 ** 31 + 104, card, control=False)["correct"] is True
