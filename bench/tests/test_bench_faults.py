"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run with one fault of `bench/faults.py` planted in the program's calls
after the engine is made, and reads `correct` against the cell's own
limits: on the CPU at a smoke size (the published hidden size, so the
logits keep the full model's scale; short prompts of 4 to 12 tokens),
and on the card (`-m cuda`) at the cell's own sizes and load, over a
short window. Every fault is caught in every cell: a decode step that
loses its state by `state_gap` and `state_pos` (a live slot's cache),
the others by `served_gap` or the state.
"""
from __future__ import annotations

import pytest
import torch

from conftest import smoke_cell

CELLS = ["minicpm3-4b.decode-long", "mamba2-2.7b.prefill-long",
         "minicpm3-4b.prefill-long"]


def _faults():
    from bench.faults import FAULTS
    return sorted(FAULTS)


def _run(cell, fault):
    from bench.faults import FAULTS
    from bench.harness import run_cell
    torch.manual_seed(0)
    mix = smoke_cell(cell, prompt_len=[4, 12], check_requests=8)
    if mix.traffic["output_len"][1] > 8:
        mix.traffic["output_len"] = [16, 48]
    return run_cell(mix, 2**31 + 101, 3.0, False, device="cpu",
                    hook=FAULTS[fault] if fault else None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell, None)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", _faults())
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", _faults())
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught_at_the_cells_size(card, cell, fault):
    from bench.control import faults
    row = next(faults(cell, [fault], 2**31 + 4321, 15.0))
    assert not row["correct"], row
