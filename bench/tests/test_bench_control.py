"""The control: the plain reference computed with FP8 (e4m3) products in
the program's place must come out not correct against each cell's
limits, where the program's own runs come out correct.

On the CPU, at the smoke size of `conftest.smoke_cell`, the FP8
reference's gaps (served tokens and a live slot's cache) are read beside
the program's and must exceed them. On the card (`-m cuda`), at the
cell's own sizes and load, one seed's control must come out not correct
against the cell's limits while the program comes out correct;
`bench/control.py` reads the same on more seeds.
"""
from __future__ import annotations

import pytest
import torch

from conftest import smoke_cell

CELLS = ["minicpm3-4b.decode-long", "mamba2-2.7b.prefill-long",
         "minicpm3-4b.prefill-long"]


def test_fp8_rounding_is_coarser_than_bf16():
    from bench.reference.common import _fp8
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    fp8 = (_fp8(x, None) - x).abs().mean()
    bf16 = (x.bfloat16().float() - x).abs().mean()
    assert fp8 > 8 * bf16


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_wider_gaps_than_the_program(cell):
    from bench.harness import run_cell
    res = run_cell(smoke_cell(cell, prompt_len=[4, 12]), 2**31 + 7, 1.5,
                   False, device="cpu", control=True)
    c, ctrl = res["checks"], res["control"]
    assert res["correct"], c
    assert ctrl["served_gap"]["value"] > c["served_gap"]["value"], ctrl
    assert ctrl["state_gap"]["value"] > c["state_gap"]["value"], ctrl
    assert res["control_correct"] in (True, False)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    from bench.control import readings
    row = next(readings(cell, [2**31 + 1234], 30.0))
    assert row["correct"], row
    assert not row["control_correct"], row
