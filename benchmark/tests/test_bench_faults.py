"""Each fault a cell can have, planted in the program underneath the
harness, turns `correct` false under the cell's own limits (on the CPU
at a small size: `small.py`; the readings at the cells' sizes on the
card are `benchmark/readings.py --faults`)."""

import pytest

from harness import faults

import small

CASES = [(cell, fault)
         for cell in ("md2r18.harden_l0_bf16", "dhr50.harden_l0_bf16",
                      "md2r18.selfsup_f32", "md2r18.eval_pgd10_f32")
         for fault in faults.kinds(small.spec(cell)["traffic"])]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_not_correct(cell, fault):
    kind = small.spec(cell)["traffic"]["entry"]
    with faults.planted(kind, fault):
        result, _ = small.run(cell)
    assert result["correct"] is False, result["checks"]
