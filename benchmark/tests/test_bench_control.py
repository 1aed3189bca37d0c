"""Each cell's control comes out not correct under the cell's limits: the
reference in the program's place, one precision below the one its
configuration states (bfloat16 -> float8 e4m3 convolutions, here on the
CPU; float32 -> TF32, which only a card has), at a small size
(`small.py`). The readings at the cells' sizes on the card are
`benchmark/readings.py --control`."""


import pytest
import torch

import reference
from harness import main as harness, port

import small

CELLS = ("md2r18.harden_l0_bf16", "dhr50.harden_l0_bf16",
         "md2r18.eval_pgd10_f32", "md2r18.selfsup_f32")


def _low(s):
    return "fp8" if s["traffic"].get("hardening", {}).get(
        "compute_dtype") == "bfloat16" else "tf32"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, request):
    s = small.spec(cell)
    if _low(s) == "tf32":
        dev = request.getfixturevalue("card")
        control = lambda model_or_state: reference.tf32()
    else:
        dev = torch.device("cpu")
        control = lambda state: reference.fp8(state.model)
    program = port.load()
    program.use_f32_numerics()
    c = harness.CELLS[s["traffic"]["entry"]](s, 2 ** 33 + 9, dev, program,
                                             reference)
    c.setup()
    for i in range(3 if c.kind == "eval" else 0):
        c.step(i)
    c.free()
    got = c.control_record(control)
    readings = c.readings(c.reference_record(got), got)
    over = {k: v for k, v in readings.items()
            if k in s["limits"] and not v <= s["limits"][k]}
    assert over, (readings, s["limits"])
