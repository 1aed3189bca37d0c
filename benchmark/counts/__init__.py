"""The work of each op and model pass, counted from the shapes (and,
where the work depends on the data, the inputs) it was called with, and
the card's peaks: the yardstick of the roofline and MFU metrics.

`counts/<op>.py:work(pass, args)` gives (bytes, operations, peak
FLOP/s) of one call of the op's pass (the "op:<op>.<pass>" range's
suffix). An op the harness wraps (`harness/spans.py:OPS`) gets `args` as
the call's positional arguments, each tensor described as (shape,
dtype); any other op gets them from the program's own span: a dict by
parameter name, each tensor as (shape, dtype), each number or string as
it is (`harness/readings.py:op_calls`). A roofline of a new kernel is
then two new files: its count here and its reader under `metrics/`.
"""
