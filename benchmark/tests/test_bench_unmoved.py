"""The four cells' inputs, weights and readings are what they were before
the harness learnt temporal frames, pose networks and ManyDepth: at a
small size (`small.py`) on the CPU, the digests of each cell's pool
tensors, its seeded weights, the program's record and the readings
against the reference (but the two it added since, `NEW`) equal those
that the harness gave before that change. Pinned on one thread (the
calibration's convolutions sum in another order on more), with torch
2.13's CPU build."""

import hashlib

import pytest
import torch

import reference
from harness import main as harness, port

import small

SEED = 2 ** 33 + 5
NEW = ("attack_moved", "attack_stayed")
PINNED = {
    "md2r18.harden_l0_bf16": {
        "pool": "6a75185759c386b2", "weights": "bb8351bb213af721",
        "record": "d655c2e30887476a", "readings": "e925865f9214533c"},
    "dhr50.harden_l0_bf16": {
        "pool": "03c731faf3122c26", "weights": "3c35d1183c76bb76",
        "record": "dd1e19b57b5be9a0", "readings": "14c441060788fc02"},
    "md2r18.eval_pgd10_f32": {
        "pool": "6ac778164d9e46bb", "weights": "646928f866bd1e17",
        "record": "8a108d91361277dc", "readings": "b16aa7a489bd0ecb"},
    "md2r18.selfsup_f32": {
        "pool": "0940d279281c7fa6", "weights": "646928f866bd1e17",
        "record": "544aea6fab8d84d8", "readings": "28ab60edf7c7d505"},
}


def _feed(h, x) -> None:
    """Every tensor's shape, dtype and bytes, every float's bits, every
    other leaf's repr, dicts in the order of their sorted keys."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            h.update(str(k).encode())
            _feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            _feed(h, v)
    elif x is None:
        h.update(b"None")
    elif isinstance(x, float):
        h.update(x.hex().encode())
    else:
        h.update(repr(x).encode())


def digest(x) -> str:
    h = hashlib.sha256()
    _feed(h, x)
    return h.hexdigest()[:16]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_cell_reads_as_before(cell, one_thread):
    s = small.spec(cell)
    c = harness.CELLS[s["traffic"]["entry"]](s, SEED, torch.device("cpu"),
                                             port.load(), reference)
    c.setup()
    for i in range(2 if c.kind == "eval" else 0):
        c.step(i)
    got = {"pool": digest(c.pool)}
    got["weights"] = digest(c.weights if c.kind == "train"
                            else {"model": c.sd})
    c.free()
    ref = c.reference_record()
    got["record"] = digest(c.record if c.kind == "train" else c.answers)
    got["readings"] = digest({k: v for k, v in c.readings(ref).items()
                              if k not in NEW})
    assert got == PINNED[cell]
