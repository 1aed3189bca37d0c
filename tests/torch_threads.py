"""The port's test modules' share of the host's cores.

The suite runs six test processes on one host (pytest-xdist), and torch's
default of one intra-op thread a core oversubscribes it: its OpenMP
threads spin while they wait, so a small op in one process waits for
the others' (a test of a few seconds alone took minutes inside the
suite). Every port test module takes this fixture.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for torch while the module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
