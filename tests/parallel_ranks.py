"""One rank of the data-parallel tests' two-process gloo group:

    python tests/parallel_ranks.py RANK WORLD STORE TREE_JSON OUT_DIR

joins the group through the file store STORE (no port: the suite's
workers would race for ports) with a 60 s timeout, runs every case of
tests/parallel_common.py on its rows and saves them to
OUT_DIR/rank<RANK>.pt (the gradients rank 0's only: the ranks' are equal,
which their digests show). The CLI runs log to OUT_DIR/cli, shared by the
ranks, as under torchrun.
"""

import datetime
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import parallel_common  # noqa: E402
from depthmodelhardening_tpu_torch.parallel import mesh as pmesh  # noqa


def main(rank: int, world: int, store: str, tree_json: str, out: str):
    torch.set_num_threads(1)
    sys.modules["tensorboardX"] = None  # as on the card's machine
    pmesh.initialize_distributed(
        f"file://{store}", world_size=world, rank=rank, backend="gloo",
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = pmesh.make_mesh("cpu")
        with open(tree_json) as f:
            tree = json.load(f)
        results = parallel_common.rank_results(mesh, tree,
                                               os.path.join(out, "cli"))
        torch.save(results if rank == 0 else parallel_common.slim(results),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
