"""The data-parallel mesh: one process a device over torch.distributed.

Counterpart of `depthmodelhardening_tpu/parallel/mesh.py`. Under the JAX
package's mesh the parameters are replicated, the batch is sharded on its
leading axis and the jitted step computes over the global batch, so a
step under a mesh equals the unsharded step on the same global batch.
The port keeps that equality with one process a device: each process
holds its rows of the global batch, the BatchNorm statistics are global
(`parallel/batchnorm.py`), and the gradients, the attack's texture
gradient and the metrics are averaged over the ranks (`Mesh.all_mean`).

Only `all_reduce`, `broadcast` and `barrier` are used: gloo on CUDA
tensors has nothing else, so NCCL, gloo on the card and gloo on the CPU
run one code path. The backend is NCCL for a CUDA device and gloo for the
CPU unless the caller names one.

Not ported: the virtual-CPU-device helpers (`set_host_device_count_flag`,
`ensure_virtual_cpu_devices`, XLA flags) and `make_mesh`'s fallback to
virtual devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

# torchrun's variables; MASTER_ADDR and MASTER_PORT name the coordinator
ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its rank, the
    world size, its device and the process group (None: the default
    group)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def rows(self, n: int, what: str = "batch") -> slice:
        """This rank's rows of a global batch of `n`; raises ValueError
        unless the world size divides `n` (JAX's sharding rule)."""
        if n % self.world_size:
            raise ValueError(f"{what} {n} does not divide by the world size "
                             f"{self.world_size}")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)

    def own_device(self, device=None) -> torch.device:
        """The mesh's device, where a trainer under it runs; `device`, if
        given, must be it."""
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{self.device}")
        return self.device

    def all_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Average `tensors` over the ranks in place, one all-reduce a
        dtype over a flattened buffer; returns them. Every rank gets the
        same bytes."""
        tensors = list(tensors)
        for group in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.group)
            flat /= self.world_size
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))
        return tensors

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks (a new tensor)."""
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device() -> torch.device:
    """This process's card under torchrun: cuda:LOCAL_RANK (cuda:0 when
    LOCAL_RANK is unset)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None, device=None,
                           timeout: Optional[datetime.timedelta] = None
                           ) -> bool:
    """Start the default process group. Returns True when it is up (or
    already was).

    The coordinator is named by explicit arguments (`init_method`, as
    "tcp://localhost:<port>" or "file://<path>", with `world_size` and
    `rank`) or by torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). With none named this returns False, so one call site
    serves single- and multi-process launches. Once one is named a
    failure raises, whichever way it was named: degrading such a launch
    would train unsynchronised copies (JAX `initialize_distributed`'s
    rule). `backend`: default NCCL for a CUDA `device`, gloo otherwise."""
    if dist.is_initialized():
        return True
    backend = backend or default_backend(device or "cpu")
    kwargs = {} if timeout is None else {"timeout": timeout}
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kwargs)
        return True
    if not any(v in os.environ for v in ENV_VARS):
        return False
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


def make_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh of this process. device: default the card (cuda:LOCAL_RANK
    under torchrun; `device.resolve_device`, which raises without one).
    Joins the default process group, starting it from torchrun's
    environment, or as a world of one when no coordinator is named (JAX
    `make_mesh()` over one local device), so every launch runs the same
    code path. A named coordinator that fails raises."""
    dev = resolve_device(local_device() if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not initialize_distributed(backend=backend, device=dev):
        dist.init_process_group(backend or default_backend(dev),
                                store=dist.HashStore(), rank=0, world_size=1)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev)


def make_global_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    """JAX's name for its DCN-outer mesh over every process, kept as an
    alias: a torch.distributed group already spans the hosts, so this is
    `make_mesh`."""
    return make_mesh(device, backend)


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def put_global_batch(batch, mesh: Mesh):
    """A batch whose leaves (numpy arrays or tensors, nested in dicts)
    already are this process's rows of the global batch, on the mesh's
    device."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), batch)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (the leading axis) of a global batch, on the
    mesh's device."""
    return put_global_batch(_tree_map(
        lambda x: x[mesh.rows(x.shape[0])], batch), mesh)


def replicate(modules, mesh: Mesh) -> None:
    """Broadcast every parameter and buffer of `modules` from rank 0, in
    place, so every rank starts from rank 0's state."""
    for dtype_group in _by_dtype(t for m in modules
                                 for t in list(m.parameters())
                                 + list(m.buffers())):
        flat = torch.cat([t.detach().reshape(-1) for t in dtype_group])
        dist.broadcast(flat, src=0, group=mesh.group)
        with torch.no_grad():
            for t, v in zip(dtype_group,
                            flat.split([t.numel() for t in dtype_group])):
                t.copy_(v.view_as(t))


def _by_dtype(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())
