"""Distribution over torch devices and processes (port of
vcf_tpu/parallel/dist.py): process-group start-up, the broadcast of shared
side info, the sum of per-shard statistics and the ordered gather of
variable-length streams.

A mesh (`parallel.mesh.Mesh`) is a tuple of torch devices, one per shard,
and optionally a `torch.distributed` process group.  A sharded array is a
list of tensors, one per shard, each on its shard's device.  Within a
process the collectives are plain tensor ops in shard order: a psum adds
the shards' tensors on the mesh's first device one after another, so that
no result depends on timing, and a ppermute is a `.to()` copy.  Across
the processes of the mesh's group the psum is then an `all_reduce`, the
broadcast a `broadcast` from the group's rank 0 and the ppermute a ring
of `batch_isend_irecv`, on the backend's device: the CPU for Gloo, the
rank's card for NCCL.  The global shard order is rank-major: every
process holds the same number of shards.

The backend is the caller's choice (`initialize`): NCCL needs one card a
rank, so two processes on one card talk over Gloo.  Nothing here switches
backend or device after a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

#: seconds a process waits for the others, at start-up and in every
#: collective, before it raises
TIMEOUT_S = 300


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the default process group at `coordinator` ("host:port"), as
    rank `process_id` of `num_processes`; a no-op without a coordinator.
    `backend` defaults to "nccl" when CUDA is visible, else "gloo"; an
    NCCL rank first takes the card `LOCAL_RANK` (default: its rank)."""
    if coordinator is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        dev = torch.device("cuda", _local_rank(process_id))
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def global_mesh(axis: str = "data"):
    """This process's device with the default group attached: the card
    `cuda:LOCAL_RANK` for NCCL, the CPU for Gloo.  Without a process group,
    the mesh of every visible card (`make_mesh()`)."""
    from vcf_tpu_torch.parallel.mesh import Mesh, make_mesh

    if not tdist.is_initialized():
        return make_mesh(axis=axis)
    if tdist.get_backend() == "nccl":
        dev = torch.device("cuda", _local_rank(tdist.get_rank()))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh((dev,), axis, tdist.group.WORLD)


def process_count() -> int:
    """Processes of the default group (1 without one)."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _group_size(mesh) -> int:
    return 1 if mesh.group is None else tdist.get_world_size(mesh.group)


def _comm_device(group) -> torch.device:
    """Where the backend's collectives take their tensors."""
    if tdist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def _split(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Equal chunks of the leading axis, one per shard, each on its
    shard's device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{mesh.size} shards")
    k = n // mesh.size
    return [x[i * k:(i + 1) * k].to(d) for i, d in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# Collectives over a mesh
# ---------------------------------------------------------------------------

def _psum(shards: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """The elementwise sum of the shards' tensors on the mesh's first
    device, added in shard order, then summed over the mesh's group."""
    d0 = mesh.devices[0]
    total = shards[0].to(d0, copy=True)
    for s in shards[1:]:
        total += s.to(d0)
    if mesh.group is not None:
        buf = total.to(_comm_device(mesh.group))
        tdist.all_reduce(buf, group=mesh.group)
        total = buf.to(d0)
    return total


def _pmean(shards: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """`_psum` over the number of shards in the whole mesh (lax.pmean)."""
    total = _psum(shards, mesh)
    n = len(shards) * _group_size(mesh)
    # by a tensor: CUDA divides by a Python scalar through its reciprocal
    return total / torch.tensor(n, dtype=total.dtype, device=total.device)


def _ring_shift(xs: Sequence[torch.Tensor], mesh, step: int
                ) -> List[torch.Tensor]:
    """lax.ppermute by `step` (+1 or -1) along the ring of shards: shard i
    receives shard i - step's tensor on its own device, and shard 0 (for
    +1) the last shard's, across processes too."""
    n = len(xs)
    devs = mesh.devices
    out = [None] * n
    for i in range(n):
        if 0 <= i - step < n:
            out[i] = xs[i - step].to(devs[i])
    edge_in, edge_out = (0, n - 1) if step == 1 else (n - 1, 0)
    world = _group_size(mesh)
    if world == 1:
        out[edge_in] = xs[edge_out].to(devs[edge_in])
        return out
    group, comm = mesh.group, _comm_device(mesh.group)
    rank = tdist.get_rank(group)
    send = xs[edge_out].to(comm).contiguous()
    recv = torch.empty_like(send)
    ops = [tdist.P2POp(tdist.isend, send,
                       tdist.get_global_rank(group, (rank + step) % world),
                       group),
           tdist.P2POp(tdist.irecv, recv,
                       tdist.get_global_rank(group, (rank - step) % world),
                       group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    out[edge_in] = recv.to(devs[edge_in])
    return out


# ---------------------------------------------------------------------------
# Broadcast of shared side info (codebooks, Lloyd-Max levels, Huffman
# tables): the reference's analogue is the sidecar files every process
# reads (src/VQ.py:110-112, src/LloydMax.py:107-112)
# ---------------------------------------------------------------------------

def replicate(arr, mesh) -> List[torch.Tensor]:
    """One copy of `arr` on each device of the mesh, rank 0's across the
    mesh's group (all shards then quantize against identical tables)."""
    x = _as_tensor(arr)
    if mesh.group is not None:
        buf = x.to(_comm_device(mesh.group), copy=True)
        tdist.broadcast(buf, tdist.get_global_rank(mesh.group, 0),
                        group=mesh.group)
        x = buf
    return [x.to(d, copy=True) for d in mesh.devices]


def allreduce_histogram(local_counts, mesh) -> torch.Tensor:
    """psum of per-shard histograms -> the one global histogram, on the
    mesh's first device (vcf_tpu's out_specs=P(): (n, bins) counts over n
    shards give (1, bins)).  `local_counts` is a sharded array (a list, one
    tensor per shard) or one array whose leading axis splits over the
    shards."""
    if isinstance(local_counts, (list, tuple)):
        shards = list(local_counts)
    else:
        shards = _split(_as_tensor(local_counts), mesh)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} histograms for a mesh of "
                         f"{mesh.size} shards")
    return _psum(shards, mesh)


# ---------------------------------------------------------------------------
# Ordered gather of variable-length compressed streams
# ---------------------------------------------------------------------------

def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's `t` (same shape), stacked in rank order."""
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(out, t, group=group)
    return torch.stack(out)


def _process_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's rows of a global array split rank-major over the
    processes of the mesh's group (all of it within one process)."""
    world = _group_size(mesh)
    if world == 1:
        return x
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not split over {world} "
                         "processes")
    k = x.shape[0] // world
    rank = tdist.get_rank(mesh.group)
    return x[rank * k:(rank + 1) * k]


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of `_process_rows`: every process's rows, in rank
    order, on this process's device of `x`."""
    if _group_size(mesh) == 1:
        return x
    comm = _comm_device(mesh.group)
    return _all_gather(x.to(comm), mesh.group).flatten(0, 1).to(x.device)


def _allgather_streams(local: List[Tuple[int, bytes]]
                       ) -> List[Tuple[int, bytes]]:
    """Every process's (frame_index, payload) pairs, by fixed-capacity
    buffers and actual lengths (SURVEY §7.3): one gather of each process's
    capacity and count (the maxima size the buffers), then the indexes,
    lengths and zero-padded uint8 buffers."""
    comm = _comm_device(None)
    cap = max((len(b) for _, b in local), default=0)
    sizes = _all_gather(torch.tensor([cap, len(local)], dtype=torch.int64,
                                     device=comm)).cpu()
    cap = max(int(sizes[:, 0].max()), 1)
    rows = int(sizes[:, 1].max())
    idxs = np.full(rows, -1, np.int64)
    lens = np.zeros(rows, np.int64)
    buf = np.zeros((rows, cap), np.uint8)
    for row, (idx, blob) in enumerate(local):
        idxs[row], lens[row] = idx, len(blob)
        buf[row, :len(blob)] = np.frombuffer(blob, np.uint8)
    all_idx, all_len, all_buf = (
        _all_gather(torch.from_numpy(a).to(comm)).cpu().numpy()
        for a in (idxs, lens, buf))
    all_buf = all_buf.reshape(-1, cap)
    return [(int(i), all_buf[r, :int(n)].tobytes())
            for r, (i, n) in enumerate(zip(all_idx.reshape(-1),
                                           all_len.reshape(-1)))
            if i >= 0]


def gather_streams(local_streams: Sequence[Tuple[int, bytes]],
                   n_total: int) -> List[bytes]:
    """(frame_index, payload) pairs from every process -> the `n_total`
    payloads in frame order, on every process.  With one process a sort;
    with more, `_allgather_streams` first.  A frame that no process holds
    raises ValueError."""
    pairs = list(local_streams)
    if process_count() > 1:
        pairs = _allgather_streams(pairs)
    out: List[Optional[bytes]] = [None] * n_total
    for idx, blob in pairs:
        out[idx] = blob
    missing = [i for i, b in enumerate(out) if b is None]
    if missing:
        raise ValueError(f"missing streams for frames {missing[:8]}...")
    return out  # type: ignore[return-value]
