"""Meshes of ranks, their exchanges, and processes wired into one mesh.

Counterpart of pil2_stark_tpu/parallel/distributed.py (``init_distributed``
:34, ``proof_mesh`` :58) and of the jax.lax collectives its sharded
kernels call (``all_to_all``, ``all_gather``).

A ``Mesh`` is a row-major grid of ranks, each a torch.device, with its
axis names; the sharded code shards over every axis in row-major order, as
ref parallel/ntt_sharded.py:73 ``_norm_axes`` does.  A device may stand in
the grid more than once (virtual ranks: ``[cpu] * 8`` in the tests,
``[cuda:0] * 4`` on one card), the counterpart of the reference's virtual
8-device CPU mesh: every rank still holds its own shard and runs the same
sharded code at the same shapes, and an exchange between two ranks of one
device is a copy in its memory.

A sharded array is a list with one entry per rank: for a rank this process
drives, a planar (C, N/d) tensor on its device holding columns
[r·N/d, (r+1)·N/d); for any other rank None.

One process drives every rank of its row, the single controller of
jax.shard_map, which runs its local function once per shard.  Across
processes (``init_distributed``: gloo on the CPU, NCCL on cards) the grid
is ("dcn", "ici"): process p drives row p, the other rows are None in its
grid, and every process runs the same prove on the same inputs.  Between
ranks of one process an exchange is a peer copy (``.to(device,
non_blocking=True)``, NVLink between cards); between processes every
exchange is one ``torch.distributed.all_to_all_single`` that carries all
pairs' data, so that all processes make the same collectives in the same
order.
"""
from __future__ import annotations

import datetime
import math

import numpy as np
import torch


def _device(x) -> torch.device:
    """A torch.device; a card without an index is the current one, so that
    it equals the device of the tensors made on it."""
    dev = torch.device(x)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _world():
    """(number of processes, this process's index) of torch.distributed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """devices: a (nested) row-major grid of devices, one per rank, with
    None at the ranks other processes drive; axis_names: one per grid
    axis.  With n_processes > 1, process p drives the p-th of
    n_processes equal runs of ranks.  ``exchanged_bytes`` counts the bytes
    that left their rank in exchanges (the transposes, the zero-pad moves,
    the gathers)."""

    def __init__(self, devices, axis_names, process_index=0, n_processes=1):
        grid = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names) or grid.size == 0:
            raise ValueError(f"a grid of shape {grid.shape} for axes {self.axis_names}")
        self.size = grid.size
        if self.size % n_processes or not 0 <= process_index < n_processes:
            raise ValueError(f"{self.size} ranks over {n_processes} processes "
                             f"(this one {process_index})")
        self.n_processes = n_processes
        self.process_index = process_index
        self.per_process = self.size // n_processes
        self.local_ranks = range(process_index * self.per_process,
                                 (process_index + 1) * self.per_process)
        flat = [None if x is None else _device(x) for x in grid.reshape(-1)]
        if any((flat[r] is not None) != (r in self.local_ranks) for r in range(self.size)):
            raise ValueError("the grid must name a device at every rank this process drives "
                             "and None at the others")
        self.devices = np.array(flat, dtype=object).reshape(grid.shape)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self._flat = flat
        self.lead = flat[self.local_ranks[0]]
        self.exchanged_bytes = 0

    def device(self, rank: int) -> torch.device:
        return self._flat[rank]

    def local_devices(self) -> list:
        """The distinct devices of this process's ranks."""
        return list(dict.fromkeys(self._flat[r] for r in self.local_ranks))

    def lead_rank(self, process: int) -> int:
        return process * self.per_process

    def _process(self, rank: int) -> int:
        return rank // self.per_process

    # -- exchanges ------------------------------------------------------------

    def exchange(self, sends: dict, shapes: dict) -> dict:
        """Move each pair's int64 tensor from rank src to rank dst.
        sends {(src, dst): tensor} names every pair whose src this process
        drives, shapes {(src, dst): shape} every pair whose dst it drives
        (both sides derive the pairs from the same arithmetic).  Returns
        {(src, dst): tensor on dst's device} for the pairs whose dst this
        process drives; a tensor that stays on its device is not copied (it
        may be a view)."""
        out, send_far, recv_far = {}, {}, {}
        for (s, t), x in sends.items():
            if x.dtype != torch.int64:
                raise ValueError(f"exchange: int64 tensors only, got {x.dtype}")
            if s != t:
                self.exchanged_bytes += x.numel() * 8
            if t in self.local_ranks:
                out[(s, t)] = x.to(self._flat[t], non_blocking=True)
            else:
                send_far.setdefault(self._process(t), []).append(((s, t), x))
        for (s, t), shape in shapes.items():
            if s not in self.local_ranks:
                recv_far.setdefault(self._process(s), []).append(((s, t), tuple(shape)))
        if self.n_processes > 1:
            out.update(self._exchange_processes(send_far, recv_far))
        return out

    def _exchange_processes(self, send_far: dict, recv_far: dict) -> dict:
        """One all_to_all_single over every process: each pair's data
        flattened, in (src, dst) order within each process's part."""
        import torch.distributed as dist

        comm = self.lead if dist.get_backend() == "nccl" else torch.device("cpu")
        parts, in_splits, out_splits = [], [], []
        for q in range(self.n_processes):
            flat = [x.reshape(-1).to(comm) for _, x in sorted(send_far.get(q, []),
                                                              key=lambda kv: kv[0])]
            parts += flat
            in_splits.append(sum(f.numel() for f in flat))
            out_splits.append(sum(math.prod(shape) for _, shape in recv_far.get(q, [])))
        send = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64, device=comm)
        recv = torch.empty(sum(out_splits), dtype=torch.int64, device=comm)
        dist.all_to_all_single(recv, send, out_splits, in_splits)
        out, pos = {}, 0
        for q in range(self.n_processes):
            for (s, t), shape in sorted(recv_far.get(q, [])):
                k = math.prod(shape)
                out[(s, t)] = recv[pos:pos + k].reshape(shape).to(self._flat[t],
                                                                 non_blocking=True)
                pos += k
        return out

    def all_to_all(self, chunks: list) -> list:
        """chunks[s][t]: the block rank s sends to rank t, one shape for
        all blocks; returns recv with recv[t][s] that block, for each rank
        t this process drives (None for the others)."""
        shape = tuple(chunks[self.local_ranks[0]][0].shape)
        ranks = range(self.size)
        got = self.exchange({(s, t): chunks[s][t] for s in self.local_ranks for t in ranks},
                            {(s, t): shape for t in self.local_ranks for s in ranks})
        return [[got[(s, t)] for s in ranks] if t in self.local_ranks else None for t in ranks]

    def halos(self, arrays: list, before: int, after: int) -> dict:
        """The rows around each rank's block of the sharded (C_j, N) arrays
        `arrays` that a window of its rows reads: {rank: (the `before` rows
        that precede its block, the `after` rows that follow it)} for every
        rank this process drives, each a (Σ C_j, rows) stack of the arrays
        in order.  The domain wraps: rank 0's rows before are the last
        rank's last rows.  One exchange; a pair of neighbours sends both
        edges in one block."""
        d = self.size
        local = self.local_ranks[0]
        width = sum(a[local].shape[0] for a in arrays)
        b = arrays[0][local].shape[1]
        if before > b or after > b:
            raise ValueError(f"halos of {before} and {after} rows around blocks of {b}")

        def rows(s, t):  # what s sends t: its last rows, then its first rows
            return ((before if s == (t - 1) % d else 0), (after if s == (t + 1) % d else 0))

        sends, shapes = {}, {}
        for t in range(d):
            for s in {(t - 1) % d, (t + 1) % d}:
                last, first = rows(s, t)
                if last + first == 0:
                    continue
                if t in self.local_ranks:
                    shapes[(s, t)] = (width, last + first)
                if s in self.local_ranks:
                    sends[(s, t)] = torch.cat(
                        [torch.cat([a[s][:, b - last:], a[s][:, :first]], dim=1)
                         for a in arrays]).contiguous()
        got = self.exchange(sends, shapes)
        out = {}
        for t in self.local_ranks:
            prev, nxt = (t - 1) % d, (t + 1) % d
            empty = torch.empty((width, 0), dtype=torch.int64, device=self._flat[t])
            pre = got[(prev, t)][:, :before] if before else empty
            post = got[(nxt, t)][:, rows(nxt, t)[0]:] if after else empty
            out[t] = (pre, post)
        return out

    def scatter(self, full: torch.Tensor) -> list:
        """The sharded array of a (C, N) tensor that this process holds
        whole: each of its ranks' column block, copied to the rank's
        device."""
        b = full.shape[-1] // self.size
        if b * self.size != full.shape[-1]:
            raise ValueError(f"{full.shape[-1]} columns do not split over {self.size} ranks")
        return [full[..., r * b:(r + 1) * b].to(self._flat[r]).contiguous()
                if r in self.local_ranks else None for r in range(self.size)]

    def gather_list(self, shards: list) -> list:
        """Every rank's tensor (one shape for all ranks), in rank order, on
        this process's lead device; each process's lead gets them all."""
        shape = tuple(shards[self.local_ranks[0]].shape)
        leads = [self.lead_rank(q) for q in range(self.n_processes)]
        me = self.lead_rank(self.process_index)
        got = self.exchange({(s, l): shards[s] for s in self.local_ranks for l in leads},
                            {(s, me): shape for s in range(self.size)})
        return [got[(s, me)] for s in range(self.size)]

    def gather(self, shards: list) -> torch.Tensor:
        """The whole array of a sharded one, on this process's lead device."""
        return torch.cat(self.gather_list(shards), dim=-1)


def proof_mesh(devices=None, hosts=None) -> Mesh:
    """The proof mesh (ref distributed.py:58).  One process: a ("ici",) mesh
    over `devices` (default every card; it raises without one), or with
    hosts=k a ("dcn", "ici") mesh of k rows, the shape the reference's
    tests model two hosts with.  Processes wired by init_distributed: a
    ("dcn", "ici") mesh with one row per process, this process driving
    `devices` (default its current card)."""
    n_proc, proc = _world()
    if n_proc > 1:
        if hosts not in (None, n_proc):
            raise ValueError(f"hosts={hosts} on a mesh of {n_proc} processes")
        local = [_device(x) for x in (devices if devices is not None else [_card()])]
        grid = [[None] * len(local) for _ in range(n_proc)]
        grid[proc] = local
        return Mesh(grid, ("dcn", "ici"), process_index=proc, n_processes=n_proc)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(_card_count())]
    devs = [_device(x) for x in devices]
    if hosts is None or hosts <= 1:
        return Mesh(devs, ("ici",))
    if len(devs) % hosts:
        raise ValueError(f"{len(devs)} devices do not divide evenly over {hosts} hosts")
    return Mesh(np.array(devs, dtype=object).reshape(hosts, len(devs) // hosts),
                ("dcn", "ici"))


def _card_count() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices= to build a mesh of CPU ranks")
    return torch.cuda.device_count()


def _card() -> torch.device:
    _card_count()
    return torch.device("cuda", torch.cuda.current_device())


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, timeout_s=300.0):
    """Wire this process into a mesh of processes (ref distributed.py:34).
    A no-op when torch.distributed is already initialised, or with no
    coordinator and at most one process.  Otherwise
    torch.distributed.init_process_group at the coordinator
    ("host:port" or a URL such as "tcp://localhost:29500"): gloo where no
    card is present, else NCCL, with this process on card
    process_id % device_count.  An explicit request that fails raises."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes in (None, 1):
            return
        raise ValueError(f"{num_processes} processes need a coordinator address")
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
