"""Data parallelism over ``torch.distributed`` (port of ``gennet_tpu.train.mesh``).

The reference shard_maps its train steps over a 1-D ``"data"`` mesh: the
bank's rows are split in contiguous blocks (``P("data")``), the state is
replicated, and the gradients are ``pmean``-ed. The port runs one process
per rank instead, and :class:`DataMesh` is what a rank knows of the others:
the world size, its rank, its device, and the few collectives the training
steps need. Each reduction is one all-reduce of one flat buffer. There is
no ``DistributedDataParallel`` (its gradient hooks would also reduce D's
gradients during the G step, which backpropagates through D) and no
``SyncBatchNorm`` (the reference normalises each shard with its own batch
statistics and averages the running statistics after the step).

Random streams: rank 0 draws from the very stream a run without data
parallelism uses, and rank r > 0 from :func:`rank_seed` (seed, r). So a
world of 1 reproduces the plain run bit for bit. (The reference folds the
key by the device index, device 0 included: a divergence by design.)
"""

import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

# rank r > 0 seeds its streams with (seed + r · stride) mod 2^32: the CPU
# generator keeps 32 bits of a seed, and the stride keeps the rank streams
# far from the small offsets (seed + 1, + 2, + 3, + 7, + 1000 + k) the
# workloads use for their other streams
RANK_SEED_STRIDE = 0x9E3779B9


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s stream: ``seed`` itself on rank 0."""
    return seed if rank == 0 else (seed + rank * RANK_SEED_STRIDE) % 2**32


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`rank_seed`."""
    return torch.Generator(device=device).manual_seed(rank_seed(seed, rank))


def check_rows(n_rows: int, world: int, what: str):
    """Refuse a split of ``n_rows`` rows over ``world`` ranks that is not
    even, as the reference's ``shard_map`` does (``ValueError: ... not
    evenly divisible``)."""
    if n_rows % world:
        raise ValueError(
            f"{what} has {n_rows} rows, which do not divide over a world of {world} ranks: "
            f"each rank trains on one contiguous block of rows, and the reference's jax.shard_map "
            f"refuses the same split with 'ValueError: ... not evenly divisible'")


def running_stats(*modules) -> list:
    """The BatchNorm running means and variances of ``modules`` (never a
    step count)."""
    return [b for m in modules for name, b in m.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")]


@dataclass
class DataMesh:
    """One rank's view of a data-parallel world (the default process group)."""

    world: int
    rank: int
    device: torch.device
    backend: str
    _store_dir: str | None = None   # file:// store of an in-process world of 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _host(self) -> bool:
        """Whether collectives other than all-reduce and broadcast must go
        through host tensors (gloo's other collectives take CPU tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def pmean_(self, tensors):
        """Average ``tensors`` (same dtype; ``None`` entries skipped) across
        the ranks in place: one all-reduce of one flat buffer, then a divide
        by the world size. The copies back bump each tensor's version."""
        tensors = [t for t in tensors if t is not None]
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        flat /= self.world
        self._unflatten_(flat, tensors)

    def broadcast_(self, tensors, src: int = 0):
        """Overwrite ``tensors`` with rank ``src``'s values: one broadcast of
        one flat buffer, copied back under ``no_grad`` so that every
        tensor's version counter moves (the conv kernel's weight-pack cache
        keys on it)."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src)
        self._unflatten_(flat, tensors)

    @staticmethod
    def _unflatten_(flat, tensors):
        off = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                t.copy_(flat[off : off + n].view_as(t))
                off += n

    def broadcast_modules_(self, *modules):
        """Rank 0's parameters and buffers onto every rank."""
        for m in modules:
            self.broadcast_(list(m.parameters()) + [b for b in m.buffers()
                                                    if b.is_floating_point()])

    def decide(self, value):
        """Rank 0's ``value`` (any picklable object) on every rank."""
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather_objects(self, value) -> list:
        """Every rank's ``value``, by rank, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, value)
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' row blocks of equal size, concatenated by rank, on
        every rank."""
        src = x.cpu() if self._host() else x
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src.contiguous())
        return torch.cat(parts).to(x.device)

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of ``x``'s rows, as ``P("data")``
        splits them; raises ``ValueError`` when the rows do not divide."""
        check_rows(x.shape[0], self.world, "the array to shard")
        k = x.shape[0] // self.world
        return x[self.rank * k : (self.rank + 1) * k]

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self):
        """Destroy the process group (and an in-process world's store)."""
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def rank_device(device, local: int, torchrun: bool) -> torch.device:
    """The device of the rank whose index on its host is ``local``. Under
    torchrun a CUDA rank runs on ``cuda:local``; a device naming another
    card is refused, since every rank would pin that one card (NCCL fails
    with "Duplicate GPU"). Otherwise an index-less CUDA device is
    ``cuda:local``. A CPU device is itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if torchrun and dev.index is not None and dev.index != local:
        raise ValueError(f"--device {dev} under torchrun: the rank with LOCAL_RANK {local} runs "
                         f"on cuda:{local}; pass --device cuda and each rank takes its own card")
    return dev if dev.index is not None else torch.device("cuda", local)


def init_data_mesh(device, backend: str | None = None, *, world: int | None = None,
                   rank: int | None = None, init_method: str | None = None,
                   timeout: timedelta | None = None, command: str = "") -> DataMesh:
    """Join (or make) the data-parallel world and return this rank's mesh.

    - Under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set),
      the world is torchrun's and each rank runs on ``cuda:LOCAL_RANK``
      (:func:`rank_device`).
    - A library caller may pass ``world``, ``rank`` and ``init_method``
      itself (and ``backend="gloo"`` to put two ranks on one card).
    - Otherwise the world is this process alone, joined through a
      ``file://`` store in a temporary directory (no port is taken). On a
      host with more cards than that, one line names the idle cards and
      the ``torchrun`` command that would use them; the run still does
      exactly what was asked.

    The backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` says otherwise.
    """
    env = os.environ
    store_dir = None
    torchrun = world is None and "WORLD_SIZE" in env and "RANK" in env
    if torchrun:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", rank))
        init_method = "env://"
    elif world is None:
        world, rank, local = 1, 0, 0
        store_dir = tempfile.mkdtemp(prefix="gennet_mesh_")
        init_method = f"file://{os.path.join(store_dir, 'store')}"
    else:
        if rank is None or init_method is None:
            raise ValueError("init_data_mesh: an explicit world needs rank and init_method too")
        local = 0
    dev = rank_device(device, local, torchrun)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not torchrun and store_dir is not None and dev.type == "cuda":
        n = torch.cuda.device_count()
        if n > world:
            idle = ", ".join(f"cuda:{i}" for i in range(n) if i != dev.index)
            print(f"data parallel: a world of {world} on {dev}; {idle} stay idle. To use all "
                  f"{n} cards: torchrun --standalone --nproc_per_node={n} -m "
                  f"gennet_tpu_torch.cli.main {command or '<command>'} ... --data-parallel",
                  flush=True)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    return DataMesh(world=world, rank=rank, device=dev, backend=backend, _store_dir=store_dir)


def is_main(mesh: DataMesh | None) -> bool:
    """True on rank 0, and in a run without a mesh."""
    return mesh is None or mesh.rank == 0
