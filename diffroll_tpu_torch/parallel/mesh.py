"""The (data, model) mesh under `torch.distributed` (counterpart of
`diffroll_tpu/parallel/mesh.py` and `cli/_common.py::setup_mesh`).

The JAX package runs one controller over a (data, model) device mesh and
lets XLA insert the collectives. The port runs one process per GPU:
launched by `torchrun --nproc_per_node=N python -m diffroll_tpu_torch <verb>
... trainer.model_axis=M`, or an entry called inside a process group the
caller has already initialised (any backend). `setup_mesh` initialises the
group where it is not up (NCCL for CUDA, gloo for the CPU) and returns a
`Mesh`; a process outside any launched group gets None, and every path
runs as it does on one device.

Rank r sits at (data index r // model, model index r % model), as
`make_mesh` reshapes its devices. The ranks of one data index form a model
group; the ranks of one model index, a data group.

How the ranks share the work:
  * batches: every rank walks the same global batches; the ranks of data
    index d keep rows d::data of each (`data/pipeline.DataLoader
    (process_index, process_count)` for the train and validation splits;
    the evaluation entries load the whole batch and stripe it themselves);
  * draws: every rank draws the GLOBAL batch's t, noise, dropout mask, x_T
    and per-step noise from the same seeded generator and keeps its data
    stripe, as JAX's single controller draws one global array, so a step
    over the mesh equals the single-process step on the same global batch;
  * parameters: with model > 1 each rank keeps its chunk of every parameter
    the JAX rule shards (`parallel/model_axis.py`); the products are
    column-parallel over the model group;
  * gradients: averaged over the data group after `backward`, in buckets
    of `BUCKET_ELEMS` (`average_gradients`), on every training route; the
    tasks call the net outside a module `forward`, so a
    `DistributedDataParallel` wrapper would never see the graph;
  * results: the sampled rolls are gathered from the model-index-0 rank of
    each data index, and only rank 0 writes files.
Every collective on tensors is an all-reduce or a broadcast (a gather is an
all-reduce of a zero buffer each rank fills its slot of), so gloo (the CPU,
and two ranks sharing one card: it moves only those two on CUDA tensors)
and NCCL run the same code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_ELEMS = 1 << 23   # 32 MiB of f32 gradients per all-reduce


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the (data, model) mesh. `data_group` and
    `model_group` are the process groups of its data and model axes (None:
    the whole world, where that axis spans it)."""

    rank: int
    data: int
    model: int
    device: torch.device
    backend: str
    data_group: Any = None
    model_group: Any = None

    def __deepcopy__(self, memo):
        # a deep-copied module keeps its place on the same groups
        return self

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def stripe(self, x):
        """Rows d::data of a global batch (a tensor or an array), d this
        rank's data index."""
        return x[self.data_index::self.data]

    def rows(self, n: int) -> int:
        """This rank's rows of a global batch of n."""
        return len(range(self.data_index, n, self.data))

    def global_rows(self, batch: Any, local_rows: int) -> int:
        """The rows of the global batch whose stripe `batch` is: the
        loader's `global_rows`, else a full batch of `local_rows` a stripe."""
        first = batch[0] if isinstance(batch, (tuple, list)) else batch
        if isinstance(first, dict) and "global_rows" in first:
            return int(first["global_rows"])
        return local_rows * self.data

    def average_gradients(self, params: Sequence[torch.nn.Parameter],
                          extras: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Dict[str, torch.Tensor]:
        """All-reduce every parameter's gradient to its mean over the data
        group, in place, bucketed (a model-sharded parameter's is its
        chunk's). A parameter without a gradient here counts as a zero one
        where another rank has one, and stays without one where no rank
        has. `extras` (scalars, e.g. the losses) are averaged in the last
        bucket and returned."""
        params = list(params)
        extras = dict(extras or {})
        flags = torch.tensor([float(p.grad is not None) for p in params],
                             device=params[0].device)
        tail = [flags] + [v.detach().float().reshape(1) for v in extras.values()]
        buckets: List[List[int]] = [[]]
        n = 0
        for i, p in enumerate(params):
            if buckets[-1] and n + p.numel() > BUCKET_ELEMS:
                buckets.append([])
                n = 0
            buckets[-1].append(i)
            n += p.numel()
        for bi, idx in enumerate(buckets):
            parts = [params[i].grad.reshape(-1).float() if params[i].grad is not None
                     else torch.zeros(params[i].numel(), device=params[i].device)
                     for i in idx]
            last = bi == len(buckets) - 1
            flat = torch.cat(parts + (tail if last else []))
            dist.all_reduce(flat, group=self.data_group)
            off = 0
            for i in idx:
                p, k = params[i], params[i].numel()
                p.grad = (flat[off: off + k] / self.data).view_as(p).to(p.dtype)
                off += k
            if last:
                has = (flat[off: off + len(params)] > 0).tolist()  # one host read
                for p, h in zip(params, has):
                    if not h:
                        p.grad = None
                vals = flat[off + len(params):] / self.data
                return {k: vals[j] for j, k in enumerate(extras)}
        return {}

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank (of a whole net)."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data group, in place (each stripe counted once)."""
        dist.all_reduce(x, group=self.data_group)
        return x

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's chunk of a tensor sharded on `dim` -> the whole
        tensor on every rank of the model group: an all-reduce of a zero
        buffer in which each rank fills its slot (adding zeros is exact).
        Low-precision chunks travel in f32."""
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.model
        wire = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
        buf = torch.zeros(shape, dtype=wire, device=x.device)
        buf.narrow(dim, self.model_index * n, n).copy_(x)
        dist.all_reduce(buf, group=self.model_group)
        return buf.to(x.dtype)

    def all_reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group (low precision summed in f32)."""
        wire = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
        buf = x.to(wire).contiguous().clone()
        dist.all_reduce(buf, group=self.model_group)
        return buf.to(x.dtype)

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This model index's contiguous chunk of `x` along `dim`."""
        n = x.shape[dim] // self.model
        return x.narrow(dim, self.model_index * n, n)

    def gather_stripes(self, part: torch.Tensor, n: int) -> torch.Tensor:
        """Every data stripe of a global batch of n rows -> the whole batch
        on every rank, on the device: an all-reduce of a zero buffer that
        the model-index-0 rank of each data index fills."""
        buf = torch.zeros((n,) + tuple(part.shape[1:]), dtype=part.dtype, device=part.device)
        if self.model_index == 0:
            buf[self.data_index::self.data] = part
        dist.all_reduce(buf)
        return buf

    def sample_stripes(self, sample_fn, x_T: torch.Tensor, waveform=None, roll_cond=None,
                       noise=None) -> Optional[torch.Tensor]:
        """A task's reverse process over the data axis: `sample_fn(x_T,
        waveform, roll_cond, noise=...)` on this rank's rows of the global
        batch (x_T, the conditioning and the per-step noise (n, B, ...)),
        the rolls gathered (`gather_stripes`) to rank 0 as one CPU tensor;
        None elsewhere. A rank without rows samples nothing."""
        part = x_T[:0]
        if self.rows(x_T.shape[0]):
            st = lambda v: None if v is None else self.stripe(v)  # noqa: E731
            part, _ = sample_fn(st(x_T), st(waveform), st(roll_cond),
                                noise=None if noise is None
                                else noise[:, self.data_index::self.data])
        out = self.gather_stripes(part, x_T.shape[0])
        return out.cpu() if self.is_main else None

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def close_group() -> None:
    """Destroy the process group, if one is up (the module entry's exit)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def launched() -> bool:
    """Whether this process belongs to a launched group: one initialised
    already, or a `torchrun` environment."""
    return dist.is_available() and (dist.is_initialized() or "WORLD_SIZE" in os.environ)


def _axis_groups(data: int, model: int, rank: int):
    """This rank's data and model groups. Every rank creates every group,
    in the same order, as `new_group` requires; an axis that spans the
    world is the default group (None), and a model axis of 1 has none."""
    data_group = model_group = None
    if model > 1:
        for j in range(model):
            g = dist.new_group([d * model + j for d in range(data)])
            if j == rank % model:
                data_group = g
        if data > 1:
            for d in range(data):
                g = dist.new_group([d * model + j for j in range(model)])
                if d == rank // model:
                    model_group = g
    return data_group, model_group


def setup_mesh(cfg, device: torch.device, train: bool = True) -> Optional[Mesh]:
    """The mesh for `cfg.trainer.data_axis` / `model_axis` on `device` (the
    entry's `device=`), or None outside a launched group.

    `data_axis` None means world // model_axis; otherwise data x model must
    equal the world size, and where the caller trains (`train`) its train
    batch must divide by the data axis: the JAX package narrows the axis
    silently where they differ, but a process cannot be dropped from a
    launched group. On CUDA rank r takes card LOCAL_RANK (r where unset),
    modulo the cards present."""
    t = cfg.trainer
    model = int(t.model_axis)
    if model < 1:
        raise ValueError(f"trainer.model_axis={model} must be >= 1")
    if not launched():
        need = (t.data_axis or 1) * model
        if need > 1:
            raise ValueError(f"trainer.data_axis={t.data_axis} x trainer.model_axis={model} "
                             f"needs {need} processes: launch with torchrun "
                             f"--nproc_per_node={need}")
        return None
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % model:
        raise ValueError(f"trainer.model_axis={model} does not divide the process group's "
                         f"{world} ranks")
    data = world // model if t.data_axis is None else int(t.data_axis)
    if data * model != world:
        raise ValueError(f"trainer.data_axis={t.data_axis} x trainer.model_axis={model} but "
                         f"the process group has {world} ranks; they must be equal (or leave "
                         f"data_axis unset)")
    bs = cfg.dataloader.train_batch_size
    if train and bs % data:
        raise ValueError(f"dataloader.train_batch_size={bs} does not divide over the data "
                         f"axis of {data} ranks")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    data_group, model_group = _axis_groups(data, model, rank)
    return Mesh(rank=rank, data=data, model=model, device=device,
                backend=str(dist.get_backend()), data_group=data_group,
                model_group=model_group)
