"""The data axis under `torch.distributed` (counterpart of
`diffroll_tpu/parallel/mesh.py` and `cli/_common.py::setup_mesh`).

The JAX package runs one controller over a (data, model) device mesh and
lets XLA insert the gradient reduction. The port runs one process per GPU:
launched by `torchrun --nproc_per_node=N python -m diffroll_tpu_torch <verb>
... trainer.data_axis=N`, or an entry called inside a process group the
caller has already initialised (any backend). `setup_mesh` initialises the
group where it is not up (NCCL for CUDA, gloo for the CPU) and returns a
`DataMesh`; a process outside any launched group gets None, and every path
runs as it does on one device.

How the ranks share the work (`DataMesh` carries the rank and the size):
  * batches: every rank walks the same global batches; rank r keeps rows
    r::size of each (`data/pipeline.DataLoader(process_index, process_count)`
    for the train and validation splits; the evaluation entries load the
    whole batch and stripe it themselves);
  * draws: every rank draws the GLOBAL batch's t, noise, dropout mask, x_T
    and per-step noise from the same seeded generator and keeps its stripe,
    as JAX's single controller draws one global array, so a data-parallel
    step equals the single-process step on the same global batch;
  * gradients: averaged over the ranks after `backward`, in buckets of
    `BUCKET_ELEMS` (`average_gradients`), on every training route; the
    tasks call the net outside a module `forward`, so a
    `DistributedDataParallel` wrapper would never see the graph;
  * results: the sampled rolls are gathered to rank 0 as CPU objects (gloo
    covers only all-reduce and broadcast on CUDA tensors), and only rank 0
    writes files.
The model axis is not ported: `model_axis > 1` raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS_ITEM = ("ROADMAP Queue 1, item 25 (the model axis: tensor parallelism over "
                   "output channels)")
BUCKET_ELEMS = 1 << 23   # 32 MiB of f32 gradients per all-reduce


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis."""

    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def stripe(self, x):
        """Rows rank::size of a global batch (a tensor or an array)."""
        return x[self.rank::self.size]

    def rows(self, n: int) -> int:
        """This rank's rows of a global batch of n."""
        return len(range(self.rank, n, self.size))

    def global_rows(self, batch: Any, local_rows: int) -> int:
        """The rows of the global batch whose stripe `batch` is: the
        loader's `global_rows`, else a full batch of `local_rows` a rank."""
        first = batch[0] if isinstance(batch, (tuple, list)) else batch
        if isinstance(first, dict) and "global_rows" in first:
            return int(first["global_rows"])
        return local_rows * self.size

    def average_gradients(self, params: Sequence[torch.nn.Parameter],
                          extras: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Dict[str, torch.Tensor]:
        """All-reduce every parameter's gradient to its mean over the ranks,
        in place, bucketed. A parameter without a gradient here counts as a
        zero one where another rank has one, and stays without one where no
        rank has. `extras` (scalars, e.g. the losses) are averaged in the
        last bucket and returned."""
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
            dist.all_reduce(flat)
            off = 0
            for i in idx:
                p, k = params[i], params[i].numel()
                p.grad = (flat[off: off + k] / self.size).view_as(p).to(p.dtype)
                off += k
            if last:
                has = (flat[off: off + len(params)] > 0).tolist()  # one host read
                for p, h in zip(params, has):
                    if not h:
                        p.grad = None
                vals = flat[off + len(params):] / self.size
                return {k: vals[j] for j, k in enumerate(extras)}
        return {}

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x)
        return x

    def gather_rows(self, part: np.ndarray) -> Optional[np.ndarray]:
        """Every rank's stripe (its rows rank::size of a global batch) ->
        the global batch on rank 0, None elsewhere."""
        parts: Optional[List[Any]] = [None] * self.size if self.is_main else None
        dist.gather_object(part, parts, dst=0)
        if not self.is_main:
            return None
        n = sum(len(p) for p in parts)
        out = np.empty((n,) + part.shape[1:], part.dtype)
        for r, p in enumerate(parts):
            out[r::self.size] = p
        return out

    def sample_stripes(self, sample_fn, x_T: torch.Tensor, waveform=None, roll_cond=None,
                       noise=None) -> Optional[torch.Tensor]:
        """A task's reverse process over the data axis: `sample_fn(x_T,
        waveform, roll_cond, noise=...)` on this rank's rows of the global
        batch (x_T, the conditioning and the per-step noise (n, B, ...)),
        the rolls gathered to rank 0 as one CPU tensor; None elsewhere. A
        rank without rows samples nothing."""
        part = x_T[:0]
        if self.rows(x_T.shape[0]):
            st = lambda v: None if v is None else self.stripe(v)  # noqa: E731
            part, _ = sample_fn(st(x_T), st(waveform), st(roll_cond),
                                noise=None if noise is None else noise[:, self.rank::self.size])
        out = self.gather_rows(part.cpu().numpy())
        return None if out is None else torch.from_numpy(out)

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


def setup_mesh(cfg, device: torch.device) -> Optional[DataMesh]:
    """The data axis for `cfg.trainer.data_axis` / `model_axis` on
    `device` (the entry's `device=`), or None outside a launched group.

    `data_axis` None means the world size; any other value must equal it,
    and the train batch must divide by it: the JAX package narrows the axis
    silently where they differ, but a process cannot be dropped from a
    launched group. On CUDA rank r takes card LOCAL_RANK (r where unset),
    modulo the cards present."""
    t = cfg.trainer
    if t.model_axis > 1:
        raise NotImplementedError(f"trainer.model_axis={t.model_axis}: the model axis is not "
                                  f"ported yet ({MODEL_AXIS_ITEM}); use model_axis=1")
    if t.model_axis < 1:
        raise ValueError(f"trainer.model_axis={t.model_axis} must be >= 1")
    if not launched():
        if t.data_axis not in (None, 1):
            raise ValueError(f"trainer.data_axis={t.data_axis} needs {t.data_axis} processes: "
                             f"launch with torchrun --nproc_per_node={t.data_axis}")
        return None
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    rank, size = dist.get_rank(), dist.get_world_size()
    if t.data_axis is not None and t.data_axis != size:
        raise ValueError(f"trainer.data_axis={t.data_axis} but the process group has {size} "
                         f"ranks; they must be equal (or leave data_axis unset)")
    bs = cfg.dataloader.train_batch_size
    if bs % size:
        raise ValueError(f"dataloader.train_batch_size={bs} does not divide over the data "
                         f"axis of {size} ranks")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    return DataMesh(rank=rank, size=size, device=device, backend=str(dist.get_backend()))
