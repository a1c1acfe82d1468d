"""The model axis: each rank keeps its chunk of the parameters the JAX rule
shards, and the products run column-parallel (counterpart of what GSPMD does
for `diffroll_tpu/parallel/mesh.py::param_sharding`).

`shard_module(net, mesh, optimizer)` applies the rule
(`compat.torch_ckpt.param_sharding`: a parameter is sharded iff its JAX
leaf's trailing, output-channel, dimension divides the model axis) and
replaces every such parameter by its rank's contiguous chunk, slicing the
optimizer's state (Adam's moments, f32 or bf16) alike. Then:

  * every `Linear`, `Conv1d`, `Conv2d` and `ConvTranspose2d` whose weight is
    sharded computes only its output channels from the whole input, and the
    outputs are concatenated over the model group (the module's class is
    swapped for a subclass that does so; `column` does the same for the
    products the port's blocks compute functionally);
  * the other sharded parameters (GroupNorm's scale and bias, `uncon_z`,
    `trainable_parameters`) are gathered before use (`full_param`);
  * the kernel routes read the whole weights: `full_view(net)` puts the
    gathered parameters in place of the chunks for its duration (the
    products then compute whole), as XLA hands a `pallas_call` the gathered
    weights.

The gradients come from one `torch.autograd.Function` pair, Megatron's:
`_Gather`'s backward is the rank's slice, since every model rank holds the
same cotangent (an all-gather that summed on the way back would give
gradients `model` times too large); `_Copy` is the identity whose backward
sums the input's gradient over the model group, because a column-parallel
product gives each rank only its channels' share of it. Both are built on
`all_reduce` alone (`Mesh.gather_model`, `Mesh.all_reduce_model`).

Checkpoints hold whole tensors: `full_state_dict` and `full_optimizer_state`
gather the chunks (every rank of the mesh calls them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh


@dataclasses.dataclass
class _Shard:
    """A module's sharded parameters: leaf -> (the dim carrying the model
    axis, the whole parameter's shape)."""

    mesh: Mesh
    leaves: Dict[str, Tuple[int, torch.Size]]


def _shard(module: nn.Module) -> Optional[_Shard]:
    return module.__dict__.get("_model_shard")


def is_chunk(module: nn.Module, leaf: str) -> bool:
    """Whether `module.<leaf>` is currently this rank's chunk (not whole)."""
    s = _shard(module)
    return s is not None and leaf in s.leaves and \
        getattr(module, leaf).shape != s.leaves[leaf][1]


def is_sharded(net: nn.Module) -> bool:
    return any(_shard(m) is not None for m in net.modules())


class _Gather(torch.autograd.Function):
    """The model group's chunks along `dim` -> the whole tensor; backward:
    this rank's slice of the (model-replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.gather_model(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.chunk(g, ctx.dim).contiguous(), None, None


class _Copy(torch.autograd.Function):
    """The identity; backward: the sum over the model group (the input of a
    column-parallel product gets a share of its gradient on each rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_model(g), None


def gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return _Gather.apply(x, dim, mesh)


def full_param(module: nn.Module, leaf: str) -> torch.Tensor:
    """`module.<leaf>` whole: gathered over the model group where it is a
    chunk (its gradient then flows back to the chunk)."""
    p = getattr(module, leaf)
    if not is_chunk(module, leaf):
        return p
    s = _shard(module)
    return gather(p, s.leaves[leaf][0], s.mesh)


def column(module: nn.Module, x: torch.Tensor,
           compute: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
           dim: int) -> torch.Tensor:
    """`compute(x, module.weight, module.bias)`, column-parallel where the
    weight is this rank's chunk of output channels: the chunk's outputs from
    the whole input, concatenated over the model group along the output's
    channel dim `dim`."""
    if not is_chunk(module, "weight"):
        return compute(x, module.weight, module.bias)
    mesh = _shard(module).mesh
    return gather(compute(_Copy.apply(x, mesh), module.weight, module.bias), dim, mesh)


# ---------------------------------------------------------------- modules

class _ColumnLinear:
    def forward(self, x):
        return column(self, x, F.linear, -1)


class _ColumnConv:
    """Conv1d / Conv2d: `_conv_forward` is what their `forward` (and a
    subclass's, e.g. the U-Net's padded `Downsample`) calls. A grouped conv's
    chunk of output channels reads its groups' input channels."""

    def _conv_forward(self, x, weight, bias):
        fn = F.conv1d if isinstance(self, nn.Conv1d) else F.conv2d
        if not is_chunk(self, "weight"):
            return fn(x, weight, bias, self.stride, self.padding, self.dilation, self.groups)
        mesh = _shard(self).mesh
        if self.groups > 1 and self.groups % mesh.model:
            raise ValueError(f"{self.groups} groups do not split over a model axis of "
                             f"{mesh.model}")

        groups = self.groups // mesh.model if self.groups > 1 else 1

        def compute(v, w, b):
            if self.groups > 1:
                v = mesh.chunk(v, 1)   # the chunk's groups read their own input channels
            return fn(v, w, b, self.stride, self.padding, self.dilation, groups)

        return column(self, x, compute, 1)


class _ColumnConvTranspose2d:
    def forward(self, x):
        def compute(v, w, b):
            return F.conv_transpose2d(v, w, b, self.stride, self.padding, self.output_padding,
                                      self.groups, self.dilation)

        return column(self, x, compute, 1)


class _GatheredGroupNorm:
    def forward(self, x):
        return F.group_norm(x, self.num_groups, full_param(self, "weight"),
                            full_param(self, "bias"), self.eps)


_MIXINS = ((nn.Linear, _ColumnLinear), (nn.Conv1d, _ColumnConv), (nn.Conv2d, _ColumnConv),
           (nn.ConvTranspose2d, _ColumnConvTranspose2d), (nn.GroupNorm, _GatheredGroupNorm))
_CLASSES: Dict[type, type] = {}


def _column_class(cls: type) -> Optional[type]:
    """`cls` with its product (or norm) made model-parallel; None for a
    module whose sharded parameters its owner reads through `full_param`."""
    for base, mixin in _MIXINS:
        if issubclass(cls, base):
            if cls not in _CLASSES:
                _CLASSES[cls] = type(f"ModelParallel{cls.__name__}", (mixin, cls), {})
            return _CLASSES[cls]
    return None


def shard_module(net: nn.Module, mesh: Mesh,
                 optimizer: Optional[torch.optim.Optimizer] = None) -> Dict[str, int]:
    """Rank 0's whole weights on every rank, then this rank's chunk of
    every parameter the JAX rule shards over `mesh.model`, in place; the
    optimizer's parameters and their state (whole tensors of the
    parameter's shape: Adam's moments) are sliced alike. Returns {name:
    dim} of the sharded parameters."""
    from ..compat.torch_ckpt import param_sharding

    rule = param_sharding(net, mesh.model)
    if not rule:
        return rule
    mesh.broadcast_module(net)
    whole: Dict[int, Tuple[nn.Parameter, int, torch.Size]] = {}   # id(whole) -> (chunk, dim, shape)
    modules = dict(net.named_modules())
    for name, dim in rule.items():
        mname, _, leaf = name.rpartition(".")
        mod = modules[mname]
        old = mod._parameters[leaf]
        chunk = nn.Parameter(mesh.chunk(old.detach(), dim).clone(),
                             requires_grad=old.requires_grad)
        mod._parameters[leaf] = chunk
        whole[id(old)] = (chunk, dim, old.shape)
        s = _shard(mod)
        if s is None:
            s = _Shard(mesh, {})
            mod.__dict__["_model_shard"] = s
            cls = _column_class(type(mod))
            if cls is not None:
                mod.__class__ = cls
        s.leaves[leaf] = (dim, old.shape)
    if optimizer is not None:
        for group in optimizer.param_groups:
            group["params"] = [whole[id(p)][0] if id(p) in whole else p
                               for p in group["params"]]
        old_state, optimizer.state = optimizer.state, defaultdict(dict)
        for p, st in old_state.items():
            if id(p) in whole:
                p, dim, shape = whole[id(p)]
                st = {k: (mesh.chunk(v, dim).clone()
                          if torch.is_tensor(v) and v.shape == shape else v)
                      for k, v in st.items()}
            optimizer.state[p] = st
    return rule


def _sharded_leaves(net: nn.Module) -> Iterator[Tuple[nn.Module, str, int]]:
    for mod in net.modules():
        s = _shard(mod)
        if s is not None:
            for leaf, (dim, _) in s.leaves.items():
                yield mod, leaf, dim


@contextlib.contextmanager
def full_view(net: nn.Module):
    """Within: every sharded parameter of `net` reads whole (gathered over
    the model group, its gradient flowing back to the chunk), so the
    products compute whole and the kernel operands are built from whole
    weights. A no-op for a whole net, and inside another `full_view`."""
    swapped = []
    try:
        for mod, leaf, dim in _sharded_leaves(net):
            if is_chunk(mod, leaf):
                p = mod._parameters[leaf]
                mod._parameters[leaf] = gather(p, dim, _shard(mod).mesh)
                swapped.append((mod, leaf, p))
        yield net
    finally:
        for mod, leaf, p in swapped:
            mod._parameters[leaf] = p


def full_tensors(net: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-parameter tensors of `net`'s chunks' shapes (its parameters, an
    EMA, gradients) -> whole ones, gathered (every rank of the model group
    calls it); names that are not sharded pass as they are."""
    out = {}
    with torch.no_grad():
        for name, v in tensors.items():
            mname, _, leaf = name.rpartition(".")
            mod = net.get_submodule(mname)
            s = _shard(mod)
            if s is not None and leaf in s.leaves and tuple(v.shape) != tuple(s.leaves[leaf][1]):
                v = s.mesh.gather_model(v.contiguous(), s.leaves[leaf][0])
            out[name] = v
    return out


def full_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """`net.state_dict()` with every chunk gathered whole."""
    return full_tensors(net, net.state_dict())


def full_optimizer_state(optimizer: torch.optim.Optimizer, net: nn.Module) -> Dict:
    """`optimizer.state_dict()` with every moment of a sharded parameter
    gathered whole: the state a single process would hold. The optimizer's
    parameters must be `net.parameters()`, in order."""
    sd = optimizer.state_dict()
    names = [n for n, _ in net.named_parameters()]
    params = dict(net.named_parameters())
    state = {}
    for idx, st in sd["state"].items():
        name = names[idx]
        p = params[name]
        state[idx] = {k: (full_tensors(net, {name: v})[name]
                          if torch.is_tensor(v) and v.shape == p.shape else v)
                      for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}
