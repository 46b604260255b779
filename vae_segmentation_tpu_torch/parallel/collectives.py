"""The mesh's collectives (counterparts of the JAX package's ``ppermute``,
``psum``, ``pmean`` and GSPMD's gathers), each a ``torch.autograd.Function``:

  * ``halo_exchange(x, mesh)``: x [B, d, ...] -> [B, d + 2, ...], the slab
    with the planes either side of it from the neighbouring 'spatial'
    ranks (zeros past the volume's edge); the backward sends the halo
    planes' gradients back to their owners, which add them;
  * ``spatial_sum`` / ``data_sum`` / ``data_mean``: an all-reduce over the
    row / column whose backward is the same all-reduce;
  * ``gather_spatial`` (on D) and ``gather_data`` (on the batch): an
    all-gather whose backward is a reduce-scatter;
  * ``mean_grads``: the gradients of a parameter list averaged over the
    mesh in one fixed-order flat all-reduce (every rank's flat gradient
    gathered, then added in rank order), the same bits on every rank.

Gradient convention. The loss on every rank is the exact loss of the
global batch (the losses gather what they need). Each collective takes its
standard adjoint, and backward starts from that replicated loss on every
rank: the gradient each rank gets is that of the sum of the ranks' losses
with respect to its own copy of the parameters, which the replicated and
the sharded stages alike reach through the collectives' adjoints. Those
copies are equal, so the sum over ranks of their gradients is the mesh
size times the one-process gradient, and one mean over the mesh's ranks
(``mean_grads``) gives every parameter the one-process gradient. A
collective whose backward were the identity would break this by a factor
of n_spatial or n_data (tests/test_torch_collectives.py,
tests/test_torch_dist_step.py).

Transport, by ``dist.get_backend()``: under NCCL the exchanges are
``batch_isend_irecv`` and the gathers and reductions NCCL's collectives on
the card; under gloo, which takes CUDA tensors only for all-reduce and
broadcast, the exchanges and gathers of CUDA tensors go through host
buffers. ``describe`` says which, and the first collective of a run
prints it once.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from vae_segmentation_tpu_torch.parallel.sharding import Mesh

_ANNOUNCED = set()


def describe(backend: str, device_type: str) -> str:
    """The transport the collectives take for tensors on `device_type`
    under `backend`."""
    if backend == "nccl":
        return "nccl: exchanges by batch_isend_irecv, gathers and " \
               "reductions by NCCL collectives on the card"
    if device_type == "cuda":
        return "gloo: all-reduce on the card; exchanges and gathers " \
               "through host buffers"
    return "gloo: every collective on host tensors"


def _announce(t: torch.Tensor) -> str:
    backend = dist.get_backend()
    key = (backend, t.device.type)
    if key not in _ANNOUNCED:
        _ANNOUNCED.add(key)
        print(f"collectives: {describe(backend, t.device.type)}",
              flush=True)
    return backend


def _host(t: torch.Tensor, backend: str) -> bool:
    """Whether `t` goes through a host buffer (gloo and a CUDA tensor)."""
    return backend != "nccl" and t.is_cuda


# ---- transports (no autograd)

def _all_reduce(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Sum of `t` over `group` (n ranks), in a new tensor."""
    out = t.detach().clone().contiguous()
    if n > 1:
        _announce(out)
        dist.all_reduce(out, group=group)
    return out


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *t.shape]: every rank's `t`, in the group's rank order."""
    t = t.detach().contiguous()
    if n == 1:
        return t[None].clone()
    backend = _announce(t)
    if _host(t, backend):
        h = t.cpu()
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.stack(parts).to(t.device)
    if backend == "nccl":
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def _reduce_scatter(t: torch.Tensor, group, n: int, index: int
                    ) -> torch.Tensor:
    """Part `index` of the sum over `group` of `t` [n, ...]."""
    t = t.detach().contiguous()
    if n == 1:
        return t[0].clone()
    backend = _announce(t)
    if backend == "nccl":
        out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=group)
        return out
    return _all_reduce(t, group, n)[index].clone()


def _exchange(mesh: Mesh, to_prev: torch.Tensor, to_next: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send `to_prev` to the previous rank of the data row and `to_next` to
    the next; returns (from the previous, from the next), zeros at an edge
    of the row."""
    i, ranks = mesh.spatial_index, mesh.row_ranks
    prev = ranks[i - 1] if i > 0 else None
    nxt = ranks[i + 1] if i + 1 < len(ranks) else None
    from_prev = torch.zeros_like(to_prev)
    from_next = torch.zeros_like(to_next)
    if prev is None and nxt is None:
        return from_prev, from_next
    backend = _announce(to_prev)
    host = _host(to_prev, backend)
    bufs = [b.detach().cpu() if host else b.detach().contiguous()
            for b in (to_prev, to_next, from_prev, from_next)]
    ops = []
    if prev is not None:
        ops += [dist.P2POp(dist.isend, bufs[0], prev, mesh.spatial_group),
                dist.P2POp(dist.irecv, bufs[2], prev, mesh.spatial_group)]
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, bufs[1], nxt, mesh.spatial_group),
                dist.P2POp(dist.irecv, bufs[3], nxt, mesh.spatial_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        return bufs[2].to(to_prev.device), bufs[3].to(to_next.device)
    return bufs[2], bufs[3]


# ---- the differentiable collectives

class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        lo, hi = _exchange(mesh, x[:, :1], x[:, -1:])
        return torch.cat([lo, x, hi], dim=1)

    @staticmethod
    def backward(ctx, g):
        # the halo planes' gradients belong to the neighbours' boundary
        # planes: send them back, add what comes back to ours
        from_prev, from_next = _exchange(ctx.mesh, g[:, :1], g[:, -1:])
        gx = g[:, 1:-1].clone()
        gx[:, :1] += from_prev
        gx[:, -1:] += from_next
        return gx, None


def halo_exchange(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [B, d, ...] (this rank's D planes) -> [B, d + 2, ...]: the
    previous rank's last plane, x, the next rank's first plane; zeros at
    the volume's edges (the 3^3 conv's SAME padding)."""
    return _Halo.apply(x.contiguous(), mesh)


def halo_dlim(mesh: Mesh, d2: int) -> Tuple[int, int]:
    """The valid plane range of this rank's halo slab of d2 planes: an
    edge slab's missing neighbour is no plane of the volume (the JAX
    package's ``stencil_shard_wrap_pre``)."""
    first = mesh.spatial_index == 0
    last = mesh.spatial_index == mesh.n_spatial - 1
    return (1 if first else 0), (d2 - 2 if last else d2 - 1)


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n, scale):
        ctx.group, ctx.n, ctx.scale = group, n, scale
        out = _all_reduce(x, group, n)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        out = _all_reduce(g, ctx.group, ctx.n)
        return (out * ctx.scale if ctx.scale != 1.0 else out), None, None, \
            None


def spatial_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over this rank's data row (the 'spatial' psum)."""
    return _AllReduce.apply(x, mesh.spatial_group, mesh.n_spatial, 1.0)


def data_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over this rank's spatial column."""
    return _AllReduce.apply(x, mesh.data_group, mesh.n_data, 1.0)


def data_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of `x` over this rank's spatial column (the 'data'
    pmean)."""
    return _AllReduce.apply(x, mesh.data_group, mesh.n_data,
                            1.0 / mesh.n_data)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.group, ctx.n, ctx.index, ctx.dim = group, n, index, dim
        parts = _all_gather(x, group, n)          # [n, *x.shape]
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.stack(g.chunk(ctx.n, dim=ctx.dim))
        return _reduce_scatter(parts, ctx.group, ctx.n, ctx.index), None, \
            None, None, None


def gather_spatial(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's D planes [B, d, ...] -> the whole volume [B, d n, ...]
    on every rank of the data row."""
    return _Gather.apply(x, mesh.spatial_group, mesh.n_spatial,
                         mesh.spatial_index, 1)


def gather_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's items [b, ...] -> the global batch [b n, ...] on every
    rank of the spatial column."""
    return _Gather.apply(x, mesh.data_group, mesh.n_data, mesh.data_index, 0)


@torch.no_grad()
def mean_grads(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Replace the gradient of every parameter in `params` that has one by
    its mean over the mesh's ranks: one flat vector a rank, gathered and
    added in rank order (a fixed order, so every rank holds the same
    bits), then divided by the mesh size."""
    params = [p for p in params if p.grad is not None]
    if not params or mesh.size == 1:
        return
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    parts = _all_gather(flat, mesh.group, mesh.size)
    total = parts[0].clone()
    for i in range(1, mesh.size):
        total += parts[i]
    total /= mesh.size
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(total[off:off + n].view_as(p.grad))
        off += n


def global_sums(sums: torch.Tensor, like: torch.Tensor,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """Per-item partial sums [b, ...] of a rank's slice `like` -> the
    global batch's sums [B, ...] on every rank: summed over the data row
    when `like` is split on D, then gathered over the column. Unchanged
    without a mesh."""
    if mesh is None:
        return sums
    from vae_segmentation_tpu_torch.parallel.sharding import spatial_mesh

    if spatial_mesh(like) is not None:
        sums = spatial_sum(sums, mesh)
    return gather_data(sums, mesh)

