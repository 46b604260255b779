"""The port's ('data', 'spatial') mesh (counterpart of vae_segmentation_tpu/
parallel/sharding.py and cli/common.py::make_mesh_if_multichip).

The reference trains under single-process ``nn.DataParallel``
(main_source.py:354, main_target.py:436-438); the JAX package replaced it
with a device mesh whose 'data' axis splits the batch and whose 'spatial'
axis splits the volume's D axis. The port runs one process a rank
(``torch.distributed``) and lays the world's ranks out the same way:

  * ``Mesh``: an (n_data, n_spatial) grid of ranks, rank = data_index *
    n_spatial + spatial_index, with a process group for each data row (the
    ranks that split the D planes of the same items: the 'spatial'
    collectives) and each spatial column (the ranks that hold the same
    planes of other items: the 'data' collectives);
  * ``batch_shard``: a rank's slice of the global batch, its items and,
    under 'spatial', its D planes; ``replicate``: one module's parameters
    and buffers made equal on every rank of the mesh;
  * ``make_mesh_if_multichip``: the JAX package's sizing rule.

A model runs on its rank's slice. While a mesh is ``active`` (the train
steps), the shard wraps of ``models/blocks.py`` read it: a 5-D activation
is split over 'spatial' on D unless it is tagged replicated
(``mark_replicated``, where a stage's D does not split, as the JAX
package's wraps fall back to the unsharded op). Eval runs with no mesh
active, on one rank, as in one process.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """This rank's place in an (n_data, n_spatial) grid of the world's
    first n_data * n_spatial ranks. ``member`` is False on a rank outside
    the grid, which does no work."""

    n_data: int
    n_spatial: int
    rank: int
    member: bool
    data_index: int = 0
    spatial_index: int = 0
    backend: str = "gloo"
    # global ranks of this rank's data row / spatial column, in order
    row_ranks: List[int] = field(default_factory=list)
    col_ranks: List[int] = field(default_factory=list)
    spatial_group: object = None     # the row: 'spatial' collectives
    data_group: object = None        # the column: 'data' collectives
    group: object = None             # every rank of the grid

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def first_rank(self) -> bool:
        """Whether this is the grid's rank 0 (the one that writes)."""
        return self.member and self.rank == 0


def make_mesh(n_data: int, n_spatial: int = 1) -> Mesh:
    """The mesh over the world's first n_data * n_spatial ranks. Every
    rank of the world calls it (``new_group`` is collective); a rank past
    the grid gets ``member=False``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data < 1 or n_spatial < 1 or n_data * n_spatial > world:
        raise ValueError(f"mesh data={n_data} x spatial={n_spatial} does "
                         f"not fit a world of {world} ranks")
    mesh = Mesh(n_data=n_data, n_spatial=n_spatial, rank=rank,
                member=rank < n_data * n_spatial,
                backend=dist.get_backend())
    size = n_data * n_spatial
    mesh.group = dist.new_group(list(range(size))) if size < world \
        else dist.group.WORLD
    for d in range(n_data):
        ranks = [d * n_spatial + s for s in range(n_spatial)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mesh.row_ranks, mesh.spatial_group = ranks, g
            mesh.data_index, mesh.spatial_index = d, ranks.index(rank)
    for s in range(n_spatial):
        ranks = [d * n_spatial + s for d in range(n_data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mesh.col_ranks, mesh.data_group = ranks, g
    return mesh


def mesh_shape(n_dev: int, batch_size: int, spatial_shards: int,
               patch_d: int) -> Tuple[int, int, List[str]]:
    """(n_data, n_spatial, messages) of the JAX package's rule
    (cli/common.py:240-281): the data axis is the largest divisor of the
    batch that fits the ranks left after --spatial_shards; with
    --spatial_shards 1, idle pairs are promoted to spatial = 2 when the
    patch's D divides by 8; a warning when ranks stay idle."""
    n_spatial = spatial_shards
    avail = n_dev // n_spatial
    n_data = 1
    for d in range(min(avail, batch_size), 0, -1):
        if batch_size % d == 0:
            n_data = d
            break
    msgs = []
    if n_spatial == 1 and n_data > 1 and n_data * 2 <= n_dev \
            and patch_d % 8 == 0:
        n_spatial = 2
        msgs.append(f"Auto-promoting {n_dev - n_data} idle chips to spatial "
                    f"sharding: mesh data={n_data} x spatial={n_spatial}")
    if n_data * n_spatial < n_dev:
        msgs.append(f"WARNING: using {n_data * n_spatial} of {n_dev} devices "
                    f"(batch_size={batch_size}, "
                    f"spatial_shards={spatial_shards}); raise the batch or "
                    f"--spatial_shards to occupy the slice")
    return n_data, n_spatial, msgs


def make_mesh_if_multichip(cfg, world: Optional[int] = None
                           ) -> Optional[Mesh]:
    """The run's mesh, sized by ``mesh_shape`` from the world's ranks (the
    JAX package's chips), --batch_size, --spatial_shards and the patch;
    prints the rule's messages; None for a 1 x 1 mesh (everything runs as
    one process)."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    n_data, n_spatial, msgs = mesh_shape(world, cfg.batch_size,
                                         cfg.spatial_shards,
                                         cfg.patch_size[0])
    for m in msgs:
        print(m)
    if n_data == 1 and n_spatial == 1:
        return None
    return make_mesh(n_data, n_spatial)


# ---- the active mesh and the layout of a rank's tensors

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Within: the shard wraps of the models, the losses and the train
    steps work on this rank's slice of `mesh` (None: as one process).
    The counterpart of the JAX package's ``set_stencil_mesh``."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    """The active mesh, or None."""
    return _ACTIVE


_REPLICATED = "_vaeseg_replicated"


def mark_replicated(t: torch.Tensor) -> torch.Tensor:
    """Tag `t` as whole on every rank of its data row: a stage whose D
    does not split over 'spatial' (the JAX wraps' unsharded fallback)."""
    setattr(t, _REPLICATED, True)
    return t


def like(out, src: torch.Tensor):
    """Give `out` (a tensor or a tuple whose first item is one) the layout
    tag of `src`, the tensor it was computed from plane by plane."""
    if getattr(src, _REPLICATED, False):
        mark_replicated(out[0] if isinstance(out, tuple) else out)
    return out


def spatial_mesh(x: torch.Tensor) -> Optional[Mesh]:
    """The active mesh when `x` is split over its 'spatial' axis on D,
    else None."""
    mesh = _ACTIVE
    if mesh is None or mesh.n_spatial == 1 or getattr(x, _REPLICATED, False):
        return None
    return mesh


def global_depth(x: torch.Tensor) -> int:
    """The D extent of the volume `x` [B, D, ...] is a slice of."""
    mesh = spatial_mesh(x)
    return x.shape[1] * (1 if mesh is None else mesh.n_spatial)


def global_voxels(x: torch.Tensor) -> int:
    """D H W of the volume `x` [B, D, H, W, C] is a slice of: the count an
    instance norm divides by."""
    return global_depth(x) * x.shape[2] * x.shape[3]


def take_planes(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's D planes of a volume `t` [B, D, ...] that is whole on
    the rank (its gradient is the planes' own, zero elsewhere)."""
    d = t.shape[1]
    if d % mesh.n_spatial:
        raise ValueError(f"take_planes: D {d} does not split over "
                         f"{mesh.n_spatial} ranks")
    n = d // mesh.n_spatial
    return t[:, mesh.spatial_index * n:(mesh.spatial_index + 1) * n] \
        .contiguous()


def batch_shard(mesh: Mesh, t: torch.Tensor, spatial: bool = True
                ) -> torch.Tensor:
    """This rank's slice of a global batch `t` [B, D, ...]: its items and,
    with `spatial` and a 'spatial' axis, its D planes."""
    b = t.shape[0]
    if b % mesh.n_data:
        raise ValueError(f"batch_shard: batch {b} does not split over "
                         f"{mesh.n_data} data ranks")
    n = b // mesh.n_data
    t = t[mesh.data_index * n:(mesh.data_index + 1) * n]
    if spatial and mesh.n_spatial > 1:
        return take_planes(mesh, t)
    return t.contiguous()


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` broadcast from the grid's
    rank 0 over the mesh's ranks (they start equal when every rank builds
    from one seed; this makes it so whatever each loaded)."""
    if mesh.size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module
