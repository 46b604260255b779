"""The port's mesh (``parallel/sharding.py``): its sizing rule against the
JAX package's ``cli/common.py::make_mesh_if_multichip`` over a grid of
(devices, batch, --spatial_shards, patch), the printed messages included,
and the group layout of real gloo worlds on the CPU (ranks outside the grid
included)."""

import types

import pytest

import torch_dist_workers as W
from vae_segmentation_tpu.cli import common as jcommon
from vae_segmentation_tpu_torch.parallel import launch, sharding

GRID = [(n, b, s, p) for n in (1, 2, 3, 4, 8) for b in (1, 2, 3, 4, 6)
        for s in (1, 2, 4) for p in (32, 64, 96, 100)]


def _jax_rule(monkeypatch, capsys, n_dev, batch, spatial, patch):
    """(n_data, n_spatial, printed lines) of the JAX function, its device
    count and mesh constructor stubbed."""
    made = {}
    monkeypatch.setattr(jcommon.jax, "device_count", lambda: n_dev)
    monkeypatch.setattr(jcommon.parallel, "make_mesh",
                        lambda n_data, n_spatial: made.update(
                            n_data=n_data, n_spatial=n_spatial) or made)
    from vae_segmentation_tpu.models import blocks
    monkeypatch.setattr(blocks, "set_stencil_mesh", lambda mesh: None)
    cfg = types.SimpleNamespace(spatial_shards=spatial, batch_size=batch,
                                patch_size=(patch, patch, patch))
    capsys.readouterr()
    mesh = jcommon.make_mesh_if_multichip(cfg)
    lines = capsys.readouterr().out.splitlines()
    if mesh is None:
        return 1, 1, lines
    return made["n_data"], made["n_spatial"], lines


def test_sizing_rule_matches_jax(monkeypatch, capsys):
    """mesh_shape == the JAX rule (the largest batch divisor that fits,
    the auto-promotion of idle pairs when D % 8 == 0, the warning) on
    every point of the grid; a 1 x 1 mesh is no mesh in both."""
    for n_dev, batch, spatial, patch in GRID:
        nd, ns, lines = _jax_rule(monkeypatch, capsys, n_dev, batch,
                                  spatial, patch)
        got = sharding.mesh_shape(n_dev, batch, spatial, patch)
        assert got == (nd, ns, lines), (n_dev, batch, spatial, patch)


def test_make_mesh_if_multichip_prints_and_degenerates(capsys):
    cfg = types.SimpleNamespace(spatial_shards=1, batch_size=1,
                                patch_size=(32, 32, 32))
    assert sharding.make_mesh_if_multichip(cfg, world=1) is None
    cfg.batch_size = 2
    with pytest.raises(RuntimeError, match="not initialized"):
        sharding.make_mesh_if_multichip(cfg, world=4)
    out = capsys.readouterr().out
    assert "Auto-promoting 2 idle chips to spatial sharding: mesh data=2 " \
           "x spatial=2" in out


@pytest.mark.parametrize("world,n_data,n_sp", [(4, 2, 2), (3, 1, 2)])
def test_group_layout(world, n_data, n_sp):
    """rank = data_index * n_spatial + spatial_index; the row holds the
    ranks of one data index in spatial order, the column those of one
    spatial index in data order; a rank past the grid is no member."""
    got = launch.spawn(W.mesh_layout, world, timeout=60.0,
                       args=(n_data, n_sp))
    for rank, m in enumerate(got):
        if rank >= n_data * n_sp:
            assert not m["member"]
            continue
        d, s = divmod(rank, n_sp)
        assert m["member"] and (m["data_index"], m["spatial_index"]) == (d, s)
        assert m["row"] == [d * n_sp + k for k in range(n_sp)]
        assert m["col"] == [k * n_sp + s for k in range(n_data)]
        assert m["size"] == n_data * n_sp
