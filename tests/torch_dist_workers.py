"""The ranks' side of the port's multi-rank tests: functions that
``parallel.launch.spawn`` runs in each process of a gloo world on the CPU.
They import torch and the port only (never JAX, whose tests start these
worlds), and return numpy arrays and plain values."""

import hashlib

import torch

from vae_segmentation_tpu_torch import models as pm
from vae_segmentation_tpu_torch import train as pt
from vae_segmentation_tpu_torch.ops import losses as L
from vae_segmentation_tpu_torch.parallel import collectives as C
from vae_segmentation_tpu_torch.parallel import sharding as S


def _mesh(world, n_data, n_spatial):
    return S.make_mesh(n_data, n_spatial) if world > 1 else None


def mesh_layout(rank, world, n_data, n_spatial):
    """This rank's place in the mesh and its groups' ranks."""
    m = S.make_mesh(n_data, n_spatial)
    return {"member": m.member, "data_index": m.data_index,
            "spatial_index": m.spatial_index, "row": m.row_ranks,
            "col": m.col_ranks, "size": m.size}


def collectives(rank, world, n_data, n_spatial, x, c):
    """Each collective on this rank's slice of the global x [B, D, ...]
    (the same numpy array on every rank) and its backward from the loss
    sum(y * c[rank]): (y, dL/dx) a collective."""
    mesh = S.make_mesh(n_data, n_spatial)
    xg = torch.from_numpy(x)
    out = {}
    for name in ("halo", "spatial_sum", "gather_spatial", "gather_data",
                 "data_mean"):
        xl = S.batch_shard(mesh, xg).requires_grad_(True)
        y = {"halo": lambda v: C.halo_exchange(v, mesh),
             "spatial_sum": lambda v: C.spatial_sum(v, mesh),
             "gather_spatial": lambda v: C.gather_spatial(v, mesh),
             "gather_data": lambda v: C.gather_data(v, mesh),
             "data_mean": lambda v: C.data_mean(v, mesh)}[name](xl)
        cw = torch.from_numpy(c[rank][name])
        (y * cw).sum().backward()
        out[name] = (y.detach(), xl.grad)
    # the fixed-order mean of gradients: every rank's copy the same bits
    p = torch.nn.Parameter(torch.zeros(3, 5))
    p.grad = torch.from_numpy(c[rank]["grad"])
    C.mean_grads([p], mesh)
    out["mean_grads"] = p.grad
    return out


def _digest(t):
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def adapt_step(rank, world, n_data, n_spatial, spec):
    """One adaptation step (domain_loss_type 8, dropout 0 unless the spec
    says) of the port's Joint from spec['state'] on this rank's slice of
    spec['image'], spec['label']: loss terms, the gradients (rank 0's; every
    rank's are checked equal by digest), every parameter's digest after
    the update, and whether the VAE moved."""
    mesh = _mesh(world, n_data, n_spatial)
    kw = dict(n_class=2, dim=spec["dim"], fmaps=spec["fmaps"],
              bottleneck=spec["bottleneck"], dtype=torch.float32)
    student = pm.Joint(vae_decoder_dropout=spec.get("dropout", 0.0),
                       seg_dropout=spec.get("dropout", 0.0), **kw)
    teacher = pm.Joint(**kw)
    state = {k: torch.from_numpy(v) for k, v in spec["state"].items()}
    pm.load_state(student, state)
    pt.copy_params(teacher, student)
    for p in teacher.parameters():
        p.requires_grad_(False)
    vae0 = {k: v.clone() for k, v in student.Vae.state_dict().items()}
    opt = pt.optim.sgd(pt.optim.freeze_vae(student), spec["lr"])
    step = pt.make_adapt_step(pt.AdaptConfig(
        n_class=2, domain_loss_type=spec.get("loss_type", 8),
        kl=spec.get("kl", False)))
    img = torch.from_numpy(spec["image"])
    lab = torch.from_numpy(spec["label"])
    if mesh is not None:
        img, lab = S.batch_shard(mesh, img), S.batch_shard(mesh, lab)
    gen = torch.Generator().manual_seed(spec.get("seed", 0))
    with S.active(mesh):
        aux = step(student, teacher, opt, img, lab, gen,
                   pt.default_sched(spec.get("lambda_vae", 1.0)))
    grads = {k: p.grad for k, p in student.named_parameters()
             if p.grad is not None}
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": grads if rank == 0 else None,
            "grad_digest": {k: _digest(g) for k, g in grads.items()},
            "param_digest": {k: _digest(v)
                             for k, v in student.state_dict().items()},
            "vae_unmoved": all(torch.equal(v, vae0[k]) for k, v in
                               student.Vae.state_dict().items())}


def source_step(rank, world, n_data, n_spatial, spec):
    """One vae_train (reparam at spec['scale']) or seg_train step of a
    ShapeVAE / SegUNet (spec['norm_type'], default 1) from spec['state']
    on this rank's slice: the loss
    terms and the gradients (rank 0's), their digests, and the reparam
    seeds this rank drew."""
    mesh = _mesh(world, n_data, n_spatial)
    vae = spec["kind"] == "vae"
    norm_type = spec.get("norm_type", 1)
    if vae:
        net = pm.ShapeVAE(n_class=2, fmaps=spec["fmaps"], dim=spec["dim"],
                          bottleneck=spec["bottleneck"], dtype=torch.float32,
                          norm_type=norm_type)
        step = pt.make_vae_train_step(2, scale=spec["scale"])
    else:
        net = pm.SegUNet(n_class=2, fmaps=spec["fmaps"], dtype=torch.float32,
                         norm_type=norm_type)
        step = pt.make_seg_train_step(2)
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in spec["state"].items()})
    opt = pt.optim.sgd(net.parameters(), spec["lr"])
    img = torch.from_numpy(spec["image"])
    lab = torch.from_numpy(spec["label"])
    if mesh is not None:
        img, lab = S.batch_shard(mesh, img), S.batch_shard(mesh, lab)
    gen = torch.Generator().manual_seed(spec.get("seed", 0))
    seeds = []
    if vae:
        # the reparam seeds this rank hands the kernel
        from vae_segmentation_tpu_torch.ops import reparam
        real = reparam.reparam_kl

        def spy(mean, std, scale, seed):
            seeds.append(int(seed))
            return real(mean, std, scale, seed)
        reparam.reparam_kl = spy
    try:
        with S.active(mesh):
            aux = step(net, opt, lab, gen) if vae else step(net, opt, img,
                                                            lab)
    finally:
        if vae:
            reparam.reparam_kl = real
    grads = {k: p.grad for k, p in net.named_parameters()
             if p.grad is not None}
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": grads if rank == 0 else None,
            "grad_digest": {k: _digest(g) for k, g in grads.items()},
            "seeds": seeds}


def joint_step(rank, world, n_data, n_spatial, spec):
    """One source step of a Joint (spec['kind']: 'joint' for joint_train,
    'cached' for the source domain_adaptation with spec['pseudo'] as its
    cached pseudo label) from spec['state'], SGD with the VAE frozen, on
    this rank's slice: loss terms, the gradients (rank 0's) and their
    digests, whether the VAE moved, and for 'cached' the step's prediction
    gathered to the global batch (what the CLI's --mode refresh writes)."""
    mesh = _mesh(world, n_data, n_spatial)
    model = pm.Joint(n_class=2, dim=spec["dim"], fmaps=spec["fmaps"],
                     bottleneck=spec["bottleneck"], dtype=torch.float32)
    pm.load_state(model, {k: torch.from_numpy(v)
                          for k, v in spec["state"].items()})
    vae0 = {k: v.clone() for k, v in model.Vae.state_dict().items()}
    opt = pt.optim.sgd(pt.optim.freeze_vae(model), spec["lr"])
    img = torch.from_numpy(spec["image"])
    lab = torch.from_numpy(spec["label"])
    pseudo = torch.from_numpy(spec["pseudo"])
    if mesh is not None:
        img, lab, pseudo = (S.batch_shard(mesh, v) for v in (img, lab,
                                                             pseudo))
    sched = pt.default_sched(spec.get("lambda_vae", 1.0))
    with S.active(mesh):
        if spec["kind"] == "joint":
            aux = pt.make_joint_train_step(2)(model, opt, img, lab, sched)
        else:
            aux = pt.make_cached_pseudo_adapt_step(pt.AdaptConfig(
                n_class=2))(model, opt, img, lab, pseudo, sched)
    pred = aux.pop("pred", None)
    if pred is not None and mesh is not None:
        if mesh.n_spatial > 1:
            pred = C.gather_spatial(pred, mesh)
        pred = C.gather_data(pred, mesh)
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": grads if rank == 0 else None,
            "grad_digest": {k: _digest(g) for k, g in grads.items()},
            "pred": pred,
            "vae_unmoved": all(torch.equal(v, vae0[k]) for k, v in
                               model.Vae.state_dict().items())}


def dh_loss(rank, world, n_data, n_spatial, pred, recon, pseudo):
    """The adaptation loss (type 8, dh bucketing) of this rank's slice of
    fixed pred / recon / pseudo volumes: the loss, this rank's recon loss
    had it used its own items alone, and dL/dpred of its slice."""
    mesh = _mesh(world, n_data, n_spatial)
    p = torch.from_numpy(pred)
    r, s = torch.from_numpy(recon), torch.from_numpy(pseudo)
    if mesh is not None:
        p, r, s = (S.batch_shard(mesh, v) for v in (p, r, s))
    p.requires_grad_(True)
    cfg = pt.AdaptConfig(n_class=2, domain_loss_type=8)
    # what the rank's own items alone would give (no mesh: no gather)
    own = 1.0 - L.multi_soft_dice(p.detach(), (r,))[0][:, 1:2].mean()
    with S.active(mesh):
        d_pr, d_ps = L.multi_soft_dice(p, (r, s))
        recon_loss = 1.0 - d_pr[:, 1:2].mean()
        fake_loss = 1.0 - d_ps[:, 1:2].mean()
        final = pt.adapt_loss(recon_loss, fake_loss, 0.0, 0.0, cfg,
                              pt.default_sched(1.0))
    final.backward()
    return {"final": float(final.detach()),
            "recon": float(recon_loss.detach()),
            "own_recon": float(own), "grad": p.grad}


def cli(rank, world, which, argv, cwds):
    """One of the port's CLIs (``which``: 'source' or 'target') with argv
    in this rank's directory cwds[rank]: (its result, its stdout)."""
    import contextlib
    import io
    import os

    from vae_segmentation_tpu_torch.cli import source_main, target_main

    os.chdir(cwds[rank])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = (source_main if which == "source" else target_main).main(argv)
    return res, out.getvalue()


def adapt_dis_step(rank, world, n_data, n_spatial, spec):
    """One domain_adaptation_dis step of a Joint2 from spec['state'] with a
    teacher SegUNet from spec['teacher'], SGD with the Dis frozen, on this
    rank's slice: loss terms, the gradients (rank 0's) and their digests,
    whether the Dis moved."""
    mesh = _mesh(world, n_data, n_spatial)
    model = pm.Joint2(n_class=2, fmaps=spec["fmaps"],
                      bottleneck=spec["bottleneck"], dtype=torch.float32)
    pm.load_state(model, {k: torch.from_numpy(v)
                          for k, v in spec["state"].items()})
    teacher = pm.SegUNet(n_class=2, fmaps=spec["fmaps"], dtype=torch.float32)
    pm.load_state(teacher, {k: torch.from_numpy(v)
                            for k, v in spec["teacher"].items()})
    dis0 = {k: v.clone() for k, v in model.Dis.state_dict().items()}
    opt = pt.optim.sgd(pt.optim.freeze_dis(model), spec["lr"])
    img = torch.from_numpy(spec["image"])
    lab = torch.from_numpy(spec["label"])
    if mesh is not None:
        img, lab = S.batch_shard(mesh, img), S.batch_shard(mesh, lab)
    with S.active(mesh):
        aux = pt.make_adapt_dis_step(pt.AdaptConfig(n_class=2))(
            model, teacher, opt, img, lab, torch.Generator().manual_seed(0),
            pt.default_sched(spec.get("lambda_vae", 1.0)))
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": grads if rank == 0 else None,
            "grad_digest": {k: _digest(g) for k, g in grads.items()},
            "dis_unmoved": all(torch.equal(v, dis0[k]) for k, v in
                               model.Dis.state_dict().items())}


def dis_input_grad(rank, world, n_data, n_spatial, spec):
    """1 - the batch mean of a ShapeEncoder's scores of this rank's slice of
    spec['x'], and its gradient in that slice."""
    from vae_segmentation_tpu_torch.train import steps as ST

    mesh = _mesh(world, n_data, n_spatial)
    enc = pm.ShapeEncoder(dim=1, fmaps=spec["fmaps"],
                          bottleneck=spec["bottleneck"], dtype=torch.float32,
                          generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(spec["x"])
    if mesh is not None:
        x = S.batch_shard(mesh, x)
    x.requires_grad_(True)
    with S.active(mesh):
        loss = 1.0 - ST._batch_mean(enc(x))
    loss.backward()
    return {"loss": float(loss.detach()), "grad": x.grad}
