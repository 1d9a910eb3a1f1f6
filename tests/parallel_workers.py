"""Worker processes of tests/test_torch_parallel.py: the port's data- and
tensor-parallel steps, its sharded decodes, batched serving and the
training loop, each rank a process of a gloo group on the CPU. This
module imports neither jax nor vtaco_tpu (the ranks are spawned and
import it afresh): the parent computes the JAX package's results and
hands every input over in a payload file.

``spawn(name, world, tmp, payload)`` runs ``name(rank, payload)`` in
``world`` ranks (one torch thread each, a file store under ``tmp``) and
returns each rank's result; with ``torchrun_port`` the ranks join through
torchrun's environment instead, each rank a host of its own.
"""

from __future__ import annotations

import copy
import os

import torch
import torch.distributed as dist
import yaml

from vtaco_tpu_torch.core.config import get_generator, get_model
from vtaco_tpu_torch.core.weights import load_jax_params
from vtaco_tpu_torch.data.core import get_dataset
from vtaco_tpu_torch.data.device_data import DeviceDataset
from vtaco_tpu_torch.generate import mise
from vtaco_tpu_torch.generate.inferencer import Inferencer
from vtaco_tpu_torch.cli import train as cli_train
from vtaco_tpu_torch.parallel.mesh import batch_rows, gather_rows, make_mesh
from vtaco_tpu_torch.parallel.multihost import initialize_distributed, process_shard
from vtaco_tpu_torch.parallel.tp import shard_state, unsharded
from vtaco_tpu_torch.train.loop import build_mesh_bank, train
from vtaco_tpu_torch.train.trainer import Trainer, _minmax_norm


def spawn(name, world, tmp, payload, torchrun_port=None):
    """Run ``name`` of this module in ``world`` gloo ranks; their results."""
    tmp = str(tmp)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    torch.multiprocessing.start_processes(_entry, args=(name, world, tmp, torchrun_port),
                                          nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, name, world, tmp, torchrun_port):
    torch.set_num_threads(1)
    if torchrun_port is None:
        initialize_distributed(local_rank=rank, local_size=world,
                               init_method=f"file://{tmp}/store")
    else:   # one rank per host, as torchrun on each of ``world`` nodes sets it
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                          LOCAL_WORLD_SIZE="1", GROUP_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(torchrun_port))
        initialize_distributed()
        initialize_distributed()       # a second call is a no-op
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = globals()[name](rank, payload)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def port_model(cfg, params, stats):
    model = get_model(copy.deepcopy(cfg), device="cpu")
    return load_jax_params(model, params, stats)


def port_trainer(p, device_mesh=None):
    """The payload's model and Trainer (contact_per_finger from the
    payload, as the JAX trainer's)."""
    cfg = p["cfg"]
    model = port_model(cfg, p["params"], p["stats"])
    return Trainer.from_config(model, cfg, mesh_bank=build_mesh_bank(cfg, "cpu"),
                               contact_per_finger=p["per_finger"],
                               device_mesh=device_mesh)


def state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _fused(p, device_mesh):
    """A fused block of len(ids) steps on the train split on the device
    (the CPU): its scalars and the model after it."""
    tr = port_trainer(p, device_mesh)
    cfg = p["cfg"]
    dds = DeviceDataset(get_dataset("train", cfg),
                        pointcloud_noise=cfg["data"]["pointcloud_noise"], device="cpu")
    fn = tr.make_fused_train_fn(dds, cfg["data"]["points_subsample"],
                                cfg["data"]["pointcloud_n"])
    g = torch.Generator().manual_seed(5)
    scal = tr.read_scalars(fn(p["ids"], g))
    return scal, state(tr.model)


def dp_vtaco(rank, p):
    """The data-parallel VTacO step on the payload's batch and draws, the
    replicated B = 1 eval step after it, and a fused block under the mesh
    beside the same block on one rank alone."""
    mesh = make_mesh(data=2)
    tr = port_trainer(p, mesh)
    scalars = tr.train_step(p["batch"], draws=p["draws"])
    out = {"scalars": scalars, "state": state(tr.model), "mesh": mesh.shape,
           "shard": process_shard(),
           "eval": tr.eval_step(p["val_batch"])}
    out["fused"], out["fused_state"] = _fused(p, mesh)
    out["fused_one"], out["fused_one_state"] = _fused(p, None)
    return out


def dp_tactile(rank, p):
    """The data-parallel tactile step, the same step on this rank's rows
    alone (what local BatchNorm and min-max would compute), then
    ``loop.train`` for two steps at data = 2, each rank with its own
    out_dir."""
    mesh = make_mesh(data=2)
    tr = port_trainer(p, mesh)
    scalars = tr.train_step(p["batch"])
    out = {"scalars": scalars, "state": state(tr.model), "rank": rank}
    rows = {k: v[rank:rank + 1] for k, v in p["batch"].items()}
    depths = torch.as_tensor(rows["inputs.depth"])
    out["minmax"] = _minmax_norm(depths, mesh.get_group("data")).numpy()
    out["minmax_local"] = _minmax_norm(depths).numpy()
    local = port_trainer(p)
    out["local_scalars"] = local.train_step(rows)
    out["local_state"] = state(local.model)
    cfg = copy.deepcopy(p["loop_cfg"])
    cfg["training"]["out_dir"] = os.path.join(p["loop_dir"], f"rank{rank}")
    torch.manual_seed(0)
    trainer, it = train(cfg, max_iters=2, device="cpu")
    out["loop"] = {"it": it, "step": trainer.step, "state": state(trainer.model),
                   "mesh": trainer.mesh.shape}
    # the train CLI with --cpu inside the group: the group's mesh
    path = os.path.join(p["loop_dir"], f"cli{rank}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(p["loop_cfg"], f)
    cli_dir = os.path.join(p["loop_dir"], f"cli_rank{rank}")
    cli_train.main([path, "--cpu", "--max-iters", "1", "--out-dir", cli_dir])
    out["cli_files"] = sorted(os.listdir(cli_dir)) if os.path.isdir(cli_dir) else []
    return out


def hosts(rank, p):
    """Two hosts of one rank each, as torchrun makes them: the host's
    shard, the train split under ``data.shard_by_process`` (validation
    whole), this rank's rows of a host batch of three and the gathered
    global batch of six."""
    mesh = make_mesh(data=2)
    cfg = copy.deepcopy(p["cfg"])
    cfg["data"]["shard_by_process"] = True
    rows = batch_rows(3, mesh)
    x = torch.arange(3.0) + 10 * rank
    return {"shard": process_shard(), "mesh": mesh.shape,
            "train": [m["model"] for m in get_dataset("train", cfg).models],
            "val": len(get_dataset("val", cfg)), "rows": tuple(rows),
            "gathered": gather_rows(rows.take(x), mesh, rows).tolist()}


def tp_vtaco(rank, p):
    """The (data=2, model=2) step, min_shard 4: the partitioned names and
    shapes, the step's scalars, the whole parameters after it (gathered),
    and one eval step."""
    mesh = make_mesh(data=2, model=2)
    tr = port_trainer(p, mesh)
    spec = shard_state(mesh, tr.model, tr.optimizer, min_shard=4)
    local = {n: tuple(pp.shape) for n, pp in tr.model.named_parameters()}
    column = [type(m).__name__ for m in tr.model._tp["column"]]
    scalars = tr.train_step(p["batch"], draws=p["draws"])
    ev = tr.eval_step(p["val_batch"])
    with unsharded(tr.model, tr.optimizer):
        whole = state(tr.model)
        moments = {n: tr.optimizer.state[pp]["exp_avg"].clone()
                   for n, pp in tr.model.named_parameters()
                   if n in spec and "exp_avg" in tr.optimizer.state[pp]}
    return {"spec": spec, "local_shapes": local, "scalars": scalars, "state": whole,
            "moments": moments, "eval": ev, "coord": mesh.get_coordinate(),
            "column": column}


def decode(rank, p):
    """Every sharded decode under a 2-rank mesh and the same calls without
    one."""
    mesh = make_mesh(data=2)
    cfg = p["cfg"]
    model = port_model(cfg, p["params"], p["stats"]).eval()
    gen = get_generator(model, cfg, transfer_dtype="float32",
                        contact_per_finger=p["per_finger"])
    out = {}
    one = {"grid": torch.as_tensor(p["grids"][:1])}
    out["sharded"] = gen.eval_points_dense_sharded(model, p["nx_sharded"], one, mesh)
    out["sharded_ref"] = gen.eval_points_dense(model, p["nx_sharded"], one)
    for b in (2, 3):      # split over the ranks, and replicated
        c = {"grid": torch.as_tensor(p["grids"][:b])}
        for td in (torch.float32, torch.bfloat16, "int8"):
            for m in (mesh, None):
                out["dense", b, str(td), m is None] = gen.decode_dense_batched(
                    model, p["nx"], c, device_mesh=m, transfer_dtype=td)
    c = {"grid": torch.as_tensor(p["grids"][:2])}
    for case, kw in p["points_cases"].items():
        for m in (mesh, None):
            out["points", case, m is None] = gen.decode_points_batched(
                model, kw.get("pts_b"), c, device_mesh=m, **{
                    k: v for k, v in kw.items() if k != "pts_b"})
    for m in (mesh, None):
        grids, levels = mise.multires_decode_batched(
            gen, model, c, p["res0"], 1, None, device_mesh=m)
        out["mise", m is None] = (grids, levels)
    return out


def serve(rank, p):
    """Inferencer.run_batched on the payload's batches, two objects a
    flight, at float32 transfers, over the mesh and without it, each into
    its own directory."""
    mesh = make_mesh(data=2)
    cfg = p["cfg"]
    model = port_model(cfg, p["params"], p["stats"]).eval()
    gen = get_generator(model, cfg)
    dense = gen.decode_dense_batched
    gen.decode_dense_batched = lambda *a, **kw: dense(
        *a, **{**kw, "transfer_dtype": torch.float32})
    out = {}
    for m, name in ((mesh, "mesh"), (None, "one")):
        d = os.path.join(p["out"], f"{name}{rank}")
        out[name] = Inferencer(model, gen).run_batched(model, p["batches"], batch_size=2,
                                                      device_mesh=m, out_dir=d)
        out[name + "_files"] = sorted(os.listdir(d)) if os.path.isdir(d) else []
    return out
