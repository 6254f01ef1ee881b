"""Distributed blocking launcher: run HDB itself over a process group.

The paper's own workload as a job: records split over the ranks, the
sketches all-reduce and exact counts route by ``all_to_all_single``
(``core/distributed.py``). One process a rank, started by ``torchrun``:

    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.block \\
        --entities E

builds the synthetic corpus's keys on every rank (seed 3), pads them to a
multiple of the world size and runs ``distributed_hashed_dynamic_blocking``
on a one-dim ``("data",)`` mesh: NCCL on the card, gloo with
``--device cpu``. A world of one runs ``hashed_dynamic_blocking``, as the
reference does on one device. ``main`` joins a process group that is
already initialised (the tests' gloo worlds) and otherwise initialises
one from torchrun's environment. ``--ckpt-dir D`` checkpoints each
rank's local HDB state (keys, valid, psize) after every iteration of the
mesh path (``training/checkpoint``, under ``D/rank_<r>``, where the
reference's one controller writes the global state to ``D``); as in the
reference, the single-device path takes no checkpoint.
"""
import argparse
import logging
import os

import torch
import torch.distributed as tdist

from ..core import blocks, distributed, hdb
from ..core.hdb import HDBConfig
from ..data import synthetic
from ..device import resolve_device
from ..training import checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true",
                    help="lower one iteration on the production mesh "
                         "(not ported: ROADMAP A10b-6c)")
    ap.add_argument("--entities", type=int, default=2000)
    ap.add_argument("--max-block-size", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint each rank's state every iteration of the "
                         "mesh path, under <dir>/rank_<r>")
    ap.add_argument("--rep-capacity", type=int, default=0,
                    help="per-shard over-sized block rep capacity "
                         "(0 = DistConfig default)")
    ap.add_argument("--route-slack", type=float, default=0.0,
                    help="bucket slack of the exchanges (0 = DistConfig default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL between ranks) or cpu (gloo)")
    args = ap.parse_args(argv)
    if args.dryrun:
        raise NotImplementedError(
            "--dryrun needs the port's lowering and cost analysis (launch/"
            "dryrun.py, hlo_analysis.py), which wait for ROADMAP A10b-6c")

    cfg = HDBConfig(max_block_size=args.max_block_size)
    dist_kw = {}
    if args.rep_capacity:
        dist_kw["rep_capacity_per_shard"] = args.rep_capacity
    if args.route_slack:
        dist_kw["route_slack"] = args.route_slack

    own_group = False
    if not tdist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        on_card = torch.device(args.device).type == "cuda"
        if on_card:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        tdist.init_process_group("nccl" if on_card else "gloo")
        own_group = True
    try:
        dev = resolve_device(args.device)
        corpus = synthetic.generate(synthetic.SyntheticSpec(
            num_entities=args.entities, seed=3), device=dev)
        keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
        world = tdist.get_world_size() if tdist.is_initialized() else 1
        if world > 1:
            from torch.distributed.device_mesh import DeviceMesh
            keys, valid = distributed.pad_rows(keys, valid, world)
            mesh = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("data",))
            cb = None
            if args.ckpt_dir:
                rank_dir = os.path.join(args.ckpt_dir, f"rank_{tdist.get_rank()}")
                cb = lambda it, st: checkpoint.save(rank_dir, it, st)  # noqa: E731
            res = distributed.distributed_hashed_dynamic_blocking(
                keys, valid, cfg, mesh, ("data",),
                dist=distributed.DistConfig(**dist_kw), checkpoint_cb=cb,
                verbose=True, device=dev)
        else:
            res = hdb.hashed_dynamic_blocking(keys, valid, cfg, verbose=True, device=dev)
        if not tdist.is_initialized() or tdist.get_rank() == 0:
            print(f"[block] accepted assignments: {len(res.rids):,} over "
                  f"{res.num_records:,} records")
    finally:
        if own_group:
            tdist.destroy_process_group()
    return res


if __name__ == "__main__":
    # the CLI owns logging: the [hdb]/[hdb-dist] stats are INFO
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
