"""Training launcher (port of ``repro.launch.train``), on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 4 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --device cpu --steps 20 [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --steps 4 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 4 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi-3-vision-4.2b --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch seamless-m4t-large-v2 --steps 4 --batch 8 --seq 128

``--arch`` takes every family (a vlm model's ``lm_batch`` draws its patch
embeddings and the loss reads the text positions; an encdec model's draws
``--seq // 2`` frames beside the decoder's tokens, as the reference's
launcher asks).

One process: the reference's single-device path (empty sharding rules,
``default_optimizer``, ``default_lr``, and a ``TrainingSupervisor`` with
checkpoints when ``--ckpt-dir`` is given).

Several ranks, under torchrun's environment (``WORLD_SIZE`` > 1, with
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), the
reference's sharded run: the process group (NCCL when every rank of the
host has a card of its own, gloo otherwise: ranks sharing one card, or
``--device cpu``), ``make_host_mesh()`` (a ``("data", "model")`` mesh of
one model rank a group) set as the current mesh, ``rules_for(cfg,
SHAPES["train_4k"], mesh)``, the params and the optimizer state placed
by their specs (``launch.sharding``), and the sharded step; the first
rank prints.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch internlm2-1.8b --reduced --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import os

from .. import models as M
from ..checkpoint import CheckpointManager
from ..configs import SHAPES, get_config
from ..data import lm_batch
from . import RULES
from ..distributed import ResiliencePolicy, TrainingSupervisor
from ..models.common import set_current_mesh
from ..train import default_lr, default_optimizer, make_train_step


def _join_group(device: str):
    """Initialize the process group from torchrun's environment; returns
    the rank's device.  NCCL when every rank of the host has a card of
    its own, else gloo (CUDA tensors then stage through the host)."""
    import torch
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                  os.environ["WORLD_SIZE"]))
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but torch.cuda.is_available()"
                           " is False; pass --device cpu")
    nccl = cuda and torch.cuda.device_count() >= per_host
    if cuda:
        torch.cuda.set_device(local % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    dist.init_process_group("nccl" if nccl else "gloo")
    return device


def _sharded(cfg, opt, device: str):
    """(mesh, rules, state) of the sharded run: the mesh set as the
    current one, the params and the state placed by their specs."""
    import torch
    from .mesh import make_host_mesh
    from .sharding import distribute, init_state, rules_for

    mesh = make_host_mesh(device=torch.device(device).type)
    set_current_mesh(mesh)
    rules = rules_for(cfg, SHAPES["train_4k"], mesh)
    specs = M.param_specs(cfg, rules)
    params = distribute(M.init_params(cfg, 0, device=device), mesh, specs)
    return mesh, rules, (params, init_state(opt, params, specs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    opt = default_optimizer(cfg)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch.distributed as dist
        args.device = _join_group(args.device)
        mesh, rules, state = _sharded(cfg, opt, args.device)
        say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        say(f"arch={cfg.arch} params={M.count_params(cfg):,} "
            f"device={args.device} ranks={dist.get_world_size()} "
            f"backend={dist.get_backend()} mesh={tuple(mesh.shape)} "
            f"{tuple(mesh.mesh_dim_names)}")
    else:
        say, rules = print, RULES
        say(f"arch={cfg.arch} params={M.count_params(cfg):,} "
            f"device={args.device}")
        params = M.init_params(cfg, 0, device=args.device)
        state = (params, opt.init(params))
    raw = make_train_step(cfg, rules, opt, default_lr(cfg, args.steps),
                          accum_steps=args.accum)

    def step_fn(state, batch, step):
        p, o, m = raw(state[0], state[1], batch, step)
        return (p, o), m

    def batch_fn(step):
        return lm_batch(cfg, seed=17, step=step, batch=args.batch,
                        seq=args.seq, t_enc=args.seq // 2,
                        device=args.device)

    if args.ckpt_dir:
        sup = TrainingSupervisor(
            CheckpointManager(args.ckpt_dir, keep_k=3),
            policy=ResiliencePolicy(max_retries=8, deadline_factor=3.0,
                                    checkpoint_every=args.ckpt_every))
        sup.run(state, step_fn, args.steps, batch_fn)
        say(f"done: {sup.report.final_step} steps, "
            f"loss {sup.report.losses[-1]:.4f}")
    else:
        for step in range(args.steps):
            state, m = step_fn(state, batch_fn(step), step)
            if step % 10 == 0 or step == args.steps - 1:
                say(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                    f"lr {float(m['lr']):.2e}")
    if rules is not RULES:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
