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

One process, one device: the reference's single-device path (empty
sharding rules, ``default_optimizer``, ``default_lr``, and a
``TrainingSupervisor`` with checkpoints when ``--ckpt-dir`` is given).
The reference's multi-device run (GSPMD placements from ``rules_for``) is
ROADMAP A, slice 16e: under a process group of more than one rank this
raises.
"""
from __future__ import annotations

import argparse

from .. import models as M
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import lm_batch
from . import RULES
from ..distributed import ResiliencePolicy, TrainingSupervisor
from ..train import default_lr, default_optimizer, make_train_step

def _single_process():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "launch.train runs one rank; the reference's sharded training "
            "(rules_for placements over a device mesh) is ROADMAP A, "
            "slice 16e")


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
    _single_process()

    cfg = get_config(args.arch, reduced=args.reduced)
    print(f"arch={cfg.arch} params={M.count_params(cfg):,} "
          f"device={args.device}")

    params = M.init_params(cfg, 0, device=args.device)
    opt = default_optimizer(cfg)
    state = (params, opt.init(params))
    raw = make_train_step(cfg, RULES, opt, default_lr(cfg, args.steps),
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
        print(f"done: {sup.report.final_step} steps, "
              f"loss {sup.report.losses[-1]:.4f}")
    else:
        for step in range(args.steps):
            state, m = step_fn(state, batch_fn(step), step)
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                      f"lr {float(m['lr']):.2e}")


if __name__ == "__main__":
    main()
