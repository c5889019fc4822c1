"""Serving launcher (port of ``repro.launch.serve``): batched generation
plus diverse re-ranking, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 8 --new-tokens 16 --diverse-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --reduced --device cpu --diverse-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --requests 8 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi-3-vision-4.2b --requests 8 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --reduced --device cpu --diverse-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --requests 8 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --reduced --device cpu

``--arch`` takes every family: a vlm model gets zero patch embeddings
before each prompt, as the reference's engine feeds; an encdec model is
served through the engine's ``t_enc=0`` path, as the reference's launcher
builds its engine (no frames: the cross-attention adds nothing).
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import models as M
from ..configs import get_config
from . import RULES
from ..data import embed_examples
from ..serving import Request, ServingEngine, diverse_rerank

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--diverse-k", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    params = M.init_params(cfg, 0, device=args.device)
    # a vlm model's cache also holds its patches (num_patches is 0 for the
    # other families)
    engine = ServingEngine(cfg, RULES, params, batch=4,
                           capacity=cfg.num_patches + args.new_tokens + 32)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, size=8)
                    .astype(np.int32), max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    done = engine.generate(reqs)
    for i, r in enumerate(done):
        print(f"req {i}: {r.out.tolist()}")
    if args.diverse_k:
        outs = np.stack([r.out for r in done])
        emb = embed_examples(outs, dim=16, device=args.device)
        top = diverse_rerank(emb, args.diverse_k)
        print(f"\nmost diverse {args.diverse_k}: requests {top.tolist()}")
    return done


if __name__ == "__main__":
    main()
