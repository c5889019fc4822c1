"""Batched serving engine and diversity re-ranking (port of
``repro.serving.engine``): present k maximally diverse results, the paper's
motivating application.

``ServingEngine`` drives prefill and greedy decode over a fixed batch of
request slots against a KV cache on the model's device (continuous
batching lite: the requests go through in groups of ``batch``).  Diverse
reranking plugs into that loop at two levels:

* ``rerank_group`` — after a group finishes decoding, every request's
  candidate embeddings absorb into its session's streaming core-set and
  the slates come back from one fused multi-session solve
  (``OnlineReranker.rerank_many``);
* ``generate_diverse`` — ``generate`` + ``rerank_group`` a group: the
  serve-then-diversify loop.

``diverse_rerank`` is the legacy one-shot spelling (a ``DeprecationWarning``
wrapper over ``repro_torch.diversify``).

The engine keeps the reference's behaviour, including what a fix would
change: prompts are left-padded with token 0, the pad positions count from
0 and no mask hides them, the decode position is ``S + s`` for the group's
longest prompt S (``P + S + s`` for a vlm model, whose prefill feeds P
zero patch embeddings before the prompt), an encdec model encodes
``t_enc`` zero frames (fp32) and decodes the prompt, its cache made for
``t_enc or S`` frames (with ``t_enc=0`` the encoder sees no frames and the
cross-attention adds nothing; the reference's encoder raises there), the
greedy pick is the first maximal logit, and
``rerank_group`` keys a request without a ``session`` by its index in the
group (``req-{i}``), so a later group's such requests land in an earlier
group's sessions.  One difference is decided: a KV cache too short for the
group's patches, prompt and decode steps raises ``ValueError`` (the
reference's scatter drops the writes past its end); an ssm model's state
does not grow, and its capacity is not read; a hybrid model's local
attention keeps a rolling buffer of its window.

Spans (with an enabled ``obs.trace`` active): ``serving.generate`` a group,
inside it ``serving.prefill`` and one ``serving.decode`` a step, each fenced
on its result; ``serving.rerank_group`` around a group's rerank.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import models as M
from ..device import resolve_device
from ..kernels.build import LAUNCHES
from ..models.common import ModelConfig, ShardingRules
from ..models.vlm import D_VISION
from ..obs.trace import launch_span as _launch_span, span as _span


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None
    # -- diverse-rerank fields (see rerank_group) --------------------------
    session: Optional[str] = None        # session key (None = per-request)
    candidates: Optional[np.ndarray] = None   # (n, d) candidate embeddings
    slate: Optional[np.ndarray] = None        # (k, d) diverse slate
    slate_reused: bool = False           # served from the cached certificate


def _fence(span, tok: torch.Tensor) -> None:
    """An open span times the step's execution, not its launch."""
    if span is not None and tok.is_cuda:
        torch.cuda.synchronize()


class ServingEngine:
    """``params`` is the model (``models.init_params`` or
    ``interop.params_from_reference``); the engine runs on its device.
    ``reranker``: a ``serving.OnlineReranker`` for ``rerank_group``."""

    def __init__(self, cfg: ModelConfig, rules: ShardingRules, params, *,
                 batch: int = 4, capacity: int = 256, t_enc: int = 0,
                 reranker=None):
        M._ported(cfg)
        self.cfg, self.rules, self.params = cfg, rules, params
        self.batch, self.capacity, self.t_enc = batch, capacity, t_enc
        self.reranker = reranker
        self.device = resolve_device(None, like=params["embed"])

    def _prefix(self) -> int:
        """Positions before the prompt: a vlm model's patches."""
        return self.cfg.num_patches if self.cfg.family == "vlm" else 0

    def _check_capacity(self, S: int, steps: int) -> None:
        cfg = self.cfg
        if cfg.family == "ssm":
            return
        full = cfg.window == 0 or cfg.local_global_period > 1
        P = self._prefix()
        if full and P + S + steps - 1 > self.capacity:
            raise ValueError(
                f"a cache of capacity={self.capacity} holds no "
                + (f"{P} patch + " if P else "")
                + f"{S} prompt + {steps - 1} decoded positions; raise "
                "capacity")

    @torch.no_grad()
    def generate(self, requests: List[Request]) -> List[Request]:
        cfg, dev = self.cfg, self.device
        for i in range(0, len(requests), self.batch):
            group = requests[i:i + self.batch]
            S = max(len(r.prompt) for r in group)
            steps = max(r.max_new_tokens for r in group)
            self._check_capacity(S, steps)
            toks = np.zeros((self.batch, S), np.int32)
            for j, r in enumerate(group):
                toks[j, S - len(r.prompt):] = r.prompt  # left-pad
            with _span("serving.generate", requests=len(group),
                       prompt_len=S, steps=steps):
                batch = {"tokens": torch.as_tensor(toks, device=dev)}
                if cfg.family == "encdec":
                    batch = {"frames": torch.zeros(
                        (self.batch, self.t_enc, cfg.d_model),
                        dtype=torch.float32, device=dev),
                        "dec_tokens": batch["tokens"]}
                if cfg.family == "vlm":
                    batch["patch_embeds"] = torch.zeros(
                        (self.batch, cfg.num_patches, D_VISION),
                        dtype=torch.float32, device=dev)
                cache = M.make_cache(cfg, self.batch, self.capacity,
                                     t_enc=self.t_enc or S, device=dev)
                # decode positions on the device: no host copy a step
                S0 = S + self._prefix()
                positions = torch.arange(S0, S0 + steps, dtype=torch.int32,
                                         device=dev)
                with _span("serving.prefill", tokens=self.batch * S0) as sp:
                    logits, cache = M.prefill_fn(self.params, cfg, self.rules,
                                                 batch, cache)
                    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                    _fence(sp, tok)
                outs = [tok]
                for s in range(steps - 1):
                    with _span("serving.decode", step=s) as sp:
                        logits, cache = M.decode_fn(self.params, cfg,
                                                    self.rules, tok,
                                                    positions[s], cache)
                        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                        _fence(sp, tok)
                    outs.append(tok)
                gen = torch.cat(outs, dim=1).to(torch.int32).cpu().numpy()
            for j, r in enumerate(group):
                r.out = gen[j, : r.max_new_tokens]
        return requests

    # -- serving-time diversity (serving.rerank) ----------------------------
    def rerank_group(self, requests: List[Request]) -> List[Request]:
        """Diverse-rerank one continuous-batching group: every request with
        ``candidates`` absorbs them into its session core-set and all the
        changed sessions solve in one fused run.  Slates land on
        ``r.slate`` (``r.slate_reused`` marks certificate-reuse hits).
        Needs a ``reranker=`` (``serving.OnlineReranker``)."""
        if self.reranker is None:
            raise ValueError("ServingEngine needs reranker= "
                             "(repro_torch.serving.OnlineReranker) to rerank")
        live = [(f"req-{i}" if r.session is None else r.session, r)
                for i, r in enumerate(requests) if r.candidates is not None]
        if not live:
            return requests
        with _launch_span("serving.rerank_group", LAUNCHES,
                          requests=len(live)):
            out = self.reranker.rerank_many({key: r.candidates
                                             for key, r in live})
        for key, r in live:
            res = out[key]
            r.slate = res.slate
            r.slate_reused = res.reused
        return requests

    def generate_diverse(self, requests: List[Request]) -> List[Request]:
        """``generate`` + ``rerank_group`` per continuous-batching group —
        a decode step's worth of requests reranks as one fused call."""
        for i in range(0, len(requests), self.batch):
            group = requests[i:i + self.batch]
            self.generate(group)
            self.rerank_group(group)
        return requests


def diverse_rerank(candidate_embeddings, k: int,
                   measure: str = "remote-edge", *, group_labels=None,
                   quotas=None, matroid=None, b=1, chunk: int = 0,
                   kprime=None, eps: float = 0.1, tau=None, cliff=None,
                   device=None, use_pallas="auto") -> np.ndarray:
    """Pick the k most diverse candidates; returns their indices.

    Legacy spelling of ``repro_torch.diversify`` (whose ``DiversityResult``
    also carries the candidate ``indices``) — prefer the facade for new
    code.  ``quotas`` (with per-candidate ``group_labels``) makes the
    result an exact-quota partition-matroid basis; ``matroid=`` takes any
    ``constrained.matroid`` oracle; ``group_labels`` alone balances k across
    the categories.  ``b``/``chunk``/``kprime``/``eps`` pass through to the
    engine (``b="auto"`` / ``kprime="auto"``: the radius-certified adaptive
    engine).  ``device``: where the run goes (default: the candidates'
    device when they are a tensor, else the card); ``use_pallas`` as in
    ``ExecutionSpec``.

    >>> import numpy as np
    >>> rng = np.random.default_rng(1)
    >>> emb = rng.normal(size=(64, 16)).astype(np.float32)
    >>> lab = rng.integers(0, 3, size=64)
    >>> idx = diverse_rerank(emb, 6, group_labels=lab, quotas=[2, 2, 2],
    ...                      device="cpu")
    >>> np.bincount(lab[idx], minlength=3).tolist()
    [2, 2, 2]
    """
    from ..api import ExecutionSpec, ProblemSpec, _warn_legacy, diversify

    _warn_legacy("repro_torch.serving.diverse_rerank")
    dev = resolve_device(device, like=candidate_embeddings)
    res = diversify(
        ProblemSpec(points=candidate_embeddings, k=k, measure=measure,
                    labels=group_labels, matroid=matroid, quotas=quotas),
        ExecutionSpec(mode="batch", kprime=kprime, b=b, chunk=chunk,
                      eps=eps, tau=tau, cliff=cliff, device=str(dev),
                      use_pallas=use_pallas))
    return res.indices
