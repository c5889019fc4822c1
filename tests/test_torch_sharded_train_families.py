"""The sharded training step of the families ``test_torch_sharded_train``
does not run: gemma2, phi-3-vision, mamba2, recurrentgemma (at 4 layers,
as every other recurrentgemma test runs it) and seamless, reduced, on a
(2, 2) ``("data", "model")`` mesh of four gloo CPU ranks with AdamW,
against the reference's sharded step on a 4-device CPU mesh of
``AxisType.Auto`` axes and against the port's own one-rank step.

The harness is ``test_torch_sharded_train``'s (its rank and reference
scripts, its seeded inputs: N(0, 0.05) params, norms zero, 8 rows a
batch, 2 steps, lr 1e-3; the vlm's patches and the encdec's frames
N(0, 1)), started here on these cases alone, so the two files run on
different workers, with one reference subprocess a case.  What each case computes tensor-parallel over
``model``: every family's MLPs (the hybrid's ``m_*``) and vocab (gemma2's
tied head under its logit softcap, the vlm's loss over its text
positions); gemma2's, phi-3-vision's and seamless's attention over their
heads (``attn_shard="heads"``; seamless's cross attention over its
``x*`` heads), recurrentgemma's over its head dim (its reduced config's
``head_dim``).

Held as the other file holds its cases: against the reference's sharded
step in bf16, loss and ``grad_norm`` within 4 times the reference's own
sharded-vs-one-device distance (floors 2e-5 and 1e-3 of the reference's
value) and each param entry within twice the largest change the two
steps made to its leaf plus a bf16 ulp, the leaf's mean within 4 times
the reference's own mean distance (floor 2^-10 of its mean entry; a bf16
ulp, 2^-8, for mamba2's ``Dskip``, ``conv_b`` and ``conv_w``, whose bf16
gradient the two packages round differently on one device already:
``BF16_SUMMED``); against the one-rank step in
float64, the loss of both steps and the step-0 gradient leaf by leaf
within 1e-10, the params within 8 fp32 ulps of the leaf's largest entry.
"""
import time

from conftest import SUBPROC_ENV

import numpy as np
import pytest

import test_torch_sharded_train as base

# name: (arch, mesh shape, optimizer, accum_steps, config overrides)
CASES = {"gemma2_adamw_2x2": ("gemma2-27b", (2, 2), "adamw", 1, {}),
         "phi3v_adamw_2x2": ("phi-3-vision-4.2b", (2, 2), "adamw", 1, {}),
         "mamba2_adamw_2x2": ("mamba2-130m", (2, 2), "adamw", 1, {}),
         "recurrentgemma_adamw_2x2": ("recurrentgemma-9b", (2, 2), "adamw",
                                      1, {"num_layers": 4}),
         "seamless_adamw_2x2": ("seamless-m4t-large-v2", (2, 2), "adamw", 1,
                                {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train_families")
    base._inputs(out / "inputs.npz", CASES)
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    base._finish(base.spawn(out, env, CASES, (), split=True),
                 t0 + base.SPAWN_TIMEOUT)

    def load(who):
        import pickle
        if who == "reference":
            return {k: load(f"reference{k}")[k] for k in CASES}
        with open(out / f"{who}.pkl", "rb") as f:
            return pickle.load(f)
    load.seconds = time.monotonic() - t0
    load.inputs = dict(np.load(out / "inputs.npz"))
    print(f"ranks and reference: {load.seconds:.1f} s")
    return load


# the ssm leaves whose broadcast gradient the reference's compiled backward
# sums with a bf16 rounding after every add and the port in fp32, rounded
# once (ROADMAP C, decided differences): the port's one-device bf16
# step already parts from the reference's there by about a bf16 ulp of the
# leaf's mean entry (mamba2's Dskip 6.3e-5 after 2 steps, its sharded step
# equal to its one-rank step), so their mean is held at that ulp
BF16_SUMMED = ("['Dskip']", "['conv_b']", "['conv_w']")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference(runs, case):
    got = runs("rank0")[case]
    assert "error" not in got, got.get("error")
    ref = runs("reference")[case]
    for (l, g), (rl, rg), (ol, og) in zip(got["bf16"]["metrics"],
                                         ref["sharded"]["metrics"],
                                         ref["one"]["metrics"]):
        tol, err = base._tol(l, rl, ol, 2e-5 * abs(rl))
        assert err <= tol, (case, "loss", l, rl, ol)
        tol, err = base._tol(g, rg, og, 1e-3 * abs(rg))
        assert err <= tol, (case, "grad_norm", g, rg, og)
    arch = CASES[case][0]
    ssm = arch.startswith("mamba2")
    for key, want in ref["sharded"]["params"].items():
        have = got["bf16"]["params"][key].astype(np.float32)
        own = np.abs(want - ref["one"]["params"][key])
        ulp = 2.0 ** -8 * float(np.abs(want).max())
        floor = 2.0 ** (-8 if ssm and key.endswith(BF16_SUMMED) else -10)
        assert float(np.abs(have - want).mean()) <= max(
            4 * float(own.mean()), floor * float(np.abs(want).mean()),
            1e-12), key
        moved = float(np.abs(want - runs.inputs[f"{arch}|{key}"]).max())
        assert float(np.abs(have - want).max()) <= 2 * moved + ulp, key


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_one_rank_in_float64(runs, case):
    got = runs("rank0")[case]
    assert "error" not in got, got.get("error")
    one = got["one_rank"]
    for (l, _), ol in zip(got["f64"]["metrics"], one["losses"]):
        assert abs(l - ol) <= 1e-10 * abs(ol), (case, l, ol)
    for key, want in one["grads0"].items():
        err = np.linalg.norm(got["grads0"][key] - want)
        assert err <= 1e-10 * np.linalg.norm(want), (case, key, err)
    for key, want in one["params"].items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got["f64"]["params"][key], want, rtol=0,
                                   atol=8 * 2.0 ** -24 * scale,
                                   err_msg=key)


@pytest.mark.parametrize("rank", range(base.WORLD))
def test_local_shapes_are_the_specs_shards(runs, rank):
    rec = runs(f"rank{rank}")
    for case in CASES:
        assert rec[case]["bad_local_shapes"] == [], case
        assert rec[case]["n_leaves"] > 0
        assert rec[case]["init_state_equal"], case
