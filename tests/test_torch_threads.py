"""One torch intra-op thread in every test process.

The tier-1 command runs six test workers side by side on the machine's
cores.  Torch's intra-op pool puts a thread on every core in each of
them, and its threads spin between operations, so six pools oversubscribe
the cores several times over: a port test that takes 0.8 s alone took
102 s in such a run.  The port's tests work on small tensors that gain
nothing from the pool.  Every worker imports every test module when it
collects the suite, so the setting below holds in each worker for the
whole session (a run of single files keeps torch's default).
"""
import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
