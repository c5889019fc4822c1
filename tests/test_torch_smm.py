"""Port parity for the streaming core-set: ``repro_torch.core.smm`` on the
CPU (its plain distance tiles) against ``repro.core.smm``, the
paper-verbatim per-point oracle, itself under other chunkings, and a
reference stream carried across mid-way.

The streams grow in scale as they go, so far points turn up inside chunks
and T fills and merges several times.  What must be equal: T (its rows are
input rows, slot by slot), the valid count, ``e_cnt``, the delegates,
``n_phases``, the phase-log counts, ``generation``, the certificate's
counts/kprime/meets_target and the finalized core-set.  Floats derived
from distances — ``d_thr``, the phase log's d_i, the certificate's radius,
scale and ratio — agree to rtol 1e-5: ``d_thr`` starts as the smallest
positive pairwise distance of the boot prefix, where the factorized
euclidean form cancels (sqrt near 0) and arccos is steepest (sim near 1),
so a 1-ulp difference of an fp32 dot product summed in another order by
XLA and by torch shows up as a few 1e-6 of it.  Inside the port the same
stream under any chunking is equal bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import StreamingCoreset as RefSMM
from repro.obs import RunTrace as RefTrace, activate as ref_activate
from repro_torch import obs
from repro_torch.core import SMMState, StreamingCoreset
from repro_torch.interop import stream_from_reference, to_numpy

RTOL = 1e-5
K, KP = 4, 16


def _stream(n=600, d=3, seed=0):
    rg = np.random.default_rng(seed)
    scale = 1.0 + np.arange(n)[:, None] / 60.0
    return (rg.normal(size=(n, d)) * scale).astype(np.float32)


def _chunks(n, chunking):
    """Chunk boundaries: an int is a fixed size; "boot" is one chunk that
    spans the boot prefix (k'+1 rows) and then some, then 97-row chunks."""
    if chunking == "boot":
        cuts = [0, KP + 1 + 23] + list(range(KP + 1 + 23 + 97, n, 97))
    else:
        cuts = list(range(0, n, chunking))
    return list(zip(cuts, cuts[1:] + [n]))


def _feed(smm, stream, chunking):
    for a, b in _chunks(len(stream), chunking):
        smm.update(stream[a:b])
    return smm


def _port(stream, chunking, mode, metric, **kw):
    return _feed(StreamingCoreset(K, KP, stream.shape[1], metric=metric,
                                  mode=mode, device="cpu", **kw),
                 stream, chunking)


def _ref(stream, chunking, mode, metric, **kw):
    return _feed(RefSMM(K, KP, stream.shape[1], metric=metric, mode=mode,
                        **kw), stream, chunking)


def _host(state):
    return {f: np.asarray(to_numpy(getattr(state, f))) for f in state._fields}


def assert_state_equal(got, want, rtol=RTOL):
    g, w = _host(got.state), _host(want.state)
    valid = w["t_valid"]
    np.testing.assert_array_equal(g["t_valid"], valid)
    np.testing.assert_array_equal(g["T"][valid], w["T"][valid])
    np.testing.assert_array_equal(g["e_cnt"][valid], w["e_cnt"][valid])
    if got.mode == "ext":
        for j in np.flatnonzero(valid):
            c = int(w["e_cnt"][j])
            np.testing.assert_array_equal(g["e_pts"][j, :c],
                                          w["e_pts"][j, :c])
    np.testing.assert_array_equal(g["m_valid"], w["m_valid"])
    np.testing.assert_array_equal(g["M"][w["m_valid"]],
                                  w["M"][w["m_valid"]])
    assert int(g["n_phases"]) == int(w["n_phases"])
    np.testing.assert_allclose(float(g["d_thr"]), float(w["d_thr"]),
                               rtol=rtol)
    assert [n for n, _ in got.phase_log] == [n for n, _ in want.phase_log]
    np.testing.assert_allclose([d for _, d in got.phase_log],
                               [d for _, d in want.phase_log], rtol=rtol)
    assert got.n_seen == want.n_seen


def assert_cert_equal(got, want, rtol=RTOL):
    assert (got.kprime, got.kind, got.counts, got.meets_target) == \
        (want.kprime, want.kind, want.counts, want.meets_target)
    for f in ("radius", "scale", "ratio"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, err_msg=f)
    np.testing.assert_allclose(got.radii, want.radii, rtol=rtol)


def assert_coreset_equal(got, want, mode):
    cert_g, cert_w = got.cert, want.cert
    assert_cert_equal(cert_g, cert_w)
    np.testing.assert_allclose(float(got.radius), float(want.radius),
                               rtol=RTOL)
    g = {f: np.asarray(to_numpy(getattr(got, f)))
         for f in got._fields if f != "cert"}
    w = {f: np.asarray(getattr(want, f)) for f in want._fields
         if f != "cert"}
    if mode == "gen":
        np.testing.assert_array_equal(g["multiplicity"], w["multiplicity"])
        keep = w["multiplicity"] > 0
        np.testing.assert_array_equal(g["points"][keep], w["points"][keep])
    else:
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["weights"], w["weights"])
        np.testing.assert_array_equal(g["points"][w["valid"]],
                                      w["points"][w["valid"]])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("mode", ["plain", "ext", "gen"])
def test_matches_reference(mode, metric):
    # one point per update: the reference compiles one tail shape only
    stream = _stream(n=450)
    got = _port(stream, 1, mode, metric, eps=2.0)
    want = _ref(stream, 1, mode, metric, eps=2.0)
    assert len(want.phase_log) >= 3          # several merges ...
    assert_state_equal(got, want)
    assert got.generation == want.generation
    assert_cert_equal(got.certificate(), want.certificate())
    assert_coreset_equal(got.finalize(), want.finalize(), mode)


@pytest.mark.parametrize("chunking", [7, 250, "boot"])
def test_matches_reference_under_chunkings(chunking):
    stream = _stream(n=300, seed=1)
    got = _port(stream, chunking, "ext", "euclidean")
    want = _ref(stream, chunking, "ext", "euclidean")
    assert len(want.phase_log) >= 3
    assert_state_equal(got, want)
    assert got.generation == want.generation
    assert_coreset_equal(got.finalize(), want.finalize(), "ext")


def test_far_points_inside_chunks():
    # the far-point path runs mid-chunk: a chunk that both fills T (a merge
    # inside the chunk) and inserts more far points after the merge
    stream = _stream(n=500, seed=2)
    smm = StreamingCoreset(K, KP, 3, mode="gen", device="cpu")
    with obs.activate(obs.RunTrace(enabled=True)) as tr:
        _feed(smm, stream, 250)
    # one read per tail plus one per far insert, beyond the merges' reads
    assert tr.counters["host_syncs"] > 2 * len(smm.phase_log) + 2
    merged_mid = [n for n, _ in smm.phase_log if n % 250]
    assert len(merged_mid) >= 2


@pytest.mark.parametrize("mode", ["plain", "ext", "gen"])
def test_chunk_invariance_inside_the_port(mode):
    stream = _stream(n=700, seed=3)
    runs = [_port(stream, c, mode, "euclidean") for c in (1, 7, 250, "boot")]
    first = runs[0]
    for other in runs[1:]:
        assert_state_equal(other, first, rtol=0)
        a, b = first.finalize(), other.finalize()
        for f in a._fields:
            if f != "cert":
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.cert == b.cert


def reference_smm(stream, k, kprime):
    """Pure-python per-point doubling algorithm (paper §4 verbatim); a copy
    of the oracle in tests/test_smm.py."""
    cap = kprime + 1
    T = [p for p in stream[:cap]]
    rest = stream[cap:]
    # d1 = min positive pairwise
    d1 = np.inf
    for i in range(cap):
        for j in range(i + 1, cap):
            d = np.linalg.norm(T[i] - T[j])
            if d > 0:
                d1 = min(d1, d)
    d = d1 if np.isfinite(d1) else 1e-30
    M = []

    def merge(T, d):
        keep = []
        removed = []
        for t in T:
            if all(np.linalg.norm(t - u) > 2 * d for u in keep):
                keep.append(t)
            else:
                removed.append(t)
        return keep, removed

    T, M = merge(T, d)
    while len(T) >= cap:
        d *= 2
        T, M = merge(T, d)
    for p in rest:
        dist = min(np.linalg.norm(p - t) for t in T)
        if dist > 4 * d:
            T.append(p)
            if len(T) >= cap:
                d *= 2
                T, M = merge(T, d)
                while len(T) >= cap:
                    d *= 2
                    T, M = merge(T, d)
    return np.asarray(T), d, np.asarray(M) if M else np.zeros((0, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_per_point_oracle(seed):
    stream = np.random.default_rng(seed).normal(size=(3000, 3)) \
        .astype(np.float32)
    k, kp = 8, 32
    smm = StreamingCoreset(k, kp, 3, device="cpu")
    for i in range(0, 3000, 250):
        smm.update(stream[i:i + 250])
    got = np.asarray(sorted(map(tuple, smm.finalize().compact().numpy())))
    T_ref, d_ref, _ = reference_smm(stream, k, kp)
    assert len(T_ref) >= k
    want = np.asarray(sorted(map(tuple, T_ref)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(smm.state.d_thr), d_ref, rtol=RTOL)


@pytest.mark.parametrize("mode", ["plain", "ext", "gen"])
def test_reference_stream_resumes_in_the_port(mode):
    stream = _stream(n=450, seed=4)
    want = RefSMM(K, KP, 3, mode=mode)
    _feed(want, stream[:230], 1)
    arrays, meta = want.state_dict()
    got = stream_from_reference({n: np.asarray(a) for n, a in arrays.items()},
                                meta, device="cpu")
    for smm in (got, want):
        _feed(smm, stream[230:], 1)
    assert_state_equal(got, want)
    assert got.generation == want.generation
    assert_coreset_equal(got.finalize(), want.finalize(), mode)
    # and back: the port's state resumes in the reference
    arrays, meta = to_numpy(got)
    back = RefSMM.from_state_dict(arrays, meta)
    for smm in (got, back):
        _feed(smm, stream[:50], 1)
    assert_state_equal(got, back)


def test_pre_boot_state_crosses_over():
    stream = _stream(n=100, seed=5)
    want = RefSMM(K, KP, 3, mode="ext")
    want.update(stream[:9])                  # still buffering the prefix
    arrays, meta = want.state_dict()
    got = stream_from_reference({n: np.asarray(a) for n, a in arrays.items()},
                                meta, device="cpu")
    assert got.state is None and got.n_seen == 9
    for smm in (got, want):
        _feed(smm, stream[9:], 1)
    assert_state_equal(got, want)


def test_counters_match_reference():
    stream = _stream(n=300, seed=6)
    tr = obs.RunTrace(enabled=True)
    with obs.activate(tr):
        got = _port(stream, 1, "ext", "euclidean")
    rtr = RefTrace(enabled=True)
    with ref_activate(rtr):
        _ref(stream, 1, "ext", "euclidean")
    for name in ("points_absorbed", "merges"):
        assert tr.counters[name] == rtr.counters[name], name
    assert tr.counters["merges"] == len(got.phase_log)
    merges = [s for s in tr.spans if s.name == "smm.merge"]
    assert [s.attrs["n_processed"] for s in merges] == \
        [n for n, _ in got.phase_log]


def test_state_lives_on_the_device_and_small_streams():
    smm = StreamingCoreset(4, 16, 3, device="cpu")
    pts = _stream(n=10)
    smm.update(pts)
    assert smm.state is None
    cs = smm.finalize()                      # prefix-buffer path
    assert cs.size == 10 and cs.cert.radius == 0.0
    with pytest.raises(ValueError, match="< k=4"):
        StreamingCoreset(4, 16, 3, device="cpu").finalize()
    smm.update(_stream(n=200, seed=8))
    st = smm.state
    assert isinstance(st, SMMState)
    assert st.T.shape == (17, 3) and st.T.device.type == "cpu"
    assert st.e_cnt.dtype == torch.int32 and st.t_valid.dtype == torch.bool


def test_duplicate_points_dont_hang():
    pts = np.ones((500, 3), np.float32)
    pts[::7] = 2.0
    smm = StreamingCoreset(2, 8, 3, device="cpu")
    for i in range(0, 500, 100):
        smm.update(pts[i:i + 100])
    assert smm.finalize().size >= 2


def test_rejections():
    with pytest.raises(ValueError, match="true metric"):
        StreamingCoreset(2, 8, 3, metric="sqeuclidean", device="cpu")
    with pytest.raises(ValueError, match="k' must be >= k"):
        StreamingCoreset(9, 8, 3, device="cpu")
    # save/restore are ported (slice 12): a checkpoint of a stream still
    # in its prefix buffer restores to the same stream
    import tempfile

    from repro_torch.checkpoint import CheckpointManager

    smm = StreamingCoreset(2, 8, 3, device="cpu")
    smm.update(np.ones((3, 3), np.float32))
    with tempfile.TemporaryDirectory() as d:
        smm.save(CheckpointManager(d), 0)
        back, step = StreamingCoreset.restore(CheckpointManager(d),
                                              device="cpu")
    assert step == 0 and back.n_seen == 3 and back.state is None
