"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch: ``python -m pytest -q -m cuda
tests/test_torch_kernels.py``.  Tests that need the card carry the
``cuda`` marker and skip elsewhere (decided in a fixture, never at import
time).  With ``--fmad=false`` and the plain version's operation order, the
kernel must agree bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.sort_mot import FUSED, MEGAKERNEL  # noqa: E402
from repro_torch.core.sort import SortEngine, chunk_state_of  # noqa: E402
from repro_torch.data.synthetic import (SceneConfig,  # noqa: E402
                                        generate_scene)
from repro_torch.kernels import chunk, frame, ops, ref  # noqa: E402
from repro_torch.serve import StreamScheduler  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(seed, t, d, s, device):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(7, t, s)) * 20).astype(np.float32)
    x[2] = np.abs(x[2]) * 50 + 100
    x[3] = np.abs(x[3]) / 20 + 0.3
    a = rng.normal(size=(t, s, 7, 7)).astype(np.float32)
    p = (a @ a.swapaxes(-1, -2) + np.eye(7, dtype=np.float32))
    p = p.reshape(t, s, 49).transpose(2, 0, 1)
    xy = rng.uniform(-30, 30, size=(d, 2, s))
    wh = rng.uniform(5, 40, size=(d, 2, s))
    det = np.concatenate([xy, xy + wh], 1)
    dm = rng.random((d, s)) < 0.8
    alive = rng.random((t, s)) < 0.7
    act = rng.random((1, s)) < 0.6
    return [torch.tensor(np.ascontiguousarray(v), dtype=torch.float32,
                         device=device)
            for v in (x, p, det, dm, alive, act)]


def _bits(a):
    return a.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(16, 16), (5, 9), (32, 32)])
@pytest.mark.parametrize("variant", ["greedy", "hungarian"])
def test_fused_frame_kernel_matches_plain(cuda_device, variant, t, d):
    """Both variants, ragged stream edge (S=300 is no multiple of the
    block's 8 streams), the kernel's T/D bounds: bit for bit."""
    x, p, det, dm, alive, act = _operands(13, t, d, 300, cuda_device)
    t2d = (None if variant == "greedy" else ops._hungarian_stage(
        x, det, dm, alive, act, 0.3))
    before = frame.fused_frame.launches
    got = frame.fused_frame(x, p, det, dm, alive, act, t2d,
                            iou_threshold=0.3)
    torch.cuda.synchronize()
    assert frame.fused_frame.launches == before + 1
    want = ref.frame_lane(x, p, det, dm, alive, 0.3, active=act,
                          trk_to_det=t2d)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[3] > 0, want[3])


@pytest.mark.cuda
def test_fused_frame_kernel_rejects_what_it_does_not_take(cuda_device):
    x, p, det, dm, alive, act = _operands(2, 4, 3, 16, cuda_device)
    before = frame.fused_frame.launches
    with pytest.raises(TypeError):
        frame.fused_frame(x.double(), p, det, dm, alive)
    with pytest.raises(ValueError, match="contiguous"):
        frame.fused_frame(x, p, det, dm.T.contiguous().T, alive)
    with pytest.raises(ValueError, match="shape"):
        frame.fused_frame(x, p, det, dm, alive, act[:, :8])
    with pytest.raises(ValueError, match="T <= 32"):
        big = _operands(2, 33, 3, 16, cuda_device)
        frame.fused_frame(*big[:5])
    with pytest.raises(ValueError, match="is on"):
        frame.fused_frame(x, p, det.cpu(), dm, alive)
    assert frame.fused_frame.launches == before


@pytest.mark.cuda
def test_scheduler_on_card_kernel_equals_plain(cuda_device):
    """A short ragged serving run on the card: one launch per step, and
    the same tracks as with the plain version forced."""
    cfg = dataclasses.replace(FUSED.sort, max_trackers=8, max_detections=8)
    rng = np.random.default_rng(1)
    seqs = []
    for i in range(24):
        _, _, db, dm = generate_scene(SceneConfig(
            num_frames=int(rng.integers(2, 30)), max_objects=6, seed=i))
        seqs.append((f"s{i}", db, dm))
    runs = []
    for mode in ("auto", "ref"):
        sched = StreamScheduler(SortEngine(cfg, frame_mode=mode),
                                num_lanes=10, chunk=6)
        for name, db, dm in seqs:
            sched.submit(name, db, dm)
        before = frame.fused_frame.launches
        runs.append(sched.run())
        launched = frame.fused_frame.launches - before
        assert launched == (sched.chunks_run * 6 if mode == "auto" else 0)
    for a, b in zip(*runs):
        assert a.name == b.name
        np.testing.assert_array_equal(a.uid, b.uid)
        np.testing.assert_array_equal(a.emit, b.emit)
        np.testing.assert_array_equal(a.boxes.view(np.int32),
                                      b.boxes.view(np.int32))


def test_fused_frame_takes_only_cpu_or_cuda_tensors():
    """CPU tensors run the plain version; any other device is refused
    (here the meta device, which has no kernel and no plain version)."""
    x, p, det, dm, alive, act = _operands(4, 4, 3, 8, "cpu")
    before = frame.fused_frame.launches
    got = frame.fused_frame(x, p, det, dm, alive, act)
    want = ref.frame_lane(x, p, det, dm, alive, 0.3, active=act)
    assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    assert got[3].dtype == torch.int32 and torch.equal(got[3] > 0, want[3])
    assert frame.fused_frame.launches == before
    meta = [v.to("meta") for v in (x, p, det, dm, alive)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        frame.fused_frame(*meta)


# ------------------------------------------------------------ fused_chunk
def _chunk_operands(seed, t, d, s, frames, device):
    """A fresh chunk state and ``frames`` planned frames of boxes that move
    at constant velocity with jitter, plus clutter: ``det [F, D, 4, S]``,
    ``det_mask [F, D, S]`` (85%), ``active [F, 1, S]`` (90%), ``reset
    [F, 1, S]`` (every lane at frame 0, then 5% a frame)."""
    rng = np.random.default_rng(seed)
    k = max(1, min(t, d) - 1)
    ctr = rng.uniform(100, 900, size=(k, 2, s))
    wh = rng.uniform(30, 120, size=(k, 2, s))
    vel = rng.normal(0, 5, size=(k, 2, s))
    det = np.zeros((frames, d, 4, s), np.float32)
    for f in range(frames):
        c = ctr + vel * f + rng.normal(0, 2, size=ctr.shape)
        det[f, :k] = np.concatenate([c - wh / 2, c + wh / 2], axis=1)
        xy = rng.uniform(0, 1000, size=(d - k, 2, s))
        det[f, k:] = np.concatenate([xy, xy + 60], axis=1)
    dm = (rng.random((frames, d, s)) < 0.85).astype(np.float32)
    act = (rng.random((frames, 1, s)) < 0.9).astype(np.float32)
    rst = (rng.random((frames, 1, s)) < 0.05).astype(np.int32)
    rst[0] = 1
    cfg = dataclasses.replace(MEGAKERNEL.sort, max_trackers=t,
                              max_detections=d)
    state = chunk_state_of(SortEngine(cfg, device=device).init_ragged(s))
    return state, [torch.tensor(v, device=device) for v in (det, dm, act,
                                                            rst)]


def _contiguous(state):
    return ref.ChunkState(*(v.contiguous() for v in state))


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 7])
@pytest.mark.parametrize("t,d", [(16, 16), (5, 9), (32, 32)])
@pytest.mark.parametrize("variant", ["greedy", "gather", "hungarian"])
def test_fused_chunk_kernel_matches_plain(cuda_device, variant, t, d,
                                          frames):
    """Every variant from a warmed-up state (4 plain Hungarian frames),
    ragged stream edge (S=300), the kernel's T/D bounds: state, x, p and
    boxes bit for bit, every integer output equal."""
    state, ops_all = _chunk_operands(17, t, d, 300, 4 + frames, cuda_device)
    state, _ = ref.chunk_lane(state, *(a[:4] for a in ops_all),
                              assoc="hungarian")
    state = _contiguous(state)
    args = [a[4:].contiguous() for a in ops_all]
    t2d = None
    assoc = "greedy" if variant == "greedy" else "hungarian"
    if variant == "gather":
        _, pre = ref.chunk_lane(state, *args, assoc="hungarian")
        t2d = pre.trk_to_det.contiguous()
    before = chunk.fused_chunk.launches
    got_st, got = chunk.fused_chunk(state, *args, t2d, assoc=assoc)
    torch.cuda.synchronize()
    assert chunk.fused_chunk.launches == before + 1
    want_st, want = ref.chunk_lane(state, *args, t2d, assoc=assoc)
    for name, g, w in zip(ref.ChunkState._fields, got_st, want_st):
        if g.dtype == torch.float32:
            assert torch.equal(_bits(g), _bits(w)), name
        else:
            assert torch.equal(g, w), name
    assert torch.equal(_bits(got.boxes), _bits(want.boxes))
    for name in ("uid", "trk_to_det", "cls"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.emit > 0, want.emit)
    assert torch.equal(got.matched_det > 0, want.matched_det)
    assert want.matched_det.any() and want.emit.any()


@pytest.mark.cuda
def test_fused_chunk_kernel_rejects_what_it_does_not_take(cuda_device):
    state, args = _chunk_operands(3, 4, 3, 16, 2, cuda_device)
    state = _contiguous(state)
    before = chunk.fused_chunk.launches
    with pytest.raises(TypeError):
        chunk.fused_chunk(state._replace(x=state.x.double()), *args)
    with pytest.raises(TypeError):
        chunk.fused_chunk(state, *args[:3], args[3].float())
    with pytest.raises(ValueError, match="contiguous"):
        chunk.fused_chunk(state, args[0], args[1].transpose(1, 2)
                          .contiguous().transpose(1, 2), *args[2:])
    with pytest.raises(ValueError, match="shape"):
        chunk.fused_chunk(state, args[0], args[1][:1], *args[2:])
    with pytest.raises(ValueError, match="is on"):
        chunk.fused_chunk(state, args[0].cpu(), *args[1:])
    with pytest.raises(ValueError, match="embedding"):
        chunk.fused_chunk(state._replace(embed=torch.zeros(
            (2, 4, 16), device=cuda_device)), *args)
    big, big_args = _chunk_operands(3, 33, 3, 16, 2, cuda_device)
    with pytest.raises(ValueError, match="T <= 32"):
        chunk.fused_chunk(_contiguous(big), *big_args)
    assert chunk.fused_chunk.launches == before


def _megakernel_sequences():
    rng = np.random.default_rng(2)
    seqs = []
    for i in range(24):
        _, _, db, dm = generate_scene(SceneConfig(
            num_frames=int(rng.integers(2, 30)), max_objects=6, seed=50 + i))
        seqs.append((f"s{i}", db, dm))
    return seqs


def _serve(cfg, seqs, frame_mode="auto"):
    sched = StreamScheduler(SortEngine(cfg, frame_mode=frame_mode),
                            num_lanes=10, chunk=6)
    for name, db, dm in seqs:
        sched.submit(name, db, dm)
    before = chunk.fused_chunk.launches
    tracks = sched.run()
    return tracks, sched, chunk.fused_chunk.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("assoc", ["hungarian", "greedy"])
def test_megakernel_scheduler_on_card(cuda_device, assoc):
    """MEGAKERNEL (cut to T=D=8) on the card: one launch per chunk, the
    same tracks as with the plain version forced, and the same tracks bit
    for bit as the per-frame FUSED path."""
    cfg = dataclasses.replace(MEGAKERNEL.sort, max_trackers=8,
                              max_detections=8, assoc=assoc)
    seqs = _megakernel_sequences()
    got, sched, launched = _serve(cfg, seqs, "auto")
    assert launched == sched.chunks_run > 1
    plain, plain_sched, plain_launched = _serve(cfg, seqs, "ref")
    assert plain_launched == 0
    fused, _, _ = _serve(dataclasses.replace(cfg, chunk_kernel=False), seqs)
    for a, b, c in zip(got, plain, fused):
        assert a.name == b.name == c.name
        for other in (b, c):
            np.testing.assert_array_equal(a.uid, other.uid)
            np.testing.assert_array_equal(a.emit, other.emit)
            np.testing.assert_array_equal(a.boxes.view(np.int32),
                                          other.boxes.view(np.int32))
    assert sched.lane_steps == plain_sched.lane_steps
    assert sched.utilization == plain_sched.utilization


@pytest.mark.cuda
@pytest.mark.parametrize("assoc", ["hungarian", "greedy"])
def test_chunk_step_on_card_runs_no_plain_version(cuda_device, monkeypatch,
                                                  assoc):
    """With the plain chunk versions made to raise, the kernel-mode chunk
    step still runs: the Hungarian solve is inside the launch."""
    state, args = _chunk_operands(5, 16, 16, 64, 4, cuda_device)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    monkeypatch.setattr(ref, "chunk_lane", refuse)
    monkeypatch.setattr(ref, "step_chunk_lane", refuse)
    monkeypatch.setattr(ref, "frame_lane", refuse)
    new, outs = ops.chunk_step(state, *args, assoc=assoc, mode="kernel")
    torch.cuda.synchronize()
    assert outs.emit.dtype == torch.bool and outs.emit.any()
    assert new.x.is_cuda


def test_fused_chunk_takes_only_cpu_or_cuda_tensors():
    """CPU tensors run the plain version (int32 ``emit``/``matched_det``,
    no launch); any other device is refused."""
    state, args = _chunk_operands(4, 4, 3, 8, 3, "cpu")
    before = chunk.fused_chunk.launches
    got_st, got = chunk.fused_chunk(state, *args, assoc="hungarian")
    want_st, want = ref.chunk_lane(state, *args, assoc="hungarian")
    assert chunk.fused_chunk.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got_st, want_st))
    assert got.emit.dtype == torch.int32
    assert torch.equal(got.emit > 0, want.emit)
    assert torch.equal(got.matched_det > 0, want.matched_det)
    meta = ref.ChunkState(*(v.to("meta") for v in state))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        chunk.fused_chunk(meta, *(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="assoc"):
        chunk.fused_chunk(state, *args, assoc="auction")
