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

from repro_torch.configs.sort_mot import FUSED  # noqa: E402
from repro_torch.core.sort import SortEngine  # noqa: E402
from repro_torch.data.synthetic import (SceneConfig,  # noqa: E402
                                        generate_scene)
from repro_torch.kernels import frame, ops, ref  # noqa: E402
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
