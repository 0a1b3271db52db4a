"""Port parity for the whole slice: engine, scheduler, state conversion,
and the port's device and import rules.

The JAX scheduler and engine run jitted, so XLA may fuse and reorder
their float arithmetic; track decisions (uid, emit) must still be equal
exactly, and boxes agree within ``BOX_TOL``.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import sort_mot as jconfigs  # noqa: E402
from repro.core import sort as jsort  # noqa: E402
from repro.serve import StreamScheduler as JaxScheduler  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.sort_mot import FUSED, SERVICE  # noqa: E402
from repro_torch.core.sort import (SortEngine, lane_state_of,  # noqa: E402
                                   sort_state_of)
from repro_torch.data.synthetic import (SceneConfig,  # noqa: E402
                                        generate_scene)
from repro_torch.kernels import frame  # noqa: E402
from repro_torch.serve import StreamScheduler  # noqa: E402

# boxes are pixel coordinates (up to ~2000): jitted XLA vs eager float32
# differ by a few ulps per frame (1 ulp at 1024 is 1.2e-4), accumulated
# over a sequence's frames
BOX_TOL = dict(rtol=1e-5, atol=2e-3)
STATE_TOL = dict(rtol=1e-5, atol=1e-3)
SRC = Path(__file__).resolve().parents[1] / "src"


def _small(assoc="hungarian"):
    """FUSED with its widths cut to T=D=8 for the CPU."""
    return dataclasses.replace(FUSED.sort, max_trackers=8, max_detections=8,
                               assoc=assoc)


def _sequences(n, seed, lengths=(3, 25)):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        f = int(rng.integers(lengths[0], lengths[1] + 1))
        _, _, db, dm = generate_scene(SceneConfig(
            num_frames=f, max_objects=int(rng.integers(3, 7)),
            seed=seed * 1000 + i))
        seqs.append((f"s{i}", db, dm))
    return seqs


@pytest.mark.parametrize("assoc", ["hungarian", "greedy"])
def test_scheduler_matches_jax_scheduler(assoc):
    """Ragged submissions through 4 recycled lanes, chunk 8: the port's
    scheduler on the CPU against the JAX scheduler, sequence by sequence."""
    cfg = _small(assoc)
    seqs = _sequences(10, 3)
    jsched = JaxScheduler(jsort.SortEngine(jsort.SortConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "cost"})), num_lanes=4, chunk=8)
    before = frame.fused_frame.launches
    tsched = StreamScheduler(SortEngine(cfg, device="cpu"), num_lanes=4,
                             chunk=8)
    for name, db, dm in seqs:
        jsched.submit(name, db, dm)
        tsched.submit(name, db, dm)
    want, got = jsched.run(), tsched.run()
    assert frame.fused_frame.launches == before       # CPU: plain version
    assert [g.name for g in got] == [s[0] for s in seqs]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.uid, w.uid, err_msg=g.name)
        np.testing.assert_array_equal(g.emit, w.emit, err_msg=g.name)
        np.testing.assert_allclose(g.boxes, w.boxes, **BOX_TOL,
                                   err_msg=g.name)
    assert g.uid.dtype == np.int32 and g.emit.dtype == bool
    for attr in ("frames_processed", "lane_steps", "chunks_run",
                 "admissions"):
        assert getattr(tsched, attr) == getattr(jsched, attr), attr
    assert tsched.utilization == jsched.utilization
    assert not tsched.busy


def _chunk_operands(seqs, lanes, frames, start):
    """Two chunks' worth of a hand-planned lane schedule: lane ``l`` serves
    ``seqs[l]`` from frame 0 (reset at step 0) and goes idle when it ends."""
    d = 8
    det = np.zeros((frames, lanes, d, 4), np.float32)
    dm = np.zeros((frames, lanes, d), bool)
    act = np.zeros((frames, lanes), bool)
    reset = np.zeros((frames, lanes), bool)
    for lane, (_, db, m) in enumerate(seqs[:lanes]):
        for f in range(frames):
            k = start + f
            if k < db.shape[0]:
                det[f, lane, :db.shape[1]] = db[k]
                dm[f, lane, :m.shape[1]] = m[k]
                act[f, lane] = True
                reset[f, lane] = k == 0
    return det, dm, act, reset


def _lane_fields(lane):
    out = {"x": lane.x, "p": lane.p, "frame_count": lane.frame_count,
           "embed": lane.embed, **lane.pool._asdict()}
    return {k: np.asarray(v) for k, v in out.items()}


def test_chunk_from_converted_mid_sequence_state():
    """The JAX engine runs a chunk; its state crosses to the port through
    ``convert``; both then run the next chunk from that same state."""
    cfg = _small()
    jeng = jsort.SortEngine(jsort.SortConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "cost"}))
    teng = SortEngine(cfg, device="cpu")
    seqs = _sequences(4, 11, lengths=(8, 14))
    chunk = jax.jit(jeng.run_chunk_ragged)
    jstate, _ = chunk(jeng.init_ragged(4), *map(
        jnp.asarray, _chunk_operands(seqs, 4, 6, 0)))
    fields = _lane_fields(jstate)
    tstate = convert.lane_state_from_numpy(fields, "cpu")
    back = convert.lane_state_to_numpy(tstate)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ops2 = _chunk_operands(seqs, 4, 6, 6)
    jstate2, jout = chunk(jstate, *map(jnp.asarray, ops2))
    tstate2, tout = teng.run_chunk_ragged(tstate,
                                          *map(torch.from_numpy, ops2))
    np.testing.assert_array_equal(tout.uid.numpy(), np.asarray(jout.uid))
    np.testing.assert_array_equal(tout.emit.numpy(), np.asarray(jout.emit))
    np.testing.assert_array_equal(tout.matched_det.numpy(),
                                  np.asarray(jout.matched_det))
    np.testing.assert_allclose(tout.boxes.numpy(), np.asarray(jout.boxes),
                               **BOX_TOL)
    got, want = convert.lane_state_to_numpy(tstate2), _lane_fields(jstate2)
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], **STATE_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sort_config_from_reference_fields():
    for ref_cfg, port_cfg in ((jconfigs.FUSED.sort, FUSED.sort),
                              (jconfigs.SERVICE.sort, SERVICE.sort)):
        assert convert.sort_config_from_dict(
            dataclasses.asdict(ref_cfg)) == port_cfg
    assert FUSED.streams_per_chip == jconfigs.FUSED.streams_per_chip == 2048
    with pytest.raises(ValueError, match="unknown"):
        convert.sort_config_from_dict({"max_trackers": 4, "mesh": 2})


def test_run_and_step_agree_with_lane_state_roundtrip():
    """``run`` (lane layout throughout) equals ``step`` frame by frame
    (converting each frame), and the layout converters are inverses."""
    eng = SortEngine(_small(), device="cpu")
    d = eng.config.max_detections
    seqs = _sequences(3, 5, lengths=(10, 10))
    frames = torch.from_numpy(np.stack(
        [np.pad(db, ((0, 0), (0, d - db.shape[1]), (0, 0)))
         for _, db, _ in seqs], 1))
    masks = torch.from_numpy(np.stack(
        [np.pad(dm, ((0, 0), (0, d - dm.shape[1]))) for _, _, dm in seqs], 1))
    state_run, outs = eng.run(eng.init(3), frames, masks)
    state = eng.init(3)
    for f in range(frames.shape[0]):
        state, out = eng.step(state, frames[f], masks[f])
        for a, b in zip(out, outs):
            assert torch.equal(a, b[f])
    for a, b in zip((*state[:2], *state.pool, *state[3:]),
                    (*state_run[:2], *state_run.pool, *state_run[3:])):
        assert torch.equal(a, b)
    again = sort_state_of(lane_state_of(state))
    assert torch.equal(again.p, state.p) and torch.equal(again.x, state.x)


def test_device_rules(monkeypatch):
    """No device means the card; without CUDA that raises rather than
    quietly running on the CPU.  Unported paths raise by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SortEngine(FUSED.sort)
    with pytest.raises(RuntimeError, match="CUDA"):
        SortEngine(FUSED.sort, device="cuda")
    assert SortEngine(FUSED.sort, device="cpu").device.type == "cpu"
    for change, error, name in (
            (dict(use_kernels=False), NotImplementedError, "per-phase"),
            (dict(chunk_kernel=True, use_kernels=False), ValueError,
             "use_kernels=True"),
            (dict(num_classes=3), NotImplementedError, "multi-class")):
        with pytest.raises(error, match=name):
            SortEngine(dataclasses.replace(FUSED.sort, **change),
                       device="cpu")
    eng = SortEngine(_small(), device="cpu")
    with pytest.raises(NotImplementedError):
        StreamScheduler(eng, num_lanes=4, mesh=object())
    with pytest.raises(NotImplementedError):
        StreamScheduler(eng, num_lanes=4, min_lanes=2, max_lanes=8)


def test_scheduler_validation_and_drain_edges():
    eng = SortEngine(_small(), device="cpu")
    sched = StreamScheduler(eng, num_lanes=2, chunk=4)
    with pytest.raises(ValueError, match="detection slots"):
        sched.submit("wide", np.zeros((3, 9, 4)), np.zeros((3, 9), bool))
    _, db, dm = _sequences(1, 9, lengths=(5, 5))[0]
    assert sched.submit("empty", db[:0], dm[:0]) == 0
    assert sched.busy and [r.name for r in sched.pop_ready()] == ["empty"]
    sched.submit("one", db, dm)
    sched.submit("two", db[:1], dm[:1])
    results = sched.run()
    assert [r.name for r in results] == ["one", "two"]
    assert results[1].num_frames == 1 and not sched.busy
    assert sched.frames_processed == 6 and sched.chunks_run == 2


_MODULE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_port_imports_no_jax_and_nothing_of_repro():
    """In a fresh interpreter, importing every module of the port loads
    neither JAX nor any module of the JAX package; and no source file of
    the port names either in an import."""
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(SRC / "repro_torch")
                                  .with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py")
        if p.name != "__init__.py") + ["repro_torch"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    root = Path(repro_torch.__file__).parent
    for path in [*root.rglob("*.py"), SRC.parent / "chip_smoke.py"]:
        hit = _MODULE.search(path.read_text())
        assert hit is None, f"{path} imports {hit.group(1)}"


def test_data_copies_match_reference(tmp_path):
    """The port's copies of the scene generator, Table I and the MOT15
    writer give the reference's scenes, sizes and files."""
    from repro.data import mot as jmot
    from repro.data import synthetic as jsyn
    from repro_torch.data import mot
    cfg = dict(num_frames=30, max_objects=9, seed=7)
    for got, want in zip(generate_scene(SceneConfig(**cfg)),
                         jsyn.generate_scene(jsyn.SceneConfig(**cfg))):
        np.testing.assert_array_equal(got, want)
    assert mot.TABLE_I == jmot.TABLE_I
    tracks = _sequences(1, 2)[0]
    boxes = np.concatenate([tracks[1], tracks[1][:, :1]], 1)
    uid = np.arange(boxes.shape[1])[None].repeat(boxes.shape[0], 0)
    emit = np.ones(uid.shape, bool)
    mot.write_results(tmp_path / "a.txt", boxes, uid, emit)
    jmot.write_results(tmp_path / "b.txt", boxes, uid, emit)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
