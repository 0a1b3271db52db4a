"""Port parity for the chunk slice: ``ChunkState``, the chunk body and its
plain version, the chunk kernel's module, the engine's ``chunk_kernel``
path and the MEGAKERNEL presets through the scheduler.

Chunk operands come from the port's own scheduler planning seeded
sequences onto 8 lanes (mid-chunk recycling included), in crowded scenes
so that greedy and Hungarian association differ.  Against the reference
run eagerly (``jax.disable_jit()``) the plain version must agree bit for
bit; against jitted JAX, decisions exactly and floats within the
tolerances of ``test_torch_lane.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import slots as jslots  # noqa: E402
from repro.core import sort as jsort  # noqa: E402
from repro.kernels import chunk as jchunk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serve import StreamScheduler as JaxScheduler  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.sort_mot import (FUSED, MEGAKERNEL,  # noqa: E402
                                          MEGAKERNEL_GREEDY)
from repro_torch.core import slots  # noqa: E402
from repro_torch.core.sort import (SortEngine, chunk_state_of,  # noqa: E402
                                   lane_state_of_chunk)
from repro_torch.data.synthetic import (SceneConfig,  # noqa: E402
                                        generate_scene)
from repro_torch.kernels import chunk, ops, ref  # noqa: E402
from repro_torch.serve import StreamScheduler  # noqa: E402

X_TOL = dict(rtol=1e-5, atol=1e-4)
P_TOL = dict(rtol=1e-4, atol=1e-3)
BOX_TOL = dict(rtol=1e-5, atol=2e-3)
F, T, D, S = 5, 4, 3, 8
ROOT = Path(__file__).resolve().parents[1]


def _reference_presets():
    """The repository's ``configs/sort_mot.py``, where the reference's
    MEGAKERNEL presets live (a file, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_sort_mot", ROOT / "configs" / "sort_mot.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _crowded(n, seed, d, lengths=(2, 9)):
    """Short sequences of up to three objects in a small image: boxes
    overlap, so the assignment has real choices to make."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        _, _, db, dm = generate_scene(SceneConfig(
            num_frames=int(rng.integers(lengths[0], lengths[1])),
            max_objects=3, img_w=240, img_h=420, mean_size=60,
            det_noise=10.0, speed=15.0, fp_rate=0.5, seed=seed * 100 + i))
        seqs.append((f"s{i}", db[:, :d], dm[:, :d]))
    return seqs


def _planned_chunks(seed, t=T, d=D, s=S, f=F, n_chunks=2):
    """``n_chunks`` consecutive chunks as the scheduler plans them, in the
    chunk layout: ``det [F, D, 4, S]``, ``det_mask [F, D, S]``, ``active
    [F, 1, S]`` float32, ``reset [F, 1, S]`` int32 (numpy)."""
    cfg = dataclasses.replace(MEGAKERNEL.sort, max_trackers=t,
                              max_detections=d)
    sched = StreamScheduler(SortEngine(cfg, device="cpu"), num_lanes=s,
                            chunk=f)
    for name, db, dm in _crowded(14, seed, d):
        sched.submit(name, db, dm)
    chunks = []
    for _ in range(n_chunks):
        det, dm, act, rst, _ = sched._plan_chunk()
        sched.chunks_run += 1
        chunks.append((np.ascontiguousarray(det.transpose(0, 2, 3, 1)),
                       np.ascontiguousarray(
                           dm.transpose(0, 2, 1).astype(np.float32)),
                       act.astype(np.float32)[:, None],
                       rst.astype(np.int32)[:, None]))
    return sched.engine, chunks


def _mid_chunk(seed, t=T, d=D):
    """A mid-sequence state (after one planned chunk, plain version) and
    the next planned chunk, which recycles lanes mid-chunk."""
    engine, (first, second) = _planned_chunks(seed, t, d)
    state0 = chunk_state_of(engine.init_ragged(S))
    state1, _ = ref.chunk_lane(state0, *map(torch.from_numpy, first),
                               assoc="hungarian")
    assert second[3][1:].sum() > 0          # a lane recycles mid-chunk
    return state1, second


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(want, got, what):
    for name, w, g in zip(type(got)._fields, want, got):
        g = g.numpy()
        w = np.asarray(w)
        assert w.shape == g.shape and w.dtype == g.dtype, (what, name)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what}.{name}")


def _jax_state(cs):
    """The same state for the reference, through ``convert``."""
    return jref.ChunkState(**{k: jnp.asarray(v) for k, v in
                              convert.chunk_state_to_numpy(cs).items()})


@pytest.mark.parametrize("assoc", ["greedy", "hungarian", "gather"])
def test_chunk_lane_bitwise_vs_reference_eager(assoc):
    """The whole plain chunk (and its first step alone) against the
    reference's ``ref.chunk_lane`` run eagerly: every state leaf and every
    per-frame output, bit for bit.  ``gather`` hands both the assignment
    of a Hungarian run, as the reference's pre-pass does."""
    state, ops_np = _mid_chunk(5)
    t2d = None
    if assoc == "gather":
        _, pre = ref.chunk_lane(state, *map(torch.from_numpy, ops_np),
                                assoc="hungarian")
        t2d = pre.trk_to_det
        assert (t2d >= 0).any()
    mode = "greedy" if assoc == "gather" else assoc
    with jax.disable_jit():
        want_st, want = jref.chunk_lane(
            _jax_state(state), *map(jnp.asarray, ops_np),
            None if t2d is None else jnp.asarray(t2d.numpy()), assoc=mode)
    got_st, got = ref.chunk_lane(state, *map(torch.from_numpy, ops_np), t2d,
                                 assoc=mode)
    _assert_bitwise(want_st, got_st, f"{assoc} state")
    _assert_bitwise(want, got, f"{assoc} outs")
    assert got.emit.any() and got.matched_det.any()
    step_st, step = ref.step_chunk_lane(
        state, *(torch.from_numpy(a[0]) for a in ops_np),
        None if t2d is None else t2d[0], assoc=mode)
    _assert_bitwise([w[0] for w in want], step, f"{assoc} step")


def test_hungarian_and_greedy_chunks_differ():
    """The crowded operands are not a case where the two association
    algorithms agree anyway."""
    state, ops_np = _mid_chunk(5)
    args = (state, *map(torch.from_numpy, ops_np))
    _, hun = ref.chunk_lane(*args, assoc="hungarian")
    _, gre = ref.chunk_lane(*args, assoc="greedy")
    assert not torch.equal(hun.trk_to_det, gre.trk_to_det)


@pytest.mark.parametrize("variant", ["greedy", "hungarian"])
def test_fused_chunk_cpu_matches_pallas_interpret(variant):
    """The port's ``fused_chunk`` on CPU tensors (its plain version)
    against the Pallas kernel in interpret mode: greedy in both kernels,
    and for the Hungarian variant a gather by the port's Hungarian
    assignment in both (the Pallas kernel solves no JV itself)."""
    state, ops_np = _mid_chunk(1)
    ops_t = list(map(torch.from_numpy, ops_np))
    t2d = None
    if variant == "hungarian":
        _, pre = ref.chunk_lane(state, *ops_t, assoc="hungarian")
        t2d = pre.trk_to_det
    want_st, want = jchunk.fused_chunk(
        _jax_state(state), *map(jnp.asarray, ops_np),
        None if t2d is None else jnp.asarray(t2d.numpy()),
        assoc="greedy", block_s=4, interpret=True)
    before = chunk.fused_chunk.launches
    got_st, got = chunk.fused_chunk(state, *ops_t, t2d, assoc="greedy")
    assert chunk.fused_chunk.launches == before      # CPU: no launch
    for name, w, g in zip(ref.ChunkState._fields, want_st, got_st):
        w, g = np.asarray(w), g.numpy()
        if name == "x":
            np.testing.assert_allclose(g, w, **X_TOL)
        elif name == "p":
            np.testing.assert_allclose(g, w, **P_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               **BOX_TOL)
    for name in ("uid", "emit", "trk_to_det", "matched_det", "cls"):
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("t,d", [(4, 3), (6, 5), (3, 6), (8, 8)])
def test_assign_slots_unrolled_matches_scatter_and_reference(t, d):
    rng = np.random.default_rng(t * 10 + d)
    for _ in range(6):
        free = rng.random((t, 9)) < 0.5
        want = rng.random((d, 9)) < 0.6
        got = ref.assign_slots_lane_unrolled(torch.from_numpy(free),
                                             torch.from_numpy(want))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), slots.assign_slots_lane(
                torch.from_numpy(free), torch.from_numpy(want)).numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jref.assign_slots_lane_unrolled(jnp.asarray(free),
                                            jnp.asarray(want))))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jslots.assign_slots_lane(jnp.asarray(free), jnp.asarray(want))))


def test_chunk_state_conversions_are_exact():
    """``chunk_state_of`` and ``lane_state_of_chunk`` are inverses, and a
    reference ``ChunkState`` crosses through ``convert`` leaf for leaf."""
    state, _ = _mid_chunk(5)
    lane = lane_state_of_chunk(state)
    again = chunk_state_of(lane)
    for name, a, b in zip(ref.ChunkState._fields, state, again):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    jlane = jsort.LaneSortState(
        x=jnp.asarray(lane.x.numpy()), p=jnp.asarray(lane.p.numpy()),
        pool=jslots.SlotPool(**{k: jnp.asarray(v.numpy())
                                for k, v in lane.pool._asdict().items()}),
        frame_count=jnp.asarray(lane.frame_count.numpy()),
        embed=jnp.asarray(lane.embed.numpy()))
    jcs = jsort.chunk_state_of(jlane)
    fields = {k: np.asarray(v) for k, v in jcs._asdict().items()}
    ported = convert.chunk_state_from_numpy(fields, "cpu")
    for name, a, b in zip(ref.ChunkState._fields, ported, state):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    back = convert.chunk_state_to_numpy(ported)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    with pytest.raises(ValueError, match="missing"):
        convert.chunk_state_from_numpy({"x": fields["x"]})


@pytest.mark.parametrize("assoc", ["hungarian", "greedy"])
def test_engine_chunk_kernel_equals_per_frame_path(assoc):
    """``chunk_kernel=True`` and ``False`` serve the same submissions bit
    for bit over several chunks of mid-chunk recycling: tracks, counters
    and the final lane state."""
    cfg = dataclasses.replace(FUSED.sort, max_trackers=T, max_detections=D,
                              assoc=assoc)
    runs = []
    for chunk_kernel in (False, True):
        sched = StreamScheduler(
            SortEngine(dataclasses.replace(cfg, chunk_kernel=chunk_kernel),
                       device="cpu"), num_lanes=S, chunk=F)
        for name, db, dm in _crowded(20, 3, D):
            sched.submit(name, db, dm)
        runs.append((sched.run(), sched))
    (want, ws), (got, gs) = runs
    assert gs.chunks_run >= 3
    for w, g in zip(want, got):
        assert w.name == g.name
        np.testing.assert_array_equal(g.uid, w.uid)
        np.testing.assert_array_equal(g.emit, w.emit)
        np.testing.assert_array_equal(_bits(g.boxes), _bits(w.boxes))
    for attr in ("frames_processed", "lane_steps", "chunks_run",
                 "admissions"):
        assert getattr(gs, attr) == getattr(ws, attr), attr
    assert gs.utilization == ws.utilization
    a, b = ws._state, gs._state
    for name in ("x", "p", "frame_count", "embed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name, u, v in zip(a.pool._fields, a.pool, b.pool):
        assert torch.equal(u, v), name


@pytest.mark.parametrize("preset", ["MEGAKERNEL", "MEGAKERNEL_GREEDY"])
def test_megakernel_scheduler_matches_jax_scheduler(preset):
    """The port's scheduler over a MEGAKERNEL preset (cut to T=D=8 for the
    CPU) against the JAX scheduler over the reference's preset."""
    port = {"MEGAKERNEL": MEGAKERNEL,
            "MEGAKERNEL_GREEDY": MEGAKERNEL_GREEDY}[preset].sort
    reference = getattr(_reference_presets(), preset)
    assert convert.sort_config_from_dict(dataclasses.asdict(reference)) == port
    jcfg = dataclasses.replace(reference, max_trackers=8, max_detections=8)
    cfg = dataclasses.replace(port, max_trackers=8, max_detections=8)
    rng = np.random.default_rng(4)
    seqs = []
    for i in range(10):
        _, _, db, dm = generate_scene(SceneConfig(
            num_frames=int(rng.integers(3, 20)),
            max_objects=int(rng.integers(3, 7)), seed=400 + i))
        seqs.append((f"s{i}", db, dm))
    jsched = JaxScheduler(jsort.SortEngine(jcfg), num_lanes=4, chunk=8)
    tsched = StreamScheduler(SortEngine(cfg, device="cpu"), num_lanes=4,
                             chunk=8)
    for name, db, dm in seqs:
        jsched.submit(name, db, dm)
        tsched.submit(name, db, dm)
    want, got = jsched.run(), tsched.run()
    assert [g.name for g in got] == [s[0] for s in seqs]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.uid, w.uid, err_msg=g.name)
        np.testing.assert_array_equal(g.emit, w.emit, err_msg=g.name)
        np.testing.assert_allclose(g.boxes, w.boxes, **BOX_TOL,
                                   err_msg=g.name)
    for attr in ("frames_processed", "lane_steps", "chunks_run",
                 "admissions"):
        assert getattr(tsched, attr) == getattr(jsched, attr), attr


def test_chunk_step_modes_on_cpu():
    """``auto`` on CPU tensors is the plain version; ``kernel`` raises;
    bool ``emit``/``matched_det`` come out of either."""
    state, ops_np = _mid_chunk(4)
    args = (state, *map(torch.from_numpy, ops_np))
    before = chunk.fused_chunk.launches
    auto = ops.chunk_step(*args, assoc="hungarian")
    plain = ops.chunk_step(*args, assoc="hungarian", mode="ref")
    for a, b in zip((*auto[0], *auto[1]), (*plain[0], *plain[1])):
        assert torch.equal(a, b)
    assert auto[1].emit.dtype == torch.bool
    assert chunk.fused_chunk.launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.chunk_step(*args, mode="kernel")
    with pytest.raises(ValueError):
        ops.chunk_step(*args, assoc="auction")
    with pytest.raises(ValueError, match="mode"):
        ops.chunk_step(*args, mode="pallas")
