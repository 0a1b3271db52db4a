"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main paths from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all started
   together);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes and time both with CUDA events, reading the SM clock
   before and after each kernel's timing: ``fused_frame`` (S=2048 streams,
   T=D=16) in its two variants, and ``fused_chunk`` (the same widths, a
   32-frame chunk planned from the main path's submissions, from the state
   its first chunk leaves) in its three (in-kernel Hungarian, greedy, and
   the gather by a given assignment);
4. drive the main paths, each on 2048 lanes at chunk 32 over a few
   thousand ragged synthetic sequences (lengths 32-128 frames, object
   counts from paper Table I): the FUSED preset (one ``fused_frame`` launch
   per frame, fed by the plain-torch Hungarian stage), then MEGAKERNEL and
   MEGAKERNEL_GREEDY (one ``fused_chunk`` launch per chunk).  Each path
   counts its kernel's launches, splits its step time with CUDA events and
   host clocks, serves the same submissions again with the plain version
   forced and requires equal tracks, and profiles one chunk for the card's
   idle share; MEGAKERNEL's tracks must also equal FUSED's bit for bit;
5. print one ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, ...}`` line.

Needs CUDA; exits non-zero without it.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("REPRO_TORCH_BUILD", str(ROOT / "build"))

CHUNK = 32
NUM_SEQUENCES = 3072
SEQ_FRAMES = (32, 128)     # cut from Table I's 71-1000 frames for run time
SEED = 0
TIMED_LAUNCHES = 100
# H100 memory rate and float32 (non-tensor-core) peak, by the card's name
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12}
MEM_RATE_DEFAULT = 3.35e12          # H100 SXM, HBM3
F32_PEAK = 67e12
# float operations per active tracker in one frame: predict 104, update
# ~1040 (4x4 inverse, gain, mean and covariance, the masked blend)
OPS_PER_TRACKER = 1144
IOU_OPS_PER_PAIR = 17               # greedy variant: one IoU per (d, t)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sm_clocks() -> str:
    """The SM clock and its maximum, MHz, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return MEM_RATE_DEFAULT


def call_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds per call on the card's timeline, one call at a
    time between CUDA events: device time plus any wait on the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int, batches: int = 5) -> float:
    """Milliseconds per call on the card alone: each batch of ``reps``
    calls is queued behind a sleep kernel long enough to cover the host's
    enqueue time, so the card runs them back to back.  Median of the
    batch means; CUDA events around each batch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(sleep_cycles_per_ms() * (2 * enqueue_ms + 1))
    means = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return float(np.median(means))


def sleep_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def profiled_ms(fn) -> tuple[float, float, int]:
    """(wall ms, device-busy ms, device operations) of one call of ``fn``
    under ``torch.profiler`` (device activity only); busy is nan where the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_ = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops_:
        return wall_ms, float("nan"), 0
    return (wall_ms, sum(e.time_range.elapsed_us() for e in ops_) / 1e3,
            len(ops_))


class Spans:
    """CUDA events around every call of ``module.name`` while in the
    ``with`` block, recorded without synchronising; :meth:`ms` sums the
    spans on the card's timeline."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.pairs = []

    def __enter__(self):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


# ------------------------------------------------------------- phase 2
def build_kernels() -> None:
    from repro_torch.kernels import build
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    for name, lib in zip(sources, libs):
        log = lib.with_name(lib.name + ".log").read_text().strip()
        print(f"built csrc/{name}.cu -> {lib.relative_to(ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  ptxas:", line.strip())


# ------------------------------------------------------------- phase 3
def frame_inputs(s: int, t: int, d: int, device, seed: int):
    """Lane-layout operands of one frame: plausible boxes, SPD
    covariances, 80% valid detections, 70% live slots, 25% idle lanes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1800, size=(t, 2, s))
    wh = rng.uniform(20, 200, size=(t, 2, s))
    x = np.zeros((7, t, s), np.float32)
    x[0], x[1] = xy[:, 0] + wh[:, 0] / 2, xy[:, 1] + wh[:, 1] / 2
    x[2], x[3] = wh[:, 0] * wh[:, 1], wh[:, 0] / wh[:, 1]
    x[4:] = rng.normal(0, 2, size=(3, t, s))
    a = rng.normal(size=(t, s, 7, 7)).astype(np.float32)
    p = (a @ a.swapaxes(-1, -2) + np.eye(7, dtype=np.float32))
    p = p.reshape(t, s, 49).transpose(2, 0, 1)
    # detections: jittered copies of the slots' boxes plus clutter
    ctr = x[:2, :d].transpose(1, 0, 2) + rng.normal(0, 4, size=(d, 2, s))
    half = wh[:d] / 2
    det = np.concatenate([ctr - half, ctr + half], axis=1)
    det[d // 2:] = np.concatenate([xy[:d - d // 2], xy[:d - d // 2] + 60], 1)
    dm = rng.random((d, s)) < 0.8
    alive = rng.random((t, s)) < 0.7
    act = rng.random((1, s)) < 0.75

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return (dev(x), dev(p), dev(det), dev(dm), dev(alive), dev(act))


def frame_bytes(t: int, d: int, s: int, variant: str) -> int:
    """Bytes fused_frame must move: each operand its variant reads, once,
    and each output, once (float32 and int32 are 4 bytes)."""
    state = (7 + 49) * t * s
    ins = state + 4 * d * s + s                     # x, p, det, active
    # the Hungarian variant reads trk_to_det; greedy, det_mask and alive
    ins += t * s if variant == "hungarian" else d * s + t * s
    outs = state + t * s + d * s                    # x, p, t2d, matched_det
    return 4 * (ins + outs)


def check_kernel(device, name: str, s=2048, t=16, d=16):
    from repro_torch.kernels import frame, ops, ref
    x, p, det, dm, alive, act = frame_inputs(s, t, d, device, SEED)
    t2d = ops._hungarian_stage(x, det, dm, alive, act, 0.3)
    n_active = int(act.sum().item()) * t
    rate = mem_rate(name)
    rows = {}
    for variant, t2d_in in (("hungarian", t2d), ("greedy", None)):
        def kernel():
            return frame.fused_frame(x, p, det, dm, alive, act, t2d_in,
                                     iou_threshold=0.3)

        def plain():
            return ref.frame_lane(x, p, det, dm, alive, 0.3, active=act,
                                  assoc="greedy", trk_to_det=t2d_in)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got[2], want[2]):
            raise AssertionError(f"{variant}: trk_to_det differs")
        if not torch.equal(got[3] > 0, want[3]):
            raise AssertionError(f"{variant}: matched_det differs")
        err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
        bitwise = all(torch.equal(got[i].view(torch.int32),
                                  want[i].view(torch.int32)) for i in (0, 1))
        if err != 0.0:
            raise AssertionError(f"{variant}: x/p differ by {err}")
        clocks = [sm_clocks()]
        ms = device_ms(kernel, TIMED_LAUNCHES)
        clocks.append(sm_clocks())
        # a few calls per batch: the plain version is ~100-500 launches a
        # call, and the host blocks once the card's launch queue is full
        plain_ms = device_ms(plain, 2)
        one_ms = call_ms(kernel, TIMED_LAUNCHES)
        ops_ = n_active * OPS_PER_TRACKER
        if variant == "greedy":
            ops_ += n_active * d * IOU_OPS_PER_PAIR
        nbytes = frame_bytes(t, d, s, variant)
        bound_ms = max(nbytes / rate, ops_ / F32_PEAK) * 1e3
        rows[variant] = dict(
            max_abs_err=err, bitwise=bitwise, ms=ms, plain_ms=plain_ms,
            call_ms=one_ms, sm_clocks=clocks,
            bound_ms=bound_ms, bound_by=("bytes" if nbytes / rate
                                         >= ops_ / F32_PEAK else "operations"),
            mbytes=nbytes / 1e6)
        print(f"fused_frame[{variant}] S={s} T={t} D={d}: max|err| {err} "
              f"(bit-identical: {bitwise}); on the card {ms * 1e3:.2f} us "
              f"per launch ({one_ms * 1e3:.2f} us one call at a time), "
              f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.2f} MB, {bound_ms / ms:.1%} of bound); SM "
              f"clock before/after the timing: {clocks[0]} / {clocks[1]}")
    return rows


def chunk_bytes(t: int, d: int, s: int, f: int, variant: str) -> int:
    """Bytes fused_chunk must move: the state (63 words a slot, 2 a
    stream) in and out once, and per frame det, det_mask, active, reset
    (and trk_to_det for the gather) in, boxes, uid, emit, trk_to_det, cls
    and matched_det out."""
    state = 2 * (63 * t + 2) * s
    per_in = 4 * d + d + 2 + (t if variant == "gather" else 0)
    per_out = 8 * t + d
    return 4 * (state + f * s * (per_in + per_out))


def planned_chunks(config, device, seqs, num_lanes: int, n: int):
    """The first ``n`` chunks the main path's scheduler plans for ``seqs``,
    in the chunk layout on the card; returns (engine, chunks)."""
    from repro_torch.core.sort import SortEngine
    from repro_torch.serve.scheduler import StreamScheduler
    sched = StreamScheduler(SortEngine(config, device=device),
                            num_lanes=num_lanes, chunk=CHUNK)
    for name_, db, dm in seqs:
        sched.submit(name_, db, dm)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    chunks = []
    for _ in range(n):
        det, dm, act, rst, _ = sched._plan_chunk()
        sched.chunks_run += 1
        chunks.append((dev(det.transpose(0, 2, 3, 1)),
                       dev(dm.transpose(0, 2, 1).astype(np.float32)),
                       dev(act.astype(np.float32)[:, None]),
                       dev(rst.astype(np.int32)[:, None])))
    return sched.engine, chunks


def check_chunk_kernel(device, name: str, seqs):
    """fused_chunk in its three variants against its plain version on the
    main path's second chunk (lanes recycling mid-chunk), from the state
    its first chunk leaves."""
    from repro_torch.configs.sort_mot import MEGAKERNEL
    from repro_torch.core.sort import chunk_state_of
    from repro_torch.kernels import chunk, ref
    lanes = MEGAKERNEL.streams_per_chip
    engine, (first, second) = planned_chunks(MEGAKERNEL.sort, device, seqs,
                                             lanes, 2)
    state, _ = ref.chunk_lane(chunk_state_of(engine.init_ragged(lanes)),
                              *first, assoc="hungarian")
    state = ref.ChunkState(*(v.contiguous() for v in state))
    t, s = state.alive.shape
    f, d = second[0].shape[0], second[0].shape[1]
    _, pre = ref.chunk_lane(state, *second, assoc="hungarian")
    t2d = pre.trk_to_det.contiguous()
    lane_frames = int(second[2].sum().item())    # active (lane, frame)s
    rate = mem_rate(name)
    rows = {}
    for variant in ("hungarian", "greedy", "gather"):
        assoc = "greedy" if variant == "greedy" else "hungarian"
        t2d_in = t2d if variant == "gather" else None

        def kernel():
            return chunk.fused_chunk(state, *second, t2d_in, assoc=assoc)

        def plain():
            return ref.chunk_lane(state, *second, t2d_in, assoc=assoc)

        (got_st, got), (want_st, want) = kernel(), plain()
        torch.cuda.synchronize()
        err, bitwise = 0.0, True
        for field, g, w in zip((*ref.ChunkState._fields,
                                *ref.ChunkOuts._fields),
                               (*got_st, *got), (*want_st, *want)):
            if g.dtype == torch.float32:
                err = max(err, float((g - w).abs().max()) if g.numel()
                          else 0.0)
                bitwise &= torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
            elif not torch.equal(g, w.to(g.dtype)):
                raise AssertionError(f"fused_chunk[{variant}]: {field} "
                                     f"differs from the plain version")
        if not bitwise or err != 0.0:
            raise AssertionError(f"fused_chunk[{variant}]: floats differ "
                                 f"by {err} (bit-identical: {bitwise})")
        clocks = [sm_clocks()]
        ms = device_ms(kernel, 20)
        clocks.append(sm_clocks())
        one_ms = call_ms(kernel, 20)
        plain_ms = call_ms(plain, 1, warmup=0)   # host-bound: ~10^5 launches
        ops_ = lane_frames * t * OPS_PER_TRACKER
        if variant != "gather":
            ops_ += lane_frames * t * d * IOU_OPS_PER_PAIR
        nbytes = chunk_bytes(t, d, s, f, variant)
        bound_ms = max(nbytes / rate, ops_ / F32_PEAK) * 1e3
        rows[variant] = dict(
            max_abs_err=err, bitwise=bitwise, ms=ms, plain_ms=plain_ms,
            call_ms=one_ms, sm_clocks=clocks, bound_ms=bound_ms,
            bound_by=("bytes" if nbytes / rate >= ops_ / F32_PEAK
                      else "operations"), mbytes=nbytes / 1e6)
        print(f"fused_chunk[{variant}] S={s} T={t} D={d} F={f}: max|err| "
              f"{err} (bit-identical: {bitwise}); on the card "
              f"{ms * 1e3:.2f} us per launch = {ms * 1e3 / f:.2f} us per "
              f"frame ({one_ms * 1e3:.2f} us one call at a time), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({rows[variant]['bound_by']}; {nbytes / 1e6:.2f} MB, "
              f"{ops_ / 1e9:.3f} Gop; {bound_ms / ms:.1%} of bound); SM "
              f"clock before/after the timing: {clocks[0]} / {clocks[1]}")
    return rows


# ------------------------------------------------------------- phase 4
def make_sequences(n: int, seed: int):
    from repro_torch.data.mot import TABLE_I
    from repro_torch.data.synthetic import SceneConfig, generate_scene
    rng = np.random.default_rng(seed)
    objects = [k for _, k in TABLE_I.values()]
    seqs = []
    for i in range(n):
        cfg = SceneConfig(num_frames=int(rng.integers(SEQ_FRAMES[0],
                                                      SEQ_FRAMES[1] + 1)),
                          max_objects=objects[i % len(objects)],
                          seed=seed * 100003 + i)
        _, _, db, dm = generate_scene(cfg)
        seqs.append((f"seq{i}", db, dm))
    return seqs


def serve(config, device, seqs, frame_mode: str, num_lanes: int,
          spans=()):
    """Serve ``seqs`` through a fresh ``StreamScheduler``; returns (tracks,
    scheduler, wall s, launches of each kernel).  ``spans`` names
    ``(label, owner, attribute)`` callables to time with CUDA events around
    every call in the run (``sched.span_ms``, summed on the card's
    timeline); ``sched.plan_s`` is the host planning time."""
    from repro_torch.core.sort import SortEngine
    from repro_torch.kernels import chunk, frame
    from repro_torch.serve.scheduler import StreamScheduler
    engine = SortEngine(config, device=device, frame_mode=frame_mode)
    sched = StreamScheduler(engine, num_lanes=num_lanes, chunk=CHUNK)
    for name, db, dm in seqs:
        sched.submit(name, db, dm)
    plan_s = 0.0
    plan = sched._plan_chunk

    def timed_plan():                     # the scheduler's host planning
        nonlocal plan_s
        t0 = time.perf_counter()
        out = plan()
        plan_s += time.perf_counter() - t0
        return out

    sched._plan_chunk = timed_plan
    timers = {label: Spans(owner, attr) for label, owner, attr in spans}
    with contextlib.ExitStack() as stack:
        for timer in timers.values():
            stack.enter_context(timer)
        torch.cuda.synchronize()
        frame.fused_frame.launches = 0
        chunk.fused_chunk.launches = 0
        t0 = time.perf_counter()
        tracks = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_frame": frame.fused_frame.launches,
                    "fused_chunk": chunk.fused_chunk.launches}
    sched.plan_s = plan_s
    sched.span_ms = {k: timer.ms() for k, timer in timers.items()}
    return tracks, sched, wall, launches


def check_tracks(tracks, seqs, t: int):
    if [tr.name for tr in tracks] != [s[0] for s in seqs]:
        raise AssertionError("tracks not released in submission order")
    for tr, (_, db, _) in zip(tracks, seqs):
        f = db.shape[0]
        if tr.boxes.shape != (f, t, 4) or tr.uid.shape != (f, t):
            raise AssertionError(f"{tr.name}: shapes {tr.boxes.shape}")
        if not np.isfinite(tr.boxes[tr.emit]).all():
            raise AssertionError(f"{tr.name}: emitted a non-finite box")
        if (tr.uid[tr.emit] < 1).any():
            raise AssertionError(f"{tr.name}: emitted a dead slot")


def same_tracks(got, want, what: str) -> None:
    """uid and emit equal, boxes bit for bit, sequence by sequence."""
    for a, b in zip(got, want, strict=True):
        if a.name != b.name or not (np.array_equal(a.uid, b.uid)
                                    and np.array_equal(a.emit, b.emit)):
            raise AssertionError(f"{a.name}: uid/emit differ from {what}")
        if not np.array_equal(a.boxes.view(np.int32),
                              b.boxes.view(np.int32)):
            err = float(np.abs(a.boxes - b.boxes).max())
            raise AssertionError(f"{a.name}: boxes differ from {what} by "
                                 f"{err}")


def run_path(preset: str, device, seqs, kernel: str, spans):
    """One main path: warm-up, the kernel run with its launches counted and
    its step split, the plain run held against it, one profiled chunk."""
    from repro_torch.configs import sort_mot
    service = getattr(sort_mot, preset)
    cfg, lanes = service.sort, service.streams_per_chip
    n_frames = sum(db.shape[0] for _, db, _ in seqs)
    print(f"{preset} path: {len(seqs)} sequences, {n_frames} frames, "
          f"{lanes} lanes, chunk {CHUNK}, T=D={cfg.max_trackers}, "
          f"{cfg.assoc}")
    serve(cfg, device, seqs[:64], "auto", lanes)        # warm-up
    tracks, sched, wall, launches = serve(cfg, device, seqs, "auto", lanes,
                                          spans)
    steps = sched.chunks_run * CHUNK
    want = steps if kernel == "fused_frame" else sched.chunks_run
    if launches[kernel] != want:
        raise AssertionError(f"{preset}: {kernel} launched "
                             f"{launches[kernel]} times, expected {want}")
    check_tracks(tracks, seqs, cfg.max_trackers)
    ref_tracks, ref_sched, ref_wall, ref_launches = serve(cfg, device, seqs,
                                                          "ref", lanes)
    if any(ref_launches.values()):
        raise AssertionError(f"{preset}: the plain run launched a kernel")
    same_tracks(tracks, ref_tracks, f"{preset}'s plain run")
    for attr in ("lane_steps", "chunks_run", "frames_processed"):
        if getattr(sched, attr) != getattr(ref_sched, attr):
            raise AssertionError(f"{preset}: {attr} differs between runs")
    emitted = int(sum(tr.emit.sum() for tr in tracks))
    print(f"{preset} kernel run: {sched.frames_processed} frames in "
          f"{wall:.3f} s = {sched.frames_processed / wall:.1f} frames/s, "
          f"{steps} steps ({wall / steps * 1e3:.3f} ms/step), "
          f"{launches[kernel]} {kernel} launches, utilization "
          f"{sched.utilization:.4f}, {emitted} boxes emitted")
    print(f"{preset} plain run: {ref_sched.frames_processed} frames in "
          f"{ref_wall:.3f} s = "
          f"{ref_sched.frames_processed / ref_wall:.1f} frames/s "
          f"({ref_wall / steps * 1e3:.3f} ms/step); tracks equal (uid/emit "
          f"exact, boxes bit for bit)")
    idle = profile_chunk(cfg, device, seqs, lanes)
    return dict(tracks=tracks, launches=launches[kernel], steps=steps,
                chunks=sched.chunks_run, wall=wall, plan_s=sched.plan_s,
                span_ms=sched.span_ms, idle=idle,
                frames_per_s=sched.frames_processed / wall)


def transfer_ms(config, device, seqs, num_lanes: int, reps: int = 5):
    """Host ms of one chunk's transfers as the scheduler makes them: the
    planned operands to the card, and boxes, uid and emit back; a
    synchronise before each clock read, median of ``reps``."""
    from repro_torch.core.sort import SortEngine
    from repro_torch.serve.scheduler import StreamScheduler
    sched = StreamScheduler(SortEngine(config, device=device),
                            num_lanes=num_lanes, chunk=CHUNK)
    for name, db, dm in seqs:
        sched.submit(name, db, dm)
    planned = sched._plan_chunk()[:4]
    operands = [torch.from_numpy(a).to(device) for a in planned]
    _, outs = sched.engine.run_chunk_ragged(sched._state, *operands)
    h2d, d2h = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in planned:
            torch.from_numpy(a).to(device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for a in (outs.boxes, outs.uid, outs.emit):
            a.cpu().numpy()
        t2 = time.perf_counter()
        h2d.append((t1 - t0) * 1e3)
        d2h.append((t2 - t1) * 1e3)
    return float(np.median(h2d)), float(np.median(d2h))


def profile_chunk(config, device, seqs, num_lanes: int) -> float:
    """The card's idle share in a chunk of the main path: chunk 1 of the
    same submissions (all lanes busy, lanes recycling mid-chunk), run
    through two fresh schedulers, timed as is in one and under
    ``torch.profiler`` in the other, so that the profiler's own host cost
    stays out of the wall time the busy time is held against."""
    from repro_torch.core.sort import SortEngine
    from repro_torch.serve.scheduler import StreamScheduler

    def second_chunk():
        sched = StreamScheduler(SortEngine(config, device=device),
                                num_lanes=num_lanes, chunk=CHUNK)
        for name, db, dm in seqs:
            sched.submit(name, db, dm)
        sched.run_chunk()
        return sched.run_chunk

    chunk = second_chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof_wall_ms, busy_ms, n_ops = profiled_ms(second_chunk())
    idle = 1 - busy_ms / wall_ms
    print(f"main-path chunk 1 ({CHUNK} steps): {wall_ms:.3f} ms wall "
          f"({prof_wall_ms:.3f} ms under the profiler), card busy "
          f"{busy_ms:.3f} ms in {n_ops} device operations, idle share "
          f"{idle:.4f}")
    return idle


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here outside a checkout)
    from repro_torch.core.sort import SortEngine
    from repro_torch.kernels import ops
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    t0 = time.perf_counter()
    build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    seqs = make_sequences(NUM_SEQUENCES, SEED)
    frame_rows = check_kernel(device, name)
    chunk_rows = check_chunk_kernel(device, name, seqs)

    fused = run_path("FUSED", device, seqs, "fused_frame", (
        ("stage", ops, "_hungarian_stage"), ("frame_step", ops, "frame_step")))
    steps = fused["steps"]
    step_ms = fused["wall"] / steps * 1e3
    plan_ms = fused["plan_s"] / steps * 1e3
    stage_ms = fused["span_ms"]["stage"] / steps
    frame_ms = fused["span_ms"]["frame_step"] / steps
    print(f"FUSED per step {step_ms:.3f} ms: hungarian stage "
          f"{stage_ms:.3f} ms, fused_frame launch (wrapper included) "
          f"{frame_ms - stage_ms:.4f} ms (both CUDA-event spans), host "
          f"planning {plan_ms:.3f} ms, rest (engine lifecycle ops, "
          f"transfers) {step_ms - frame_ms - plan_ms:.3f} ms; idle share "
          f"{fused['idle']:.4f}")

    from repro_torch.configs.sort_mot import MEGAKERNEL
    h2d_ms, d2h_ms = transfer_ms(MEGAKERNEL.sort, device, seqs,
                                 MEGAKERNEL.streams_per_chip)
    print(f"one chunk's transfers (host clock): H2D of the planned operands "
          f"{h2d_ms:.3f} ms, D2H of boxes/uid/emit {d2h_ms:.3f} ms")
    mega = {}
    for preset in ("MEGAKERNEL", "MEGAKERNEL_GREEDY"):
        run = run_path(preset, device, seqs, "fused_chunk", (
            ("chunk_step", ops, "chunk_step"),
            ("engine", SortEngine, "run_chunk_ragged")))
        steps = run["steps"]
        step_ms = run["wall"] / steps * 1e3
        plan_ms = run["plan_s"] / steps * 1e3
        launch_ms = run["span_ms"]["chunk_step"] / steps
        engine_ms = run["span_ms"]["engine"] / steps
        xfer_ms = (h2d_ms + d2h_ms) / CHUNK
        print(f"{preset} per step {step_ms:.3f} ms: host planning "
              f"{plan_ms:.3f} ms, fused_chunk launch (chunk_step span: the "
              f"kernel on the card and its wrapper) {launch_ms:.4f} ms, "
              f"engine layout ops {engine_ms - launch_ms:.4f} ms (CUDA-event "
              f"spans), transfers {xfer_ms:.3f} ms (H2D + D2H timed alone), "
              f"rest (the host's per-sequence output copies and "
              f"bookkeeping) {step_ms - plan_ms - engine_ms - xfer_ms:.3f} "
              f"ms; {run['launches']} launches for {run['chunks']} chunks; "
              f"idle share {run['idle']:.4f}")
        mega[preset] = run
    same_tracks(mega["MEGAKERNEL"]["tracks"], fused["tracks"],
                "the FUSED kernel run")
    print("MEGAKERNEL tracks equal the FUSED kernel run's (uid/emit exact, "
          "boxes bit for bit)")

    def entry(kernel, source, replaces, rows, launches, main):
        kern = rows[main]
        return dict(
            name=kernel, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=kern["max_abs_err"],
            ms=kern["ms"], plain_ms=kern["plain_ms"],
            bound_ms=kern["bound_ms"], bound_by=kern["bound_by"],
            library_ms=None, bound_us=kern["bound_ms"] * 1e3,
            call_ms=kern["call_ms"],
            variants={v: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "sm_clocks")}
                      for v, r in rows.items()})

    kernels = [
        entry("fused_frame", "src/repro_torch/kernels/csrc/frame.cu",
              "src/repro/kernels/frame.py:73", frame_rows,
              fused["launches"], "hungarian"),
        entry("fused_chunk", "src/repro_torch/kernels/csrc/chunk.cu",
              "src/repro/kernels/chunk.py:117", chunk_rows,
              mega["MEGAKERNEL"]["launches"], "hungarian")]
    kernels[1]["launches_greedy_path"] = mega["MEGAKERNEL_GREEDY"]["launches"]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
