"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` (one process per source, all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (S=2048 streams, T=D=16) and time both with CUDA
   events;
4. drive the main path: the FUSED preset's ``SortEngine`` on the card
   behind a ``StreamScheduler`` of 2048 lanes serving a few thousand
   ragged synthetic sequences (lengths 32-128 frames, object counts from
   paper Table I), count the kernel's launches and time the Hungarian
   stage and the kernel's launch on those frames with CUDA events, then
   serve the same submissions with the plain version forced and require
   equal tracks, and profile one chunk of them for the card's idle share;
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
        ms = device_ms(kernel, TIMED_LAUNCHES)
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
            call_ms=one_ms,
            bound_ms=bound_ms, bound_by=("bytes" if nbytes / rate
                                         >= ops_ / F32_PEAK else "operations"),
            mbytes=nbytes / 1e6)
        print(f"fused_frame[{variant}] S={s} T={t} D={d}: max|err| {err} "
              f"(bit-identical: {bitwise}); on the card {ms * 1e3:.2f} us "
              f"per launch ({one_ms * 1e3:.2f} us one call at a time), "
              f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.2f} MB, {bound_ms / ms:.1%} of bound)")
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
          spans: bool = False):
    """Serve ``seqs`` through a fresh ``StreamScheduler``; returns (tracks,
    scheduler, wall s, kernel launches).  With ``spans``, CUDA events
    around every Hungarian stage and every ``frame_step`` of the run give
    ``sched.span_ms``, their summed spans on the card's timeline."""
    from repro_torch.core.sort import SortEngine
    from repro_torch.kernels import frame, ops
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
    timers = ({"stage": Spans(ops, "_hungarian_stage"),
               "frame_step": Spans(ops, "frame_step")} if spans else {})
    with contextlib.ExitStack() as stack:
        for timer in timers.values():
            stack.enter_context(timer)
        torch.cuda.synchronize()
        frame.fused_frame.launches = 0
        t0 = time.perf_counter()
        tracks = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = frame.fused_frame.launches
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


def main_path(device):
    from repro_torch.configs.sort_mot import FUSED
    cfg, lanes = FUSED.sort, FUSED.streams_per_chip
    seqs = make_sequences(NUM_SEQUENCES, SEED)
    n_frames = sum(db.shape[0] for _, db, _ in seqs)
    print(f"main path: {len(seqs)} sequences, {n_frames} frames, "
          f"{lanes} lanes, chunk {CHUNK}, T=D={cfg.max_trackers}")
    serve(cfg, device, seqs[:64], "auto", lanes)        # warm-up
    tracks, sched, wall, launches = serve(cfg, device, seqs, "auto", lanes,
                                          spans=True)
    steps = sched.chunks_run * CHUNK
    if launches != steps:
        raise AssertionError(f"fused_frame launched {launches} times for "
                             f"{steps} steps")
    check_tracks(tracks, seqs, cfg.max_trackers)
    ref_tracks, ref_sched, ref_wall, ref_launches = serve(cfg, device, seqs,
                                                          "ref", lanes)
    if ref_launches != 0:
        raise AssertionError("the plain run launched the kernel")
    box_err = 0.0
    for a, b in zip(tracks, ref_tracks):
        if a.name != b.name or not (np.array_equal(a.uid, b.uid)
                                    and np.array_equal(a.emit, b.emit)):
            raise AssertionError(f"{a.name}: uid/emit differ from plain run")
        box_err = max(box_err, float(np.abs(a.boxes - b.boxes).max()))
    if box_err != 0.0:
        raise AssertionError(f"boxes differ from plain run by {box_err}")
    emitted = int(sum(tr.emit.sum() for tr in tracks))
    print(f"kernel run: {sched.frames_processed} frames in {wall:.3f} s = "
          f"{sched.frames_processed / wall:.1f} frames/s, {steps} steps "
          f"({wall / steps * 1e3:.3f} ms/step), utilization "
          f"{sched.utilization:.4f}, {emitted} boxes emitted")
    print(f"plain run: {ref_sched.frames_processed} frames in "
          f"{ref_wall:.3f} s = {ref_sched.frames_processed / ref_wall:.1f} "
          f"frames/s ({ref_wall / steps * 1e3:.3f} ms/step); tracks equal "
          f"(uid/emit exact, boxes max|err| {box_err})")
    idle = profile_chunk(cfg, device, seqs, lanes)
    return dict(launches=launches, steps=steps, wall=wall,
                plan_s=sched.plan_s, span_ms=sched.span_ms, idle=idle)


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
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    t0 = time.perf_counter()
    build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    rows = check_kernel(device, name)
    run = main_path(device)

    steps = run["steps"]
    step_ms = run["wall"] / steps * 1e3
    plan_ms = run["plan_s"] / steps * 1e3
    stage_ms = run["span_ms"]["stage"] / steps
    frame_ms = run["span_ms"]["frame_step"] / steps
    print(f"per step of the main path {step_ms:.3f} ms: hungarian stage "
          f"{stage_ms:.3f} ms, fused_frame launch (wrapper included) "
          f"{frame_ms - stage_ms:.4f} ms (both CUDA-event spans), host "
          f"planning {plan_ms:.3f} ms, rest (engine lifecycle ops, "
          f"transfers) {step_ms - frame_ms - plan_ms:.3f} ms; idle share "
          f"{run['idle']:.4f}")
    kern = rows["hungarian"]
    entry = dict(
        name="fused_frame", route="cuda",
        source="src/repro_torch/kernels/csrc/frame.cu",
        replaces="src/repro/kernels/frame.py:73",
        launches=run["launches"], max_abs_err=kern["max_abs_err"],
        ms=kern["ms"], plain_ms=kern["plain_ms"], bound_ms=kern["bound_ms"],
        bound_by=kern["bound_by"], library_ms=None,
        bound_us=kern["bound_ms"] * 1e3, call_ms=kern["call_ms"],
        variants={v: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")}
                  for v, r in rows.items()})
    print(json.dumps({"kernels": [entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
