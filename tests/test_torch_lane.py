"""Port parity: lane primitives and the fused frame kernel's module.

The same numpy inputs, made from a seed, go through the JAX package and
through ``repro_torch``.  The lane primitives repeat the reference's
operation order, so against the reference run eagerly
(``jax.disable_jit()``) they must agree bit for bit.  Jitted JAX (the
Pallas kernel in interpret mode) lets XLA fuse and reorder float
arithmetic, so against it floats get a tolerance and decisions none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import frame as jframe  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, frame, ops, ref  # noqa: E402

# interpret-mode Pallas is jitted: XLA reorders the float arithmetic, which
# the reference measured at up to ~2e-4 on means after one update for
# inputs of scale ~50; covariances carry larger terms
X_TOL = dict(rtol=1e-5, atol=1e-4)
P_TOL = dict(rtol=1e-4, atol=1e-3)


def _operands(seed, t=6, d=5, s=8):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(7, t, s)) * 20).astype(np.float32)
    x[2] = np.abs(x[2]) * 50 + 100           # positive areas
    x[3] = np.abs(x[3]) / 20 + 0.3           # aspect ratios
    a = rng.normal(size=(t, s, 7, 7)).astype(np.float32)
    p = (a @ a.swapaxes(-1, -2) + np.eye(7, dtype=np.float32))
    p = np.ascontiguousarray(p.reshape(t, s, 49).transpose(2, 0, 1))
    xy = rng.uniform(-30, 30, size=(d, 2, s))
    wh = rng.uniform(5, 40, size=(d, 2, s))
    det = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    dm = (rng.random((d, s)) < 0.8).astype(np.float32)
    alive = (rng.random((t, s)) < 0.7).astype(np.float32)
    act = (rng.random((1, s)) < 0.6).astype(np.float32)
    z = (rng.normal(size=(4, t, s)) * 20).astype(np.float32)
    mask = (rng.random((1, t, s)) < 0.6).astype(np.float32)
    return dict(x=x, p=p, det=det, dm=dm, alive=alive, act=act, z=z,
                mask=mask)


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a))
    b = np.ascontiguousarray(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b)


def _jt(o):
    return {k: jnp.asarray(v) for k, v in o.items()}


def _tt(o):
    return {k: torch.from_numpy(v) for k, v in o.items()}


# --------------------------------------------------- bitwise primitives
_PRIMITIVES = {
    "predict_mean_lane": lambda m, o: [m.predict_mean_lane(o["x"])],
    "predict_lane": lambda m, o: list(m.predict_lane(o["x"], o["p"])),
    "update_lane": lambda m, o: list(m.update_lane(
        *m.predict_lane(o["x"], o["p"]), o["z"], o["mask"][0][None])),
    "z_to_xyxy_lane": lambda m, o: [m.z_to_xyxy_lane(o["x"][:4]),
                                    m.z_to_xyxy_lane(o["x"][:4, 0])],
    "xyxy_to_z_lane": lambda m, o: [m.xyxy_to_z_lane(o["det"])],
    "iou_lane": lambda m, o: [m.iou_lane(
        o["det"], m.z_to_xyxy_lane(m.predict_mean_lane(o["x"])[:4]))],
    "_inv4": lambda m, o: [v for row in m._inv4(
        [[o["p"][i * 7 + j] + (10.0 if i == j else 0.0) for j in range(4)]
         for i in range(4)]) for v in row],
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(_PRIMITIVES))
def test_lane_primitive_bitwise(name, seed):
    o = _operands(seed)
    with jax.disable_jit():
        want = _PRIMITIVES[name](jref, _jt(o))
    got = _PRIMITIVES[name](ref, _tt(o))
    for w, g in zip(want, got):
        _bits_equal(w, g.numpy())


@pytest.mark.parametrize("assoc,active", [("hungarian", True)])
def test_frame_lane_bitwise(assoc, active):
    """The whole plain frame (predict, Hungarian association, update,
    restore) against the reference's lane oracle run eagerly (small: an
    eager batched JAX Hungarian solve runs op by op).  The greedy frame's
    parts are held bitwise one by one (``test_torch_assoc.py``)."""
    o = _operands(5, t=4, d=3, s=6)
    args = ("x", "p", "det", "dm", "alive")
    with jax.disable_jit():
        j = _jt(o)
        want = jref.frame_lane(*(j[k] for k in args), 0.3, assoc=assoc,
                               active=j["act"] if active else None)
    t = _tt(o)
    got = ref.frame_lane(*(t[k] for k in args), 0.3, assoc=assoc,
                         active=t["act"] if active else None)
    for w, g in zip(want, got):
        _bits_equal(w, g.numpy())


# ------------------------------------------------- the kernel's module
@pytest.mark.parametrize("variant,active", [("greedy", True),
                                            ("hungarian", True),
                                            ("hungarian", False)])
def test_fused_frame_cpu_matches_pallas_interpret(variant, active):
    """The port's ``fused_frame`` on CPU tensors (its plain version) against
    the Pallas kernel in interpret mode, both variants: in-kernel greedy,
    and a gather by the Hungarian stage's precomputed assignment (made by
    the port's stage and handed to both)."""
    o = _operands(11, t=4, d=3)
    t = _tt(o)
    act_t = t["act"] if active else None
    t2d = None
    if variant == "hungarian":
        t2d = ops._hungarian_stage(t["x"], t["det"], t["dm"], t["alive"],
                                   act_t, 0.3)
    j = _jt(o)
    want = jframe.fused_frame(
        j["x"], j["p"], j["det"], j["dm"], j["alive"],
        j["act"] if active else None,
        None if t2d is None else jnp.asarray(t2d.numpy()),
        iou_threshold=0.3, block_s=4, interpret=True)
    before = frame.fused_frame.launches
    got = frame.fused_frame(t["x"], t["p"], t["det"], t["dm"], t["alive"],
                            act_t, t2d, iou_threshold=0.3)
    assert frame.fused_frame.launches == before      # CPU: no launch
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **X_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **P_TOL)
    _bits_equal(want[2], got[2].numpy())
    _bits_equal(want[3], got[3].numpy())
    if active:  # inactive lanes pass through bit for bit
        off = o["act"][0] == 0
        _bits_equal(o["x"][:, :, off], got[0].numpy()[:, :, off])
        _bits_equal(o["p"][:, :, off], got[1].numpy()[:, :, off])


@pytest.mark.parametrize("assoc", ["greedy", "hungarian"])
def test_frame_step_modes_on_cpu(assoc):
    """``auto`` on CPU tensors is the plain version; ``kernel`` raises."""
    t = _tt(_operands(3))
    args = (t["x"], t["p"], t["det"], t["dm"], t["alive"], t["act"])
    auto = ops.frame_step(*args, assoc=assoc)
    plain = ops.frame_step(*args, assoc=assoc, mode="ref")
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.frame_step(*args, assoc=assoc, mode="kernel")
    with pytest.raises(ValueError):
        ops.frame_step(*args, assoc="auction")


def test_build_key_follows_source_and_flags(tmp_path, monkeypatch):
    """The library name is keyed by the source and the flags, so an edited
    kernel is rebuilt and never confused with a stale build."""
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    second = build.library_path("k")
    assert second != first and second.name.startswith("libk_")
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != second


def test_build_dir_follows_the_caller(tmp_path, monkeypatch):
    """Libraries land under ``$REPRO_TORCH_BUILD``, else under the working
    directory's ``build/``, never beside the installed package."""
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "out"))
    assert (build.library_path("frame").parent
            == (tmp_path / "out" / "repro_torch").resolve())
    monkeypatch.delenv("REPRO_TORCH_BUILD")
    monkeypatch.chdir(tmp_path)
    assert (build.library_path("frame").parent
            == (tmp_path / "build" / "repro_torch").resolve())
