"""Port parity: association (Hungarian, greedy) and the slot lifecycle.

Decisions — ``col4row``, ``trk_to_det``, ``matched_det``, slot claims,
uids, lifecycle counters — must equal the JAX package's exactly, ties
included: the port repeats the reference's Dijkstra scan with its
first-index ``argmin`` and the greedy flat ``d*T + t`` first-index argmax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import association as jassoc  # noqa: E402
from repro.core import greedy as jgreedy  # noqa: E402
from repro.core import hungarian as jhung  # noqa: E402
from repro.core import slots as jslots  # noqa: E402
from repro_torch.core import (association, greedy, hungarian,  # noqa: E402
                              slots)

_j_solve_masked = jax.jit(jhung.solve_masked, static_argnums=3)
_j_assoc_lane = jax.jit(jassoc.associate_lane, static_argnums=3)


def _np(a):
    return np.asarray(a)


def _iou_case(seed, d, t, lanes, ties):
    """A ``[D, T, L]`` IoU tensor with masks.  ``ties`` quantises the IoU
    to a few levels and repeats detections, so many pairs score the same
    and only the solver's scan order separates them."""
    rng = np.random.default_rng(seed)
    iou = rng.random((d, t, lanes)).astype(np.float32)
    if ties:
        iou = np.round(iou * 3) / 3
        iou[d // 2:] = iou[:d - d // 2]                 # duplicate detections
        iou = iou.astype(np.float32)
    dm = rng.random((d, lanes)) < 0.8
    tm = rng.random((t, lanes)) < 0.7
    return iou, dm, tm


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d,t", [(5, 5), (6, 3), (2, 7)])
def test_solve_masked_matches_reference(d, t, ties):
    iou, dm, tm = _iou_case(d * 10 + t, d, t, 40, ties)
    cost = -np.moveaxis(iou, -1, 0)                       # [L, D, T]
    rm, cm = dm.T, tm.T
    n = max(d, t)
    want = _j_solve_masked(jnp.asarray(cost), jnp.asarray(rm),
                           jnp.asarray(cm), n)
    got = hungarian.solve_masked(torch.from_numpy(cost), torch.from_numpy(rm),
                                 torch.from_numpy(cm), n)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.dtype == torch.int32


def test_pad_cost_matrix_bitwise():
    rng = np.random.default_rng(4)
    cost = -rng.random((7, 4, 6)).astype(np.float32)
    rm = rng.random((7, 4)) < 0.7
    cm = rng.random((7, 6)) < 0.7
    with jax.disable_jit():
        want = jhung.pad_cost_matrix(jnp.asarray(cost), jnp.asarray(rm),
                                     jnp.asarray(cm), 6)
    got = hungarian.pad_cost_matrix(torch.from_numpy(cost),
                                    torch.from_numpy(rm),
                                    torch.from_numpy(cm), 6)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  _np(want).view(np.int32))


def test_solve_is_optimal_and_lane_layout_agrees():
    """``solve`` reaches scipy's optimal cost, and ``solve_masked_lane`` is
    ``solve_masked`` on the transposed batch."""
    from scipy.optimize import linear_sum_assignment
    rng = np.random.default_rng(8)
    cost = rng.random((30, 6, 6)).astype(np.float32)
    col4row = hungarian.solve(torch.from_numpy(cost)).numpy()
    for b in range(cost.shape[0]):
        r, c = linear_sum_assignment(cost[b])
        assert sorted(col4row[b]) == list(range(6))
        np.testing.assert_allclose(cost[b, np.arange(6), col4row[b]].sum(),
                                   cost[b, r, c].sum(), rtol=1e-6)
    iou, dm, tm = _iou_case(9, 4, 5, 12, ties=True)
    lane = hungarian.solve_masked_lane(torch.from_numpy(-iou),
                                       torch.from_numpy(dm),
                                       torch.from_numpy(tm), 5)
    batch = hungarian.solve_masked(
        torch.from_numpy(-np.moveaxis(iou, -1, 0)), torch.from_numpy(dm.T),
        torch.from_numpy(tm.T), 5)
    assert torch.equal(lane, batch.T)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d,t", [(6, 6), (8, 4), (3, 8)])
def test_associate_lane_matches_reference(d, t, ties):
    iou, dm, tm = _iou_case(d * 7 + t, d, t, 24, ties)
    want = _j_assoc_lane(jnp.asarray(iou), jnp.asarray(dm), jnp.asarray(tm),
                         0.3)
    got = association.associate_lane(torch.from_numpy(iou),
                                     torch.from_numpy(dm),
                                     torch.from_numpy(tm), 0.3)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("d,t", [(0, 4), (4, 0)])
def test_associate_degenerate_frames(d, t):
    """D=0 or T=0: nothing matches, in both layouts."""
    iou = torch.zeros((d, t, 3))
    t2d, md = association.associate_lane(iou, torch.ones((d, 3), dtype=bool),
                                         torch.ones((t, 3), dtype=bool))
    assert t2d.shape == (t, 3) and (t2d == -1).all()
    assert md.shape == (d, 3) and not md.any()
    a = association.associate_from_iou(
        iou.permute(2, 0, 1), torch.ones((3, d), dtype=bool),
        torch.ones((3, t), dtype=bool))
    assert a.trk_to_det.shape == (3, t) and not a.matched_det.any()
    assert a.unmatched_det.all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d,t", [(6, 6), (7, 3)])
def test_greedy_assign_lane_matches_reference(d, t, ties):
    iou, dm, tm = _iou_case(d * 3 + t, d, t, 32, ties)
    with jax.disable_jit():
        want = jgreedy.greedy_assign_lane(jnp.asarray(iou), jnp.asarray(dm),
                                          jnp.asarray(tm), 0.3)
    got = greedy.greedy_assign_lane(torch.from_numpy(iou),
                                    torch.from_numpy(dm),
                                    torch.from_numpy(tm), 0.3)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


def _pool_case(seed, t=6, s=10):
    rng = np.random.default_rng(seed)
    alive = rng.random((t, s)) < 0.5
    ints = {f: rng.integers(0, 5, size=(t, s)).astype(np.int32)
            for f in ("age", "hits", "hit_streak", "time_since_update")}
    uid = np.where(alive, rng.integers(1, 50, size=(t, s)), -1)
    return dict(alive=alive, **ints, uid=uid.astype(np.int32),
                cls=np.where(alive, 0, -1).astype(np.int32),
                next_uid=rng.integers(1, 60, size=(s,)).astype(np.int32))


def _pools(fields):
    return (jslots.SlotPool(**{k: jnp.asarray(v) for k, v in fields.items()}),
            slots.SlotPool(**{k: torch.from_numpy(v)
                              for k, v in fields.items()}))


def _assert_pools_equal(want, got):
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)
        want_dtype = torch.bool if name == "alive" else torch.int32
        assert g.dtype == want_dtype, name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lifecycle_matches_reference(seed):
    """``tick``, ``assign_slots_lane`` and ``birth_lane`` on lane-major
    pools, chained as the engine chains them."""
    fields = _pool_case(seed)
    rng = np.random.default_rng(seed + 100)
    matched = rng.random(fields["alive"].shape) < 0.5
    want_births = rng.random((5, fields["alive"].shape[1])) < 0.6
    jp, tp = _pools(fields)
    jp = jslots.tick(jp, jnp.asarray(matched), 1)
    tp = slots.tick(tp, torch.from_numpy(matched), 1)
    _assert_pools_equal(jp, tp)
    j_slot = jslots.assign_slots_lane(~jp.alive, jnp.asarray(want_births))
    t_slot = slots.assign_slots_lane(~tp.alive, torch.from_numpy(want_births))
    np.testing.assert_array_equal(t_slot.numpy(), _np(j_slot))
    assert t_slot.dtype == torch.int32
    _assert_pools_equal(jslots.birth_lane(jp, j_slot),
                        slots.birth_lane(tp, t_slot))


def test_init_and_transpose_pool():
    jp = jslots.transpose_pool(jslots.init_pool((3,), 4))
    tp = slots.transpose_pool(slots.init_pool((3,), 4))
    _assert_pools_equal(jp, tp)
    assert slots.UID_LIMIT == jslots.UID_LIMIT
    back = slots.transpose_pool(tp)
    assert back.alive.shape == (3, 4) and back.next_uid.shape == (3,)
