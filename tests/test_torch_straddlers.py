"""K4, the straddler selection (``ops/straddlers.py``) behind
``raster_common.select_straddlers``.

On the CPU ``select_straddlers`` runs K4's plain version,
``select_straddlers_reference``; these tests hold it to the JAX package's
``select_straddlers`` (jitted on the CPU), all five results bit for bit,
on batches with no straddler, one of each kind, exactly ``cap`` and
``cap + 1`` straddlers, fewer triangles than ``cap``, w at W_EPS and NaN,
and invalid rows among the straddlers. The card's tests hold K4 to its
plain version, eagerly and as a CUDA graph replayed with its inputs
rewritten (``profiling.k4_graph_replays``), whose batches a CPU test
checks here."""

import jax
import numpy as np
import pytest
import torch

from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu_torch.ops import raster_common as trc
from myrenderer_tpu_torch.ops import straddlers
from myrenderer_tpu_torch.utils import profiling
from myrenderer_tpu_torch.utils.trisets import (REPLAY_CAP, STRADDLER_CASES,
                                                STRADDLER_REPLAYS,
                                                straddler_batch,
                                                straddler_case,
                                                straddler_replay)

torch.set_num_threads(1)


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", list(STRADDLER_CASES))
def test_plain_version_matches_jax(name):
    """select_straddlers_reference against the JAX package's
    select_straddlers: app_clip, app_vary, app_valid, sel and overflow
    bit for bit; select_straddlers on the CPU gives the same."""
    clip, vary, valid, cap = straddler_case(name)
    w = clip[..., 3]
    eps = np.float32(trc.W_EPS)
    n = int((valid & (w > eps).any(-1) & (w <= eps).any(-1)).sum())
    assert n == STRADDLER_CASES[name][1]
    if name == "w_at_w_eps_and_nan":
        assert (w == eps).any() and np.isnan(w).any()
    want = jax.jit(lambda c, v, m: jrc.select_straddlers(c, v, m, cap))(
        clip, vary, valid)
    args = [torch.from_numpy(a) for a in (clip, vary, valid)]
    got = trc.select_straddlers_reference(*args, cap)
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(bits(a), bits(b))
    assert bool(got[4]) == (n > cap)
    assert int(got[2][:cap].sum()) == min(n, cap)
    for a, b in zip(got, trc.select_straddlers(*args, cap)):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_no_triangles_raises():
    """T == 0: the plain code cannot take it (its dead slots read row
    T - 1), and the dispatcher says so for either device."""
    empty = torch.zeros((0, 3, 4))
    none = torch.zeros(0, dtype=torch.bool)
    with pytest.raises(IndexError):
        trc.select_straddlers_reference(empty, empty, none, 4)
    with pytest.raises(IndexError, match="at least one triangle"):
        trc.select_straddlers(empty, empty, none, 4)


@pytest.mark.parametrize("bad,match", [
    (lambda c, v, m: (c[..., :3], v, m), "tri_clip has the shape"),
    (lambda c, v, m: (c, v[:-1], m), "tri_vary has the shape"),
    (lambda c, v, m: (c, v, m.to(torch.uint8)), "torch.bool"),
    (lambda c, v, m: (c.double(), v, m), "torch.float32")])
def test_dispatcher_checks_its_inputs(bad, match):
    clip, vary, valid, cap = straddler_case("one_in")
    args = [torch.from_numpy(a) for a in (clip, vary, valid)]
    with pytest.raises((ValueError, TypeError), match=match):
        trc.select_straddlers(*bad(*args), cap)


@pytest.mark.parametrize("r", range(len(STRADDLER_REPLAYS)))
def test_replay_batches_hold_their_straddlers(r):
    """The graph check's batches: each of both sizes holds the straddlers
    its entry names (all within the last 200 rows for "in_last"), and its
    plain results agree with the JAX package's."""
    want, kw = STRADDLER_REPLAYS[r]
    for n in (5_000, 300_000):
        clip, vary, valid = straddler_replay(n, r)
        w = clip[..., 3]
        eps = np.float32(trc.W_EPS)
        straddle = valid & (w > eps).any(-1) & (w <= eps).any(-1)
        assert int(straddle.sum()) == want
        if "in_last" in kw:
            assert not straddle[:-kw["in_last"]].any()
    jwant = jax.jit(lambda c, v, m: jrc.select_straddlers(
        c, v, m, REPLAY_CAP))(clip, vary, valid)
    got = trc.select_straddlers(*(torch.from_numpy(a)
                                  for a in (clip, vary, valid)), REPLAY_CAP)
    assert bool(got[4]) == (want > REPLAY_CAP)
    for a, b in zip(jwant, got):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k4_matches_plain_version_on_card(cuda_device):
    """K4 against its plain version on the card, every case above and a
    batch of the stress terrain's size: all five results bit for bit,
    one launch a call."""
    batches = [straddler_case(name) for name in STRADDLER_CASES]
    batches.append((*straddler_batch(1_002_528, 5, 77, nan_rows=40), 128))
    for clip, vary, valid, cap in batches:
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (clip, vary, valid)]
        before = straddlers.K4.launches
        got = trc.select_straddlers(*args, cap)
        assert straddlers.K4.launches == before + 1
        want = trc.select_straddlers_reference(*args, cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(bits(a.cpu()), bits(b.cpu()))


@pytest.mark.cuda
def test_k4_graph_replays_match_plain_version(cuda_device):
    """K4's two calls of a frame captured in one CUDA graph and replayed
    60 times, the inputs rewritten in place between replays (none, fewer
    than cap, exactly cap, cap + 1, spread over many blocks, all in the
    last block, NaN rows, invalid rows): every replay bit-equal to the
    plain version, overflow included; the graph holds one launch a call
    and leaves its scratch zeroed."""
    assert profiling.k4_graph_replays(cuda_device, replays=60) == 0
