"""K3, the terrain's whole-stream vertex shader (``ops/terrain_vertex.py``).

On the CPU the terrain's ``vertex_batch_fn`` runs K3's plain version,
``terrain_vertex_reference``; these tests hold it to the JAX package's
whole-stream vertex function (``content/terrain.py``
``_make_vertex_batch_fn``, jitted on the CPU) bit for bit, heights of 0,
1 and subnormals among the inputs, and the dispatcher to the plain
version. The card's test holds K3 to its plain version.

XLA's CPU runtime treats subnormal f32 inputs as zero; the port keeps
them (IEEE arithmetic, as K3 on the card). A subnormal height reaches
the bits of a varying (5 h) and no clip lane at these inputs, so the
JAX package's varyings are the port's on the heights with their
subnormals zeroed, and the port's own varyings there are 5 h
unflushed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.content import terrain as jterrain
from myrenderer_tpu.ops import vertex_stage as jvs
from myrenderer_tpu_torch.content import terrain as tterrain
from myrenderer_tpu_torch.ops import terrain_vertex as tv
from myrenderer_tpu_torch.ops import vertex_stage as tvs
from myrenderer_tpu_torch.utils.trisets import terrain_inputs

torch.set_num_threads(1)

CASES = [(size, instances) for size in (1, 2, 7, 16) for instances in (1, 3)]


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32)


def jax_terrain(size, heights, uniforms, worlds):
    """The JAX package's whole-stream terrain function, jitted: clip and
    varyings as [T, 3, 4] (its planes stacked) and ids."""
    def fn(w, u, h):
        ctx = jvs.BatchVertexCtx(None, {}, w, None, {0: u, 1: h})
        out = jterrain._make_vertex_batch_fn(size)(ctx)
        clip = jnp.stack([jnp.stack(out.clip[k], -1) for k in range(3)], 1)
        vary = jnp.stack([jnp.stack(out.vary[k], -1) for k in range(3)], 1)
        return clip, vary, out.ids
    return jax.jit(fn)(worlds, uniforms, heights)


def zero_subnormals(x):
    """``x`` as XLA's CPU runtime reads it: subnormals as signed zeros."""
    tiny = np.finfo(np.float32).tiny
    return np.where(np.abs(x) < tiny, np.copysign(np.float32(0), x), x)


@pytest.mark.parametrize("size,instances", CASES)
def test_plain_version_matches_jax(size, instances):
    """terrain_vertex_reference against the JAX package's function: clip
    positions bit for bit, ids equal, in the same order; varyings bit for
    bit where the heights are normal or zero, and 5 h unflushed where
    they are subnormal (the JAX package's CPU runtime reads those as
    0)."""
    heights, uniforms, worlds = terrain_inputs(size, instances, 7 * size)
    subnormal = (heights != 0) & (np.abs(heights) < np.finfo(np.float32).tiny)
    assert (heights == 0).any()
    assert heights.size < 3 or ((heights == 1).any() and subnormal.any())
    jclip, jvary, jids = jax_terrain(size, heights, uniforms, worlds)
    tris = tv.terrain_vertex_reference(torch.from_numpy(heights),
                                       torch.from_numpy(uniforms),
                                       torch.from_numpy(worlds), size)
    zeroed = tv.terrain_vertex_reference(
        torch.from_numpy(zero_subnormals(heights)),
        torch.from_numpy(uniforms), torch.from_numpy(worlds), size)
    T = 2 * instances * size * size
    assert tris.clip.shape == tris.vary.shape == (T, 3, 4)
    np.testing.assert_array_equal(bits(jclip), bits(tris.clip))
    np.testing.assert_array_equal(bits(jclip), bits(zeroed.clip))
    np.testing.assert_array_equal(bits(jvary), bits(zeroed.vary))
    np.testing.assert_array_equal(np.asarray(jids), tris.ids.numpy())
    # the port's varyings: 5 h of the height each vertex reads, in IEEE
    # float32 (numpy flushes nothing)
    y = tris.vary.numpy()[..., 0]
    ids = tris.ids.numpy()
    inst, rank = ids // (2 * size * size), ids % (2 * size * size)
    quad, second = rank // 2, rank % 2
    rows = tv.LOOKUP_ROW.reshape(2, 3)[second]
    cols = tv.LOOKUP_COL.reshape(2, 3)[second]
    idx = np.minimum(quad[:, None] + size * rows + cols, size * size - 1)
    h_read = heights[inst[:, None], idx]
    np.testing.assert_array_equal(bits(y), bits(np.float32(5) * h_read))
    assert (np.abs(y[subnormal[inst[:, None], idx]]) > 0).all()
    assert tris.ids.dtype == torch.int32 and tris.planar


@pytest.mark.parametrize("size,instances", CASES)
def test_dispatcher_runs_plain_version_on_cpu(size, instances):
    """The terrain's vertex_batch_fn on CPU tensors equals
    terrain_vertex_reference bit for bit and launches nothing."""
    heights, uniforms, worlds = (torch.from_numpy(a) for a in
                                 terrain_inputs(size, instances, size + 1))
    ctx = tvs.BatchVertexCtx(None, {}, worlds, None,
                             {0: uniforms, 1: heights})
    before = tv.K3.launches
    got = tterrain._make_vertex_batch_fn(size, torch.device("cpu"))(ctx)
    want = tv.terrain_vertex_reference(heights, uniforms, worlds, size)
    assert tv.K3.launches == before
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert got.planar


@pytest.mark.parametrize("bad,match", [
    (lambda h, u, w: (h[:, :-1], u, w), "heights must be"),
    (lambda h, u, w: (h, u[:, :8], w), "uniforms must be"),
    (lambda h, u, w: (h, u, w[:1]), "worlds must be"),
    (lambda h, u, w: (h.double(), u, w), "float32")])
def test_dispatcher_checks_its_inputs(bad, match):
    heights, uniforms, worlds = (torch.from_numpy(a) for a in
                                 terrain_inputs(4, 2, 0))
    with pytest.raises((ValueError, TypeError), match=match):
        tv.terrain_vertex(*bad(heights, uniforms, worlds), 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k3_matches_plain_version_on_card(cuda_device):
    """K3 against its plain version on the card, one launch a call: the
    demo's terrain size, the stress scene's and three instances; every
    lane bit for bit."""
    for size, instances in ((100, 1), (708, 1), (37, 3)):
        h, u, w = (torch.from_numpy(a).to(cuda_device) for a in
                   terrain_inputs(size, instances, size))
        before = tv.K3.launches
        got = tv.terrain_vertex(h, u, w, size)
        assert tv.K3.launches == before + 1
        want = tv.terrain_vertex_reference(h, u, w, size)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(bits(a.cpu()), bits(b.cpu()))
