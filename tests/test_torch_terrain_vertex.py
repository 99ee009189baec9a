"""K3, the terrain's whole-stream vertex shader (``ops/terrain_vertex.py``).

On the CPU the terrain's ``vertex_batch_fn`` runs K3's plain version,
``terrain_vertex_reference``; these tests hold it to the JAX package's
whole-stream vertex function (``content/terrain.py``
``_make_vertex_batch_fn``, jitted on the CPU) bit for bit, heights of 0,
1 and subnormals among the inputs, and the dispatcher to the plain
version. The per-vertex shader (``content/terrain._make_vertex_fn``) is
held to the JAX package's per-vertex function on the same heights. The
card's tests hold K3 to its plain version.

XLA's CPU runtime reads subnormal f32 inputs as zeros, and a TPU has no
subnormals; the port's shaders read a subnormal height as a zero of its
sign where they read it (``terrain_vertex.flush_subnormals``, and the
same test in K3), so their varyings (5 h) and clip rows equal the JAX
package's bit for bit on the raw heights."""

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


@pytest.mark.parametrize("size,instances", CASES)
def test_plain_version_matches_jax(size, instances):
    """terrain_vertex_reference against the JAX package's function: clip
    positions, varyings and ids bit for bit, in the same order, on heights
    with 0, 1 and subnormals (read as signed zeros by both)."""
    heights, uniforms, worlds = terrain_inputs(size, instances, 7 * size)
    subnormal = (heights != 0) & (np.abs(heights) < np.finfo(np.float32).tiny)
    assert (heights == 0).any()
    assert heights.size < 3 or ((heights == 1).any() and subnormal.any())
    jclip, jvary, jids = jax_terrain(size, heights, uniforms, worlds)
    tris = tv.terrain_vertex_reference(torch.from_numpy(heights),
                                       torch.from_numpy(uniforms),
                                       torch.from_numpy(worlds), size)
    T = 2 * instances * size * size
    assert tris.clip.shape == tris.vary.shape == (T, 3, 4)
    np.testing.assert_array_equal(bits(jclip), bits(tris.clip))
    np.testing.assert_array_equal(bits(jvary), bits(tris.vary))
    np.testing.assert_array_equal(np.asarray(jids), tris.ids.numpy())
    assert tris.ids.dtype == torch.int32 and tris.planar


@pytest.mark.parametrize("size", [2, 7])
def test_per_vertex_shader_matches_jax(size):
    """The per-vertex shader (``_make_vertex_fn``, through the vertex
    stage's vmap) against the JAX package's per-vertex function under
    ``jax.jit``, on heights with subnormals: clip positions and varyings
    bit for bit."""
    heights, uniforms, worlds = terrain_inputs(size, 1, 3 * size)
    assert ((heights != 0)
            & (np.abs(heights) < np.finfo(np.float32).tiny)).any()
    V = 6 * size * size
    vidx = np.arange(V, dtype=np.int32)
    iids = np.zeros(V, np.int32)

    def jax_fn(w, u, h):
        return jvs.run_vertex_stage(jterrain._make_vertex_fn(size),
                                    jnp.asarray(vidx), {}, w,
                                    jnp.asarray(iids), {0: u, 1: h})

    jclip, jvary = jax.jit(jax_fn)(worlds, uniforms, heights)
    tris = tvs.run_vertex_stage(
        tterrain._make_vertex_fn(size, torch.device("cpu")),
        torch.from_numpy(vidx), {}, torch.from_numpy(worlds),
        torch.from_numpy(iids),
        {0: torch.from_numpy(uniforms), 1: torch.from_numpy(heights)})
    np.testing.assert_array_equal(bits(np.asarray(jclip).reshape(-1, 3, 4)),
                                  bits(tris.clip))
    np.testing.assert_array_equal(bits(np.asarray(jvary).reshape(-1, 3, 4)),
                                  bits(tris.vary))


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
    """K3 against its plain version on the card, one launch a call: sizes
    1, 7, 37, 100 (the demo's) and 708 (the stress scene's), each with 1
    and 3 instances, so that ragged chunks and instance edges are crossed,
    heights with subnormals among them; every lane bit for bit."""
    for size in (1, 7, 37, 100, 708):
        for instances in (1, 3):
            h, u, w = (torch.from_numpy(a).to(cuda_device) for a in
                       terrain_inputs(size, instances, size + instances))
            before = tv.K3.launches
            got = tv.terrain_vertex(h, u, w, size)
            assert tv.K3.launches == before + 1
            want = tv.terrain_vertex_reference(h, u, w, size)
            torch.cuda.synchronize()
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(bits(a.cpu()), bits(b.cpu()))
