"""Vertex-stage parity: the PyTorch port against the JAX package on the
CPU, bit for bit. Inputs are made with numpy from a seed and handed to
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu import math3d
from myrenderer_tpu.content import terrain as jterrain
from myrenderer_tpu.content import polygon as jpolygon
from myrenderer_tpu.ops import vertex_stage as jvs
from myrenderer_tpu_torch.content import terrain as tterrain
from myrenderer_tpu_torch.content import polygon as tpolygon
from myrenderer_tpu_torch.ops import vertex_stage as tvs

torch.set_num_threads(1)


def assert_bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    bad = a.view(np.int32) != b.view(np.int32)
    assert not bad.any(), f"{int(bad.sum())} of {a.size} values differ"


def random_forest(n, seed):
    """Parents (-1 = root) and level lists of a random node forest."""
    rng = np.random.default_rng(seed)
    parents = np.full(n, -1, np.int32)
    depth = np.zeros(n, np.int32)
    for i in range(1, n):
        if rng.uniform() < 0.8:
            parents[i] = rng.integers(0, i)
            depth[i] = depth[parents[i]] + 1
    levels = [np.nonzero(depth == d)[0].astype(np.int32)
              for d in range(1, int(depth.max()) + 1)]
    return parents, levels


@pytest.mark.parametrize("n,seed", [(1, 0), (6, 1), (40, 2)])
def test_compose_world_transforms(n, seed):
    rng = np.random.default_rng(seed + 100)
    locals_ = rng.standard_normal((n, 4, 4)).astype(np.float32)
    parents, levels = random_forest(n, seed)
    want = jax.jit(lambda l: jvs.compose_world_transforms(
        l, levels, parents))(locals_)
    got = tvs.compose_world_transforms(
        torch.from_numpy(locals_),
        tvs.level_indices(levels, parents, torch.device("cpu")))
    assert_bits_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_aabb(seed):
    rng = np.random.default_rng(seed)
    n = 64
    lo = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    finite = rng.uniform(size=n) > 0.2
    persp = math3d.perspective(90, 1.0, 0.1, 200)
    mats = np.stack([persp @ math3d.look_at(
        (rng.uniform(-5, 5), rng.uniform(-5, 5), rng.uniform(-5, 5)),
        (0, 0, 0), (0, 1, 0)) for _ in range(n)]).astype(np.float32)
    want = jax.jit(jvs.cull_aabb)(mats, lo, hi, finite)
    got = tvs.cull_aabb(*(torch.from_numpy(x)
                          for x in (mats, lo, hi, finite)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert 0 < int(got.sum()) < n      # both outcomes exercised


def terrain_inputs(size, seed):
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 1, size * size).astype(np.float32)
    uniform = np.zeros(17, np.float32)
    uniform[:16] = np.eye(4, dtype=np.float32).reshape(-1)
    uniform[16] = size
    cam = rng.uniform(-10, 10, 3)
    world = (math3d.perspective(90, 1.0, 0.1, 200)
             @ math3d.look_at(cam, (0, 0, 0), (0, 1, 0))).astype(np.float32)
    return hm, uniform, world


@pytest.mark.parametrize("size,seed", [(8, 0), (33, 1)])
def test_terrain_vertex_batch_fn(size, seed):
    """The terrain's whole-stream vertex function: same triangles, in
    the same array order, with the same submission ranks."""
    hm, uniform, world = terrain_inputs(size, seed)

    def jax_fn(worlds, u, h):
        ctx = jvs.BatchVertexCtx(None, {}, worlds, None, {0: u, 1: h})
        out = jterrain._make_vertex_batch_fn(size)(ctx)
        clip = jnp.stack([jnp.stack(out.clip[k], -1) for k in range(3)], 1)
        vary = jnp.stack([jnp.stack(out.vary[k], -1) for k in range(3)], 1)
        return clip, vary, out.ids

    jclip, jvary, jids = jax.jit(jax_fn)(world[None], uniform[None],
                                         hm[None])
    ctx = tvs.BatchVertexCtx(None, {}, torch.from_numpy(world[None]), None,
                             {0: torch.from_numpy(uniform[None]),
                              1: torch.from_numpy(hm[None])})
    tris = tterrain._make_vertex_batch_fn(size, torch.device("cpu"))(ctx)
    assert_bits_equal(jclip, tris.clip)
    assert_bits_equal(jvary, tris.vary)
    np.testing.assert_array_equal(np.asarray(jids), tris.ids.numpy())
    assert tris.planar


def test_polygon_vertex_fn():
    """The polygons' per-vertex function under vmap."""
    rng = np.random.default_rng(5)
    V = 21
    attrs = rng.uniform(0, 200, (V, 5)).astype(np.float32)
    worlds = np.stack([math3d.projection_2d(
        left=0.0, right=200.0, bottom=200.0, top=0.0, near=0.1, far=200.0),
        rng.standard_normal((4, 4))]).astype(np.float32)
    iids = (np.arange(V) >= 12).astype(np.int32)
    vidx = np.arange(V, dtype=np.int32)

    def jax_fn(worlds, attrs):
        return jvs.run_vertex_stage(
            jpolygon._vertex_fn, jnp.asarray(vidx),
            {"pos": attrs[:, 0:2], "color": attrs[:, 2:5]}, worlds,
            jnp.asarray(iids), {})

    jclip, jvary = jax.jit(jax_fn)(worlds, attrs)
    ta = torch.from_numpy(attrs)
    tris = tvs.run_vertex_stage(
        tpolygon._vertex_fn, torch.from_numpy(vidx),
        {"pos": ta[:, 0:2], "color": ta[:, 2:5]}, torch.from_numpy(worlds),
        torch.from_numpy(iids), {})
    assert_bits_equal(np.asarray(jclip).reshape(-1, 3, 4), tris.clip)
    assert_bits_equal(np.asarray(jvary).reshape(-1, 3, 4), tris.vary)
    assert tris.ids is None and not tris.planar
