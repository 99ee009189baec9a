"""Texture sampling, bitcasts, ``VertexCtx.binding_at`` and fragment-stage
texture sampling of the PyTorch port against the JAX package on the CPU.

The samplers must give the JAX package's compiled samplers' bits on
seeded UVs, borders included; the fragment-ctx quad of
``tests/test_render_e2e.py`` must render the JAX frame on both backends,
and ``tests/goldens/textured_128.png`` must be reproduced."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.ops import sampling as jsampling
from myrenderer_tpu.ops import vertex_stage as jvs
from myrenderer_tpu_torch import (Binding, BindingLayout, Instance, Pipeline,
                                  VertexBuffer, VertexLayout)
from myrenderer_tpu_torch.ops import sampling as tsampling
from myrenderer_tpu_torch.ops import vertex_stage as tvs
from myrenderer_tpu_torch.ops.vertex_stage import matvec4
from myrenderer_tpu_torch.renderer.pipeline import (BUILTIN_TRANSFORM,
                                                    TEXTURE_VIEW)
from myrenderer_tpu_torch.utils.png import load_rgba8
from test_render_e2e import _checker_texture, _textured_quad
from test_torch_sequential import JAX, TORCH, assert_goldens_rule

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "textured_128.png")


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    bad = a.view(np.int32) != b.view(np.int32)
    assert not bad.any(), f"{int(bad.sum())} of {a.size} values differ"


def seeded_uv(seed, shape=(40, 50)):
    """UVs over [-0.2, 1.2]^2 with the borders and corners included."""
    uv = np.random.default_rng(seed).uniform(-0.2, 1.2, shape + (2,))
    edges = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [0, 0.5],
                      [1, 0.5], [0.5, 1], [0.999999, 0.25], [1e-7, 0.75]])
    uv.reshape(-1, 2)[:len(edges)] = edges
    return uv.astype(np.float32)


@pytest.mark.parametrize("name", ["sample_nearest", "sample_bilinear"])
@pytest.mark.parametrize("tex_shape,seed", [((4, 4, 4), 0), ((5, 7, 3), 1),
                                            ((1, 6, 1), 2)])
def test_sampler_matches_jax(name, tex_shape, seed):
    tex = np.random.default_rng(seed + 10).uniform(
        0, 1, tex_shape).astype(np.float32)
    uv = seeded_uv(seed)
    want = jax.jit(getattr(jsampling, name))(tex, uv)
    got = getattr(tsampling, name)(torch.from_numpy(tex),
                                   torch.from_numpy(uv))
    assert_bits_equal(want, got.numpy())


def test_bilinear_borders_clamp_to_edge():
    """At u = 0 the result is texel 0 exactly (the border rule), at
    u = 1 the last texel; texel centers return their texel."""
    tex = torch.tensor([0.0, 1.0, 2.0, 3.0])[None, :, None]
    uv = torch.tensor([[0.0, 0.5], [1.0, 0.5], [0.375, 0.5], [0.5, 0.5]])
    out = tsampling.sample_bilinear(tex, uv)[:, 0]
    np.testing.assert_array_equal(out.numpy(), [0.0, 3.0, 1.0, 1.5])


def test_bitcasts_round_trip():
    words = np.array([0x3F800000, 7, 0xFFC00123, 0xDEADBEEF, 0x80000000],
                     np.uint32)
    f = tvs.bitcast_f32(torch.from_numpy(words))
    assert f.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(tvs.bitcast_u32(f).numpy(), words)
    np.testing.assert_array_equal(
        np.asarray(jvs.bitcast_u32(jnp.asarray(words.view(np.float32)))),
        tvs.bitcast_u32(torch.from_numpy(words.view(np.float32))).numpy())
    with pytest.raises(TypeError):
        tvs.bitcast_f32(torch.zeros(2, dtype=torch.int64))


def test_bitcasts_under_vmap():
    """The bitcasts of a vertex function's binding words, batched by
    vmap (two levels), give the unbatched bits: the words are viewed
    under the batching wrapper, which some torch releases cannot do."""
    words = np.array([[0x3F800000, 7, 0xFFC00123, 0xDEADBEEF],
                      [0, 1, 0x80000000, 0x7F800001]], np.uint32)
    f = torch.from_numpy(words.view(np.float32))
    for fn, dtype in ((tvs.bitcast_u32, np.uint32),
                      (tvs.bitcast_i32, np.int32)):
        got = torch.func.vmap(torch.func.vmap(fn))(f)
        np.testing.assert_array_equal(got.numpy(), words.view(dtype))
    back = torch.func.vmap(tvs.bitcast_f32)(tvs.bitcast_i32(f))
    np.testing.assert_array_equal(back.numpy().view(np.uint32), words)


def test_binding_at_under_vmap():
    """``binding_at`` inside the vmapped vertex stage reads one element
    per vertex from the instance's row, equal to the JAX package's."""
    rng = np.random.default_rng(3)
    rows = rng.uniform(0, 1, (2, 500)).astype(np.float32)
    V = 12
    vidx = np.arange(V, dtype=np.int32)
    iids = (np.arange(V) >= 6).astype(np.int32)
    cells = rng.integers(0, 500, V).astype(np.int32)
    worlds = np.stack([np.eye(4, dtype=np.float32)] * 2)

    def jax_vfn(ctx):
        h = ctx.binding_at(0, ctx.attr("cell")[0].astype(jnp.int32))
        s = ctx.binding_stacked(0)[ctx.instance_id, 0]
        return jnp.stack([h, s, h, jnp.float32(1.0)]), jnp.zeros(4)

    def torch_vfn(ctx):
        h = ctx.binding_at(0, ctx.attr("cell")[0].to(torch.int32))
        s = ctx.binding_stacked(0)[ctx.instance_id, 0]
        return torch.stack([h, s, h, torch.ones(())]), torch.zeros(4)

    jclip, _ = jax.jit(lambda r, c, w: jvs.run_vertex_stage(
        jax_vfn, jnp.asarray(vidx), {"cell": c}, w, jnp.asarray(iids),
        {0: r}))(rows, cells[:, None].astype(np.float32), worlds)
    tris = tvs.run_vertex_stage(
        torch_vfn, torch.from_numpy(vidx),
        {"cell": torch.from_numpy(cells[:, None].astype(np.float32))},
        torch.from_numpy(worlds), torch.from_numpy(iids),
        {0: torch.from_numpy(rows)})
    got = tris.clip.reshape(V, 4).numpy()
    assert_bits_equal(np.asarray(jclip), got)
    np.testing.assert_array_equal(got[:, 0], rows[iids, cells])


def torch_textured_quad(rend, tex):
    """The fragment-ctx quad of ``test_render_e2e._textured_quad``,
    through the port's API."""
    layout = VertexLayout.create([("pos", 2), ("uv", 2)])

    def vfn(ctx):
        p = ctx.attr("pos")
        uv = ctx.attr("uv")
        one = torch.ones((), dtype=torch.float32)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], one, one])),
                torch.stack([uv[0], uv[1], torch.zeros(()), one]))

    def ffn(vary, ctx):
        return tsampling.sample_nearest(ctx.binding(1), vary[..., :2])

    pipe = Pipeline.create(
        rend, vertex_fn=vfn, fragment_fn=ffn,
        bindings=[BindingLayout(0, BUILTIN_TRANSFORM),
                  BindingLayout(1, TEXTURE_VIEW)],
        vertex_layout=layout)
    assert pipe.fragment_uses_ctx
    vb = VertexBuffer.new(rend, 0, 2, layout)
    lo, hi = 0.1, 0.9
    vb.write_vertices(np.array([
        [lo, lo, 0, 0], [hi, lo, 1, 0], [lo, hi, 0, 1],
        [hi, lo, 1, 0], [hi, hi, 1, 1], [lo, hi, 0, 1]], np.float32))
    node = Instance.create_node(
        rend, pipeline=pipe, bindings=[Binding(1, attachment=tex)],
        bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def render_quad(api, backend, size):
    pkg = api.pkg
    core = pkg.Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(size, size, "textured")
    rend = api.renderer(core, backend)
    rend.adopt_window(window)
    rend.debug_winner = True
    make = _textured_quad if api is JAX else torch_textured_quad
    node = make(rend, _checker_texture(4))
    surf = pkg.Surface.create_window_scene(rend, window, node)
    surf.set_perspective(pkg.math3d.projection_2d(
        left=0.0, right=1.0, bottom=1.0, top=0.0, near=0.1, far=2.0))
    draw = pkg.Draw.create(rend)
    draw.begin()
    draw.clear((0, 0, 1, 1))
    draw.draw_surface(surf)
    draw.end()
    return (window.read_pixels(as_uint8=False),
            np.asarray(draw.last_winners[0]))


@pytest.mark.parametrize("jax_backend,backend", [("pallas", "auto"),
                                                 ("oracle", "oracle")])
def test_fragment_ctx_quad_matches_jax(jax_backend, backend):
    jfb, jwin = render_quad(JAX, jax_backend, 64)
    tfb, twin = render_quad(TORCH, backend, 64)
    np.testing.assert_array_equal(jwin, twin)
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))
    # both checker colors inside one triangle: per-pixel sampling
    assert len(np.unique(tfb[twin == 0], axis=0)) == 2


@pytest.mark.parametrize("backend", ["auto", "oracle"])
def test_textured_golden(backend):
    fb, _ = render_quad(TORCH, backend, 128)
    assert_goldens_rule(load_rgba8(GOLDEN).astype(np.float32) / 255.0, fb)

