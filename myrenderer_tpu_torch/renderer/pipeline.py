"""Pipeline and VertexLayout: the programmable-stage description.

Mirrors ``Renderer/Pipeline.zig`` and ``Renderer/VertexLayout.zig``, with
one deliberate substitution: where the reference carries WGSL source
strings compiled by the GPU driver (``Pipeline.zig:95-98``), a pipeline
here carries *Python callables* over torch tensors, run by the frame:

    vertex_fn(ctx: VertexCtx) -> (clip_pos f32[4], varyings f32[4])
    fragment_fn(varyings f32[..., 4]) -> rgba f32[..., 4]   (vectorized)
    fragment_fn(varyings, ctx: FragmentCtx) -> rgba          (two-param)

A two-parameter fragment function also receives the drawn instance's
bindings (``FragmentCtx.binding(loc)``) — the fragment-stage resource
access that makes the texture_view / texture_sampler binding kinds
(``Pipeline.zig:34-55``; in WebGPU these are fragment-stage resources)
usable per-PIXEL, e.g. UV texture sampling (``ops/sampling.py``).
The default fragment function is the reference's pass-through color
shader (``Pipeline.zig:12-32``). Fixed raster state defaults match
``Pipeline.zig:145-154``: triangle lists, clockwise front faces, back
culling, depth32 write-enabled with a 'less' compare.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

# Binding kinds (BindingLayout union, Pipeline.zig:34-55)
MANAGED_UNIFORM = "managed_uniform"
MANAGED_STORAGE = "managed_storage"
UNMANAGED_BUFFER = "unmanaged_buffer"
BUILTIN_TRANSFORM = "builtin_transform"
TEXTURE_VIEW = "texture_view"
TEXTURE_SAMPLER = "texture_sampler"

_KINDS = (MANAGED_UNIFORM, MANAGED_STORAGE, UNMANAGED_BUFFER,
          BUILTIN_TRANSFORM, TEXTURE_VIEW, TEXTURE_SAMPLER)


@dataclass(frozen=True)
class BindingLayout:
    """One bind-group slot (``Pipeline.zig:34-55``). Locations must be
    dense and declared in order — the contract the reference's
    ``update_buffer`` silently assumes (``Instance.zig:180-185``,
    SURVEY.md §2.5); we validate instead of assuming."""

    location: int
    kind: str

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown binding kind {self.kind!r}")


@dataclass(frozen=True)
class VertexLayout:
    """Packed vertex attribute layout (``VertexLayout.zig:9-31``).

    fields: ordered (name, width) pairs; field order is shader location
    order, widths are float32 lane counts (Vec2/Vec3/Vec4 -> 2/3/4).
    """

    fields: Tuple[Tuple[str, int], ...]

    @staticmethod
    def create(fields: Sequence[Tuple[str, int]]) -> "VertexLayout":
        for name, width in fields:
            if width not in (1, 2, 3, 4):
                raise ValueError(f"attribute {name!r}: width {width} "
                                 "not in 1..4 (float32xN formats)")
        return VertexLayout(tuple((str(n), int(w)) for n, w in fields))

    @property
    def stride(self) -> int:
        return sum(w for _, w in self.fields)

    def offsets(self) -> dict:
        out, at = {}, 0
        for name, width in self.fields:
            out[name] = (at, width)
            at += width
        return out


def default_fragment_fn(color):
    """Pass-through vertex color (``Pipeline.zig:12-32``)."""
    return color


def _fragment_arity(fn) -> int:
    """Positional-parameter count of a fragment function: 1 (varyings
    only) or 2 (varyings + FragmentCtx). A function opts into the ctx
    by declaring a second positional parameter — required, or
    defaulted-and-named ``ctx`` (so ``def f(vary, ctx=None)`` still
    receives its bindings rather than silently shading with ctx=None).
    ``*args`` callables keep the classic single-argument call (they
    predate the ctx contract and cannot be told apart). Validated at
    Pipeline.create so a malformed program fails HERE, not mid-frame
    (the WGSL-compile-time analogue, ``Pipeline.zig:95-98``)."""
    import inspect
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return 1     # non-introspectable callable: assume classic form
    pos = [p for p in params
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    n_req = sum(p.default is p.empty for p in pos)
    if any(p.kind is p.VAR_POSITIONAL for p in params):
        return 2 if n_req >= 2 else 1
    if n_req > 2 or not pos:
        raise ValueError(
            f"fragment_fn must take (varyings) or (varyings, ctx); "
            f"{getattr(fn, '__name__', fn)!r} takes {n_req} required "
            "positional parameters")
    if n_req == 2 or (len(pos) >= 2 and pos[1].name == "ctx"):
        return 2
    return 1


class Pipeline:
    """A render pipeline: vertex/fragment programs + binding layout +
    raster state. Create through ``Pipeline.create`` (``Pipeline.zig:92``).
    """

    def __init__(self, renderer, vertex_fn: Callable,
                 fragment_fn: Optional[Callable],
                 bindings: Sequence[BindingLayout],
                 vertex_layout: Optional[VertexLayout],
                 cull_mode: str, front_face: str,
                 depth_write: bool, depth_compare: str,
                 vertex_batch_fn: Optional[Callable] = None):
        self.renderer = renderer
        self.vertex_fn = vertex_fn
        self.vertex_batch_fn = vertex_batch_fn
        self.fragment_fn = fragment_fn or default_fragment_fn
        self.fragment_uses_ctx = _fragment_arity(self.fragment_fn) >= 2
        self.bindings = tuple(bindings)
        self.vertex_layout = vertex_layout
        self.cull_mode = cull_mode
        self.front_face = front_face
        self.depth_write = depth_write
        self.depth_compare = depth_compare

        locs = [b.location for b in self.bindings]
        if locs != list(range(len(locs))):
            raise ValueError(
                "binding locations must be dense and declared in order "
                f"(got {locs}) — contract inherited from the reference's "
                "location==index assumption (Instance.zig:180-185)")
        self.id = renderer._register(renderer.pipelines, self)

    @staticmethod
    def create(renderer, *, vertex_fn: Callable,
               fragment_fn: Optional[Callable] = None,
               bindings: Sequence[BindingLayout] = (),
               vertex_layout: Optional[VertexLayout] = None,
               cull_mode: str = "back", front_face: str = "cw",
               depth_write: bool = True,
               depth_compare: str = "less",
               vertex_batch_fn: Optional[Callable] = None) -> "Pipeline":
        """Create a pipeline (``Pipeline.zig:92``). ``vertex_fn`` is the
        per-vertex program; ``vertex_batch_fn``, when given, is an
        equivalent whole-stream formulation used by the performance
        path (dense mesh-shader style; must produce identical output).

        ``depth_write=False`` (an extension — the reference has no such
        option, ``Pipeline.zig:150-154`` is write-on) documents one
        deviation from GPU fixed-function semantics: triangles within a
        depth_write=False batch are still depth-tested against EACH
        OTHER (the nearest passing triangle wins), whereas real hardware
        tests every fragment against the unchanged depth buffer only, so
        the LAST passing draw wins. Both backends deviate consistently.
        """
        if front_face != "cw":
            raise NotImplementedError(
                "only front_face='cw' (the reference's fixed state, "
                "Pipeline.zig:145-149) is supported")
        if depth_compare not in ("less",):
            raise NotImplementedError("depth_compare must be 'less'")
        return Pipeline(renderer, vertex_fn, fragment_fn, bindings,
                        vertex_layout, cull_mode, front_face,
                        depth_write, depth_compare,
                        vertex_batch_fn=vertex_batch_fn)

    def get_builtin_location(self, builtin: str = "transform") -> Optional[int]:
        """``Pipeline.zig:62-70``."""
        assert builtin == "transform"
        for b in self.bindings:
            if b.kind == BUILTIN_TRANSFORM:
                return b.location
        return None

    def destroy(self) -> None:
        """``Pipeline.zig:72-80`` — drop from the registry."""
        if self in self.renderer.pipelines:
            self.renderer.pipelines.remove(self)
            self.renderer.bump_scene_version()
