"""The program's spans (``rayaccel_tpu_torch/utils/spans.py``): a shared
null context with no profiler on; under ``torch.profiler`` a frame's
``racc.*`` ranges nest inside ``racc.render.frame``, name one of the four
layers, count the loops and shrinks the frame reports, and change no
pixel."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rayaccel_tpu_torch.utils import spans

SIZE = 64
LAYERS = {"render", "dense", "sparse", "shade"}
# Pooled path tracer, pooled Whitted trees, and the per-wave Whitted path
# with shadow rays (primary_only), all in four waves of 1024 lanes; the
# pools shrink at 1024 lanes.
KINDS = {"pt": ("PathTracingRenderer", {}),
         "whitted": ("WhittedRenderer", {}),
         "whitted_shadow": ("WhittedRenderer",
                            {"shadows": True, "primary_only": True})}


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(viewport=(SIZE, SIZE), max_depth=3)


def renderer(sd, kind):
    cls, kw = KINDS[kind]
    cfg = racc.Configuration(wave_size=1024, trace_block=512,
                             min_stage_width=1024)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, SIZE, SIZE)
    return getattr(racc, cls)(racc.create_context(cfg, device="cpu"), cam,
                              sd, **kw)


def traced_frame(r, key):
    """The program's spans of one frame: [(start us, end us, name)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame(key)
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.name.startswith("racc.")]


def test_no_profiler_no_range():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("racc.render.frame") is spans.span("racc.dense")
    with spans.span("racc.render.frame") as entered:
        assert entered is None


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_span_lies_in_the_frame_and_names_a_layer(scene, kind):
    r = renderer(scene, kind)
    assert r.pooled == (kind != "whitted_shadow")
    got = traced_frame(r, rng.PRNGKey(3))
    frames = [s for s in got if s[2] == "racc.render.frame"]
    assert len(frames) == 1
    lo, hi, _ = frames[0]
    for s, e, name in got:
        assert lo <= s <= e <= hi, name
        assert name.split(".")[1] in LAYERS, name
    names = Counter(n for _, _, n in got)
    assert names["racc.render.loop"] > 0 and names["racc.dense"] > 0
    assert names["racc.shade"] > 0 and names["racc.shade.surface"] > 0
    if kind == "whitted_shadow":
        # One step a wave: the primaries and their shadow rays.
        assert names["racc.render.wave"] == r.n_waves
        assert names["racc.render.loop"] == r.n_waves
        assert names["racc.dense"] == 2 * r.n_waves
        assert names["racc.sparse"] == 0
    else:
        assert names["racc.render.stage1"] == 1
        assert names["racc.render.wave"] == r.n_waves
        assert names["racc.sparse"] == names["racc.render.loop"]


def test_loop_and_shrink_spans_count_the_whitted_frame(scene):
    r = renderer(scene, "whitted")
    names = Counter(n for _, _, n in traced_frame(r, rng.PRNGKey(4)))
    assert r.last_info["shrinks"] == 2
    assert names["racc.render.loop"] == r.last_info["iterations"] > 0
    assert names["racc.render.shrink"] == r.last_info["shrinks"]
    # Every count the loop reads back is named: one before each step and
    # one as each stage ends.
    assert names["racc.render.read.pool_count"] == (
        r.last_info["iterations"] + r.last_info["shrinks"] + 1)


@pytest.mark.parametrize("kind", ["pt", "whitted"])
def test_every_sparse_call_holds_a_pass(scene, kind):
    got = traced_frame(renderer(scene, kind), rng.PRNGKey(5))
    calls = [s for s in got if s[2] == "racc.sparse"]
    passes = [s for s in got if s[2] == "racc.sparse.pass"]
    assert calls and len(passes) >= len(calls)
    for s, e, _ in calls:
        assert any(s <= ps and pe <= e for ps, pe, _ in passes)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_profiler_changes_no_pixel(scene, kind):
    on, off = renderer(scene, kind), renderer(scene, kind)
    for i in range(2):
        traced_frame(on, rng.PRNGKey(10 + i))
        off.render_frame(rng.PRNGKey(10 + i))
    assert torch.equal(on.frame_buffer, off.frame_buffer)
    assert on.rays_traced_total == off.rays_traced_total
    assert on.dropped == off.dropped
