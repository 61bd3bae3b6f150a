"""The frame pool (``render/pool.py``): the staged bounce loop over both
pooled frames' ladders and the reassembly by lane id; and the seams the
benchmark's layer spans wrap in the render modules, which a refactor of the
render layer must keep."""

import importlib
import json
import pathlib

import pytest
import torch

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.render import pathtracer, pool, whitted
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rayaccel_tpu_torch.types import Rays

torch.set_num_threads(2)

N = 16384
LADDERS = {
    "pt_quarter": pathtracer._stage_widths(N, 8, 1024),
    "whitted_ratio2": whitted._stage_widths(N, 2, 1024),
}


def _lifetimes(pattern):
    """Steps each lane lives, by lane id: 0 is dead from the start."""
    life = torch.ones(N, dtype=torch.int64)
    if pattern == "one_lane_to_the_end":
        life[N // 3] = 12
    elif pattern == "seeded":
        life = torch.randint(1, 11, (N,), generator=torch.Generator()
                             .manual_seed(5))
    elif pattern == "dead_from_the_start":
        life = torch.zeros(N, dtype=torch.int64)
    return life


@pytest.mark.parametrize("pattern", ["all_after_one_step",
                                     "one_lane_to_the_end", "seeded",
                                     "dead_from_the_start"])
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_run_pool_emits_every_lane_once(ladder, pattern):
    """Each step ages the live lanes and writes a value of (lane, age);
    a lane dies at the end of its lifetime. Across the pieces every lane id
    is valid exactly once, its row the value it died with, and the
    iteration count is the steps taken: the longest lifetime."""
    widths = LADDERS[ladder]
    assert len(widths) > 2
    lane0 = 3 * N                       # as on the fourth rank of a mesh
    life = _lifetimes(pattern)
    steps = 0

    def step(st):
        nonlocal steps
        steps += 1
        alive = st["alive"]
        age = st["age"] + alive.to(torch.int64)
        lane = st["lane"].to(torch.int64) - lane0
        val = torch.where(alive[:, None],
                          torch.stack([lane, age, lane * age], 1).float(),
                          st["val"])
        return dict(st, age=age, val=val, alive=alive & (age < life[lane]))

    def narrow(st, perm, n_live):
        assert perm.shape[0] in widths
        return dict(age=st["age"][perm], val=st["val"][perm],
                    lane=st["lane"][perm],
                    alive=torch.arange(perm.shape[0]) < n_live)

    st0 = dict(alive=life > 0, age=torch.zeros(N, dtype=torch.int64),
               val=torch.full((N, 3), -1.0),
               lane=torch.arange(lane0, lane0 + N, dtype=torch.int32))
    st, rows, iterations = pool.run_pool(st0, widths, step, narrow,
                                         lambda st: (st["val"],))
    assert iterations == steps == int(life.max())
    assert not st["alive"].any()
    valid = rows[:, 0] < pool.LANE_INVALID
    assert int(valid.sum()) == N
    ids = rows[valid, 0].to(torch.int64) - lane0
    assert torch.equal(torch.sort(ids).values, torch.arange(N))

    got = pool.by_lane(rows[:, 0], rows[:, 1:], N, lane0)
    lane = torch.arange(N)
    want = torch.stack([lane, life, lane * life], 1).float()
    want[life == 0] = -1.0
    assert torch.equal(got, want)


def test_the_benchmark_layer_seams_run(monkeypatch):
    """Every entry point of ``rtbench/layers/*.json``, wrapped by module
    attribute as the harness wraps it, runs in one CPU frame of the pooled
    path tracer and one of the pooled Whitted renderer with shadows, with
    rays as its second positional argument and ``active=`` by keyword."""
    layers = pathlib.Path(__file__).resolve().parents[1] / "rtbench/layers"
    entries = [e for f in sorted(layers.glob("*.json"))
               for e in json.loads(f.read_text())["entries"]]
    assert len(entries) == 6
    calls = {e["entry"]: 0 for e in entries}

    def wrapped(fn, entry):
        def call(*a, **kw):
            calls[entry["entry"]] += 1
            if entry.get("kind"):
                assert isinstance(a[entry["rays"]], Rays)
                assert entry["active"] in kw
            return fn(*a, **kw)
        return call

    for e in entries:
        modname, attr = e["entry"].split(":")
        mod = importlib.import_module(modname)
        monkeypatch.setattr(mod, attr, wrapped(getattr(mod, attr), e))
    sd = make_test_scene(viewport=(64, 64), max_depth=3)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 64)
    ctx = racc.create_context(racc.Configuration(
        wave_size=1024, trace_block=512, min_stage_width=1024), device="cpu")
    for r in (racc.PathTracingRenderer(ctx, cam, sd),
              racc.WhittedRenderer(ctx, cam, sd, shadows=True)):
        assert r.pooled
        r.render_frame(rng.PRNGKey(1))
        assert r.dropped == 0
    assert all(calls.values()), calls
