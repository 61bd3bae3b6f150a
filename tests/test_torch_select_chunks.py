"""K2 past one CTA's shared memory, and the SPD ``tetra`` scene that needs
it, held on the CPU.

The select kernel (``csrc/select_nearest.cu``) streams more boxes than one
CTA holds in chunks, and lets a lane skip a chunk whose union box
(``ClusterScene.bb_chunks``) cannot change its answer. The kernel runs on
the card alone (``tests/test_torch_cuda.py`` holds it there); here the
skip rule itself, run chunk by chunk in torch as the kernel runs it at a
split of 1, must give the plain version's words bit for bit, on a
battlefield-like scene in clusters of 8 cut into chunks of 32 boxes. The
benchmark's ``tetra.pt.d2`` configuration renders ``rtbench/scenes/
spd_tetra.py``; at size factor 4 and 64 x 36 its frames agree with the
benchmark's plain reference and drop no ray.
"""

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.loader import make_battlefield_like

import rayaccel_tpu_torch as racc
from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.ops.intersect import safe_inv_dir
from rayaccel_tpu_torch.scene.clusters import (SELECT_CHUNK,
                                               cluster_scene_from_numpy,
                                               compile_clusters_np,
                                               select_chunk_boxes)
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.scene.loader import make_test_scene
from rtbench import run, scene as rt_scene
from rtbench.scenes import spd_tetra

from tests.torch_helpers import port_scene

torch.set_num_threads(2)

N = 2048
CHUNK = 32
INT_MIN = -0x80000000
NONE = 0x7FFFFFFF
INF = 0x7F800000


@pytest.fixture(scope="module")
def scene():
    cs = port_scene(compile_clusters(
        make_battlefield_like(n_objects=40, grid=21), cluster_size=8))
    assert cs.bb.shape[0] >= 8 * CHUNK
    return cs


def _rays(scene, kind):
    """K2's arguments for N rays (select tiles of 512): ``random``, origins
    inside the scene's bounds in every direction, or ``camera``, a pencil
    from above the scene toward its middle, the coherent case. A dead
    select tile, scattered dead lanes and a few empty windows in both."""
    rs = np.random.default_rng(5)
    lo, hi = scene.cl_bbmin.amin(0).numpy(), scene.cl_bbmax.amax(0).numpy()
    if kind == "random":
        o = rs.uniform(lo, hi, (N, 3)).astype(np.float32)
        d = rs.normal(size=(N, 3)).astype(np.float32)
    else:
        mid = (lo + hi) / 2
        o = np.broadcast_to(mid + [0, 40, 0], (N, 3)).astype(np.float32)
        aim = mid + rs.uniform(-8, 8, (N, 3)) * [1, 0, 1]
        d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(N, np.float32)
    tmax = np.full(N, 1e6, np.float32)
    tmax[1024:1536] = -1.0
    tmax[rs.random(N) < 0.2] = -1.0
    tmin[100:110], tmax[100:110] = 5.0, 2.0
    tmax = torch.tensor(tmax)
    live = ((tmax > 0).reshape(-1, 512).any(dim=1).repeat_interleave(512)
            .to(torch.uint8))
    F8 = torch.cat([torch.tensor(o), safe_inv_dir(torch.tensor(d)),
                    torch.tensor(tmin)[:, None], tmax[:, None]], dim=1)
    return F8, live


def _smallest(words, n):
    return torch.topk(words, n, dim=1, largest=False, sorted=True).values


def chunked_select(F8, prev, live, bb, k, id_bits, count):
    """K2's multi-chunk path at a split of 1, chunk by chunk in torch:
    each lane tests the chunks that :func:`sparse.chunk_skips` leaves it
    (and, without ``count``, those whose least word is not above its
    (k+1)-th word so far), keeps its k + 1 least words and its count,
    then fills a short list with its missed boxes in id order. Returns
    the rows of the lanes that run the box loop, their mask and the
    (lane, chunk) pairs tested."""
    ub = select_chunk_boxes(bb, CHUNK)
    skip, first = sparse.chunk_skips(F8, prev, ub, id_bits)
    runs = (live == 1) & ~(F8[:, 7] < F8[:, 6])
    words = sparse._packed_entries(F8, prev, bb, id_bits)
    R = F8.shape[0]
    top = torch.full((R, k + 1), NONE, dtype=torch.int32)
    cnt = torch.zeros(R, dtype=torch.int64)
    tested = 0
    for q in range(ub.shape[0]):
        need = runs & ~skip[:, q]
        if not count:
            need &= ~(first[:, q] > top[:, k])
        tested += int(need.sum())
        w = words[:, q * CHUNK:(q + 1) * CHUNK]
        kept = need[:, None] & (w < INF)
        cnt += kept.sum(dim=1)
        top = _smallest(torch.cat([top, torch.where(kept, w, NONE)], dim=1),
                        k + 1)
    missed = torch.where(words >= INF, words, NONE)
    top = _smallest(torch.cat([top, missed], dim=1), k + 1)
    rows = torch.cat([top.T, cnt[None].to(torch.int32)])
    return rows if count else rows[:k + 1], runs, tested


@pytest.mark.parametrize("count", [True, False], ids=["count", "no_count"])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("kind", ["random", "camera"])
def test_skipped_chunks_change_no_answer(scene, kind, k, count):
    """The chunk skips give the plain version's words (and count, where
    asked), bit for bit, on a first pass and on a restart pass whose
    lanes drop every word below their spill word. The first pass tests
    some chunks and skips others; the restart tests no more; the pairs
    tested with the count are those that ``select_chunks_needed`` counts,
    and without it no more."""
    F8, live = _rays(scene, kind)
    bb = scene.bb
    id_bits = max((bb.shape[0] - 1).bit_length(), 1)
    n_chunks = -(-bb.shape[0] // CHUNK)
    prev = torch.full((N,), INT_MIN, dtype=torch.int32)
    spill = sparse.select_nearest_plain(F8, prev, live, bb, 4, id_bits)[4]
    counts = []
    for p in (prev, spill.contiguous()):
        want = sparse.select_nearest_plain(F8, p, live, bb, k, id_bits,
                                           count=count)
        got, runs, tested = chunked_select(F8, p, live, bb, k, id_bits,
                                           count)
        assert torch.equal(got[:, runs], want[:, runs])
        needed = sparse.select_chunks_needed(F8, p, live,
                                             select_chunk_boxes(bb, CHUNK),
                                             id_bits)
        assert tested == needed if count else tested <= needed
        counts.append(tested)
    assert 0 < counts[0] < int(runs.sum()) * n_chunks
    assert counts[1] <= counts[0]


def test_plain_select_leaves_out_the_count_row(scene):
    F8, live = _rays(scene, "random")
    prev = torch.full((N,), INT_MIN, dtype=torch.int32)
    id_bits = max((scene.bb.shape[0] - 1).bit_length(), 1)
    full = sparse.select_nearest(F8, prev, live, scene.bb, 4, id_bits)
    short = sparse.select_nearest(F8, prev, live, scene.bb, 4, id_bits,
                                  count=False)
    assert full.shape == (6, N) and torch.equal(short, full[:5])


def test_chunk_boxes_hold_every_box():
    """Each union box holds its chunk's boxes, their planes put in order
    first; a run shorter than a chunk ends the table; a NaN plane makes
    its union's NaN."""
    rs = np.random.default_rng(3)
    lo = rs.uniform(-10, 10, (200, 3)).astype(np.float32)
    bb = torch.tensor(np.concatenate([lo, lo + rs.uniform(0, 2, (200, 3))
                                      .astype(np.float32)], axis=1))
    bb[7] = bb[7, [3, 4, 5, 0, 1, 2]]            # planes swapped
    ub = select_chunk_boxes(bb, CHUNK)
    assert ub.shape == (7, 6)
    owner = torch.arange(200) // CHUNK
    ordered = torch.cat([torch.minimum(bb[:, :3], bb[:, 3:]),
                         torch.maximum(bb[:, :3], bb[:, 3:])], dim=1)
    assert (ordered[:, :3] >= ub[owner, :3]).all()
    assert (ordered[:, 3:] <= ub[owner, 3:]).all()
    for q in range(7):
        part = ordered[q * CHUNK:(q + 1) * CHUNK]
        assert torch.equal(ub[q, :3], part[:, :3].amin(0))
        assert torch.equal(ub[q, 3:], part[:, 3:].amax(0))
    bb[40, 1] = float("nan")
    assert select_chunk_boxes(bb, CHUNK)[1, 1].isnan()


def test_compiled_scene_carries_its_chunk_boxes(scene):
    assert scene.bb_chunks.shape == (-(-scene.bb.shape[0] // SELECT_CHUNK), 6)
    assert torch.equal(scene.bb_chunks, select_chunk_boxes(scene.bb))


def test_select_spans_one_a_pass():
    """Under the profiler each ``racc.sparse.pass`` holds one
    ``racc.sparse.select``, around K2's call."""
    sd = make_test_scene(viewport=(64, 64), max_depth=2)
    cfg = racc.Configuration(wave_size=1024, trace_block=512,
                             min_stage_width=1024)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 64)
    r = racc.PathTracingRenderer(racc.create_context(cfg, device="cpu"),
                                 cam, sd)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame(rng.PRNGKey(0))
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.name.startswith("racc.sparse")]
    passes = [s for s in spans if s[2] == "racc.sparse.pass"]
    selects = [s for s in spans if s[2] == "racc.sparse.select"]
    assert passes and len(selects) == len(passes)
    for s in selects:
        assert sum(p[0] <= s[0] and s[1] <= p[1] for p in passes) == 1


def test_select_readers():
    """``select.device_ms_per_frame`` sums K2's kernels by name in the
    counted frames, either path's; ``select.calls_per_frame`` counts the
    program's select spans a frame; a trace with neither reads None and
    0."""
    ops = [("void racc::(anonymous namespace)::select_kernel<4, 1>(...)",
            "kernel", 300.0, 0, "sparse", False),
           ("void racc::(anonymous namespace)::select_chunks_kernel<8, 2>"
            "(...)", "kernel", 900.0, 1, "sparse", False),
           ("void racc::(anonymous namespace)::select_kernel<4, 1>(...)",
            "kernel", 50.0, None, "sparse", False),
           ("pair_hit_kernel<...>", "kernel", 70.0, 1, "sparse", False)]
    host = [(0, 5, "racc.sparse.select"), (6, 9, "racc.sparse.select"),
            (10, 12, "racc.sparse.pass"), (13, 14, "racc.sparse.select")]
    tl = SimpleNamespace(ops=ops, n_frames=2, _host=host)
    ms = run.load_reader("select.device_ms_per_frame")(SimpleNamespace(
        timeline=tl))
    assert ms == pytest.approx(0.6)
    calls = run.load_reader("select.calls_per_frame")
    assert calls(SimpleNamespace(timeline=tl)) == 1.5
    empty = SimpleNamespace(ops=ops[3:], n_frames=2, _host=[])
    assert run.load_reader("select.device_ms_per_frame")(SimpleNamespace(
        timeline=empty)) is None
    assert calls(SimpleNamespace(timeline=empty)) == 0


@pytest.mark.parametrize("size_factor", [1, 2, 3, 4])
def test_tetra_has_four_triangles_a_tetrahedron(size_factor):
    """4^SF tetrahedra of four outward triangles, inside the cube
    [-1, 1]^3, the same bytes for the same arguments."""
    a = spd_tetra.generate(1, max_depth=2, size_factor=size_factor,
                           viewport=(64, 36))
    b = spd_tetra.generate(2, max_depth=2, size_factor=size_factor,
                           viewport=(64, 36))
    n = 4 ** (size_factor + 1)
    assert a["indices"].shape == (n, 3) and a["vertices"].shape == (3 * n, 3)
    assert np.abs(a["vertices"]).max() == 1.0
    for key, value in a.items():
        assert np.asarray(value).tobytes() == np.asarray(b[key]).tobytes()
    v = a["vertices"].reshape(-1, 12, 3)
    centre = np.repeat(v.mean(axis=1), 4, axis=0)
    face = a["vertices"][a["indices"]].mean(axis=1)
    assert (np.sum(a["triangle_normals"] * (face - centre), axis=1) > 0).all()
    SceneData(**a)


def test_tetra_configuration_is_found_without_the_program():
    """The configuration's generator loads through ``rtbench.scene.find``,
    and neither it nor the harness's scene module imports the program or
    JAX."""
    gen = rt_scene.find("spd_tetra", run.HERE)
    assert gen(0, max_depth=2, size_factor=1, viewport=(8, 8))[
        "indices"].shape == (16, 3)
    code = ("import sys; from rtbench import scene; "
            "scene.find('spd_tetra', 'rtbench')(0, max_depth=2, "
            "size_factor=2, viewport=(8, 8)); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'rayaccel_tpu', 'rayaccel_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, check=True)
    assert out.stdout.strip() == "[]"
    cfg = run.load_json(f"{run.HERE}/configs/spd_tetra_pt.json")
    assert cfg["scene"]["args"]["size_factor"] == 10
    assert cfg["reduced"] == []


def test_tetra_cell_matches_the_reference_at_a_small_size():
    """``tetra.pt.d2`` through ``run_cell`` at size factor 4 (1,024
    triangles in clusters of 128) and 64 x 36 on the CPU, every pixel and
    frame compared: correct, no ray dropped; the primaries hit the
    pyramid."""
    bench = run.load_bench()
    ov = {"config": {"scene": {"args": {"size_factor": 4,
                                        "viewport": [64, 36]}},
                     "configuration": {"wave_size": 1024,
                                       "trace_block": 512}},
          "traffic": {"check_pixels": 1 << 20, "check_frames": 1 << 20,
                      "max_frames": 3}}
    result, numbers = run.run_cell(
        bench, run.find_cell(bench, "tetra.pt.d2"), 20261018, 0.2, False,
        torch.device("cpu"), 0.0, ov, log=lambda obj: None)
    assert result["correct"], numbers
    assert numbers["dropped"]["value"] == 0
    assert numbers["differ_pct"]["value"] <= 1.0
    sd = SceneData(**spd_tetra.generate(0, max_depth=2, size_factor=4,
                                        viewport=(64, 36)))
    cs = cluster_scene_from_numpy(**compile_clusters_np(sd), device="cpu")
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, 64, 36)
    cfg = racc.Configuration(wave_size=4096, trace_block=512)
    r = racc.PathTracingRenderer(racc.create_context(cfg, device="cpu"),
                                 cam, sd, tpu_scene=cs)
    r.render_frame(rng.PRNGKey(1))
    # Bounces follow the primaries that hit: more than a tenth do.
    assert r.rays_traced_total > 1.1 * 64 * 36 and r.dropped == 0
